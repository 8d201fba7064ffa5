from .extractor_base import ExtractorBase, extractor_loader  # noqa: F401
