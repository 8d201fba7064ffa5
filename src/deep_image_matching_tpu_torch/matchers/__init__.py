from .matcher_base import BatchedMatcher, MatcherBase, matcher_loader  # noqa: F401
