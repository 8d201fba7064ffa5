"""CLI entry: images -> features.h5 / matches.h5 -> COLMAP database.

    python -m deep_image_matching_tpu_torch --dir PROJECT \\
        --pipeline superpoint+lightglue --skip_reconstruction

Port of ``deep_image_matching_tpu/__main__.py``. For the detector-free
pipelines (``roma``) the per-pair keypoints are merged into multiview tracks
after the COLMAP export, which is then redone from the merged files.
Reconstruction is not ported yet, so a run without
``--skip_reconstruction`` fails at start; the view-graph export is skipped.
"""

from __future__ import annotations

import logging


def run_matching(args: dict):
    """Config -> ImageMatcher -> COLMAP export. Returns (feature_path,
    match_path, None); the matcher's per-stage wall times are logged."""
    from .config import Config
    from .image_matching import ImageMatcher
    from .io.h5_to_db import export_to_colmap
    from .matchers.matcher_base import DetectorFreeMatcher
    from .utils.logger import change_logger_level

    if not args.get("skip_reconstruction"):
        raise NotImplementedError(
            "Reconstruction is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1: reconstruction); pass --skip_reconstruction"
        )
    if args.get("openmvg"):
        raise NotImplementedError(
            "The OpenMVG export is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1: exports and host tools)"
        )
    config = Config(args=args)
    if config.general.get("verbose"):
        change_logger_level("dim_tpu_torch", "debug")
    config.save()

    matcher = ImageMatcher(config)
    feature_path, match_path = matcher.run()

    logger = logging.getLogger("dim_tpu_torch")
    database_path = config.output_dir / "database.db"
    export_to_colmap(
        img_dir=config.image_dir,
        feature_path=feature_path,
        match_path=match_path,
        database_path=database_path,
        camera_config_path=config.general.get("camera_options"),
    )
    if isinstance(matcher.matcher, DetectorFreeMatcher):
        from .utils.dense_to_multiview import dense_to_multiview

        dense_to_multiview(
            feature_path, match_path, database_path, config.image_dir,
            camera_config_path=config.general.get("camera_options"),
        )
    if config.general.get("graph", True):
        logger.info("View-graph export is not ported yet (ROADMAP.md, queue 1); skipped")
    return feature_path, match_path, None


def main():
    from .parser import parse_cli

    run_matching(parse_cli())


if __name__ == "__main__":
    main()
