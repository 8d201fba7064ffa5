"""CLI entry: images -> features.h5 / matches.h5 -> COLMAP database ->
COLMAP model.

    python -m deep_image_matching_tpu_torch --dir PROJECT \\
        --pipeline superpoint+lightglue

Port of ``deep_image_matching_tpu/__main__.py``. For the detector-free
pipelines (``roma``) the per-pair keypoints are merged into multiview tracks
after the COLMAP export, which is then redone from the merged files. Then,
unless ``--skip_reconstruction`` is given, the incremental mapper writes a
COLMAP text model and ``model.ply`` under ``reconstruction/``, with its
bundle adjustment on ``general.tpu.device``. The view-graph export is not
ported and is skipped; ``--openmvg`` raises.
"""

from __future__ import annotations

import logging


def run_matching(args: dict):
    """Config -> ImageMatcher -> COLMAP export -> reconstruction. Returns
    (feature_path, match_path, model): the model is the mapper's
    (cameras, images, points3D), or None with ``--skip_reconstruction`` or
    when no model came out. Exceptions of the mapper propagate. The
    matcher's per-stage wall times are logged."""
    from .config import Config
    from .image_matching import ImageMatcher
    from .io.h5_to_db import export_to_colmap
    from .matchers.matcher_base import DetectorFreeMatcher
    from .utils.logger import change_logger_level

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
    reconstruction = None
    if not config.general.get("skip_reconstruction"):
        from .reconstruction import incremental_reconstruction

        reconstruction = incremental_reconstruction(
            database_path, config.image_dir, config.output_dir,
            options=config.general.get("sfm_options"),
            backend=config.general.get("sfm_backend", "auto"),
            device=config.general.get("tpu", {}).get("device", "auto"),
        )
    return feature_path, match_path, reconstruction


def main():
    from .parser import parse_cli

    run_matching(parse_cli())


if __name__ == "__main__":
    main()
