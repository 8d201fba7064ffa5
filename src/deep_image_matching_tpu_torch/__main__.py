"""CLI entry: images -> features.h5 / matches.h5 -> COLMAP database ->
COLMAP model.

    python -m deep_image_matching_tpu_torch --dir PROJECT \\
        --pipeline superpoint+lightglue

Port of ``deep_image_matching_tpu/__main__.py``. For the detector-free
pipelines (``roma``) the per-pair keypoints are merged into multiview tracks
after the COLMAP export, which is then redone from the merged files. Then
the view graph (``graph.py``; on by default, off with ``graph: false``), and,
unless ``--skip_reconstruction`` is given, the incremental mapper writes a
COLMAP text model and ``model.ply`` under ``reconstruction/``, with its
bundle adjustment on ``general.tpu.device``. With ``--openmvg CONF`` the
matches are exported as an OpenMVG project under ``openmvg/``, reconstructed
there where ``openMVG_main_SfM`` is found. With ``DIM_TPU_PROFILE=DIR`` the
set-up, the matching stages and the COLMAP export are traced to
``DIR/image_matching/trace.json`` (``utils/profiler.py``). Each call is one
run of the port's spans (``utils/profiler.run_scope``): ``setup`` (the
configuration, the image list, the extractor's and matcher's construction),
then the matcher's and the export's own.
"""

from __future__ import annotations


def run_matching(args: dict):
    """Config -> ImageMatcher -> COLMAP export -> reconstruction. Returns
    (feature_path, match_path, model): the model is the mapper's
    (cameras, images, points3D), or None with ``--skip_reconstruction`` or
    when no model came out. Exceptions of the view graph and of the mapper
    propagate. The matcher's per-stage wall times are logged."""
    from .utils.profiler import run_scope

    with run_scope():
        return _run_matching(args)


def _run_matching(args: dict):
    from .config import Config
    from .image_matching import ImageMatcher
    from .io.h5_to_db import export_to_colmap
    from .matchers.matcher_base import DetectorFreeMatcher
    from .utils.logger import change_logger_level
    from .utils.profiler import device_trace, span

    with device_trace("image_matching"):
        with span("setup"):
            config = Config(args=args)
            if config.general.get("verbose"):
                change_logger_level("dim_tpu_torch", "debug")
            config.save()
            matcher = ImageMatcher(config)
        database_path = config.output_dir / "database.db"
        feature_path, match_path = matcher.run()
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
        from .graph import view_graph

        view_graph(database_path, config.output_dir, config.image_dir)
    reconstruction = None
    if not config.general.get("skip_reconstruction"):
        from .reconstruction import incremental_reconstruction

        reconstruction = incremental_reconstruction(
            database_path, config.image_dir, config.output_dir,
            options=config.general.get("sfm_options"),
            backend=config.general.get("sfm_backend", "auto"),
            device=config.general.get("tpu", {}).get("device", "auto"),
        )
    if config.general.get("openmvg_conf"):
        from .io.h5_to_openmvg import export_to_openmvg
        from .openmvg import openmvg_reconstruction

        openmvg_dir = config.output_dir / "openmvg"
        export_to_openmvg(
            img_dir=config.image_dir,
            feature_path=feature_path,
            match_path=match_path,
            openmvg_out_path=openmvg_dir,
            camera_config_path=config.general.get("camera_options"),
        )
        openmvg_reconstruction(openmvg_out_path=openmvg_dir,
                               openmvg_conf=config.general.get("openmvg_conf"))
    return feature_path, match_path, reconstruction


def main():
    from .parser import parse_cli

    run_matching(parse_cli())


if __name__ == "__main__":
    main()
