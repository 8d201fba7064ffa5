"""Incremental SfM: pycolmap (host C++ COLMAP) or the native TPU mapper.

Parity: reference ``reconstruction.py:12-110`` — runs
``pycolmap.incremental_mapping`` on the exported database, picks the largest
model, writes COLMAP text + PLY. pycolmap stays an optional host dependency
(SURVEY.md section 2.4); unlike the reference, reconstruction still works
without it via the native incremental mapper (``sfm/``: RANSAC PnP +
multi-view triangulation + bundle adjustment on ``device``). Backend
selection: ``backend="auto"`` (default) prefers pycolmap and falls back to
native; ``"pycolmap"`` / ``"native"`` force one.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger("dim_tpu_torch")


def pycolmap_available() -> bool:
    try:
        import pycolmap  # noqa: F401

        return True
    except ImportError:
        return False


def incremental_reconstruction(
    database_path: Path,
    image_dir: Path,
    output_dir: Path,
    options: Optional[dict] = None,
    export_text: bool = True,
    export_ply: bool = True,
    backend: str = "auto",
    device=None,
) -> Optional[Any]:
    """Map the database's images; returns the model or None when no model
    came out. The native mapper runs its bundle adjustment on ``device``
    (``utils/device.resolve_device``: the first CUDA device unless "cpu" is
    asked for)."""
    if backend not in ("auto", "pycolmap", "native"):
        raise ValueError(f"Unknown sfm backend {backend!r}")
    if backend == "native" or (backend == "auto" and not pycolmap_available()):
        if backend == "auto":
            logger.info(
                "pycolmap not installed - using the native incremental mapper"
            )
        from .sfm import native_incremental_mapping

        return native_incremental_mapping(
            database_path, image_dir, output_dir,
            options=options, export_text=export_text, export_ply=export_ply,
            device=device,
        )
    import multiprocessing

    import pycolmap

    output_dir = Path(output_dir)
    rec_dir = output_dir / "reconstruction"
    rec_dir.mkdir(parents=True, exist_ok=True)

    opts = {"num_threads": multiprocessing.cpu_count()}
    if options:
        opts.update(options)
    mapper_options = pycolmap.IncrementalPipelineOptions(**opts)

    logger.info("Running incremental mapping (pycolmap)...")
    reconstructions = pycolmap.incremental_mapping(
        database_path=str(database_path),
        image_path=str(image_dir),
        output_path=str(rec_dir),
        options=mapper_options,
    )
    if not reconstructions:
        logger.error("Reconstruction failed: no model produced")
        return None
    # keep the largest model (reference reconstruction.py:81-89)
    best_idx = max(
        reconstructions, key=lambda k: reconstructions[k].num_reg_images()
    )
    model = reconstructions[best_idx]
    logger.info(
        f"Reconstruction done: {model.num_reg_images()} registered images, "
        f"{model.num_points3D()} 3D points"
    )
    if export_text:
        model.write_text(str(rec_dir))
    if export_ply:
        model.export_PLY(str(rec_dir / "model.ply"))
    return model
