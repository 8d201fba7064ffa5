"""CLI argument parser.

Copy of ``deep_image_matching_tpu/parser.py`` — the reference's flag surface
(--dir/--images/--outs/--pipeline/--config_file/--quality/--tiling/
--strategy/--pair_file/--overlap/--global_feature/--db_path/--upright/
--skip_reconstruction/--force/-V/--graph/--openmvg/--camera_options/--gui).
"""

from __future__ import annotations

import argparse

from .config import confs, opt_zoo


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deep-image-matching-tpu-torch",
        description="Multiview image matching for SfM (PyTorch/CUDA port)",
    )
    parser.add_argument("--gui", action="store_true", help="Run the GUI")
    parser.add_argument("-d", "--dir", type=str, help="Project dir (expects images/ inside)")
    parser.add_argument("-i", "--images", type=str, help="Image folder (overrides --dir/images)")
    parser.add_argument("-o", "--outs", type=str, help="Output folder")
    parser.add_argument(
        "-p", "--pipeline", type=str, choices=list(confs.keys()), help="Pipeline preset"
    )
    parser.add_argument("-c", "--config_file", type=str, help="YAML config override")
    parser.add_argument(
        "-q", "--quality", type=str,
        choices=["lowest", "low", "medium", "high", "highest"], default="high",
    )
    parser.add_argument(
        "-t", "--tiling", type=str,
        choices=["none", "preselection", "grid", "exhaustive"], default="none",
    )
    parser.add_argument(
        "-m", "--strategy", type=str,
        choices=opt_zoo["matching_strategy"], default="matching_lowres",
    )
    parser.add_argument("-pf", "--pair_file", type=str, help="Custom pairs file")
    parser.add_argument("-v", "--overlap", type=int, help="Sequential overlap window")
    parser.add_argument(
        "-r", "--global_feature", type=str, choices=opt_zoo["retrieval"],
        help="Global feature for retrieval strategy",
    )
    parser.add_argument("-db", "--db_path", type=str, help="COLMAP db for covisibility")
    parser.add_argument("--upright", action="store_true", help="Rotate images upright")
    parser.add_argument(
        "--resume", action="store_true",
        help="Reuse existing features.h5/raw_matches.h5 (skip completed work)",
    )
    parser.add_argument("--skip_reconstruction", action="store_true")
    parser.add_argument("-f", "--force", action="store_true", help="Overwrite outputs")
    parser.add_argument("-V", "--verbose", action="store_true")
    parser.add_argument("--graph", action="store_true", default=True, help="Export view graph")
    parser.add_argument("--openmvg", type=str, default=None, help="OpenMVG config / bin dir")
    parser.add_argument("--camera_options", type=str, default=None, help="cameras.yaml path")
    return parser


def parse_cli() -> dict:
    parser = build_parser()
    args = parser.parse_args()
    if args.gui:
        parser.error("--gui is not ported to the PyTorch package yet (ROADMAP.md, queue 1)")
    if not args.dir and not args.images:
        parser.error("either --dir or --images is required")
    if not args.pipeline:
        parser.error("--pipeline is required")
    return vars(args)
