"""OpenMVG SfM runner, a host subprocess (port of
``deep_image_matching_tpu/openmvg.py``): ``openMVG_main_SfM --sfm_engine
INCREMENTAL`` on an exported project where the executable is found;
otherwise a warning, and the project is left for external processing.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger("dim_tpu_torch")


def find_openmvg_bin(openmvg_conf: Optional[str] = None) -> Optional[Path]:
    """Locate the openMVG_main_SfM executable.

    ``openmvg_conf`` may be (reference ``--openmvg config.yaml`` surface):
    a YAML file with ``general: path_to_binaries`` (null = use PATH), a
    directory containing the binaries, or the executable itself.
    """
    if openmvg_conf:
        cand = Path(openmvg_conf)
        if cand.is_file() and cand.suffix.lower() in (".yaml", ".yml"):
            import yaml

            conf = yaml.safe_load(cand.read_text()) or {}
            bin_dir = (conf.get("general") or {}).get("path_to_binaries")
            cand = Path(bin_dir) if bin_dir else None
        if cand is not None:
            if cand.is_dir():
                exe = cand / "openMVG_main_SfM"
                if exe.exists():
                    return exe
            elif cand.is_file():
                return cand
    found = shutil.which("openMVG_main_SfM")
    return Path(found) if found else None


def openmvg_reconstruction(
    openmvg_out_path: Path,
    openmvg_conf: Optional[str] = None,
    skip_reconstruction: bool = False,
) -> Optional[Path]:
    """Run incremental SfM on an exported OpenMVG project directory."""
    if skip_reconstruction:
        return None
    openmvg_out_path = Path(openmvg_out_path)
    exe = find_openmvg_bin(openmvg_conf)
    if exe is None:
        logger.warning(
            "openMVG binaries not found - skipping OpenMVG reconstruction. "
            "The exported project is ready at "
            f"{openmvg_out_path} for external processing."
        )
        return None
    recon_dir = openmvg_out_path / "reconstruction"
    recon_dir.mkdir(exist_ok=True)
    cmd = [
        str(exe),
        "--sfm_engine", "INCREMENTAL",
        "--input_file", str(openmvg_out_path / "matches" / "sfm_data.json"),
        "--match_dir", str(openmvg_out_path / "matches"),
        "--output_dir", str(recon_dir),
    ]
    logger.info(f"Running: {' '.join(cmd)}")
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        logger.error(f"OpenMVG failed:\n{result.stdout}\n{result.stderr}")
        return None
    logger.info(f"OpenMVG reconstruction written to {recon_dir}")
    return recon_dir
