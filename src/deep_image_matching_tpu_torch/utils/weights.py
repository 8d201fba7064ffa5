"""Weight-resolution policy for learned models.

The reference never runs a learned model with random weights: checkpoints are
downloaded at runtime via torch.hub (e.g. the LightGlue loader in
``thirdparty/LightGlue/lightglue/lightglue.py:389-396``) and a download
failure is a hard error. This build is offline, so the equivalent policy is:
a missing checkpoint ABORTS with the expected-filename table, unless the user
explicitly opts into random-init execution with
``general: {allow_random_weights: true}`` in the config YAML or
``DIM_TPU_ALLOW_RANDOM_WEIGHTS=1`` in the environment. Silently matching with
random weights produces zero matches end-to-end and burns accelerator time.

Classical weight-free fallbacks (determinant-of-Hessian detection, identity
affine shape, gradient-moment orientation) are NOT random init — they are
valid algorithms with different quality — and are only logged loudly.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Sequence

logger = logging.getLogger("dim_tpu_torch")

# process-global override; None = unset -> consult the environment variable
_ALLOW: Optional[bool] = None


class MissingWeightsError(RuntimeError):
    """A learned model has no pretrained checkpoint and random-init execution
    was not explicitly allowed."""


def find_checkpoint(names: Sequence[str]) -> Optional[Path]:
    """The first of ``names`` found in DIM_TPU_WEIGHTS_DIR, then in
    ~/.cache/dim_tpu; None where there is none."""
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in names:
            if (base / name).exists():
                return base / name
    return None


def set_allow_random_weights(value: Optional[bool]) -> None:
    """Set the process-global policy (None restores env-var control)."""
    global _ALLOW
    _ALLOW = value


def random_weights_allowed() -> bool:
    if _ALLOW is not None:
        return _ALLOW
    return os.environ.get("DIM_TPU_ALLOW_RANDOM_WEIGHTS", "0").lower() in (
        "1",
        "true",
        "yes",
    )


class strict:
    """Context manager: force the strict policy, restoring on exit. Used to
    probe whether REAL weights exist for a model (loaders raise
    MissingWeightsError instead of silently falling back)."""

    def __enter__(self):
        global _ALLOW
        self._prev = _ALLOW
        _ALLOW = False
        return self

    def __exit__(self, *exc):
        global _ALLOW
        _ALLOW = self._prev
        return False


def missing_weights(model: str, filenames: Sequence[str], note: str = "") -> None:
    """Call at every checkpoint-miss site BEFORE falling back to random init.

    Raises :class:`MissingWeightsError` with the converter filename table
    unless random weights are allowed, in which case a loud warning is logged
    and the caller may proceed with its deterministic random init.
    """
    table = "\n".join(f"  - DIM_TPU_WEIGHTS_DIR/{n}  (or ~/.cache/dim_tpu/{n})"
                      for n in filenames)
    if random_weights_allowed():
        logger.warning(
            f"{model}: no pretrained weights found; running with RANDOM INIT "
            "(explicitly allowed). Matches will be meaningless."
        )
        return
    raise MissingWeightsError(
        f"No pretrained weights for {model}. Searched for:\n{table}\n"
        + (f"{note}\n" if note else "")
        + "Running a learned model with random weights produces garbage "
        "matches end-to-end. Download/convert the checkpoint into "
        "DIM_TPU_WEIGHTS_DIR, or set `general: {allow_random_weights: true}` "
        "(env DIM_TPU_ALLOW_RANDOM_WEIGHTS=1) to run anyway (development only)."
    )


def reject_cached_random(model: str, filenames: Sequence[str],
                         note: str = "") -> None:
    """Call when about to serve CACHED random-init params from a
    module-level cache: re-consults the policy so a strict() probe raises
    MissingWeightsError instead of silently receiving random params another
    caller cached under allow-random (the upright-probe leak). Unlike
    :func:`missing_weights`, serving cached params under allow-random stays
    silent — the first load already warned."""
    if random_weights_allowed():
        return
    missing_weights(model, filenames, note)


def classical_fallback(model: str, fallback: str) -> None:
    """Log (loudly) that a weight-free classical algorithm replaces a learned
    stage — valid output, different quality than the reference."""
    logger.warning(
        f"{model}: no learned weights found; using the weight-free fallback "
        f"({fallback}). Output is valid but quality differs from the "
        "pretrained reference stage."
    )
