"""Seeded checkpoints, made on the device from ``--seed`` in one draw per
file and saved under the published state-dict keys, where the program's
normal loading path finds them (``DIM_TPU_WEIGHTS_DIR``). The reference
reads the same files.

The configuration names its models under ``reference`` (its extractor and
its matcher); each is ``portbench/reference/<model>.py``, which gives the
checkpoint's file name (``FILE``), every entry's shape (``shapes()``) and
the recipe: ``std(name, shape)``, the standard deviation of an entry drawn
from a normal, 0 for one that is not drawn, whose value ``fixed(name,
shape)`` gives.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List

import torch

from harness import plugins


def models(config: dict) -> List[str]:
    """The configuration's reference models, extractor first."""
    ref = config["reference"]
    return [ref["extractor"], ref["matcher"]]


def state_dict(model: str, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One model's seeded state dict on the CPU, drawn on ``device``."""
    ref = plugins.reference(model)
    shapes = ref.shapes()
    drawn = [(k, s) for k, s in shapes.items() if ref.std(k, s) > 0]
    total = sum(math.prod(s) for _, s in drawn)
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        std = ref.std(k, s)
        if std > 0:
            n = math.prod(s)
            out[k] = (noise[at:at + n].view(s) * std).cpu()
            at += n
        else:
            out[k] = ref.fixed(k, s)
    return out


def write(wdir: Path, models, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Write the checkpoints of ``models`` for ``seed`` into ``wdir``;
    returns the state dicts by model."""
    wdir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    out = {}
    for m in models:
        out[m] = state_dict(m, gen, device)
        torch.save(out[m], wdir / plugins.reference(m).FILE)
    return out
