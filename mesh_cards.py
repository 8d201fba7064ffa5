"""``chip_smoke.py``'s device-mesh phase over several cards, one slot each.

    python3 mesh_cards.py [N]

Builds the kernels, writes the main paths' projects (``chip_smoke._main_setup``)
and runs ``chip_smoke.phase_mesh`` with the mesh set to the first N visible
CUDA devices (all of them by default): each row of ``chip_smoke.MESH_RUNS``
on one device (``cuda:0``) and on the N-card mesh, their files bit-equal,
then the LoFTR step split over the cards. Unlike ``cuda:0`` named twice,
this copies the store and the matchers' weights to the other cards and
launches the kernels there. Exits non-zero on any failure; the last line is
the launches per row.
"""

from __future__ import annotations

import json
import sys

import chip_smoke


def main() -> None:
    sys.path.insert(0, str(chip_smoke.SRC))
    import torch

    card = chip_smoke.phase_environment()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if n < 2 or n > torch.cuda.device_count():
        chip_smoke._fail(f"{n} cards asked for, {torch.cuda.device_count()} visible")
    chip_smoke.MESH_DEVICES = tuple(f"cuda:{i}" for i in range(n))
    print(f"[mesh] devices {chip_smoke.MESH_DEVICES}", flush=True)
    chip_smoke.phase_build()
    chip_smoke._main_setup()
    launches = chip_smoke.phase_mesh(card)
    print(json.dumps(launches), flush=True)


if __name__ == "__main__":
    main()
