"""Faults planted in the timed path, for the check that ``correct`` comes
out false: a transformer step that returns its state unchanged, half of
each match batch left out, a mesh whose gather drops a slot, and answers
altered where they are written (raw matches, verified matches,
keypoints). Each takes a ``pytest.MonkeyPatch``.

    python3 portbench/faults.py --fault <name> --workload <cell> --seed <n> --seconds <s>

runs one whole run of a cell on the card with the fault planted, for the
fault's reading at the cell's own size (PERF.md); the CPU tests plant them
in runs cut to a small size.
"""

import sys

import numpy as np


def _identity_blocks(monkeypatch):
    """A transformer step that returns its state unchanged."""
    from deep_image_matching_tpu_torch.models import lightglue

    monkeypatch.setattr(lightglue, "_self_block", lambda x, *a, **k: x)
    monkeypatch.setattr(lightglue, "_cross_block", lambda x0, x1, *a, **k: (x0, x1))


def _half_batch(monkeypatch):
    """Half of each match batch left out (its rows reported unmatched)."""
    from deep_image_matching_tpu_torch.matchers import lightglue

    orig = lightglue.LightGlueMatcher._match_batch_arrays

    def half(self, b0, b1):
        matches0, valid = orig(self, b0, b1)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return matches0, valid

    monkeypatch.setattr(lightglue.LightGlueMatcher, "_match_batch_arrays", half)


def _no_exchange(monkeypatch):
    """A mesh of two slots whose gather drops the second slot's rows and
    repeats the first slot's in their place."""
    import torch

    from deep_image_matching_tpu_torch.parallel import mesh

    cpu = torch.device("cpu")
    monkeypatch.setattr(mesh, "_DEFAULT_MESH", mesh.MeshRunner([cpu, cpu]))

    def gather(parts, n, device):
        return torch.cat([parts[0].to(device)] * len(parts))[:n]

    monkeypatch.setattr(mesh.MeshRunner, "gather", staticmethod(gather))


def _altered_raw(monkeypatch):
    """Each raw match's second index moved to the next keypoint where it
    is written."""
    from deep_image_matching_tpu_torch.io import writer

    orig = writer.MatchWriter.save_raw

    def save_raw(self, a, b, m):
        m = np.asarray(m).copy()
        if len(m):
            m[:, 1] = (m[:, 1] + 1) % (m[:, 1].max() + 1)
        return orig(self, a, b, m)

    monkeypatch.setattr(writer.MatchWriter, "save_raw", save_raw)


def _altered_verified(monkeypatch):
    """Half of each pair's verified matches dropped where they are written."""
    from deep_image_matching_tpu_torch.io import writer

    orig = writer.MatchWriter.save_verified
    monkeypatch.setattr(writer.MatchWriter, "save_verified",
                        lambda self, a, b, m: orig(self, a, b, np.asarray(m)[::2]))


def _altered_features(monkeypatch):
    """Every keypoint written one pixel to the right, in every module of the
    port that writes features."""
    import sys

    from deep_image_matching_tpu_torch.io import h5

    orig = h5.write_features

    def write_features(fd, name, keypoints, *a, **k):
        return orig(fd, name, np.asarray(keypoints) + np.float32([1, 0]), *a, **k)

    for name, mod in list(sys.modules.items()):
        if name.startswith("deep_image_matching_tpu_torch") and \
                getattr(mod, "write_features", None) is orig:
            monkeypatch.setattr(mod, "write_features", write_features)


FAULTS = {"state_unchanged": _identity_blocks, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "raw_altered": _altered_raw,
          "verified_altered": _altered_verified, "features_altered": _altered_features}


def main(argv=None) -> int:
    import argparse

    import pytest

    p = argparse.ArgumentParser()
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    a, rest = p.parse_known_args(argv)
    import run

    sys.path.insert(0, str(run.CHECKOUT / "src"))
    mp = pytest.MonkeyPatch()
    try:
        FAULTS[a.fault](mp)
        return run.run(rest)
    finally:
        mp.undo()


if __name__ == "__main__":
    sys.exit(main())
