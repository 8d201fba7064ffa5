"""SE2-LoFTR, rotation-equivariant LoFTR (port of
``deep_image_matching_tpu/models/se2loftr.py``).

The C8 backbone (``E2_ResNetFPN_8_2`` of the ``loftr_ds_e2_dense_8rot``
configuration: regular fields [16, 24, 32] x 8 rotations = [128, 192, 256]
channels) runs in its e2cnn-exported form: plain convolutions whose filters
are the steerable ones expanded, BatchNorm folded, ReLU after the FPN's 3x3
convolutions (the standard backbone's LeakyReLU is not used), and a 3x3
regular -> trivial projection (``l3_triv``) on the coarse output. The
position encoding (``temp_bug_fix`` on, as in the 8rot configuration), the
transformer, the coarse matching and the fine refinement are LoFTR's
(``models/loftr.py``).

The published ``8rot.ckpt`` holds e2cnn modules: ``export_e2cnn_state_dict``
expands each R2Conv from the checkpoint's own basis coefficients and
``sampled_basis`` buffers (or its cached ``filter``) and repeats each
InnerBatchNorm's per-field statistics over the field's channels, in numpy,
without e2cnn; ``params_from_torch`` takes either form.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import loftr
from .loftr import _conv, _he_conv, _resnet_fpn

Params = Dict

N_ROT = 8
SE2_CHANNELS = [128, 192, 256]  # (128 // 8, 196 // 8, 256 // 8) * 8
TRIV_COARSE = 256  # layer3triv's trivial fields
TRIV_FINE = 128    # layer1_outconv2's trivial fields


# ---------------------------------------------------------------------------
# e2cnn checkpoint -> exported form (host numpy)
# ---------------------------------------------------------------------------

def _e2_layer_specs() -> Dict[str, tuple]:
    """(fields in, their size, fields out, their size, kernel) of each R2Conv
    of the 8-rotation backbone (initial_dim 128, block_dims [128, 196, 256],
    the same number of filters: regular fields [16, 24, 32])."""
    f1, f2, f3 = 16, 24, 32
    N = N_ROT
    specs = {
        "backbone.conv1": (1, 1, f1, N, 7),
        "backbone.layer3_outconv": (f3, N, f3, N, 1),
        "backbone.layer3triv": (f3, N, TRIV_COARSE, 1, 3),
        "backbone.layer2_outconv": (f2, N, f3, N, 1),
        "backbone.layer2_outconv2.0": (f3, N, f3, N, 3),
        "backbone.layer2_outconv2.3": (f3, N, f2, N, 3),
        "backbone.layer1_outconv": (f1, N, f2, N, 1),
        "backbone.layer1_outconv2.0": (f2, N, f2, N, 3),
        "backbone.layer1_outconv2.3": (f2, N, TRIV_FINE, 1, 3),
    }
    for stage, (fi, fo) in {1: (f1, f1), 2: (f1, f2), 3: (f2, f3)}.items():
        for b in range(2):
            ci = fi if b == 0 else fo
            specs[f"backbone.layer{stage}.{b}.conv1"] = (ci, N, fo, N, 3)
            specs[f"backbone.layer{stage}.{b}.conv2"] = (fo, N, fo, N, 3)
        if stage > 1:
            specs[f"backbone.layer{stage}.0.downsample.0"] = (fi, N, fo, N, 1)
    return specs


def _expand_r2conv(sd: Dict, prefix: str, spec: tuple) -> np.ndarray:
    """One R2Conv as a plain (out, in, k, k) filter: its cached ``filter``
    buffer where the checkpoint holds one, else its basis coefficients
    ``weights`` combined with its one ``sampled_basis`` buffer, channels
    field-major (e2cnn's FieldType layout)."""
    nf_in, s_in, nf_out, s_out, k = spec
    cached = sd.get(f"{prefix}.filter")
    if cached is not None:
        return np.asarray(cached, np.float32).reshape(nf_out * s_out, nf_in * s_in, k, k)
    w = np.asarray(sd[f"{prefix}.weights"], np.float32).reshape(-1)
    blocks = [v for key, v in sd.items()
              if key.startswith(f"{prefix}.basisexpansion") and key.endswith("sampled_basis")]
    if len(blocks) != 1:
        raise KeyError(f"{prefix}: expected 1 sampled_basis buffer, found {len(blocks)} "
                       "(non-uniform field types are not supported)")
    basis = np.asarray(blocks[0], np.float32)  # (dim, s_out, s_in, k * k)
    dim = basis.shape[0]
    if basis.shape[1:] != (s_out, s_in, k * k):
        raise ValueError(f"{prefix}: sampled_basis shape {basis.shape} does not match "
                         f"spec (*, {s_out}, {s_in}, {k * k})")
    if w.size // dim != nf_out * nf_in:
        raise ValueError(f"{prefix}: {w.size} coefficients / dim {dim} = {w.size // dim} "
                         f"pairs, expected {nf_out}*{nf_in}")
    block = np.einsum("oid,dabq->oiabq", w.reshape(nf_out, nf_in, dim), basis)
    return block.transpose(0, 2, 1, 3, 4).reshape(nf_out * s_out, nf_in * s_in, k, k)


def _bn_prefixes():
    out = ["backbone.bn1", "backbone.layer2_outconv2.1", "backbone.layer1_outconv2.1"]
    for stage in (1, 2, 3):
        for b in range(2):
            out += [f"backbone.layer{stage}.{b}.bn1", f"backbone.layer{stage}.{b}.bn2"]
        if stage > 1:
            out.append(f"backbone.layer{stage}.0.downsample.1")
    return out


def export_e2cnn_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """The published 8rot.ckpt (e2cnn modules) in the plain-convolution
    exported form, the numpy equivalent of e2cnn's ``model.export()``:
    R2Conv filters expanded, InnerBatchNorm statistics (one per field,
    shared by its rotation channels) repeated over each field; the
    transformer and matching modules pass through."""
    from ..convert import _np_state

    sd = _np_state(state_dict)
    out: Dict[str, np.ndarray] = {}
    for prefix, spec in _e2_layer_specs().items():
        out[f"{prefix}.weight"] = _expand_r2conv(sd, prefix, spec)
    for prefix in _bn_prefixes():
        for stat in ("weight", "bias", "running_mean", "running_var"):
            keys = [k for k in sd if k.startswith(f"{prefix}.") and k.endswith(f".{stat}")
                    and "batch_norm" in k]
            if len(keys) != 1:
                raise KeyError(f"{prefix}: expected 1 InnerBatchNorm '{stat}' buffer, "
                               f"found {keys}")
            out[f"{prefix}.{stat}"] = np.repeat(np.asarray(sd[keys[0]]), N_ROT)
    for k, v in sd.items():
        if not k.startswith("backbone."):
            out[k] = v
    return out


def _is_e2cnn_state_dict(sd) -> bool:
    return any(k.endswith(".weights") or "basisexpansion" in k or "batch_norm" in k
               for k in sd)


def params_from_torch(state_dict) -> Params:
    """SE2-LoFTR's tree from the published e2cnn checkpoint (expanded here)
    or from an already exported one."""
    sd = dict(state_dict)
    if _is_e2cnn_state_dict(sd):
        sd = export_e2cnn_state_dict(sd)
    return params_from_exported_torch(sd)


def params_from_exported_torch(state_dict) -> Params:
    """SE2-LoFTR's tree from an exported checkpoint (plain Conv2d /
    BatchNorm2d modules under the original names), BatchNorm folded in
    numpy f32 as the JAX package folds it."""
    from ..convert import (
        _LOFTR_FPN,
        _np_state,
        loftr_backbone_from_torch,
        loftr_transformer_from_torch,
    )

    sd = _np_state(state_dict)
    return {"backbone": loftr_backbone_from_torch(sd, list(_LOFTR_FPN)),
            **loftr_transformer_from_torch(sd)}


def init_params(generator: torch.Generator) -> Params:
    """Random weights at the 8rot shapes from ``generator``: LoFTR's
    transformer and fine stage, a backbone of the exported form's widths."""
    g = generator
    c1, c2, c3 = SE2_CHANNELS

    def block(ci, co, down=False):
        p = {"conv1": _he_conv(g, 3, ci, co), "conv2": _he_conv(g, 3, co, co)}
        if down:
            p["down"] = _he_conv(g, 1, ci, co)
        return p

    backbone = {
        "conv1": _he_conv(g, 7, 1, c1),
        "layer1": [block(c1, c1), block(c1, c1)],
        "layer2": [block(c1, c2, down=True), block(c2, c2)],
        "layer3": [block(c2, c3, down=True), block(c3, c3)],
        "l3_out": _he_conv(g, 1, c3, c3, False),
        "l3_triv": _he_conv(g, 3, c3, TRIV_COARSE, False),
        "l2_out": _he_conv(g, 1, c2, c3, False),
        "l2_out2a": _he_conv(g, 3, c3, c3),
        "l2_out2b": _he_conv(g, 3, c3, c2),
        "l1_out": _he_conv(g, 1, c1, c2, False),
        "l1_out2a": _he_conv(g, 3, c2, c2),
        "l1_out2b": _he_conv(g, 3, c2, TRIV_FINE),
    }
    rest = loftr.init_params(g)
    return {**rest, "backbone": backbone}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def backbone_forward(params: Params, images: torch.Tensor):
    """images (B, H, W, 1) -> (coarse (B, H/8, W/8, 256), fine (B, H/2,
    W/2, 128)): ReLU in the FPN and ``l3_triv`` on the coarse branch."""
    x3_out, x1_out = _resnet_fpn(params["backbone"], images, F.relu)
    return _conv(x3_out, params["backbone"]["l3_triv"]), x1_out


def match_pair(params: Params, images0: torch.Tensor, images1: torch.Tensor,
               max_matches: int = 2048, threshold: float = 0.2, compute_dtype=torch.float32,
               coarse_impl: str = "dense", temperature: float = 0.1) -> Dict[str, torch.Tensor]:
    """SE2-LoFTR on a batch of pairs: the SE2 backbone, then LoFTR's
    matching with ``temp_bug_fix`` on. At the defaults (float32, dense,
    temperature 0.1) this is the JAX package's ``match_pair_impl``."""
    return loftr.match_with_backbone(params, backbone_forward, images0, images1, max_matches,
                                     threshold, True, compute_dtype, coarse_impl, temperature)

