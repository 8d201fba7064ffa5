"""SuperGlue matcher (PyTorch port of ``deep_image_matching_tpu/models/superglue.py``).

``SuperGlue`` is an ``nn.Module`` whose parameters carry the torch
state-dict keys the JAX package converts from (``kenc.encoder.*``,
``gnn.layers.{i}.attn.proj.{0,1,2}``, ``.attn.merge``, ``.mlp.{0,1,3}``,
``final_proj``, ``bin_score``): 1x1 ``Conv1d`` layers and inference
``BatchNorm1d``. The keypoint encoder has the JAX package's channels
(3, 32, 64, 128, 256). ``forward`` is the JAX package's ``forward_impl`` on
batched pairs with fixed keypoint capacity and validity masks:

- keypoint encoder, 9 (self, cross) attentional propagation blocks with 4
  heads interleaved across channels, final projection;
- entropic optimal transport with a learned dustbin score and masked
  marginals (``masked_log_optimal_transport``), 100 log-space Sinkhorn
  iterations by default;
- mutual-argmax filtering (``_filter``).

BatchNorm is folded into the preceding convolution once, by
``SuperGlue.folded_params``, as the JAX package folds it at conversion; the
matcher keeps the folded parameters and hands them to every ``forward``.
Attention, the
propagation MLP and the Sinkhorn iterations go through the kernel wrappers
of ``ops/`` (on the GPU: the attention kernel, the FFN kernel in ``relu``
mode and the Sinkhorn kernel; on the CPU their plain versions), the JAX
package's ``attn_impl="flash"`` route.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import fused_attention
from ..ops.ffn import ffn_fused, ffn_weights_tf32
from ..ops.sinkhorn import sinkhorn_fused
from ..utils.device import upload_blocking

logger = logging.getLogger("dim_tpu_torch")

_NEG = -1e30
KENC_CHANNELS = (3, 32, 64, 128, 256)


def _mlp(channels) -> nn.Sequential:
    """Conv1d -> BatchNorm1d -> ReLU per layer, the last layer a bare conv
    (the torch SuperGlue ``MLP``)."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1, bias=True))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class _KeypointEncoder(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.encoder = _mlp(channels)


class _MultiHeadedAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.merge = nn.Conv1d(dim, dim, kernel_size=1)
        self.proj = nn.ModuleList([nn.Conv1d(dim, dim, kernel_size=1) for _ in range(3)])


class _AttentionalPropagation(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.attn = _MultiHeadedAttention(dim)
        self.mlp = _mlp((2 * dim, 2 * dim, dim))


class _GNN(nn.Module):
    def __init__(self, dim: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([_AttentionalPropagation(dim) for _ in range(n_layers)])


class SuperGlue(nn.Module):
    def __init__(self, n_blocks: int = 9, dim: int = 256, num_heads: int = 4,
                 kenc_channels=KENC_CHANNELS):
        super().__init__()
        if kenc_channels[-1] != dim:
            raise ValueError(f"keypoint encoder ends at {kenc_channels[-1]}, width is {dim}")
        self.num_heads = num_heads
        self.kenc = _KeypointEncoder(tuple(kenc_channels))
        self.gnn = _GNN(dim, 2 * n_blocks)  # alternating self, cross
        self.final_proj = nn.Conv1d(dim, dim, kernel_size=1)
        self.register_parameter("bin_score", nn.Parameter(torch.tensor(1.0)))

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "SuperGlue":
        """Conv weights ~ N(0, 1/fan_in), zero biases, identity BatchNorm
        (the folded weights equal the conv weights), bin score 1: the JAX
        package's ``init_params`` recipe, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / m.weight.shape[1] ** 0.5)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - m.eps)
        self.bin_score.fill_(1.0)
        return self

    def folded_params(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Every 1x1 conv as an ``nn.Linear`` (out, in) weight and bias in
        ``dtype``, each BatchNorm folded into the conv before it in f32; in
        float32 also each propagation MLP's weights split into TF32 halves
        (``{g}.mlp.0.weight_tf32``, ``{g}.mlp.3.weight_tf32``), which the
        FFN kernel's float32 form reads."""
        sd = self.state_dict()
        out: Dict[str, torch.Tensor] = {}

        def conv(prefix, bn=None):
            w = sd[f"{prefix}.weight"][:, :, 0].float()
            b = sd[f"{prefix}.bias"].float()
            if bn is not None:
                s = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + 1e-5)
                w = w * s[:, None]
                b = (b - sd[f"{bn}.running_mean"].float()) * s + sd[f"{bn}.bias"].float()
            out[f"{prefix}.weight"] = w.to(dtype)
            out[f"{prefix}.bias"] = b.to(dtype)

        n_enc = len(self.kenc.encoder) // 3 + 1
        for i in range(n_enc):
            conv(f"kenc.encoder.{3 * i}", f"kenc.encoder.{3 * i + 1}" if i < n_enc - 1 else None)
        for i in range(len(self.gnn.layers)):
            g = f"gnn.layers.{i}"
            for k in range(3):
                conv(f"{g}.attn.proj.{k}")
            conv(f"{g}.attn.merge")
            conv(f"{g}.mlp.0", f"{g}.mlp.1")
            conv(f"{g}.mlp.3")
        conv("final_proj")
        out["bin_score"] = sd["bin_score"].float()
        if dtype == torch.float32:
            # the TF32 halves the FFN kernel's float32 form reads, made once
            for i in range(len(self.gnn.layers)):
                g = f"gnn.layers.{i}.mlp"
                out[f"{g}.0.weight_tf32"], out[f"{g}.3.weight_tf32"] = ffn_weights_tf32(
                    out[f"{g}.0.weight"], out[f"{g}.3.weight"])
        return out


# ---------------------------------------------------------------------------
# Building blocks (JAX layouts: (B, N, D) tokens)
# ---------------------------------------------------------------------------

def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """kpts (B, N, 2); size (B, 2) as (w, h): centre at size / 2, scale by
    0.7 max(size)."""
    size = size.float()
    center = size / 2.0
    scaling = size.max(dim=-1, keepdim=True).values * 0.7
    return (kpts - center[:, None, :]) / scaling[:, None, :]


def _lin(x, p, prefix):
    return F.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def _kenc(p, kpts_n, scores, n_layers: int):
    x = torch.cat([kpts_n, scores[..., None]], dim=-1)
    for i in range(n_layers):
        x = _lin(x, p, f"kenc.encoder.{3 * i}")
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _mha(x, source, q_mask, kv_mask, p, g, num_heads):
    """Queries of x attend to source. Channels are viewed as (head_dim,
    heads): heads are interleaved across channels."""
    B, Nq, D = x.shape
    hd = D // num_heads

    def heads(t):
        return t.reshape(B, -1, hd, num_heads).permute(0, 3, 1, 2).contiguous()

    q = heads(_lin(x, p, f"{g}.attn.proj.0"))
    k = heads(_lin(source, p, f"{g}.attn.proj.1"))
    v = heads(_lin(source, p, f"{g}.attn.proj.2"))
    out = fused_attention(q, k, v, q_mask, kv_mask, hd ** -0.5)
    out = out.to(x.dtype).permute(0, 2, 3, 1).reshape(B, Nq, D)
    return _lin(out, p, f"{g}.attn.merge")


def _prop(x, source, q_mask, kv_mask, p, g, num_heads):
    """x + MLP([x | message]) through the FFN kernel's relu mode."""
    msg = _mha(x, source, q_mask, kv_mask, p, g, num_heads)
    split = None
    if f"{g}.mlp.0.weight_tf32" in p:  # float32: the weights' TF32 halves
        split = (p[f"{g}.mlp.0.weight_tf32"], p[f"{g}.mlp.3.weight_tf32"])
    return ffn_fused(x, msg, p[f"{g}.mlp.0.weight"], p[f"{g}.mlp.0.bias"], None, None,
                     p[f"{g}.mlp.3.weight"], p[f"{g}.mlp.3.bias"], mode="relu", split=split)


def masked_log_optimal_transport(scores, mask0, mask1, alpha, iters: int) -> torch.Tensor:
    """Entropic OT in log space with dustbins and masked marginals: invalid
    rows and columns carry no transport mass and the marginals use the true
    keypoint counts. scores (B, M, N) f32 -> (B, M+1, N+1) log-coupling."""
    B, M, N = scores.shape
    ms = mask0.sum(-1).float()
    ns = mask1.sum(-1).float()
    both = mask0[:, :, None] & mask1[:, None, :]
    neg = upload_blocking(_NEG, scores.device, scores.dtype)
    alpha = alpha.float()

    bins0 = torch.where(mask0, alpha, neg)[:, :, None]
    bins1 = torch.where(mask1, alpha, neg)[:, None, :]
    z = torch.where(both, scores, neg)
    couplings = torch.cat([
        torch.cat([z, bins0], dim=2),
        torch.cat([bins1, alpha.expand(B, 1, 1)], dim=2),
    ], dim=1)

    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], neg), (torch.log(ns) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], neg), (torch.log(ms) + norm)[:, None]], 1)
    u, v = sinkhorn_fused(couplings, log_mu, log_nu, iters)
    return couplings + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def _filter(scores, mask0, mask1, threshold: float):
    """Mutual argmax + threshold over the OT matrix without its dustbins.
    Returns matches0 (B, M) int32 (-1 = none), mscores0, valid0."""
    inner = scores[:, :-1, :-1]
    inner = torch.where(mask0[:, :, None] & mask1[:, None, :], inner,
                        upload_blocking(_NEG, inner.device, inner.dtype))
    max0, m0 = inner.max(dim=2)
    m1 = inner.argmax(dim=1)
    idx = torch.arange(m0.shape[1], device=m0.device)[None]
    mutual0 = idx == torch.gather(m1, 1, m0)
    mscores0 = torch.where(mutual0, torch.exp(max0),
                           upload_blocking(0.0, max0.device, max0.dtype))
    valid0 = mutual0 & (mscores0 > threshold) & mask0
    matches0 = torch.where(valid0, m0, upload_blocking(-1, m0.device, m0.dtype)).int()
    return matches0, mscores0, valid0


@torch.no_grad()
def forward(
    model: SuperGlue,
    kpts0: torch.Tensor, kpts1: torch.Tensor,        # (B, M/N, 2) pixels
    scores0: torch.Tensor, scores1: torch.Tensor,    # (B, M/N) detection scores
    desc0: torch.Tensor, desc1: torch.Tensor,        # (B, M/N, 256)
    mask0: torch.Tensor, mask1: torch.Tensor,        # (B, M/N) bool
    size0: torch.Tensor, size1: torch.Tensor,        # (B, 2) (w, h)
    sinkhorn_iterations: int = 100,
    match_threshold: float = 0.2,
    compute_dtype: torch.dtype = torch.float32,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Batched SuperGlue matching (the JAX package's ``forward_impl``). The
    transformer runs in ``compute_dtype`` (f32 accumulation); the scores and
    the optimal transport stay f32. ``params`` is
    ``model.folded_params(compute_dtype)`` on the model's device, folded
    here if not given. Returns matches0 (B, M) int32, matching_scores0 and
    valid0."""
    num_heads = model.num_heads
    mask0, mask1 = mask0.bool(), mask1.bool()
    p = model.folded_params(compute_dtype) if params is None else params
    desc0 = desc0.to(compute_dtype)
    desc1 = desc1.to(compute_dtype)
    n_enc = len(model.kenc.encoder) // 3 + 1
    kn0 = normalize_keypoints(kpts0, size0).to(compute_dtype)
    kn1 = normalize_keypoints(kpts1, size1).to(compute_dtype)
    desc0 = desc0 + _kenc(p, kn0, scores0.to(compute_dtype), n_enc)
    desc1 = desc1 + _kenc(p, kn1, scores1.to(compute_dtype), n_enc)

    for blk in range(len(model.gnn.layers) // 2):
        s, c = f"gnn.layers.{2 * blk}", f"gnn.layers.{2 * blk + 1}"
        desc0 = _prop(desc0, desc0, mask0, mask0, p, s, num_heads)
        desc1 = _prop(desc1, desc1, mask1, mask1, p, s, num_heads)
        desc0, desc1 = (_prop(desc0, desc1, mask0, mask1, p, c, num_heads),
                        _prop(desc1, desc0, mask1, mask0, p, c, num_heads))

    md0 = _lin(desc0, p, "final_proj")
    md1 = _lin(desc1, p, "final_proj")
    # bf16 products are exact in f32: the JAX package's f32-accumulated einsum
    sim = torch.einsum("bmd,bnd->bmn", md0.float(), md1.float()) / md0.shape[-1] ** 0.5
    ot = masked_log_optimal_transport(sim, mask0, mask1, p["bin_score"], sinkhorn_iterations)
    matches0, mscores0, valid0 = _filter(ot, mask0, mask1, match_threshold)
    return {"matches0": matches0, "matching_scores0": mscores0, "valid0": valid0}


# ---------------------------------------------------------------------------
# Default weights
# ---------------------------------------------------------------------------

_DEFAULT_MODELS: Dict[str, SuperGlue] = {}
_DEFAULT_RANDOM: set = set()


def load_default_model(weights: str = "outdoor") -> SuperGlue:
    """``superglue_{weights}.pth`` from DIM_TPU_WEIGHTS_DIR or
    ~/.cache/dim_tpu if it exists, else random weights from a seeded
    generator, subject to the weights policy. Cached random weights
    re-consult the policy."""
    from ..utils.weights import missing_weights, reject_cached_random

    names = [f"superglue_{weights}.pth"]
    if weights in _DEFAULT_MODELS:
        if weights in _DEFAULT_RANDOM:
            reject_cached_random(f"SuperGlue ({weights})", names)
        return _DEFAULT_MODELS[weights]
    model = SuperGlue()
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        cand = base / names[0]
        if cand.exists():
            model.load_state_dict(torch.load(str(cand), map_location="cpu"))
            logger.info(f"Loaded SuperGlue weights from {cand}")
            _DEFAULT_MODELS[weights] = model.eval()
            return _DEFAULT_MODELS[weights]
    missing_weights(f"SuperGlue ({weights})", names)
    _DEFAULT_MODELS[weights] = model.reset_random(torch.Generator().manual_seed(7)).eval()
    _DEFAULT_RANDOM.add(weights)
    return _DEFAULT_MODELS[weights]
