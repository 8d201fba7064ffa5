"""SuperGlue (Sarlin et al., CVPR 2020), as ``magicleap/SuperGluePretrainedNetwork``
``models/superglue.py`` computes it for one pair: keypoint encoder,
alternating self and cross attentional propagation with 4 heads interleaved
across channels, final projection, log-space Sinkhorn with a learned
dustbin, mutual argmax.

Parameters carry that file's state-dict keys: 1x1 ``Conv1d`` weights
(out, in, 1), ``BatchNorm1d`` in inference (``kenc.encoder.{i}``,
``gnn.layers.{i}.attn.proj.{0,1,2}`` / ``.attn.merge`` / ``.mlp.{0,1,3}``,
``final_proj``, ``bin_score``); the benchmark's seeded checkpoint is
``FILE``, drawn by ``std`` and ``fixed``. Departure: the keypoint encoder has the
channels (3, 32, 64, 128, 256), the layout the repository's SuperGlue
loads; the published file appends ``descriptor_dim`` to
``keypoint_encoder`` and so has a fifth 256 -> 256 layer, whose checkpoint
entries the repository's loader refuses.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .lowp import exact

KENC = (3, 32, 64, 128, 256)
BN_EPS = 1e-5


def shapes(n_blocks: int = 9, dim: int = 256) -> Dict[str, tuple]:
    """Every entry's shape under its key; BatchNorm entries are marked by
    their names (``running_mean``, ``running_var``, ``num_batches_tracked``)."""
    out: Dict[str, tuple] = {}

    def conv(name, n_in, n_out):
        out[f"{name}.weight"] = (n_out, n_in, 1)
        out[f"{name}.bias"] = (n_out,)

    def bn(name, n):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{k}"] = (n,)
        out[f"{name}.num_batches_tracked"] = ()

    for i in range(len(KENC) - 1):
        conv(f"kenc.encoder.{3 * i}", KENC[i], KENC[i + 1])
        if i < len(KENC) - 2:
            bn(f"kenc.encoder.{3 * i + 1}", KENC[i + 1])
    for i in range(2 * n_blocks):
        g = f"gnn.layers.{i}"
        conv(f"{g}.attn.merge", dim, dim)
        for k in range(3):
            conv(f"{g}.attn.proj.{k}", dim, dim)
        conv(f"{g}.mlp.0", 2 * dim, 2 * dim)
        bn(f"{g}.mlp.1", 2 * dim)
        conv(f"{g}.mlp.3", 2 * dim, dim)
    conv("final_proj", dim, dim)
    out["bin_score"] = ()
    return out


FILE = "superglue_outdoor.pth"


def std(name: str, shape: tuple) -> float:
    """The seeded checkpoint's normal standard deviation of one entry, the
    port's ``reset_random`` recipe: convolution weights N(0, 1/fan_in); 0
    where the entry is not drawn (``fixed``)."""
    return shape[1] ** -0.5 if name.endswith(".weight") and len(shape) == 3 else 0.0


def fixed(name: str, shape: tuple) -> torch.Tensor:
    """An entry that is not drawn: identity BatchNorm (unit gain and
    variance, zero mean and bias), zero biases, the dustbin score 1."""
    if name.endswith("running_var") or name == "bin_score":
        return torch.ones(shape)
    if name.endswith("num_batches_tracked"):
        return torch.zeros(shape, dtype=torch.long)
    if name.endswith(".weight") and len(shape) == 1:
        return torch.ones(shape)
    return torch.zeros(shape)


def _conv(sd, name, x, rnd):
    """A 1x1 convolution on (C, N) channels-first points."""
    w = sd[f"{name}.weight"][:, :, 0]
    return rnd(w) @ rnd(x) + sd[f"{name}.bias"][:, None]


def _bn(sd, name, x):
    mean, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
    return ((x - mean[:, None]) / torch.sqrt(var[:, None] + BN_EPS)
            * sd[f"{name}.weight"][:, None] + sd[f"{name}.bias"][:, None])


def _mlp(sd, prefix, x, n_convs, rnd):
    for i in range(n_convs):
        x = _conv(sd, f"{prefix}.{3 * i}", x, rnd)
        if i < n_convs - 1:
            x = F.relu(_bn(sd, f"{prefix}.{3 * i + 1}", x))
    return x


def _attention_prop(sd, g, x, src, heads, rnd):
    """x + MLP([x | attention(x, src, src)]) on (D, N) channels."""
    dim = x.shape[0]
    hd = dim // heads
    q, k, v = (_conv(sd, f"{g}.attn.proj.{i}", t, rnd).view(hd, heads, -1)
               for i, t in enumerate((x, src, src)))
    scores = torch.einsum("dhn,dhm->hnm", rnd(q), rnd(k)) / hd ** 0.5
    msg = torch.einsum("hnm,dhm->dhn", rnd(scores.softmax(-1)), rnd(v)).reshape(dim, -1)
    msg = _conv(sd, f"{g}.attn.merge", msg, rnd)
    return x + _mlp(sd, f"{g}.mlp", torch.cat([x, msg], 0), 2, rnd)


def log_optimal_transport(scores, alpha, iters: int):
    """The published ``log_optimal_transport`` for one (M, N) pair."""
    m, n = scores.shape
    one = scores.new_tensor(1.0)
    ms, ns = m * one, n * one
    bins0 = alpha.expand(m, 1)
    bins1 = alpha.expand(1, n)
    couplings = torch.cat([torch.cat([scores, bins0], 1),
                           torch.cat([bins1, alpha.expand(1, 1)], 1)], 0)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], 1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], 0)
    return couplings + u[:, None] + v[None, :] - norm


@torch.no_grad()
def match(sd: Dict[str, torch.Tensor], kpts0, kpts1, scores0, scores1, desc0, desc1,
          size0, size1, n_blocks: int = 9, heads: int = 4, sinkhorn_iterations: int = 100,
          match_threshold: float = 0.0, rnd: Callable = exact) -> Dict[str, object]:
    """One pair: keypoints (M, 2) / (N, 2) in pixels, detection scores,
    descriptors (M, D) / (N, D), sizes (w, h). Returns ``scores`` (M, N),
    the optimal transport's log coupling without its dustbins, and
    ``matches`` (K, 2), mutual argmaxes above the threshold."""
    def norm_kpts(k, size):
        size = size.float()
        return (k - size / 2) / (size.max() * 0.7)

    n_enc = len(KENC) - 1
    d0 = desc0.float().T + _mlp(sd, "kenc.encoder", torch.cat(
        [norm_kpts(kpts0, size0).T, scores0.float()[None]], 0), n_enc, rnd)
    d1 = desc1.float().T + _mlp(sd, "kenc.encoder", torch.cat(
        [norm_kpts(kpts1, size1).T, scores1.float()[None]], 0), n_enc, rnd)
    for i in range(2 * n_blocks):
        g = f"gnn.layers.{i}"
        src0, src1 = (d1, d0) if i % 2 else (d0, d1)
        d0, d1 = (_attention_prop(sd, g, d0, src0, heads, rnd),
                  _attention_prop(sd, g, d1, src1, heads, rnd))
    m0 = _conv(sd, "final_proj", d0, rnd)
    m1 = _conv(sd, "final_proj", d1, rnd)
    sim = (rnd(m0).T @ rnd(m1)) / m0.shape[0] ** 0.5
    ot = log_optimal_transport(sim, sd["bin_score"].float(), sinkhorn_iterations)[:-1, :-1]
    best0, arg0 = ot.max(1)
    arg1 = ot.argmax(0)
    mutual = arg1[arg0] == torch.arange(len(arg0), device=ot.device)
    ok = mutual & (best0.exp() > match_threshold)
    idx = torch.arange(len(arg0), device=ot.device)
    return {"scores": ot, "matches": torch.stack([idx[ok], arg0[ok]], -1)}



def match_pair(sd: Dict[str, torch.Tensor], conf: dict, f0: dict, f1: dict, size0, size1,
               rnd: Callable = exact) -> Dict[str, object]:
    """``match`` on two images' features (``keypoints``, ``scores``,
    ``descriptors``) with the configuration's matcher options ``conf``."""
    return match(sd, f0["keypoints"], f1["keypoints"], f0["scores"], f1["scores"],
                 f0["descriptors"], f1["descriptors"], size0, size1,
                 sinkhorn_iterations=int(conf["sinkhorn_iterations"]),
                 match_threshold=float(conf["match_threshold"]), rnd=rnd)
