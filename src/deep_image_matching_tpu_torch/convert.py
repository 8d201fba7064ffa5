"""Weights carried across from the JAX package's parameter pytrees.

``superpoint_params_from_jax`` and ``lightglue_params_from_jax`` turn the
JAX package's parameters (any nesting of dicts whose leaves convert with
``np.asarray``) into torch state dicts with the original key names, the
inverse of the JAX package's ``params_from_torch``:

- convolution kernels HWIO -> OIHW;
- dense kernels stored for ``x @ W`` (in, out) -> ``nn.Linear`` (out, in);
- LightGlue's stacked layer axis -> ``transformers.{i}.*``,
  ``log_assignment.{i}.*`` and ``token_confidence.{i}.*``; the last layer's
  token head is padding in the JAX tree (its loop exits by the bound) and
  has no torch counterpart, so it is dropped;
- the fused qkv projection keeps its (heads, head_dim, 3) output order,
  which both packages unpack the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.superpoint import _CONV_LAYERS

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def superpoint_params_from_jax(params) -> StateDict:
    sd: StateDict = {}
    for name, _, _, _ in _CONV_LAYERS:
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["w"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(params[name]["b"])
    return sd


def lightglue_params_from_jax(params) -> StateDict:
    sd: StateDict = {"posenc.Wr.weight": _t(np.asarray(params["posenc"]["wr"]).T)}

    def lin(prefix, p, i=None):
        w = np.asarray(p["w"])
        b = None if "b" not in p else np.asarray(p["b"])
        if i is not None:
            w = w[i]
            b = None if b is None else b[i]
        sd[f"{prefix}.weight"] = _t(w.T)
        if b is not None:
            sd[f"{prefix}.bias"] = _t(b)

    if "input_proj" in params:
        lin("input_proj", params["input_proj"])
    layers = params["layers"]
    n_layers = np.asarray(layers["self"]["qkv"]["w"]).shape[0]
    for i in range(n_layers):
        t = f"transformers.{i}"
        s, c = layers["self"], layers["cross"]
        lin(f"{t}.self_attn.Wqkv", s["qkv"], i)
        lin(f"{t}.self_attn.out_proj", s["out"], i)
        lin(f"{t}.cross_attn.to_qk", c["qk"], i)
        lin(f"{t}.cross_attn.to_v", c["v"], i)
        lin(f"{t}.cross_attn.to_out", c["out"], i)
        for blk, p in (("self_attn", s), ("cross_attn", c)):
            lin(f"{t}.{blk}.ffn.0", p["ffn1"], i)
            sd[f"{t}.{blk}.ffn.1.weight"] = _t(np.asarray(p["ln"]["g"])[i])
            sd[f"{t}.{blk}.ffn.1.bias"] = _t(np.asarray(p["ln"]["b"])[i])
            lin(f"{t}.{blk}.ffn.3", p["ffn2"], i)
        lin(f"log_assignment.{i}.final_proj", layers["assign"]["final"], i)
        lin(f"log_assignment.{i}.matchability", layers["assign"]["match"], i)
        if i < n_layers - 1:
            lin(f"token_confidence.{i}.token.0", layers["token"], i)
    return sd
