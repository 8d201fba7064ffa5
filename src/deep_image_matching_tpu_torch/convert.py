"""Weights carried across from the JAX package's parameter pytrees.

``superpoint_params_from_jax``, ``lightglue_params_from_jax`` and
``superglue_params_from_jax`` turn the JAX package's parameters (any nesting of dicts whose leaves convert with
``np.asarray``) into torch state dicts with the original key names, the
inverse of the JAX package's ``params_from_torch``:

- convolution kernels HWIO -> OIHW;
- dense kernels stored for ``x @ W`` (in, out) -> ``nn.Linear`` (out, in);
- LightGlue's stacked layer axis -> ``transformers.{i}.*``,
  ``log_assignment.{i}.*`` and ``token_confidence.{i}.*``; the last layer's
  token head is padding in the JAX tree (its loop exits by the bound) and
  has no torch counterpart, so it is dropped;
- the fused qkv projection keeps its (heads, head_dim, 3) output order,
  which both packages unpack the same way;
- SuperGlue's dense layers -> 1x1 ``Conv1d`` (out, in, 1) weights. The JAX
  package holds BatchNorm folded into the convolutions, so the folded
  weights are written with an identity BatchNorm (weight 1, bias 0, mean 0,
  variance 1 - eps), which folds back to the same weights.

ALIKED keeps its folded parameters as nested dicts of tensors, as the JAX
package does: ``aliked_params_from_jax`` turns the JAX package's tree into
the port's (convolutions HWIO -> OIHW, everything else as it is).

RoMa (with its VGG19 pyramid and DINOv2) keeps its parameters as nested
dicts of tensors rather than a module: ``roma_params_from_jax`` carries the
JAX package's tree over (convolutions HWIO -> OIHW, dense (in, out) ->
(out, in), DINOv2's stacked blocks -> a list), and ``roma_params_from_torch``
/ ``dinov2_params_from_torch`` read the reference checkpoints
(``roma_outdoor.pth``, ``dinov2_vitl14_pretrain.pth``), folding each
BatchNorm into the convolution before it once, as the JAX package's
``params_from_torch`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

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


_BN_EPS = 1e-5


def superglue_params_from_jax(params) -> StateDict:
    sd: StateDict = {}

    def conv(prefix, p, i=None):
        w = np.asarray(p["w"])
        b = np.asarray(p["b"])
        if i is not None:
            w, b = w[i], b[i]
        sd[f"{prefix}.weight"] = _t(w.T[:, :, None])
        sd[f"{prefix}.bias"] = _t(b)

    def identity_bn(prefix, n):
        sd[f"{prefix}.weight"] = torch.ones(n)
        sd[f"{prefix}.bias"] = torch.zeros(n)
        sd[f"{prefix}.running_mean"] = torch.zeros(n)
        sd[f"{prefix}.running_var"] = torch.full((n,), 1.0 - _BN_EPS)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    kenc = params["kenc"]
    for i, p in enumerate(kenc):
        conv(f"kenc.encoder.{3 * i}", p)
        if i < len(kenc) - 1:
            identity_bn(f"kenc.encoder.{3 * i + 1}", np.asarray(p["b"]).shape[-1])
    blocks = params["blocks"]
    n_blocks = np.asarray(blocks["self"]["q"]["w"]).shape[0]
    for blk in range(n_blocks):
        for name, li in (("self", 2 * blk), ("cross", 2 * blk + 1)):
            g, p = f"gnn.layers.{li}", blocks[name]
            for k, key in enumerate(("q", "k", "v")):
                conv(f"{g}.attn.proj.{k}", p[key], blk)
            conv(f"{g}.attn.merge", p["merge"], blk)
            conv(f"{g}.mlp.0", p["mlp1"], blk)
            identity_bn(f"{g}.mlp.1", np.asarray(p["mlp1"]["b"]).shape[-1])
            conv(f"{g}.mlp.3", p["mlp2"], blk)
    conv("final_proj", params["final"])
    sd["bin_score"] = _t(np.asarray(params["bin_score"]).reshape(()))
    return sd


def aliked_params_from_jax(params) -> Dict:
    """The JAX package's ALIKED parameters (BatchNorm already folded) in the
    port's layout: 4-d convolution weights HWIO -> OIHW, biases and the SDDH
    aggregation weights unchanged."""
    if isinstance(params, dict):
        return {k: (_t(np.asarray(v).transpose(3, 2, 0, 1)) if k == "w" and np.ndim(v) == 4
                    else aliked_params_from_jax(v)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [aliked_params_from_jax(v) for v in params]
    return _t(params)


# ---------------------------------------------------------------------------
# RoMa, VGG19, DINOv2
# ---------------------------------------------------------------------------

def _conv_from_jax(p) -> Dict[str, torch.Tensor]:
    return {"w": _t(np.asarray(p["w"]).transpose(3, 2, 0, 1)), "b": _t(p["b"])}


def _lin_from_jax(p) -> Dict[str, torch.Tensor]:
    out = {"w": _t(np.asarray(p["w"]).T)}
    if "b" in p:
        out["b"] = _t(p["b"])
    return out


def _ln_from_jax(p) -> Dict[str, torch.Tensor]:
    return {"g": _t(p["g"]), "b": _t(p["b"])}


def _vit_block_from_jax(p) -> Dict:
    out = {"ln1": _ln_from_jax(p["ln1"]), "qkv": _lin_from_jax(p["qkv"]),
           "proj": _lin_from_jax(p["proj"]), "ln2": _ln_from_jax(p["ln2"]),
           "fc1": _lin_from_jax(p["fc1"]), "fc2": _lin_from_jax(p["fc2"])}
    for k in ("ls1", "ls2"):
        if k in p:
            out[k] = _t(p[k])
    return out


def dinov2_params_from_jax(params) -> Dict:
    blocks = params["blocks"]
    if isinstance(blocks, dict):  # stacked along a leading depth axis
        depth = np.asarray(blocks["qkv"]["w"]).shape[0]

        def take(tree, i):
            if isinstance(tree, dict):
                return {k: take(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        blocks = [take(blocks, i) for i in range(depth)]
    return {
        "patch_embed": _conv_from_jax(params["patch_embed"]),
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "blocks": [_vit_block_from_jax(b) for b in blocks],
        "norm": _ln_from_jax(params["norm"]),
    }


def vgg19_params_from_jax(params) -> Dict:
    return {"stages": [[_conv_from_jax(c) for c in stage] for stage in params["stages"]]}


def roma_params_from_jax(params) -> Dict:
    """The JAX package's RoMa parameters (numpy or JAX leaves) in the port's
    layouts; ``dinov2`` is carried over where the tree holds it."""

    def refiner(p):
        out = {"block1": {k: _conv_from_jax(p["block1"][k]) for k in ("conv1", "conv2")},
               "hidden": [{k: _conv_from_jax(h[k]) for k in ("conv1", "conv2")}
                          for h in p["hidden"]],
               "out": _conv_from_jax(p["out"])}
        if "disp_emb" in p:
            out["disp_emb"] = _lin_from_jax(p["disp_emb"])
        return out

    out = {
        "vgg": vgg19_params_from_jax(params["vgg"]),
        "proj": {s: _lin_from_jax(p) for s, p in params["proj"].items()},
        "gp_pos_conv": _lin_from_jax(params["gp_pos_conv"]),
        "embed_blocks": [_vit_block_from_jax(b) for b in params["embed_blocks"]],
        "embed_out": _lin_from_jax(params["embed_out"]),
        "refiners": {s: refiner(p) for s, p in params["refiners"].items()},
    }
    if "dinov2" in params:
        out["dinov2"] = dinov2_params_from_jax(params["dinov2"])
    return out


def _fold_bn(sd, conv: str, bn: str, eps: float = 1e-5):
    """Conv weight (out, ...) and bias with the inference BatchNorm ``bn``
    after it folded in."""
    w = sd[f"{conv}.weight"]
    b = sd.get(f"{conv}.bias", torch.zeros(w.shape[0]))
    s = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + eps)
    w = w * s.reshape(-1, *([1] * (w.dim() - 1)))
    return {"w": w, "b": (b - sd[f"{bn}.running_mean"]) * s + sd[f"{bn}.bias"]}


def _f32_state(state_dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            if not torch.is_tensor(v) else v.detach().float().cpu()
            for k, v in state_dict.items()}


def vgg19_params_from_torch(sd, prefix: str = "encoder.layers") -> Dict:
    """VGG19-bn features with each BatchNorm folded into its convolution."""
    from .models.vgg_refiner import VGG19_CONV_IDX

    sd = _f32_state(sd)
    return {"stages": [[_fold_bn(sd, f"{prefix}.{i}", f"{prefix}.{i + 1}") for i in stage]
                       for stage in VGG19_CONV_IDX]}


def dinov2_params_from_torch(sd) -> Dict:
    """The official DINOv2 naming (``dinov2_vitl14_pretrain.pth``); the depth
    is read from the keys."""
    sd = _f32_state(sd)

    def lin(prefix):
        out = {"w": sd[f"{prefix}.weight"]}
        if f"{prefix}.bias" in sd:
            out["b"] = sd[f"{prefix}.bias"]
        return out

    def ln(prefix):
        return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    blocks = [{"ln1": ln(f"blocks.{i}.norm1"), "qkv": lin(f"blocks.{i}.attn.qkv"),
               "proj": lin(f"blocks.{i}.attn.proj"), "ls1": sd[f"blocks.{i}.ls1.gamma"],
               "ln2": ln(f"blocks.{i}.norm2"), "fc1": lin(f"blocks.{i}.mlp.fc1"),
               "fc2": lin(f"blocks.{i}.mlp.fc2"), "ls2": sd[f"blocks.{i}.ls2.gamma"]}
              for i in range(depth)]
    return {"patch_embed": {"w": sd["patch_embed.proj.weight"], "b": sd["patch_embed.proj.bias"]},
            "cls_token": sd["cls_token"], "pos_embed": sd["pos_embed"], "blocks": blocks,
            "norm": ln("norm")}


def roma_params_from_torch(state_dict, dinov2_state_dict: Optional[Dict] = None) -> Dict:
    """A ``roma_outdoor.pth`` / ``roma_indoor.pth`` state dict (and, where
    given, the separate DINOv2 weights) in the port's layouts, every
    BatchNorm folded once."""
    sd = _f32_state(state_dict)

    def lin(prefix):
        out = {"w": sd[f"{prefix}.weight"]}
        if f"{prefix}.bias" in sd:
            out["b"] = sd[f"{prefix}.bias"]
        return out

    def conv1x1_bn(prefix):
        p = _fold_bn(sd, f"{prefix}.0", f"{prefix}.1")
        return {"w": p["w"][:, :, 0, 0], "b": p["b"]}

    def refiner_block(prefix):
        return {"conv1": _fold_bn(sd, f"{prefix}.0", f"{prefix}.1"),
                "conv2": {"w": sd[f"{prefix}.3.weight"], "b": sd[f"{prefix}.3.bias"]}}

    def refiner(prefix):
        n_hidden = 1 + max(int(k[len(prefix) + 15:].split(".")[0])
                           for k in sd if k.startswith(f"{prefix}.hidden_blocks."))
        out = {"block1": refiner_block(f"{prefix}.block1"),
               "hidden": [refiner_block(f"{prefix}.hidden_blocks.{h}") for h in range(n_hidden)],
               "out": {"w": sd[f"{prefix}.out_conv.weight"], "b": sd[f"{prefix}.out_conv.bias"]}}
        if f"{prefix}.disp_emb.weight" in sd:
            out["disp_emb"] = {"w": sd[f"{prefix}.disp_emb.weight"][:, :, 0, 0],
                               "b": sd[f"{prefix}.disp_emb.bias"]}
        return out

    def vit_block(prefix):
        blk = {"ln1": {"g": sd[f"{prefix}.norm1.weight"], "b": sd[f"{prefix}.norm1.bias"]},
               "qkv": lin(f"{prefix}.attn.qkv"), "proj": lin(f"{prefix}.attn.proj"),
               "ln2": {"g": sd[f"{prefix}.norm2.weight"], "b": sd[f"{prefix}.norm2.bias"]},
               "fc1": lin(f"{prefix}.mlp.fc1"), "fc2": lin(f"{prefix}.mlp.fc2")}
        if f"{prefix}.ls1.gamma" in sd:
            blk["ls1"] = sd[f"{prefix}.ls1.gamma"]
            blk["ls2"] = sd[f"{prefix}.ls2.gamma"]
        return blk

    from .models.roma import SCALES

    params = {
        "vgg": vgg19_params_from_torch(sd, prefix="encoder.cnn.layers"),
        "proj": {s: conv1x1_bn(f"decoder.proj.{s}") for s in SCALES},
        "gp_pos_conv": {"w": sd["decoder.gps.16.pos_conv.weight"][:, :, 0, 0],
                        "b": sd["decoder.gps.16.pos_conv.bias"]},
        "embed_blocks": [vit_block(f"decoder.embedding_decoder.blocks.{i}") for i in range(5)],
        "embed_out": lin("decoder.embedding_decoder.to_out"),
        "refiners": {s: refiner(f"decoder.conv_refiner.{s}") for s in SCALES},
    }
    if dinov2_state_dict is not None:
        params["dinov2"] = dinov2_params_from_torch(dinov2_state_dict)
    return params
