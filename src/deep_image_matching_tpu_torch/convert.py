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

The retrieval networks (``models/retrieval.py``) are modules:
``retrieval_params_from_jax`` turns each of the JAX package's four trees
(``netvlad``: ``{"backbone": {"convs"}, "centers", "assign_w", "pca_w",
"pca_b"}``; ``openibl``: ``{"convs", "centers", "assign_w", "assign_b"}``;
``cosplace`` and ``dir``: ``{"stem", "stages", "proj", "gem_p"}``, BatchNorm
folded) into the modules' state dicts: convolutions HWIO -> OIHW, the (D, K)
assignment -> a (K, D, 1, 1) convolution, dense (in, out) -> (out, in).

``disk_params_from_jax``, ``xfeat_params_from_jax``, ``keynet_params_from_jax``,
``affnet_params_from_jax`` / ``orinet_params_from_jax`` and
``hardnet_params_from_jax`` write the checkpoints' own layouts (each gate
between the convolutions it separates; ``XFeatModel``'s, kornia's KeyNet and
the ``features.N`` names), which the JAX package's ``params_from_torch``
reads back exactly and the port's loaders read as they read the released
files. LighterGlue's tree goes through ``lightglue_params_from_jax`` at its
own sizes.

``dedode_params_from_jax`` (detector-L, descriptor B, descriptor G's VGG and
refiners; G's DINOv2 through ``dinov2_params_from_jax``),
``ripe_params_from_jax`` and ``liftfeat_params_from_jax`` write the released
checkpoints' names with identity BatchNorms (a LiftFeat BaseLayer's folded
bias as its affine-free BatchNorm's negated mean); the JAX package's
``params_from_torch`` reads them back exactly, and the port's models fold
them into their trees (``refiner_params_from_torch`` for the ConvRefiners
that DeDoDe, RIPE and RoMa share).

``rdd_params_from_jax`` and ``alike_params_from_jax`` write the upstream
RDD and ALNet names in the same way (RDD's matchability head with its folded
bias as the negated mean of an affine-free BatchNorm); the models'
``params_from_torch`` fold them back into the port's trees.
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


def refiner_params_from_torch(sd: Dict[str, torch.Tensor], prefix: str) -> Dict:
    """A ConvRefiner at ``prefix`` of an f32 state dict (``_f32_state``):
    ``block1`` and ``hidden_blocks.{h}`` (conv ``.0``, BatchNorm ``.1``
    folded into it, conv ``.3``), ``out_conv``, and RoMa's ``disp_emb``
    where present."""

    def block(bprefix):
        return {"conv1": _fold_bn(sd, f"{bprefix}.0", f"{bprefix}.1"),
                "conv2": {"w": sd[f"{bprefix}.3.weight"], "b": sd[f"{bprefix}.3.bias"]}}

    n_hidden = 1 + max(int(k[len(prefix) + 15:].split(".")[0])
                       for k in sd if k.startswith(f"{prefix}.hidden_blocks."))
    out = {"block1": block(f"{prefix}.block1"),
           "hidden": [block(f"{prefix}.hidden_blocks.{h}") for h in range(n_hidden)],
           "out": {"w": sd[f"{prefix}.out_conv.weight"], "b": sd[f"{prefix}.out_conv.bias"]}}
    if f"{prefix}.disp_emb.weight" in sd:
        out["disp_emb"] = {"w": sd[f"{prefix}.disp_emb.weight"][:, :, 0, 0],
                           "b": sd[f"{prefix}.disp_emb.bias"]}
    return out


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
        "refiners": {s: refiner_params_from_torch(sd, f"decoder.conv_refiner.{s}")
                     for s in SCALES},
    }
    if dinov2_state_dict is not None:
        params["dinov2"] = dinov2_params_from_torch(dinov2_state_dict)
    return params


# ---------------------------------------------------------------------------
# retrieval: VGG16 + NetVLAD, folded-BN ResNets + GeM
# ---------------------------------------------------------------------------

def _retrieval_conv(p) -> tuple:
    return _t(np.asarray(p["w"]).transpose(3, 2, 0, 1)), _t(p["b"])


def retrieval_params_from_jax(params, kind: str) -> StateDict:
    """One of the JAX package's retrieval trees -> the state dict of
    ``models/retrieval.VGG16NetVLAD`` (``netvlad``, ``openibl``) or
    ``ResNetGeM`` (``cosplace``, ``dir``)."""
    from .models.retrieval import vgg16_conv_indices

    sd: StateDict = {}
    if kind in ("netvlad", "openibl"):
        convs = (params["backbone"] if kind == "netvlad" else params)["convs"]
        for idx, p in zip(vgg16_conv_indices(), convs):
            sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = _retrieval_conv(p)
        assign = np.asarray(params["assign_w"])  # (D, K)
        sd["net_vlad.conv.weight"] = _t(assign.T[:, :, None, None])
        sd["net_vlad.centroids"] = _t(params["centers"])
        if params.get("assign_b") is not None:
            sd["net_vlad.conv.bias"] = _t(params["assign_b"])
        if params.get("pca_w") is not None:
            pca_w = np.asarray(params["pca_w"])  # (K * D, out)
            sd["net_vlad.pca.weight"] = _t(pca_w.T)
            b = params.get("pca_b")
            sd["net_vlad.pca.bias"] = _t(np.zeros(pca_w.shape[1]) if b is None else b)
        return sd
    if kind not in ("cosplace", "dir"):
        raise ValueError(f"Unknown retrieval network '{kind}'")
    sd["stem.weight"], sd["stem.bias"] = _retrieval_conv(params["stem"])
    for si, blocks in enumerate(params["stages"]):
        for bi, bp in enumerate(blocks):
            for name, p in bp.items():
                dst = f"layers.{si}.{bi}.{'downsample' if name == 'down' else name}"
                sd[f"{dst}.weight"], sd[f"{dst}.bias"] = _retrieval_conv(p)
    if "proj" in params:
        sd["proj.weight"] = _t(np.asarray(params["proj"]["w"]).T)
        sd["proj.bias"] = _t(params["proj"]["b"])
    sd["gem_p"] = _t(params["gem_p"])
    return sd


# ---------------------------------------------------------------------------
# DISK, XFeat, KeyNet, AffNet / OriNet, HardNet: checkpoint-layout state
# dicts from the JAX package's trees. The JAX package folds each BatchNorm
# into its convolution on load, so a folded convolution is written with an
# identity BatchNorm (mean 0, variance 1 - eps, whose sum with eps is 1.0 in
# f32), which folds back to the same weights bit for bit.
# ---------------------------------------------------------------------------

def _identity_bn(sd: StateDict, prefix: str, n: int, affine: bool = False) -> None:
    if affine:
        sd[f"{prefix}.weight"] = torch.ones(n)
        sd[f"{prefix}.bias"] = torch.zeros(n)
    sd[f"{prefix}.running_mean"] = torch.zeros(n)
    sd[f"{prefix}.running_var"] = torch.full((n,), 1.0 - _BN_EPS)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def disk_params_from_jax(params) -> StateDict:
    """The JAX package's DISK tree -> ``models/disk.DISK``'s state dict,
    which the position-based converters of both packages read back: per
    block its gate (where gated) before its conv, so each gate lies between
    its conv and the one before."""
    sd: StateDict = {}
    for group in ("down", "up"):
        for i, p in enumerate(params[group]):
            if p["prelu"] is not None:
                sd[f"{group}.{i}.prelu.weight"] = _t(p["prelu"])
            sd[f"{group}.{i}.conv.weight"] = _oihw(p["w"])
            sd[f"{group}.{i}.conv.bias"] = _t(p["b"])
    return sd


def xfeat_params_from_jax(params) -> StateDict:
    """The JAX package's XFeat tree -> an ``XFeatModel`` state dict
    (``block.{i}.layer.0`` conv + ``layer.1`` affine-free BatchNorm for a
    BasicLayer, ``block.{i}`` for a plain conv; ``skip1``'s conv at index 1)."""
    from .models.xfeat import BLOCKS

    sd: StateDict = {}
    for block, layers in BLOCKS.items():
        for i, (kind, *_rest) in enumerate(layers):
            p = params[block][i]
            src = 1 if block == "skip1" else i
            if kind == "bl":
                sd[f"{block}.{src}.layer.0.weight"] = _oihw(p["w"])
                sd[f"{block}.{src}.layer.0.bias"] = _t(p["b"])
                _identity_bn(sd, f"{block}.{src}.layer.1", np.asarray(p["b"]).shape[0])
            else:
                sd[f"{block}.{src}.weight"] = _oihw(p["w"])
                sd[f"{block}.{src}.bias"] = _t(p["b"])
    return sd


def keynet_params_from_jax(params) -> StateDict:
    """The JAX package's KeyNet tree -> kornia's names
    (``feature_extractor.lb_block.{i}.0``, ``last_conv.0``), without
    BatchNorms (the converter folds one only where present)."""
    sd: StateDict = {}
    for i, p in enumerate(params["blocks"]):
        sd[f"feature_extractor.lb_block.{i}.0.weight"] = _oihw(p["w"])
        sd[f"feature_extractor.lb_block.{i}.0.bias"] = _t(p["b"])
    sd["last_conv.0.weight"] = _oihw(params["last"]["w"])
    sd["last_conv.0.bias"] = _t(params["last"]["b"])
    return sd


def _features_from_jax(params, conv_idx) -> StateDict:
    """``features.{i}`` convolutions, each but the last followed by an
    identity affine-free BatchNorm at ``features.{i + 1}``."""
    sd: StateDict = {}
    layers = params["layers"]
    for j, (i, p) in enumerate(zip(conv_idx, layers)):
        sd[f"features.{i}.weight"] = _oihw(p["w"])
        sd[f"features.{i}.bias"] = _t(p["b"])
        if j < len(layers) - 1:
            _identity_bn(sd, f"features.{i + 1}", np.asarray(p["b"]).shape[0])
    return sd


def affnet_params_from_jax(params) -> StateDict:
    """The JAX package's AffNet or OriNet tree -> the released
    ``features.N.*`` layout (the head at ``features.19``)."""
    return _features_from_jax(params, (0, 3, 6, 9, 12, 15, 19))


orinet_params_from_jax = affnet_params_from_jax


def hardnet_params_from_jax(params) -> StateDict:
    """The JAX package's HardNet tree -> the ``features.N.*`` layout; the
    last convolution keeps its (identity) BatchNorm, as HardNet has one."""
    sd: StateDict = {}
    for i, p in zip((0, 3, 6, 9, 12, 15, 19), params["layers"]):
        sd[f"features.{i}.weight"] = _oihw(p["w"])
        sd[f"features.{i}.bias"] = _t(p["b"])
        _identity_bn(sd, f"features.{i + 1}", np.asarray(p["b"]).shape[0])
    return sd


# ---------------------------------------------------------------------------
# DeDoDe, RIPE, LiftFeat: the checkpoints' own layouts, BatchNorms identity
# ---------------------------------------------------------------------------

def _vgg19_state(sd: StateDict, prefix: str, params) -> None:
    """The folded VGG19-bn encoder as ``{prefix}.{i}`` convolutions, each with
    an identity affine BatchNorm at ``{prefix}.{i + 1}``."""
    from .models.vgg_refiner import VGG19_CONV_IDX

    for stage, convs in zip(VGG19_CONV_IDX, params["stages"]):
        for i, p in zip(stage, convs):
            sd[f"{prefix}.{i}.weight"] = _oihw(p["w"])
            sd[f"{prefix}.{i}.bias"] = _t(p["b"])
            _identity_bn(sd, f"{prefix}.{i + 1}", np.asarray(p["b"]).shape[0], affine=True)


def _refiner_state(sd: StateDict, prefix: str, params) -> None:
    """A ConvRefiner tree as ``block1`` / ``hidden_blocks.{h}`` (conv ``.0``,
    identity affine BatchNorm ``.1``, conv ``.3``) and ``out_conv``."""

    def block(bprefix, p):
        sd[f"{bprefix}.0.weight"] = _oihw(p["conv1"]["w"])
        sd[f"{bprefix}.0.bias"] = _t(p["conv1"]["b"])
        _identity_bn(sd, f"{bprefix}.1", np.asarray(p["conv1"]["b"]).shape[0], affine=True)
        sd[f"{bprefix}.3.weight"] = _oihw(p["conv2"]["w"])
        sd[f"{bprefix}.3.bias"] = _t(p["conv2"]["b"])

    block(f"{prefix}.block1", params["block1"])
    for h, p in enumerate(params["hidden"]):
        block(f"{prefix}.hidden_blocks.{h}", p)
    sd[f"{prefix}.out_conv.weight"] = _oihw(params["out"]["w"])
    sd[f"{prefix}.out_conv.bias"] = _t(params["out"]["b"])


def dedode_params_from_jax(params) -> StateDict:
    """The JAX package's DeDoDe detector-L, descriptor-B or descriptor-G tree
    (G: a refiner at scale 14) -> the released checkpoint's names
    (``encoder.layers.*`` or G's ``encoder.vgg.layers.*``,
    ``decoder.layers.{scale}.*``). G's DINOv2 is not in that checkpoint: it
    goes to the port's tree through ``dinov2_params_from_jax``."""
    sd: StateDict = {}
    prefix = "encoder.vgg.layers" if "14" in params["refiners"] else "encoder.layers"
    _vgg19_state(sd, prefix, params["encoder"])
    for scale, p in params["refiners"].items():
        _refiner_state(sd, f"decoder.layers.{scale}", p)
    return sd


def ripe_params_from_jax(params) -> StateDict:
    """The JAX package's RIPE tree -> ``ripe_weights.pth``'s names
    (``net.encoder.layers.*``, ``net.decoder.layers.{scale}.*``, the optional
    ``conv_dim_reduction_coarse_desc`` as a Conv1d (out, in, 1))."""
    sd: StateDict = {}
    _vgg19_state(sd, "net.encoder.layers", params["encoder"])
    for scale, p in params["refiners"].items():
        _refiner_state(sd, f"net.decoder.layers.{scale}", p)
    if "dim_reduction" in params:
        w = np.asarray(params["dim_reduction"]["w"])
        sd["conv_dim_reduction_coarse_desc.weight"] = _t(w.T[:, :, None])
        sd["conv_dim_reduction_coarse_desc.bias"] = _t(params["dim_reduction"]["b"])
    return sd


def liftfeat_params_from_jax(params) -> StateDict:
    """The JAX package's LiftFeat tree -> ``LiftFeat.pth``'s names. A
    BaseLayer (conv without bias + affine-free BatchNorm) carries its folded
    bias as the BatchNorm's running mean, negated; a conv + affine BatchNorm
    pair keeps the conv's bias and an identity BatchNorm."""
    sd: StateDict = {}

    def conv(key, p):
        sd[f"{key}.weight"] = _oihw(p["w"])
        sd[f"{key}.bias"] = _t(p["b"])

    def base_layer(prefix, p):
        sd[f"{prefix}.layer.0.weight"] = _oihw(p["w"])
        b = np.asarray(p["b"])
        sd[f"{prefix}.layer.1.running_mean"] = _t(-b)
        sd[f"{prefix}.layer.1.running_var"] = torch.full(b.shape, 1.0 - _BN_EPS)
        sd[f"{prefix}.layer.1.num_batches_tracked"] = torch.tensor(0)

    def conv_bn(conv_key, bn_key, p):
        conv(conv_key, p)
        _identity_bn(sd, bn_key, np.asarray(p["b"]).shape[0], affine=True)

    def lin(key, p):
        sd[f"{key}.weight"] = _t(np.asarray(p["w"]).T)
        sd[f"{key}.bias"] = _t(p["b"])

    for name, p in params["backbone"].items():
        conv(name, p)
    for up in ("upsample5", "upsample4"):
        conv_bn(f"{up}.conv", f"{up}.bn", params[up])
    conv("conv_fusion45", params["fusion45"])
    conv("conv_fusion34", params["fusion34"])
    kh = params["keypoint_head"]
    for i, p in enumerate(kh["layers"]):
        base_layer(f"keypoint_head.layer{i + 1}", p)
    conv_bn("keypoint_head.conv", "keypoint_head.bn", kh["out"])
    for i, p in enumerate(params["descriptor_head"]):
        base_layer(f"descriptor_head.layer.{i}", p)
    dh = params["depth_head"]
    for key, name in (("upa", "upsampleDa"), ("upb", "upsampleDb"), ("upc", "upsampleDc")):
        conv_bn(f"depth_head.{name}.conv", f"depth_head.{name}.bn", dh[key])
    for key, name in (("da", "a"), ("db", "b"), ("dc", "c")):
        conv_bn(f"depth_head.convDep{name}", f"depth_head.bnDep{name}", dh[key])
    bp = params["booster"]
    for i, p in zip((0, 2, 4), bp["denc"]):
        lin(f"feature_boost.denc.encoder.{i}", p)
    for i, p in enumerate(bp["nenc"]):
        lin(f"feature_boost.nenc.encoder.{i}", p)
    for i, lp in enumerate(bp["aft"]):
        pre = f"feature_boost.attn_proj.layers.{i}"
        for key, name in (("q", "attn.query"), ("k", "attn.key"), ("v", "attn.value"),
                          ("proj", "attn.proj"), ("ffn1", "ffn.mlp.0"), ("ffn2", "ffn.mlp.2")):
            lin(f"{pre}.{name}", lp[key])
    return sd


# ---------------------------------------------------------------------------
# LoFTR and SE2-LoFTR: the port keeps the JAX package's tree (convolutions
# OIHW, linear layers (out, in)); the checkpoints' own names are read by
# ``loftr_params_from_torch`` (BatchNorm folded in numpy f32, the JAX
# package's arithmetic, so both hold the same bits) and written by
# ``loftr_state_dict`` (identity BatchNorms, which fold back bit for bit)
# ---------------------------------------------------------------------------

def loftr_params_from_jax(params) -> Dict:
    """The JAX package's LoFTR or SE2-LoFTR tree in the port's layouts:
    4-d convolution weights HWIO -> OIHW, 2-d dense weights (in, out) ->
    (out, in), everything else as it is."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k == "w" and np.ndim(v) == 4:
                out[k] = _t(np.asarray(v).transpose(3, 2, 0, 1))
            elif k == "w" and np.ndim(v) == 2:
                out[k] = _t(np.asarray(v).T)
            else:
                out[k] = loftr_params_from_jax(v)
        return out
    if isinstance(params, (list, tuple)):
        return [loftr_params_from_jax(v) for v in params]
    return _t(params)


# backbone entries (name in the tree -> checkpoint prefix, its BatchNorm or
# None, whether the checkpoint's convolution has a bias)
_LOFTR_FPN = {
    "l3_out": ("backbone.layer3_outconv", None, False),
    "l3_triv": ("backbone.layer3triv", None, False),
    "l2_out": ("backbone.layer2_outconv", None, False),
    "l2_out2a": ("backbone.layer2_outconv2.0", "backbone.layer2_outconv2.1", False),
    "l2_out2b": ("backbone.layer2_outconv2.3", None, True),
    "l1_out": ("backbone.layer1_outconv", None, False),
    "l1_out2a": ("backbone.layer1_outconv2.0", "backbone.layer1_outconv2.1", False),
    "l1_out2b": ("backbone.layer1_outconv2.3", None, True),
}
_LOFTR_ENC = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("merge", "merge"),
              ("mlp1", "mlp.0"), ("mlp2", "mlp.2"))


def _loftr_backbone_entries(bp: Dict):
    """(tree entry, conv prefix, BatchNorm prefix or None, conv bias) of a
    LoFTR backbone tree, in the checkpoint's order."""
    yield bp["conv1"], "backbone.conv1", "backbone.bn1", False
    for s in (1, 2, 3):
        for i, blk in enumerate(bp[f"layer{s}"]):
            pre = f"backbone.layer{s}.{i}"
            yield blk["conv1"], f"{pre}.conv1", f"{pre}.bn1", False
            yield blk["conv2"], f"{pre}.conv2", f"{pre}.bn2", False
            if "down" in blk:
                yield blk["down"], f"{pre}.downsample.0", f"{pre}.downsample.1", False
    for name, (conv, bn, bias) in _LOFTR_FPN.items():
        if name in bp:
            yield bp[name], conv, bn, bias


def loftr_state_dict(params) -> StateDict:
    """The port's LoFTR (or SE2-LoFTR exported-form) tree -> the checkpoint's
    names (``backbone.*``, ``loftr_coarse.layers.{i}.*``,
    ``fine_preprocess.*``, ``loftr_fine.layers.{i}.*``); a folded convolution
    is written bias-free with an identity BatchNorm carrying its bias."""
    sd: StateDict = {}
    for p, conv, bn, bias in _loftr_backbone_entries(params["backbone"]):
        sd[f"{conv}.weight"] = p["w"].detach().float().cpu().clone()
        if bn is not None:
            _identity_bn(sd, bn, p["w"].shape[0], affine=True)
            sd[f"{bn}.bias"] = p["b"].detach().float().cpu().clone()
        elif bias:
            sd[f"{conv}.bias"] = p["b"].detach().float().cpu().clone()

    def lin(key, p):
        sd[f"{key}.weight"] = p["w"].detach().float().cpu().clone()
        if "b" in p:
            sd[f"{key}.bias"] = p["b"].detach().float().cpu().clone()

    for stage, layers in (("loftr_coarse", params["coarse"]), ("loftr_fine", params["fine"])):
        for i, lp in enumerate(layers):
            pre = f"{stage}.layers.{i}"
            for key, name in _LOFTR_ENC:
                lin(f"{pre}.{name}", lp[key])
            for ln in ("ln1", "ln2"):
                sd[f"{pre}.norm{ln[-1]}.weight"] = lp[ln]["g"].detach().float().cpu().clone()
                sd[f"{pre}.norm{ln[-1]}.bias"] = lp[ln]["b"].detach().float().cpu().clone()
    for key in ("down_proj", "merge_feat"):
        lin(f"fine_preprocess.{key}", params["fine_pre"][key])
    return sd


def _np_state(state_dict) -> Dict[str, np.ndarray]:
    """A state dict as numpy arrays, the lightning wrapper's ``matcher.``
    prefix dropped."""
    out = {}
    for k, v in state_dict.items():
        k = k[len("matcher."):] if k.startswith("matcher.") else k
        out[k] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _np_folded(sd: Dict[str, np.ndarray], conv: str, bn: str) -> Dict[str, torch.Tensor]:
    """Convolution ``conv`` with the inference BatchNorm ``bn`` folded in,
    in numpy f32 as the JAX package's ``params_from_torch`` folds it."""
    w = sd[f"{conv}.weight"]
    b = sd.get(f"{conv}.bias")
    g, beta = sd[f"{bn}.weight"], sd[f"{bn}.bias"]
    mean, var = sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]
    s = g / np.sqrt(var + 1e-5)
    wf = w * s[:, None, None, None]
    bf = ((b if b is not None else 0.0) - mean) * s + beta
    return {"w": _t(np.asarray(wf, np.float32)), "b": _t(np.asarray(bf, np.float32))}


def loftr_backbone_from_torch(sd: Dict[str, np.ndarray], fpn_keys) -> Dict:
    """A LoFTR-layout backbone (stem, three stages of two blocks, the FPN
    entries ``fpn_keys``) from a numpy state dict, BatchNorm folded."""
    def block(pre):
        p = {"conv1": _np_folded(sd, f"{pre}.conv1", f"{pre}.bn1"),
             "conv2": _np_folded(sd, f"{pre}.conv2", f"{pre}.bn2")}
        if f"{pre}.downsample.0.weight" in sd:
            p["down"] = _np_folded(sd, f"{pre}.downsample.0", f"{pre}.downsample.1")
        return p

    bp = {"conv1": _np_folded(sd, "backbone.conv1", "backbone.bn1")}
    for s in (1, 2, 3):
        bp[f"layer{s}"] = [block(f"backbone.layer{s}.{i}") for i in range(2)]
    for name in fpn_keys:
        conv, bn, bias = _LOFTR_FPN[name]
        if bn is not None:
            bp[name] = _np_folded(sd, conv, bn)
        else:
            bp[name] = {"w": _t(sd[f"{conv}.weight"])}
            if bias and f"{conv}.bias" in sd:
                bp[name]["b"] = _t(sd[f"{conv}.bias"])
    return bp


def loftr_transformer_from_torch(sd: Dict[str, np.ndarray]) -> Dict:
    """The coarse and fine layers and the fine preprocessing of a LoFTR
    state dict (as many layers as it holds)."""
    def lin(key):
        out = {"w": _t(sd[f"{key}.weight"])}
        if f"{key}.bias" in sd:
            out["b"] = _t(sd[f"{key}.bias"])
        return out

    def layers(stage):
        n = 1 + max((int(k.split(".")[2]) for k in sd if k.startswith(f"{stage}.layers.")),
                    default=-1)
        out = []
        for i in range(n):
            pre = f"{stage}.layers.{i}"
            lp = {key: lin(f"{pre}.{name}") for key, name in _LOFTR_ENC}
            for ln in ("ln1", "ln2"):
                lp[ln] = {"g": _t(sd[f"{pre}.norm{ln[-1]}.weight"]),
                          "b": _t(sd[f"{pre}.norm{ln[-1]}.bias"])}
            out.append(lp)
        return out

    return {"coarse": layers("loftr_coarse"),
            "fine_pre": {"down_proj": lin("fine_preprocess.down_proj"),
                         "merge_feat": lin("fine_preprocess.merge_feat")},
            "fine": layers("loftr_fine")}


def loftr_params_from_torch(state_dict, temp_bug_fix: bool = False) -> Dict:
    """An original LoFTR checkpoint (``outdoor_ds.ckpt``'s names, with or
    without the lightning wrapper's ``matcher.`` prefix) in the port's tree.
    ``temp_bug_fix`` changes no weight (the position encoding is made at
    match time); it is taken as the JAX package's converter takes it."""
    sd = _np_state(state_dict)
    fpn = [k for k in _LOFTR_FPN if k != "l3_triv"]
    return {"backbone": loftr_backbone_from_torch(sd, fpn), **loftr_transformer_from_torch(sd)}


# ---------------------------------------------------------------------------
# RDD, ALIKE
# ---------------------------------------------------------------------------

def _folded_conv_state(sd: StateDict, conv: str, bn: str, p) -> None:
    """A folded convolution as the checkpoint's bias-free convolution and an
    identity affine BatchNorm carrying the folded bias."""
    sd[f"{conv}.weight"] = _oihw(p["w"])
    _identity_bn(sd, bn, np.asarray(p["b"]).shape[0], affine=True)
    sd[f"{bn}.bias"] = _t(p["b"])


def _plain_conv_state(sd: StateDict, key: str, p) -> None:
    sd[f"{key}.weight"] = _oihw(p["w"])
    if "b" in p:
        sd[f"{key}.bias"] = _t(p["b"])


def rdd_params_from_jax(params) -> StateDict:
    """The JAX package's RDD tree -> an upstream RDD state dict (``detector.*``,
    ``descriptor.*``; identity BatchNorms, the matchability head's folded
    bias as its affine-free BatchNorm's negated mean), which the JAX
    package's ``params_from_torch`` reads back exactly."""
    from .models.rdd import N_LEVELS

    sd: StateDict = {}
    det = params["detector"]
    for b in (1, 2, 3, 4):
        for j in (1, 2):
            _folded_conv_state(sd, f"detector.block{b}.conv{j}", f"detector.block{b}.bn{j}",
                               det[f"block{b}"][f"conv{j}"])
        if b > 1:
            _plain_conv_state(sd, f"detector.block{b}.downsample", det[f"block{b}"]["down"])
    for i in range(1, 5):
        _plain_conv_state(sd, f"detector.conv{i}", det["agg"][f"conv{i}"])
    _plain_conv_state(sd, "detector.convhead2.0", det["head"])
    body = "descriptor.backbone.0.body"
    _folded_conv_state(sd, f"{body}.conv1", f"{body}.bn1", params["resnet"]["stem"])
    for si, blocks in enumerate(params["resnet"]["stages"]):
        for bi, blk in enumerate(blocks):
            pre = f"{body}.layer{si + 1}.{bi}"
            for j in (1, 2, 3):
                _folded_conv_state(sd, f"{pre}.conv{j}", f"{pre}.bn{j}", blk[f"conv{j}"])
            if "down" in blk:
                _folded_conv_state(sd, f"{pre}.downsample.0", f"{pre}.downsample.1",
                                   blk["down"])
    for i in range(N_LEVELS):
        pr = params["projs"][i]
        _plain_conv_state(sd, f"descriptor.input_proj.{i}.0", pr["conv"])
        sd[f"descriptor.input_proj.{i}.1.weight"] = _t(pr["gn"]["g"])
        sd[f"descriptor.input_proj.{i}.1.bias"] = _t(pr["gn"]["b"])
    sd["descriptor.transformer.level_embed"] = _t(params["level_embed"])
    for i, lp in enumerate(params["encoder"]):
        pre = f"descriptor.transformer.encoder.layers.{i}"
        for key, name in (("sampling_offsets", "self_attn.sampling_offsets"),
                          ("attention_weights", "self_attn.attention_weights"),
                          ("value_proj", "self_attn.value_proj"),
                          ("output_proj", "self_attn.output_proj"),
                          ("fc1", "linear1"), ("fc2", "linear2")):
            sd[f"{pre}.{name}.weight"] = _t(np.asarray(lp[key]["w"]).T)
            sd[f"{pre}.{name}.bias"] = _t(lp[key]["b"])
        for ln, name in (("ln1", "norm1"), ("ln2", "norm2")):
            sd[f"{pre}.{name}.weight"] = _t(lp[ln]["g"])
            sd[f"{pre}.{name}.bias"] = _t(lp[ln]["b"])
    mh = params["match_head"]
    for i in (0, 1):
        pre = f"descriptor.matchibility_head.{i}.layer"
        sd[f"{pre}.0.weight"] = _oihw(mh[f"l{i}"]["w"])
        _identity_bn(sd, f"{pre}.1", np.asarray(mh[f"l{i}"]["b"]).shape[0])
        sd[f"{pre}.1.running_mean"] = _t(-np.asarray(mh[f"l{i}"]["b"], np.float32))
    _plain_conv_state(sd, "descriptor.matchibility_head.2", mh["out"])
    return sd


def alike_params_from_jax(params) -> StateDict:
    """The JAX package's ALIKE tree (any of alike-t/s/n/l) -> an upstream
    ALNet state dict with identity BatchNorms, which the JAX package's
    ``params_from_torch`` reads back exactly."""
    sd: StateDict = {}
    for b in (1, 2, 3, 4):
        for j in (1, 2):
            _folded_conv_state(sd, f"block{b}.conv{j}", f"block{b}.bn{j}",
                               params[f"block{b}"][f"conv{j}"])
        if b > 1:
            _plain_conv_state(sd, f"block{b}.downsample", params[f"block{b}"]["down"])
    for i in range(1, 5):
        _plain_conv_state(sd, f"conv{i}", params["agg"][f"conv{i}"])
    if "head1" in params:
        _plain_conv_state(sd, "convhead1", params["head1"])
    _plain_conv_state(sd, "convhead2", params["head2"])
    return sd
