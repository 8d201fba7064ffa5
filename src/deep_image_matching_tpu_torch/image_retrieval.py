"""Retrieval-based pair selection from global descriptors (port of
``deep_image_matching_tpu/image_retrieval.py``).

The descriptors (NetVLAD, OpenIBL, CosPlace, DIR or the weight-free
``tiny``) run on ``device`` in batches of 8 at the common 640 x 480 size,
with f32 convolutions and products in full f32 (``utils/device.full_f32``:
TF32 would move them by ~1e-3 and flip near-tie ranks); the similarity and
the top-k stay host numpy.

Weight policy (``utils/weights.py``), as in the JAX package: a learned
descriptor without its checkpoint aborts with the expected-filename table,
or, where random weights are allowed, falls back to ``tiny`` with a warning.
``--global_feature tiny`` asks for it explicitly.

Checkpoints, under ``DIM_TPU_WEIGHTS_DIR`` or ``~/.cache/dim_tpu``:
``netvlad.npz`` holds the JAX package's arrays under flat names
(``backbone.convs.{i}.w`` HWIO and ``.b`` for the 13 convolutions,
``centers`` (K, D), ``assign_w`` (D, K), and optionally ``pca_w``
(K * D, out) and ``pca_b``), converted by
``convert.retrieval_params_from_jax``; ``vgg16_netvlad.pth`` /
``openibl.pth``, ``cosplace_resnet18.pth`` / ``cosplace.pth`` and
``Resnet101-AP-GeM-LM18.pt`` / ``dir_resnet101_gem.pth`` are upstream torch
checkpoints read with ``torch.load``, their BatchNorm folded in numpy.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .models import retrieval as R
from .utils.device import full_f32, resolve_device
from .utils.image import ImageList, read_image, resize_image
from .utils.weights import classical_fallback, find_checkpoint, missing_weights

# appended to the abort message at every retrieval checkpoint-miss site
_TINY_NOTE = (
    "Or select the weight-free descriptor explicitly: --global_feature tiny "
    "(config `general: {retrieval: tiny}`)."
)
METHODS = ("netvlad", "openibl", "cosplace", "dir", "tiny")

logger = logging.getLogger("dim_tpu_torch")


def load_images(image_list: ImageList, resize_max: int = 640) -> np.ndarray:
    """(N, resize_max * 3 // 4, resize_max, 3) RGB f32 in [0, 1]: each image
    fitted to ``resize_max``, then resized to the common batch size."""
    imgs = []
    for im in image_list:
        arr = read_image(im.path, grayscale=False).astype(np.float32) / 255.0
        h, w = arr.shape[:2]
        s = resize_max / max(h, w)
        arr = resize_image(arr, (max(8, round(w * s)), max(8, round(h * s))))
        imgs.append(resize_image(arr, (resize_max, resize_max * 3 // 4)))
    return np.stack(imgs)


def load_model(retrieval: str) -> Optional[torch.nn.Module]:
    """The learned network of ``retrieval`` on the CPU, or None for ``tiny``
    and for a missing checkpoint where random weights are allowed."""
    if retrieval == "tiny":
        return None
    return {"netvlad": _load_netvlad, "openibl": _load_openibl, "cosplace": _load_cosplace,
            "dir": _load_dir}[retrieval]()


def compute_global_descriptors(
    image_list: ImageList,
    retrieval: str = "netvlad",
    resize_max: int = 640,
    batch_size: int = 8,
    device=None,
    model: Optional[torch.nn.Module] = None,
) -> np.ndarray:
    """(N, dim) L2-normalised f32 descriptors, computed on ``device``
    (``general.tpu.device``: "auto" is the first CUDA device). ``model``
    overrides the checkpoint loader (``load_model``)."""
    device = resolve_device(device)
    batch_all = load_images(image_list, resize_max)
    if model is None:
        model = load_model(retrieval)
    resnet = isinstance(model, R.ResNetGeM)
    if model is not None:
        model = model.to(device).eval()
    from .models.vgg_refiner import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.from_numpy(IMAGENET_MEAN).to(device)[None, :, None, None]
    std = torch.from_numpy(IMAGENET_STD).to(device)[None, :, None, None]
    descs = []
    with torch.no_grad(), full_f32():
        for s in range(0, len(batch_all), batch_size):
            chunk = torch.from_numpy(batch_all[s:s + batch_size]).to(device)
            chunk = chunk.permute(0, 3, 1, 2).contiguous()
            if model is None:
                d = R.tiny_descriptor(chunk)
            elif resnet:
                d = model((chunk - mean) / std)
            else:
                d = model(chunk)
            descs.append(d.float().cpu().numpy())
    return np.concatenate(descs, axis=0)


def _torch_checkpoint(path: Path) -> dict:
    ckpt = torch.load(str(path), map_location="cpu")
    return ckpt.get("state_dict", ckpt)


def _missing(model: str, names) -> None:
    missing_weights(model, names, note=_TINY_NOTE)
    classical_fallback(model, "'tiny' global descriptor")


def netvlad_tree_from_npz(data) -> dict:
    """The flat arrays of ``netvlad.npz`` as the JAX package's NetVLAD tree."""
    n = sum(1 for k in data if k.startswith("backbone.convs.") and k.endswith(".w"))
    tree = {"backbone": {"convs": [{"w": data[f"backbone.convs.{i}.w"],
                                    "b": data[f"backbone.convs.{i}.b"]} for i in range(n)]},
            "centers": data["centers"], "assign_w": data["assign_w"]}
    for k in ("pca_w", "pca_b"):
        if k in data:
            tree[k] = data[k]
    return tree


def _load_netvlad():
    from .convert import retrieval_params_from_jax

    path = find_checkpoint(["netvlad.npz"])
    if path is None:
        return _missing("NetVLAD", ["netvlad.npz"])
    with np.load(path) as data:
        sd = retrieval_params_from_jax(netvlad_tree_from_npz(dict(data)), "netvlad")
    logger.info(f"Loaded NetVLAD weights from {path}")
    return R.VGG16NetVLAD.from_state_dict(sd)


def _load_openibl():
    names = ["vgg16_netvlad.pth", "openibl.pth"]
    path = find_checkpoint(names)
    if path is None:
        return _missing("OpenIBL", names)
    logger.info(f"Loaded OpenIBL weights from {path}")
    return R.VGG16NetVLAD.from_state_dict(R.openibl_state_from_torch(_torch_checkpoint(path)))


def _load_cosplace():
    names = ["cosplace_resnet18.pth", "cosplace.pth"]
    path = find_checkpoint(names)
    if path is None:
        return _missing("CosPlace", names)
    logger.info(f"Loaded CosPlace weights from {path}")
    sd = R.cosplace_state_from_torch(_torch_checkpoint(path))
    return R.ResNetGeM.from_state_dict(sd, [s for _, _, s in R.R18_STAGES], bottleneck=False)


def _load_dir():
    names = ["Resnet101-AP-GeM-LM18.pt", "dir_resnet101_gem.pth"]
    path = find_checkpoint(names)
    if path is None:
        return _missing("DIR", names)
    logger.info(f"Loaded DIR weights from {path}")
    sd = R.resnet_state_from_torch(_torch_checkpoint(path), R.R101_STAGES, bottleneck=True)
    return R.ResNetGeM.from_state_dict(sd, [s for _, _, s in R.R101_STAGES], bottleneck=True)


def pairs_from_descriptors(names: List[str], descs: np.ndarray,
                           num_matched: int = 10) -> List[Tuple[str, str]]:
    """Each image's ``num_matched`` most similar others (f32 inner products,
    the diagonal at -inf, ``np.argsort`` of the negated row), as sorted,
    unique name pairs."""
    sim = descs @ descs.T
    np.fill_diagonal(sim, -np.inf)
    pairs = set()
    k = min(num_matched, len(names) - 1)
    for i in range(len(names)):
        for j in np.argsort(-sim[i])[:k]:
            pairs.add(tuple(sorted((names[i], names[int(j)]))))
    logger.info(f"Retrieval selected {len(pairs)} pairs (top-{k})")
    return sorted(pairs)


def retrieval_pairs(
    image_list: ImageList,
    retrieval: str = "netvlad",
    num_matched: int = 10,
    device=None,
) -> List[Tuple[str, str]]:
    if retrieval not in METHODS:
        raise ValueError(f"Unknown retrieval method '{retrieval}'")
    descs = compute_global_descriptors(image_list, retrieval, device=device)
    return pairs_from_descriptors(image_list.img_names, descs, num_matched)
