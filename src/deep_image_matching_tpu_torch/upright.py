"""The ALIKED probe extractor of ``deep_image_matching_tpu/upright.py``.

Only ``_AlikedProbe`` is ported: the low-resolution pair probe
(``low_resolution.py``) falls back to it when ALIKED weights exist but
SuperPoint/LightGlue ones do not. The upright stage itself is not ported
(``--upright`` raises in ``image_matching.py``; ROADMAP.md, queue 1).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger("dim_tpu_torch")


class _AlikedProbe:
    """Probe extractor on the ALIKED checkpoint, with SuperPointRunner's
    ``extract_images`` / ``extract_arrays`` surface. Raises
    FileNotFoundError where no ``aliked-n16rot.pth`` exists."""

    def __init__(self, max_keypoints: int = 512, resize_max: int = 512,
                 device: torch.device = torch.device("cpu")):
        from .extractors.aliked import load_params
        from .models.aliked import tree_map

        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), load_params("aliked-n16rot"))
        self.max_keypoints = max_keypoints
        self.resize_max = resize_max

    def extract_images(self, paths) -> list:
        import cv2

        prepped = []
        for p in paths:
            img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
            h, w = img.shape
            scale = 1.0
            if self.resize_max and max(h, w) > self.resize_max:
                scale = self.resize_max / max(h, w)
                img = cv2.resize(img, (round(w * scale), round(h * scale)),
                                 interpolation=cv2.INTER_AREA)
            prepped.append((img, scale, (w, h)))
        return self.extract_arrays(prepped)

    def extract_arrays(self, prepped) -> list:
        """prepped: list of (grayscale image (h, w), scale, orig (w, h));
        keypoints come back divided by ``scale``. Every image is padded to one
        square of side ceil(resize_max / 32) * 32 (or its own, if larger), and
        the images go in chunks of 8 (4 above 768 px); a chunk that runs out
        of device memory is bisected, every other error propagates."""
        from .models import aliked as aliked_model

        results = [None] * len(prepped)
        pad_to = 32
        side = -(-self.resize_max // pad_to) * pad_to
        for img, _, _ in prepped:
            h, w = img.shape[:2]
            side = max(side, -(-h // pad_to) * pad_to, -(-w // pad_to) * pad_to)
        chunk = 8 if side <= 768 else 4

        def run_chunk(sub):
            batch = np.zeros((len(sub), side, side, 3), np.float32)
            vhw = np.zeros((len(sub), 2), np.int64)
            for j, i in enumerate(sub):
                img = prepped[i][0]
                if img.dtype == np.uint8:
                    img = img.astype(np.float32) / 255.0
                h, w = img.shape[:2]
                batch[j, :h, :w] = img[..., None]
                vhw[j] = (h, w)
            out = aliked_model.extract(
                self.params, torch.from_numpy(batch).to(self.device),
                torch.from_numpy(vhw).to(self.device), max_keypoints=self.max_keypoints,
                detection_threshold=0.2, nms_radius=3)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, i in enumerate(sub):
                m = out["mask"][j]
                results[i] = {"keypoints": out["keypoints"][j][m] / prepped[i][1],
                              "descriptors": out["descriptors"][j][m],
                              "scores": out["scores"][j][m]}

        def run_resilient(sub):
            try:
                run_chunk(sub)
            except torch.cuda.OutOfMemoryError:
                if len(sub) <= 1:
                    raise
                torch.cuda.empty_cache()
                logger.warning(f"ALIKED probe batch of {len(sub)} at {side}x{side} ran out "
                               "of device memory; bisecting")
                mid = len(sub) // 2
                run_resilient(sub[:mid])
                run_resilient(sub[mid:])

        for s in range(0, len(prepped), chunk):
            run_resilient(list(range(s, min(s + chunk, len(prepped)))))
        return results
