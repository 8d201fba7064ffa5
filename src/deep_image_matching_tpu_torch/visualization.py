"""Match and keypoint plots (copy of
``deep_image_matching_tpu/visualization.py``): OpenCV side-by-side match
plots and keypoint dumps, and a matplotlib variant that imports matplotlib
only when it is called.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import cv2
import numpy as np


def viz_keypoints_cv2(
    image: np.ndarray,
    keypoints: np.ndarray,
    output_path: Optional[Path] = None,
    radius: int = 2,
    color=(0, 255, 0),
) -> np.ndarray:
    if image.ndim == 2:
        image = cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
    out = image.copy()
    for x, y in np.asarray(keypoints, np.int32):
        cv2.circle(out, (int(x), int(y)), radius, color, -1, lineType=cv2.LINE_AA)
    if output_path is not None:
        cv2.imwrite(str(output_path), out)
    return out


def viz_matches_cv2(
    image0: np.ndarray,
    image1: np.ndarray,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    output_path: Optional[Path] = None,
    line_color=(0, 200, 0),
    point_color=(0, 0, 255),
    max_lines: int = 500,
) -> np.ndarray:
    """Side-by-side image pair with match lines (matched kpts0[i]<->kpts1[i])."""
    if image0.ndim == 2:
        image0 = cv2.cvtColor(image0, cv2.COLOR_GRAY2BGR)
    if image1.ndim == 2:
        image1 = cv2.cvtColor(image1, cv2.COLOR_GRAY2BGR)
    h = max(image0.shape[0], image1.shape[0])
    w = image0.shape[1] + image1.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: image0.shape[0], : image0.shape[1]] = image0
    canvas[: image1.shape[0], image0.shape[1] :] = image1
    off = image0.shape[1]
    n = len(kpts0)
    step = max(1, n // max_lines)
    for i in range(0, n, step):
        p0 = (int(kpts0[i, 0]), int(kpts0[i, 1]))
        p1 = (int(kpts1[i, 0]) + off, int(kpts1[i, 1]))
        cv2.line(canvas, p0, p1, line_color, 1, lineType=cv2.LINE_AA)
        cv2.circle(canvas, p0, 2, point_color, -1, lineType=cv2.LINE_AA)
        cv2.circle(canvas, p1, 2, point_color, -1, lineType=cv2.LINE_AA)
    if output_path is not None:
        cv2.imwrite(str(output_path), canvas)
    return canvas


def viz_matches_mpl(
    image0: np.ndarray,
    image1: np.ndarray,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    output_path: Optional[Path] = None,
    dpi: int = 150,
):
    """Matplotlib variant (reference ``visualization.py:45-120``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6), dpi=dpi)
    for ax, img in zip(axes, (image0, image1)):
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.axis("off")
    fig.canvas.draw()
    for p0, p1 in zip(kpts0, kpts1):
        con = matplotlib.patches.ConnectionPatch(
            xyA=tuple(p0), coordsA=axes[0].transData,
            xyB=tuple(p1), coordsB=axes[1].transData,
            color="lime", linewidth=0.5,
        )
        fig.add_artist(con)
    axes[0].scatter(kpts0[:, 0], kpts0[:, 1], s=2, c="r")
    axes[1].scatter(kpts1[:, 0], kpts1[:, 1], s=2, c="r")
    if output_path is not None:
        fig.savefig(output_path, bbox_inches="tight")
        plt.close(fig)
    return fig
