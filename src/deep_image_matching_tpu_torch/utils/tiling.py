"""Image tiling: grid split with overlap and padding.

Copied from ``deep_image_matching_tpu/utils/tiling.py`` (numpy only); parity
with the reference ``utils/tiling.py:28-255``. Tiles are one stacked
(N, h, w[, C]) array, with dict views for the reference's API. The image is
padded to a size divisible by the window (split evenly top/bottom and
left/right), and the origins include the padded border's negative offset, so
a keypoint at tile-local (u, v) lies at (u + x0, v + y0) in the image.
``tile_size`` arguments are (width, height).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

IntPair = Tuple[int, int]


class Tiler:
    def __init__(self):
        self._n_rows = None
        self._n_cols = None

    @property
    def grid(self) -> Tuple[int, int]:
        return (self._n_rows, self._n_cols)

    def compute_tiles_by_size(
        self,
        input: np.ndarray,
        window_size: Union[int, IntPair],
        overlap: Union[int, IntPair] = 0,
    ) -> Tuple[Dict[int, np.ndarray], Dict[int, IntPair], Tuple[int, int, int, int]]:
        """Split an (H, W[, C]) image into overlapping tiles.

        Args:
          window_size: tile size; int or (x, y) i.e. (width, height).
          overlap: overlap between adjacent tiles; int or (x, y).

        Returns:
          tiles: {idx: (h, w[, C]) array}, row-major indices.
          origins: {idx: (x, y)} top-left corner in original image coords
            (can be negative on the padded border).
          padding: (top, bottom, left, right).
        """
        tiles_arr, origins_arr, padding = self.compute_tiles_array(
            input, window_size, overlap
        )
        tiles = {i: tiles_arr[i] for i in range(len(tiles_arr))}
        origins = {i: (int(origins_arr[i, 0]), int(origins_arr[i, 1])) for i in range(len(origins_arr))}
        return tiles, origins, padding

    def tile_origins(
        self,
        shape_hw: IntPair,
        window_size: Union[int, IntPair],
        overlap: Union[int, IntPair] = 0,
    ) -> Tuple[np.ndarray, Tuple[int, int, int, int], IntPair]:
        """Pure grid geometry, no pixels: returns (origins (N,2) x/y in
        original image coords, padding (top,bottom,left,right), (wh, ww)).
        Used by the device-tiling route, which uploads the image once and
        cuts the tiles on the device (``ops/tile_merge.py::cut_tiles``)."""
        if isinstance(window_size, int):
            wh, ww = window_size, window_size
        else:
            ww, wh = int(window_size[0]), int(window_size[1])  # (x, y) -> w, h
        if isinstance(overlap, int):
            oh, ow = overlap, overlap
        else:
            ow, oh = int(overlap[0]), int(overlap[1])
        if oh >= wh or ow >= ww:
            raise ValueError("overlap must be smaller than the window size")

        H, W = int(shape_hw[0]), int(shape_hw[1])
        pad_h = (-H) % wh
        pad_w = (-W) % ww
        top, bottom = pad_h // 2, pad_h - pad_h // 2
        left, right = pad_w // 2, pad_w - pad_w // 2

        sh, sw = wh - oh, ww - ow
        Hp, Wp = H + pad_h, W + pad_w
        ys = list(range(0, Hp - wh + 1, sh))
        xs = list(range(0, Wp - ww + 1, sw))
        self._n_rows, self._n_cols = len(ys), len(xs)
        origins = np.array(
            [(x - left, y - top) for y in ys for x in xs], dtype=np.int32
        )
        return origins, (top, bottom, left, right), (wh, ww)

    def compute_tiles_array(
        self,
        input: np.ndarray,
        window_size: Union[int, IntPair],
        overlap: Union[int, IntPair] = 0,
    ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int, int]]:
        """Array-native variant: returns (tiles (N,h,w[,C]), origins (N,2) x/y,
        padding)."""
        if not isinstance(input, np.ndarray):
            raise TypeError("input must be a numpy array")
        origins, padding, (wh, ww) = self.tile_origins(
            input.shape[:2], window_size, overlap
        )
        top, bottom, left, right = padding
        pad_spec = [(top, bottom), (left, right)] + [(0, 0)] * (input.ndim - 2)
        padded = np.pad(input, pad_spec, mode="constant")

        tiles = np.stack(
            [
                padded[y + top : y + top + wh, x + left : x + left + ww]
                for x, y in origins
            ],
            axis=0,
        )
        return tiles, origins, padding

    def compute_tiles_by_grid(
        self,
        input: np.ndarray,
        grid: IntPair = (2, 2),
        overlap: Union[int, IntPair] = 0,
    ) -> Tuple[Dict[int, np.ndarray], Dict[int, IntPair], Tuple[int, int, int, int]]:
        """Split into a fixed (rows, cols) grid (reference GRID mode)."""
        rows, cols = grid
        H, W = input.shape[:2]
        wh = -(-H // rows)
        ww = -(-W // cols)
        return self.compute_tiles_by_size(input, (ww, wh), overlap)
