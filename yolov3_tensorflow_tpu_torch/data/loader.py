"""Letterbox geometry of the PyTorch port, in numpy (JAX package:
data/loader.py:74-127; reference: dataset/file_util.py:44-59).

Only the decode-independent half of the loader: the serving path gets
decoded uint8 arrays and needs no PIL or cv2.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def letterbox_geometry(src_hw: Tuple[int, int],
                       dst_hw: Tuple[int, int]):
    """Replicate tf.image.resize_image_with_pad geometry: scale by the
    limiting axis (floor to int, at least 1 pixel), centre with
    floor-divided padding.  Returns ((rh, rw), (pad_top, pad_left))."""
    sh, sw = src_hw
    dh, dw = dst_hw
    ratio = min(dh / sh, dw / sw)
    rh = max(1, int(np.floor(sh * ratio)))
    rw = max(1, int(np.floor(sw * ratio)))
    pt, pl = (dh - rh) // 2, (dw - rw) // 2
    return (rh, rw), (pt, pl)


def letterbox_array(arr: np.ndarray, dst_hw: Tuple[int, int],
                    as_float: bool = True) -> np.ndarray:
    """NEAREST letterbox of a decoded RGB uint8 (H, W, 3) array -> BGR
    (file_util.py:44-59), with the centre convention floor((i+0.5)*src/dst)
    of every loader of the JAX package."""
    sh, sw = arr.shape[:2]
    (rh, rw), (pt, pl) = letterbox_geometry((sh, sw), dst_hw)
    ymap = np.minimum(((np.arange(rh) + 0.5) * (sh / rh)).astype(np.int64),
                      sh - 1)
    xmap = np.minimum(((np.arange(rw) + 0.5) * (sw / rw)).astype(np.int64),
                      sw - 1)
    resized = arr[ymap][:, xmap]
    canvas = np.zeros((dst_hw[0], dst_hw[1], 3), np.uint8)
    canvas[pt:pt + rh, pl:pl + rw] = resized
    bgr = canvas[..., ::-1]
    if as_float:
        return bgr.astype(np.float32) / 255.0
    return bgr.copy()
