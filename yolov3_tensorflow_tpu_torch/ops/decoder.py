"""Prediction decoder of the PyTorch port (reference:
yolov3/yolov3_decoder.py:11-192; JAX package: ops/decoder.py).

For each head:
  * xy    = clip(sigmoid(t_xy), eps, hi) + grid_left_top
  * wh    = exp(clip(t_wh, -15, 15)) * anchor_wh_in_grid_units
  * score = clip(sigmoid(t_conf), eps, hi)   (x certainty, Gaussian YOLO)
  * class = clip(softmax(t_cls), eps, hi)
  * boxes = [xy - wh/2, xy + wh/2] corner form

with ``hi = min(1 - eps, _SAFE_HI)``.  Raw heads come from the port's
detector in NCHW; they are permuted to NHWC before the reshape to
(N, H, W, B, box_len), which is over channels-last as in the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device

# 1 - 1e-8 rounds to exactly 1.0 in f32, so the Keras epsilon alone makes
# the upper clip a no-op; 1 - 1e-7 is representable and the tighter of the
# two applies, so a log of a decoded probability stays finite.
_SAFE_HI = float(np.float32(1.0) - np.float32(1e-7))


def grid_left_top(height: int, width: int) -> np.ndarray:
    """Meshgrid left-top coords (H, W, 1, 2) ordered [x, y]
    (yolov3_decoder.py:47-60)."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    return np.stack([xs, ys], axis=-1).reshape(height, width, 1, 2).astype(
        np.float32)


def anchors_in_grid_units(anchor_boxes, grid_hw) -> np.ndarray:
    """Anchors ([W,H] normalized) scaled to grid units
    (yolov3_decoder.py:35-40)."""
    h, w = grid_hw
    return np.asarray(anchor_boxes, np.float32) * np.array(
        [w, h], np.float32)


def decode_single_head(raw, left_top, anchors, class_num: int, eps: float,
                       gaussian: bool = False):
    """raw: (N, H, W, B, box_len) -> (raw_txywh, decoded, corner_boxes).

    With ``gaussian`` the raw layout is [t_xywh, sigma_xywh, obj, classes]
    and the decoded objectness is multiplied by the localization
    certainty (1 - mean sigma); the decoded layout stays
    [xy, wh, score, probs]."""
    raw = raw.float()
    hi = min(1.0 - eps, _SAFE_HI)
    xy = torch.clamp(torch.sigmoid(raw[..., 0:2]), eps, hi)
    xy = xy + left_top
    wh = torch.exp(torch.clamp(raw[..., 2:4], -15.0, 15.0)) * anchors
    si = 8 if gaussian else 4
    score = torch.clamp(torch.sigmoid(raw[..., si:si + 1]), eps, hi)
    if gaussian:
        sigma = torch.clamp(torch.sigmoid(raw[..., 4:8]), eps, hi)
        certainty = 1.0 - torch.mean(sigma, dim=-1, keepdim=True)
        score = torch.clamp(score * certainty, eps, hi)
    if class_num >= 1:
        probs = torch.clamp(torch.softmax(raw[..., si + 1:], dim=-1),
                            eps, hi)
        decoded = torch.cat([xy, wh, score, probs], dim=-1)
    else:
        decoded = torch.cat([xy, wh, score], dim=-1)
    half = wh / 2.0
    boxes = torch.cat([xy - half, xy + half], dim=-1)
    return raw[..., 0:4], decoded, boxes


class YOLOv3Decoder:
    """Per-head grids and anchors from a Config, on ``device``; decodes
    the three raw heads, NCHW (N, C, H, W) or (N, H, W, B, box_len)."""

    def __init__(self, cfg: Config, device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.class_num = cfg.class_num
        self.box_len = cfg.box_len
        self.box_num = cfg.box_num
        self.grids = cfg.head_grid_sizes
        self.left_tops = [torch.from_numpy(grid_left_top(h, w)).to(device)
                          for (h, w) in self.grids]
        self.anchors = [torch.from_numpy(anchors_in_grid_units(a, g))
                        .to(device)
                        for a, g in zip(cfg.anchor_boxes, self.grids)]

    def _reshape(self, raw, head_idx):
        h, w = self.grids[head_idx]
        b = self.box_num[head_idx]
        return raw.permute(0, 2, 3, 1).reshape(-1, h, w, b, self.box_len)

    def decode(self, raw_heads: Sequence) -> List[Tuple]:
        """raw_heads: (p8, p16, p32).  Returns, per head,
        (raw_txywh, decoded, corner_boxes) like yolov3_decoder.py:84-87."""
        out = []
        for i, raw in enumerate(raw_heads):
            if raw.ndim == 4:
                raw = self._reshape(raw, i)
            out.append(decode_single_head(raw, self.left_tops[i],
                                          self.anchors[i], self.class_num,
                                          self.cfg.epsilon,
                                          self.cfg.is_gaussian_yolo))
        return out
