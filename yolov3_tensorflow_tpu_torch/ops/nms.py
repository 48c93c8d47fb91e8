"""Batched greedy per-class NMS of the PyTorch port (JAX package:
ops/nms.py; reference: yolov3_post_process.py:43-129).

Static shapes throughout, as on the TPU:
  1. the score filter is a masked top-K selection over the flattened
     (H*W*B) candidates of all three heads at once;
  2. greedy per-class NMS walks the K score-sorted candidates; the
     pairwise IOU and same-class tests are one (N, K, K) suppression
     matrix, and the greedy pass is a loop over its rows;
  3. the result is a fixed (N, K, 10) tensor
     [x0, y0, x1, y1, conf, cls_prob, cls, score, head_idx, keep].

Ties order exactly as in JAX: ``jax.lax.top_k`` puts the lower index first
and ``jnp.argsort`` is stable, so both become ``torch.sort(stable=True)``
(CUDA ``topk`` promises no order among ties).  IOU is strict ``>``, with
the union clamped at 1e-12.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import Config
from .decoder import YOLOv3Decoder

def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(N, K, 4) corner boxes -> (N, K, K) IOU, row i = box i against all
    (yolov3_post_process.py:131-159: non-positive overlap -> 0).  The
    arithmetic is the JAX row function's, op for op."""
    box = boxes[:, :, None, :]
    other = boxes[:, None, :, :]
    lt = torch.maximum(box[..., 0:2], other[..., 0:2])
    rb = torch.minimum(box[..., 2:4], other[..., 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    area_b = (other[..., 2] - other[..., 0]) * (other[..., 3] - other[..., 1])
    union = torch.clamp(area_a + area_b - inter, min=1e-12)
    return inter / union


def greedy_nms(boxes, scores, classes, valid, nms_thresh: float):
    """Greedy class-aware NMS, batched over images.

    boxes (N,K,4) corner, scores (N,K), classes (N,K), valid (N,K) bool.
    Returns the keep mask (N,K) aligned with the INPUT order."""
    k = boxes.shape[1]
    neg = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(-neg, dim=1, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    scls = torch.gather(classes, 1, order)
    alive = torch.gather(valid, 1, order)
    idx = torch.arange(k, device=boxes.device)
    suppress = (pairwise_iou(sb) > nms_thresh) \
        & (scls[:, :, None] == scls[:, None, :]) \
        & (idx[None, :] > idx[:, None])[None]
    for i in range(k):
        # alive starts as the valid mask and is only ever cleared
        alive = alive & ~(alive[:, i:i + 1] & suppress[:, i])
    keep = torch.zeros_like(alive).scatter(1, order, alive)
    return keep & valid


class BatchedNMS:
    """Filter + cross-head per-class NMS on ``device``.

    ``__call__(raw_heads)`` -> (N, K, 10) detections.  Candidates below
    ``confidence_thresh`` never enter; boxes are normalized to [0, 1]
    (yolov3_post_process.py:65-68)."""

    def __init__(self, cfg: Config, score_thresh: float = None,
                 nms_thresh: float = None, top_k: int = None,
                 device="cuda"):
        self.cfg = cfg
        self.decoder = YOLOv3Decoder(cfg, device)
        self.score_thresh = (cfg.confidence_thresh if score_thresh is None
                             else score_thresh)
        self.nms_thresh = cfg.nms_thresh if nms_thresh is None else nms_thresh
        self.top_k = cfg.max_detections if top_k is None else top_k

    def _candidates(self, decoded_heads):
        """Flatten the three heads into one candidate table per image."""
        cfg = self.cfg
        cols = []
        for head_idx, (_, decoded, boxes) in enumerate(decoded_heads):
            h, w = cfg.head_grid_sizes[head_idx]
            n = decoded.shape[0]
            conf = decoded[..., 4].reshape(n, -1)
            if cfg.class_num >= 1:
                cls_prob = torch.amax(decoded[..., 5:], dim=-1).reshape(n, -1)
                cls_idx = torch.argmax(decoded[..., 5:], dim=-1).reshape(
                    n, -1).float()
                score = conf * cls_prob
            else:
                cls_prob = torch.ones_like(conf)
                cls_idx = torch.zeros_like(conf)
                score = conf
            scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                                 device=boxes.device)
            nboxes = (boxes / scale).reshape(n, -1, 4)
            head_col = torch.full_like(conf, float(head_idx))
            cols.append(torch.cat([
                nboxes, conf[..., None], cls_prob[..., None],
                cls_idx[..., None], score[..., None], head_col[..., None]],
                dim=-1))
        return torch.cat(cols, dim=1)  # (N, T, 9)

    def __call__(self, raw_heads: Sequence,
                 return_candidate_counts: bool = False):
        """-> (N, K, 10) detections; with return_candidate_counts also the
        (N,) number of above-threshold candidates BEFORE the static top-K
        truncation, so callers can see scenes that overflow
        ``max_detections``."""
        cand = self._candidates(self.decoder.decode(raw_heads))
        score = cand[..., 7]
        valid = score > self.score_thresh
        counts = valid.sum(dim=1, dtype=torch.int32)
        masked = torch.where(valid, score, torch.full_like(score,
                                                           -float("inf")))
        k = min(self.top_k, cand.shape[1])
        top_score, top_idx = torch.sort(masked, dim=1, descending=True,
                                        stable=True)
        top_score, top_idx = top_score[:, :k], top_idx[:, :k]
        sel = torch.gather(cand, 1, top_idx[..., None].expand(
            -1, -1, cand.shape[-1]))
        keep = greedy_nms(sel[..., 0:4], sel[..., 7], sel[..., 6],
                          top_score > self.score_thresh, self.nms_thresh)
        det = torch.cat([sel, keep[..., None].float()], dim=-1)
        if return_candidate_counts:
            return det, counts
        return det
