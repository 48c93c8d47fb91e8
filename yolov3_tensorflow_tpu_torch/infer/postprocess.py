"""Inference post-processing of the PyTorch port (JAX package:
infer/postprocess.py; reference: yolov3/yolov3_post_process.py:10-205).

The score filter and cross-head per-class NMS run on the device
(ops/nms.py); this module converts the fixed-size output into the
reference's per-head box lists, rescales to a target size (:161-172) and
draws results with per-head colors (:174-205).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config

# blue, green, red for head /8, /16, /32 (yolov3_post_process.py:18)
HEAD_BOX_COLOR = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]


def split_detections(detections: np.ndarray) -> List[List[np.ndarray]]:
    """(N, K, 10) NMS output -> per-image list of 3 per-head arrays of
    (k_i, 8) rows [x0 y0 x1 y1 conf cls_prob cls score] (normalized),
    mirroring apply_nms's per-head output (yolov3_post_process.py:94-105)."""
    out = []
    det = np.asarray(detections)
    for img in det:
        kept = img[img[:, 9] > 0.5]
        heads = []
        for h in range(3):
            rows = kept[kept[:, 8] == float(h)][:, 0:8]
            heads.append(rows.astype(np.float64))
        out.append(heads)
    return out


def resize_boxes(head_boxes: Sequence[np.ndarray],
                 target_size) -> List[np.ndarray]:
    """Normalized -> target scale (yolov3_post_process.py:161-172).
    target_size: [W, H, W, H]."""
    ts = np.asarray(target_size, np.float64)
    out = []
    for rows in head_boxes:
        if len(rows) == 0:
            out.append(rows)
        else:
            r = np.array(rows, np.float64)
            r[:, 0:4] = r[:, 0:4] * ts
            out.append(r)
    return out


def visualize(image: np.ndarray, head_boxes: Sequence[np.ndarray],
              src_box_size, image_path: str):
    """Draw per-head colored boxes + 'class|score' text, write to disk
    (yolov3_post_process.py:174-205).  image: float [0,1] (BGR, the
    network input).  Needs cv2, which only this function imports."""
    import cv2

    img = (255 * np.asarray(image)).astype(np.uint8).copy()
    height, width = img.shape[:2]
    image_size = np.tile(np.array([width, height], np.float64), 2)
    rescale = image_size / np.asarray(src_box_size, np.float64)
    for i, rows in enumerate(head_boxes):
        for box in np.asarray(rows).reshape(-1, 8):
            left, top, right, bottom = box[:4] * rescale
            left, top = max(left, 0), max(top, 0)
            right, bottom = min(right, width), min(bottom, height)
            cv2.rectangle(img, (int(round(left)), int(round(top))),
                          (int(round(right)), int(round(bottom))),
                          HEAD_BOX_COLOR[i],
                          max(1, round(3 * width / 1200)))
            cv2.putText(img, "{:.0f}|{:.2f}".format(round(box[6]), box[7]),
                        (int(round(left)), int(round(top))),
                        cv2.FONT_HERSHEY_SIMPLEX,
                        max(0.3, 0.3 * width / 1000), (255, 0, 0))
    cv2.imwrite(image_path, img)


class YOLOv3PostProcessor:
    """The device NMS plus the host-side conversion, mirroring the
    reference class surface (yolov3_post_process.py:10)."""

    def __init__(self, cfg: Config, score_thresh: Optional[float] = None,
                 nms_thresh: Optional[float] = None, device="cuda"):
        from ..ops.nms import BatchedNMS
        self.cfg = cfg
        self.nms = BatchedNMS(cfg, score_thresh, nms_thresh, device=device)

    def process(self, raw_heads) -> List[List[np.ndarray]]:
        """Raw 3-head outputs -> per-image, per-head normalized (k, 8)
        detection arrays.  Warns when a dense scene overflowed the static
        top-K candidate budget."""
        det, counts = self.nms(raw_heads, return_candidate_counts=True)
        counts = counts.cpu().numpy()
        if (counts > self.nms.top_k).any():
            logging.warning(
                "NMS candidate overflow: %d image(s) had more than "
                "max_detections=%d above-threshold candidates (max %d); "
                "raise Config.max_detections or confidence_thresh",
                int((counts > self.nms.top_k).sum()), self.nms.top_k,
                int(counts.max()))
        return split_detections(det.cpu().numpy())
