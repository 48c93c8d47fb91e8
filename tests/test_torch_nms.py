"""The port's decoder + batched NMS + post-processor against the JAX
package on the same raw heads (JAX gets them NHWC, the port NCHW).
Keep mask, class and head columns must be exactly equal; float columns
within 1e-6 (sigmoid/exp/softmax of two libraries, float32).  The inputs
include deliberately tied scores and an image with no detection."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.ops.decoder import YOLOv3Decoder as JaxDecoder
from yolov3_tensorflow_tpu.ops.nms import BatchedNMS as JaxNMS
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.infer.postprocess import (
    YOLOv3PostProcessor, resize_boxes, split_detections)
from yolov3_tensorflow_tpu_torch.ops.decoder import YOLOv3Decoder
from yolov3_tensorflow_tpu_torch.ops.nms import BatchedNMS, pairwise_iou

from . import torch_threads  # noqa: F401

FLOAT_ATOL = 1e-6
EXACT_COLS = [6, 8, 9]  # cls, head, keep


def cfg_pair(**kw):
    kw = dict(input_image_size=(64, 96, 3), **kw)
    return JaxConfig(**kw), Config(**kw)


def raw_heads(cfg, seed=0, n=3):
    """NHWC raw heads: image 0 random, image 1 with copied anchors (tied
    scores, overlapping boxes), image 2 with every objectness at -20."""
    rng = np.random.RandomState(seed)
    heads = []
    for c, (h, w), b in zip(cfg.head_channel_nums, cfg.head_grid_sizes,
                            cfg.box_num):
        x = (rng.randn(n, h, w, b, cfg.box_len) * 1.5).astype(np.float32)
        x[1, :, 1:] = x[1, :, :1]  # every column repeats column 0: ties
        x[1, 1:, :, 1:] = x[1, :1, :, :1]
        si = 8 if cfg.is_gaussian_yolo else 4
        x[2, ..., si] = -20.0  # no detection survives the threshold
        heads.append(x.reshape(n, h, w, c))
    return heads


def run_both(jcfg, cfg, heads, **kw):
    want = JaxNMS(jcfg, **kw)([jnp.asarray(h) for h in heads],
                              return_candidate_counts=True)
    got = BatchedNMS(cfg, device="cpu", **kw)(
        [torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2)))
         for h in heads], return_candidate_counts=True)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


@pytest.mark.parametrize("kw", [
    dict(class_num=3, confidence_thresh=0.3),
    dict(class_num=3, confidence_thresh=0.3, max_detections=16),
    dict(class_num=0, confidence_thresh=0.5),
    dict(class_num=2, confidence_thresh=0.2, is_gaussian_yolo=True),
    dict(class_num=4, confidence_thresh=0.05, nms_thresh=0.2)])
def test_batched_nms_matches_jax(kw):
    jcfg, cfg = cfg_pair(**kw)
    (want, want_counts), (got, got_counts) = run_both(
        jcfg, cfg, raw_heads(cfg))
    assert got.shape == want.shape == (3, min(cfg.max_detections, sum(
        h * w * b for (h, w), b in zip(cfg.head_grid_sizes, cfg.box_num))),
        10)
    np.testing.assert_array_equal(got[..., EXACT_COLS],
                                  want[..., EXACT_COLS])
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, rtol=0)
    np.testing.assert_array_equal(got_counts, want_counts)
    assert got[0, :, 9].sum() > 0 and got[1, :, 9].sum() > 0
    assert got[2, :, 9].sum() == 0 and got_counts[2] == 0
    # image 1's tied candidates were kept and suppressed as in JAX
    assert len(np.unique(got[1, got[1, :, 9] > 0, 7])) \
        < got[1, :, 9].sum()


def test_decoder_matches_jax():
    jcfg, cfg = cfg_pair(class_num=3)
    heads = raw_heads(cfg, seed=2)
    want = JaxDecoder(jcfg).decode([jnp.asarray(h) for h in heads])
    got = YOLOv3Decoder(cfg, device="cpu").decode(
        [torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2)))
         for h in heads])
    for gh, wh in zip(got, want):
        for g, w in zip(gh, wh):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=1e-5, rtol=1e-6)


def test_pairwise_iou_strict_and_clamped():
    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3],
                           [0.5, 0, 1.5, 1], [0, 0, 0, 0]]],
                         dtype=torch.float32)
    iou = pairwise_iou(boxes)[0]
    assert iou[0, 1] == 1.0 and iou[0, 2] == 0.0
    assert abs(iou[0, 3].item() - 1 / 3) < 1e-7
    assert iou[4, 4] == 0.0  # empty union clamps at 1e-12, no NaN


def test_postprocessor_splits_and_warns(caplog):
    _, cfg = cfg_pair(class_num=3, confidence_thresh=0.05,
                      max_detections=8)
    heads = [torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2)))
             for h in raw_heads(cfg)]
    post = YOLOv3PostProcessor(cfg, device="cpu")
    with caplog.at_level(logging.WARNING):
        per_image = post.process(heads)
    assert "NMS candidate overflow" in caplog.text
    det = BatchedNMS(cfg, device="cpu")(heads).numpy()
    want = split_detections(det)
    assert len(per_image) == 3
    for got_img, want_img in zip(per_image, want):
        for g, w in zip(got_img, want_img):
            np.testing.assert_array_equal(g, w)
            assert g.shape[1] == 8
    rows = resize_boxes(per_image[0], [96, 64, 96, 64])
    np.testing.assert_allclose(rows[0][:, :4],
                               per_image[0][0][:, :4] * [96, 64, 96, 64])
