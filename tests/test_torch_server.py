"""The port's letterbox geometry, un-letterboxing and dynamic batcher
against the JAX package: geometry and pixels exactly equal; the batcher
coalesces single-image requests, pads to the ladder and resolves every
future, on a CPU DetectionEngine too."""
import threading

import numpy as np
import pytest

from yolov3_tensorflow_tpu.data.loader import \
    letterbox_array as jax_letterbox_array
from yolov3_tensorflow_tpu.data.loader import \
    letterbox_geometry as jax_letterbox_geometry
from yolov3_tensorflow_tpu.infer.server import \
    _ladder_size as jax_ladder_size
from yolov3_tensorflow_tpu.infer.server import \
    unletterbox_boxes as jax_unletterbox_boxes
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.data.loader import (letterbox_array,
                                                     letterbox_geometry)
from yolov3_tensorflow_tpu_torch.infer.predict import Predictor
from yolov3_tensorflow_tpu_torch.infer.server import (DetectionEngine,
                                                      DynamicBatcher,
                                                      ServerStats,
                                                      _ladder_size,
                                                      unletterbox_boxes)
from yolov3_tensorflow_tpu_torch.models.detector import build_detector

from . import torch_threads  # noqa: F401

SIZES = [(480, 640), (640, 480), (416, 416), (100, 37), (4000, 8),
         (8, 4000), (417, 415), (1, 1)]


@pytest.mark.parametrize("dst", [(416, 416), (384, 480), (64, 96)])
def test_letterbox_geometry_equals_jax(dst):
    for src in SIZES:
        assert letterbox_geometry(src, dst) == jax_letterbox_geometry(
            src, dst)


@pytest.mark.parametrize("as_float", [False, True])
def test_letterbox_array_equals_jax(as_float):
    rng = np.random.RandomState(0)
    for src in [(48, 64), (64, 48), (37, 100), (5, 200), (64, 96)]:
        arr = rng.randint(0, 256, src + (3,), dtype=np.uint8)
        got = letterbox_array(arr, (64, 96), as_float=as_float)
        want = jax_letterbox_array(arr, (64, 96), as_float=as_float)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_unletterbox_equals_jax():
    rng = np.random.RandomState(1)
    rows = rng.uniform(-0.1, 1.1, (12, 9))
    for src in SIZES:
        np.testing.assert_array_equal(
            unletterbox_boxes(rows, src, (416, 416)),
            jax_unletterbox_boxes(rows, src, (416, 416)))
    empty = unletterbox_boxes(np.zeros((0, 9)), (10, 10), (416, 416))
    assert empty.shape == (0, 9)


def test_ladder_size_equals_jax():
    for n in range(1, 70):
        for cap in (1, 8, 64):
            assert _ladder_size(n, cap) == jax_ladder_size(n, cap)


class _RecordingEngine:
    """Engine double: records batch sizes; each image's one row carries
    its mean pixel value, so a misrouted answer shows."""

    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def __call__(self, images):
        with self.lock:
            self.batches.append(images.shape[0])
        return [np.full((1, 9), float(img.mean())) for img in images]


def test_batcher_coalesces_pads_and_routes():
    eng = _RecordingEngine()
    b = DynamicBatcher(eng, (8, 8), max_batch=8, batch_timeout_ms=200.0)
    b.start()
    try:
        b.submit(np.zeros((8, 8, 3), np.uint8)).result(timeout=10)
        values = (10, 20, 30)
        futs = [b.submit(np.full((8, 8, 3), v, np.uint8)) for v in values]
        for v, f in zip(values, futs):
            assert abs(f.result(timeout=10)[0, 0] - v) < 1e-6
        assert eng.batches[0] == 1
        assert 4 in eng.batches[1:]  # 3 requests padded to the ladder
        snap = b.stats.snapshot()
        assert snap["images"] == 4 and snap["batches"] == len(eng.batches)
    finally:
        b.stop()


def test_batcher_rejects_wrong_shape_and_fails_waiters():
    b = DynamicBatcher(_RecordingEngine(), (8, 8), max_batch=4)
    with pytest.raises(ValueError):
        b.submit(np.zeros((9, 8, 3), np.uint8))

    class Boom:
        def __call__(self, images):
            raise RuntimeError("device fell over")

    b = DynamicBatcher(Boom(), (8, 8), max_batch=4, batch_timeout_ms=50.0)
    b.start()
    try:
        with pytest.raises(RuntimeError, match="device fell over"):
            b.submit(np.zeros((8, 8, 3), np.uint8)).result(timeout=10)
    finally:
        b.stop()


def test_warmup_runs_every_ladder_shape_on_the_worker_thread():
    """CUDA libraries set up per thread, so the ladder is warmed on the
    thread that will serve."""
    seen = []

    class Engine:
        def __call__(self, images):
            seen.append((images.shape[0], threading.current_thread().name))
            return [np.zeros((0, 9)) for _ in images]

    b = DynamicBatcher(Engine(), (8, 8), max_batch=8)
    try:
        b.warmup()
        assert seen == [(1, "batcher"), (2, "batcher"), (4, "batcher"),
                        (8, "batcher")]
        assert len(b.submit(np.zeros((8, 8, 3), np.uint8)).result(
            timeout=10)) == 0
    finally:
        b.stop()


def test_stats_snapshot():
    s = ServerStats()
    s.record_batch(3, 4)
    s.record_request(5.0)
    s.record_request(7.0, error=True)
    snap = s.snapshot()
    assert snap["batch_size_histogram"] == {"4": 1}
    assert snap["errors"] == 1 and snap["latency_ms"]["p50"] == 7.0


def test_batcher_over_cpu_engine_answers_every_request():
    """Single-image requests of different original sizes, letterboxed,
    through DynamicBatcher -> DetectionEngine -> Predictor on the CPU;
    each answer equals the engine's answer on the same batch."""
    cfg = Config(input_image_size=(64, 64, 3), class_num=2,
                 confidence_thresh=0.3)
    pred = Predictor(cfg, build_detector(cfg, device="cpu").state_dict(),
                     device="cpu")
    engine = DetectionEngine(cfg, pred.predict, device="cpu")
    rng = np.random.RandomState(2)
    boxed = [letterbox_array(rng.randint(0, 256, (h, w, 3), np.uint8),
                             (64, 64), as_float=False)
             for h, w in [(50, 80), (90, 40), (64, 64), (33, 70), (70, 71),
                          (20, 90)]]
    b = DynamicBatcher(engine, (64, 64), max_batch=4,
                       batch_timeout_ms=500.0)
    b.start()
    try:
        futs = [b.submit(im) for im in boxed]
        answers = [f.result(timeout=60) for f in futs]
    finally:
        b.stop()
    assert b.stats.snapshot()["batch_size_histogram"] == {"4": 1, "2": 1}
    direct = engine(np.stack(boxed[:4])) + engine(np.stack(boxed[4:]))
    for got, want in zip(answers, direct):
        assert got.shape[1] == 9
        np.testing.assert_array_equal(got, want)
