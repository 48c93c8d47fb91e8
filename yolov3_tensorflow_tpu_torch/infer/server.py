"""Dynamic batching for the serving path of the PyTorch port (JAX
package: infer/server.py:60-275).

  * **Request coalescing.** Single-image requests are queued and
    assembled into batches (up to ``max_batch``, waiting at most
    ``batch_timeout_ms`` after the first request) so the card runs at
    batch efficiency.
  * **Shape ladder.** Assembled batches are zero-padded up to the next
    power of two (capped at ``max_batch``); padding rows are sliced off
    before post-processing.
  * **Device post-processing.** Score filter + NMS run on the device
    (ops/nms.py) as part of the batch; the host only maps the final
    (k, 8) detection rows back to each request's original pixel frame
    (inverting the exact letterbox geometry of data/loader.py).

The HTTP front end of the JAX package (``InferenceServer``) decodes JPEG
request bodies with PIL and is not ported yet.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..data.loader import letterbox_geometry
from .postprocess import YOLOv3PostProcessor

_WARMUP = object()  # queue marker: run the ladder warmup on the worker


def unletterbox_boxes(rows: np.ndarray, src_hw: Tuple[int, int],
                      dst_hw: Tuple[int, int]) -> np.ndarray:
    """Map normalized letterbox-frame corner boxes back to original-image
    pixels: invert the exact :func:`letterbox_geometry` placement (scale
    by the limiting axis, centre with floor-divided padding), then clamp
    to the image bounds.  rows: (k, >=4) with [x0 y0 x1 y1 ...]
    normalized to the model input frame."""
    if len(rows) == 0:
        return np.asarray(rows, np.float64).reshape(0, rows.shape[1]
                                                    if rows.ndim == 2 else 8)
    (rh, rw), (pt, pl) = letterbox_geometry(src_hw, dst_hw)
    sh, sw = src_hw
    dh, dw = dst_hw
    out = np.array(rows, np.float64)
    # normalized -> letterbox pixels
    out[:, 0:4] = out[:, 0:4] * np.array([dw, dh, dw, dh], np.float64)
    # remove padding, undo the resize ratio
    out[:, [0, 2]] = (out[:, [0, 2]] - pl) * (sw / rw)
    out[:, [1, 3]] = (out[:, [1, 3]] - pt) * (sh / rh)
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0.0, float(sw))
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0.0, float(sh))
    return out


class DetectionEngine:
    """Batch uint8 letterboxed images -> per-image detection rows.

    Bundles the model forward (``Predictor.predict`` — raw 3-head
    outputs) with the device NMS + host conversion
    (YOLOv3PostProcessor, on ``device``).  Returns, per image, one (k, 8) float array of
    [x0 y0 x1 y1 conf cls_prob cls score] rows normalized to the model
    input frame (heads concatenated; the head index is appended as a 9th
    column for response labeling)."""

    def __init__(self, cfg: Config, predict_fn, device="cuda"):
        self.cfg = cfg
        self.predict_fn = predict_fn
        self.post = YOLOv3PostProcessor(cfg, device=device)

    def __call__(self, images: np.ndarray) -> List[np.ndarray]:
        heads = self.predict_fn(images)
        per_image = self.post.process(heads)
        out = []
        for head_rows in per_image:
            rows = [np.concatenate(
                        [np.asarray(r, np.float64).reshape(-1, 8),
                         np.full((len(r), 1), float(h))], axis=1)
                    for h, r in enumerate(head_rows) if len(r)]
            out.append(np.concatenate(rows, axis=0) if rows
                       else np.zeros((0, 9), np.float64))
        return out


class ServerStats:
    """Lock-protected batching/latency counters for ``GET /stats``."""

    def __init__(self, latency_window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.batches = 0
        self.errors = 0
        self.batch_hist = {}
        self._lat_ms = []
        self._window = latency_window

    def record_batch(self, n_real: int, n_padded: int):
        with self._lock:
            self.batches += 1
            self.images += n_real
            key = str(n_padded)
            self.batch_hist[key] = self.batch_hist.get(key, 0) + 1

    def record_request(self, latency_ms: float, error: bool = False):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            self._lat_ms.append(latency_ms)
            if len(self._lat_ms) > self._window:
                self._lat_ms = self._lat_ms[-self._window:]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            q = (lambda p: lat[min(len(lat) - 1,
                                   int(p * len(lat)))] if lat else 0.0)
            return {
                "requests": self.requests,
                "images": self.images,
                "batches": self.batches,
                "errors": self.errors,
                "batch_size_histogram": dict(self.batch_hist),
                "avg_coalesced": (self.images / self.batches
                                  if self.batches else 0.0),
                "latency_ms": {"p50": q(0.50), "p90": q(0.90),
                               "p99": q(0.99)},
            }


def _ladder_size(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch — the shape ladder
    keeps the number of distinct batch shapes at log2(max_batch)+1."""
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


class DynamicBatcher:
    """Coalesces single-image submissions into padded device batches.

    ``submit`` enqueues one letterboxed uint8 (H, W, 3) image and returns
    a Future resolving to that image's (k, 9) detection rows.  A worker
    thread blocks on the first queued item, keeps collecting until
    ``max_batch`` images or ``batch_timeout_ms`` elapse, zero-pads to the
    shape ladder, and runs the engine once for the whole batch."""

    def __init__(self, engine, input_hw: Tuple[int, int],
                 max_batch: int = 64, batch_timeout_ms: float = 2.0,
                 stats: Optional[ServerStats] = None):
        self.engine = engine
        self.input_hw = tuple(input_hw)
        self.max_batch = int(max_batch)
        self.timeout_s = float(batch_timeout_ms) / 1000.0
        self.stats = stats or ServerStats()
        self._q: "queue.Queue" = queue.Queue()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ api --
    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batcher")
        self._thread.start()

    def stop(self):
        self._running = False
        self._q.put(None)  # unblock the worker
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def submit(self, image: np.ndarray) -> Future:
        image = np.asarray(image, np.uint8)
        expect = self.input_hw + (3,)
        if image.shape != expect:
            raise ValueError(f"batcher expects letterboxed {expect}, "
                             f"got {image.shape}")
        fut: Future = Future()
        self._q.put((image, fut))
        return fut

    def warmup(self):
        """Run every ladder shape once on the worker thread before
        serving, and wait for it; starts the worker.  It has to be the
        worker's thread: the first engine call on a thread pays that
        thread's CUDA library set-up (cuDNN handles and plans), which on
        an H100 made the first served batch several times slower than a
        warm one."""
        self.start()
        done: Future = Future()
        self._q.put((_WARMUP, done))
        done.result()

    def _run_warmup(self, done: Future):
        n = 1
        shapes = []
        while True:
            shapes.append(n)
            if n >= self.max_batch:
                break
            n = min(n * 2, self.max_batch)
        try:
            for b in shapes:
                zeros = np.zeros((b,) + self.input_hw + (3,), np.uint8)
                t0 = time.monotonic()
                self.engine(zeros)
                logging.info("serve warmup: batch %d ran in %.1fs",
                             b, time.monotonic() - t0)
        except Exception as e:  # noqa: BLE001 — reported to the caller
            done.set_exception(e)
        else:
            done.set_result(None)

    # --------------------------------------------------------- worker --
    def _collect(self):
        """One batch: block for the first item, then drain until the
        deadline or max_batch.  Returns None on stop, or the warmup item
        itself when it comes first."""
        first = self._q.get()
        if first is None or first[0] is _WARMUP:
            return first
        items = [first]
        deadline = time.monotonic() + self.timeout_s
        while len(items) < self.max_batch:
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            try:
                nxt = self._q.get(timeout=remain)
            except queue.Empty:
                break
            if nxt is None:
                break
            if nxt[0] is _WARMUP:  # runs after this batch
                self._q.put(nxt)
                break
            items.append(nxt)
        return items

    def _loop(self):
        while self._running:
            items = self._collect()
            if not items:
                continue
            if items[0] is _WARMUP:
                self._run_warmup(items[1])
                continue
            images = np.stack([im for im, _ in items])
            n = len(items)
            padded = _ladder_size(n, self.max_batch)
            if padded != n:
                pad = np.zeros((padded - n,) + images.shape[1:], np.uint8)
                images = np.concatenate([images, pad], axis=0)
            try:
                results = self.engine(images)[:n]
                self.stats.record_batch(n, padded)
                for (_, fut), rows in zip(items, results):
                    fut.set_result(rows)
            except Exception as e:  # noqa: BLE001 — fail every waiter
                logging.exception("serve batch failed")
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
