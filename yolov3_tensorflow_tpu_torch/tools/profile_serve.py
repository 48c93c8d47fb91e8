"""Where the serving path's time goes, on one NVIDIA GPU.

    python -m yolov3_tensorflow_tpu_torch.tools.profile_serve \\
        [--backbone resnet-18] [--batches 8 64]

For each batch size, runs ``DetectionEngine`` (Predictor forward + NMS +
host conversion) on a YOLOv3 at 416x416 (the flagship ResNet-18 unless
``--backbone`` names another ported one) with seeded random weights and
prints one JSON line per batch:

  * ``stage_ms``: median host-clock time of each stage, each ending in
    ``torch.cuda.synchronize()`` (forward, NMS, host conversion);
  * ``device_busy_ms`` and ``idle_share``: CUDA kernel time summed by
    ``torch.profiler`` over one engine call, against its wall time;
  * ``top_kernels``: the kernels with the most device time.

Needs a CUDA device; fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import Config
from ..infer.predict import Predictor
from ..infer.server import DetectionEngine
from ..models.detector import BACKBONES, build_detector


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def profile_batch(engine, predictor, images, reps=10):
    engine(images)  # warm up: kernel build, cuDNN algorithm choice
    fwd_ms, heads = _median_ms(lambda: predictor.predict(images), reps)
    nms_ms, _ = _median_ms(
        lambda: engine.post.nms(heads, return_candidate_counts=True), reps)
    total_ms, _ = _median_ms(lambda: engine(images), reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {
        "batch": int(images.shape[0]),
        "stage_ms": {"forward": fwd_ms, "nms": nms_ms,
                     "host_conversion": total_ms - fwd_ms - nms_ms,
                     "engine_total": total_ms},
        "img_per_s": images.shape[0] / total_ms * 1e3,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_kernels": [{"name": e.key[:80],
                         "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in kernels[:8]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet-18",
                    choices=sorted(BACKBONES))
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = Config(input_image_size=(416, 416, 3), confidence_thresh=0.3,
                 model_backbone=args.backbone)
    gen = torch.Generator().manual_seed(args.seed)
    sd = build_detector(cfg, "cpu", generator=gen).state_dict()
    predictor = Predictor(cfg, sd, "cuda")
    engine = DetectionEngine(cfg, predictor.predict, device="cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.RandomState(args.seed)
    for b in args.batches:
        images = rng.randint(0, 256, (b, 416, 416, 3), dtype=np.uint8)
        with torch.inference_mode():
            row = profile_batch(engine, predictor, images)
        print(json.dumps({"gpu": gpu, "backbone": args.backbone, **row}),
              flush=True)


if __name__ == "__main__":
    main()
