"""Where the train step's time goes, on one NVIDIA GPU.

    python -m yolov3_tensorflow_tpu_torch.tools.profile_train \\
        [--backbone resnet-18] [--batch 128] [--backends fused xla] \\
        [--conv-backend xla winograd] [--winograd-min-channels 128 64] \\
        [--host-batch]

Builds ``YOLOv3Trainer`` for a YOLOv3 at 416x416 (the flagship ResNet-18
unless ``--backbone`` names another ported one, e.g. resnet-18-v2; bf16,
RAdam, augmentation on, seeded random weights, bench.py's labels) and,
for each conv backend (``--conv-backend``: "xla" direct convolution,
"winograd" the fused Winograd chain, once per channel floor of
``--winograd-min-channels``: 128 runs module 2's second block on it, 64
module 1's two blocks as well) and each noise backend, prints one JSON
line:

  * ``step_ms`` / ``img_per_s``: median host-clock time of a train step
    ending in ``torch.cuda.synchronize()``, over ``--steps`` steps;
  * ``device_busy_ms``, ``device_ops_per_step`` and ``idle_share``: CUDA
    kernel and copy time and count summed
    by ``torch.profiler`` over ``--profiled`` steps, against their wall
    time (which includes the profiler's own cost);
  * ``range_device_ms``: device time of the step's named ranges
    (``train.inputs``, ``train.forward``, ``train.loss``,
    ``train.optimizer``; the backward runs on autograd's own thread, so
    it is what remains of the busy time);
  * ``h2d_ms``: the host-to-device copies (with ``--host-batch`` the
    uint8 batch is fed from pageable host memory every step, as a loader
    without pinned memory would; by default it stays on the card, as in
    bench.py);
  * ``category_ms``: device time by kind of kernel (the Winograd
    kernel, the port's other kernels, convolutions, cuDNN's layout
    transposes, element-wise and reduction kernels, copies, other), and
    ``winograd_share`` the Winograd kernel's share of the busy time;
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
from ..models.detector import BACKBONES
from ..train.trainer import YOLOv3Trainer

RANGES = ("train.inputs", "train.forward", "train.loss", "train.optimizer")
# kernel-name markers of each category, checked in this order
CATEGORIES = (
    ("winograd kernel", ("winograd_f2x3", "winograd_stats_final")),
    ("port kernels", ("pool3x3s2", "bn_pool_relu", "noisy_normalize")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("conv", "xmma", "gemm", "cutlass", "sm90_", "cudnn")),
    ("element-wise and reductions", ("elementwise", "reduce_kernel",
                                     "Reduce", "foreach", "multi_tensor")),
    ("copies", ("Memcpy", "Memset")),
)


def categorize(name: str) -> str:
    for category, markers in CATEGORIES:
        if any(m in name for m in markers):
            return category
    return "other"


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (n, 416, 416, 3), dtype=np.uint8)
    labels = -np.ones((n, 32, 5), np.float32)
    labels[:, 0] = [0.5, 0.5, 0.3, 0.3, 0]
    labels[:, 1] = [0.25, 0.25, 0.1, 0.2, 0]
    return images, labels


def profile_backend(conv_backend, min_channels, backend, args):
    cfg = Config(input_image_size=(416, 416, 3), batch_size=args.batch,
                 max_boxes=32, optimizer="radam", compute_dtype="bfloat16",
                 is_augment=True, augment_backend=backend,
                 rectified_coord_num=-1, model_backbone=args.backbone,
                 conv_backend=conv_backend,
                 winograd_min_channels=min_channels)
    trainer = YOLOv3Trainer(cfg, "cuda", seed=args.seed)
    images, labels = _batch(args.batch, args.seed)
    if not args.host_batch:
        images = torch.from_numpy(images).cuda()
        labels = torch.from_numpy(labels).cuda()
    state = trainer.state
    for _ in range(3):  # warm up: kernel build, library set-up
        state, _ = trainer.train_step(state, images, labels)
    times = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.profiled):
            state, _ = trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_step = 1.0 / args.profiled
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    # the named ranges appear as device-side annotations spanning their
    # kernels: kept apart from the kernel and copy times
    ranges = {e.key: e.self_device_time_total / 1e3 * per_step
              for e in device if e.key in RANGES}
    device = [e for e in device if not e.key.startswith("train.")]
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    h2d_ms = sum(e.self_device_time_total for e in device
                 if "HtoD" in e.key) / 1e3
    ranges["train.backward (remainder)"] = \
        busy_ms * per_step - sum(ranges.values())
    categories = {}
    for e in device:
        c = categorize(e.key)
        categories[c] = categories.get(c, 0.0) \
            + e.self_device_time_total / 1e3 * per_step
    step_ms = float(np.median(times))
    return {
        "backbone": args.backbone, "conv_backend": conv_backend,
        "winograd_min_channels": min_channels, "backend": backend, "batch": args.batch,
        "host_batch": args.host_batch, "step_ms": step_ms,
        "img_per_s": args.batch / step_ms * 1e3,
        "profiled_steps": args.profiled,
        "profiled_wall_ms_per_step": wall_ms * per_step,
        "device_busy_ms_per_step": busy_ms * per_step,
        "device_ops_per_step": sum(e.count for e in device) * per_step,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "h2d_ms_per_step": h2d_ms * per_step,
        "range_device_ms_per_step": ranges,
        "category_ms_per_step": categories,
        "winograd_share": categories.get("winograd kernel", 0.0)
        / (busy_ms * per_step),
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3
                         * per_step,
                         "calls_per_step": e.count * per_step}
                        for e in device[:args.top]],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet-18",
                    choices=sorted(BACKBONES))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--backends", nargs="+", default=["fused", "xla"],
                    choices=["fused", "xla"])
    ap.add_argument("--conv-backend", nargs="+", default=["xla"],
                    choices=["xla", "winograd"])
    ap.add_argument("--winograd-min-channels", type=int, nargs="+",
                    default=[128])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--host-batch", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device available")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    # the channel floor matters only to the Winograd chain
    runs = [(conv, floor) for conv in args.conv_backend
            for floor in (args.winograd_min_channels if conv == "winograd"
                          else args.winograd_min_channels[:1])]
    for conv_backend, min_channels in runs:
        for backend in args.backends:
            torch.cuda.reset_peak_memory_stats()
            print(json.dumps({"gpu": gpu, **profile_backend(
                conv_backend, min_channels, backend, args)}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
