"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card (tolerance:
bitwise equality), drives the
serving path of the flagship ResNet-18 YOLOv3 at 416x416 (seeded random
weights) through ``Predictor``, ``DetectionEngine`` and ``DynamicBatcher``,
and checks what comes out.  Each phase prints one line; a failed check
raises, so any failure exits non-zero.  The line before the last is the
per-kernel JSON record, the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when no CUDA device is available.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

FLAGSHIP_HW = (416, 416)
FLAGSHIP_BATCH = 64
SEED = 0
TIMED_LAUNCHES = 20  # per kernel; the median is reported


def phase(name: str, **fields) -> None:
    print(f"{name}: {json.dumps(fields)}", flush=True)


def cuda_time_ms(fn, iters: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def gpu_identity() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernels --
def stem_inputs(n, c, h, w, kind, device, seed):
    """bf16 y (N, C, H, W) and f32 inv, shift (C,) for one stem case."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "ties":  # quantized ramp: many equal taps per window
        y = (torch.arange(n * c * h * w) % 7 - 3).float().reshape(
            n, c, h, w) * 0.25
    else:
        y = torch.randn(n, c, h, w, generator=g)
    if kind == "negative":
        y = -y.abs() - 0.01
    inv = torch.rand(c, generator=g) + 0.5
    shift = torch.randn(c, generator=g) * 0.2
    if kind == "negative":
        shift = -shift.abs()
    if kind == "inv0":
        inv[c // 2] = 0.0
    return (y.to(device=device, dtype=torch.bfloat16), inv.to(device),
            shift.to(device))


def check_stem_kernel(device):
    """bn_pool_relu_eval on the card vs its plain version on the card:
    bitwise equal output on the flagship shape and the edge cases."""
    import torch

    from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
        bn_pool_relu_eval, bn_pool_relu_eval_reference)

    n, c = FLAGSHIP_BATCH, 64
    h, w = FLAGSHIP_HW[0] // 2, FLAGSHIP_HW[1] // 2
    cases = [("flagship", (n, c, h, w), "randn"),
             ("odd_13x11", (4, 8, 13, 11), "randn"),
             ("inv0", (4, 8, 16, 16), "inv0"),
             ("all_negative", (4, 8, 16, 16), "negative"),
             ("ties", (4, 8, 17, 16), "ties")]
    max_err = 0.0
    for i, (name, shape, kind) in enumerate(cases):
        y, inv, shift = stem_inputs(*shape, kind, device, SEED + i)
        got = bn_pool_relu_eval(y, inv, shift)
        ref = bn_pool_relu_eval_reference(y, inv, shift)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"stem {name}: {got.shape} {got.dtype} vs "
                                 f"{ref.shape}")
        err = (got.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"stem {name}: kernel differs from the "
                                 f"plain version (max abs err {err})")
        phase("kernels.bn_pool_relu_eval.case", case=name, shape=shape,
              bitwise_equal=True)

    y, inv, shift = stem_inputs(n, c, h, w, "randn", device, SEED)
    ho, wo = -(-h // 2), -(-w // 2)
    nbytes = n * c * h * w * 2 + n * c * ho * wo * 2 + 2 * c * 4
    ops = n * c * ho * wo * 27  # 9 taps x (mul, add, max)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    kernel_ms = cuda_time_ms(lambda: bn_pool_relu_eval(y, inv, shift))
    plain_ms = cuda_time_ms(
        lambda: bn_pool_relu_eval_reference(y, inv, shift))
    record = {
        "name": "bn_pool_relu_eval", "route": "cuda",
        "source": "yolov3_tensorflow_tpu_torch/ops/csrc/stem_pool.cu",
        "replaces": "yolov3_tensorflow_tpu/ops/stem_pool.py:580",
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes it
    }
    phase("kernels.bn_pool_relu_eval", shape=[n, c, h, w], bytes=nbytes,
          ms=kernel_ms, bound_ms=record["bound_ms"],
          bound_by=record["bound_by"], plain_ms=plain_ms,
          gbytes_per_s=nbytes / kernel_ms / 1e6)
    return [record]


# -------------------------------------------------------------- model --
def seeded_state_dict(cfg, device):
    """Flagship weights from SEED, with non-trivial BN scale, bias and
    running statistics."""
    import torch

    from yolov3_tensorflow_tpu_torch.models.detector import build_detector
    g = torch.Generator().manual_seed(SEED)
    model = build_detector(cfg, "cpu", generator=g)
    sd = model.state_dict()
    for key, t in sd.items():
        c = t.shape[0]
        if key.endswith(".scale"):  # keeps the heads of order 1
            t.copy_(torch.rand(c, generator=g) * 0.6 + 0.6)
        elif key.endswith(".mean"):
            t.copy_(torch.randn(c, generator=g) * 0.1)
        elif key.endswith(".var"):
            t.copy_(torch.rand(c, generator=g) + 0.5)
        elif key.endswith(".bias") and "FusedBatchNorm" in key:
            t.copy_(torch.randn(c, generator=g) * 0.1)
    return {k: v.to(device) for k, v in sd.items()}


def check_model(cfg, sd, images, device, gpu):
    """Flagship eval forward at batch 64 with the kernel stem and with the
    plain composition ("xla"): stems bitwise equal, heads within 3e-2."""
    import torch

    from yolov3_tensorflow_tpu_torch.infer.predict import (Predictor,
                                                           normalize_images)
    fused = Predictor(cfg, sd, device)
    plain = Predictor(cfg.replace(stem_backend="xla"), sd, device)
    x = normalize_images(torch.from_numpy(images).to(device))
    with torch.inference_mode():
        stems = [p.model.backbone.stem_conv_bn_pool_relu(
            x, p.model.backbone.stem) for p in (fused, plain)]
        heads = [p.predict(images) for p in (fused, plain)]
    torch.cuda.synchronize()
    if not torch.equal(stems[0].view(torch.int16),
                       stems[1].to(torch.bfloat16).view(torch.int16)):
        raise AssertionError("model stem: kernel and plain stems differ")
    head_err = 0.0
    for a, b in zip(*heads):
        if not torch.isfinite(a).all():
            raise AssertionError("model: non-finite head values")
        head_err = max(head_err, (a - b).abs().max().item())
    if head_err > 3e-2:
        raise AssertionError(f"model: kernel vs plain heads differ by "
                             f"{head_err} > 3e-2")
    expect = [(FLAGSHIP_BATCH, c, h, w) for c, (h, w) in
              zip(cfg.head_channel_nums, cfg.head_grid_sizes)]
    if [tuple(h.shape) for h in heads[0]] != expect:
        raise AssertionError(f"model: head shapes {heads[0]} vs {expect}")

    steps = 10
    with torch.inference_mode():
        for _ in range(3):
            fused.predict(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fused.predict(images)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    phase("model", input=list(cfg.input_image_size),
          batch=FLAGSHIP_BATCH, stem_bitwise_equal=True,
          head_max_abs_err_vs_plain_stem=head_err, head_tolerance=3e-2,
          eval_forward_img_per_s=FLAGSHIP_BATCH * steps / dt, gpu=gpu)
    return fused


# -------------------------------------------------------------- serve --
def serve(cfg, predictor, device, gpu, n_requests=16, max_batch=8):
    """DynamicBatcher over a DetectionEngine on the card: single-image
    requests of different original sizes, each answer held against a
    direct engine call on the same batch."""
    from yolov3_tensorflow_tpu_torch.data.loader import letterbox_array
    from yolov3_tensorflow_tpu_torch.infer.server import (DetectionEngine,
                                                          DynamicBatcher,
                                                          unletterbox_boxes)
    from yolov3_tensorflow_tpu_torch.ops.stem_pool import bn_pool_relu_eval

    rng = np.random.RandomState(SEED)
    hw = cfg.input_image_size[:2]
    sizes = [(int(rng.randint(120, 900)), int(rng.randint(120, 900)))
             for _ in range(n_requests)]
    originals = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                 for h, w in sizes]
    boxed = [letterbox_array(a, hw, as_float=False) for a in originals]

    engine = DetectionEngine(cfg, predictor.predict, device=device)
    batcher = DynamicBatcher(engine, hw, max_batch=max_batch,
                             batch_timeout_ms=200.0)
    try:
        batcher.warmup()  # starts the worker and warms its thread
        bn_pool_relu_eval.launches = 0
        done = {}
        t0 = time.perf_counter()
        futures = []
        for i, im in enumerate(boxed):
            ts = time.perf_counter()
            fut = batcher.submit(im)
            fut.add_done_callback(
                lambda f, i=i, ts=ts:
                done.__setitem__(i, time.perf_counter() - ts))
            futures.append(fut)
        answers = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        launches = {"bn_pool_relu_eval": bn_pool_relu_eval.launches}
    finally:
        batcher.stop()
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"serve: a kernel was never launched on the "
                             f"main path: {launches}")
    stats = batcher.stats.snapshot()

    kept, direct_ms = 0, []
    for start in range(0, n_requests, max_batch):
        t0 = time.perf_counter()
        direct = engine(np.stack(boxed[start:start + max_batch]))
        direct_ms.append((time.perf_counter() - t0) * 1e3)
        for j, rows in enumerate(direct):
            got = answers[start + j]
            if not np.array_equal(got, rows):
                raise AssertionError(f"serve: request {start + j} differs "
                                     "from the direct engine call")
            if not np.isfinite(rows).all():
                raise AssertionError("serve: non-finite detections")
            kept += len(rows)
            px = unletterbox_boxes(rows, sizes[start + j], hw)
            h, w = sizes[start + j]
            if len(px) and (px[:, [0, 2]].max() > w or px[:, [1, 3]].max()
                            > h or px[:, :4].min() < 0):
                raise AssertionError("serve: un-letterboxed box outside "
                                     "the image")
    if kept == 0:
        raise AssertionError("serve: NMS kept no box at all")
    lat = sorted(done.values())
    phase("serve", requests=len(answers), batches=stats["batches"],
          batch_size_histogram=stats["batch_size_histogram"],
          boxes_kept=kept, p50_latency_ms=lat[len(lat) // 2] * 1e3,
          img_per_s=n_requests / wall, direct_engine_ms=direct_ms, gpu=gpu)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from yolov3_tensorflow_tpu_torch.config import Config
    from yolov3_tensorflow_tpu_torch.ops.cuda_build import kernel_library

    device = torch.device("cuda:0")
    gpu = gpu_identity()
    print(gpu, flush=True)
    phase("device", gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    kernel_library(verbose=True)
    phase("build", seconds=time.perf_counter() - t0)

    records = check_stem_kernel(device)
    print("kernels: " + json.dumps([r["name"] for r in records]),
          flush=True)

    cfg = Config(input_image_size=FLAGSHIP_HW + (3,),
                 batch_size=FLAGSHIP_BATCH, max_boxes=32,
                 confidence_thresh=0.3)
    sd = seeded_state_dict(cfg, device)
    images = np.random.RandomState(SEED).randint(
        0, 256, (FLAGSHIP_BATCH,) + FLAGSHIP_HW + (3,), dtype=np.uint8)
    predictor = check_model(cfg, sd, images, device, gpu)
    launches = serve(cfg, predictor, device, gpu)

    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
