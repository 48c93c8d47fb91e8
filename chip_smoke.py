"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card at the main
paths' shapes and at edge cases, and times it beside its bound and the
closest PyTorch library call.  Tolerance: bitwise equality for the stem
and noise kernels; the Winograd kernel, whose tensor-core sums run in
another order than the plain version's float32 product, within one bf16
step per output (|k - p| <= 2^-7 |p| + 1e-4 max|p|) with at least
WINOGRAD_BITWISE_SHARE of them bitwise (out, and out3 of EPI_BN_ADD), its
per-channel sums within 1e-5 of their terms' summed magnitudes, and its
aux output bitwise.
Then it drives the two paths of two models at 416x416 (seeded random
weights): the flagship ResNet-18 YOLOv3, whose stem runs the fused BN +
pool + relu kernels, and ResNet-18-v2 YOLOv3, whose stem runs the
pool-only kernels:

  * serving: the batch-64 eval forward, held against the plain stem
    (``stem_backend="xla"``), and 16 requests through ``Predictor``,
    ``DetectionEngine`` and ``DynamicBatcher``;
  * training: ``YOLOv3Trainer.train_step`` at batch 128 in bf16 with
    RAdam: 6 steps on one fixed batch without augmentation, whose loss
    must fall, then 3 warm-up and 20 timed steps with augmentation: for
    the flagship with each noise backend (``augment_backend`` "fused" and
    "xla"), for v2 with "auto";
  * the flagship's train step at ``conv_backend="winograd"``
    (``train.resnet-18.winograd``): module 2's second block on the fused
    Winograd chain, two forward and two gradient launches of the Winograd
    kernel per step; the descent check, then 3 warm-up and 20 timed steps
    with augment_backend "auto";
  * the same at ``winograd_min_channels=64``
    (``train.resnet-18.winograd64``): module 1's two blocks join the chain,
    the second through the residual-boundary modes, twelve Winograd
    launches per step (WINOGRAD_PATHS).

Each path runs with every kernel's launch count set to 0 just before it
and fails if one of its kernels was not launched.  Each phase prints one
line; a failed check raises, so any failure exits non-zero.  The seconds
of each phase and the total come on lines of their own, then the
per-kernel JSON record, then the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when no CUDA device is available.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 on the tensor cores

FLAGSHIP = "resnet-18"
V2 = "resnet-18-v2"
FLAGSHIP_HW = (416, 416)
FLAGSHIP_BATCH = 64  # serving (bench.py --infer)
TRAIN_BATCH = 128  # training (bench.py)
SEED = 0
TIMED_LAUNCHES = 20  # per kernel; the median is reported
DESCENT_STEPS = 6
WARMUP_STEPS, TIMED_STEPS = 3, 20
# the main-path run whose launch count each kernel's record reports
KERNEL_PATHS = {"bn_pool_relu_eval": "serve.resnet-18",
                "bn_pool_relu_fwd": "train.resnet-18",
                "bn_pool_relu_bwd": "train.resnet-18",
                "noisy_normalize": "train.resnet-18",
                "max_pool_s2_eval": "serve.resnet-18-v2",
                "max_pool_s2_fwd": "train.resnet-18-v2",
                "max_pool_s2_bwd": "train.resnet-18-v2",
                "winograd_call.conv_stats": "train.resnet-18.winograd",
                "winograd_call.bn_act_conv_stats": "train.resnet-18.winograd",
                "winograd_call.dyeff_conv": "train.resnet-18.winograd",
                "winograd_call.dyeff_conv_bn_act":
                    "train.resnet-18.winograd",
                "winograd_call.bn_add_conv_stats":
                    "train.resnet-18.winograd64",
                "winograd_call.dyeff_conv_bn_add":
                    "train.resnet-18.winograd64"}
# the Winograd chain's shapes (N, C, Co, H, W) on the flagship train path
# at 416x416, batch 128: module 2's second block, and module 1's blocks
# at winograd_min_channels=64
WINOGRAD_SHAPES = {
    "module2_chain": (TRAIN_BATCH, 128, 128, FLAGSHIP_HW[0] // 8,
                      FLAGSHIP_HW[1] // 8),
    "module1_chain": (TRAIN_BATCH, 64, 64, FLAGSHIP_HW[0] // 4,
                      FLAGSHIP_HW[1] // 4)}
# each Winograd path: its winograd_min_channels, its chain shape (the
# shape of the records of the modes KERNEL_PATHS gives it), and its
# launches per train step of each mode (JAX models/resnet18.py:123-199: a chain block
# runs two forward and two gradient launches; module 1's second block
# starts from the first's deferred boundary)
WINOGRAD_PATHS = {
    "train.resnet-18.winograd": (128, "module2_chain", {
        "conv_stats": 1, "bn_act_conv_stats": 1, "dyeff_conv": 1,
        "dyeff_conv_bn_act": 1}),
    "train.resnet-18.winograd64": (64, "module1_chain", {
        "conv_stats": 2, "bn_act_conv_stats": 3, "bn_add_conv_stats": 1,
        "dyeff_conv": 2, "dyeff_conv_bn_add": 1, "dyeff_conv_bn_act": 3})}
# least share of the Winograd kernel's bf16 outputs bit-equal to the plain
# version's (measured on an H100: 99.985% at the chain's shape, 100% at
# the small edge cases)
WINOGRAD_BITWISE_SHARE = 0.999
# operations the noise kernel does, counted from csrc/augment_noise.cu:
# per element (convert, scale, select, round), extra per element of a
# gaussian image (three hash rounds with the seed adds, the uniform, the
# central rational of the inverse CDF plus 4.85% of the tail's, the
# noise add), per pixel of a salt-pepper image (three hash rounds, the
# uniform, the compare, the salt bit)
NOISE_OPS_ELEMENT, NOISE_OPS_GAUSS, NOISE_OPS_SP_PIXEL = 4, 63, 33


def phase(name: str, **fields) -> None:
    print(f"{name}: {json.dumps(fields)}", flush=True)


PHASE_SECONDS = {}


@contextlib.contextmanager
def timed(name: str):
    """Host seconds of one phase, printed on a line of its own."""
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0
    phase("seconds", phase=name, seconds=PHASE_SECONDS[name])


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


# ptxas's report of a kernel: its name, then its stack and spills, then
# its registers (and static shared memory)
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
WINOGRAD_INSTANTIATION = re.compile(
    r"winograd_f2x3_kernelILi(\d)ELi(\d)ELb([01])E")


def build_kernels(kernel_library):
    """Build the kernel library (its compiler output printed as it was),
    and return ptxas's report of each Winograd instantiation: (mode,
    aligned) -> registers, static shared memory, stack and spills.  A
    library built earlier in this checkout is compiled again by hand for
    the report."""
    import os
    import tempfile

    from yolov3_tensorflow_tpu_torch.ops.cuda_build import (BUILD_DIR,
                                                            CSRC_DIR,
                                                            NVCC_FLAGS)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR) as log:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            kernel_library(verbose=True)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        log.seek(0)
        text = log.read()
    print(text, end="", flush=True)
    if "winograd_f2x3_kernel" not in text:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        text = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-cubin", "-o",
             os.path.join(BUILD_DIR, "winograd_report.cubin"),
             os.path.join(CSRC_DIR, "winograd.cu")], check=True,
            capture_output=True, text=True, timeout=600).stderr
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    report, name = {}, None
    for line in text.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        inst = WINOGRAD_INSTANTIATION.search(name or "")
        if inst is None:
            continue
        key = (wg.MODES[(int(inst.group(1)), int(inst.group(2)))],
               inst.group(3) == "1")
        m = PTXAS_SPILLS.search(line)
        if m:
            report.setdefault(key, {}).update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
        m = PTXAS_USED.search(line)
        if m:
            report.setdefault(key, {}).update(
                registers=int(m.group(1)),
                static_smem_bytes=int(m.group(2) or 0))
            name = None
    return report


def gpu_identity() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, tensor_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of bytes over the memory rate,
    float32 operations over the float32 peak and bf16 tensor-core
    operations over the tensor-core peak.  The three units work at the
    same time, so none of the times adds to another."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S,
                tensor_ops / BF16_TENSOR_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bits(t):
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def check_bitwise(what, got, want):
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(bits(got), bits(want)):
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{what}: kernel differs from the plain "
                             f"version (max abs err {err})")


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts():
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def kernel_wrappers():
    """Each kernel's wrapper by record name; the Winograd kernel's one
    launcher per mode, as ``winograd_call.<mode>``."""
    from yolov3_tensorflow_tpu_torch.ops.augment_noise import noisy_normalize
    from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
        bn_pool_relu_bwd, bn_pool_relu_eval, bn_pool_relu_fwd,
        max_pool_s2_bwd, max_pool_s2_eval, max_pool_s2_fwd)
    from yolov3_tensorflow_tpu_torch.ops.winograd import KERNELS
    return {"bn_pool_relu_eval": bn_pool_relu_eval,
            "bn_pool_relu_fwd": bn_pool_relu_fwd,
            "bn_pool_relu_bwd": bn_pool_relu_bwd,
            "noisy_normalize": noisy_normalize,
            "max_pool_s2_eval": max_pool_s2_eval,
            "max_pool_s2_fwd": max_pool_s2_fwd,
            "max_pool_s2_bwd": max_pool_s2_bwd,
            **{f"winograd_call.{mode}": fn for mode, fn in KERNELS.items()}}


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
    for i, (name, shape, kind) in enumerate(cases):
        y, inv, shift = stem_inputs(*shape, kind, device, SEED + i)
        check_bitwise(f"bn_pool_relu_eval {name}",
                      bn_pool_relu_eval(y, inv, shift),
                      bn_pool_relu_eval_reference(y, inv, shift))
        phase("kernels.bn_pool_relu_eval.case", case=name, shape=shape,
              bitwise_equal=True)

    y, inv, shift = stem_inputs(n, c, h, w, "randn", device, SEED)
    ho, wo = -(-h // 2), -(-w // 2)
    nbytes = n * c * h * w * 2 + n * c * ho * wo * 2 + 2 * c * 4
    bound_ms, bound_by = bound(nbytes, n * c * ho * wo * 27)  # 9 x (mul,
    # add, max)
    kernel_ms = cuda_time_ms(lambda: bn_pool_relu_eval(y, inv, shift))
    plain_ms = cuda_time_ms(
        lambda: bn_pool_relu_eval_reference(y, inv, shift))
    record = {
        "name": "bn_pool_relu_eval", "route": "cuda",
        "source": "yolov3_tensorflow_tpu_torch/ops/csrc/stem_pool.cu",
        "replaces": "yolov3_tensorflow_tpu/ops/stem_pool.py:580",
        "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes it
    }
    phase("kernels.bn_pool_relu_eval", shape=[n, c, h, w], bytes=nbytes,
          ms=kernel_ms, bound_ms=bound_ms, bound_by=bound_by,
          plain_ms=plain_ms, gbytes_per_s=nbytes / kernel_ms / 1e6)
    return [record]


def check_train_stem_kernels(device):
    """bn_pool_relu_fwd (p, codes) and bn_pool_relu_bwd (dy, the two
    per-channel sums) on the card vs their plain versions on the card:
    bitwise equal at the flagship train shape [128,64,208,208] and the
    edge cases.  Returns the two kernel records."""
    import torch

    from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
        bn_pool_relu_bwd, bn_pool_relu_bwd_reference, bn_pool_relu_eval,
        bn_pool_relu_fwd, bn_pool_relu_reference)

    n, c = TRAIN_BATCH, 64
    h, w = FLAGSHIP_HW[0] // 2, FLAGSHIP_HW[1] // 2
    cases = [("flagship", (n, c, h, w), "randn"),
             ("odd_13x11", (4, 8, 13, 11), "randn"),
             ("inv0", (4, 8, 16, 16), "inv0"),
             ("all_negative", (4, 8, 16, 16), "negative"),
             ("ties", (4, 8, 17, 16), "ties")]

    def dp_for(p, seed):
        g = torch.Generator(device=p.device).manual_seed(seed)
        return torch.randn(p.shape, generator=g, device=p.device).to(
            torch.bfloat16)

    for i, (name, shape, kind) in enumerate(cases):
        y, inv, shift = stem_inputs(*shape, kind, device, SEED + 10 + i)
        p, codes = bn_pool_relu_fwd(y, inv, shift)
        p_ref, codes_ref = bn_pool_relu_reference(y, inv, shift)
        check_bitwise(f"bn_pool_relu_fwd {name} p", p, p_ref)
        check_bitwise(f"bn_pool_relu_fwd {name} codes", codes, codes_ref)
        check_bitwise(f"bn_pool_relu_fwd {name} vs eval", p,
                      bn_pool_relu_eval(y, inv, shift))
        dp = dp_for(p, SEED + 20 + i)
        dy, sums = bn_pool_relu_bwd(codes, dp, p, inv, shift, shape[2:])
        dy_ref, sums_ref = bn_pool_relu_bwd_reference(codes, dp, p, inv,
                                                      shift, shape[2:])
        check_bitwise(f"bn_pool_relu_bwd {name} dy", dy, dy_ref)
        check_bitwise(f"bn_pool_relu_bwd {name} sums", sums, sums_ref)
        if kind == "negative" and not (codes == 9).all():
            raise AssertionError("all-negative stem: an active code")
        phase("kernels.bn_pool_relu_train.case", case=name, shape=shape,
              bitwise_equal=True,
              active_share=float((codes <= 8).float().mean()))

    y, inv, shift = stem_inputs(n, c, h, w, "randn", device, SEED)
    p, codes = bn_pool_relu_fwd(y, inv, shift)
    dp = dp_for(p, SEED)
    ho, wo = p.shape[2], p.shape[3]
    big, small = n * c * h * w, n * c * ho * wo
    fwd_bytes = big * 2 + small * (2 + 1) + 2 * c * 4
    bwd_bytes = small * (2 + 1 + 2) + big * 2 + 2 * c * 4 * 2
    fwd_bound = bound(fwd_bytes, small * 9 * 4)  # 9 x (mul, add, max, code)
    # per input element: up to 4 code compares and adds, one multiply;
    # per pooled output: 4 for the two sums
    bwd_bound = bound(bwd_bytes, big * 9 + small * 4)
    records = []
    for name, fn, plain, nbytes, (bound_ms, bound_by), line in (
            ("bn_pool_relu_fwd",
             lambda: bn_pool_relu_fwd(y, inv, shift),
             lambda: bn_pool_relu_reference(y, inv, shift),
             fwd_bytes, fwd_bound, 588),
            ("bn_pool_relu_bwd",
             lambda: bn_pool_relu_bwd(codes, dp, p, inv, shift, (h, w)),
             lambda: bn_pool_relu_bwd_reference(codes, dp, p, inv, shift,
                                                (h, w)),
             bwd_bytes, bwd_bound, 602)):
        kernel_ms = cuda_time_ms(fn)
        plain_ms = cuda_time_ms(plain, iters=5)
        records.append({
            "name": name, "route": "cuda",
            "source": "yolov3_tensorflow_tpu_torch/ops/csrc/stem_pool.cu",
            "replaces": f"yolov3_tensorflow_tpu/ops/stem_pool.py:{line}",
            "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes it
        })
        phase(f"kernels.{name}", shape=[n, c, h, w], bytes=nbytes,
              ms=kernel_ms, bound_ms=bound_ms, bound_by=bound_by,
              plain_ms=plain_ms, gbytes_per_s=nbytes / kernel_ms / 1e6)
    return records


def check_noise_kernel(device):
    """noisy_normalize on the card vs its plain version on the card:
    bitwise equal at the flagship train batch [128,416,416,3] with noise
    off, gaussian only, salt-pepper only, and the per-image mix the
    augmentation draws.  Returns the kernel record, timed on the mix."""
    import torch

    from yolov3_tensorflow_tpu_torch.data.augment import (RANDOM_NORMAL,
                                                          _scalars)
    from yolov3_tensorflow_tpu_torch.ops.augment_noise import (
        noisy_normalize, noisy_normalize_reference)

    n, (h, w) = TRAIN_BATCH, FLAGSHIP_HW
    gen = torch.Generator(device=device).manual_seed(SEED)
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    seeds = torch.randint(0, 2 ** 32, (n, 2), generator=gen, device=device,
                          dtype=torch.int64)
    kind, _ = _scalars(gen, n, torch.bfloat16)
    ones = torch.ones(n, device=device)
    cases = {
        "noise_off": (0 * ones, -ones),
        "gaussian_only": (RANDOM_NORMAL * ones, -ones),
        "salt_pepper_only": (0 * ones, RANDOM_NORMAL * ones),
        "flagship_mix": (torch.where(kind == 1, RANDOM_NORMAL, 0.0),
                         torch.where(kind == 0, RANDOM_NORMAL, -1.0)),
    }
    for name, (g_std, p_eff) in cases.items():
        got = noisy_normalize(images, seeds, g_std, p_eff)
        want = noisy_normalize_reference(images, seeds, g_std, p_eff)
        check_bitwise(f"noisy_normalize {name}", got, want)
        phase("kernels.noisy_normalize.case", case=name,
              shape=[n, h, w, 3], bitwise_equal=True)
    g_std, p_eff = cases["flagship_mix"]
    n_gauss = int((g_std > 0).sum())
    n_sp = int((p_eff > 0).sum())
    nbytes = n * h * w * 3 * (1 + 2) + n * (16 + 8)
    ops = (n * h * w * 3 * NOISE_OPS_ELEMENT
           + n_gauss * h * w * 3 * NOISE_OPS_GAUSS
           + n_sp * h * w * NOISE_OPS_SP_PIXEL)
    bound_ms, bound_by = bound(nbytes, ops)
    kernel_ms = cuda_time_ms(
        lambda: noisy_normalize(images, seeds, g_std, p_eff))
    plain_ms = cuda_time_ms(
        lambda: noisy_normalize_reference(images, seeds, g_std, p_eff),
        iters=5)
    record = {
        "name": "noisy_normalize", "route": "cuda",
        "source": "yolov3_tensorflow_tpu_torch/ops/csrc/augment_noise.cu",
        "replaces": "yolov3_tensorflow_tpu/ops/augment_noise.py:201",
        "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes it
    }
    phase("kernels.noisy_normalize", shape=[n, h, w, 3], bytes=nbytes,
          ops=ops, gaussian_images=n_gauss, salt_pepper_images=n_sp,
          ms=kernel_ms, bound_ms=bound_ms, bound_by=bound_by,
          plain_ms=plain_ms, gbytes_per_s=nbytes / kernel_ms / 1e6)
    return record


def pool_input(n, c, h, w, kind, device, seed):
    """bf16 y (N, C, H, W) on the card for one pool-only stem case."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.randn(n, c, h, w, generator=g)
    if kind == "negative":
        y = -y.abs() - 0.01
    elif kind == "constant":  # every tap of every window equal
        y = torch.full((n, c, h, w), -0.75)
    elif kind == "ties":  # quantized ramp: many equal taps per window
        y = (torch.arange(n * c * h * w) % 7 - 3).float().reshape(
            n, c, h, w) * 0.25
    elif kind == "nan":  # NaN taps in nine windows (see the test suite)
        y[0, 0, 0, 0] = y[0, 1, 4, 5] = y[1, 2, 7, 6] = float("nan")
        y[1, 3, 9, 9] = y[1, 3, 10, 10] = float("nan")
    return y.to(device=device, dtype=torch.bfloat16)


def library_codes(idx, ho, wo, w):
    """Tap codes 0-8 from F.max_pool2d's flat input indices (even sizes:
    window (r, t) starts at input (2r, 2t))."""
    import torch
    r = torch.arange(ho, device=idx.device)[:, None]
    t = torch.arange(wo, device=idx.device)[None, :]
    a = idx // w - 2 * r
    b = idx % w - 2 * t
    return (a * 3 + b).to(torch.uint8)


def check_pool_kernels(device):
    """max_pool_s2_eval, max_pool_s2_fwd (p, codes) and max_pool_s2_bwd
    (dy) on the card vs their plain versions on the card: bitwise equal at
    the v2 train shape [128,64,208,208] and the edge cases (odd sizes, H
    not a multiple of 8, all negative, ties, NaN).  Times each beside its
    bound and beside F.max_pool2d (ceil_mode, with indices for train) and
    its backward, which compute the same function on even sizes, and says
    whether their results are bitwise the kernels'.  Returns the three
    kernel records."""
    import torch
    import torch.nn.functional as F

    from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
        max_pool_s2_bwd, max_pool_s2_bwd_reference, max_pool_s2_eval,
        max_pool_s2_fwd, max_pool_s2_reference)

    n, c = TRAIN_BATCH, 64
    h, w = FLAGSHIP_HW[0] // 2, FLAGSHIP_HW[1] // 2
    cases = [("v2_train", (n, c, h, w), "randn"),
             ("odd_13x11", (4, 8, 13, 11), "randn"),
             ("h18_w10", (4, 8, 18, 10), "randn"),
             ("all_negative", (4, 8, 16, 16), "negative"),
             ("constant", (4, 8, 16, 16), "constant"),
             ("ties", (4, 8, 17, 16), "ties"),
             ("nan", (2, 4, 16, 16), "nan")]

    def dp_for(p, seed):
        g = torch.Generator(device=p.device).manual_seed(seed)
        return torch.randn(p.shape, generator=g, device=p.device).to(
            torch.bfloat16)

    for i, (name, shape, kind) in enumerate(cases):
        y = pool_input(*shape, kind, device, SEED + 30 + i)
        p, codes = max_pool_s2_fwd(y)
        p_ref, codes_ref = max_pool_s2_reference(y)
        check_bitwise(f"max_pool_s2_fwd {name} p", p, p_ref)
        check_bitwise(f"max_pool_s2_fwd {name} codes", codes, codes_ref)
        check_bitwise(f"max_pool_s2_eval {name}", max_pool_s2_eval(y), p_ref)
        dp = dp_for(p, SEED + 40 + i)
        check_bitwise(f"max_pool_s2_bwd {name} dy",
                      max_pool_s2_bwd(codes, dp, shape[2:]),
                      max_pool_s2_bwd_reference(codes, dp, shape[2:]))
        if int(codes.max()) > 8:
            raise AssertionError(f"max_pool_s2 {name}: a code above 8")
        if kind == "constant" and codes.any():
            raise AssertionError("max_pool_s2 ties: not the first tap")
        nan_windows = int(torch.isnan(p.float()).sum())
        if kind == "nan" and nan_windows != 9:
            raise AssertionError(f"max_pool_s2 nan: {nan_windows} NaN "
                                 "windows, 9 expected")
        phase("kernels.max_pool_s2.case", case=name, shape=shape,
              bitwise_equal=True, nan_windows=nan_windows)

    y_eval = pool_input(FLAGSHIP_BATCH, c, h, w, "randn", device, SEED)
    check_bitwise("max_pool_s2_eval v2_serve", max_pool_s2_eval(y_eval),
                  max_pool_s2_reference(y_eval, emit_codes=False))
    y = pool_input(n, c, h, w, "randn", device, SEED)
    p, codes = max_pool_s2_fwd(y)
    dp = dp_for(p, SEED)
    ho, wo = p.shape[2], p.shape[3]

    # the library's versions, and whether they give the kernels' bits
    lib_p, lib_idx = F.max_pool2d(y, 3, 2, ceil_mode=True,
                                  return_indices=True)

    def lib_bwd():
        return torch.ops.aten.max_pool2d_with_indices_backward(
            dp, y, [3, 3], [2, 2], [0, 0], [1, 1], True, lib_idx)

    library_equal = {
        "p": bool(torch.equal(bits(lib_p), bits(p))),
        "codes": bool(torch.equal(library_codes(lib_idx, ho, wo, w),
                                  codes)),
        "dy": bool(torch.equal(bits(lib_bwd()),
                               bits(max_pool_s2_bwd(codes, dp, (h, w))))),
    }
    lib_dy_err = (lib_bwd().float()
                  - max_pool_s2_bwd(codes, dp, (h, w)).float()).abs().max()

    big, small = n * c * h * w, n * c * ho * wo
    eval_big, eval_small = FLAGSHIP_BATCH * c * h * w, \
        FLAGSHIP_BATCH * c * ho * wo
    # per pooled output 9 compares (eval), plus 9 code selects (train);
    # backward: per input element its 1, 2 or 4 candidate windows (2.25
    # on average at even sizes), one add per window
    specs = (
        ("max_pool_s2_eval", lambda: max_pool_s2_eval(y_eval),
         lambda: max_pool_s2_reference(y_eval, emit_codes=False),
         lambda: F.max_pool2d(y_eval, 3, 2, ceil_mode=True),
         eval_big * 2 + eval_small * 2, eval_small * 9, 548,
         [FLAGSHIP_BATCH, c, h, w]),
        ("max_pool_s2_fwd", lambda: max_pool_s2_fwd(y),
         lambda: max_pool_s2_reference(y),
         lambda: F.max_pool2d(y, 3, 2, ceil_mode=True, return_indices=True),
         big * 2 + small * (2 + 1), small * 18, 565, [n, c, h, w]),
        ("max_pool_s2_bwd", lambda: max_pool_s2_bwd(codes, dp, (h, w)),
         lambda: max_pool_s2_bwd_reference(codes, dp, (h, w)), lib_bwd,
         small * (1 + 2) + big * 2, big * 2.25 + small, 571, [n, c, h, w]),
    )
    records = []
    for name, fn, plain, library, nbytes, ops, line, shape in specs:
        bound_ms, bound_by = bound(nbytes, ops)
        kernel_ms = cuda_time_ms(fn)
        plain_ms = cuda_time_ms(plain, iters=5)
        library_ms = cuda_time_ms(library)
        records.append({
            "name": name, "route": "cuda",
            "source": "yolov3_tensorflow_tpu_torch/ops/csrc/stem_pool.cu",
            "replaces": f"yolov3_tensorflow_tpu/ops/stem_pool.py:{line}",
            "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
        phase(f"kernels.{name}", shape=shape, bytes=nbytes, ms=kernel_ms,
              bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
              library_ms=library_ms, gbytes_per_s=nbytes / kernel_ms / 1e6)
    phase("kernels.max_pool_s2.library", call="F.max_pool2d(y, 3, 2, "
          "ceil_mode=True, return_indices=True) and "
          "aten.max_pool2d_with_indices_backward", shape=[n, c, h, w],
          bitwise_equal_to_kernels=library_equal,
          dy_max_abs_diff=float(lib_dy_err))
    return records


def winograd_inputs(n, c, co, h, w, device, seed):
    """The Winograd kernel's operands of one case, on the card: bf16 x, y
    (the partner: the identity of PRO_BN_ADD, y of PRO_DYEFF), cvals and
    OIHW weights; float32 (inv, shift) over C and over Co, and (ds, dq)
    over C; bf16 avals (a boundary activation, zero where it was cut) and
    dvals (its cotangent) for EPI_BN_ADD."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0, dtype=torch.bfloat16):
        t = torch.randn(*shape, generator=g, device=device) * scale
        return t.to(dtype)

    def inv_shift(k):
        return torch.stack([torch.rand(k, generator=g, device=device) + 0.5,
                            draw(k, scale=0.2, dtype=torch.float32)])

    return dict(x=draw(n, c, h, w), y=draw(n, c, h, w),
                cvals=draw(n, co, h, w),
                w=draw(co, c, 3, 3, scale=(2.0 / (9 * c)) ** 0.5),
                scal_c=inv_shift(c), scal_co=inv_shift(co),
                scal2=torch.stack([draw(c, scale=1e-3, dtype=torch.float32),
                                   draw(c, scale=1e-4, dtype=torch.float32)]),
                avals=draw(n, co, h, w).clamp_(min=0),
                dvals=draw(n, co, h, w))


def winograd_kwargs(mode, a):
    """winograd_call's keyword arguments for ``mode`` on case ``a``."""
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    pro, epi = mode
    kw = dict(pro=pro, epi=epi, aux=pro != wg.PRO_NONE)
    if pro in (wg.PRO_BN_ACT, wg.PRO_BN_ADD):
        kw["scal"] = a["scal_c"]
    if pro in (wg.PRO_BN_ADD, wg.PRO_DYEFF):
        kw["partner"] = a["y"]
    if pro == wg.PRO_DYEFF:
        kw["scal2"] = a["scal2"]
    if epi in (wg.EPI_BN_ACT, wg.EPI_BN_ADD):
        kw.update(cvals=a["cvals"], scal=a["scal_co"])
    if epi == wg.EPI_BN_ADD:
        kw.update(avals=a["avals"], dvals=a["dvals"])
    return kw


def check_step_close(what, got, want):
    """bf16 ``got`` within one bf16 step of ``want`` and at least
    WINOGRAD_BITWISE_SHARE of it bitwise; returns (the max abs error, the
    share of bit-equal outputs)."""
    import torch
    out, ref = got.float(), want.float()
    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype}")
    err = (out - ref).abs()
    if not (err <= 2 ** -7 * ref.abs() + 1e-4 * ref.abs().max()).all():
        raise AssertionError(f"{what}: more than one bf16 step from the "
                             f"plain version (max abs err {err.max()})")
    # the sums' order moves a few outputs by one step; a lost bf16
    # rounding in the transforms moves about half of them
    share = float((got == want).float().mean())
    if share < WINOGRAD_BITWISE_SHARE:
        raise AssertionError(f"{what}: only {share:.6f} of the outputs "
                             "bit-equal to the plain version's")
    return float(err.max()), share


def check_winograd_close(what, got, want, mode, kw):
    """The kernel's outputs against the plain version's (tolerances in
    the module docstring); returns (the output's max abs error, its share
    of bit-equal outputs, out3's share or None)."""
    import torch

    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    pro, epi = mode
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, {len(want)} "
                             "expected")
    err, share = check_step_close(f"{what} out", got[0], want[0])
    ref = want[0].float()
    if epi != wg.EPI_NONE:
        if epi == wg.EPI_STATS:
            terms = torch.stack([ref.abs().sum((0, 2, 3)),
                                 ref.square().sum((0, 2, 3))])
        else:  # |g|: out / inv, or out3 itself
            g = want[-1].float().abs() if epi == wg.EPI_BN_ADD else \
                ref.abs() / kw["scal"][0].abs()[None, :, None, None]
            terms = torch.stack([g.sum((0, 2, 3)), (g * kw["cvals"].float(
            ).abs()).sum((0, 2, 3))])
        if not ((got[1] - want[1]).abs() <= 1e-5 * terms + 1e-6).all():
            raise AssertionError(f"{what}: sums differ by "
                                 f"{(got[1] - want[1]).abs().max()}")
    aux = 1 + (epi != wg.EPI_NONE)
    if kw["aux"]:
        check_bitwise(f"{what} aux", got[aux], want[aux])
    share3 = None
    if epi == wg.EPI_BN_ADD:  # out3, the identity's gradient
        _, share3 = check_step_close(f"{what} out3", got[aux + 1],
                                     want[aux + 1])
    return err, share, share3


def winograd_cost(mode, n, c, co, h, w):
    """(bytes, float32 operations, bf16 tensor-core operations) of one
    launch: each input read once, each output written once; the 16
    products; the BT (32 adds per tile and input channel) and AT (24 per
    tile and output channel) transforms, the prologue (3 per input
    element, 4 with the identity's add) and the epilogue (3 per output
    element for the sums, 3 more for the BN mask or the boundary's add
    and mask)."""
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    pro, epi = mode
    x_el, o_el = n * c * h * w, n * co * h * w
    tiles = n * -(-h // 2) * -(-w // 2)
    nbytes = x_el * 2 + 16 * c * co * 2 + o_el * 2
    ops = tiles * (32 * c + 24 * co)
    if pro != wg.PRO_NONE:  # scalars, the aux write, the partner read
        partner = pro in (wg.PRO_BN_ADD, wg.PRO_DYEFF)
        nbytes += 2 * c * 4 + x_el * 2 * (2 if partner else 1)
        ops += (4 if pro == wg.PRO_BN_ADD else 3) * x_el
    if epi != wg.EPI_NONE:  # the sums
        nbytes += 2 * co * 4
        ops += 3 * o_el
    if epi in (wg.EPI_BN_ACT, wg.EPI_BN_ADD):  # cvals and the scalars
        nbytes += o_el * 2 + 2 * co * 4
        ops += 3 * o_el
    if epi == wg.EPI_BN_ADD:  # avals and dvals read, out3 written
        nbytes += 3 * o_el * 2
    return nbytes, ops, 2 * 16 * tiles * c * co


def check_winograd_kernel(device):
    """winograd_call on the card vs winograd_reference on the card in each
    ported mode, at the flagship chain's two shapes (WINOGRAD_SHAPES) and
    at edge cases (odd H and W with C = Co = 8, a ragged final block of
    tiles with Co below the kernel's channel block, a batch below 32 at the
    chain's width, a wide W in two column segments, a last band of one
    tile row, Co over two channel blocks, many small images, W = 11 on the
    narrow-copy variant); two launches repeat bitwise.  Times each
    mode at both chain shapes beside its bound and the library's
    convolution (F.conv2d plus the float32 sums for the forward modes,
    torch.nn.grad.conv2d_input for the gradient modes; neither includes
    the fused prologue or epilogue).  Returns the records of the six modes
    on the train paths, each at the chain shape of its path
    (KERNEL_PATHS, WINOGRAD_PATHS); the plain-conv mode's numbers and the
    other shape's are printed on lines of their own."""
    import torch

    from yolov3_tensorflow_tpu_torch.ops import winograd as wg

    cases = list(WINOGRAD_SHAPES.items()) + [
        ("odd_13x11_c8", (2, 8, 8, 13, 11)),
        ("ragged_tiles_co24", (3, 16, 24, 7, 9)),
        ("n8_chain_width", (8, 128, 128, 26, 26)),
        ("wide_w", (1, 8, 72, 6, 200)),
        # a last band of one tile row, Co over two channel blocks, many
        # small images (blocks crossing image boundaries), W = 11
        ("last_band_one_row", (8, 128, 128, 50, 52)),
        ("co128_two_blocks", (4, 64, 128, 20, 20)),
        ("many_small_images", (32, 64, 64, 26, 26)),
        ("w11_narrow_copies", (4, 32, 32, 10, 11))]
    records = []
    for i, (name, shape) in enumerate(cases):
        a = winograd_inputs(*shape, device, SEED + 50 + i)
        u = wg.transform_weights(a["w"]).to(torch.bfloat16)
        errors = {}
        for mode, mode_name in wg.MODES.items():
            kw = winograd_kwargs(mode, a)
            got = wg.winograd_call(a["x"], u, **kw)
            again = wg.winograd_call(a["x"], u, **kw)
            want = wg.winograd_reference(a["x"], u, **kw)
            what = f"winograd_call {mode_name} {name}"
            err, share, share3 = check_winograd_close(what, got, want, mode,
                                                      kw)
            for first, second in zip(got, again):
                check_bitwise(f"{what} repeat", first, second)
            errors[mode_name] = err
            phase("kernels.winograd_call.case", case=name, mode=mode_name,
                  shape=shape, max_abs_err=err, bitwise_share=share,
                  out3_bitwise_share=share3)
        del got, again, want
        if name in WINOGRAD_SHAPES:
            records += time_winograd_modes(name, a, u, errors)
        del a, u
        free_card()
    return records


def time_winograd_modes(shape_name, a, u, errors):
    """Each mode's kernel, plain version and library call timed on case
    ``a`` at the chain shape ``shape_name``; returns the records of the
    modes whose record reports this shape."""
    import torch
    import torch.nn.functional as F

    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    shape = WINOGRAD_SHAPES[shape_name]
    n, c, co, h, w = shape
    records = []
    w_fwd = a["w"].flip(2, 3).transpose(0, 1)  # the conv whose dx it is

    def conv_and_sums():
        y = F.conv2d(a["x"], a["w"], padding=1)
        yf = y.float()
        return y, torch.stack([yf.sum((0, 2, 3)),
                               yf.square().sum((0, 2, 3))])

    def conv_input_grad():
        return torch.nn.grad.conv2d_input((n, co, h, w), w_fwd, a["x"],
                                          padding=1)

    def library(mode_name):
        if mode_name == "conv":
            return lambda: F.conv2d(a["x"], a["w"], padding=1)
        if mode_name.startswith("dyeff"):
            return conv_input_grad
        return conv_and_sums

    for mode, mode_name in wg.MODES.items():
        kw = winograd_kwargs(mode, a)
        nbytes, ops, tensor_ops = winograd_cost(mode, *shape)
        bound_ms, bound_by = bound(nbytes, ops, tensor_ops)
        kernel_ms = cuda_time_ms(
            lambda: wg.winograd_call(a["x"], u, **kw))
        plain_ms = cuda_time_ms(
            lambda: wg.winograd_reference(a["x"], u, **kw), iters=3)
        library_ms = cuda_time_ms(library(mode_name))
        err = errors[mode_name]
        phase(f"kernels.winograd_call.{mode_name}", case=shape_name,
              shape=list(shape), bytes=nbytes, ops=ops,
              tensor_ops=tensor_ops, ms=kernel_ms, bound_ms=bound_ms,
              bound_by=bound_by, plain_ms=plain_ms,
              library_ms=library_ms,
              library_factor=kernel_ms / library_ms, max_abs_err=err,
              tflop_per_s=tensor_ops / kernel_ms / 1e9,
              gbytes_per_s=nbytes / kernel_ms / 1e6)
        name = f"winograd_call.{mode_name}"
        if name in KERNEL_PATHS and \
                WINOGRAD_PATHS[KERNEL_PATHS[name]][1] == shape_name:
            records.append({
                "name": name, "route": "cuda",
                "source": "yolov3_tensorflow_tpu_torch/ops/csrc/"
                          "winograd.cu",
                "replaces": "yolov3_tensorflow_tpu/ops/winograd.py:429",
                "max_abs_err": err, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
            })
    return records


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


def stem_output(backbone, x):
    """The backbone's stem (conv and pool) on normalized images."""
    from yolov3_tensorflow_tpu_torch.models.resnet18_v2 import ResNet18V2
    if isinstance(backbone, ResNet18V2):
        return backbone.stem_conv_pool(x, backbone.stem)
    return backbone.stem_conv_bn_pool_relu(x, backbone.stem)


def check_model(cfg, sd, images, device, gpu):
    """Eval forward at batch 64 with the kernel stem and with the plain
    composition ("xla"): stems bitwise equal, heads within 3e-2."""
    import torch

    from yolov3_tensorflow_tpu_torch.infer.predict import (Predictor,
                                                           normalize_images)
    fused = Predictor(cfg, sd, device)
    plain = Predictor(cfg.replace(stem_backend="xla"), sd, device)
    x = normalize_images(torch.from_numpy(images).to(device))
    with torch.inference_mode():
        stems = [stem_output(p.model.backbone, x) for p in (fused, plain)]
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
    phase(f"model.{cfg.model_backbone}", input=list(cfg.input_image_size),
          batch=FLAGSHIP_BATCH, stem_bitwise_equal=True,
          head_max_abs_err_vs_plain_stem=head_err, head_tolerance=3e-2,
          eval_forward_img_per_s=FLAGSHIP_BATCH * steps / dt, gpu=gpu)
    return fused


# -------------------------------------------------------------- serve --
def serve(cfg, predictor, device, gpu, kernels, n_requests=16,
          max_batch=8):
    """DynamicBatcher over a DetectionEngine on the card: single-image
    requests of different original sizes, each answer held against a
    direct engine call on the same batch.  Fails unless each of
    ``kernels`` was launched while the requests were served."""
    from yolov3_tensorflow_tpu_torch.data.loader import letterbox_array
    from yolov3_tensorflow_tpu_torch.infer.server import (DetectionEngine,
                                                          DynamicBatcher,
                                                          unletterbox_boxes)

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
        reset_launches()
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
        launches = launch_counts()
    finally:
        batcher.stop()
    if not all(launches[k] for k in kernels):
        raise AssertionError(f"serve {cfg.model_backbone}: a kernel was "
                             f"never launched on the main path: {launches}")
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
    phase(f"serve.{cfg.model_backbone}", requests=len(answers),
          batches=stats["batches"],
          batch_size_histogram=stats["batch_size_histogram"],
          boxes_kept=kept, p50_latency_ms=lat[len(lat) // 2] * 1e3,
          img_per_s=n_requests / wall, direct_engine_ms=direct_ms, gpu=gpu)
    return launches


# -------------------------------------------------------------- train --
def train_batch(device):
    """bench.py's train inputs: a seeded uint8 batch and two boxes per
    image, on the card (the host loader is not part of this run)."""
    import torch
    rng = np.random.RandomState(SEED)
    images = rng.randint(0, 255, (TRAIN_BATCH,) + FLAGSHIP_HW + (3,),
                         dtype=np.uint8)
    labels = -np.ones((TRAIN_BATCH, 32, 5), np.float32)
    labels[:, 0] = [0.5, 0.5, 0.3, 0.3, 0]
    labels[:, 1] = [0.25, 0.25, 0.1, 0.2, 0]
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def train_config(backbone, **kw):
    from yolov3_tensorflow_tpu_torch.config import Config
    return Config(input_image_size=FLAGSHIP_HW + (3,), batch_size=TRAIN_BATCH,
                  max_boxes=32, optimizer="radam", compute_dtype="bfloat16",
                  rectified_coord_num=-1, model_backbone=backbone, **kw)


def free_card():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def descent(backbone, device, images, labels, name=None, **cfg_kw):
    """DESCENT_STEPS train steps on one fixed batch without augmentation:
    the total loss must fall.  ``cfg_kw``: further config fields."""
    from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer
    name = name or f"train.{backbone}"
    trainer = YOLOv3Trainer(train_config(backbone, is_augment=False,
                                         **cfg_kw), device, seed=SEED)
    state, losses = trainer.state, []
    for _ in range(DESCENT_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
        losses.append(metrics["total_loss"])
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: total_loss did not fall "
                             f"over {DESCENT_STEPS} steps on one batch: "
                             f"{losses}")
    phase(f"{name}.descent", steps=DESCENT_STEPS,
          total_loss=losses, batch=TRAIN_BATCH, augment=False)
    del trainer, state, metrics
    free_card()


def timed_steps(backbone, augment_backend, device, images, labels, gpu,
                name=None, **cfg_kw):
    """WARMUP_STEPS + TIMED_STEPS augmented train steps with every launch
    count set to 0 just before them; returns the run's numbers and its
    launch counts.  ``cfg_kw``: further config fields."""
    import torch

    from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer
    name = name or f"train.{backbone}"
    trainer = YOLOv3Trainer(
        train_config(backbone, is_augment=True,
                     augment_backend=augment_backend, **cfg_kw), device,
        seed=SEED)
    state = trainer.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for _ in range(WARMUP_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    final = {k: v.float().tolist() if torch.is_tensor(v) else v
             for k, v in metrics.items()}
    if not np.isfinite(final["total_loss"]):
        raise AssertionError(f"{name} {augment_backend}: "
                             f"non-finite loss {final}")
    steps = WARMUP_STEPS + TIMED_STEPS
    run = dict(img_per_s=TRAIN_BATCH * TIMED_STEPS / dt,
               step_ms=dt / TIMED_STEPS * 1e3,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()})
    phase(f"{name}.{augment_backend}", batch=TRAIN_BATCH,
          timed_steps=TIMED_STEPS, final_total_loss=final["total_loss"],
          gpu=gpu, **run)
    del trainer, state, metrics
    free_card()
    return run


def require_launches(what, launches, names):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched on the main "
                             f"path: {missing}")


def train(device, gpu):
    """The flagship train step (bench.py: 416x416, batch 128, bf16, RAdam,
    is_augment) through YOLOv3Trainer.train_step: a descent check without
    augmentation, then the timed A/B of the two noise backends.  Returns
    the launch counts of the run with the default backend."""
    from yolov3_tensorflow_tpu_torch.train.trainer import \
        AUTO_AUGMENT_BACKEND

    images, labels = train_batch(device)
    descent(FLAGSHIP, device, images, labels)
    runs = {b: timed_steps(FLAGSHIP, b, device, images, labels, gpu)
            for b in ("fused", "xla")}
    stem = ("bn_pool_relu_fwd", "bn_pool_relu_bwd")
    require_launches("train fused", runs["fused"]["launches"],
                     stem + ("noisy_normalize",))
    require_launches("train xla", runs["xla"]["launches"], stem)
    if runs["xla"]["launches"]["noisy_normalize"]:
        raise AssertionError("train xla: the noise kernel ran")
    faster = max(runs, key=lambda b: runs[b]["img_per_s"])
    phase("train.augment_ab", fused_img_per_s=runs["fused"]["img_per_s"],
          xla_img_per_s=runs["xla"]["img_per_s"], faster=faster,
          auto=AUTO_AUGMENT_BACKEND, gpu=gpu)
    return runs[AUTO_AUGMENT_BACKEND]["launches"]


def train_v2(device, gpu):
    """The ResNet-18-v2 train step (bench.py --backbone resnet-18-v2):
    the descent check, then the timed run with augment_backend "auto".
    Returns its launch counts."""
    images, labels = train_batch(device)
    descent(V2, device, images, labels)
    run = timed_steps(V2, "auto", device, images, labels, gpu)
    require_launches("train v2", run["launches"],
                     ("max_pool_s2_fwd", "max_pool_s2_bwd",
                      "noisy_normalize"))
    return run["launches"]


def train_winograd(device, gpu, name):
    """The flagship train step at conv_backend="winograd" on the Winograd
    path ``name`` of WINOGRAD_PATHS: the descent check, then the timed run
    with augment_backend "auto", which must launch each Winograd mode the
    path's number of times per step, and no other mode (the plain conv
    never).  Returns its launch counts."""
    min_channels, _, per_step = WINOGRAD_PATHS[name]
    cfg_kw = dict(conv_backend="winograd",
                  winograd_min_channels=min_channels)
    images, labels = train_batch(device)
    descent(FLAGSHIP, device, images, labels, name=name, **cfg_kw)
    run = timed_steps(FLAGSHIP, "auto", device, images, labels, gpu,
                      name=name, **cfg_kw)
    launches = run["launches"]
    steps = WARMUP_STEPS + TIMED_STEPS
    counts = {k: v for k, v in launches.items()
              if k.startswith("winograd_call.")}
    want = {k: per_step.get(k.split(".", 1)[1], 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: Winograd launches {counts}, "
                             f"{want} expected")
    require_launches(name, launches, ("bn_pool_relu_fwd", "bn_pool_relu_bwd",
                                      "noisy_normalize"))
    return launches


def serve_model(backbone, device, gpu, kernels):
    """The batch-64 eval forward against the plain stem, then 16 requests
    through the DynamicBatcher.  Returns the serve run's launch counts."""
    from yolov3_tensorflow_tpu_torch.config import Config
    cfg = Config(input_image_size=FLAGSHIP_HW + (3,),
                 batch_size=FLAGSHIP_BATCH, max_boxes=32,
                 confidence_thresh=0.3, model_backbone=backbone)
    sd = seeded_state_dict(cfg, device)
    images = np.random.RandomState(SEED).randint(
        0, 256, (FLAGSHIP_BATCH,) + FLAGSHIP_HW + (3,), dtype=np.uint8)
    predictor = check_model(cfg, sd, images, device, gpu)
    launches = serve(cfg, predictor, device, gpu, kernels)
    del predictor, sd
    free_card()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from yolov3_tensorflow_tpu_torch.ops.cuda_build import kernel_library

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    gpu = gpu_identity()
    print(gpu, flush=True)
    phase("device", gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    with timed("build"):
        ptxas = build_kernels(kernel_library)
    from yolov3_tensorflow_tpu_torch.ops import winograd as wg
    for (mode_name, aligned), info in sorted(ptxas.items()):
        # the launch's dynamic shared memory at each chain shape
        pro, epi = next(k for k, v in wg.MODES.items() if v == mode_name)
        smem = {name: wg.winograd_plan(
            n, c, co, h, w, pro in (wg.PRO_BN_ADD, wg.PRO_DYEFF),
            {wg.EPI_BN_ACT: 1, wg.EPI_BN_ADD: 3}.get(epi, 0)).smem_bytes
            for name, (n, c, co, h, w) in WINOGRAD_SHAPES.items()}
        phase("ptxas.winograd_f2x3_kernel", mode=mode_name,
              variant="aligned" if aligned else "narrow", **info,
              dynamic_smem_bytes=smem)
    if len(ptxas) != 2 * len(wg.MODES) or any(
            v.get("spill_store_bytes", 1) or v.get("spill_load_bytes", 1)
            for v in ptxas.values()):
        raise AssertionError(f"ptxas report: {len(ptxas)} Winograd "
                             f"instantiations, or spills: {ptxas}")

    with timed("kernels"):
        records = check_stem_kernel(device)
        records += check_train_stem_kernels(device)
        records.append(check_noise_kernel(device))
        records += check_pool_kernels(device)
        records += check_winograd_kernel(device)
    print("kernels: " + json.dumps([r["name"] for r in records]),
          flush=True)

    paths = {}  # launch counts of each main-path run
    with timed("serve.resnet-18"):
        paths["serve.resnet-18"] = serve_model(FLAGSHIP, device, gpu,
                                               ("bn_pool_relu_eval",))
    with timed("train.resnet-18"):
        paths["train.resnet-18"] = train(device, gpu)
    with timed("serve.resnet-18-v2"):
        paths["serve.resnet-18-v2"] = serve_model(V2, device, gpu,
                                                  ("max_pool_s2_eval",))
    with timed("train.resnet-18-v2"):
        paths["train.resnet-18-v2"] = train_v2(device, gpu)
    for name in WINOGRAD_PATHS:
        with timed(name):
            paths[name] = train_winograd(device, gpu, name)
    for r in records:
        r["launches"] = paths[KERNEL_PATHS[r["name"]]][r["name"]]
    phase("seconds", phase="total",
          seconds=time.perf_counter() - t_start, phases=PHASE_SECONDS)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
