"""Stem pooling ops: the fused BN + 3x3/s2 max-pool + relu of ResNet-18
and the pool-only 3x3/s2 max-pool of ResNet-18-v2, eval and train.

Port of ``yolov3_tensorflow_tpu/ops/stem_pool.py``:

  * :func:`bn_pool_relu_eval`: the fused stem's code-free forward
    (inference);
  * :func:`bn_pool_relu`: its train op, a ``torch.autograd.Function``
    whose forward also writes an argmax code per window
    (:func:`bn_pool_relu_fwd`) and whose backward routes ``dp`` by those
    codes (:func:`bn_pool_relu_bwd`); ``y`` is not saved for backward.

    p = relu(maxpool_3x3_s2_SAME(bf16(bf16(y * inv_b) + shift_b)))

    with ``inv_b = bf16(inv)`` and ``shift_b = bf16(shift)`` per channel;
  * :func:`max_pool_s2_eval`, :func:`max_pool_s2` (forward
    :func:`max_pool_s2_fwd`, backward :func:`max_pool_s2_bwd`): the same
    for ``p = maxpool_3x3_s2_SAME(bf16(y))``, the pool-only stem.

All on NCHW tensors.  Codes are uint8, NCHW at the pooled size: the first
tap (row-major in the 3x3 window) strictly above all taps before it; the
fused stem writes 9 when the window's maximum is not > 0 (relu clamps it,
so it gets no gradient).  The max propagates NaN, and a NaN tap is never
above the running max, so a window's code stops at the tap before its
first NaN (the TPU kernels' ``jnp.maximum`` chain).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/stem_pool.cu``) and counts one launch in ``<wrapper>.launches``;
on a CPU tensor it runs the plain PyTorch version (``*_reference``), which
is also the kernel's test oracle.  There is no fallback: a tensor on any
other device, a failed build or a failed launch raises.

Pooling geometry is TF SAME for window 3 / stride 2: ``Ho = ceil(H/2)``,
``pad_top = max((Ho-1)*2 + 3 - H, 0) // 2`` (0 for even H, so window r
covers rows 2r..2r+2), and the same for columns.  Padding is -inf: it
never wins a window.  (The TPU's pool-only kernel pads with -3.0e38,
which an input at or below it would lose to; the port's tests keep their
inputs above it.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import check_launch, kernel_library

INACTIVE = 9  # code of a window that relu clamps
# taps (a, b) in the order their routed dp terms are added to dy: every
# input element receives its terms in the TPU kernel's order (_route_row,
# stem_pool.py:221-245), because each tap only reaches one row/col parity
_ROUTE_ORDER = ((2, 0), (2, 2), (0, 0), (0, 2), (2, 1), (0, 1), (1, 0),
                (1, 2), (1, 1))
_BLOCK = 256  # threads per block of the backward's partial sums


def same_pool_geometry(size: int):
    """(out, pad_lo, pad_hi) of a TF SAME 3x3/s2 window along one axis."""
    out = -(-size // 2)
    pad_total = max((out - 1) * 2 + 3 - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def _pad_same(t):
    """``t`` as float32, padded with -inf to the SAME window grid."""
    _, top, bottom = same_pool_geometry(t.shape[2])
    _, left, right = same_pool_geometry(t.shape[3])
    return F.pad(t.float(), (left, right, top, bottom), value=float("-inf"))


def _padded_bn(y, inv, shift):
    """bf16(bf16(y*inv_b) + shift_b) in ``y``'s dtype, padded by
    :func:`_pad_same`."""
    dt = y.dtype
    t = y * inv.to(dt)[None, :, None, None]
    return _pad_same(t + shift.to(dt)[None, :, None, None])


def _scan_taps(t, ho, wo):
    """(max, code) of every 3x3/s2 window of the padded float32 ``t``:
    the 9 shifted taps scanned in row-major order, the code moving on a
    strict ``>`` and the max by ``torch.maximum`` (NaN propagates)."""
    n, c = t.shape[:2]
    cur = torch.full((n, c, ho, wo), float("-inf"), device=t.device)
    code = torch.zeros((n, c, ho, wo), dtype=torch.uint8, device=t.device)
    for a in range(3):
        for b in range(3):
            tap = t[:, :, a:a + 2 * ho - 1:2, b:b + 2 * wo - 1:2]
            code = torch.where(tap > cur, a * 3 + b, code).to(torch.uint8)
            cur = torch.maximum(cur, tap)
    return cur, code


def bn_pool_relu_eval_reference(y: torch.Tensor, inv: torch.Tensor,
                                shift: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch composition of the fused eval stem, in ``y``'s dtype:
    mul and add each round to ``y.dtype`` (bf16 for the kernel's
    semantics), then SAME max-pool in f32 and relu.  y: (N, C, H, W);
    inv, shift: (C,) float32.  Returns ``y.dtype``."""
    t = _padded_bn(y, inv, shift)
    return F.relu(F.max_pool2d(t, 3, 2)).to(y.dtype)


def bn_pool_relu_reference(y: torch.Tensor, inv: torch.Tensor,
                           shift: torch.Tensor):
    """Plain version of the train forward: (p, codes) for bf16 ``y``.
    ``p`` is :func:`bn_pool_relu_eval_reference`'s; the codes come from
    the 9 shifted taps scanned in row-major order with strict ``>``."""
    p = bn_pool_relu_eval_reference(y, inv, shift)
    cur, code = _scan_taps(_padded_bn(y, inv, shift), p.shape[2],
                           p.shape[3])
    return p, torch.where(cur > 0, code, INACTIVE).to(torch.uint8)


def bn_pool_relu_bwd_reference(codes, dp, p, inv, shift, hw):
    """Plain version of the backward.  codes (N, C, Ho, Wo) uint8; dp, p
    bf16 of that shape; inv, shift (C,) f32; ``hw`` the input's (H, W).
    Returns (dy bf16 (N, C, H, W), sums (2, C) f32) with sums[0] = sum of
    dp_active and sums[1] = sum of dp_active * (p - shift) per channel.

    dy: 9 masked shifted adds in :data:`_ROUTE_ORDER`, then one f32
    multiply by inv and one bf16 round.  The sums repeat the kernel's
    additions: a halving tree over blocks of 256 pooled outputs of a
    plane, then per channel a strided in-order sum over (n, block) and a
    second halving tree."""
    n, c, ho, wo = dp.shape
    dpf = dp.float()
    dy = (_route(codes, dpf, hw) * inv[None, :, None, None]).to(
        torch.bfloat16)

    active = codes <= 8
    t0 = torch.where(active, dpf, 0.0)
    t1 = torch.where(active, dpf * (p.float() - shift[None, :, None, None]),
                     0.0)
    plane = ho * wo
    chunks = -(-plane // _BLOCK)
    terms = torch.stack([t0, t1]).reshape(2, n, c, plane)
    terms = F.pad(terms, (0, chunks * _BLOCK - plane))
    part = _halving_tree(terms.reshape(2, n, c, chunks, _BLOCK))
    part = part.permute(0, 2, 1, 3).reshape(2, c, n * chunks)
    rows = -(-(n * chunks) // _BLOCK)
    part = F.pad(part, (0, rows * _BLOCK - n * chunks))
    part = part.reshape(2, c, rows, _BLOCK)
    lane = torch.zeros((2, c, _BLOCK), dtype=torch.float32, device=dp.device)
    for r in range(rows):
        lane = lane + part[:, :, r]
    return dy, _halving_tree(lane)


def _route(codes, dpf, hw):
    """float32 (N, C, H, W): each pooled dp routed to the tap its code
    names, the at most four terms of an input element added to 0 in the
    TPU kernel's order (:data:`_ROUTE_ORDER`)."""
    n, c, ho, wo = dpf.shape
    h, w = hw
    _, top, _ = same_pool_geometry(h)
    _, left, _ = same_pool_geometry(w)
    acc = torch.zeros((n, c, 2 * ho + 1, 2 * wo + 1), dtype=torch.float32,
                      device=dpf.device)
    for a, b in _ROUTE_ORDER:
        view = acc[:, :, a:a + 2 * ho - 1:2, b:b + 2 * wo - 1:2]
        view += torch.where(codes == a * 3 + b, dpf, 0.0)
    return acc[:, :, top:top + h, left:left + w]


def _halving_tree(x):
    """Sum over the last axis (a power of two) as x[:s] + x[s:2s], s
    halving: the order of a shared-memory block reduction."""
    s = x.shape[-1] // 2
    while s > 0:
        x = x[..., :s] + x[..., s:2 * s]
        s //= 2
    return x[..., 0]


def _check_cuda_args(name, y, *per_channel):
    if y.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {y.device}")
    c = y.shape[1]
    for v in per_channel:
        if v.device != y.device or v.dtype != torch.float32 \
                or tuple(v.shape) != (c,):
            raise ValueError(f"{name}: inv and shift must be float32 of "
                             f"shape ({c},) on {y.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def bn_pool_relu_eval(y: torch.Tensor, inv: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """Inference-mode ``relu(maxpool_3x3_s2(y*inv + shift))`` on NCHW ``y``
    (cast to bf16, as the TPU op does), float32 ``inv``/``shift`` of
    shape (C,).  Returns bf16 (N, C, ceil(H/2), ceil(W/2)).

    CUDA tensors go to the hand-written kernel and count one launch in
    ``bn_pool_relu_eval.launches``; CPU tensors run the plain version."""
    y = y.to(torch.bfloat16)
    if y.device.type == "cpu":
        return bn_pool_relu_eval_reference(y, inv, shift)
    _check_cuda_args("bn_pool_relu_eval", y, inv, shift)
    n, c, h, w = y.shape
    y, inv, shift = y.contiguous(), inv.contiguous(), shift.contiguous()
    ho, top, _ = same_pool_geometry(h)
    wo, left, _ = same_pool_geometry(w)
    out = torch.empty((n, c, ho, wo), dtype=torch.bfloat16, device=y.device)
    lib = kernel_library()
    err = lib.yolo_bn_pool_relu_eval(
        y.data_ptr(), inv.data_ptr(), shift.data_ptr(), out.data_ptr(),
        n, c, h, w, ho, wo, top, left, y.device.index, _stream(y))
    check_launch(lib, err, "bn_pool_relu_eval")
    bn_pool_relu_eval.launches += 1
    return out


bn_pool_relu_eval.launches = 0


def bn_pool_relu_fwd(y: torch.Tensor, inv: torch.Tensor,
                     shift: torch.Tensor):
    """Train forward of the fused stem: (p bf16, codes uint8), both
    (N, C, ceil(H/2), ceil(W/2)), for NCHW ``y`` (cast to bf16).  ``p``
    is bit-equal to :func:`bn_pool_relu_eval`'s output.  CUDA tensors go
    to the kernel (``bn_pool_relu_fwd.launches``), CPU tensors to
    :func:`bn_pool_relu_reference`."""
    y = y.to(torch.bfloat16)
    if y.device.type == "cpu":
        return bn_pool_relu_reference(y, inv, shift)
    _check_cuda_args("bn_pool_relu_fwd", y, inv, shift)
    n, c, h, w = y.shape
    y, inv, shift = y.contiguous(), inv.contiguous(), shift.contiguous()
    ho, top, _ = same_pool_geometry(h)
    wo, left, _ = same_pool_geometry(w)
    out = torch.empty((n, c, ho, wo), dtype=torch.bfloat16, device=y.device)
    codes = torch.empty((n, c, ho, wo), dtype=torch.uint8, device=y.device)
    lib = kernel_library()
    err = lib.yolo_bn_pool_relu_fwd(
        y.data_ptr(), inv.data_ptr(), shift.data_ptr(), out.data_ptr(),
        codes.data_ptr(), n, c, h, w, ho, wo, top, left, y.device.index,
        _stream(y))
    check_launch(lib, err, "bn_pool_relu_fwd")
    bn_pool_relu_fwd.launches += 1
    return out, codes


bn_pool_relu_fwd.launches = 0


def bn_pool_relu_bwd(codes, dp, p, inv, shift, hw):
    """Code-routed backward of the fused stem: (dy bf16 (N, C, H, W),
    sums (2, C) f32), see :func:`bn_pool_relu_bwd_reference`.  ``dp`` is
    cast to bf16 first, as the TPU op does.  CUDA tensors go to the
    kernel (``bn_pool_relu_bwd.launches``), CPU tensors to the plain
    version."""
    dp = dp.to(torch.bfloat16)
    if dp.device.type == "cpu":
        return bn_pool_relu_bwd_reference(codes, dp, p, inv, shift, hw)
    _check_cuda_args("bn_pool_relu_bwd", dp, inv, shift)
    n, c, ho, wo = dp.shape
    h, w = hw
    if (same_pool_geometry(h)[0], same_pool_geometry(w)[0]) != (ho, wo):
        raise ValueError(f"bn_pool_relu_bwd: input size {hw} does not pool "
                         f"to {(ho, wo)}")
    for name, t, dt in (("codes", codes, torch.uint8),
                        ("p", p, torch.bfloat16)):
        if t.device != dp.device or t.dtype != dt or t.shape != dp.shape:
            raise ValueError(f"bn_pool_relu_bwd: {name} must be {dt} of "
                             f"shape {tuple(dp.shape)} on {dp.device}")
    codes, dp, p = codes.contiguous(), dp.contiguous(), p.contiguous()
    inv, shift = inv.contiguous(), shift.contiguous()
    _, top, _ = same_pool_geometry(h)
    _, left, _ = same_pool_geometry(w)
    chunks = -(-(ho * wo) // _BLOCK)
    dy = torch.empty((n, c, h, w), dtype=torch.bfloat16, device=dp.device)
    partial = torch.empty((n * c * chunks * 2,), dtype=torch.float32,
                          device=dp.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=dp.device)
    lib = kernel_library()
    err = lib.yolo_bn_pool_relu_bwd(
        codes.data_ptr(), dp.data_ptr(), p.data_ptr(), inv.data_ptr(),
        shift.data_ptr(), dy.data_ptr(), partial.data_ptr(), sums.data_ptr(),
        n, c, h, w, ho, wo, top, left, dp.device.index, _stream(dp))
    check_launch(lib, err, "bn_pool_relu_bwd")
    bn_pool_relu_bwd.launches += 1
    return dy, sums


bn_pool_relu_bwd.launches = 0


class _BnPoolRelu(torch.autograd.Function):
    """custom_vjp of the JAX op (stem_pool.py:588-618): saves (codes, p,
    inv, shift) and never ``y``."""

    @staticmethod
    def forward(ctx, y, inv, shift):
        p, codes = bn_pool_relu_fwd(y, inv, shift)
        ctx.save_for_backward(codes, p, inv, shift)
        ctx.y_meta = (y.dtype, tuple(y.shape[2:]))
        return p

    @staticmethod
    def backward(ctx, dp):
        codes, p, inv, shift = ctx.saved_tensors
        y_dtype, hw = ctx.y_meta
        dy, sums = bn_pool_relu_bwd(codes, dp, p, inv, shift, hw)
        # sums[1] = dinv * inv.  A channel whose gamma underflowed to 0
        # has inv == 0 and sums[1] == 0: the guard keeps 0/0 out of dinv
        # (stem_pool.py:604-615)
        zero = inv == 0
        safe_inv = torch.where(zero, torch.ones_like(inv), inv)
        dinv = torch.where(zero, torch.zeros_like(inv), sums[1] / safe_inv)
        return dy.to(y_dtype), dinv.to(inv.dtype), sums[0].to(shift.dtype)


def bn_pool_relu(y: torch.Tensor, inv: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """Train-mode ``relu(maxpool_3x3_s2(y*inv + shift))`` on NCHW ``y``,
    differentiable in ``y``, ``inv`` and ``shift``.  Returns bf16."""
    return _BnPoolRelu.apply(y, inv, shift)


# ------------------------------------------------- pool-only stem (v2) --
def max_pool_s2_reference(y: torch.Tensor, emit_codes: bool = True):
    """Plain version of the pool-only stem: ``p`` bf16 (the SAME 3x3/s2
    max of ``bf16(y)``, -inf padding) and, with ``emit_codes``, the uint8
    codes 0-8 of :func:`_scan_taps`.  Returns (p, codes) or p."""
    y = y.to(torch.bfloat16)
    ho, wo = same_pool_geometry(y.shape[2])[0], same_pool_geometry(
        y.shape[3])[0]
    cur, code = _scan_taps(_pad_same(y), ho, wo)
    p = cur.to(torch.bfloat16)
    return (p, code) if emit_codes else p


def max_pool_s2_bwd_reference(codes: torch.Tensor, dp: torch.Tensor, hw):
    """Plain version of the pool-only backward: dy bf16 (N, C, H, W) from
    uint8 codes and dp (N, C, Ho, Wo), the routed terms summed in float32
    (:func:`_route`) and rounded to bf16 once."""
    return _route(codes, dp.to(torch.bfloat16).float(), hw).to(
        torch.bfloat16)


def _pool_geometry(n, c, h, w):
    """The size arguments of a pool-only launch on an (n, c, h, w) input:
    N, C, H, W, Ho, Wo, pad_top, pad_left."""
    ho, top, _ = same_pool_geometry(h)
    wo, left, _ = same_pool_geometry(w)
    return n, c, h, w, ho, wo, top, left


def max_pool_s2_eval(y: torch.Tensor) -> torch.Tensor:
    """Inference-mode ``maxpool_3x3_s2_SAME(bf16(y))`` on NCHW ``y``, no
    codes: bf16 (N, C, ceil(H/2), ceil(W/2)), bit-equal to
    :func:`max_pool_s2`'s output.  CUDA tensors go to the kernel
    (``max_pool_s2_eval.launches``), CPU tensors to
    :func:`max_pool_s2_reference`."""
    y = y.to(torch.bfloat16)
    if y.device.type == "cpu":
        return max_pool_s2_reference(y, emit_codes=False)
    _check_cuda_args("max_pool_s2_eval", y)
    y = y.contiguous()
    geometry = _pool_geometry(*y.shape)
    shape = geometry[:2] + geometry[4:6]
    out = torch.empty(shape, dtype=torch.bfloat16, device=y.device)
    lib = kernel_library()
    err = lib.yolo_max_pool_s2_eval(y.data_ptr(), out.data_ptr(), *geometry,
                                    y.device.index, _stream(y))
    check_launch(lib, err, "max_pool_s2_eval")
    max_pool_s2_eval.launches += 1
    return out


max_pool_s2_eval.launches = 0


def max_pool_s2_fwd(y: torch.Tensor):
    """Train forward of the pool-only stem: (p bf16, codes uint8), both
    (N, C, ceil(H/2), ceil(W/2)), for NCHW ``y`` (cast to bf16).  CUDA
    tensors go to the kernel (``max_pool_s2_fwd.launches``), CPU tensors
    to :func:`max_pool_s2_reference`."""
    y = y.to(torch.bfloat16)
    if y.device.type == "cpu":
        return max_pool_s2_reference(y)
    _check_cuda_args("max_pool_s2_fwd", y)
    y = y.contiguous()
    geometry = _pool_geometry(*y.shape)
    shape = geometry[:2] + geometry[4:6]
    out = torch.empty(shape, dtype=torch.bfloat16, device=y.device)
    codes = torch.empty(shape, dtype=torch.uint8, device=y.device)
    lib = kernel_library()
    err = lib.yolo_max_pool_s2_fwd(y.data_ptr(), out.data_ptr(),
                                   codes.data_ptr(), *geometry,
                                   y.device.index, _stream(y))
    check_launch(lib, err, "max_pool_s2_fwd")
    max_pool_s2_fwd.launches += 1
    return out, codes


max_pool_s2_fwd.launches = 0


def max_pool_s2_bwd(codes: torch.Tensor, dp: torch.Tensor, hw):
    """Code-routed backward of the pool-only stem: dy bf16 (N, C, H, W)
    for the input size ``hw``, see :func:`max_pool_s2_bwd_reference`.
    ``dp`` is cast to bf16 first, as the TPU op does.  CUDA tensors go to
    the kernel (``max_pool_s2_bwd.launches``), CPU tensors to the plain
    version."""
    dp = dp.to(torch.bfloat16)
    if dp.device.type == "cpu":
        return max_pool_s2_bwd_reference(codes, dp, hw)
    _check_cuda_args("max_pool_s2_bwd", dp)
    n, c, ho, wo = dp.shape
    h, w = hw
    if (same_pool_geometry(h)[0], same_pool_geometry(w)[0]) != (ho, wo):
        raise ValueError(f"max_pool_s2_bwd: input size {hw} does not pool "
                         f"to {(ho, wo)}")
    if codes.device != dp.device or codes.dtype != torch.uint8 \
            or codes.shape != dp.shape:
        raise ValueError(f"max_pool_s2_bwd: codes must be uint8 of shape "
                         f"{tuple(dp.shape)} on {dp.device}")
    codes, dp = codes.contiguous(), dp.contiguous()
    geometry = _pool_geometry(n, c, h, w)
    dy = torch.empty((n, c, h, w), dtype=torch.bfloat16, device=dp.device)
    lib = kernel_library()
    err = lib.yolo_max_pool_s2_bwd(codes.data_ptr(), dp.data_ptr(),
                                   dy.data_ptr(), *geometry,
                                   dp.device.index, _stream(dp))
    check_launch(lib, err, "max_pool_s2_bwd")
    max_pool_s2_bwd.launches += 1
    return dy


max_pool_s2_bwd.launches = 0


class _MaxPoolS2(torch.autograd.Function):
    """custom_vjp of the JAX op (stem_pool.py:548-575): saves the codes
    and never ``y``."""

    @staticmethod
    def forward(ctx, y):
        p, codes = max_pool_s2_fwd(y)
        ctx.save_for_backward(codes)
        ctx.y_meta = (y.dtype, tuple(y.shape[2:]))
        return p

    @staticmethod
    def backward(ctx, dp):
        (codes,) = ctx.saved_tensors
        y_dtype, hw = ctx.y_meta
        return max_pool_s2_bwd(codes, dp, hw).to(y_dtype)


def max_pool_s2(y: torch.Tensor) -> torch.Tensor:
    """Train-mode ``maxpool_3x3_s2_SAME(y)`` on NCHW ``y``, differentiable
    in ``y`` (first-in-scan ties take the whole gradient).  Returns
    bf16."""
    return _MaxPoolS2.apply(y)
