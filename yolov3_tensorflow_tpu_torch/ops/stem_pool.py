"""Fused eval stem: BatchNorm-apply + 3x3/s2 max-pool + relu.

Port of ``yolov3_tensorflow_tpu/ops/stem_pool.py`` ``bn_pool_relu_eval``
(the code-free forward of the fused stem; the train forward with argmax
codes and its backward come with the training slice).

    p = relu(maxpool_3x3_s2_SAME(bf16(bf16(y * inv_b) + shift_b)))

on an NCHW tensor, with ``inv_b = bf16(inv)`` and ``shift_b = bf16(shift)``
per channel.  On a CUDA tensor :func:`bn_pool_relu_eval` launches the
hand-written kernel (``csrc/stem_pool.cu``); on a CPU tensor it runs the
plain PyTorch version :func:`bn_pool_relu_eval_reference`, which is also the
kernel's test oracle.  There is no fallback: a tensor on any other device,
a failed build or a failed launch raises.

Pooling geometry is TF SAME for window 3 / stride 2: ``Ho = ceil(H/2)``,
``pad_top = max((Ho-1)*2 + 3 - H, 0) // 2`` (0 for even H, so window r
covers rows 2r..2r+2), and the same for columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import check_launch, kernel_library


def same_pool_geometry(size: int):
    """(out, pad_lo, pad_hi) of a TF SAME 3x3/s2 window along one axis."""
    out = -(-size // 2)
    pad_total = max((out - 1) * 2 + 3 - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def bn_pool_relu_eval_reference(y: torch.Tensor, inv: torch.Tensor,
                                shift: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch composition of the fused eval stem, in ``y``'s dtype:
    mul and add each round to ``y.dtype`` (bf16 for the kernel's
    semantics), then SAME max-pool in f32 and relu.  y: (N, C, H, W);
    inv, shift: (C,) float32.  Returns ``y.dtype``."""
    dt = y.dtype
    t = y * inv.to(dt)[None, :, None, None]
    t = t + shift.to(dt)[None, :, None, None]
    _, top, bottom = same_pool_geometry(y.shape[2])
    _, left, right = same_pool_geometry(y.shape[3])
    t = F.pad(t.float(), (left, right, top, bottom), value=float("-inf"))
    return F.relu(F.max_pool2d(t, 3, 2)).to(dt)


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
    if y.device.type != "cuda":
        raise ValueError(f"bn_pool_relu_eval: no kernel for device "
                         f"{y.device}")
    n, c, h, w = y.shape
    for name, v in (("inv", inv), ("shift", shift)):
        if v.device != y.device or v.dtype != torch.float32 \
                or tuple(v.shape) != (c,):
            raise ValueError(f"bn_pool_relu_eval: {name} must be float32 "
                             f"of shape ({c},) on {y.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    y = y.contiguous()
    inv = inv.contiguous()
    shift = shift.contiguous()
    ho, top, _ = same_pool_geometry(h)
    wo, left, _ = same_pool_geometry(w)
    out = torch.empty((n, c, ho, wo), dtype=torch.bfloat16, device=y.device)
    lib = kernel_library()
    err = lib.yolo_bn_pool_relu_eval(
        y.data_ptr(), inv.data_ptr(), shift.data_ptr(), out.data_ptr(),
        n, c, h, w, ho, wo, top, left, y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    check_launch(lib, err, "bn_pool_relu_eval")
    bn_pool_relu_eval.launches += 1
    return out


bn_pool_relu_eval.launches = 0
