"""Backbone op vocabulary of the PyTorch port, eval mode.

Port of ``yolov3_tensorflow_tpu/models/layers.py`` (the reference's
``BasicBackbone``, backbone/basic_backbone.py:9-163) for the serving path:

  * conv: he_normal init, no bias, TF SAME padding.  TF SAME pads the
    extra row/column AFTER the image for stride 2 on even sizes, which
    ``nn.Conv2d(padding=1)`` cannot express (it pads symmetrically), so
    :class:`Conv2dSame` pads explicitly by the SAME formula.
  * :class:`FusedBatchNorm`: eval-mode apply from the running averages,
    ``inv = rsqrt(var + eps) * scale`` and ``shift = bias - mean * inv`` in
    float32, applied as ``x * inv + shift`` in the compute dtype.  Train-mode
    statistics come with the training slice.
  * residual merge with the 1x1 NIN + BN projection, relu, 2x nearest
    upsample, and the fused stem ``conv -> BN + 3x3/s2 max-pool + relu``.

Tensors are NCHW.  Modules carry flax's auto-names (``Conv_k``,
``FusedBatchNorm_k``, numbered in creation order per module), so a flax
variable tree maps onto the state dict by name (tools/import_flax.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem_pool import bn_pool_relu_eval, bn_pool_relu_eval_reference

BN_EPSILON = 1e-5  # (basic_backbone.py:14)
STEM_BACKENDS = ("auto", "fused", "xla")
# flax he_normal = variance_scaling(2, fan_in, truncated_normal): the
# normal is truncated at 2 std and rescaled by this constant
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME (pad_lo, pad_hi) along one axis: the odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Module):
    """2-D convolution with TF padding semantics ("SAME" or "VALID"),
    OIHW ``weight`` in float32, run in ``dtype``.  ``bias`` (head output
    convs only) is added after the conv in ``dtype``, as flax's nn.Conv
    does."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: str = "SAME", bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        if init_std is None:  # he_normal
            std = math.sqrt(2.0 / (cin * kernel_size * kernel_size)) \
                / _TRUNC_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            nn.init.normal_(self.weight, 0.0, init_std, generator=generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.padding == "SAME":
            top, bottom = same_padding(x.shape[2], self.kernel_size,
                                       self.stride)
            left, right = same_padding(x.shape[3], self.kernel_size,
                                       self.stride)
            if (top, left) == (bottom, right):
                y = F.conv2d(x, w, stride=self.stride, padding=(top, left))
            else:
                y = F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                             stride=self.stride)
        else:
            y = F.conv2d(x, w, stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[None, :, None, None]
        return y


class FusedBatchNorm(nn.Module):
    """Eval-mode BatchNorm with float32 parameters and running averages
    (``scale``, ``bias``; buffers ``mean``, ``var``) and compute-dtype I/O
    (JAX ``FusedBatchNorm`` with ``use_running_average=True``)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 epsilon: float = BN_EPSILON):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def scalars(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 (inv, shift) of the running-average apply."""
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm statistics come with the training "
                "slice of the port (ROADMAP Queue 1); call .eval()")
        inv, shift = self.scalars()
        return x.to(self.dtype) * inv.to(self.dtype)[None, :, None, None] \
            + shift.to(self.dtype)[None, :, None, None]


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NCHW (keras UpSampling2D nearest,
    yolov3_detector.py:115)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class BasicBackbone(nn.Module):
    """Base module giving the backbones and the detector the shared op
    vocabulary.  :meth:`conv_bn_pair` creates and registers sub-modules
    under flax's auto-names; the remaining methods apply them."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stem_backend: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem_backend not in STEM_BACKENDS:
            raise ValueError(f"unknown stem_backend {stem_backend!r} "
                             f"(choose from {', '.join(STEM_BACKENDS)})")
        self.dtype = dtype
        self.stem_backend = stem_backend
        self.generator = generator
        self._name_counts = {}

    def _register(self, kind: str, module: nn.Module) -> nn.Module:
        k = self._name_counts.get(kind, 0)
        self._name_counts[kind] = k + 1
        self.add_module(f"{kind}_{k}", module)
        return module

    # ---------------------------------------------------------- create --
    def conv_bn_pair(self, cin: int, cout: int, kernel_size: int = 3,
                     stride: int = 1, padding: str = "SAME"):
        """A conv (he_normal, no bias, default 3x3/1 SAME,
        basic_backbone.py:20-43) and the BatchNorm after it (momentum .9,
        eps 1e-5, basic_backbone.py:68-78), created in flax's order."""
        conv = self._register("Conv", Conv2dSame(
            cin, cout, kernel_size, stride, padding, dtype=self.dtype,
            generator=self.generator))
        return conv, self._register(
            "FusedBatchNorm", FusedBatchNorm(cout, dtype=self.dtype))

    # ----------------------------------------------------------- apply --
    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)

    @staticmethod
    def conv_bn(x, pair):
        conv, bn = pair
        return bn(conv(x))

    def conv_bn_relu(self, x, pair):
        return self.activation(self.conv_bn(x, pair))

    def element_wise_add(self, identity, residual, nin=None):
        """Residual merge with the optional 1x1 NIN conv + BN on the
        identity branch (basic_backbone.py:102-125)."""
        if nin is not None:
            identity = self.conv_bn(identity, nin)
        return identity + residual

    def stem_conv_bn_pool_relu(self, x, pair):
        """The reference stem chain conv_bn -> max_pool(3x3/2) -> relu
        (resnet18.py:53-58).  ``stem_backend`` "auto"/"fused" run the
        fused BN + pool + relu op (the hand-written kernel on CUDA, its
        plain version on CPU); "xla" runs the plain composition in the
        compute dtype."""
        conv, bn = pair
        y = conv(x)
        inv, shift = bn.scalars()
        if self.stem_backend == "xla":
            return bn_pool_relu_eval_reference(y, inv, shift)
        return bn_pool_relu_eval(y, inv, shift)
