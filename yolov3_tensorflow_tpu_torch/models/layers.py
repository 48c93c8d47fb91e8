"""Backbone op vocabulary of the PyTorch port, eval and train mode.

Port of ``yolov3_tensorflow_tpu/models/layers.py`` (the reference's
``BasicBackbone``, backbone/basic_backbone.py:9-163):

  * conv: he_normal init, no bias, TF SAME padding.  TF SAME pads the
    extra row/column AFTER the image for stride 2 on even sizes, which
    ``nn.Conv2d(padding=1)`` cannot express (it pads symmetrically), so
    :class:`Conv2dSame` pads explicitly by the SAME formula.
  * :class:`FusedBatchNorm`: float32 statistics and running averages,
    compute-dtype tensor I/O.  Eval applies the running averages; train
    uses the batch's single-pass biased statistics and moves the running
    averages by momentum 0.9 (the opposite conventions of
    ``nn.BatchNorm2d``, which keeps 0.1 of the old value and tracks the
    unbiased variance).  Either way ``inv = rsqrt(var + eps) * scale`` and
    ``shift = bias - mean * inv`` in float32, applied as
    ``x * inv + shift`` in the compute dtype.
  * residual merge with the 1x1 NIN + BN projection, relu, 2x nearest
    upsample, the fused stem ``conv -> BN + 3x3/s2 max-pool + relu`` and
    the pool-only stem ``conv -> 3x3/s2 max-pool`` (ResNet-18-v2).
  * :func:`l2_regularization`: the explicit L2 terms Keras keeps in
    ``model.losses``.
  * the Winograd routing of ``conv_backend="winograd"`` (train only):
    :meth:`BasicBackbone.fused_ok` / :meth:`~BasicBackbone.chain_ok` (the
    JAX package's shape rules and ``winograd_min_channels`` floor) and
    :meth:`~BasicBackbone.fused_conv_stats`, the conv on the kernel
    (ops/winograd.py) with its BatchNorm statistics from the epilogue,
    which :meth:`FusedBatchNorm.stats_scalars` turns into apply scalars.

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

from ..ops.stem_pool import (bn_pool_relu, bn_pool_relu_eval,
                              bn_pool_relu_eval_reference, max_pool_s2,
                              max_pool_s2_eval, same_pool_geometry)
from ..ops.winograd import (eligible, hconv_bn_act_stats,
                            hconv_bn_add_act_stats, hconv_stats)

L2_CONV_DECAY = 5.0e-4  # conv kernel weight decay (basic_backbone.py:11)
BN_L2_GAMMA_DECAY = 1.0e-5  # BN gamma weight decay (basic_backbone.py:12)
BN_MOMENTUM = 0.9  # share of the old running average (basic_backbone.py:13)
BN_EPSILON = 1e-5  # (basic_backbone.py:14)
# the three detection-head output convs carry no L2 regularizer
# (yolov3_detector.py:98-100); their module names contain this marker
HEAD_OUT_MARKER = "head_out"
STEM_BACKENDS = ("auto", "fused", "xla")
CONV_BACKENDS = ("xla", "winograd")
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
    """BatchNorm with float32 parameters (``scale``, ``bias``) and running
    averages (buffers ``mean``, ``var``) and compute-dtype tensor I/O (JAX
    ``FusedBatchNorm``).  Follows ``self.training``: train mode normalizes
    with the batch statistics and updates the running averages."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 epsilon: float = BN_EPSILON):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _apply_scalars(self, mean, var):
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return inv, self.bias - mean * inv

    def scalars(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 (inv, shift) of the running-average apply."""
        return self._apply_scalars(self.mean, self.var)

    def stats_scalars(self, total: torch.Tensor, total_sq: torch.Tensor,
                      count: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-mode (inv, shift) from the per-channel float32 sum and
        sum of squares of ``count`` elements: biased single-pass variance
        ``max(E[x^2] - E[x]^2, 0)``.  Moves the running averages as
        ``ra = 0.9 * ra + 0.1 * stat`` (statistics detached) and returns
        scalars that stay differentiable in the sums, scale and bias."""
        mean = total / count
        var = torch.clamp(total_sq / count - mean.square(), min=0.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return self._apply_scalars(mean, var)

    def batch_scalars(self, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-mode (inv, shift) of NCHW ``x``: :meth:`stats_scalars`
        on its float32 per-channel sums."""
        x32 = x.float()
        return self.stats_scalars(x32.sum((0, 2, 3)),
                                  x32.square().sum((0, 2, 3)),
                                  count_per_channel(x32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.batch_scalars(x) if self.training \
            else self.scalars()
        return bn_apply(x, inv, shift, self.dtype)


def bn_apply(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The BatchNorm apply ``x * inv + shift`` on NCHW ``x`` in ``dtype``
    (each op rounds to it), from float32 per-channel scalars."""
    return x.to(dtype) * inv.to(dtype)[None, :, None, None] \
        + shift.to(dtype)[None, :, None, None]


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NCHW (keras UpSampling2D nearest,
    yolov3_detector.py:115)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class BasicBackbone(nn.Module):
    """Base module giving the backbones and the detector the shared op
    vocabulary.  :meth:`new_conv`, :meth:`new_batch_norm` and
    :meth:`conv_bn_pair` create and register sub-modules under flax's
    auto-names; the remaining methods apply them."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stem_backend: str = "auto", conv_backend: str = "xla",
                 winograd_min_channels: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem_backend not in STEM_BACKENDS:
            raise ValueError(f"unknown stem_backend {stem_backend!r} "
                             f"(choose from {', '.join(STEM_BACKENDS)})")
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"unknown conv_backend {conv_backend!r} "
                             f"(choose from {', '.join(CONV_BACKENDS)})")
        self.dtype = dtype
        self.stem_backend = stem_backend
        self.conv_backend = conv_backend
        self.winograd_min_channels = winograd_min_channels
        self.generator = generator
        self._name_counts = {}

    def _register(self, kind: str, module: nn.Module) -> nn.Module:
        k = self._name_counts.get(kind, 0)
        self._name_counts[kind] = k + 1
        self.add_module(f"{kind}_{k}", module)
        return module

    # ---------------------------------------------------------- create --
    def new_conv(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: str = "SAME") -> Conv2dSame:
        """A conv (he_normal, no bias, default 3x3/1 SAME,
        basic_backbone.py:20-43), registered as the next ``Conv_k``."""
        return self._register("Conv", Conv2dSame(
            cin, cout, kernel_size, stride, padding, dtype=self.dtype,
            generator=self.generator))

    def new_batch_norm(self, features: int) -> FusedBatchNorm:
        """A BatchNorm (momentum .9, eps 1e-5, basic_backbone.py:68-78),
        registered as the next ``FusedBatchNorm_k``."""
        return self._register("FusedBatchNorm",
                              FusedBatchNorm(features, dtype=self.dtype))

    def conv_bn_pair(self, cin: int, cout: int, kernel_size: int = 3,
                     stride: int = 1, padding: str = "SAME"):
        """A conv and the BatchNorm after it, created in flax's order."""
        conv = self.new_conv(cin, cout, kernel_size, stride, padding)
        return conv, self.new_batch_norm(cout)

    # ----------------------------------------------------------- apply --
    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)

    @staticmethod
    def conv_bn(x, pair):
        conv, bn = pair
        return bn(conv(x))

    def conv_bn_relu(self, x, pair):
        """conv_bn -> relu, on the fused Winograd path when eligible (the
        conv with its statistics epilogue, then one apply + relu pass; JAX
        layers.py:640-653), otherwise the classic composition."""
        conv, bn = pair
        if self.fused_ok(x, conv):
            y, total, total_sq = self.fused_conv_stats(x, conv)
            inv, shift = bn.stats_scalars(total, total_sq,
                                          count_per_channel(y))
            return self.activation(bn_apply(y, inv, shift, self.dtype))
        return self.activation(self.conv_bn(x, pair))

    def bn_activation(self, x, bn):
        """BatchNorm then relu (basic_backbone.py:152-163)."""
        return self.activation(bn(x))

    def element_wise_add(self, identity, residual, nin=None):
        """Residual merge with the optional 1x1 NIN conv + BN on the
        identity branch (basic_backbone.py:102-125)."""
        if nin is not None:
            identity = self.conv_bn(identity, nin)
        return identity + residual

    # ------------------------------------------- winograd fused chain --
    def _use_winograd(self, shape_nhwc, conv: Conv2dSame,
                      device_type: str) -> bool:
        """Does ``conv`` on an input of NHWC shape ``shape_nhwc`` run on
        the Winograd kernel?  (JAX layers.py:328-349): not for "xla"; not
        below the ``winograd_min_channels`` floor on either side; then
        :func:`eligible`."""
        if self.conv_backend == "xla":
            return False
        filters = conv.weight.shape[0]
        min_c = self.winograd_min_channels
        if min_c and (shape_nhwc[3] < min_c or filters < min_c):
            return False
        k, s = conv.kernel_size, conv.stride
        return eligible(shape_nhwc, filters, (k, k), (s, s), conv.padding, 1,
                        device_type)

    def chain_ok(self, shape_nchw, conv: Conv2dSame, device_type: str
                 ) -> bool:
        """Can a residual block whose first conv is ``conv`` run on the
        fused Winograd chain at this NCHW input shape?  Train only."""
        n, c, h, w = shape_nchw
        return self.training and self._use_winograd((n, h, w, c), conv,
                                                    device_type)

    def fused_ok(self, x: torch.Tensor, conv: Conv2dSame) -> bool:
        """Can a conv_bn -> relu link on NCHW ``x`` run on the fused
        Winograd path?  Train only."""
        return self.chain_ok(x.shape, conv, x.device.type)

    def fused_conv_stats(self, x, conv: Conv2dSame, prologue=None,
                         ident=None):
        """``conv`` on the Winograd kernel, returning (y_raw, sum,
        sumsq): with ``prologue=(inv, shift)`` the previous BatchNorm's
        apply + relu ride the conv's input read; with ``ident`` as well,
        the previous residual boundary (apply + add + relu) rides it and
        the boundary activation ``a`` comes back too, as (y_raw, a, sum,
        sumsq) (JAX ``fused_conv_stats`` with ``WinogradConv3x3``)."""
        w = conv.weight.to(self.dtype)
        if ident is not None:
            return hconv_bn_add_act_stats(x, ident, w, *prologue)
        if prologue is None:
            return hconv_stats(x, w)
        return hconv_bn_act_stats(x, w, *prologue)

    def stem_conv_bn_pool_relu(self, x, pair):
        """The reference stem chain conv_bn -> max_pool(3x3/2) -> relu
        (resnet18.py:53-58).  ``stem_backend`` "auto"/"fused" run the
        fused BN + pool + relu op: in eval the code-free kernel on the
        running-average scalars; in train the float32 conv-output sums
        give the BN scalars and :func:`bn_pool_relu` (argmax codes forward,
        code-routed backward) applies them (JAX layers.py:569-594).  On a
        CUDA tensor each runs its hand-written kernel, on a CPU tensor its
        plain version.  "xla" runs the plain composition in the compute
        dtype: BN, SAME max-pool with -inf padding, relu."""
        conv, bn = pair
        y = conv(x)
        if not self.training:
            inv, shift = bn.scalars()
            if self.stem_backend == "xla":
                return bn_pool_relu_eval_reference(y, inv, shift)
            return bn_pool_relu_eval(y, inv, shift)
        if self.stem_backend == "xla":
            return self.activation(max_pool_same(bn(y)))
        return bn_pool_relu(y, *bn.batch_scalars(y))

    def stem_conv_pool(self, x, conv):
        """The ResNet-18-v2 stem chain conv -> max_pool(3x3/2), with no BN
        or relu (resnet18_v2.py:61-62; JAX layers.py:628-638).
        ``stem_backend`` "auto"/"fused" run the pool-only op on the conv
        output cast to bf16: :func:`max_pool_s2_eval` in eval,
        :func:`max_pool_s2` (codes forward, code-routed backward) in train;
        the kernels on a CUDA tensor, their plain versions on a CPU one.
        "xla" runs :func:`max_pool_same` in the compute dtype (the JAX
        classic path)."""
        y = conv(x)
        if self.stem_backend == "xla":
            return max_pool_same(y)
        return max_pool_s2(y) if self.training else max_pool_s2_eval(y)


def count_per_channel(y: torch.Tensor) -> float:
    """Elements per channel of NCHW ``y``: the BatchNorm count."""
    return float(y.numel() // y.shape[1])


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max-pool with TF SAME windows and -inf padding (flax
    ``nn.max_pool(padding="SAME")``), in ``x``'s dtype."""
    _, top, bottom = same_pool_geometry(x.shape[2])
    _, left, right = same_pool_geometry(x.shape[3])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def l2_regularization(model: nn.Module
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit L2 weight-decay terms, replacing Keras ``model.losses``
    (JAX layers.py:677-702): ``(kernel_reg, gamma_reg)`` with
    kernel_reg = 5e-4 * sum(w^2) over every conv weight except the head
    output convs, and gamma_reg = 1e-5 * sum(gamma^2) over every BN scale.
    Keras ``l2(l)`` is ``l * sum(square(w))``, with no 1/2 factor."""
    kernel_sq, gamma_sq = [], []
    for name, module in model.named_modules():
        if isinstance(module, Conv2dSame) and HEAD_OUT_MARKER not in name:
            kernel_sq.append(module.weight.float().square().sum())
        elif isinstance(module, FusedBatchNorm):
            gamma_sq.append(module.scale.float().square().sum())
    zero = next(model.parameters()).new_zeros(())
    kernel_reg = L2_CONV_DECAY * (sum(kernel_sq) if kernel_sq else zero)
    gamma_reg = BN_L2_GAMMA_DECAY * (sum(gamma_sq) if gamma_sq else zero)
    return kernel_reg, gamma_reg
