"""YOLOv3 detector of the PyTorch port: backbone + 3-scale heads.

Port of ``yolov3_tensorflow_tpu/models/detector.py`` (reference:
yolov3/yolov3_detector.py:15-151) for the resnet-18 and resnet-18-v2
backbones.  The heads are op for op the JAX model's:

  * /32 head: conv_bn(512) -> relu -> 1x1 head conv
  * /16 head: 3x3 conv_bn(256) on the /32 feature -> 2x nearest upsample
    -> concat(s16) -> 1x1 conv_bn(256) -> 3x3 conv_bn(512) -> 1x1 head conv
  * /8 head: 1x1 conv_bn(128) on merge16 -> upsample -> concat(s8) ->
    1x1 conv_bn(128) -> 3x3 conv_bn(256) -> 1x1 head conv
  * head output convs: RandomNormal(0.01) init, with bias.

``forward`` returns the three raw heads in NCHW float32, in eval mode or,
after ``.train()``, with train-mode BatchNorm everywhere and the train
stem.  With ``conv_backend="winograd"`` a train forward routes the convs
that the JAX package's shape rules admit to the Winograd kernel (the
backbone's chain, and the four 3x3 head links through
``conv_bn_relu``, which the rules never admit at the heads' widths); eval
always runs direct convolution, as in JAX.  The JAX model
returns the heads NHWC, and every reshape to (N, H, W, B, box_len)
(decoder, :func:`pack_heads`) is over channels-last, so those permute
first.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import (ALL_BACKBONES, BACKBONE_RESNET_18,
                      BACKBONE_RESNET_18_V2, Config)
from ..device import resolve_device
from .layers import BasicBackbone, Conv2dSame, upsample2x_nearest
from .resnet18 import ResNet18
from .resnet18_v2 import ResNet18V2

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BACKBONES = {BACKBONE_RESNET_18: ResNet18, BACKBONE_RESNET_18_V2: ResNet18V2}


class YOLOv3Detector(BasicBackbone):
    """``forward(images)`` -> (p8, p16, p32) raw heads, NCHW float32,
    channels = box_num * box_len."""

    def __init__(self, backbone_name: str = BACKBONE_RESNET_18,
                 head_channel_nums: Tuple[int, int, int] = (15, 10, 15),
                 **kwargs):
        super().__init__(**kwargs)
        if backbone_name not in BACKBONES:
            if backbone_name in ALL_BACKBONES:
                raise NotImplementedError(
                    f"backbone {backbone_name!r} is not ported yet "
                    "(ROADMAP Queue 1, other backbones)")
            raise ValueError(f"no such backbone: {backbone_name}")
        self.backbone = BACKBONES[backbone_name](
            dtype=self.dtype, stem_backend=self.stem_backend,
            conv_backend=self.conv_backend,
            winograd_min_channels=self.winograd_min_channels,
            generator=self.generator)
        c8, c16, c32 = head_channel_nums
        # creation order = the JAX model's call order (flax names)
        self.tower32 = self.conv_bn_pair(512, 512)
        self.head_out_32 = self._head_out_conv(512, c32)
        self.branch16 = self.conv_bn_pair(512, 256)
        self.merge16 = self.conv_bn_pair(512, 256, 1)
        self.tower16 = self.conv_bn_pair(256, 512)
        self.head_out_16 = self._head_out_conv(512, c16)
        self.branch8 = self.conv_bn_pair(256, 128, 1)
        self.merge8 = self.conv_bn_pair(256, 128, 1)
        self.tower8 = self.conv_bn_pair(128, 256)
        self.head_out_8 = self._head_out_conv(256, c8)

    def _head_out_conv(self, cin, channels):
        """Final 1x1 head conv: RandomNormal(0.01), bias, no L2
        (yolov3_detector.py:98-100); registered as head_out_<stride> by
        the attribute it is assigned to."""
        return Conv2dSame(cin, channels, 1, bias=True, dtype=self.dtype,
                          init_std=0.01, generator=self.generator)

    def forward(self, images: torch.Tensor):
        """images: (N, 3, H, W) float in [0, 1]."""
        s8, s16, s32 = self.backbone(images)

        p32 = self.head_out_32(self.conv_bn_relu(s32, self.tower32))

        net = upsample2x_nearest(self.conv_bn_relu(s32, self.branch16))
        merge16 = torch.cat([net, s16.to(net.dtype)], dim=1)
        merge16 = self.conv_bn_relu(merge16, self.merge16)
        p16 = self.head_out_16(self.conv_bn_relu(merge16, self.tower16))

        net = upsample2x_nearest(self.conv_bn_relu(merge16, self.branch8))
        merge8 = torch.cat([net, s8.to(net.dtype)], dim=1)
        merge8 = self.conv_bn_relu(merge8, self.merge8)
        p8 = self.head_out_8(self.conv_bn_relu(merge8, self.tower8))
        return p8.float(), p16.float(), p32.float()


def build_detector(cfg: Config, device="cuda",
                   generator: Optional[torch.Generator] = None
                   ) -> YOLOv3Detector:
    """The detector of ``cfg.model_backbone`` on ``device`` (CUDA unless the
    caller asks for the CPU), in eval mode.  Weights are drawn on the
    CPU from ``generator`` (seed 0 when None), then moved."""
    device = resolve_device(device)
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = YOLOv3Detector(
        backbone_name=cfg.model_backbone,
        head_channel_nums=tuple(cfg.head_channel_nums),
        conv_backend=cfg.conv_backend,
        winograd_min_channels=cfg.winograd_min_channels,
        dtype=COMPUTE_DTYPES[cfg.compute_dtype],
        stem_backend=cfg.stem_backend,
        generator=generator)
    return model.to(device).eval()


def _nhwc(p: torch.Tensor) -> torch.Tensor:
    return p.permute(0, 2, 3, 1)


def pack_heads(p8, p16, p32):
    """The reference's merged single-tensor layout (yolov3_detector.py:
    79-86) from NCHW heads: each head goes channels-last, /8 and /16 are
    reshaped onto the /32 grid (channels x16 and x4), then concatenated.
    Returns the NHWC merged tensor, as the JAX pack_heads does."""
    p8, p16, p32 = _nhwc(p8), _nhwc(p16), _nhwc(p32)
    n, h32, w32, _ = p32.shape
    r8 = p8.reshape(n, h32, w32, -1)
    r16 = p16.reshape(n, h32, w32, -1)
    return torch.cat([r8, r16, p32], dim=-1)


def unpack_heads(merged, head_grid_sizes: Sequence, box_nums: Sequence,
                 box_len: int):
    """Inverse of :func:`pack_heads` (reference yolov3_decoder.py:89-117):
    the NHWC merged tensor -> (N, H, W, B, box_len) per head."""
    (h8, w8), (h16, w16), (h32, w32) = head_grid_sizes
    b8, b16, b32 = box_nums
    n = merged.shape[0]
    c8 = b8 * box_len * 16
    c16 = b16 * box_len * 4
    p8 = merged[..., :c8].reshape(n, h8, w8, b8, box_len)
    p16 = merged[..., c8:c8 + c16].reshape(n, h16, w16, b16, box_len)
    p32 = merged[..., c8 + c16:].reshape(n, h32, w32, b32, box_len)
    return p8, p16, p32
