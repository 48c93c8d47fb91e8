"""ResNet-18 backbone of the PyTorch port, eval mode (reference:
backbone/resnet18.py:14-69; JAX package: models/resnet18.py, classic
path).

Modified ResNet-18: 3x3/2 conv_bn stem + 3x3/2 maxpool + relu (the fused
stem op), then four residual modules of two blocks each (first block
NIN-projected), filters 64/128/256/512, emitting the stride-8/16/32
feature triple.  Sub-modules are created in the JAX model's order (per
block: Conv, BN, Conv, BN, [NIN Conv, BN]), so their flax auto-names
line up.  The Winograd chain of the JAX package is train-only and comes
with the training slice.
"""
from __future__ import annotations

from .layers import BasicBackbone

FILTERS = (64, 128, 256, 512)


class ResNet18(BasicBackbone):

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.stem = self.conv_bn_pair(3, 64, stride=2)
        self.stages = []
        cin = 64
        for i, filters in enumerate(FILTERS):
            stride = 1 if i == 0 else 2
            self.stages.append(
                (self._residual_block(cin, filters, stride, is_nin=True),
                 self._residual_block(filters, filters, 1, is_nin=False)))
            cin = filters

    def _residual_block(self, cin, filters, stride, is_nin):
        """input -> conv+bn -> relu -> conv+bn -> add -> relu
        (resnet18.py:18-35); creates the block's modules."""
        first = self.conv_bn_pair(cin, filters, stride=stride)
        second = self.conv_bn_pair(filters, filters)
        nin = (self.conv_bn_pair(cin, filters, 1, stride, "VALID")
               if is_nin else None)
        return first, second, nin

    def _apply_block(self, x, block):
        first, second, nin = block
        residual = self.conv_bn_relu(x, first)
        residual = self.conv_bn(residual, second)
        return self.activation(self.element_wise_add(x, residual, nin))

    def forward(self, x):
        """NCHW images -> (s8, s16, s32) NCHW features (resnet18.py:53-69)."""
        net = self.stem_conv_bn_pool_relu(x, self.stem)
        feats = []
        for stage in self.stages:
            for block in stage:
                net = self._apply_block(net, block)
            feats.append(net)
        return feats[1], feats[2], feats[3]
