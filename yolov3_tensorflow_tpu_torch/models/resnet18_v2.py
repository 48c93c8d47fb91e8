"""ResNet-18-v2 backbone of the PyTorch port, eval and train (reference:
backbone/resnet18_v2.py:10-74; JAX package: models/resnet18_v2.py).

Pre-activation variant: a 3x3/2 stem conv with no BN or relu, then the
3x3/2 max-pool (the pool-only stem op); four residual modules of two
blocks each, a block being bn+relu -> conv -> bn+relu -> conv -> add,
filters 64/128/256/512.  The first block of a module is NIN-projected and
its 1x1 conv + BN taps the PRE-ACTIVATED input; the second block adds the
raw input (resnet18_v2.py:14-37).  Each of the three stride-8/16/32 taps
gets a bn+relu of its own.  Sub-modules are created in the JAX model's
order (the stem Conv; per block BN, Conv, BN, Conv, [NIN Conv, BN]; the
three tap BNs), so their flax auto-names line up.
"""
from __future__ import annotations

from .layers import BasicBackbone

FILTERS = (64, 128, 256, 512)


class ResNet18V2(BasicBackbone):

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.new_conv(3, 64, stride=2)  # the stem, Conv_0
        self.stages = []
        cin = 64
        for i, filters in enumerate(FILTERS):
            stride = 1 if i == 0 else 2
            self.stages.append(
                (self._residual_block(cin, filters, stride, is_nin=True),
                 self._residual_block(filters, filters, 1, is_nin=False)))
            cin = filters
        self.taps = [self.new_batch_norm(f) for f in FILTERS[1:]]

    @property
    def stem(self):
        """The stem conv, registered as ``Conv_0`` (a second attribute
        holding it would put its weight in the state dict twice)."""
        return self.Conv_0

    def _residual_block(self, cin, filters, stride, is_nin):
        """Creates the block's modules in flax's order."""
        pre = self.new_batch_norm(cin)
        first = self.new_conv(cin, filters, stride=stride)
        mid = self.new_batch_norm(filters)
        second = self.new_conv(filters, filters)
        nin = (self.conv_bn_pair(cin, filters, 1, stride, "VALID")
               if is_nin else None)
        return pre, first, mid, second, nin

    def _apply_block(self, x, block):
        pre_bn, first, mid, second, nin = block
        pre = self.bn_activation(x, pre_bn)
        residual = second(self.bn_activation(first(pre), mid))
        if nin is not None:
            return self.element_wise_add(pre, residual, nin)
        return self.element_wise_add(x, residual)

    def forward(self, x):
        """NCHW images -> (s8, s16, s32) NCHW features
        (resnet18_v2.py:55-74)."""
        net = self.stem_conv_pool(x, self.stem)
        feats = []
        for stage in self.stages:
            for block in stage:
                net = self._apply_block(net, block)
            feats.append(net)
        return tuple(self.bn_activation(f, bn)
                     for f, bn in zip(feats[1:], self.taps))
