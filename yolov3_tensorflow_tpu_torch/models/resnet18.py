"""ResNet-18 backbone of the PyTorch port, eval and train (reference:
backbone/resnet18.py:14-69; JAX package: models/resnet18.py).

Modified ResNet-18: 3x3/2 conv_bn stem + 3x3/2 maxpool + relu (the fused
stem op), then four residual modules of two blocks each (first block
NIN-projected), filters 64/128/256/512, emitting the stride-8/16/32
feature triple.  Sub-modules are created in the JAX model's order (per
block: Conv, BN, Conv, BN, [NIN Conv, BN]), so their flax auto-names
line up, whichever path runs.

Train mode with ``conv_backend="winograd"`` runs the JAX package's fused
Winograd chain (resnet18.py:63-199) where its shape rules admit a block:
the block's two 3x3 convs on the Winograd kernel, each with its output's
BatchNorm statistics from the epilogue, the first BatchNorm's apply +
relu riding the second conv's input read, and the block's own apply +
add + relu deferred as the chain state ``("def", y_raw, identity, inv,
shift)``.  A chain block that starts from a deferred state takes it on
its first conv's read (``hconv_bn_add_act_stats``), whose boundary
activation is the block's identity (or the NIN projection's input); a
block outside the rules, and each module's end, materializes it.  At the
default ``winograd_min_channels=128`` the chain is module 2's second
block alone (module 1 is below the floor, modules 3-4 outside the
kernel's shape rules, every first block strided); at 64 module 1's two
blocks join it, the second from the first's deferred state.  Every other
block is the classic NCHW block.
"""
from __future__ import annotations

from .layers import BasicBackbone, bn_apply, count_per_channel

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
        residual = self.activation(self.conv_bn(x, first))
        residual = self.conv_bn(residual, second)
        return self.activation(self.element_wise_add(x, residual, nin))

    # ----------------------------------------------- winograd chain ----
    def _materialize(self, state):
        """Chain state -> tensor: the deferred ``relu(bn(y) + identity)``
        as one elementwise pass."""
        if state[0] == "mat":
            return state[1]
        _, y, ident, inv, shift = state
        return self.activation(bn_apply(y, inv, shift, self.dtype)
                               + ident.to(self.dtype))

    def _chain_residual_block(self, state, block):
        """One residual block as part of the fused chain (JAX
        ``_chain_residual_block``): takes and returns a chain state."""
        (conv1, bn1), (conv2, bn2), nin = block
        x = state[1]
        if not self.chain_ok(x.shape, conv1, x.device.type):
            return ("mat", self._apply_block(self._materialize(state),
                                             block))
        if state[0] == "mat":
            a_prev = x
            y1, total1, sq1 = self.fused_conv_stats(x, conv1)
        else:  # the previous block's boundary rides this conv's read
            _, y_prev, ident_prev, inv_p, shift_p = state
            y1, a_prev, total1, sq1 = self.fused_conv_stats(
                y_prev, conv1, prologue=(inv_p, shift_p), ident=ident_prev)
        inv1, shift1 = bn1.stats_scalars(total1, sq1, count_per_channel(y1))
        y2, total2, sq2 = self.fused_conv_stats(y1, conv2,
                                                prologue=(inv1, shift1))
        inv2, shift2 = bn2.stats_scalars(total2, sq2, count_per_channel(y2))
        ident = self.conv_bn(a_prev, nin) if nin is not None else a_prev
        return ("def", y2, ident, inv2, shift2)

    def _chain_module(self, state, stage):
        for block in stage:
            state = self._chain_residual_block(state, block)
        return state

    # ------------------------------------------------------- entry ----
    def forward(self, x):
        """NCHW images -> (s8, s16, s32) NCHW features (resnet18.py:53-69).
        The chain engages per module as in JAX (resnet18.py:149-199): module
        1 when its 64-channel blocks pass the shape rules, modules 2-4 when
        module 2's do."""
        n, _, h, w = x.shape
        dev = x.device.type
        chain_m1 = self.chain_ok((n, 64, h // 4, w // 4),
                                 self.stages[0][1][0][0], dev)
        chain_deep = self.chain_ok((n, 128, h // 8, w // 8),
                                   self.stages[1][1][0][0], dev)
        net = self.stem_conv_bn_pool_relu(x, self.stem)
        feats = []
        for i, stage in enumerate(self.stages):
            if chain_m1 or (chain_deep and i > 0):
                net = self._materialize(self._chain_module(("mat", net),
                                                           stage))
            else:
                for block in stage:
                    net = self._apply_block(net, block)
            feats.append(net)
        return feats[1], feats[2], feats[3]
