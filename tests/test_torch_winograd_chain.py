"""The flagship's fused Winograd chain of the port against the JAX package
on the CPU, its Pallas kernel in interpret mode: the routing rules, one
fused link, and the flagship's train forward and backward at 64x64.  The
kernel op and its autograd ops are held against JAX in
tests/test_torch_winograd.py, whose helpers this file shares.

Tolerances:
  * a fused link against the classic composition within 3e-2, its
    running averages within 1e-2 of scale;
  * the flagship's train heads within 3e-2 (the bf16 stem-backend bound
    of tests/test_stem_pool.py), the gradients of the chain's two convs
    and two BatchNorms within 0.05 of scale, for a cotangent on the
    chain's module output, against the JAX model traced with its bf16
    sums accumulated in float32 (:func:`flagship` says why);
  * ``eligible`` and the routed kernel calls equal to JAX's.
"""
import contextlib

import jax
import jax._src.lax.lax as jax_lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.models.detector import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu.ops import winograd as jw
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.models.detector import build_detector
from yolov3_tensorflow_tpu_torch.ops import winograd as pw
from yolov3_tensorflow_tpu_torch.tools.import_flax import import_flax

from . import torch_threads  # noqa: F401
from .test_torch_detector import seeded_variables
from .test_torch_winograd import GRAD_TOL, assert_scaled, f32, strict

HEAD_TOL = 3e-2
HW = (64, 64)


def recorder(module, calls, layout):
    """A stand-in for ``module.winograd_call`` that records (prologue,
    epilogue, aux, NCHW input shape) of every call."""
    original = module.winograd_call

    def record(x, u, *args, **kw):
        shape = tuple(x.shape)
        if layout == "hwcn":
            shape = (shape[3], shape[2], shape[0], shape[1])
        calls.append((kw.get("pro", 0), kw.get("epi", 0),
                      bool(kw.get("aux", False)), shape))
        return original(x, u, *args, **kw)
    return record


def test_fused_link_matches_classic():
    """A conv_bn -> relu link that the shape rules admit (128 channels at
    8x8, train mode) runs the fused path: the Winograd conv with its
    statistics, then one apply + relu; it agrees with the classic
    composition within the bf16 bound, running averages included."""
    from yolov3_tensorflow_tpu_torch.models.layers import BasicBackbone
    x = torch.tensor(np.random.RandomState(8).randn(2, 128, 8, 8),
                     dtype=torch.float32)
    outs, averages = [], []
    for backend in ("winograd", "xla"):
        net = BasicBackbone(conv_backend=backend,
                            generator=torch.Generator().manual_seed(9))
        pair = net.conv_bn_pair(128, 128)
        net.train()
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pw, "winograd_call", recorder(pw, calls, "nchw"))
            outs.append(f32(net.conv_bn_relu(x, pair)))
        assert len(calls) == (backend == "winograd")
        averages.append([f32(t) for t in (pair[1].mean, pair[1].var)])
    assert_scaled(outs[0], outs[1], HEAD_TOL, "link")
    for got, want in zip(*averages):
        assert_scaled(got, want, 1e-2, "running average")


# ------------------------------------------------------- eligibility --
ELIGIBLE_CASES = [
    ((128, 52, 52, 128), 128), ((128, 104, 104, 64), 64),
    ((128, 26, 26, 256), 256), ((128, 13, 13, 512), 512),
    ((128, 13, 13, 512), 256), ((128, 26, 26, 256), 512),
    ((128, 52, 52, 128), 256), ((2, 8, 8, 128), 128), ((2, 4, 4, 256), 256),
    ((2, 16, 16, 64), 64), ((2, 8, 8, 128), 256), ((8, 32, 32, 60), 60),
    ((1, 6, 200, 8), 8), ((2, 5, 5, 8), 8), ((2, 1, 8, 8), 8)]


def test_eligible_matches_jax():
    """The port's shape rules decide as JAX's on the CPU: the chain and
    detector-link shapes of the flagship at 416x416, batch 128, and at the
    test size; with another kernel size, stride, padding or grouping."""
    for shape, co in ELIGIBLE_CASES:
        assert pw.eligible(shape, co, (3, 3), (1, 1), "SAME", 1) == \
            jw.eligible(shape, co, (3, 3), (1, 1), "SAME", 1), (shape, co)
    assert pw.eligible((128, 52, 52, 128), 128, (3, 3), (1, 1), "SAME", 1)
    assert not pw.eligible((128, 26, 26, 256), 256, (3, 3), (1, 1), "SAME",
                           1)
    shape = (8, 32, 32, 64)
    for args in (((1, 1), (1, 1), "SAME", 1), ((3, 3), (2, 2), "SAME", 1),
                 ((3, 3), (1, 1), "VALID", 1), ((3, 3), (1, 1), "SAME", 64)):
        assert pw.eligible(shape, 64, *args) == jw.eligible(shape, 64, *args)
    assert pw.pick_wchunk(52, 4096, 4096, 128) is None


def test_small_batches_stay_off_the_device_kernel():
    """JAX refuses a batch below 32 on a backend other than the CPU; the
    port does on a device other than the CPU."""
    assert pw.eligible((8, 52, 52, 128), 128, (3, 3), (1, 1), "SAME", 1)
    assert not pw.eligible((8, 52, 52, 128), 128, (3, 3), (1, 1), "SAME", 1,
                           device_type="cuda")
    assert pw.eligible((32, 52, 52, 128), 128, (3, 3), (1, 1), "SAME", 1,
                       device_type="cuda")


# ------------------------------------------------------ the flagship --
def cfg_pair(**kw):
    kw = dict(input_image_size=HW + (3,), class_num=2, stem_backend="xla",
              conv_backend="winograd", **kw)
    return JaxConfig(**kw), Config(**kw)


@contextlib.contextmanager
def float32_sums():
    """JAX's bf16 sums accumulated in float32 and rounded once, as
    PyTorch's are, while a JAX reference is traced.  XLA on the CPU adds
    a bf16 reduction's terms in bf16: the gradient of a bf16 broadcast
    (a BatchNorm apply's inv and shift) over 512 ones comes out as 256.
    The forward, the kernels and every float32 sum are untouched."""
    bf16_sum = jax_lax.reduce_sum

    def sum_in_float32(operand, axes, *args, **kw):
        if operand.dtype != jnp.bfloat16:
            return bf16_sum(operand, axes, *args, **kw)
        return bf16_sum(operand.astype(jnp.float32), axes, *args,
                        **kw).astype(jnp.bfloat16)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lax, "reduce_sum", sum_in_float32)
        yield


def run_flagship(**cfg_kw):
    """One train forward and backward of the flagship at 64x64, batch 2,
    bf16, from the same weights on both sides, the cotangent on the
    stride-8 feature, the JAX side traced under :func:`float32_sums`; the
    kernel calls each side routed.  ``cfg_kw``: further config fields of
    both sides."""
    jcfg, cfg = cfg_pair(**cfg_kw)
    variables = seeded_variables()
    images = np.random.RandomState(6).rand(2, *HW, 3).astype(np.float32)
    g8 = (np.random.RandomState(5).randn(2, HW[0] // 8, HW[1] // 8, 128)
          * 1e-2).astype(np.float32)
    jax_calls, port_calls = [], []
    jmodel = jax_build_detector(jcfg)

    def loss(params):
        heads, state = jmodel.apply(
            {**variables, "params": params}, jnp.asarray(images), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        s8 = state["intermediates"]["backbone"]["__call__"][0][0]
        return jnp.sum(s8.astype(jnp.float32) * g8), heads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jw, "winograd_call", recorder(jw, jax_calls, "hwcn"))
        mp.setattr(pw, "winograd_call", recorder(pw, port_calls, "nchw"))
        with float32_sums():
            (_, jheads), jgrads = strict(jax.value_and_grad(
                loss, has_aux=True), variables["params"])
        model = build_detector(cfg, "cpu")
        model.load_state_dict(import_flax(variables, model))
        model.train()
        feats = []
        model.backbone.register_forward_hook(
            lambda module, args, out: feats.append(out[0]))
        heads = model(torch.from_numpy(images.transpose(0, 3, 1, 2)))
        feats[0].float().backward(torch.from_numpy(g8.transpose(0, 3, 1, 2)))
    return dict(model=model, heads=heads, jheads=jheads, jgrads=jgrads,
                jax_calls=jax_calls, port_calls=port_calls)


@pytest.fixture(scope="module")
def flagship():
    """:func:`run_flagship` at the default ``winograd_min_channels=128``.

    The backward's cotangent enters at the stride-8 feature, the output of
    module 2 whose second block is the chain.  Measured on the CPU at this
    size: JAX against itself, with excess precision on and off, moves the
    chain's gradients by 46-63% of scale with the cotangent on the heads
    (6-38% at the stride-8 feature).  Against JAX traced with its bf16
    sums in bf16 the port moved them by 15-24% (0.5-2.2%); with those
    sums in float32 (:func:`float32_sums`) by at most 0.05% at the
    stride-8 feature."""
    return run_flagship()


def test_flagship_routes_jax_four_kernel_calls(flagship):
    """Two forward and two gradient kernel calls per train step, in JAX's
    order and modes, all on module 2's second block."""
    calls = flagship["port_calls"]
    assert calls == flagship["jax_calls"]
    assert [c[:3] for c in calls] == [
        (pw.PRO_NONE, pw.EPI_STATS, False),
        (pw.PRO_BN_ACT, pw.EPI_STATS, True),
        (pw.PRO_DYEFF, pw.EPI_BN_ACT, True),
        (pw.PRO_DYEFF, pw.EPI_NONE, True)]
    assert {c[3] for c in calls} == {(2, 128, 8, 8)}


def test_flagship_train_heads_match_jax(flagship):
    for got, want in zip(flagship["heads"], flagship["jheads"]):
        want = np.asarray(want)
        assert np.abs(want).max() > 0.1  # the comparison is not vacuous
        np.testing.assert_allclose(f32(got).transpose(0, 2, 3, 1), want,
                                   atol=HEAD_TOL, rtol=0)


def test_flagship_chain_gradients_match_jax(flagship):
    """The gradients of the chain block's two convs and two BatchNorms."""
    backbone = flagship["model"].backbone
    (conv1, bn1), (conv2, bn2), _ = backbone.stages[1][1]
    names = {id(m): n for n, m in backbone.named_children()}
    jgrads = flagship["jgrads"]["backbone"]
    checked = 0
    for conv in (conv1, conv2):
        want = np.asarray(jgrads[names[id(conv)]]["kernel"])
        assert_scaled(f32(conv.weight.grad), want.transpose(3, 2, 0, 1),
                      GRAD_TOL, names[id(conv)])
        checked += 1
    for bn in (bn1, bn2):
        for leaf in ("scale", "bias"):
            want = np.asarray(jgrads[names[id(bn)]][leaf])
            assert_scaled(f32(getattr(bn, leaf).grad), want, GRAD_TOL,
                          f"{names[id(bn)]}.{leaf}")
            checked += 1
    assert checked == 6


def test_v2_routes_no_kernel_call():
    """ResNet-18-v2 at conv_backend="winograd" routes nothing to the
    kernel, as JAX does: the JAX side traced abstractly, the port run."""
    jcfg, cfg = cfg_pair(model_backbone="resnet-18-v2")
    variables = seeded_variables(model_backbone="resnet-18-v2")
    jmodel = jax_build_detector(jcfg)
    jax_calls, port_calls = [], []
    x = np.random.RandomState(7).rand(2, *HW, 3).astype(np.float32)

    def loss(params):
        heads, _ = jmodel.apply({**variables, "params": params},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return sum(jnp.sum(h) for h in heads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jw, "winograd_call", recorder(jw, jax_calls, "hwcn"))
        mp.setattr(pw, "winograd_call", recorder(pw, port_calls, "nchw"))
        jax.eval_shape(jax.grad(loss), variables["params"])
        model = build_detector(cfg, "cpu").train()
        sum(h.sum() for h in model(torch.from_numpy(
            x.transpose(0, 3, 1, 2)))).backward()
    assert jax_calls == port_calls == []
