"""Train mode of the port's model against the JAX package on the CPU:
the train-mode FusedBatchNorm (output and running averages, classic and
stats mode), the explicit L2 terms, and the detector's train forward
(heads and every BatchNorm's running averages) with the classic stem and
with the fused stem (the JAX Pallas kernel in interpret mode).

Tolerances: BatchNorm at float32 within 1e-5 absolute, at bf16 within one
bf16 ulp (rtol 2^-7); running averages within 1e-6; L2 terms within
rtol 1e-6; the detector's float32 train heads within 2e-3 absolute (the
18-layer bound of tests/test_parity_e2e.py) and its running averages
within atol 1e-5 + rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.models.detector import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu.models.layers import FusedBatchNorm as JaxBN
from yolov3_tensorflow_tpu.models.layers import \
    l2_regularization as jax_l2
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.models.detector import build_detector
from yolov3_tensorflow_tpu_torch.models.layers import (FusedBatchNorm,
                                                       l2_regularization)
from yolov3_tensorflow_tpu_torch.tools.import_flax import import_flax

from . import torch_threads  # noqa: F401

HW = (64, 64)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def bn_case(c=7, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 5, c) * 2 + rng.randn(c)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (rng.randn(c) * 0.3).astype(np.float32)}
    stats = {"mean": (rng.randn(c) * 0.5).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, c).astype(np.float32)}
    return x, params, stats


def port_bn(c, dtype, params, stats):
    bn = FusedBatchNorm(c, dtype=dtype).train()
    with torch.no_grad():
        for name, v in {**params, **stats}.items():
            getattr(bn, name).copy_(torch.from_numpy(v))
    return bn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_jax(dtype):
    x, params, stats = bn_case()
    jdt = jnp.dtype(dtype)
    want, upd = JaxBN(use_running_average=False, dtype=jdt).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        mutable=["batch_stats"])
    want = np.asarray(want.astype(jnp.float32))
    bn = port_bn(x.shape[-1], getattr(torch, dtype), params, stats)
    got = bn(nchw(x)).float().detach().numpy().transpose(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]),
                                   atol=1e-6, rtol=0)


def test_stats_mode_matches_jax_and_is_differentiable():
    """Stats mode (the fused stem's BatchNorm): (inv, shift) from the
    float32 sum and sum of squares, as JAX FusedBatchNorm(stats=...)."""
    x, params, stats = bn_case(c=5, seed=2)
    s, q = x.sum((0, 1, 2)), np.square(x).sum((0, 1, 2))
    count = float(np.prod(x.shape[:3]))
    (inv_j, shift_j), upd = JaxBN(use_running_average=False).apply(
        {"params": params, "batch_stats": stats},
        stats=(jnp.asarray(s), jnp.asarray(q), count),
        mutable=["batch_stats"])
    bn = port_bn(5, torch.bfloat16, params, stats)
    st = torch.tensor(s, requires_grad=True)
    inv, shift = bn.stats_scalars(st, torch.tensor(q), count)
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(inv_j),
                               rtol=1e-6)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(shift_j),
                               rtol=1e-6, atol=1e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]),
                                   atol=1e-6)
    shift.sum().backward()
    assert st.grad is not None and bn.scale.grad is not None


def seeded_variables(seed=0):
    jcfg = JaxConfig(input_image_size=HW + (3,), class_num=2)
    model = jax_build_detector(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = [getattr(k, "key", "") for k in path]
        if name[-1] == "kernel":
            std = 0.01 if "head_out" in name[-2] else \
                np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * std).astype(np.float32)
        if name[-1] in ("scale", "var"):
            return rng.uniform(0.6, 1.2, leaf.shape).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return seeded_variables()


def test_l2_regularization_matches_jax(variables):
    cfg = Config(input_image_size=HW + (3,), class_num=2)
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(import_flax(variables, model))
    kreg, greg = l2_regularization(model)
    jk, jg = jax_l2(variables["params"])
    np.testing.assert_allclose(float(kreg.detach()), float(jk), rtol=1e-6)
    np.testing.assert_allclose(float(greg.detach()), float(jg), rtol=1e-6)
    # the head output convs carry no regularizer
    heads = sum(float(m.weight.square().sum()) for n, m in
                model.named_modules() if n.startswith("head_out"))
    assert heads > 0
    kreg.backward()
    assert model.head_out_8.weight.grad is None
    assert model.backbone.Conv_0.weight.grad.abs().max() > 0


@pytest.mark.parametrize("stem", ["xla", "fused"])
def test_detector_train_forward_matches_jax(variables, stem):
    kw = dict(input_image_size=HW + (3,), class_num=2,
              compute_dtype="float32", stem_backend=stem)
    jmodel = jax_build_detector(JaxConfig(**kw))
    x = np.random.RandomState(3).rand(4, *HW, 3).astype(np.float32)
    heads, upd = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x))
    cfg = Config(**kw)
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(import_flax(variables, model))
    got = model.train()(nchw(x))
    for g, w in zip(got, heads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.05  # the comparison is not vacuous
        np.testing.assert_allclose(
            g.detach().numpy().transpose(0, 2, 3, 1), w, atol=2e-3, rtol=0)
    want = import_flax({"params": variables["params"],
                        "batch_stats": jax.device_get(upd["batch_stats"])},
                       model)
    for key, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=key)
