"""The port's layer vocabulary (yolov3_tensorflow_tpu_torch/models/
layers.py) against flax at float32: TF SAME convs (stride 2 pads after),
eval-mode FusedBatchNorm, the 2x nearest upsample.  Tolerance 1e-5
absolute (float32 sums in another order).  Train-mode BatchNorm is held
against JAX in tests/test_torch_train_layers.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from yolov3_tensorflow_tpu.models.layers import FusedBatchNorm as JaxBN
from yolov3_tensorflow_tpu.models.layers import \
    upsample2x_nearest as jax_upsample
from yolov3_tensorflow_tpu_torch.models.layers import (Conv2dSame,
                                                       FusedBatchNorm,
                                                       same_padding,
                                                       upsample2x_nearest)

from . import torch_threads  # noqa: F401

ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw,k,stride,padding", [
    ((12, 10), 3, 2, "SAME"), ((13, 11), 3, 2, "SAME"),
    ((9, 8), 3, 1, "SAME"), ((12, 10), 1, 2, "VALID"),
    ((13, 11), 1, 2, "VALID"), ((8, 8), 1, 1, "SAME")])
def test_conv_matches_flax(hw, k, stride, padding):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, 5).astype(np.float32)
    conv = nn.Conv(features=6, kernel_size=(k, k), strides=(stride, stride),
                   padding=padding, use_bias=False, dtype=jnp.float32)
    kernel = rng.randn(k, k, 5, 6).astype(np.float32) * 0.3
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
    port = Conv2dSame(5, 6, k, stride, padding, dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_same_padding_puts_the_odd_pixel_after():
    assert same_padding(208, 3, 2) == (0, 1)
    assert same_padding(13, 3, 2) == (1, 1)
    assert same_padding(13, 3, 1) == (1, 1)
    assert same_padding(13, 1, 2) == (0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_batchnorm_matches_flax(dtype):
    rng = np.random.RandomState(1)
    c = 7
    x = rng.randn(2, 5, 4, c).astype(np.float32) * 2
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (rng.randn(c) * 0.3).astype(np.float32)}
    stats = {"mean": (rng.randn(c) * 0.5).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, c).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = np.asarray(JaxBN(use_running_average=True, dtype=jdt).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
        .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    bn = FusedBatchNorm(c, dtype=tdt).eval()
    with torch.no_grad():
        for name, v in {**params, **stats}.items():
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = bn(nchw(x)).float().numpy().transpose(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        # two bf16 roundings in both; rsqrt may differ by an ulp in
        # float32, which can move one bf16 rounding: one bf16 ulp
        np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -7)


def test_batchnorm_refuses_train_mode():
    """Train mode was refused until the training slice; it now normalizes
    with the batch statistics (zero mean, unit biased variance up to eps)
    and moves the running averages by momentum 0.9."""
    x = torch.arange(24.0).reshape(2, 3, 2, 2)
    bn = FusedBatchNorm(3, dtype=torch.float32).train()
    y = bn(x)
    np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).detach().numpy(), 0.0,
                               atol=1e-5)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(
        y.square().mean(dim=(0, 2, 3)).detach().numpy(),
        (var / (var + 1e-5)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), (0.9 + 0.1 * var).numpy(),
                               rtol=1e-6)


def test_upsample_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    got = upsample2x_nearest(nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
