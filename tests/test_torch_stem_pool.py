"""The port's fused eval stem (yolov3_tensorflow_tpu_torch/ops/stem_pool.py)
against the JAX package's bn_pool_relu_eval (Pallas, interpret mode on the
CPU) and, for odd sizes the Pallas kernel rejects, against the JAX classic
composition.  Tolerance: none -- the plain PyTorch version must be
bitwise equal.  The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.ops.stem_pool import (
    bn_pool_relu_eval as jax_bn_pool_relu_eval)
from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
    bn_pool_relu_eval, bn_pool_relu_eval_reference, same_pool_geometry)

from . import torch_threads  # noqa: F401


def jax_classic(y, inv, shift):
    """relu(max_pool3x3s2_SAME(bf16(bf16(y*inv) + shift))) on [H,W,C,N]
    (tests/test_stem_pool.py classic composition)."""
    bn = (y.astype(jnp.bfloat16) * inv.astype(jnp.bfloat16)[None, None, :,
                                                            None]
          + shift.astype(jnp.bfloat16)[None, None, :, None])
    pooled = jax.lax.reduce_window(
        bn.astype(jnp.float32), -jnp.inf, jax.lax.max, (3, 3, 1, 1),
        (2, 2, 1, 1), "SAME")
    return jnp.maximum(pooled, 0.0).astype(jnp.bfloat16)


def make_case(shape_hwcn, kind, seed):
    """bf16-exact y [H,W,C,N] as float32 numpy, f32 inv/shift (C,)."""
    H, W, C, N = shape_hwcn
    rng = np.random.RandomState(seed)
    if kind == "ties":  # quantized ramp: many equal taps per window
        y = ((np.arange(H * W * C * N) % 5) - 2).reshape(
            H, W, C, N).astype(np.float32) * 0.5
    else:
        y = rng.randn(H, W, C, N).astype(np.float32)
    inv = (rng.rand(C) + 0.5).astype(np.float32)
    shift = (rng.randn(C) * 0.3).astype(np.float32)
    if kind == "negative":
        y = -np.abs(y) - 0.01
        shift = -np.abs(shift)
    if kind == "mixed_sign_inv":
        inv = (rng.randn(C) * 0.7).astype(np.float32)
        inv[C // 2] = 0.0  # the zero-gamma channel
    y = np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    return y, inv, shift


def to_port(y_hwcn):
    return torch.from_numpy(np.ascontiguousarray(
        y_hwcn.transpose(3, 2, 0, 1))).to(torch.bfloat16)


def port_stem(y, inv, shift):
    out = bn_pool_relu_eval(to_port(y), torch.from_numpy(inv),
                            torch.from_numpy(shift))
    assert out.dtype == torch.bfloat16
    return out.float().numpy().transpose(2, 3, 1, 0)  # NCHW -> HWCN


@pytest.mark.parametrize("kind", ["randn", "negative", "ties",
                                  "mixed_sign_inv"])
def test_plain_stem_bit_equals_jax_kernel(kind):
    y, inv, shift = make_case((16, 8, 8, 4), kind, seed=3)
    want = np.asarray(jax_bn_pool_relu_eval(
        jnp.asarray(y, jnp.bfloat16), jnp.asarray(inv),
        jnp.asarray(shift)).astype(jnp.float32))
    got = port_stem(y, inv, shift)
    assert got.shape == want.shape == (8, 4, 8, 4)
    np.testing.assert_array_equal(got, want)
    if kind == "negative":
        assert not got.any()


@pytest.mark.parametrize("hw", [(13, 11), (7, 16), (16, 9)])
def test_plain_stem_odd_sizes_bit_equal_jax_classic(hw):
    y, inv, shift = make_case((hw[0], hw[1], 4, 2), "randn", seed=5)
    want = np.asarray(jax_classic(jnp.asarray(y), jnp.asarray(inv),
                                  jnp.asarray(shift)).astype(jnp.float32))
    got = port_stem(y, inv, shift)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_pool_geometry():
    # TF SAME k=3 s=2: even sizes pad one after, odd sizes one each side
    assert same_pool_geometry(208) == (104, 0, 1)
    assert same_pool_geometry(13) == (7, 1, 1)
    assert same_pool_geometry(1) == (1, 1, 1)


def test_reference_keeps_compute_dtype():
    """The plain version computes in y's dtype: float32 for the classic
    ("xla") stem at fp32 compute, bf16 for the kernel's semantics."""
    y, inv, shift = make_case((8, 8, 4, 2), "randn", seed=1)
    y32 = torch.from_numpy(np.ascontiguousarray(y.transpose(3, 2, 0, 1)))
    out = bn_pool_relu_eval_reference(y32, torch.from_numpy(inv),
                                      torch.from_numpy(shift))
    assert out.dtype == torch.float32
    t = torch.relu(y32 * torch.from_numpy(inv)[None, :, None, None]
                   + torch.from_numpy(shift)[None, :, None, None])
    np.testing.assert_array_equal(
        out.numpy(), torch.nn.functional.max_pool2d(
            torch.nn.functional.pad(t, (0, 1, 0, 1)), 3, 2).numpy())


def test_wrapper_rejects_other_devices():
    y = torch.zeros(1, 2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bn_pool_relu_eval(y, torch.ones(2, device="meta"),
                          torch.zeros(2, device="meta"))
