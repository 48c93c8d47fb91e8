"""The port's pool-only stem op ``max_pool_s2`` (ResNet-18-v2: eval
forward, forward with argmax codes, code-routed backward) against the JAX
package's ``max_pool_s2_eval``, ``max_pool_s2`` and its vjp (Pallas,
interpret mode on the CPU), and, for the odd sizes the Pallas kernel
rejects, against the plain ``max_pool_same`` composition and its autograd.

Tolerance: none.  The pooled output, the codes and dy must be bitwise
equal.  Inputs stay above the TPU kernel's -3.0e38 padding sentinel (the
port pads with -inf).  The JAX functions run under ``jax.jit``, so each
shape and dtype traces the interpreted kernels once.  The plain versions
run here; tests/test_torch_cuda_kernels.py holds the CUDA kernels
against them on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.ops.stem_pool import _pool_fwd as jax_pool_fwd
from yolov3_tensorflow_tpu.ops.stem_pool import max_pool_s2 as jax_op
from yolov3_tensorflow_tpu.ops.stem_pool import \
    max_pool_s2_eval as jax_eval
from yolov3_tensorflow_tpu_torch.models.layers import max_pool_same
from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
    max_pool_s2, max_pool_s2_bwd, max_pool_s2_eval, max_pool_s2_fwd,
    same_pool_geometry)

from . import torch_threads  # noqa: F401

SHAPES = [(4, 8, 16, 8), (2, 64, 32, 32)]  # (N, C, H, W)
SHAPE_IDS = ["4x8x16x8", "2x64x32x32"]
KINDS = ["randn", "negative", "constant", "quantized", "float32"]


def make_y(shape, kind, seed):
    """NCHW numpy input: bf16-exact float32, or, for "float32", values
    the ops round to bf16 themselves."""
    rng = np.random.RandomState(seed)
    y = rng.randn(*shape).astype(np.float32)
    if kind == "negative":
        y = -np.abs(y) - 0.01
    elif kind == "constant":  # every tap of every window equal
        y = np.full(shape, -0.75, np.float32)
    elif kind == "quantized":  # many equal taps per window
        y = np.round(y * 2) / 2
    if kind != "float32":
        y = np.array(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    return y


def make_dp(shape, seed):
    n, c, h, w = shape
    g = np.random.RandomState(seed).randn(
        n, c, same_pool_geometry(h)[0], same_pool_geometry(w)[0])
    return np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))


@jax.jit
def jax_fwd(y):
    """(p, codes) of the Pallas forward and p of the eval op, on
    [H,W,C,N]."""
    p, idx = jax_pool_fwd(y.astype(jnp.bfloat16))
    return p, idx, jax_eval(y)


@jax.jit
def jax_vjp(y, g):
    """(p, dy) of the JAX op's custom vjp, on [H,W,C,N]."""
    p, vjp = jax.vjp(jax_op, y)
    return p, vjp(g.astype(jnp.bfloat16))[0]


def hwcn(a):
    return np.ascontiguousarray(np.asarray(a).transpose(2, 3, 1, 0))


def nchw(a):
    return np.asarray(a).transpose(3, 2, 0, 1)


def as_f32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_forward_and_codes_equal_jax_kernel(shape, kind):
    y = make_y(shape, kind, seed=1)
    p_j, idx_j, p_eval_j = jax_fwd(jnp.asarray(hwcn(y)))
    p, codes = max_pool_s2_fwd(torch.tensor(y))
    p_eval = max_pool_s2_eval(torch.tensor(y))
    assert p.dtype == p_eval.dtype == torch.bfloat16
    assert codes.dtype == torch.uint8 and int(codes.max()) <= 8
    want = nchw(p_j.astype(jnp.float32))
    np.testing.assert_array_equal(as_f32(p), want)
    np.testing.assert_array_equal(as_f32(p_eval), want)
    np.testing.assert_array_equal(
        nchw(p_eval_j.astype(jnp.float32)), want)
    np.testing.assert_array_equal(codes.numpy(),
                                  nchw(idx_j.astype(jnp.float32)))
    if kind == "constant":
        assert not codes.any()  # the first tap wins every tie


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_backward_equals_jax_kernel(shape, kind):
    y = make_y(shape, kind, seed=2)
    g = make_dp(shape, seed=3)
    yt = torch.tensor(y, requires_grad=True)
    p = max_pool_s2(yt)
    p.backward(torch.from_numpy(g).to(torch.bfloat16))
    p_j, dy_j = jax_vjp(jnp.asarray(hwcn(y)), jnp.asarray(hwcn(g)))
    assert yt.grad.dtype == torch.float32 and dy_j.dtype == jnp.float32
    np.testing.assert_array_equal(as_f32(p), nchw(p_j.astype(jnp.float32)))
    np.testing.assert_array_equal(yt.grad.numpy(), nchw(dy_j))
    # every window hands its whole dp to exactly one tap; each dy element
    # is one bf16 rounding (relative error <= 2^-8) of its routed sum
    dy = yt.grad.numpy()
    assert abs(dy.sum() - g.sum()) <= 2.0 ** -8 * np.abs(dy).sum()


def test_nan_rule_equals_jax_kernel():
    """A NaN tap makes its window's max NaN and freezes its code at the
    tap before it, in the kernel and in JAX's jnp.maximum chain; dp
    follows the codes."""
    shape = (2, 4, 16, 16)
    y = make_y(shape, "randn", seed=4)
    y[0, 0, 0, 0] = np.nan  # tap (0, 0) of window (0, 0)
    y[0, 1, 4, 5] = np.nan  # tap (2, 1) of window (1, 2), (0, 1) of (2, 2)
    y[1, 2, 7, 6] = np.nan  # tap (1, 2) of window (3, 2), (1, 0) of (3, 3)
    y[1, 3, 9, 9] = np.nan  # tap (1, 1) of window (4, 4)
    y[1, 3, 10, 10] = np.nan  # tap (2, 2) of (4, 4), and of (4, 5),
    # (5, 4), (5, 5)
    p, codes = max_pool_s2_fwd(torch.from_numpy(y))
    p_j, idx_j, _ = jax_fwd(jnp.asarray(hwcn(y), jnp.bfloat16))
    np.testing.assert_array_equal(as_f32(p), nchw(p_j.astype(jnp.float32)))
    np.testing.assert_array_equal(codes.numpy(),
                                  nchw(idx_j.astype(jnp.float32)))
    nan_windows = {(0, 0, 0, 0), (0, 1, 1, 2), (0, 1, 2, 2), (1, 2, 3, 2),
                   (1, 2, 3, 3), (1, 3, 4, 4), (1, 3, 4, 5), (1, 3, 5, 4),
                   (1, 3, 5, 5)}
    assert set(zip(*np.nonzero(np.isnan(as_f32(p))))) == nan_windows
    assert codes[0, 0, 0, 0] == 0 and codes[1, 3, 4, 4] < 4
    g = make_dp(shape, seed=5)
    dy = max_pool_s2_bwd(codes, torch.from_numpy(g), shape[2:])
    _, dy_j = jax_vjp(jnp.asarray(hwcn(y), jnp.bfloat16),
                      jnp.asarray(hwcn(g)))
    np.testing.assert_array_equal(as_f32(dy),
                                  nchw(dy_j.astype(jnp.float32)))


def distinct_planes(n, c, h, w, seed):
    """Each (n, c) plane a permutation of distinct integers (exact in
    bf16 for h * w <= 256): no ties anywhere."""
    rng = np.random.RandomState(seed)
    planes = [rng.permutation(h * w) - h * w // 2 for _ in range(n * c)]
    return np.stack(planes).reshape(n, c, h, w).astype(np.float32)


@pytest.mark.parametrize("hw", [(13, 11), (7, 16), (18, 10), (1, 3)])
def test_odd_sizes_equal_plain_composition(hw):
    """Sizes the Pallas kernel rejects (odd, or H not a multiple of 8):
    p equals max_pool_same of the bf16 input, and dy the bf16-rounded
    float32 autograd of max_pool_same (dp on a 1/64 grid, so the float32
    sums are exact in any order)."""
    shape = (2, 3) + hw
    y = distinct_planes(*shape, seed=6)
    n, c, h, w = shape
    dp = np.round(np.random.RandomState(7).randn(
        n, c, same_pool_geometry(h)[0], same_pool_geometry(w)[0]) * 64) / 64
    dp = torch.tensor(dp, dtype=torch.float32)
    yt = torch.tensor(y, requires_grad=True)
    p = max_pool_s2(yt)
    p.backward(dp)
    assert torch.equal(p, max_pool_same(torch.from_numpy(y).bfloat16()))
    assert torch.equal(p, max_pool_s2_eval(torch.from_numpy(y)))
    y32 = torch.tensor(y, requires_grad=True)
    max_pool_same(y32).backward(dp)
    assert torch.equal(yt.grad, y32.grad.bfloat16().float())
