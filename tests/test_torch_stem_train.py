"""The port's train stem op ``bn_pool_relu`` (forward with argmax codes,
code-routed backward) against the JAX package's ``bn_pool_relu`` (Pallas,
interpret mode on the CPU) and, for the odd sizes the Pallas kernel
rejects, against a loop-by-loop NumPy oracle of the same semantics.

Tolerances: the pooled output, the codes and dy must be bitwise equal;
dinv and dshift (sums over the batch, taken in another order than the
JAX kernel's) within rtol 1e-5 of the JAX values, with an absolute floor
of 1e-6 times the sum of the absolute terms for cancelling sums.  The
plain version runs here; tests/test_torch_cuda_kernels.py holds the CUDA
kernels against it on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.ops.stem_pool import _fwd as jax_fwd
from yolov3_tensorflow_tpu.ops.stem_pool import bn_pool_relu as jax_op
from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
    bn_pool_relu, bn_pool_relu_bwd, bn_pool_relu_eval, bn_pool_relu_fwd,
    same_pool_geometry)

from . import torch_threads  # noqa: F401

SHAPE = (16, 8, 8, 4)  # [H, W, C, N]: the Pallas kernel needs H % 8 == 0


def make_case(shape_hwcn, kind, seed):
    """bf16-exact y [H,W,C,N] and f32 inv/shift (C,) as numpy."""
    H, W, C, N = shape_hwcn
    rng = np.random.RandomState(seed)
    if kind == "ties":  # quantized ramp: many equal taps per window
        y = ((np.arange(H * W * C * N) % 5) - 2).reshape(
            H, W, C, N).astype(np.float32) * 0.5
    elif kind == "ones":  # every tap of every window equal
        y = np.ones((H, W, C, N), np.float32)
    else:
        y = rng.randn(H, W, C, N).astype(np.float32)
    inv = (rng.rand(C) + 0.5).astype(np.float32)
    shift = (rng.randn(C) * 0.3).astype(np.float32)
    if kind == "ones":
        inv, shift = np.ones(C, np.float32), np.zeros(C, np.float32)
    if kind == "negative":
        y = -np.abs(y) - 0.01
        shift = -np.abs(shift)
    if kind == "inv0":
        inv[C // 2] = 0.0  # the zero-gamma channel
    y = np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    return y, inv, shift


def nchw(a_hwcn):
    return np.ascontiguousarray(a_hwcn.transpose(3, 2, 0, 1))


def hwcn(a_nchw):
    return a_nchw.transpose(2, 3, 1, 0)


def port_grads(y, inv, shift, g):
    """(p, dy, dinv, dshift) of the port's autograd op, in [H,W,C,N]."""
    yt = torch.tensor(nchw(y), dtype=torch.bfloat16, requires_grad=True)
    it = torch.tensor(inv, requires_grad=True)
    st = torch.tensor(shift, requires_grad=True)
    p = bn_pool_relu(yt, it, st)
    p.backward(torch.tensor(nchw(g)).to(torch.bfloat16))
    return (hwcn(p.detach().float().numpy()),
            hwcn(yt.grad.float().numpy()), it.grad.numpy(),
            st.grad.numpy())


def jax_grads(y, inv, shift, g):
    p, vjp = jax.vjp(jax_op, jnp.asarray(y, jnp.bfloat16),
                     jnp.asarray(inv), jnp.asarray(shift))
    dy, dinv, dshift = vjp(jnp.asarray(g, jnp.bfloat16))
    return (np.asarray(p.astype(jnp.float32)),
            np.asarray(dy.astype(jnp.float32)), np.asarray(dinv),
            np.asarray(dshift))


def assert_sums_close(got, want, terms_abs):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(terms_abs))


@pytest.mark.parametrize("kind", ["randn", "ties", "negative", "inv0"])
def test_forward_and_codes_equal_jax_kernel(kind):
    y, inv, shift = make_case(SHAPE, kind, seed=3)
    p_j, idx_j = jax_fwd(jnp.asarray(y, jnp.bfloat16), jnp.asarray(inv),
                         jnp.asarray(shift))
    p, codes = bn_pool_relu_fwd(torch.tensor(nchw(y)), torch.tensor(inv),
                                torch.tensor(shift))
    assert p.dtype == torch.bfloat16 and codes.dtype == torch.uint8
    np.testing.assert_array_equal(hwcn(p.float().numpy()),
                                  np.asarray(p_j.astype(jnp.float32)))
    np.testing.assert_array_equal(hwcn(codes.numpy()).astype(np.float32),
                                  np.asarray(idx_j.astype(jnp.float32)))
    if kind == "negative":
        assert (codes == 9).all()


@pytest.mark.parametrize("kind", ["randn", "ties", "negative", "inv0",
                                  "ones"])
def test_backward_equals_jax_kernel(kind):
    y, inv, shift = make_case(SHAPE, kind, seed=4)
    H, W, C, N = SHAPE
    g = np.random.RandomState(5).randn(H // 2, W // 2, C, N).astype(
        np.float32)
    g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    p, dy, dinv, dshift = port_grads(y, inv, shift, g)
    p_j, dy_j, dinv_j, dshift_j = jax_grads(y, inv, shift, g)
    np.testing.assert_array_equal(p, p_j)
    np.testing.assert_array_equal(dy, dy_j)
    scale = np.abs(g).sum() * (1.0 + np.abs(p_j).max())
    assert_sums_close(dshift, dshift_j, scale)
    assert_sums_close(dinv, dinv_j, scale / max(inv.min(), 1e-3))
    for t in (dy, dinv, dshift):
        assert np.isfinite(t).all()
    if kind == "inv0":
        assert dinv[C // 2] == 0.0
    if kind == "negative":
        assert not dy.any() and not dshift.any()
    if kind == "ones":
        # every window's first tap takes its whole gradient: the routed
        # mass equals the pooled mass, and dshift the per-channel sum of g
        np.testing.assert_allclose(dy.sum(), g.astype(np.float32).sum(),
                                   rtol=1e-3)
        np.testing.assert_allclose(dshift, g.sum(axis=(0, 1, 3)),
                                   rtol=1e-5, atol=1e-4)


def test_eval_op_bit_equals_train_primal():
    for kind in ("randn", "ties", "negative", "inv0"):
        y, inv, shift = make_case((13, 11, 4, 2), kind, seed=6)
        args = (torch.tensor(nchw(y)), torch.tensor(inv),
                torch.tensor(shift))
        p_eval = bn_pool_relu_eval(*args)
        p_train, _ = bn_pool_relu_fwd(*args)
        assert torch.equal(p_eval.view(torch.int16),
                           p_train.view(torch.int16))


def numpy_oracle(y, inv, shift, dp):
    """Loop-by-loop codes and dy on NCHW float32 numpy: bf16 BN apply,
    TF SAME windows, taps outside the image skipped, first strict maximum
    wins, code 9 where the maximum is not > 0; dy sums the routed dp in
    the TPU kernel's order, then one multiply by inv."""
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(  # noqa
        jnp.bfloat16).astype(jnp.float32))
    n, c, h, w = y.shape
    ho, top, _ = same_pool_geometry(h)
    wo, left, _ = same_pool_geometry(w)
    t = bf(bf(y * bf(inv)[None, :, None, None])
           + bf(shift)[None, :, None, None])
    codes = np.full((n, c, ho, wo), 9, np.uint8)
    for i0, j0, k0, l0 in np.ndindex(n, c, ho, wo):
        best, code = -np.inf, 0
        for a in range(3):
            for b in range(3):
                r, s = 2 * k0 - top + a, 2 * l0 - left + b
                if 0 <= r < h and 0 <= s < w and t[i0, j0, r, s] > best:
                    best, code = t[i0, j0, r, s], 3 * a + b
        if best > 0:
            codes[i0, j0, k0, l0] = code
    dy = np.zeros_like(y)
    for i0, j0, r, s in np.ndindex(n, c, h, w):
        rp, sp = r + top, s + left
        rows = [(rp // 2 - 1, 2), (rp // 2, 0)] if rp % 2 == 0 \
            else [((rp - 1) // 2, 1)]
        cols = [(sp // 2, 0), (sp // 2 - 1, 2)] if sp % 2 == 0 \
            else [((sp - 1) // 2, 1)]
        acc = np.float32(0.0)
        for wr, a in rows:
            for wc, b in cols:
                if 0 <= wr < ho and 0 <= wc < wo \
                        and codes[i0, j0, wr, wc] == 3 * a + b:
                    acc = np.float32(acc + dp[i0, j0, wr, wc])
        dy[i0, j0, r, s] = acc * inv[j0]
    return codes, bf(dy)


@pytest.mark.parametrize("hw", [(13, 11), (7, 16), (16, 9), (1, 3)])
@pytest.mark.parametrize("kind", ["randn", "ties", "negative"])
def test_odd_sizes_against_numpy_oracle(hw, kind):
    y, inv, shift = make_case((hw[0], hw[1], 3, 2), kind, seed=7)
    y = nchw(y)
    ho, wo = same_pool_geometry(hw[0])[0], same_pool_geometry(hw[1])[0]
    dp = np.random.RandomState(8).randn(2, 3, ho, wo).astype(np.float32)
    dp = np.asarray(jnp.asarray(dp, jnp.bfloat16).astype(jnp.float32))
    want_codes, want_dy = numpy_oracle(y, inv, shift, dp)
    p, codes = bn_pool_relu_fwd(torch.tensor(y), torch.tensor(inv),
                                torch.tensor(shift))
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    dy, sums = bn_pool_relu_bwd(codes, torch.tensor(dp), p,
                                torch.tensor(inv), torch.tensor(shift), hw)
    np.testing.assert_array_equal(dy.float().numpy(), want_dy)
    active = want_codes <= 8
    pf = p.float().numpy()
    np.testing.assert_allclose(
        sums.numpy(),
        [np.where(active, dp, 0).sum(axis=(0, 2, 3)),
         np.where(active, dp * (pf - shift[None, :, None, None]),
                  0).sum(axis=(0, 2, 3))], rtol=1e-5, atol=1e-5)


def test_train_stem_gradients_flow_through_the_model_stem():
    """The detector's train stem (conv -> f32 sums -> BN stats scalars ->
    bn_pool_relu) gives finite, non-zero gradients to the stem conv and
    BN and moves the stem's running averages."""
    from yolov3_tensorflow_tpu_torch.models.resnet18 import ResNet18
    torch.manual_seed(0)
    model = ResNet18(dtype=torch.float32, stem_backend="fused",
                     generator=torch.Generator().manual_seed(1)).train()
    x = torch.rand(2, 3, 32, 32)
    bn = model.stem[1]
    before = bn.mean.clone()
    s8, s16, s32 = model(x)
    (s8.float().square().mean() + s32.float().square().mean()).backward()
    conv = model.stem[0]
    for t in (conv.weight.grad, bn.scale.grad, bn.bias.grad):
        assert torch.isfinite(t).all() and t.abs().max() > 0
    assert not torch.equal(before, bn.mean)
