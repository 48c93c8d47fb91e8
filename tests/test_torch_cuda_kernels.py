"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU (marker ``gpu``) and skip without
one.  The card's machine has no JAX, so this file imports none and runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest -q

Tolerance: none.  Every kernel output (pooled values, codes, dy, the two
per-channel sums, the noised batch) must be bitwise equal to its plain
version's on the same inputs, NaN included.
"""
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu_torch.ops.augment_noise import (
    noisy_normalize, noisy_normalize_reference)
from yolov3_tensorflow_tpu_torch.ops.stem_pool import (
    bn_pool_relu, bn_pool_relu_bwd, bn_pool_relu_bwd_reference,
    bn_pool_relu_eval, bn_pool_relu_eval_reference, bn_pool_relu_fwd,
    bn_pool_relu_reference, max_pool_s2, max_pool_s2_bwd,
    max_pool_s2_bwd_reference, max_pool_s2_eval, max_pool_s2_fwd,
    max_pool_s2_reference)

STEM_CASES = [((4, 8, 16, 8), "randn"), ((2, 4, 13, 11), "ties"),
              ((2, 8, 16, 16), "inv0"), ((2, 4, 8, 8), "negative"),
              ((2, 64, 208, 208), "randn")]
POOL_CASES = [((4, 8, 16, 8), "randn"), ((2, 4, 13, 11), "ties"),
              ((2, 4, 18, 10), "constant"), ((2, 4, 8, 8), "negative"),
              ((2, 4, 16, 16), "nan"), ((2, 64, 208, 208), "randn")]


def need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def stem_case(n, c, h, w, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "ties":
        y = ((np.arange(n * c * h * w) % 5) - 2).reshape(n, c, h, w) * 0.5
    else:
        y = rng.randn(n, c, h, w)
    inv = rng.rand(c) + 0.5
    shift = rng.randn(c) * 0.3
    if kind == "negative":
        y, shift = -np.abs(y) - 0.01, -np.abs(shift)
    if kind == "inv0":
        inv[c // 2] = 0.0
    return (torch.tensor(y, dtype=torch.bfloat16, device="cuda"),
            torch.tensor(inv, dtype=torch.float32, device="cuda"),
            torch.tensor(shift, dtype=torch.float32, device="cuda"))


def pool_case(n, c, h, w, kind, seed):
    """bf16 y (N, C, H, W) on the card for one pool-only case."""
    rng = np.random.RandomState(seed)
    y = rng.randn(n, c, h, w)
    if kind == "ties":
        y = ((np.arange(n * c * h * w) % 5) - 2).reshape(n, c, h, w) * 0.5
    elif kind == "constant":
        y = np.full((n, c, h, w), -0.75)
    elif kind == "negative":
        y = -np.abs(y) - 0.01
    elif kind == "nan":
        y[0, 0, 0, 0] = y[0, 1, 4, 5] = y[1, 2, 7, 6] = np.nan
        y[1, 3, 9, 9] = y[1, 3, 10, 10] = np.nan
    return torch.tensor(y, dtype=torch.bfloat16, device="cuda")


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", STEM_CASES)
def test_stem_kernel_bit_equals_plain_version(shape, kind):
    need_gpu()
    y, inv, shift = stem_case(*shape, kind, seed=2)
    before = bn_pool_relu_eval.launches
    got = bn_pool_relu_eval(y, inv, shift)
    want = bn_pool_relu_eval_reference(y, inv, shift)
    torch.cuda.synchronize()
    assert bn_pool_relu_eval.launches == before + 1
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", STEM_CASES)
def test_stem_train_kernels_bit_equal_plain_versions(shape, kind):
    need_gpu()
    y, inv, shift = stem_case(*shape, kind, seed=3)
    before = (bn_pool_relu_fwd.launches, bn_pool_relu_bwd.launches)
    p, codes = bn_pool_relu_fwd(y, inv, shift)
    p_ref, codes_ref = bn_pool_relu_reference(y, inv, shift)
    assert_bitwise(p, p_ref)
    assert_bitwise(codes, codes_ref)
    assert_bitwise(p, bn_pool_relu_eval(y, inv, shift))
    g = torch.Generator(device="cuda").manual_seed(4)
    dp = torch.randn(p.shape, device="cuda", generator=g).to(torch.bfloat16)
    dy, sums = bn_pool_relu_bwd(codes, dp, p, inv, shift, y.shape[2:])
    dy_ref, sums_ref = bn_pool_relu_bwd_reference(codes, dp, p, inv, shift,
                                                  y.shape[2:])
    torch.cuda.synchronize()
    assert (bn_pool_relu_fwd.launches, bn_pool_relu_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert_bitwise(dy, dy_ref)
    assert_bitwise(sums, sums_ref)
    if kind == "negative":
        assert (codes == 9).all() and not dy.float().abs().sum()


@pytest.mark.gpu
def test_stem_autograd_op_runs_the_kernels():
    need_gpu()
    y, inv, shift = stem_case(2, 8, 16, 16, "inv0", seed=5)
    y.requires_grad_()
    inv.requires_grad_()
    shift.requires_grad_()
    before = (bn_pool_relu_fwd.launches, bn_pool_relu_bwd.launches)
    bn_pool_relu(y, inv, shift).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (bn_pool_relu_fwd.launches, bn_pool_relu_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for t in (y.grad, inv.grad, shift.grad):
        assert torch.isfinite(t.float()).all()
    assert inv.grad[4] == 0  # the inv == 0 channel


@pytest.mark.gpu
def test_stem_kernel_rejects_bad_scalars():
    need_gpu()
    y = torch.zeros(1, 4, 8, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        bn_pool_relu_eval(y, torch.ones(4, device="cuda").half(),
                          torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        bn_pool_relu_fwd(y, torch.ones(3, device="cuda"),
                         torch.zeros(3, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["off", "gaussian", "salt_pepper",
                                  "mixed"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_noise_kernel_bit_equals_plain_version(kind, out_dtype):
    need_gpu()
    n, h, w = 6, 48, 40
    rng = np.random.RandomState(7)
    images = torch.tensor(rng.randint(0, 256, (n, h, w, 3)),
                          dtype=torch.uint8, device="cuda")
    seeds = torch.tensor(rng.randint(0, 2 ** 32, (n, 2)),
                         dtype=torch.int64, device="cuda")
    g_std = {"off": [0.0] * n, "gaussian": [0.01] * n,
             "salt_pepper": [0.0] * n,
             "mixed": [0.01, 0.0, 0.0] * 2}[kind]
    p_eff = {"off": [-1.0] * n, "gaussian": [-1.0] * n,
             "salt_pepper": [0.3] * n,
             "mixed": [-1.0, 0.01, -1.0] * 2}[kind]
    g_std = torch.tensor(g_std, device="cuda")
    p_eff = torch.tensor(p_eff, device="cuda")
    before = noisy_normalize.launches
    got = noisy_normalize(images, seeds, g_std, p_eff, out_dtype)
    want = noisy_normalize_reference(images, seeds, g_std, p_eff,
                                     out_dtype)
    torch.cuda.synchronize()
    assert noisy_normalize.launches == before + 1
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind", POOL_CASES)
def test_pool_kernels_bit_equal_plain_versions(shape, kind):
    need_gpu()
    y = pool_case(*shape, kind, seed=6)
    before = (max_pool_s2_eval.launches, max_pool_s2_fwd.launches,
              max_pool_s2_bwd.launches)
    p_eval = max_pool_s2_eval(y)
    p, codes = max_pool_s2_fwd(y)
    p_ref, codes_ref = max_pool_s2_reference(y)
    assert_bitwise(p, p_ref)
    assert_bitwise(p_eval, p_ref)
    assert_bitwise(codes, codes_ref)
    g = torch.Generator(device="cuda").manual_seed(7)
    dp = torch.randn(p.shape, device="cuda", generator=g).to(torch.bfloat16)
    dy = max_pool_s2_bwd(codes, dp, y.shape[2:])
    assert_bitwise(dy, max_pool_s2_bwd_reference(codes, dp, y.shape[2:]))
    torch.cuda.synchronize()
    assert (max_pool_s2_eval.launches, max_pool_s2_fwd.launches,
            max_pool_s2_bwd.launches) == tuple(b + 1 for b in before)
    assert int(codes.max()) <= 8
    if kind == "constant":
        assert not codes.any()
    if kind == "nan":
        assert int(torch.isnan(p.float()).sum()) == 9


@pytest.mark.gpu
def test_pool_autograd_op_runs_the_kernels():
    need_gpu()
    y = pool_case(2, 8, 16, 16, "randn", seed=8).float().requires_grad_()
    before = (max_pool_s2_fwd.launches, max_pool_s2_bwd.launches)
    max_pool_s2(y).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (max_pool_s2_fwd.launches, max_pool_s2_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert y.grad.dtype == torch.float32
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0


@pytest.mark.gpu
def test_pool_kernel_rejects_bad_codes():
    need_gpu()
    dp = torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        max_pool_s2_bwd(torch.zeros(1, 4, 4, 4, device="cuda"), dp, (8, 8))
    with pytest.raises(ValueError, match="does not pool"):
        max_pool_s2_bwd(torch.zeros(1, 4, 4, 4, dtype=torch.uint8,
                                    device="cuda"), dp, (12, 8))
