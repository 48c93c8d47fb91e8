"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU (marker ``gpu``) and skip without
one.  The card's machine has no JAX, so this file imports none and runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest -q

Tolerance: none for the stem and noise kernels.  Every such output
(pooled values, codes, dy, the two per-channel sums, the noised batch)
must be bitwise equal to its plain version's on the same inputs, NaN
included.  The Winograd kernel sums its products on the tensor cores in
another order than the plain version's float32 product, so its bf16
outputs (out, and out3 of EPI_BN_ADD) are held to one bf16 step (|k - p|
<= 2^-7 |p| + 1e-4 max|p|) with at least 99.9% of them bitwise, its
per-channel sums to 1e-5 of their terms' summed magnitudes, and its aux
output bitwise.
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
from yolov3_tensorflow_tpu_torch.ops import winograd as wg

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


# (N, C, Co, H, W): the chain's shape at batch 8, odd sizes, a ragged final
# tile block, C = Co = 8, Co not a multiple of the kernel's block, a wide W
# (two column segments); then a last band of one tile row at module 2's
# width, Co = 128 over two channel blocks, many small images (blocks
# crossing image boundaries, W = 26 on the narrow-copy variant), W = 11
WINOGRAD_CASES = [(8, 128, 128, 52, 52), (2, 8, 8, 13, 11), (3, 16, 24, 7, 9),
                  (1, 8, 72, 6, 200), (2, 8, 8, 2, 2), (8, 128, 128, 50, 52),
                  (4, 64, 128, 20, 20), (32, 64, 64, 26, 26),
                  (4, 32, 32, 10, 11)]
# least share of bf16 outputs bit-equal to the plain version's (measured
# on an H100: 99.985% at the chain's shape, 100% at the small ones)
WINOGRAD_BITWISE_SHARE = 0.999


def winograd_case(n, c, co, h, w, seed):
    rng = np.random.RandomState(seed)

    def dev(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device="cuda")
    return dict(
        x=dev(rng.randn(n, c, h, w)), y=dev(rng.randn(n, c, h, w)),
        cvals=dev(rng.randn(n, co, h, w)),
        w=dev(rng.randn(co, c, 3, 3) * np.sqrt(2.0 / (9 * c))),
        scal_c=dev([rng.rand(c) + 0.5, rng.randn(c) * 0.2], torch.float32),
        scal_co=dev([rng.rand(co) + 0.5, rng.randn(co) * 0.2],
                    torch.float32),
        scal2=dev([rng.randn(c) * 1e-3, rng.randn(c) * 1e-4],
                  torch.float32),
        # a boundary activation (zero where it was cut) and its cotangent
        avals=dev(np.maximum(rng.randn(n, co, h, w), 0)),
        dvals=dev(rng.randn(n, co, h, w)))


def winograd_args(mode, a):
    pro, epi = mode
    kw = dict(pro=pro, epi=epi, aux=pro != wg.PRO_NONE)
    if pro in (wg.PRO_BN_ACT, wg.PRO_BN_ADD):
        kw["scal"] = a["scal_c"]
    if pro in (wg.PRO_BN_ADD, wg.PRO_DYEFF):  # the identity, or y
        kw["partner"] = a["y"]
    if pro == wg.PRO_DYEFF:
        kw["scal2"] = a["scal2"]
    if epi in (wg.EPI_BN_ACT, wg.EPI_BN_ADD):
        kw.update(cvals=a["cvals"], scal=a["scal_co"])
    if epi == wg.EPI_BN_ADD:
        kw.update(avals=a["avals"], dvals=a["dvals"])
    return kw


def assert_step_close(got, want):
    """bf16 ``got`` within one bf16 step of ``want``, and at least
    WINOGRAD_BITWISE_SHARE of it bitwise."""
    out, ref = got.float(), want.float()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    bound = 2 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
    assert ((out - ref).abs() <= bound).all()
    # the sums' order moves a few outputs by one step; a lost bf16
    # rounding in the transforms moves about half of them
    assert (got == want).float().mean() >= WINOGRAD_BITWISE_SHARE


def assert_winograd_close(got, want, mode, kw):
    pro, epi = mode
    assert len(got) == len(want)
    assert_step_close(got[0], want[0])
    ref = want[0].float()
    if epi != wg.EPI_NONE:
        if epi == wg.EPI_STATS:
            terms = torch.stack([ref.abs().sum((0, 2, 3)),
                                 ref.square().sum((0, 2, 3))])
        else:  # |g|: out / inv, or out3 itself
            g = want[-1].float().abs() if epi == wg.EPI_BN_ADD else \
                ref.abs() / kw["scal"][0].abs()[None, :, None, None]
            terms = torch.stack([
                g.sum((0, 2, 3)),
                (g * kw["cvals"].float().abs()).sum((0, 2, 3))])
        assert ((got[1] - want[1]).abs() <= 1e-5 * terms + 1e-6).all()
    aux = 1 + (epi != wg.EPI_NONE)
    if kw["aux"]:
        assert_bitwise(got[aux], want[aux])
    if epi == wg.EPI_BN_ADD:  # out3, the identity's gradient
        assert_step_close(got[aux + 1], want[aux + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WINOGRAD_CASES, ids=str)
@pytest.mark.parametrize("mode", list(wg.MODES), ids=list(wg.MODES.values()))
def test_winograd_kernel_matches_plain_version(mode, shape):
    need_gpu()
    n, c, co, h, w = shape
    a = winograd_case(*shape, seed=9)
    u = wg.transform_weights(a["w"]).to(torch.bfloat16)
    kw = winograd_args(mode, a)
    name = wg.MODES[mode]
    before = wg.KERNELS[name].launches
    got = wg.winograd_call(a["x"], u, **kw)
    again = wg.winograd_call(a["x"], u, **kw)
    want = wg.winograd_reference(a["x"], u, **kw)
    torch.cuda.synchronize()
    assert wg.KERNELS[name].launches == before + 2
    assert_winograd_close(got, want, mode, kw)
    for first, second in zip(got, again):  # no atomics: runs repeat
        assert_bitwise(first, second)


@pytest.mark.gpu
def test_winograd_autograd_ops_run_the_kernels():
    """The chain's two ops, forward and backward, each launch their mode
    once, and give the plain versions' values and gradients on the card
    (the CPU tests hold the plain versions against JAX)."""
    need_gpu()
    a = winograd_case(4, 16, 16, 9, 10, seed=10)
    launches = {m: k.launches for m, k in wg.KERNELS.items()}
    results = []
    for device in ("cuda", "cpu"):
        x, w, inv, shift = (t.detach().to(device).requires_grad_() for t in
                            (a["x"], a["w"], *a["scal_c"]))
        y1, s1, q1 = wg.hconv_stats(x, w)
        y2, s2, q2 = wg.hconv_bn_act_stats(y1, w, inv, shift)
        loss = (y2.float().square().mean() + s1.sum() * 1e-3
                + q2.sum() * 1e-5)
        loss.backward()
        results.append([t.detach().float().cpu() for t in
                        (y2, s2, q2, x.grad, w.grad, inv.grad, shift.grad)])
    torch.cuda.synchronize()
    for name in ("conv_stats", "bn_act_conv_stats", "dyeff_conv",
                 "dyeff_conv_bn_act"):
        assert wg.KERNELS[name].launches == launches[name] + 1, name
    for got, want in zip(*results):
        scale = want.abs().max() + 1e-6
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() / scale <= 0.05


@pytest.mark.gpu
def test_winograd_residual_op_runs_the_kernels():
    """hconv_bn_add_act_stats forward and backward launch their two modes
    once each, and give the plain versions' values and gradients on the
    card, with a cotangent on every output."""
    need_gpu()
    a = winograd_case(4, 16, 16, 9, 10, seed=11)
    launches = {m: k.launches for m, k in wg.KERNELS.items()}
    results = []
    for device in ("cuda", "cpu"):
        x, ident, w, inv, shift = (
            t.detach().to(device).requires_grad_() for t in
            (a["x"], a["y"], a["w"], *a["scal_c"]))
        y, act, s, q = wg.hconv_bn_add_act_stats(x, ident, w, inv, shift)
        loss = (y.float().square().mean() + act.float().mean()
                + s.sum() * 1e-3 + q.sum() * 1e-5)
        loss.backward()
        results.append([t.detach().float().cpu() for t in
                        (y, act, s, q, x.grad, ident.grad, w.grad, inv.grad,
                         shift.grad)])
    torch.cuda.synchronize()
    for name in ("bn_add_conv_stats", "dyeff_conv_bn_add"):
        assert wg.KERNELS[name].launches == launches[name] + 1, name
    assert torch.equal(results[0][1], results[1][1])  # a: bitwise
    for got, want in zip(*results):
        scale = want.abs().max() + 1e-6
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() / scale <= 0.05


@pytest.mark.gpu
def test_winograd_kernel_rejects_bad_operands():
    need_gpu()
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16, device="cuda")
    u = torch.zeros(16, 8, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="u must be"):
        wg.winograd_call(x, u.float())
    with pytest.raises(ValueError, match="scal2 must be"):
        wg.winograd_call(x, u, partner=x, pro=wg.PRO_DYEFF)
    scal = torch.zeros(2, 8, device="cuda")
    with pytest.raises(ValueError, match="cvals must be"):
        wg.winograd_call(x, u, partner=x, scal=scal, scal2=scal,
                         pro=wg.PRO_DYEFF, epi=wg.EPI_BN_ACT)
    with pytest.raises(ValueError, match="partner must be"):
        wg.winograd_call(x, u, scal=scal, pro=wg.PRO_BN_ADD,
                         epi=wg.EPI_STATS, aux=True)
    with pytest.raises(ValueError, match="avals must be"):
        wg.winograd_call(x, u, partner=x, cvals=x, dvals=x, scal=scal,
                         scal2=scal, pro=wg.PRO_DYEFF, epi=wg.EPI_BN_ADD,
                         aux=True)
