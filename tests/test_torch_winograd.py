"""The port's Winograd F(2x2, 3x3) op and its autograd ops against the
JAX package on the CPU, its Pallas kernel in interpret mode.  Inputs are
drawn with numpy; the shapes are tests/test_winograd.py's.  The flagship's
chain is held against JAX in tests/test_torch_winograd_chain.py.

The JAX side is compiled without excess precision (:func:`strict`): XLA on
the CPU otherwise drops the bf16 rounding of the BT column combos, whose
result only feeds the float32 upcast of the products, and about half the
outputs then differ by one bf16 step from what the TPU kernel computes.
With the rounding kept, the port's plain version gives the JAX kernel's
bits.

Tolerances:
  * outputs, aux and out3 (the identity's gradient of EPI_BN_ADD) of the
    kernel op bitwise equal in each ported mode (tests/test_winograd.py
    allows 0.03 of scale against direct conv);
  * the per-channel sums (EPI_STATS, EPI_BN_ACT, EPI_BN_ADD) within 1e-3
    of the sum of the absolute values of their terms (float32 sums in
    another order);
  * the autograd ops' outputs within 1e-2 of their max-abs scale, their
    sums as above, every gradient within 0.05 of scale; conv3x3 against
    direct convolution within 0.03 (output) and 0.05 (gradients) of
    scale, tests/test_winograd.py's bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.ops import winograd as jw
from yolov3_tensorflow_tpu_torch.ops import winograd as pw

from . import torch_threads  # noqa: F401
from .test_winograd import SHAPES, TRAIN_SHAPES

CHUNKED = (1, 4, 32, 8, 8)  # tests/test_winograd.py:42-53
MODE_SHAPE = (2, 13, 13, 8, 16)  # odd H and W, C != Co
OUT_TOL, SUM_TOL, GRAD_TOL = 1e-2, 1e-3, 0.05


def hwcn(a):
    """NCHW numpy -> the JAX kernel's bf16 [H, W, C, N] view."""
    return jnp.transpose(jnp.asarray(a, jnp.bfloat16), (2, 3, 1, 0))


def from_hwcn(a):
    return np.asarray(jnp.transpose(a, (3, 2, 0, 1)).astype(jnp.float32))


def bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def f32(t):
    return t.detach().float().numpy()


def assert_scaled(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-6
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: {err} of scale > {tol}"


def assert_sums(got, want, terms, what):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= SUM_TOL * terms + 1e-6).all(), \
        f"{what}: {(err / terms).max()} of the summed magnitudes"


def mode_inputs(shape, seed):
    n, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(n, c, h, w).astype(np.float32),
        y=rng.randn(n, c, h, w).astype(np.float32),
        cvals=rng.randn(n, co, h, w).astype(np.float32),
        w=(rng.randn(co, c, 3, 3) * 0.2).astype(np.float32),
        scal_c=np.stack([rng.rand(c) + 0.5, rng.randn(c) * 0.2]).astype(
            np.float32),
        scal_co=np.stack([rng.rand(co) + 0.5, rng.randn(co) * 0.2]).astype(
            np.float32),
        scal2=np.stack([rng.randn(c) * 0.1, rng.randn(c) * 0.05]).astype(
            np.float32),
        # a boundary activation (zero where it was cut) and its cotangent
        avals=np.maximum(rng.randn(n, co, h, w), 0).astype(np.float32),
        dvals=rng.randn(n, co, h, w).astype(np.float32))


def strict(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def sum_terms(out, mode, cvals, inv):
    """Per channel, the summed magnitudes of the two sums' terms, from the
    bf16 output: |o| and o^2 (EPI_STATS); |g| and |g c| with g = out/inv
    (EPI_BN_ACT), or g = out3 given as ``out`` with ``inv`` None
    (EPI_BN_ADD)."""
    o = out.astype(np.float64)
    if mode[1] == pw.EPI_STATS:
        return np.stack([np.abs(o).sum((0, 2, 3)), (o * o).sum((0, 2, 3))])
    g = np.abs(o if inv is None else o / inv[None, :, None, None])
    return np.stack([g.sum((0, 2, 3)), (g * np.abs(cvals)).sum((0, 2, 3))])


def mode_case(mode, shape, seed):
    """One kernel case: (numpy inputs, the port's arguments, the JAX
    kernel's positional arguments)."""
    pro, epi = mode
    a = mode_inputs(shape, seed)
    u = pw.transform_weights(bf16(a["w"])).to(torch.bfloat16)
    port = dict(x=bf16(a["x"]), u=u, pro=pro, epi=epi,
                aux=pro != pw.PRO_NONE)
    jax_kw = {}
    if pro in (pw.PRO_BN_ACT, pw.PRO_BN_ADD):
        port["scal"] = torch.tensor(a["scal_c"])
        jax_kw["scal"] = jnp.asarray(a["scal_c"])[:, :, None]
    if pro in (pw.PRO_BN_ADD, pw.PRO_DYEFF):  # the identity, or y
        port["partner"] = bf16(a["y"])
        jax_kw["partner"] = hwcn(a["y"])
    if pro == pw.PRO_DYEFF:
        port["scal2"] = torch.tensor(a["scal2"])
        jax_kw["scal2"] = jnp.asarray(a["scal2"])[:, :, None]
    if epi in (pw.EPI_BN_ACT, pw.EPI_BN_ADD):
        port.update(cvals=bf16(a["cvals"]), scal=torch.tensor(a["scal_co"]))
        jax_kw.update(cvals=hwcn(a["cvals"]),
                      scal=jnp.asarray(a["scal_co"])[:, :, None])
    if epi == pw.EPI_BN_ADD:
        port.update(avals=bf16(a["avals"]), dvals=bf16(a["dvals"]))
        jax_kw.update(avals=hwcn(a["avals"]), dvals=hwcn(a["dvals"]))
    jax_args = (hwcn(a["x"]), jnp.asarray(f32(u), jnp.bfloat16)) + tuple(
        jax_kw.get(k) for k in ("partner", "cvals", "avals", "dvals",
                                "scal", "scal2"))
    return a, port, jax_args


# the JAX kernel's remaining shapes of tests/test_winograd.py: C != Co,
# odd H and W, the chunked case, a wide ragged W (conv3x3 below takes
# all of SHAPES against direct convolution)
SHAPE_CASES = [SHAPES[1], SHAPES[2], CHUNKED, TRAIN_SHAPES[2]]
KERNEL_CASES = [(mode, MODE_SHAPE, 0) for mode in pw.MODES] + [
    ((pw.PRO_NONE, pw.EPI_STATS), shape, 1) for shape in SHAPE_CASES]


@pytest.fixture(scope="module")
def kernel_cases():
    """Every kernel case on both sides: (numpy inputs, the port's outputs,
    the JAX kernel's), NCHW float32 numpy; the JAX kernels in one
    compile."""
    cases = [mode_case(*case) for case in KERNEL_CASES]

    def run_all(all_args):
        return [jw.winograd_call(*args, pro=mode[0], epi=mode[1],
                                 aux=mode[0] != pw.PRO_NONE, interpret=True)
                for args, (mode, _, _) in zip(all_args, KERNEL_CASES)]

    wants = strict(run_all, [jax_args for _, _, jax_args in cases])
    out = {}
    for case, (a, port, _), want in zip(KERNEL_CASES, cases, wants):
        got = [f32(t) for t in pw.winograd_call(**port)]
        want = [np.asarray(t.sum(-1)) if t.ndim == 3 else from_hwcn(t)
                for t in want]
        out[case] = (got, want, a)
    return out


@pytest.mark.parametrize("mode", list(pw.MODES), ids=list(pw.MODES.values()))
def test_plain_version_matches_jax_kernel(kernel_cases, mode):
    """winograd_call on CPU tensors (the plain version) against the JAX
    kernel in each ported mode: output, sums, aux and out3, in JAX's
    order."""
    got, want, a = kernel_cases[(mode, MODE_SHAPE, 0)]
    pro, epi = mode
    assert len(got) == len(want) == 1 + (epi != pw.EPI_NONE) + (
        pro != pw.PRO_NONE) + (epi == pw.EPI_BN_ADD)
    assert got[0].shape == (MODE_SHAPE[0], MODE_SHAPE[4]) + MODE_SHAPE[1:3]
    np.testing.assert_array_equal(got[0], want[0])
    if epi != pw.EPI_NONE:
        if epi == pw.EPI_BN_ADD:  # g itself is out3
            terms = sum_terms(want[-1], mode, a["cvals"], None)
        else:
            terms = sum_terms(want[0], mode, a["cvals"], a["scal_co"][0])
        assert_sums(got[1], want[1], terms, "sums")
    aux = 1 + (epi != pw.EPI_NONE)
    if pro != pw.PRO_NONE:
        np.testing.assert_array_equal(got[aux], want[aux])
    if epi == pw.EPI_BN_ADD:
        np.testing.assert_array_equal(got[aux + 1], want[aux + 1])
        assert (got[aux + 1] != 0).any() and (got[aux + 1] == 0).any()


@pytest.mark.parametrize("shape", SHAPE_CASES, ids=str)
def test_conv_stats_matches_jax_kernel(kernel_cases, shape):
    """The statistics mode on the remaining shapes of tests/test_winograd.py:
    odd sizes, C != Co, chunked and ragged W."""
    got, want, _ = kernel_cases[((pw.PRO_NONE, pw.EPI_STATS), shape, 1)]
    np.testing.assert_array_equal(got[0], want[0])
    terms = sum_terms(want[0], (pw.PRO_NONE, pw.EPI_STATS), None, None)
    assert_sums(got[1], want[1], terms, "sums")
    assert np.isfinite(got[1]).all()


def test_unported_modes_raise():
    """The (prologue, epilogue) pairs that the JAX package never calls are
    no mode of the kernel: they raise, on the CPU as on a device."""
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    u = torch.zeros(16, 8, 8, dtype=torch.bfloat16)
    pairs = [(pro, epi) for pro in range(4) for epi in range(4)
             if (pro, epi) not in pw.MODES]
    assert len(pairs) == 9 and (pw.PRO_BN_ACT, pw.EPI_BN_ACT) in pairs
    for pro, epi in pairs:
        with pytest.raises(NotImplementedError, match="not a mode"):
            pw.winograd_call(x, u, pro=pro, epi=epi)


# ------------------------------------------------------ autograd ops --
def op_case(shape, seed):
    n, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(n, c, h, w).astype(np.float32),
                w=(rng.randn(co, c, 3, 3) * 0.2).astype(np.float32),
                inv=(rng.randn(c) * 0.5 + 1.0).astype(np.float32),
                shift=(rng.randn(c) * 0.2).astype(np.float32),
                dy=rng.randn(n, co, h, w).astype(np.float32),
                ds=rng.randn(co).astype(np.float32),
                dq=(rng.randn(co) * 0.1).astype(np.float32))


OP_SHAPE = TRAIN_SHAPES[0]  # ragged 13x13


@pytest.fixture(scope="module")
def jax_ops():
    """jax.vjp of hconv_stats and hconv_bn_act_stats (HWCN) on numpy
    inputs, with nonzero cotangents: one compile."""
    a = op_case(OP_SHAPE, seed=2)

    def run(x, w, inv, shift, cts):
        out = {}
        for op, scal in (("hconv_stats", ()),
                         ("hconv_bn_act_stats", (inv, shift))):
            y, vjp = jax.vjp(getattr(jw, op), x, w, *scal)
            out[op] = (y, vjp(cts))
        return out

    refs = strict(run, hwcn(a["x"]),
                  jnp.asarray(a["w"].transpose(2, 3, 1, 0), jnp.bfloat16),
                  jnp.asarray(a["inv"]), jnp.asarray(a["shift"]),
                  (hwcn(a["dy"]), jnp.asarray(a["ds"]), jnp.asarray(a["dq"])))
    return a, refs


@pytest.mark.parametrize("op", ["hconv_stats", "hconv_bn_act_stats"])
def test_autograd_ops_match_jax_vjp(jax_ops, op):
    """Values and every gradient of HConvStats / HConvBnActStats against
    jax.vjp of the JAX custom VJPs, with nonzero (dy, ds, dq), on the
    ragged 13x13 shape."""
    a, refs = jax_ops
    (jy, js, jq), jgrads = refs[op]
    bn = op == "hconv_bn_act_stats"
    x = bf16(a["x"]).requires_grad_()
    w = bf16(a["w"]).requires_grad_()
    scal = [torch.tensor(a[k]).requires_grad_() for k in ("inv", "shift")] \
        if bn else []
    y, s, q = getattr(pw, op)(x, w, *scal)
    torch.autograd.backward(
        (y, s, q), (bf16(a["dy"]), torch.tensor(a["ds"]),
                    torch.tensor(a["dq"])))
    assert_scaled(f32(y), from_hwcn(jy), OUT_TOL, "y")
    terms = sum_terms(from_hwcn(jy), (0, pw.EPI_STATS), None, None)
    assert_sums(torch.stack([s, q]).detach().numpy(),
                np.stack([np.asarray(js), np.asarray(jq)]), terms, "stats")
    grads = [x.grad, w.grad] + [t.grad for t in scal]
    want = [from_hwcn(jgrads[0]),
            np.asarray(jgrads[1], np.float32).transpose(3, 2, 0, 1)] + \
        [np.asarray(g) for g in jgrads[2:]]
    tie = None
    if bn:  # exact-zero pre-activations: both subgradients are valid
        xb = bf16(a["x"])
        tie = f32(xb * bf16(a["inv"])[None, :, None, None]
                  + bf16(a["shift"])[None, :, None, None]) == 0
    for name, g, ref in zip(("dx", "dw", "dinv", "dshift"), grads, want):
        g = f32(g)
        assert np.isfinite(g).all(), name
        if name == "dx" and tie is not None:
            g, ref = np.where(tie, 0.0, g), np.where(tie, 0.0, ref)
        assert_scaled(g, ref, GRAD_TOL, name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv3x3_matches_direct(shape):
    """conv3x3 (the PRO_NONE / EPI_NONE forward and input gradient, the
    library's weight gradient) against direct convolution of the same
    bf16 operands, with tests/test_winograd.py's bounds: the output within
    0.03 and the gradients within 0.05 of their max-abs scale."""
    a = op_case(shape, seed=3)
    x = bf16(a["x"]).requires_grad_()
    wt = bf16(a["w"]).requires_grad_()
    y = pw.conv3x3(x, wt)
    y.float().backward(torch.tensor(a["dy"]))
    xd = x.detach().float().requires_grad_()
    wd = wt.detach().float().requires_grad_()
    yd = torch.nn.functional.conv2d(xd, wd, padding=1)
    yd.backward(torch.tensor(a["dy"]))
    assert y.dtype == torch.bfloat16 and y.shape == yd.shape
    assert_scaled(f32(y), f32(yd), 0.03, "y")
    assert_scaled(f32(x.grad), f32(xd.grad), GRAD_TOL, "dx")
    assert_scaled(f32(wt.grad), f32(wd.grad), GRAD_TOL, "dw")
    y2, s, q = pw.conv3x3_stats(x.detach().float(), wt.detach())
    np.testing.assert_array_equal(f32(y2), f32(y))
    yd = yd.detach()
    assert_scaled(f32(s), f32(yd.sum((0, 2, 3))), 0.03, "sum")
    assert_scaled(f32(q), f32(yd.square().sum((0, 2, 3))), 0.03, "sumsq")
