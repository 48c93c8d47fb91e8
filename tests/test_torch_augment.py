"""The port's normalize + noise op (ops/augment_noise.py) and on-device
augmentation (data/augment.py) against the JAX package (Pallas kernel in
interpret mode on the CPU; data/augment.py).

Tolerances:
  * noise off, salt-pepper masks and salt values: exact;
  * gaussian noise at the kernel's output type bf16: bitwise on at least
    99.9% of the elements and within one bf16 ulp on the rest.  The hash
    and the uniform are exact; the inverse CDF loses ~1e-4 of z to
    cancellation near |u - 0.5| = 0.47575 in float32, and XLA's fused
    evaluation rounds it differently from an op-by-op one (PyTorch and
    the CUDA kernel), so float32 outputs differ in their last bits there;
  * the color chain with injected per-image scalars: within 1e-6 at
    float32;
  * distributions (noise moments, salt-pepper density, per-image scalar
    ranges and frequencies): the bounds of tests/test_augment_noise.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.data.augment import _color as jax_color
from yolov3_tensorflow_tpu.ops.augment_noise import \
    noisy_normalize as jax_noisy_normalize
from yolov3_tensorflow_tpu_torch.data import augment
from yolov3_tensorflow_tpu_torch.ops.augment_noise import (_ndtri,
                                                           noisy_normalize)

from . import torch_threads  # noqa: F401


def images(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               dtype=np.uint8)


def seeds(n, seed=1):
    """(N, 2) seed words covering the full uint32 range."""
    words = np.random.RandomState(seed).randint(0, 2 ** 32, (n, 2),
                                                dtype=np.uint64)
    return words.astype(np.uint32).view(np.int32)


def both(img, sd, g_std, p_eff, out=torch.float32):
    """(port NCHW, JAX NHWC->NCHW) outputs as float32 numpy."""
    jdt = jnp.float32 if out == torch.float32 else jnp.bfloat16
    want = jax_noisy_normalize(jnp.asarray(img), jnp.asarray(sd),
                               jnp.asarray(g_std, jnp.float32),
                               jnp.asarray(p_eff, jnp.float32),
                               out_dtype=jdt)
    got = noisy_normalize(torch.from_numpy(img), torch.from_numpy(sd),
                          torch.tensor(g_std, dtype=torch.float32),
                          torch.tensor(p_eff, dtype=torch.float32), out)
    assert got.dtype == out and got.shape == (img.shape[0], 3) + \
        img.shape[1:3]
    return (got.float().numpy(),
            np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_noise_off_is_exact(out):
    img = images(2, 32, 32)
    got, want = both(img, seeds(2), [0.0, 0.0], [-1.0, -1.0], out)
    np.testing.assert_array_equal(got, want)
    ref = torch.from_numpy(img).permute(0, 3, 1, 2).float() * np.float32(
        1.0 / 255.0)
    np.testing.assert_array_equal(got, ref.to(out).float().numpy())


def test_salt_pepper_masks_and_values_exact():
    img = images(3, 40, 48, seed=2)
    got, want = both(img, seeds(3, seed=3), [0.0] * 3, [0.3, 0.01, 0.5])
    np.testing.assert_array_equal(got, want)
    base = img.transpose(0, 3, 1, 2).astype(np.float32) * np.float32(
        1 / 255)
    changed = got != base
    assert np.isin(got[changed], [0.0, 1.0]).all()
    frac = changed.any(axis=1)[2].mean()  # the p=0.5 image, per pixel
    assert abs(frac - 0.5) < 0.03, frac


def test_gaussian_values_match_jax_kernel():
    img = images(4, 48, 64, seed=4)
    got, want = both(img, seeds(4, seed=5), [0.01] * 4, [-1.0] * 4,
                     torch.bfloat16)
    differ = got != want
    print(f"gaussian bf16: {int(differ.sum())} of {differ.size} elements "
          "differ from the JAX kernel")
    assert differ.mean() <= 1e-3
    ulp = np.abs(want) * 2.0 ** -7  # one bf16 ulp at most this big
    assert (np.abs(got - want)[differ] <= ulp[differ] + 1e-12).all()


def test_mixed_batch_matches_jax_kernel():
    img = images(6, 32, 40, seed=6)
    g = [0.01, 0.0, 0.0, 0.01, 0.0, 0.0]
    p = [-1.0, 0.01, -1.0, -1.0, 0.2, -1.0]
    got, want = both(img, seeds(6, seed=7), g, p, torch.bfloat16)
    quiet = [1, 2, 4, 5]  # no gaussian draw: exact
    np.testing.assert_array_equal(got[quiet], want[quiet])
    assert (got != want).mean() <= 1e-3


def test_gaussian_noise_distribution():
    img = images(2, 64, 64)
    got, _ = both(img, seeds(2), [0.01, 0.01], [-1.0, -1.0])
    d = got - img.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    assert abs(d.mean()) < 3e-4
    assert abs(d.std() - 0.01) < 5e-4
    assert np.abs(d).max() < 0.01 * 6.5  # ~5.6 sigma max at 24-bit u


def test_salt_pepper_is_per_pixel():
    img = images(3, 64, 64, seed=1)
    got, _ = both(img, seeds(3, seed=11), [0.0] * 3, [0.5] * 3)
    ref = img.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    changed = np.abs(got - ref) > 1e-7
    assert np.isin(got[changed], [0.0, 1.0]).all()
    pix_sel = changed.any(axis=1)  # (N, H, W)
    vals = got.transpose(0, 2, 3, 1)[pix_sel]  # (P, 3)
    salt = np.where(vals[:, :1] > 0.5, 1.0, 0.0)
    agree = (vals == salt) | ~changed.transpose(0, 2, 3, 1)[pix_sel]
    assert agree.all()
    assert abs(pix_sel.mean() - 0.5) < 0.02
    assert abs((got[changed] > 0.5).mean() - 0.5) < 0.03


def test_ndtri_matches_scipy():
    from scipy.special import ndtri
    u = np.linspace(2e-25, 1 - 1e-7, 4001).astype(np.float32)
    err = np.abs(_ndtri(torch.from_numpy(u)).numpy()
                 - ndtri(u.astype(np.float64)))
    assert err.max() < 5e-4, err.max()


def test_every_uniform_gives_a_finite_normal():
    """All 2^24 values of the uniform map to a finite z.  The TPU
    kernel's _u01 rounds the top one to exactly 1.0 and its inverse CDF
    returns NaN there (a NaN pixel about once per 32 gaussian 416x416
    images); the port clamps that one value below 1."""
    from yolov3_tensorflow_tpu.ops.augment_noise import _ndtri as jax_ndtri
    from yolov3_tensorflow_tpu.ops.augment_noise import _u01 as jax_u01
    from yolov3_tensorflow_tpu_torch.ops.augment_noise import _u01
    top = np.asarray([0xFFFFFF00], np.uint32).view(np.int32)
    assert float(jax_u01(jnp.asarray(top))[0]) == 1.0
    assert np.isnan(float(jax_ndtri(jax_u01(jnp.asarray(top)))[0]))
    u = _u01(torch.arange(2 ** 24, dtype=torch.int64) << 8)
    assert float(u.max()) < 1.0 and float(u.min()) > 0.0
    assert torch.isfinite(_ndtri(u)).all()
    assert float(u[-2]) == float(jax_u01(jnp.asarray(
        np.asarray([0xFFFFFE00], np.uint32).view(np.int32)))[0])


def test_wrapper_checks_inputs():
    img = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        noisy_normalize(img.float(), torch.zeros(2, 2, dtype=torch.int64),
                        torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="seeds"):
        noisy_normalize(img, torch.zeros(2, 3, dtype=torch.int64),
                        torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="no kernel"):
        noisy_normalize(img.to("meta"), torch.zeros(2, 2, dtype=torch.int64,
                                                    device="meta"),
                        torch.zeros(2, device="meta"),
                        torch.zeros(2, device="meta"))


# ------------------------------------------------------------- color --
def test_color_chain_matches_jax_with_injected_scalars():
    rng = np.random.RandomState(9)
    n = 6
    # noised input slightly out of gamut, as the reference's chain sees it
    x = rng.uniform(-0.02, 1.02, (n, 16, 20, 3)).astype(np.float32)
    x[0, :4] = 0.5  # grey pixels: chroma 0
    x[1, :4] = 0.0  # black pixels: V = 0
    scal = dict(s_eff=rng.uniform(0.9, 1.1, n),
                c_eff=rng.uniform(0.9, 1.1, n),
                pre_b=rng.uniform(-0.12, 0.12, n) * (rng.rand(n) > 0.5),
                post_b=rng.uniform(-0.12, 0.12, n) * (rng.rand(n) > 0.5))
    scal = {k: v.astype(np.float32) for k, v in scal.items()}
    jcolor = {k: jnp.asarray(v).reshape((n, 1, 1) if k == "s_eff"
                                        else (n, 1, 1, 1))
              for k, v in scal.items()}
    want = np.asarray(jax_color(jnp.asarray(x), jcolor))
    tcolor = {k: torch.from_numpy(v).reshape(n, 1, 1, 1)
              for k, v in scal.items()}
    got = augment._color(torch.from_numpy(x).permute(0, 3, 1, 2), tcolor)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)


def test_scalar_distributions():
    g = torch.Generator().manual_seed(0)
    n = 6000
    noise_type, color = augment._scalars(g, n, torch.float32)
    freq = np.bincount(noise_type.numpy(), minlength=3) / n
    np.testing.assert_allclose(freq, [1 / 3] * 3, atol=0.03)
    s = color["s_eff"].flatten().numpy()
    c = color["c_eff"].flatten().numpy()
    pre = color["pre_b"].flatten().numpy()
    post = color["post_b"].flatten().numpy()
    identity = (s == 1.0) & (c == 1.0) & (pre == 0) & (post == 0)
    assert abs(identity.mean() - 0.25) < 0.03  # order 3: no color
    colored = ~identity
    assert (s[colored] >= 0.9).all() and (s[colored] <= 1.1).all()
    assert (c[colored] >= 0.9).all() and (c[colored] <= 1.1).all()
    b = pre + post
    assert np.abs(b).max() <= 30 / 255 + 1e-7
    assert ((pre != 0) & (post != 0)).sum() == 0
    # order 0 puts b before saturation, orders 1-2 after: 1 : 2
    assert abs((pre != 0).mean() - 0.25) < 0.03
    assert abs((post != 0).mean() - 0.5) < 0.03
    assert abs(np.std(s[colored]) - 0.2 / np.sqrt(12)) < 0.005


def test_augment_backends_share_the_scalar_stream():
    """Images drawn without noise come out of both backends identical (the
    per-image scalars come from the same generator stream); every output
    lies in [0, 1]."""
    img = torch.from_numpy(images(16, 24, 24, seed=3))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    fused = augment.augment_batch_fused(g1, img, torch.float32)
    plain = augment.augment_batch(
        g2, img.permute(0, 3, 1, 2).float() * np.float32(1 / 255))
    noise_type, _ = augment._scalars(torch.Generator().manual_seed(5), 16,
                                     torch.float32)
    quiet = (noise_type == augment.NOISE_NONE).numpy()
    assert quiet.any()
    np.testing.assert_allclose(fused.numpy()[quiet], plain.numpy()[quiet],
                               atol=1e-6, rtol=0)
    for out in (fused, plain):
        assert out.shape == (16, 3, 24, 24)
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_xla_backend_noise_distributions():
    """The generator-drawn noise: gaussian images carry N(0, 0.01) noise,
    salt-pepper images a per-pixel 1% select with fair salt."""
    n, h, w = 48, 64, 64
    img = torch.full((n, 3, h, w), 0.5)
    g = torch.Generator().manual_seed(2)
    nt, _ = augment._scalars(torch.Generator().manual_seed(2), n,
                             torch.float32)
    # the color chain is affine per image; undo nothing, read the noise
    # through the identity-color images only
    out = augment.augment_batch(g, img)
    _, color = augment._scalars(torch.Generator().manual_seed(2), n,
                                torch.float32)
    identity = ((color["s_eff"] == 1) & (color["c_eff"] == 1)
                & (color["pre_b"] == 0) & (color["post_b"] == 0)).flatten()
    gauss = ((nt == augment.NOISE_GAUSSIAN) & identity).numpy()
    sp = ((nt == augment.NOISE_SALT_PEPPER) & identity).numpy()
    assert gauss.any() and sp.any()
    # contrast with c = 1 recenters nothing: x - mean + mean
    d = out.numpy()[gauss] - 0.5
    assert abs(d.std() - 0.01) < 5e-4 and abs(d.mean()) < 5e-4
    hit = np.abs(out.numpy()[sp] - 0.5) > 0.25  # (k, 3, H, W)
    per_pixel = hit.any(axis=1)
    assert (hit.all(axis=1) == per_pixel).all()  # channel-shared
    assert abs(per_pixel.mean() - 0.01) < 0.003
