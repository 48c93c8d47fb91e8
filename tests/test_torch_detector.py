"""The port's flagship detector, weight bridge and whole serving slice
against the JAX package, at 64x64 with class_num=2.

The JAX variables are the flax tree of the JAX model (structure from
eval_shape) filled from a numpy seed, BN scale, bias and running
statistics included; they reach the port through tools/import_flax.
Tolerances: heads at float32 within atol 2e-3 (the 18-layer Keras parity
bound of tests/test_parity_e2e.py), at bfloat16 within 3e-2 (the stem
backend parity bound of tests/test_stem_pool.py).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.infer.server import \
    DetectionEngine as JaxDetectionEngine
from yolov3_tensorflow_tpu.models.detector import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu.models.detector import pack_heads as jax_pack
from yolov3_tensorflow_tpu.models.detector import unpack_heads as jax_unpack
from yolov3_tensorflow_tpu.train.trainer import _normalize_images
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.infer.predict import Predictor
from yolov3_tensorflow_tpu_torch.infer.server import DetectionEngine
from yolov3_tensorflow_tpu_torch.models.detector import (YOLOv3Detector,
                                                         build_detector,
                                                         pack_heads,
                                                         unpack_heads)
from yolov3_tensorflow_tpu_torch.tools.import_flax import import_flax

from . import torch_threads  # noqa: F401

HW = (64, 64)
FP32_ATOL = 2e-3
BF16_ATOL = 3e-2


def cfg_pair(**kw):
    kw = dict(input_image_size=HW + (3,), class_num=2, **kw)
    return JaxConfig(**kw), Config(**kw)


def seeded_variables(seed=0, **cfg_kw):
    """The JAX model's variable tree (the flagship unless ``cfg_kw`` says
    otherwise), every leaf drawn from numpy."""
    jcfg, _ = cfg_pair(**cfg_kw)
    model = jax_build_detector(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = [getattr(k, "key", "") for k in path]
        shape = leaf.shape
        if name[-1] == "kernel":
            std = 0.01 if "head_out" in name[-2] else \
                np.sqrt(2.0 / np.prod(shape[:-1]))
            return (rng.randn(*shape) * std).astype(np.float32)
        if name[-1] == "scale":
            return rng.uniform(0.6, 1.2, shape).astype(np.float32)
        if name[-1] == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return seeded_variables()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randint(0, 256, (2,) + HW + (3,),
                                            dtype=np.uint8)


def port_model(cfg, variables):
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(import_flax(variables, model))
    return model


def jax_heads(jcfg, variables, images):
    model = jax_build_detector(jcfg)
    fn = jax.jit(lambda v, x: model.apply(v, _normalize_images(x),
                                          train=False))
    return [np.asarray(h) for h in fn(variables, jnp.asarray(images))]


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("stem", ["xla", "fused"])
@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_heads_match_jax(variables, images, stem, dtype, atol):
    jcfg, cfg = cfg_pair(stem_backend=stem, compute_dtype=dtype)
    want = jax_heads(jcfg, variables, images)
    pred = Predictor(cfg, import_flax(variables, build_detector(
        cfg, device="cpu")), device="cpu")
    got = pred.predict(images)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape[1] == w.shape[-1]
        assert np.abs(w).max() > 0.1  # the comparison is not vacuous
        np.testing.assert_allclose(nhwc(g), w, atol=atol, rtol=0)


def test_pack_unpack_match_jax(variables, images):
    jcfg, cfg = cfg_pair(compute_dtype="float32", stem_backend="xla")
    rng = np.random.RandomState(4)
    heads = [rng.randn(2, c, h, w).astype(np.float32) for c, (h, w) in
             zip(cfg.head_channel_nums, cfg.head_grid_sizes)]
    merged = pack_heads(*[torch.from_numpy(h) for h in heads])
    want = np.asarray(jax_pack(*[h.transpose(0, 2, 3, 1) for h in heads]))
    np.testing.assert_array_equal(merged.numpy(), want)
    for g, w in zip(unpack_heads(merged, cfg.head_grid_sizes, cfg.box_num,
                                 cfg.box_len),
                    jax_unpack(jnp.asarray(want), jcfg.head_grid_sizes,
                               jcfg.box_num, jcfg.box_len)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bridge_covers_all_146_leaves(variables):
    _, cfg = cfg_pair()
    model = build_detector(cfg, device="cpu")
    sd = import_flax(variables, model)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == len(sd) == len(model.state_dict()) == 146
    k = variables["params"]["backbone"]["Conv_3"]["kernel"]  # 1x1 NIN
    np.testing.assert_array_equal(sd["backbone.Conv_3.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["FusedBatchNorm_6.var"].numpy(),
        variables["batch_stats"]["FusedBatchNorm_6"]["var"])
    np.testing.assert_array_equal(
        sd["head_out_16.bias"].numpy(),
        variables["params"]["head_out_16"]["bias"])


def test_bridge_rejects_missing_and_leftover_leaves(variables):
    _, cfg = cfg_pair()
    model = build_detector(cfg, device="cpu")
    missing = copy.deepcopy(jax.device_get(variables))
    del missing["batch_stats"]["backbone"]["FusedBatchNorm_20"]["mean"]
    with pytest.raises(KeyError, match="missing"):
        import_flax(missing, model)
    leftover = copy.deepcopy(jax.device_get(variables))
    leftover["params"]["Conv_99"] = {"kernel": np.zeros((1, 1, 2, 2))}
    with pytest.raises(KeyError, match="leftover"):
        import_flax(leftover, model)
    unknown = copy.deepcopy(jax.device_get(variables))
    unknown["params"]["head_out_8"]["gamma"] = np.zeros(3)
    with pytest.raises(KeyError, match="unmapped"):
        import_flax(unknown, model)


def test_other_backbones_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        YOLOv3Detector(backbone_name="mixnet-18")
    with pytest.raises(ValueError, match="no such backbone"):
        YOLOv3Detector(backbone_name="vgg")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the GPU-less behaviour")
    _, cfg = cfg_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, {})


def match_rows(a, b, tol):
    """Pairs of rows (same head and class, boxes within tol)."""
    pairs, used = [], set()
    for i, ra in enumerate(a):
        for j, rb in enumerate(b):
            if j not in used and ra[8] == rb[8] and ra[6] == rb[6] \
                    and np.abs(ra[:4] - rb[:4]).max() < tol:
                pairs.append((i, j))
                used.add(j)
                break
    return pairs


def test_whole_slice_matches_jax(variables, images):
    """uint8 batch -> Predictor -> DetectionEngine on the CPU, against the
    JAX eval forward + BatchedNMS engine on the same weights, float32:
    heads within 2e-3, every kept detection matched within 2e-3.  The
    port runs its default stem ("auto": the fused op, here its plain
    version), which is the JAX "fused" stem's arithmetic."""
    jcfg, cfg = cfg_pair(compute_dtype="float32", confidence_thresh=0.3)
    jcfg = jcfg.replace(stem_backend="fused")
    model = jax_build_detector(jcfg)
    fwd = jax.jit(lambda x: model.apply(variables, _normalize_images(x),
                                        train=False))
    want_heads = fwd(jnp.asarray(images))
    want = JaxDetectionEngine(jcfg, fwd)(images)

    pred = Predictor(cfg, import_flax(variables, build_detector(
        cfg, device="cpu")), device="cpu")
    for g, w in zip(pred.predict(images), want_heads):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=FP32_ATOL,
                                   rtol=0)
    got = DetectionEngine(cfg, pred.predict, device="cpu")(images)
    assert len(got) == len(want) == len(images)
    total = 0
    for g, w in zip(got, want):
        assert g.shape[1] == w.shape[1] == 9
        pairs = match_rows(w, g, FP32_ATOL)
        assert len(pairs) >= 0.9 * max(len(g), len(w))
        for i, j in pairs:
            np.testing.assert_allclose(g[j], w[i], atol=FP32_ATOL, rtol=0)
        total += len(pairs)
    assert total > 0
