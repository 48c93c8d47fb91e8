"""The port's ResNet-18-v2 YOLOv3 (pre-activation blocks, the pool-only
stem) against the JAX package's, at 64x64 with class_num=2, from the same
seeded flax variables moved across by tools/import_flax.

Tolerances, as for the flagship (tests/test_torch_detector.py): heads at
float32 within atol 2e-3 (the 18-layer Keras parity bound of
tests/test_parity_e2e.py), at bfloat16 within 3e-2 (the stem backend
parity bound of tests/test_stem_pool.py); every kept detection of the
serving engine within 2e-3.  The train step is held against the JAX
trainer in tests/test_torch_trainer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.infer.server import \
    DetectionEngine as JaxDetectionEngine
from yolov3_tensorflow_tpu.models.detector import \
    build_detector as jax_build_detector
from yolov3_tensorflow_tpu.train.trainer import _normalize_images
from yolov3_tensorflow_tpu_torch.infer.predict import Predictor
from yolov3_tensorflow_tpu_torch.infer.server import DetectionEngine
from yolov3_tensorflow_tpu_torch.models.detector import build_detector
from yolov3_tensorflow_tpu_torch.models.resnet18_v2 import ResNet18V2
from yolov3_tensorflow_tpu_torch.ops.stem_pool import (max_pool_s2_eval,
                                                       max_pool_s2_fwd)
from yolov3_tensorflow_tpu_torch.tools.import_flax import import_flax

from . import torch_threads  # noqa: F401
from .test_torch_detector import (BF16_ATOL, FP32_ATOL, cfg_pair,
                                  jax_heads, match_rows, nhwc,
                                  seeded_variables)

V2 = dict(model_backbone="resnet-18-v2")


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(**V2)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)


def predictor(cfg, variables):
    return Predictor(cfg, import_flax(variables, build_detector(
        cfg, device="cpu")), device="cpu")


@pytest.mark.parametrize("stem", ["xla", "fused"])
@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_heads_match_jax(variables, images, stem, dtype, atol):
    jcfg, cfg = cfg_pair(stem_backend=stem, compute_dtype=dtype, **V2)
    want = jax_heads(jcfg, variables, images)
    got = predictor(cfg, variables).predict(images)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape[1] == w.shape[-1]
        assert np.abs(w).max() > 0.1  # the comparison is not vacuous
        np.testing.assert_allclose(nhwc(g), w, atol=atol, rtol=0)


def test_bridge_covers_all_154_leaves(variables):
    """Every flax leaf lands on the port's model and back: the stem conv
    has no BN, each block has a pre-activation BN, and the three taps have
    BNs of their own (created last)."""
    _, cfg = cfg_pair(**V2)
    model = build_detector(cfg, device="cpu")
    sd = import_flax(variables, model)
    assert len(jax.tree_util.tree_leaves(variables)) == len(sd) \
        == len(model.state_dict()) == 154
    backbone = variables["params"]["backbone"]
    assert model.backbone.stem is model.backbone.Conv_0
    assert sd["backbone.Conv_0.weight"].shape == (64, 3, 3, 3)
    # block 1: BN_0 (pre, 64), Conv_1, BN_1, Conv_2, NIN Conv_3 + BN_2
    assert sd["backbone.FusedBatchNorm_0.scale"].shape == (64,)
    np.testing.assert_array_equal(
        sd["backbone.Conv_3.weight"].numpy(),
        backbone["Conv_3"]["kernel"].transpose(3, 2, 0, 1))
    # the three tap BNs: 128, 256, 512 features
    taps = [model.backbone.taps[i].scale.shape[0] for i in range(3)]
    assert taps == [128, 256, 512]
    last = max(int(k.split("_")[1]) for k in backbone
               if k.startswith("FusedBatchNorm"))
    np.testing.assert_array_equal(
        sd[f"backbone.FusedBatchNorm_{last}.var"].numpy(),
        variables["batch_stats"]["backbone"][f"FusedBatchNorm_{last}"][
            "var"])
    assert sd[f"backbone.FusedBatchNorm_{last}.var"].shape == (512,)


def test_whole_slice_matches_jax(variables, images):
    """uint8 batch -> Predictor -> DetectionEngine on the CPU, against the
    JAX eval forward (pool-only Pallas stem) + BatchedNMS engine on the
    same weights, float32: heads within 2e-3, every kept detection
    matched within 2e-3.  The port runs its default stem ("auto": the
    pool-only op, here its plain version)."""
    jcfg, cfg = cfg_pair(compute_dtype="float32", confidence_thresh=0.3,
                         **V2)
    jcfg = jcfg.replace(stem_backend="fused")
    model = jax_build_detector(jcfg)
    fwd = jax.jit(lambda x: model.apply(variables, _normalize_images(x),
                                        train=False))
    want_heads = fwd(jnp.asarray(images))
    want = JaxDetectionEngine(jcfg, fwd)(images)

    pred = predictor(cfg, variables)
    for g, w in zip(pred.predict(images), want_heads):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=FP32_ATOL,
                                   rtol=0)
    got = DetectionEngine(cfg, pred.predict, device="cpu")(images)
    assert len(got) == len(want) == len(images)
    total = 0
    for g, w in zip(got, want):
        pairs = match_rows(w, g, FP32_ATOL)
        assert len(pairs) >= 0.9 * max(len(g), len(w))
        for i, j in pairs:
            np.testing.assert_allclose(g[j], w[i], atol=FP32_ATOL, rtol=0)
        total += len(pairs)
    assert total > 0


@pytest.mark.parametrize("stem", ["auto", "fused", "xla"])
def test_stem_runs_the_pool_only_op(stem):
    """Eval and train stems: "auto"/"fused" go through the pool-only op
    (bf16, equal to its plain version), "xla" through max_pool_same in the
    compute dtype; the stem conv gets a finite, non-zero gradient."""
    backbone = ResNet18V2(dtype=torch.float32, stem_backend=stem,
                          generator=torch.Generator().manual_seed(3))
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        y = backbone.stem(x)
        net = backbone.eval().stem_conv_pool(x, backbone.stem)
    if stem == "xla":
        assert net.dtype == torch.float32
    else:
        assert torch.equal(net, max_pool_s2_eval(y))
        assert torch.equal(net, max_pool_s2_fwd(y)[0])
    s8, s16, s32 = backbone.train()(x)
    assert [t.shape[1] for t in (s8, s16, s32)] == [128, 256, 512]
    assert min(float(t.detach().min()) for t in (s8, s16, s32)) >= 0
    (s8.float().square().mean() + s32.float().square().mean()).backward()
    grad = backbone.stem.weight.grad
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
