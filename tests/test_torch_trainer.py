"""The training slice as a whole: the port's ``YOLOv3Trainer`` against
the JAX package's on the CPU, from the same weights (moved across by
tools/import_flax), over 3 steps (64x64, class_num=2, float32, batch 4,
RAdam on the default schedule, augmentation off) of the flagship with the
fused stem on both sides (the JAX Pallas kernels in interpret mode, the
port's plain versions) and of ResNet-18-v2 with the plain stem on both
sides, with the rectified coord loss active for the first 2 steps so the
image counters are compared too.

Tolerances: per-step total_loss and every breakdown term within rtol
1e-4; parameters and BatchNorm running averages after 3 steps within
atol 1e-5 + rtol 1e-4; the 3-step weight change of every conv within 1%
of JAX's (relative L2), 2% for ResNet-18-v2; image_count exact.

Why v2 runs the plain stem here: a kernel stem casts the conv output to
bf16 even at float32, and where an input lands on a bf16 rounding
boundary, a last-bit difference between XLA's and PyTorch's convolutions
moves a pooled value by one bf16 step.  Over 3 steps that grows
(measured on v2: 0.08, 0.91 and 5.2 times the parameter tolerance after
steps 1, 2 and 3; the port against itself from weights perturbed by 1e-7
relative: 1.4-7.9 times on v2 and 2.5-35 on the flagship).  The plain
stem keeps float32 end to end (0.74 times after 3 steps).  The v2 kernel
stem is held against JAX op by op (tests/test_torch_max_pool.py) and
through this trainer at bf16 (tests/test_torch_trainer_bf16.py).  The
wider v2 bound on the weight change: the heads' one-step weight changes
agree within 8e-5 on both backbones, and the backward amplifies that
loss-gradient difference on its way to the stem (one-step changes of the
backbone convs differ by up to 0.57% on the flagship and 1.2% on v2,
whose pre-activation blocks and tap BNs put more BatchNorms with
16-element channels in the path).
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.train.trainer import YOLOv3Trainer as JaxTrainer
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.models.detector import build_detector
from yolov3_tensorflow_tpu_torch.ops.augment_noise import noisy_normalize
from yolov3_tensorflow_tpu_torch.tools.import_flax import import_flax
from yolov3_tensorflow_tpu_torch.train.trainer import YOLOv3Trainer

from . import torch_threads  # noqa: F401

N, STEPS = 4, 3
# bound on the relative L2 gap of each conv's 3-step weight change
# (by backbone class)
DELTA_RTOL = {"ResNet18": 1e-2, "ResNet18V2": 2e-2}
KEYS = ("rectified_coord_loss", "coord_loss_xy", "coord_loss_wh",
        "noobj_iou_loss", "obj_iou_loss", "class_loss", "kernel_reg",
        "gamma_reg", "total_loss")


def settings(**kw):
    base = dict(input_image_size=(64, 64, 3), batch_size=N, max_boxes=4,
                class_num=2, is_augment=False, compute_dtype="float32",
                stem_backend="fused", rectified_coord_num=N)
    base.update(kw)
    return base


def batch(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (N, 64, 64, 3)).astype(np.uint8)
    labels = -np.ones((N, 4, 5), np.float32)
    labels[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    labels[: N // 2, 1] = [0.2, 0.3, 0.1, 0.2, 0]
    return images, labels


def jax_state_dict(state, model):
    return import_flax({"params": jax.device_get(state.params),
                        "batch_stats": jax.device_get(state.batch_stats)},
                       model)


def run_pair(**kw):
    """(per-step JAX metrics, per-step port metrics, JAX trainer, JAX
    state, port state, start weights) after STEPS steps on one batch."""
    jt = JaxTrainer(JaxConfig(num_devices=1, **settings(**kw)),
                    restore=False, checkpoint_dir=tempfile.mkdtemp())
    cfg = Config(**settings(**kw))
    start = jax_state_dict(jt.state, build_detector(cfg, "cpu"))
    pt = YOLOv3Trainer(cfg, "cpu", state_dict=start)
    images, labels = batch()
    # the state on the trainer's mesh, as every step returns it: the first
    # step then compiles the program the later ones reuse (from the
    # uncommitted init state it compiles it twice; the steps' bits are
    # the same either way)
    js = jax.device_put(jt.state, NamedSharding(jt.mesh, PartitionSpec()))
    ps = pt.state
    jm_all, pm_all, counts = [], [], []
    for _ in range(STEPS):
        js, jm = jt.train_step(js, jnp.asarray(images), jnp.asarray(labels))
        ps, pm = pt.train_step(ps, images, labels)
        jm_all.append(jax.device_get(jm))
        pm_all.append({k: v.numpy() if torch.is_tensor(v) else v
                       for k, v in pm.items()})
        counts.append((int(js.image_count), int(ps.image_count)))
    return jm_all, pm_all, counts, js, ps, start


@pytest.fixture(scope="module", params=[
    dict(model_backbone="resnet-18"),
    dict(model_backbone="resnet-18-v2", stem_backend="xla")],
    ids=["resnet-18", "resnet-18-v2"])
def fp32_run(request):
    return run_pair(**request.param)


def test_losses_follow_jax(fp32_run):
    jm_all, pm_all, _, _, _, _ = fp32_run
    for step, (jm, pm) in enumerate(zip(jm_all, pm_all)):
        for k in KEYS:
            np.testing.assert_allclose(pm[k], np.asarray(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        assert pm["lr"] == float(jm["lr"])
    totals = [float(m["total_loss"]) for m in pm_all]
    assert totals[-1] < totals[0]
    assert np.asarray(pm_all[0]["rectified_coord_loss"]).sum() > 0
    assert np.asarray(pm_all[-1]["rectified_coord_loss"]).sum() == 0


def test_image_count_follows_jax(fp32_run):
    _, _, counts, _, _, _ = fp32_run
    assert counts == [(N, N), (2 * N, 2 * N), (2 * N, 2 * N)]


def test_parameters_and_batch_stats_follow_jax(fp32_run):
    _, _, _, js, ps, start = fp32_run
    want = jax_state_dict(js, ps.model)
    got = ps.model.state_dict()
    moved = 0
    for key, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=key)
        if key.endswith("weight"):
            d_port = t - start[key]
            d_jax = want[key] - start[key]
            norm = float(d_jax.norm())
            assert norm > 0, key
            assert float((d_port - d_jax).norm()) <= \
                DELTA_RTOL[type(ps.model.backbone).__name__] * norm, key
            moved += 1
    assert moved == 31  # every conv of the detector


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_augmented_steps_run_on_the_cpu(backend):
    """An augmented train step runs on the CPU with either noise backend
    (the fused one through the kernel's plain version), finite and in
    step with the state."""
    cfg = Config(**settings(is_augment=True, augment_backend=backend,
                            compute_dtype="bfloat16"))
    tr = YOLOv3Trainer(cfg, "cpu")
    images, labels = batch(seed=1)
    launches = noisy_normalize.launches
    state = tr.state
    for _ in range(2):
        state, metrics = tr.train_step(state, images, labels)
        assert torch.isfinite(metrics["total_loss"])
        assert metrics["total_loss"].device.type == "cpu"
    assert state.step == 2 and int(state.image_count) == 2 * N
    assert noisy_normalize.launches == launches  # no kernel on the CPU
    assert tr.augment_backend() == backend
    heads = tr.forward(state, images)
    assert [tuple(h.shape) for h in heads] == [
        (N, c, h, w) for c, (h, w) in zip(cfg.head_channel_nums,
                                          cfg.head_grid_sizes)]
    val = tr.eval_step(state, images, labels)
    assert torch.isfinite(val["total_loss"])
