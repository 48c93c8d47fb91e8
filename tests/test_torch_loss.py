"""The port's YOLOv3 loss (ops/loss.py, ops/labels.py) against the JAX
loss and the independent NumPy oracle tests/reference_loss.py, for the
flag cases of tests/test_loss.py that this slice ports (class_num 0 and
>= 1, focal, TIoU recall, label smoothing), plus the structural cases:
padding rows, the rectified counter's gating, empty images and extreme
logits.

Tolerances: total and breakdown within rtol 1e-5 of the JAX loss
(float32 sums in another order) and within the oracle bounds of
tests/test_loss.py (total rtol 2e-4; breakdown rtol 2e-3, atol 1e-5);
gradients within 1e-5 absolute of JAX's; the image counter exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.ops.labels import LabelDecoder as JaxLabels
from yolov3_tensorflow_tpu.ops.loss import YOLOv3Loss as JaxLoss
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.ops.labels import LabelDecoder, valid_mask
from yolov3_tensorflow_tpu_torch.ops.loss import YOLOv3Loss

from . import torch_threads  # noqa: F401
from .reference_loss import reference_loss

KEYS = ("rectified_coord_loss", "coord_loss_xy", "coord_loss_wh",
        "noobj_iou_loss", "obj_iou_loss", "class_loss")


def cfg_pair(**kw):
    base = dict(input_image_size=(32, 32, 3), max_boxes=3,
                anchor_boxes=(((0.2, 0.3), (0.5, 0.4)), ((0.3, 0.3),),
                              ((0.6, 0.7), (0.9, 0.8))))
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def random_heads(cfg, n, seed=0):
    """NHWC numpy heads (the JAX layout)."""
    rng = np.random.RandomState(seed)
    return [(0.5 * rng.randn(n, h, w, c)).astype(np.float32)
            for (h, w), c in zip(cfg.head_grid_sizes, cfg.head_channel_nums)]


def targets(n, m, rows):
    t = -np.ones((n, m, 5), np.float32)
    for (i, j), row in rows.items():
        t[i, j] = row
    return t


def port_loss(cfg, heads, t, count, grad=False):
    th = [torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2)))
          .requires_grad_(grad) for h in heads]
    total, bd, cnt = YOLOv3Loss(cfg, "cpu")(th, torch.from_numpy(t),
                                           torch.tensor(count))
    return th, total, bd, cnt


@pytest.mark.parametrize("class_num,focal,tiou,smooth", [
    (0, False, False, False), (3, False, False, False),
    (3, True, False, False), (0, False, True, False),
    (4, False, False, True)])
def test_matches_jax_and_numpy_oracle(class_num, focal, tiou, smooth):
    jcfg, cfg = cfg_pair(class_num=class_num, is_focal_loss=focal,
                         is_tiou_recall=tiou, is_label_smoothing=smooth,
                         rectified_coord_num=100)
    heads = random_heads(cfg, 2, seed=class_num + 10 * focal + 100 * tiou)
    t = targets(2, 3, {
        (0, 0): [0.5, 0.5, 0.25, 0.3, min(1, class_num and 1)],
        (0, 1): [0.2, 0.7, 0.1, 0.15, 0],
        (1, 0): [0.8, 0.3, 0.4, 0.5, min(2, max(0, class_num - 1))]})
    jloss = JaxLoss(jcfg)

    def jax_total(hs):
        total, bd, cnt = jloss(hs, jnp.asarray(t), jnp.asarray(0, jnp.int32))
        return total, (bd, cnt)

    (j_total, (j_bd, j_cnt)), j_grads = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))([jnp.asarray(h) for h in heads])
    th, total, bd, cnt = port_loss(cfg, heads, t, 0, grad=True)
    np.testing.assert_allclose(float(total.detach()), float(j_total),
                               rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(bd[k].detach().numpy(),
                                   np.asarray(j_bd[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert int(cnt) == int(j_cnt) == 2
    ref_total, ref_bd, ref_cnt = reference_loss(heads, t, jcfg,
                                                image_count=0)
    np.testing.assert_allclose(float(total.detach()), ref_total, rtol=2e-4)
    got = np.stack([bd[k].detach().numpy() for k in KEYS])
    np.testing.assert_allclose(got, ref_bd, rtol=2e-3, atol=1e-5)
    assert int(cnt) == ref_cnt
    total.backward()
    for g, jg in zip(th, j_grads):
        np.testing.assert_allclose(g.grad.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jg), atol=1e-5, rtol=0)


def test_labels_match_jax():
    jcfg, cfg = cfg_pair()
    t = targets(2, 3, {(0, 0): [0.5, 0.5, 0.25, 0.3, 1],
                       (1, 2): [0.1, 0.9, 0.2, 0.1, 0]})
    for (g, gb), (w, wb) in zip(LabelDecoder(cfg).decode(
            torch.from_numpy(t).reshape(2, 15)),
            JaxLabels(jcfg).decode(jnp.asarray(t))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(valid_mask(torch.from_numpy(t)).numpy(),
                                  [[1, 0, 0], [0, 0, 1]])


def test_padding_rows_do_not_matter():
    _, cfg = cfg_pair(max_boxes=5)
    heads = random_heads(cfg, 1)
    t1 = targets(1, 5, {(0, 0): [0.5, 0.5, 0.2, 0.2, 0]})
    t2 = t1.copy()
    t2[0, 3] = [-1, 0.9, 0.9, 0.9, 5]  # garbage that still reads padding
    _, l1, _, _ = port_loss(cfg, heads, t1, 10 ** 9)
    _, l2, _, _ = port_loss(cfg, heads, t2, 10 ** 9)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_rectified_counter_gating():
    _, cfg = cfg_pair(rectified_coord_num=3)
    heads = random_heads(cfg, 2)
    t = targets(2, 3, {(0, 0): [0.5, 0.5, 0.2, 0.2, 0]})
    for count, active, after in ((0, True, 2), (3, True, 5),
                                 (4, False, 4)):
        _, _, bd, cnt = port_loss(cfg, heads, t, count)
        assert (bd["rectified_coord_loss"].sum() > 0) == active
        assert int(cnt) == after


def test_empty_image_and_gradients_finite():
    _, cfg = cfg_pair()
    heads = random_heads(cfg, 2)
    t = -np.ones((2, 3, 5), np.float32)
    th, total, _, _ = port_loss(cfg, heads, t, 0, grad=True)
    total.backward()
    assert torch.isfinite(total)
    assert all(torch.isfinite(h.grad).all() for h in th)
    _, _, bd, _ = port_loss(cfg, heads, t, 10 ** 9)
    assert bd["coord_loss_xy"].sum() == 0 and bd["obj_iou_loss"].sum() == 0
    assert bd["noobj_iou_loss"].sum() > 0


@pytest.mark.parametrize("logit", [-120.0, 120.0])
def test_gradients_finite_at_extreme_logits(logit):
    """The noobj term drives score logits below -88, where the naive
    sigmoid's gradient is inf/inf (JAX tests/test_loss.py regression)."""
    _, cfg = cfg_pair(class_num=2)
    heads = [np.full((1, h, w, c), logit, np.float32)
             for (h, w), c in zip(cfg.head_grid_sizes,
                                  cfg.head_channel_nums)]
    t = targets(1, 3, {(0, 0): [0.5, 0.5, 0.2, 0.2, 1]})
    th, total, _, _ = port_loss(cfg, heads, t, 10 ** 9, grad=True)
    total.backward()
    assert torch.isfinite(total)
    assert all(torch.isfinite(h.grad).all() for h in th)


@pytest.mark.parametrize("flag", ["is_giou_loss", "is_gradient_harmonized",
                                  "is_gaussian_yolo"])
def test_unported_extensions_raise(flag):
    _, cfg = cfg_pair(**{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        YOLOv3Loss(cfg, "cpu")


def test_box_weights_raise():
    _, cfg = cfg_pair()
    heads = random_heads(cfg, 1)
    t = targets(1, 3, {(0, 0): [0.5, 0.5, 0.2, 0.2, 0]})
    th = [torch.from_numpy(h).permute(0, 3, 1, 2) for h in heads]
    with pytest.raises(NotImplementedError, match="box_weights"):
        YOLOv3Loss(cfg, "cpu")(th, torch.from_numpy(t), torch.tensor(0),
                               box_weights=torch.ones(1, 3))
