"""The port's optimizers and lr schedule (train/optimizers.py,
train/schedule.py) against the JAX package's optax chains
(train/optimizers.py make_optimizer) over 10 steps that cross lr
boundaries, from the same parameters and the same gradients.

Tolerance: parameters within rtol 1e-5 and atol 1e-7 of optax's after
every step (float32 element-wise arithmetic in the same order; the
per-step scalars such as b^t and rho_t may differ in their last ulp).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.train.optimizers import \
    make_optimizer as jax_make_optimizer
from yolov3_tensorflow_tpu.train.schedule import \
    piecewise_epoch_schedule as jax_schedule
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.train.optimizers import (make_optimizer,
                                                          radam_coefficient)
from yolov3_tensorflow_tpu_torch.train.schedule import \
    piecewise_epoch_schedule

from . import torch_threads  # noqa: F401

# epochs of 2 steps: lr 1e-3 (steps 0-3), 1e-2 (4-5), 2e-3 (6-)
SCHEDULE = dict(step_epoch=(1, 2), step_lr=(1e-3, 1e-2, 2e-3))
SPE = 2


def run_both(name, clip=None, steps=10, seed=0):
    kw = dict(optimizer=name, grad_clip_norm=clip, **SCHEDULE)
    tx, _ = jax_make_optimizer(JaxConfig(**kw), steps_per_epoch=SPE)
    rng = np.random.RandomState(seed)
    shapes = {"w": (3, 4), "b": (5,), "s": (1,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
               for k in shapes]
    opt, sched = make_optimizer(Config(**kw), tparams, steps_per_epoch=SPE)
    lrs = []
    for _ in range(steps):
        grads = {k: (rng.randn(*s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(grads[k])
        lrs.append(sched(opt.count))
        opt.step()
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")
    return lrs


@pytest.mark.parametrize("name", ["radam", "adam", "sgdm"])
def test_optimizer_matches_optax_across_lr_boundaries(name):
    lrs = run_both(name)
    assert sorted(set(lrs)) == sorted(float(np.float32(v))
                                      for v in SCHEDULE["step_lr"])


@pytest.mark.parametrize("name", ["radam", "sgdm"])
def test_global_norm_clipping_matches_optax(name):
    run_both(name, clip=2.0, seed=1)


def test_radam_crosses_from_warmup_to_adaptive():
    flags = [radam_coefficient(t)[0] for t in range(1, 12)]
    assert not flags[0] and flags[-1]  # rho_1 < 5, rho_11 >= 5
    assert flags == sorted(flags)


def test_schedule_matches_jax():
    kw = dict(step_epoch=(20, 60, 80), step_lr=(1e-5, 1e-3, 1e-4, 1e-6))
    ours = piecewise_epoch_schedule(**kw, steps_per_epoch=7)
    theirs = jax_schedule(**kw, steps_per_epoch=7)
    for step in (0, 6, 7, 140, 146, 147, 420, 560, 567, 10 ** 5):
        assert ours(step) == float(theirs(step)), step


def test_unported_options_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="grad_accum_steps"):
        make_optimizer(Config(grad_accum_steps=2), p)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(Config(optimizer="lamb"), p)
