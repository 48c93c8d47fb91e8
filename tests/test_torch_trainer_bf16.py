"""The training slice at the flagship's compute type: the port's
``YOLOv3Trainer`` against the JAX package's over 3 steps at bf16 (64x64,
class_num=2, batch 4, the kernel stem on both sides: the fused BN + pool +
relu of the flagship, the pool-only one of ResNet-18-v2), from the same
weights.  Tolerance: per-step total_loss within rtol 3e-2 (the bf16
stem-backend bound of tests/test_stem_pool.py); bf16 convolutions round
differently in XLA and PyTorch, so parameters are not compared here
(tests/test_torch_trainer.py compares them at float32)."""
import numpy as np
import pytest

from . import torch_threads  # noqa: F401
from .test_torch_trainer import run_pair


@pytest.mark.parametrize("backbone", ["resnet-18", "resnet-18-v2"])
def test_bf16_losses_follow_jax(backbone):
    jm_all, pm_all, counts, _, ps, _ = run_pair(compute_dtype="bfloat16",
                                                model_backbone=backbone)
    for step, (jm, pm) in enumerate(zip(jm_all, pm_all)):
        np.testing.assert_allclose(pm["total_loss"],
                                   np.asarray(jm["total_loss"]), rtol=3e-2,
                                   err_msg=f"step {step}")
    assert counts[-1][0] == counts[-1][1]
    stem = ps.model.backbone.Conv_0.weight  # the stem conv
    assert stem.grad is not None and np.isfinite(stem.grad.numpy()).all()
