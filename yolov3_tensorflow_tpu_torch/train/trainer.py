"""Train step of the PyTorch port (reference: yolov3/trainer.py:19-185;
JAX package: train/trainer.py, trimmed to the step and its parts).

``YOLOv3Trainer(cfg, device=...).train_step(state, images_u8, labels)``
runs what the JAX package's jitted step runs (trainer.py:264-351):
normalize or augment on the device -> train forward (train-mode BatchNorm,
the fused stem's train kernels) -> YOLOv3 loss + explicit L2 -> backward
-> optimizer update, and returns the next state and the step's metrics.
The metrics stay device tensors (the lr is a host float): nothing in the
step reads a value back, so the host never waits for the card inside it.

Left for later slices, each raising when its knob asks for it rather than
being ignored (ROADMAP Queue 1): EMA, ``freeze_backbone``, mixup,
gradient accumulation, transfer init, checkpointing, the epoch loop,
validation, TensorBoard and multi-scale steps.  ``conv_backend=
"winograd"`` runs the backbone's fused Winograd chain where the JAX
package's shape rules admit it (models/resnet18.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import Config
from ..data.augment import augment_batch, augment_batch_fused
from ..device import resolve_device
from ..infer.predict import normalize_images
from ..models.detector import COMPUTE_DTYPES, build_detector
from ..models.layers import l2_regularization
from ..ops.loss import YOLOv3Loss
from .optimizers import make_optimizer
from .state import TrainState

AUGMENT_BACKENDS = ("auto", "fused", "xla")
# augment_backend="auto" on the card: the backend that won the A/B of
# the flagship step (chip_smoke.py train phase, PERF.md)
AUTO_AUGMENT_BACKEND = "fused"


def _refuse_deferred(cfg: Config) -> None:
    """Raise for every train knob whose feature this slice does not run."""
    deferred = [
        (cfg.ema_decay, "EMA of the weights (ema_decay)"),
        (cfg.freeze_backbone, "freeze_backbone"),
        (cfg.is_mixup, "mixup (is_mixup)"),
        (max(1, int(cfg.grad_accum_steps)) > 1,
         "gradient accumulation (grad_accum_steps > 1)"),
        (cfg.init_from, "transfer init (init_from)"),
        (cfg.multi_scale_sizes, "multi-scale training (multi_scale_sizes)"),
        (cfg.spatial_partition > 1, "spatial_partition > 1"),
    ]
    for asked, what in deferred:
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch trainer yet "
                "(ROADMAP Queue 1, item 6)")
    if cfg.augment_backend not in AUGMENT_BACKENDS:
        raise ValueError(f"unknown augment_backend {cfg.augment_backend!r}"
                         f" (choose from {', '.join(AUGMENT_BACKENDS)})")


class YOLOv3Trainer:
    """Builds the detector, the loss, the optimizer and the train state on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``state_dict``: start from these weights (for example a JAX state
    through ``tools.import_flax``) instead of the seeded initialization."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 800,
                 state_dict: Optional[dict] = None):
        _refuse_deferred(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        model = build_detector(cfg, self.device,
                               generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        model.train()
        self.loss_fn = YOLOv3Loss(cfg, self.device)
        optimizer, self.schedule = make_optimizer(cfg, model.parameters())
        # the augmentation stream, on the device that draws it
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.state = TrainState(
            step=0, model=model, optimizer=optimizer,
            image_count=torch.zeros((), dtype=torch.int64,
                                    device=self.device),
            aug_generator=gen)

    # ------------------------------------------------------------------ #
    def augment_backend(self) -> str:
        """The noise backend the step runs: "fused" (the kernel) or "xla"
        (generator-drawn noise), with "auto" resolved."""
        b = self.cfg.augment_backend
        return AUTO_AUGMENT_BACKEND if b == "auto" else b

    def _as_device(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, non_blocking=True)

    def _inputs(self, state: TrainState, images):
        """NHWC batch -> the model's NCHW input: normalized, and augmented
        on the device when ``cfg.is_augment``."""
        h, w, _ = self.cfg.input_image_size
        if tuple(images.shape[1:3]) != (h, w):
            raise ValueError(f"batch of size {tuple(images.shape[1:3])}, "
                             f"config input {(h, w)} (multi-scale steps are "
                             "not ported yet)")
        if not self.cfg.is_augment:
            return normalize_images(images)
        if self.augment_backend() == "fused":
            if images.dtype != torch.uint8:
                raise ValueError("augment_backend='fused' takes a uint8 "
                                 f"batch, got {images.dtype}")
            return augment_batch_fused(state.aug_generator, images,
                                       self.dtype)
        return augment_batch(state.aug_generator,
                             normalize_images(images).to(self.dtype))

    def train_step(self, state: TrainState, images, labels):
        """One optimizer step on a (N, H, W, 3) batch (uint8 as the
        loader ships it, or float in [0, 1]) and (N, M, 5) labels.
        Returns (state, metrics); the model and optimizer are updated in
        place and the returned state names them."""
        model = state.model
        model.train()
        # the named ranges are what tools/profile_train.py reads; they
        # cost nothing while no profiler runs
        with record_function("train.inputs"):
            images = self._as_device(images)
            labels = self._as_device(labels).float()
            x = self._inputs(state, images)
        with record_function("train.forward"):
            heads = model(x)
        with record_function("train.loss"):
            total, breakdown, new_count = self.loss_fn(heads, labels,
                                                       state.image_count)
            kreg, greg = l2_regularization(model)
            full = total + kreg + greg
        with record_function("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            full.backward()
        with record_function("train.optimizer"):
            state.optimizer.step()
        metrics = {k: v.detach() for k, v in breakdown.items()}
        metrics.update(total_loss=full.detach(), kernel_reg=kreg.detach(),
                       gamma_reg=greg.detach(),
                       lr=self.schedule(state.step))
        state.step += 1
        state.image_count = new_count
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, labels):
        """Loss of the eval-mode model (running-average BatchNorm), L2
        terms included as in Keras' val_loss (trainer.py:353-367)."""
        model = state.model
        model.eval()
        heads = model(normalize_images(self._as_device(images)))
        total, breakdown, _ = self.loss_fn(
            heads, self._as_device(labels).float(), state.image_count)
        kreg, greg = l2_regularization(model)
        metrics = dict(breakdown)
        metrics["total_loss"] = total + kreg + greg
        return metrics

    @torch.no_grad()
    def forward(self, state: TrainState, images):
        """Eval-mode raw heads (p8, p16, p32), NCHW float32."""
        model = state.model
        model.eval()
        return model(normalize_images(self._as_device(images)))
