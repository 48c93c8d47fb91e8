"""Model forward of the serving path (JAX package: train/trainer.py
``_normalize_images`` and ``YOLOv3Trainer.predict``): uint8 NHWC batch
-> normalized NCHW float -> eval forward -> raw heads."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.detector import build_detector


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> contiguous NCHW float32; integer batches are scaled
    by 1/255 (the reference's convert_image_dtype, file_util.py:58).  The
    whole forward runs in the contiguous NCHW format (a permuted view
    would carry channels-last strides into every conv)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    if not torch.is_floating_point(x):
        return x.float() * (1.0 / 255.0)
    return x.float()


class Predictor:
    """``Predictor(cfg, state_dict, device).predict(uint8 batch)`` ->
    (p8, p16, p32) raw heads, NCHW float32 on ``device``: the forward of
    the JAX trainer's ``predict``, without int8 quantization or mesh
    padding."""

    def __init__(self, cfg: Config, state_dict, device="cuda"):
        if cfg.quant != "none":
            raise NotImplementedError(
                f"quant={cfg.quant!r} is not ported yet (ROADMAP Queue 1, "
                "int8 PTQ inference)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_detector(cfg, self.device)
        self.model.load_state_dict(state_dict, strict=True)

    @torch.inference_mode()
    def predict(self, images) -> tuple:
        """images: (N, H, W, 3) uint8, numpy or tensor."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(self.device, non_blocking=True)
        return self.model(normalize_images(images))
