"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device.  The entry points default to CUDA and
    run on the CPU only when the caller asks for it; a CUDA device on a
    machine without one is an error, never a silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on an NVIDIA GPU "
            "and uses the CPU only when asked (pass device='cpu')")
    return device
