"""Move the JAX package's flax variables into the PyTorch port.

``import_flax(variables, model)`` takes the variable tree of the JAX
``YOLOv3Detector`` (``{"params": ..., "batch_stats": ...}``, nested dicts
of numpy arrays, e.g. ``jax.device_get(variables)``; JAX itself is never
imported here) and returns a state dict for the port's model.  The port's
modules carry flax's names, so the map is by name:

  * ``.../Conv_k/kernel`` (HWIO)           -> ``....Conv_k.weight`` (OIHW)
  * ``.../FusedBatchNorm_k/{scale,bias}``  -> ``....FusedBatchNorm_k.*``
  * ``batch_stats/.../{mean,var}``         -> the same module's buffers
  * ``head_out_{8,16,32}/{kernel,bias}``   -> ``head_out_*.{weight,bias}``

Every leaf must land on a tensor of ``model``'s state dict with the same
shape, and every tensor of the state dict must be covered: a missing or a
leftover leaf raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {("params", "kernel"): "weight",
               ("params", "scale"): "scale",
               ("params", "bias"): "bias",
               ("batch_stats", "mean"): "mean",
               ("batch_stats", "var"): "var"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def import_flax(variables: Mapping, model: nn.Module
                ) -> Dict[str, torch.Tensor]:
    """flax variable tree -> float32 state dict for ``model``."""
    expected = model.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            name = _LEAF_NAMES.get((collection, path[-1]))
            if name is None:
                raise KeyError(f"unmapped flax leaf "
                               f"{collection}/{'/'.join(path)}")
            key = ".".join(path[:-1] + (name,))
            arr = np.asarray(leaf, np.float32)
            if name == "weight":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if key not in expected:
                raise KeyError(f"leftover flax leaf "
                               f"{collection}/{'/'.join(path)} (no {key} "
                               "in the model)")
            if tuple(arr.shape) != tuple(expected[key].shape):
                raise ValueError(f"{key}: flax shape {arr.shape} vs model "
                                 f"{tuple(expected[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} model tensor(s) missing from the "
                       f"flax variables: {', '.join(missing[:8])}")
    return out
