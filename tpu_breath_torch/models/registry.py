"""Architecture registry (counterpart of tpu_breath/models/registry.py).
Only cnn8 is ported so far."""
from __future__ import annotations

import torch

from tpu_breath_torch.models.cnn8 import CNN8
from tpu_breath_torch.models.layers import init_weights

ARCHS = {"cnn8": CNN8}


def build(arch: str, num_scalar_features: int, seed: int = 0):
    """A seeded-init model of the named architecture (init on the CPU from
    torch.Generator(seed), so the weights do not depend on the device)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    model = ARCHS[arch](num_scalar_features=num_scalar_features)
    return init_weights(model, torch.Generator().manual_seed(seed))
