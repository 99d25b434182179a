"""Architecture registry (counterpart of tpu_breath/models/registry.py)."""
from __future__ import annotations

import torch

from tpu_breath_torch.models.cnn8 import CNN8
from tpu_breath_torch.models.layers import init_weights
from tpu_breath_torch.models.vgg import VGG

ARCHS = {"cnn8": CNN8, "vgg": VGG}


def build(arch: str, num_scalar_features: int, seed: int = 0, **kwargs):
    """A seeded-init model of the named architecture (init on the CPU from
    torch.Generator(seed), so the weights do not depend on the device).
    kwargs (dropout_rate, bf16) go to the model's constructor."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    model = ARCHS[arch](num_scalar_features=num_scalar_features, **kwargs)
    return init_weights(model, torch.Generator().manual_seed(seed))
