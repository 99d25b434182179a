"""Device selection: the port's entry points run on the card unless the
caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """'cuda' demands a card (no silent CPU fallback); 'cpu' runs the plain
    versions of the kernels."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu / device='cpu' to run "
                           "on the CPU")
    return device
