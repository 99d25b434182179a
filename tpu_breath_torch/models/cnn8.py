"""CNN8: 8-conv audio classifier with a scalar-descriptor side branch
(counterpart of tpu_breath/models/cnn8.py, ~2.43M params).

Conv widths 32-64-128-128-256x4 with Conv->ReLU->BN, 2x2 max pool (floor
mode) after convs 2 and 4, channel dropout after conv 4, global average
pooling; scalar MLP S->64->64; classifier (256+64)->256->128->1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_breath_torch.models.layers import ConvBlock, MLPBlock

IN_CHANNELS = 9
WIDTHS = (32, 64, 128, 128, 256, 256, 256, 256)
POOL_AFTER = (1, 3)
DROP_AFTER = 3
DROPOUT = 0.3


class CNN8(nn.Module):
    """features [B, C, H, W], scalars [B, S] -> logits [B].

    On CUDA the body runs under bf16 autocast (the JAX package's bf16
    activations); the last Linear always runs in f32. Elsewhere it runs in
    the input's dtype."""

    def __init__(self, num_scalar_features: int = 36):
        super().__init__()
        ins = (IN_CHANNELS,) + WIDTHS[:-1]
        self.convs = nn.ModuleList(ConvBlock(i, o) for i, o in zip(ins, WIDTHS))
        self.channel_dropout = nn.Dropout2d(DROPOUT)
        self.scalar_mlp = nn.ModuleList([
            MLPBlock(num_scalar_features, 64, DROPOUT), MLPBlock(64, 64)])
        self.classifier = nn.ModuleList([
            MLPBlock(WIDTHS[-1] + 64, 256, DROPOUT), MLPBlock(256, 128)])
        self.head = nn.Linear(128, 1)

    def _body(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.convs):
            x = block(x)
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 2)
            if i == DROP_AFTER:
                x = self.channel_dropout(x)
        x = x.mean(dim=(2, 3))
        for block in self.scalar_mlp:
            s = block(s)
        z = torch.cat([x, s.to(x.dtype)], dim=-1)
        for block in self.classifier:
            z = block(z)
        return z

    def forward(self, features: torch.Tensor, scalars: torch.Tensor
                ) -> torch.Tensor:
        dev = features.device.type
        if dev == "cuda":
            with torch.autocast("cuda", dtype=torch.bfloat16):
                z = self._body(features, scalars)
        else:
            z = self._body(features, scalars)
        with torch.autocast(dev, enabled=False):
            return self.head(z.float()).squeeze(-1)
