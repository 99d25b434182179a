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

from tpu_breath_torch.models.layers import (Classifier, ConvBlock, Dropout2d,
                                            MLPBlock, global_avg_pool)

IN_CHANNELS = 9
WIDTHS = (32, 64, 128, 128, 256, 256, 256, 256)
POOL_AFTER = (1, 3)
DROP_AFTER = 3
DROPOUT = 0.3


class CNN8(Classifier):
    """features [B, C, H, W], scalars [B, S] -> logits [B] (bf16 body on
    CUDA, f32 head: see Classifier)."""

    def __init__(self, num_scalar_features: int = 36,
                 dropout_rate: float = DROPOUT, bf16: bool = True):
        super().__init__(bf16)
        d = dropout_rate
        ins = (IN_CHANNELS,) + WIDTHS[:-1]
        self.convs = nn.ModuleList(ConvBlock(i, o) for i, o in zip(ins, WIDTHS))
        self.channel_dropout = Dropout2d(d)
        self.scalar_mlp = nn.ModuleList([
            MLPBlock(num_scalar_features, 64, d), MLPBlock(64, 64)])
        self.classifier = nn.ModuleList([
            MLPBlock(WIDTHS[-1] + 64, 256, d), MLPBlock(256, 128)])
        self.head = nn.Linear(128, 1)

    def _body(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.convs):
            x = block(x)
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 2)
            if i == DROP_AFTER:
                x = self.channel_dropout(x)
        x = global_avg_pool(x)
        for block in self.scalar_mlp:
            s = block(s)
        z = torch.cat([x, s.to(x.dtype)], dim=-1)
        for block in self.classifier:
            z = block(z)
        return z
