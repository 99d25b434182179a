"""Shared building blocks for the model zoo (counterpart of
tpu_breath/models/layers.py), in NCHW.

BatchNorm: eps 1e-5 and running statistics in eval, as Flax's BatchNorm
(momentum 0.9 there is PyTorch's momentum 0.1; this port has no training
yet, so only eps matters).
"""
from __future__ import annotations

import math

import torch
from torch import nn

BN_EPS = 1e-5


class ConvBlock(nn.Module):
    """Conv3x3 (padding 1) -> ReLU -> BN, CNN8's order."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 3, padding=1)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(torch.relu(self.conv(x)))


class MLPBlock(nn.Module):
    """Linear -> ReLU -> BN -> optional Dropout."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS, momentum=0.1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.bn(torch.relu(self.dense(x))))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init from a torch.Generator: He-normal (fan-in) conv
    kernels, Xavier-uniform dense kernels, zero biases, BN scale 1 / bias 0
    / mean 0 / var 1 (tpu_breath/models/layers.py:23-24)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_in),
                                generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model
