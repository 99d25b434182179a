"""Shared building blocks for the model zoo (counterpart of
tpu_breath/models/layers.py), in NCHW.

BatchNorm trains as Flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5) does:
Flax's momentum 0.9 is PyTorch's 0.1, and Flax's running variance tracks
the *biased* batch variance where nn.BatchNorm2d stores the unbiased one.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over [B, C] or [B, C, H, W] with Flax's running statistics.

    Training normalises with the biased batch statistics (as both frameworks
    do) and updates running_mean = 0.9 * old + 0.1 * mean and running_var =
    0.9 * old + 0.1 * biased var. Keeps nn.BatchNorm2d's state_dict keys."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS,
                         momentum=1.0 - FLAX_MOMENTUM)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        old = self.running_var * FLAX_MOMENTUM
        # a copy: autograd keeps the tensor F.batch_norm updated
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        with torch.no_grad():
            # F.batch_norm folded in momentum * var * n / (n - 1); take the
            # Bessel factor back out of the new share
            self.running_var.copy_((var - old) * ((n - 1) / n) + old)
        return out


def _act_bn(x: torch.Tensor, bn: BatchNorm, order: str) -> torch.Tensor:
    if order == "relu_bn":
        return bn(torch.relu(x))
    return F.gelu(bn(x), approximate="none")


class ConvBlock(nn.Module):
    """Conv3x3 (padding 1, optional stride) then ReLU -> BN ("relu_bn",
    CNN8) or BN -> exact GELU ("bn_gelu", VGG)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 order: str = "relu_bn", use_bias: bool = True):
        super().__init__()
        if order not in ("relu_bn", "bn_gelu"):
            raise ValueError(order)
        self.order = order
        self.conv = nn.Conv2d(in_features, features, 3, stride=strides,
                              padding=1, bias=use_bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _act_bn(self.conv(x), self.bn, self.order)


class MLPBlock(nn.Module):
    """Linear then ReLU -> BN or BN -> exact GELU, then optional Dropout."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0,
                 order: str = "relu_bn", use_bias: bool = True):
        super().__init__()
        if order not in ("relu_bn", "bn_gelu"):
            raise ValueError(order)
        self.order = order
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        self.bn = BatchNorm(features)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(_act_bn(self.dense(x), self.bn, self.order))


def max_pool_2x2(x: torch.Tensor, ceil_mode: bool = False) -> torch.Tensor:
    """2x2 / stride-2 max pool; ceil_mode keeps the odd tail row/column."""
    return F.max_pool2d(x, 2, ceil_mode=ceil_mode)


class Classifier(nn.Module):
    """features [B, C, H, W], scalars [B, S] -> logits [B]: the subclass's
    _body (to the last hidden layer) and its Linear `head`.

    On CUDA the body runs under bf16 autocast (the JAX package's bf16
    activations) unless bf16 is False; the head always runs in f32.
    Elsewhere the body runs in the input's dtype, or as the caller's
    autocast says."""

    def __init__(self, bf16: bool = True):
        super().__init__()
        self.bf16 = bf16

    def _body(self, features: torch.Tensor, scalars: torch.Tensor
              ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, features: torch.Tensor, scalars: torch.Tensor
                ) -> torch.Tensor:
        dev = features.device.type
        with (torch.autocast("cuda", dtype=torch.bfloat16)
              if dev == "cuda" and self.bf16 else contextlib.nullcontext()):
            z = self._body(features, scalars)
        with torch.autocast(dev, enabled=False):
            return self.head(z.float()).squeeze(-1)


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
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model
