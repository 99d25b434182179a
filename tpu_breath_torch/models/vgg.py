"""VGG-style classifier with a 1x1-conv residual on the last block
(counterpart of tpu_breath/models/vgg.py, ~8.15M params).

Four 3-conv blocks (64, 128, 256, 512) of bias-free Conv -> BN -> exact
GELU; block 1 downsamples with a stride-2 last conv, blocks 2-3 with
ceil-mode max pooling; channel dropout after blocks 1 (rate/2) and 2-4;
block 4 adds a 1x1-conv + BN residual from block 3's output, summed in f32;
bias-free scalar MLP S->64->64 and classifier (512+64)->256->128; f32 head.
"""
from __future__ import annotations

import torch
from torch import nn

from tpu_breath_torch.models.layers import (BatchNorm, Classifier, ConvBlock,
                                            Dropout2d, MLPBlock,
                                            global_avg_pool, max_pool_2x2)

IN_CHANNELS = 9
WIDTHS = (64, 128, 256, 512)
CONVS_PER_BLOCK = 3
DROPOUT = 0.2


class VGG(Classifier):
    """features [B, C, H, W], scalars [B, S] -> logits [B] (bf16 body on
    CUDA, f32 head: see Classifier)."""

    def __init__(self, num_scalar_features: int = 36,
                 dropout_rate: float = DROPOUT, bf16: bool = True):
        super().__init__(bf16)
        d = dropout_rate
        convs, cin = [], IN_CHANNELS
        for b, width in enumerate(WIDTHS):
            for i in range(CONVS_PER_BLOCK):
                last = i == CONVS_PER_BLOCK - 1
                stride = 2 if (b == 0 and last) else 1
                convs.append(ConvBlock(cin, width, stride, order="bn_gelu",
                                       use_bias=False))
                cin = width
        self.convs = nn.ModuleList(convs)
        self.drop_half = Dropout2d(d * 0.5)
        self.drop = Dropout2d(d)
        self.res_conv = nn.Conv2d(WIDTHS[2], WIDTHS[3], 1, bias=False)
        self.res_bn = BatchNorm(WIDTHS[3])
        self.scalar_mlp = nn.ModuleList([
            MLPBlock(num_scalar_features, 64, d, "bn_gelu", use_bias=False),
            MLPBlock(64, 64, 0.0, "bn_gelu", use_bias=False)])
        self.classifier = nn.ModuleList([
            MLPBlock(WIDTHS[3] + 64, 256, d, "bn_gelu", use_bias=False),
            MLPBlock(256, 128, d, "bn_gelu", use_bias=False)])
        self.head = nn.Linear(128, 1)

    def _block(self, x: torch.Tensor, b: int) -> torch.Tensor:
        for conv in self.convs[b * CONVS_PER_BLOCK:(b + 1) * CONVS_PER_BLOCK]:
            x = conv(x)
        return x

    def _body(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        x = self.drop_half(self._block(x, 0))
        x = self.drop(max_pool_2x2(self._block(x, 1), ceil_mode=True))
        x = self.drop(max_pool_2x2(self._block(x, 2), ceil_mode=True))
        # the 1x1 conv in the body's dtype, its BatchNorm in f32 (Flax's
        # dtype=float32): the residual enters the f32 sum unrounded
        residual = self.res_conv(x)
        with torch.autocast(x.device.type, enabled=False):
            residual = self.res_bn(residual.float())
        main = self.drop(self._block(x, 3))
        x = global_avg_pool((main.float() + residual).to(main.dtype))
        for block in self.scalar_mlp:
            s = block(s)
        z = torch.cat([x, s.to(x.dtype)], dim=-1)
        for block in self.classifier:
            z = block(z)
        return z
