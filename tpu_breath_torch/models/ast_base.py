"""The Audio Spectrogram Transformer (Gong, Chung and Glass, Interspeech
2021, arXiv:2104.01778; github.com/YuanGongND/ast src/models/ast_models.py
at model_size 'base384', which is timm's vit_deit_base_distilled_patch16_384,
DeiT-B distilled) on the system's feature stack, ~86.88M params at the
published widths.

features [B, 9, 128, 63] -> Conv2d(9 -> 768, 16 x 16, stride (10, 10),
bias), unpadded as AST's, so frames 56-62 are not read -> 12 x 5 = 60
patch tokens; the class and distillation tokens in front, a learned
position embedding; 12 pre-LN blocks x + Attn(LN x), x + MLP(LN x)
(LayerNorm eps 1e-6; 12 heads of 64, Q K V from one Linear split as
timm's reshape(B, N, 3, 12, 64), softmax(Q K^T / 8) V; MLP 768 -> 3072 ->
exact GELU -> 768); LN, the mean of the two leading tokens, LN, and the
f32 Linear head to one logit. Dropout and drop-path are 0, AST's
defaults. The scalars are taken and not used: AST has no scalar path.
State-dict names are timm's without AST's `v.` prefix.

On the card the body runs under bf16 autocast (Classifier): the residual
stream stays f32 (LayerNorm and the adds promote), the GEMMs run in bf16,
and attention runs on the SDPA backend pinned in CUDA_BACKEND, which
raises on a call it cannot take instead of falling back. On the CPU
attention takes SDPA's math path. The features come in
channels-last on the card, which makes the patch tokens' flatten and
transpose a view.

Spans (utils/profiling.py): ast.embed, ast.attention (the SDPA call
alone), ast.mlp and ast.head, the null context unless something records.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from tpu_breath_torch.models.layers import Classifier
from tpu_breath_torch.utils import profiling

IN_CHANNELS = 9
INPUT_SIZE = (128, 63)  # mel bins x frames of the system's stack
EMBED_DIM = 768
DEPTH = 12
NUM_HEADS = 12
MLP_DIM = 3072
PATCH = 16
STRIDES = (10, 10)  # AST's fstride, tstride
# 12 x 5 patches of the unpadded convolution and the two leading tokens
TOKENS = ((INPUT_SIZE[0] - PATCH) // STRIDES[0] + 1) * (
    (INPUT_SIZE[1] - PATCH) // STRIDES[1] + 1) + 2
LN_EPS = 1e-6

# the SDPA backend attention takes on the card: memory-efficient attention
# (CUTLASS) ran a bf16 training call at the cell's shapes in 0.87 ms
# against cuDNN's 1.02 and flash's 1.40 on an H100 (utils/sdpa_times.py);
# it also takes the f32 of --f32
CUDA_BACKEND = SDPBackend.EFFICIENT_ATTENTION


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of [B, H, N, d] tensors on the one
    backend pinned for q's device: a call it cannot take raises (no
    fallback)."""
    backend = CUDA_BACKEND if q.device.type == "cuda" else SDPBackend.MATH
    with profiling.span("ast.attention"), sdpa_kernel(backend):
        return F.scaled_dot_product_attention(q, k, v)


class PatchEmbed(nn.Module):
    """[B, 9, 128, 63] -> patch tokens [B, 60, D] by one strided
    convolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(IN_CHANNELS, dim, PATCH, stride=STRIDES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads
                                      ).permute(2, 0, 3, 1, 4).unbind(0)
        o = attend(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("ast.mlp"):
            return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    """Pre-LN: x + Attn(LN1 x), then x + MLP(LN2 x)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AST(Classifier):
    """features [B, C, H, W], scalars [B, S] (unused) -> logits [B] (bf16
    body on CUDA, f32 head: see Classifier). The defaults are the published
    widths; smaller widths are for tests. The patching and the input are
    the system's and AST's alone."""

    # drawn by layers.init_weights: truncated normal, std 0.02 (timm's)
    TRUNC_NORMAL = ("cls_token", "dist_token", "pos_embed")

    def __init__(self, num_scalar_features: int = 36, bf16: bool = True,
                 embed_dim: int = EMBED_DIM, depth: int = DEPTH,
                 num_heads: int = NUM_HEADS, mlp_dim: int = MLP_DIM):
        super().__init__(bf16)
        self.patch_embed = PatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, TOKENS, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_dim)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, 1)

    def _body(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        with profiling.span("ast.embed"):
            x = self.patch_embed(x)
            lead = torch.cat([self.cls_token, self.dist_token], dim=1)
            # the cat promotes bf16 patch tokens to the f32 stream
            x = torch.cat([lead.expand(x.shape[0], -1, -1), x], dim=1
                          ) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        with profiling.span("ast.head"):
            x = self.norm(x)
            return self.head_norm((x[:, 0] + x[:, 1]) / 2)
