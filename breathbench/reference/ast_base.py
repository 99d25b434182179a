"""The Audio Spectrogram Transformer in plain float32 (Gong, Chung and
Glass, Interspeech 2021, arXiv:2104.01778; github.com/YuanGongND/ast
src/models/ast_models.py, ASTModel at model_size 'base384', which is timm's
vit_deit_base_distilled_patch16_384): a bias-carrying Conv2d of patch x
patch at strides (fstride, tstride), unpadded, to embed_dim, its grid
flattened to tokens; the class and distillation tokens in front and the
position embedding added; depth pre-LN blocks x + Attn(LN1 x), x +
MLP(LN2 x) with LayerNorm eps 1e-6, Q K V from one Linear split as timm's
reshape(B, N, 3, heads, head_dim), softmax(Q K^T / sqrt(head_dim)) V
written out (two matmuls and a softmax), its heads joined and projected,
MLP fc1 -> exact (erf) GELU -> fc2; then LN, the mean of the class and
distillation tokens, LN, and a Linear head to one logit. Every matmul,
the attention's two included, goes through the numerics' rounder q.
Sizes from the configuration's "model" object; parameter names are the
port's state_dict names (timm's without AST's `v.` prefix).

Departures from AST, as the configuration's `assumed` and `reduced` list
them: 9 input channels (the system's stack) for AST's 1 mel channel; one
logit for the 35 classes of its Speech Commands recipe; weights seeded,
not ImageNet-pretrained DeiT; 63 frames at hop 256 (12 x 5 patches, 62
tokens) for the recipe's 128 at hop 160 (146 tokens), the unpadded patch
convolution leaving frames 56-62 unread as AST's leaves a tail; the
scalars taken and not used (AST has no scalar path). Dropout and
drop-path are 0, AST's defaults, so `drop` draws nothing; with no
BatchNorm, train "calibrate" is the evaluation forward."""
from __future__ import annotations

import math

import torch

from breathbench.reference.layers import conv, linear

LN_EPS = 1e-6


def _ln(name: str, d: int) -> list:
    # LayerNorm's scale and shift drawn as BatchNorm's (data.weights)
    return [(f"{name}.weight", (d,), "bn_weight"),
            (f"{name}.bias", (d,), "bn_bias")]


def _dense(name: str, n_out: int, n_in: int) -> list:
    return [(f"{name}.weight", (n_out, n_in), "linear"),
            (f"{name}.bias", (n_out,), "bias")]


def leaves(m: dict) -> list:
    """(name, shape, kind) of every parameter."""
    d, p = m["embed_dim"], m["patch"]
    out = [("cls_token", (1, 1, d), "bias"), ("dist_token", (1, 1, d), "bias"),
           ("pos_embed", (1, m["tokens"], d), "bias"),
           ("patch_embed.proj.weight", (d, m["in_channels"], p, p), "conv"),
           ("patch_embed.proj.bias", (d,), "bias")]
    for i in range(m["depth"]):
        b = f"blocks.{i}"
        out += (_ln(f"{b}.norm1", d) + _dense(f"{b}.attn.qkv", 3 * d, d)
                + _dense(f"{b}.attn.proj", d, d) + _ln(f"{b}.norm2", d)
                + _dense(f"{b}.mlp.fc1", m["mlp_dim"], d)
                + _dense(f"{b}.mlp.fc2", d, m["mlp_dim"]))
    return out + _ln("norm", d) + _ln("head_norm", d) + _dense("head", 1, d)


def layer_norm(x: torch.Tensor, P: dict, name: str) -> torch.Tensor:
    """Over the last axis: the mean and biased variance, eps LN_EPS."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * P[f"{name}.weight"]
            + P[f"{name}.bias"])


def matmul(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return q.output(torch.matmul(q(a), q(b)))


def attention(h: torch.Tensor, P: dict, name: str, heads: int, q
              ) -> torch.Tensor:
    b, n, c = h.shape
    hd = c // heads
    qkv = linear(h, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"], q)
    qq, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scores = matmul(qq, k.transpose(-2, -1), q) / math.sqrt(hd)
    o = matmul(torch.softmax(scores, dim=-1), v, q)
    return linear(o.transpose(1, 2).reshape(b, n, c),
                  P[f"{name}.proj.weight"], P[f"{name}.proj.bias"], q)


def mlp(h: torch.Tensor, P: dict, name: str, q) -> torch.Tensor:
    h = linear(h, P[f"{name}.fc1.weight"], P[f"{name}.fc1.bias"], q)
    h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return linear(h, P[f"{name}.fc2.weight"], P[f"{name}.fc2.bias"], q)


def forward(P: dict, feats: torch.Tensor, scals: torch.Tensor, m: dict,
            train, drop, q) -> torch.Tensor:
    """Logits [B] of features [B, C, H, W]; scalars [B, S] unused."""
    x = conv(feats, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"],
             q, stride=(m["fstride"], m["tstride"]), padding=0)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    lead = torch.cat([P["cls_token"], P["dist_token"]], dim=1)
    x = torch.cat([lead.expand(b, -1, -1), x], dim=1) + P["pos_embed"]
    for i in range(m["depth"]):
        blk = f"blocks.{i}"
        x = x + attention(layer_norm(x, P, f"{blk}.norm1"), P, f"{blk}.attn",
                          m["num_heads"], q)
        x = x + mlp(layer_norm(x, P, f"{blk}.norm2"), P, f"{blk}.mlp", q)
    x = layer_norm(x, P, "norm")
    z = layer_norm((x[:, 0] + x[:, 1]) / 2, P, "head_norm")
    return linear(z, P["head.weight"], P["head.bias"], q.head).squeeze(-1)
