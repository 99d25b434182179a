"""The VGG-style model in plain float32 (the source's src/model.py:92-202):
four blocks of convs_per_block bias-free conv3x3 -> BatchNorm -> exact GELU
(block 1's last conv with stride 2, blocks 2 and 3 followed by ceil-mode
2x2 max pooling), channel dropout after each block (block_dropout), a
residual from block 3's output through a bias-free 1x1 conv and BatchNorm
added to block 4's, global average pooling; the scalar MLP and the
classifier of bias-free Linear -> BatchNorm -> GELU (-> dropout); a Linear
head to one logit. Sizes from the configuration's "model" object;
parameter names are the checkpoint's (state_dict) names."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from breathbench.reference.layers import (batch_norm, bn_leaves, conv,
                                          linear)


def leaves(m: dict) -> list:
    """(name, shape, kind) of every parameter and buffer."""
    out, cin, k = [], m["in_channels"], 0
    for w in m["block_widths"]:
        for _ in range(m["convs_per_block"]):
            out.append((f"convs.{k}.conv.weight", (w, cin, 3, 3), "conv"))
            out += bn_leaves(f"convs.{k}.bn", w)
            cin, k = w, k + 1
    res_in, res_out = m["block_widths"][2], m["block_widths"][3]
    out.append(("res_conv.weight", (res_out, res_in, 1, 1), "conv"))
    out += bn_leaves("res_bn", res_out)
    for group, widths, fan in (("scalar_mlp", m["scalar_widths"],
                                m["num_scalar_features"]),
                               ("classifier", m["classifier_widths"],
                                m["block_widths"][-1]
                                + m["scalar_widths"][-1])):
        for j, w in enumerate(widths):
            out.append((f"{group}.{j}.dense.weight", (w, fan), "linear"))
            out += bn_leaves(f"{group}.{j}.bn", w)
            fan = w
    out.append(("head.weight", (1, fan), "linear"))
    out.append(("head.bias", (1,), "bias"))
    return out


def _block(x, P, b, m, train, q):
    n = m["convs_per_block"]
    for i in range(n):
        k = b * n + i
        stride = 2 if (b == 0 and i == n - 1) else 1
        x = conv(x, P[f"convs.{k}.conv.weight"], None, q, stride=stride)
        x = F.gelu(batch_norm(x, P, f"convs.{k}.bn", train))
    return x


def _mlp(z, P, group, widths, drops, train, drop, q):
    for j, p in enumerate(drops[:len(widths)]):
        z = linear(z, P[f"{group}.{j}.dense.weight"], None, q)
        z = F.gelu(batch_norm(z, P, f"{group}.{j}.bn", train))
        z = drop(z, p, channels=False)
    return z


def forward(P: dict, feats: torch.Tensor, scals: torch.Tensor, m: dict,
            train: bool, drop, q) -> torch.Tensor:
    """Logits [B] of features [B, C, H, W] and scalars [B, S]."""
    pd = m["block_dropout"]
    x = drop(_block(feats, P, 0, m, train, q), pd[0], channels=True)
    x = drop(F.max_pool2d(_block(x, P, 1, m, train, q), 2, ceil_mode=True),
             pd[1], channels=True)
    x = drop(F.max_pool2d(_block(x, P, 2, m, train, q), 2, ceil_mode=True),
             pd[2], channels=True)
    residual = batch_norm(conv(x, P["res_conv.weight"], None, q, padding=0),
                          P, "res_bn", train)
    main = drop(_block(x, P, 3, m, train, q), pd[3], channels=True)
    x = (main + residual).mean(dim=(2, 3))
    s = _mlp(scals, P, "scalar_mlp", m["scalar_widths"], m["scalar_dropout"],
             train, drop, q)
    z = _mlp(torch.cat([x, s], dim=-1), P, "classifier",
             m["classifier_widths"], m["classifier_dropout"], train, drop, q)
    return linear(z, P["head.weight"], P["head.bias"], q.head).squeeze(-1)
