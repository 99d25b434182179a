"""CNN8 in plain float32 (the source's src/model.py:5-82): 8 conv3x3
(padding 1, bias) -> ReLU -> BatchNorm blocks, 2x2 max pooling (floor)
after the blocks listed in pool_after, channel dropout after
channel_dropout_after, global average pooling; the scalar MLP and the
classifier of Linear -> ReLU -> BatchNorm (-> dropout); a Linear head to
one logit. Sizes from the configuration's "model" object; parameter names
are the checkpoint's (state_dict) names."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from breathbench.reference.layers import (batch_norm, bn_leaves, conv,
                                          linear)


def leaves(m: dict) -> list:
    """(name, shape, kind) of every parameter and buffer."""
    out, cin = [], m["in_channels"]
    for i, w in enumerate(m["conv_widths"]):
        out.append((f"convs.{i}.conv.weight", (w, cin, 3, 3), "conv"))
        out.append((f"convs.{i}.conv.bias", (w,), "bias"))
        out += bn_leaves(f"convs.{i}.bn", w)
        cin = w
    for group, widths, fan in (("scalar_mlp", m["scalar_widths"],
                                m["num_scalar_features"]),
                               ("classifier", m["classifier_widths"],
                                m["conv_widths"][-1]
                                + m["scalar_widths"][-1])):
        for j, w in enumerate(widths):
            out.append((f"{group}.{j}.dense.weight", (w, fan), "linear"))
            out.append((f"{group}.{j}.dense.bias", (w,), "bias"))
            out += bn_leaves(f"{group}.{j}.bn", w)
            fan = w
    out.append(("head.weight", (1, fan), "linear"))
    out.append(("head.bias", (1,), "bias"))
    return out


def _mlp(z, P, group, widths, drops, train, drop, q):
    for j, p in enumerate(drops[:len(widths)]):
        z = linear(z, P[f"{group}.{j}.dense.weight"],
                   P[f"{group}.{j}.dense.bias"], q)
        z = batch_norm(torch.relu(z), P, f"{group}.{j}.bn", train)
        z = drop(z, p, channels=False)
    return z


def forward(P: dict, feats: torch.Tensor, scals: torch.Tensor, m: dict,
            train: bool, drop, q) -> torch.Tensor:
    """Logits [B] of features [B, C, H, W] and scalars [B, S]."""
    x = feats
    for i in range(len(m["conv_widths"])):
        x = conv(x, P[f"convs.{i}.conv.weight"], P[f"convs.{i}.conv.bias"],
                 q)
        x = batch_norm(torch.relu(x), P, f"convs.{i}.bn", train)
        if i in m["pool_after"]:
            x = F.max_pool2d(x, 2)
        if i == m["channel_dropout_after"]:
            x = drop(x, m["dropout"], channels=True)
    x = x.mean(dim=(2, 3))
    s = _mlp(scals, P, "scalar_mlp", m["scalar_widths"], m["scalar_dropout"],
             train, drop, q)
    z = _mlp(torch.cat([x, s], dim=-1), P, "classifier",
             m["classifier_widths"], m["classifier_dropout"], train, drop, q)
    return linear(z, P["head.weight"], P["head.bias"], q.head).squeeze(-1)
