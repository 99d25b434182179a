"""Flax CNN8 variables -> the port's CNN8 state_dict.

The Flax variables arrive as nested dicts of numpy arrays (no jax needed):
params {"ConvBlock_0".."ConvBlock_7": {"Conv_0", "BatchNorm_0"},
"MLPBlock_0".."MLPBlock_3": {"Dense_0", "BatchNorm_0"}, "Dense_0"} and
batch_stats with the same BatchNorm paths. Conv kernels go HWIO -> OIHW,
Dense kernels [in, out] -> Linear [out, in]; BN scale/bias/mean/var map to
weight/bias/running_mean/running_var unchanged (Flax keeps the biased batch
variance; nothing is rescaled).
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_breath_torch.models.cnn8 import WIDTHS

# Flax MLPBlock index -> (ModuleList name, index): two scalar-MLP blocks,
# then the two classifier blocks, in Flax's creation order
_MLP = {0: ("scalar_mlp", 0), 1: ("scalar_mlp", 1),
        2: ("classifier", 0), 3: ("classifier", 1)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def cnn8_from_flax(params: dict, batch_stats: dict) -> dict:
    """Flax CNN8 {params, batch_stats} (numpy leaves) -> CNN8 state_dict."""
    sd: dict = {}
    for i in range(len(WIDTHS)):
        p, s = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        sd[f"convs.{i}.conv.weight"] = _t(p["Conv_0"]["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        sd[f"convs.{i}.conv.bias"] = _t(p["Conv_0"]["bias"])
        _bn(sd, f"convs.{i}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for i, (group, j) in _MLP.items():
        p, s = params[f"MLPBlock_{i}"], batch_stats[f"MLPBlock_{i}"]
        sd[f"{group}.{j}.dense.weight"] = _t(p["Dense_0"]["kernel"]).T.contiguous()
        sd[f"{group}.{j}.dense.bias"] = _t(p["Dense_0"]["bias"])
        _bn(sd, f"{group}.{j}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    sd["head.weight"] = _t(params["Dense_0"]["kernel"]).T.contiguous()
    sd["head.bias"] = _t(params["Dense_0"]["bias"])
    return sd
