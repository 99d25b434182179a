"""Flax CNN8 / VGG variables -> the port's state_dicts.

The Flax variables arrive as nested dicts of numpy arrays (no jax needed),
under Flax's auto-names. CNN8: params {"ConvBlock_0".."ConvBlock_7":
{"Conv_0", "BatchNorm_0"}, "MLPBlock_0".."MLPBlock_3": {"Dense_0",
"BatchNorm_0"}, "Dense_0"}. VGG: "ConvBlock_0".."ConvBlock_11" (bias-free),
the residual's "Conv_0" / "BatchNorm_0" at the top level, the same four
MLPBlocks (bias-free) and "Dense_0". batch_stats has the same BatchNorm
paths. Conv kernels go HWIO -> OIHW,
Dense kernels [in, out] -> Linear [out, in]; BN scale/bias/mean/var map to
weight/bias/running_mean/running_var unchanged (Flax keeps the biased batch
variance; nothing is rescaled).
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_breath_torch.models import cnn8, vgg

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


def _conv(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["kernel"]).permute(3, 2, 0, 1
                                                          ).contiguous()
    if "bias" in params:
        sd[f"{prefix}.bias"] = _t(params["bias"])


def _convs_mlps_head(sd: dict, params: dict, batch_stats: dict,
                     n_convs: int) -> dict:
    for i in range(n_convs):
        p, s = params[f"ConvBlock_{i}"], batch_stats[f"ConvBlock_{i}"]
        _conv(sd, f"convs.{i}.conv", p["Conv_0"])
        _bn(sd, f"convs.{i}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for i, (group, j) in _MLP.items():
        p, s = params[f"MLPBlock_{i}"], batch_stats[f"MLPBlock_{i}"]
        dense = p["Dense_0"]
        sd[f"{group}.{j}.dense.weight"] = _t(dense["kernel"]).T.contiguous()
        if "bias" in dense:
            sd[f"{group}.{j}.dense.bias"] = _t(dense["bias"])
        _bn(sd, f"{group}.{j}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    sd["head.weight"] = _t(params["Dense_0"]["kernel"]).T.contiguous()
    sd["head.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def cnn8_from_flax(params: dict, batch_stats: dict) -> dict:
    """Flax CNN8 {params, batch_stats} (numpy leaves) -> CNN8 state_dict."""
    return _convs_mlps_head({}, params, batch_stats, len(cnn8.WIDTHS))


def vgg_from_flax(params: dict, batch_stats: dict) -> dict:
    """Flax VGG {params, batch_stats} (numpy leaves) -> VGG state_dict."""
    sd: dict = {}
    _conv(sd, "res_conv", params["Conv_0"])
    _bn(sd, "res_bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    return _convs_mlps_head(sd, params, batch_stats,
                            len(vgg.WIDTHS) * vgg.CONVS_PER_BLOCK)


FROM_FLAX = {"cnn8": cnn8_from_flax, "vgg": vgg_from_flax}
