"""The system under test as a configuration asks for it: the port's
models with the benchmark's weights, its feature spec and training
configuration. Nothing here measures; the kinds call it in set-up."""
from __future__ import annotations

import importlib

import torch

from breathbench import data

TRAINABLE = {"conv", "linear", "bias", "bn_weight", "bn_bias"}


def members(config: dict) -> list:
    """The configuration's models: [(model object, blend weight)]."""
    return [(m["model"], m.get("weight", 1.0)) for m in config["members"]]


def reference(arch: str):
    """The plain reference module of an architecture."""
    return importlib.import_module(f"breathbench.reference.{arch}")


def leaves(config: dict) -> list:
    """(name, shape, kind) of every member's leaves, names prefixed by the
    member's index ("0/convs.0.conv.weight")."""
    return [(f"{i}/{name}", shape, kind)
            for i, (m, _) in enumerate(members(config))
            for name, shape, kind in reference(m["arch"]).leaves(m)]


CALIBRATION_CLIPS = 16


@torch.no_grad()
def weights(seed: int, config: dict, device, calibrate: bool = False
            ) -> list[dict]:
    """Each member's weights by state_dict name, made on the device (the
    seeded draw, data.weights). calibrate (for a model that serves in
    evaluation): every BatchNorm's running statistics then set to the
    batch statistics its layer sees when the plain reference runs the
    oracle's features of CALIBRATION_CLIPS seeded clips, as training would
    leave them, so that the model's logits are of order one and its
    probabilities not saturated."""
    flat = data.weights(seed, leaves(config), device)
    out = [{} for _ in members(config)]
    for key, t in flat.items():
        i, name = key.split("/", 1)
        out[int(i)][name] = t
    if calibrate:
        from breathbench.reference import layers, oracle

        y = torch.arange(CALIBRATION_CLIPS, device=device) % 2
        wavs = data.clips(data.stream_seed(seed, "calibration"), y.float())
        f, s = oracle.features(wavs.cpu().numpy(), config["features"],
                               workers=0)
        f, s = torch.from_numpy(f).to(device), torch.from_numpy(s).to(device)
        for (m, _), P in zip(members(config), out):
            reference(m["arch"]).forward(P, f, s, m, "calibrate",
                                         lambda z, p, channels: z,
                                         layers.rounder("f32"))
    return out


def body_dtype(config: dict, device) -> torch.dtype:
    """The dtype the program's model body computes in on this device."""
    bf16 = config["precision"]["body"] == "bfloat16"
    return torch.bfloat16 if (bf16 and device.type == "cuda") else torch.float32


def models(config: dict, weights: list[dict], device) -> list:
    """The port's models (registry.build) holding the benchmark's weights,
    on device. Raises if a member's names, shapes or parameter count
    differ from the configuration's."""
    from tpu_breath_torch.models import registry

    out = []
    for (m, _), w in zip(members(config), weights):
        model = registry.build(m["arch"], m["num_scalar_features"],
                               bf16=config["precision"]["body"] == "bfloat16")
        n = sum(p.numel() for p in model.parameters())
        if n != m["num_parameters"]:
            raise RuntimeError(f"{m['arch']}: the port's model has {n} "
                               f"parameters, the configuration "
                               f"{m['num_parameters']}")
        model.load_state_dict(w, strict=True)
        out.append(model.to(device))
    return out


def feature_spec(config: dict):
    from tpu_breath_torch.config import FeatureSpec

    kw = dict(config["features"])
    kw["npz_keys"] = tuple(kw["npz_keys"])
    return FeatureSpec(**kw)


def train_cfg(config: dict, seed: int):
    from tpu_breath_torch.config import TrainCfg

    return TrainCfg(**config["train"], seed=seed)
