"""Checkpoints (counterpart of tpu_breath/train/checkpoint.py; Orbax
checkpoints are not read). A checkpoint holds what the JAX TrainState
holds: the model (parameters and BatchNorm statistics), the optimizer state
and the step, plus metadata.

Layout: <save_dir>/best_epochNNN/{model.pt, train_state.pt, meta.json}.
meta.json is written last, so a directory without it is an interrupted save
and is skipped. Serving restores model.pt alone.
"""
from __future__ import annotations

import json
import os
import re

import torch

MODEL_FILE = "model.pt"
STATE_FILE = "train_state.pt"
META_FILE = "meta.json"


def epoch_dir(save_dir: str, epoch: int) -> str:
    """The directory of the checkpoint of `epoch` under save_dir."""
    return os.path.join(os.path.abspath(save_dir), f"best_epoch{epoch:03d}")


def save(save_dir: str, model: torch.nn.Module, epoch: int,
         metadata: dict, optimizer: torch.optim.Optimizer | None = None,
         step: int = 0) -> str:
    """Write model.state_dict(), the optimizer state and step (when an
    optimizer is given), then {"epoch", **metadata}; returns the path."""
    path = epoch_dir(save_dir, epoch)
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, MODEL_FILE))
    if optimizer is not None:  # loaded with map_location="cpu"
        torch.save({"optimizer": optimizer.state_dict(), "step": int(step)},
                   os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump({"epoch": epoch,
                   **{k: float(v) for k, v in metadata.items()}}, f)
    return path


def latest_checkpoint(save_dir: str) -> str | None:
    """The highest-epoch complete checkpoint under save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    best = None
    for name in os.listdir(save_dir):
        m = re.fullmatch(r"best_epoch(\d+)", name)
        if not m or not os.path.exists(os.path.join(save_dir, name,
                                                    META_FILE)):
            continue
        if best is None or int(m.group(1)) > best[0]:
            best = (int(m.group(1)), os.path.join(save_dir, name))
    return best[1] if best else None


def restore(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the checkpoint's weights into model (strict)."""
    state = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    return model


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> tuple[int, int]:
    """Load model, optimizer state and step; returns (step, epoch). Both
    loads copy into the live tensors (nn.Module.load_state_dict and
    loop.AdamW.load_state_dict), so the optimizer's state, its step count
    included, stays on its parameters' device, and a CUDA graph that reads
    them reads the restored values."""
    restore(path, model)
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"]), int(load_metadata(path)["epoch"])


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)
