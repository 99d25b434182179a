"""Checkpoints: a state_dict file plus meta.json (counterpart of
tpu_breath/train/checkpoint.py; Orbax checkpoints are not read).

Layout: <save_dir>/best_epochNNN/{model.pt, meta.json}. meta.json is written
last, so a directory without it is an interrupted save and is skipped.
"""
from __future__ import annotations

import json
import os
import re

import torch

MODEL_FILE = "model.pt"
META_FILE = "meta.json"


def _dir(save_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_dir), f"best_epoch{epoch:03d}")


def save(save_dir: str, model: torch.nn.Module, epoch: int,
         metadata: dict) -> str:
    """Write model.state_dict() and {"epoch", **metadata}; returns the path."""
    path = _dir(save_dir, epoch)
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, MODEL_FILE))
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


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)
