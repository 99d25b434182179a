"""Validation-accuracy-weighted sigmoid ensemble served from wavs, and the
submission writer (counterpart of tpu_breath/ensemble.py)."""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from tpu_breath.config import DEFAULT_FEATURES
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.models import registry
from tpu_breath_torch.train import checkpoint as ckpt_lib


def softmax_weights(val_scores) -> np.ndarray:
    """softmax of the models' validation accuracies: the blend weights."""
    w = np.asarray(val_scores, np.float64)
    e = np.exp(w - w.max())
    return e / e.sum()


def load_models(ckpt_paths, archs, num_scalar_features: int,
                device) -> list[torch.nn.Module]:
    models = []
    for path, arch in zip(ckpt_paths, archs):
        model = registry.build(arch, num_scalar_features)
        models.append(ckpt_lib.restore(path, model).to(device).eval())
    return models


@torch.no_grad()
def serve_from_wav(ckpt_paths, archs, val_scores, wavs: np.ndarray,
                   spec=None, micro_batch: int = 8, device="cuda"
                   ) -> np.ndarray:
    """wavs[N, 16000] -> ensemble probabilities [N] (float64): per
    micro-batch, features on `device`, every model's forward, and the
    softmax(val-acc)-weighted sigmoid blend. The tail micro-batch is
    zero-padded to micro_batch clips and the padding's outputs dropped."""
    spec = spec or DEFAULT_FEATURES
    if not (len(ckpt_paths) == len(archs) == len(val_scores)):
        raise ValueError("one checkpoint, arch and val score per model")
    models = load_models(ckpt_paths, archs, spec.n_scalars, device)
    weights = softmax_weights(val_scores)
    n = wavs.shape[0]
    out = np.empty(n, np.float64)
    for lo in range(0, n, micro_batch):
        hi = min(lo + micro_batch, n)
        x = np.zeros((micro_batch, wavs.shape[1]), np.float32)
        x[: hi - lo] = wavs[lo:hi]
        f, s = extract_features(torch.from_numpy(x).to(device), spec)
        p = torch.zeros(micro_batch, dtype=torch.float32, device=device)
        for model, w in zip(models, weights):
            p = p + float(w) * torch.sigmoid(model(f, s))
        out[lo:hi] = p[: hi - lo].cpu().numpy()
    return out


def write_submission(ids, probs, out_path: str) -> list[tuple[str, str]]:
    """probs > 0.5 -> 'E' else 'I', written as an ID,Target csv."""
    rows = [(str(i), "E" if p > 0.5 else "I")
            for i, p in zip(ids, probs)]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["ID", "Target"])
        writer.writerows(rows)
    return rows
