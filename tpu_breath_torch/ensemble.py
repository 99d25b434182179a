"""Validation-accuracy-weighted sigmoid ensemble, from the feature cache or
served from wavs, and the submission writer (counterpart of
tpu_breath/ensemble.py)."""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from tpu_breath_torch.config import DEFAULT_FEATURES
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.models import registry
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train.loop import predict_logits


def softmax_weights(val_scores, use_softmax: bool = True) -> np.ndarray:
    """The blend weights: softmax of the models' validation accuracies, or
    the accuracies normalised to sum 1."""
    w = np.asarray(val_scores, np.float64)
    if use_softmax:
        e = np.exp(w - w.max())
        return e / e.sum()
    return w / w.sum()


def load_models(ckpt_paths, archs, num_scalar_features: int,
                device) -> list[torch.nn.Module]:
    models = []
    for path, arch in zip(ckpt_paths, archs):
        model = registry.build(arch, num_scalar_features)
        models.append(ckpt_lib.restore(path, model).to(device).eval())
    return models


def predict_probs(model: torch.nn.Module, feats: np.ndarray,
                  scals: np.ndarray, batch_size: int = 1024,
                  device="cuda") -> np.ndarray:
    """Sigmoid probabilities [N] (float32) of one model over the whole set;
    the set goes to the device once."""
    device = resolve_device(device)
    model.to(device)
    f = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
    s = torch.from_numpy(np.ascontiguousarray(scals, np.float32)).to(device)
    logits = predict_logits(model, f, s, batch_size)
    return 1.0 / (1.0 + np.exp(-logits))


def weighted_ensemble(ckpt_paths, archs, val_scores, feats, scals,
                      num_scalar_features: int, use_softmax: bool = True,
                      batch_size: int = 1024, device="cuda") -> np.ndarray:
    """sum_m w_m * sigmoid(model_m) [N] (float64), w = softmax_weights."""
    if not (len(ckpt_paths) == len(archs) == len(val_scores)):
        raise ValueError("one checkpoint, arch and val score per model")
    device = resolve_device(device)
    weights = softmax_weights(val_scores, use_softmax)
    probs = np.zeros(feats.shape[0], np.float64)
    for model, w in zip(load_models(ckpt_paths, archs, num_scalar_features,
                                    device), weights):
        probs += w * predict_probs(model, feats, scals, batch_size, device)
    return probs


def average_ensemble(ckpt_paths, archs, feats, scals,
                     num_scalar_features: int, batch_size: int = 1024,
                     device="cuda") -> np.ndarray:
    """Unweighted mean of the models' probabilities."""
    return weighted_ensemble(ckpt_paths, archs, np.ones(len(ckpt_paths)),
                             feats, scals, num_scalar_features,
                             use_softmax=False, batch_size=batch_size,
                             device=device)


@torch.no_grad()
def serve_from_wav(ckpt_paths, archs, val_scores, wavs: np.ndarray,
                   spec=None, micro_batch: int = 8, device="cuda"
                   ) -> np.ndarray:
    """wavs[N, 16000] -> ensemble probabilities [N] (float64): per
    micro-batch, features on `device`, every model's forward, and the
    weighted sigmoid blend. The tail micro-batch is zero-padded to
    micro_batch clips and the padding's outputs dropped."""
    spec = spec or DEFAULT_FEATURES
    if not (len(ckpt_paths) == len(archs) == len(val_scores)):
        raise ValueError("one checkpoint, arch and val score per model")
    device = resolve_device(device)
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
