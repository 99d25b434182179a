"""Validation-accuracy-weighted sigmoid ensemble, from the feature cache or
served from wavs (Server: one CUDA graph a micro-batch on the card), and
the submission writer (counterpart of tpu_breath/ensemble.py)."""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from tpu_breath_torch import graphs
from tpu_breath_torch.config import DEFAULT_FEATURES
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features, gt_switch
from tpu_breath_torch.models import registry
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train.loop import predict_logits
from tpu_breath_torch.utils import profiling


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
    """Sigmoid probabilities [N] (float32) of one model over the whole set
    (tpu_breath/ensemble.py::predict_probs): the set goes to the device
    once, then batches of batch_size rows, the tail padded with its last
    row, through loop.Predictor (on the card one replay a batch, one wait
    at the end)."""
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


def blend(models, weights, feats: torch.Tensor, scals: torch.Tensor
          ) -> torch.Tensor:
    """sum_m weights[m] * sigmoid(model_m(feats, scals)) [B] f32: the
    serving program's model part (tpu_breath/ensemble.py::serve)."""
    p = torch.zeros(feats.shape[0], dtype=torch.float32, device=feats.device)
    for model, w in zip(models, weights):
        p = p + float(w) * torch.sigmoid(model(feats, scals))
    return p


class Server:
    """The JAX package's jitted `serve`: wavs -> features -> every model's
    forward -> the weighted sigmoid blend, for models in eval mode on
    `device`.

    On the card each micro-batch is one replay of a CUDA graph that holds
    the whole program (graphs.Graph), one graph per (micro_batch, fused_gt,
    the global TF32/cuDNN flags), captured at its first use and kept while
    the server lives. The micro-batches are queued (wavs up from pinned
    memory, probabilities down into a pinned buffer) and the host waits
    once, at the end. On the CPU (or inside graphs.eager()) the same
    program runs eagerly.
    fused_gt follows TPU_BREATH_PALLAS_GT, read once a call.

    Spans (utils/profiling.py): a call is server.call (attrs clips,
    micro_batches), its parts server.stage (the pinned buffers, the clips
    copied in), server.issue (each micro-batch's copy in, replay and copy
    out, queued), server.wait (the host's one wait) and server.unstage
    (the probabilities as float64)."""

    def __init__(self, models, weights, spec=None, device="cuda"):
        self.models = list(models)
        self.weights = [float(w) for w in weights]
        self.spec = spec or DEFAULT_FEATURES
        self.device = resolve_device(device)
        self.graphs: dict = {}

    def program(self, y: torch.Tensor, fused_gt: bool) -> torch.Tensor:
        """One micro-batch y [B, n] on the device -> probabilities [B]."""
        return blend(self.models, self.weights,
                     *extract_features(y, self.spec, fused_gt))

    @torch.no_grad()
    def __call__(self, wavs: np.ndarray, micro_batch: int = 8
                 ) -> np.ndarray:
        """wavs[N, 16000] -> probabilities [N] (float64); the tail
        micro-batch is zero-padded to micro_batch clips and the padding's
        outputs dropped."""
        n = wavs.shape[0]
        n_pad = -(-n // micro_batch) * micro_batch
        with profiling.span("server.call", clips=n,
                            micro_batches=n_pad // micro_batch):
            cuda = self.device.type == "cuda"
            graphed = graphs.replays(self.device)
            with profiling.span("server.stage"):
                y = torch.zeros((n_pad, wavs.shape[1]),
                                dtype=torch.float32, pin_memory=cuda)
                y[:n] = torch.from_numpy(np.asarray(wavs, np.float32))
                out = torch.empty(n_pad, dtype=torch.float32,
                                  pin_memory=cuda)
            fused_gt = gt_switch()
            key = (micro_batch, fused_gt, graphs.global_flags())
            with profiling.span("server.issue"):
                for lo in range(0, n_pad, micro_batch):
                    x = y[lo:lo + micro_batch]
                    if not graphed:
                        out[lo:lo + micro_batch].copy_(
                            self.program(x.to(self.device), fused_gt))
                        continue
                    graph = self.graphs.get(key)
                    if graph is None:
                        graph = self.graphs[key] = graphs.Graph(
                            lambda t: self.program(t, fused_gt), (x,),
                            self.device)
                    out[lo:lo + micro_batch].copy_(graph(x),
                                                   non_blocking=True)
            with profiling.span("server.wait"):
                if cuda:
                    graphs.wait(self.device)
            with profiling.span("server.unstage"):
                return out.numpy()[:n].astype(np.float64)


def serve_from_wav(ckpt_paths, archs, val_scores, wavs: np.ndarray,
                   spec=None, use_softmax: bool = True, micro_batch: int = 8,
                   device="cuda") -> np.ndarray:
    """Cache-free inference (tpu_breath/ensemble.py::serve_from_wav): wavs
    [N, 16000] -> ensemble probabilities [N] (float64) through a Server of
    the checkpoints' models, blended by softmax_weights(val_scores,
    use_softmax), micro_batch clips a replay."""
    spec = spec or DEFAULT_FEATURES
    if not (len(ckpt_paths) == len(archs) == len(val_scores)):
        raise ValueError("one checkpoint, arch and val score per model")
    device = resolve_device(device)
    models = load_models(ckpt_paths, archs, spec.n_scalars, device)
    server = Server(models, softmax_weights(val_scores, use_softmax), spec,
                    device)
    return server(wavs, micro_batch)


def write_submission(ids, probs, out_path: str, threshold: float = 0.5
                     ) -> list[tuple[str, str]]:
    """probs > threshold -> 'E' else 'I', written as an ID,Target csv."""
    rows = [(str(i), "E" if p > threshold else "I")
            for i, p in zip(ids, probs)]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["ID", "Target"])
        writer.writerows(rows)
    return rows
