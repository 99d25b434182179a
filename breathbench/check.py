"""The correctness check's reference side: the configuration's plain
models (reference/<arch>.py) on the reference's own features of the
benchmark's clips (reference/oracle.py), in the reference's float32 with
TF32 off, or in the control's numerics."""
from __future__ import annotations

import numpy as np
import torch

from breathbench import harness, program
from breathbench.reference import augment as ref_aug
from breathbench.reference import layers, oracle
from breathbench.reference import train as ref_train

BLOCK = 128  # rows a reference forward takes at once


def features(config: dict, wavs: np.ndarray, device, workers=None):
    """The oracle's (features, scalars) of clips wavs [n, samples] as
    float32 tensors on device."""
    f, s = oracle.features(np.asarray(wavs, np.float32), config["features"],
                           workers)
    return torch.from_numpy(f).to(device), torch.from_numpy(s).to(device)


@torch.no_grad()
def probs(config: dict, weights: list[dict], feats, scals,
          numerics: str = "f32") -> np.ndarray:
    """The blended sigmoid of every member in evaluation, [n] float64."""
    q = layers.rounder(numerics)
    drop = layers.Dropout(torch.float32, train=False)
    out = np.zeros(feats.shape[0])
    with harness.full_f32():
        for (m, w_blend), P in zip(program.members(config), weights):
            mod = program.reference(m["arch"])
            P = {k: v.float() for k, v in P.items()}
            for lo in range(0, feats.shape[0], BLOCK):
                z = mod.forward(P, feats[lo:lo + BLOCK], scals[lo:lo + BLOCK],
                                m, False, drop, q)
                out[lo:lo + BLOCK] += w_blend * torch.sigmoid(
                    z).double().cpu().numpy()
    return out


def prob_gaps(served: np.ndarray, reference: np.ndarray, prefix: str = "prob_"
              ) -> dict:
    """The widest gap between a served probability and the reference's,
    and the mean gap (steadier from seed to seed)."""
    d = np.abs(np.asarray(served, np.float64) - reference)
    if not np.all(np.isfinite(d)):
        return {prefix + "gap": float("inf"),
                prefix + "gap_mean": float("inf")}
    return {prefix + "gap": float(np.max(d)),
            prefix + "gap_mean": float(np.mean(d))}


def train_steps(config: dict, weights: dict, batches: list, lrs: list,
                drop_seed: int, device, numerics: str = "f32",
                half_batch: bool = False, moments: tuple | None = None,
                draws: list | None = None) -> dict:
    """The reference's len(batches) steps of the configuration's one model
    from weights (and AdamW's state moments, ref_train.steps), dropout
    drawn from drop_seed, each batch augmented by its draw (draws None:
    augmentation off); half_batch plants the fault "half of the batch left
    out, the mean over the rest"."""
    (m, _), = program.members(config)
    mod = program.reference(m["arch"])
    q = layers.rounder(numerics)
    names = [n for n, _, kind in mod.leaves(m) if kind in program.TRAINABLE]
    drop = layers.Dropout(program.body_dtype(config, device), train=True)

    def augment(i, batch):
        if draws is not None:
            batch = ref_aug.apply(batch, draws[i])
        if half_batch:
            batch = tuple(t[:t.shape[0] // 2] for t in batch)
        return batch

    def forward(P, f, s, train, drop):
        return mod.forward(P, f, s, m, train, drop, q)

    with harness.full_f32():
        return ref_train.steps(forward, weights, names, batches, lrs,
                               config["train"], drop_seed, drop, moments,
                               augment)
