"""The reference's first training steps: float32 forward and backward of
the model in training mode, mean binary cross-entropy on logits, the
gradients clipped to a global norm (g * max_norm / norm once the norm
reaches max_norm), AdamW with decoupled decay (p -= lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)), the rate of the warmup-cosine schedule.
The step's rows, the dropout generator's seed and the augmentation's
draws follow the training loop's documented rules (the epoch's permutation
of the train split, the epoch's seeds, reference/augment.py), worked out
here again."""
from __future__ import annotations

import math

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The batch order of an epoch: a permutation of the train split by
    numpy's default_rng([seed + 1, epoch])."""
    return np.random.default_rng([seed + 1, epoch]).permutation(n)


def dropout_seed(seed: int, epoch: int) -> int:
    """The seed of the default generator an epoch draws its dropout masks
    from: the second word of SeedSequence([seed, epoch])."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(2)[1])


def aug_seed(seed: int, epoch: int) -> int:
    """The seed of the generator an epoch draws its augmentation from: the
    first word of SeedSequence([seed, epoch])."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(2)[0])


def rate(train: dict, steps_per_epoch: int, step: int) -> float:
    """The warmup-cosine schedule: a linear rise from start_factor over the
    first warmup_frac of the run's steps, then a cosine to eta_min."""
    total = steps_per_epoch * train["num_epochs"]
    warm = int(train["warmup_frac"] * total)
    base, f0 = train["base_lr"], train["lr_start_factor"]
    if step < warm:
        return base * (f0 + (1.0 - f0) * min(step / warm, 1.0))
    t = min(max(step - warm, 0), max(total - warm, 1))
    cos = math.cos(math.pi * t / max(total - warm, 1))
    return train["lr_eta_min"] + (base - train["lr_eta_min"]) * 0.5 * (1 + cos)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def steps(forward, P0: dict, names: list, batches: list, lrs: list,
          train: dict, drop_seed: int, drop, moments: tuple | None = None,
          augment=None) -> dict:
    """len(batches) steps from the parameters P0 (the trainable leaves
    `names`, the rest buffers), each batch (features, scalars, labels) on
    the device; from AdamW's state moments = (first moments, second
    moments, steps taken) by leaf name, or from a fresh one. augment(i,
    batch) gives step i's batch as the step trains on it. Returns the step
    losses, each leaf's norm of the first step's clipped gradient, and
    each leaf's norm of its change over all the steps. forward(P, feats,
    scals, train=True, drop=drop) gives the logits."""
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    for k in names:
        P[k].requires_grad_(True)
    if moments is None:
        m = {k: torch.zeros_like(P[k]) for k in names}
        v = {k: torch.zeros_like(P[k]) for k in names}
        taken = 0
    else:
        m = {k: moments[0][k].detach().clone().float() for k in names}
        v = {k: moments[1][k].detach().clone().float() for k in names}
        taken = int(moments[2])
    losses, grad_norms = [], None
    dev = next(iter(P.values())).device
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(drop_seed)
        for i, (batch, lr) in enumerate(zip(batches, lrs)):
            f, s, y = batch if augment is None else augment(i, batch)
            count = taken + i + 1
            loss = bce(forward(P, f, s, train=True, drop=drop), y)
            grads = torch.autograd.grad(loss, [P[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                if norm >= train["grad_clip_norm"]:
                    grads = [g / norm * train["grad_clip_norm"]
                             for g in grads]
                if i == 0:
                    grad_norms = {k: float(torch.linalg.vector_norm(g))
                                  for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    m_hat = m[k] / (1 - BETAS[0] ** count)
                    v_hat = v[k] / (1 - BETAS[1] ** count)
                    upd = (m_hat / (v_hat.sqrt() + EPS)
                           + train["weight_decay"] * P[k])
                    P[k].sub_(lr * upd)
    change = {k: float(torch.linalg.vector_norm(P[k].detach() - P0[k].float()))
              for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def leaf_gaps(program: dict, reference: dict, keep: list) -> dict:
    """Each kept leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and its median leaf's norm."""
    med = float(np.median([reference[k] for k in keep]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], med)
            for k in keep}


def kept_leaves(grad_norms: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's (the rest move under Adam by
    round-off alone)."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, g in grad_norms.items() if g >= 1e-3 * med]


def numbers(program: dict, reference: dict, worst: bool = False,
            prefix: str = "") -> dict:
    """The numbers a training cell compares, each name after prefix: the
    worst step's relative loss gap, and the median leaf's gap of the first
    gradient's norm and of the change's norm. The worst leaf's gaps
    (worst=True: for the look, not compared) swing from seed to seed with
    a leaf whose sum cancels in bf16 (PERF.md)."""
    keep = kept_leaves(reference["grad_norms"])
    grad = leaf_gaps(program["grad_norms"], reference["grad_norms"], keep)
    change = leaf_gaps(program["change_norms"], reference["change_norms"],
                       keep)
    if worst:
        out = {"grad_gap": max(grad.values()),
               "change_gap": max(change.values())}
    else:
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                               zip(program["losses"], reference["losses"])),
               "grad_gap": float(np.median(list(grad.values()))),
               "change_gap": float(np.median(list(change.values())))}
    return {prefix + k: v for k, v in out.items()}
