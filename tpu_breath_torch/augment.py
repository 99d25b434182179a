"""CutMix / MixUp on the device (counterpart of tpu_breath/augment.py).

Each augmentation is split into a draw (random numbers from a
torch.Generator on the batch's device) and an apply (a pure function of the
batch and the draws), so tests can hand both frameworks the same draws.
The semantics are the JAX package's:
- CutMix pastes one box from a permuted batch into every clip, recomputes
  lambda from the realised integer box, mixes the labels and leaves the
  scalars alone;
- MixUp mixes features, scalars and labels with one lambda;
- per step r ~ U[0, 1) picks CutMix (r < cutmix_prob), MixUp
  (r < cutmix_prob + mixup_prob) or nothing; use_aug gates it all.
The branch is selected on the device (torch.where), so a step never waits
for the host. As in the JAX package a step draws whether or not use_aug is
on, and gate() applies the flag on the device, so one program (one CUDA
graph of the step) serves the epochs before the warmup's end and after.
Under a data-parallel mesh the draws are of the global batch (every rank
draws them from the same seeded generator), each rank mixes its own rows
with partner rows taken from the global batch (local_rows,
apply_augmentation's `partners`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

BETA_TRIES = 64


class Batch(NamedTuple):
    features: torch.Tensor  # [B, C, H, W]
    scalars: torch.Tensor   # [B, S]
    labels: torch.Tensor    # [B] float


class CutMixDraw(NamedTuple):
    perm: torch.Tensor  # [B] int64
    lam: torch.Tensor   # () f32, Beta(alpha, alpha)
    cx: torch.Tensor    # () int64 in [0, W)
    cy: torch.Tensor    # () int64 in [0, H)


class MixUpDraw(NamedTuple):
    perm: torch.Tensor
    lam: torch.Tensor


class AugDraw(NamedTuple):
    r: torch.Tensor  # () f32, U[0, 1)
    cutmix: CutMixDraw
    mixup: MixUpDraw


def beta_symmetric(g: torch.Generator, alpha: float, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw by Johnk's method: x = u^(1/a),
    y = v^(1/a), accept x + y <= 1, return x / (x + y). BETA_TRIES candidate
    pairs are drawn at once and the first accepted one is taken, so no host
    sync is needed (acceptance is 0.95 at alpha 0.2 and 0.5 at alpha 1)."""
    u = torch.rand(2, BETA_TRIES, generator=g, device=device,
                   dtype=torch.float64)
    x, y = u[0] ** (1.0 / alpha), u[1] ** (1.0 / alpha)
    s = x + y
    first = torch.argmax(((s <= 1.0) & (s > 0.0)).to(torch.int8))
    # take, not [first]: indexing with a device scalar reads it on the host
    return torch.take(x / s.clamp(min=torch.finfo(torch.float64).tiny),
                      first).float()


def draw(g: torch.Generator, b: int, h: int, w: int, cutmix_alpha: float,
         mixup_alpha: float, device) -> AugDraw:
    """All random numbers of one step's augmentation, from g."""
    r = torch.rand((), generator=g, device=device)
    cut = CutMixDraw(torch.randperm(b, generator=g, device=device),
                     beta_symmetric(g, cutmix_alpha, device),
                     torch.randint(0, w, (), generator=g, device=device),
                     torch.randint(0, h, (), generator=g, device=device))
    mix = MixUpDraw(torch.randperm(b, generator=g, device=device),
                    beta_symmetric(g, mixup_alpha, device))
    return AugDraw(r, cut, mix)


def gate(d: AugDraw, use_aug) -> AugDraw:
    """d with the use_aug gate (a bool, or a bool scalar on d's device)
    applied: gated off, r becomes +inf, which picks neither CutMix nor
    MixUp, so apply_augmentation returns the batch as it was (the JAX
    package's passthrough branch, tpu_breath/augment.py:65-74)."""
    if not torch.is_tensor(use_aug):
        return d if use_aug else d._replace(r=torch.full_like(d.r, math.inf))
    return d._replace(r=torch.where(use_aug, d.r, math.inf))


def local_rows(d: AugDraw, rows: slice) -> AugDraw:
    """The draws of a global batch for its rows `rows`: the partner of
    local row i is global row perm[rows][i]."""
    return AugDraw(d.r, d.cutmix._replace(perm=d.cutmix.perm[rows]),
                   d.mixup._replace(perm=d.mixup.perm[rows]))


def cutmix(batch: Batch, d: CutMixDraw, partners: Batch | None = None
           ) -> Batch:
    """Box from the permuted batch (rows d.perm of partners, by default
    batch itself) pasted into each clip; lambda recomputed from the integer
    box (tpu_breath/augment.py:28-50)."""
    partners = batch if partners is None else partners
    _, _, h, w = batch.features.shape
    cut_rat = torch.sqrt(1.0 - d.lam)
    cut_w = (w * cut_rat).to(torch.int64)
    cut_h = (h * cut_rat).to(torch.int64)
    bbx1 = torch.clamp(d.cx - cut_w // 2, 0, w)
    bby1 = torch.clamp(d.cy - cut_h // 2, 0, h)
    bbx2 = torch.clamp(d.cx + cut_w // 2, 0, w)
    bby2 = torch.clamp(d.cy + cut_h // 2, 0, h)
    dev = batch.features.device
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    box = (row >= bby1) & (row < bby2) & (col >= bbx1) & (col < bbx2)
    mixed = torch.where(box, partners.features[d.perm], batch.features)
    lam_adj = 1.0 - ((bbx2 - bbx1) * (bby2 - bby1)).float() / (w * h)
    labels = (lam_adj * batch.labels
              + (1.0 - lam_adj) * partners.labels[d.perm])
    return Batch(mixed, batch.scalars, labels)


def mixup(batch: Batch, d: MixUpDraw, partners: Batch | None = None
          ) -> Batch:
    """Convex combination of features, scalars and labels with rows d.perm
    of partners (by default batch itself)."""
    partners = batch if partners is None else partners
    lam, p = d.lam, d.perm
    return Batch(lam * batch.features + (1 - lam) * partners.features[p],
                 lam * batch.scalars + (1 - lam) * partners.scalars[p],
                 lam * batch.labels + (1 - lam) * partners.labels[p])


def apply_augmentation(batch: Batch, d: AugDraw, cutmix_prob: float,
                       mixup_prob: float, partners: Batch | None = None
                       ) -> Batch:
    """CutMix if r < cutmix_prob, else MixUp if r < cutmix_prob +
    mixup_prob, else the batch unchanged; the perms index partners (by
    default batch itself). The use_aug gate is in r (gate)."""
    cut = cutmix(batch, d.cutmix, partners)
    mix = mixup(batch, d.mixup, partners)
    is_cut = d.r < cutmix_prob
    is_mix = ~is_cut & (d.r < cutmix_prob + mixup_prob)
    return Batch(*(torch.where(is_cut, c, torch.where(is_mix, m, o))
                   for c, m, o in zip(cut, mix, batch)))
