"""The training loop's CutMix and MixUp, written again from its documented
rules, so the reference can follow a step with augmentation on.

Draws: a step draws from one torch.Generator on the batch's device,
re-seeded with the epoch's augmentation seed at the epoch's start, in this
order: r ~ U[0, 1) (f32); CutMix's partner permutation of the batch, its
lambda ~ Beta(cutmix_alpha, cutmix_alpha), the box centre cx in [0, W) and
cy in [0, H); MixUp's partner permutation and its lambda ~ Beta(mixup_alpha,
mixup_alpha). A Beta(a, a) draw is Johnk's method on 64 candidate pairs
(u, v) ~ U[0, 1)^2 in float64 drawn at once: x = u^(1/a), y = v^(1/a), the
first pair with 0 < x + y <= 1 gives x / (x + y), as f32. A step draws
whether or not augmentation is on.

Apply: CutMix if r < cutmix_prob, else MixUp if r < cutmix_prob +
mixup_prob, else the batch unchanged. CutMix pastes the partner's box
[cy - h'/2, cy + h'/2) x [cx - w'/2, cx + w'/2) (clamped to the map, h' =
int(H sqrt(1 - lambda)), w' likewise, halves by floor division) into every
row's features, leaves the scalars, and mixes the labels by the box's real
share of the map; MixUp mixes features, scalars and labels by lambda."""
from __future__ import annotations

import torch

TRIES = 64


def _beta(g: torch.Generator, alpha: float, device) -> torch.Tensor:
    u = torch.rand(2, TRIES, generator=g, device=device, dtype=torch.float64)
    x, y = u[0] ** (1.0 / alpha), u[1] ** (1.0 / alpha)
    s = x + y
    ok = ((s <= 1.0) & (s > 0.0)).nonzero()
    i = int(ok[0, 0]) if len(ok) else 0
    return (x[i] / max(float(s[i]), torch.finfo(torch.float64).tiny)).float()


def draws(seed: int, steps: int, b: int, h: int, w: int, train: dict,
          device) -> list[dict]:
    """The first `steps` steps' draws of an epoch whose augmentation seed
    is `seed`, for a batch of b rows of h x w maps."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(steps):
        r = float(torch.rand((), generator=g, device=device))
        cut_perm = torch.randperm(b, generator=g, device=device)
        cut_lam = float(_beta(g, train["cutmix_alpha"], device))
        cx = int(torch.randint(0, w, (), generator=g, device=device))
        cy = int(torch.randint(0, h, (), generator=g, device=device))
        mix_perm = torch.randperm(b, generator=g, device=device)
        mix_lam = float(_beta(g, train["mixup_alpha"], device))
        if r < train["cutmix_prob"]:
            out.append({"kind": "cutmix", "perm": cut_perm, "lam": cut_lam,
                        "cx": cx, "cy": cy})
        elif r < train["cutmix_prob"] + train["mixup_prob"]:
            out.append({"kind": "mixup", "perm": mix_perm, "lam": mix_lam})
        else:
            out.append({"kind": "none"})
    return out


def apply(batch: tuple, d: dict) -> tuple:
    """(features, scalars, labels) augmented by one step's draw d."""
    f, s, y = batch
    if d["kind"] == "none":
        return batch
    p, lam = d["perm"], d["lam"]
    if d["kind"] == "mixup":
        return (lam * f + (1 - lam) * f[p], lam * s + (1 - lam) * s[p],
                lam * y + (1 - lam) * y[p])
    _, _, h, w = f.shape
    # the box's sides in float32, as the loop computes them
    rat = torch.sqrt(1.0 - torch.tensor(lam, dtype=torch.float32))
    cut_w, cut_h = int(w * rat), int(h * rat)

    def side(c: int, half: int, n: int) -> tuple[int, int]:
        return min(max(c - half, 0), n), min(max(c + half, 0), n)
    x1, x2 = side(d["cx"], cut_w // 2, w)
    y1, y2 = side(d["cy"], cut_h // 2, h)
    mixed = f.clone()
    mixed[:, :, y1:y2, x1:x2] = f[p][:, :, y1:y2, x1:x2]
    share = 1.0 - torch.tensor((x2 - x1) * (y2 - y1),
                               dtype=torch.float32) / (w * h)
    return mixed, s, share.to(y.device) * y + (1 - share.to(y.device)) * y[p]
