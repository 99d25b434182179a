"""Training engine (counterpart of tpu_breath/train/loop.py, its
single-device resident path): BCE on logits, global-norm clipping, AdamW
with a warmup-cosine rate, CutMix/MixUp, early stopping on val accuracy,
best checkpoints and faithful resume.

- The train split lives on the device; a step gathers its batch by index:
  features, or in fused mode wavs that the step turns into features.
- Batch order is the JAX package's: epoch e shuffles with
  np.random.default_rng([seed + 1, e]).permutation(n), drop-last batches.
- Every other random draw of epoch e (augmentation, dropout) comes from
  generators seeded from (seed, e), so a resumed run replays the epochs
  after its checkpoint exactly as the uninterrupted run ran them.
- A step never waits for the host: losses and accuracies stay on the device
  until the end of the epoch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tpu_breath_torch import augment
from tpu_breath_torch.config import FeatureSpec, TrainCfg
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train import metrics as metrics_mod
from tpu_breath_torch.train.schedule import warmup_cosine


@dataclasses.dataclass
class FitResult:
    best_val_acc: float
    best_ckpt_path: str | None
    model: nn.Module  # with the best weights when cfg.restore_best_weights
    history: list[dict]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in f32."""
    z, y = logits.float(), labels.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def make_optimizer(model: nn.Module, cfg: TrainCfg) -> torch.optim.AdamW:
    """optax.adamw(b1 0.9, b2 0.999, eps 1e-8, weight_decay) over every
    parameter; the rate is set before each step."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.base_lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    max_norm, g <- (g / norm) * max_norm; below it g is untouched. (No
    +1e-6 as in torch.nn.utils.clip_grad_norm_.) Returns the norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    clip = norm >= max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))
    return norm


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               lr: float, batch: augment.Batch, cfg: TrainCfg,
               draws: augment.AugDraw | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """augment (when draws are given) -> forward -> BCE -> backward ->
    clip -> AdamW at rate lr. Returns (loss, train accuracy against the
    original labels) as device scalars."""
    model.train()
    labels = batch.labels
    if draws is not None:
        batch = augment.apply_augmentation(batch, draws, cfg.cutmix_prob,
                                           cfg.mixup_prob)
    logits = model(batch.features, batch.scalars)
    loss = bce_with_logits(logits, batch.labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    clip_by_global_norm_(grads, cfg.grad_clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    acc = ((logits.detach() > 0).float() == labels).float().mean()
    return loss.detach(), acc


@torch.no_grad()
def predict_logits(model: nn.Module, feats: torch.Tensor,
                   scals: torch.Tensor, batch_size: int) -> np.ndarray:
    """Eval-mode f32 logits [N] of tensors already on the model's device."""
    model.eval()
    out = [model(feats[lo:lo + batch_size], scals[lo:lo + batch_size]
                 ).float() for lo in range(0, feats.shape[0], batch_size)]
    if not out:
        return np.empty(0, np.float32)
    return torch.cat(out).cpu().numpy()


def evaluate(model: nn.Module, feats: torch.Tensor, scals: torch.Tensor,
             labels_np: np.ndarray, batch_size: int,
             drop_last: bool = False) -> dict:
    """Loss, accuracy, AUC, precision, recall, F1 and the probability range
    over the split (the JAX package's evaluate)."""
    n = len(labels_np)
    n_use = (n // batch_size) * batch_size if drop_last else n
    logits = predict_logits(model, feats[:n_use], scals[:n_use], batch_size)
    labels = np.asarray(labels_np[:n_use])
    probs = 1.0 / (1.0 + np.exp(-logits))
    m = metrics_mod.binary_metrics(probs, labels)
    m["loss"] = float(np.mean(np.maximum(logits, 0) - logits * labels
                              + np.log1p(np.exp(-np.abs(logits)))))
    m["prob_min"] = float(probs.min()) if n_use else 0.0
    m["prob_max"] = float(probs.max()) if n_use else 0.0
    return m


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The JAX package's batch order for an epoch (loop.py:389)."""
    return np.random.default_rng([seed + 1, epoch]).permutation(n)


def epoch_seeds(seed: int, epoch: int) -> tuple[int, int]:
    """(augmentation seed, dropout seed) of an epoch, from (seed, epoch)."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2)
    return int(a), int(b)


def _snapshot(model: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def fused_features(wavs: torch.Tensor, spec: FeatureSpec, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step's features of a gathered batch wavs [b, n]: chunks of
    `chunk` clips (precompute's geometry) when b is a larger multiple of
    it, else one call (tpu_breath/train/loop.py::_maybe_fused_features)."""
    b = wavs.shape[0]
    if b > chunk and b % chunk == 0:
        parts = [extract_features(wavs[lo:lo + chunk], spec)
                 for lo in range(0, b, chunk)]
        return (torch.cat([f for f, _ in parts]),
                torch.cat([s for _, s in parts]))
    return extract_features(wavs, spec)


def fit(model: nn.Module, train_store, val_store, train_labels, val_labels,
        cfg: TrainCfg, save_dir: str | None = None, log_fn=print,
        resume: bool = False, device="cuda",
        fused_spec: FeatureSpec | None = None) -> FitResult:
    """Full training run with early stopping and best-checkpoint saves.

    train_store / val_store: (features [N, C, H, W], scalars [N, S]) numpy
    arrays. Runs on `device` (the card unless device='cpu').

    Fused mode (fused_spec given): train_store is (wavs [N, n_samples],
    None), the wavs stay on the device, and each step computes its batch's
    features with fused_features before the unchanged train_step; the
    validation split stays precomputed. Batch order, augmentation and
    dropout draws are the cached mode's."""
    device = resolve_device(device)
    n_train = len(train_labels)
    b = cfg.batch_size
    steps_per_epoch = n_train // b  # drop last
    if steps_per_epoch == 0:
        raise ValueError("batch_size larger than the training split")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    if fused_spec is None:
        feats_tr, scals_tr = put(train_store[0]), put(train_store[1])
        _, _, h, w = feats_tr.shape
    else:
        wavs_tr = put(train_store[0])
        h, w = fused_spec.n_mels, fused_spec.t_fixed
    labels_tr = put(train_labels)
    feats_va, scals_va = put(val_store[0]), put(val_store[1])

    model.to(device)
    optimizer = make_optimizer(model, cfg)
    schedule = warmup_cosine(cfg.base_lr, steps_per_epoch * cfg.num_epochs,
                             cfg.warmup_frac, cfg.lr_start_factor,
                             cfg.lr_eta_min)
    step, start_epoch = 0, 0
    best_val_acc, best_val_loss = 0.0, float("inf")
    best_ckpt = ckpt_lib.latest_checkpoint(save_dir) if save_dir else None
    if resume and best_ckpt:
        # the newest checkpoint is the best one so far: the early-stop count
        # restarts at 0 and the best metrics are its own
        step, start_epoch = ckpt_lib.restore_train_state(best_ckpt, model,
                                                         optimizer)
        meta = ckpt_lib.load_metadata(best_ckpt)
        best_val_acc = float(meta.get("val_acc", 0.0))
        best_val_loss = float(meta.get("val_loss", float("inf")))
        log_fn(f"resumed from epoch {start_epoch} "
               f"(best val acc {best_val_acc:.4f})")
    else:
        best_ckpt = None
    best_weights = _snapshot(model)
    early_stop = 0
    history: list[dict] = []
    cuda_devices = [device.index or 0] if device.type == "cuda" else []

    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        use_aug = epoch >= cfg.warmup_epochs
        perm = torch.from_numpy(epoch_permutation(cfg.seed, epoch, n_train)
                                ).to(device)
        aug_seed, drop_seed = epoch_seeds(cfg.seed, epoch)
        gen = torch.Generator(device=device).manual_seed(aug_seed)
        losses, accs = [], []
        with torch.random.fork_rng(devices=cuda_devices):
            torch.manual_seed(drop_seed)  # dropout masks
            for s in range(steps_per_epoch):
                # the ranges name a step's spans in a --profile trace
                with record_function("train_step"):
                    idx = perm[s * b:(s + 1) * b]
                    if fused_spec is None:
                        feats, scals = feats_tr[idx], scals_tr[idx]
                    else:
                        with record_function("fused_features"):
                            feats, scals = fused_features(wavs_tr[idx],
                                                          fused_spec)
                    batch = augment.Batch(feats, scals, labels_tr[idx])
                    draws = (augment.draw(gen, b, h, w, cfg.cutmix_alpha,
                                          cfg.mixup_alpha, device)
                             if use_aug else None)
                    loss, acc = train_step(model, optimizer, schedule(step),
                                           batch, cfg, draws)
                step += 1
                losses.append(loss)
                accs.append(acc)
        train_loss = float(torch.stack(losses).double().mean())
        train_acc = float(torch.stack(accs).double().mean())

        val = evaluate(model, feats_va, scals_va, val_labels,
                       cfg.eval_batch_size,
                       drop_last=cfg.parity_drop_last_eval)
        row = {"epoch": epoch + 1, "train_loss": train_loss,
               "train_acc": train_acc, "val_loss": val["loss"],
               "val_acc": val["acc"], "val_auc": val["auc"],
               "val_f1": val["f1"], "val_precision": val["precision"],
               "val_recall": val["recall"], "lr": schedule(step),
               "sec": time.time() - t0}
        history.append(row)
        log_fn(f"[Epoch {epoch + 1:03d}] aug={'ON' if use_aug else 'OFF'} "
               f"train loss {train_loss:.4f} acc {train_acc:.4f} | "
               f"val loss {val['loss']:.4f} acc {val['acc']:.4f} "
               f"auc {val['auc']:.4f} f1 {val['f1']:.4f} "
               f"p∈[{val['prob_min']:.3f},{val['prob_max']:.3f}] "
               f"lr {row['lr']:.2e} ({row['sec']:.1f}s)")

        metric = val["acc"] if cfg.monitor == "val_acc" else -val["loss"]
        best_metric = (best_val_acc if cfg.monitor == "val_acc"
                       else -best_val_loss)
        if metric - best_metric > cfg.min_delta:
            best_val_acc, best_val_loss = val["acc"], val["loss"]
            best_weights = _snapshot(model)
            early_stop = 0
            if save_dir:
                best_ckpt = ckpt_lib.save(
                    save_dir, model, epoch + 1,
                    {"val_acc": val["acc"], "val_loss": val["loss"]},
                    optimizer=optimizer, step=step)
        else:
            early_stop += 1
            if early_stop >= cfg.patience:
                log_fn(f"early stopping at epoch {epoch + 1} "
                       f"(best val acc {best_val_acc:.4f})")
                break

    if cfg.restore_best_weights:
        model.load_state_dict(best_weights)
    return FitResult(best_val_acc=best_val_acc, best_ckpt_path=best_ckpt,
                     model=model, history=history)
