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
- fit runs inside reproducible(), cuDNN's deterministic algorithms: on the
  card, as in the JAX package, a run is a function of its seed (one seed,
  one history; a resumed run is the run it continues).

Under a data-parallel mesh (fit(mesh=...), the JAX package's streaming
branch) each rank holds only its host shard of the train split
(loader.host_shard) and streams its local batches of batch_size / world
rows from it (loader.stream_batches), each epoch permuted by the same
epoch_rng(seed, e); an epoch has the smallest shard's number of steps, so
every rank runs the same collectives. The step computes
what the single process computes over the global batch (the ranks' local
batches in rank order): global BatchNorm statistics and dropout masks
(models/layers.py), augmentation drawn for the global batch with partner
rows gathered from every rank, and gradients averaged over the ranks by one
all-reduce of their concatenation before clipping. Train loss and accuracy
are reduced over the ranks once an epoch; validation is replicated, rank
0's metrics decide early stopping on every rank, and rank 0 writes the
checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tpu_breath_torch import augment
from tpu_breath_torch.config import FeatureSpec, TrainCfg
from tpu_breath_torch.data import loader
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.models import layers
from tpu_breath_torch.parallel import mesh as mesh_lib
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train import metrics as metrics_mod
from tpu_breath_torch.train.schedule import warmup_cosine


@dataclasses.dataclass
class FitResult:
    best_val_acc: float
    best_ckpt_path: str | None
    model: nn.Module  # with the best weights when cfg.restore_best_weights
    history: list[dict]


@contextlib.contextmanager
def reproducible():
    """cuDNN's deterministic algorithms inside the block (deterministic on,
    benchmark off: no autotuned or atomics-reducing choice), the caller's
    flags restored on exit. Without it cuDNN may pick a backward algorithm
    whose sums land in another order from run to run."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


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
               draws: augment.AugDraw | None = None,
               mesh: mesh_lib.Mesh | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """augment (when draws are given) -> forward -> BCE -> backward ->
    clip -> AdamW at rate lr. Returns (loss, train accuracy against the
    original labels) as device scalars.

    Under a mesh, batch is this rank's rows of the global batch and draws
    are the global batch's: the partners are gathered from every rank, and
    the gradients are averaged over the ranks before clipping (the model's
    layers must point at the mesh: layers.set_mesh). Loss and accuracy are
    this rank's."""
    model.train()
    labels = batch.labels
    if draws is not None:
        partners = None
        if mesh is not None and mesh.world > 1:
            b = labels.shape[0]
            partners = augment.Batch(*(mesh_lib.all_gather_rows(mesh, t)
                                       for t in batch))
            draws = augment.local_rows(
                draws, slice(mesh.rank * b, (mesh.rank + 1) * b))
        batch = augment.apply_augmentation(batch, draws, cfg.cutmix_prob,
                                           cfg.mixup_prob, partners)
    logits = model(batch.features, batch.scalars)
    loss = bce_with_logits(logits, batch.labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if mesh is not None:
        mesh_lib.all_reduce_mean_(mesh, grads)
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


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The generator of an epoch's batch order (the JAX package's,
    loop.py:389): its permutation of the train split, or of a rank's
    shard under a mesh."""
    return np.random.default_rng([seed + 1, epoch])


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The JAX package's batch order for an epoch."""
    return epoch_rng(seed, epoch).permutation(n)


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


def fit_step(model: nn.Module, optimizer: torch.optim.Optimizer, lr: float,
             data: tuple, rows: torch.Tensor | None, cfg: TrainCfg,
             gen: torch.Generator, use_aug: bool,
             fused_spec: FeatureSpec | None = None,
             mesh: mesh_lib.Mesh | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of fit on the rows `rows` of data (rows None: data are the
    batch): data is (features, scalars, labels), or in fused mode (wavs,
    labels) and fused_features turns the wavs into features and scalars;
    then the augmentation of the global batch (cfg.batch_size rows) drawn
    from gen when use_aug, and train_step at rate lr. Returns train_step's
    (loss, accuracy)."""
    def take(t):
        return t if rows is None else t[rows]
    *x, labels = data
    if fused_spec is not None:
        with record_function("fused_features"):  # the gather included
            x = fused_features(take(x[0]), fused_spec)
    else:
        x = [take(t) for t in x]
    batch = augment.Batch(*x, take(labels))
    _, _, h, w = batch.features.shape
    draws = (augment.draw(gen, cfg.batch_size, h, w, cfg.cutmix_alpha,
                          cfg.mixup_alpha, batch.labels.device)
             if use_aug else None)
    args = (model, optimizer, lr, batch, cfg, draws)
    return train_step(*args) if mesh is None else train_step(*args, mesh)


@reproducible()
def fit(model: nn.Module, train_store, val_store, train_labels, val_labels,
        cfg: TrainCfg, save_dir: str | None = None, log_fn=print,
        resume: bool = False, device="cuda",
        fused_spec: FeatureSpec | None = None,
        mesh: mesh_lib.Mesh | None = None) -> FitResult:
    """Full training run with early stopping and best-checkpoint saves.

    train_store / val_store: (features [N, C, H, W], scalars [N, S]) numpy
    arrays. Runs on `device` (the card unless device='cpu'; under a mesh,
    on the mesh's device).

    Fused mode (fused_spec given): train_store is (wavs [N, n_samples],
    None), and each step computes its batch's features with fused_features
    before the unchanged train_step; the validation split stays
    precomputed. Batch order, augmentation and dropout draws are the cached
    mode's.

    mesh: data parallelism (the module docstring); every rank passes the
    whole split and keeps its host shard. Without a mesh the train split
    lives on the device and a step gathers its batch by index.

    The whole run is inside reproducible(), with no way to leave it: the
    JAX package's contract that a seed fixes the history."""
    device = mesh.device if mesh is not None else resolve_device(device)
    n_train = len(train_labels)
    b = cfg.batch_size
    steps_per_epoch = n_train // b  # drop last
    if steps_per_epoch == 0:
        raise ValueError("batch_size larger than the training split")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    if mesh is not None:
        # this rank's host shard; an epoch has the smallest shard's steps
        if b % mesh.world:
            raise ValueError(f"batch_size ({b}) must be a multiple of the "
                             f"mesh size ({mesh.world})")
        local_batch = b // mesh.world
        shard = loader.host_shard(n_train, mesh.rank, mesh.world)
        host = [np.ascontiguousarray(np.asarray(a)[shard], np.float32)
                for a in (train_store[0], train_labels)]
        if fused_spec is None:
            host.insert(1, np.ascontiguousarray(
                np.asarray(train_store[1])[shard], np.float32))
        per = -(-n_train // mesh.world)
        min_shard = n_train - (mesh.world - 1) * per
        steps_per_epoch = min_shard // local_batch
        if steps_per_epoch < 1:
            raise ValueError(
                f"streaming layout needs one full batch on every rank: the "
                f"smallest host shard has {max(min_shard, 0)} of {n_train} "
                f"examples vs a local batch of {local_batch} "
                f"({mesh.world} ranks)")
    elif fused_spec is None:  # (features, scalars, labels) on the device
        train_tr = (put(train_store[0]), put(train_store[1]),
                    put(train_labels))
    else:  # (wavs, labels)
        train_tr = (put(train_store[0]), put(train_labels))
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
    mesh_lib.barrier(mesh)  # every rank has read the checkpoints
    best_weights = _snapshot(model)
    early_stop = 0
    history: list[dict] = []
    cuda_devices = [device.index or 0] if device.type == "cuda" else []
    layers.set_mesh(model, mesh)  # None: each layer's own code
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        use_aug = epoch >= cfg.warmup_epochs
        aug_seed, drop_seed = epoch_seeds(cfg.seed, epoch)
        gen = torch.Generator(device=device).manual_seed(aug_seed)
        if mesh is None:
            perm = torch.from_numpy(epoch_permutation(
                cfg.seed, epoch, n_train)).to(device)
            batches = (perm[s * b:(s + 1) * b]
                       for s in range(steps_per_epoch))
        else:
            batches = loader.stream_batches(
                host, local_batch, epoch_rng(cfg.seed, epoch), depth=2,
                device=device, max_batches=steps_per_epoch)
        losses, accs = [], []
        with torch.random.fork_rng(devices=cuda_devices):
            torch.manual_seed(drop_seed)  # dropout masks
            for item in batches:
                # the ranges name a step's spans in a --profile trace
                with record_function("train_step"):
                    # this rank's streamed rows, or rows of the split
                    data, rows = ((item, None) if mesh is not None
                                  else (train_tr, item))
                    loss, acc = fit_step(model, optimizer, schedule(step),
                                         data, rows, cfg, gen, use_aug,
                                         fused_spec, mesh)
                step += 1
                losses.append(loss)
                accs.append(acc)
        means = torch.stack([torch.stack(losses).double().mean(),
                             torch.stack(accs).double().mean()])
        if mesh is not None:  # the global batch's means
            mesh_lib.all_reduce_mean_(mesh, [means])
        train_loss, train_acc = (float(v) for v in means)

        val = evaluate(model, feats_va, scals_va, val_labels,
                       cfg.eval_batch_size,
                       drop_last=cfg.parity_drop_last_eval)
        if mesh is not None:  # one decision on every rank
            val = mesh_lib.broadcast_object(mesh, val)
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
                meta = {"val_acc": val["acc"], "val_loss": val["loss"]}
                if mesh_lib.is_primary(mesh):
                    best_ckpt = ckpt_lib.save(
                        save_dir, model, epoch + 1, meta,
                        optimizer=optimizer, step=step)
                else:
                    best_ckpt = ckpt_lib.epoch_dir(save_dir, epoch + 1)
                mesh_lib.barrier(mesh)  # rank 0's files are whole
        else:
            early_stop += 1
            if early_stop >= cfg.patience:
                log_fn(f"early stopping at epoch {epoch + 1} "
                       f"(best val acc {best_val_acc:.4f})")
                break
    layers.set_mesh(model, None)

    if cfg.restore_best_weights:
        model.load_state_dict(best_weights)
    return FitResult(best_val_acc=best_val_acc, best_ckpt_path=best_ckpt,
                     model=model, history=history)
