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
  until the end of the epoch, which reads them and the validation logits
  with one wait.
- On the card a step is one replay of a CUDA graph of the whole step
  (TrainStep, the JAX package's jitted make_train_step) and an evaluation
  batch one replay of a graph of the forward (Predictor, its
  make_eval_step); on the CPU the same programs run eagerly.
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
are reduced over the ranks once an epoch. Validation is sharded as the
JAX package's make_eval_step(model, mesh) shards it: each padded eval batch
split over the ranks in rank order and the logits all-gathered, so every
rank holds them all; rank 0's metrics decide early stopping on every rank,
and rank 0 writes the checkpoints. On an NCCL mesh (one rank a card) the
streamed step and an evaluation batch are each one CUDA graph, collectives
included (parallel/mesh.replays); on a gloo mesh (CPU ranks, ranks sharing
a card), whose collectives cannot be captured, the same programs run
eagerly.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tpu_breath_torch import augment, graphs
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


class AdamW(torch.optim.Optimizer):
    """optax.adamw(lr, b1, b2, eps, weight_decay) as tensor operations, one
    code path on the CPU and on the card, nothing read on the host, so a
    CUDA graph can hold a step: the moments by torch._foreach_* ops, the
    step count a device tensor (optax's count, advanced before use), the
    bias corrections 1 - b**count in f32 from it, the decayed update
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p) in optax's
    order, and the rate a 0-d f32 tensor on the parameters' device (or a
    float, written into such a tensor). Every parameter decays, as optax's
    adamw without a mask.

    The state exists from construction, in torch.optim.AdamW's layout:
    each parameter's "exp_avg", "exp_avg_sq" and "step" (one f32 tensor
    that every parameter shares). load_state_dict copies into these
    tensors, so a graph captured before a restore reads the restored
    values."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        ps = [p for g in self.param_groups for p in g["params"]]
        device = ps[0].device
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        self.rate = torch.full((), lr, dtype=torch.float32, device=device)
        for p in ps:
            self.state[p] = {"step": self.count,
                             "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, lr) -> None:
        """One update of every parameter that has a gradient, at rate lr."""
        if not torch.is_tensor(lr):
            lr = self.rate.fill_(lr)
        neg_lr = -lr
        self.count.add_(1)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            m = [self.state[p]["exp_avg"] for p in ps]
            v = [self.state[p]["exp_avg_sq"] for p in ps]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            m_hat = torch._foreach_div(m, 1 - torch.pow(b1, self.count))
            v_hat = torch._foreach_div(v, 1 - torch.pow(b2, self.count))
            torch._foreach_sqrt_(v_hat)
            torch._foreach_add_(v_hat, group["eps"])
            update = torch._foreach_div(m_hat, v_hat)
            torch._foreach_add_(update, ps, alpha=group["weight_decay"])
            torch._foreach_mul_(update, neg_lr)
            torch._foreach_add_(ps, update)

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, then every value copied into this optimizer's own
        state tensors (on the parameters' device)."""
        own = dict(self.state)
        super().load_state_dict(state_dict)
        for p, loaded in self.state.items():
            for k, v in loaded.items():
                own[p][k].copy_(v)
        self.state = collections.defaultdict(dict, own)


def make_optimizer(model: nn.Module, cfg: TrainCfg) -> AdamW:
    """optax.adamw(b1 0.9, b2 0.999, eps 1e-8, weight_decay) over every
    parameter; the rate is given at each step."""
    return AdamW(model.parameters(), lr=cfg.base_lr, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=cfg.weight_decay)


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


def train_step(model: nn.Module, optimizer: AdamW,
               lr, batch: augment.Batch, cfg: TrainCfg,
               draws: augment.AugDraw | None = None,
               mesh: mesh_lib.Mesh | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """augment (when draws are given) -> forward -> BCE -> backward ->
    clip -> AdamW at rate lr (a float or a 0-d f32 device tensor). Returns
    (loss, train accuracy against the original labels) as device scalars.

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
    optimizer.step(lr)
    acc = ((logits.detach() > 0).float() == labels).float().mean()
    return loss.detach(), acc


class Predictor:
    """Eval-mode f32 logits of `model` on the rows of (feats, scals),
    tensors on the model's device: the JAX package's make_eval_step and
    the padding of its evaluate (tpu_breath/train/loop.py:203-233). Rows go
    in batches of batch_size, the tail padded with its last row and the
    padding's logits dropped, so every batch has one shape.

    Under a mesh (make_eval_step(model, mesh)) a batch is split over the
    ranks in rank order, padded further with its last row to a multiple of
    the world; each rank runs the forward on its rows and the logits are
    all-gathered, so every rank returns them all.

    On the card (under a mesh: an NCCL mesh, mesh_lib.replays) each batch
    is one replay of a CUDA graph of the gather, the forward and the
    logits' all-gather (one graph per global flags, graphs.global_flags,
    captured at its first use and kept while the Predictor lives); the
    logits are gathered on the device and copied into a pinned host
    tensor, readable after one graphs.wait. The
    model's parameters and statistics change in place (AdamW,
    load_state_dict), so one graph serves a whole fit. On the CPU, on a
    gloo mesh, or inside graphs.eager(), the same program runs eagerly."""

    def __init__(self, model: nn.Module, feats: torch.Tensor,
                 scals: torch.Tensor, batch_size: int,
                 mesh: mesh_lib.Mesh | None = None):
        self.model, self.feats, self.scals = model, feats, scals
        self.batch_size, self.mesh = batch_size, mesh
        self.graphs: dict = {}

    def forward(self, rows: torch.Tensor) -> torch.Tensor:
        """The program: logits of rows (int64 on the device; under a mesh
        this rank's rows of a batch, the logits the whole batch's)."""
        logits = self.model(self.feats[rows], self.scals[rows]).float()
        if self.mesh is None:
            return logits
        return mesh_lib.all_gather_rows(self.mesh, logits)

    @torch.no_grad()
    def __call__(self, n: int | None = None) -> torch.Tensor:
        """Logits [n] of rows [0, n) (all by default), in a host tensor
        that is complete once the current stream is done (graphs.wait)."""
        n = self.feats.shape[0] if n is None else n
        device = self.feats.device
        cuda = device.type == "cuda"
        self.model.eval()
        b = self.batch_size
        n_pad = -(-n // b) * b
        rank, world = ((0, 1) if self.mesh is None
                       else (self.mesh.rank, self.mesh.world))
        per = -(-b // world)  # a rank's rows of a batch
        # rows [k, i]: row i of this rank's share of batch k
        share = torch.arange(rank * per, (rank + 1) * per, device=device)
        rows = (torch.arange(0, n_pad, b, device=device)[:, None]
                + share.clamp_(max=b - 1)).clamp_(max=max(n - 1, 0))
        out = torch.empty(n_pad, dtype=torch.float32, device=device)
        key = graphs.global_flags()
        for k, lo in enumerate(range(0, n_pad, b)):
            if not _replays(device, self.mesh):
                out[lo:lo + b] = self.forward(rows[k])[:b]
                continue
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = graphs.Graph(
                    self.forward, (rows[k],), device)
            out[lo:lo + b] = graph(rows[k])[:b]
        host = torch.empty(n, dtype=torch.float32, pin_memory=cuda)
        return host.copy_(out[:n], non_blocking=cuda)


def _replays(device, mesh: mesh_lib.Mesh | None) -> bool:
    """Whether a program on device (under mesh) runs as a graph."""
    return graphs.replays(device) if mesh is None else mesh_lib.replays(mesh)


def predict_logits(model: nn.Module, feats: torch.Tensor,
                   scals: torch.Tensor, batch_size: int) -> np.ndarray:
    """Eval-mode f32 logits [N] of tensors already on the model's device,
    through a Predictor (one wait on the card)."""
    predict = Predictor(model, feats, scals, batch_size)
    logits = predict()
    if feats.device.type == "cuda":
        graphs.wait(feats.device)
    del predict
    graphs.release(feats.device)
    return logits.numpy()


def evaluate(predict: Predictor, labels_np: np.ndarray,
             drop_last: bool = False) -> dict:
    """Loss, accuracy, AUC, precision, recall, F1 and the probability range
    over predict's rows (the JAX package's evaluate). Work queued on the
    current stream before the call (fit's epoch means) is complete after
    it: it waits once."""
    n = len(labels_np)
    n_use = (n // predict.batch_size) * predict.batch_size if drop_last else n
    logits = predict(n_use)
    if predict.feats.device.type == "cuda":
        graphs.wait(predict.feats.device)
    logits = logits.numpy()
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


@torch.no_grad()
def fused_features(wavs: torch.Tensor, spec: FeatureSpec, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step's features of a gathered batch wavs [b, n]:
    extract_features on chunks of `chunk` clips (precompute's geometry)
    when b is a larger multiple of it, else one call
    (tpu_breath/train/loop.py::_maybe_fused_features). The same kernels as
    precompute's chunk graph (features.extract_features_compiled), so the
    features equal the cache's bit for bit; on the card the step's own
    graph holds them (a graph cannot replay inside another's capture)."""
    b = wavs.shape[0]
    if not (b > chunk and b % chunk == 0):
        chunk = b
    feats = torch.empty((b, spec.n_channels, spec.n_mels, spec.t_fixed),
                        device=wavs.device)
    scals = torch.empty((b, spec.n_scalars), device=wavs.device)
    for lo in range(0, b, chunk):
        f, s = extract_features(wavs[lo:lo + chunk], spec)
        feats[lo:lo + chunk].copy_(f)
        scals[lo:lo + chunk].copy_(s)
    return feats, scals


def fit_step(model: nn.Module, optimizer: AdamW, lr, data: tuple,
             rows: torch.Tensor | None, cfg: TrainCfg, gen: torch.Generator,
             use_aug, fused_spec: FeatureSpec | None = None,
             mesh: mesh_lib.Mesh | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of fit on the rows `rows` of data (rows None: data are the
    batch): data is (features, scalars, labels), or in fused mode (wavs,
    labels) and fused_features turns the wavs into features and scalars;
    then the augmentation of the global batch (cfg.batch_size rows), drawn
    from gen in every step and gated by use_aug (a bool or a bool device
    scalar), as the JAX package draws and gates it; and train_step at rate
    lr. Returns train_step's (loss, accuracy)."""
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
    draws = augment.gate(augment.draw(gen, cfg.batch_size, h, w,
                                      cfg.cutmix_alpha, cfg.mixup_alpha,
                                      batch.labels.device), use_aug)
    args = (model, optimizer, lr, batch, cfg, draws)
    return train_step(*args) if mesh is None else train_step(*args, mesh)


class TrainStep:
    """fit's step as one program (the JAX package's jitted make_train_step,
    tpu_breath/train/loop.py:84-200, and under a mesh its
    make_train_step_batched, :128-135): fit_step, its inputs given as
    tensors on one device. With data, the resident train split (cached:
    (features, scalars, labels); fused_spec given: (wavs, labels)),
    step(rows, lr, use_aug) steps on the rows [batch_size] int64 of it.
    With data None (the streamed input under a mesh), step(*batch, lr,
    use_aug) steps on the batch itself, this rank's rows of the global
    batch as loader.Prefetcher hands them over. lr () f32 and use_aug ()
    bool; gen is the augmentation's generator. Returns (loss, accuracy)
    device scalars.

    On the card (under a mesh: an NCCL mesh, mesh_lib.replays), the first
    call runs the step eagerly on the capture stream (the run's real first
    step; under a mesh it issues every collective of the step, so the
    communicator exists before the capture) and captures it (graphs.Graph,
    gen registered, a capture advancing no generator; in the default
    capture mode, as the single process's); every later call copies its
    inputs in on the current stream and replays the whole step,
    collectives included, with one launch and no host wait. Every rank
    captures at its first step, so the ranks' collectives keep one order.
    One graph per global flags (graphs.global_flags), kept while the
    TrainStep lives. The returned scalars are the graph's static outputs:
    copy them before the next call. On the CPU, on a gloo mesh, or inside
    graphs.eager(), every call runs the step eagerly."""

    def __init__(self, model: nn.Module, optimizer: AdamW,
                 data: tuple | None, cfg: TrainCfg, gen: torch.Generator,
                 fused_spec: FeatureSpec | None = None,
                 mesh: mesh_lib.Mesh | None = None):
        self.model, self.optimizer, self.data = model, optimizer, data
        self.cfg, self.gen, self.fused_spec = cfg, gen, fused_spec
        self.mesh = mesh
        self.graphs: dict = {}

    def body(self, *xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        *x, lr, use_aug = xs
        data, rows = ((tuple(x), None) if self.data is None
                      else (self.data, x[0]))
        return fit_step(self.model, self.optimizer, lr, data, rows, self.cfg,
                        self.gen, use_aug, self.fused_spec, self.mesh)

    def __call__(self, *xs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        device = xs[0].device
        if not _replays(device, self.mesh):
            return self.body(*xs)
        key = graphs.global_flags()
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = graphs.Graph(
                self.body, xs, device, generators=(self.gen,))
            return graph.warm_out
        return graph(*xs)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """x on device without a host wait (pinned staging on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
    whole split, keeps its host shard and streams its batches. Without a
    mesh the train split lives on the device and a step gathers its batch
    by index. Either way every step is a call of one TrainStep (on the
    card, and under a mesh on NCCL only: the first step eager and
    captured, every later one a replay; on a gloo mesh every step eager)
    and the validation split goes through one Predictor (sharded over a
    mesh; one replay a padded batch where the steps replay). Both, with
    their graphs, are released when fit returns. An epoch waits on the
    host once, at its end, for its loss, accuracy and validation logits.

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
        train_tr = None  # streamed: a step's input is its batch
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
    cuda = device.type == "cuda"
    cuda_devices = [device.index or 0] if cuda else []
    # one augmentation generator, re-seeded in place each epoch
    gen = torch.Generator(device=device)
    predict = Predictor(model, feats_va, scals_va, cfg.eval_batch_size, mesh)
    run_step = TrainStep(model, optimizer, train_tr, cfg, gen, fused_spec,
                         mesh)
    gate = {on: torch.full((), on, dtype=torch.bool, device=device)
            for on in (False, True)}
    losses = torch.empty(steps_per_epoch, device=device)
    accs = torch.empty(steps_per_epoch, device=device)
    means_host = torch.empty(2, dtype=torch.float64, pin_memory=cuda)

    def step_into(s: int, item: torch.Tensor, lr: torch.Tensor,
                  use_aug: bool) -> None:
        """Step s of an epoch, its loss and accuracy copied into the epoch's
        buffers (a graph's next replay overwrites its outputs)."""
        x = (item,) if mesh is None else item  # rows, or the streamed batch
        loss, acc = run_step(*x, lr, gate[use_aug])
        losses[s].copy_(loss)
        accs[s].copy_(acc)

    layers.set_mesh(model, mesh)  # None: each layer's own code
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        use_aug = epoch >= cfg.warmup_epochs
        aug_seed, drop_seed = epoch_seeds(cfg.seed, epoch)
        gen.manual_seed(aug_seed)
        rates = _upload(np.float32([schedule(step + s)
                                    for s in range(steps_per_epoch)]), device)
        if mesh is None:
            perm = _upload(epoch_permutation(cfg.seed, epoch, n_train),
                           device)
            batches = (perm[s * b:(s + 1) * b]
                       for s in range(steps_per_epoch))
        else:
            batches = loader.stream_batches(
                host, local_batch, epoch_rng(cfg.seed, epoch), depth=2,
                device=device, max_batches=steps_per_epoch)
        with torch.random.fork_rng(devices=cuda_devices):
            torch.manual_seed(drop_seed)  # dropout masks
            for s, item in enumerate(batches):
                # the ranges name a step's spans in a --profile trace
                with record_function("train_step"):
                    step_into(s, item, rates[s], use_aug)
                step += 1
        means = torch.stack([losses.double().mean(), accs.double().mean()])
        if mesh is not None:  # the global batch's means
            mesh_lib.all_reduce_mean_(mesh, [means])
        means_host.copy_(means, non_blocking=cuda)
        val = evaluate(predict, val_labels,  # the epoch's one wait
                       drop_last=cfg.parity_drop_last_eval)
        train_loss, train_acc = means_host.tolist()
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
    # the gradients of a captured step live in its graph's pool
    optimizer.zero_grad(set_to_none=True)
    del step_into, run_step, predict  # and their graphs
    graphs.release(device)

    if cfg.restore_best_weights:
        model.load_state_dict(best_weights)  # copy_ into the live tensors
    return FitResult(best_val_acc=best_val_acc, best_ckpt_path=best_ckpt,
                     model=model, history=history)
