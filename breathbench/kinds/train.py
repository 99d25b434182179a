"""Training traffic: `train` (cached features) or `train --fused` (from
the wavs), as the CLI runs them: loop.fit over a seeded labelled dataset.

Parameters: n_labelled (clips, split by the port's split_train_val as the
CLI splits them), fused (the train split's wavs resident on the device and
the feature graph inside the step; else every clip precomputed in set-up),
chunk (precompute's clips a call), checked_steps (the first steps the
reference follows), eval_sample (validation clips the reference scores),
reference (its numerics: "f32", or "bf16" for the body as the program
computes it on the card, reference/layers.py), trace_epochs (epochs the
profiler covers).

Set-up: the data and weights, the precompute (the validation split, or
every clip), the model, and fit's first epoch (its eager first step and
the captures). The window runs from the end of epoch 1 to the first epoch
end after --seconds (fit calls log_fn once an epoch; the harness stops fit
there) at which the check's records are kept: the first step of the first
epoch with augmentation on (warmup_epochs) and that epoch's evaluation,
both inside the window. A fit that ends before is followed by the next
run's fit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from breathbench import check, data, flops, harness, program
from breathbench.reference import augment as ref_aug
from breathbench.reference import train as ref_train


class StopWindow(Exception):
    """Raised from fit's log_fn to end the window."""


class Window:
    """fit's log_fn: the window starts at the first epoch's end and stops
    fit at the first epoch end past `seconds` at which the recorder has
    kept all it keeps."""

    def __init__(self, run: harness.Run, recorder):
        self.run, self.recorder = run, recorder
        self.start = self.end = None
        self.epochs = 0
        self.traced_epochs = 0
        self.nan_epochs = 0

    def __call__(self, message: str) -> None:
        now = time.perf_counter()
        if self.start is None:
            self.start = now
            self.run.counters["setup_s"] = now - self.run.process_start
            if self.run.tracer is not None:
                self.run.tracer.start()
            return
        self.epochs += 1
        self.nan_epochs += "nan" in message
        tracer = self.run.tracer
        if tracer is not None and tracer.prof is not None \
                and self.epochs >= self.run.size("trace_epochs"):
            tracer.stop()
            self.traced_epochs = self.epochs
        if now - self.start >= self.run.seconds and self.recorder.done:
            self.end = now
            raise StopWindow


class Segment:
    """Steps [first, first + n) of the run's TrainStep calls (1: the run's
    first step): before the first, the model's state and AdamW's moments
    and step count; after each, its loss; after the first, each leaf's
    gradient as AdamW got it, (m1 - b1 m0) / (1 - b1) from its first
    moments m0 before and m1 after; after the last, each leaf's value."""

    def __init__(self, first: int, n: int):
        self.first, self.n = first, n
        self.losses, self.state, self.moments = [], None, None
        self.grads, self.params = None, None

    @torch.no_grad()
    def before(self, call: int, step) -> None:
        if call != self.first:
            return
        opt = step.optimizer
        named = list(step.model.named_parameters())
        self.state = {k: v.detach().clone()
                      for k, v in step.model.state_dict().items()}
        self.moments = tuple(
            {k: opt.state[p][key].clone() for k, p in named}
            for key in ("exp_avg", "exp_avg_sq")) + (
            opt.state[named[0][1]]["step"].clone(),)

    @torch.no_grad()
    def after(self, call: int, step, out) -> None:
        if not self.first <= call < self.first + self.n:
            return
        self.losses.append(out[0].detach().clone())
        opt = step.optimizer
        named = list(step.model.named_parameters())
        if call == self.first:
            b1 = opt.param_groups[0]["betas"][0]
            m0 = self.moments[0]
            self.grads = {k: (opt.state[p]["exp_avg"] - b1 * m0[k]) / (1 - b1)
                          for k, p in named}
        if call == self.first + self.n - 1:
            self.params = {k: p.detach().clone() for k, p in named}

    @property
    def done(self) -> bool:
        return self.params is not None

    def summary(self) -> dict:
        norm = torch.linalg.vector_norm
        return {"losses": [float(x) for x in self.losses],
                "grad_norms": {k: float(norm(g.float()))
                               for k, g in self.grads.items()},
                "change_norms": {k: float(norm(p.float()
                                               - self.state[k].float()))
                                 for k, p in self.params.items()}}


class Recorder:
    """What the check compares, kept as fit runs: the segments of its
    TrainStep calls (loop.TrainStep wrapped), and one evaluation: the
    model's state when its `eval_call`-th Predictor call (1: epoch 0's)
    starts, and the validation logits that call returns (loop.Predictor
    wrapped)."""

    def __init__(self, segments: list, eval_call: int):
        self.segments, self.eval_call = segments, eval_call
        self.calls = self.eval_calls = 0
        self.eval_state = self.eval_logits = None

    def wrap_step(self, base):
        rec = self

        class Recorded(base):
            def __call__(self, *xs):
                call = rec.calls + 1
                for seg in rec.segments:
                    seg.before(call, self)
                out = super().__call__(*xs)
                rec.calls = call
                for seg in rec.segments:
                    seg.after(call, self, out)
                return out
        return Recorded

    def wrap_predictor(self, base):
        rec = self

        class Recorded(base):
            def __call__(self, n=None):
                rec.eval_calls += 1
                if rec.eval_calls != rec.eval_call:
                    return super().__call__(n)
                with torch.no_grad():
                    rec.eval_state = {k: v.detach().clone() for k, v in
                                      self.model.state_dict().items()}
                rec.eval_logits = super().__call__(n)  # read after fit's wait
                return rec.eval_logits
        return Recorded

    @property
    def done(self) -> bool:
        return all(s.done for s in self.segments) \
            and self.eval_logits is not None


def _probes(run, model, config, cfg, spec, wav_tr, feats_tr, y_tr, fused
            ) -> None:
    """After the window, in a traced run: ms of one cached step replay at
    the batch, ms of the fused step's features (its chunk graph replayed
    batch / chunk times), and the yardstick's FLOPs of one step
    (flops.step)."""
    from tpu_breath_torch import features, graphs
    from tpu_breath_torch.train import loop

    dev, b = run.device, cfg.batch_size
    chunk = run.size("chunk")
    if feats_tr is None:  # fused: the batch's features by the chunk graph
        feats_tr = features.extract_features_batched(wav_tr[:b], spec, chunk,
                                                     device=dev)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(x[:b])).to(dev)
                  for x in (*feats_tr, y_tr))
    rows = torch.arange(b, device=dev)
    lr = torch.full((), cfg.base_lr, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with loop.reproducible():
        step = loop.TrainStep(model, loop.make_optimizer(model, cfg), batch,
                              cfg, gen)
        run.counters["step_ms"] = harness.event_ms(
            lambda: step(rows, lr, on), 8, 3, dev)
        del step
    if fused:
        y = torch.from_numpy(wav_tr[:b]).to(dev)
        run.counters["features_ms"] = harness.event_ms(
            lambda: [features.extract_features_compiled(
                y[lo:lo + chunk], spec) for lo in range(0, b, chunk)],
            4, 3, dev)
        run.counters["kernel_batch"] = chunk
    run.counters["flops_per_step"] = flops.step(config, b, fused)
    graphs.release(dev)


def run(run: harness.Run) -> harness.Outcome:
    from tpu_breath_torch import features, graphs
    from tpu_breath_torch.data import dataset
    from tpu_breath_torch.train import loop

    dev, config = run.device, run.cell.config
    f32 = run.sizes.get("body") == "float32"  # the look: --f32's numerics
    if f32:
        config = dict(config, precision=dict(config["precision"],
                                             body="float32"))
    spec = program.feature_spec(config)
    cfg = program.train_cfg(config, run.seed)
    n = run.size("n_labelled")
    if "batch_size" in run.sizes:  # a test at a small size
        cfg = dataclasses.replace(cfg, batch_size=run.sizes["batch_size"],
                                  eval_batch_size=run.sizes["batch_size"])
    y_all = data.labels(run.seed, n, dev)
    wav_all = data.clips(run.seed, y_all).cpu().numpy()
    rows = [{"ID": f"clip_{i:05d}", "Target": "E" if t > 0.5 else "I"}
            for i, t in enumerate(y_all.cpu().numpy())]
    tr_rows, va_rows = dataset.split_train_val(rows)
    tr = np.array([int(r["ID"][5:]) for r in tr_rows])
    va = np.array([int(r["ID"][5:]) for r in va_rows])
    y_tr = dataset.labels_from_targets([r["Target"] for r in tr_rows])
    y_va = dataset.labels_from_targets([r["Target"] for r in va_rows])
    wav_tr, wav_va = wav_all[tr], wav_all[va]
    fused = run.size("fused")
    chunk = run.size("chunk")
    if fused:
        va_store = features.extract_features_batched(wav_va, spec, chunk,
                                                     device=dev)
        train_store, feats_tr, fused_spec = (wav_tr, None), None, spec
    else:
        f, s = features.extract_features_batched(
            np.concatenate([wav_tr, wav_va]), spec, chunk, device=dev)
        feats_tr = (f[:len(tr)], s[:len(tr)])
        train_store, va_store, fused_spec = feats_tr, (f[len(tr):],
                                                       s[len(tr):]), None
    weights = program.weights(run.seed, config, dev)
    model, = program.models(config, weights, dev)
    steps_per_epoch = len(tr) // cfg.batch_size
    k = run.size("checked_steps")
    aug_epoch = max(cfg.warmup_epochs, 1)  # the first with augmentation on
    follow = Segment(aug_epoch * steps_per_epoch + 1, 1)
    recorder = Recorder([Segment(1, k), follow], aug_epoch + 1)

    window = Window(run, recorder)
    bases = loop.TrainStep, loop.Predictor
    loop.TrainStep = recorder.wrap_step(bases[0])
    loop.Predictor = recorder.wrap_predictor(bases[1])
    try:
        with harness.full_f32() if f32 else contextlib.nullcontext():
            while True:  # a fit that ends early is followed by the next run
                loop.fit(model, train_store, va_store, y_tr, y_va, cfg,
                         save_dir=None, log_fn=window, device=dev,
                         fused_spec=fused_spec)
    except StopWindow:
        pass
    finally:
        loop.TrainStep, loop.Predictor = bases
    gc.collect()
    graphs.release(dev)
    peak = harness.memory_peak(dev)
    clips = window.epochs * steps_per_epoch * cfg.batch_size
    values = {"train_clips_per_s": clips / (window.end - window.start),
              "setup_s": run.counters["setup_s"]}
    run.counters["traced_steps"] = window.traced_epochs * steps_per_epoch
    run.log(f"[train] {window.epochs} epochs of {steps_per_epoch} steps of "
            f"{cfg.batch_size} in {window.end - window.start:.3f} s")
    if run.trace:
        _probes(run, model, config, cfg, spec, wav_tr, feats_tr, y_tr, fused)
    start, got = recorder.segments[0].summary(), follow.summary()
    state, moments = follow.state, follow.moments
    eval_state = recorder.eval_state
    eval_logits = recorder.eval_logits.numpy().astype(np.float64)
    del model, recorder, follow, train_store, va_store, feats_tr
    gc.collect()
    graphs.release(dev)

    # the reference: the first k steps from the seed's weights (epoch 0,
    # augmentation off); the first step of epoch aug_epoch (augmentation
    # on) from the program's state before it; the evaluation at that
    # epoch's end from the program's state then, on a seeded sample of the
    # validation split with its last row (the padded batch's)
    t_check = time.perf_counter()
    b = cfg.batch_size
    order0 = ref_train.epoch_order(run.seed, 0, len(tr))[:k * b]
    order1 = ref_train.epoch_order(run.seed, aug_epoch, len(tr))[:b]
    used = np.unique(np.concatenate([order0, order1]))
    n_va = len(va)
    pick = np.union1d(data.order(run.seed + 3, n_va)[
        :run.size("eval_sample")], [n_va - 1])
    f, s = check.features(config, np.concatenate([wav_tr[used],
                                                  wav_va[pick]]), dev,
                          run.sizes.get("oracle_workers"))
    f_va, s_va = f[len(used):], s[len(used):]
    y = torch.from_numpy(y_tr).to(dev)

    def batches(order, n):
        i = torch.from_numpy(np.searchsorted(used, order)).to(dev)
        return [(f[i[j * b:(j + 1) * b]], s[i[j * b:(j + 1) * b]],
                 y[torch.from_numpy(order[j * b:(j + 1) * b]).to(dev)])
                for j in range(n)]
    first = batches(order0, k)
    aug = batches(order1, 1)
    draws = ref_aug.draws(ref_train.aug_seed(run.seed, aug_epoch), 1, b,
                          f.shape[2], f.shape[3], config["train"], dev)
    lrs0 = [ref_train.rate(config["train"], steps_per_epoch, i)
            for i in range(k)]
    lrs1 = [ref_train.rate(config["train"], steps_per_epoch,
                           aug_epoch * steps_per_epoch)]
    seed0 = ref_train.dropout_seed(run.seed, 0)
    seed1 = ref_train.dropout_seed(run.seed, aug_epoch)
    served = 1.0 / (1.0 + np.exp(-eval_logits[pick]))

    # the reference's numerics, by the traffic: float32, or the body as
    # the program computes it here (bfloat16 on the card)
    bf16 = program.body_dtype(config, dev) == torch.bfloat16
    ref_numerics = run.size("reference") if bf16 else "f32"

    def reference(numerics=ref_numerics, half_batch=False, augmented=True):
        """The reference's three readings (in the control's numerics, or
        with a fault planted)."""
        return (check.train_steps(config, weights[0], first, lrs0, seed0,
                                  dev, numerics, half_batch),
                check.train_steps(config, state, aug, lrs1, seed1, dev,
                                  numerics, half_batch, moments,
                                  draws if augmented else None),
                check.probs(config, [eval_state], f_va, s_va, numerics))

    def compare(ref):
        return {**ref_train.numbers(start, ref[0]),
                **ref_train.numbers(got, ref[1], prefix="aug_"),
                **check.prob_gaps(served, ref[2], prefix="eval_")}
    ref = reference()
    numbers = compare(ref)
    run.log(f"[check] the reference's {k} first steps, step "
            f"{aug_epoch * steps_per_epoch + 1} ({draws[0]['kind']}) and the "
            f"evaluation of epoch {aug_epoch + 1} on {len(used)} + "
            f"{len(pick)} clips in {time.perf_counter() - t_check:.1f} s")
    readings = {}
    if run.sizes.get("readings") is not None:
        readings["worst_leaf_gap"] = {
            **ref_train.numbers(start, ref[0], worst=True),
            **ref_train.numbers(got, ref[1], worst=True, prefix="aug_")}
        readings["aug_kind"] = draws[0]["kind"]
    if run.sizes.get("readings"):  # the control and the planted faults
        readings["control_fp8"] = compare(reference("fp8"))
        half = reference(half_batch=True)
        readings["half_batch"] = {
            **ref_train.numbers(start, half[0]),
            **ref_train.numbers(got, half[1], prefix="aug_")}
        readings["no_augmentation"] = ref_train.numbers(
            got, reference(augmented=False)[1], prefix="aug_")
        readings["answer_flipped"] = check.prob_gaps(1.0 - served, ref[2],
                                                     prefix="eval_")
    losses = start["losses"] + got["losses"]
    ok_steps = len(losses) == k + 1 and all(math.isfinite(x) for x in losses)
    return harness.Outcome(
        attempted=(window.epochs + 1) * steps_per_epoch,
        failed=(0 if ok_steps else k + 1)
        + window.nan_epochs * steps_per_epoch,
        values=values, numbers=numbers,
        memory_peak_bytes=peak, readings=readings)
