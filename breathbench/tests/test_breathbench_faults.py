"""The check fails a broken timed path: each fault a cell can have,
planted in the port underneath a tiny CPU run of the harness, turns
`correct` false; and the control (the reference in fp8 put in the
program's place) fails the limits of each cell."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from breathbench import check, data, harness, program
from breathbench.reference import augment as ref_aug
from breathbench.reference import train as ref_train
from breathbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(workload,
                                                          monkeypatch):
    from tpu_breath_torch.train import loop

    monkeypatch.setattr(loop.AdamW, "step", lambda self, lr: None)
    line = tiny.run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached"])
def test_half_the_batch_left_out_is_caught(workload, monkeypatch):
    from tpu_breath_torch.train import loop

    bce = loop.bce_with_logits
    monkeypatch.setattr(loop, "bce_with_logits",
                        lambda z, y: bce(z[:z.shape[0] // 2],
                                         y[:y.shape[0] // 2]))
    line = tiny.run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached"])
def test_augmentation_left_out_is_caught(workload, monkeypatch):
    from tpu_breath_torch import augment

    monkeypatch.setattr(augment, "apply_augmentation",
                        lambda batch, *a, **k: batch)
    line = tiny.run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached"])
def test_the_evaluations_answers_altered_where_produced_are_caught(
        workload, monkeypatch):
    """Every logit of the evaluation turned to the other class: the
    evaluation's mean gap catches a broken evaluation, not one answer in
    hundreds (PERF.md)."""
    from tpu_breath_torch.train import loop

    forward = loop.Predictor.forward

    def altered(self, rows):
        z = forward(self, rows)
        return -z - 8.0 * torch.sign(z)
    monkeypatch.setattr(loop.Predictor, "forward", altered)
    line = tiny.run(workload, eval_sample=8)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cnn8.serve_open", "vgg.score_files"])
def test_an_answer_altered_where_it_is_produced_is_caught(workload,
                                                          monkeypatch):
    from tpu_breath_torch import ensemble

    blend = ensemble.blend

    def altered(*a):
        p = blend(*a)
        return torch.cat([1.0 - p[:1], p[1:]])
    monkeypatch.setattr(ensemble, "blend", altered)
    # one answer of each program call altered; micro-batches of 4 clips,
    # about what a micro-batch of the serving cell holds at its rate
    line = tiny.run(workload, **{"sample": 16, "pool_clips": 16,
                                 "clips": 16, "micro_batch": 4})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cnn8.serve_open", "vgg.score_files"])
def test_the_fp8_control_fails_a_serving_cells_limits(workload):
    """The reference in fp8 in the program's place, against the reference,
    on 48 seeded clips with the cell's weights (calibrated), on the CPU."""
    cell = harness.cell(workload)
    config = cell.config
    w = program.weights(12, config, CPU, calibrate=True)
    wavs = data.clips(12, data.labels(12, 48, CPU)).numpy()
    f, s = check.features(config, wavs, CPU, workers=0)
    ref = check.probs(config, w, f, s)
    ctrl = check.prob_gaps(check.probs(config, w, f, s, "fp8"), ref)
    ok, checks = harness.verdict(ctrl, cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached"])
def test_the_fp8_control_fails_a_training_cells_limits(workload):
    """The reference in fp8 in the program's place, against the reference,
    at batch 64 on seeded oracle features: the cell's first steps, one
    step with augmentation on, and an evaluation."""
    torch.manual_seed(0)
    cell = harness.cell(workload)
    config, train = cell.config, cell.config["train"]
    k = cell.traffic["checked_steps"]
    w = program.weights(13, config, CPU)[0]
    b = 64
    y = data.labels(13, (k + 1) * b, CPU)
    f, s = check.features(config, data.clips(13, y).numpy(), CPU, workers=0)
    batches = [(f[i * b:(i + 1) * b], s[i * b:(i + 1) * b],
                y[i * b:(i + 1) * b]) for i in range(k + 1)]
    lrs = [ref_train.rate(train, 6, i) for i in range(k)]
    draws = ref_aug.draws(ref_train.aug_seed(13, 4), 1, b, f.shape[2],
                          f.shape[3], train, CPU)
    seed0, seed4 = ref_train.dropout_seed(13, 0), ref_train.dropout_seed(13, 4)

    def side(numerics):
        return (check.train_steps(config, w, batches[:k], lrs, seed0, CPU,
                                  numerics),
                check.train_steps(config, w, batches[k:], lrs[:1], seed4,
                                  CPU, numerics, draws=draws),
                check.probs(config, [w], f[:b], s[:b], numerics))
    ref, ctrl = side("f32"), side("fp8")
    numbers = {**ref_train.numbers(ctrl[0], ref[0]),
               **ref_train.numbers(ctrl[1], ref[1], prefix="aug_"),
               **check.prob_gaps(ctrl[2], ref[2], prefix="eval_")}
    assert set(cell.limits) <= set(numbers)
    assert np.isfinite(list(numbers.values())).all()
    ok, checks = harness.verdict(numbers, cell.limits)
    assert not ok, checks
