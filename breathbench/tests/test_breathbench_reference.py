"""At tiny sizes on the CPU the plain reference agrees with the port's
plain CPU path: the models, the training step, the kernel shapes the
yardstick assumes, and each traffic mix run end to end through the
harness (correct against the cell's own limits)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from breathbench import check, data, flops, harness, program
from breathbench.reference import layers
from breathbench.reference import train as ref_train
from breathbench.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ["cnn8", "vgg"])
@pytest.mark.parametrize("train", [False, True])
def test_reference_model_equals_the_ports_on_the_cpu(arch, train):
    torch.manual_seed(0)
    config = harness.load_json(f"{harness.HERE}/configs/{arch}.json")
    (m, _), = program.members(config)
    w = program.weights(5, config, CPU)
    model, = program.models(config, w, CPU)
    model.train(train)
    f = torch.randn(6, 9, 128, 63)
    s = torch.randn(6, 36)
    with torch.random.fork_rng():
        torch.manual_seed(3)
        got = model(f, s)
    with torch.random.fork_rng():
        torch.manual_seed(3)
        want = program.reference(arch).forward(
            {k: v.clone() for k, v in w[0].items()}, f, s, m, train,
            layers.Dropout(torch.float32, train), layers.rounder("f32"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_schedule_and_seeds_follow_the_ports_rules():
    from tpu_breath_torch.train import loop
    from tpu_breath_torch.train.schedule import warmup_cosine

    train = harness.load_json(f"{harness.HERE}/configs/cnn8.json")["train"]
    sched = warmup_cosine(train["base_lr"], 6 * train["num_epochs"],
                          train["warmup_frac"], train["lr_start_factor"],
                          train["lr_eta_min"])
    for step in (0, 1, 5, 29, 30, 31, 300, 599):
        # the port folds the schedule in float32: an f32 ulp of base_lr
        assert ref_train.rate(train, 6, step) == pytest.approx(
            sched(step), rel=1e-6, abs=1e-4 * 2 ** -23)
    seed = 2 ** 31 + 7
    assert np.array_equal(ref_train.epoch_order(seed, 0, 50),
                          loop.epoch_permutation(seed, 0, 50))
    assert ref_train.dropout_seed(seed, 0) == loop.epoch_seeds(seed, 0)[1]


def test_kernel_shapes_are_the_ports_main_path():
    from tpu_breath_torch.ops import chroma, spectral

    y = torch.randn(2, 16000) * 0.1
    s512 = spectral.stft_mag_cr(y, 512, 256)
    s2048 = spectral.stft_mag_cr(y, 2048, 256)[..., ::2]
    p12 = chroma._piptrack_band(s512, 16000, 512)[0]
    p36 = chroma._piptrack_band(s2048, 16000, 2048)[0]
    assert flops.SHAPES["A_pairs"] == (p12[0].numel(), p36[0].numel())
    assert flops.SHAPES["B"][:2] == tuple(s512.shape[1:])


def test_the_oracle_pool_equals_one_process():
    wavs = data.clips(3, torch.tensor([0.0, 1.0, 1.0])).numpy()
    config = harness.load_json(f"{harness.HERE}/configs/cnn8.json")
    a = check.features(config, wavs, CPU, workers=0)
    b = check.features(config, wavs, CPU, workers=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_the_same_seed_gives_the_same_inputs():
    y = data.labels(2 ** 31 + 1, 10, CPU)
    assert int(y.sum()) == 5
    assert torch.equal(data.clips(9, y), data.clips(9, y))
    c = data.clips(9, y)
    assert torch.equal(torch.round(c * 32768), c * 32768)
    assert not torch.equal(c, data.clips(10, y))


@pytest.mark.parametrize("workload", ["cnn8.train_fused", "vgg.train_cached",
                                      "cnn8.serve_open", "vgg.score_files"])
def test_each_mix_at_a_tiny_size_is_correct_on_the_cpu(workload):
    line = tiny.run(workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
