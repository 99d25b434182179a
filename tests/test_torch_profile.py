"""--profile of the port's CLI on the CPU at a tiny size: `precompute
--profile DIR` writes feature_stages.json with the JAX package's stage
names (stft512_dd aside: the port has no double-float path), `train
--profile DIR` writes a torch.profiler trace, the table of its top
operations and train_profile.json. On the CPU the times come from the
host clock, and the JSON says so. The port's one timer, profiling.device_ms,
on the CPU: the calls it makes and the values it returns."""
import json
import math
import time
import wave

import numpy as np
import pytest

from tpu_breath.utils import profiling as jx_profiling
from tpu_breath_torch import cli
from tpu_breath_torch.utils import profiling

N_TRAIN, N_TEST = 10, 2


def _write_wav(path, y):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profile")
    root = tmp / "input"
    (root / "train").mkdir(parents=True)
    (root / "test").mkdir()
    rng = np.random.default_rng(13)
    rows = []
    for i in range(N_TRAIN + N_TEST):
        y = 0.05 * rng.standard_normal(16000)
        if i < N_TRAIN:
            t = "EI"[i % 2]
            rows.append(f"x_{t}_{i:04d},{t}")
            _write_wav(root / "train" / f"x_{i:04d}.wav", y)
        else:
            _write_wav(root / "test" / f"x_{i:04d}.wav", y)
    (root / "train.csv").write_text("ID,Target\n" + "\n".join(rows) + "\n")
    (root / "test.csv").write_text("ID\n" + "".join(
        f"x_{i:04d}\n" for i in range(N_TRAIN, N_TRAIN + N_TEST)))
    common = ["--root", str(root), "--out-root", str(tmp / "out"),
              "--device", "cpu"]
    cli.main(["precompute", "--chunk", "4", "--profile",
              str(tmp / "features"), *common])
    cli.main(["train", "--archs", "cnn8", "--epochs", "2", "--batch-size",
              "4", "--profile", str(tmp / "train"), *common])
    return tmp


def test_feature_profile_names_every_stage(runs):
    with open(runs / "features" / "feature_stages.json") as f:
        prof = json.load(f)
    # 10 train clips in chunks of 4: two whole chunks are timed
    assert (prof["n_clips"], prof["chunk"]) == (8, 4)
    assert (prof["device"], prof["timer"]) == ("cpu", "host clock")
    names = [r["stage"] for r in prof["stages"]]
    assert len(names) == len(set(names))
    assert set(names) == set(jx_profiling.feature_stages()) - {"stft512_dd"}
    ms = [r["ms"] for r in prof["stages"]]
    assert ms == sorted(ms, reverse=True) and min(ms) > 0
    for r in prof["stages"]:
        assert r["ms_per_chunk"] == pytest.approx(r["ms"] / 2)
        assert r["clips_per_s"] == pytest.approx(8 / (r["ms"] / 1e3))


def test_train_profile_trace_and_ops(runs):
    with open(runs / "train" / "train_profile.json") as f:
        prof = json.load(f)
    assert set(prof) == {"cnn8"}
    assert set(prof["cnn8"]) == {"epochs", "total_s", "first_epoch_s",
                                 "warm_epoch_median_s"}
    assert prof["cnn8"]["epochs"] == 2
    with open(runs / "train" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the step spans fit names for the trace's reader
    assert "train_step" in names and "aten::convolution" in names
    # and its epochs' spans, the epoch's wait among them
    assert "fit.epoch" in names and "fit.wait" in names
    table = (runs / "train" / "ops.txt").read_text()
    assert "Self CPU" in table and "aten::" in table


def test_train_profile_of_histories(tmp_path):
    rows = [{"sec": s} for s in (3.0, 1.0, 2.0)]
    with open(profiling.write_train_profile(str(tmp_path),
                                            {"vgg": rows})) as f:
        assert json.load(f)["vgg"] == {
            "epochs": 3, "total_s": 6.0, "first_epoch_s": 3.0,
            "warm_epoch_median_s": 1.5}


# (launches, rounds, warm-up): the kernel table's; eight launches in three
# rounds; the stage profile's
@pytest.mark.parametrize("launches, rounds, warmup",
                         [(20, 1, 3), (8, 3, 1), (1, 1, 0)],
                         ids=["kernel_table", "rounds", "stage_profile"])
def test_device_ms_calls_fn_warmup_plus_launches_times_rounds(
        launches, rounds, warmup):
    calls = []

    def fn():
        calls.append(1)
        time.sleep(1e-3)

    ms = profiling.device_ms(fn, "cpu", launches, rounds, warmup)
    assert len(calls) == warmup + launches * rounds
    # one value a round, ms a launch: each launch sleeps at least 1 ms
    assert len(ms) == rounds
    assert all(math.isfinite(m) and m >= 1.0 for m in ms)
