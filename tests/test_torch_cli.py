"""The port's command line on the CPU at a tiny size: precompute -> e2e
(train cnn8,vgg + predict) -> resume -> predict from the cache, from npz
and from wavs, on a seeded synthetic dataset (24 labelled clips, 8 test
clips), plus device handling and the bare run."""
import csv
import json
import os
import shutil
import wave

import numpy as np
import pytest
import torch

from tpu_breath.data import wav as jx_wav
from tpu_breath_torch import cli
from tpu_breath_torch.config import Paths
from tpu_breath_torch.data import dataset as ds
from tpu_breath_torch.data import wav as wav_io
from tpu_breath_torch.train import checkpoint as ckpt_lib

N_TRAIN, N_TEST = 24, 8


def _write_wav(path, y):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


def _dataset(root):
    """Rising (E) or falling (I) envelopes on seeded noise, in the repo's
    layout: train.csv / test.csv, train/x_NNNN.wav for x_[EI]_NNNN."""
    rng = np.random.default_rng(12)
    t = np.arange(16000) / 16000
    (root / "train").mkdir(parents=True)
    (root / "test").mkdir()
    rows = []
    for i in range(N_TRAIN + N_TEST):
        e = bool(rng.integers(2))
        y = 0.1 * (0.1 + 0.9 * (t if e else 1 - t)) * rng.standard_normal(
            16000)
        if i < N_TRAIN:
            rows.append(f"x_{'E' if e else 'I'}_{i:04d},{'E' if e else 'I'}")
            _write_wav(root / "train" / f"x_{i:04d}.wav", y)
        else:
            _write_wav(root / "test" / f"x_{i:04d}.wav", y)
    (root / "train.csv").write_text("ID,Target\n" + "\n".join(rows) + "\n")
    (root / "test.csv").write_text("ID\n" + "".join(
        f"x_{i:04d}\n" for i in range(N_TRAIN, N_TRAIN + N_TEST)))


def _submission(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root, out = tmp / "input", tmp / "out"
    _dataset(root)
    common = ["--root", str(root), "--out-root", str(out), "--device", "cpu"]
    cli.main(["precompute", "--npz", *common])
    cli.main(["e2e", "--epochs", "1", "--batch-size", "8", *common])
    return {"root": root, "out": out, "common": common}


def test_precompute_writes_cache_and_npz(e2e):
    cache = os.path.join(e2e["root"], "feature_cache_torch")
    assert ds.FeatureStore.cache_exists(cache)
    store = ds.FeatureStore.load_cache(cache)
    assert len(store.ids) == N_TRAIN + N_TEST
    assert store.features.shape[1:] == (9, 128, 63)
    assert np.isfinite(store.features).all()
    assert len(os.listdir(e2e["root"] / "precomputed")) == N_TRAIN + N_TEST


def test_e2e_writes_checkpoints_history_and_submission(e2e):
    for arch in ("cnn8", "vgg"):
        d = cli.ckpt_dir(str(e2e["out"]), arch)
        path = ckpt_lib.latest_checkpoint(d)
        assert path is not None
        assert set(os.listdir(path)) == {"model.pt", "train_state.pt",
                                         "meta.json"}
        with open(os.path.join(d, "history.jsonl")) as f:
            hist = [json.loads(line) for line in f]
        assert [r["epoch"] for r in hist] == [1]
        assert np.isfinite(hist[0]["train_loss"])
    rows = _submission(e2e["out"] / "submissions" / "submission.csv")
    assert rows[0] == ["ID", "Target"]
    assert [r[0] for r in rows[1:]] == [f"x_{i:04d}" for i in
                                        range(N_TRAIN, N_TRAIN + N_TEST)]
    assert all(r[1] in ("E", "I") for r in rows[1:])


def test_resume_then_predict_from_cache_npz_and_wav(e2e, capsys):
    common = e2e["common"]
    cli.main(["train", "--archs", "cnn8", "--epochs", "2", "--batch-size",
              "8", "--resume", *common])
    assert "resumed from epoch 1" in capsys.readouterr().out
    with open(os.path.join(cli.ckpt_dir(str(e2e["out"]), "cnn8"),
                           "history.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [2]

    sub = e2e["out"] / "submissions" / "submission.csv"
    cli.main(["predict", *common])
    from_cache = _submission(sub)
    cli.main(["predict", "--from-npz", str(e2e["root"] / "precomputed"),
              *common])
    assert _submission(sub) == from_cache

    wavs = [str(e2e["root"] / "test" / f"x_{i:04d}.wav")
            for i in range(N_TRAIN, N_TRAIN + 3)]
    capsys.readouterr()
    cli.main(["predict", "--from-wav", *wavs, *common])
    lines = [l.split("\t") for l in capsys.readouterr().out.splitlines()
             if "\t" in l]
    assert [l[0] for l in lines] == wavs
    # the same clips' labels as from the cache
    assert [l[1] for l in lines] == [r[1] for r in from_cache[1:4]]


def test_train_from_npz(e2e, tmp_path):
    out = tmp_path / "npz_run"
    cli.main(["train", "--archs", "cnn8", "--epochs", "1", "--batch-size",
              "8", "--from-npz", str(e2e["root"] / "precomputed"),
              "--root", str(e2e["root"]), "--out-root", str(out),
              "--device", "cpu"])
    assert ckpt_lib.latest_checkpoint(cli.ckpt_dir(str(out), "cnn8"))


def test_ensemble_val_on_the_runs_checkpoints(e2e, tmp_path):
    """utils/ensemble_val.py end to end on the run's CPU checkpoints: the
    seed-42 val split's rows, each member's checkpoint score, and the
    weighted blend equal to ensemble.weighted_ensemble's on those rows."""
    from tpu_breath_torch import ensemble
    from tpu_breath_torch.train.metrics import binary_metrics
    from tpu_breath_torch.utils import ensemble_val

    archs = ["cnn8", "vgg"]
    ckpts = [ckpt_lib.latest_checkpoint(cli.ckpt_dir(str(e2e["out"]), a))
             for a in archs]
    out = tmp_path / "ens.json"
    rep = ensemble_val.main([*(x for a, p in zip(archs, ckpts)
                               for x in ("--ckpt", f"{a}={p}")),
                             "--root", str(e2e["root"]), "--device", "cpu",
                             "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    va_rows = ds.split_train_val(ds.load_frames(Paths(str(e2e["root"])))[0])[1]
    assert rep["val_n"] == len(va_rows) == 5
    scores = [ckpt_lib.load_metadata(p)["val_acc"] for p in ckpts]
    assert [rep["members"][a]["ckpt_val_acc"] for a in archs] == [
        round(s, 6) for s in scores]
    assert sum(rep["weights_softmax"]) == pytest.approx(1.0, abs=1e-5)
    va = ds.FeatureStore.load_cache(Paths(str(e2e["root"])).feature_cache
                                    ).subset([r["ID"] for r in va_rows])
    y = ds.labels_from_targets([r["Target"] for r in va_rows])
    blend = ensemble.weighted_ensemble(ckpts, archs, scores, va.features,
                                       va.scalars, 36, device="cpu")
    for k, v in binary_metrics(blend, y).items():
        assert rep["weighted_ensemble"][k] == pytest.approx(v, abs=1e-6,
                                                            nan_ok=True)
        assert np.isnan(v) or 0.0 <= v <= 1.0


def test_fused_train_raises_on_a_train_wav_that_does_not_decode(e2e,
                                                                 tmp_path):
    """As in the JAX package (tpu_breath/cli.py calls load_wav_batch without
    `errors`): train --fused raises on a train wav that does not decode,
    while train from the cache (which precompute filled with zeros for
    such a clip) runs. Both packages' load_wav_batch, called without
    `errors`, raise on the same file; with `errors` the clip is zeros."""
    root = tmp_path / "input"
    shutil.copytree(e2e["root"], root)
    train_rows = ds.load_frames(Paths(str(root)))[0]
    tr_id = ds.split_train_val(train_rows)[0][0]["ID"]
    broken = root / "train" / ds.train_wav_name(tr_id)
    broken.write_bytes(b"RIFF-not-a-wav")
    common = ["--root", str(root), "--out-root", str(tmp_path / "out"),
              "--device", "cpu", "--archs", "cnn8", "--epochs", "1",
              "--batch-size", "8"]
    with pytest.raises(Exception) as decode_error:
        wav_io.load_wav(str(broken))
    with pytest.raises(decode_error.type):
        cli.main(["train", "--fused", *common])
    cli.main(["train", *common])
    assert ckpt_lib.latest_checkpoint(cli.ckpt_dir(str(tmp_path / "out"),
                                                   "cnn8"))

    good = str(root / "train" / ds.train_wav_name(train_rows[-1]["ID"]))
    assert good != str(broken)
    for load in (jx_wav.load_wav_batch, wav_io.load_wav_batch):
        assert load([good]).shape == (1, 16000)
        with pytest.raises(decode_error.type):
            load([good, str(broken)])
    errors: list = []
    got = wav_io.load_wav_batch([good, str(broken)], errors=errors)
    assert [p for p, _ in errors] == [str(broken)]
    assert not got[1].any() and got[0].any()


@pytest.mark.parametrize("argv", [["precompute"], ["train"], ["e2e"],
                                  ["predict"], ["train", "--fused"],
                                  ["precompute", "--profile", "p"],
                                  ["e2e", "--fused", "--profile", "p"]])
def test_cuda_is_the_default_and_needs_a_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*argv, "--root", str(tmp_path), "--out-root",
                  str(tmp_path)])


def test_bare_run_is_train_and_predict(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "cmd_train", lambda ns: seen.update(train=ns))
    monkeypatch.setattr(cli, "cmd_precompute",
                        lambda ns: seen.update(precompute=ns))
    cli.main([])
    ns = seen["train"]
    assert (ns.archs, ns.predict, ns.device, ns.epochs) == (
        "cnn8,vgg", True, "cuda", 0)
    cli.main(["--precompute"])
    assert seen["precompute"].chunk == 128


def test_help_names_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        cli.main(["train", "--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "--mesh auto|off|N" in out and "data-parallel mesh" in out
    assert "--scan and --epoch-scan of the JAX package's CLI are not " \
           "ported" in out
    assert "--fused" in out and "--profile" in out
    assert "--device" in out
