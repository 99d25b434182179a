"""The port's serving path: `python -m tpu_breath_torch predict --from-wav`
with a checkpoint converted from Flax, against JAX
sigmoid(CNN8.apply(extract_features(w))) with the same weights (f32 on both
sides: the CPU run of the port has no autocast), plus the checkpoint,
ensemble and CLI pieces."""
import csv
import glob
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.config import DEFAULT_FEATURES as SPEC
from tpu_breath.data import wav as wav_io
from tpu_breath.features import extract_features as jx_extract
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath_torch import cli, ensemble
from tpu_breath_torch.models.cnn8 import CNN8
from tpu_breath_torch.models.convert import cnn8_from_flax
from tpu_breath_torch.train import checkpoint as ckpt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "golden_*.npz")))


def _write_pcm16(path, samples, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """3 wavs from the fixtures, a converted Flax checkpoint, one CLI run."""
    tmp = tmp_path_factory.mktemp("serve")
    golden = [np.load(p)["wav"] for p in FIXTURES]
    clips = golden + [golden[0][::-1] * 0.5]
    paths = []
    for i, c in enumerate(clips):
        paths.append(str(tmp / f"clip{i}.wav"))
        _write_pcm16(paths[-1], c)
    wavs = wav_io.load_wav_batch(paths, SPEC.expected_len)

    flax_model = FlaxCNN8(num_scalar_features=36, dtype=jnp.float32)
    f0, s0 = jax.jit(lambda w: jx_extract(w, SPEC))(jnp.asarray(wavs))
    v = flax_model.init({"params": jax.random.PRNGKey(7)}, f0, s0,
                        train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    logits = flax_model.apply({"params": params, "batch_stats": stats},
                              f0, s0, train=False)
    expect = np.asarray(jax.nn.sigmoid(logits))

    model = CNN8(36)
    model.load_state_dict(cnn8_from_flax(params, stats))
    ckpt_lib.save(cli.ckpt_dir(str(tmp), "cnn8"), model, 3,
                  {"val_acc": 0.8})
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run(
        [sys.executable, "-m", "tpu_breath_torch", "predict", "--from-wav",
         *paths, "--archs", "cnn8", "--device", "cpu", "--out-root",
         str(tmp)], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    return {"tmp": tmp, "paths": paths, "wavs": wavs, "expect": expect,
            "res": res}


def test_cli_probabilities_match_jax(served):
    res = served["res"]
    assert res.returncode == 0, res.stderr
    rows = [l.split("\t") for l in res.stdout.splitlines() if "\t" in l]
    assert [r[0] for r in rows] == served["paths"]
    probs = np.array([float(r[2]) for r in rows])
    # printed with 4 decimals; bound 1e-3
    np.testing.assert_allclose(probs, served["expect"], atol=1e-3, rtol=0)
    assert [r[1] for r in rows] == ["E" if p > 0.5 else "I" for p in probs]


def test_csv_has_id_target_rows(served):
    out = served["tmp"] / "submissions" / "from_wav_predictions.csv"
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "Target"]
    assert [r[0] for r in rows[1:]] == served["paths"]
    assert all(r[1] in ("E", "I") for r in rows[1:])


def test_serve_from_wav_full_precision(served):
    """The same serve in-process, unrounded, with a micro-batch of 2 so the
    padded tail (3 = 2 + 1) is exercised."""
    ckpt = ckpt_lib.latest_checkpoint(cli.ckpt_dir(str(served["tmp"]),
                                                   "cnn8"))
    probs = ensemble.serve_from_wav([ckpt], ["cnn8"], [0.8], served["wavs"],
                                    micro_batch=2, device="cpu")
    np.testing.assert_allclose(probs, served["expect"], atol=1e-3, rtol=0)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cli.resolve_device("cuda")
    assert cli.resolve_device("cpu") == torch.device("cpu")


def test_predict_without_checkpoint_fails(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["predict", "--from-wav", "x.wav", "--device", "cpu",
                  "--out-root", str(tmp_path)])


def test_checkpoint_latest_skips_interrupted_saves(tmp_path):
    model = CNN8(36)
    ckpt_lib.save(str(tmp_path), model, 2, {"val_acc": 0.5})
    p5 = ckpt_lib.save(str(tmp_path), model, 5, {"val_acc": 0.7})
    os.makedirs(tmp_path / "best_epoch009")  # no meta.json: interrupted
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == p5
    assert ckpt_lib.load_metadata(p5) == {"epoch": 5, "val_acc": 0.7}
    restored = ckpt_lib.restore(p5, CNN8(36))
    assert all(torch.equal(a, b) for a, b in zip(
        restored.state_dict().values(), model.state_dict().values()))
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "none")) is None


def test_softmax_weights_and_submission(tmp_path):
    w = ensemble.softmax_weights([0.7, 0.8])
    np.testing.assert_allclose(w, np.exp([0.7, 0.8]) / np.exp([0.7, 0.8]).sum())
    rows = ensemble.write_submission(["a", "b"], [0.9, 0.5],
                                     str(tmp_path / "s.csv"))
    assert rows == [("a", "E"), ("b", "I")]
    assert (tmp_path / "s.csv").read_text().splitlines() == [
        "ID,Target", "a,E", "b,I"]
