"""The fused wav -> train step of the port (train.loop.fit(fused_spec=...),
`train --fused`) on the CPU: fused == cached inside the port (the property
of tests/test_fused.py), and one fused step against the JAX package's.

The port's CPU features are batch-invariant bit for bit when torch runs on
one thread (measured: a clip's features and scalars are equal whether it is
computed alone, in a batch of 4 or 8 in any order, or in a batch of 16);
with more threads MKL's float64 GEMM may block the mel matmul differently
under load (ROADMAP §3: 3.4e-6). So the equality tests pin one thread."""
import csv
import glob
import json
import os
import wave

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tpu_breath.config import TrainCfg as JxTrainCfg
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.train import loop as jx_loop
from tpu_breath.train.schedule import warmup_cosine as jx_warmup_cosine
from tpu_breath_torch import augment, cli
from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
from tpu_breath_torch.config import TrainCfg
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import cnn8_from_flax
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train import loop
from tpu_breath_torch.train.schedule import warmup_cosine

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(n: int, seed: int = 0):
    """The golden wavs, then seeded noise with a rising (label 1) or
    falling (label 0) envelope; (wavs [n, 16000] f32, labels [n])."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000
    wavs = [np.load(p)["wav"] for p in FIXTURES]
    labels = [0.0, 1.0]
    while len(wavs) < n:
        up = len(wavs) % 2
        env = 0.1 + 0.9 * (t if up else 1 - t)
        wavs.append(0.1 * env * rng.standard_normal(16000))
        labels.append(float(up))
    return (np.stack(wavs[:n]).astype(np.float32),
            np.array(labels[:n], np.float32))


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def test_step_features_equal_standalone_at_chunk_geometry():
    """Batch 4 in chunks of 2 equals two standalone extract_features calls
    of 2; batch 3 (no multiple of the chunk) equals one call."""
    w = torch.from_numpy(_clips(4)[0])
    f, s = loop.fused_features(w, SPEC, chunk=2)
    parts = [extract_features(w[lo:lo + 2]) for lo in (0, 2)]
    assert _nan_equal(f, torch.cat([p[0] for p in parts]))
    assert _nan_equal(s, torch.cat([p[1] for p in parts]))
    f3, s3 = loop.fused_features(w[:3], SPEC, chunk=2)
    ref3 = extract_features(w[:3])
    assert _nan_equal(f3, ref3[0]) and _nan_equal(s3, ref3[1])


def test_one_fused_step_equals_one_cached_step():
    """The same weights, augmentation draws (CutMix/MixUp) and dropout
    seed: the fused step's loss, accuracy and updated weights equal the
    cached step's, fed features computed beforehand."""
    wavs, labels = _clips(4)
    w, y = torch.from_numpy(wavs), torch.from_numpy(labels)
    cfg = TrainCfg(batch_size=4, cutmix_prob=0.5, mixup_prob=0.5)
    cached = extract_features(w)
    out = []
    for fused in (False, True):
        model = registry.build("cnn8", 36, seed=5)
        opt = loop.make_optimizer(model, cfg)
        feats, scals = (loop.fused_features(w, SPEC) if fused else cached)
        g = torch.Generator().manual_seed(7)
        draws = augment.draw(g, 4, 128, 63, cfg.cutmix_alpha,
                             cfg.mixup_alpha, "cpu")
        torch.manual_seed(11)
        loss, acc = loop.train_step(model, opt, 1e-3,
                                    augment.Batch(feats, scals, y), cfg,
                                    draws)
        out.append((loss, acc, model.state_dict()))
    (l0, a0, sd0), (l1, a1, sd1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


def test_fused_fit_history_equals_cached():
    """3 epochs, batch 4 of 8 clips, augmentation from epoch 2, dropout
    on: fused fit (features per step, batches in shuffled order) and cached
    fit (features of all 8 clips in one call) give equal histories."""
    wavs, labels = _clips(8, seed=1)
    f, s = (t.numpy() for t in extract_features(torch.from_numpy(wavs)))
    cfg = TrainCfg(num_epochs=3, base_lr=1e-3, batch_size=4,
                   eval_batch_size=4, warmup_epochs=1, patience=99, seed=3)
    runs = [loop.fit(registry.build("cnn8", 36, seed=3), store, (f, s),
                     labels, labels, cfg, log_fn=lambda *_: None,
                     device="cpu", fused_spec=spec)
            for store, spec in (((f, s), None), ((wavs, None), SPEC))]
    assert [len(r.history) for r in runs] == [3, 3]
    for rc, rf in zip(runs[0].history, runs[1].history):
        for k in rc:
            if k != "sec":
                assert rc[k] == rf[k], (k, rc, rf)


def test_one_fused_step_matches_jax():
    """One fused step of the port against JAX's fused make_train_step on
    the same 4 wavs and weights (CNN8 in f32, dropout 0, augmentation off):
    the loss within 1e-3 relative (measured 2.2e-4) and the same accuracy.
    Not closer: the features themselves differ by up to 3e-4
    (tests/test_torch_features.py) and the loss sums their effect over the
    batch."""
    wavs, labels = _clips(4, seed=2)
    jcfg = JxTrainCfg(num_epochs=1, batch_size=4, warmup_epochs=99)
    fm = FlaxCNN8(num_scalar_features=36, dropout_rate=0.0,
                  dtype=jnp.float32)
    # CNN8's weights do not depend on the spatial size: a small sample
    # keeps the init cheap; jitted, and otherwise as create_state builds
    # the state (its eager init takes ~16 s on the CPU)
    v = jax.jit(lambda k: fm.init({"params": k}, jnp.zeros((2, 9, 8, 8)),
                                  jnp.zeros((2, 36))))(jax.random.PRNGKey(1))
    tx = optax.chain(
        optax.clip_by_global_norm(jcfg.grad_clip_norm),
        optax.adamw(jx_warmup_cosine(jcfg.base_lr, jcfg.num_epochs,
                                     jcfg.warmup_frac, jcfg.lr_start_factor,
                                     jcfg.lr_eta_min),
                    b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=jcfg.weight_decay))
    state = jx_loop.TrainState(params=v["params"],
                               batch_stats=v["batch_stats"],
                               opt_state=jax.jit(tx.init)(v["params"]),
                               step=jnp.zeros((), jnp.int32))
    sd = cnn8_from_flax(jax.tree.map(np.asarray, v["params"]),
                        jax.tree.map(np.asarray, v["batch_stats"]))
    step = jx_loop.make_train_step(fm, tx, jcfg, fused_spec=SPEC)
    _, stats = step(state, jnp.asarray(wavs), jnp.zeros((4, 0)),
                    jnp.asarray(labels), jnp.arange(4),
                    jax.random.PRNGKey(0), jnp.asarray(False))

    cfg = TrainCfg(num_epochs=1, batch_size=4, warmup_epochs=99)
    model = registry.build("cnn8", 36, dropout_rate=0.0)
    model.load_state_dict(sd)
    feats, scals = loop.fused_features(torch.from_numpy(wavs), SPEC)
    loss, acc = loop.train_step(
        model, loop.make_optimizer(model, cfg),
        warmup_cosine(cfg.base_lr, 1)(0),
        augment.Batch(feats, scals, torch.from_numpy(labels)), cfg)
    want = float(stats["loss"])
    assert abs(float(loss) - want) <= 1e-3 * abs(want), (float(loss), want)
    assert float(acc) == float(stats["acc"])


def _write_wav(path, y):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


def test_fused_cli_equals_cached_cli(tmp_path):
    """`train --fused --predict` on a tiny CPU dataset (16 labelled clips,
    4 test clips) writes its history, checkpoint and submission, and its
    history equals `train`'s from the cache; the banner names the mode."""
    wavs, labels = _clips(20, seed=4)
    root = tmp_path / "input"
    (root / "train").mkdir(parents=True)
    (root / "test").mkdir()
    rows = []
    for i, (y, lab) in enumerate(zip(wavs, labels)):
        if i < 16:
            t = "E" if lab else "I"
            rows.append(f"x_{t}_{i:04d},{t}")
            _write_wav(root / "train" / f"x_{i:04d}.wav", y)
        else:
            _write_wav(root / "test" / f"x_{i:04d}.wav", y)
    (root / "train.csv").write_text("ID,Target\n" + "\n".join(rows) + "\n")
    (root / "test.csv").write_text(
        "ID\n" + "".join(f"x_{i:04d}\n" for i in range(16, 20)))
    common = ["--root", str(root), "--device", "cpu", "--archs", "cnn8",
              "--epochs", "2", "--batch-size", "8"]
    cli.main(["precompute", *common[:4]])
    hist = {}
    for mode in ("cached", "fused"):
        out = tmp_path / mode
        cli.main(["train", *common, "--out-root", str(out), "--predict",
                  *(["--fused"] if mode == "fused" else [])])
        d = cli.ckpt_dir(str(out), "cnn8")
        assert ckpt_lib.latest_checkpoint(d) is not None
        with open(os.path.join(d, "history.jsonl")) as f:
            hist[mode] = [json.loads(line) for line in f]
        with open(out / "submissions" / "submission.csv") as f:
            sub = list(csv.reader(f))
        assert sub[0] == ["ID", "Target"] and len(sub) == 5
    assert [r["epoch"] for r in hist["fused"]] == [1, 2]
    for rc, rf in zip(hist["cached"], hist["fused"]):
        assert {k: v for k, v in rc.items() if k != "sec"} == {
            k: v for k, v in rf.items() if k != "sec"}
