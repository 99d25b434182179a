"""Data parallelism in the port (tpu_breath_torch/parallel/mesh.py) on the
CPU: ranks are OS processes joined over gloo, started as torchrun starts
them (tests/torch_mesh_worker.py). The 2-rank step against the single
process and against the JAX package's 8-device sharded step;
`train --mesh 2` and `precompute --mesh 2` against single-process runs; and
the parsing of --mesh."""
import json
import os
import socket
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpu_breath.augment import Batch as JxBatch
from tpu_breath.config import TrainCfg as JxTrainCfg
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.parallel import mesh as jx_mesh
from tpu_breath.train import loop as jx_loop
from tpu_breath_torch import augment, cli
from tpu_breath_torch.config import Paths, TrainCfg
from tpu_breath_torch.data import dataset as ds
from tpu_breath_torch.data import wav as wav_io
from tpu_breath_torch.features import extract_features_batched
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX
from tpu_breath_torch.train import loop
from tpu_breath_torch.train.schedule import warmup_cosine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
TIMEOUT = 300  # seconds a rank may take before the test fails


@pytest.fixture(autouse=True)
def one_thread():
    """The tests' own torch work on one thread, as the ranks run it
    (OMP_NUM_THREADS=1): the shapes are tiny, and on a loaded machine
    many threads a process slow every process down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(args: list[str], world: int = 2, module: bool = False
           ) -> list[str]:
    """Run `world` ranks of the worker (or, module=True, of python -m
    tpu_breath_torch) with a launcher's environment; their logs. Fails the
    test on a timeout or a non-zero exit."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        cmd = ([sys.executable, "-m", "tpu_breath_torch", *args] if module
               else [sys.executable, WORKER, *args])
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank timed out (collectives out of step?)")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return logs


def _params_close(got: dict, want: dict, lr: float) -> None:
    """tests/test_parallel.py's bounds on the parameters after one step:
    under 1e-3 of them off by more than 1e-4 (Adam moves a near-zero
    gradient whose sign depends on reduction order by a whole lr), none by
    3 lr; BatchNorm running statistics within 1e-5."""
    names = [k for k in want if "running" not in k and "num_batches" not in k]
    a = np.concatenate([got[k].numpy().ravel() for k in names])
    b = np.concatenate([want[k].numpy().ravel() for k in names])
    off = np.abs(a - b)
    assert (off > 1e-4).mean() < 1e-3, (off > 1e-4).mean()
    assert off.max() < 3 * lr, off.max()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def _batch16(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((16, 9, 16, 8)).astype(
                np.float32)),
            torch.from_numpy(rng.standard_normal((16, 36)).astype(
                np.float32)),
            torch.from_numpy(rng.integers(0, 2, 16).astype(np.float32)))


@pytest.mark.parametrize("cutmix_prob, mixup_prob", [(1.0, 0.0), (0.0, 1.0)])
def test_two_rank_step_equals_the_single_process(tmp_path, cutmix_prob,
                                                 mixup_prob):
    """One step of CNN8 (f32, dropout on, CutMix or MixUp on) on 2 gloo
    ranks, each with half of a batch of 16, against train_step on the whole
    batch with the same draws: the ranks' mean loss within 1e-5 and their
    mean accuracy equal to the single process's, the parameters within
    test_parallel.py's bounds, and both ranks' weights bit-equal."""
    feats, scals, labels = _batch16()
    cfg = TrainCfg(batch_size=16, cutmix_prob=cutmix_prob,
                   mixup_prob=mixup_prob)
    model = registry.build("cnn8", 36, seed=3, bf16=False)
    lr = 1e-3
    init = {"cfg": {"batch_size": 16, "cutmix_prob": cutmix_prob,
                    "mixup_prob": mixup_prob},
            "dropout": 0.3, "state": model.state_dict(), "features": feats,
            "scalars": scals, "labels": labels, "aug": True, "aug_seed": 5,
            "drop_seed": 6, "lr": lr}
    torch.save(init, tmp_path / "init.pt")
    _ranks(["step", str(tmp_path), str(tmp_path / "init.pt")])
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]

    opt = loop.make_optimizer(model, cfg)
    draws = augment.draw(torch.Generator().manual_seed(5), 16, 16, 8,
                         cfg.cutmix_alpha, cfg.mixup_alpha, "cpu")
    torch.manual_seed(6)
    loss, acc = loop.train_step(model, opt, lr,
                                augment.Batch(feats, scals, labels), cfg,
                                draws)
    assert abs(np.mean([r["loss"] for r in ranks]) - float(loss)) < 1e-5
    assert np.mean([r["acc"] for r in ranks]) == float(acc)
    _params_close(ranks[0]["state"], model.state_dict(), lr)
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_two_rank_step_equals_the_jax_package(tmp_path):
    """The 2-rank step on Flax's CNN8 parameters converted to the port
    (f32, no augmentation, dropout 0) against
    tpu_breath.train.loop.make_train_step under the 8-device mesh of
    tests/conftest.py: loss within 1e-5, accuracy equal, the parameters
    and BatchNorm statistics within test_parallel.py's bounds."""
    feats, scals, labels = _batch16(seed=1)
    jcfg = JxTrainCfg(num_epochs=1, batch_size=16, warmup_epochs=99)
    fm = FlaxCNN8(num_scalar_features=36, dropout_rate=0.0,
                  dtype=jnp.float32)
    f, s, y = (jnp.asarray(t.numpy()) for t in (feats, scals, labels))
    state, tx, schedule = jx_loop.create_state(
        fm, jax.random.PRNGKey(0), jcfg, steps_per_epoch=1,
        sample_batch=JxBatch(f[:2], s[:2], y[:2]))
    start = FROM_FLAX["cnn8"](jax.tree.map(np.asarray, state.params),
                              jax.tree.map(np.asarray, state.batch_stats))
    mesh = jx_mesh.make_mesh(jax.devices()[:8])
    state = jax.device_put(state, jx_mesh.replicated(mesh))
    new, stats = jx_loop.make_train_step(fm, tx, jcfg, mesh)(
        state, f, s, y, jnp.arange(16), jax.random.PRNGKey(1),
        jnp.asarray(False))
    want = FROM_FLAX["cnn8"](jax.tree.map(np.asarray, new.params),
                             jax.tree.map(np.asarray, new.batch_stats))

    lr = float(warmup_cosine(jcfg.base_lr, 1, jcfg.warmup_frac,
                             jcfg.lr_start_factor, jcfg.lr_eta_min)(0))
    assert lr == pytest.approx(float(schedule(0)), rel=1e-6)
    torch.save({"cfg": {"batch_size": 16}, "dropout": 0.0, "state": start,
                "features": feats, "scalars": scals, "labels": labels,
                "aug": False, "aug_seed": 0, "drop_seed": 0, "lr": lr},
               tmp_path / "init.pt")
    _ranks(["step", str(tmp_path), str(tmp_path / "init.pt")])
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]
    assert abs(np.mean([r["loss"] for r in ranks])
               - float(stats["loss"])) < 1e-5
    assert np.mean([r["acc"] for r in ranks]) == pytest.approx(
        float(stats["acc"]), abs=1e-6)
    _params_close(ranks[0]["state"], want, jcfg.base_lr)


# 59 labelled rows -> the 80/20 split's 47 train rows -> host shards of 24
# and 23 -> 5 steps a rank at local batch 4 (tests/test_multiprocess.py)
N_TRAIN, N_TEST = 59, 8


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """tests/test_multiprocess.py's uneven synthetic cache, in the port's
    cache format."""
    root = tmp_path_factory.mktemp("mesh_input")
    rng = np.random.default_rng(11)
    ids_tr = [f"breath_{'E' if i % 2 else 'I'}_{i:03d}"
              for i in range(N_TRAIN)]
    ids_te = [f"test_{i:03d}" for i in range(N_TEST)]
    with open(root / "train.csv", "w") as f:
        f.write("ID,Target\n")
        for i, fid in enumerate(ids_tr):
            f.write(f"{fid},{'E' if i % 2 else 'I'}\n")
    with open(root / "test.csv", "w") as f:
        f.write("ID\n" + "\n".join(ids_te) + "\n")
    all_ids = ids_tr + ids_te
    feats = rng.standard_normal((len(all_ids), 9, 16, 8)).astype(np.float32)
    y = np.asarray([1.0 if "_E_" in i else 0.0 for i in ids_tr]
                   + [0.5] * N_TEST)
    feats[:, 0, 0, 0] += 2.0 * y
    scals = rng.standard_normal((len(all_ids), 36)).astype(np.float32)
    ds.FeatureStore(all_ids, feats, scals).save_cache(
        Paths(str(root)).feature_cache)
    return root


def test_train_mesh_two_ranks(synth_root, tmp_path):
    """`python -m tpu_breath_torch train --mesh 2` in 2 gloo processes on
    the uneven cache (batch 8, 2 epochs, --f32): 2 history rows, 5 steps
    an epoch (the learning rate after each epoch is the schedule's at 5 and
    10 of 10 steps), both ranks' final weights bit-equal, losses within 0.5
    of the single-process run (test_multiprocess.py's bound), and every
    checkpoint written once, by rank 0."""
    args = ["train", "--root", str(synth_root), "--archs", "cnn8",
            "--epochs", "2", "--batch-size", "8", "--seed", "0", "--f32",
            "--device", "cpu"]
    out = tmp_path / "mp"
    logs = _ranks(["cli", str(out), *args, "--out-root", str(out),
                   "--mesh", "2"])
    assert "data-parallel mesh: 2 ranks, gloo" in logs[0]
    with open(os.path.join(cli.ckpt_dir(str(out), "cnn8"),
                           "history.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    assert len(hist) == 2
    cfg = cli._arch_cfg("cnn8", cli.build_parser().parse_args(args))
    sched = warmup_cosine(cfg.base_lr, 5 * 2, cfg.warmup_frac,
                          cfg.lr_start_factor, cfg.lr_eta_min)
    assert [r["lr"] for r in hist] == [sched(5), sched(10)]
    w0, w1 = (torch.load(out / f"cnn8_rank{r}.pt") for r in (0, 1))
    assert all(torch.equal(v, w1[k]) for k, v in w0.items())
    with open(out / "saves.txt") as f:
        saves = f.read().split()
    ckpts = [d for d in os.listdir(cli.ckpt_dir(str(out), "cnn8"))
             if d.startswith("best_epoch")]
    assert saves == ["0"] * len(ckpts) and ckpts

    cli.main([*args, "--out-root", str(tmp_path / "sp"), "--mesh", "off"])
    with open(os.path.join(cli.ckpt_dir(str(tmp_path / "sp"), "cnn8"),
                           "history.jsonl")) as f:
        single = [json.loads(line) for line in f]
    for a, b in zip(hist, single):
        assert np.isfinite([a["train_loss"], a["val_loss"]]).all()
        assert abs(a["train_loss"] - b["train_loss"]) < 0.5, (a, b)
        assert abs(a["val_loss"] - b["val_loss"]) < 0.5, (a, b)


def test_one_rank_streaming_fit_equals_the_resident_fit(synth_root,
                                                        monkeypatch):
    """fit(mesh=...) on one gloo rank in this process (streamed host
    batches, the gradient and epoch-end all-reduces over one rank) gives
    the resident path's history: the same batches in the same order, the
    same draws, and reductions over one rank that change no bit."""
    from tpu_breath_torch.parallel import mesh as mesh_lib

    tr, va, _, y_tr, y_va = cli._prepare_splits(
        Paths(str(synth_root)), None, torch.device("cpu"))
    cfg = TrainCfg(num_epochs=3, batch_size=8, eval_batch_size=16,
                   warmup_epochs=1)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    hist = {}
    mesh = mesh_lib.make_mesh("cpu")
    try:
        assert (mesh.world, mesh.backend) == (1, "gloo")
        for name, m in (("resident", None), ("streaming", mesh)):
            model = registry.build("cnn8", 36, seed=0, bf16=False)
            hist[name] = loop.fit(model, (tr.features, tr.scalars),
                                  (va.features, va.scalars), y_tr, y_va,
                                  cfg, device="cpu", mesh=m,
                                  log_fn=lambda msg: None).history
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(hist["resident"], hist["streaming"]):
        a, b = ({k: v for k, v in r.items() if k != "sec"} for r in (a, b))
        assert a == b
    assert len(hist["streaming"]) == 3


def _write_wav(path, samples) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def test_precompute_mesh_two_ranks_equals_one_process(tmp_path):
    """`precompute --mesh 2` in 2 gloo processes on 6 train + 3 test noise
    wavs at chunk 2 (super-chunks of 4, the last padded): the cache equals
    single-process extract_features_batched, the features bit for bit (one
    thread on both sides: one_thread) and the scalars within JAX's rtol
    1e-6 / atol 2e-6."""
    root = tmp_path / "wavs"
    rng = np.random.default_rng(4)
    for d in ("train", "test"):
        os.makedirs(root / d)
    ids = []
    with open(root / "train.csv", "w") as f:
        f.write("ID,Target\n")
        for i in range(6):
            ids.append(f"x_{'E' if i % 2 else 'I'}_{i:03d}")
            f.write(f"{ids[-1]},{'E' if i % 2 else 'I'}\n")
            _write_wav(root / "train" / ds.train_wav_name(ids[-1]),
                       0.1 * rng.standard_normal(16000))
    with open(root / "test.csv", "w") as f:
        f.write("ID\n")
        for i in range(3):
            ids.append(f"t_{i:03d}")
            f.write(f"{ids[-1]}\n")
            _write_wav(root / "test" / ds.test_wav_name(ids[-1]),
                       0.05 * rng.standard_normal(16000))
    logs = _ranks(["precompute", "--root", str(root), "--out-root",
                   str(root), "--chunk", "2", "--mesh", "2", "--device",
                   "cpu"], module=True)
    assert "data-parallel mesh: 2 ranks, gloo" in logs[1]
    store = ds.FeatureStore.load_cache(Paths(str(root)).feature_cache)
    assert list(store.ids) == ids
    paths = ([str(root / "train" / ds.train_wav_name(i)) for i in ids[:6]]
             + [str(root / "test" / ds.test_wav_name(i)) for i in ids[6:]])
    f, s = extract_features_batched(wav_io.load_wav_batch(paths), chunk=2,
                                    device="cpu")
    assert np.array_equal(np.asarray(store.features), f, equal_nan=True)
    np.testing.assert_allclose(np.asarray(store.scalars), s, rtol=1e-6,
                               atol=2e-6)


@pytest.mark.parametrize("cmd, default", [("precompute", "off"),
                                          ("train", "auto"),
                                          ("e2e", "auto")])
def test_mesh_defaults(cmd, default):
    assert cli.build_parser().parse_args([cmd]).mesh == default


@pytest.mark.parametrize("world, arg, outcome", [
    (None, "auto", None), (None, "off", None), (None, "1", None),
    ("1", "auto", None), (None, "2", "2 but the launcher started 1"),
    ("2", "3", "3 but the launcher started 2"),
    ("2", "off", "off under a launcher of 2 ranks"),
    (None, "two", "want auto, off or a number")])
def test_resolve_mesh(monkeypatch, world, arg, outcome):
    """auto in one process is off (the JAX package's n <= 1); N must equal
    the launcher's WORLD_SIZE; off under more than one rank raises (the
    ranks would race to write the same files)."""
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    device = torch.device("cpu")
    if outcome is None:
        assert cli._resolve_mesh(arg, device) is None
    else:
        with pytest.raises(ValueError, match=outcome):
            cli._resolve_mesh(arg, device)
