"""The programs that replay as CUDA graphs on an NCCL mesh, held against the
JAX package's sharded programs on the CPU: the sharded evaluation
(loop.Predictor and evaluate under a mesh, make_eval_step(model, mesh)),
the sharded extraction (features._extract_sharded, the JAX package's
extract_features_batched(..., mesh=...)) and the streamed step
(loop.TrainStep on a rank's batch, make_train_step_batched(..., mesh)),
cached against the JAX package and fused against the port's single
process; and the predicate that decides whether a mesh's programs replay.

On the CPU the ranks are OS processes joined over gloo
(tests/torch_mesh_worker.py `graphs`, started once for the module as
tests/test_torch_mesh.py starts them), and the programs run eagerly; the
JAX side runs under the 8-device mesh of tests/conftest.py. The graphs
themselves run on the card (tests/test_torch_cuda.py, marker `cuda`, and
chip_smoke.py's mesh phase). Inputs are made with numpy from seeds; each
test states its tolerance."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.augment import Batch as JxBatch
from tpu_breath.config import DEFAULT_FEATURES as JX_SPEC
from tpu_breath.config import TrainCfg as JxTrainCfg
from tpu_breath.features import extract_features_batched as jx_batched
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.parallel import mesh as jx_mesh
from tpu_breath.train import loop as jx_loop
from tpu_breath_torch import graphs
from tpu_breath_torch.config import DEFAULT_FEATURES, TrainCfg
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX
from tpu_breath_torch.parallel import mesh as mesh_lib
from tpu_breath_torch.train import loop
from tpu_breath_torch.train.schedule import warmup_cosine
from tests.test_torch_mesh import _params_close, _ranks

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))
# the evaluation: 11 validation rows in eval batches of 5, so the tail
# batch is padded (one real row) and every batch is padded further to 6
# rows, 3 a rank
N_VAL, EVAL_BATCH = 11, 5
# the extraction: 5 clips at 2 a rank, super-chunks of 4, the last padded
N_CLIPS, CHUNK = 5, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as the ranks run (OMP_NUM_THREADS=1): many small
    ops, which parallel test workers slow by orders of magnitude when each
    spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(n: int, seed: int) -> np.ndarray:
    """The two golden wavs, then circular shifts of them at seeded gains
    0.1-3 (real stethoscope spectra)."""
    gold = [np.load(p)["wav"] for p in FIXTURES]
    rng = np.random.default_rng(seed)
    clips = list(gold)
    while len(clips) < n:
        g = gold[len(clips) % len(gold)]
        clips.append(np.roll(g, int(rng.integers(1, len(g))))
                     * 10.0 ** rng.uniform(-1.0, 0.5))
    return np.stack(clips[:n]).astype(np.float32)


def _flax_cnn8(f: np.ndarray, s: np.ndarray, y: np.ndarray, seed: int,
               batch_size: int):
    """Flax's CNN8 (f32, dropout 0) with its train state, optax chain and
    schedule, and the same weights in the port's layout."""
    jcfg = JxTrainCfg(num_epochs=1, batch_size=batch_size, warmup_epochs=99)
    fm = FlaxCNN8(num_scalar_features=36, dropout_rate=0.0,
                  dtype=jnp.float32)
    state, tx, schedule = jx_loop.create_state(
        fm, jax.random.PRNGKey(seed), jcfg, steps_per_epoch=1,
        sample_batch=JxBatch(*(jnp.asarray(a[:2]) for a in (f, s, y))))
    port = FROM_FLAX["cnn8"](jax.tree.map(np.asarray, state.params),
                             jax.tree.map(np.asarray, state.batch_stats))
    return fm, jcfg, state, tx, schedule, port


def _data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 9, 16, 8)).astype(np.float32),
            rng.standard_normal((n, 36)).astype(np.float32),
            (np.arange(n) % 2).astype(np.float32))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Every input of the module, and one launch of two gloo ranks that
    runs all four programs on them; (inputs, each rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh_graphs")
    f, s, y = _data(N_VAL, seed=7)
    fm, _, state, _, _, port = _flax_cnn8(f, s, y, 0, EVAL_BATCH)
    ev = {"features": torch.from_numpy(f), "scalars": torch.from_numpy(s),
          "labels": y, "batch_size": EVAL_BATCH, "state": port}
    cf, cs, cy = _data(16, seed=1)
    cfm, jcfg, cstate, tx, schedule, cport = _flax_cnn8(cf, cs, cy, 0, 16)
    lr = float(warmup_cosine(jcfg.base_lr, 1, jcfg.warmup_frac,
                             jcfg.lr_start_factor, jcfg.lr_eta_min)(0))
    cached = {"cfg": {"batch_size": 16}, "dropout": 0.0, "state": cport,
              "batch": tuple(map(torch.from_numpy, (cf, cs, cy))),
              "fused": False, "aug": False, "aug_seed": 0, "drop_seed": 0,
              "lr": lr}
    wavs = _clips(4, seed=5)
    model = registry.build("cnn8", 36, seed=3, dropout_rate=0.3, bf16=False)
    fused = {"cfg": {"batch_size": 4, "cutmix_prob": 0.0, "mixup_prob": 1.0},
             "dropout": 0.3, "state": model.state_dict(),
             "batch": (torch.from_numpy(wavs),
                       torch.tensor([0.0, 1.0, 1.0, 0.0])),
             "fused": True, "aug": True, "aug_seed": 5, "drop_seed": 6,
             "lr": 1e-3}
    extract = {"wavs": _clips(N_CLIPS, seed=2), "chunk": CHUNK}
    init = {"eval": ev, "extract": extract, "cached": cached,
            "fused": fused}
    torch.save(init, tmp / "init.pt")
    _ranks(["graphs", str(tmp), str(tmp / "init.pt")])
    ranks = [torch.load(tmp / f"graphs_rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    jax_side = {"eval": (fm, state), "cached": (cfm, jcfg, cstate, tx,
                                                schedule)}
    return init, jax_side, ranks


def test_sharded_evaluation_equals_the_jax_package(case):
    """Two ranks' sharded Predictor (11 rows, eval batches of 5: the tail
    padded with its last row, each batch padded further to 6 for the two
    ranks) against make_eval_step(model, mesh) under the 8-device mesh,
    batch by batch as the JAX package's evaluate pads them, on Flax's
    CNN8 parameters converted to the port (f32): every rank's logits
    within 1e-5 abs of JAX's; evaluate's threshold metrics (accuracy,
    AUC, precision, recall, F1) equal to jx_loop.evaluate's, the loss and
    the probability range within 1e-5; both ranks' results equal."""
    init, jax_side, ranks = case
    e = init["eval"]
    fm, state = jax_side["eval"]
    mesh = jx_mesh.make_mesh(jax.devices()[:8])
    state = jax.device_put(state, jx_mesh.replicated(mesh))
    step = jx_loop.make_eval_step(fm, mesh)
    f, s = jnp.asarray(e["features"].numpy()), jnp.asarray(
        e["scalars"].numpy())
    want = []
    for lo in range(0, N_VAL, EVAL_BATCH):
        hi = min(lo + EVAL_BATCH, N_VAL)
        idx = np.concatenate([np.arange(lo, hi),
                              np.full(EVAL_BATCH - (hi - lo), hi - 1)])
        want.append(np.asarray(step(state, f, s, jnp.asarray(idx)))[:hi - lo])
    want = np.concatenate(want)
    metrics = jx_loop.evaluate(step, state, f, s, e["labels"], EVAL_BATCH)
    for r in ranks:
        assert r["logits"].shape == (N_VAL,)
        np.testing.assert_allclose(r["logits"], want, rtol=0, atol=1e-5)
        for k in ("acc", "auc", "precision", "recall", "f1"):
            assert r["metrics"][k] == metrics[k], k
        for k in ("loss", "prob_min", "prob_max"):
            assert abs(r["metrics"][k] - metrics[k]) <= 1e-5, k
    assert np.array_equal(ranks[0]["logits"], ranks[1]["logits"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def test_sharded_extraction_equals_the_jax_package(case):
    """Two ranks' _extract_sharded of 5 clips at 2 a rank (super-chunks of
    4, the last padded with silence) against the JAX package's
    extract_features_batched(..., mesh=...) under the 8-device mesh at 1
    clip a device (one super-chunk of 8, padded): NaN masks equal, each
    channel within 3e-4 abs and the scalars within 5e-4 rel (floor 1e-2),
    the bounds of tests/test_torch_graphs.py::test_batched_tail_matches_jax;
    both ranks return the same arrays bit for bit."""
    init, _, ranks = case
    wavs = init["extract"]["wavs"]
    jf, js = jx_batched(wavs, JX_SPEC, chunk=1,
                        mesh=jx_mesh.make_mesh(jax.devices()[:8]))
    for r in ranks:
        f, s = r["features"], r["scalars"]
        assert f.shape == jf.shape and s.shape == js.shape
        np.testing.assert_array_equal(np.isnan(f), np.isnan(jf))
        np.testing.assert_array_equal(np.isnan(s), np.isnan(js))
        for c, name in enumerate(DEFAULT_FEATURES.channel_order):
            err = np.nanmax(np.abs(f[:, c] - jf[:, c]))
            assert err <= 3e-4, (name, err)
        rel = np.abs(s - js) / np.maximum(np.abs(js), 1e-2)
        assert np.nanmax(rel) <= 5e-4
    for k in ("features", "scalars"):
        assert np.array_equal(ranks[0][k], ranks[1][k], equal_nan=True)


def test_cached_mesh_step_equals_the_jax_package(case):
    """One streamed step of two ranks through loop.TrainStep (data None,
    8 rows a rank, no augmentation, dropout 0, Flax's CNN8 parameters
    converted, f32) against make_train_step_batched(..., mesh) under the
    8-device mesh on the global batch of 16: the ranks' mean loss within
    1e-5 and mean accuracy within 1e-6, the parameters and BatchNorm
    statistics within tests/test_parallel.py's bounds
    (test_torch_mesh._params_close), both ranks' weights bit-equal."""
    init, jax_side, ranks = case
    fm, jcfg, state, tx, schedule = jax_side["cached"]
    c = init["cached"]
    assert c["lr"] == pytest.approx(float(schedule(0)), rel=1e-6)
    mesh = jx_mesh.make_mesh(jax.devices()[:8])
    state = jax.device_put(state, jx_mesh.replicated(mesh))
    batch = JxBatch(*(jnp.asarray(t.numpy()) for t in c["batch"]))
    new, stats = jx_loop.make_train_step_batched(fm, tx, jcfg, mesh)(
        state, batch, jax.random.PRNGKey(1), jnp.asarray(False))
    want = FROM_FLAX["cnn8"](jax.tree.map(np.asarray, new.params),
                             jax.tree.map(np.asarray, new.batch_stats))
    got = [r["cached"] for r in ranks]
    assert abs(np.mean([r["loss"] for r in got])
               - float(stats["loss"])) < 1e-5
    assert np.mean([r["acc"] for r in got]) == pytest.approx(
        float(stats["acc"]), abs=1e-6)
    _params_close(got[0]["state"], want, jcfg.base_lr)
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k


def test_fused_mesh_step_equals_the_single_process(case):
    """One fused streamed step of two ranks through loop.TrainStep (2
    golden-derived wavs a rank, features computed in the step, MixUp on,
    dropout 0.3, f32) against the port's single-process fused TrainStep on
    the 4 wavs with the same draws (tests/test_torch_fused.py holds that
    step against JAX): the ranks' mean loss within 1e-5 and mean accuracy
    equal, the parameters within tests/test_parallel.py's bounds, both
    ranks' weights bit-equal."""
    init, _, ranks = case
    d = init["fused"]
    cfg = TrainCfg(**d["cfg"])
    model = registry.build("cnn8", 36, dropout_rate=d["dropout"], bf16=False)
    model.load_state_dict(d["state"])
    step = loop.TrainStep(model, loop.make_optimizer(model, cfg), d["batch"],
                          cfg, torch.Generator().manual_seed(d["aug_seed"]),
                          DEFAULT_FEATURES)
    torch.manual_seed(d["drop_seed"])
    loss, acc = step(torch.arange(4), torch.tensor(d["lr"]),
                     torch.tensor(d["aug"]))
    got = [r["fused"] for r in ranks]
    assert abs(np.mean([r["loss"] for r in got]) - float(loss)) < 1e-5
    assert np.mean([r["acc"] for r in got]) == float(acc)
    _params_close(got[0]["state"], model.state_dict(), d["lr"])
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_mesh_replays_only_on_nccl_cards_outside_eager(backend, device,
                                                       eager):
    """A mesh's programs replay as graphs exactly when its backend is NCCL,
    its device a card, and the call outside graphs.eager() (no card is
    needed to ask)."""
    mesh = mesh_lib.Mesh(0, 2, torch.device(device, 0), backend)
    want = backend == "nccl" and device == "cuda" and not eager
    if eager:
        with graphs.eager():
            assert mesh_lib.replays(mesh) is want
    else:
        assert mesh_lib.replays(mesh) is want
