"""The port's compiled dispatch on the CPU: features.extract_features_compiled,
the queued extract_features_batched (tail padded) and ensemble.Server
behind serve_from_wav (use_softmax restored), against the eager path and
the JAX package's extract_features_batched and serve_from_wav; and
write_submission's threshold against the JAX package's.

On the CPU every entry runs the eager path and captures no graph; the
graphs themselves run only on the card (tests/test_torch_cuda.py, marker
`cuda`). Clips: the golden wavs and circular shifts of them at seeded
gains (real stethoscope spectra, the parity sweep's real clips), made with
numpy."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath import ensemble as jx_ensemble
from tpu_breath.config import DEFAULT_FEATURES as SPEC, TrainCfg
from tpu_breath.features import extract_features_batched as jx_batched
from tpu_breath_torch import ensemble, features, graphs
from tpu_breath_torch.models.cnn8 import CNN8
from tpu_breath_torch.models.convert import cnn8_from_flax
from tpu_breath_torch.train import checkpoint as ckpt_lib

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: repeated calls of one shape then sum in one order
    (MKL's blocking moves with the threads it gets under a loaded CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _real_clips(n: int, seed: int = 0) -> np.ndarray:
    """The two golden wavs, then circular shifts of them at gains 0.1-3."""
    gold = [np.load(p)["wav"] for p in FIXTURES]
    rng = np.random.default_rng(seed)
    clips = list(gold)
    while len(clips) < n:
        g = gold[len(clips) % len(gold)]
        clips.append(np.roll(g, int(rng.integers(1, len(g))))
                     * 10.0 ** rng.uniform(-1.0, 0.5))
    return np.stack(clips[:n]).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    return _real_clips(13)


@pytest.fixture(scope="module")
def one_call(clips):
    f, s = features.extract_features(torch.from_numpy(clips))
    return f.numpy(), s.numpy()


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("fused_gt", [False, True])
def test_compiled_entry_on_cpu_is_extract_features(clips, fused_gt):
    """On a CPU tensor the compiled entry is extract_features: the same
    outputs bit for bit, new tensors a call, and no graph captured."""
    y = torch.from_numpy(clips[:3])
    before = dict(features._GRAPHS)
    ref = features.extract_features(y, fused_gt=fused_gt)
    got = features.extract_features_compiled(y, fused_gt=fused_gt)
    again = features.extract_features_compiled(y, fused_gt=fused_gt)
    assert all(_nan_equal(g, r) for g, r in zip(got, ref))
    assert all(a.data_ptr() != g.data_ptr() for a, g in zip(again, got))
    assert features._GRAPHS == before


def test_batched_tail_equals_one_call(clips, one_call):
    """13 clips in chunks of 8 (the tail padded to 8 with silence, its
    rows dropped) against one call of 13: equal NaN masks, features within
    2e-4 abs and scalars within 2e-4 rel (floor 1e-2), the bound of
    test_torch_features.py::test_batched_chunks_equal_one_call (the mel
    chain's float64 product sums in a blocking that moves with the batch)."""
    f, s = features.extract_features_batched(clips, chunk=8, device="cpu")
    assert f.shape == one_call[0].shape and s.shape == one_call[1].shape
    np.testing.assert_array_equal(np.isnan(f), np.isnan(one_call[0]))
    np.testing.assert_array_equal(np.isnan(s), np.isnan(one_call[1]))
    assert np.nanmax(np.abs(f - one_call[0])) <= 2e-4
    rel = np.abs(s - one_call[1]) / np.maximum(np.abs(one_call[1]), 1e-2)
    assert np.nanmax(rel) <= 2e-4


def test_batched_tail_matches_jax(clips):
    """The same 13 clips in chunks of 8 through the JAX package's
    extract_features_batched, which pads its tail chunk too: per channel
    within 3e-4 abs and scalars within 5e-4 rel (floor 1e-2), the bounds
    of tests/test_torch_features.py."""
    f, s = features.extract_features_batched(clips, chunk=8, device="cpu")
    jf, js = jx_batched(clips, SPEC, chunk=8)
    np.testing.assert_array_equal(np.isnan(f), np.isnan(jf))
    for c, name in enumerate(SPEC.channel_order):
        err = np.nanmax(np.abs(f[:, c] - jf[:, c]))
        assert err <= 3e-4, (name, err)
    rel = np.abs(s - js) / np.maximum(np.abs(js), 1e-2)
    assert np.nanmax(rel) <= 5e-4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two CNN8 checkpoints of the JAX package (tests/test_serve.py's
    setup: create_state from PRNGKeys 0 and 1) and the same weights as the
    port's checkpoints, through the port's converter."""
    from tpu_breath.augment import Batch
    from tpu_breath.features import extract_features as jx_extract
    from tpu_breath.models import registry
    from tpu_breath.train import checkpoint as jx_ckpt
    from tpu_breath.train.loop import create_state

    tmp = tmp_path_factory.mktemp("graphs_serve")
    wavs = _real_clips(6, seed=3)
    f0, s0 = jax.jit(lambda w: jx_extract(w, SPEC))(jnp.asarray(wavs[:1]))
    sample = Batch(f0, s0, jnp.zeros(1, jnp.float32))
    jx_paths, pt_paths = [], []
    for i in range(2):
        state, _, _ = create_state(registry.build("cnn8", SPEC.n_scalars),
                                   jax.random.PRNGKey(i), TrainCfg(), 1,
                                   sample)
        jx_paths.append(jx_ckpt.save(str(tmp / f"jax{i}"), state, 1,
                                     {"val_acc": 0.7 + 0.05 * i}))
        model = CNN8(SPEC.n_scalars)
        model.load_state_dict(cnn8_from_flax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats)))
        pt_paths.append(ckpt_lib.save(str(tmp / f"torch{i}"), model, 1,
                                      {"val_acc": 0.7 + 0.05 * i}))
    return {"wavs": wavs, "jax": jx_paths, "torch": pt_paths,
            "scores": [0.7, 0.75]}


@pytest.mark.parametrize("use_softmax", [True, False])
def test_serve_from_wav_matches_jax(checkpoints, use_softmax):
    """6 clips, micro-batches of 4 (a tail of 2 padded and dropped), two
    CNN8 members blended by softmax or normalised val accuracies: within
    1e-3 of the JAX package's serve_from_wav (f32 on both sides; the
    features differ by up to 3e-4, test_torch_features.py), the bound of
    tests/test_torch_serve.py."""
    c = checkpoints
    want = jx_ensemble.serve_from_wav(c["jax"], ["cnn8", "cnn8"],
                                      c["scores"], c["wavs"], SPEC,
                                      use_softmax=use_softmax, micro_batch=4)
    got = ensemble.serve_from_wav(c["torch"], ["cnn8", "cnn8"], c["scores"],
                                  c["wavs"], use_softmax=use_softmax,
                                  micro_batch=4, device="cpu")
    assert got.dtype == np.float64 and got.shape == (6,)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_server_on_cpu_captures_nothing_and_pads_the_tail(checkpoints):
    """A Server on the CPU runs its program eagerly (no graph), and a clip's
    probability does not depend on the micro-batch it lands in beyond the
    features' batch bound: micro-batches of 4 (a padded tail) against one
    of 6 within 1e-5."""
    models = ensemble.load_models(checkpoints["torch"], ["cnn8", "cnn8"],
                                  SPEC.n_scalars, "cpu")
    server = ensemble.Server(models, ensemble.softmax_weights([0.7, 0.75]),
                             device="cpu")
    by4 = server(checkpoints["wavs"], micro_batch=4)
    by6 = server(checkpoints["wavs"], micro_batch=6)
    assert server.graphs == {}
    np.testing.assert_allclose(by4, by6, atol=1e-5, rtol=0)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_write_submission_threshold_matches_jax(tmp_path, threshold):
    """probs > threshold -> 'E': the same csv as the JAX package's."""
    ids, probs = ["a", "b", "c", "d"], [0.9, 0.5, 0.31, 0.3]
    rows = ensemble.write_submission(ids, probs, str(tmp_path / "t.csv"),
                                     threshold=threshold)
    jx_ensemble.write_submission(ids, probs, str(tmp_path / "j.csv"),
                                 threshold=threshold)
    assert ((tmp_path / "t.csv").read_text().splitlines()
            == (tmp_path / "j.csv").read_text().splitlines())
    assert rows == [(i, "E" if p > threshold else "I")
                    for i, p in zip(ids, probs)]


def test_replay_launch_accounting():
    """graphs.add_launches adds a graph's per-kernel counts to the wrappers'
    counters (what a replay does) and read_launches reads them back."""
    before = graphs.read_launches()
    graphs.add_launches({"A": 2, "B''": 1, "C": 1, "E": 1})
    after = graphs.read_launches()
    graphs.add_launches({"A": -2, "B''": -1, "C": -1, "E": -1})
    assert {k: after[k] - before[k] for k in after} == {
        "A": 2, "B": 0, "B'": 0, "B''": 1, "C": 1, "D": 0, "E": 1, "F": 0}
    assert graphs.read_launches() == before
    from tpu_breath_torch.ops.cuda import gammatone_kernel, tuning_kernel
    assert (tuning_kernel.LAUNCHES, gammatone_kernel.LAUNCHES) == (
        before["A"], before["B''"])
