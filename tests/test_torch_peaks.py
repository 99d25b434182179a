"""Kernel C (find_peaks greedy suppression) of the PyTorch port, plain
version, against the JAX package's find_peaks_stats_batched (XLA and the
Pallas kernel in interpret mode, atol 1e-5) and scipy's peak counts, and
against suppress_peaks_pallas exactly on adversarial score sets
(tests/peaks_cases.py)."""
import numpy as np
import pytest
import scipy.signal
import jax
import jax.numpy as jnp
import torch

from tpu_breath.ops import peaks as jx_peaks
from tpu_breath.ops.pallas import peaks_kernel as jx_pallas_peaks
from tpu_breath_torch.ops import peaks
from tpu_breath_torch.ops.cuda import peaks_kernel

from tests import peaks_cases

SR = 16000


@pytest.fixture(scope="module")
def envs():
    rng = np.random.default_rng(21)
    out = []
    for i in range(6):
        env = np.abs(scipy.signal.hilbert(
            rng.standard_normal(16000))).astype(np.float32)
        if i % 2:
            env = np.round(env * 64) / 64  # quantized -> plateaus and ties
        out.append(env)
    return np.stack(out)


def _assert_stats_match_jax(envs, use_pallas):
    h = envs.mean(axis=-1)
    ref = jax.jit(lambda x, y: jx_peaks.find_peaks_stats_batched(
        x, y, SR // 10, use_pallas=use_pallas))(jnp.asarray(envs),
                                                jnp.asarray(h))
    got = peaks.find_peaks_stats_batched(torch.from_numpy(envs),
                                         torch.from_numpy(h), SR // 10)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stats_match_jax(envs, use_pallas):
    _assert_stats_match_jax(envs, use_pallas)


def test_stats_match_jax_on_rows_past_the_shared_memory_list():
    """Rows of 40,000 samples, past kernel C's shared-memory list (its
    wrapper then keeps the list in device memory): the plain version gives
    JAX's XLA path's counts exactly and its heights' mean and std within
    the comparison above, and scipy's counts."""
    assert 40_000 > peaks_kernel.SMEM_SAMPLES
    rng = np.random.default_rng(40)
    envs = np.stack([np.abs(scipy.signal.hilbert(rng.standard_normal(40_000)))
                     for _ in range(2)]).astype(np.float32)
    envs[1] = np.round(envs[1] * 64) / 64
    _assert_stats_match_jax(envs, use_pallas=False)
    n = peaks.find_peaks_stats_batched(
        torch.from_numpy(envs), torch.from_numpy(envs.mean(axis=-1)),
        SR // 10)[0]
    for i, env in enumerate(envs):
        pk, _ = scipy.signal.find_peaks(env, height=float(env.mean()),
                                        distance=SR // 10)
        assert int(n[i]) == len(pk) >= 15


def test_counts_and_heights_match_scipy(envs):
    h = envs.mean(axis=-1)
    n, mean, std = peaks.find_peaks_stats_batched(
        torch.from_numpy(envs), torch.from_numpy(h), SR // 10)
    for i, env in enumerate(envs):
        pk, props = scipy.signal.find_peaks(env, height=float(h[i]),
                                            distance=SR // 10)
        assert int(n[i]) == len(pk)
        hts = props["peak_heights"]
        np.testing.assert_allclose(float(mean[i]), hts.mean(), atol=1e-5)
        np.testing.assert_allclose(float(std[i]), hts.std(), atol=1e-5)


def test_local_maxima_matches_jax_on_plateaus(envs):
    x = np.concatenate([envs[1], [0.0, 1.0, 1.0, 1.0, 1.0, 0.5, 2.0, 2.0]]
                       ).astype(np.float32)
    got = peaks.local_maxima(torch.from_numpy(x[None]))[0].numpy()
    ref = np.asarray(jax.jit(jx_peaks.local_maxima)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    # scipy's plateau midpoint: the run 1,1,1,1 at 16001..16004 peaks at 16002
    assert got[16002] and not got[16003]
    assert not got[-1] and not got[-2]  # a run touching the end never counts


def test_empty_and_single_peak():
    z = torch.zeros(2, 16000)
    n, m, s = peaks.find_peaks_stats_batched(z, torch.tensor([0.5, 0.5]),
                                             SR // 10)
    assert torch.all(n == 0) and torch.all(m == 0) and torch.all(s == 0)
    one = torch.zeros(1, 16000)
    one[0, 8000] = 1.0
    n, m, s = peaks.find_peaks_stats_batched(one, torch.tensor([0.0]),
                                             SR // 10)
    assert int(n[0]) == 1 and abs(float(m[0]) - 1.0) < 1e-6
    assert float(s[0]) == 0.0


def test_suppression_ties_go_to_lowest_index():
    scores = torch.full((1, 100), -torch.inf)
    scores[0, [10, 30, 31, 60]] = torch.tensor([1.0, 2.0, 2.0, 2.0])
    vals, kept = peaks_kernel.suppress_peaks(scores, 25, 6)
    # 30 wins the tie with 31 (which it suppresses), then 60, then 10's
    # window (|10 - 30| < 25) was already suppressed by 30
    assert kept[0].tolist() == [True, True, False, False, False, False]
    assert vals[0, :2].tolist() == [2.0, 2.0]


CASES = peaks_cases.cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_suppression_matches_pallas_on_adversarial_sets(name):
    """Kernel C's plain version equals suppress_peaks_pallas (interpret
    mode): kept equal, vals exact (0 where nothing was kept). On the sets
    made from a signal, the survivors are scipy's find_peaks peaks."""
    scores, signal, rounds = CASES[name]
    vals, kept = peaks_kernel.suppress_peaks(torch.from_numpy(scores[None]),
                                             peaks_cases.DISTANCE, rounds)
    rv, rk = jx_pallas_peaks.suppress_peaks_pallas(
        jnp.asarray(scores[None]), peaks_cases.DISTANCE, rounds, True)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    if signal is not None:
        x, height = signal
        pk, props = scipy.signal.find_peaks(x, height=height,
                                            distance=peaks_cases.DISTANCE)
        assert int(kept.sum()) == len(pk)
        np.testing.assert_array_equal(np.sort(vals[kept].numpy()),
                                      np.sort(props["peak_heights"]))
