"""Kernel A (tuning-estimate tail) of the PyTorch port, plain version,
against the JAX package: the XLA path (ops/chroma.py), the Pallas kernel in
interpret mode, and the NumPy oracle. Tuning indices must be exactly equal.
"""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.baseline import dsp_np
from tpu_breath.ops import chroma as jx_chroma
from tpu_breath.ops import select as jx_select
from tpu_breath.ops.pallas.tuning_kernel import estimate_tuning_index_pallas
from tpu_breath_torch.ops import chroma, select
from tpu_breath_torch.ops.cuda import tuning_kernel

SR = 16000
FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))
# bpo -> (n_fft, hop) of the spectrogram the main path feeds the estimate:
# chroma_stft reads |STFT_512| (hop 256), CENS |STFT_2048| at hop 512
GEOMETRY = {12: (512, 256), 36: (2048, 512)}
CASES = ("golden0", "golden1", "noise0", "noise1", "silence", "impulse",
         "plateau")


def _clips() -> np.ndarray:
    rng = np.random.default_rng(11)
    golden = [np.load(p)["wav"] for p in FIXTURES]
    imp = np.zeros(SR, np.float32)
    imp[SR // 3] = 0.7
    noise = [rng.standard_normal(SR).astype(np.float32) * a
             for a in (0.05, 0.002)]
    return np.stack(golden + noise + [np.zeros(SR, np.float32), imp,
                                      golden[0]]).astype(np.float32)


@pytest.fixture(scope="module")
def spectra():
    """bpo -> f32(|STFT_f64|) [7, F, T] per case; the plateau case
    quantizes the first golden clip's spectrum (ties in localmax/median)."""
    clips = _clips()
    out = {}
    for bpo, (n_fft, hop) in GEOMETRY.items():
        S = np.stack([np.abs(dsp_np.stft(c.astype(np.float64), n_fft, hop))
                      for c in clips]).astype(np.float32)
        S[-1] = np.round(S[-1] * 16) / 16
        out[bpo] = S
    return out


@pytest.fixture(scope="module")
def results(spectra):
    """Per bpo: the index from the port, JAX XLA, JAX Pallas (interpret),
    the port's kernel wrapper on JAX's piptrack outputs, and the oracle."""
    res = {}
    for bpo, S in spectra.items():
        n_fft = GEOMETRY[bpo][0]
        xla = np.asarray(jax.jit(jax.vmap(
            lambda s: jx_chroma.estimate_tuning_index(s, SR, n_fft, bpo)))(S))
        p, m = jax.jit(jax.vmap(
            lambda s: jx_chroma._piptrack_band(s, SR, n_fft)))(S)
        pallas = np.asarray(estimate_tuning_index_pallas(p, m, bpo))
        wrapper = tuning_kernel.estimate_tuning_index(
            torch.from_numpy(np.array(p)), torch.from_numpy(np.array(m)),
            bpo).numpy()
        port = chroma.estimate_tuning_index(torch.from_numpy(S), SR, n_fft,
                                            bpo).numpy()
        oracle = np.array([
            int(round((dsp_np.estimate_tuning_from_S(s, SR, n_fft, bpo)
                       + 0.5) / 0.01)) for s in S])
        res[bpo] = {"xla": xla, "pallas": pallas, "wrapper": wrapper,
                    "port": port, "oracle": oracle, "band": (p, m)}
    return res


def _tie_width(S, bpo, n_fft):
    """The oracle histogram's top1 - top2 count gap (tools/parity_sweep.py):
    0 is a pure tie-break, 1 means one residual decides the argmax."""
    pitches, mags = dsp_np.piptrack(S, SR, n_fft)
    mask = pitches > 0
    thr = np.median(mags[mask]) if mask.any() else 0.0
    f = pitches[(mags >= thr) & mask].astype(np.float32)
    octs = np.float32(np.log2(np.float32(f.astype(np.float64) / 27.5)
                              .astype(np.float64)))
    r = np.mod(np.float32(bpo) * octs, np.float32(1.0))
    r[r >= 0.5] -= np.float32(1.0)
    top = np.sort(np.histogram(r, np.linspace(-0.5, 0.5, 101))[0])[-2:]
    return int(top[1] - top[0])


@pytest.mark.parametrize("bpo", sorted(GEOMETRY))
def test_tuning_index_equals_oracle(results, bpo):
    r = results[bpo]
    assert r["port"].dtype == np.int32
    np.testing.assert_array_equal(r["port"], r["oracle"], err_msg=str(CASES))


@pytest.mark.parametrize("bpo", sorted(GEOMETRY))
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_tuning_index_equals_jax(spectra, results, bpo, ref):
    """Exactly equal to JAX. Where a near-tie flips against JAX, the port
    must equal the oracle (checked above) and the tie width is reported."""
    r = results[bpo]
    flips = [(CASES[i], _tie_width(spectra[bpo][i], bpo, GEOMETRY[bpo][0]))
             for i in np.flatnonzero(r["port"] != r[ref])]
    assert not flips, f"flips vs {ref} (case, tie width): {flips}"


@pytest.mark.parametrize("bpo", sorted(GEOMETRY))
def test_kernel_wrapper_equals_pallas_on_same_piptrack(results, bpo):
    r = results[bpo]
    np.testing.assert_array_equal(r["wrapper"], r["pallas"])


def test_silence_falls_back_to_index_50(results):
    for bpo in GEOMETRY:
        assert results[bpo]["port"][CASES.index("silence")] == 50


@pytest.mark.parametrize("bpo", sorted(GEOMETRY))
def test_piptrack_band_matches_oracle_bitwise(spectra, results, bpo):
    """The port's piptrack (f32 with a float64-rounded divide) gives the
    oracle's bits. JAX's XLA:CPU build may contract S + 0.5*avg*shift into an
    FMA, so its magnitudes agree to the rounding of that sum (an ulp of the
    clip's largest |S|, two at most); its pitches are bitwise equal."""
    n_fft = GEOMETRY[bpo][0]
    S = spectra[bpo]
    p, m = chroma._piptrack_band(torch.from_numpy(S), SR, n_fft)
    lo, hi = chroma._band_rows(S.shape[1], SR)
    for i, s in enumerate(S):
        op, om = dsp_np.piptrack(s, SR, n_fft)
        np.testing.assert_array_equal(p[i].numpy(), op[lo:hi])
        np.testing.assert_array_equal(m[i].numpy(), om[lo:hi])
    jp, jm = results[bpo]["band"]
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    for i in range(len(S)):
        np.testing.assert_allclose(m[i].numpy(), np.asarray(jm[i]), rtol=0,
                                   atol=2 * np.spacing(S[i].max()))


def test_masked_median_matches_jax():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((4, 999)).astype(np.float32)
    v[1] = np.round(v[1] * 4) / 4  # ties
    mask = rng.random((4, 999)) < np.array([[0.5], [0.3], [0.0], [1.0]])
    got = select.masked_median(torch.from_numpy(v), torch.from_numpy(mask))
    ref = np.array([float(jx_select.masked_median(jnp.asarray(a),
                                                  jnp.asarray(b)))
                    for a, b in zip(v, mask)], np.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hist_edges_match_jax():
    np.testing.assert_array_equal(tuning_kernel.hist_edges_f32(100),
                                  jx_chroma._hist_edges_f32(100))


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tuning_kernel.estimate_tuning_index(torch.zeros(2, 3, 4),
                                            torch.zeros(2, 3, 5), 12)
