"""The PyTorch port's whole feature slice (tpu_breath_torch.features) on the
CPU, against JAX extract_features on the same clips and against the
committed golden npz (the oracle's output).

Bounds, set from measurement on these clips (port vs JAX worst 1.6e-4 on
lpc, scalars 9e-5 rel; port vs golden 3.6e-5): per channel 3e-4 abs vs JAX
(5e-4, twice JAX's 2.3e-4 oracle envelope in PARITY.md, tightened), scalars
5e-4 rel with a 1e-2 floor; vs golden 1e-4 abs and 1e-4 rel (the JAX
package's own golden test allows 2e-3 / 2e-2)."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.baseline import feature_np
from tpu_breath.config import DEFAULT_FEATURES as SPEC
from tpu_breath.features import extract_features as jx_extract
from tpu_breath.ops import cepstral as jx_cepstral, cqt as jx_cqt
from tpu_breath.ops import dft as jx_dft, lpc as jx_lpc
from tpu_breath.ops import rhythm as jx_rhythm, scalars as jx_scalars
from tpu_breath.ops import spectral as jx_spectral
from tpu_breath_torch import features
from tpu_breath_torch.ops import cepstral, cqt, dft, lpc, rhythm, scalars
from tpu_breath_torch.ops import spectral

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


def _synthetic() -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000
    noise = rng.standard_normal(16000) * 0.05
    tone = (0.3 * np.sin(2 * np.pi * 440 * t) * np.exp(-3 * t)
            + 0.01 * rng.standard_normal(16000))
    return np.stack([noise, tone]).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    """2 golden wavs and 2 seeded synthetic clips."""
    golden = np.stack([np.load(p)["wav"] for p in FIXTURES])
    return np.concatenate([golden, _synthetic()])


@pytest.fixture(scope="module")
def jax_out(clips):
    f, s = jax.jit(lambda y: jx_extract(y, SPEC))(jnp.asarray(clips))
    return np.asarray(f), np.asarray(s)


@pytest.fixture(scope="module")
def port_out(clips):
    f, s = features.extract_features(torch.from_numpy(clips))
    return f.numpy(), s.numpy()


def test_shapes_and_dtypes(port_out, clips):
    f, s = port_out
    assert f.shape == (len(clips), 9, 128, 63) and f.dtype == np.float32
    assert s.shape == (len(clips), 36) and s.dtype == np.float32


@pytest.mark.parametrize("channel", SPEC.channel_order)
def test_channel_matches_jax(jax_out, port_out, channel):
    c = SPEC.channel_order.index(channel)
    ref, got = jax_out[0][:, c], port_out[0][:, c]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) <= 3e-4


def test_scalars_match_jax(jax_out, port_out):
    ref, got = jax_out[1], port_out[1]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    assert np.nanmax(rel) <= 5e-4, (np.nanargmax(rel), np.nanmax(rel))


def test_silence_nans_are_faithful():
    """Silence: the scalars that are 0/0 in the oracle (scipy's skew of a
    constant, autocorrelation over a zero lag-0 energy, ...) are NaN in the
    port at the same positions as in JAX and the oracle; the 2-D channels
    stay finite. (Their values are z-scored rounding noise of constant
    rows, so only finiteness is compared.)"""
    y = np.zeros((1, 16000), np.float32)
    f, s = features.extract_features(torch.from_numpy(y))
    _, s_j = jax.jit(lambda v: jx_extract(v, SPEC))(jnp.asarray(y))
    s_o = feature_np.process_clip(y[0], SPEC)["scalars"]
    assert np.isfinite(f.numpy()).all()
    np.testing.assert_array_equal(np.isnan(s.numpy()[0]),
                                  np.isnan(np.asarray(s_j)[0]))
    np.testing.assert_array_equal(np.isnan(s.numpy()[0]), np.isnan(s_o))


def test_matches_golden(port_out):
    f, s = port_out
    for i, path in enumerate(FIXTURES):
        d = np.load(path)
        stack = np.stack([d[k] for k in SPEC.channel_order])
        assert np.abs(f[i] - stack).max() < 1e-4, path
        rel = np.abs(s[i] - d["scalars"]) / np.maximum(
            np.abs(d["scalars"]), 1e-2)
        assert rel.max() < 1e-4, path


def test_batched_chunks_equal_one_call(clips, port_out):
    f, s = features.extract_features_batched(clips[:3], chunk=2)
    np.testing.assert_array_equal(f, port_out[0][:3])
    np.testing.assert_array_equal(s, port_out[1][:3])


# module-level parity on the synthetic clips


@pytest.fixture(scope="module")
def y2():
    return _synthetic()


def _cmp(got: torch.Tensor, ref, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


def test_mel_db_and_deltas(y2):
    yj = jnp.asarray(y2)
    mel_j = jx_spectral.power_to_db(jx_spectral.melspectrogram(
        yj, 16000, 512, 256, 128, fmax=4500.0), ref_max=True)
    mel_t = spectral.power_to_db(spectral.melspectrogram(
        torch.from_numpy(y2), 16000, 512, 256, 128, fmax=4500.0),
        ref_max=True)
    _cmp(mel_t, mel_j, atol=1e-3)
    _cmp(cepstral.delta(mel_t, order=2), jx_cepstral.delta(mel_j, order=2),
         atol=1e-3)
    _cmp(cepstral.mod_spec(mel_t), jx_cepstral.mod_spec(mel_j), atol=2e-2)


def test_mfcc(y2):
    ref = jx_cepstral.mfcc(jnp.asarray(y2), 16000, 40, 256, 512)
    _cmp(cepstral.mfcc(torch.from_numpy(y2), 16000, 40, 256, 512), ref,
         atol=5e-3)


def test_lpc_features(y2):
    ref = jax.jit(lambda y: jx_lpc.lpc_features(y, 12))(jnp.asarray(y2))
    _cmp(lpc.lpc_features(torch.from_numpy(y2), 12), ref, atol=5e-4)


def test_onset_and_tempogram(y2):
    yj = jnp.asarray(y2)
    oj = jx_rhythm.onset_strength(yj, 16000, 256)
    ot = rhythm.onset_strength(torch.from_numpy(y2), 16000, 256)
    _cmp(ot, oj, atol=1e-4)
    _cmp(rhythm.tempogram(ot), jx_rhythm.tempogram(oj), atol=1e-4)


def test_cqt_multirate_and_cens(y2):
    yj = jnp.asarray(y2)
    idx = np.array([37, 62], np.int32)
    ref = jax.jit(lambda y, i: jx_cqt.cqt_mag_multirate(
        y, i, 16000, 256, SPEC.cqt_fmin, 36, 7))(yj, jnp.asarray(idx))
    got = cqt.cqt_mag_multirate(torch.from_numpy(y2), torch.from_numpy(idx),
                                16000, 256, SPEC.cqt_fmin, 36, 7)
    _cmp(got.float(), ref, atol=1e-5, rtol=1e-4)
    ref_cens = jax.jit(lambda y: jx_cqt.chroma_cens(
        y, 16000, 256, SPEC.cqt_fmin))(yj)
    _cmp(cqt.chroma_cens(torch.from_numpy(y2), 16000, 256, SPEC.cqt_fmin),
         ref_cens, atol=1e-4)


def test_hilbert_and_autocorr(y2):
    yj = jnp.asarray(y2)
    _cmp(dft.hilbert_envelope(torch.from_numpy(y2)),
         jax.jit(jx_dft.hilbert_envelope)(yj), atol=1e-5)
    ac_j = np.asarray(jax.jit(jx_dft.autocorr_full)(yj))
    ac_t = dft.autocorr_full(torch.from_numpy(y2)).numpy()
    # relative to the lag-0 energy, the scale scalars 33-35 divide by
    np.testing.assert_allclose(ac_t / ac_j[:, :1], ac_j / ac_j[:, :1],
                               atol=1e-6, rtol=0)


def test_extract_scalars_standalone(y2):
    """extract_scalars computing its own spectrograms (no sharing) agrees
    with the JAX function called the same way."""
    ref = jax.jit(jx_scalars.extract_scalars)(jnp.asarray(y2))
    got = scalars.extract_scalars(torch.from_numpy(y2))
    rel = np.abs(got.numpy() - np.asarray(ref)) / np.maximum(
        np.abs(np.asarray(ref)), 1e-2)
    assert rel.max() <= 5e-4, (rel.argmax(), rel.max())
