"""The port's NumPy oracle (tpu_breath_torch.baseline) against the JAX
package's (tpu_breath.baseline), which it copies: every public function of
dsp_np on seeded inputs and process_clip on the golden wavs and the edge
clips return the same arrays bit for bit (NaNs in the same places), and
the port's process_clip matches the committed golden fixtures at 1e-6, as
tests/test_golden_fixtures.py holds the JAX package's."""
import glob
import inspect
import os

import numpy as np
import pytest

from tpu_breath.baseline import dsp_np as jx_dsp
from tpu_breath.baseline import feature_np as jx_feature
from tpu_breath.config import FeatureSpec as JxSpec
from tpu_breath_torch.baseline import dsp_np, feature_np
from tpu_breath_torch.config import FeatureSpec
from tpu_breath_torch.utils.kernel_times import clip_set

SR = 16000
FMIN = 32.703195662574764
FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


def _y(seed: int = 0, n: int = SR) -> np.ndarray:
    """A golden wav's samples plus seeded noise: f32 [n]."""
    rng = np.random.default_rng(seed)
    gold = np.load(FIXTURES[seed % len(FIXTURES)])["wav"][:n]
    return (gold + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _S(n_fft: int = 512, hop: int = 256) -> np.ndarray:
    return np.abs(jx_dsp.stft(_y().astype(np.float64), n_fft, hop))


def _freqs(n: int = 36, fmin: float = 262.0, bpo: int = 36) -> np.ndarray:
    return fmin * 2.0 ** (np.arange(n) / bpo)


# public function of dsp_np -> (args, kwargs) on seeded inputs; the CQT
# family at fewer bins and octaves than the feature graph, so the direct
# CQT stays cheap on the CPU
CASES = {
    "hann": lambda: ((512,), {"periodic": False}),
    "frame": lambda: ((_y(), 512, 256), {}),
    "stft": lambda: ((_y(), 512, 256), {}),
    "fft_frequencies": lambda: ((SR, 2048), {}),
    "hz_to_mel": lambda: ((np.linspace(0, 8000, 257),), {}),
    "mel_to_hz": lambda: ((np.linspace(0, 60, 129),), {}),
    "mel_frequencies": lambda: ((130, 0.0, 4500.0), {}),
    "mel_filterbank": lambda: ((SR, 512, 128), {"fmax": 4500.0}),
    "power_to_db": lambda: ((_S() ** 2,), {"ref": np.max}),
    "melspectrogram": lambda: ((_y(), SR), {"n_fft": 512, "hop_length": 256,
                                            "fmax": 4500.0}),
    "delta": lambda: ((np.log1p(_S()),), {"order": 2}),
    "mfcc": lambda: ((_y(), SR), {"n_mfcc": 40, "hop_length": 256,
                                  "n_fft": 512}),
    "normalize": lambda: ((_S(),), {"norm": 1}),
    "localmax": lambda: ((_S(),), {}),
    "piptrack": lambda: ((_S(), SR, 512), {}),
    "hz_to_octs": lambda: ((_freqs(),), {"tuning": 0.1}),
    "pitch_tuning": lambda: ((_freqs() * 1.003,), {"bins_per_octave": 36}),
    "estimate_tuning_from_S": lambda: ((_S(), SR, 512, 12), {}),
    "chroma_filterbank": lambda: ((SR, 512), {"tuning": -0.07}),
    "chroma_stft": lambda: ((_S(), SR), {}),
    "estimate_tuning_from_y": lambda: ((_y(1), SR), {}),
    "cqt_kernel_bank": lambda: ((SR, 262.0, 36, 36), {}),
    "cqt": lambda: ((_y(), SR, 256, 262.0, 72, 36), {}),
    "wavelet_lengths": lambda: ((_freqs(), SR), {}),
    "wavelet_basis": lambda: ((_freqs(), SR, 36), {}),
    "sparsify_rows": lambda: ((jx_dsp.wavelet_basis(_freqs(), SR, 36)[0],),
                              {}),
    "resample_half": lambda: ((_y().astype(np.float64),), {"res_type": "sinc"}),
    "vqt_multirate": lambda: ((_y(), SR, 256, FMIN, 252, 36),
                              {"tuning": 0.13}),
    "chroma_cens_librosa": lambda: ((_y(1), SR, 256), {}),
    "cq_to_chroma": lambda: ((252, 36, 12, FMIN), {}),
    "chroma_cens": lambda: ((_y(), SR, 256), {"fmin": 262.0,
                                              "n_octaves": 2}),
    "onset_strength": lambda: ((_y(), SR, 256), {}),
    "autocorrelate": lambda: ((np.random.default_rng(2).standard_normal(
        (63, 3)),), {"axis": 0}),
    "tempogram": lambda: ((jx_dsp.onset_strength(_y(), SR, 256),),
                          {"win_length": 384}),
    "lpc": lambda: ((_y()[:512].astype(np.float64), 12), {}),
    "lpc_features": lambda: ((_y(), 12, SR), {}),
    "rms": lambda: ((_y(),), {"hop_length": 256}),
    "zero_crossing_rate": lambda: ((_y(),), {"hop_length": 256}),
    "spectral_centroid": lambda: ((_S(2048), SR, 2048), {}),
    "spectral_bandwidth": lambda: ((_S(2048), SR, 2048), {}),
    "spectral_rolloff": lambda: ((_S(2048, 512), SR, 2048), {}),
    "spectral_flatness": lambda: ((_S(2048),), {}),
    "spectral_contrast": lambda: ((_S(2048), SR, 2048), {}),
    "hilbert_envelope": lambda: ((_y(),), {}),
    "full_autocorr_normalized": lambda: ((_y(),), {}),
}


def _public(module) -> set[str]:
    return {name for name, f in inspect.getmembers(module, inspect.isfunction)
            if not name.startswith("_") and f.__module__ == module.__name__}


def assert_bit_equal(a, b, where: str = "") -> None:
    """Equal types, shapes, dtypes and values, NaNs in the same places."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def test_every_public_function_is_copied_and_covered():
    """The port's dsp_np has every public function of the JAX package's
    (and no other), and CASES covers each."""
    assert _public(dsp_np) == _public(jx_dsp)
    assert set(CASES) == _public(jx_dsp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dsp_np_function_is_bit_equal_to_the_jax_package(name):
    args, kwargs = CASES[name]()
    want = getattr(jx_dsp, name)(*args, **kwargs)
    got = getattr(dsp_np, name)(*args, **kwargs)
    assert_bit_equal(got, want, name)


def _edge_clips() -> dict:
    """The golden wavs, silence, an impulse and the quantized clip."""
    clips = clip_set(5, seed=0)
    return dict(zip(("golden0", "golden1", "silence", "impulse",
                     "quantized"), clips))


@pytest.mark.parametrize("name", ["golden0", "golden1", "silence",
                                  "impulse", "quantized"])
def test_process_clip_is_bit_equal_to_the_jax_package(name):
    y = _edge_clips()[name]
    want = jx_feature.process_clip(y, JxSpec())
    got = feature_np.process_clip(y, FeatureSpec())
    assert list(got) == list(want)
    for key in want:
        assert_bit_equal(got[key], want[key], f"{name}:{key}")
    if name == "silence":  # the 0/0 scalars of a constant clip
        assert np.isnan(got["scalars"]).any()


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_process_clip_matches_the_golden_fixtures(path):
    d = np.load(path)
    out = feature_np.process_clip(d["wav"], FeatureSpec())
    for k in FeatureSpec().channel_order:
        np.testing.assert_allclose(out[k], d[k], atol=1e-6,
                                   err_msg=f"{path}:{k}")
    np.testing.assert_allclose(out["scalars"], d["scalars"], atol=1e-6)
