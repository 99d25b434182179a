"""Kernel B (gammatone-channel epilogue) of the PyTorch port, plain
version, against the JAX package's double-float path (dd.matmul_dd +
dd.log1p_cr + znorm, features.py:137-141) and the Pallas kernel in interpret
mode, on the same [B, 257, 63] magnitudes, at the Pallas test's atol 1e-5."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.baseline import dsp_np
from tpu_breath.config import DEFAULT_FEATURES as SPEC
from tpu_breath.ops import dd, spectral as jx_spectral
from tpu_breath.ops.pallas import epilogue_kernel as jx_epilogue
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import epilogue_kernel

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


@pytest.fixture(scope="module")
def mags():
    """f32(|STFT_512|) of the golden clips, seeded noise (loud and quiet)
    and an impulse: [5, 257, 63]."""
    rng = np.random.default_rng(3)
    clips = [np.load(p)["wav"] for p in FIXTURES]
    clips += [rng.standard_normal(16000) * a for a in (0.1, 1e-3)]
    imp = np.zeros(16000)
    imp[4000] = 1.0
    clips.append(imp)
    return np.stack([np.abs(dsp_np.stft(np.asarray(c, np.float64),
                                        SPEC.n_fft, SPEC.hop_length))
                     for c in clips]).astype(np.float32)


@pytest.fixture(scope="module")
def fb():
    return jx_spectral.mel_matrix(SPEC.sr, SPEC.n_fft, SPEC.n_gammatone)


def test_plain_matches_jax_dd_path(mags, fb):
    """Golden and noise clips. (On the impulse, whose product spans many
    decades, the JAX dd path is 4.7e-5 off the float64 oracle while the port
    stays within 2e-6 of it — test_plain_matches_float64_oracle.)"""
    mags = mags[:4]
    fbj = jnp.asarray(fb)

    @jax.jit
    def xla_path(m):
        gt = dd.log1p_cr(dd.matmul_dd(m.swapaxes(-1, -2), fbj.T
                                      ).swapaxes(-1, -2))
        return jx_spectral.znorm(gt, axes=(-2, -1))

    ref = np.asarray(xla_path(jnp.asarray(mags)))
    got = epilogue_kernel.fused_epilogue(torch.from_numpy(mags),
                                         torch.from_numpy(fb)).numpy()
    assert got.shape == (mags.shape[0], SPEC.n_gammatone, mags.shape[-1])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret(mags, fb):
    ref = np.asarray(jx_epilogue.fused_epilogue(jnp.asarray(mags[:2]),
                                                jnp.asarray(fb)))
    got = epilogue_kernel.fused_epilogue(torch.from_numpy(mags[:2]),
                                         torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_plain_matches_float64_oracle(mags, fb):
    """The channel recipe in float64 (feature_np: log1p(fb @ |S|), then
    z-score), rounded once: the port keeps to ~1 ulp of the z-scored value."""
    gt = np.log1p(fb.astype(np.float64) @ mags.astype(np.float64))
    mean = gt.mean(axis=(-2, -1), keepdims=True)
    ref = (gt - mean) / (gt.std(axis=(-2, -1), keepdims=True) + 1e-8)
    got = epilogue_kernel.fused_epilogue(torch.from_numpy(mags),
                                         torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_device_const_mel_matches_jax_constant():
    got = spectral.device_const(spectral.mel_matrix, SPEC.sr, SPEC.n_fft,
                                SPEC.n_gammatone, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, jx_spectral.mel_matrix(SPEC.sr, SPEC.n_fft, SPEC.n_gammatone))


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        epilogue_kernel.fused_epilogue(torch.zeros(1, 257, 63),
                                       torch.zeros(64, 256))
