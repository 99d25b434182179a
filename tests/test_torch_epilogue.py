"""Kernels B, B' and B'' (the gammatone channel) of the PyTorch port, plain
versions, against the JAX package on the same inputs:
- B against the double-float path (dd.matmul_dd + dd.log1p_cr + znorm,
  features.py:137-141) and the Pallas kernel in interpret mode, atol 1e-5;
- B' (plain=True) against the Pallas kernel's plain variant, atol 5e-5;
- B'' against Pallas fused_gammatone in interpret mode, atol 1e-5;
- extract_features(fused_gt=True) against JAX extract_features(
  pallas_gt=True): gammatone 3e-4, the other channels and the scalars as
  the default path gives them.
The tolerances are the JAX package's own (tests/test_pallas_epilogue.py)."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.baseline import dsp_np
from tpu_breath.config import DEFAULT_FEATURES as SPEC
from tpu_breath.features import extract_features as jx_extract
from tpu_breath.ops import dd, spectral as jx_spectral
from tpu_breath.ops.pallas import epilogue_kernel as jx_epilogue
from tpu_breath_torch import features
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import epilogue_kernel, gammatone_kernel

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


@pytest.fixture(scope="module")
def clips():
    """The golden clips, seeded noise (loud and quiet) and an impulse:
    [5, 16000] f32."""
    rng = np.random.default_rng(3)
    clips = [np.load(p)["wav"] for p in FIXTURES]
    clips += [rng.standard_normal(16000) * a for a in (0.1, 1e-3)]
    imp = np.zeros(16000)
    imp[4000] = 1.0
    clips.append(imp)
    return np.stack(clips).astype(np.float32)


@pytest.fixture(scope="module")
def mags(clips):
    """f32(|STFT_512|) of the clips: [5, 257, 63]."""
    return np.stack([np.abs(dsp_np.stft(np.asarray(c, np.float64),
                                        SPEC.n_fft, SPEC.hop_length))
                     for c in clips]).astype(np.float32)


@pytest.fixture(scope="module")
def frames(clips):
    """The clips center-padded and framed as the feature graph frames them
    for kernel B'': [5, 63, 512] raw signal values."""
    yp = np.pad(clips, ((0, 0), (SPEC.n_fft // 2, SPEC.n_fft // 2)))
    return spectral.frame_signal(torch.from_numpy(yp), SPEC.n_fft,
                                 SPEC.hop_length, 63).contiguous().numpy()


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


def test_f32_variant_matches_pallas_plain(mags, fb):
    """B' (plain=True): the f32 product and log1p, against the Pallas
    kernel's plain variant in interpret mode, at its test's 5e-5. Golden and
    noise clips (measured 6.7e-6); the impulse, whose product spans many
    decades, comes to 4.7e-5 and is left to the float64 variants."""
    ref = np.asarray(jx_epilogue.fused_epilogue(jnp.asarray(mags[:4]),
                                                jnp.asarray(fb), plain=True))
    got = epilogue_kernel.fused_epilogue(torch.from_numpy(mags[:4]),
                                         torch.from_numpy(fb),
                                         plain=True).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


def test_framedft_basis_matches_jax_constant():
    np.testing.assert_array_equal(spectral.framedft_basis(SPEC.n_fft),
                                  jx_spectral._framedft_consts(SPEC.n_fft,
                                                               "hann"))


def test_gammatone_plain_matches_pallas_interpret(frames, fb):
    """B'' against Pallas fused_gammatone in interpret mode (2 s a clip
    here), at its test's 1e-5, on the golden and noise clips (measured
    4.8e-6). On the impulse the JAX double-float chain is 4.5e-5 off while
    the port stays within 2e-6 of the float64 oracle (next test)."""
    ref = np.asarray(jx_epilogue.fused_gammatone(
        jnp.asarray(frames[:4]),
        jnp.asarray(jx_spectral._framedft_consts(SPEC.n_fft, "hann")),
        jnp.asarray(fb)))
    got = gammatone_kernel.fused_gammatone(
        torch.from_numpy(frames[:4]),
        torch.from_numpy(spectral.framedft_basis(SPEC.n_fft)),
        torch.from_numpy(fb)).numpy()
    assert got.shape == (4, SPEC.n_gammatone, 63)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_gammatone_plain_matches_float64_oracle(clips, mags, frames, fb):
    """The recipe in float64 from f32(|STFT_f64|), rounded once: B'' keeps
    to 2e-6 of it on every clip, the impulse included (measured 1.3e-6)."""
    gt = np.log1p(fb.astype(np.float64) @ mags.astype(np.float64))
    mean = gt.mean(axis=(-2, -1), keepdims=True)
    ref = (gt - mean) / (gt.std(axis=(-2, -1), keepdims=True) + 1e-8)
    got = gammatone_kernel.fused_gammatone(
        torch.from_numpy(frames),
        torch.from_numpy(spectral.framedft_basis(SPEC.n_fft)),
        torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_fused_gt_features_match_jax_pallas_gt(clips):
    """extract_features(fused_gt=True) against JAX extract_features(
    pallas_gt=True) (interpret mode) on the golden and noise clips: the
    gammatone channel within 3e-4 (the feature tests' bound); the port's
    other channels and scalars are exactly its default path's."""
    y = clips[:4]
    f_j, _ = jax.jit(lambda x: jx_extract(x, SPEC, True))(jnp.asarray(y))
    f_t, s_t = features.extract_features(torch.from_numpy(y), fused_gt=True)
    f_d, s_d = features.extract_features(torch.from_numpy(y), fused_gt=False)
    gi = SPEC.channel_order.index("gammatone")
    np.testing.assert_allclose(f_t[:, gi].numpy(), np.asarray(f_j)[:, gi],
                               atol=3e-4, rtol=0)
    others = [c for c in range(SPEC.n_channels) if c != gi]
    assert torch.equal(f_t[:, others].nan_to_num(), f_d[:, others].nan_to_num())
    assert torch.equal(s_t.nan_to_num(), s_d.nan_to_num())


def test_fused_gt_from_env(monkeypatch, clips):
    """extract_features with fused_gt unset reads TPU_BREATH_PALLAS_GT at
    each call and takes B'' only when it is 1; an explicit fused_gt wins."""
    calls = []
    real = gammatone_kernel.fused_gammatone

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(gammatone_kernel, "fused_gammatone", counting)
    y = torch.from_numpy(clips[:1])
    for env, fused_gt, want in (("1", None, 1), ("0", None, 0),
                                ("1", False, 0), ("0", True, 1)):
        monkeypatch.setenv("TPU_BREATH_PALLAS_GT", env)
        calls.clear()
        features.extract_features(y, fused_gt=fused_gt)
        assert len(calls) == want, (env, fused_gt)


def test_tiled_basis_undoes_to_framedft_basis():
    """Kernel B''s basis relayout: entry [r, s, w, ri, i, lane] is basis[8 s
    + 4 i + lane % 4, ri F + 88 r + 8 w + lane // 4], zero past F, and
    undoing it gives back framedft_basis(512) exactly."""
    basis = spectral.framedft_basis(SPEC.n_fft)
    k, f = basis.shape[0], basis.shape[1] // 2
    tiles = gammatone_kernel.tiled_basis(SPEC.n_fft)
    assert tiles.shape == (3, k // 8, 11, 2, 2, 32)
    assert tiles.dtype == np.float32
    r, s, w, ri, i, lane = np.indices(tiles.shape)
    kk, ff = 8 * s + 4 * i + lane % 4, 88 * r + 8 * w + lane // 4
    real = ff < f
    assert not tiles[~real].any()
    back = np.full_like(basis, np.nan)
    back[kk[real], (ri * f + ff)[real]] = tiles[real]
    np.testing.assert_array_equal(back, basis)


def test_gammatone_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        gammatone_kernel.fused_gammatone(torch.zeros(1, 63, 512),
                                         torch.zeros(512, 513),
                                         torch.zeros(64, 256))
