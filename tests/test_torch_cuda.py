"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider
"""
import glob
import os

import numpy as np
import pytest
import torch

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def clips():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(9)
    golden = [np.load(p)["wav"] for p in FIXTURES]
    noise = [rng.standard_normal(16000) * a for a in (0.3, 0.01, 1e-3)]
    imp = np.zeros(16000)
    imp[123] = 1.0
    silence = np.zeros(16000)
    plateau = np.round(rng.standard_normal(16000) * 4) / 64
    y = np.stack(golden + noise + [imp, silence, plateau]).astype(np.float32)
    return torch.from_numpy(y).cuda()


def test_tuning_kernel_exact(clips):
    from tpu_breath_torch.ops import chroma, spectral
    from tpu_breath_torch.ops.cuda import tuning_kernel as tk

    for n_fft, bpo, step in ((512, 12, 1), (2048, 36, 2)):
        S = spectral.stft_mag_cr(clips, n_fft, 256)[..., ::step]
        p, m = (t.contiguous() for t in chroma._piptrack_band(S, 16000,
                                                              n_fft))
        got = tk.estimate_tuning_index(p, m, bpo)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.estimate_tuning_index_plain(p, m, bpo))
        assert torch.equal(got.cpu(), tk.estimate_tuning_index(
            p.cpu(), m.cpu(), bpo))


def test_epilogue_kernel_within_1e5(clips):
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    mag = spectral.stft_mag_cr(clips, 512, 256).contiguous()
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    got = ek.fused_epilogue(mag, fb)
    torch.cuda.synchronize()
    ref = ek.fused_epilogue_plain(mag, fb)
    assert float((got - ref).abs().max()) <= 1e-5


def test_peaks_kernel_exact(clips):
    from tpu_breath_torch.ops import dft, peaks
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    env = dft.hilbert_envelope(clips)
    scores = torch.where(peaks.local_maxima(env)
                         & (env >= env.mean(-1, keepdim=True)), env,
                         -torch.inf).contiguous()
    vals, kept = pk.suppress_peaks(scores, 1600, 12)
    torch.cuda.synchronize()
    rvals, rkept = pk.suppress_peaks_plain(scores, 1600, 12)
    assert torch.equal(kept, rkept)
    assert float((vals - rvals).abs().max()) <= 1e-5


def test_features_gpu_match_cpu(clips):
    from tpu_breath_torch.features import extract_features

    f, s = extract_features(clips[:5])
    fc, sc = extract_features(clips[:5].cpu())
    assert torch.equal(torch.isnan(f.cpu()), torch.isnan(fc))
    assert float((f.cpu() - fc).abs().nan_to_num().max()) < 1e-4
    rel = (s.cpu() - sc).abs() / sc.abs().clamp(min=1e-2)
    assert float(rel.max()) < 1e-3


def test_wrappers_reject_wrong_dtype(clips):
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    with pytest.raises(TypeError):
        pk.suppress_peaks(clips.double(), 1600, 12)
