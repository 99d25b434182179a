"""NumPy builders of the constants the port's feature graph uses (the
port's own copy of those functions of tpu_breath/baseline/dsp_np.py, which
re-derives librosa 0.10): the Hann window, the Slaney mel filterbank, the
VQT filters' FFT basis, the CQT-to-chroma map and the direct CQT's kernel
bank."""
from __future__ import annotations

import numpy as np

def hann(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; periodic matches scipy.signal.get_window('hann', n, fftbins=True)."""
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(np.float64)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2, 1 + n_fft // 2, endpoint=True)


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-20) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(sr: float, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """librosa.filters.mel: triangular filters on the (Slaney) mel scale with
    slaney area normalization. Shape [n_mels, 1 + n_fft//2]."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


WINDOW_BANDWIDTH_HANN = 1.50018310546875  # librosa.filters.WINDOW_BANDWIDTHS


def _cqt_alpha(bins_per_octave: int) -> float:
    """librosa.filters._relative_bandwidth for geometric bin spacing."""
    r2 = 2.0 ** (2.0 / bins_per_octave)
    return (r2 - 1) / (r2 + 1)


def wavelet_lengths(freqs: np.ndarray, sr: float, filter_scale: float = 1.0,
                    bins_per_octave: int = 36):
    """librosa.filters.wavelet_lengths (gamma=0): (lengths, f_cutoff)."""
    alpha = _cqt_alpha(bins_per_octave)
    Q = filter_scale / alpha
    lengths = Q * sr / freqs
    f_cutoff = np.max(freqs * (1 + 0.5 * WINDOW_BANDWIDTH_HANN / Q))
    return lengths, f_cutoff


def wavelet_basis(freqs: np.ndarray, sr: float, bins_per_octave: int,
                  filter_scale: float = 1.0, pad_fft: bool = True):
    """librosa.filters.wavelet: l1-normalized hann-windowed complex
    exponentials, centered in a pow2-padded (pad_fft) array.
    Returns (basis [n, pad_to] complex128, lengths [n])."""
    lengths, _ = wavelet_lengths(freqs, sr, filter_scale, bins_per_octave)
    max_len = lengths.max()
    pad_to = (int(2.0 ** np.ceil(np.log2(max_len))) if pad_fft
              else int(np.ceil(max_len)))
    basis = np.zeros((len(freqs), pad_to), dtype=np.complex128)
    for i, (ilen, freq) in enumerate(zip(lengths, freqs)):
        t = np.arange(-ilen // 2, ilen // 2, dtype=np.float64)
        sig = np.exp(1j * 2 * np.pi * freq * t / sr)
        sig = sig * hann(len(sig), periodic=True)
        sig = sig / np.sum(np.abs(sig))
        start = (pad_to - len(sig)) // 2
        basis[i, start:start + len(sig)] = sig
    return basis, lengths


def sparsify_rows(x: np.ndarray, quantile: float = 0.01) -> np.ndarray:
    """librosa.util.sparsify_rows (dense equivalent): per row, zero the
    smallest-magnitude entries whose cumulative l1 mass is below quantile."""
    mags = np.abs(x)
    norms = np.sum(mags, axis=1, keepdims=True)
    mag_sort = np.sort(mags, axis=1)
    cumulative = np.cumsum(mag_sort / norms, axis=1)
    out = np.zeros_like(x)
    for i in range(x.shape[0]):
        j = int(np.argmin(cumulative[i] < quantile))
        keep = mags[i] >= mag_sort[i, j]
        out[i, keep] = x[i, keep]
    return out


def _vqt_filter_fft(sr: float, freqs_oct: np.ndarray, bins_per_octave: int,
                    filter_scale: float = 1.0, sparsity: float = 0.01):
    """librosa __vqt_filter_fft: pow2-padded wavelet basis, scaled by
    length/n_fft, FFT'd, positive-frequency half, row-sparsified."""
    basis, lengths = wavelet_basis(freqs_oct, sr, bins_per_octave,
                                   filter_scale)
    n_fft = basis.shape[1]
    basis = basis * (lengths[:, None] / float(n_fft))
    fft_basis = np.fft.fft(basis, n=n_fft, axis=1)[:, : n_fft // 2 + 1]
    if sparsity is not None and sparsity > 0:
        fft_basis = sparsify_rows(fft_basis, quantile=sparsity)
    return fft_basis, n_fft


def cq_to_chroma(n_input: int, bins_per_octave: int, n_chroma: int,
                 fmin: float, base_c: bool = True) -> np.ndarray:
    """librosa.filters.cq_to_chroma (window=None path)."""
    n_merge = bins_per_octave // n_chroma
    ctc = np.repeat(np.eye(n_chroma), n_merge, axis=1)
    n_octaves = int(np.ceil(n_input / bins_per_octave))
    ctc = np.tile(ctc, n_octaves)[:, :n_input]
    midi_0 = np.mod(12 * np.log2(fmin / 440.0) + 69, 12)
    roll = midi_0 if base_c else midi_0 - 9
    roll = -int(np.round(roll * (n_chroma / 12.0)))
    return np.roll(ctc, roll, axis=0)


def cqt_kernel_bank(sr: float, fmin: float, n_bins: int, bins_per_octave: int,
                    filter_scale: float = 1.0):
    """Hann-windowed complex-exponential wavelet bank (librosa.filters.wavelet
    semantics: l1-normalized, centered). Returns (kernels [n_bins, max_len]
    complex128, lengths [n_bins])."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    Q = filter_scale / _cqt_alpha(bins_per_octave)
    lengths = Q * sr / freqs
    max_len = int(np.ceil(lengths.max()))
    kernels = np.zeros((n_bins, max_len), dtype=np.complex128)
    for k in range(n_bins):
        ilen = lengths[k]
        t = np.arange(-ilen // 2, ilen // 2, dtype=np.float64)
        sig = np.exp(1j * 2 * np.pi * freqs[k] * t / sr)
        sig = sig * hann(len(sig), periodic=True)
        sig = sig / np.sum(np.abs(sig))
        start = (max_len - len(sig)) // 2
        kernels[k, start:start + len(sig)] = sig
    return kernels, lengths
