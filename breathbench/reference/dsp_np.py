"""The benchmark's frozen copy of the port's NumPy/SciPy DSP oracle
(tpu_breath_torch/baseline/dsp_np.py as of the benchmark's first version):
the librosa-0.10 algorithms of the reference pipeline (reference
src/precompute/process.py:25-108, src/precompute/methods.py:24-143)
re-derived in NumPy, and SciPy where librosa delegates to it. The
benchmark's correctness check computes its features with it
(features_np.process_clip); it imports nothing of the port, so a change to
the port cannot move the yardstick.

One deliberate deviation, documented in cqt(): librosa computes the CQT with a
recursive multirate algorithm (sub-sampling each octave with soxr); cqt()
computes the textbook *direct* CQT (hann-windowed complex exponential kernels
correlated with the signal at full rate), which the recursive algorithm
approximates (vqt_multirate() is the recursive one).
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.stats
from scipy.fftpack import dct as scipy_dct
from scipy.signal import find_peaks

# ---------------------------------------------------------------------------
# Windows and framing
# ---------------------------------------------------------------------------

def hann(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; periodic matches scipy.signal.get_window('hann', n, fftbins=True)."""
    denom = n if periodic else n - 1
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / denom)).astype(np.float64)


def frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame along the last axis -> [..., frame_length, n_frames]."""
    n = x.shape[-1]
    n_frames = 1 + (n - frame_length) // hop_length
    idx = (np.arange(frame_length)[:, None]
           + hop_length * np.arange(n_frames)[None, :])
    return x[..., idx]


# ---------------------------------------------------------------------------
# STFT and spectrogram helpers
# ---------------------------------------------------------------------------

def stft(y: np.ndarray, n_fft: int, hop_length: int, window: str = "hann",
         center: bool = True) -> np.ndarray:
    """librosa.stft semantics: center=True zero-pads n_fft//2 (pad_mode
    'constant' is the librosa>=0.10 default), periodic Hann, rfft.
    Returns complex [1 + n_fft//2, n_frames]."""
    if window == "hann":
        win = hann(n_fft, periodic=True)
    elif window == "ones":
        win = np.ones(n_fft)
    else:
        raise ValueError(window)
    if center:
        y = np.pad(y, n_fft // 2, mode="constant")
    frames = frame(y.astype(np.float64), n_fft, hop_length)
    return np.fft.rfft(frames * win[:, None], axis=0)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2, 1 + n_fft // 2, endpoint=True)


# ---------------------------------------------------------------------------
# Mel scale and filterbank (Slaney variant; librosa defaults)
# ---------------------------------------------------------------------------

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


def power_to_db(S: np.ndarray, ref=1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> np.ndarray:
    """librosa.power_to_db. ref may be a scalar or np.max (applied to S)."""
    S = np.asanyarray(S)
    if callable(ref):
        ref_value = ref(S)
    else:
        ref_value = np.abs(ref)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def melspectrogram(y: np.ndarray, sr: float, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None,
                   power: float = 2.0) -> np.ndarray:
    S = np.abs(stft(y, n_fft, hop_length)) ** power
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    return fb @ S


def delta(data: np.ndarray, width: int = 9, order: int = 1, axis: int = -1) -> np.ndarray:
    """librosa.feature.delta == scipy savgol_filter(width, polyorder=order,
    deriv=order, mode='interp') (librosa 0.10 source)."""
    return scipy.signal.savgol_filter(data, width, polyorder=order,
                                      deriv=order, axis=axis, mode="interp")


def mfcc(y: np.ndarray, sr: float, n_mfcc: int = 20, hop_length: int = 512,
         n_fft: int = 2048) -> np.ndarray:
    """librosa.feature.mfcc: dB mel spectrogram (ref=1.0, top_db=80), DCT-II ortho."""
    S = power_to_db(melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                                   n_mels=128, fmax=None, power=2.0))
    return scipy_dct(S, axis=-2, type=2, norm="ortho")[..., :n_mfcc, :]


def normalize(S: np.ndarray, norm: float = np.inf, axis: int = 0) -> np.ndarray:
    """librosa.util.normalize with fill=None: columns below tiny threshold are
    left unnormalized."""
    if norm == np.inf:
        length = np.max(np.abs(S), axis=axis, keepdims=True)
    elif norm == 1:
        length = np.sum(np.abs(S), axis=axis, keepdims=True)
    elif norm == 2:
        length = np.sqrt(np.sum(np.abs(S) ** 2, axis=axis, keepdims=True))
    else:
        raise ValueError(norm)
    threshold = np.finfo(np.float64).tiny
    length = np.where(length < threshold, 1.0, length)
    return S / length


# ---------------------------------------------------------------------------
# Pitch tracking / tuning estimation (for chroma_stft)
# ---------------------------------------------------------------------------

def localmax(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """librosa.util.localmax: strictly greater than predecessor, >= successor,
    edges via edge padding."""
    paddings = [(0, 0)] * x.ndim
    paddings[axis] = (1, 1)
    x_pad = np.pad(x, paddings, mode="edge")
    inds1 = [slice(None)] * x.ndim
    inds1[axis] = slice(0, -2)
    inds2 = [slice(None)] * x.ndim
    inds2[axis] = slice(2, None)
    return (x > x_pad[tuple(inds1)]) & (x >= x_pad[tuple(inds2)])


def piptrack(S: np.ndarray, sr: float, n_fft: int, fmin: float = 150.0,
             fmax: float = 4000.0, threshold: float = 0.1):
    """librosa.piptrack on a precomputed magnitude spectrogram S [freq, T].

    Computed in float32 like real librosa (librosa.load yields float32 and
    the whole stft/piptrack chain inherits it), with the parabolic-shift
    division done in float64 and rounded once to f32 — i.e. the correctly-
    rounded f32 result. The feature graph (ops/chroma.py::_piptrack_band)
    computes the same correctly-rounded values, so the two sides agree
    bit-for-bit given equal S; plain f32 arithmetic differs by ~1 ulp between
    backends, which flips the near-tied tuning histogram argmax downstream
    (PARITY.md)."""
    S = np.asarray(S, np.float32)
    fmax = min(fmax, sr / 2.0)
    fft_freqs = fft_frequencies(sr, n_fft)
    avg = np.float32(0.5) * (S[2:, :] - S[:-2, :])
    shift = np.float32(2) * S[1:-1, :] - S[2:, :] - S[:-2, :]
    tiny = np.finfo(np.float32).tiny
    denom = shift + (np.abs(shift) < tiny).astype(np.float32)
    shift = np.float32(avg.astype(np.float64) / denom.astype(np.float64))
    avg = np.pad(avg, ([(1, 1), (0, 0)]), mode="constant")
    shift = np.pad(shift, ([(1, 1), (0, 0)]), mode="constant")
    dskew = np.float32(0.5) * avg * shift
    freq_mask = ((fmin <= fft_freqs) & (fft_freqs < fmax))[:, None]
    ref_value = np.float32(threshold) * np.max(S, axis=0, keepdims=True)
    idx = freq_mask & localmax(S * freq_mask.astype(np.float32), axis=0) \
        & (S > ref_value)
    bins = np.arange(S.shape[0], dtype=np.float32)[:, None]
    pitches = np.where(idx,
                       (bins + shift) * np.float32(sr) / np.float32(n_fft),
                       np.float32(0.0))
    mags = np.where(idx, S + dskew, np.float32(0.0))
    return pitches.astype(np.float32), mags.astype(np.float32)


def hz_to_octs(frequencies, tuning: float = 0.0, bins_per_octave: int = 12):
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asanyarray(frequencies, dtype=np.float64) / (A440 / 16))


def pitch_tuning(frequencies: np.ndarray, resolution: float = 0.01,
                 bins_per_octave: int = 12) -> float:
    """float32 chain with correctly-rounded divide/log2 (see piptrack)."""
    frequencies = np.atleast_1d(frequencies).astype(np.float32)
    frequencies = frequencies[frequencies > 0]
    if len(frequencies) == 0:
        return 0.0
    q = np.float32(frequencies.astype(np.float64) / 27.5)  # A440/16
    octs = np.float32(np.log2(q.astype(np.float64)))
    residual = np.mod(np.float32(bins_per_octave) * octs, np.float32(1.0))
    residual[residual >= 0.5] -= np.float32(1.0)
    bins = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, tuning = np.histogram(residual, bins)
    return tuning[np.argmax(counts)]


def estimate_tuning_from_S(S: np.ndarray, sr: float, n_fft: int,
                           bins_per_octave: int = 12) -> float:
    """librosa.estimate_tuning(S=S, ...): median-magnitude gated pitch histogram."""
    pitches, mags = piptrack(S, sr, n_fft)
    pitch_mask = pitches > 0
    if pitch_mask.any():
        threshold = np.median(mags[pitch_mask])
    else:
        threshold = 0.0
    return pitch_tuning(pitches[(mags >= threshold) & pitch_mask],
                        bins_per_octave=bins_per_octave)


# ---------------------------------------------------------------------------
# Chroma (STFT variant)
# ---------------------------------------------------------------------------

def chroma_filterbank(sr: float, n_fft: int, tuning: float = 0.0,
                      n_chroma: int = 12, ctroct: float = 5.0,
                      octwidth: float = 2.0, base_c: bool = True) -> np.ndarray:
    """librosa.filters.chroma: gaussian chroma-class weights over FFT bins."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(frequencies, tuning=tuning,
                                    bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts = normalize(wts, norm=2, axis=0)
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)])


def chroma_stft(S: np.ndarray, sr: float, n_chroma: int = 12) -> np.ndarray:
    """librosa.feature.chroma_stft(S=|stft|): per-clip tuning estimation,
    chroma filterbank projection, per-frame inf-norm."""
    n_fft = 2 * (S.shape[0] - 1)
    tuning = estimate_tuning_from_S(S, sr, n_fft, bins_per_octave=n_chroma)
    fb = chroma_filterbank(sr, n_fft, tuning=tuning, n_chroma=n_chroma)
    raw = fb @ S
    return normalize(raw, norm=np.inf, axis=0)


def estimate_tuning_from_y(y: np.ndarray, sr: float,
                           bins_per_octave: int = 12) -> float:
    """librosa.estimate_tuning(y=y, sr=sr, bins_per_octave=...): piptrack on
    |stft(y, n_fft=2048, hop=512)| (piptrack's own defaults: hop = n_fft//4),
    then the median-gated pitch histogram."""
    n_fft = 2048
    S = np.abs(stft(y, n_fft, n_fft // 4))
    return estimate_tuning_from_S(S, sr, n_fft, bins_per_octave=bins_per_octave)


# ---------------------------------------------------------------------------
# Direct CQT + CENS chroma
# ---------------------------------------------------------------------------

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


def cqt(y: np.ndarray, sr: float, hop_length: int, fmin: float, n_bins: int,
        bins_per_octave: int, scale: bool = True) -> np.ndarray:
    """Direct constant-Q transform (see module docstring for the deliberate
    deviation from librosa's recursive multirate algorithm). Frame t is the
    kernel correlated with the signal centered at sample t*hop_length, zero
    padding beyond the signal bounds; scale=True divides by sqrt(length)."""
    kernels, lengths = cqt_kernel_bank(sr, fmin, n_bins, bins_per_octave)
    max_len = kernels.shape[1]
    n_frames = 1 + len(y) // hop_length
    half = max_len // 2
    ypad = np.pad(y.astype(np.float64), (half, max_len), mode="constant")
    # frames [max_len, n_frames] centered at t*hop
    fr = frame(ypad, max_len, hop_length)[:, :n_frames]
    C = np.conj(kernels) @ fr
    if scale:
        C /= np.sqrt(lengths)[:, None]
    return C


# ---------------------------------------------------------------------------
# librosa's actual recursive multirate CQT (librosa 0.10 vqt/cqt algorithm):
# per-octave FFT-basis correlation at successively halved sample rates.
# Implemented to close the oracle-trust gap on the CENS channel (the direct
# cqt() above is the textbook transform this algorithm approximates): the two
# are compared on real clips in tests/test_cqt_multirate.py and the measured
# deviation is recorded in PARITY.md.
#
# res_type: librosa 0.10's default is 'soxr_hq'; soxr is not installed here,
# so the 2:1 octave decimation implements librosa's 'polyphase' mode exactly
# (scipy.signal.resample_poly is the backend librosa itself calls), plus a
# 'sinc' mode (very long windowed-sinc half-band FIR) used to bound the
# sensitivity of the result to the resampler choice.
# ---------------------------------------------------------------------------

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


def resample_half(y: np.ndarray, res_type: str = "polyphase") -> np.ndarray:
    """librosa.resample(y, orig_sr=2, target_sr=1, res_type=..., scale=True):
    2:1 decimation, length fixed to ceil(n/2), scaled by 1/sqrt(1/2)."""
    n_out = int(np.ceil(y.shape[-1] / 2))
    if res_type == "polyphase":
        y_hat = scipy.signal.resample_poly(y, 1, 2, axis=-1)
    elif res_type == "sinc":
        # 2:1 half-band windowed-sinc FIR, far longer than soxr/polyphase use:
        # an (over-engineered) reference decimator to bound resampler effects
        taps = scipy.signal.firwin(255, 0.5, window=("kaiser", 14.0))
        y_hat = scipy.signal.upfirdn(taps, y, up=1, down=2)
        lead = (255 - 1) // 4  # group delay (127) / down (2), rounded
        y_hat = y_hat[..., lead:lead + n_out]
    else:
        raise ValueError(res_type)
    if y_hat.shape[-1] < n_out:
        y_hat = np.pad(y_hat, (0, n_out - y_hat.shape[-1]))
    y_hat = y_hat[..., :n_out]
    return y_hat / np.sqrt(0.5)


def vqt_multirate(y: np.ndarray, sr: float, hop_length: int, fmin: float,
                  n_bins: int, bins_per_octave: int, tuning: float = 0.0,
                  filter_scale: float = 1.0, sparsity: float = 0.01,
                  res_type: str = "polyphase", scale: bool = True
                  ) -> np.ndarray:
    """librosa.cqt's actual recursive algorithm (librosa 0.10 vqt, gamma=0):
    top octave correlated at full rate via FFT-basis x STFT(window='ones'),
    then y is 2:1-decimated and the hop halved for each lower octave; the
    per-octave responses are stacked and scale-compensated."""
    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    n_octaves = int(np.ceil(n_bins / bins_per_octave))
    n_filters = min(bins_per_octave, n_bins)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths, f_cutoff = wavelet_lengths(freqs, sr, filter_scale,
                                        bins_per_octave)
    if f_cutoff > sr / 2:
        raise ValueError("filter cutoff exceeds Nyquist")
    # early downsampling (librosa __early_downsample): inactive for this
    # pipeline's parameters — assert rather than implement untested code
    ds1 = max(0, int(np.ceil(np.log2(0.85 * (sr / 2) / f_cutoff)) - 1) - 2)
    hop_twos = int(np.log2(hop_length & -hop_length))
    ds2 = max(0, hop_twos - n_octaves + 1)
    assert min(ds1, ds2) == 0, "early downsampling not implemented"

    vqt_resp = []
    my_y, my_sr, my_hop = np.asarray(y, np.float64), float(sr), hop_length
    for i in range(n_octaves):
        sl = (slice(-n_filters, None) if i == 0
              else slice(-n_filters * (i + 1), -n_filters * i))
        fft_basis, n_fft = _vqt_filter_fft(my_sr, freqs[sl], bins_per_octave,
                                           filter_scale, sparsity)
        fft_basis = fft_basis * np.sqrt(sr / my_sr)  # downsample compensation
        D = stft(my_y, n_fft, my_hop, window="ones")
        vqt_resp.append(fft_basis @ D)
        if my_hop % 2 == 0:
            my_hop //= 2
            my_sr /= 2.0
            my_y = resample_half(my_y, res_type)

    # __trim_stack: bottom octaves first in vqt_resp order top->down
    max_col = min(r.shape[-1] for r in vqt_resp)
    C = np.empty((n_bins, max_col), dtype=np.complex128)
    end = n_bins
    for resp in vqt_resp:
        n_oct = resp.shape[0]
        if end < n_oct:
            C[:end] = resp[-end:, :max_col]
        else:
            C[end - n_oct:end] = resp[:, :max_col]
        end -= n_oct
    if scale:
        C = C / np.sqrt(lengths[:, None])
    return C


def chroma_cens_librosa(y: np.ndarray, sr: float, hop_length: int,
                        fmin: float = 32.703195662574764, n_chroma: int = 12,
                        bins_per_octave: int = 36, n_octaves: int = 7,
                        win_len_smooth: int = 41,
                        res_type: str = "polyphase") -> np.ndarray:
    """The full librosa.feature.chroma_cens(y=y, ...) path: per-clip tuning
    estimation (piptrack at n_fft=2048), recursive multirate CQT, chroma
    fold, l1 norm, quantize, hann smooth, l2 norm — vs chroma_cens() below
    which fixes tuning=0 and uses the direct CQT."""
    tuning = estimate_tuning_from_y(y, sr, bins_per_octave=bins_per_octave)
    n_bins = n_octaves * bins_per_octave
    C = np.abs(vqt_multirate(y, sr, hop_length, fmin, n_bins,
                             bins_per_octave, tuning=tuning,
                             res_type=res_type))
    # chroma_cqt folds with the UNSHIFTED fmin (only cqt() applies the
    # tuning shift); for C1 the resulting roll is 0 either way
    ctc = cq_to_chroma(n_bins, bins_per_octave, n_chroma, fmin)
    chroma = ctc @ C
    chroma = normalize(chroma, norm=1, axis=0)
    quant_steps = [0.4, 0.2, 0.1, 0.05]
    chroma_quant = np.zeros_like(chroma)
    for step in quant_steps:
        chroma_quant += 0.25 * (chroma > step)
    win = hann(win_len_smooth + 2, periodic=False)
    win /= np.sum(win)
    cens = scipy.signal.convolve(chroma_quant, win[None, :], mode="same")
    return normalize(cens, norm=2, axis=0)


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


def chroma_cens(y: np.ndarray, sr: float, hop_length: int,
                fmin: float = 32.703195662574764, n_chroma: int = 12,
                bins_per_octave: int = 36, n_octaves: int = 7,
                win_len_smooth: int = 41) -> np.ndarray:
    """librosa.feature.chroma_cens: CQT chroma -> l1 norm -> quantize ->
    Hann smooth -> l2 norm. (Tuning is fixed to 0; see cqt() docstring.)"""
    n_bins = n_octaves * bins_per_octave
    C = np.abs(cqt(y, sr, hop_length, fmin, n_bins, bins_per_octave))
    ctc = cq_to_chroma(n_bins, bins_per_octave, n_chroma, fmin)
    chroma = ctc @ C
    chroma = normalize(chroma, norm=1, axis=0)
    QUANT_STEPS = [0.4, 0.2, 0.1, 0.05]
    QUANT_WEIGHTS = [0.25, 0.25, 0.25, 0.25]
    chroma_quant = np.zeros_like(chroma)
    for step, weight in zip(QUANT_STEPS, QUANT_WEIGHTS):
        chroma_quant += weight * (chroma > step)
    win = hann(win_len_smooth + 2, periodic=False)
    win /= np.sum(win)
    cens = scipy.signal.convolve(chroma_quant, win[None, :], mode="same")
    return normalize(cens, norm=2, axis=0)


# ---------------------------------------------------------------------------
# Onset strength + tempogram
# ---------------------------------------------------------------------------

def onset_strength(y: np.ndarray, sr: float, hop_length: int,
                   n_fft: int = 2048, lag: int = 1) -> np.ndarray:
    """librosa.onset.onset_strength: dB mel-spectrogram spectral flux,
    half-wave rectified, mean over mel bands, center-compensated."""
    S = melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                       n_mels=128, fmax=0.5 * sr, power=2.0)
    S = power_to_db(S)
    onset_env = S[:, lag:] - S[:, :-lag]
    onset_env = np.maximum(0.0, onset_env)
    onset_env = np.mean(onset_env, axis=0)
    pad_width = lag + n_fft // (2 * hop_length)
    onset_env = np.pad(onset_env, (pad_width, 0), mode="constant")
    return onset_env[: S.shape[-1]]


def autocorrelate(x: np.ndarray, axis: int = -2) -> np.ndarray:
    """librosa.autocorrelate: FFT-based full autocorrelation, positive lags."""
    n = x.shape[axis]
    f = np.fft.rfft(x, n=2 * n, axis=axis)
    ac = np.fft.irfft(f * np.conj(f), n=2 * n, axis=axis)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    return ac[tuple(sl)]


def tempogram(onset_envelope: np.ndarray, win_length: int = 384) -> np.ndarray:
    """librosa.feature.tempogram: linear-ramp pad, hop-1 framing, windowed
    local autocorrelation, per-frame inf-norm."""
    n = len(onset_envelope)
    pad = win_length // 2
    oe = np.pad(onset_envelope, pad, mode="linear_ramp", end_values=0)
    frames = frame(oe, win_length, 1)[:, :n]
    win = hann(win_length, periodic=True)
    ac = autocorrelate(frames * win[:, None], axis=0)
    return normalize(ac, norm=np.inf, axis=0)


# ---------------------------------------------------------------------------
# Burg LPC (librosa.lpc semantics)
# ---------------------------------------------------------------------------

def lpc(y: np.ndarray, order: int) -> np.ndarray:
    """Burg's method, mirroring librosa.core._lpc exactly."""
    dtype = y.dtype if y.dtype.kind == "f" else np.float64
    ar_coeffs = np.zeros(order + 1, dtype=dtype)
    ar_coeffs[0] = 1.0
    ar_coeffs_prev = ar_coeffs.copy()
    fwd = y[1:].astype(dtype).copy()
    bwd = y[:-1].astype(dtype).copy()
    den = np.dot(fwd, fwd) + np.dot(bwd, bwd)
    for i in range(order):
        reflect = -2.0 * np.dot(bwd, fwd) / den
        ar_coeffs_prev, ar_coeffs = ar_coeffs, ar_coeffs_prev
        for j in range(1, i + 2):
            ar_coeffs[j] = ar_coeffs_prev[j] + reflect * ar_coeffs_prev[i - j + 1]
        fwd_tmp = fwd.copy()
        fwd = fwd + reflect * bwd
        bwd = bwd + reflect * fwd_tmp
        q = 1.0 - reflect ** 2
        den = q * den - bwd[-1] ** 2 - fwd[0] ** 2
        fwd = fwd[1:]
        bwd = bwd[:-1]
    return ar_coeffs


def lpc_features(y: np.ndarray, order: int, sr: int = 16_000) -> np.ndarray:
    """reference src/precompute/methods.py:116-134: pre-emphasis 0.97,
    25ms/10ms Hamming frames, Burg LPC, coefficients a[1:], zeros on failure."""
    pre_emphasis = 0.97
    y_emph = np.append(y[0], y[1:] - pre_emphasis * y[:-1])
    frame_length = int(0.025 * sr)
    frame_shift = int(0.010 * sr)
    feats = []
    ham = np.hamming(frame_length)
    for i in range(0, len(y_emph) - frame_length, frame_shift):
        fr = y_emph[i:i + frame_length] * ham
        with np.errstate(all="ignore"):
            a = lpc(fr, order)
        if np.all(np.isfinite(a)):
            feats.append(a[1:])
        else:
            feats.append(np.zeros(order))
    if not feats:
        return np.zeros((order, 1), dtype=np.float32)
    return np.array(feats, dtype=np.float32).T


# ---------------------------------------------------------------------------
# Scalar-descriptor building blocks (reference src/precompute/methods.py:48-114)
# ---------------------------------------------------------------------------

def rms(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    ypad = np.pad(y, frame_length // 2, mode="constant")
    fr = frame(ypad, frame_length, hop_length)
    return np.sqrt(np.mean(np.abs(fr) ** 2, axis=0))


def zero_crossing_rate(y: np.ndarray, frame_length: int = 2048,
                       hop_length: int = 512, threshold: float = 1e-10) -> np.ndarray:
    ypad = np.pad(y, frame_length // 2, mode="edge")
    fr = frame(ypad, frame_length, hop_length).copy()
    fr[np.abs(fr) <= threshold] = 0.0
    sign = np.signbit(fr)
    crossings = np.pad(sign[1:] != sign[:-1], ([(1, 0), (0, 0)]),
                       mode="constant")
    return np.mean(crossings, axis=0)


def spectral_centroid(S: np.ndarray, sr: float, n_fft: int) -> np.ndarray:
    freq = fft_frequencies(sr, n_fft)[:, None]
    return np.sum(freq * normalize(S, norm=1, axis=0), axis=0)


def spectral_bandwidth(S: np.ndarray, sr: float, n_fft: int, p: float = 2.0) -> np.ndarray:
    freq = fft_frequencies(sr, n_fft)[:, None]
    centroid = spectral_centroid(S, sr, n_fft)[None, :]
    deviation = np.abs(freq - centroid)
    Sn = normalize(S, norm=1, axis=0)
    return np.sum(Sn * deviation ** p, axis=0) ** (1.0 / p)


def spectral_rolloff(S: np.ndarray, sr: float, n_fft: int,
                     roll_percent: float = 0.85) -> np.ndarray:
    freq = fft_frequencies(sr, n_fft)[:, None]
    total = np.cumsum(S, axis=0)
    threshold = roll_percent * total[-1:, :]
    ind = np.where(total < threshold, np.nan, 1.0)
    return np.nanmin(ind * freq, axis=0)


def spectral_flatness(S: np.ndarray, amin: float = 1e-10, power: float = 2.0) -> np.ndarray:
    S_thresh = np.maximum(amin, S ** power)
    gmean = np.exp(np.mean(np.log(S_thresh), axis=0))
    amean = np.mean(S_thresh, axis=0)
    return gmean / amean


def spectral_contrast(S: np.ndarray, sr: float, n_fft: int, fmin: float = 200.0,
                      n_bands: int = 6, quantile: float = 0.02) -> np.ndarray:
    freq = fft_frequencies(sr, n_fft)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    valley = np.zeros((n_bands + 1, S.shape[1]))
    peak = np.zeros_like(valley)
    for k, (f_low, f_high) in enumerate(zip(octa[:-1], octa[1:])):
        current_band = (freq >= f_low) & (freq <= f_high)
        idx = np.flatnonzero(current_band)
        if k > 0:
            current_band[idx[0] - 1] = True
        if k == n_bands:
            current_band[idx[-1] + 1:] = True
        sub_band = S[current_band]
        if k < n_bands:
            sub_band = sub_band[:-1]
        n_idx = int(max(np.rint(quantile * np.sum(current_band)), 1))
        sortedr = np.sort(sub_band, axis=0)
        valley[k] = np.mean(sortedr[:n_idx], axis=0)
        peak[k] = np.mean(sortedr[-n_idx:], axis=0)
    return power_to_db(peak) - power_to_db(valley)


def hilbert_envelope(y: np.ndarray) -> np.ndarray:
    return np.abs(scipy.signal.hilbert(y))


def full_autocorr_normalized(y: np.ndarray) -> np.ndarray:
    ac = np.correlate(y, y, mode="full")[len(y) - 1:]
    return ac / ac[0]
