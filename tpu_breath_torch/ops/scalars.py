"""The 36-value scalar descriptor vector, batched (counterpart of
tpu_breath/ops/scalars.py; same order as its lines 219-288)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_breath_torch.ops import dft, peaks, select, spectral

_TINY = float(np.finfo(np.float32).tiny)

# framing descriptors


def rms_frames(y: torch.Tensor, frame_length: int = 2048,
               hop_length: int = 256) -> torch.Tensor:
    n_frames = 1 + y.shape[-1] // hop_length
    yp = torch.nn.functional.pad(y, (frame_length // 2, frame_length // 2))
    fr = spectral.frame_signal(yp, frame_length, hop_length, n_frames)
    return torch.sqrt(torch.mean(fr * fr, dim=-1))


def zcr_frames(y: torch.Tensor, frame_length: int = 2048,
               hop_length: int = 256) -> torch.Tensor:
    n_frames = 1 + y.shape[-1] // hop_length
    half = frame_length // 2
    yp = torch.cat([y[..., :1].expand(*y.shape[:-1], half), y,
                    y[..., -1:].expand(*y.shape[:-1], half)], dim=-1)
    yp = torch.where(yp.abs() <= 1e-10, 0.0, yp)  # librosa's threshold
    fr = spectral.frame_signal(torch.signbit(yp).to(torch.int8),
                               frame_length, hop_length, n_frames)
    crossings = (fr[..., 1:] != fr[..., :-1]).sum(dim=-1)
    # librosa pads the first diff slot with False -> divide by frame_length
    return crossings.to(y.dtype) / frame_length


# spectral-shape descriptors (magnitude spectrograms [..., F, T])


@functools.lru_cache(maxsize=None)
def _freqs(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2, 1 + n_fft // 2, dtype=np.float32)[:, None]


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the same order for every row of a batch.

    CUDA's row reduction reads 16 bytes at a time from the first aligned
    element of a row, so a row that starts off a 16-byte boundary (row b of
    [B, 63] starts at 252 * b bytes) is summed in another order, and a
    clip's scalars would depend on its place in the batch: the fused step's
    batches would not reproduce the cache. Zero-padding the axis to a
    multiple of 4 aligns every row alike; adding zeros changes no sum."""
    pad = (-x.shape[-1]) % 4
    x = torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()
    return x.sum(dim=-1)


def _sum_freq(S: torch.Tensor) -> torch.Tensor:
    """Sum over the frequency axis of [..., F, T], in the same order for
    every clip of a batch (see _sum_last: the time-major |STFT| keeps F
    contiguous in rows of 1,025 values)."""
    return _sum_last(S.movedim(-2, -1))


def _l1_norm_cols(S: torch.Tensor) -> torch.Tensor:
    length = _sum_freq(S.abs())[..., None, :]
    return S / torch.where(length < _TINY, 1.0, length)


def spectral_centroid(S: torch.Tensor, sr: int, n_fft: int) -> torch.Tensor:
    freq = spectral.device_const(_freqs, sr, n_fft, device=S.device)
    return _sum_freq(freq * _l1_norm_cols(S))


def spectral_bandwidth(S: torch.Tensor, sr: int, n_fft: int) -> torch.Tensor:
    """p = 2 bandwidth around the centroid."""
    freq = spectral.device_const(_freqs, sr, n_fft, device=S.device)
    dev = (freq - spectral_centroid(S, sr, n_fft)[..., None, :]).abs()
    return _sum_freq(_l1_norm_cols(S) * dev ** 2.0) ** 0.5


def spectral_rolloff(S: torch.Tensor, sr: int, n_fft: int) -> torch.Tensor:
    """85% roll-off frequency. The running sum is float64, as the oracle's:
    in f32 its rounding moves a frame's crossing by a bin where a partial
    sum lies within ~1e-6 of the threshold, and the card's parallel scan
    rounds otherwise than a sequential one (on an H100 the std of the
    rolloff, scalar 14, then missed the oracle by 1.3e-3 rel on real
    clips)."""
    freq = spectral.device_const(_freqs, sr, n_fft, device=S.device)
    total = torch.cumsum(S.double(), dim=-2)
    threshold = 0.85 * total[..., -1:, :]
    return torch.amin(torch.where(total < threshold, torch.inf, freq), dim=-2)


def spectral_flatness(S: torch.Tensor) -> torch.Tensor:
    """Flatness of the power spectrum (amin 1e-10)."""
    S_thresh = torch.clamp(S ** 2.0, min=1e-10)
    n = S.shape[-2]
    gmean = torch.exp(_sum_freq(torch.log(S_thresh)) / n)
    return gmean / (_sum_freq(S_thresh) / n)


@functools.lru_cache(maxsize=None)
def _contrast_bands(sr: int, n_fft: int):
    """Static (start, stop, n_idx) per sub-band, mirroring the oracle's
    masks (baseline/dsp_np.spectral_contrast; librosa's fmin 200, 6 bands,
    quantile 0.02)."""
    fmin, n_bands, quantile = 200.0, 6, 0.02
    freq = np.linspace(0, sr / 2, 1 + n_fft // 2)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    bands = []
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        idx = np.flatnonzero((freq >= f_low) & (freq <= f_high))
        start, stop = idx[0], idx[-1] + 1
        if k > 0:
            start -= 1
        if k == n_bands:
            stop = len(freq)
        n_idx = int(max(np.rint(quantile * (stop - start)), 1))
        sub_stop = stop if k == n_bands else stop - 1
        bands.append((int(start), int(sub_stop), n_idx))
    return tuple(bands)


def spectral_contrast(S: torch.Tensor, sr: int, n_fft: int) -> torch.Tensor:
    """[..., n_bands+1, T] valley-to-peak contrast in dB."""
    valleys, peaks_ = [], []
    for start, stop, n_idx in _contrast_bands(sr, n_fft):
        sub, _ = torch.sort(S[..., start:stop, :], dim=-2)
        valleys.append(sub[..., :n_idx, :].mean(dim=-2))
        peaks_.append(sub[..., -n_idx:, :].mean(dim=-2))
    return (spectral.power_to_db(torch.stack(peaks_, dim=-2))
            - spectral.power_to_db(torch.stack(valleys, dim=-2)))


# statistics helpers

_STABLE_SUM_SPLIT = 128
_STABLE_SUM_MAX = 512


def _row_sum_stable(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed two-level association: a long axis
    is reshaped to [..., N/128, 128] and summed as two short sums, so the
    result does not depend on how a backend tiles one long reduction (the
    fused==cached training identity rests on it, tpu_breath/ops/scalars.py
    :142-169)."""
    n = x.shape[-1]
    if n <= _STABLE_SUM_MAX:
        return _sum_last(x)
    pad = (-n) % _STABLE_SUM_SPLIT
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    parts = x.reshape(*x.shape[:-1], -1, _STABLE_SUM_SPLIT)
    return _sum_last(parts.sum(dim=-1))


def _skew(x: torch.Tensor) -> torch.Tensor:
    """scipy.stats.skew(bias=True) along the last axis; NaN for a constant
    row, as scipy returns (the JAX graph gets the same 0/0 once the device
    flushes the denormal 1e-30**1.5 to zero)."""
    n = x.shape[-1]
    d = x - (_row_sum_stable(x) / n)[..., None]
    m2 = _row_sum_stable(d * d) / n
    m3 = _row_sum_stable(d * d * d) / n
    return torch.where(m2 > 0, m3 / torch.clamp(m2, min=1e-30) ** 1.5,
                       torch.nan)


def _kurtosis(x: torch.Tensor) -> torch.Tensor:
    """scipy.stats.kurtosis (Fisher, bias=True) along the last axis."""
    n = x.shape[-1]
    d = x - (_row_sum_stable(x) / n)[..., None]
    m2 = _row_sum_stable(d * d) / n
    m4 = _row_sum_stable((d * d) * (d * d)) / n
    return torch.where(m2 > 0, m4 / torch.clamp(m2, min=1e-30) ** 2 - 3.0,
                       torch.nan)


def _mstd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[-1]
    mean = _sum_last(x) / n
    var = _sum_last((x - mean[..., None]).square()) / n
    return mean, torch.sqrt(var)


def extract_scalars(y: torch.Tensor, sr: int = 16_000, hop_length: int = 256,
                    n_fft: int = 512, n_mels: int = 128,
                    stft512_mag: torch.Tensor | None = None,
                    stft2048_mag: torch.Tensor | None = None,
                    mel2048_power: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """y[B, 16000] -> [B, 36] in the reference's order. The keyword
    spectrograms let extract_features share the ones it already computed."""
    feats = []
    for v in (rms_frames(y, 2048, hop_length), zcr_frames(y, 2048, hop_length)):
        m, s = _mstd(v)
        feats += [m, s, v.amax(dim=-1), v.amin(dim=-1)]

    S2048 = stft2048_mag
    if S2048 is None:
        S2048 = spectral.stft_mag(y, 2048, hop_length)
    # hop-512 frames are every 2nd hop-256 frame
    S2048_h512 = (S2048[..., ::2] if hop_length == 256
                  else spectral.stft_mag(y, 2048, 512))
    nyq = sr / 2
    centroid = spectral_centroid(S2048, sr, 2048)
    cm, cs = _mstd(centroid)
    bm, bs = _mstd(spectral_bandwidth(S2048, sr, 2048))
    rm, rs = _mstd(spectral_rolloff(S2048_h512, sr, 2048))
    fm, fs = _mstd(spectral_flatness(S2048))
    contrast = spectral_contrast(S2048, sr, 2048)
    km, ks = _mstd(contrast.reshape(*contrast.shape[:-2], -1))
    feats += [cm / nyq, cs / nyq, _skew(centroid),
              bm / nyq, bs / nyq, rm / nyq, rs / nyq, fm, fs, km, ks]

    env = dft.hilbert_envelope(y)
    em, es = _mstd(env)
    feats += [em, es, em / (es + 1e-8)]
    feats += list(peaks.find_peaks_stats_batched(env, em, sr // 10))

    if stft512_mag is None:
        stft512_mag = spectral.stft_mag(y, n_fft, hop_length)
    low_bins = int(1000 * n_fft / sr)
    p512 = stft512_mag * stft512_mag
    low_e = _sum_last(p512[..., :low_bins, :].flatten(-2))
    low_ratio = low_e / (_sum_last(p512.flatten(-2)) + 1e-8)

    mel = mel2048_power
    if mel is None:
        mel = spectral.melspectrogram(y, sr, n_fft=2048,
                                      hop_length=hop_length, n_mels=n_mels)
    mel_db = spectral.power_to_db(mel, ref_max=True)
    d = mel_db[..., 1:] - mel_db[..., :-1]
    flux = torch.sqrt(torch.sum(d * d, dim=-2))
    xm, xs = _mstd(flux)
    feats += [low_ratio, xm, xs, flux.amax(dim=-1)]

    p = select.percentiles(y.abs(), (90.0, 10.0))
    feats += [_skew(y), _kurtosis(y), p[..., 0], p[..., 1]]

    ac = dft.autocorr_full(y)
    ac = ac / ac[..., :1]
    first_min = torch.argmin(ac[..., : sr // 20], dim=-1).to(y.dtype)
    feats += [ac[..., sr // 100], ac[..., sr // 50], first_min / sr]
    return torch.stack(feats, dim=-1)
