"""The benchmark's frozen copy of the port's per-clip NumPy feature
pipeline (tpu_breath_torch/baseline/feature_np.py as of the benchmark's
first version), the oracle mirroring the reference's librosa pipeline:
reference src/precompute/process.py:25-108 (channel recipes + z-scoring +
min-value padding) and src/precompute/methods.py:48-114 (scalar
descriptors). process_clip(y, spec) returns the 9 channels and the 36
scalars of one clip. It imports nothing of the port.
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.stats
from scipy.fftpack import dct as scipy_dct
from scipy.signal import find_peaks

from breathbench.reference import dsp_np as L
from breathbench.reference.spec import FeatureSpec


def pad_or_truncate(waveform: np.ndarray, target_len: int) -> np.ndarray:
    """reference src/precompute/methods.py:24-28."""
    n = len(waveform)
    if n >= target_len:
        return waveform[:target_len]
    return np.concatenate([waveform, np.zeros(target_len - n, dtype=np.float32)])


def pad_time(spec2d: np.ndarray, from_bins: int, t_fixed: int) -> np.ndarray:
    """Pad/truncate time axis; fill value is the array min
    (reference src/precompute/methods.py:30-37)."""
    _, t_raw = spec2d.shape
    if t_raw >= t_fixed:
        return spec2d[:, :t_fixed]
    minv = spec2d.min()
    pad_block = np.full((from_bins, t_fixed - t_raw), minv, dtype=np.float32)
    return np.concatenate([spec2d, pad_block], axis=1)


def pad_freq(spec2d: np.ndarray, from_bins: int, to_bins: int) -> np.ndarray:
    """reference src/precompute/methods.py:39-46."""
    t_fixed = spec2d.shape[1]
    if from_bins >= to_bins:
        return spec2d[:to_bins, :]
    minv = spec2d.min()
    pad_rows = np.full((to_bins - from_bins, t_fixed), minv, dtype=np.float32)
    return np.concatenate([spec2d, pad_rows], axis=0)


def _znorm(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / (x.std() + 1e-8)


def _znorm_rows(x: np.ndarray) -> np.ndarray:
    return (x - x.mean(axis=1, keepdims=True)) / (x.std(axis=1, keepdims=True) + 1e-8)


def extract_scalar_features(y: np.ndarray, spec: FeatureSpec) -> np.ndarray:
    """The 36-dim descriptor vector (reference src/precompute/methods.py:48-114;
    the code computes 36 even though the docs claim 39 — discrepancy D2)."""
    sr, hop, n_fft = spec.sr, spec.hop_length, spec.n_fft
    features: list[float] = []

    rms_v = L.rms(y, frame_length=2048, hop_length=hop)
    zcr_v = L.zero_crossing_rate(y, frame_length=2048, hop_length=hop)
    features.extend([
        np.mean(rms_v), np.std(rms_v), np.max(rms_v), np.min(rms_v),
        np.mean(zcr_v), np.std(zcr_v), np.max(zcr_v), np.min(zcr_v),
    ])

    S2048 = np.abs(L.stft(y, 2048, hop))
    centroid = L.spectral_centroid(S2048, sr, 2048)
    bandwidth = L.spectral_bandwidth(S2048, sr, 2048)
    # rolloff keeps librosa's default hop of 512 (reference methods.py:61
    # omits hop_length)
    S2048_h512 = np.abs(L.stft(y, 2048, 512))
    rolloff = L.spectral_rolloff(S2048_h512, sr, 2048, roll_percent=0.85)
    flatness = L.spectral_flatness(S2048)
    contrast = L.spectral_contrast(S2048, sr, 2048)
    features.extend([
        np.mean(centroid) / (sr / 2), np.std(centroid) / (sr / 2),
        scipy.stats.skew(centroid),
        np.mean(bandwidth) / (sr / 2), np.std(bandwidth) / (sr / 2),
        np.mean(rolloff) / (sr / 2), np.std(rolloff) / (sr / 2),
        np.mean(flatness), np.std(flatness),
        np.mean(contrast), np.std(contrast),
    ])

    envelope = np.abs(scipy.signal.hilbert(y))
    env_mean, env_std = np.mean(envelope), np.std(envelope)
    env_snr = env_mean / (env_std + 1e-8)
    peaks, props = find_peaks(envelope, height=env_mean, distance=sr // 10)
    n_peaks = len(peaks)
    peak_heights = props["peak_heights"] if n_peaks > 0 else [0]
    features.extend([
        env_mean, env_std, env_snr,
        n_peaks, np.mean(peak_heights),
        np.std(peak_heights) if n_peaks > 1 else 0,
    ])

    stft_m = np.abs(L.stft(y, n_fft, hop))
    low_bins = int(1000 * n_fft / sr)
    low_energy = np.sum(stft_m[:low_bins, :] ** 2)
    total_energy = np.sum(stft_m ** 2)
    low_ratio = low_energy / (total_energy + 1e-8)

    mel = L.melspectrogram(y, sr, n_fft=2048, hop_length=hop, n_mels=spec.n_mels)
    mel_db = L.power_to_db(mel, ref=np.max)
    flux = np.sqrt(np.sum(np.diff(mel_db, axis=1) ** 2, axis=0))
    features.extend([low_ratio, np.mean(flux), np.std(flux), np.max(flux)])

    features.extend([
        scipy.stats.skew(y),
        scipy.stats.kurtosis(y),
        np.percentile(np.abs(y), 90),
        np.percentile(np.abs(y), 10),
    ])

    autocorr = L.full_autocorr_normalized(y)
    first_min_idx = (np.argmin(autocorr[: sr // 20])
                     if len(autocorr) > sr // 20 else len(autocorr) // 2)
    features.extend([
        autocorr[sr // 100] if len(autocorr) > sr // 100 else 0,
        autocorr[sr // 50] if len(autocorr) > sr // 50 else 0,
        first_min_idx / sr,
    ])

    return np.array(features, dtype=np.float32)


def process_clip(y: np.ndarray, spec: FeatureSpec = FeatureSpec()) -> dict[str, np.ndarray]:
    """wav -> the 10-array npz feature dict (reference src/precompute/process.py:25-103)."""
    sr, hop, n_fft = spec.sr, spec.hop_length, spec.n_fft
    y = pad_or_truncate(np.asarray(y, dtype=np.float32), spec.expected_len)
    T = spec.t_fixed

    mel_spec = L.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                n_mels=spec.n_mels, fmax=spec.fmax)
    mel_db = L.power_to_db(mel_spec, ref=np.max)
    mel_delta = L.delta(mel_db, order=1)
    mel_delta2 = L.delta(mel_db, order=2)
    mel_p = pad_time(_znorm(mel_db).astype(np.float32), spec.n_mels, T)
    d1_p = pad_time(_znorm(mel_delta).astype(np.float32), spec.n_mels, T)
    d2_p = pad_time(_znorm(mel_delta2).astype(np.float32), spec.n_mels, T)

    mfcc = L.mfcc(y, sr, n_mfcc=spec.n_mfcc, hop_length=hop, n_fft=n_fft)
    mfcc_all = np.vstack([mfcc, L.delta(mfcc, order=1), L.delta(mfcc, order=2)])
    mfcc_p = pad_freq(pad_time(_znorm_rows(mfcc_all).astype(np.float32),
                               mfcc_all.shape[0], T),
                      mfcc_all.shape[0], spec.n_mels)

    stft_m = np.abs(L.stft(y, n_fft, hop))
    chroma = L.chroma_stft(stft_m, sr)
    # full librosa path: per-clip tuning estimation + recursive multirate CQT
    cens = L.chroma_cens_librosa(y, sr, hop, fmin=spec.cqt_fmin,
                                 bins_per_octave=spec.cqt_bins_per_octave,
                                 n_octaves=spec.cqt_n_octaves,
                                 win_len_smooth=spec.cens_win_len_smooth)
    chroma_all = np.vstack([chroma, cens])
    chroma_p = pad_freq(pad_time(_znorm_rows(chroma_all).astype(np.float32), 24, T),
                        24, spec.n_mels)

    # "gammatone" is actually a 64-band mel filterbank on |STFT| with log1p
    # (reference src/precompute/methods.py:136-140, discrepancy D9)
    gt_fb = L.mel_filterbank(sr, n_fft, spec.n_gammatone)
    gammatone = np.log1p(gt_fb @ stft_m)
    gt_p = pad_freq(pad_time(_znorm(gammatone).astype(np.float32),
                             spec.n_gammatone, T),
                    spec.n_gammatone, spec.n_mels)

    lpc = L.lpc_features(y, spec.n_lpc, sr)
    lpc_p = pad_freq(pad_time(_znorm(lpc).astype(np.float32), spec.n_lpc, T),
                     spec.n_lpc, spec.n_mels)

    mod_spec = scipy_dct(scipy_dct(mel_db, axis=0, norm="ortho")[:40, :],
                         axis=1, norm="ortho")
    mod_p = pad_freq(pad_time(_znorm(mod_spec).astype(np.float32), 40, T),
                     40, spec.n_mels)

    onset_env = L.onset_strength(y, sr, hop)
    tempo = L.tempogram(onset_env, win_length=spec.tempogram_win_length)
    tempo_p = pad_freq(pad_time(_znorm(tempo).astype(np.float32),
                                tempo.shape[0], T),
                       tempo.shape[0], spec.n_mels)

    scalars = extract_scalar_features(y, spec)

    return {
        "mel": mel_p.astype(np.float32),
        "mfcc": mfcc_p.astype(np.float32),
        "chroma": chroma_p.astype(np.float32),
        "mel_delta": d1_p.astype(np.float32),
        "mel_delta2": d2_p.astype(np.float32),
        "gammatone": gt_p.astype(np.float32),
        "lpc": lpc_p.astype(np.float32),
        "mod_spec": mod_p.astype(np.float32),
        "tempogram": tempo_p.astype(np.float32),
        "scalars": scalars,
    }
