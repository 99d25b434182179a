"""The batched wav -> (9-channel spectrogram stack, scalar vector) graph
(counterpart of tpu_breath/features.py).

Channel order at the model boundary is alphabetical: chroma, gammatone, lpc,
mel, mel_delta, mel_delta2, mfcc, mod_spec, tempogram.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_breath.config import DEFAULT_FEATURES, FeatureSpec
from tpu_breath_torch.ops import cepstral, chroma as chroma_ops
from tpu_breath_torch.ops import cqt as cqt_ops
from tpu_breath_torch.ops import lpc as lpc_ops
from tpu_breath_torch.ops import rhythm, scalars as scalar_ops, spectral
from tpu_breath_torch.ops.cuda import epilogue_kernel


def _zn(x):
    return spectral.znorm(x, axes=(-2, -1))


def _zn_rows(x):
    return spectral.znorm(x, axes=(-1,))


def _pads(x, spec: FeatureSpec):
    return spectral.pad_freq_min(spectral.pad_time_min(x, spec.t_fixed),
                                 spec.n_mels)


@torch.no_grad()
def extract_features(y: torch.Tensor, spec: FeatureSpec = DEFAULT_FEATURES
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[B, 16000] f32 -> (features [B, 9, 128, 63], scalars [B, 36]), on
    y's device."""
    if y.dim() != 2:
        raise ValueError(f"y {tuple(y.shape)}: want [B, n_samples]")
    spectral.disable_tf32()
    y = y.float()
    sr, hop, n_fft = spec.sr, spec.hop_length, spec.n_fft

    # mel + deltas
    mel_spec = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                       n_mels=spec.n_mels, fmax=spec.fmax)
    mel_db = spectral.power_to_db(mel_spec, ref_max=True)
    mel_c = _pads(_zn(mel_db), spec)
    d1_c = _pads(_zn(cepstral.delta(mel_db, order=1)), spec)
    d2_c = _pads(_zn(cepstral.delta(mel_db, order=2)), spec)

    # mfcc stack: 40 + delta + delta2 rows, per-row z-score, min-padded
    mf = cepstral.mfcc(y, sr, spec.n_mfcc, hop, n_fft)
    mf_all = torch.cat([mf, cepstral.delta(mf, order=1),
                        cepstral.delta(mf, order=2)], dim=-2)
    mfcc_c = _pads(_zn_rows(mf_all), spec)

    # shared 2048-point spectrograms: onset-strength mel, scalar
    # descriptors' |STFT|/mel, and the CENS tuning estimate
    p2048 = spectral.stft_power64(y, 2048, hop)          # [B, T, F] f64
    stft2048_mag = torch.sqrt(p2048).float().transpose(-1, -2)
    mel2048_power = spectral.mel_from_power64(p2048, sr, 2048, spec.n_mels)

    # chroma_stft + chroma_cens; the round-once |STFT_512| also feeds the
    # gammatone channel and the scalars
    stft512 = spectral.stft_mag_cr(y, n_fft, hop).contiguous()
    ch = chroma_ops.chroma_stft(stft512, sr)
    cens = cqt_ops.chroma_cens(y, sr, hop, spec.cqt_fmin,
                               bins_per_octave=spec.cqt_bins_per_octave,
                               n_octaves=spec.cqt_n_octaves,
                               win_len_smooth=spec.cens_win_len_smooth,
                               stft2048_mag=stft2048_mag)
    chroma_c = _pads(_zn_rows(torch.cat([ch, cens], dim=-2)), spec)

    # "gammatone" = z-normed log1p(64-band mel filterbank @ |STFT|): kernel B
    gt_fb = spectral.device_const(spectral.mel_matrix, sr, n_fft,
                                  spec.n_gammatone, device=y.device)
    gt_c = _pads(epilogue_kernel.fused_epilogue(stft512, gt_fb), spec)

    lpc_c = _pads(_zn(lpc_ops.lpc_features(y, spec.n_lpc, sr)), spec)
    mod_c = _pads(_zn(cepstral.mod_spec(mel_db, n_keep=40)), spec)

    onset = rhythm.onset_strength(y, sr, hop, mel_power=mel2048_power)
    tempo_c = _pads(_zn(rhythm.tempogram(onset, spec.tempogram_win_length)),
                    spec)

    scalars = scalar_ops.extract_scalars(y, sr, hop, n_fft, spec.n_mels,
                                         stft512_mag=stft512,
                                         stft2048_mag=stft2048_mag,
                                         mel2048_power=mel2048_power)
    by_name = {
        "mel": mel_c, "mfcc": mfcc_c, "chroma": chroma_c,
        "mel_delta": d1_c, "mel_delta2": d2_c, "gammatone": gt_c,
        "lpc": lpc_c, "mod_spec": mod_c, "tempogram": tempo_c,
    }
    feats = torch.stack([by_name[k] for k in spec.channel_order], dim=-3)
    return feats, scalars


def extract_features_batched(wavs: np.ndarray,
                             spec: FeatureSpec = DEFAULT_FEATURES,
                             chunk: int = 128, device: str = "cpu"
                             ) -> tuple[np.ndarray, np.ndarray]:
    """wavs[N, 16000] -> numpy (features [N, 9, 128, 63], scalars [N, 36]),
    in chunks of `chunk` clips on `device`."""
    n = wavs.shape[0]
    feats_out = np.empty((n, spec.n_channels, spec.n_mels, spec.t_fixed),
                         np.float32)
    scal_out = np.empty((n, spec.n_scalars), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        y = torch.from_numpy(np.ascontiguousarray(wavs[lo:hi], np.float32))
        f, s = extract_features(y.to(device), spec)
        feats_out[lo:hi] = f.cpu().numpy()
        scal_out[lo:hi] = s.cpu().numpy()
    return feats_out, scal_out
