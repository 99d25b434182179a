"""Profiling of the feature graph and of training (counterpart of
tpu_breath/utils/profiling.py), behind the CLI's --profile:

- feature_stages / profile_feature_stages / write_feature_profile: each
  named subgraph of the feature stack timed over chunks of precompute's
  size, slowest first -> feature_stages.json (`precompute --profile DIR`);
- trace: a torch.profiler trace (CPU and, on the card, CUDA activity) of a
  training run -> trace.json and a table of the top operations, ops.txt
  (`train/e2e --profile DIR`);
- write_train_profile: per-epoch wall time from fit histories ->
  train_profile.json.

Times on the card come from CUDA events around all chunks of a stage; on
the CPU (device='cpu') from the host clock, and the JSON says which. The
stages run eagerly (extract_features and its subgraphs), not as the
captured graph that precompute replays (features.extract_features_compiled):
a graph replays the whole feature stack at once, so it has no stages to
time.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from tpu_breath_torch.device import resolve_device


def feature_stages() -> dict:
    """Stage name -> function of a chunk y [B, 16000] on the device: the
    JAX package's stages, with the round-once |STFT_512| (stft_mag_cr) as
    `stft512` and no `stft512_dd` (the port has no double-float path)."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.features import extract_features
    from tpu_breath_torch.ops import (cepstral, chroma as ch_ops,
                                      cqt as cqt_ops, dft, lpc as lpc_ops,
                                      peaks, rhythm, scalars as scalar_ops,
                                      spectral)

    sr, hop, n_fft = SPEC.sr, SPEC.hop_length, SPEC.n_fft

    def _mels(y):
        db = spectral.power_to_db(
            spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                    n_mels=SPEC.n_mels, fmax=SPEC.fmax),
            ref_max=True)
        return db + cepstral.delta(db, 1) + cepstral.delta(db, 2)

    def _mfccs(y):
        mf = cepstral.mfcc(y, sr, SPEC.n_mfcc, hop, n_fft)
        return mf + cepstral.delta(mf, 1) + cepstral.delta(mf, 2)

    return {
        "full": lambda y: extract_features(y, SPEC),
        "stft512": lambda y: spectral.stft_mag_cr(y, n_fft, hop),
        "stft2048": lambda y: spectral.stft_mag_cr(y, 2048, hop),
        "mel+deltas": _mels,
        "mfcc+deltas": _mfccs,
        "chroma_stft": lambda y: ch_ops.chroma_stft(
            spectral.stft_mag_cr(y, n_fft, hop).contiguous(), sr),
        "tuning36": lambda y: ch_ops.estimate_tuning_index(
            spectral.stft_mag_cr(y, 2048, hop)[..., ::2], sr, 2048, 36),
        "cens": lambda y: cqt_ops.chroma_cens(y, sr, hop, SPEC.cqt_fmin),
        "cqt": lambda y: cqt_ops.cqt_mag_multirate(
            y, torch.full(y.shape[:-1], 50, device=y.device), sr, hop,
            SPEC.cqt_fmin, 36, 7),
        "lpc": lambda y: lpc_ops.lpc_features(y, SPEC.n_lpc, sr),
        "tempogram": lambda y: rhythm.tempogram(
            rhythm.onset_strength(y, sr, hop), SPEC.tempogram_win_length),
        "scalars": lambda y: scalar_ops.extract_scalars(y, sr, hop, n_fft,
                                                        SPEC.n_mels),
        "hilbert": dft.hilbert_envelope,
        "autocorr": dft.autocorr_full,
        "find_peaks": lambda y: peaks.find_peaks_stats_batched(
            y.abs(), y.abs().mean(dim=-1), sr // 10),
    }


def _elapsed_ms(fn, device: torch.device) -> float:
    """Time of fn() in ms: CUDA events on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def profile_feature_stages(wavs: np.ndarray, chunk: int = 128,
                           device="cuda") -> list[dict]:
    """Time each stage over wavs [N, 16000] in chunks of `chunk` clips (the
    whole set when smaller), after one warm-up chunk. Returns
    [{stage, ms, ms_per_chunk, clips_per_s}], slowest first."""
    from tpu_breath_torch.ops import spectral

    device = resolve_device(device)
    if wavs.shape[0] == 0:
        raise ValueError("no clips to profile")
    stages = feature_stages()
    chunk = min(chunk, wavs.shape[0])
    n_chunks = wavs.shape[0] // chunk
    x = torch.from_numpy(np.ascontiguousarray(
        wavs[:n_chunks * chunk], np.float32)).to(device).reshape(
            n_chunks, chunk, -1)
    rows = []
    for name, f in stages.items():
        with spectral.full_f32():  # as extract_features runs them
            f(x[0])
            ms = _elapsed_ms(lambda: [f(c) for c in x], device)
        rows.append({"stage": name, "ms": ms, "ms_per_chunk": ms / n_chunks,
                     "clips_per_s": n_chunks * chunk / (ms / 1e3)})
        print(f"{name:14s} {rows[-1]['clips_per_s']:10.1f} clips/s "
              f"({ms:.2f} ms for {n_chunks} x {chunk})", flush=True)
    return sorted(rows, key=lambda r: -r["ms"])


def write_feature_profile(profile_dir: str, wavs: np.ndarray,
                          chunk: int = 128, device="cuda") -> str:
    device = resolve_device(device)
    os.makedirs(profile_dir, exist_ok=True)
    rows = profile_feature_stages(wavs, chunk=chunk, device=device)
    chunk = min(chunk, wavs.shape[0])
    path = os.path.join(profile_dir, "feature_stages.json")
    with open(path, "w") as f:
        json.dump({"n_clips": (wavs.shape[0] // chunk) * chunk,
                   "chunk": chunk,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                   "timer": ("cuda events" if device.type == "cuda"
                             else "host clock"),
                   "stages": rows}, f, indent=1)
    return path


@contextlib.contextmanager
def trace(profile_dir: str, device):
    """torch.profiler over the block (CPU activity, and CUDA activity on
    the card); on exit writes profile_dir/trace.json (Chrome trace) and
    profile_dir/ops.txt (top 40 operations by self time on the device)."""
    device = resolve_device(device)
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    key = ("self_device_time_total" if device.type == "cuda"
           else "self_cpu_time_total")
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))


def write_train_profile(profile_dir: str, histories: dict) -> str:
    """{arch: fit history rows} -> train_profile.json: epochs, total wall
    time, the first epoch (cuDNN and kernel set-up included) and the median
    of the later ones."""
    os.makedirs(profile_dir, exist_ok=True)
    out = {}
    for arch, rows in histories.items():
        secs = [r["sec"] for r in rows]
        out[arch] = {
            "epochs": len(secs),
            "total_s": float(sum(secs)),
            "first_epoch_s": secs[0] if secs else None,
            "warm_epoch_median_s": (float(np.median(secs[1:] or secs))
                                    if secs else None),
        }
    path = os.path.join(profile_dir, "train_profile.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return path
