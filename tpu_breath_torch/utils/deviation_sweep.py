"""Dataset-level size of the two documented oracle deviations (counterpart
of tools/deviation_sweep.py; PARITY.md §5/§5b), all on the host in NumPy,
through the port's own oracle (baseline/dsp_np.py, baseline/feature_np.py):

(a) the resampler inside the CQT: librosa 0.10's default soxr_hq 2:1
    decimator against the bit-matched res_type='polyphase' the oracle
    ships; soxr is bracketed by the long windowed-sinc decimator
    (dsp_np.resample_half('sinc')), the difference carried through the
    whole chroma channel (chroma_stft rows stacked with CENS, per-row
    z-score) on --n-resample clips drawn by default_rng(0), in float64;
(b) scipy find_peaks' tied-peak order: scipy's unstable argsort priority
    against the card's deterministic order (highest height first, ties to
    the lowest index; greedy_peaks), over every clip: the clips whose
    (n_peaks, mean, std) differ.

    python -m tpu_breath_torch.utils.deviation_sweep [--root input]
        [--n-clips 512] [--n-resample 500] [--device cuda]
        [--out PATH]

With a dataset under --root (train.csv, test.csv and their wavs) the sweep
runs on its train and test clips; otherwise on --n-clips seeded clips
(parity_sweep.seeded_clips), and the report says which. The work is host
NumPy; --device is resolved as every tool of the port resolves it (cuda
demands a card). Prints the report as JSON and writes it to --out when
given: utils/parity_sweep.py --deviations PATH folds it into its report.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import scipy.signal

from tpu_breath_torch.baseline import dsp_np, feature_np
from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
from tpu_breath_torch.config import Paths
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.utils import parity_sweep


def chroma_channel(y: np.ndarray, res_type: str) -> np.ndarray:
    """The oracle's chroma channel (chroma_stft and CENS stacked, each row
    z-scored) with the given CQT decimator, as feature_np.process_clip
    builds it."""
    y = feature_np.pad_or_truncate(np.asarray(y, dtype=np.float32),
                                   SPEC.expected_len)
    stft_m = np.abs(dsp_np.stft(y, SPEC.n_fft, SPEC.hop_length))
    ch = dsp_np.chroma_stft(stft_m, SPEC.sr)
    cens = dsp_np.chroma_cens_librosa(
        y, SPEC.sr, SPEC.hop_length, fmin=SPEC.cqt_fmin,
        bins_per_octave=SPEC.cqt_bins_per_octave,
        n_octaves=SPEC.cqt_n_octaves, win_len_smooth=SPEC.cens_win_len_smooth,
        res_type=res_type)
    return feature_np._znorm_rows(np.vstack([ch, cens])).astype(np.float32)


def greedy_peaks(env: np.ndarray, distance: int) -> tuple[int, float, float]:
    """find_peaks(height=mean, distance) in the card's deterministic order
    (descending height, ties to the LOWEST index): (n_peaks, mean, std) of
    the kept heights."""
    cand, props = scipy.signal.find_peaks(env, height=env.mean())
    h = props["peak_heights"]
    keep = np.ones(len(cand), bool)
    for i in np.argsort(-h, kind="stable"):
        if not keep[i]:
            continue
        j = i - 1
        while j >= 0 and cand[i] - cand[j] < distance:
            keep[j] = False
            j -= 1
        j = i + 1
        while j < len(cand) and cand[j] - cand[i] < distance:
            keep[j] = False
            j += 1
    kept = h[keep]
    n = int(keep.sum())
    return (n, float(np.mean(kept) if n else 0.0),
            float(np.std(kept) if n > 1 else 0.0))


def scipy_peaks(env: np.ndarray, distance: int) -> tuple[int, float, float]:
    """find_peaks(height=mean, distance) as scipy orders it: (n_peaks,
    mean, std) of the kept heights."""
    p, props = scipy.signal.find_peaks(env, height=env.mean(),
                                       distance=distance)
    h = props["peak_heights"] if len(p) else [0]
    return (len(p), float(np.mean(h)),
            float(np.std(h) if len(p) > 1 else 0.0))


def peak_ties(wavs: np.ndarray, sr: int = SPEC.sr) -> dict:
    """(b) over every clip, on the float64 Hilbert envelope, distance
    sr // 10."""
    n_diff = 0
    max_abs = {"n_peaks": 0.0, "mean": 0.0, "std": 0.0}
    for i, w in enumerate(wavs):
        env = np.abs(scipy.signal.hilbert(w.astype(np.float64)))
        a, b = scipy_peaks(env, sr // 10), greedy_peaks(env, sr // 10)
        if a != b:
            n_diff += 1
            for k, x, y in zip(("n_peaks", "mean", "std"), a, b):
                max_abs[k] = max(max_abs[k], abs(x - y))
        if (i + 1) % 1000 == 0:
            print(f"peaks {i + 1}/{len(wavs)}: {n_diff} clips differ",
                  flush=True)
    return {"n_clips": len(wavs), "n_clips_differ": n_diff,
            "frac_differ": n_diff / len(wavs), "max_abs_diff": max_abs}


def resampler(wavs: np.ndarray, n_resample: int) -> dict:
    """(a) on n_resample clips drawn by default_rng(0): the distribution of
    each clip's max abs difference of the z-scored chroma channel."""
    n_rs = min(n_resample, len(wavs))
    sample = np.random.default_rng(0).choice(len(wavs), size=n_rs,
                                             replace=False)
    errs = []
    for j, i in enumerate(sample):
        y64 = wavs[i].astype(np.float64)
        errs.append(float(np.abs(chroma_channel(y64, "polyphase")
                                 - chroma_channel(y64, "sinc")).max()))
        if (j + 1) % 50 == 0:
            print(f"resample {j + 1}/{n_rs}: max so far {max(errs):.3e}",
                  flush=True)
    errs = np.asarray(errs)
    return {"n_clips": n_rs, "max_abs_err": float(errs.max()),
            "p99_abs_err": float(np.percentile(errs, 99)),
            "median_abs_err": float(np.median(errs))}


def sweep(wavs: np.ndarray, n_resample: int) -> dict:
    """The report over wavs [N, 16000] (tools/deviation_sweep.py's keys)."""
    out = {"n_clips_total": len(wavs), "peak_tie": peak_ties(wavs)}
    pt = out["peak_tie"]
    print(f"(b) tied-peak ordering: {pt['n_clips_differ']}/{len(wavs)} "
          f"clips differ, max diffs {pt['max_abs_diff']}", flush=True)
    out["resampler_chroma_channel"] = rs = resampler(wavs, n_resample)
    print(f"(a) resampler -> z-scored chroma channel over {rs['n_clips']} "
          f"clips: max {rs['max_abs_err']:.3e}, p99 {rs['p99_abs_err']:.3e}, "
          f"median {rs['median_abs_err']:.3e}", flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="input",
                    help="dataset root (train.csv, test.csv, train/, test/)"
                         "; without one, seeded clips")
    ap.add_argument("--n-clips", type=int, default=512,
                    help="seeded clips when --root holds no dataset")
    ap.add_argument("--n-resample", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report here")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if os.path.exists(Paths(root=args.root).train_csv):
        wavs, _ = parity_sweep.dataset_clips(args.root)
        inputs = f"dataset {args.root}"
    else:
        wavs, _, _ = parity_sweep.seeded_clips(args.n_clips, 0)
        inputs = f"seeded clips: parity_sweep.seeded_clips({args.n_clips}, 0)"
    report = {"inputs": inputs, **sweep(wavs, args.n_resample)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"written: {args.out}", flush=True)
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
