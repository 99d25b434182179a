"""Find and diagnose bpo-12 tuning flips (counterpart of tools/flip_hunt.py):
the device's tuning estimate at 12 bins an octave against the oracle's on
a seeded sample of clips, and for a clip where they differ, where the two
chains part (S, the pitch mask, the median threshold, the residual
histogram).

    python -m tpu_breath_torch.utils.flip_hunt [--root input]
        [--n-clips 512] [--device cuda] [--out PATH]

find_flips draws the sample as the JAX tool does (default_rng(0), 500
clips without replacement; every clip when there are fewer than 500).
The device side is the feature graph's own: the round-once |STFT_512| and
ops/chroma.py's tuning (kernel A on the card), in chunks
(parity_sweep.device_tunings); the oracle side baseline/dsp_np.py's
estimate_tuning_from_S on |stft| of the clip in float64. With a dataset
under --root the hunt runs on its train and test clips, otherwise on
--n-clips seeded clips (parity_sweep.seeded_clips). Prints the flips and
each flip's diagnose() as JSON, and writes them to --out when given.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu_breath_torch.baseline import dsp_np
from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
from tpu_breath_torch.config import Paths
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.ops import chroma, select, spectral
from tpu_breath_torch.utils import parity_sweep

SAMPLE = 500
TOL = 1e-6


def sample_indices(n: int) -> np.ndarray:
    """The clips the JAX tool draws: default_rng(0).choice(n, 500, no
    replacement), or all n when n < 500."""
    if n < SAMPLE:
        return np.arange(n)
    return np.random.default_rng(0).choice(n, size=SAMPLE, replace=False)


def oracle_spectrum(wav: np.ndarray) -> np.ndarray:
    """|stft| of the clip in float64, the oracle's S [257, 63]."""
    return np.abs(dsp_np.stft(wav.astype(np.float64), SPEC.n_fft,
                              SPEC.hop_length))


def find_flips(wavs: np.ndarray, ids: list[str], device="cuda"
               ) -> list[dict]:
    """The sampled clips whose device bpo-12 tuning differs from the
    oracle's by more than 1e-6: [{sample, index, id, oracle, device}]."""
    device = resolve_device(device)
    sample = sample_indices(len(wavs))
    t_dev = parity_sweep.device_tunings(wavs[sample], SPEC, device)[0]
    flips = []
    for j, i in enumerate(sample):
        t_o = dsp_np.estimate_tuning_from_S(oracle_spectrum(wavs[i]),
                                            SPEC.sr, SPEC.n_fft, 12)
        if abs(float(t_dev[j]) - t_o) > TOL:
            flips.append({"sample": j, "index": int(i), "id": ids[i],
                          "oracle": float(t_o), "device": float(t_dev[j])})
            print(f"FLIP sample={j} idx={i} id={ids[i]} oracle={t_o} "
                  f"device={float(t_dev[j])}", flush=True)
    print(f"{len(flips)} flips / {len(sample)}", flush=True)
    return flips


def residual_counts(pitches: np.ndarray, bpo: int = 12) -> np.ndarray:
    """The tuning histogram (100 bins over [-0.5, 0.5)) of the selected
    pitches, with the oracle's f32 casts."""
    f = pitches[pitches > 0].astype(np.float32)
    q = np.float32(f.astype(np.float64) / 27.5)
    octs = np.float32(np.log2(q.astype(np.float64)))
    r = np.mod(np.float32(bpo) * octs, np.float32(1.0))
    r[r >= 0.5] -= np.float32(1.0)
    return np.histogram(r, np.linspace(-0.5, 0.5, 101))[0]


def oracle_pieces(S: np.ndarray) -> dict:
    """The oracle's tuning chain on S [F, T]: piptrack's pitches and mags,
    the pitch mask, the median threshold, the selection, the histogram and
    the tuning."""
    pitches, mags = dsp_np.piptrack(S, SPEC.sr, SPEC.n_fft)
    mask = pitches > 0
    thr = float(np.median(mags[mask])) if mask.any() else 0.0
    sel = (mags >= thr) & mask
    return {"pitches": pitches, "mags": mags, "mask": mask, "thr": thr,
            "sel": sel, "counts": residual_counts(pitches[sel]),
            "tuning": dsp_np.estimate_tuning_from_S(S, SPEC.sr, SPEC.n_fft,
                                                    12)}


@torch.no_grad()
def device_pieces(S: torch.Tensor) -> dict:
    """The same chain by the port's ops on S [F, T] on its device:
    piptrack on the candidate band (zeros elsewhere, as the oracle's), the
    masked median (ops/select.py), the tuning (kernel A on the card)."""
    p_band, m_band = chroma._piptrack_band(S[None], SPEC.sr, SPEC.n_fft)
    lo, hi = chroma._band_rows(S.shape[0], SPEC.sr)
    pitches = torch.zeros_like(S).index_copy(
        0, torch.arange(lo, hi, device=S.device), p_band[0])
    mags = torch.zeros_like(S).index_copy(
        0, torch.arange(lo, hi, device=S.device), m_band[0])
    mask = pitches > 0
    thr = float(select.masked_median(mags.reshape(1, -1),
                                     mask.reshape(1, -1))[0])
    p, m, mask = (t.cpu().numpy() for t in (pitches, mags, mask))
    sel = (m >= thr) & mask
    return {"pitches": p, "mags": m, "mask": mask, "thr": thr, "sel": sel,
            "counts": residual_counts(p[sel]),
            "tuning": float(chroma.estimate_tuning(S[None], SPEC.sr,
                                                   SPEC.n_fft, 12)[0])}


def _top(counts: np.ndarray) -> list[list[int]]:
    return [[int(b), int(counts[b])] for b in np.argsort(counts)[-4:][::-1]]


def diagnose(wav: np.ndarray, device="cuda") -> dict:
    """Where the device's and the oracle's bpo-12 tuning chains part on one
    clip (tools/flip_hunt.py:58-105): the S difference, each side's pitch
    count, threshold, selection and tuning, whether the pitch masks agree,
    the top histogram bins and the bins whose counts differ."""
    device = resolve_device(device)
    S_o = oracle_spectrum(wav).astype(np.float32)
    with spectral.full_f32():
        S_d = spectral.stft_mag_cr(torch.from_numpy(np.ascontiguousarray(
            wav, np.float32)).to(device)[None], SPEC.n_fft,
            SPEC.hop_length)[0]
        dev = device_pieces(S_d)
    ora = oracle_pieces(S_o)
    S_d = S_d.cpu().numpy()
    diff = np.nonzero(ora["counts"] != dev["counts"])[0]
    return {
        "s_max_abs_diff": float(np.max(np.abs(S_o - S_d))),
        "s_n_mismatched": int(np.sum(S_o != S_d)), "s_size": int(S_o.size),
        **{side: {"n_pitch": int(p["mask"].sum()), "thr": p["thr"],
                  "n_sel": int(p["sel"].sum()), "tuning": p["tuning"],
                  "top_bins": _top(p["counts"])}
           for side, p in (("oracle", ora), ("device", dev))},
        "pitch_mask_agree": bool(np.array_equal(ora["mask"], dev["mask"])),
        "bins_differ": [[int(b), int(ora["counts"][b]), int(dev["counts"][b])]
                        for b in diff],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="input",
                    help="dataset root (train.csv, test.csv, train/, test/)"
                         "; without one, seeded clips")
    ap.add_argument("--n-clips", type=int, default=512,
                    help="seeded clips when --root holds no dataset")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report here")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if os.path.exists(Paths(root=args.root).train_csv):
        wavs, ids = parity_sweep.dataset_clips(args.root)
        inputs = f"dataset {args.root}"
    else:
        wavs, ids, _ = parity_sweep.seeded_clips(args.n_clips, 0)
        inputs = f"seeded clips: parity_sweep.seeded_clips({args.n_clips}, 0)"
    flips = find_flips(wavs, ids, device)
    report = {"inputs": inputs, "n_sampled": len(sample_indices(len(wavs))),
              "device": parity_sweep.device_label(device), "flips": flips,
              "diagnoses": [diagnose(wavs[f["index"]], device)
                            for f in flips]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
