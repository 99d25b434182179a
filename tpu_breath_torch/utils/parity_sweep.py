"""The port's parity sweep (counterpart of tools/parity_sweep.py): the
feature graph on a device against the port's own NumPy oracle
(baseline/feature_np.process_clip), clip by clip.

The device runs extract_features_batched (chunks of 128) over every clip,
and the two tuning estimates on the same S the graph builds (kernel A on
the card): bpo 12 on the round-once |STFT_512|, bpo 36 on the even frames
of |STFT_2048| at hop 256 (ops/cqt.py::chroma_cens). A seeded sample of
the clips goes through the oracle, with the oracle's two tunings, in a
pool of processes started by `spawn` (a forked child of a process that
holds a CUDA context is broken).

The oracle's sample holds the seeded set's golden wavs, silence, impulse
and quantized clip always (oracle_sample). The report keeps
PARITY_SWEEP.json's keys: per channel the distribution
over the sampled clips of each clip's max abs error, the scalars' max rel
error (floor 1e-2), the tuning flip rates, and each flip with its tie
width (tie_width). It adds the same statistics over the real clips with
no flip (`*_unflipped`, which envelope_misses holds to PARITY.md's
envelope) and over the synthetic clips (`*_synthetic`), the NaN-mask
mismatches, the oracle's clips/s in one process and the device.

Synthetic clips (silence, an impulse, quantized plateaus, white noise)
lie outside the envelope's evidence, which is real stethoscope clips:
there the port's CPU path and the JAX package both miss it, on
ill-conditioned quantities (a z-scored constant row, an argmin over an
exactly-zero autocorrelation, the skew of a near-constant spectral
centroid; tests/test_torch_parity_sweep.py). Their NaN masks and flips are
gated, their errors reported.

NaNs: silence z-scores a constant CENS row to 0/0, on both sides. The
masks of the non-finite entries are compared per clip and channel (a
mismatch is counted) and the errors are taken over the entries finite on
both sides.

    python -m tpu_breath_torch.utils.parity_sweep [--root input]
        [--n-clips 512] [--n-oracle 128] [--seed 0] [--out R.json]
        [--device cuda] [--fused-gt] [--deviations PATH]

With a dataset under --root (train.csv, test.csv and their wavs) the
sweep runs on its train and test clips; otherwise on --n-clips seeded
clips (seeded_clips). Prints the report as JSON, writes it to --out when
given, and exits 1 when the report misses the envelope. --deviations
PATH folds in a report of utils/deviation_sweep.py as
`documented_deviations` (null without one).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from tpu_breath_torch.baseline import dsp_np, feature_np
from tpu_breath_torch.config import DEFAULT_FEATURES, FeatureSpec, Paths
from tpu_breath_torch.data import dataset as ds
from tpu_breath_torch.data import wav as wav_io
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.features import extract_features_batched
from tpu_breath_torch.ops import chroma, spectral
from tpu_breath_torch.utils.kernel_times import clip_set, golden

CHUNK = 128
# PARITY.md's envelope of the JAX package against the oracle on real
# clips: every channel's max abs error, the scalars' max rel error
ENVELOPE_ABS = 2.3e-4
ENVELOPE_REL = 6.9e-4
REL_FLOOR = 1e-2
# a flip whose oracle histogram leads by more than this many counts is not
# the documented class (one residual moved by |S| rounding; PARITY.md)
MAX_TIE_WIDTH = 1
SET_NAMES = ("golden0", "golden1", "silence", "impulse", "quantized")
# one BLAS thread in each oracle process: with a process a core, more only
# contend (8 processes of 8 threads ran 4-5x slower on an 8-core host)
ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                               "MKL_NUM_THREADS")}


def seeded_clips(n: int, seed: int
                 ) -> tuple[np.ndarray, list[str], np.ndarray]:
    """n clips [n, 16000], their names and which are synthetic: clip_set's
    first max(5, n // 4) (the golden wavs, then the synthetic silence,
    impulse, quantized clip and noise of loudness 1e-3 to 0.3), then
    circular shifts of the two golden wavs by seeded offsets at seeded
    gains (0.1 to 3): real stethoscope spectra in a new framing."""
    n_set = min(n, max(len(SET_NAMES), n // 4))
    clips = list(clip_set(n_set, seed))
    names = [SET_NAMES[i] if i < len(SET_NAMES) else f"noise{i}"
             for i in range(n_set)]
    gold = [d["wav"] for d in golden()]
    synthetic = (np.arange(n) >= len(gold)) & (np.arange(n) < n_set)
    rng = np.random.default_rng([seed, 1])
    for i in range(n - n_set):
        g = i % len(gold)
        shift = int(rng.integers(1, len(gold[g])))
        gain = 10.0 ** rng.uniform(-1.0, 0.5)
        clips.append(np.roll(gold[g], shift) * gain)
        names.append(f"golden{g}_shift{shift}_gain{gain:.3f}")
    return np.stack(clips).astype(np.float32), names, synthetic


def dataset_clips(root: str, spec: FeatureSpec = DEFAULT_FEATURES
                  ) -> tuple[np.ndarray, list[str]]:
    """The dataset's train and test clips under root, decoded as precompute
    decodes them."""
    ids, wav_paths = ds.dataset_wavs(Paths(root=root))
    return wav_io.load_wav_batch(wav_paths, spec.expected_len), ids


def oracle_clip(wav: np.ndarray, spec: FeatureSpec = DEFAULT_FEATURES
                ) -> dict:
    """One clip through the oracle: process_clip's dict, the oracle's
    tunings at bpo 12 and 36 (tools/parity_sweep.py:102-119) and the
    seconds process_clip took."""
    t0 = time.perf_counter()
    out = feature_np.process_clip(wav, spec)
    out["seconds"] = time.perf_counter() - t0
    y = wav.astype(np.float64)
    stft_m = np.abs(dsp_np.stft(y, spec.n_fft, spec.hop_length))
    out["t12"] = dsp_np.estimate_tuning_from_S(stft_m, spec.sr, spec.n_fft, 12)
    out["t36"] = dsp_np.estimate_tuning_from_y(y, spec.sr, 36)
    return out


def tie_width(S_o: np.ndarray, bpo: int, sr: float, n_fft: int) -> int:
    """The oracle histogram's top-1 minus top-2 count, for a flip's
    post-mortem (tools/parity_sweep.py:84-100): 0 means the argmax was a
    pure tie-break, 1 that one moved residual decides it (the only flips
    |S| rounding noise can cause). The f32 casts are the oracle's."""
    pitches, mags = dsp_np.piptrack(S_o, sr, n_fft)
    mask = pitches > 0
    thr = np.median(mags[mask]) if mask.any() else 0.0
    f = pitches[(mags >= thr) & mask]
    f = f[f > 0].astype(np.float32)
    q = np.float32(f.astype(np.float64) / 27.5)
    octs = np.float32(np.log2(q.astype(np.float64)))
    r = np.mod(np.float32(bpo) * octs, np.float32(1.0))
    r[r >= 0.5] -= np.float32(1.0)
    counts, _ = np.histogram(r, np.linspace(-0.5, 0.5, 101))
    top = np.sort(counts)[-2:]
    return int(top[1] - top[0])


@torch.no_grad()
def device_tunings(wavs: np.ndarray, spec: FeatureSpec, device
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The tunings at bpo 12 and 36 [N] from the port's ops on the S the
    feature graph builds (tools/parity_sweep.py:73-82), in chunks."""
    t12, t36 = [], []
    with spectral.full_f32():
        for lo in range(0, len(wavs), CHUNK):
            y = torch.from_numpy(np.ascontiguousarray(
                wavs[lo:lo + CHUNK], np.float32)).to(device)
            s512 = spectral.stft_mag_cr(y, spec.n_fft, spec.hop_length)
            t12.append(chroma.estimate_tuning(s512, spec.sr, spec.n_fft, 12))
            s2048 = spectral.stft_mag(y, 2048, spec.hop_length)[..., ::2]
            t36.append(chroma.estimate_tuning(s2048, spec.sr, 2048, 36))
    return (torch.cat(t12).cpu().numpy(), torch.cat(t36).cpu().numpy())


def _masked_err(dev: np.ndarray, ora: np.ndarray, floor: float | None
                ) -> tuple[float, bool]:
    """(max abs error, or rel with the floor, over the entries finite on
    both sides; whether the non-finite masks differ)."""
    bad_d, bad_o = ~np.isfinite(dev), ~np.isfinite(ora)
    ok = ~(bad_d | bad_o)
    err = np.abs(dev[ok] - ora[ok])
    if floor is not None:
        err = err / np.maximum(np.abs(ora[ok]), floor)
    return (float(err.max()) if err.size else 0.0,
            not np.array_equal(bad_d, bad_o))


def compare_clip(feats: np.ndarray, scals: np.ndarray, out: dict,
                 spec: FeatureSpec = DEFAULT_FEATURES
                 ) -> tuple[dict, float, list[str]]:
    """One clip's device features [9, 128, 63] and scalars [36] against the
    oracle's dict: (max abs error per channel, the scalars' max rel error,
    the names, channels or "scalars", whose NaN masks differ)."""
    errs, mismatched = {}, []
    for c, name in enumerate(spec.channel_order):
        errs[name], differ = _masked_err(feats[c], out[name], None)
        if differ:
            mismatched.append(name)
    rel, differ = _masked_err(scals, out["scalars"], REL_FLOOR)
    if differ:
        mismatched.append("scalars")
    return errs, rel, mismatched


def worst_scalar(dev: np.ndarray, ora: np.ndarray, clip_id: str,
                  synthetic: bool) -> dict:
    """A clip's scalar farthest from the oracle (rel, floor 1e-2, over the
    entries finite on both sides): where a miss comes from."""
    ok = np.isfinite(dev) & np.isfinite(ora)
    rel = np.where(ok, np.abs(dev - ora) / np.maximum(np.abs(ora), REL_FLOOR),
                   0.0)
    j = int(np.argmax(rel))
    return {"id": clip_id, "synthetic": synthetic, "scalar": j,
            "device": float(dev[j]), "oracle": float(ora[j]),
            "rel": float(rel[j])}


def stats(values) -> dict | None:
    if not len(values):
        return None
    v = np.asarray(values)
    return {"max": float(v.max()), "p99": float(np.percentile(v, 99)),
            "p50": float(np.percentile(v, 50)), "mean": float(v.mean())}


def device_label(device: torch.device) -> str:
    """The card's `nvidia-smi` name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def oracle_sample(ids: list[str], n_oracle: int, seed: int) -> np.ndarray:
    """The clips named in SET_NAMES (so that silence's NaNs are compared on
    every seeded run), then a seeded choice of the rest: n_oracle in all."""
    fixed = [i for i, name in enumerate(ids) if name in SET_NAMES][:n_oracle]
    rest = np.setdiff1d(np.arange(len(ids)), fixed)
    rng = np.random.default_rng(seed)
    extra = rng.choice(rest, size=min(n_oracle - len(fixed), len(rest)),
                       replace=False)
    return np.concatenate([np.asarray(fixed, int), extra.astype(int)])


def clip_flips(wav: np.ndarray, out: dict, t12: float, t36: float,
               clip_id: str, spec: FeatureSpec = DEFAULT_FEATURES
               ) -> list[dict]:
    """The device tunings of a clip that differ from the oracle's (by more
    than 1e-6), each with the oracle histogram's tie width."""
    flips = []
    y = wav.astype(np.float64)
    for bpo, t_dev in ((12, t12), (36, t36)):
        t_o = out[f"t{bpo}"]
        if abs(float(t_dev) - t_o) <= 1e-6:
            continue
        # bpo 36's S: |stft(y, 2048, 512)| (piptrack's defaults in
        # estimate_tuning_from_y); the device reads the same frames
        n_fft, hop = ((spec.n_fft, spec.hop_length) if bpo == 12
                      else (2048, 512))
        S_o = np.abs(dsp_np.stft(y, n_fft, hop))
        flips.append({"id": clip_id, "bpo": bpo, "t_oracle": float(t_o),
                      "t_device": float(t_dev),
                      "tie_width": tie_width(S_o, bpo, spec.sr, n_fft)})
    return flips


def make_report(wavs: np.ndarray, ids: list[str], synthetic: np.ndarray,
                sample: np.ndarray, oracle: list[dict], feats: np.ndarray,
                scals: np.ndarray, tunings: tuple[np.ndarray, np.ndarray],
                spec: FeatureSpec = DEFAULT_FEATURES) -> dict:
    """The report of one device run (feats, scals) and the device tunings
    against the oracle's dicts of the sampled clips."""
    rows, flips, mismatches, worst = [], [], [], []
    for i, out in zip(sample, oracle):
        errs, rel, mismatched = compare_clip(feats[i], scals[i], out, spec)
        mine = clip_flips(wavs[i], out, tunings[0][i], tunings[1][i], ids[i],
                          spec)
        flips += mine
        mismatches += [{"id": ids[i], "channel": m} for m in mismatched]
        worst.append(worst_scalar(scals[i], out["scalars"], ids[i],
                                   bool(synthetic[i])))
        rows.append((errs, rel, bool(synthetic[i]), bool(mine)))

    def group(keep) -> tuple[dict, dict | None]:
        """Per channel and for the scalars, the statistics over the sampled
        clips for which keep(synthetic, flipped) holds."""
        chosen = [(e, r) for e, r, syn, flipped in rows if keep(syn, flipped)]
        return ({k: stats([e[k] for e, _ in chosen])
                 for k in spec.channel_order},
                stats([r for _, r in chosen]))

    channels, scalars = group(lambda syn, flipped: True)
    channels_unflipped, scalars_unflipped = group(
        lambda syn, flipped: not syn and not flipped)
    channels_synthetic, scalars_synthetic = group(lambda syn, flipped: syn)
    n = len(sample)
    seconds = sum(out["seconds"] for out in oracle)
    return {
        "n_total": len(ids),
        "n_oracle_sampled": n,
        "channel_max_abs_err": channels,
        "scalar_max_rel_err": scalars,
        "tuning_flip_rate_bpo12": sum(f["bpo"] == 12 for f in flips) / n,
        "tuning_flip_rate_bpo36": sum(f["bpo"] == 36 for f in flips) / n,
        "tuning_flips": flips,
        # utils/deviation_sweep.py's report, folded in by main's
        # --deviations (tools/parity_sweep.py:157-164)
        "documented_deviations": None,
        "n_oracle_synthetic": int(np.count_nonzero(synthetic[sample])),
        "channel_max_abs_err_unflipped": channels_unflipped,
        "scalar_max_rel_err_unflipped": scalars_unflipped,
        "channel_max_abs_err_synthetic": channels_synthetic,
        "scalar_max_rel_err_synthetic": scalars_synthetic,
        "nan_mask_mismatches": len(mismatches),
        "nan_mask_mismatched": mismatches,
        "scalar_worst": sorted(worst, key=lambda w: -w["rel"])[:8],
        "oracle_clips_per_s": n / seconds if seconds > 0 else None,
    }


@contextlib.contextmanager
def environ(env: dict):
    """os.environ updated with env inside the block (the processes started
    there inherit it), restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sweeps(wavs: np.ndarray, ids: list[str], n_oracle: int, seed: int,
           device="cuda", fused_gts=(False,), workers: int | None = None,
           synthetic: np.ndarray | None = None,
           spec: FeatureSpec = DEFAULT_FEATURES) -> list[dict]:
    """One report per entry of fused_gts (kernel B, or B'' when true), every
    device run held against one oracle run on n_oracle clips
    (oracle_sample). synthetic: which clips are synthetic (default none).
    The oracle's processes (workers, default one a CPU core) work while the
    device runs."""
    if not 1 <= n_oracle:
        raise ValueError(f"n_oracle {n_oracle}: want at least one clip")
    device = resolve_device(device)
    if synthetic is None:
        synthetic = np.zeros(len(ids), bool)
    sample = oracle_sample(ids, n_oracle, seed)
    if workers is None:
        workers = max(1, min(len(sample), len(os.sched_getaffinity(0))))
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        with environ(ONE_THREAD):  # the processes start at the submits
            futures = [pool.submit(oracle_clip, wavs[i], spec)
                       for i in sample]
        runs = [extract_features_batched(wavs, spec, chunk=CHUNK,
                                         device=device, fused_gt=gt)
                for gt in fused_gts]
        tunings = device_tunings(wavs, spec, device)
        oracle = [f.result() for f in futures]
    finally:
        pool.shutdown(cancel_futures=True)
    oracle_wall_s = time.perf_counter() - t0
    label = device_label(device)
    reports = []
    for gt, (feats, scals) in zip(fused_gts, runs):
        rep = make_report(wavs, ids, synthetic, sample, oracle, feats, scals,
                          tunings, spec)
        rep.update(device=label, fused_gt=bool(gt), seed=seed,
                   oracle_workers=workers, oracle_wall_s=oracle_wall_s)
        reports.append(rep)
    return reports


def sweep(wavs: np.ndarray, ids: list[str], n_oracle: int, seed: int,
          device="cuda", fused_gt: bool = False, workers: int | None = None,
          synthetic: np.ndarray | None = None) -> dict:
    """The report of one device run (see sweeps)."""
    return sweeps(wavs, ids, n_oracle, seed, device, (fused_gt,), workers,
                  synthetic)[0]


def envelope_misses(report: dict) -> list[str]:
    """What the report misses: a NaN-mask mismatch; on the real clips with
    no tuning flip, a channel above ENVELOPE_ABS or the scalars above
    ENVELOPE_REL; a flip with a tie width above MAX_TIE_WIDTH."""
    misses = []
    if report["nan_mask_mismatches"]:
        misses.append(f"NaN masks differ: {report['nan_mask_mismatched']}")
    for name, st in report["channel_max_abs_err_unflipped"].items():
        if st is not None and not st["max"] <= ENVELOPE_ABS:
            misses.append(f"{name} max abs {st['max']:.3g} > {ENVELOPE_ABS}")
    st = report["scalar_max_rel_err_unflipped"]
    if st is not None and not st["max"] <= ENVELOPE_REL:
        misses.append(f"scalars max rel {st['max']:.3g} > {ENVELOPE_REL}")
    misses += [f"flip {f}" for f in report["tuning_flips"]
               if f["tie_width"] > MAX_TIE_WIDTH]
    return misses


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="input",
                    help="dataset root (train.csv, test.csv, train/, test/)"
                         "; without one, seeded clips")
    ap.add_argument("--n-clips", type=int, default=512,
                    help="seeded clips when --root holds no dataset")
    ap.add_argument("--n-oracle", type=int, default=128,
                    help="clips to re-derive with the (slow) NumPy oracle")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused-gt", action="store_true",
                    help="the gammatone channel by kernel B'' (default B)")
    ap.add_argument("--deviations", default=None, metavar="PATH",
                    help="a report of utils/deviation_sweep.py, folded in "
                         "as documented_deviations")
    args = ap.parse_args(argv)
    if os.path.exists(Paths(root=args.root).train_csv):
        wavs, ids = dataset_clips(args.root)
        synthetic = None
    else:
        wavs, ids, synthetic = seeded_clips(args.n_clips, args.seed)
    report = sweep(wavs, ids, args.n_oracle, args.seed, args.device,
                   args.fused_gt, synthetic=synthetic)
    if args.deviations:
        with open(args.deviations) as f:
            report["documented_deviations"] = json.load(f)
    misses = envelope_misses(report)
    report["envelope_misses"] = misses
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
