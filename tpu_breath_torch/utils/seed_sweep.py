"""Multi-seed sweep and its summary (counterpart of tools/seed_sweep.py and
tools/summarize_sweep.py): train each (mode, arch, seed) through the
port's CLI, cached and/or fused, keep each run's history.jsonl, and
aggregate the runs' best epochs.

    python -m tpu_breath_torch.utils.seed_sweep --out DIR [--archs cnn8,vgg]
        [--seeds 0,1,2,3,4] [--modes cached,fused] [--root input]
        [--epochs N] [--device cuda]
    python -m tpu_breath_torch.utils.seed_sweep summarize --dir DIR

The sweep runs `train --root R --out-root DIR/run_<mode>_<arch>_seed<s>
--archs <arch> --seed <s> --mesh off --device D [--epochs N] [--fused]`
for each run, copies that run's checkpoints_torch/<arch>/history.jsonl to
DIR/<mode>_<arch>_seed<s>.jsonl and skips a run whose copy exists (a
retry resumes where it stopped); then writes DIR/SUMMARY.json for the
runs of this invocation (sweep_summary). --epochs 0 (the default) trains
the config's epochs. `summarize` rebuilds DIR/SUMMARY.json from every
*_seed*.jsonl in DIR (summarize), for sweeps of several invocations.
Both write only under the directory given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
import time

import numpy as np

from tpu_breath_torch.device import resolve_device

METRICS = ("epoch", "val_acc", "val_auc", "val_f1")
SUMMARY_METRICS = METRICS + ("val_precision", "val_recall")


def read_history(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def best_row(rows: list[dict]) -> dict:
    """The first epoch of highest val_acc."""
    return rows[max(range(len(rows)), key=lambda i: rows[i]["val_acc"])]


def _stats(rows: list[dict], per_seed: list[dict]) -> dict:
    accs = [r["val_acc"] for r in rows]
    return {"n_seeds": len(rows),
            "val_acc_mean": float(np.mean(accs)),
            "val_acc_std": float(np.std(accs)),
            "val_acc_best": float(np.max(accs)),
            "val_auc_best": float(np.max([r["val_auc"] for r in rows])),
            "val_f1_best": float(np.max([r["val_f1"] for r in rows])),
            "per_seed": per_seed}


def history_name(mode: str, arch: str, seed: int) -> str:
    return f"{mode}_{arch}_seed{seed}.jsonl"


def sweep_summary(out: str, runs: list[tuple[str, str, int]]) -> dict:
    """tools/seed_sweep.py's summary of `runs` [(mode, arch, seed)] from
    their histories under out: per mode and arch, the statistics of each
    seed's best epoch, with its epoch, val_acc, val_auc and val_f1."""
    summary = {}
    for mode, arch, _ in runs:
        key = f"{mode}_{arch}"
        if key in summary:
            continue
        best = [best_row(read_history(p)) for p in
                (os.path.join(out, history_name(mode, arch, s))
                 for m, a, s in runs if (m, a) == (mode, arch))
                if os.path.exists(p)]
        if best:
            summary[key] = _stats(best, [{k: r[k] for k in METRICS}
                                         for r in best])
    return summary


def summarize(directory: str) -> dict:
    """tools/summarize_sweep.py's aggregate of every <mode>_<arch>_seed<s>
    .jsonl in directory: per mode and arch, the statistics of each seed's
    best epoch, with its seed, epochs run and paper metrics, by seed."""
    runs: dict = {}
    for p in sorted(glob.glob(os.path.join(directory, "*_seed*.jsonl"))):
        m = re.match(r"(\w+)_(\w+)_seed(\d+)\.jsonl", os.path.basename(p))
        if not m:
            continue
        rows = read_history(p)
        best = best_row(rows)
        runs.setdefault(f"{m.group(1)}_{m.group(2)}", []).append(
            {"seed": int(m.group(3)), "epochs_run": len(rows),
             **{k: best[k] for k in SUMMARY_METRICS if k in best}})
    return {key: _stats(rows, sorted(rows, key=lambda r: r["seed"]))
            for key, rows in runs.items()}


def disagreements(a, b, path: str = "") -> list[str]:
    """Where two summaries differ on a key both hold, at any depth (lists
    element by element)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in a.keys() & b.keys()
                for d in disagreements(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: {len(a)} != {len(b)} entries"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in disagreements(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def write_summary(path: str, summary: dict) -> None:
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)


def run_sweep(out: str, archs: list[str], seeds: list[int],
              modes: list[str], root: str = "input", epochs: int = 0,
              device: str = "cuda") -> dict:
    """The sweep (see the module docstring); returns its summary, also
    written to out/SUMMARY.json."""
    from tpu_breath_torch import cli

    resolve_device(device)
    os.makedirs(out, exist_ok=True)
    runs = [(m, a, s) for m in modes for a in archs for s in seeds]
    for mode, arch, seed in runs:
        hist_dst = os.path.join(out, history_name(mode, arch, seed))
        if os.path.exists(hist_dst):
            print(f"[sweep] skip {hist_dst} (done)", flush=True)
            continue
        out_root = os.path.join(out, f"run_{mode}_{arch}_seed{seed}")
        t0 = time.time()
        print(f"[sweep] start {mode} {arch} seed {seed}", flush=True)
        argv = ["train", "--root", root, "--out-root", out_root, "--archs",
                arch, "--seed", str(seed), "--mesh", "off", "--device",
                device]
        if epochs:
            argv += ["--epochs", str(epochs)]
        if mode == "fused":
            argv.append("--fused")
        cli.main(argv)
        shutil.copyfile(os.path.join(cli.ckpt_dir(out_root, arch),
                                     "history.jsonl"), hist_dst)
        rows = read_history(hist_dst)
        print(f"[sweep] done {mode} {arch} seed {seed}: best val acc "
              f"{best_row(rows)['val_acc']:.4f} ({time.time() - t0:.0f}s, "
              f"{len(rows)} epochs)", flush=True)
    summary = sweep_summary(out, runs)
    write_summary(os.path.join(out, "SUMMARY.json"), summary)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default="cnn8,vgg")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--modes", default="cached,fused")
    ap.add_argument("--root", default="input")
    ap.add_argument("--out", required=True,
                    help="directory of the runs, their histories and "
                         "SUMMARY.json")
    ap.add_argument("--epochs", type=int, default=0,
                    help="passed on to train --epochs (0: the config's)")
    ap.add_argument("--device", default="cuda")
    return ap


def build_summarize_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="seed_sweep summarize",
        description="rebuild DIR/SUMMARY.json from every *_seed*.jsonl")
    ap.add_argument("--dir", required=True)
    return ap


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["summarize"]:
        args = build_summarize_parser().parse_args(argv[1:])
        summary = summarize(args.dir)
        out = os.path.join(args.dir, "SUMMARY.json")
        write_summary(out, summary)
        print(json.dumps({k: {kk: vv for kk, vv in v.items()
                              if kk != "per_seed"}
                          for k, v in summary.items()}, indent=1))
        print(f"written: {out}")
        return summary
    args = build_parser().parse_args(argv)
    summary = run_sweep(args.out, args.archs.split(","),
                        [int(s) for s in args.seeds.split(",")],
                        args.modes.split(","), args.root, args.epochs,
                        args.device)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
