"""Validation-split metrics of the weighted ensemble (counterpart of
tools/ensemble_val.py): given per-arch checkpoints, accuracy, AUC,
precision, recall and F1 on the val split (the seed-42 split of
data/dataset.split_train_val) for each model alone, for the
softmax(val-acc)-weighted blend and for the unweighted average: what the
ensemble buys over its best member.

    python -m tpu_breath_torch.utils.ensemble_val --ckpt cnn8=PATH
        [--ckpt vgg=PATH ...] [--root input] [--device cuda] [--out PATH]

The features come from the port's feature cache under --root
(Paths(root).feature_cache, written by `precompute`); a checkpoint is a
best_epochNNN directory of train/checkpoint.py, its meta.json's val_acc
the member's score. Prints the report as JSON and writes it to --out when
given.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from tpu_breath_torch import ensemble
from tpu_breath_torch.config import Paths
from tpu_breath_torch.data import dataset as ds
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train.metrics import binary_metrics
from tpu_breath_torch.utils import parity_sweep


def _rounded(metrics: dict) -> dict:
    return {k: round(float(v), 6) for k, v in metrics.items()}


def blend_report(probs: list[np.ndarray], scores: list[float],
                 labels: np.ndarray) -> dict:
    """The blends of tools/ensemble_val.py:77-87 over the members'
    probabilities [N] and checkpoint scores: the softmax weights, the
    weighted blend's and the plain average's metrics (6 decimals)."""
    w = ensemble.softmax_weights(scores)
    blend = np.sum([wi * p for wi, p in zip(w, probs)], axis=0)
    return {"weights_softmax": [round(float(x), 6) for x in w],
            "weighted_ensemble": _rounded(binary_metrics(blend, labels)),
            "average_ensemble": _rounded(binary_metrics(
                np.mean(probs, axis=0), labels))}


def validate(ckpts: list[tuple[str, str]], root: str = "input",
             device="cuda") -> dict:
    """ckpts [(arch, checkpoint path)] -> the report: val_n, each member's
    metrics and checkpoint val_acc, and blend_report."""
    device = resolve_device(device)
    train_rows, _ = ds.load_frames(Paths(root=root))
    store = ds.FeatureStore.load_cache(Paths(root=root).feature_cache,
                                       mmap=False)
    _, va_rows = ds.split_train_val(train_rows)
    va = store.subset([r["ID"] for r in va_rows])
    y_va = ds.labels_from_targets([r["Target"] for r in va_rows])
    out = {"val_n": int(len(y_va)), "members": {}}
    probs, scores = [], []
    for arch, path in ckpts:
        score = float(ckpt_lib.load_metadata(path)["val_acc"])
        print(f"[{arch}] {path} (ckpt val_acc {score:.4f})", flush=True)
        model, = ensemble.load_models([path], [arch], va.scalars.shape[1],
                                      device)
        p = ensemble.predict_probs(model, va.features, va.scalars,
                                   device=device)
        m = binary_metrics(p, y_va)
        m["ckpt_val_acc"] = score
        out["members"][arch] = _rounded(m)
        print(f"[{arch}] val: " + " ".join(f"{k}={v:.4f}"
                                           for k, v in m.items()), flush=True)
        probs.append(p)
        scores.append(score)
    out.update(blend_report(probs, scores, y_va))
    out["device"] = parity_sweep.device_label(device)
    print("weighted:", out["weighted_ensemble"], flush=True)
    print("average: ", out["average_ensemble"], flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", action="append", required=True,
                    metavar="ARCH=PATH", help="repeatable; arch=checkpoint")
    ap.add_argument("--root", default="input")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report here")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    ckpts = [tuple(spec.split("=", 1)) for spec in args.ckpt]
    if any(len(c) != 2 for c in ckpts):
        raise SystemExit(f"--ckpt wants ARCH=PATH: {args.ckpt}")
    report = validate(ckpts, args.root, args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"written: {args.out}", flush=True)
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
