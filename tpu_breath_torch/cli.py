"""Command line of the port (counterpart of tpu_breath/cli.py).

Only the serving path is ported:

    python -m tpu_breath_torch predict --from-wav a.wav b.wav --archs cnn8 \
        [--out-root DIR] [--device cuda|cpu]

Checkpoints are read from <out-root>/checkpoints_torch/<arch>/ and the
predictions written to <out-root>/submissions/from_wav_predictions.csv.
"""
from __future__ import annotations

import argparse
import os

import torch

from tpu_breath.config import DEFAULT_FEATURES
from tpu_breath.data import wav as wav_io
from tpu_breath_torch import ensemble
from tpu_breath_torch.train import checkpoint as ckpt_lib

CKPT_DIRNAME = "checkpoints_torch"


def ckpt_dir(out_root: str, arch: str) -> str:
    return os.path.join(out_root, CKPT_DIRNAME, arch)


def resolve_device(name: str) -> torch.device:
    """'cuda' demands a card (no silent CPU fallback); 'cpu' runs the plain
    versions of the kernels."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    return torch.device(name)


def _load_ensemble_ckpts(out_root: str, archs: list[str]):
    ckpts, scores = [], []
    for arch in archs:
        path = ckpt_lib.latest_checkpoint(ckpt_dir(out_root, arch))
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for {arch} under {ckpt_dir(out_root, arch)}")
        ckpts.append(path)
        scores.append(ckpt_lib.load_metadata(path)["val_acc"])
    return ckpts, scores


def cmd_predict(args) -> None:
    if not args.from_wav:
        raise SystemExit("predict: only --from-wav is ported so far")
    device = resolve_device(args.device)
    spec = DEFAULT_FEATURES
    archs = args.archs.split(",")
    ckpts, scores = _load_ensemble_ckpts(args.out_root, archs)
    errors: list = []
    wavs = wav_io.load_wav_batch(args.from_wav, spec.expected_len,
                                 errors=errors)
    for path, msg in errors:
        print(f"error: {path}: {msg}")
    probs = ensemble.serve_from_wav(ckpts, archs, scores, wavs, spec,
                                    device=device)
    for path, p in zip(args.from_wav, probs):
        print(f"{path}\t{'E' if p > 0.5 else 'I'}\t{p:.4f}")
    out = os.path.join(args.out_root, "submissions",
                       "from_wav_predictions.csv")
    ensemble.write_submission(args.from_wav, probs, out)
    print(f"predictions written: {out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_breath_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("predict")
    sp.add_argument("--out-root", dest="out_root", default=".")
    sp.add_argument("--archs", default="cnn8")
    sp.add_argument("--from-wav", dest="from_wav", nargs="+", default=None,
                    metavar="FILE", help="classify wav file(s) directly")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
