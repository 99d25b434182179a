"""The reference's features of many clips: features_np.process_clip in a
pool of spawned processes (a forked child of a process that holds a CUDA
context breaks), one BLAS thread each, one process a host core."""
from __future__ import annotations

import contextlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                               "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS")}


@contextlib.contextmanager
def _environ(env: dict):
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


def _clips(wavs: np.ndarray, features: dict) -> tuple[np.ndarray, np.ndarray]:
    from breathbench.reference import features_np, spec as spec_lib

    spec = spec_lib.from_config(features)
    out = [features_np.process_clip(w, spec) for w in wavs]
    feats = np.stack([np.stack([o[k] for k in spec.channel_order])
                      for o in out])
    return feats, np.stack([o["scalars"] for o in out])


def features(wavs: np.ndarray, features: dict, workers: int | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
    """(features [n, C, H, T], scalars [n, S]) float32 of clips wavs [n,
    samples], by the oracle; workers 0 runs in this process."""
    workers = os.cpu_count() if workers is None else workers
    if workers == 0 or len(wavs) <= 1:
        return _clips(wavs, features)
    parts = np.array_split(wavs, min(len(wavs), 4 * workers))
    with _environ(ONE_THREAD), ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = [f.result() for f in
                [pool.submit(_clips, p, features) for p in parts]]
    return (np.concatenate([d[0] for d in done]),
            np.concatenate([d[1] for d in done]))
