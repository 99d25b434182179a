"""CSV handling, ID <-> wav mapping, the seed-42 split and the feature store
(counterpart of tpu_breath/data/dataset.py, without pandas or sklearn).

The whole feature set lives in memory as dense arrays ([N, 9, 128, 63] and
[N, 36] float32); training moves it to the device once. Two formats:
- the flat cache: features.npy / scalars.npy / ids.txt / meta.json under
  Paths.feature_cache, stamped with the port's FEATURE_NUMERIC_VERSION;
- npz parity mode: one .npz per clip in the original schema.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import re

import numpy as np

from tpu_breath_torch.config import FEATURE_NUMERIC_VERSION, FeatureSpec, Paths

CACHE_FILES = ("features.npy", "scalars.npy", "ids.txt")


def train_wav_name(file_id: str) -> str:
    """Strip the _[EI]_ label fragment: x_E_0001 -> x_0001.wav."""
    return re.sub(r"_[EI]_", "_", file_id) + ".wav"


def test_wav_name(file_id: str) -> str:
    return file_id if file_id.endswith(".wav") else file_id + ".wav"


def _read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_frames(paths: Paths) -> tuple[list[dict], list[dict]]:
    """(train rows, test rows) of train.csv / test.csv as dicts keyed by
    the header (ID, Target for train; ID for test)."""
    return _read_csv(paths.train_csv), _read_csv(paths.test_csv)


def dataset_wavs(paths: Paths) -> tuple[list[str], list[str]]:
    """(IDs, wav paths) of the train clips, then the test clips."""
    train_rows, test_rows = load_frames(paths)
    ids = [r["ID"] for r in train_rows] + [r["ID"] for r in test_rows]
    wav_paths = ([os.path.join(paths.train_audio_dir, train_wav_name(r["ID"]))
                  for r in train_rows]
                 + [os.path.join(paths.test_audio_dir, test_wav_name(r["ID"]))
                    for r in test_rows])
    return ids, wav_paths


def split_train_val(rows: list, test_size: float = 0.20, seed: int = 42
                    ) -> tuple[list, list]:
    """sklearn's train_test_split(rows, test_size=0.2, shuffle=True,
    random_state=42), not stratified: RandomState(42).permutation(n); the
    first ceil(0.2 n) indices are the val split, the rest the train split,
    both in permutation order."""
    n = len(rows)
    n_val = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return [rows[i] for i in perm[n_val:]], [rows[i] for i in perm[:n_val]]


def labels_from_targets(targets) -> np.ndarray:
    """'E' -> 1.0, 'I' -> 0.0."""
    return np.asarray([1.0 if t == "E" else 0.0 for t in targets], np.float32)


@dataclasses.dataclass
class FeatureStore:
    """Dense in-memory feature set for a list of clip IDs."""

    ids: list[str]
    features: np.ndarray  # [N, C, H, W] float32
    scalars: np.ndarray   # [N, S] float32

    def subset(self, id_list) -> "FeatureStore":
        index = {fid: i for i, fid in enumerate(self.ids)}
        rows = np.asarray([index[i] for i in id_list], np.int64)
        return FeatureStore(list(id_list), self.features[rows],
                            self.scalars[rows])

    # flat cache

    def save_cache(self, cache_dir: str) -> None:
        """meta.json (with the numeric stamp) is written last: a cache
        without it reads as absent."""
        os.makedirs(cache_dir, exist_ok=True)
        np.save(os.path.join(cache_dir, "features.npy"), self.features)
        np.save(os.path.join(cache_dir, "scalars.npy"), self.scalars)
        with open(os.path.join(cache_dir, "ids.txt"), "w") as f:
            f.write("\n".join(self.ids))
        with open(os.path.join(cache_dir, "meta.json"), "w") as f:
            json.dump({"numeric_version": FEATURE_NUMERIC_VERSION,
                       "n_clips": len(self.ids),
                       "feature_shape": list(self.features.shape[1:]),
                       "scalar_dim": int(self.scalars.shape[1])}, f)

    @classmethod
    def load_cache(cls, cache_dir: str, mmap: bool = True) -> "FeatureStore":
        """The cache under cache_dir; raises ValueError unless meta.json
        stamps it with this port's FEATURE_NUMERIC_VERSION (a cache of
        other numerics is never read)."""
        stamp = cls._stamp(cache_dir)
        if stamp != FEATURE_NUMERIC_VERSION:
            raise ValueError(f"feature cache {cache_dir}: numeric_version "
                             f"{stamp!r}, not {FEATURE_NUMERIC_VERSION!r}; "
                             f"run precompute again")
        mode = "r" if mmap else None
        feats = np.load(os.path.join(cache_dir, "features.npy"),
                        mmap_mode=mode)
        scals = np.load(os.path.join(cache_dir, "scalars.npy"),
                        mmap_mode=mode)
        with open(os.path.join(cache_dir, "ids.txt")) as f:
            ids = f.read().splitlines()
        return cls(ids, feats, scals)

    @staticmethod
    def _stamp(cache_dir: str):
        """meta.json's numeric_version, None without a readable meta.json."""
        try:
            with open(os.path.join(cache_dir, "meta.json")) as f:
                return json.load(f).get("numeric_version")
        except (OSError, ValueError):
            return None

    @classmethod
    def cache_exists(cls, cache_dir: str) -> bool:
        """True only for a complete cache stamped with this port's
        FEATURE_NUMERIC_VERSION; a missing or other stamp reads as absent."""
        return (all(os.path.exists(os.path.join(cache_dir, n))
                    for n in CACHE_FILES)
                and cls._stamp(cache_dir) == FEATURE_NUMERIC_VERSION)

    # npz parity mode

    def save_npz(self, out_dir: str, spec: FeatureSpec) -> None:
        """One .npz per clip: one key per channel plus "scalars"."""
        os.makedirs(out_dir, exist_ok=True)
        for i, fid in enumerate(self.ids):
            arrays = {name: self.features[i, c]
                      for c, name in enumerate(spec.channel_order)}
            arrays["scalars"] = self.scalars[i]
            np.savez(os.path.join(out_dir, fid + ".npz"), **arrays)

    @classmethod
    def load_npz(cls, feature_dir: str, id_list, spec: FeatureSpec
                 ) -> "FeatureStore":
        """Read per-clip npz files: the channels are the first file's keys
        minus the excluded set, stacked in sorted order."""
        excluded = {"scalars", "sr", "hop_length", "n_fft"}
        with np.load(os.path.join(feature_dir, id_list[0] + ".npz")) as d:
            names = sorted(k for k in d.keys() if k not in excluded)
            scalar_dim = d["scalars"].shape[0]
        n = len(id_list)
        feats = np.empty((n, len(names), spec.n_mels, spec.t_fixed),
                         np.float32)
        scals = np.empty((n, scalar_dim), np.float32)
        for i, fid in enumerate(id_list):
            with np.load(os.path.join(feature_dir, fid + ".npz")) as d:
                for c, name in enumerate(names):
                    feats[i, c] = d[name]
                scals[i] = d["scalars"]
        return cls(list(id_list), feats, scals)
