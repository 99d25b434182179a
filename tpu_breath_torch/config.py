"""Frozen configuration of the port (its own copy of tpu_breath/config.py's
FeatureSpec, TrainCfg, the two flagship training configs and Paths).

Paths differ from the JAX package's on purpose: the feature cache lives in
<root>/feature_cache_torch/ and checkpoints in <out_root>/checkpoints_torch/,
so neither package reads the other's files. FEATURE_NUMERIC_VERSION is the
port's own stamp of its feature numerics.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """The 9-channel spectrogram stack + scalar descriptor schema."""

    sr: int = 16_000
    duration: float = 1.0
    n_mels: int = 128
    n_mfcc: int = 40
    hop_length: int = 256
    n_fft: int = 512
    fmax: float = 4500.0
    n_gammatone: int = 64
    n_lpc: int = 12
    # CQT / CENS (librosa chroma_cens defaults)
    cqt_bins_per_octave: int = 36
    cqt_n_octaves: int = 7
    cqt_fmin: float = 32.703195662574764  # note C1
    cens_win_len_smooth: int = 41
    tempogram_win_length: int = 384

    @property
    def expected_len(self) -> int:
        return int(self.sr * self.duration)

    @property
    def t_fixed(self) -> int:
        """Number of STFT frames."""
        return self.expected_len // self.hop_length + 1

    @property
    def n_cqt_bins(self) -> int:
        return self.cqt_bins_per_octave * self.cqt_n_octaves

    # channel names of the npz schema; stacked in alphabetical order
    npz_keys: Tuple[str, ...] = (
        "mel", "mfcc", "chroma", "mel_delta", "mel_delta2",
        "gammatone", "lpc", "mod_spec", "tempogram",
    )

    @property
    def channel_order(self) -> Tuple[str, ...]:
        return tuple(sorted(self.npz_keys))

    @property
    def n_channels(self) -> int:
        return len(self.npz_keys)

    n_scalars: int = 36


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    """Training hyperparameters (the JAX package's TrainCfg without its
    epoch_scan switch, which the port does not have, and without
    use_cutmix / use_mixup, which neither package reads: cutmix_prob and
    mixup_prob select the augmentation)."""

    num_epochs: int = 30
    base_lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 512
    eval_batch_size: int = 1024
    patience: int = 15
    min_delta: float = 1e-4
    monitor: str = "val_acc"
    restore_best_weights: bool = True
    cutmix_prob: float = 0.5
    mixup_prob: float = 0.5
    cutmix_alpha: float = 1.0
    mixup_alpha: float = 0.2
    warmup_epochs: int = 5
    grad_clip_norm: float = 1.0
    warmup_frac: float = 0.05
    lr_start_factor: float = 0.1
    lr_eta_min: float = 1e-6
    seed: int = 0
    # True drops the val tail like the original loader (drop_last=True)
    parity_drop_last_eval: bool = False


CNN8_TRAIN = TrainCfg(
    num_epochs=100, base_lr=4e-4, patience=25,
    cutmix_prob=0.6, mixup_prob=0.4, warmup_epochs=4,
)
VGG_TRAIN = TrainCfg(num_epochs=140, patience=55)
# VGG's run at the Speech Commands recipe's rate of AST (egs/speechcommands)
AST_TRAIN = dataclasses.replace(VGG_TRAIN, base_lr=2.5e-4)


@dataclasses.dataclass(frozen=True)
class Paths:
    """One path layout for every stage: inputs under root, outputs under
    out_root."""

    root: str = "input"
    out_root: str = "."

    @property
    def train_csv(self) -> str:
        return os.path.join(self.root, "train.csv")

    @property
    def test_csv(self) -> str:
        return os.path.join(self.root, "test.csv")

    @property
    def train_audio_dir(self) -> str:
        return os.path.join(self.root, "train")

    @property
    def test_audio_dir(self) -> str:
        return os.path.join(self.root, "test")

    @property
    def precomputed_dir(self) -> str:
        """Per-clip npz files in the reference schema (shared format)."""
        return os.path.join(self.root, "precomputed")

    @property
    def feature_cache(self) -> str:
        return os.path.join(self.root, "feature_cache_torch")

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.out_root, "checkpoints_torch")

    @property
    def submission_dir(self) -> str:
        return os.path.join(self.out_root, "submissions")


DEFAULT_FEATURES = FeatureSpec()

# Stamp of the numeric output of the port's feature stack. The flat feature
# cache records it and a mismatch reads as no cache. Bump on any change that
# alters extract_features output.
FEATURE_NUMERIC_VERSION = "torch-6"
