"""The feature schema the reference computes (the fields of a
configuration's "features" object)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    sr: int = 16_000
    duration: float = 1.0
    n_mels: int = 128
    n_mfcc: int = 40
    hop_length: int = 256
    n_fft: int = 512
    fmax: float = 4500.0
    n_gammatone: int = 64
    n_lpc: int = 12
    cqt_bins_per_octave: int = 36
    cqt_n_octaves: int = 7
    cqt_fmin: float = 32.703195662574764
    cens_win_len_smooth: int = 41
    tempogram_win_length: int = 384
    n_scalars: int = 36
    npz_keys: Tuple[str, ...] = (
        "mel", "mfcc", "chroma", "mel_delta", "mel_delta2",
        "gammatone", "lpc", "mod_spec", "tempogram",
    )

    @property
    def expected_len(self) -> int:
        return int(self.sr * self.duration)

    @property
    def t_fixed(self) -> int:
        return self.expected_len // self.hop_length + 1

    @property
    def channel_order(self) -> Tuple[str, ...]:
        """Channels stacked in alphabetical order, as the models take them."""
        return tuple(sorted(self.npz_keys))


def from_config(features: dict) -> FeatureSpec:
    """The spec of a configuration's "features" object."""
    kw = dict(features)
    if "npz_keys" in kw:
        kw["npz_keys"] = tuple(kw["npz_keys"])
    return FeatureSpec(**kw)
