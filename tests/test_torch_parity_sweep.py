"""The port's parity sweep (tpu_breath_torch.utils.parity_sweep) on the CPU,
at a small size: the report's schema, the envelope on the port's CPU path,
the NaN-mask accounting and the flip post-mortem's tie width; and why the
synthetic clips are held to their NaN masks and flips only: the port's CPU
path and the JAX package both miss the envelope there."""
import json
import os
import wave

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.config import FeatureSpec as JxSpec
from tpu_breath.features import extract_features as jx_extract
from tpu_breath_torch.features import extract_features
from tpu_breath_torch.utils import parity_sweep as ps
from tpu_breath_torch.utils.kernel_times import clip_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = JxSpec()


@pytest.fixture(scope="module")
def report():
    """8 seeded clips on the CPU, 6 through the oracle in 2 spawned
    processes: golden0, golden1, silence, impulse, quantized and one
    shifted golden wav."""
    wavs, ids, synthetic = ps.seeded_clips(8, seed=0)
    return ps.sweep(wavs, ids, n_oracle=6, seed=0, device="cpu",
                    workers=2, synthetic=synthetic)


def test_dataset_clips_are_the_train_then_the_test_wavs(tmp_path):
    """With a dataset under --root the sweep takes its train clips, then
    its test clips, decoded as precompute decodes them."""
    rng = np.random.default_rng(3)
    (tmp_path / "train").mkdir()
    (tmp_path / "test").mkdir()
    clips = {"train/s_0001.wav": None, "train/s_0002.wav": None,
             "test/t_0003.wav": None}
    for name in clips:
        clips[name] = np.round(rng.uniform(-0.5, 0.5, 16000) * 32767)
        with wave.open(str(tmp_path / name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(clips[name].astype("<i2").tobytes())
    (tmp_path / "train.csv").write_text("ID,Target\ns_E_0001,E\ns_I_0002,I\n")
    (tmp_path / "test.csv").write_text("ID\nt_0003\n")
    wavs, ids = ps.dataset_clips(str(tmp_path))
    assert ids == ["s_E_0001", "s_I_0002", "t_0003"]
    np.testing.assert_array_equal(
        wavs, np.stack(list(clips.values())).astype(np.float32) / 32768)


def _keys(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_report_keys_are_a_superset_of_parity_sweep_json(report):
    with open(os.path.join(ROOT, "PARITY_SWEEP.json")) as f:
        jax_report = json.load(f)
    jax_report.pop("documented_deviations")  # its nested keys: not ported
    assert _keys(jax_report) - _keys(report) == set()
    assert "documented_deviations" in report
    for flip in jax_report["tuning_flips"]:
        assert {"id", "bpo", "t_oracle", "t_device", "tie_width"} == set(flip)
    assert report["n_total"] == 8 and report["n_oracle_sampled"] == 6
    assert report["n_oracle_synthetic"] == 3
    assert report["device"] == "cpu" and report["oracle_clips_per_s"] > 0


def test_cpu_sweep_has_no_flip_and_stays_inside_the_envelope(report):
    assert report["tuning_flips"] == []
    assert report["tuning_flip_rate_bpo12"] == 0.0
    assert report["tuning_flip_rate_bpo36"] == 0.0
    assert report["nan_mask_mismatches"] == 0
    assert ps.envelope_misses(report) == []
    for st in report["channel_max_abs_err_unflipped"].values():
        assert st["max"] <= ps.ENVELOPE_ABS


def test_silence_counts_no_nan_mask_mismatch_and_a_planted_one_counts():
    """Silence's NaN scalars sit in the same places on both sides; a NaN
    planted in a channel, or one taken out of the scalars, is counted."""
    y = np.zeros((1, 16000), np.float32)
    f, s = (t.numpy()[0] for t in extract_features(torch.from_numpy(y)))
    out = ps.oracle_clip(y[0])
    assert np.isnan(s).any()
    assert ps.compare_clip(f, s, out)[2] == []
    f2, s2 = f.copy(), s.copy()
    f2[SPEC.channel_order.index("mel"), 3, 5] = np.nan
    s2[np.isnan(s2)] = 0.0
    assert ps.compare_clip(f2, s2, out)[2] == ["mel", "scalars"]
    ids = ["silence"]
    rep = ps.make_report(y, ids, np.array([True]), np.array([0]), [out],
                         f2[None], s2[None],
                         (np.array([out["t12"]]), np.array([out["t36"]])))
    assert rep["nan_mask_mismatches"] == 2
    assert ps.envelope_misses(rep)[0].startswith("NaN masks differ")


def _peaks_spectrogram(bins_per_frame: list[int]) -> np.ndarray:
    """|S| [257, T] with one symmetric peak a frame (parabolic shift 0, so
    each pitch is exactly bin * sr / n_fft, every magnitude 1)."""
    S = np.zeros((257, len(bins_per_frame)), np.float32)
    for t, k in enumerate(bins_per_frame):
        S[k, t], S[k - 1, t], S[k + 1, t] = 1.0, 0.5, 0.5
    return S


@pytest.mark.parametrize("bins,want", [([10, 15], 0), ([10, 10, 15], 1),
                                       ([10, 20, 15], 1)])
def test_tie_width_on_planted_histograms(bins, want):
    """Two pitches in different histogram bins, one count each: an exact
    tie (0); a bin that leads by one count (1; 312.5 and 625 Hz are an
    octave apart, so their residuals share a bin)."""
    assert ps.tie_width(_peaks_spectrogram(bins), 12, 16000, 512) == want


SYNTHETIC = {"silence": 2, "impulse": 3, "noise11": 11}  # clip_set(12, 0)


@pytest.fixture(scope="module")
def synthetic_errors():
    """name -> [(channel errors, scalars' rel error, NaN-mask mismatches,
    the worst scalar) of the port's CPU path, then of the JAX package]
    against the oracle."""
    y = clip_set(12, seed=0)[list(SYNTHETIC.values())]
    port = [t.numpy() for t in extract_features(torch.from_numpy(y))]
    jx = [np.asarray(t) for t in
          jax.jit(lambda v: jx_extract(v, SPEC))(jnp.asarray(y))]
    out = {}
    for i, name in enumerate(SYNTHETIC):
        oracle = ps.oracle_clip(y[i])
        out[name] = [(*ps.compare_clip(f[i], s[i], oracle),
                      ps.worst_scalar(s[i], oracle["scalars"], name, True))
                     for f, s in (port, jx)]
    return out


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_synthetic_clips_lie_outside_the_envelope_for_both_packages(
        name, synthetic_errors):
    """On these synthetic clips the port's CPU path and the JAX package
    both miss PARITY.md's envelope against the oracle (silence: a z-scored
    constant row, mfcc; the impulse: an argmin over an exactly-zero
    autocorrelation, scalar 35; white noise: the skew of a near-constant
    spectral centroid, scalar 10), so the card is not held to it there.
    Prints both packages' errors (pytest -s)."""
    for package, (errs, rel, mismatched, worst) in zip(
            ("port", "jax"), synthetic_errors[name]):
        channel = max(errs, key=errs.get)
        print(f"{name} {package}: worst channel {channel} {errs[channel]:.3g}"
              f" abs; worst scalar {worst['scalar']} {rel:.3g} rel")
        assert mismatched == []
        assert (max(errs.values()) > ps.ENVELOPE_ABS
                or rel > ps.ENVELOPE_REL), (name, errs, rel)
