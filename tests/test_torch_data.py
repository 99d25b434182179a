"""The port's own copies of the JAX-free modules (config, data/wav,
baseline/dsp_np), its dataset layer (csv, split, feature store) and its
metrics, against the JAX package, sklearn and pandas on the CPU. Exact
unless a test says otherwise."""
import dataclasses
import os
import wave

import numpy as np
import pandas as pd
import pytest

from tpu_breath import config as jx_config
from tpu_breath.baseline import dsp_np as jx_dsp
from tpu_breath.data import dataset as jx_ds
from tpu_breath.data import wav as jx_wav
from tpu_breath.train import metrics as jx_metrics
from tpu_breath_torch import config
from tpu_breath_torch.baseline import dsp_np
from tpu_breath_torch.data import dataset as ds
from tpu_breath_torch.data import wav
from tpu_breath_torch.train import metrics

SPEC = config.DEFAULT_FEATURES


# -------------------------------------------------------------------- config

def test_config_copies_equal_jax():
    assert dataclasses.asdict(SPEC) == dataclasses.asdict(
        jx_config.DEFAULT_FEATURES)
    assert SPEC.channel_order == jx_config.DEFAULT_FEATURES.channel_order
    for ours, theirs in ((config.TrainCfg(), jx_config.TrainCfg()),
                         (config.CNN8_TRAIN, jx_config.CNN8_TRAIN),
                         (config.VGG_TRAIN, jx_config.VGG_TRAIN)):
        want = dataclasses.asdict(theirs)
        # epoch_scan is not ported; use_cutmix / use_mixup are read nowhere
        for name in ("epoch_scan", "use_cutmix", "use_mixup"):
            del want[name]
        assert dataclasses.asdict(ours) == want


def test_paths_keep_the_packages_apart():
    ours, theirs = config.Paths("r", "o"), jx_config.Paths("r", "o")
    assert ours.train_csv == theirs.train_csv
    assert ours.test_audio_dir == theirs.test_audio_dir
    assert ours.feature_cache == os.path.join("r", "feature_cache_torch")
    assert ours.ckpt_dir == os.path.join("o", "checkpoints_torch")
    assert ours.feature_cache != theirs.feature_cache
    assert ours.ckpt_dir != theirs.ckpt_dir
    assert config.FEATURE_NUMERIC_VERSION != jx_config.FEATURE_NUMERIC_VERSION


def test_dsp_np_copies_equal_jax():
    np.testing.assert_array_equal(dsp_np.hann(512, True),
                                  jx_dsp.hann(512, True))
    np.testing.assert_array_equal(dsp_np.hann(43, False),
                                  jx_dsp.hann(43, False))
    np.testing.assert_array_equal(dsp_np.mel_filterbank(16000, 2048, 128),
                                  jx_dsp.mel_filterbank(16000, 2048, 128))
    np.testing.assert_array_equal(
        dsp_np.mel_filterbank(16000, 512, 128, 0.0, 4500.0),
        jx_dsp.mel_filterbank(16000, 512, 128, 0.0, 4500.0))
    freqs = 32.7 * 2.0 ** (np.arange(36) / 36)
    a, n_a = dsp_np._vqt_filter_fft(4000, freqs, 36)
    b, n_b = jx_dsp._vqt_filter_fft(4000, freqs, 36)
    assert n_a == n_b
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dsp_np.wavelet_lengths(freqs, 4000)[0],
                                  jx_dsp.wavelet_lengths(freqs, 4000)[0])
    np.testing.assert_array_equal(dsp_np.cq_to_chroma(252, 36, 12, 32.7),
                                  jx_dsp.cq_to_chroma(252, 36, 12, 32.7))


# ----------------------------------------------------------------------- wav

def _write(path, data: np.ndarray, sr: int, width: int, fmt: int = 1):
    """A RIFF/WAVE file with interleaved samples already encoded."""
    raw = data.tobytes()
    ch = 1 if data.ndim == 1 else data.shape[1]
    with open(path, "wb") as f:
        f.write(b"RIFF" + (36 + len(raw)).to_bytes(4, "little") + b"WAVE")
        f.write(b"fmt " + (16).to_bytes(4, "little")
                + fmt.to_bytes(2, "little") + ch.to_bytes(2, "little")
                + sr.to_bytes(4, "little")
                + (sr * ch * width).to_bytes(4, "little")
                + (ch * width).to_bytes(2, "little")
                + (8 * width).to_bytes(2, "little"))
        f.write(b"data" + len(raw).to_bytes(4, "little") + raw)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, 16000)
    paths = {}
    paths["pcm16"] = str(tmp / "a.wav")
    with wave.open(paths["pcm16"], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    paths["f32_stereo"] = str(tmp / "b.wav")
    _write(paths["f32_stereo"], np.stack([x, -x[::-1]], 1).astype("<f4"),
           16000, 4, fmt=3)
    paths["pcm32_44k_short"] = str(tmp / "c.wav")
    _write(paths["pcm32_44k_short"],
           (rng.uniform(-0.5, 0.5, 30000) * 2 ** 31).astype("<i4"), 44100, 4)
    paths["broken"] = str(tmp / "d.wav")
    with open(paths["broken"], "wb") as f:
        f.write(b"not a wav")
    return paths


def test_wav_batch_equals_jax_decoder(wav_files):
    """PCM16, float32 stereo (downmix) and 44.1 kHz PCM32 shorter than a
    second (resample + pad), plus a broken file reported in `errors`: the
    port's decoder gives the JAX package's samples bitwise."""
    paths = list(wav_files.values())
    errs_t, errs_j = [], []
    got = wav.load_wav_batch(paths, 16000, errors=errs_t)
    ref = jx_wav.load_wav_batch(paths, 16000, errors=errs_j)
    np.testing.assert_array_equal(got, ref)
    assert [p for p, _ in errs_t] == [wav_files["broken"]] == [
        p for p, _ in errs_j]
    assert not got[-1].any()
    with pytest.raises(ValueError):
        wav.load_wav_batch([wav_files["broken"]], 16000)


# ------------------------------------------------------------------- dataset

def test_split_equals_sklearn_on_4000_ids():
    """RandomState(42).permutation: the first ceil(0.2 n) rows are the val
    split, the rest the train split, in permutation order, as sklearn's
    train_test_split(test_size=0.2, shuffle=True, random_state=42) (and so
    the JAX package) gives them."""
    from sklearn.model_selection import train_test_split

    ids = [f"s{i:05d}_{'E' if i % 3 else 'I'}_x" for i in range(4000)]
    tr, va = ds.split_train_val([{"ID": i} for i in ids])
    sk_tr, sk_va = train_test_split(ids, test_size=0.2, shuffle=True,
                                    random_state=42)
    assert [r["ID"] for r in tr] == sk_tr and [r["ID"] for r in va] == sk_va
    jx_tr, jx_va = jx_ds.split_train_val(pd.DataFrame({"ID": ids}))
    assert list(jx_tr["ID"]) == sk_tr and list(jx_va["ID"]) == sk_va
    for n in (2, 7, 1001):
        tr, va = ds.split_train_val(list(range(n)))
        sk_tr, sk_va = train_test_split(list(range(n)), test_size=0.2,
                                        shuffle=True, random_state=42)
        assert (tr, va) == (sk_tr, sk_va)


def test_frames_names_and_labels_equal_jax(tmp_path):
    (tmp_path / "train.csv").write_text(
        "ID,Target\nsteth_a_E_1,E\nsteth_b_I_2,I\nsteth_c_E_3,E\n")
    (tmp_path / "test.csv").write_text("ID\nsteth_d_4\nsteth_e_5.wav\n")
    paths = config.Paths(str(tmp_path), str(tmp_path))
    tr, te = ds.load_frames(paths)
    jtr, jte = jx_ds.load_frames(jx_config.Paths(str(tmp_path),
                                                 str(tmp_path)))
    assert [r["ID"] for r in tr] == list(jtr["ID"])
    assert [r["ID"] for r in te] == list(jte["ID"])
    np.testing.assert_array_equal(
        ds.labels_from_targets([r["Target"] for r in tr]),
        jx_ds.labels_from_targets(jtr["Target"]))
    for r in tr:
        assert ds.train_wav_name(r["ID"]) == jx_ds.train_wav_name(r["ID"])
    for r in te:
        assert ds.test_wav_name(r["ID"]) == jx_ds.test_wav_name(r["ID"])
    assert ds.train_wav_name("x_E_0001") == "x_0001.wav"


@pytest.fixture
def store():
    rng = np.random.default_rng(1)
    ids = [f"c{i}" for i in range(5)]
    return ds.FeatureStore(
        ids, rng.standard_normal((5, 9, 128, 63)).astype(np.float32),
        rng.standard_normal((5, 36)).astype(np.float32))


def test_cache_round_trip_and_stamp(store, tmp_path):
    cache = str(tmp_path / "cache")
    assert not ds.FeatureStore.cache_exists(cache)
    store.save_cache(cache)
    assert ds.FeatureStore.cache_exists(cache)
    back = ds.FeatureStore.load_cache(cache)
    assert back.ids == store.ids
    np.testing.assert_array_equal(back.features, store.features)
    np.testing.assert_array_equal(back.scalars, store.scalars)
    sub = back.subset(["c3", "c0"])
    np.testing.assert_array_equal(sub.features, store.features[[3, 0]])
    # another stamp (here the JAX package's own cache) reads as absent
    jx_cache = str(tmp_path / "jx")
    jx_ds.FeatureStore(store.ids, store.features, store.scalars
                       ).save_cache(jx_cache)
    assert not ds.FeatureStore.cache_exists(jx_cache)
    os.remove(os.path.join(cache, "meta.json"))
    assert not ds.FeatureStore.cache_exists(cache)


@pytest.mark.parametrize("stamp", ["missing", "other"])
def test_load_cache_refuses_a_cache_of_other_numerics(store, tmp_path, stamp):
    """load_cache reads meta.json as cache_exists does: a cache without the
    port's stamp (none, or the JAX package's own) raises, never loads."""
    cache = str(tmp_path / "cache")
    if stamp == "other":
        jx_ds.FeatureStore(store.ids, store.features, store.scalars
                           ).save_cache(cache)
    else:
        store.save_cache(cache)
        os.remove(os.path.join(cache, "meta.json"))
    with pytest.raises(ValueError, match="numeric_version"):
        ds.FeatureStore.load_cache(cache)


def test_npz_round_trip_and_jax_interop(store, tmp_path):
    """Per-clip npz files written by the port read back equal, by the port
    and by the JAX package (channels in sorted-key order)."""
    out = str(tmp_path / "npz")
    store.save_npz(out, SPEC)
    assert sorted(np.load(os.path.join(out, "c0.npz")).keys()) == sorted(
        list(SPEC.channel_order) + ["scalars"])
    back = ds.FeatureStore.load_npz(out, ["c4", "c1"], SPEC)
    jx_back = jx_ds.FeatureStore.load_npz(out, ["c4", "c1"],
                                          jx_config.DEFAULT_FEATURES)
    np.testing.assert_array_equal(back.features, store.features[[4, 1]])
    np.testing.assert_array_equal(back.scalars, store.scalars[[4, 1]])
    np.testing.assert_array_equal(jx_back.features, back.features)


# ------------------------------------------------------------------- metrics

@pytest.mark.parametrize("ties", [False, True])
def test_metrics_against_sklearn_and_jax(ties):
    """Accuracy, precision, recall, F1 and ROC-AUC (ties averaged) equal
    sklearn's within 1e-12 and the JAX package's exactly."""
    from sklearn.metrics import (accuracy_score, f1_score, precision_score,
                                 recall_score, roc_auc_score)

    rng = np.random.default_rng(3)
    probs = rng.random(500)
    if ties:
        probs = np.round(probs, 1)
    labels = (rng.random(500) < probs).astype(np.float64)
    m = metrics.binary_metrics(probs, labels)
    preds = probs > 0.5
    assert abs(m["auc"] - roc_auc_score(labels, probs)) < 1e-12
    assert abs(m["acc"] - accuracy_score(labels, preds)) < 1e-12
    assert abs(m["precision"] - precision_score(labels, preds)) < 1e-12
    assert abs(m["recall"] - recall_score(labels, preds)) < 1e-12
    assert abs(m["f1"] - f1_score(labels, preds)) < 1e-12
    assert m == jx_metrics.binary_metrics(probs, labels)
    assert np.isnan(metrics.roc_auc(probs, np.ones(500)))
