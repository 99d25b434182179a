"""The port's tools (tpu_breath_torch/utils: feature_roofline, seed_sweep,
ensemble_val, deviation_sweep, flip_hunt, and parity_sweep's
--deviations) on the CPU at a small size, each held against its JAX tool
(tools/*.py, imported by file path) on the same inputs; the roofline's
FLOP count (the FFT formulas, the feature count's linearity in the batch
and its independence of the gammatone route, the models' forward against
XLA's cost_analysis of the Flax models); the kernels' work model
(ops/cuda/work.py) against the kernel table's bounds; and no tool's
default names a path the repository holds."""
import glob
import importlib.util
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from tpu_breath import ensemble as jx_ensemble
from tpu_breath.baseline import dsp_np as jx_dsp
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.models.vgg import VGG as FlaxVGG
from tpu_breath.train.metrics import binary_metrics as jx_metrics
from tpu_breath.utils import profiling as jx_profiling
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX
from tpu_breath_torch.ops.cuda import (epilogue_kernel, gammatone_kernel,
                                       lpc_kernel, peaks_kernel, tuning_kernel,
                                       work)
from tpu_breath_torch.utils import (deviation_sweep, ensemble_val,
                                    feature_roofline, flip_hunt,
                                    parity_sweep, profiling, seed_sweep)
from tpu_breath_torch.utils.kernel_times import (clip_set, golden,
                                                 kernel_inputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_R5 = os.path.join(ROOT, "results", "sweep_r5")
NO_DATASET = os.path.join(ROOT, "tests", "no_dataset_here")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: its work is many small ops, which
    parallel test workers slow by orders of magnitude when each spreads
    them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name: str):
    """tools/<name>.py as a module (imported by file path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def copy_sweep(dst) -> str:
    """results/sweep_r5's histories (never its SUMMARY.json) into dst."""
    os.makedirs(dst)
    for p in glob.glob(os.path.join(SWEEP_R5, "*_seed*.jsonl")):
        shutil.copy(p, dst)
    return str(dst)


# ---- seed sweep and its summary


def test_summarize_reproduces_the_committed_sweep_summary(tmp_path):
    d = copy_sweep(tmp_path / "r5")
    seed_sweep.main(["summarize", "--dir", d])
    with open(os.path.join(d, "SUMMARY.json"), "rb") as f:
        got = f.read()
    with open(os.path.join(SWEEP_R5, "SUMMARY.json"), "rb") as f:
        want = f.read()
    assert json.loads(got) == json.loads(want)
    assert got == want


def test_sweep_summary_equals_the_jax_tools_when_every_run_is_done(
        tmp_path, monkeypatch):
    """Every history present: both tools train nothing and write the same
    SUMMARY.json for the same (mode, arch, seed) matrix."""
    args = ["--archs", "cnn8,vgg", "--seeds", "0,1,2,3,4,5,6,7",
            "--modes", "cached,fused"]
    jx_dir, my_dir = copy_sweep(tmp_path / "jax"), copy_sweep(tmp_path / "me")
    monkeypatch.setattr(sys, "argv", ["seed_sweep.py", *args, "--out",
                                      jx_dir])
    jax_tool("seed_sweep").main()
    mine = seed_sweep.main([*args, "--out", my_dir, "--device", "cpu"])
    with open(os.path.join(jx_dir, "SUMMARY.json")) as f:
        want = json.load(f)
    with open(os.path.join(my_dir, "SUMMARY.json")) as f:
        assert json.load(f) == want == mine
    assert set(want) == {"cached_cnn8", "cached_vgg", "fused_cnn8",
                         "fused_vgg"}


def test_sweep_and_summarize_agree_on_their_shared_keys(tmp_path):
    d = copy_sweep(tmp_path / "r5")
    runs = [(m, a, s) for m in ("cached", "fused") for a in ("cnn8", "vgg")
            for s in range(8)]
    a, b = seed_sweep.sweep_summary(d, runs), seed_sweep.summarize(d)
    assert seed_sweep.disagreements(a, b) == []
    b["fused_vgg"]["per_seed"][3]["val_acc"] += 1e-9
    assert seed_sweep.disagreements(a, b) == [
        "/fused_vgg/per_seed[3]/val_acc: "
        f"{a['fused_vgg']['per_seed'][3]['val_acc']!r} != "
        f"{b['fused_vgg']['per_seed'][3]['val_acc']!r}"]


def test_sweep_trains_each_run_through_the_cli_once(tmp_path, monkeypatch):
    """Each (mode, arch, seed) is one `train` of the port's CLI with the
    JAX tool's arguments (and --epochs, --device), its history copied;
    a second invocation skips every run."""
    from tpu_breath_torch import cli

    calls = []

    def fake_train(argv):
        calls.append(argv)
        arch = argv[argv.index("--archs") + 1]
        d = cli.ckpt_dir(argv[argv.index("--out-root") + 1], arch)
        os.makedirs(d)
        with open(os.path.join(d, "history.jsonl"), "w") as f:
            for e, acc in enumerate((0.5, 0.75, 0.625), 1):
                f.write(json.dumps({"epoch": e, "val_acc": acc,
                                    "val_auc": acc, "val_f1": acc}) + "\n")

    monkeypatch.setattr(cli, "main", fake_train)
    out = str(tmp_path / "sweep")
    args = ["--archs", "cnn8", "--seeds", "3,1", "--modes", "cached,fused",
            "--root", "R", "--epochs", "2", "--device", "cpu", "--out", out]
    summary = seed_sweep.main(args)
    assert calls == [
        ["train", "--root", "R", "--out-root",
         os.path.join(out, f"run_{m}_cnn8_seed{s}"), "--archs", "cnn8",
         "--seed", str(s), "--mesh", "off", "--device", "cpu", "--epochs",
         "2"] + (["--fused"] if m == "fused" else [])
        for m in ("cached", "fused") for s in (3, 1)]
    assert sorted(os.listdir(out)) == sorted(
        ["SUMMARY.json"] + [f"{m}_cnn8_seed{s}.jsonl" for m in
                            ("cached", "fused") for s in (1, 3)]
        + [f"run_{m}_cnn8_seed{s}" for m in ("cached", "fused")
           for s in (1, 3)])
    assert summary["fused_cnn8"]["per_seed"] == [
        {"epoch": 2, "val_acc": 0.75, "val_auc": 0.75, "val_f1": 0.75}] * 2
    seed_sweep.main(args)
    assert len(calls) == 4


# ---- deviation sweep


@pytest.fixture(scope="module")
def dev_clips() -> np.ndarray:
    """The golden wavs and 2 seeded noise clips."""
    rng = np.random.default_rng(4)
    noise = [rng.standard_normal(16000) * a for a in (0.05, 0.3)]
    return np.stack([d["wav"] for d in golden()] + noise).astype(np.float32)


@pytest.mark.parametrize("clip", range(4))
def test_deviation_functions_are_bit_equal_to_the_jax_tools(dev_clips,
                                                             clip):
    jx = jax_tool("deviation_sweep")
    y = dev_clips[clip]
    y64 = y.astype(np.float64)
    for res_type in ("polyphase", "sinc"):
        np.testing.assert_array_equal(
            deviation_sweep.chroma_channel(y64, res_type),
            jx.chroma_channel(y64, res_type))
    env = np.abs(scipy.signal.hilbert(y64))
    for name in ("greedy_peaks", "scipy_peaks"):
        assert (getattr(deviation_sweep, name)(env, 1600)
                == getattr(jx, name)(env, 1600))


def test_deviation_sweep_report_has_the_jax_keys(tmp_path):
    out = tmp_path / "dev.json"
    rep = deviation_sweep.main(["--root", NO_DATASET, "--n-clips", "8",
                                "--n-resample", "1", "--device", "cpu",
                                "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == rep
    with open(os.path.join(ROOT, "PARITY_SWEEP.json")) as f:
        jx_rep = json.load(f)["documented_deviations"]
    for key in ("peak_tie", "resampler_chroma_channel"):
        assert set(jx_rep[key]) == set(rep[key])
    assert set(jx_rep) - set(rep) == set()
    assert rep["n_clips_total"] == rep["peak_tie"]["n_clips"] == 8
    assert rep["resampler_chroma_channel"]["n_clips"] == 1
    assert rep["inputs"].startswith("seeded clips")


@pytest.fixture(scope="module")
def one_sweep():
    """parity_sweep.sweep's report of main's run below (8 seeded clips, one
    through the oracle), made once for both cases."""
    wavs, ids, synthetic = parity_sweep.seeded_clips(8, 0)
    return parity_sweep.sweep(wavs, ids, 1, 0, "cpu", False,
                              synthetic=synthetic)


@pytest.mark.parametrize("deviations", [False, True])
def test_parity_sweep_folds_a_deviation_report(tmp_path, deviations,
                                               one_sweep, monkeypatch):
    monkeypatch.setattr(parity_sweep, "sweep",
                        lambda *a, **k: json.loads(json.dumps(one_sweep)))
    dev = {"n_clips_total": 3, "peak_tie": {"n_clips_differ": 1}}
    (tmp_path / "dev.json").write_text(json.dumps(dev))
    argv = ["--root", NO_DATASET, "--n-clips", "8", "--n-oracle", "1",
            "--device", "cpu", "--out", str(tmp_path / "rep.json")]
    if deviations:
        argv += ["--deviations", str(tmp_path / "dev.json")]
    assert parity_sweep.main(argv) == 0
    assert one_sweep["documented_deviations"] is None
    with open(tmp_path / "rep.json") as f:
        rep = json.load(f)
    assert rep["documented_deviations"] == (dev if deviations else None)


# ---- feature roofline


def test_roofline_stages_are_the_profiles():
    assert (set(profiling.feature_stages())
            == set(jx_profiling.feature_stages()) - {"stft512_dd"})


@pytest.mark.parametrize("flop_frac, hbm_frac, want", [
    (0.30, 0.30, "latency/serial-bound"),
    (np.nextafter(0.30, 1), 0.0, "compute-bound"),
    (np.nextafter(0.30, 1), 0.9, "compute-bound"),
    (0.30, np.nextafter(0.30, 1), "bandwidth-bound"),
    (0.0, 0.0, "latency/serial-bound"),
    (None, None, "latency/serial-bound"),
])
def test_classification_at_the_30_percent_edges(flop_frac, hbm_frac, want):
    assert feature_roofline.classify(flop_frac, hbm_frac) == want


def test_bytes_are_linear_in_the_batch_and_zero_for_a_view():
    y = torch.from_numpy(clip_set(8, seed=2))
    one = feature_roofline.count(lambda x: x.abs() + 1.0, y[:4])
    two = feature_roofline.count(lambda x: x.abs() + 1.0, y)
    # abs: 4 clips read and written; + 1.0: read and written again
    assert one["bytes"] == 4 * 4 * 16000 * 4 and two["bytes"] == \
        2 * one["bytes"]
    view = feature_roofline.count(lambda x: x[:, ::2].T.unsqueeze(0)[..., :7],
                                  y)
    assert view == {"flops": 0, "bytes": 0, "kernel_calls": {}}
    # a reshape that cannot view copies: read and written once
    copy = feature_roofline.count(lambda x: x[:, ::2].T.reshape(-1), y)
    assert copy["bytes"] == 2 * 8 * 8000 * 4


@pytest.mark.parametrize("op, passes", [
    (lambda x: torch.empty_like(x).copy_(x), 2),
    (lambda x: torch.empty_like(x).fill_(1.0), 1),
    (lambda x: torch.empty_like(x).zero_(), 1),
    (lambda x: torch.zeros_like(x), 1),
    (lambda x: x.new_zeros(x.shape), 1),
], ids=["copy_", "fill_", "zero_", "zeros_like", "new_zeros"])
def test_bytes_read_no_overwritten_destination(op, passes):
    """copy_ reads its source and writes its destination, never reads it;
    a fill or a zeros_like only writes."""
    y = torch.from_numpy(clip_set(8, seed=3))
    assert feature_roofline.count(op, y)["bytes"] == passes * 8 * 16000 * 4


@pytest.mark.parametrize("b", [8, 128])
def test_kernel_bytes_are_the_work_model_at_the_tables_shapes(b):
    """Under count_kernels a wrapper's call adds the model's bytes, not its
    plain version's steps, at the main path's shapes."""
    x = kernel_inputs(torch.from_numpy(clip_set(b, seed=b)))
    rounds = 16000 // 1600 + 2
    pairs = x["p12"][0].numel()
    bb, f, t = x["mag"].shape
    g, k = x["fb"].shape[0], x["frames"].shape[-1]
    calls = [
        (lambda: tuning_kernel.estimate_tuning_index(x["p12"], x["m12"], 12),
         work.tuning(b, pairs), "A"),
        (lambda: epilogue_kernel.fused_epilogue(x["mag"], x["fb"]),
         work.epilogue(b, f, t, g), "B"),
        (lambda: epilogue_kernel.fused_epilogue(x["mag"], x["fb"], True),
         work.epilogue(b, f, t, g, plain=True), "B'"),
        (lambda: gammatone_kernel.fused_gammatone(x["frames"], x["basis"],
                                                  x["fb"]),
         work.gammatone(b, t, k, f, g), "B''"),
        (lambda: peaks_kernel.suppress_peaks(x["scores"], 1600, rounds),
         work.peaks(b, 16000, rounds), "C"),
        (lambda: lpc_kernel.lpc_frames(*x["lpc"]),
         work.lpc(b, 16000, 400, 98, 12), "E"),
    ]
    assert (bb, f, t, g, k) == (b, 257, 63, 64, 512)
    for call, w, name in calls:
        counter = feature_roofline.ByteCounter()
        with feature_roofline.count_kernels(counter), counter:
            call()
        assert (counter.bytes, dict(counter.kernel_calls)) == (w.bytes,
                                                               {name: 1})
    assert work.tuning(b, pairs).bytes == 2 * b * pairs * 4 + b * 4


# the kernel table's bounds (PERF.md §6), ms at B = 8 / 128, 4 decimals
TABLE_BOUNDS = {8: {"A": 0.0005, "B": 0.0002, "B'": 0.0002, "B''": 0.0042,
                    "C": 0.0002, "D": 0.0316, "E": 0.0011},
                128: {"A": 0.0072, "B": 0.0040, "B'": 0.0040, "B''": 0.0673,
                      "C": 0.0024, "D": 0.5063, "E": 0.0173}}
TABLE_BY = {"A": "bytes", "B": "operations", "B'": "operations",
            "B''": "operations", "C": "bytes", "D": "operations",
            "E": "operations"}


@pytest.mark.parametrize("b", [8, 128])
def test_chip_smoke_bounds_keep_the_kernel_tables_figures(b):
    x = kernel_inputs(torch.from_numpy(clip_set(b, seed=b)))
    got = chip_smoke.bounds(x, 16000 // 1600 + 2)
    assert {k: round(v[0], 4) for k, v in got.items()} == TABLE_BOUNDS[b]
    assert {k: v[1] for k, v in got.items()} == TABLE_BY


@pytest.fixture(scope="module")
def roofline(tmp_path_factory):
    out = tmp_path_factory.mktemp("roofline") / "r.json"
    rep = feature_roofline.main(["--n", "16", "--chunk", "8", "--root",
                                 NO_DATASET, "--device", "cpu", "--out",
                                 str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    return rep


def test_cpu_roofline_records_the_host_clock_and_no_share(roofline):
    assert (roofline["timer"], roofline["device"]) == ("host clock", "cpu")
    assert (roofline["n_clips"], roofline["chunk"]) == (16, 8)
    assert roofline["inputs"].startswith("seeded noise")
    assert roofline["peak_flops"] == feature_roofline.PEAK_FLOPS == 989e12
    assert roofline["peak_hbm_bytes_s"] == work.HBM_BPS == 3.35e12
    assert set(roofline["stages"]) == set(profiling.feature_stages())
    for name, row in roofline["stages"].items():
        assert row["wall_ms"] > 0 and row["clips_per_s"] > 0
        assert row["flop_frac"] is row["hbm_frac"] is row["bound"] is None
        assert row["gbytes_accessed"] == 2 * row["bytes_per_chunk"] / 1e9
        assert row["gflops"] == 2 * row["flops_per_chunk"] / 1e9


def test_roofline_full_counts_the_bench_flops_and_the_path_kernels(roofline):
    full = roofline["stages"]["full"]
    assert full["flops_per_chunk"] == feature_roofline.feature_flops(8)
    assert full["kernel_calls_per_chunk"] == {"A": 2, "B": 1, "C": 1,
                                              "E": 1}
    calls = {k: v["kernel_calls_per_chunk"]
             for k, v in roofline["stages"].items()}
    assert calls["tuning36"] == {"A": 1} and calls["find_peaks"] == {"C": 1}
    assert calls["lpc"] == {"E": 1}
    assert calls["chroma_stft"] == {"A": 1} and calls["scalars"] == {"C": 1}


@pytest.mark.parametrize("n", [8, 512, 2048])
def test_fft_flops_are_n_log2_n_formulas(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)))
    xc = torch.complex(x, x.flip(-1))
    count = feature_roofline.counted_flops
    assert count(lambda: torch.fft.fft(xc)) == 3 * 5 * n * math.log2(n)
    assert count(lambda: torch.fft.rfft(x)) == 3 * 2.5 * n * math.log2(n)
    half = torch.fft.rfft(x)
    assert count(lambda: torch.fft.irfft(half, n)) == (
        3 * 2.5 * n * math.log2(n))


def test_feature_flops_are_linear_in_b_and_route_free(monkeypatch):
    """Counted on kernel B's route whatever TPU_BREATH_PALLAS_GT says, so
    the count is a function of the shapes alone."""
    at4 = feature_roofline.feature_flops(4)
    assert feature_roofline.feature_flops(8) == 2 * at4
    monkeypatch.setenv("TPU_BREATH_PALLAS_GT", "1")
    assert feature_roofline.feature_flops(4) == at4


def _valid_tap_conv(x, w, bias, stride, padding, dilation, transposed,
                    output_padding, groups, out_shape=None):
    """2 x the multiply-adds of a stride-1 convolution whose kernel taps
    land inside the input (padding taps not counted, as XLA counts)."""
    taps = 1
    for size, k, p, o in zip(x[2:], w[2:], padding, out_shape[2:]):
        taps *= sum(0 <= j - p + t < size for j in range(o)
                    for t in range(k))
    return 2 * x[0] * w[0] * (x[1] // groups) * taps


@pytest.mark.parametrize("arch,flax_cls", [("cnn8", FlaxCNN8),
                                           ("vgg", FlaxVGG)])
def test_forward_flops_against_xla_cost_analysis(arch, flax_cls):
    """The roofline's count of a forward at batch 2 against XLA's
    cost_analysis of the Flax model's forward, the weights carried across
    by models/convert.py. FlopCounterMode counts every tap of a padded
    convolution, XLA only the taps inside the input, and XLA adds the
    elementwise work. Measured: port / XLA 1.0496 (CNN8), 1.0320 (VGG);
    XLA / the port's inside taps 1.0031, 1.0335."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, 9, 128, 63)).astype(np.float32)
    s = rng.standard_normal((2, 36)).astype(np.float32)
    flax_model = flax_cls(num_scalar_features=36, dtype=jnp.float32)
    v = jax.jit(lambda f, s: flax_model.init(
        {"params": jax.random.PRNGKey(0)}, f, s, train=False))(f, s)
    cost = jax.jit(lambda v, f, s: flax_model.apply(
        v, f, s, train=False)).lower(v, f, s).compile().cost_analysis()
    xla = float((cost[0] if isinstance(cost, list) else cost)["flops"])

    model = registry.build(arch, 36)
    model.load_state_dict(FROM_FLAX[arch](
        jax.tree.map(np.asarray, v["params"]),
        jax.tree.map(np.asarray, v["batch_stats"])))
    model.eval()
    ft, st = torch.from_numpy(f), torch.from_numpy(s)
    with torch.no_grad():
        port = feature_roofline.counted_flops(lambda: model(ft, st))
        inside = FlopCounterMode(
            display=False,
            custom_mapping={torch.ops.aten.convolution: _valid_tap_conv})
        with inside:
            model(ft, st)
    assert 1.0 < port / xla < 1.06
    assert 1.0 < xla / inside.get_total_flops() < 1.04


# ---- ensemble validation


def test_blend_is_the_jax_tools_arithmetic():
    rng = np.random.default_rng(6)
    probs = [rng.uniform(size=301).astype(np.float32) for _ in range(3)]
    labels = (rng.uniform(size=301) < 0.45).astype(np.float32)
    scores = [0.7725, 0.79, 0.80125]
    got = ensemble_val.blend_report(probs, scores, labels)
    w = jx_ensemble.softmax_weights(scores)
    want = {"weighted_ensemble": jx_metrics(
                np.sum([wi * p for wi, p in zip(w, probs)], axis=0), labels),
            "average_ensemble": jx_metrics(np.mean(probs, axis=0), labels)}
    np.testing.assert_allclose(got["weights_softmax"], w, atol=1e-6)
    for key, metrics in want.items():
        assert set(got[key]) == set(metrics)
        for k, v in metrics.items():
            assert abs(got[key][k] - v) <= 1e-6, (key, k)


# ---- flip hunt


def test_find_flips_finds_none_on_the_golden_clips():
    wavs = np.stack([d["wav"] for d in golden()]).astype(np.float32)
    assert flip_hunt.find_flips(wavs, ["golden0", "golden1"], "cpu") == []


def test_sample_is_the_jax_tools():
    assert np.array_equal(flip_hunt.sample_indices(5000),
                          np.random.default_rng(0).choice(5000, size=500,
                                                          replace=False))
    assert np.array_equal(flip_hunt.sample_indices(12), np.arange(12))


@pytest.mark.parametrize("clip", range(2))
def test_diagnose_oracle_pieces_are_the_jax_oracles(clip):
    wav = golden()[clip]["wav"]
    S = np.abs(jx_dsp.stft(wav.astype(np.float64), 512, 256)).astype(
        np.float32)
    got = flip_hunt.oracle_pieces(S)
    p, m = jx_dsp.piptrack(S, 16000, 512)
    np.testing.assert_array_equal(got["pitches"], p)
    np.testing.assert_array_equal(got["mags"], m)
    assert got["tuning"] == jx_dsp.estimate_tuning_from_S(S, 16000, 512, 12)
    assert got["counts"].sum() == got["sel"].sum()
    rep = flip_hunt.diagnose(wav, "cpu")
    # the device's tuning is f32 (-0.5 + index * 0.01), the oracle's a
    # float64 bin edge: find_flips' tolerance
    assert rep["oracle"]["tuning"] == got["tuning"]
    assert abs(rep["device"]["tuning"] - got["tuning"]) <= flip_hunt.TOL
    assert rep["pitch_mask_agree"] and rep["bins_differ"] == []
    assert rep["s_size"] == S.size


def test_flip_hunt_main_on_seeded_clips(tmp_path):
    rep = flip_hunt.main(["--root", NO_DATASET, "--n-clips", "8",
                          "--device", "cpu", "--out",
                          str(tmp_path / "f.json")])
    assert rep["n_sampled"] == 8 and rep["device"] == "cpu"
    assert rep["flips"] == [] == rep["diagnoses"]


# ---- defaults and devices


PARSERS = {
    "feature_roofline": (feature_roofline.build_parser, [], "out"),
    "seed_sweep": (seed_sweep.build_parser, ["--out", "D"], None),
    "summarize": (seed_sweep.build_summarize_parser, ["--dir", "D"], None),
    "ensemble_val": (ensemble_val.build_parser, ["--ckpt", "cnn8=P"], "out"),
    "deviation_sweep": (deviation_sweep.build_parser, [], "out"),
    "flip_hunt": (flip_hunt.build_parser, [], "out"),
}


@pytest.mark.parametrize("tool", sorted(PARSERS))
def test_no_default_names_a_path_in_the_repository(tool):
    """The JAX tools write results/*.json by default; the port's write
    only where --out / --dir says (required, or no file by default)."""
    build, required, out = PARSERS[tool]
    args = vars(build().parse_args(required))
    for k, v in args.items():
        if isinstance(v, str) and k not in ("root", "device", "archs",
                                            "seeds", "modes"):
            assert v in required, (k, v)
    if out is None:  # the directory is required
        with pytest.raises(SystemExit):
            build().parse_args([])
    else:
        assert args[out] is None
    assert args.get("device", "cuda") == "cuda"
    # the JAX tools' defaults name committed files
    for path in ("feature_roofline.json", "ensemble_val.json",
                 "deviation_sweep.json", "sweep", "sweep_r4/SUMMARY.json"):
        assert os.path.exists(os.path.join(ROOT, "results", path))


@pytest.mark.parametrize("call", [
    lambda: feature_roofline.main(["--n", "8", "--chunk", "8"]),
    lambda: seed_sweep.run_sweep("unused", ["cnn8"], [0], ["cached"]),
    lambda: ensemble_val.validate([("cnn8", "unused")]),
    lambda: deviation_sweep.main(["--n-clips", "8"]),
    lambda: flip_hunt.main(["--n-clips", "8"]),
    lambda: flip_hunt.find_flips(np.zeros((1, 16000), np.float32), ["x"]),
], ids=["feature_roofline", "seed_sweep", "ensemble_val", "deviation_sweep",
        "flip_hunt", "find_flips"])
def test_tools_demand_a_card_by_default(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()
