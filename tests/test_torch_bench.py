"""The port's bench (tpu_breath_torch/bench.py): its CPU rehearsal's line
against bench.py's keys (read from bench.py's source, never imported), the
FFT FLOP formulas, the feature count's linearity in the batch and its
independence of the gammatone route, and the models' counted forward FLOPs
against XLA's cost_analysis of the Flax models."""
import ast
import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.models.vgg import VGG as FlaxVGG
from tpu_breath_torch import bench
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--device", "cpu", "--n-clips", "16", "--chunk", "8", "--batch",
         "8", "--steps", "2", "--baseline-clips", "1", "--repeats", "1",
         "--serve-calls", "2"]


def bench_py_keys() -> set:
    """The keys of the dict bench.py passes to json.dumps."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs beside other workers, and more
    threads would only contend with theirs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rehearsal():
    """bench.main's CPU rehearsal at tiny sizes: (its stdout, its line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.main(FLAGS)
    return out.getvalue(), line


def test_rehearsal_prints_one_line_with_bench_py_keys(rehearsal):
    out, line = rehearsal
    assert out.count("\n") == 1 and json.loads(out) == line
    keys = bench_py_keys()
    assert len(keys) == 12 and keys <= set(line)
    for k in ("serve_ms", "split", "flops", "runs", "gammatone_route",
              "inputs", "repeats", "peak_flops", "peak_source"):
        assert k in line
    assert line["device"] == {"platform": "cpu"}
    assert line["gammatone_route"] == "B" and line["repeats"] == 1
    assert line["inputs"].startswith("seeded noise")
    assert line["metric"].startswith("fused wav->feature->train-step")
    assert line["unit"] == "clips/s" and line["peak_flops"] == 989e12


def test_rehearsal_writes_no_time_rate_or_mfu(rehearsal):
    """A CPU number is never written under a device metric's name."""
    _, line = rehearsal
    for k in bench_py_keys() - {"metric", "unit", "cpu_baseline_clips"}:
        assert line[k] is None, k
    assert line["runs"] is None and line["spread"] is None
    for b in ("1", "8"):
        assert line["serve_ms"][b] == {"calls": 2, "median": None,
                                       "p90": None}
    for arch in ("cnn8", "vgg"):
        split = line["split"][arch]
        assert set(split) == {"features", "fwd", "grad", "cached", "fused",
                              "attribution_ms", "cached_batch_sweep",
                              "max_memory_allocated_bytes"}
        for name in ("features", "fwd", "grad", "cached", "fused"):
            assert all(split[name][k] is None
                       for k in ("ms", "ms_runs", "clips_per_s", "mfu"))
        assert split["attribution_ms"] is None
        assert split["max_memory_allocated_bytes"] is None  # no card
        assert split["cached_batch_sweep"] == {
            b: {"ms": None, "clips_per_s": None} for b in ("4", "8", "16")}


def test_rehearsal_keeps_counts_and_a_finite_loss(rehearsal):
    _, line = rehearsal
    assert line["cpu_baseline_clips"] == 1
    assert line["sizes"] == {"n_clips": 16, "chunk": 8, "batch": 8,
                             "steps": 2, "serve_calls": 2, "split_rounds": 1}
    flops = line["flops"]
    assert flops["feature_counted_at_batch"] == 8
    assert 0.05 < flops["feature_gflop_per_clip"] < 0.2  # ~79 MFLOP
    for arch in ("cnn8", "vgg"):
        assert math.isfinite(line["loss"][arch]) and line["loss"][arch] > 0
        g = flops["pieces_gflop"][arch]
        assert 0 < g["fwd"] < g["grad"] <= g["cached"]
        assert g["features"] == pytest.approx(
            8 * flops["feature_gflop_per_clip"], rel=1e-12)
        assert g["fused"] == pytest.approx(g["features"] + g["cached"],
                                           rel=1e-12)
        assert line["split"][arch]["fused"]["gflop"] == g["fused"]
    # VGG does more work a clip than CNN8
    assert (flops["pieces_gflop"]["vgg"]["fwd"]
            > flops["pieces_gflop"]["cnn8"]["fwd"])


@pytest.mark.parametrize("n", [8, 512, 2048])
def test_fft_flops_are_n_log2_n_formulas(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)))
    xc = torch.complex(x, x.flip(-1))
    assert bench.counted_flops(lambda: torch.fft.fft(xc)) == (
        3 * 5 * n * math.log2(n))
    assert bench.counted_flops(lambda: torch.fft.rfft(x)) == (
        3 * 2.5 * n * math.log2(n))
    half = torch.fft.rfft(x)
    assert bench.counted_flops(lambda: torch.fft.irfft(half, n)) == (
        3 * 2.5 * n * math.log2(n))


def test_feature_flops_are_linear_in_b_and_route_free(monkeypatch):
    """Counted on kernel B's route whatever TPU_BREATH_PALLAS_GT says, so
    the count is a function of the shapes alone."""
    at4 = bench.feature_flops(4)
    assert bench.feature_flops(8) == 2 * at4
    monkeypatch.setenv("TPU_BREATH_PALLAS_GT", "1")
    assert bench.feature_flops(4) == at4


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
    """The bench's count of a forward at batch 2 against XLA's
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
        port = bench.counted_flops(lambda: model(ft, st))
        inside = FlopCounterMode(
            display=False,
            custom_mapping={torch.ops.aten.convolution: _valid_tap_conv})
        with inside:
            model(ft, st)
    assert 1.0 < port / xla < 1.06
    assert 1.0 < xla / inside.get_total_flops() < 1.04


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run the bench")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(FLAGS[2:] + ["--device", "cuda"])


@pytest.mark.parametrize("flag,value", [("--repeats", "0"), ("--batch", "16"),
                                        ("--baseline-clips", "17")])
def test_sizes_the_bench_cannot_run_raise(flag, value):
    with pytest.raises(ValueError, match="n_clips"):
        bench.main(FLAGS + [flag, value])
