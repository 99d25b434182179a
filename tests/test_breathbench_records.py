"""The benchmark's readers of the program's own records
(breathbench/records.py and the metrics that use it) on synthetic records,
on a fit traced on the CPU, and in tiny traced runs of the harness on the
CPU."""
import time
import types

import numpy as np
import pytest
import torch

from breathbench import harness, records, report
from breathbench.tests import tiny
from breathbench.trace import Tracer
from tpu_breath_torch.config import TrainCfg
from tpu_breath_torch.train import loop
from tpu_breath_torch.utils import profiling
from tpu_breath_torch.utils.profiling import Count, DeviceSpan, Span

S = 1_000_000_000  # ns a second
# the window opens at 5 s and lasts 10; the profiler runs from 6 s to 9 s
SETUP_S, SECONDS, START_S, STOP_S = 5.0, 10.0, 6.0, 9.0


@pytest.fixture(autouse=True)
def no_records():
    """Each test starts and ends with no records, whatever ran before it in
    this process."""
    profiling.records()
    yield
    profiling.records()


def _run(workload, recs, stopped=True):
    run = harness.Run(cell=harness.cell(workload), seed=1, seconds=SECONDS,
                      trace=True, device=torch.device("cpu"),
                      process_start=0.0, counters={"setup_s": SETUP_S})
    run.tracer = types.SimpleNamespace(
        _t0=START_S, host_s=STOP_S - START_S if stopped else None)
    run.program_records = recs
    return run


def _read(metric, run):
    return harness.reader(metric)(run)


def _recs(spans=(), device=(), counts=()):
    return {"spans": list(spans), "device": list(device),
            "counts": list(counts)}


def _span(name, t0, t1, id=None, parent=None):
    return Span(name, id, parent, int(t0 * S), int(t1 * S), None)


def test_the_traced_part_runs_from_the_profilers_start_to_its_stop():
    assert records.traced(_run("vgg.train_cached", None)) == (START_S * S,
                                                              STOP_S * S)
    untraced = _run("vgg.train_cached", None, stopped=False)
    assert records.traced(untraced) == (0, -1)


def test_epoch_gaps_run_from_a_wait_to_the_next_step():
    spans = [_span("fit.wait", 5.5, 5.6), _span("train_step", 6.2, 6.3),
             _span("fit.wait", 7.0, 7.1), _span("train_step", 7.3, 7.31),
             _span("train_step", 7.4, 7.41),
             _span("fit.wait", 8.0, 8.1), _span("train_step", 8.15, 8.2),
             _span("fit.wait", 8.9, 8.95), _span("train_step", 9.5, 9.6)]
    # the epoch end before the profiler (5.6 s) and the one whose next
    # step falls after its stop (8.95 s) are left out
    got = _read("epoch_gap_ms.train", _run("vgg.train_cached",
                                           _recs(spans)))
    assert got == pytest.approx(125.0)


def test_device_spans_are_read_in_the_traced_part_only():
    dev = [DeviceSpan("fit.step.device", 1, int(t * S), ms) for t, ms in
           ((5.5, 500.0), (7.0, 60.0), (8.0, 70.0), (9.5, 900.0))]
    dev.append(DeviceSpan("other", 2, 7 * S, 40.0))
    run = _run("cnn8.train_fused", _recs(device=dev))
    assert _read("step_device_ms.train", run) == pytest.approx(65.0)


def _call(t, parts, id, clips=4):
    """A server.call at t s with children (name, ms) laid end to end."""
    out, t0 = [], t
    for name, ms in parts:
        out.append(_span(name, t0, t0 + ms / 1e3, parent=id))
        t0 += ms / 1e3
    call = Span("server.call", id, None, int(t * S), int(t0 * S),
                {"clips": clips, "micro_batches": -(-clips // 8)})
    return [call] + out


def _calls(times):
    """Server calls (t s, clips, stage ms, wait ms) with their parts."""
    spans = []
    for i, (t, clips, stage, wait) in enumerate(times):
        spans += _call(t, [("server.stage", stage), ("server.issue", 1.0),
                           ("server.wait", wait),
                           ("server.unstage", stage)], i + 1, clips)
    return spans


def test_server_calls_are_read_in_the_traced_part():
    """The profiler runs from 6 s to 9 s: the readers read the calls that
    start there."""
    spans = _calls(((5.5, 4, 70.0, 70.0), (6.1, 4, 1.0, 2.0),
                    (6.5, 4, 3.0, 4.0), (6.9, 4, 5.0, 6.0),
                    (9.5, 1500, 50.0, 50.0), (15.5, 4, 70.0, 70.0)))
    run = _run("cnn8.serve_open", _recs(spans))
    assert _read("server_wait_ms.serve", run) == pytest.approx(4.0)
    assert _read("server_stage_p95_ms.serve", run) == pytest.approx(
        harness.quantile([2.0, 6.0, 10.0], 0.95))
    score = _run("vgg.score_files", _recs(spans))
    assert _read("server_stage_ms.score", score) == pytest.approx(6.0)
    untraced = _run("cnn8.serve_open", _recs(spans), stopped=False)
    assert _read("server_wait_ms.serve", untraced) is None


def test_a_decode_and_its_numpy_pass_are_one_pass():
    spans = [_span("wav.decode", 5.0, 5.5), _span("wav.decode", 6.0, 6.08),
             _span("wav.fallback", 6.1, 6.3), _span("wav.decode", 7.0, 7.1),
             _span("wav.decode", 8.0, 8.09), _span("wav.decode", 9.5, 9.9)]
    run = _run("vgg.score_files", _recs(spans))
    assert _read("wav_decode_ms.score", run) == pytest.approx(100.0)


def test_captures_count_in_the_traced_part_and_zero_is_a_reading():
    spans = [_span("train_step", 8.0, 8.1)]
    counts = [Count("graph.captures", 4 * S, 2),
              Count("graph.captures", 10 * S, 1)]
    assert _read("graph_captures.train", _run(
        "vgg.train_cached", _recs(spans, counts=counts))) == 0
    counts.append(Count("graph.captures", 7 * S, 1))
    assert _read("graph_captures.train", _run(
        "vgg.train_cached", _recs(spans, counts=counts))) == 1
    # no record in the traced part: nothing to read
    late = [_span("train_step", 10.0, 10.1)]
    assert _read("graph_captures.train", _run(
        "vgg.train_cached", _recs(late, counts=counts))) is None


METRICS = ["epoch_gap_ms.train", "step_device_ms.train",
           "server_stage_p95_ms.serve", "server_wait_ms.serve",
           "server_stage_ms.score", "wav_decode_ms.score",
           "graph_captures.train", "graph_captures.serve",
           "graph_captures.score"]


@pytest.mark.parametrize("metric", METRICS)
def test_without_records_every_reader_returns_none(metric):
    """A run whose port recorded nothing (a --trace 0 run, or a port
    without the recorder) reads None, and the records are taken from the
    port once."""
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == metric)
    run = _run(entry["workloads"][0], None)
    del run.program_records
    assert _read(metric, run) is None
    assert run.program_records is None


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(9 + 36, 1)

    def forward(self, f, s):
        return self.dense(torch.cat([f.mean(dim=(2, 3)), s], -1))[:, 0]


def test_a_fit_traced_on_the_cpu_has_epoch_gaps_and_no_device_spans():
    """fit driven under the benchmark's Tracer, nothing switched on: the
    profiler's records are the traced part's."""
    rng = np.random.default_rng(9)
    f = rng.standard_normal((20, 9, 4, 4)).astype(np.float32)
    s = rng.standard_normal((20, 36)).astype(np.float32)
    y = (np.arange(20) % 2).astype(np.float32)
    cfg = TrainCfg(num_epochs=3, batch_size=6, eval_batch_size=20,
                   patience=99, seed=4)
    run = harness.Run(cell=harness.cell("vgg.train_cached"), seed=1,
                      seconds=60.0, trace=True, device=torch.device("cpu"),
                      process_start=time.perf_counter(),
                      counters={"setup_s": 0.0})
    run.tracer = Tracer(run.device)
    run.tracer.start()
    loop.fit(_Tiny(), (f, s), (f, s), y, y, cfg, log_fn=lambda *_: None,
             device="cpu")
    run.tracer.stop()
    assert not profiling._REC.on
    gap = _read("epoch_gap_ms.train", run)
    assert gap is not None and gap > 0
    assert _read("graph_captures.train", run) == 0
    assert _read("step_device_ms.train", run) is None


@pytest.mark.parametrize("workload,sizes", [
    ("vgg.score_files", {"trace_passes": 1}),
    ("cnn8.serve_open", {"rate_per_s": 4, "trace_seconds": 1e9}),
])
def test_a_tiny_traced_run_reads_the_host_span_metrics(workload, sizes):
    """A --trace 1 run of the cell at a tiny size on the CPU: the port
    records while the harness's profiler runs, and each new host-span
    metric of the cell reads a number. The traced part holds a call
    whatever the host's load: scoring's first pass, serving's whole
    window (the profiler stops at the window's end)."""
    torch.set_num_threads(2)
    cell = harness.cell(workload)
    kind = cell.traffic["kind"]
    run = harness.Run(cell=cell, seed=2 ** 31 + 11, seconds=1.0,
                      trace=True, device=torch.device("cpu"),
                      process_start=time.perf_counter(),
                      sizes={**tiny.SIZES[kind], "oracle_workers": 0,
                             **sizes}, log=lambda m: None)
    run.tracer = Tracer(run.device)
    line = report.line(run, harness.kind(kind).run(run))
    assert line["correct"]
    assert not profiling._REC.on
    new = [m["name"] for m in cell.per_layer if m["name"] in METRICS]
    assert len(new) == 3
    for name in new:
        assert line["metrics"][name]["value"] is not None, name
    assert line["metrics"][f"graph_captures.{kind}"]["value"] == 0
