"""What every cell shares: BENCHMARK.json and the files it names, the
run's context (device, spans, counters, the tracer), the yardstick's
constants and timers, and the correctness check's bookkeeping."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with the files it names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in the cell: every metric but setup_s
    lists its cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json under root, its configuration,
    traffic and limits files found by name."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "breathbench")
    return Cell(
        name=name, entry=entry,
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(here, "traffic",
                                       entry["traffic"] + ".json")),
        limits=load_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name)])


def reader(metric: str, root: str = ROOT):
    """The read(run) function of metrics/<metric>.py."""
    path = os.path.join(root, "breathbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "breathbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    """The general generator of a traffic kind (kinds/<name>.py)."""
    return importlib.import_module(f"breathbench.kinds.{name}")


@dataclasses.dataclass
class Run:
    """One run of one cell: its arguments, device and what it records."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    process_start: float  # perf_counter time of the process's start
    tracer: object = None
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    log: object = print
    sizes: dict = dataclasses.field(default_factory=dict)  # test overrides
    trace_data: object = None  # the reduced trace (trace.Trace)

    def size(self, key: str):
        """A traffic parameter, or its override (tests at small sizes)."""
        return self.sizes.get(key, self.cell.traffic[key])

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span `name` (seconds kept under spans[name]); inside
        the traced window also a profiler range bench.<name>."""
        rng = None
        if self.tracer is not None and self.tracer.prof is not None:
            from torch.autograd.profiler import record_function
            rng = record_function("bench." + name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            if rng is not None:
                rng.__exit__(None, None, None)


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back: requests or steps attempted and
    failed, the end-to-end values by name, the numbers the check compared
    (name -> value), the device's peak memory; in a run for the limits'
    readings (sizes "readings"), what the control and the planted faults
    read on the same numbers."""
    attempted: int
    failed: int
    values: dict
    numbers: dict
    memory_peak_bytes: int
    readings: dict = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, launches: int, rounds: int, device) -> float:
    """ms per call of fn: one warm call, then `rounds` rounds of `launches`
    back-to-back calls, each timed by CUDA events (host clock on the CPU);
    the median round."""
    import torch

    fn()
    sync(device)
    out = []
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / launches)
    return statistics.median(out)


def quantile(xs: list, q: float) -> float:
    """The q-quantile of xs (linear between order statistics)."""
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block (the reference's
    float32 is float32)."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and each number beside its limit: every number the cell's
    limits name is compared (a missing or non-finite one is not correct);
    a number they do not name is shown with the limit None (not compared,
    PERF.md says why)."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    checks.update({k: {"value": v, "limit": None}
                   for k, v in numbers.items() if k not in limits})
    ok = bool(limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values() if c["limit"] is not None)
    return ok, checks


def memory_peak(device) -> int:
    """The device's peak of allocated memory in this process so far."""
    import torch

    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
