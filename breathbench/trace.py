"""The traced window of a --trace 1 run: torch.profiler over part of the
window (the traffic's trace share), reduced to the device's kernels, the
host spans around them, the busy time and the idle gaps.

A kernel is a "kernel" event of the profiler's trace; busy time is the
union of the kernels' intervals inside the traced window (the window is
the harness's own "bench.trace_window" range); an idle gap is a stretch of
the window with no kernel, named by the innermost host range (the
harness's "bench.*" spans, or the program's own record_function ranges)
that covers its middle."""
from __future__ import annotations

import collections
import json
import os
import tempfile
import time

WINDOW = "bench.trace_window"


class Tracer:
    """start() and stop() bracket the traced window (the profiler runs
    between them); reduce() reads the trace after the run's window."""

    def __init__(self, device):
        self.device = device
        self.prof = self.range = None
        self.host_s = None
        self.events = None

    def start(self) -> None:
        if self.prof is not None:
            return
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.range = record_function(WINDOW)
        self.range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.events is not None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host_s = time.perf_counter() - self._t0
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        self.prof = None

    def reduce(self) -> "Trace | None":
        return None if self.events is None else Trace(self.events,
                                                      self.host_s)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The traced window's kernels [(name, start_us, end_us)], host ranges,
    busy and window seconds."""

    def __init__(self, events: list, host_s: float):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X" and "dur" in e]
        if win:
            self.t0 = min(e["ts"] for e in win)
            self.t1 = max(e["ts"] + e["dur"] for e in win)
        else:  # no range recorded: the whole trace
            ts = [e["ts"] for e in events if "ts" in e and "dur" in e]
            self.t0, self.t1 = (min(ts), max(ts)) if ts else (0.0, 0.0)
        self.kernels = [(e["name"], max(e["ts"], self.t0),
                         min(e["ts"] + e["dur"], self.t1)) for e in events
                        if e.get("cat") == "kernel" and "dur" in e
                        and e["ts"] + e["dur"] > self.t0
                        and e["ts"] < self.t1]
        self.ranges = [(e["name"], e["ts"], e["ts"] + e["dur"])
                       for e in events
                       if e.get("cat") == "user_annotation" and "dur" in e
                       and e.get("name") != WINDOW]
        self.busy = _merge([[a, b] for _, a, b in self.kernels])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.host_s = host_s

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_seconds(self, match) -> tuple[float, int]:
        """Seconds and count of the kernels whose name matches."""
        ks = [b - a for name, a, b in self.kernels if match(name)]
        return sum(ks) / 1e6, len(ks)

    def top_ops(self, k: int = 10) -> list:
        total = collections.Counter()
        for name, a, b in self.kernels:
            total[name[:200]] += (b - a) / 1e6
        return [[n, s] for n, s in total.most_common(k)]

    def gaps(self) -> list:
        """(start_us, end_us) of every stretch of the window with no
        kernel."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_at(self, t: float) -> str:
        """The innermost host range covering time t."""
        best = None
        for name, a, b in self.ranges:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "outside any span"

    def idle_gaps(self, k: int = 10) -> list:
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]
        return [[self.host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in longest]

    def counts_by(self, names: dict) -> dict:
        """kernel key -> (device seconds, launches) for kernels whose name
        contains one of the key's substrings."""
        return {k: self.device_seconds(lambda n, s=subs: any(x in n
                                                               for x in s))
                for k, subs in names.items()}

