"""The program's own records for the per-layer readers: the spans, device
spans and counts of the port's recorder (tpu_breath_torch.utils.profiling),
taken once a run, and the part of the window they are read over.

The port records while recording is switched on or a torch profiler is
active. The harness switches nothing on, so a --trace 1 run has records
of its traced part alone (the profiler's start to its stop) and a
--trace 0 run none; every reader reads the traced part. There the
profiler slows the host, so a host reading is the program's time under
the profiler: comparable between runs traced alike, an upper reading of
the untraced program (PERF.md has both for each cell). Where the port
keeps no records (one without the recorder, or none recorded), every
reader returns None."""
from __future__ import annotations

import statistics


def taken(run) -> dict | None:
    """The port's records of the run, taken from the port at the first
    call and kept on the run for the other readers; None where there are
    none."""
    if "program_records" not in vars(run):
        try:
            from tpu_breath_torch.utils.profiling import records
        except ImportError:  # a port without the recorder
            records = None
        recs = records() if records is not None else None
        run.program_records = (recs if recs and any(recs.values())
                               else None)
    return run.program_records


def traced(run) -> tuple[int, int]:
    """(from, to) of the traced part (the profiler's start to its stop),
    perf_counter ns; empty without a stopped profiler."""
    tracer = run.tracer
    if tracer is None or tracer.host_s is None:
        return 0, -1
    return (int(tracer._t0 * 1e9),
            int((tracer._t0 + tracer.host_s) * 1e9))


def spans(run, names) -> list | None:
    """The spans whose name is in names that start in the traced part, by
    start; None without records."""
    recs = taken(run)
    if recs is None:
        return None
    lo, hi = traced(run)
    return sorted((s for s in recs["spans"]
                   if s.name in names and lo <= s.t0_ns <= hi),
                  key=lambda s: s.t0_ns)


def device_ms(run, name: str) -> float | None:
    """Median ms of the traced part's device spans `name`; None without
    any."""
    recs = taken(run)
    if recs is None:
        return None
    lo, hi = traced(run)
    xs = [d.ms for d in recs["device"] if d.name == name
          and lo <= d.t_ns <= hi]
    return statistics.median(xs) if xs else None


def call_parts_ms(run, call: str, parts) -> list:
    """For each span `call` in the traced part, the host ms of its
    children named in parts, summed."""
    calls = spans(run, {call}) or []
    ids = {c.id for c in calls}
    total = dict.fromkeys(ids, 0)
    for s in taken(run)["spans"] if calls else ():
        if s.parent in ids and s.name in parts:
            total[s.parent] += s.t1_ns - s.t0_ns
    return [total[c.id] / 1e6 for c in calls]


def captures(run) -> int | None:
    """graph.captures counted in the traced part: 0 where nothing captured
    there, None where it holds no record at all."""
    recs = taken(run)
    if recs is None:
        return None
    lo, hi = traced(run)
    if not any(lo <= s.t0_ns <= hi for s in recs["spans"]):
        return None
    return sum(c.n for c in recs["counts"]
               if c.name == "graph.captures" and lo <= c.t_ns <= hi)
