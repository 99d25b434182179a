"""p95 over the traced part's Server calls of the host ms of their
staging and unstaging (spans server.stage + server.unstage of a
server.call), under the profiler (records.py)."""
from breathbench import harness, records


def read(run):
    xs = records.call_parts_ms(run, "server.call",
                               {"server.stage", "server.unstage"})
    return harness.quantile(xs, 0.95) if xs else None
