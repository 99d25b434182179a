"""Median host ms of one ensemble.Server call in the traced second of the
window, queueing left out (the harness's span around each call)."""
import statistics


def read(run):
    xs = run.spans.get("server_call", [])[:run.counters.get("traced_calls")]
    return statistics.median(xs) * 1e3 if xs else None
