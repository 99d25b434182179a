"""Median host ms of one pass's ensemble.Server call (the harness's span
around it)."""
import statistics


def read(run):
    xs = run.spans.get("server")
    return statistics.median(xs) * 1e3 if xs else None
