"""The 95th percentile of the host ms of one ensemble.Server call in the
traced second of the window, queueing left out (the harness's span around
each call): the host's stalls inside a call, such as the intra-op pool's
around its copies."""
from breathbench import harness


def read(run):
    xs = run.spans.get("server_call", [])[:run.counters.get("traced_calls")]
    return harness.quantile(xs, 0.95) * 1e3 if xs else None
