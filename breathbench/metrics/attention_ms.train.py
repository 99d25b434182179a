"""Device ms a training step of the attention kernels (breathbench/
attention.py's names: the SDPA calls' forward and backward kernels, of
whichever backend the model pins) in the traced window, the window's
evaluation forwards included, over the traced steps (profiler trace)."""
from breathbench import attention


def read(run):
    t, steps = run.trace_data, run.counters.get("traced_steps")
    if t is None or not steps:
        return None
    secs, calls = attention.found(t)
    return 1e3 * secs / steps if calls["fwd"] else None
