"""The attention kernels' share of their roofline in the traced window,
%: the least time of their calls (breathbench/attention.py: each call's
bytes at 3.35 TB/s or FLOPs at the bf16 peak, whichever is larger, from
the configuration's shapes; the backward calls and as many forward calls
at the train batch, the other forward calls at the evaluation batch) over
their device time (the kernels by name in the profiler trace, one marker
kernel a call counting the calls)."""
from breathbench import attention


def read(run):
    t = run.trace_data
    if t is None:
        return None
    secs, calls = attention.found(t)
    if not calls["fwd"] or secs <= 0:
        return None
    return 100.0 * attention.least_seconds(run.cell.config, calls) / secs
