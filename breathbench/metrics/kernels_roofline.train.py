"""Kernels A, B, B'' and C's share of their roofline in the traced
window, %: the sum over their launches of each call's least time
(breathbench/flops.py's bytes over HBM's rate or operations over their
peak, at the cell's clips a call) over the sum of their device time (the
kernels by name in the profiler trace)."""
from breathbench import flops

NAMES = {"A": ("tuning_tail_kernel",), "B": ("epilogue_kernel",),
         "B''": ("gammatone_kernel",), "C": ("suppress_kernel",)}


def read(run):
    t, b = run.trace_data, run.counters.get("kernel_batch")
    if t is None or not b:
        return None
    f, tt, g = flops.SHAPES["B"]
    n, rounds = flops.SHAPES["C"]
    p12, p36 = flops.SHAPES["A_pairs"]
    # A runs twice a feature call, once at each pair count
    per_call = {"A": (flops.bound_s(flops.tuning(b, p12))
                      + flops.bound_s(flops.tuning(b, p36))) / 2,
                "B": flops.bound_s(flops.epilogue(b, f, tt, g)),
                "B''": flops.bound_s(flops.gammatone(b, tt, flops.SHAPES[
                    "B2_k"], f, g)),
                "C": flops.bound_s(flops.peaks(b, n, rounds))}
    bound = device = 0.0
    for k, (secs, launches) in t.counts_by(NAMES).items():
        bound += per_call[k] * launches
        device += secs
    return 100.0 * bound / device if device > 0 else None
