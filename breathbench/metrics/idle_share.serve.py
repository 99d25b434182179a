"""The share of the traced window, in %, in which no kernel ran on the
device (profiler trace)."""


def read(run):
    t = run.trace_data
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
