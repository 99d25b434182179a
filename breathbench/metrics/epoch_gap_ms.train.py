"""Median host ms, over the traced part's epoch ends, from the end of
fit's wait (span fit.wait) to the start of the next epoch's first step
(span train_step): the stretch in which the program queues nothing on
the device (under the profiler: records.py)."""
import bisect
import statistics

from breathbench import records


def read(run):
    waits = records.spans(run, {"fit.wait"})
    steps = [s.t0_ns for s in records.spans(run, {"train_step"}) or ()]
    gaps = []
    for w in waits or ():
        i = bisect.bisect_left(steps, w.t1_ns)
        if i < len(steps):
            gaps.append((steps[i] - w.t1_ns) / 1e6)
    return statistics.median(gaps) if gaps else None
