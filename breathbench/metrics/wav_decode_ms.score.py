"""Median over the traced passes of the decoder's host ms: the native
call (span wav.decode) and, where a file failed it, the numpy pass that
follows it (span wav.fallback)."""
import statistics

from breathbench import records


def read(run):
    xs = records.spans(run, {"wav.decode", "wav.fallback"})
    passes = []
    for s in xs or ():
        ms = (s.t1_ns - s.t0_ns) / 1e6
        if s.name == "wav.decode" or not passes:
            passes.append(ms)
        else:  # the numpy pass of the decode before it
            passes[-1] += ms
    return statistics.median(passes) if passes else None
