"""Median over the traced part's Server calls of the host's one wait
(span server.wait), ms."""
import statistics

from breathbench import records


def read(run):
    xs = records.call_parts_ms(run, "server.call", {"server.wait"})
    return statistics.median(xs) if xs else None
