"""Median over the traced passes' Server calls of the host ms of their
staging and unstaging (spans server.stage + server.unstage)."""
import statistics

from breathbench import records


def read(run):
    xs = records.call_parts_ms(run, "server.call",
                               {"server.stage", "server.unstage"})
    return statistics.median(xs) if xs else None
