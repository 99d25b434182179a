"""CUDA graphs captured (counter graph.captures) in the traced part: 0
when every program was captured in set-up."""
from breathbench import records


def read(run):
    return records.captures(run)
