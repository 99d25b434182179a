"""Runs of the benchmark's cells on the CPU at tiny sizes, skipping only
the look for a card: the same kinds, check and report as a run."""
from __future__ import annotations

import time

import torch

from breathbench import harness, report

SIZES = {
    "train": {"n_labelled": 40, "batch_size": 8, "chunk": 8},
    "serve": {"pool_clips": 16, "rate_per_s": 20, "warm_batches": [8],
              "sample": 8},
    "score": {"clips": 8, "sample": 8},
}
SECONDS = {"train": 0.5, "serve": 1.0, "score": 0.5}


def run(workload: str, seed: int = 2 ** 31 + 11, root: str = harness.ROOT,
        **extra) -> dict:
    """The result line of one tiny CPU run of the cell."""
    torch.set_num_threads(2)
    cell = harness.cell(workload, root)
    kind = cell.traffic["kind"]
    r = harness.Run(cell=cell, seed=seed, seconds=SECONDS[kind], trace=False,
                    device=torch.device("cpu"),
                    process_start=time.perf_counter(),
                    sizes={**SIZES[kind], "oracle_workers": 0, **extra},
                    log=lambda m: None)
    out = harness.kind(kind).run(r)
    line = report.line(r, out)
    line["readings"] = out.readings
    return line
