"""The serving cell's one sweep for its rate, in one process on the card:

    python -m breathbench.sweep --workload <serve cell> --rates 500,1000
        --seconds <s> --seed <n>

runs the cell's traffic at each rate (no correctness check) and prints a
line a rate: the latency's median and 95th percentile, the mean latency of
the first and of the last quarter of the requests, and how long past the
close the last answer came. A rate the server sustains keeps the last
quarter's latency near the first's and drains at once; past the knee the
backlog grows through the run."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from breathbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    cell = harness.cell(a.workload)
    for rate in [float(r) for r in a.rates.split(",")]:
        run = harness.Run(cell=cell, seed=a.seed, seconds=a.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          process_start=time.perf_counter(),
                          sizes={"rate_per_s": rate, "sample": 0},
                          log=lambda m: print(m, file=sys.stderr, flush=True))
        out = harness.kind(cell.traffic["kind"]).run(run)
        print(json.dumps({"rate_per_s": rate, **out.values,
                          **out.readings, "failed": out.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
