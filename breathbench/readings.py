"""The readings a cell's limits are set from, in one process on the card:

    python -m breathbench.readings --workload <cell> --seeds 1,2,...
        --control-seeds 1,2,3 --seconds <s> [--out chiprun_out/x.jsonl]

Each seed runs the cell as the benchmark does (a window of --seconds: a
training cell needs none, so 0 stops fit at the first epoch end at which
the check has kept its records) and
gives the numbers its check compares: the lower readings. On the control
seeds the same run also gives the control's numbers (the reference in
fp8 put in the program's place) and a planted fault's: the upper readings.
One JSON line a seed, then the summary: each number's largest sound
reading, the smallest reading of the control and of each fault, and a
limit between the lower reading and the least upper one that counts. A
state left unchanged reads 1 on change_gap by its measure and needs no
run."""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from breathbench import harness


CONTROL = "control_fp8"
FAULTS = ("half_batch", "no_augmentation", "answer_flipped")


def upper(lower: float, reads: dict, training: bool) -> float | None:
    """The smallest upper reading that counts: the control's where it is
    three times the lower reading or more; in a training cell also a
    planted fault's where it is ten times or more."""
    ok = [v for name, v in reads.items()
          if (name == CONTROL and v >= 3 * lower)
          or (training and name in FAULTS and v >= 10 * lower)]
    return min(ok) if ok else None


def limit(lower: float, upper: float) -> float | None:
    """Two thirds of the way from lower to upper on a log scale (more room
    above the lower reading, which fresh seeds exceed); None unless the
    upper reading is three times the lower or more."""
    if upper is None or not upper >= 3 * lower or lower <= 0:
        return None
    return math.exp((math.log(lower) + 2 * math.log(upper)) / 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    ap.add_argument("--look-f32", action="store_true",
                    help="run the program with --f32's numerics (bf16 and "
                    "TF32 off): a look at what the bf16 body adds, not a "
                    "lower reading")
    a = ap.parse_args(argv)
    cell = harness.cell(a.workload)
    control = {int(s) for s in a.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        run = harness.Run(cell=cell, seed=seed, seconds=a.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          process_start=time.perf_counter(),
                          sizes={"readings": seed in control,
                                 **({"body": "float32"} if a.look_f32
                                    else {})},
                          log=lambda m: print(m, file=sys.stderr, flush=True))
        out = harness.kind(cell.traffic["kind"]).run(run)
        line = {"seed": seed, "numbers": out.numbers,
                "readings": out.readings, "failed": out.failed,
                "values": out.values}
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {}
    training = cell.traffic["kind"] == "train"
    for k in lines[0]["numbers"]:
        lo = max(line["numbers"][k] for line in lines)
        reads = {}
        for name in (CONTROL, *FAULTS):
            got = [line["readings"][name][k] for line in lines
                   if k in line["readings"].get(name, {})]
            if got:
                reads[name] = min(got)
        summary[k] = {"lower": lo, **reads,
                      "limit": limit(lo, upper(lo, reads, training))}
    print(json.dumps({"summary": summary}), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            for line in lines + [{"workload": a.workload,
                                  "summary": summary}]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
