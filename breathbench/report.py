"""The run's result line: the metrics the cell reports, the device, the
trace's breakdown, and the numbers compared beside their limits."""
from __future__ import annotations

import json
import subprocess
import sys

from breathbench import harness


def power_limit() -> str | None:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def line(run: harness.Run, outcome: harness.Outcome) -> dict:
    import torch

    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes,
              "card": power_limit() if dev.type == "cuda" else None}
    metrics = {}
    breakdown = None
    if run.trace:
        trace = run.tracer.reduce() if run.tracer is not None else None
        run.trace_data = trace
        for m in run.cell.per_layer:
            v = harness.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if trace is not None:
            device["busy_s"] = trace.busy_s
            device["window_s"] = trace.window_s
            breakdown = {"device_ops": trace.top_ops(),
                         "idle_gaps": trace.idle_gaps()}
    else:
        for m in run.cell.end_to_end:
            if m["name"] in outcome.values:
                metrics[m["name"]] = {"value": outcome.values[m["name"]],
                                      "unit": m["unit"]}
    correct, checks = harness.verdict(outcome.numbers, run.cell.limits)
    out = {"correct": correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def emit(out: dict) -> None:
    """The checks as the last lines on stderr, the line last on stdout."""
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
