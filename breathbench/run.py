"""Run one cell of BENCHMARK.json once:

    python -m breathbench.run --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. Set-up, the timed window, the correctness
check, then one JSON line on stdout (the last line): correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 the breakdown,
and last the numbers compared beside their limits (also the last lines on
standard error). Without a CUDA device, or with fewer than the cell asks
for, without the port, or with jax, jaxlib, flax or the JAX package
loaded, it exits non-zero and prints no result."""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """perf_counter() time at which this process started (/proc)."""
    now = time.perf_counter()
    try:
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_breath")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    root = os.getcwd()
    from breathbench import harness

    try:
        cell = harness.cell(a.workload, root)
    except (OSError, KeyError, StopIteration) as e:
        log(f"breathbench: cannot read the cell {a.workload!r}: {e!r}")
        return 2
    cache_dirs(root)
    import torch

    try:
        import tpu_breath_torch  # noqa: F401  the system under test
    except ImportError as e:
        log(f"breathbench: the port is not here: {e!r}")
        return 4
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"breathbench: the cell needs {chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    from breathbench import report

    device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, seed=a.seed, seconds=a.seconds,
                      trace=bool(a.trace), device=device,
                      process_start=PROCESS_START, log=log)
    if run.trace:
        from breathbench.trace import Tracer
        run.tracer = Tracer(device)
    outcome = harness.kind(cell.traffic["kind"]).run(run)
    line = report.line(run, outcome)
    bad = forbidden_modules()
    if bad:
        log(f"breathbench: loaded in this process: {', '.join(bad)}")
        return 5
    report.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
