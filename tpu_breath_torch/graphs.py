"""Captured CUDA graphs: the port's counterpart of jax.jit.

The JAX package compiles its feature graph once per shape (_extract_jit)
and its serving program once per micro-batch (ensemble.serve), queues every
call and reads the results once at the end. On the card one such program
is a CUDA graph: Graph runs a function once eagerly on a side stream (the
lazy work a capture refuses: cached constants, cuFFT plans, the cuBLAS
workspace, the kernel library's build and its shared-memory attributes),
captures a second call on static input and output buffers, and then each
call copies its input in and replays the whole graph with one launch.

Launch counts. A kernel wrapper adds one to its LAUNCHES where it launches
its kernel, so a replay, which calls no wrapper, would add nothing. Graph
records at capture how many launches of each kernel the graph holds, takes
the capture's own counts back out (capturing launches nothing), and adds
the recorded counts on every replay.

There is no fallback: on the card a capture or a replay that fails raises.
"""
from __future__ import annotations

import functools
import time

import torch


def kernel_counters() -> dict:
    """kernel -> (wrapper module, name of its launch counter)."""
    from tpu_breath_torch.ops.cuda import (cqt_kernel, epilogue_kernel,
                                           gammatone_kernel, peaks_kernel,
                                           tuning_kernel)
    return {"A": (tuning_kernel, "LAUNCHES"),
            "B": (epilogue_kernel, "LAUNCHES"),
            "B'": (epilogue_kernel, "LAUNCHES_F32"),
            "B''": (gammatone_kernel, "LAUNCHES"),
            "C": (peaks_kernel, "LAUNCHES"),
            "D": (cqt_kernel, "LAUNCHES")}


def read_launches() -> dict:
    return {k: getattr(mod, name)
            for k, (mod, name) in kernel_counters().items()}


def add_launches(counts: dict) -> None:
    for k, (mod, name) in kernel_counters().items():
        setattr(mod, name, getattr(mod, name) + counts.get(k, 0))


def global_flags() -> tuple:
    """The global numerics switches a capture freezes into a graph (TF32
    for cuBLAS and cuDNN, cuDNN's deterministic and benchmark modes): part
    of the key of a graph that runs the models, so a call under other
    flags captures anew."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def wait(device) -> None:
    """The host's one wait for a queue of replays: their outputs, copied
    to pinned host memory on the current stream, are then readable."""
    torch.cuda.current_stream(device).synchronize()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


class Graph:
    """fn(x) (x one tensor, the output a tuple or one tensor) captured as a
    CUDA graph on `device`, for inputs of example's shape.

    A call copies x into the static input buffer (on the current stream,
    without waiting on the host; x may be pinned host memory) and replays
    the graph on the current stream. It returns the graph's static output
    buffers: the next call overwrites them, so a caller copies what it
    keeps before it calls again.

    capture_s: seconds of the warm call and the capture; pool_bytes: the
    graph's private memory pool (its peak: a pool's segments are not
    released while the graph lives); launches: kernel -> launches a replay.
    """

    def __init__(self, fn, example: torch.Tensor, device):
        device = torch.device(device)
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.static_in = torch.empty(example.shape, dtype=example.dtype,
                                         device=device)
            self.static_in.copy_(example)
            stream = _capture_stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                fn(self.static_in)  # the warm call: it launches for real
            current.wait_stream(stream)
            before = read_launches()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.static_out = fn(self.static_in)
            after = read_launches()
            self.launches = {k: after[k] - before[k] for k in after}
            add_launches({k: -n for k, n in self.launches.items()})
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == pool)

    def __call__(self, x: torch.Tensor):
        self.static_in.copy_(x, non_blocking=True)
        self.graph.replay()
        add_launches(self.launches)
        return self.static_out
