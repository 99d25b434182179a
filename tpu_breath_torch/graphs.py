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
The only way to run a program's eager body on the card is eager(), the
comparison side for the tests and chip_smoke.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from tpu_breath_torch.utils import profiling


def kernel_counters() -> dict:
    """kernel -> (wrapper module, name of its launch counter)."""
    from tpu_breath_torch.ops.cuda import (bn_act_kernel, cqt_kernel,
                                           epilogue_kernel, gammatone_kernel,
                                           lpc_kernel, peaks_kernel,
                                           tuning_kernel)
    return {"A": (tuning_kernel, "LAUNCHES"),
            "B": (epilogue_kernel, "LAUNCHES"),
            "B'": (epilogue_kernel, "LAUNCHES_F32"),
            "B''": (gammatone_kernel, "LAUNCHES"),
            "C": (peaks_kernel, "LAUNCHES"),
            "D": (cqt_kernel, "LAUNCHES"),
            "E": (lpc_kernel, "LAUNCHES"),
            "F": (bn_act_kernel, "LAUNCHES")}


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


_EAGER = False  # True inside eager() only


@contextlib.contextmanager
def eager():
    """Inside the block every program that replays a graph on the card (the
    feature chunk, a Server's micro-batch, fit's step, an evaluation batch)
    runs its body eagerly instead: the eager side of a comparison. No CLI
    flag reaches it."""
    global _EAGER
    saved, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = saved


def replays(device) -> bool:
    """Whether a program on `device` runs as a graph: on the card, outside
    eager()."""
    return torch.device(device).type == "cuda" and not _EAGER


def wait(device) -> None:
    """The host's one wait for a queue of replays: their outputs, copied
    to pinned host memory on the current stream, are then readable."""
    torch.cuda.current_stream(device).synchronize()


def release(device) -> None:
    """Return the memory of graphs no longer referenced to the card (the
    caching allocator's empty_cache). A deleted graph's private pool stays
    cached in this process until an allocation fails, out of reach of any
    other process on the card (ranks started next, say)."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


class Graph:
    """fn(*xs) (xs tensors, the output a tuple or one tensor) captured as a
    CUDA graph on `device`, for inputs of examples' shapes.

    Construction copies examples into the static input buffers, runs fn
    once eagerly on them on the capture stream (the warm call: it launches
    for real, and builds what a capture refuses), then captures fn on them.
    The warm call's output stays in warm_out until the first replay: a
    program whose call changes state (a train step) returns it as its
    first call's result, so the warm call is that call. `generators`: the
    CUDA generators other than the device's default that fn draws from,
    registered with the graph, so a replay draws the numbers the eager call
    would and advances them as it would (a capture advances none).

    A call copies xs into the static input buffers (on the current stream,
    without waiting on the host; an x may be pinned host memory) and
    replays the graph on the current stream. It returns the graph's static
    output buffers: the next call overwrites them, so a caller copies what
    it keeps before it calls again.

    capture_s: seconds of the warm call and the capture; pool_bytes: the
    graph's private memory pool (its peak: a pool's segments are not
    released while the graph lives); launches: kernel -> launches a replay.
    The warm call and the capture are the span graph.capture (attr fn: fn's
    qualified name); each adds one to the counter graph.captures.
    """

    def __init__(self, fn, examples: tuple, device, generators=()):
        name = getattr(fn, "__qualname__", type(fn).__qualname__)
        with profiling.span("graph.capture", fn=name):
            self._capture(fn, examples, torch.device(device), generators)
        profiling.count("graph.captures")

    def _capture(self, fn, examples: tuple, device: torch.device,
                 generators) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.static_in = tuple(
                torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                for x in examples)
            stream = _capture_stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.warm_out = fn(*self.static_in)
            current.wait_stream(stream)
            for t in _tensors(self.warm_out):  # read on the current stream
                t.record_stream(current)
            before = read_launches()
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            with torch.cuda.graph(self.graph, stream=stream):
                self.static_out = fn(*self.static_in)
            after = read_launches()
            self.launches = {k: after[k] - before[k] for k in after}
            add_launches({k: -n for k, n in self.launches.items()})
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == pool)

    def __call__(self, *xs: torch.Tensor):
        self.warm_out = None
        for static, x in zip(self.static_in, xs):
            static.copy_(x, non_blocking=True)
        self.graph.replay()
        add_launches(self.launches)
        return self.static_out


def _tensors(out) -> tuple:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)
