"""Profiling of the port (counterpart of tpu_breath/utils/profiling.py):
the recorder of the program's own spans and counters, and the CLI's
--profile.

- span / device_span / count / recording / records / collect: the
  recorder (below);
- feature_stages / profile_feature_stages / write_feature_profile: each
  named subgraph of the feature stack timed over chunks of precompute's
  size, slowest first -> feature_stages.json (`precompute --profile DIR`);
- trace: a torch.profiler trace (CPU and, on the card, CUDA activity) of a
  training run, with recording on -> trace.json and a table of the top
  operations, ops.txt (`train/e2e --profile DIR`);
- write_train_profile: per-epoch wall time from fit histories ->
  train_profile.json.

Times on the card come from CUDA events around all chunks of a stage; on
the CPU (device='cpu') from the host clock, and the JSON says which. The
stages run eagerly (extract_features and its subgraphs), not as the
captured graph that precompute replays (features.extract_features_compiled):
a graph replays the whole feature stack at once, so it has no stages to
time.

The recorder. The program names what it does with span(name, **attrs):
fit's epochs and their parts, a train step's issue, Server's staging,
issue and wait, the decoder, a graph's capture (the table of names is in
PERF.md). A span records while recording is on (recording()) or a torch
profiler is active; else it is one flag check and one call, and returns
the shared null context. A recorded span keeps its name, start and end on
time.perf_counter_ns(), its id and the id of the span that encloses it in
its thread (so the parts of one epoch or one Server call carry that
call's id) and its attrs, in memory, the newest KEEP of each kind;
records() hands them over and clears them. Under a torch profiler a span
is also a record_function of its name, so the profiler's trace names its
host ranges by the program's spans; the profiler leaves the switch as it
was, so once it stops the spans are the null context again. Nothing is
written anywhere.

device_span(name, device) times the device work a block queues by two
CUDA events on the current stream, only while a span would record and on
the card (else the null context: no event, so nothing captured with
recording off holds an event node). collect() reads the events the
device has passed; fit calls it after its epoch's one host wait, so no
read waits.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler

from tpu_breath_torch.device import resolve_device

KEEP = 1 << 18  # the newest spans, device spans and counts kept of each

# a span: name, id, the enclosing span's id (None at the top), start and
# end (time.perf_counter_ns), attrs (a dict or None)
Span = collections.namedtuple("Span", "name id parent t0_ns t1_ns attrs")
# a device span: name, the enclosing span's id, the host time at which its
# first event was recorded, device ms
DeviceSpan = collections.namedtuple("DeviceSpan", "name parent t_ns ms")
# a counter's increment at a host time
Count = collections.namedtuple("Count", "name t_ns n")


class _Recorder:
    """The process's records (one instance, _REC): recording's switch,
    the finished records and the device spans not yet read."""

    def __init__(self):
        self.on = False
        self.spans = collections.deque(maxlen=KEEP)
        self.device = collections.deque(maxlen=KEEP)
        self.counts = collections.deque(maxlen=KEEP)
        self.pending = []  # (name, parent, t_ns, start, end)
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans' ids."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def top(self):
        st = self.stack()
        return st[-1] if st else None


_REC = _Recorder()
_NULL = contextlib.nullcontext()


def _recording() -> bool:
    """Whether a span records now: recording on or a profiler active."""
    return _REC.on or autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "rf", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.rf = name, attrs or None, None

    def __enter__(self):
        if autograd_profiler._is_profiler_enabled:
            self.rf = autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.stack = _REC.stack()
        self.parent = self.stack[-1] if self.stack else None
        self.id = next(_REC.ids)
        self.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        _REC.spans.append(Span(self.name, self.id, self.parent, self.t0, t1,
                               self.attrs))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as span `name` while
    recording is on or a torch profiler is active, else the shared null
    context."""
    if not _recording():
        return _NULL
    return _Span(name, attrs)


class _DeviceSpan:
    __slots__ = ("name", "start", "end", "parent", "t")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start, self.end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
        self.parent, self.t = _REC.top(), time.perf_counter_ns()
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        _REC.pending.append((self.name, self.parent, self.t, self.start,
                             self.end))
        return False


def device_span(name: str, device):
    """A context manager that times the device work the block queues on
    the current stream as device span `name`, while a span would record
    and with `device` a CUDA device; else the shared null context (no
    event)."""
    if not _recording() or torch.device(device).type != "cuda":
        return _NULL
    return _DeviceSpan(name)


def collect() -> None:
    """Read the device spans the device has passed, without waiting (an
    event not yet passed stays for a later call). Call it after a host
    wait."""
    left = []
    for item in _REC.pending:
        name, parent, t, start, end = item
        if end.query():
            _REC.device.append(DeviceSpan(name, parent, t,
                                          start.elapsed_time(end)))
        else:
            left.append(item)
    _REC.pending = left


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (kept with the time) while a span would
    record."""
    if _recording():
        _REC.counts.append(Count(name, time.perf_counter_ns(), n))


@contextlib.contextmanager
def recording():
    """Recording switched on inside the block, the previous state restored
    after it."""
    saved, _REC.on = _REC.on, True
    try:
        yield
    finally:
        _REC.on = saved


def records() -> dict:
    """{"spans": [Span], "device": [DeviceSpan], "counts": [Count]}, each
    in the order recorded, and clear them."""
    out = {}
    for key in ("spans", "device", "counts"):
        q = getattr(_REC, key)
        out[key] = [q.popleft() for _ in range(len(q))]
    return out


def feature_stages() -> dict:
    """Stage name -> function of a chunk y [B, 16000] on the device: the
    JAX package's stages, with the round-once |STFT_512| (stft_mag_cr) as
    `stft512` and no `stft512_dd` (the port has no double-float path)."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.features import extract_features
    from tpu_breath_torch.ops import (cepstral, chroma as ch_ops,
                                      cqt as cqt_ops, dft, lpc as lpc_ops,
                                      peaks, rhythm, scalars as scalar_ops,
                                      spectral)

    sr, hop, n_fft = SPEC.sr, SPEC.hop_length, SPEC.n_fft

    def _mels(y):
        db = spectral.power_to_db(
            spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                    n_mels=SPEC.n_mels, fmax=SPEC.fmax),
            ref_max=True)
        return db + cepstral.delta(db, 1) + cepstral.delta(db, 2)

    def _mfccs(y):
        mf = cepstral.mfcc(y, sr, SPEC.n_mfcc, hop, n_fft)
        return mf + cepstral.delta(mf, 1) + cepstral.delta(mf, 2)

    return {
        "full": lambda y: extract_features(y, SPEC),
        "stft512": lambda y: spectral.stft_mag_cr(y, n_fft, hop),
        "stft2048": lambda y: spectral.stft_mag_cr(y, 2048, hop),
        "mel+deltas": _mels,
        "mfcc+deltas": _mfccs,
        "chroma_stft": lambda y: ch_ops.chroma_stft(
            spectral.stft_mag_cr(y, n_fft, hop).contiguous(), sr),
        "tuning36": lambda y: ch_ops.estimate_tuning_index(
            spectral.stft_mag_cr(y, 2048, hop)[..., ::2], sr, 2048, 36),
        "cens": lambda y: cqt_ops.chroma_cens(y, sr, hop, SPEC.cqt_fmin),
        "cqt": lambda y: cqt_ops.cqt_mag_multirate(
            y, torch.full(y.shape[:-1], 50, device=y.device), sr, hop,
            SPEC.cqt_fmin, 36, 7),
        "lpc": lambda y: lpc_ops.lpc_features(y, SPEC.n_lpc, sr),
        "tempogram": lambda y: rhythm.tempogram(
            rhythm.onset_strength(y, sr, hop), SPEC.tempogram_win_length),
        "scalars": lambda y: scalar_ops.extract_scalars(y, sr, hop, n_fft,
                                                        SPEC.n_mels),
        "hilbert": dft.hilbert_envelope,
        "autocorr": dft.autocorr_full,
        "find_peaks": lambda y: peaks.find_peaks_stats_batched(
            y.abs(), y.abs().mean(dim=-1), sr // 10),
    }


def _elapsed_ms(fn, device: torch.device) -> float:
    """Time of fn() in ms: CUDA events on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def profile_feature_stages(wavs: np.ndarray, chunk: int = 128,
                           device="cuda") -> list[dict]:
    """Time each stage over wavs [N, 16000] in chunks of `chunk` clips (the
    whole set when smaller), after one warm-up chunk. Returns
    [{stage, ms, ms_per_chunk, clips_per_s}], slowest first."""
    from tpu_breath_torch.ops import spectral

    device = resolve_device(device)
    if wavs.shape[0] == 0:
        raise ValueError("no clips to profile")
    stages = feature_stages()
    chunk = min(chunk, wavs.shape[0])
    n_chunks = wavs.shape[0] // chunk
    x = torch.from_numpy(np.ascontiguousarray(
        wavs[:n_chunks * chunk], np.float32)).to(device).reshape(
            n_chunks, chunk, -1)
    rows = []
    for name, f in stages.items():
        with spectral.full_f32():  # as extract_features runs them
            f(x[0])
            ms = _elapsed_ms(lambda: [f(c) for c in x], device)
        rows.append({"stage": name, "ms": ms, "ms_per_chunk": ms / n_chunks,
                     "clips_per_s": n_chunks * chunk / (ms / 1e3)})
        print(f"{name:14s} {rows[-1]['clips_per_s']:10.1f} clips/s "
              f"({ms:.2f} ms for {n_chunks} x {chunk})", flush=True)
    return sorted(rows, key=lambda r: -r["ms"])


def write_feature_profile(profile_dir: str, wavs: np.ndarray,
                          chunk: int = 128, device="cuda") -> str:
    device = resolve_device(device)
    os.makedirs(profile_dir, exist_ok=True)
    rows = profile_feature_stages(wavs, chunk=chunk, device=device)
    chunk = min(chunk, wavs.shape[0])
    path = os.path.join(profile_dir, "feature_stages.json")
    with open(path, "w") as f:
        json.dump({"n_clips": (wavs.shape[0] // chunk) * chunk,
                   "chunk": chunk,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                   "timer": ("cuda events" if device.type == "cuda"
                             else "host clock"),
                   "stages": rows}, f, indent=1)
    return path


@contextlib.contextmanager
def trace(profile_dir: str, device):
    """torch.profiler over the block (CPU activity, and CUDA activity on
    the card), with recording on (the program's spans name the trace's
    host ranges; their records stay for records()); on exit writes
    profile_dir/trace.json (Chrome trace) and profile_dir/ops.txt (top 40
    operations by self time on the device)."""
    device = resolve_device(device)
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    key = ("self_device_time_total" if device.type == "cuda"
           else "self_cpu_time_total")
    with open(os.path.join(profile_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))


def write_train_profile(profile_dir: str, histories: dict) -> str:
    """{arch: fit history rows} -> train_profile.json: epochs, total wall
    time, the first epoch (cuDNN and kernel set-up included) and the median
    of the later ones."""
    os.makedirs(profile_dir, exist_ok=True)
    out = {}
    for arch, rows in histories.items():
        secs = [r["sec"] for r in rows]
        out[arch] = {
            "epochs": len(secs),
            "total_s": float(sum(secs)),
            "first_epoch_s": secs[0] if secs else None,
            "warm_epoch_median_s": (float(np.median(secs[1:] or secs))
                                    if secs else None),
        }
    path = os.path.join(profile_dir, "train_profile.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return path
