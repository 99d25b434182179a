"""Host-side WAV ingestion (the port's own copy of tpu_breath/data/wav.py).

Decodes clips into one [N, 16000] float32 array: any input rate is
resampled to 16 kHz (Kaiser-windowed-sinc polyphase), multi-channel audio is
downmixed by channel mean, PCM8/16/24/32 and IEEE-float samples convert to
float32. `load_wav_batch` decodes through the port's threaded C++ decoder
(csrc/wavio.cpp), which this module builds with the host's C++ compiler at
first use into tpu_breath_torch/_build/ and loads with ctypes; there is no
numpy fallback. The numpy `read_wav` / `load_wav` / `resample_poly` are its
plain version: the two agree bit for bit on clips at 16 kHz and within
2e-6 where a clip is resampled (the order of the filter's sum differs).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import struct
import subprocess
import threading
import time

import numpy as np

from tpu_breath_torch.utils import profiling

TARGET_SR = 16_000

# Kaiser-windowed-sinc polyphase design, the JAX package's and the C++
# decoder's (csrc/wavio.cpp): beta 8.6 (~90 dB stopband), 16 zero-crossings
# per side at the narrower Nyquist. librosa's soxr_hq differs at the
# 1e-4-of-peak level; the downstream channel effect is bounded in PARITY.md.
_KAISER_BETA = 8.6
_ZERO_CROSSINGS = 16

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVIO_SRC = os.path.join(_PKG, "csrc", "wavio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# the JAX package's native/Makefile flags: no -march=native or -ffast-math,
# so no multiply-add is contracted and the samples stay those of its build
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
LD_FLAGS = ["-shared", "-lpthread"]


def compiler() -> str | None:
    """The host's C++ compiler: g++, else c++ (None if neither is found)."""
    return shutil.which("g++") or shutil.which("c++")


def library_path() -> str:
    """The decoder's library for this source and these flags (the file
    name carries their hash, so an edited source is rebuilt)."""
    h = hashlib.sha256()
    with open(WAVIO_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libtpu_breath_wavio_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile csrc/wavio.cpp if its library is missing. Returns {"path",
    "seconds"} (0.0 when the library was there). Raises RuntimeError
    without a compiler or when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0}
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++ on PATH) to build "
                           f"the wav decoder {WAVIO_SRC}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # processes (test workers, ranks) and threads may build at once: each
    # writes its own file and renames it into place
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, WAVIO_SRC, *LD_FLAGS, "-o",
                              tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({res.returncode}) to build "
                               f"the wav decoder {WAVIO_SRC}:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": out, "seconds": time.perf_counter() - t0}


@functools.lru_cache(maxsize=None)
def _native_lib() -> ctypes.CDLL:
    """The loaded decoder (built on first call)."""
    path = build()["path"]
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load the wav decoder {path} (built by "
                           f"{compiler()} from {WAVIO_SRC}): {e}") from e
    lib.decode_wav_batch.restype = ctypes.c_int
    lib.decode_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _resample_filter(up: int, down: int) -> np.ndarray:
    """Polyphase prototype lowpass: cutoff at the narrower Nyquist, gain
    `up` (compensates zero-stuffing), float64 taps."""
    m = max(up, down)
    half = _ZERO_CROSSINGS * m
    n = np.arange(-half, half + 1, dtype=np.float64)
    fc = 1.0 / m  # in units of the upsampled Nyquist pair (cycles/sample*2)
    h = up * fc * np.sinc(fc * n)
    return h * np.kaiser(2 * half + 1, _KAISER_BETA)


def resample_poly(x: np.ndarray, sr_in: int, sr_out: int = TARGET_SR
                  ) -> np.ndarray:
    """Rational L/M polyphase resample of a 1-D signal (float64 math,
    float32 out). Output sample t sits at input time t*M/L (phase-aligned at
    t=0, zero-padded boundaries); n_out = ceil(n * L / M) like
    librosa.resample."""
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    if up == down:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float64)
    h = _resample_filter(up, down)
    half = (len(h) - 1) // 2
    n_in = len(x)
    n_out = -(-n_in * up // down)
    taps = 2 * half // up + 1  # input samples under the filter per output
    t = np.arange(n_out, dtype=np.int64)
    # v[k] = sum_m h[m] u[k + half - m], u[i*up] = x[i]; k = t*down
    # input index i contributes tap m = t*down + half - i*up
    i0 = -(-(t * down - half) // up)  # ceil((t*down - half)/up)
    i = i0[:, None] + np.arange(taps, dtype=np.int64)[None, :]
    m = (t * down + half)[:, None] - i * up
    valid = (i >= 0) & (i < n_in) & (m >= 0) & (m < len(h))
    xi = np.where(valid, x[np.clip(i, 0, n_in - 1)], 0.0)
    hm = np.where(valid, h[np.clip(m, 0, len(h) - 1)], 0.0)
    return np.einsum("ot,ot->o", xi, hm).astype(np.float32)


def _decode_samples(fmt_code: int, bits: int, raw: bytes) -> np.ndarray:
    """Raw data-chunk bytes -> float64 interleaved samples, librosa/soundfile
    scaling (PCM int full-scale -> [-1, 1))."""
    if fmt_code == 3:  # IEEE float
        if bits == 32:
            return np.frombuffer(raw, "<f4").astype(np.float64)
        if bits == 64:
            return np.frombuffer(raw, "<f8").astype(np.float64)
    elif fmt_code == 1:  # integer PCM
        if bits == 16:
            return np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
        if bits == 24:
            b = np.frombuffer(raw, np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.int64)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            return v.astype(np.float64) / float(1 << 23)
        if bits == 32:
            return np.frombuffer(raw, "<i4").astype(np.float64) / float(1 << 31)
        if bits == 8:  # unsigned in WAV
            return (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
    raise ValueError(f"unsupported WAV format code {fmt_code} / {bits}-bit")


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """RIFF/WAVE -> (float64 mono signal at the FILE's rate, sample_rate).
    Multi-channel is downmixed by channel mean (librosa.load mono=True)."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) != 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt_code = channels = bits = sr = None
        while True:
            chunk = f.read(8)
            if len(chunk) != 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                if len(fmt) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                fmt_code, channels, sr = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                if fmt_code == 0xFFFE and len(fmt) >= 26:  # EXTENSIBLE
                    fmt_code = struct.unpack("<H", fmt[24:26])[0]
                if size & 1:
                    f.seek(1, 1)
            elif cid == b"data":
                if fmt_code is None:
                    raise ValueError(f"{path}: data before fmt")
                raw = f.read(size)
                break
            else:
                f.seek(size + (size & 1), 1)
    samples = _decode_samples(fmt_code, bits, raw)
    if channels > 1:
        samples = samples[: (len(samples) // channels) * channels]
        samples = samples.reshape(-1, channels).mean(axis=1)
    return samples, sr


def load_wav(path: str, expected_len: int = 16_000) -> np.ndarray:
    """One clip -> float32 [expected_len] at 16 kHz: decode, downmix,
    resample-if-needed, then tail zero-pad / truncate (librosa.load(sr=16000)
    + pad_or_truncate semantics, reference src/precompute/process.py:28 +
    methods.py:24-28)."""
    y64, sr = read_wav(path)
    if sr != TARGET_SR:
        y = resample_poly(y64, sr, TARGET_SR)
    else:
        y = y64.astype(np.float32)
    if len(y) >= expected_len:
        return y[:expected_len]
    return np.pad(y, (0, expected_len - len(y)))


def load_wav_batch(paths: list[str], expected_len: int = 16_000,
                   n_threads: int = 0,
                   errors: list | None = None) -> np.ndarray:
    """[N, expected_len] float32 at 16 kHz, decoded by the native decoder
    on `n_threads` threads (0: the hardware's concurrency).

    The JAX package's error rule (tpu_breath/data/wav.py), not a fallback:
    if any file fails, the whole batch goes through the numpy pass, where a
    failed clip decodes to zeros and, when `errors` is given, (path,
    message) is appended to it instead of raising, as the reference's
    precompute tally does (src/precompute/process.py:107-108,
    core.py:36-45).

    Spans (utils/profiling.py): wav.decode (the native call, attr files)
    and wav.fallback (the numpy pass)."""
    lib = _native_lib()
    out = np.zeros((len(paths), expected_len), dtype=np.float32)
    c_paths = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
    with profiling.span("wav.decode", files=len(paths)):
        failed = lib.decode_wav_batch(
            c_paths, len(paths),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), expected_len,
            n_threads)
    if failed == 0:
        return out
    with profiling.span("wav.fallback"):
        for i, p in enumerate(paths):
            try:
                out[i] = load_wav(p, expected_len)
            except Exception as e:
                out[i] = 0.0
                if errors is None:
                    raise
                errors.append((p, str(e)))
    return out
