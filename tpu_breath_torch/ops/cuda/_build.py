"""Build and load the CUDA kernels: nvcc into a shared library with a plain
C interface, loaded with ctypes.

The library is built at first use from every csrc/*.cu of this package into
tpu_breath_torch/_build/ (git-ignored): one nvcc per source, all started
together, then one link. Its file name carries a hash of the sources
(headers included), so an edited kernel is rebuilt and a stale library never
loads.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (all return a cudaError_t as int)
SIGNATURES = {
    "tuning_index_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fused_epilogue_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fused_gammatone_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P],
    "suppress_peaks_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cqt_mag_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "burg_lpc_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bn_act_stats_launch": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "bn_act_merge_launch": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _F, _F,
                            _P],
    "bn_act_apply_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _I,
                            _I, _P],
    "bn_act_reduce_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                             _I, _F, _I, _I, _P],
    "bn_act_sums_launch": [_P, _P, _L, _I, _I, _P, _F, _I, _P, _P, _P, _P,
                           _P],
    "bn_act_elemt_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                            _I, _I, _F, _I, _I, _P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtpu_breath_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise on the first failure. Returns
    their stderr (nvcc's -Xptxas -v report), concatenated."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[-1])}: nvcc failed "
                               f"({p.returncode}):\n{err}")
    return "".join(err for _, err in outs)


def build() -> dict:
    """Compile csrc/*.cu if the library for these sources is missing.
    Returns {"path", "seconds", "log"} (log holds nvcc's -Xptxas -v report)."""
    out = library_path()
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0, "log": "cached"}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
            for s in cus]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
                     "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", o, s]
                    for s, o in zip(cus, objs)])
    tmp = f"{out}.{tag}"
    try:
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            os.remove(o)
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    handle = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
