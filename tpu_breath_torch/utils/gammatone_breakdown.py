"""Where kernel B'' (csrc/gammatone_kernel.cu) spends its time on the card.

    python -m tpu_breath_torch.utils.gammatone_breakdown

Builds the kernel and three cut-down copies of its source side by side and
times each at the main path's shapes (B = 8 and 128 seeded noise clips; the
kernel's time does not depend on the data):
  full           the kernel as it ships (its error against the plain
                 version is printed);
  dft            the DFT main loop alone: the epilogue (|S|, filterbank
                 product, z-score) is cut;
  dft_loads      the main loop's copies and fragment loads, no DMMA;
  dft_dmma       the main loop's copies and DMMAs on fixed fragments.
Each time is the mean of 20 back-to-back launches by CUDA events, queued
behind a spin kernel so that the card runs them back to back; the median
of 3 such runs is printed. Needs a CUDA device and nvcc; the copies are
built under tpu_breath_torch/_build/.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build
from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

SRC = os.path.join(_build.CSRC, "gammatone_kernel.cu")
# the text each cut replaces, and what replaces it
_DFT_END = "               T, K, K / kKT, fbs, fb, G, F);\n\n    // every block"
_DFT_ONLY = """               T, K, K / kKT, fbs, fb, G, F);
    {
      double s = 0.0;
      for (int a0 = 0; a0 < kRows / 16; ++a0)
        for (int a1 = 0; a1 < 2; ++a1)
          for (int a2 = 0; a2 < 4; ++a2) s += acc[a0][a1][a2];
      out[static_cast<size_t>(clip) * G * T +
          (r * kThreads + threadIdx.x) % (G * T)] = static_cast<float>(s);
      return;
    }
    // every block"""
_MMA = ("        mma_f64(acc[mt][0], af, br0, br1);\n"
        "        mma_f64(acc[mt][1], af, bi0, bi1);\n")
# the fragments are still loaded and widened, and folded into acc by integer
# xor so that the loads stay live
_NO_MMA = """        acc[mt][0][0] = __longlong_as_double(
            __double_as_longlong(acc[mt][0][0]) ^ __double_as_longlong(af[0]) ^
            __double_as_longlong(af[1]) ^ __double_as_longlong(af[2]) ^
            __double_as_longlong(af[3]) ^ __double_as_longlong(br0) ^
            __double_as_longlong(br1));
        acc[mt][1][0] = __longlong_as_double(
            __double_as_longlong(acc[mt][1][0]) ^ __double_as_longlong(bi0) ^
            __double_as_longlong(bi1));
"""
_B_LOAD = ("      const double br0 = bs[0], br1 = bs[32], bi0 = bs[64], "
           "bi1 = bs[96];")
_A_LOAD = ("        load_a<kAStride>(af, a + (16 * mt + g) * kAStride + 8 * s "
           "+ t);")


def variants() -> dict[str, str]:
    """name -> CUDA source: the kernel and its cut-down copies."""
    with open(SRC) as f:
        src = f.read()
    for piece in (_DFT_END, _MMA, _B_LOAD, _A_LOAD):
        if piece not in src:
            raise RuntimeError(f"{SRC} no longer holds {piece!r}")
    dft = src.replace(_DFT_END, _DFT_ONLY)
    fixed = dft.replace(_B_LOAD, "      const double br0 = 0.5 * g, br1 = "
                        "0.25 * t, bi0 = br1, bi1 = br0;").replace(
        _A_LOAD, "        af[0] = 0.5 * g; af[1] = 0.25 * t; af[2] = af[1]; "
        "af[3] = af[0];")
    return {"full": src, "dft": dft, "dft_loads": dft.replace(_MMA, _NO_MMA),
            "dft_dmma": fixed}


def build(names: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once; name -> loaded library."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in names.items():
        cu = os.path.join(_build.BUILD_DIR, f"gt_breakdown_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o", so,
             cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(so)
        lib.fused_gammatone_launch.argtypes = _build.SIGNATURES[
            "fused_gammatone_launch"]
        libs[name] = lib
    return libs


def launch_ms(run, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of run() in ms over `iters` launches queued behind a spin
    kernel (about 0.5 ms, longer than the host takes to queue them)."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_inputs(b: int, seed: int) -> tuple[torch.Tensor, ...]:
    """frames [b, 63, 512], basis and fb as the feature graph builds them
    from b seeded noise clips of one second at 16 kHz."""
    y = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 16000)).astype(np.float32) * 0.1).cuda()
    yp = torch.nn.functional.pad(y, (256, 256))
    frames = spectral.frame_signal(yp, 512, 256, 63).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, 512,
                                  device=y.device)
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=y.device)
    return frames, basis, fb


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gammatone_breakdown needs a CUDA device")
    libs = build(variants())
    print(f"device {torch.cuda.get_device_name(0)}")
    for b in (8, 128):
        frames, basis, fb = kernel_inputs(b, seed=b)
        t, k = frames.shape[1:]
        f, g = basis.shape[1] // 2, fb.shape[0]
        tiles = spectral.device_const(gk.tiled_basis, k, device=basis.device)
        ref = gk.fused_gammatone_plain(frames, basis, fb)
        for name, lib in libs.items():
            out = torch.empty(b, g, t, device="cuda")

            def run():
                _build.check(lib.fused_gammatone_launch(
                    frames.data_ptr(), tiles.data_ptr(), fb.data_ptr(),
                    out.data_ptr(), None, b, t, k, f, g,
                    torch.cuda.current_stream().cuda_stream), name)
            run()
            torch.cuda.synchronize()
            ms = [launch_ms(run) for _ in range(3)]
            err = (f", max abs err vs plain "
                   f"{float((out - ref).abs().max()):.3g}"
                   if name == "full" else "")
            print(f"B={b} {name}: {np.median(ms):.4f} ms (median of 3 runs "
                  f"of 20 calls){err}")


if __name__ == "__main__":
    main()
