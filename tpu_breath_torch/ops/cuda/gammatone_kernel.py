"""Kernel B'': the whole gammatone channel (csrc/gammatone_kernel.cu).

Counterpart of tpu_breath/ops/pallas/epilogue_kernel.py::fused_gammatone:
frames [B, T, K] (raw signal values) times the window-folded real-DFT
basis [K, 2F] -> |S| -> z-normed log1p(fb @ |S|) [B, G, T]. Both products
accumulate in float64; |S| is taken in float64 and rounded to f32 once.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import _build
from tpu_breath_torch.ops.cuda import epilogue_kernel

SMEM_BYTES = 232_448  # the H100's opt-in shared memory per block
FRAMES_PER_TILE = 16  # kTT in the kernel

LAUNCHES = 0


def smem_bytes(t: int, k: int, f: int, g: int) -> int:
    return k * FRAMES_PER_TILE * 8 + (f + g) * t * 4


def fused_gammatone_plain(frames: torch.Tensor, basis: torch.Tensor,
                          fb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float64 matmul of frames by basis, |S| in
    float64 rounded to f32, then kernel B's plain version."""
    ri = torch.matmul(frames.double(), basis.double())      # [B, T, 2F]
    f = basis.shape[1] // 2
    re, im = ri[..., :f], ri[..., f:]
    mag = torch.sqrt(re * re + im * im).float().transpose(-1, -2)
    return epilogue_kernel.fused_epilogue_plain(mag, fb)


def fused_gammatone(frames: torch.Tensor, basis: torch.Tensor,
                    fb: torch.Tensor) -> torch.Tensor:
    """frames [B, T, K], basis [K, 2F], fb [G, F] f32 -> z-normed gammatone
    [B, G, T]. CPU tensors run the plain version; CUDA tensors the kernel."""
    global LAUNCHES
    if (frames.dim() != 3 or basis.dim() != 2 or fb.dim() != 2
            or basis.shape[0] != frames.shape[2] or basis.shape[1] % 2
            or fb.shape[1] != basis.shape[1] // 2):
        raise ValueError(f"frames {tuple(frames.shape)} / basis "
                         f"{tuple(basis.shape)} / fb {tuple(fb.shape)}: want "
                         "[B, T, K], [K, 2F] and [G, F]")
    if frames.device.type == "cpu":
        return fused_gammatone_plain(frames, basis, fb)
    if (frames.device.type != "cuda" or basis.device != frames.device
            or fb.device != frames.device):
        raise ValueError(f"unsupported devices {frames.device}/"
                         f"{basis.device}/{fb.device}")
    if not all(x.dtype == torch.float32 for x in (frames, basis, fb)):
        raise TypeError("gammatone kernel takes float32 frames, basis, fb")
    if not all(x.is_contiguous() for x in (frames, basis, fb)):
        raise ValueError("gammatone kernel takes contiguous tensors")
    b, t, k = frames.shape
    f, g = basis.shape[1] // 2, fb.shape[0]
    if smem_bytes(t, k, f, g) > SMEM_BYTES:
        raise ValueError(f"T {t}, K {k}, F {f}, G {g} exceed the kernel's "
                         "shared memory")
    out = torch.empty(b, g, t, dtype=torch.float32, device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    rc = _build.lib().fused_gammatone_launch(
        frames.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
        b, t, k, f, g, stream)
    _build.check(rc, "fused_gammatone_launch")
    LAUNCHES += 1
    return out
