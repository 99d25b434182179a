"""Kernel E: Burg LPC of every frame of a batch of clips
(csrc/lpc_kernel.cu).

Replaces no TPU kernel (the JAX package leaves the stage to XLA); the
eager recursion (burg_lpc, below) streamed every step's [B, n_frames, L]
float64 windows through device memory. The kernel frames the pre-emphasised
clips with the float64 window, runs each frame's float64 recursion in one
warp's registers and writes only the coefficients a[1:]. One launch a
call. The result is [B, order, n_frames] in the plain version's memory
layout, frame-major (strides (n_frames order, 1, order)): the features'
z-norm sums in memory order, so another layout would move the lpc channel
at the rounding level.

Call the wrapper through the module, as `lpc_kernel.lpc_frames(...)`,
never as a name imported from it: utils/feature_roofline.count_kernels swaps
the module's attribute to count the kernel's bytes, and an imported name
would escape the count.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build

MAX_ORDER = 31  # lane j of a frame's warp holds a[j] (csrc: kMaxOrder)
MAX_FRAME = 1025  # 32 samples of each window a lane (csrc)

LAUNCHES = 0


def burg_lpc(frames: torch.Tensor, order: int) -> torch.Tensor:
    """AR coefficients [..., order+1] (a[0] = 1) of each frame [..., n];
    frames whose result is not finite get zeros (the reference's
    failure -> zeros semantics)."""
    fwd = frames[..., 1:]
    bwd = frames[..., :-1]
    den = (fwd * fwd).sum(-1) + (bwd * bwd).sum(-1)
    ar = torch.zeros(*frames.shape[:-1], order + 1, dtype=frames.dtype,
                     device=frames.device)
    ar[..., 0] = 1.0
    for i in range(order):
        reflect = -2.0 * (bwd * fwd).sum(-1) / den
        # ar[j] += reflect * ar[i + 1 - j] for 1 <= j <= i + 1
        rev = torch.flip(ar[..., :i + 1], dims=(-1,))
        upd = ar[..., 1:i + 2] + reflect[..., None] * rev
        ar = torch.cat([ar[..., :1], upd, ar[..., i + 2:]], dim=-1)
        fwd_new = fwd + reflect[..., None] * bwd
        bwd_new = bwd + reflect[..., None] * fwd
        fwd, bwd = fwd_new[..., 1:], bwd_new[..., :-1]
        # the sum over the shrunk windows, not librosa's incremental
        # q * den - edges update (same value, no cancellation)
        den = (fwd * fwd).sum(-1) + (bwd * bwd).sum(-1)
    ok = torch.isfinite(ar).all(dim=-1, keepdim=True)
    return torch.where(ok, ar, 0.0)


def lpc_frames_plain(y_emph: torch.Tensor, window: torch.Tensor, hop: int,
                     n_frames: int, order: int) -> torch.Tensor:
    """Plain PyTorch version: y_emph [B, n], window [L] float64 ->
    [B, order, n_frames] f32, the frames y_emph[t hop:t hop + L] * window
    in float64 through burg_lpc."""
    frames = spectral.frame_signal(y_emph.double(), window.shape[0], hop,
                                   n_frames) * window
    coeffs = burg_lpc(frames, order)  # [B, n_frames, order+1]
    return coeffs[..., 1:].transpose(-1, -2).float()


def lpc_frames(y_emph: torch.Tensor, window: torch.Tensor, hop: int,
               n_frames: int, order: int) -> torch.Tensor:
    """y_emph [B, n] f32 (pre-emphasised clips), window [L] float64 ->
    [B, order, n_frames] f32: a[1:] of the Burg LPC of each frame
    y_emph[t hop:t hop + L] * window. CPU tensors run the plain version;
    CUDA tensors run the kernel."""
    global LAUNCHES
    if y_emph.dim() != 2 or window.dim() != 1:
        raise ValueError(f"y_emph {tuple(y_emph.shape)}, window "
                         f"{tuple(window.shape)}: want [B, n] and [L]")
    frame_len, n = window.shape[0], y_emph.shape[1]
    if not 2 <= frame_len <= MAX_FRAME or not 1 <= order <= MAX_ORDER:
        raise ValueError(f"frame {frame_len}, order {order}: want 2 <= frame "
                         f"<= {MAX_FRAME} and 1 <= order <= {MAX_ORDER}")
    if hop < 1 or n_frames < 1 or (n_frames - 1) * hop + frame_len > n:
        raise ValueError(f"{n_frames} frames of {frame_len} at hop {hop}: "
                         f"want at least one, all inside {n} samples")
    if y_emph.device.type == "cpu" and window.device.type == "cpu":
        return lpc_frames_plain(y_emph, window, hop, n_frames, order)
    if y_emph.device.type != "cuda" or window.device != y_emph.device:
        raise ValueError(f"y_emph on {y_emph.device}, window on "
                         f"{window.device}: want one CUDA device")
    if (y_emph.dtype != torch.float32 or window.dtype != torch.float64
            or not (y_emph.is_contiguous() and window.is_contiguous())):
        raise TypeError("lpc kernel takes contiguous float32 clips and a "
                        "contiguous float64 window")
    b = y_emph.shape[0]
    out = torch.empty(b, n_frames, order, dtype=torch.float32,
                      device=y_emph.device)
    stream = torch.cuda.current_stream(y_emph.device).cuda_stream
    rc = _build.lib().burg_lpc_launch(
        y_emph.data_ptr(), window.data_ptr(), out.data_ptr(), b, n,
        int(hop), frame_len, int(n_frames), int(order), stream)
    _build.check(rc, "burg_lpc_launch")
    LAUNCHES += 1
    return out.transpose(1, 2)
