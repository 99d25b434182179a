"""Kernels B and B': the gammatone-channel epilogue (csrc/epilogue_kernel.cu).

Counterpart of tpu_breath/ops/pallas/epilogue_kernel.py::fused_epilogue:
z-normed log1p(fb @ |S|) over each whole clip.
- B (plain=False, the default): the product accumulates in float64 and
  log1p is rounded once, because this channel's z-score divides by a std of
  ~0.005 on quiet clips and amplifies f32 accumulation error past the
  parity budget. The kernel runs the product on the float64 tensor cores,
  the filterbank-and-z-score stage it shares with kernel B''.
- B' (plain=True, the JAX kernel's name for it): native f32 product and
  log1p, the like-for-like partner of a plain f32 GEMM at HIGHEST
  precision: the same kernel with each output one f32 FMA chain on the
  CUDA cores (no TF32, no tensor cores).
Both take any shape and sum the z-score in the same tile order, so a
clip's rows depend neither on B nor on its place in the batch. A clip past
one block's tiles (F > MAX_FREQS, T > MAX_FRAMES or G > MAX_BANDS) runs the
kernel's range instantiation: the same tiles in ranges, the log1p values
kept in the output until the z-score's second pass.

Call the wrapper through the module, as
`epilogue_kernel.fused_epilogue(...)`, never as a name imported from it:
utils/feature_roofline.count_kernels swaps the module's attribute to count
the kernel's bytes, and an imported name would escape the count.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import _build

# one block's tiles: |S| padded to MAX_FREQS x MAX_FRAMES, fb to MAX_BANDS
# rows (the .cu's kMaxF, kRows, kBands); larger clips go in ranges of these
MAX_FREQS = 264
MAX_FRAMES = 64
MAX_BANDS = 64

LAUNCHES = 0      # kernel B
LAUNCHES_F32 = 0  # kernel B'


def znorm_clip(gt: torch.Tensor) -> torch.Tensor:
    """z-score of each [G, T] clip of gt [B, G, T] f32, its mean and variance
    taken as float64 sums rounded to f32, as the kernels do."""
    mean = gt.double().mean(dim=(-2, -1), keepdim=True).float()
    d = gt - mean
    var = d.double().square().mean(dim=(-2, -1), keepdim=True).float()
    return d / (torch.sqrt(var) + 1e-8)


def fused_epilogue_plain(mag: torch.Tensor, fb: torch.Tensor,
                         plain: bool = False) -> torch.Tensor:
    """Plain PyTorch version: mag [B, F, T], fb [G, F] -> [B, G, T] f32.
    plain=False: float64 product, log1p rounded once; plain=True: an f32
    matmul (TF32 off) and f32 log1p."""
    if plain:
        return znorm_clip(torch.log1p(torch.matmul(fb.float(), mag.float())))
    return znorm_clip(torch.log1p(torch.matmul(fb.double(),
                                               mag.double())).float())


def fused_epilogue(mag: torch.Tensor, fb: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """z-normed log1p(fb @ mag) per clip: mag [B, F, T], fb [G, F] f32.
    CPU tensors run the plain version; CUDA tensors run kernel B (plain=False)
    or B' (plain=True)."""
    global LAUNCHES, LAUNCHES_F32
    if mag.dim() != 3 or fb.dim() != 2 or fb.shape[1] != mag.shape[1]:
        raise ValueError(f"mag {tuple(mag.shape)} / fb {tuple(fb.shape)}: "
                         "want [B, F, T] and [G, F]")
    if mag.device.type == "cpu":
        return fused_epilogue_plain(mag, fb, plain)
    if mag.device.type != "cuda" or fb.device != mag.device:
        raise ValueError(f"unsupported devices {mag.device}/{fb.device}")
    if mag.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("epilogue kernel takes float32 mag and fb")
    if not (mag.is_contiguous() and fb.is_contiguous()):
        raise ValueError("epilogue kernel takes contiguous tensors")
    b, f, t = mag.shape
    g = fb.shape[0]
    if min(f, t, g) < 1:
        raise ValueError(f"F {f}, T {t}, G {g}: want F, T, G >= 1")
    out = torch.empty(b, g, t, dtype=torch.float32, device=mag.device)
    stream = torch.cuda.current_stream(mag.device).cuda_stream
    rc = _build.lib().fused_epilogue_launch(
        mag.data_ptr(), fb.data_ptr(), out.data_ptr(), b, f, t, g,
        int(plain), stream)
    _build.check(rc, "fused_epilogue_launch")
    if plain:
        LAUNCHES_F32 += 1
    else:
        LAUNCHES += 1
    return out
