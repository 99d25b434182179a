"""Kernel D: direct |CQT| at tuning 0 (csrc/cqt_kernel.cu).

Counterpart of tpu_breath/ops/pallas/cqt_kernel.py::cqt_mag_pallas: each
clip's signal stays in fast memory while the kernel bank (1/sqrt of each
bin's length folded in, as the Pallas kernel does) streams past it:

    out[b, k, t] = |sum_l ypad[b, hop*t + l] * K[k, l]|,

ypad = y padded by half the longest kernel on the left. The bank rows are
centred windows of their own length (25,412 samples at C1 down to 202 at
the top bin). The kernel's work is cut on the host into items, each a
group of BINS adjacent bins over a group of FRAMES frames, summed over the
group's widest window clipped to the samples where its frames meet the
clip: that computes the same function, since every term left out is zero.
work_table deals the items of a clip to the warps of `shares` blocks by
cost, so that small batches spread a clip over many SMs. No path of the
system calls it: the CENS channel runs the multirate CQT (ops/cqt.py).
"""
from __future__ import annotations

import functools
import heapq

import numpy as np
import torch

from tpu_breath_torch.baseline import dsp_np as _oracle
from tpu_breath_torch.ops import cqt as cqt_ops
from tpu_breath_torch.ops import spectral
from tpu_breath_torch.ops.cuda import _build

TILE_L = 256  # the Pallas kernel's L tile: the bank is padded to it
BINS = 4      # bins a work item sums (csrc: kBins)
FRAMES = 16   # frames a work item sums, or half of them (csrc: kFrames)
WARPS = 8     # warps a block, one block an SM (csrc: kWarps)
LANES = 32    # samples a step of an item's loop, one a lane
SMEM_LIMIT = 232_448  # bytes of shared memory a block may opt in to: the
                      # staged row (staged_len floats) up to this, else the
                      # row is staged in device memory
REDUCE_STEPS = 4  # an item's butterfly and stores, in steps of its loop
HALF_STEP = 0.85  # a step of a half item (FRAMES // 2 frames), in steps:
                  # latency-bound, nearly a whole one (measured)

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel_bank(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                 ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(k_re, k_im [n_bins, L_pad] f32, half, l_pad): conj(kernels) /
    sqrt(length), zero-padded to a multiple of TILE_L samples: the rows of
    tpu_breath/ops/pallas/cqt_kernel.py::_kernel_bank that hold bins (it
    pads the bins to a multiple of 128 too)."""
    kernels, lengths = _oracle.cqt_kernel_bank(sr, fmin, n_bins,
                                               bins_per_octave)
    max_len = kernels.shape[1]
    l_pad = -(-max_len // TILE_L) * TILE_L
    bank = np.zeros((n_bins, l_pad), dtype=np.complex128)
    bank[:, :max_len] = np.conj(kernels) / np.sqrt(lengths)[:, None]
    return (bank.real.astype(np.float32), bank.imag.astype(np.float32),
            max_len // 2, l_pad)


@functools.lru_cache(maxsize=None)
def bank_windows(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                 ) -> np.ndarray:
    """[n_bins, 2] int32: each bank row's nonzero window [lo, hi)."""
    k_re, k_im = _kernel_bank(sr, fmin, n_bins, bins_per_octave)[:2]
    out = np.zeros((n_bins, 2), np.int32)
    for k in range(n_bins):
        nz = np.flatnonzero((k_re[k] != 0) | (k_im[k] != 0))
        if nz.size:
            out[k] = nz[0], nz[-1] + 1
    return out


@functools.lru_cache(maxsize=None)
def group_windows(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                  ) -> np.ndarray:
    """[ceil(n_bins / BINS), 2] int64: each group of BINS adjacent bins'
    window [lo, hi), the union of its members' (their widest: they nest)."""
    win = bank_windows(sr, fmin, n_bins, bins_per_octave).astype(np.int64)
    out = np.zeros((-(-n_bins // BINS), 2), np.int64)
    for g in range(len(out)):
        w = win[g * BINS:(g + 1) * BINS]
        w = w[w[:, 1] > w[:, 0]]
        if len(w):
            out[g] = w[:, 0].min(), w[:, 1].max()
    return out


@functools.lru_cache(maxsize=None)
def _packed(sr: int, fmin: float, n_bins: int, bins_per_octave: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """(bank [rows, 2 BINS] f32, the row of each group's first sample):
    group g's rows, one a sample l of its window and LANES zero rows after
    it (for the last step's overrun), hold the re then the im values of its
    BINS bins at l (zero past n_bins)."""
    k_re, k_im = _kernel_bank(sr, fmin, n_bins, bins_per_octave)[:2]
    gw = group_windows(sr, fmin, n_bins, bins_per_octave)
    lens = gw[:, 1] - gw[:, 0] + LANES
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    bank = np.zeros((int(lens.sum()), 2 * BINS), np.float32)
    for g, (lo, hi) in enumerate(gw):
        for j in range(min(BINS, n_bins - g * BINS)):
            rows = slice(first[g], first[g] + hi - lo)
            bank[rows, j] = k_re[g * BINS + j, lo:hi]
            bank[rows, BINS + j] = k_im[g * BINS + j, lo:hi]
    return bank, first


def packed_bank(*key) -> np.ndarray:
    """The bank packed by group for the kernel (_packed)."""
    return _packed(*key)[0]


def staged_pad(hop: int) -> int:
    """Zeros before the clip in the row a block stages: FRAMES - 1 hops,
    the most an item's frames reach before the clip."""
    return hop * (FRAMES - 1)


def staged_len(n: int, hop: int) -> int:
    """Floats of the row a block stages: the clip with staged_pad zeros on
    each side and LANES after (the last step's overrun), rounded up to a
    multiple of 4."""
    return -(-(n + 2 * staged_pad(hop) + LANES) // 4) * 4


@functools.lru_cache(maxsize=None)
def work_items(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
               hop: int, n: int) -> np.ndarray:
    """[n_items, 6] int64, one row an item: (k0, t0, l0, steps, sig_off,
    bank_off). The item sums bins k0 .. k0 + BINS - 1 (those < n_bins) and
    frames t0 .. t0 + FRAMES - 1 (those < 1 + n // hop) over l = l0 + i,
    i < LANES * steps: its group's window clipped to where one of its frames
    meets the clip, rounded up to whole steps (the extra terms are zero).
    sig_off, bank_off: l0's place in the staged row (for frame t0) and in
    the packed bank."""
    half = _kernel_bank(sr, fmin, n_bins, bins_per_octave)[2]
    gw = group_windows(sr, fmin, n_bins, bins_per_octave)
    first = _packed(sr, fmin, n_bins, bins_per_octave)[1]
    n_frames = 1 + n // hop
    pad = staged_pad(hop)
    items = []
    for g, (lo, hi) in enumerate(gw):
        for t0 in range(0, n_frames, FRAMES):
            l0 = max(lo, half - hop * (t0 + FRAMES - 1))
            l1 = min(hi, half + n - hop * t0)
            steps = max(0, -(-(l1 - l0) // LANES))
            items.append((g * BINS, t0, l0, steps,
                          pad - half + hop * t0 + l0, first[g] + l0 - lo))
    items = np.array(items, np.int64)
    _check_items(items, gw, first, hop, n)
    return items


def _check_items(items: np.ndarray, gw: np.ndarray, first: np.ndarray,
                 hop: int, n: int) -> None:
    """Raise unless every item's reads stay inside the staged row and its
    group's rows of the packed bank (their LANES zeros after included)."""
    k0, t0, l0, steps, sig_off, bank_off = items.T
    g = k0 // BINS
    span = LANES * steps  # samples read from l0 on
    if not ((sig_off >= 0).all() and (k0 < 1 << 16).all()
            and (t0 < 1 << 15).all()
            and (sig_off + span + hop * (FRAMES - 1) <= staged_len(n, hop)
                 ).all()
            and (bank_off >= first[g]).all()
            and (bank_off + span <= first[g] + gw[g, 1] - gw[g, 0] + LANES
                 ).all()):
        raise AssertionError("kernel D's work items leave the staged row "
                             "or the packed bank")


@functools.lru_cache(maxsize=None)
def work_table(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
               hop: int, n: int, shares: int) -> np.ndarray:
    """The kernel's table for `shares` blocks a clip, int32: the offsets of
    the items of each of the shares * WARPS warps ([slots + 1], padded to a
    multiple of 4), then 4 ints an item (k0 | t0 << 16 | half << 31,
    sig_off, bank_off, steps). Items go longest first to the least loaded
    warp, costing steps + REDUCE_STEPS; a warp runs its items longest
    first. An item that costs more than a warp's mean load (B = 8 and
    below on 132 SMs) is cut into two halves of FRAMES // 2 frames over
    the same samples, costing steps * HALF_STEP + REDUCE_STEPS: each
    output's sum is the same, so the bits do not depend on B."""
    items = work_items(sr, fmin, n_bins, bins_per_octave, hop, n)
    slots = shares * WARPS
    mean = (items[:, 3] + REDUCE_STEPS).sum() / slots
    rows, cost = [], []  # (k0, t0, half, sig_off, bank_off, steps)
    for k0, t0, _, steps, sig_off, bank_off in items:
        if steps + REDUCE_STEPS <= mean:
            rows.append((k0, t0, 0, sig_off, bank_off, steps))
            cost.append(steps + REDUCE_STEPS)
            continue
        for h in (0, FRAMES // 2):
            rows.append((k0, t0 + h, 1, sig_off + hop * h, bank_off, steps))
            cost.append(steps * HALF_STEP + REDUCE_STEPS)
    owned = _deal(cost, slots)
    head = -(-(slots + 1) // 4) * 4
    table = np.zeros(head + 4 * len(rows), np.int64)
    table[1:slots + 1] = np.cumsum([len(o) for o in owned])
    k0, t0, half, sig_off, bank_off, steps = np.array(
        [rows[i] for o in owned for i in o], np.int64).T
    word = k0 | t0 << 16 | half << 31
    table[head:] = np.stack([word - (half << 32), sig_off, bank_off, steps],
                            axis=1).ravel()
    return table.astype(np.int32)


def _deal(cost: list, slots: int) -> list[list[int]]:
    """Indices of `cost` dealt to `slots` lists, longest first to the least
    loaded list."""
    heap = [(0.0, w) for w in range(slots)]
    owned: list[list[int]] = [[] for _ in range(slots)]
    for i in sorted(range(len(cost)), key=lambda i: (-cost[i], i)):
        load, w = heapq.heappop(heap)
        owned[w].append(i)
        heapq.heappush(heap, (load + cost[i], w))
    return owned


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cqt_mag_plain(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
                  n_bins: int, bins_per_octave: int) -> torch.Tensor:
    """Plain PyTorch version: the float64 direct |CQT| of ops/cqt.py."""
    return cqt_ops.cqt_mag(y, sr, hop_length, fmin, n_bins, bins_per_octave)


def cqt_mag(y: torch.Tensor, sr: int, hop_length: int, fmin: float,
            n_bins: int, bins_per_octave: int) -> torch.Tensor:
    """|CQT| of y[B, n] f32 -> [B, n_bins, 1 + n//hop] f32, librosa
    scale=True semantics at tuning 0. CPU tensors run the plain version;
    CUDA tensors run the kernel at any hop and length: a row whose staged
    copy (staged_len) fits shared memory (at hop 256, n up to ~50,000) is
    staged there by the kernel; a longer one is staged here in device
    memory, and the kernel's second instantiation reads it from there."""
    global LAUNCHES
    if y.dim() != 2:
        raise ValueError(f"y {tuple(y.shape)}: want [B, n_samples]")
    if y.device.type == "cpu":
        return cqt_mag_plain(y, sr, hop_length, fmin, n_bins,
                             bins_per_octave)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise TypeError("cqt kernel takes a contiguous float32 tensor")
    b, n = y.shape
    sig_len = staged_len(n, hop_length)
    pad = staged_pad(hop_length)
    staged = sig_len * 4 > SMEM_LIMIT
    if staged:  # the rows, staged in device memory as a block stages them
        y = torch.nn.functional.pad(y, (pad, sig_len - pad - n))
    key = (sr, fmin, n_bins, bins_per_octave)
    shares = max(1, _sm_count(y.device.index or 0) // max(b, 1))
    bank = spectral.device_const(packed_bank, *key, device=y.device)
    table = spectral.device_const(work_table, *key, hop_length, n, shares,
                                  device=y.device, dtype=torch.int32)
    n_frames = 1 + n // hop_length
    out = torch.empty(b, n_bins, n_frames, dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _build.lib().cqt_mag_launch(
        y.data_ptr(), bank.data_ptr(), table.data_ptr(), out.data_ptr(), b,
        n, pad, sig_len, hop_length, n_bins, n_frames, shares, int(staged),
        stream)
    _build.check(rc, "cqt_mag_launch")
    LAUNCHES += 1
    return out
