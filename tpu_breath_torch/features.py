"""The batched wav -> (9-channel spectrogram stack, scalar vector) graph
(counterpart of tpu_breath/features.py).

Channel order at the model boundary is alphabetical: chroma, gammatone, lpc,
mel, mel_delta, mel_delta2, mfcc, mod_spec, tempogram.

The gammatone channel has two backends, as in the JAX package: kernel B on
the shared round-once |STFT_512| (the default), or kernel B'' from the raw
frames (fused_gt=True). Left unset, fused_gt is read from the JAX package's
switch, TPU_BREATH_PALLAS_GT=1, at every call.

extract_features runs the graph eagerly, op by op: it is the reference.
extract_features_compiled is the JAX package's _extract_jit: on the card
one captured CUDA graph per (device, shape, spec, fused_gt), replayed
(graphs.py); extract_features_batched queues those replays chunk by chunk
and waits on the host once, and under an NCCL mesh so does
_extract_sharded, the ranks' rows gathered on the device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from tpu_breath_torch import graphs
from tpu_breath_torch.config import DEFAULT_FEATURES, FeatureSpec
from tpu_breath_torch.device import resolve_device
from tpu_breath_torch.ops import cepstral, chroma as chroma_ops
from tpu_breath_torch.ops import cqt as cqt_ops
from tpu_breath_torch.ops import lpc as lpc_ops
from tpu_breath_torch.ops import rhythm, scalars as scalar_ops, spectral
from tpu_breath_torch.ops.cuda import epilogue_kernel, gammatone_kernel


def _zn(x):
    return spectral.znorm(x, axes=(-2, -1))


def _zn_rows(x):
    return spectral.znorm(x, axes=(-1,))


def _pads(x, spec: FeatureSpec):
    return spectral.pad_freq_min(spectral.pad_time_min(x, spec.t_fixed),
                                 spec.n_mels)


def _gammatone(y: torch.Tensor, stft512: torch.Tensor, spec: FeatureSpec,
               fused_gt: bool) -> torch.Tensor:
    """z-normed log1p(64-band mel filterbank @ |STFT_512|) [B, 64, T]."""
    fb = spectral.device_const(spectral.mel_matrix, spec.sr, spec.n_fft,
                               spec.n_gammatone, device=y.device)
    if not fused_gt:
        return epilogue_kernel.fused_epilogue(stft512, fb)
    n_fft, hop = spec.n_fft, spec.hop_length
    yp = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2))
    frames = spectral.frame_signal(yp, n_fft, hop, 1 + y.shape[-1] // hop)
    basis = spectral.device_const(spectral.framedft_basis, n_fft,
                                  device=y.device)
    return gammatone_kernel.fused_gammatone(frames.contiguous(), basis, fb)


@torch.no_grad()
def extract_features(y: torch.Tensor, spec: FeatureSpec = DEFAULT_FEATURES,
                     fused_gt: bool | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """y[B, 16000] f32 -> (features [B, 9, 128, 63], scalars [B, 36]), on
    y's device. fused_gt computes the gammatone channel with kernel B''
    (frames -> DFT -> |S| -> epilogue) instead of kernel B; None reads
    TPU_BREATH_PALLAS_GT now."""
    if y.dim() != 2:
        raise ValueError(f"y {tuple(y.shape)}: want [B, n_samples]")
    if fused_gt is None:
        fused_gt = gt_switch()
    with spectral.full_f32():
        return _extract(y.float(), spec, fused_gt)


def gt_switch() -> bool:
    """The JAX package's TPU_BREATH_PALLAS_GT switch, read now."""
    return os.environ.get("TPU_BREATH_PALLAS_GT", "0") == "1"


_GRAPHS: dict = {}


@torch.no_grad()
def extract_features_compiled(y: torch.Tensor,
                              spec: FeatureSpec = DEFAULT_FEATURES,
                              fused_gt: bool | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """extract_features as one CUDA graph replay
    (tpu_breath/features.py::_extract_jit).

    On the card: one graph per (device, y's shape, spec, fused_gt),
    captured at the first call of that key after one eager warm call, kept
    for the process. No global flag enters the key: the graph sets its own
    TF32 switches (spectral.full_f32) and runs no cuDNN operation. A call
    copies y into the graph's input buffer and replays it without waiting
    on the host. It returns the graph's static output buffers, which the
    next call of the same key overwrites: copy what you keep first.
    Elsewhere (a CPU tensor, or inside graphs.eager()) it is
    extract_features and returns new tensors. fused_gt None reads
    TPU_BREATH_PALLAS_GT now, as the JAX package passes it as a static
    argument."""
    if fused_gt is None:
        fused_gt = gt_switch()
    if not graphs.replays(y.device):
        return extract_features(y, spec, fused_gt)
    key = (y.device, tuple(y.shape), spec, fused_gt)
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _GRAPHS[key] = graphs.Graph(
            lambda x: extract_features(x, spec, fused_gt), (y.float(),),
            y.device)
    return graph(y)


def _extract(y: torch.Tensor, spec: FeatureSpec, fused_gt: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    sr, hop, n_fft = spec.sr, spec.hop_length, spec.n_fft

    # mel + deltas
    mel_spec = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                       n_mels=spec.n_mels, fmax=spec.fmax)
    mel_db = spectral.power_to_db(mel_spec, ref_max=True)
    mel_c = _pads(_zn(mel_db), spec)
    d1_c = _pads(_zn(cepstral.delta(mel_db, order=1)), spec)
    d2_c = _pads(_zn(cepstral.delta(mel_db, order=2)), spec)

    # mfcc stack: 40 + delta + delta2 rows, per-row z-score, min-padded
    mf = cepstral.mfcc(y, sr, spec.n_mfcc, hop, n_fft)
    mf_all = torch.cat([mf, cepstral.delta(mf, order=1),
                        cepstral.delta(mf, order=2)], dim=-2)
    mfcc_c = _pads(_zn_rows(mf_all), spec)

    # shared 2048-point spectrograms: onset-strength mel, scalar
    # descriptors' |STFT|/mel, and the CENS tuning estimate
    p2048 = spectral.stft_power64(y, 2048, hop)          # [B, T, F] f64
    stft2048_mag = torch.sqrt(p2048).float().transpose(-1, -2)
    mel2048_power = spectral.mel_from_power64(p2048, sr, 2048, spec.n_mels)

    # chroma_stft + chroma_cens; the round-once |STFT_512| also feeds the
    # gammatone channel and the scalars
    stft512 = spectral.stft_mag_cr(y, n_fft, hop).contiguous()
    ch = chroma_ops.chroma_stft(stft512, sr)
    cens = cqt_ops.chroma_cens(y, sr, hop, spec.cqt_fmin,
                               bins_per_octave=spec.cqt_bins_per_octave,
                               n_octaves=spec.cqt_n_octaves,
                               win_len_smooth=spec.cens_win_len_smooth,
                               stft2048_mag=stft2048_mag)
    chroma_c = _pads(_zn_rows(torch.cat([ch, cens], dim=-2)), spec)

    gt_c = _pads(_gammatone(y, stft512, spec, fused_gt), spec)

    lpc_c = _pads(_zn(lpc_ops.lpc_features(y, spec.n_lpc, sr)), spec)
    mod_c = _pads(_zn(cepstral.mod_spec(mel_db, n_keep=40)), spec)

    onset = rhythm.onset_strength(y, sr, hop, mel_power=mel2048_power)
    tempo_c = _pads(_zn(rhythm.tempogram(onset, spec.tempogram_win_length)),
                    spec)

    scalars = scalar_ops.extract_scalars(y, sr, hop, n_fft, spec.n_mels,
                                         stft512_mag=stft512,
                                         stft2048_mag=stft2048_mag,
                                         mel2048_power=mel2048_power)
    by_name = {
        "mel": mel_c, "mfcc": mfcc_c, "chroma": chroma_c,
        "mel_delta": d1_c, "mel_delta2": d2_c, "gammatone": gt_c,
        "lpc": lpc_c, "mod_spec": mod_c, "tempogram": tempo_c,
    }
    feats = torch.stack([by_name[k] for k in spec.channel_order], dim=-3)
    return feats, scalars


def extract_features_batched(wavs: np.ndarray,
                             spec: FeatureSpec = DEFAULT_FEATURES,
                             chunk: int = 128, device="cuda", mesh=None,
                             fused_gt: bool | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """wavs[N, 16000] -> numpy (features [N, 9, 128, 63], scalars [N, 36]),
    in chunks of `chunk` clips on `device`, the tail chunk padded with
    silence to `chunk` clips (one shape, as the JAX package pads it) and
    its padding dropped. On the card each chunk is a replay of
    extract_features_compiled's graph: its wavs go up from pinned memory,
    its outputs down into pinned buffers, all queued on the current stream,
    and the host waits once, at the end. Under a data-parallel mesh
    (parallel/mesh.py) the ranks share the chunks (_extract_sharded: on
    NCCL queued the same way, with one wait) and every rank returns the
    whole arrays. fused_gt as extract_features, read once a call."""
    if mesh is not None:
        return _extract_sharded(wavs, spec, chunk, mesh, fused_gt)
    device = resolve_device(device)
    if fused_gt is None:
        fused_gt = gt_switch()
    n = wavs.shape[0]
    n_pad = -(-n // chunk) * chunk
    cuda = device.type == "cuda"
    y = torch.zeros((n_pad, wavs.shape[1]), dtype=torch.float32,
                    pin_memory=cuda)
    y[:n] = torch.from_numpy(np.asarray(wavs, np.float32))
    feats = torch.empty((n_pad, spec.n_channels, spec.n_mels, spec.t_fixed),
                        dtype=torch.float32, pin_memory=cuda)
    scals = torch.empty((n_pad, spec.n_scalars), dtype=torch.float32,
                        pin_memory=cuda)
    for lo in range(0, n_pad, chunk):
        x = y[lo:lo + chunk]
        f, s = extract_features_compiled(x.to(device, non_blocking=True)
                                         if cuda else x, spec, fused_gt)
        feats[lo:lo + chunk].copy_(f, non_blocking=True)
        scals[lo:lo + chunk].copy_(s, non_blocking=True)
    if cuda:
        graphs.wait(device)
    return feats.numpy()[:n], scals.numpy()[:n]


def _extract_sharded(wavs: np.ndarray, spec: FeatureSpec, chunk: int,
                     mesh, fused_gt: bool | None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Data-parallel extraction (tpu_breath/features.py::_extract_sharded):
    every rank holds all the wavs; a super-chunk is mesh.world * chunk
    clips (the last one padded with silence, so the geometry stays fixed),
    rank r extracts its rows [r chunk, (r + 1) chunk) through
    extract_features_compiled on its device (a replay of the chunk graph
    on the card), and the ranks' rows are all-gathered, so every rank
    returns the whole arrays (JAX's process_allgather).

    On an NCCL mesh the rows are gathered into device buffers and copied
    down into pinned host arrays, every super-chunk queued on the current
    stream, and the host waits once, at the end (as
    extract_features_batched does; inside graphs.eager() the chunks run
    eagerly in the same queue). On a gloo mesh, whose collectives take
    host tensors here, the rank's rows come down with one host wait a
    super-chunk and are gathered on the host."""
    from tpu_breath_torch.parallel import mesh as mesh_lib

    if fused_gt is None:
        fused_gt = gt_switch()
    n = wavs.shape[0]
    device = mesh.device
    cuda = device.type == "cuda"
    queued = mesh.backend == "nccl"
    super_chunk = chunk * mesh.world
    n_pad = -(-n // super_chunk) * super_chunk
    y = torch.zeros((n_pad // mesh.world, wavs.shape[1]), dtype=torch.float32,
                    pin_memory=cuda)  # this rank's rows, super-chunk by one
    for k, lo in enumerate(range(0, n, super_chunk)):
        part = wavs[lo + mesh.rank * chunk:min(lo + (mesh.rank + 1) * chunk,
                                               n)]
        y[k * chunk:k * chunk + len(part)] = torch.from_numpy(
            np.asarray(part, np.float32))
    shapes = ((spec.n_channels, spec.n_mels, spec.t_fixed), (spec.n_scalars,))
    host = [torch.empty((n_pad,) + sh, dtype=torch.float32, pin_memory=cuda)
            for sh in shapes]
    # the gathers' device buffers (NCCL), reused in stream order; or the
    # rank's rows on the host (gloo)
    gathered = [torch.empty((super_chunk,) + sh, dtype=torch.float32,
                            device=device) for sh in shapes] if queued else ()
    mine = () if queued else [torch.empty((chunk,) + sh, dtype=torch.float32,
                                          pin_memory=cuda) for sh in shapes]
    for k, lo in enumerate(range(0, n_pad, super_chunk)):
        x = y[k * chunk:(k + 1) * chunk]
        out = extract_features_compiled(
            x.to(device, non_blocking=True) if cuda else x, spec, fused_gt)
        if queued:
            for o, g, h in zip(out, gathered, host):
                h[lo:lo + super_chunk].copy_(
                    mesh_lib.all_gather_into(mesh, g, o), non_blocking=True)
            continue
        for o, t in zip(out, mine):
            t.copy_(o, non_blocking=cuda)
        if cuda:
            graphs.wait(device)  # the super-chunk's one wait
        for t, h in zip(mine, host):
            h[lo:lo + super_chunk] = mesh_lib.all_gather_rows(mesh, t)
    if queued:
        graphs.wait(device)
    return host[0].numpy()[:n], host[1].numpy()[:n]
