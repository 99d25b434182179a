"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider
"""
import glob
import os

import numpy as np
import pytest
import torch

from tests import peaks_cases

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def clips():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(9)
    golden = [np.load(p)["wav"] for p in FIXTURES]
    noise = [rng.standard_normal(16000) * a for a in (0.3, 0.01, 1e-3)]
    imp = np.zeros(16000)
    imp[123] = 1.0
    silence = np.zeros(16000)
    plateau = np.round(rng.standard_normal(16000) * 4) / 64
    y = np.stack(golden + noise + [imp, silence, plateau]).astype(np.float32)
    return torch.from_numpy(y).cuda()


def test_tuning_kernel_exact(clips):
    from tpu_breath_torch.ops import chroma, spectral
    from tpu_breath_torch.ops.cuda import tuning_kernel as tk

    for n_fft, bpo, step in ((512, 12, 1), (2048, 36, 2)):
        S = spectral.stft_mag_cr(clips, n_fft, 256)[..., ::step]
        p, m = (t.contiguous() for t in chroma._piptrack_band(S, 16000,
                                                              n_fft))
        got = tk.estimate_tuning_index(p, m, bpo)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.estimate_tuning_index_plain(p, m, bpo))
        assert torch.equal(got.cpu(), tk.estimate_tuning_index(
            p.cpu(), m.cpu(), bpo))


def _adversarial_pairs(n: int, seed: int) -> tuple[np.ndarray, ...]:
    """Rows of (pitch, mag) pairs that stress the order statistics: no valid
    pitch, one, two (k even), k even and odd, equal, negative and signed-zero
    magnitudes, heavy ties, every pitch valid. -> pitches, mags [9, n]."""
    rng = np.random.default_rng(seed)
    half = np.zeros(n, bool)
    half[rng.choice(n, n // 2 - (n // 2) % 2, replace=False)] = True
    odd = half.copy()
    odd[np.flatnonzero(~half)[0]] = True
    few = [np.zeros(n, bool) for _ in range(3)]
    few[1][rng.integers(n)] = True
    few[2][rng.choice(n, 2, replace=False)] = True
    mags = rng.standard_normal(n) ** 2
    zeros = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    zeros[rng.choice(n, 7, replace=False)] = 0.5
    rows = [(few[0], mags), (few[1], mags), (few[2], mags), (half, mags),
            (odd, mags), (half, np.full(n, 0.25)), (half, -mags),
            (half, zeros), (np.ones(n, bool), np.round(mags * 4) / 4)]
    pitch = rng.uniform(30.0, 4000.0, (len(rows), n))
    p = np.stack([np.where(v, pitch[i], 0.0) for i, (v, _) in enumerate(rows)])
    m = np.stack([mg for _, mg in rows])
    return p.astype(np.float32), m.astype(np.float32)


@pytest.mark.parametrize("n", [7875, 15808, 28_000, 28_001, 60_000])
def test_tuning_kernel_exact_on_adversarial_pairs(clips, n):
    """Kernel A equals its plain version exactly on pair sets built to
    break an order statistic, at bpo 12's and 36's pair counts, at
    SMEM_PAIRS (the last clip length whose list stays in shared memory)
    and past it (the list in device memory); no valid pitch gives 50."""
    from tpu_breath_torch.ops.cuda import tuning_kernel as tk

    assert (n <= tk.SMEM_PAIRS) == (n <= 28_000)
    p, m = (torch.from_numpy(a).cuda() for a in _adversarial_pairs(n, n))
    for bpo in (12, 36):
        got = tk.estimate_tuning_index(p, m, bpo)
        torch.cuda.synchronize()
        ref = tk.estimate_tuning_index_plain(p, m, bpo)
        assert torch.equal(got, ref), (bpo, got.tolist(), ref.tolist())
        assert int(got[0]) == 50


def _gammatone_inputs(y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kernel B''s inputs for clips y, as the feature graph builds them."""
    from tpu_breath_torch.ops import spectral

    yp = torch.nn.functional.pad(y, (256, 256))
    frames = spectral.frame_signal(yp, 512, 256, 63).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, 512,
                                  device=y.device)
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=y.device)
    return frames, basis, fb


def _batch(clips: torch.Tensor, b: int, seed: int) -> torch.Tensor:
    """The fixture's clips, then seeded noise, to b clips."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = 0.05 * torch.randn(b, 16000, generator=g, device="cuda")
    return torch.cat([clips, noise])[:b].contiguous()


@pytest.mark.parametrize("b", [1, 8, 128, 130])
def test_gammatone_kernel_vs_plain_at_batch(clips, b):
    """Kernel B'' within 1e-5 of its plain version at B = 1, 8, 128 and
    130 (a batch that fills no whole wave of clusters)."""
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    args = _gammatone_inputs(_batch(clips, b, seed=b))
    got = gk.fused_gammatone(*args)
    torch.cuda.synchronize()
    ref = gk.fused_gammatone_plain(*args)
    assert got.shape == (b, 64, 63)
    assert float((got - ref).abs().max()) <= 1e-5


def test_gammatone_rows_do_not_depend_on_batch(clips):
    """A clip's B'' rows are bit-equal alone (B = 1), as row 0 of a batch
    of 128 and as its row 77: the fused step and the cache give the same
    features wherever a clip sits."""
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    y = _batch(clips, 128, seed=5)
    for c in (0, 3, 6):  # a golden clip, quiet noise, silence
        one = gk.fused_gammatone(*_gammatone_inputs(y[c:c + 1]))
        for row in (0, 77):
            yb = y.clone()
            yb[[row, c]] = yb[[c, row]]
            got = gk.fused_gammatone(*_gammatone_inputs(yb))
            assert torch.equal(got[row], one[0]), (c, row)


def _quiet_and_silent(clips: torch.Tensor, b: int) -> list[torch.Tensor]:
    """Kernel B's test batches: at B = 1 a golden clip, quiet noise (1e-3)
    and silence, each alone; else _batch's b clips, which hold them."""
    if b == 1:
        return [clips[c:c + 1] for c in (0, 4, 6)]
    return [_batch(clips, b, seed=b)]


@pytest.mark.parametrize("b", [1, 8, 128])
def test_epilogue_kernel_vs_plain_at_batch(clips, b):
    """Kernel B within 1e-5 of its plain version at B = 1, 8 and 128, on a
    quiet clip and silence among others."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    for y in _quiet_and_silent(clips, b):
        mag = spectral.stft_mag_cr(y, 512, 256).contiguous()
        got = ek.fused_epilogue(mag, fb)
        torch.cuda.synchronize()
        ref = ek.fused_epilogue_plain(mag, fb)
        assert got.shape == (y.shape[0], 64, 63)
        assert float((got - ref).abs().max()) <= 1e-5


def test_epilogue_rows_do_not_depend_on_batch(clips):
    """A clip's kernel B rows are bit-equal alone (B = 1), as row 0 of a
    batch of 128 and as its row 77, on the same magnitudes."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    mag = spectral.stft_mag_cr(_batch(clips, 128, seed=5), 512,
                               256).contiguous()
    for c in (0, 4, 6):  # a golden clip, quiet noise, silence
        one = ek.fused_epilogue(mag[c:c + 1].contiguous(), fb)
        for row in (0, 77):
            mb = mag.clone()
            mb[[row, c]] = mb[[c, row]]
            got = ek.fused_epilogue(mb, fb)
            assert torch.equal(got[row], one[0]), (c, row)


@pytest.mark.parametrize("b", [1, 8, 128, 130])
def test_epilogue_f32_kernel_vs_plain_at_batch(clips, b):
    """Kernel B' (plain=True) within 5e-5 of its plain version (f32 matmul,
    TF32 off) at B = 1, 8, 128 and 130, on a quiet clip and silence among
    others, one launch a call."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    for y in _quiet_and_silent(clips, b):
        mag = spectral.stft_mag_cr(y, 512, 256).contiguous()
        before = ek.LAUNCHES_F32
        got = ek.fused_epilogue(mag, fb, plain=True)
        torch.cuda.synchronize()
        assert ek.LAUNCHES_F32 == before + 1
        with spectral.full_f32():
            ref = ek.fused_epilogue_plain(mag, fb, plain=True)
        assert got.shape == (y.shape[0], 64, 63)
        assert float((got - ref).abs().max()) <= 5e-5


def test_epilogue_f32_rows_do_not_depend_on_batch(clips):
    """A clip's kernel B' rows are bit-equal alone (B = 1), as row 0 of a
    batch of 128 and as its row 77, on the same magnitudes."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    mag = spectral.stft_mag_cr(_batch(clips, 128, seed=5), 512,
                               256).contiguous()
    for c in (0, 4, 6):  # a golden clip, quiet noise, silence
        one = ek.fused_epilogue(mag[c:c + 1].contiguous(), fb, plain=True)
        for row in (0, 77):
            mb = mag.clone()
            mb[[row, c]] = mb[[c, row]]
            got = ek.fused_epilogue(mb, fb, plain=True)
            assert torch.equal(got[row], one[0]), (c, row)


def test_epilogue_kernel_within_1e5(clips):
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    mag = spectral.stft_mag_cr(clips, 512, 256).contiguous()
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    got = ek.fused_epilogue(mag, fb)
    torch.cuda.synchronize()
    ref = ek.fused_epilogue_plain(mag, fb)
    assert float((got - ref).abs().max()) <= 1e-5


def test_epilogue_f32_variant_within_5e5(clips):
    """Kernel B' (plain=True) against its plain version (f32 matmul, TF32
    off): the JAX test's 5e-5."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    mag = spectral.stft_mag_cr(clips, 512, 256).contiguous()
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    before = ek.LAUNCHES_F32
    got = ek.fused_epilogue(mag, fb, plain=True)
    torch.cuda.synchronize()
    assert ek.LAUNCHES_F32 == before + 1
    with spectral.full_f32():
        ref = ek.fused_epilogue_plain(mag, fb, plain=True)
    assert float((got - ref).abs().max()) <= 5e-5


def test_gammatone_kernel_rejects_a_basis_it_did_not_tile(clips):
    """B'' reads the basis as tiled_basis laid it out once per device: a
    copy of the basis, equal but not the device constant, is refused."""
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    frames, basis, fb = _gammatone_inputs(clips)
    with pytest.raises(ValueError):
        gk.fused_gammatone(frames, basis.clone(), fb)


def test_gammatone_kernel_within_1e5(clips):
    """Kernel B'' against its plain version (float64 matmul, |S| rounded
    once, kernel B's plain epilogue): the JAX test's 1e-5."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    yp = torch.nn.functional.pad(clips, (256, 256))
    frames = spectral.frame_signal(yp, 512, 256, 63).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, 512,
                                  device=clips.device)
    fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                               device=clips.device)
    got = gk.fused_gammatone(frames, basis, fb)
    torch.cuda.synchronize()
    ref = gk.fused_gammatone_plain(frames, basis, fb)
    assert got.shape == (clips.shape[0], 64, 63)
    assert float((got - ref).abs().max()) <= 1e-5


def test_fused_gt_features_on_card(clips):
    """extract_features(fused_gt=True) on the card: the gammatone channel
    within 2e-4 of the default path's, the rest equal."""
    from tpu_breath_torch.features import extract_features

    f0, s0 = extract_features(clips, fused_gt=False)
    f1, s1 = extract_features(clips, fused_gt=True)
    assert float((f0[:, 1] - f1[:, 1]).abs().max()) <= 2e-4  # gammatone
    keep = [0] + list(range(2, 9))
    assert torch.equal(f0[:, keep].nan_to_num(), f1[:, keep].nan_to_num())
    assert torch.equal(s0.nan_to_num(), s1.nan_to_num())


def test_fit_on_card_runs_and_resumes(clips, tmp_path):
    """A tiny fit on the card (CNN8 and VGG, 2 epochs, augmentation from
    epoch 2): finite losses, a checkpoint with the optimizer state, and a
    resumed run that continues."""
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    rng = np.random.default_rng(3)
    y = (np.arange(32) % 2).astype(np.float32)
    f = rng.standard_normal((32, 9, 32, 16)).astype(np.float32) + y[
        :, None, None, None]
    s = rng.standard_normal((32, 36)).astype(np.float32)
    cfg = TrainCfg(num_epochs=2, batch_size=8, eval_batch_size=16,
                   warmup_epochs=1, patience=9)
    for arch in ("cnn8", "vgg"):
        d = str(tmp_path / arch)
        res = loop.fit(registry.build(arch, 36), (f, s), (f, s), y, y, cfg,
                       save_dir=d, log_fn=lambda *_: None)
        assert all(np.isfinite(r["train_loss"]) for r in res.history)
        longer = TrainCfg(**{**cfg.__dict__, "num_epochs": 3})
        again = loop.fit(registry.build(arch, 36), (f, s), (f, s), y, y,
                         longer, save_dir=d, resume=True,
                         log_fn=lambda *_: None)
        assert again.history and again.history[-1]["epoch"] == 3


def test_fit_on_card_is_a_function_of_its_seed(clips, tmp_path):
    """At the default cuDNN flags, two fits of the toy data with one seed
    give equal histories (CNN8 and VGG, augmentation from epoch 3, dropout),
    and a CNN8 run stopped at its 6th epoch line and resumed equals the
    uninterrupted run, bit for bit."""
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    assert not torch.backends.cudnn.deterministic  # fit's scope does it
    rng = np.random.default_rng(42)
    y = (np.arange(32) % 2).astype(np.float32)
    f = (rng.standard_normal((32, 9, 16, 16)).astype(np.float32) * 0.1
         + 2.0 * y[:, None, None, None])
    s = rng.standard_normal((32, 36)).astype(np.float32)
    s[:, 0] = 3.0 * y
    cfg = TrainCfg(num_epochs=10, base_lr=1e-3, batch_size=8,
                   eval_batch_size=16, warmup_epochs=2, patience=99, seed=3)

    def history(arch, log_fn=lambda *_: None, **kw):
        res = loop.fit(registry.build(arch, 36, seed=cfg.seed), (f, s),
                       (f, s), y, y, cfg, log_fn=log_fn, **kw)
        return [{k: v for k, v in r.items() if k != "sec"}
                for r in res.history]

    for arch in ("cnn8", "vgg"):
        assert history(arch) == history(arch)

    class Killed(Exception):
        pass

    def kill_at_6(msg):
        if msg.startswith("[Epoch 006]"):
            raise Killed

    full = history("cnn8", save_dir=str(tmp_path / "full"))
    with pytest.raises(Killed):
        history("cnn8", kill_at_6, save_dir=str(tmp_path / "part"))
    resumed = history("cnn8", save_dir=str(tmp_path / "part"), resume=True)
    assert resumed and resumed[0]["epoch"] > 1
    assert resumed == full[resumed[0]["epoch"] - 1:]


def test_peaks_kernel_exact(clips):
    from tpu_breath_torch.ops import dft, peaks
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    env = dft.hilbert_envelope(clips)
    scores = torch.where(peaks.local_maxima(env)
                         & (env >= env.mean(-1, keepdim=True)), env,
                         -torch.inf).contiguous()
    vals, kept = pk.suppress_peaks(scores, 1600, 12)
    torch.cuda.synchronize()
    rvals, rkept = pk.suppress_peaks_plain(scores, 1600, 12)
    assert torch.equal(kept, rkept)
    assert torch.equal(vals, rvals)


@pytest.mark.parametrize("b", [1, 8, 128])
def test_peaks_kernel_exact_on_adversarial_sets(clips, b):
    """Kernel C equals its plain version exactly (vals and kept) on the
    adversarial score sets of tests/peaks_cases.py: each set alone at
    B = 1, and the sets repeated to fill B = 8 and 128."""
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    by_rounds: dict = {}
    for name, (scores, _, rounds) in sorted(peaks_cases.cases().items()):
        by_rounds.setdefault(rounds, []).append((name, scores))
    for rounds, sets in by_rounds.items():
        rows = np.stack([s for _, s in sets])
        batches = ([(name, s[None]) for name, s in sets] if b == 1 else
                   [("all", np.resize(rows, (b, rows.shape[1])))])
        for name, batch in batches:
            x = torch.from_numpy(batch).cuda()
            vals, kept = pk.suppress_peaks(x, peaks_cases.DISTANCE, rounds)
            torch.cuda.synchronize()
            rvals, rkept = pk.suppress_peaks_plain(x, peaks_cases.DISTANCE,
                                                   rounds)
            assert kept.dtype == torch.bool, name
            assert torch.equal(kept, rkept), name
            assert torch.equal(vals, rvals), name


@pytest.mark.parametrize("n", [40_000, 100_000])
def test_peaks_kernel_exact_on_long_rows(clips, n):
    """Rows past kernel C's shared-memory list (the wrapper then keeps it
    in device memory), B = 8, distance 1,600: vals and kept equal the plain
    version exactly, and the survivor counts equal scipy's find_peaks."""
    import scipy.signal
    from tpu_breath_torch.ops import peaks
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    assert n > pk.SMEM_SAMPLES
    rng = np.random.default_rng(n)
    env = np.abs(scipy.signal.hilbert(rng.standard_normal((8, n)))
                 ).astype(np.float32)
    env[1::2] = np.round(env[1::2] * 64) / 64  # plateaus and ties
    h = env.mean(axis=-1, keepdims=True)
    x = torch.from_numpy(env).cuda()
    scores = torch.where(peaks.local_maxima(x)
                         & (x >= torch.from_numpy(h).cuda()), x,
                         -torch.inf).contiguous()
    rounds = n // 1600 + 2
    vals, kept = pk.suppress_peaks(scores, 1600, rounds)
    torch.cuda.synchronize()
    rvals, rkept = pk.suppress_peaks_plain(scores, 1600, rounds)
    assert torch.equal(kept, rkept)
    assert torch.equal(vals, rvals)
    for i in range(8):
        found, _ = scipy.signal.find_peaks(env[i], height=float(h[i, 0]),
                                           distance=1600)
        assert int(kept[i].sum()) == len(found), i


def _lpc_rows(clips) -> torch.Tensor:
    """The clips (golden wavs, noise, an impulse, silence, a quantized
    clip), a clip with a NaN and one with an inf, then seeded noise: 16
    rows."""
    g = torch.Generator(device="cuda").manual_seed(21)
    bad = clips[:2].clone()
    bad[0, 8000] = torch.nan
    bad[1, 100] = torch.inf
    noise = 0.05 * torch.randn(16 - len(clips) - 2, 16000, generator=g,
                               device="cuda")
    return torch.cat([clips, bad, noise])


@pytest.mark.parametrize("b", [1, 8, 128])
def test_lpc_kernel_vs_plain_at_batch(clips, b):
    """Kernel E against its plain version (the float64 loop) on the card
    at B = 1 (each row alone), 8 and 128 (the rows repeated): coefficients
    within 1e-5 x max(1, |a|), in the plain version's memory layout; the
    frames the plain version zeroes (silence's 0 / 0, a NaN or an inf
    inside) zero in the kernel too, bit for bit, and no other."""
    from tpu_breath_torch.ops import lpc
    from tpu_breath_torch.ops.cuda import lpc_kernel as lk

    rows = _lpc_rows(clips)
    batches = ([rows[i:i + 1] for i in range(len(rows))] if b == 1 else
               [rows.repeat(b // len(rows) + 1, 1)[:b].contiguous()])
    zeroed = 0
    for y in batches:
        args = lpc.lpc_args(y, 16000)
        got = lk.lpc_frames(*args, 12)
        torch.cuda.synchronize()
        ref = lk.lpc_frames_plain(*args, 12)
        assert got.shape == ref.shape == (len(y), 12, 98)
        assert got.stride() == ref.stride()  # the z-norm's summing order
        zero = (ref == 0).all(dim=1, keepdim=True).expand_as(ref)
        assert torch.equal((got == 0).all(dim=1, keepdim=True).expand_as(got),
                           zero)
        assert torch.equal(got[zero], ref[zero])
        err = (got - ref).abs() / ref.abs().clamp(min=1.0)
        assert float(err.max()) <= 1e-5
        zeroed += int(zero[:, 0].sum())
    # silence's frames and the NaN's and the inf's are there to be zeroed
    assert zeroed >= 98 + 3 + 1


@pytest.mark.parametrize("sr", [8000, 22050, 40000])
def test_lpc_kernel_at_other_rates(clips, sr):
    """Kernel E at the frames other sample rates give (200, 551 and 1,000
    samples: past 417 the kernel's second instantiation, 32 samples of
    each window a lane) against its plain version, within 1e-5 x
    max(1, |a|)."""
    from tpu_breath_torch.ops import lpc
    from tpu_breath_torch.ops.cuda import lpc_kernel as lk

    args = lpc.lpc_args(clips, sr)
    got = lk.lpc_frames(*args, 12)
    torch.cuda.synchronize()
    ref = lk.lpc_frames_plain(*args, 12)
    assert args[1].shape[0] == int(0.025 * sr)
    assert got.shape == ref.shape and got.stride() == ref.stride()
    assert torch.equal(got == 0, ref == 0)
    err = (got - ref).abs() / ref.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-5


def test_lpc_rows_do_not_depend_on_batch(clips):
    """Kernel E's rows are bit-equal wherever a clip sits and whatever B:
    each frame's sums run in one warp in an order fixed by its length."""
    from tpu_breath_torch.ops import lpc
    from tpu_breath_torch.ops.cuda import lpc_kernel as lk

    rows = _lpc_rows(clips)
    full = lk.lpc_frames(*lpc.lpc_args(rows, 16000), 12)
    for shift in (1, 5):
        rolled = torch.roll(rows, shift, 0).contiguous()
        got = lk.lpc_frames(*lpc.lpc_args(rolled, 16000), 12)
        assert torch.equal(torch.roll(got, -shift, 0), full)
    for i in (0, 3, len(rows) - 1):
        one = lk.lpc_frames(*lpc.lpc_args(rows[i:i + 1], 16000), 12)
        assert torch.equal(one[0], full[i])


def _captured_node_types(call) -> list[int]:
    """The type (libcuda's CUgraphNodeType, 0 a kernel) of each node of
    the CUDA graph captured from one call."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        call()
    raw = ctypes.c_void_p(int(g.raw_cuda_graph()))
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        types.append(kind.value)
    g.reset()
    return types


@pytest.mark.parametrize("kernel", ["A", "B''", "C", "B", "B'", "D", "E",
                                    "F"])
def test_wrapper_call_is_one_kernel_launch(clips, kernel):
    """One call of kernel A's, B'''s, C's, B's, B''s, D's or E's wrapper on
    CUDA tensors, or of F's evaluation forward, runs one kernel on the card
    and nothing else: a CUDA graph captured from a warm call holds one
    node, a kernel, and the wrapper's launch count went up by one (its
    kernel). Its outputs are allocated, not converted."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops import chroma, spectral
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek
    from tpu_breath_torch.ops import lpc
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk
    from tpu_breath_torch.ops.cuda import lpc_kernel as lk
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk
    from tpu_breath_torch.ops.cuda import tuning_kernel as tk

    if kernel == "A":
        mag = spectral.stft_mag_cr(clips, 512, 256)
        p, m = (t.contiguous() for t in chroma._piptrack_band(mag, 16000,
                                                              512))
        call = lambda: tk.estimate_tuning_index(p, m, 12)
        count = lambda: tk.LAUNCHES
    elif kernel == "B''":
        yp = torch.nn.functional.pad(clips, (256, 256))
        frames = spectral.frame_signal(yp, 512, 256, 1 + 16000 // 256
                                       ).contiguous()
        basis = spectral.device_const(spectral.framedft_basis, 512,
                                      device=clips.device)
        fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                                   device=clips.device)
        call = lambda: gk.fused_gammatone(frames, basis, fb)
        count = lambda: gk.LAUNCHES
    elif kernel == "C":
        scores = torch.from_numpy(np.stack([s for s, _, r in peaks_cases.cases(
        ).values() if r == peaks_cases.ROUNDS])).cuda()
        call = lambda: pk.suppress_peaks(scores, peaks_cases.DISTANCE,
                                         peaks_cases.ROUNDS)
        count = lambda: pk.LAUNCHES
    elif kernel == "D":
        call = lambda: ck.cqt_mag(clips, 16000, 256, SPEC.cqt_fmin, 252, 36)
        count = lambda: ck.LAUNCHES
    elif kernel == "E":
        args = lpc.lpc_args(clips, 16000)
        call = lambda: lk.lpc_frames(*args, SPEC.n_lpc)
        count = lambda: lk.LAUNCHES
    elif kernel == "F":
        from tpu_breath_torch.ops.cuda import bn_act_kernel as fk
        from tpu_breath_torch.utils import kernel_times

        v = kernel_times.bn_act_inputs(64, 32, 16, 8, torch.bfloat16, False,
                                       seed=1)
        call = lambda: fk.bn_act(v["x"], None, v["weight"], v["bias"],
                                 v["running_mean"], v["running_var"],
                                 "bn_gelu", False)
        count = lambda: fk.LAUNCHES
    else:
        mag = spectral.stft_mag_cr(clips, 512, 256).contiguous()
        fb = spectral.device_const(spectral.mel_matrix, 16000, 512, 64,
                                   device=clips.device)
        call = lambda: ek.fused_epilogue(mag, fb, plain=kernel == "B'")
        count = lambda: (ek.LAUNCHES_F32 if kernel == "B'"
                         else ek.LAUNCHES)
    call()
    torch.cuda.synchronize()
    before = count()
    assert _captured_node_types(call) == [0]
    assert count() == before + 1


def _stft_inputs(y: torch.Tensor, t: int, f: int, g: int):
    """|S| [B, f, t] of clips y (n_fft 2 (f - 1), the hop that gives t
    frames) and a mel filterbank [g, f], as the feature graph builds them."""
    from tpu_breath_torch.ops import spectral

    n_fft, hop = 2 * (f - 1), (y.shape[-1] - 1) // (t - 1)
    mag = spectral.stft_mag_cr(y, n_fft, hop)[..., :t].contiguous()
    fb = spectral.device_const(spectral.mel_matrix, 16000, n_fft, g,
                               device=y.device)
    return mag, fb


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("t, f, g", [(65, 257, 64), (200, 257, 64),
                                     (63, 300, 64), (63, 257, 80),
                                     (200, 300, 80)])
def test_epilogue_kernels_take_a_clip_past_their_tiles(clips, plain, t, f,
                                                       g):
    """Kernels B and B' hold a clip of up to 64 frames, 264 frequencies and
    64 bands in one block's tiles; past that they walk it in ranges of those
    tiles (the JAX kernel takes any shape): at T = 65 and 200, F = 300 and
    G = 80, one launch and within 1e-5 (B) or 5e-5 (B') of the plain
    version, the quiet and silent clips included."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import epilogue_kernel as ek

    y = clips  # golden wavs, loud and quiet noise, impulse, silence, ...
    mag, fb = _stft_inputs(y, t, f, g)
    assert mag.shape[1:] == (f, t)
    before = (ek.LAUNCHES, ek.LAUNCHES_F32)
    got = ek.fused_epilogue(mag, fb, plain=plain)
    torch.cuda.synchronize()
    assert (ek.LAUNCHES - before[0], ek.LAUNCHES_F32 - before[1]) == (
        (0, 1) if plain else (1, 0))
    with spectral.full_f32():
        ref = ek.fused_epilogue_plain(mag, fb, plain=plain)
    assert got.shape == (y.shape[0], g, t)
    assert float((got - ref).abs().max()) <= (5e-5 if plain else 1e-5)


@pytest.mark.parametrize("t, k, g", [(128, 512, 64), (63, 1024, 64),
                                     (63, 520, 64), (63, 512, 80),
                                     (128, 1024, 80)])
def test_gammatone_kernel_takes_a_clip_past_its_tiles(clips, t, k, g):
    """Kernel B'' past one cluster's tiles (T > 64, F = K / 2 + 1 > 264,
    G > 64, or K not a multiple of 32: K is padded inside the kernel) runs
    in ranges: within 1e-5 of its plain version, one launch."""
    from tpu_breath_torch.ops import spectral
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    y = _batch(clips, 8, seed=t + k + g)
    hop = (y.shape[-1] - 1) // (t - 1)
    yp = torch.nn.functional.pad(y, (k // 2, k // 2))
    frames = spectral.frame_signal(yp, k, hop, t).contiguous()
    basis = spectral.device_const(spectral.framedft_basis, k,
                                  device=y.device)
    fb = spectral.device_const(spectral.mel_matrix, 16000, k, g,
                               device=y.device)
    before = gk.LAUNCHES
    got = gk.fused_gammatone(frames, basis, fb)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    ref = gk.fused_gammatone_plain(frames, basis, fb)
    assert got.shape == (8, g, t)
    assert float((got - ref).abs().max()) <= 1e-5


def test_gammatone_kernel_copies_unaligned_frames(clips):
    """Frames that do not start on a 16-byte boundary give the bits of the
    same frames aligned (the wrapper copies them once)."""
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    frames, basis, fb = _gammatone_inputs(clips)
    store = torch.empty(frames.numel() + 1, device="cuda")
    shifted = store[1:].view(frames.shape)
    shifted.copy_(frames)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(gk.fused_gammatone(shifted, basis, fb),
                       gk.fused_gammatone(frames, basis, fb))


def test_gammatone_kernel_takes_more_clips_than_a_grid_column(clips):
    """Kernel B'' at B = 65,537, past the 65,535 blocks of a grid's y
    dimension (the clip is on x): the rows of the clips at 0, 40,000 and
    65,536 are bit-equal to the kernel's rows of those clips alone, and a
    silent clip's row is zero."""
    from tpu_breath_torch.ops.cuda import gammatone_kernel as gk

    frames, basis, fb = _gammatone_inputs(clips[:3])
    rows = (0, 40_000, 65_536)
    big = torch.zeros(65_537, *frames.shape[1:], device="cuda")
    big[list(rows)] = frames
    got = gk.fused_gammatone(big, basis, fb)
    one = gk.fused_gammatone(frames, basis, fb)
    for c, row in enumerate(rows):
        assert torch.equal(got[row], one[c]), row
    assert not got[1].any()
    del big, got
    torch.cuda.empty_cache()


def test_cqt_kernel_takes_a_row_past_its_shared_memory(clips):
    """Kernel D on rows of 100,000 samples, whose staged copy does not fit
    shared memory (read from device memory instead): within 1e-5 of the
    max of its plain version, one launch."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(100)
    y = 0.05 * torch.randn(2, 100_000, generator=g, device="cuda")
    y[0, :16000] = clips[0]
    args = (16000, 256, SPEC.cqt_fmin, 252, 36)
    assert ck.staged_len(100_000, 256) * 4 > ck.SMEM_LIMIT
    before = ck.LAUNCHES
    got = ck.cqt_mag(y, *args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    ref = ck.cqt_mag_plain(y, *args)
    assert got.shape == ref.shape == (2, 252, 1 + 100_000 // 256)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_features_gpu_match_cpu(clips):
    from tpu_breath_torch.features import extract_features

    f, s = extract_features(clips[:5])
    fc, sc = extract_features(clips[:5].cpu())
    assert torch.equal(torch.isnan(f.cpu()), torch.isnan(fc))
    assert float((f.cpu() - fc).abs().nan_to_num().max()) < 1e-4
    rel = (s.cpu() - sc).abs() / sc.abs().clamp(min=1e-2)
    assert float(rel.max()) < 1e-3


def test_wrappers_reject_wrong_dtype(clips):
    from tpu_breath_torch.ops import lpc
    from tpu_breath_torch.ops.cuda import lpc_kernel as lk
    from tpu_breath_torch.ops.cuda import peaks_kernel as pk

    with pytest.raises(TypeError):
        pk.suppress_peaks(clips.double(), 1600, 12)
    y_emph, window, hop, n_frames = lpc.lpc_args(clips, 16000)
    for y, w in ((y_emph.double(), window), (y_emph, window.float()),
                 (y_emph.t().contiguous().t(), window)):
        with pytest.raises(TypeError):
            lk.lpc_frames(y, w, hop, n_frames, 12)
    with pytest.raises(ValueError):  # the window on another device
        lk.lpc_frames(y_emph, window.cpu(), hop, n_frames, 12)


@pytest.mark.parametrize("b", [1, 8, 128, 130])
def test_cqt_kernel_within_1e5(clips, b):
    """Kernel D against its plain version (float64) at B = 1, 8, 128 and
    130 (the work table deals a clip to 132, 16, 1 and 1 blocks): one
    launch a call, max|a - b| / max|b| < 1e-5 (tests/test_pallas_cqt.py)."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    g = torch.Generator(device="cuda").manual_seed(b)
    y = torch.cat([clips, 0.05 * torch.randn(
        b, 16000, generator=g, device="cuda")])[:b].contiguous()
    args = (16000, 256, SPEC.cqt_fmin, 252, 36)
    before = ck.LAUNCHES
    got = ck.cqt_mag(y, *args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    ref = ck.cqt_mag_plain(y, *args)
    assert got.shape == ref.shape == (b, 252, 63)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("hop", [160, 512])
def test_cqt_kernel_at_other_hops(clips, hop):
    """Kernel D at hops other than the main path's 256 (its code with the
    hop a runtime value): within 1e-5 of the max of its plain version, at
    B = 8."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    y = _batch(clips, 8, seed=hop)
    args = (16000, hop, SPEC.cqt_fmin, 252, 36)
    got = ck.cqt_mag(y, *args)
    torch.cuda.synchronize()
    ref = ck.cqt_mag_plain(y, *args)
    assert got.shape == ref.shape == (8, 252, 1 + 16000 // hop)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_cqt_rows_do_not_depend_on_batch(clips):
    """A clip's kernel D rows are bit-equal alone (B = 1, the clip dealt to
    132 blocks), in a batch of 8 (16 blocks a clip) and as rows 0 and 77 of
    a batch of 128 (one block a clip)."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    args = (16000, 256, SPEC.cqt_fmin, 252, 36)
    y = _batch(clips, 128, seed=7)
    for c in (0, 4, 5):  # a golden clip, quiet noise, the impulse
        one = ck.cqt_mag(y[c:c + 1].contiguous(), *args)
        for b, row in ((8, 0), (8, 5), (128, 0), (128, 77)):
            yb = y.clone()
            yb[[row, c]] = yb[[c, row]]
            got = ck.cqt_mag(yb[:b].contiguous(), *args)
            assert torch.equal(got[row], one[0]), (c, b, row)


def test_cqt_kernel_takes_more_clips_than_a_grid_column(clips):
    """Kernel D at B = 65,537, past the 65,535 blocks of a grid's y or z
    dimension: the rows of the clips at 0, 40,000 and 65,536 are bit-equal
    to the kernel's rows of those clips alone, and a silent clip's row is
    zero."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.ops.cuda import cqt_kernel as ck

    args = (16000, 256, SPEC.cqt_fmin, 252, 36)
    rows = (0, 40_000, 65_536)
    y = torch.zeros(65_537, 16000, device="cuda")
    y[list(rows)] = clips[:3]
    got = ck.cqt_mag(y, *args)
    for c, row in enumerate(rows):
        one = ck.cqt_mag(clips[c:c + 1].contiguous(), *args)
        assert torch.equal(got[row], one[0]), row
    assert not got[1].any()
    del y, got
    torch.cuda.empty_cache()


def test_feature_call_leaves_tf32_and_the_train_loss_alone(clips):
    """A cached train step of an f32 CNN8 (cuDNN runs f32 convolutions in
    TF32 by default) gives the same loss before and after a feature call,
    which turns TF32 off only while it runs."""
    from tpu_breath_torch import augment
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.features import extract_features
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    g = torch.Generator(device="cuda").manual_seed(4)
    batch = augment.Batch(
        torch.randn(8, 9, 128, 63, generator=g, device="cuda"),
        torch.randn(8, 36, generator=g, device="cuda"),
        (torch.arange(8, device="cuda") % 2).float())
    cfg = TrainCfg(batch_size=8)

    def loss():
        model = registry.build("cnn8", 36, seed=1, bf16=False).cuda()
        torch.manual_seed(2)
        return loop.train_step(model, loop.make_optimizer(model, cfg), 1e-3,
                               batch, cfg)[0]

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    before = loss()
    extract_features(clips[:2])
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    assert torch.equal(loss(), before)


def test_fused_fit_on_card(clips, monkeypatch):
    """A fused fit of 2 epochs on the card with TPU_BREATH_PALLAS_GT=1:
    kernels A, B'' and C launch in its steps; a step's features equal the
    cached features, computed at the same chunk geometry (8 clips); at the
    caller's default cuDNN flags its history equals the cached fit's."""
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.features import extract_features_batched
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.ops.cuda import (gammatone_kernel as gk,
                                           peaks_kernel as pk,
                                           tuning_kernel as tk)
    from tpu_breath_torch.train import loop

    monkeypatch.setenv("TPU_BREATH_PALLAS_GT", "1")
    g = torch.Generator(device="cuda").manual_seed(6)
    w = torch.cat([clips[:2], 0.05 * torch.randn(14, 16000, generator=g,
                                                  device="cuda")])
    wavs = w.cpu().numpy()
    y = (np.arange(16) % 2).astype(np.float32)
    f, s = extract_features_batched(wavs, chunk=8, device="cuda")
    idx = torch.from_numpy(loop.epoch_permutation(0, 0, 16)[:8]).cuda()
    sf, ss = loop.fused_features(w[idx], SPEC)
    assert np.array_equal(sf.cpu().numpy(), f[idx.cpu().numpy()],
                          equal_nan=True)
    assert np.array_equal(ss.cpu().numpy(), s[idx.cpu().numpy()],
                          equal_nan=True)
    cfg = TrainCfg(num_epochs=2, batch_size=8, eval_batch_size=16,
                   warmup_epochs=1, patience=9)
    counts = (tk.LAUNCHES, gk.LAUNCHES, pk.LAUNCHES)
    runs = [loop.fit(registry.build("cnn8", 36), store, (f, s), y, y, cfg,
                     log_fn=lambda *_: None, fused_spec=spec)
            for store, spec in (((wavs, None), SPEC), ((f, s), None))]
    # 2 epochs x 2 steps, one feature call each: A twice per call
    assert (tk.LAUNCHES - counts[0], gk.LAUNCHES - counts[1],
            pk.LAUNCHES - counts[2]) == (8, 4, 4)
    for rf, rc in zip(*(r.history for r in runs)):
        assert {k: v for k, v in rf.items() if k != "sec"} == {
            k: v for k, v in rc.items() if k != "sec"}


def test_features_do_not_depend_on_batch_position(clips):
    """A clip's features and scalars are bit-equal wherever it sits in the
    batch (the fused step's batches reproduce the cache's rows): each row
    reduction of the scalars sums in the same order for every row."""
    from tpu_breath_torch.features import extract_features

    g = torch.Generator(device="cuda").manual_seed(8)
    y = torch.cat([clips[:2], 0.05 * torch.randn(14, 16000, generator=g,
                                                  device="cuda")])
    f, s = extract_features(y)
    for shift in (1, 3):
        f2, s2 = extract_features(torch.roll(y, shift, 0).contiguous())
        assert torch.equal(torch.roll(f2, -shift, 0).nan_to_num(),
                           f.nan_to_num())
        assert torch.equal(torch.roll(s2, -shift, 0).nan_to_num(),
                           s.nan_to_num())


def test_fused_step_does_not_wait_for_the_host(clips, monkeypatch):
    """A fused step (features in chunks, augmentation draws, CNN8 forward,
    backward, clip, AdamW) queues its work without a host synchronisation:
    torch's sync debug mode raises on one, and the CUDA runtime's record of
    a step holds no stream or event synchronize and no copy between host
    and device. A first step builds the constants and the kernels: each
    device constant's upload from host memory waits once, on its first
    call in the process."""
    from tpu_breath_torch import augment
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    monkeypatch.setenv("TPU_BREATH_PALLAS_GT", "1")
    w = clips[:8].contiguous()
    y = (torch.arange(8, device="cuda") % 2).float()
    cfg = TrainCfg(batch_size=8)
    model = registry.build("cnn8", 36).cuda()
    opt = loop.make_optimizer(model, cfg)
    g = torch.Generator(device="cuda").manual_seed(0)

    def step():
        batch = augment.Batch(*loop.fused_features(w, SPEC, chunk=4), y)
        draws = augment.draw(g, 8, 128, 63, cfg.cutmix_alpha,
                             cfg.mixup_alpha, "cuda")
        return loop.train_step(model, opt, 1e-3, batch, cfg, draws)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the profiler's exit synchronizes the device itself: cudaDeviceSynchronize
    # is left out of the count
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    waits = sorted({e.name for e in prof.events() if any(
        k in e.name for k in ("StreamSynchronize", "EventSynchronize",
                              "HtoD", "DtoH"))})
    assert not waits, waits


def test_rolloff_on_the_card_is_the_oracles():
    """The rolloff's 85% crossing on the card is the oracle's, frame for
    frame, on the two shifted golden wavs where the card's f32 running sum
    had moved it by a bin (the parity sweep's scalar 14; it sums in
    float64 now), and on the near tie of the CPU test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_breath_torch.baseline import dsp_np
    from tpu_breath_torch.ops import scalars, spectral
    from tpu_breath_torch.utils import parity_sweep

    wavs, ids, _ = parity_sweep.seeded_clips(512, seed=0)
    rows = [ids.index(n) for n in ("golden0_shift13632_gain0.754",
                                   "golden0_shift4681_gain0.495")]
    y = torch.from_numpy(wavs[rows]).cuda()
    S = spectral.stft_mag(y, 2048, 512)
    got = scalars.spectral_rolloff(S, 16000, 2048).cpu().numpy()
    for r, row in enumerate(rows):
        S_o = np.abs(dsp_np.stft(wavs[row].astype(np.float64), 2048, 512))
        want = dsp_np.spectral_rolloff(S_o, 16000, 2048)
        np.testing.assert_array_equal(got[r], want.astype(np.float32))
    near = np.zeros((1, 1025, 1), np.float32)
    near[0, 0, 0], near[0, 5, 0] = np.float32(17 / 3), 1.0
    got = scalars.spectral_rolloff(torch.from_numpy(near).cuda(), 16000, 2048)
    assert got.item() == 5 * 16000 / 2048


def test_roofline_counts_the_same_bytes_on_the_card(clips):
    """utils/feature_roofline.count: every stage's bytes and kernel calls
    on the card equal the CPU's for the same clips (the kernels counted by
    ops/cuda/work.py's model on both)."""
    from tpu_breath_torch.utils import feature_roofline, profiling

    for name, fn in profiling.feature_stages().items():
        on_card = feature_roofline.count(fn, clips)
        on_cpu = feature_roofline.count(fn, clips.cpu())
        assert ((on_card["bytes"], on_card["kernel_calls"])
                == (on_cpu["bytes"], on_cpu["kernel_calls"])), name


def _clone(out):
    return tuple(t.clone() for t in out)


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("fused_gt", [False, True])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_graph_replays_equal_eager(clips, b, fused_gt):
    """extract_features_compiled's replays of two inputs in turn equal
    extract_features (eager) bit for bit, NaN where NaN; the graph holds
    kernels A twice, B or B'', C and E once, and k replays add k times those
    launches to the counters."""
    from tpu_breath_torch import features, graphs
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC

    g = torch.Generator(device="cuda").manual_seed(b)
    base = torch.cat([clips, 0.05 * torch.randn(max(b, 16) - len(clips),
                                                16000, generator=g,
                                                device="cuda")])
    xs = (base[:b].contiguous(), base.flip(0)[:b].contiguous())
    eager = [_clone(features.extract_features(x, fused_gt=fused_gt))
             for x in xs]
    features.extract_features_compiled(xs[0], fused_gt=fused_gt)
    graph = features._GRAPHS[(xs[0].device, (b, 16000), SPEC, fused_gt)]
    before = graphs.read_launches()
    got = [_clone(features.extract_features_compiled(x, fused_gt=fused_gt))
           for x in (*xs, xs[0])]
    after = graphs.read_launches()
    for out, ref in zip(got, (*eager, eager[0])):
        assert all(_nan_equal(o, r) for o, r in zip(out, ref))
    assert graph.launches == {"A": 2, "B": 0 if fused_gt else 1, "B'": 0,
                              "B''": 1 if fused_gt else 0, "C": 1, "D": 0,
                              "E": 1}
    assert {k: after[k] - before[k] for k in after} == {
        k: 3 * n for k, n in graph.launches.items()}


def _server():
    from tpu_breath_torch import ensemble
    from tpu_breath_torch.models import registry

    models = [registry.build(a, 36, seed=0).cuda().eval()
              for a in ("cnn8", "vgg")]
    return ensemble.Server(models, ensemble.softmax_weights([0.79, 0.8]),
                           device="cuda")


def test_serve_graph_equals_eager(clips):
    """A Server's replays (features + CNN8 + VGG under bf16 autocast + the
    blend, micro-batches of 2, a tail of 1) give the eager composition's
    probabilities bit for bit; one graph for the micro-batch size."""
    from tpu_breath_torch import ensemble
    from tpu_breath_torch.features import extract_features

    server = _server()
    wavs = clips[:5].cpu().numpy()  # golden wavs and noise: finite
    got = server(wavs, micro_batch=2)
    padded = torch.cat([clips[:5], torch.zeros_like(clips[:1])])
    with torch.no_grad():
        ref = torch.cat([ensemble.blend(server.models, server.weights,
                                        *extract_features(padded[lo:lo + 2]))
                         for lo in range(0, 6, 2)])[:5].cpu().numpy()
    assert np.all(np.isfinite(got))
    assert np.array_equal(got.astype(np.float32), ref)
    assert len(server.graphs) == 1


@pytest.mark.parametrize("path", ["precompute", "serve"])
def test_replay_loop_waits_on_the_host_once(clips, path, monkeypatch):
    """extract_features_batched (19 clips in chunks of 8) and a Server
    (micro-batches of 2) queue their replays and copies without a host
    synchronisation (torch's sync debug mode raises on one) until the one
    wait that reads the results (graphs.wait, where the check ends); the
    results equal the first call's."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.features import extract_features_batched

    g = torch.Generator(device="cuda").manual_seed(19)
    wavs = torch.cat([clips[:5], 0.05 * torch.randn(14, 16000, generator=g,
                                                    device="cuda")]
                     ).cpu().numpy()
    if path == "precompute":
        run = lambda: extract_features_batched(wavs, chunk=8, device="cuda")
    else:
        server = _server()
        run = lambda: (server(wavs, micro_batch=2),)
    first = run()  # captures the graph
    waits = []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(device)
        wait(device)

    monkeypatch.setattr(graphs, "wait", final_wait)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(waits) == 1
    for a, b in zip(first, again):
        assert np.array_equal(a, b, equal_nan=True)


def _fit_data(clips):
    """16 clips (the golden wavs and seeded noise), their features by
    precompute's path at chunks of 8, alternating labels."""
    from tpu_breath_torch.features import extract_features_batched

    g = torch.Generator(device="cuda").manual_seed(6)
    w = torch.cat([clips[:2], 0.05 * torch.randn(14, 16000, generator=g,
                                                  device="cuda")])
    wavs = w.cpu().numpy()
    f, s = extract_features_batched(wavs, chunk=8, device="cuda")
    return wavs, f, s, (np.arange(16) % 2).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_graphed_fit_equals_eager_fit(clips, fused, monkeypatch):
    """fit on the card, 2 epochs of 2 steps (16 clips, batch 8, dropout
    on, augmentation on in the second epoch; 10 validation rows in batches
    of 8, the tail padded), cached or fused (TPU_BREATH_PALLAS_GT=1): as
    graphs (one of the step, one of the evaluation) and inside
    graphs.eager() (none), from one seed: the histories and the final
    weights are equal bit for bit."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    monkeypatch.setenv("TPU_BREATH_PALLAS_GT", "1")
    wavs, f, s, y = _fit_data(clips)
    made = []

    class Counting(graphs.Graph):
        def __init__(self, *a, **k):
            made.append(a[0])
            super().__init__(*a, **k)

    monkeypatch.setattr(graphs, "Graph", Counting)
    cfg = TrainCfg(num_epochs=2, batch_size=8, eval_batch_size=8,
                   warmup_epochs=1, patience=9)
    store, spec = ((wavs, None), SPEC) if fused else ((f, s), None)

    def run():
        return loop.fit(registry.build("cnn8", 36, seed=3), store,
                        (f[:10], s[:10]), y, y[:10], cfg,
                        log_fn=lambda *_: None, fused_spec=spec)

    with graphs.eager():
        eager = run()
    assert made == []
    graphed = run()
    assert len(made) == 2
    for re, rg in zip(eager.history, graphed.history):
        assert {k: v for k, v in re.items() if k != "sec"} == {
            k: v for k, v in rg.items() if k != "sec"}
    se, sg = eager.model.state_dict(), graphed.model.state_dict()
    assert all(torch.equal(se[k], sg[k]) for k in se)


@pytest.mark.parametrize("arch", ["cnn8", "vgg"])
def test_train_step_body_runs_channels_last(clips, arch):
    """A captured cached TrainStep (batch 8, augmentation and dropout on)
    of each model, one replay under torch.profiler: the body runs
    channels-last on the card, so no cuDNN NCHW<->NHWC transpose kernel
    runs; every ConvBlock's BatchNorm and activation is kernel F (a replay
    runs each of its six kernels once a block, the sums kernel twice with
    CNN8's conv bias); torch's BatchNorm kernels (the MLPs' 2-D ones and
    VGG's residual one) are its channels-last ones, but for
    one 2-D BatchNorm of CNN8: its scalar MLP ends in ReLU -> BatchNorm
    with no dropout, so that layer's gradient is the strided column slice
    the concatenation's backward hands back, which torch reduces with its
    generic kernel; and 3 steps from one seed, twice, inside
    loop.reproducible(), leave the same weights bit for bit."""
    import collections
    import re

    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    _, f, s, y = _fit_data(clips)
    data = tuple(torch.from_numpy(a).cuda() for a in (f, s, y))
    cfg = TrainCfg(batch_size=8)
    lr = torch.full((), 1e-3, device="cuda")
    on = torch.ones((), dtype=torch.bool, device="cuda")
    rows = torch.randperm(16, generator=torch.Generator().manual_seed(4)
                          ).view(2, 8).cuda()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def run(profile: bool):
        model = registry.build(arch, 36, seed=3).cuda()
        gen = torch.Generator(device="cuda").manual_seed(1)
        step = loop.TrainStep(model, loop.make_optimizer(model, cfg), data,
                              cfg, gen)
        torch.manual_seed(2)
        names = []
        for k in range(3):
            if k == 2 and profile:
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    step(rows[k % 2], lr, on)
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()]
            else:
                step(rows[k % 2], lr, on)
        torch.cuda.synchronize()
        assert len(step.graphs) == 1
        return dict(model.state_dict()), names

    with loop.reproducible():
        first, names = run(True)
        second, _ = run(False)
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]
    bn = collections.Counter(m.group(1) for m in (re.match(
        r"void at::native::(batch_norm_\w*kernel)\b", n) for n in names)
        if m)
    assert bn["batch_norm_collect_statistics_channels_last_kernel"] > 0
    assert bn["batch_norm_backward_reduce_channels_last_kernel"] > 0
    strided = {"cnn8": 1, "vgg": 0}[arch]
    assert {k: v for k, v in bn.items() if "channels_last" not in k} == (
        {"batch_norm_backward_reduce_kernel": strided} if strided else {}), bn
    blocks, conv_bias = {"cnn8": (8, 1), "vgg": (12, 0)}[arch]
    fused = collections.Counter(m.group(1) for m in (re.search(
        r"\bbn_act_(\w+?)_kernel\b", n) for n in names) if m)
    assert fused == {"stats": blocks, "merge": blocks, "apply": blocks,
                     "reduce": blocks, "sums": blocks * (1 + conv_bias),
                     "elemt": blocks}, fused
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_eval_graph_equals_eager(clips):
    """A Predictor of VGG (10 rows in batches of 4, the tail padded) gives
    eager logits bit for bit from one graph replayed every call."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    g = torch.Generator(device="cuda").manual_seed(3)
    f = torch.randn(10, 9, 128, 63, generator=g, device="cuda")
    s = torch.randn(10, 36, generator=g, device="cuda")
    predict = loop.Predictor(registry.build("vgg", 36, seed=2).cuda(), f, s,
                             4)

    def logits():
        out = predict()
        graphs.wait("cuda")
        return out.clone()

    with graphs.eager():
        ref = logits()
    got = [logits() for _ in range(2)]
    assert len(predict.graphs) == 1
    assert all(torch.equal(x, ref) for x in got)
    assert torch.isfinite(ref).all()


def test_graphed_epoch_waits_on_the_host_once(clips, monkeypatch):
    """A graphed fit's epochs after the first (3 epochs of 2 steps,
    cached, a padded evaluation) queue their uploads, step replays, means
    and evaluation replays without a host synchronisation (torch's sync
    debug mode raises on one, from the end of the first epoch) until the
    epoch's one wait (graphs.wait, where the check ends)."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    _, f, s, y = _fit_data(clips)
    waits, lines = [], []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(len(lines))
        wait(device)

    def log_fn(msg):  # an epoch ends: check the next one
        lines.append(msg)
        torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(graphs, "wait", final_wait)
    cfg = TrainCfg(num_epochs=3, batch_size=8, eval_batch_size=8,
                   warmup_epochs=1, patience=9)
    try:
        loop.fit(registry.build("cnn8", 36, seed=3), (f, s), (f[:10], s[:10]),
                 y, y[:10], cfg, log_fn=log_fn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert waits == [0, 1, 2] and len(lines) == 3


@pytest.fixture(scope="module")
def nccl_rank(clips):
    """This process as the one rank of an NCCL mesh (the launcher's
    variables set, the group destroyed after the module's tests)."""
    import socket

    import torch.distributed as dist

    from tpu_breath_torch.parallel import mesh as mesh_lib

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    names = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        mesh = mesh_lib.make_mesh("cuda")
        assert mesh.backend == "nccl" and mesh_lib.replays(mesh)
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _streamed(arrays, steps: int, seed: int):
    """steps batches of 8 rows of the host arrays (rows drawn from seed)
    through loader.Prefetcher onto the card, as fit streams them."""
    from tpu_breath_torch.data import loader

    rng = np.random.default_rng(seed)
    return loader.Prefetcher(
        (tuple(np.ascontiguousarray(a[idx]) for a in arrays)
         for idx in (rng.permutation(len(arrays[0]))[:8]
                     for _ in range(steps))), device="cuda")


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_step_graph_equals_eager(clips, nccl_rank, fused):
    """One NCCL rank's streamed step program (loop.TrainStep, data None,
    CNN8, batch 8 streamed from the host, augmentation on, dropout on),
    cached or fused (kernel B): 8 steps graphed and 8 inside
    graphs.eager() from one seeded state on the same batches give the same
    losses, accuracies, parameters, buffers, moments and step count bit
    for bit, from one captured graph."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import DEFAULT_FEATURES as SPEC
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import layers, registry
    from tpu_breath_torch.train import loop

    wavs, f, s, y = _fit_data(clips)
    arrays = (wavs, y) if fused else (f, s, y)
    cfg = TrainCfg(batch_size=8)
    lrs = torch.linspace(1e-3, 5e-4, 8, device="cuda")
    on = torch.ones((), dtype=torch.bool, device="cuda")

    def run():
        model = registry.build("cnn8", 36, seed=3).cuda()
        layers.set_mesh(model, nccl_rank)
        opt = loop.make_optimizer(model, cfg)
        step = loop.TrainStep(model, opt, None, cfg,
                              torch.Generator(device="cuda").manual_seed(1),
                              SPEC if fused else None, nccl_rank)
        torch.manual_seed(2)
        out = [tuple(t.clone() for t in step(*batch, lrs[k], on))
               for k, batch in enumerate(_streamed(arrays, 8, seed=4))]
        state = dict(model.state_dict())
        for i, p in enumerate(model.parameters()):
            state[f"m{i}"] = opt.state[p]["exp_avg"]
            state[f"v{i}"] = opt.state[p]["exp_avg_sq"]
        state["count"] = opt.count
        return out, state, len(step.graphs)

    with loop.reproducible():
        with graphs.eager():
            eager, se, n_eager = run()
        graphed, sg, n_graphed = run()
    assert (n_eager, n_graphed) == (0, 1)
    assert all(torch.equal(a, b) for e, g in zip(eager, graphed)
               for a, b in zip(e, g))
    assert all(torch.equal(se[k], sg[k]) for k in se)


def test_graphed_mesh_epoch_waits_on_the_host_once(clips, nccl_rank,
                                                   monkeypatch):
    """A graphed fit on one NCCL rank (3 epochs of 2 streamed steps,
    cached, a padded sharded evaluation) queues each epoch after the first
    without a host synchronisation (torch's sync debug mode raises on
    one, from the end of the first epoch) until the epoch's one wait
    (graphs.wait, where the check ends)."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import TrainCfg
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    _, f, s, y = _fit_data(clips)
    waits, lines = [], []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(len(lines))
        wait(device)

    def log_fn(msg):  # an epoch ends: check the next one
        lines.append(msg)
        torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(graphs, "wait", final_wait)
    cfg = TrainCfg(num_epochs=3, batch_size=8, eval_batch_size=8,
                   warmup_epochs=1, patience=9)
    try:
        loop.fit(registry.build("cnn8", 36, seed=3), (f, s), (f[:10], s[:10]),
                 y, y[:10], cfg, log_fn=log_fn, mesh=nccl_rank)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert waits == [0, 1, 2] and len(lines) == 3


def test_mesh_precompute_waits_on_the_host_once(clips, nccl_rank,
                                                monkeypatch):
    """extract_features_batched on one NCCL rank (19 clips in chunks of 8,
    _extract_sharded: the last super-chunk padded) queues its replays,
    gathers and copies without a host synchronisation until its one wait,
    and returns the single process's arrays bit for bit."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.features import extract_features_batched

    g = torch.Generator(device="cuda").manual_seed(19)
    wavs = torch.cat([clips[:5], 0.05 * torch.randn(14, 16000, generator=g,
                                                    device="cuda")]
                     ).cpu().numpy()
    one = extract_features_batched(wavs, chunk=8, device="cuda")
    extract_features_batched(wavs, chunk=8, mesh=nccl_rank)  # warm
    waits = []
    wait = graphs.wait

    def final_wait(device):
        torch.cuda.set_sync_debug_mode("default")
        waits.append(device)
        wait(device)

    monkeypatch.setattr(graphs, "wait", final_wait)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = extract_features_batched(wavs, chunk=8, mesh=nccl_rank)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(waits) == 1
    for a, b in zip(one, got):
        assert np.array_equal(a, b, equal_nan=True)
