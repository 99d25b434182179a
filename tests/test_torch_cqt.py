"""Kernel D's function, the direct |CQT| at tuning 0, on the CPU: the
port's plain version (ops/cqt.py::cqt_mag, float64 rounded once) and the
wrapper (ops/cuda/cqt_kernel.py, which takes the plain version for CPU
tensors) against JAX's XLA cqt_mag, JAX's Pallas cqt_mag_pallas in
interpret mode, and the JAX package's float64 oracle dsp_np.cqt.

Tolerance: the JAX test's max|a - b| / max|b| < 1e-5
(tests/test_pallas_cqt.py); the JAX functions run f32 products at HIGHEST
precision, the port in float64."""
import glob
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_breath.baseline import dsp_np as jx_oracle
from tpu_breath.ops.cqt import cqt_mag as jx_cqt_mag
from tpu_breath.ops.pallas import cqt_kernel as jx_pallas
from tpu_breath_torch.config import DEFAULT_FEATURES
from tpu_breath_torch.ops import cqt
from tpu_breath_torch.ops.cuda import cqt_kernel

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))
SR, HOP, N_BINS, BPO = 16000, 256, 252, 36
FMIN = DEFAULT_FEATURES.cqt_fmin  # C1


@pytest.fixture(scope="module")
def clips():
    """The 2 golden wavs, seeded noise and an impulse."""
    rng = np.random.default_rng(21)
    imp = np.zeros(16000)
    imp[8000] = 0.5
    y = [np.load(p)["wav"] for p in FIXTURES]
    y += [rng.standard_normal(16000) * 0.05, imp]
    return np.stack(y).astype(np.float32)


@pytest.fixture(scope="module")
def port(clips):
    return cqt.cqt_mag(torch.from_numpy(clips), SR, HOP, FMIN, N_BINS,
                       BPO).numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_matches_jax(clips, port, ref):
    y = jnp.asarray(clips)
    if ref == "xla":
        fn = jax.jit(lambda v: jx_cqt_mag(v, SR, HOP, FMIN, N_BINS, BPO))
    else:
        fn = jax.jit(lambda v: jx_pallas.cqt_mag_pallas(
            v, SR, HOP, FMIN, N_BINS, BPO, interpret=True))
    want = np.asarray(fn(y))
    assert port.shape == want.shape == (len(clips), N_BINS, 63)
    assert port.dtype == np.float32
    for i in range(len(clips)):  # per clip: the impulse's max is small
        assert _rel(port[i], want[i]) < 1e-5, (ref, i)


def test_plain_matches_float64_oracle(clips, port):
    """Within 1e-6 relative of |dsp_np.cqt| (float64, rounded once here
    too)."""
    for i, y in enumerate(clips):
        want = np.abs(jx_oracle.cqt(y, SR, HOP, FMIN, N_BINS, BPO))
        assert _rel(port[i], want) < 1e-6, i


def test_bank_equals_pallas_bank():
    """The kernel's bank (1/sqrt(len) folded in, padded to 100 tiles of
    256 samples) is the Pallas kernel's, bit for bit, in the rows that hold
    bins (Pallas pads the 252 bins to 256 rows of zeros)."""
    ours = cqt_kernel._kernel_bank(SR, FMIN, N_BINS, BPO)
    theirs = jx_pallas._kernel_bank(SR, FMIN, N_BINS, BPO, 63)
    assert ours[2:] == theirs[2:4] == (12707, 25600)
    assert theirs[4] == 256
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.shape == (N_BINS, 25600)
        np.testing.assert_array_equal(a, b[:N_BINS])
        assert not b[N_BINS:].any()


def test_bank_windows_hold_every_nonzero_entry():
    """Summing each row over its window computes the full product: no
    nonzero entry lies outside it. The windows hold 20% of the bank."""
    k_re, k_im = cqt_kernel._kernel_bank(SR, FMIN, N_BINS, BPO)[:2]
    win = cqt_kernel.bank_windows(SR, FMIN, N_BINS, BPO)
    cols = np.arange(k_re.shape[1])
    inside = (cols >= win[:, :1]) & (cols < win[:, 1:])
    nonzero = (k_re != 0) | (k_im != 0)
    assert not (nonzero & ~inside).any()
    assert 0.19 < inside.sum() / k_re.size < 0.21
    assert win[0, 1] - win[0, 0] <= 25414 and win[-1, 1] - win[-1, 0] >= 200


def test_wrapper_takes_the_plain_version_on_cpu(clips, port):
    before = cqt_kernel.LAUNCHES
    got = cqt_kernel.cqt_mag(torch.from_numpy(clips), SR, HOP, FMIN, N_BINS,
                             BPO)
    np.testing.assert_array_equal(got.numpy(), port)
    assert cqt_kernel.LAUNCHES == before
    with pytest.raises(ValueError):
        cqt_kernel.cqt_mag(torch.from_numpy(clips[0]), SR, HOP, FMIN,
                           N_BINS, BPO)


KEY = (SR, FMIN, N_BINS, BPO)
# blocks a clip on the card's 132 SMs at B = 128 and 130, 66, 8 and 1
SHARES = [1, 2, 16, 132]


def _table_items(shares):
    """Kernel D's work table, decoded: for each warp its items as rows
    (k0, t0, frames, sig_off, bank_off, steps)."""
    table = cqt_kernel.work_table(*KEY, HOP, 16000, shares)
    slots = shares * cqt_kernel.WARPS
    head = -(-(slots + 1) // 4) * 4
    assert table.dtype == np.int32 and table[0] == 0
    items = table[head:].reshape(-1, 4).astype(np.int64)
    assert table[slots] == len(items)
    word = items[:, 0] & 0xFFFFFFFF
    frames = np.where(word >> 31, cqt_kernel.FRAMES // 2, cqt_kernel.FRAMES)
    rows = np.stack([word & 0xFFFF, (word >> 16) & 0x7FFF, frames,
                     *items[:, 1:].T], axis=1)
    return [rows[table[w]:table[w + 1]] for w in range(slots)]


def _cost(rows):
    half = rows[:, 2] < cqt_kernel.FRAMES
    return (np.where(half, cqt_kernel.HALF_STEP, 1.0) * rows[:, 5]
            + cqt_kernel.REDUCE_STEPS)


@pytest.mark.parametrize("shares", SHARES)
def test_work_table_covers_every_bin_and_frame_once(shares):
    """Every (bin, frame) of a clip's [252, 63] output falls in exactly one
    item of kernel D's table, whatever the blocks a clip is dealt to; a
    half item sums the samples of the whole item it is cut from."""
    seen = np.zeros((N_BINS, 63), np.int64)
    whole = {(k0, t0): (sig, bank, steps) for k0, t0, _, steps, sig, bank
             in cqt_kernel.work_items(*KEY, HOP, 16000)}
    for rows in _table_items(shares):
        for k0, t0, frames, sig_off, bank_off, steps in rows:
            seen[k0:k0 + cqt_kernel.BINS, t0:t0 + frames] += 1
            t16 = t0 - t0 % cqt_kernel.FRAMES
            assert (sig_off - HOP * (t0 - t16), bank_off,
                    steps) == whole[k0, t16]
    assert (seen == 1).all()


def test_group_windows_cover_their_members():
    """A group's window holds each member bin's nonzero window, and the
    packed bank holds the members' entries over it (zero past it, for the
    last step's overrun)."""
    win = cqt_kernel.bank_windows(*KEY)
    gw = cqt_kernel.group_windows(*KEY)
    k_re, k_im = cqt_kernel._kernel_bank(*KEY)[:2]
    bank, first = cqt_kernel._packed(*KEY)
    nb = cqt_kernel.BINS
    assert len(gw) == N_BINS // nb
    for g, (lo, hi) in enumerate(gw):
        members = win[g * nb:(g + 1) * nb]
        assert (members[:, 0] >= lo).all() and (members[:, 1] <= hi).all()
        rows = bank[first[g]:first[g] + hi - lo + cqt_kernel.LANES]
        for j in range(nb):
            np.testing.assert_array_equal(rows[:hi - lo, j],
                                          k_re[g * nb + j, lo:hi])
            np.testing.assert_array_equal(rows[:hi - lo, nb + j],
                                          k_im[g * nb + j, lo:hi])
        assert not rows[hi - lo:].any()


@pytest.mark.parametrize("shares", SHARES)
def test_work_table_balances_the_warps(shares):
    """The heaviest slot's cost is within 2% of the larger of the mean over
    the slots and the costliest item (which bounds it below at B = 8 and
    under); items are cut in half only where a whole one costs more than
    the mean."""
    per_slot = _table_items(shares)
    cost = np.array([_cost(r).sum() for r in per_slot])
    biggest = max(_cost(r).max() for r in per_slot if len(r))
    assert cost.max() <= 1.02 * max(cost.mean(), biggest)
    steps = cqt_kernel.work_items(*KEY, HOP, 16000)[:, 3]
    mean = (steps + cqt_kernel.REDUCE_STEPS).sum() / len(per_slot)
    for rows in per_slot:
        half = rows[:, 2] < cqt_kernel.FRAMES
        assert (rows[half, 5] + cqt_kernel.REDUCE_STEPS > mean).all()
        assert (rows[~half, 5] + cqt_kernel.REDUCE_STEPS <= mean).all()


@pytest.mark.parametrize("shares", [1, 16])
def test_work_table_summed_as_the_kernel_sums_gives_the_plain_version(
        clips, port, shares):
    """The items of the table (at B = 128 and at B = 8, where the longest
    are cut in half), each summed as the kernel sums it (the staged row at
    sig_off + hop t + i, the packed bank at bank_off + i, for i < 32
    steps), in float64 here, give the plain version within 1e-6 of its
    max: the offsets address the right samples and entries and the
    clipped terms are zero."""
    bank = cqt_kernel._packed(*KEY)[0].astype(np.float64)
    pad = HOP * (cqt_kernel.FRAMES - 1)
    nb = cqt_kernel.BINS
    items = np.concatenate(_table_items(shares))
    for c in (0, 3):  # a golden clip and the impulse
        row = np.zeros(cqt_kernel.staged_len(16000, HOP))
        row[pad:pad + 16000] = clips[c]
        out = np.full((N_BINS, 63), np.nan)
        for k0, t0, frames, sig_off, bank_off, steps in items:
            span = cqt_kernel.LANES * steps
            sig = np.stack([row[sig_off + HOP * t:sig_off + HOP * t + span]
                            for t in range(frames)])
            z = sig @ bank[bank_off:bank_off + span]  # [frames, re | im]
            mag = np.hypot(z[:, :nb], z[:, nb:]).T[:, :63 - t0]
            out[k0:k0 + nb, t0:t0 + frames] = mag
        assert _rel(out, port[c]) < 1e-6, c
