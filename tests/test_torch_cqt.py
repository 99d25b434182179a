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
