"""Kernel E's wrapper (ops/cuda/lpc_kernel.py) on the CPU: its plain
version, its argument checks and its work model. The kernel itself is held
to the plain version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from tpu_breath_torch.ops import lpc, spectral
from tpu_breath_torch.ops.cuda import lpc_kernel, work

SR, ORDER = 16000, 12


def _clips() -> torch.Tensor:
    """Noise at three levels, a silent clip, a NaN at sample 8,000 and an
    inf at sample 100."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((6, SR)) * np.array(
        [0.3, 0.01, 1e-3, 0.0, 0.1, 0.1])[:, None]
    y[4, 8000] = np.nan
    y[5, 100] = np.inf
    return torch.from_numpy(y.astype(np.float32))


def test_wrapper_on_cpu_is_the_plain_loop_bit_for_bit():
    """On CPU tensors the wrapper is the framing and the float64 loop,
    bit for bit, launches nothing, and lpc_features returns it; frames the
    loop cannot finish (silence's 0 / 0, a NaN or an inf inside) are
    zeros."""
    y = _clips()
    y_emph, window, hop, n_frames = lpc.lpc_args(y, SR)
    assert (window.dtype, window.shape, hop, n_frames) == (
        torch.float64, (400,), 160, 98)
    before = lpc_kernel.LAUNCHES
    got = lpc_kernel.lpc_frames(y_emph, window, hop, n_frames, ORDER)
    frames = spectral.frame_signal(y_emph.double(), 400, hop, n_frames)
    want = lpc_kernel.burg_lpc(frames * window, ORDER)[..., 1:].transpose(
        -1, -2).float()
    assert got.shape == (6, ORDER, n_frames) and torch.equal(got, want)
    # frame-major memory: the features' z-norm sums in this order
    assert got.stride() == (n_frames * ORDER, 1, ORDER)
    assert lpc_kernel.LAUNCHES == before
    assert torch.equal(lpc.lpc_features(y, ORDER, SR), got)
    zeroed = (got == 0).all(dim=1)
    # the NaN reaches samples 8,000-8,001 of y_emph (frames 48-50), the
    # inf samples 100-101 (frame 0)
    assert zeroed.sum(dim=1).tolist() == [0, 0, 0, n_frames, 3, 1]
    assert zeroed[4, 48:51].all() and zeroed[5, 0]
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("case", [
    "clips not 2-d", "window not 1-d", "frame too long", "order 0",
    "order 32", "hop 0", "no frame", "frames past the clip",
    "not a CUDA device"])
def test_wrapper_rejects_bad_arguments(case):
    y = torch.zeros(2, SR)
    w = torch.ones(400, dtype=torch.float64)
    args = {"y_emph": y, "window": w, "hop": 160, "n_frames": 98,
            "order": ORDER}
    args.update({
        "clips not 2-d": {"y_emph": y[0]},
        "window not 1-d": {"window": w[None]},
        "frame too long": {"window": torch.ones(lpc_kernel.MAX_FRAME + 1,
                                                dtype=torch.float64)},
        "order 0": {"order": 0},
        "order 32": {"order": lpc_kernel.MAX_ORDER + 1},
        "hop 0": {"hop": 0},
        "no frame": {"n_frames": 0},
        "frames past the clip": {"n_frames": 99},
        "not a CUDA device": {"y_emph": y.to("meta"),
                              "window": w.to("meta")},
    }[case])
    with pytest.raises(ValueError):
        lpc_kernel.lpc_frames(**args)


def test_work_model_is_a_hand_count_at_b8():
    """Kernel E's least work at B = 8: each clip read once, the float64
    window once, the coefficients written once; a frame's float64
    operations counted by hand."""
    w = work.lpc(8, SR, 400, 98, ORDER)
    windowing = 400
    sums = 6 * sum(range(388, 400))  # steps 0-11: windows of 399 .. 388
    updates = 4 * sum(range(389, 400))  # none after the last step
    coeffs = 2 * ORDER + 2 * sum(range(1, ORDER + 1))
    assert windowing + sums + updates + coeffs == 46_248
    assert w.ops == 8 * 98 * 46_248
    assert w.bytes == 8 * SR * 4 + 400 * 8 + 8 * ORDER * 98 * 4
    assert w.peak == work.F64_CUDA_FLOPS
    assert w.bound_ms()[1] == "operations"
