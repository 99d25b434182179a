"""Kernel F, a ConvBlock's BatchNorm and activation (ops/cuda/bn_act_kernel.py,
csrc/bn_act_kernel.cu).

On the CPU: the plain version against torch's BatchNorm and activation
(today's ConvBlock path, models/layers._act_bn), Flax's running update, the
state-dict keys, the dispatch rules, the work model. On the card (marked
`cuda`, skipping without a CUDA device, decided in a fixture):

    python -m pytest --noconftest tests/test_torch_bn_kernel.py -m cuda -p no:cacheprovider

the kernels against the plain version at every distinct ConvBlock shape of
CNN8 and VGG, bit-equal repeats, a CUDA graph against the eager call, and
the launches of a step.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_breath_torch.models import registry
from tpu_breath_torch.models import layers
from tpu_breath_torch.models.layers import ConvBlock, _act_bn
from tpu_breath_torch.ops.cuda import bn_act_kernel as bk
from tpu_breath_torch.ops.cuda import work
from tpu_breath_torch.utils import kernel_times

CL = torch.channels_last


def _block(order: str, conv_bias: bool, dtype=torch.float64) -> ConvBlock:
    """A ConvBlock 5 -> 16 channels with seeded, non-trivial BatchNorm
    parameters and running statistics."""
    torch.manual_seed(3)
    blk = ConvBlock(5, 16, order=order, use_bias=conv_bias).to(dtype)
    with torch.no_grad():
        blk.bn.weight.uniform_(0.5, 1.5)
        blk.bn.bias.normal_()
        blk.bn.running_mean.normal_()
        blk.bn.running_var.uniform_(0.5, 2.0)
        if conv_bias:
            blk.conv.bias.normal_()
    return blk


def _fwd_bwd(fn, x, dz, blk):
    x = x.clone().requires_grad_()
    z = fn(x)
    grads = torch.autograd.grad(z, [x, *blk.parameters()], dz)
    return [z.detach(), *grads, blk.bn.running_mean.clone(),
            blk.bn.running_var.clone()]


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("order, conv_bias", [
    ("relu_bn", True), ("bn_gelu", False), ("relu_bn", False),
    ("bn_gelu", True)])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_plain_version_is_torch_batch_norm_and_activation(
        order, conv_bias, train, layout, dtype, tol):
    """A ConvBlock on the CPU (bn_act's plain version) against the
    convolution with its bias, then torch's BatchNorm and activation as the
    block ran them before kernel F (_act_bn): z, the gradients of the input
    and of every parameter, the running statistics; CNN8's order with its
    conv bias, VGG's without, and the other two. The same arithmetic in
    another order: float64 within 1e-10, f32 within 1e-4 of the largest
    value (or of 1): f32 sums of 252 values, and before "bn_gelu"'s
    BatchNorm the conv bias's gradient is zero in exact arithmetic, so both
    sides give the rounding of a 252-term sum (3.4e-5 measured). z keeps
    the input's layout."""
    blk = _block(order, conv_bias, dtype)
    ref = copy.deepcopy(blk)
    blk.train(train)
    ref.train(train)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 5, 9, 7, generator=g, dtype=dtype)
    dz = torch.randn(4, 16, 9, 7, generator=g, dtype=dtype)
    if layout == "channels_last":
        x, dz = (t.contiguous(memory_format=CL) for t in (x, dz))
    got = _fwd_bwd(blk, x, dz, blk)
    want = _fwd_bwd(lambda t: _act_bn(ref.conv(t), ref.bn, order), x, dz,
                    ref)
    assert got[0].is_contiguous(
        memory_format=CL if layout == "channels_last" else
        torch.contiguous_format)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("shape", [(6, 16, 5, 3), (3, 16, 1, 1)])
def test_running_statistics_are_flax_update(shape):
    """Training updates running mean and variance as Flax's BatchNorm does
    (momentum 0.9): 0.9 old + 0.1 of the batch's mean and *biased* variance
    of the BatchNorm's input (relu(x + b) for CNN8's order), and the
    evaluation leaves them alone."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    b = rng.standard_normal(shape[1]).astype(np.float32)
    mean0 = rng.standard_normal(shape[1]).astype(np.float32)
    var0 = (rng.random(shape[1]) + 0.5).astype(np.float32)
    w = torch.ones(shape[1])
    beta = torch.zeros(shape[1])
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    bk.bn_act(torch.from_numpy(x), torch.from_numpy(b), w, beta, rm, rv,
              "relu_bn", True, 0.1, 1e-5)
    t = np.maximum(x.astype(np.float64) + b[None, :, None, None], 0.0)
    mean = t.mean(axis=(0, 2, 3))
    var = t.var(axis=(0, 2, 3))  # biased
    np.testing.assert_allclose(rm.numpy(), 0.9 * mean0 + 0.1 * mean,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rv.numpy(), 0.9 * var0 + 0.1 * var,
                               rtol=1e-6)
    before = rm.clone(), rv.clone()
    bk.bn_act(torch.from_numpy(x), torch.from_numpy(b), w, beta, rm, rv,
              "relu_bn", False, 0.1, 1e-5)
    assert torch.equal(rm, before[0]) and torch.equal(rv, before[1])


def test_state_dict_keys_unchanged():
    """A ConvBlock keeps nn.Conv2d's and BatchNorm's keys, the conv bias
    among them where the block has one (CNN8), so checkpoints and
    models/convert.py load as before; every ConvBlock of CNN8 and VGG
    holds exactly these."""
    keys = ["conv.weight", "conv.bias", "bn.weight", "bn.bias",
            "bn.running_mean", "bn.running_var", "bn.num_batches_tracked"]
    assert list(ConvBlock(3, 8).state_dict()) == keys
    assert list(ConvBlock(3, 8, use_bias=False).state_dict()) == (
        keys[:1] + keys[2:])
    for arch, bias in (("cnn8", True), ("vgg", False)):
        model = registry.build(arch, 36)
        sd = model.state_dict()
        for i, blk in enumerate(model.convs):
            assert [k for k in sd if k.startswith(f"convs.{i}.")] == [
                f"convs.{i}.{k}" for k in keys if bias or k != "conv.bias"]


def test_cpu_tensor_takes_the_plain_version():
    """On CPU tensors bn_act is bn_act_plain bit for bit and launches
    nothing."""
    blk = _block("relu_bn", True, torch.float32).train()
    x = torch.randn(2, 16, 6, 5, generator=torch.Generator().manual_seed(1))
    before = bk.LAUNCHES
    args = (blk.conv.bias, blk.bn.weight, blk.bn.bias)
    rm, rv = blk.bn.running_mean, blk.bn.running_var
    got = bk.bn_act(x, *args, rm.clone(), rv.clone(), "relu_bn", True)
    want = bk.bn_act_plain(x, *args, rm.clone(), rv.clone(), "relu_bn",
                           True)
    assert torch.equal(got, want)
    assert bk.LAUNCHES == before


def test_mesh_of_two_ranks_takes_global_batch_norm(monkeypatch):
    """Under a mesh of more than one rank a training ConvBlock is the
    convolution with its bias and _act_bn, whose BatchNorm takes
    global_batch_norm; bn_act is not called. One rank: bn_act."""
    class Mesh:
        world, rank = 2, 0

    calls = []

    def global_bn(bn, x):
        calls.append(tuple(x.shape))
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                            bn.eps)

    def refuse(*a, **k):
        raise AssertionError("bn_act under a mesh of two ranks")

    blk = _block("relu_bn", True, torch.float32).train()
    x = torch.randn(2, 5, 6, 5, generator=torch.Generator().manual_seed(2))
    monkeypatch.setattr(layers, "global_batch_norm", global_bn)
    monkeypatch.setattr(bk, "bn_act", refuse)
    layers.set_mesh(blk, Mesh())
    want = F.batch_norm(torch.relu(blk.conv(x)), None, None, blk.bn.weight,
                        blk.bn.bias, True, 0.0, blk.bn.eps)
    assert torch.equal(blk(x), want) and calls == [(2, 16, 6, 5)]
    Mesh.world = 1
    with pytest.raises(AssertionError, match="bn_act under a mesh"):
        blk(x)


@pytest.mark.parametrize("case, error", [
    ("nchw", TypeError), ("3-d", TypeError), ("float16", TypeError),
    ("float64", TypeError), ("12 channels", ValueError),
    ("4 channels", ValueError), ("2048 f32 channels", ValueError),
    ("empty", ValueError), ("not a CUDA device", ValueError),
    ("a float64 parameter", TypeError), ("a parameter of 8", TypeError),
    ("order", ValueError)])
def test_kernel_refuses_what_it_does_not_take(case, error):
    """bn_act sends every tensor not on the CPU to the kernel, which raises
    on what it does not take: the layout, type, channel and parameter
    rules hold for a tensor on any device (meta tensors here), then the
    device. No silent fallback."""
    def t(*shape, dtype=torch.bfloat16, cl=True):
        x = torch.empty(*shape, dtype=dtype, device="meta")
        return x.contiguous(memory_format=CL) if cl and x.dim() == 4 else x

    x = t(2, 16, 4, 3)
    p = [torch.empty(16, device="meta") for _ in range(4)]
    order = "relu_bn"
    if case == "nchw":
        x = t(2, 16, 4, 3, cl=False)
    elif case == "3-d":
        x = t(2, 16, 12)
    elif case in ("float16", "float64"):
        x = t(2, 16, 4, 3, dtype=getattr(torch, case))
    elif case == "12 channels":
        x, p = t(2, 12, 4, 3), [q[:12] for q in p]
    elif case == "4 channels":
        x, p = t(2, 4, 4, 3), [q[:4] for q in p]
    elif case == "2048 f32 channels":
        x = t(2, 2048, 1, 1, dtype=torch.float32)
        p = [torch.empty(2048, device="meta") for _ in range(4)]
    elif case == "empty":
        x = t(0, 16, 4, 3)
    elif case == "a float64 parameter":
        p = [p[0].double()] + p[1:]
    elif case == "a parameter of 8":
        p = [p[0][:8]] + p[1:]
    elif case == "order":
        order = "gelu_bn"
    with pytest.raises(error):
        bk.bn_act(x, None, *p, order, True)


def test_block_count():
    """G: as many blocks as the rows fill (THREADS / lanes rows a block
    pass), at most MAX_BLOCKS, so every ConvBlock shape at batch 512 fills
    MAX_BLOCKS and a B = 1 evaluation of VGG's last block takes 4."""
    assert bk.blocks(1, 8, 2) == 1
    assert bk.blocks(1000, 32, 2) == -(-1000 // 64)
    assert bk.blocks(128, 512, 2) == 128 // 4
    for arch in ("cnn8", "vgg"):
        for c, h, w, _, _ in kernel_times.convblock_shapes(arch):
            assert bk.blocks(512 * h * w, c, 2) == bk.MAX_BLOCKS
            assert bk.blocks(512 * h * w, c, 4) == bk.MAX_BLOCKS


def test_work_model_is_the_passes_bytes():
    """Kernel F's least work: the statistics read x once, the apply reads x
    and writes z, the backward's sums read dz and x, dx reads both and
    writes dx; the f32 [C] vectors once each. At VGG's ConvBlock shapes a
    training step is 8 passes over 2,539,520 values a clip: 2.60 GB at
    batch 512 in bf16, bound by the bytes."""
    per_clip = sum(c * h * w for c, h, w, _, _
                   in kernel_times.convblock_shapes("vgg"))
    assert per_clip == 2_539_520
    total = 0
    for c, h, w, order, cb in kernel_times.convblock_shapes("vgg"):
        m = 512 * h * w
        parts = [work.bn_act(m, c, 2, p, order, cb)
                 for p in ("stats", "apply", "reduce", "elemt")]
        assert [p.bytes - m * c * 2 * k for p, k in zip(parts, (1, 2, 2, 3))
                ] == [2 * c * 4, 4 * c * 4, 6 * c * 4, 6 * c * 4]
        assert all(p.bound_ms()[1] == "bytes" for p in parts)
        total += sum(p.bytes for p in parts)
    assert abs(total - 8 * 512 * per_clip * 2) < 1e6
    assert round(512 * per_clip * 2 / 1e9, 2) == 2.60
    w = work.bn_act(100, 32, 2, "elemt", "relu_bn", True)
    assert (w.bytes, w.ops) == (3 * 100 * 32 * 2 + 8 * 32 * 4,
                                (7 + 1 + 1) * 100 * 32)


# ---- on the card ---------------------------------------------------------

TRAIN_SHAPES = sorted({s for a in ("cnn8", "vgg")
                       for s in kernel_times.convblock_shapes(a)})


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel F has no CPU mode")
    return torch.device("cuda")


def _card_step(v: dict, order: str, training: bool):
    """One forward and backward of the kernels on a copy of v: z, dx, the
    parameter gradients (conv bias if any, gamma, beta) and the running
    statistics after."""
    v = {k: (None if t is None else t.detach().clone()) for k, t in
         v.items()}
    out = kernel_times.bn_act_step(bk.bn_act, v, order, training)
    return [t.detach() for t in out] + [v["running_mean"], v["running_var"]]


@pytest.mark.cuda
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [8, 512])
@pytest.mark.parametrize("shape", TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])) + s[3])
def test_kernel_vs_plain_at_every_convblock_shape(card, shape, b, dtype,
                                                  training):
    """Kernel F against its plain version in float64 on the same values,
    at each distinct ConvBlock shape of CNN8 (relu_bn, conv bias) and VGG
    (bn_gelu), B = 8 and 512, bf16 and f32, training and evaluation: z,
    dx, the conv bias's, gamma's and beta's gradients and the running
    statistics after the step, each within kernel_times.bn_act_errors'
    tolerance (stated there: one rounding of z and dx to their dtype
    beside f32 arithmetic, f32 sums for the gradients and statistics);
    z and dx in the input's dtype and channels-last, the rest f32."""
    c, h, w, order, cb = shape
    v = kernel_times.bn_act_inputs(c, h, w, b, dtype, cb, seed=c + h + b)
    errors = kernel_times.bn_act_errors(v, order, training)
    assert len(errors) == (7 if cb else 6)
    for name, (err, share) in errors.items():
        assert share <= 1.0, f"{name}: max err {err:.3g} ({share:.3g} of " \
            "the tolerance)"
    got = _card_step(v, order, training)
    assert [t.dtype for t in got] == [dtype, dtype] + [torch.float32] * (
        len(got) - 2)
    assert got[0].is_contiguous(memory_format=CL)
    assert got[1].is_contiguous(memory_format=CL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TRAIN_SHAPES[0], TRAIN_SHAPES[-1]],
                         ids=lambda s: "x".join(map(str, s[:3])) + s[3])
def test_repeats_and_a_graph_replay_are_bit_equal(card, shape):
    """Two eager training steps of the kernels on the same inputs, and a
    CUDA graph of the step replayed, give the same bits: z, dx, every
    gradient and the running statistics (no atomics; the merges' order is
    fixed by the shape)."""
    c, h, w, order, cb = shape
    v = kernel_times.bn_act_inputs(c, h, w, 64, torch.bfloat16, cb, seed=4)
    first = _card_step(v, order, True)
    second = _card_step(v, order, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    static = {k: (None if t is None else t.detach().clone())
              for k, t in v.items()}
    rm0, rv0 = static["running_mean"].clone(), static["running_var"].clone()
    x = static["x"].requires_grad_()
    params = [p.requires_grad_() for p in (static["conv_bias"],
                                           static["weight"], static["bias"])
              if p is not None]

    def step():
        z = bk.bn_act(x, static["conv_bias"], static["weight"],
                      static["bias"], static["running_mean"],
                      static["running_var"], order, True)
        return [z, *torch.autograd.grad(z, [x, *params], static["dz"])]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    static["running_mean"].copy_(rm0)
    static["running_var"].copy_(rv0)
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.detach() for t in out] + [static["running_mean"],
                                            static["running_var"]]
    assert all(torch.equal(a, b) for a, b in zip(first, replayed))


@pytest.mark.cuda
@pytest.mark.parametrize("arch, blocks, per_block", [("cnn8", 8, 7),
                                                     ("vgg", 12, 6)])
def test_launches_count_a_steps_calls(card, arch, blocks, per_block):
    """A training forward and backward of the model at B = 8 on the card
    (bf16 autocast, channels-last) goes through kernel F in every
    ConvBlock: 3 launches forward and 3 backward a block, one more with
    CNN8's conv bias; an evaluation forward 1 a block."""
    model = registry.build(arch, 36, seed=1).cuda().train()
    g = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn(8, 9, 128, 63, generator=g, device="cuda")
    s = torch.randn(8, 36, generator=g, device="cuda")
    before = bk.LAUNCHES
    model(f, s).sum().backward()
    torch.cuda.synchronize()
    assert bk.LAUNCHES - before == blocks * per_block
    model.eval()
    before = bk.LAUNCHES
    with torch.no_grad():
        model(f, s)
    assert bk.LAUNCHES - before == blocks
