"""Kernel F: a ConvBlock's BatchNorm and its activation in one channels-last
kernel set (csrc/bn_act_kernel.cu), training forward and backward and the
evaluation forward.

Replaces no TPU kernel (the JAX package leaves BatchNorm to XLA, which
fuses it with its activation). On the card torch ran them as separate
channels-last BatchNorm kernels and activation passes, 13 passes over the
activations of a VGG step; the kernels take the 8 the mathematics needs.
With t = x + b (b the convolution's bias, or none):

    "bn_gelu" (VGG):  z = gelu(gamma (t - mean) r + beta), exact GELU
    "relu_bn" (CNN8): z = gamma (relu(t) - mean) r + beta

r = 1 / sqrt(var + eps). Training takes the batch's mean and biased
variance of the normalised input and updates the running statistics as
Flax does (running = 0.9 running + 0.1 batch, the biased variance); the
evaluation takes the running statistics. The backward saves x, b, gamma,
beta and the statistics, never the BatchNorm's output.

bn_act dispatches by its input alone: a CPU tensor takes the plain version
(bn_act_plain, autograd through torch ops); a CUDA tensor takes the kernels
or raises (4-D channels-last bf16 or f32 whose channels fill whole 16-byte
groups). LAUNCHES counts the kernels launched: a training ConvBlock is 3
forward and 3 backward (4 with a conv bias), an evaluation forward 1.
"""
from __future__ import annotations

import torch

from tpu_breath_torch.ops.cuda import _build

ORDERS = ("bn_gelu", "relu_bn")  # the .cu's kBnGelu, kReluBn
THREADS = 256      # a streaming block (csrc: kThreads)
MAX_BLOCKS = 264   # csrc: kMaxBlocks
VECTOR_BYTES = 16  # a thread's channel group

LAUNCHES = 0


def bn_act_plain(x: torch.Tensor, conv_bias, weight: torch.Tensor,
                 bias: torch.Tensor, running_mean: torch.Tensor,
                 running_var: torch.Tensor, order: str, training: bool,
                 momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of bn_act (its gradient by autograd): the conv
    bias added, then the block's torch path, models/layers._act_bn over
    BatchNorm's own code (layers.batch_norm: F.batch_norm with Flax's
    running update), in x's dtype and layout."""
    from tpu_breath_torch.models import layers  # layers imports this module

    t = x if conv_bias is None else x + conv_bias.to(x.dtype).view(
        (1, -1) + (1,) * (x.dim() - 2))
    return layers._act_bn(t, lambda u: layers.batch_norm(
        u, weight, bias, running_mean, running_var, training, momentum,
        eps), order)


def blocks(m: int, c: int, itemsize: int) -> int:
    """G, the streaming passes' block count for m rows of c channels of
    `itemsize` bytes: as many as the rows fill, at most MAX_BLOCKS. The
    partials' merge order, and so the bits, follow from it."""
    lanes = c // (VECTOR_BYTES // itemsize)
    return max(1, min(MAX_BLOCKS, -(-m // (THREADS // lanes))))


def check_kernel_input(x: torch.Tensor, conv_bias, params) -> None:
    """Raises unless the kernels take x and the f32 [C] parameters: 4-D
    channels-last bf16 or f32 on a CUDA device, 16-byte aligned, C a whole
    number of 16-byte groups whose count divides THREADS. The layout, type,
    channel and parameter rules come first, so they hold for a tensor on
    any device."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise TypeError(f"bn_act kernel: x {tuple(x.shape)} with strides "
                        f"{x.stride()}: want a 4-D channels-last tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bn_act kernel: x {x.dtype}, want bfloat16 or "
                        "float32")
    c, per = x.shape[1], VECTOR_BYTES // x.element_size()
    if c % per or c < per or THREADS % (c // per):
        raise ValueError(f"bn_act kernel: {c} channels of {x.dtype}: want a "
                         f"multiple of {per} in groups that divide {THREADS}")
    if x.numel() == 0:
        raise ValueError(f"bn_act kernel: x {tuple(x.shape)} is empty")
    for p in (conv_bias, *params):
        if p is None:
            continue
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise TypeError(f"bn_act kernel: a parameter {p.dtype} "
                            f"{tuple(p.shape)} on {p.device}: want f32 [{c}] "
                            f"contiguous on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"bn_act kernel: x on {x.device}, want a CUDA "
                         "device (CPU tensors take the plain version)")
    if x.data_ptr() % VECTOR_BYTES:
        raise ValueError("bn_act kernel: x is not 16-byte aligned")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(name: str, *args) -> None:
    global LAUNCHES
    _build.check(getattr(_build.lib(), name)(*args), name)
    LAUNCHES += 1


def _layout(x: torch.Tensor) -> tuple:
    """(m, c, G, is_bf16) of a kernel call on x [B, C, H, W]."""
    m, c = x.numel() // x.shape[1], x.shape[1]
    return m, c, blocks(m, c, x.element_size()), int(x.dtype ==
                                                     torch.bfloat16)


def stats_pass(x, conv_bias, running_mean, running_var, order: str,
               momentum: float, stream: int):
    """Training forward, pass 1 (2 launches): the batch's mean and biased
    variance [C] of the normalised input; the running statistics updated
    in place."""
    m, c, g, bf16 = _layout(x)
    part = torch.empty(2, g, c, dtype=torch.float32, device=x.device)
    mean, var = torch.empty(2, c, dtype=torch.float32, device=x.device)
    _launch("bn_act_stats_launch", x.data_ptr(), _ptr(conv_bias),
            part[0].data_ptr(), part[1].data_ptr(), m, c, g, bf16,
            ORDERS.index(order), stream)
    _launch("bn_act_merge_launch", part[0].data_ptr(), part[1].data_ptr(),
            m, c, g, mean.data_ptr(), var.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), 1.0 - momentum,
            momentum, stream)
    return mean, var


def apply_pass(x, conv_bias, mean, var, weight, bias, order: str,
               eps: float, stream: int) -> torch.Tensor:
    """The forward's elementwise pass (1 launch): z from x and the
    statistics given (the batch's or the running ones)."""
    m, c, g, bf16 = _layout(x)
    z = torch.empty_like(x)
    _launch("bn_act_apply_launch", x.data_ptr(), _ptr(conv_bias),
            mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), z.data_ptr(), m, c, g, eps, bf16,
            ORDERS.index(order), stream)
    return z


def reduce_pass(dz, x, conv_bias, mean, var, weight, bias, order: str,
                training: bool, eps: float, stream: int) -> torch.Tensor:
    """Backward, pass 1 (2 launches): [4, C] f32 of d_beta, d_gamma and the
    dx pass's coefficients c1, c2 (zeros for the running statistics)."""
    m, c, g, bf16 = _layout(x)
    part = torch.empty(2, g, c, dtype=torch.float32, device=x.device)
    out = torch.empty(4, c, dtype=torch.float32, device=x.device)
    _launch("bn_act_reduce_launch", dz.data_ptr(), x.data_ptr(),
            _ptr(conv_bias), mean.data_ptr(), var.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), m, c, g, eps, bf16, ORDERS.index(order),
            stream)
    _launch("bn_act_sums_launch", part[0].data_ptr(), part[1].data_ptr(),
            m, c, g, var.data_ptr(), eps, int(training), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), stream)
    return out


def elemt_pass(dz, x, conv_bias, mean, var, weight, bias, sums,
               order: str, eps: float, stream: int):
    """Backward, pass 2 (1 launch, 2 with a conv bias): dx, and the conv
    bias's gradient (None without one); sums is reduce_pass's."""
    m, c, g, bf16 = _layout(x)
    dx = torch.empty_like(x)
    part = (None if conv_bias is None else
            torch.empty(g, c, dtype=torch.float32, device=x.device))
    _launch("bn_act_elemt_launch", dz.data_ptr(), x.data_ptr(),
            _ptr(conv_bias), mean.data_ptr(), var.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), sums[2].data_ptr(),
            sums[3].data_ptr(), dx.data_ptr(), _ptr(part), m, c, g, eps,
            bf16, ORDERS.index(order), stream)
    if conv_bias is None:
        return dx, None
    d_conv_bias = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch("bn_act_sums_launch", part.data_ptr(), None, m, c, g, None,
            eps, 0, d_conv_bias.data_ptr(), None, None, None, stream)
    return dx, d_conv_bias


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _BnAct(torch.autograd.Function):
    """bn_act on the kernels. Forward: the batch's statistics (training;
    the running ones updated in place) or the running ones, then z.
    Backward: the sums, then dx and the conv bias's gradient."""

    @staticmethod
    def forward(ctx, x, conv_bias, weight, bias, running_mean, running_var,
                order, training, momentum, eps):
        stream = _stream(x)
        if training:
            mean, var = stats_pass(x, conv_bias, running_mean, running_var,
                                   order, momentum, stream)
        else:
            mean, var = running_mean, running_var
        z = apply_pass(x, conv_bias, mean, var, weight, bias, order, eps,
                       stream)
        ctx.save_for_backward(x, conv_bias, weight, bias, mean, var)
        ctx.order, ctx.training, ctx.eps = order, training, eps
        return z

    @staticmethod
    def backward(ctx, dz):
        x, conv_bias, weight, bias, mean, var = ctx.saved_tensors
        dz = dz.to(x.dtype).contiguous(memory_format=torch.channels_last)
        if dz.data_ptr() % VECTOR_BYTES:  # a view at an odd offset
            dz = dz.clone(memory_format=torch.channels_last)
        stream = _stream(x)
        sums = reduce_pass(dz, x, conv_bias, mean, var, weight, bias,
                           ctx.order, ctx.training, ctx.eps, stream)
        dx, d_conv_bias = elemt_pass(dz, x, conv_bias, mean, var, weight,
                                     bias, sums, ctx.order, ctx.eps, stream)
        return (dx, d_conv_bias, sums[1], sums[0], None, None, None, None,
                None, None)


def bn_act(x: torch.Tensor, conv_bias, weight: torch.Tensor,
           bias: torch.Tensor, running_mean: torch.Tensor,
           running_var: torch.Tensor, order: str, training: bool,
           momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """A ConvBlock's BatchNorm and activation on x [B, C, H, W], the
    convolution's output without its bias conv_bias ([C] or None); weight,
    bias the BatchNorm's gamma and beta; order "bn_gelu" or "relu_bn";
    training: the batch's statistics (the running ones updated in place),
    else the running ones. CPU tensors run bn_act_plain; CUDA tensors run
    kernel F or raise."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r}, want one of {ORDERS}")
    if x.dim() < 2:
        raise ValueError(f"x {tuple(x.shape)}: want [B, C, ...]")
    params = (weight, bias, running_mean, running_var)
    if x.device.type == "cpu":
        return bn_act_plain(x, conv_bias, *params, order, training,
                            momentum, eps)
    check_kernel_input(x, conv_bias, params)
    return _BnAct.apply(x, conv_bias, *params, order, training, momentum,
                        eps)
