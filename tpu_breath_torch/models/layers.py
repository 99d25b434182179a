"""Shared building blocks for the model zoo (counterpart of
tpu_breath/models/layers.py): the model body runs channels-last on the
card and NCHW on the CPU (Classifier.forward chooses by the features'
device); every layer keeps the layout it is given, and the parameters
stay NCHW-contiguous on both.

BatchNorm trains as Flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5) does:
Flax's momentum 0.9 is PyTorch's 0.1, and Flax's running variance tracks
the *biased* batch variance where nn.BatchNorm2d stores the unbiased one.

Under a data-parallel mesh of more than one rank (set_mesh) the layers
compute what the single process computes over the global batch, as XLA does
under a sharded jit: BatchNorm's statistics and their gradient sums are
all-reduced over the ranks (global_batch_norm), and Dropout / Dropout2d
draw their masks for the global batch, each rank keeping its rows. Without
a mesh, or with one rank, they are nn.BatchNorm2d's, nn.Dropout's and
nn.Dropout2d's own code.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_breath_torch.parallel import mesh as mesh_lib

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9


def _spread(mesh) -> bool:
    """Whether a mesh spreads the batch over more than one rank."""
    return mesh is not None and mesh.world > 1


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm of this rank's rows x [b, C, ...] with the global
    batch's mean and 1/std (given), its backward as SyncBatchNorm's: the
    input gradient needs the sums of dy and dy * xhat over the global
    batch (all-reduced); the weight and bias gradients are this rank's
    sums, which the step's gradient mean over the ranks completes. In f32;
    the output in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, mesh, n):
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh, ctx.n = mesh, n
        return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = [1, -1] + [1] * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        dy = dy.float()
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        total = mesh_lib.all_reduce_sum_(ctx.mesh, local.double())
        sum_dy, sum_dy_xhat = (total / ctx.n).float().chunk(2)
        dx = (dy - sum_dy.view(shape) - xhat * sum_dy_xhat.view(shape)) * (
            weight * invstd).view(shape)
        d_bias, d_weight = local.chunk(2)
        return dx.to(x.dtype), d_weight, d_bias, None, None, None, None


def global_batch_norm(bn: "BatchNorm", x: torch.Tensor) -> torch.Tensor:
    """bn in training on this rank's rows x, with the mean and biased
    variance of the global batch (sums of x and x^2 in float64,
    all-reduced over bn.mesh); updates bn's running statistics as Flax
    does, by the global ones."""
    dims = [0] + list(range(2, x.dim()))
    with torch.no_grad():
        xd = x.double()
        stats = torch.cat([xd.sum(dims), xd.square().sum(dims)])
        del xd
        mesh_lib.all_reduce_sum_(bn.mesh, stats)
        n = x.numel() // x.shape[1] * bn.mesh.world
        mean, sq = (stats / n).chunk(2)
        var = (sq - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + bn.eps).float()
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(m * mean.float())
        bn.running_var.mul_(1 - m).add_(m * var.float())
    return _GlobalBatchNorm.apply(x, bn.weight, bn.bias, mean.float(), invstd,
                                  bn.mesh, n)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over [B, C] or [B, C, H, W] with Flax's running statistics.

    Training normalises with the biased batch statistics (as both frameworks
    do) and updates running_mean = 0.9 * old + 0.1 * mean and running_var =
    0.9 * old + 0.1 * biased var. Keeps nn.BatchNorm2d's state_dict keys.
    Under a mesh of more than one rank (`mesh`, set by set_mesh) training
    takes the statistics of the global batch (global_batch_norm)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS,
                         momentum=1.0 - FLAX_MOMENTUM)
        self.mesh = None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if _spread(self.mesh):
            return global_batch_norm(self, x)
        n = x.numel() // x.shape[1]
        old = self.running_var * FLAX_MOMENTUM
        # a copy: autograd keeps the tensor F.batch_norm updated
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        with torch.no_grad():
            # F.batch_norm folded in momentum * var * n / (n - 1); take the
            # Bessel factor back out of the new share
            self.running_var.copy_((var - old) * ((n - 1) / n) + old)
        return out


class _GlobalDropout:
    """Dropout drawn for the global batch under a mesh of more than one
    rank: the noise of the whole global batch is drawn by the functional
    itself, on ones of the global batch's shape (from the same seeded
    generator on every rank, so the ranks agree with no communication, and
    as the single process draws it for that batch), and this rank keeps its
    rows: rank r's b rows are rows [r b, (r + 1) b)."""

    mesh = None

    def _global(self, x: torch.Tensor, tail: tuple, draw) -> torch.Tensor:
        b = x.shape[0]
        ones = torch.ones((b * self.mesh.world,) + tail, dtype=x.dtype,
                          device=x.device)
        return x * draw(ones)[self.mesh.rank * b:(self.mesh.rank + 1) * b]


class Dropout(_GlobalDropout, nn.Dropout):
    """nn.Dropout; under a mesh the global batch's mask (_GlobalDropout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.p > 0 and _spread(self.mesh)):
            return super().forward(x)
        return self._global(x, tuple(x.shape[1:]),
                            lambda ones: F.dropout(ones, self.p, True))


class Dropout2d(_GlobalDropout, nn.Dropout2d):
    """nn.Dropout2d (whole channels); under a mesh the global batch's mask
    (_GlobalDropout): one value a (clip, channel), as F.dropout2d draws."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.p > 0 and _spread(self.mesh)):
            return super().forward(x)
        return self._global(x, (x.shape[1],) + (1,) * (x.dim() - 2),
                            lambda ones: F.dropout2d(ones, self.p, True))


def set_mesh(model: nn.Module, mesh) -> None:
    """Point every BatchNorm and Dropout of model at mesh (None: off)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, _GlobalDropout)):
            m.mesh = mesh


def _act_bn(x: torch.Tensor, bn: BatchNorm, order: str) -> torch.Tensor:
    if order == "relu_bn":
        return bn(torch.relu(x))
    return F.gelu(bn(x), approximate="none")


class ConvBlock(nn.Module):
    """Conv3x3 (padding 1, optional stride) then ReLU -> BN ("relu_bn",
    CNN8) or BN -> exact GELU ("bn_gelu", VGG)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 order: str = "relu_bn", use_bias: bool = True):
        super().__init__()
        if order not in ("relu_bn", "bn_gelu"):
            raise ValueError(order)
        self.order = order
        self.conv = nn.Conv2d(in_features, features, 3, stride=strides,
                              padding=1, bias=use_bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _act_bn(self.conv(x), self.bn, self.order)


class MLPBlock(nn.Module):
    """Linear then ReLU -> BN or BN -> exact GELU, then optional Dropout."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.0,
                 order: str = "relu_bn", use_bias: bool = True):
        super().__init__()
        if order not in ("relu_bn", "bn_gelu"):
            raise ValueError(order)
        self.order = order
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        self.bn = BatchNorm(features)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(_act_bn(self.dense(x), self.bn, self.order))


def max_pool_2x2(x: torch.Tensor, ceil_mode: bool = False) -> torch.Tensor:
    """2x2 / stride-2 max pool; ceil_mode keeps the odd tail row/column."""
    return F.max_pool2d(x, 2, ceil_mode=ceil_mode)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> the mean over H and W, [B, C]. An average pool, not
    mean(dim=(2, 3)): its gradient comes back dense in x's layout, where
    mean's is a broadcast (and VGG's cast back makes it an NCHW copy), which
    sends the last BatchNorm's backward to torch's NCHW kernels."""
    return F.avg_pool2d(x, tuple(x.shape[2:])).flatten(1)


class Classifier(nn.Module):
    """features [B, C, H, W], scalars [B, S] -> logits [B]: the subclass's
    _body (to the last hidden layer) and its Linear `head`.

    On CUDA the body runs under bf16 autocast (the JAX package's bf16
    activations) unless bf16 is False, and in channels-last memory format
    (the features re-laid out once): cuDNN's sm_90 convolutions compute
    NHWC, so an NCHW body pays a transpose in and out of every convolution,
    and torch's NCHW BatchNorm kernels take one block a channel where the
    channels-last ones fill the card. The head always runs in f32.
    Elsewhere the body runs in the input's layout and dtype, or as the
    caller's autocast says."""

    def __init__(self, bf16: bool = True):
        super().__init__()
        self.bf16 = bf16

    def _body(self, features: torch.Tensor, scalars: torch.Tensor
              ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, features: torch.Tensor, scalars: torch.Tensor
                ) -> torch.Tensor:
        dev = features.device.type
        if dev == "cuda":
            features = features.contiguous(memory_format=torch.channels_last)
        # under a CUDA graph capture the weights' bf16 casts are captured
        # with the rest, not cached across it (the same casts either way)
        with (torch.autocast("cuda", dtype=torch.bfloat16,
                             cache_enabled=not
                             torch.cuda.is_current_stream_capturing())
              if dev == "cuda" and self.bf16 else contextlib.nullcontext()):
            z = self._body(features, scalars)
        with torch.autocast(dev, enabled=False):
            return self.head(z.float()).squeeze(-1)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init from a torch.Generator: He-normal (fan-in) conv
    kernels, Xavier-uniform dense kernels, zero biases, BN scale 1 / bias 0
    / mean 0 / var 1 (tpu_breath/models/layers.py:23-24)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_in),
                                generator=generator)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model
