"""Plain float32 building blocks of the reference models, and the
numerics they run in: "f32" (every operand as it is); "bf16" (the body as
a bfloat16 autocast runs it: each convolution's and matmul's operands and
output rounded to bfloat16, the gradient of its output too, the head in
float32); "fp8" (the control: as an fp8 training recipe runs each
convolution and matmul, its operands rounded to float8 e4m3 in the
forward and the gradient of its output to float8 e5m2 in the backward,
each with one scale a tensor; the rest in float32)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in dtype's grid, one scale for the tensor (its largest magnitude
    at the format's largest finite value)."""
    big = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / big
    return (x / scale).to(dtype).float() * scale


class _Fp8Op(torch.autograd.Function):
    """Identity on a convolution's or matmul's output whose backward rounds
    the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class _Bf16Op(torch.autograd.Function):
    """A convolution's or matmul's output rounded to bfloat16, and the
    gradient coming back into it."""

    @staticmethod
    def forward(ctx, y):
        return y.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Numerics:
    """How a convolution or a matmul takes its operands (operand) and
    hands back its output (output); head: the numerics of the model's
    head."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown numerics {name!r}")
        self.name = name
        self.head = Numerics("f32") if name == "bf16" else self

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        if self.name == "bf16":
            q = x.detach().to(torch.bfloat16).float()
        else:
            q = _round(x.detach(), torch.float8_e4m3fn)
        return x + (q - x.detach())  # the gradient passes straight through

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return y
        return (_Bf16Op if self.name == "bf16" else _Fp8Op).apply(y)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.operand(x)


def rounder(numerics: str) -> Numerics:
    return Numerics(numerics)


def conv(x, w, b, q, stride: int = 1, padding: int = 1):
    return q.output(F.conv2d(q(x), q(w), b, stride=stride, padding=padding))


def linear(x, w, b, q):
    return q.output(F.linear(q(x), q(w), b))


def batch_norm(x: torch.Tensor, P: dict, name: str, train
               ) -> torch.Tensor:
    """Training (train True): the batch's mean and biased variance;
    evaluation (False): the running statistics; train "calibrate": the
    batch's, which also become the running statistics."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        if train == "calibrate":
            P[f"{name}.running_mean"] = mean.detach().clone()
            P[f"{name}.running_var"] = var.detach().clone()
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    xhat = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
    return xhat * P[f"{name}.weight"].view(shape) + P[f"{name}.bias"].view(
        shape)


def bn_leaves(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


class Dropout:
    """The masks of a training forward, drawn as the program draws them:
    torch's own dropout functionals on ones of the program's shape and
    activation dtype, from the default generator of the device, in the
    order of the forward (the program seeds that generator per epoch). In
    evaluation no mask."""

    def __init__(self, dtype: torch.dtype, train: bool):
        self.dtype, self.train = dtype, train

    def __call__(self, x: torch.Tensor, p: float, channels: bool
                 ) -> torch.Tensor:
        if not self.train or p == 0.0:
            return x
        ones = torch.ones(x.shape, dtype=self.dtype, device=x.device)
        drawn = (F.dropout2d(ones, p, True) if channels
                 else F.dropout(ones, p, True))
        return x * ((drawn != 0).float() / (1.0 - p))
