"""The SDPA backends at the AST's attention shapes on the card: which one
models/ast_base.py pins (CUDA_BACKENDS) rests on this.

    python -m tpu_breath_torch.utils.sdpa_times [--out T.json]

For each of flash, memory-efficient and cuDNN attention, in bf16 at 12
heads of 64 over 62 tokens, Q, K and V laid out as the model hands them
(views of one [b, N, 3, H, d] projection): the ms of a training call
(forward and backward at the train batch, 512) and of an evaluation
forward (1,024), by CUDA events over 20 calls after 3 warm-ups (primed:
a spin kernel holds the stream first, so the card sets the pace); the
kernels each launches (one profiled training call); whether two training
calls give the same gradients bit for bit and a CUDA graph's replay the
eager call's; and the largest gap of the output from float32 math. A
backend that cannot take the call records its error. One JSON object on
stdout (and in --out)."""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from tpu_breath_torch.models import ast_base
from tpu_breath_torch.utils.kernel_times import cuda_ms

BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION,
            "efficient": SDPBackend.EFFICIENT_ATTENTION,
            "cudnn": SDPBackend.CUDNN_ATTENTION}
TRAIN_B, EVAL_B = 512, 1024
N = 62  # tokens a clip


def qkv(b: int, grad: bool, seed: int = 0):
    """The model's layout: q, k, v views of one [b, N, 3, H, d] tensor."""
    h, d = ast_base.NUM_HEADS, ast_base.EMBED_DIM // ast_base.NUM_HEADS
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, N, 3, h, d, generator=g, device="cuda",
                    dtype=torch.bfloat16).requires_grad_(grad)
    return x, x.permute(2, 0, 3, 1, 4).unbind(0)


def measure(backend: SDPBackend) -> dict:
    x, (q, k, v) = qkv(TRAIN_B, True)
    do = torch.randn(q.shape, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(1))

    def train():
        x.grad = None
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(q, k, v)
        o.backward(do)
        return o, x.grad

    xe, (qe, ke, ve) = qkv(EVAL_B, False, seed=2)

    @torch.no_grad()
    def evaluate():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qe, ke, ve)

    out = {}
    try:
        o1, g1 = (t.clone() for t in train())
        o2, g2 = train()
    except RuntimeError as e:
        return {"error": str(e).splitlines()[0][:300]}
    out["deterministic"] = bool(torch.equal(o1, o2) and torch.equal(g1, g2))
    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH):
        ref = F.scaled_dot_product_attention(q.float(), k.float(), v.float())
    out["max_abs_vs_f32"] = float((o1.float() - ref).abs().max())
    out["train_ms"] = cuda_ms(train, primed=True)
    out["eval_ms"] = cuda_ms(evaluate, primed=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        train()
        torch.cuda.synchronize()
    out["kernels"] = sorted({e.name for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and "Memcpy" not in e.name})
    # a graph of the training call replays the eager call's result
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        train()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            go, gg = train()
        graph.replay()
        torch.cuda.synchronize()
        out["graph_equals_eager"] = bool(torch.equal(go, o1)
                                         and torch.equal(gg, g1))
    except RuntimeError as e:
        out["graph_error"] = str(e).splitlines()[0][:300]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sdpa_times needs a CUDA device")
    res = {"device": torch.cuda.get_device_name(0),
           "shapes": {"train_b": TRAIN_B, "eval_b": EVAL_B, "tokens": N,
                      "heads": ast_base.NUM_HEADS},
           "backends": {name: measure(b) for name, b in BACKENDS.items()}}
    text = json.dumps(res)
    print(text, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
