"""The attention kernels of a transformer configuration's training step:
their names in the device trace and their least work, functions of the
configuration's shapes alone (the readers attention_ms.train and
attention_roofline.train).

NAMES holds substrings of the forward and backward kernels of each SDPA
backend on the card, whichever the model pins: memory-efficient attention
(CUTLASS's fmha_cutlassF / fmha_cutlassB, one kernel a call), flash
attention (flash_fwd; a backward of dot(dO, O), dQ dK dV and dQ's
conversion) and cuDNN's (the fprop and bprop kernels, and a backward's
dot(dO, O) and dQ conversion). The device time is that of every kernel
they name; CALLS names the one kernel each backend launches once a call,
which counts the calls. The card tests hold both lists to a profiled
step of the model and to each backend's training call.

A forward call reads Q, K and V and writes O and the log-sum-exp, 4 b H
N^2 d FLOPs; a backward call also reads O and dO, writes dQ, dK and dV, 8
b H N^2 d FLOPs (what FlopCounterMode counts for the reference's two
bmm's and their gradients). Activations are 2 bytes (bfloat16), the
log-sum-exp 4."""
from __future__ import annotations

from breathbench import flops, harness, program

NAMES = {"fwd": ("fmha_cutlassF", "pytorch_flash::flash_fwd",
                 "_sdpa_sm90_flash_fprop"),
         "bwd": ("fmha_cutlassB", "pytorch_flash::flash_bwd",
                 "_sdpa_sm90_flash_bprop", "cudnn::fusion::compute_dot_do_o",
                 "cudnn::fusion::convert_dq_to_16bits")}
CALLS = {"fwd": ("fmha_cutlassF", "flash_fwd_kernel",
                 "flash_fwd_splitkv_kernel", "_sdpa_sm90_flash_fprop"),
         "bwd": ("fmha_cutlassB", "flash_bwd_dq_dk_dv",
                 "_sdpa_sm90_flash_bprop")}
ACT_BYTES, LSE_BYTES = 2, 4


def found(trace) -> tuple[float, dict]:
    """(device seconds of the attention's kernels, {"fwd": calls, "bwd":
    calls}) in a trace."""
    secs = sum(s for s, _ in trace.counts_by(NAMES).values())
    return secs, {k: n for k, (_, n) in trace.counts_by(CALLS).items()}


def shapes(config: dict) -> tuple[int, int, int]:
    """(heads, tokens, head size) of the configuration's one model."""
    (m, _), = program.members(config)
    return m["num_heads"], m["tokens"], m["embed_dim"] // m["num_heads"]


def work(config: dict, b: int, backward: bool) -> tuple[int, int, float]:
    """(bytes, FLOPs, peak) of one forward or backward call at batch b."""
    h, n, d = shapes(config)
    act, lse = b * h * n * d * ACT_BYTES, b * h * n * LSE_BYTES
    if backward:
        return 8 * act + lse, 8 * b * h * n * n * d, harness.PEAK_BF16_FLOPS
    return 4 * act + lse, 4 * b * h * n * n * d, harness.PEAK_BF16_FLOPS


def least_seconds(config: dict, calls: dict) -> float:
    """The least time of the calls found: each backward call at the train
    batch with as many forward calls, the other forward calls the
    evaluation's."""
    b, b_eval = (config["train"][k] for k in ("batch_size",
                                              "eval_batch_size"))
    n_fwd, n_bwd = calls["fwd"], calls["bwd"]
    return (n_bwd * (flops.bound_s(work(config, b, True))
                     + flops.bound_s(work(config, b, False)))
            + max(n_fwd - n_bwd, 0) * flops.bound_s(work(config, b_eval,
                                                         False)))
