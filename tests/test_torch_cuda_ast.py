"""The Audio Spectrogram Transformer (models/ast_base.py) on the card: its
graphed step against the eager one, its attention kernels and each SDPA
backend's against the benchmark readers' name lists, bf16 logits against
the f32 plain reference, and the pinned SDPA backend.

Marked `cuda`; each test skips without a CUDA device (decided in the
fixture, never at import). Imports no JAX. On the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda_ast.py -m cuda -p no:cacheprovider
"""
import contextlib
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BATCH = 512  # the cell's train batch


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned SDPA backends run only "
                    "there")
    return torch.device("cuda")


def _data(n: int, seed: int):
    """Seeded features of the system's shape [n, 9, 128, 63], scalars,
    alternating labels, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(n, 9, 128, 63, generator=g, device="cuda"),
            torch.randn(n, 36, generator=g, device="cuda"),
            (torch.arange(n, device="cuda") % 2).float())


def _steps(data, steps: int, eager: bool, seed: int = 3):
    """`steps` cached TrainSteps of the published AST from one seed
    (augmentation and its draws on), graphed or inside graphs.eager():
    the losses and the state afterwards."""
    from tpu_breath_torch import graphs
    from tpu_breath_torch.config import AST_TRAIN
    from tpu_breath_torch.models import registry
    from tpu_breath_torch.train import loop

    b = data[0].shape[0] // 2
    cfg = dataclasses.replace(AST_TRAIN, batch_size=b)
    model = registry.build("ast_base", 36, seed=seed).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    step = loop.TrainStep(model, loop.make_optimizer(model, cfg), data, cfg,
                          gen)
    rows = torch.randperm(2 * b, generator=torch.Generator().manual_seed(4)
                          ).view(2, b).cuda()
    lr = torch.full((), 2.5e-4, device="cuda")
    on = torch.ones((), dtype=torch.bool, device="cuda")
    torch.manual_seed(2)
    losses = []
    with graphs.eager() if eager else contextlib.nullcontext():
        for k in range(steps):
            losses.append(step(rows[k % 2], lr, on)[0].clone())
    torch.cuda.synchronize()
    assert len(step.graphs) == (0 if eager else 1)
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


def test_graphed_step_equals_eager_step(cuda):
    """Three steps of the published AST at batch 64 (augmentation on),
    replayed from one CUDA graph and run eagerly inside loop.reproducible():
    every loss and every parameter bit-equal, and a second graphed run
    from the same seed equal again (the attention's backward included)."""
    from tpu_breath_torch.train import loop

    data = _data(128, 5)
    with loop.reproducible():
        eager = _steps(data, 3, eager=True)
        graphed = _steps(data, 3, eager=False)
        again = _steps(data, 3, eager=False)
    for run in (graphed, again):
        assert all(torch.equal(a, b) for a, b in zip(eager[0], run[0]))
        assert all(torch.equal(eager[1][k], run[1][k]) for k in eager[1])
    assert all(torch.isfinite(x).all() for x in eager[0])


def _launch_ranges(events: list) -> tuple[list, dict]:
    """The trace's kernels as (name, host launch time) and its ranges
    (user annotations and CPU ops) by name as [(start, end)]."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [(e["name"], launch.get(e["args"].get("correlation")))
               for e in events if e.get("cat") == "kernel"]
    ranges: dict = {}
    for e in events:
        if e.get("cat") in ("user_annotation", "cpu_op") and "dur" in e:
            ranges.setdefault(e["name"], []).append((e["ts"],
                                                     e["ts"] + e["dur"]))
    return kernels, ranges


def _inside(t, spans) -> bool:
    return t is not None and any(a <= t <= b for a, b in spans)


def test_attention_kernels_are_the_readers_names(cuda):
    """One eager profiled training step of the published AST at the cell's
    batch: every kernel launched inside an ast.attention range (the SDPA
    call) is one of breathbench/attention.py's forward NAMES, and its
    forward CALLS count one a block; the SDPA backward ops' CALLS count one
    "bwd" a block; and no kernel launched outside those ranges matches a
    name, so the readers count the attention and nothing else."""
    from breathbench import attention

    subs = [s for names in attention.NAMES.values() for s in names]
    data = _data(2 * BATCH, 6)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _steps(data, 1, eager=True)  # cuBLAS's and the backends' first use
    with torch.profiler.profile(activities=acts) as prof:
        _steps(data, 1, eager=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels, ranges = _launch_ranges(events)
    fwd_ranges = ranges.get("ast.attention", [])
    bwd_ranges = [iv for name, ivs in ranges.items()
                  if name.startswith("aten::_scaled_dot_product")
                  and "backward" in name for iv in ivs]
    assert len(fwd_ranges) == 12 and len(bwd_ranges) == 12, sorted(ranges)
    inside = [n for n, t in kernels if _inside(t, fwd_ranges)]
    in_bwd = [n for n, t in kernels if _inside(t, bwd_ranges)]
    outside = [n for n, t in kernels
               if not _inside(t, fwd_ranges) and not _inside(t, bwd_ranges)]
    print(json.dumps({"forward": sorted(set(inside)),
                      "backward": sorted(set(in_bwd))}))
    assert inside and all(any(s in n for s in attention.NAMES["fwd"])
                          for n in inside), inside
    assert sum(any(s in n for s in attention.CALLS["fwd"])
               for n in inside) == 12
    assert sum(any(s in n for s in attention.CALLS["bwd"])
               for n in in_bwd) == 12
    assert not [n for n in outside if any(s in n for s in subs)]


def test_bf16_logits_near_the_f32_reference(cuda):
    """The published AST with the benchmark's seeded weights, evaluation
    logits of 512 seeded clips' features (bf16 body on the card, the
    graphed Predictor at the cell's evaluation batch) against the plain
    reference in f32 with TF32 off, in blocks of 128. Measured on an H100
    (seeded logits spread 0.079 around their mean): largest gap
    0.0168, mean 0.0050; the reference's fp8 control 0.220 and 0.056. The
    bounds, 0.05 and 0.015, are 3x the bf16 gaps, and the fp8 control,
    one precision below the configuration's, misses both."""
    from breathbench import check, data, harness, program
    from breathbench.reference import layers
    from tpu_breath_torch import features
    from tpu_breath_torch.train import loop

    config = harness.load_json(f"{harness.HERE}/configs/ast_base.json")
    (m, _), = program.members(config)
    y = data.labels(7, 512, cuda)
    wavs = data.clips(7, y).cpu().numpy()
    f, s = features.extract_features_batched(
        wavs, program.feature_spec(config), 128, device=cuda)
    f, s = torch.from_numpy(f).to(cuda), torch.from_numpy(s).to(cuda)
    weights = program.weights(7, config, cuda)
    model, = program.models(config, weights, cuda)
    got = loop.Predictor(model, f, s, 1024)()
    torch.cuda.synchronize()
    got = got.double().numpy()
    mod = program.reference("ast_base")
    P = {k: v.float() for k, v in weights[0].items()}

    def ref(numerics):
        out = []
        with harness.full_f32(), torch.no_grad():
            for lo in range(0, 512, check.BLOCK):
                out.append(mod.forward(P, f[lo:lo + check.BLOCK],
                                       s[lo:lo + check.BLOCK], m, False,
                                       layers.Dropout(torch.float32, False),
                                       layers.rounder(numerics)))
        return torch.cat(out).double().cpu().numpy()
    want, fp8 = ref("f32"), ref("fp8")
    gap, gap8 = np.abs(got - want), np.abs(fp8 - want)
    print(json.dumps({"max": gap.max(), "mean": gap.mean(),
                      "fp8_max": gap8.max(), "fp8_mean": gap8.mean(),
                      "logit_std": want.std()}))
    assert want.std() > 0.01  # the logits depend on the clip
    assert gap.max() <= 0.05 and gap.mean() <= 0.015
    assert gap8.max() > 0.05 and gap8.mean() > 0.015


# the kernel-name family of each SDPA backend on this card
FAMILY = {"FLASH_ATTENTION": "pytorch_flash::",
          "EFFICIENT_ATTENTION": "fmha_cutlass",
          "CUDNN_ATTENTION": "cudnn_generated_fort_native_sdpa"}


def test_the_pinned_backend_is_the_one_that_runs(cuda):
    """The model's attention on bf16 and f32 tokens, forward and backward,
    runs the kernels of the backend CUDA_BACKEND pins and no other
    backend's, nor the math path's softmax; a call the pinned backend
    cannot take (3-D tokens, which it refuses and the math path would
    take) raises instead of falling back."""
    from tpu_breath_torch.models import ast_base

    acts = [torch.profiler.ProfilerActivity.CUDA]
    pinned = ast_base.CUDA_BACKEND.name
    for dtype in (torch.bfloat16, torch.float32):
        attn = ast_base.Attention(768, 12).to("cuda", dtype)
        x = torch.randn(8, 62, 768, device="cuda", dtype=dtype,
                        requires_grad=True)
        with torch.profiler.profile(activities=acts) as prof:
            attn(x).sum().backward()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(FAMILY[pinned] in n for n in names) == 2, (dtype, names)
        others = [f for k, f in FAMILY.items() if k != pinned]
        assert not [n for n in names if any(f in n for f in others)], names
        assert not [n for n in names if "softmax" in n.lower()], names
    q = torch.randn(4, 62, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        ast_base.attend(q, q, q)
    assert ast_base.attend(q.cpu(), q.cpu(), q.cpu()).shape == q.shape


@pytest.mark.parametrize("backend", sorted(FAMILY))
def test_every_backends_attention_kernels_are_named(cuda, backend):
    """One bf16 training call (forward, then backward) of each SDPA backend
    at the cell's shapes on leaf Q, K and V, profiled: every kernel of the
    backend's own launched inside the SDPA forward op (torch's copies
    aside) is one of breathbench/attention.py's forward NAMES, inside the
    backward op one of its backward NAMES; CALLS counts one forward and
    one backward call; and no kernel outside those ops matches a name. So
    the readers hold whichever backend the model pins."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from breathbench import attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(BATCH, 12, 62, 64, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    for x in (q, k, v):
        x.requires_grad_(True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def call():
        torch.nn.functional.scaled_dot_product_attention(q, k, v).backward(do)
        torch.cuda.synchronize()

    with sdpa_kernel(getattr(SDPBackend, backend)):
        call()  # the backend's first use
        with torch.profiler.profile(activities=acts) as prof:
            # a kernel of torch's first: the session's first launch has gone
            # unrecorded on the card, and here it would be the forward's
            torch.ones(1, device="cuda").add_(1)
            call()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels, ranges = _launch_ranges(events)
    ops = [n for n in ranges if n.startswith("aten::_scaled_dot_product")]
    fwd_ranges = [iv for n in ops if "backward" not in n for iv in ranges[n]]
    bwd_ranges = [iv for n in ops if "backward" in n for iv in ranges[n]]
    assert fwd_ranges and bwd_ranges, sorted(ranges)
    fwd = [n for n, t in kernels if _inside(t, fwd_ranges)
           and "at::native" not in n]
    bwd = [n for n, t in kernels if _inside(t, bwd_ranges)
           and "at::native" not in n]
    outside = [n for n, t in kernels
               if not _inside(t, fwd_ranges) and not _inside(t, bwd_ranges)]
    print(json.dumps({backend: {"forward": sorted(set(fwd)),
                                "backward": sorted(set(bwd))}}))

    def count(names, part):
        return sum(any(s in n for s in part) for n in names)
    assert fwd and count(fwd, attention.NAMES["fwd"]) == len(fwd), fwd
    assert bwd and count(bwd, attention.NAMES["bwd"]) == len(bwd), bwd
    assert count(fwd, attention.CALLS["fwd"]) == 1, fwd
    assert count(bwd, attention.CALLS["bwd"]) == 1, bwd
    assert count(fwd, attention.CALLS["bwd"]) == 0, fwd
    assert count(bwd, attention.CALLS["fwd"]) == 0, bwd
    assert not count(outside, attention.NAMES["fwd"] + attention.NAMES["bwd"])
