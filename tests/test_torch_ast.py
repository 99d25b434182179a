"""The Audio Spectrogram Transformer of the port (models/ast_base.py)
against the benchmark's plain reference (breathbench/reference/ast_base.py)
on the CPU: logits, one training step (loss, every gradient, the AdamW
update) at small widths on seeded weights, the published widths' counts on
meta tensors, its spans, the seeded init, and the attention readers on a
synthetic trace. The AST has no Flax twin, so nothing here imports the JAX
package."""
import math

import numpy as np
import pytest
import torch

from breathbench import attention, data, flops, harness, program
from breathbench.reference import ast_base as ref
from breathbench.reference import layers as ref_layers
from breathbench.reference import train as ref_train
from breathbench.trace import WINDOW, Trace
from tpu_breath_torch import augment
from tpu_breath_torch.config import AST_TRAIN
from tpu_breath_torch.models import layers, registry
from tpu_breath_torch.models.ast_base import AST
from tpu_breath_torch.train import loop
from tpu_breath_torch.utils import profiling

CPU = torch.device("cpu")
# small widths, the real 128 x 63 input and patching (62 tokens)
SMALL = {"embed_dim": 64, "depth": 2, "num_heads": 4, "mlp_dim": 256,
         "patch": 16, "fstride": 10, "tstride": 10, "tokens": 62,
         "in_channels": 9}
CONFIG = harness.load_json(f"{harness.HERE}/configs/ast_base.json")
N_PARAMS = 86_877_697


def _small_model() -> AST:
    return AST(36, embed_dim=64, depth=2, num_heads=4, mlp_dim=256)


def _weights(seed: int) -> dict:
    """The benchmark's seeded draw over the reference's leaves."""
    return data.weights(seed, ref.leaves(SMALL), CPU)


def _inputs(b: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 9, 128, 63, generator=g),
            torch.randn(b, 36, generator=g),
            (torch.arange(b) % 2).float())


def _ref_logits(P, f, s):
    return ref.forward(P, f, s, SMALL, True, ref_layers.Dropout(
        torch.float32, False), ref_layers.rounder("f32"))


def test_logits_equal_the_reference_at_small_widths():
    """f32 logits of the port (SDPA's math path, nn.LayerNorm's kernel)
    and the reference (softmax and LayerNorm written out) differ by the
    order of f32 sums alone: measured ~1e-6 on logits of order one, bound
    1e-5."""
    w = _weights(3)
    model = _small_model()
    model.load_state_dict(w, strict=True)
    f, s, _ = _inputs(5, 1)
    with torch.no_grad():
        got = model.eval()(f, s)
        want = _ref_logits(dict(w), f, s)
    assert got.shape == (5,) and got.dtype == torch.float32
    assert float(want.abs().max()) > 0.1  # not saturated near zero
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_a_training_step_equals_the_references():
    """One step of loop.train_step (no augmentation) from the seeded
    weights against the reference's: BCE, the gradients (clipped, as AdamW
    takes them) and AdamW's first update, written out as
    breathbench/reference/train.py has it. The loss agrees to f32 rounding
    (bound 1e-6 relative). A gradient agrees within 1e-4 of its leaf's
    largest element: the two sides sum in other orders, measured <= 2.4e-6.
    AdamW's first update is lr * (g / (|g| + eps) + wd p), about lr * sign(g)
    whatever |g|: where g is clear of rounding (over 1e-4 of its leaf's
    largest) the parameter after the step agrees within lr * 1e-2; where
    it is rounding alone (the keys' bias, to which softmax is blind, has a
    gradient of 0 up to rounding) the update's sign is the rounding's, so
    there the parameter is only held to have moved at most lr (1 + wd
    |p|)."""
    cfg = AST_TRAIN
    lr = 1e-3
    w = _weights(7)
    f, s, y = _inputs(6, 2)
    model = _small_model()
    model.load_state_dict(w, strict=True)
    opt = loop.make_optimizer(model, cfg)
    loss, _ = loop.train_step(model, opt, lr, augment.Batch(f, s, y), cfg)

    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = ref_train.bce(_ref_logits(P, f, s), y)
    names = list(P)
    grads = torch.autograd.grad(ref_loss, [P[k] for k in names])
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if norm >= cfg.grad_clip_norm:
        grads = [g / norm * cfg.grad_clip_norm for g in grads]
    got = dict(model.named_parameters())
    assert set(got) == set(names)
    for k, g in zip(names, grads):
        scale = float(g.abs().max())
        torch.testing.assert_close(got[k].grad, g, rtol=0,
                                   atol=1e-4 * scale, msg=k)
        eps, wd = 1e-8, cfg.weight_decay
        p0, p1 = w[k], got[k].detach()
        want = p0 - lr * (g / (g.abs() + eps) + wd * p0)
        clear = g.abs() > 1e-4 * scale
        torch.testing.assert_close(p1[clear], want[clear], rtol=0,
                                   atol=lr * 1e-2, msg=k)
        assert bool(((p1 - p0).abs()[~clear]
                     <= lr * (1 + wd * p0.abs()[~clear]) * 1.001).all()), k
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)


def test_published_widths_count_on_meta():
    """At the published widths: 86,877,697 parameters in the port and in
    the reference's leaves (names and shapes the port's state_dict), 62
    tokens a clip, and the yardstick's step FLOPs the closed form."""
    with torch.device("meta"):
        model = registry.ARCHS["ast_base"](36)
        x = model.patch_embed(torch.empty(2, 9, 128, 63))
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert x.shape == (2, 60, 768) and model.pos_embed.shape[1] == 62
    (m, _), = program.members(CONFIG)
    assert m["num_parameters"] == N_PARAMS and m["tokens"] == 62
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: s for k, s, _ in ref.leaves(m)} == shapes
    assert {kind for _, _, kind in ref.leaves(m)} <= program.TRAINABLE
    # forward: every Linear 2 b N in out, the patch convolution 2 b 60
    # (9 16 16) 768, attention 4 b H N^2 d a block; the backward twice
    # the forward, but the convolution's (no input gradient): once
    b, n, d, h = 4, 62, 768, 12
    dense = 12 * (768 * 2304 + 768 * 768 + 2 * 768 * 3072)
    fwd_conv = 2 * b * 60 * 9 * 16 * 16 * 768
    fwd = 2 * b * n * dense + 12 * 4 * b * h * n * n * (d // h)
    head = 2 * b * 768
    assert flops.model_step(CONFIG, b) == 3 * (fwd + head) + 2 * fwd_conv


def test_the_forward_records_its_spans_only_while_recording():
    model = _small_model().eval()
    f, s, _ = _inputs(2, 3)
    profiling.records()
    with torch.no_grad():
        model(f, s)
    assert not profiling.records()["spans"]
    with profiling.recording(), torch.no_grad():
        model(f, s)
    names = [sp.name for sp in profiling.records()["spans"]]
    assert sorted(set(names)) == ["ast.attention", "ast.embed", "ast.head",
                                  "ast.mlp"]
    assert names.count("ast.attention") == names.count("ast.mlp") == 2
    assert names.count("ast.embed") == names.count("ast.head") == 1


def _parent_init(model, generator):
    """layers.init_weights as it was before the transformer's parameters:
    He-normal conv kernels, Xavier-uniform dense kernels, zero biases,
    BatchNorm reset."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                torch.nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_in),
                                      generator=generator)
            elif isinstance(m, torch.nn.Linear):
                torch.nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            else:
                continue
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    return model


@pytest.mark.parametrize("arch", ["cnn8", "vgg"])
def test_init_leaves_the_conv_models_draws_bit_identical(arch):
    got = registry.build(arch, 36, seed=11).state_dict()
    want = _parent_init(registry.ARCHS[arch](num_scalar_features=36),
                        torch.Generator().manual_seed(11)).state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_init_draws_the_tokens_from_the_seed():
    a = registry.build("ast_base", 36, seed=3).state_dict()
    b = registry.build("ast_base", 36, seed=3).state_dict()
    c = registry.build("ast_base", 36, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k in AST.TRUNC_NORMAL:
        assert not torch.equal(a[k], c[k])
        assert abs(float(a[k].std()) - 0.02) < 5e-3, k
    assert float(a["pos_embed"].abs().max()) < 0.2
    assert torch.all(a["blocks.0.norm1.weight"] == 1)
    assert torch.all(a["blocks.0.attn.qkv.bias"] == 0)


def _trace(kernels, t1=1e6):
    """A reduced trace of kernel events (name, start us, duration us)
    inside a window [0, t1) us."""
    events = [{"name": WINDOW, "ph": "X", "ts": 0.0, "dur": t1}]
    events += [{"name": n, "cat": "kernel", "ts": t, "dur": d}
               for n, t, d in kernels]
    return Trace(events, t1 / 1e6)


def test_the_attention_readers_on_a_synthetic_trace():
    """2 traced steps of 2 blocks' attention (a forward and a backward
    kernel each) and one evaluation forward: the readers' ms a step and
    roofline share from the kernels' names and the configuration's
    shapes."""
    fwd = "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention)"
    bwd = "fmha_cutlassB_bf16_aligned_64x64_k64_sm80(PyTorchMemEffAttention)"
    ks, t = [], 0.0
    for _ in range(2 * 2):
        ks.append((fwd, t, 100.0))
        ks.append((bwd, t + 200, 150.0))
        ks.append(("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", t + 600,
                   300.0))
        t += 1000
    ks.append((fwd, t, 150.0))
    run = harness.Run(cell=harness.cell("ast_base.train_cached"), seed=1,
                      seconds=1.0, trace=True, device=CPU, process_start=0.0,
                      counters={"traced_steps": 2})
    run.trace_data = _trace(ks)
    secs = (4 * (100 + 150) + 150) / 1e6
    assert harness.reader("attention_ms.train")(run) == pytest.approx(
        1e3 * secs / 2)
    (m, _), = program.members(CONFIG)
    h, n, d = 12, 62, 64
    b, b_eval = 512, 1024

    def bound(b, backward):
        act, lse = b * h * n * d * 2, b * h * n * 4
        nbytes = (8 if backward else 4) * act + lse
        ops = (8 if backward else 4) * b * h * n * n * d
        return max(nbytes / 3.35e12, ops / 989e12)
    want = 4 * (bound(b, True) + bound(b, False)) + bound(b_eval, False)
    assert harness.reader("attention_roofline.train")(run) == pytest.approx(
        100 * want / secs)
    assert attention.shapes(CONFIG) == (h, n, d)
    # bytes bound both calls at these shapes
    nbytes, ops, peak = attention.work(CONFIG, b, True)
    assert nbytes / harness.PEAK_HBM_BPS > ops / peak


def test_the_attention_readers_count_calls_whatever_the_backend():
    """The same 2 traced steps on flash's and cuDNN's kernel names, whose
    backward is three kernels a call (dot(dO, O), dQ dK dV, dQ's
    conversion): the readers take the device time of all of them and
    count one call a marker kernel, so the least time is that of 4
    training calls and one evaluation forward, as on memory-efficient
    attention."""
    flash = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<"
             "64, 128, 128, 4> >(pytorch_flash::Flash_fwd_params)",
             ["void pytorch_flash::flash_bwd_dot_do_o_kernel<true>("
              "pytorch_flash::Flash_bwd_params)",
              "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_"
              "kernel<Flash_bwd_kernel_traits<64> >(pytorch_flash::"
              "Flash_bwd_params)",
              "void pytorch_flash::flash_bwd_convert_dq_kernel<"
              "Flash_bwd_kernel_traits<64> >(pytorch_flash::"
              "Flash_bwd_params, int)"])
    cudnn = ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_"
             "knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0",
             ["void cudnn::fusion::compute_dot_do_o_specialized<true, 64>("
              "void const*, void const*, void*)",
              "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_"
              "knob_26_64x64x64_1x4x1_cga1x1x1_kernel0_0",
              "void cudnn::fusion::convert_dq_to_16bits<true>(void const*, "
              "void*)"])
    b, b_eval = 512, 1024
    want = (4 * (flops.bound_s(attention.work(CONFIG, b, True))
                 + flops.bound_s(attention.work(CONFIG, b, False)))
            + flops.bound_s(attention.work(CONFIG, b_eval, False)))
    for fwd, bwd in (flash, cudnn):
        ks, t = [], 0.0
        for _ in range(2 * 2):
            ks.append((fwd, t, 100.0))
            ks += [(n, t + 200 + 60 * i, 50.0) for i, n in enumerate(bwd)]
            ks.append(("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", t + 600,
                       300.0))
            t += 1000
        ks.append((fwd, t, 150.0))
        run = harness.Run(cell=harness.cell("ast_base.train_cached"), seed=1,
                          seconds=1.0, trace=True, device=CPU,
                          process_start=0.0, counters={"traced_steps": 2})
        run.trace_data = _trace(ks)
        secs = (4 * (100 + 3 * 50) + 150) / 1e6
        assert harness.reader("attention_ms.train")(run) == pytest.approx(
            1e3 * secs / 2)
        assert harness.reader("attention_roofline.train")(run) == (
            pytest.approx(100 * want / secs))


def test_the_attention_readers_read_nothing_without_its_kernels():
    run = harness.Run(cell=harness.cell("ast_base.train_cached"), seed=1,
                      seconds=1.0, trace=True, device=CPU, process_start=0.0,
                      counters={"traced_steps": 2})
    for metric in ("attention_ms.train", "attention_roofline.train"):
        assert harness.reader(metric)(run) is None  # no trace
    run.trace_data = _trace([("cudnn_convolution", 0.0, 10.0)])
    for metric in ("attention_ms.train", "attention_roofline.train"):
        assert harness.reader(metric)(run) is None  # no attention kernel


def test_the_cli_trains_the_ast_with_the_vgg_run_at_asts_rate():
    from tpu_breath_torch.cli import ARCH_CFGS
    from tpu_breath_torch.config import VGG_TRAIN

    assert ARCH_CFGS["ast_base"] == AST_TRAIN
    assert AST_TRAIN.base_lr == 2.5e-4
    assert {k: v for k, v in vars(AST_TRAIN).items() if k != "base_lr"} == {
        k: v for k, v in vars(VGG_TRAIN).items() if k != "base_lr"}
    train = dict(CONFIG["train"])
    assert train.pop("patience") == train["num_epochs"]
    assert all(getattr(AST_TRAIN, k) == v for k, v in train.items())


def test_init_weights_reaches_every_transformer_leaf():
    """Every parameter of the AST is drawn or set by init_weights: none is
    left at the constructor's zeros but the biases and LayerNorm shifts."""
    model = registry.build("ast_base", 36, seed=0)
    for k, p in model.state_dict().items():
        if k.endswith(".bias"):
            assert torch.all(p == 0), k
        else:
            assert bool(p.ne(0).any()), k
    assert isinstance(model.blocks[0].norm1, torch.nn.LayerNorm)
    assert not any(isinstance(m, layers.BatchNorm) for m in model.modules())
    np.testing.assert_equal(model.norm.eps, 1e-6)


def _small_cell_run(monkeypatch, trace: bool = False) -> dict:
    """The cell ast_base.train_cached run by the harness on the CPU at
    tiny sizes (breathbench/tests/tiny.py) and small widths (the port's
    registry and the configuration both at SMALL's), readings included."""
    import copy
    import functools
    import time

    from breathbench import report
    from breathbench.tests import tiny
    from breathbench.trace import Tracer

    widths = {k: SMALL[k] for k in ("embed_dim", "depth", "num_heads",
                                     "mlp_dim")}
    monkeypatch.setitem(registry.ARCHS, "ast_base",
                        functools.partial(AST, **widths))
    torch.set_num_threads(2)
    cell = harness.cell("ast_base.train_cached")
    cell.config = copy.deepcopy(cell.config)
    m = cell.config["members"][0]["model"]
    m.update(widths, num_parameters=sum(
        p.numel() for p in registry.ARCHS["ast_base"](36).parameters()))
    run = harness.Run(cell=cell, seed=2 ** 31 + 11, seconds=0.5, trace=trace,
                      device=CPU, process_start=time.perf_counter(),
                      sizes={**tiny.SIZES["train"], "oracle_workers": 0},
                      log=lambda _: None)
    if trace:
        run.tracer = Tracer(CPU)
    return report.line(run, harness.kind("train").run(run))


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_the_cell_at_small_widths_checks_the_step(fault, monkeypatch):
    """The harness's train kind drives the AST through fit on the CPU and
    its check holds it to the plain reference: correct as it is, not
    correct when AdamW leaves the state unchanged."""
    if fault == "unchanged":
        monkeypatch.setattr(loop.AdamW, "step", lambda self, lr: None)
    line = _small_cell_run(monkeypatch)
    assert line["correct"] == (fault is None), line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "train_clips_per_s" in line["metrics"]


def test_a_traced_cpu_run_reports_no_attention_metric(monkeypatch):
    """On the CPU the trace holds no kernel: the attention readers return
    nothing (the line leaves them out) and do not raise."""
    line = _small_cell_run(monkeypatch, trace=True)
    assert line["correct"]
    assert "attention_ms.train" not in line["metrics"]
    assert "attention_roofline.train" not in line["metrics"]
    assert line["metrics"]["graph_captures.train"]["value"] == 0
