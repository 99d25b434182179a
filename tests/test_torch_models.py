"""CNN8 and VGG of the PyTorch port against Flax through cnn8_from_flax /
vgg_from_flax: parameter counts, f32 logits (<= 1e-4), bf16 logits (bound
measured below), BatchNorm mapping and training statistics, seeded init and
the registry."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import flax.linen as flax_nn

from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.models.vgg import VGG as FlaxVGG
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.cnn8 import CNN8
from tpu_breath_torch.models.convert import cnn8_from_flax, vgg_from_flax
from tpu_breath_torch.models.layers import BatchNorm
from tpu_breath_torch.models.vgg import VGG

N_PARAMS = 2_433_473
N_PARAMS_VGG = 8_145_985


@pytest.fixture(scope="module")
def flax_vars():
    """Seeded Flax init; batch_stats moved off (0, 1) so the BN mapping is
    exercised."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((4, 9, 128, 63)).astype(np.float32)
    s = rng.standard_normal((4, 36)).astype(np.float32)
    v = FlaxCNN8(num_scalar_features=36, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(f), jnp.asarray(s),
        train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda x: np.asarray(x) + 0.2 * rng.random(x.shape).astype(np.float32),
        v["batch_stats"])
    return params, stats, f, s


def _port(params, stats) -> CNN8:
    model = CNN8(num_scalar_features=36)
    model.load_state_dict(cnn8_from_flax(params, stats))
    return model.eval()


def test_param_count_matches_flax(flax_vars):
    params = flax_vars[0]
    assert sum(x.size for x in jax.tree.leaves(params)) == N_PARAMS
    model = registry.build("cnn8", 36)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS


def test_f32_logits_match_flax(flax_vars):
    params, stats, f, s = flax_vars
    ref = np.asarray(FlaxCNN8(num_scalar_features=36, dtype=jnp.float32)
                     .apply({"params": params, "batch_stats": stats},
                            jnp.asarray(f), jnp.asarray(s), train=False))
    with torch.no_grad():
        got = _port(params, stats)(torch.from_numpy(f), torch.from_numpy(s))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_bf16_logits_match_flax(flax_vars):
    """Flax bf16 activations vs the port under bf16 autocast (on the CPU
    here; the card autocasts by itself). Measured gap 4.9e-3 on logits of
    ~1, about what either side differs from its own f32 run (6e-3):
    bound 2e-2."""
    params, stats, f, s = flax_vars
    ref = np.asarray(FlaxCNN8(num_scalar_features=36)
                     .apply({"params": params, "batch_stats": stats},
                            jnp.asarray(f), jnp.asarray(s), train=False))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = _port(params, stats)(torch.from_numpy(f), torch.from_numpy(s))
    assert got.dtype == torch.float32  # the last Linear runs in f32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


def test_converter_maps_batchnorm_without_rescaling(flax_vars):
    params, stats, _, _ = flax_vars
    sd = cnn8_from_flax(params, stats)
    np.testing.assert_array_equal(
        sd["convs.3.bn.running_var"].numpy(),
        stats["ConvBlock_3"]["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(
        sd["classifier.1.bn.weight"].numpy(),
        params["MLPBlock_3"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(
        sd["convs.0.conv.weight"].numpy(),
        params["ConvBlock_0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  params["Dense_0"]["kernel"].T)
    assert set(sd) == set(CNN8(36).state_dict())


def test_seeded_init_is_reproducible_and_scaled():
    a = registry.build("cnn8", 36, seed=3).state_dict()
    b = registry.build("cnn8", 36, seed=3).state_dict()
    c = registry.build("cnn8", 36, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.conv.weight"], c["convs.0.conv.weight"])
    w = a["convs.4.conv.weight"]  # He-normal, fan-in 128*9
    assert abs(float(w.std()) - (2.0 / (128 * 9)) ** 0.5) < 2e-3
    assert torch.all(a["convs.4.conv.bias"] == 0)
    lim = (6.0 / (320 + 256)) ** 0.5  # Xavier-uniform
    assert float(a["classifier.0.dense.weight"].abs().max()) <= lim


def test_eval_deterministic_train_stochastic():
    model = registry.build("cnn8", 36)
    f = torch.randn(2, 9, 128, 63, generator=torch.Generator().manual_seed(0))
    s = torch.zeros(2, 36)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(f, s), model(f, s))
    model.train()
    with torch.no_grad():
        assert not torch.equal(model(f, s), model(f, s))


def test_registry():
    assert set(registry.ARCHS) == {"cnn8", "vgg", "ast_base"}
    assert isinstance(registry.build("vgg", 36), VGG)
    with pytest.raises(ValueError):
        registry.build("resnet", 36)


@pytest.fixture(scope="module")
def flax_vgg_vars():
    """Seeded Flax VGG init, batch_stats moved off (0, 1)."""
    rng = np.random.default_rng(1)
    f = rng.standard_normal((3, 9, 128, 63)).astype(np.float32)
    s = rng.standard_normal((3, 36)).astype(np.float32)
    v = FlaxVGG(num_scalar_features=36, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(f), jnp.asarray(s),
        train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda x: np.asarray(x) + 0.2 * rng.random(x.shape).astype(np.float32),
        v["batch_stats"])
    return params, stats, f, s


def _port_vgg(params, stats) -> VGG:
    model = VGG(num_scalar_features=36)
    model.load_state_dict(vgg_from_flax(params, stats))
    return model.eval()


def test_vgg_param_count_matches_flax(flax_vgg_vars):
    params = flax_vgg_vars[0]
    assert sum(x.size for x in jax.tree.leaves(params)) == N_PARAMS_VGG
    model = registry.build("vgg", 36)
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS_VGG


def test_vgg_f32_logits_match_flax(flax_vgg_vars):
    """f32 eval logits within 1e-4 (measured 5e-8)."""
    params, stats, f, s = flax_vgg_vars
    ref = np.asarray(FlaxVGG(num_scalar_features=36, dtype=jnp.float32)
                     .apply({"params": params, "batch_stats": stats},
                            jnp.asarray(f), jnp.asarray(s), train=False))
    with torch.no_grad():
        got = _port_vgg(params, stats)(torch.from_numpy(f),
                                       torch.from_numpy(s))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_vgg_bf16_logits_match_flax(flax_vgg_vars):
    """Flax bf16 activations vs the port under bf16 autocast (on the CPU
    here; the card autocasts by itself). Measured gap 8.5e-4, about Flax's
    own bf16-vs-f32 gap (6.6e-4): bound 2e-2 as for CNN8. The residual's
    BatchNorm runs in f32, as Flax's dtype=float32 one does."""
    params, stats, f, s = flax_vgg_vars
    ref = np.asarray(FlaxVGG(num_scalar_features=36)
                     .apply({"params": params, "batch_stats": stats},
                            jnp.asarray(f), jnp.asarray(s), train=False))
    model = _port_vgg(params, stats)
    seen = []
    model.res_conv.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    model.res_bn.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(torch.from_numpy(f), torch.from_numpy(s))
    assert seen == [torch.bfloat16, torch.float32]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


def test_vgg_converter_covers_every_tensor(flax_vgg_vars):
    params, stats, _, _ = flax_vgg_vars
    sd = vgg_from_flax(params, stats)
    assert set(sd) == set(VGG(36).state_dict())
    np.testing.assert_array_equal(sd["res_conv.weight"].numpy(),
                                  params["Conv_0"]["kernel"].transpose(
                                      3, 2, 0, 1))
    np.testing.assert_array_equal(sd["convs.11.bn.running_var"].numpy(),
                                  stats["ConvBlock_11"]["BatchNorm_0"]["var"])
    assert "convs.0.conv.bias" not in sd  # bias-free convs


def test_vgg_shapes_ceil_pools_and_stride():
    """Block 1's stride-2 conv and the ceil-mode pools: 128x63 -> 64x32 ->
    32x16 -> 16x8 at block 4."""
    model = registry.build("vgg", 36).eval()
    seen = []
    model.convs[9].register_forward_hook(
        lambda m, i, o: seen.append(tuple(o.shape)))
    with torch.no_grad():
        model(torch.zeros(2, 9, 128, 63), torch.zeros(2, 36))
    assert seen == [(2, 512, 16, 8)]


@pytest.mark.parametrize("shape", [(16, 5), (16, 5, 4, 3)])
def test_batchnorm_trains_as_flax(shape):
    """One training-mode call: output and running statistics as Flax's
    BatchNorm(momentum 0.9, eps 1e-5) gives them, running var from the
    biased batch variance (torch's BatchNorm would store the unbiased one),
    within 1e-6 relative."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    c = shape[1]
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = (rng.random(c) + 0.5).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    xj = np.moveaxis(x, 1, -1)  # Flax normalises the last axis
    y_j, mut = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                                 epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(xj), mutable=["batch_stats"])
    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        y_t = bn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, np.moveaxis(np.asarray(y_j), -1, 1),
                               rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)


def _layout_run(model, f, s, train, bns):
    """A copy of model (in train or eval mode) on f, s: its logits, every
    parameter's gradient of the training loss, the (channels-last,
    NCHW-contiguous) flags of each ConvBlock output and of its gradient,
    and for each module named in bns, a ConvBlock or a BatchNorm, (its
    BatchNorm, the BatchNorm's input in float64, running mean and var
    before the call). A ConvBlock's BatchNorm takes the convolution's
    output with its bias, after the ReLU for "relu_bn"."""
    import copy

    from tpu_breath_torch.train.loop import bce_with_logits

    m = copy.deepcopy(model).train(train)
    layouts, seen = [], []

    def flags(t):
        return (t.is_contiguous(memory_format=torch.channels_last),
                t.is_contiguous())

    def keep(_m, _i, o):
        layouts.append(flags(o))
        o.register_hook(lambda g: layouts.append(flags(g)))

    def bn_input(mod, x):
        if isinstance(mod, BatchNorm):
            return mod, x.detach().double()
        with torch.no_grad():
            t = mod.conv(x.detach())
        return mod.bn, (torch.relu(t) if mod.order == "relu_bn"
                        else t).double()

    def record(mod, i):
        bn, x = bn_input(mod, i[0])
        seen.append((bn, x, bn.running_mean.clone(), bn.running_var.clone()))

    for block in m.convs:
        block.register_forward_hook(keep)
    for name in bns:
        m.get_submodule(name).register_forward_pre_hook(record)
    torch.manual_seed(0)  # the same dropout draws in every run
    logits = m(f, s)
    bce_with_logits(logits, (torch.arange(len(f)) % 2).float()).backward()
    return (logits.detach(), {n: p.grad for n, p in m.named_parameters()},
            layouts, seen)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch", ["cnn8", "vgg"])
def test_body_keeps_channels_last(arch, train):
    """The body as the card runs it, on channels-last features (handed in
    here; Classifier.forward re-lays them out on CUDA only), against the
    NCHW run: every ConvBlock's output and its gradient stay channels-last
    (the NCHW run's stay NCHW: the CPU path is unchanged), so each
    ConvBlock's BatchNorm backward takes kernel F on the card; the f32
    logits agree within 1e-4, each image BatchNorm's running
    statistics are Flax's update from its biased batch statistics (train)
    or untouched (eval), and every parameter's gradient of the training
    loss agrees within 1e-4 with the body in float64 (the head and VGG's
    residual BatchNorm stay f32, as the model pins them). In f32 the two
    layouts round otherwise, which moves a few values across a ReLU's kink
    or a max pool's tie and single gradient elements by up to 2e-2
    (measured, batch 4 at 128 x 63); in float64 the comparison holds the
    layout alone (measured <= 1e-10). Odd sizes reach VGG's ceil-mode
    pools and CNN8's floor ones."""
    g = torch.Generator().manual_seed(5)
    f = torch.randn(4, 9, 40, 21, generator=g)
    s = torch.randn(4, 36, generator=g)
    model = registry.build(arch, 36, seed=1)
    bns = [f"convs.{i}" for i in range(len(model.convs))] + (
        ["res_bn"] if hasattr(model, "res_bn") else [])
    cl = torch.channels_last

    ref, _, ref_layouts, _ = _layout_run(model, f, s, train, [])
    got, _, layouts, seen = _layout_run(
        model, f.contiguous(memory_format=cl), s, train, bns)
    assert len(layouts) == 2 * len(model.convs)
    assert all(c for c, _ in layouts), layouts
    assert all(nchw and not c for c, nchw in ref_layouts), ref_layouts
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    assert len(seen) == len(bns)
    for bn, x, mean0, var0 in seen:
        if not train:
            assert torch.equal(bn.running_mean, mean0)
            assert torch.equal(bn.running_var, var0)
            continue
        mean = 0.9 * mean0.double() + 0.1 * x.mean((0, 2, 3))
        var = 0.9 * var0.double() + 0.1 * x.var((0, 2, 3), unbiased=False)
        np.testing.assert_allclose(bn.running_mean.numpy(), mean.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), var.numpy(),
                                   rtol=1e-5, atol=1e-6)

    model.double()
    for name in ("head", "res_bn"):
        if hasattr(model, name):
            model.get_submodule(name).float()
    f64, s64 = f.double(), s.double()
    _, ref_grads, _, _ = _layout_run(model, f64, s64, train, [])
    _, grads, layouts, _ = _layout_run(
        model, f64.contiguous(memory_format=cl), s64, train, [])
    assert all(c for c, _ in layouts), layouts
    assert set(grads) == set(ref_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
