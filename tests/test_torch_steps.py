"""The port's compiled train and eval steps on the CPU: loop.TrainStep (the
JAX package's make_train_step as one program: its rate and its
augmentation gate read from tensors) and loop.Predictor (make_eval_step
with evaluate's padded tail), against optax and the JAX package's evaluate
and predict_probs; the restore into the live tensors a captured graph
reads. On the CPU both programs run eagerly and capture nothing; the
graphs run on the card (tests/test_torch_cuda.py, marker `cuda`). Inputs
are made with numpy from seeds; each test states its tolerance."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from tpu_breath import ensemble as jx_ensemble
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.train import loop as jx_loop
from tpu_breath_torch import augment, ensemble
from tpu_breath_torch.config import TrainCfg
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train import loop


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: many small ops, which parallel test workers slow
    by orders of magnitude when each spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n: int, h: int = 4, w: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 9, h, w)).astype(np.float32),
            rng.standard_normal((n, 36)).astype(np.float32),
            (np.arange(n) % 2).astype(np.float32))


class _Linear(nn.Module):
    """Logits of the features' channel means and the scalars; each
    forward's batch size is kept in `sizes`."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(9 + 36, 1)
        self.sizes: list[int] = []

    def forward(self, f, s):
        self.sizes.append(f.shape[0])
        return self.dense(torch.cat([f.mean(dim=(2, 3)), s], -1))[:, 0]


def test_step_program_reads_its_rate_and_gate_from_tensors(monkeypatch):
    """Two calls of one TrainStep with its rate and use_aug tensors changed
    in place between them (1e-3 gated off, then 5e-4 gated on, MixUp
    always): the gated-off call drew (the generator moved) and handed the
    model the batch as it was, bit for bit; the gated-on call mixed it; the
    parameters after both equal optax's clip -> adamw at those rates, fed
    the same gradients, within 1e-6 of each tensor's largest |value| (the
    bound of test_optimizer_chain_matches_optax_over_five_steps)."""
    cfg = TrainCfg(batch_size=8, cutmix_prob=0.0, mixup_prob=1.0,
                   grad_clip_norm=0.05, weight_decay=1e-4)
    data = tuple(map(torch.from_numpy, _data(8)))
    torch.manual_seed(0)
    model = _Linear()
    p0 = [p.detach().numpy().copy() for p in model.parameters()]
    gen = torch.Generator().manual_seed(3)
    step = loop.TrainStep(model, loop.make_optimizer(model, cfg), data, cfg,
                          gen)
    seen, grads = [], []
    apply, clip = augment.apply_augmentation, loop.clip_by_global_norm_

    def spy_apply(batch, *a, **k):
        out = apply(batch, *a, **k)
        seen.append((batch, out))
        return out

    def spy_clip(gs, max_norm):
        grads.append([g.detach().numpy().copy() for g in gs])
        return clip(gs, max_norm)

    monkeypatch.setattr(augment, "apply_augmentation", spy_apply)
    monkeypatch.setattr(loop, "clip_by_global_norm_", spy_clip)
    rows = torch.arange(8)
    lr, on = torch.tensor(1e-3), torch.tensor(False)
    state = gen.get_state()
    step(rows, lr, on)
    assert not torch.equal(gen.get_state(), state)
    batch, out = seen[0]
    assert all(torch.equal(o, b) for o, b in zip(out, batch))
    lr.fill_(5e-4)
    on.fill_(True)
    step(rows, lr, on)
    batch, out = seen[1]
    assert not torch.equal(out.features, batch.features)

    rates = np.float32([1e-3, 5e-4])
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                     optax.adamw(lambda c: jnp.asarray(rates)[c], b1=0.9,
                                 b2=0.999, eps=1e-8,
                                 weight_decay=cfg.weight_decay))
    params = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(params)
    for gs in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
    for a, b in zip(model.parameters(), params):
        b = np.asarray(b)
        err = np.abs(a.detach().numpy() - b).max()
        assert err <= 1e-6 * np.abs(b).max(), err


def test_step_and_eval_on_cpu_capture_nothing_and_pad_the_tail():
    """On the CPU the step program and the eval program run eagerly and
    keep no graph; the Predictor takes 10 rows in batches of 4, the tail
    padded with its last row ([8, 9, 9, 9]) and the padding dropped: its
    logits equal the model's on all 10 rows at once within 1e-6 (one
    product's blocking moves with the batch)."""
    f, s, y = map(torch.from_numpy, _data(10))
    cfg = TrainCfg(batch_size=4)
    model = _Linear()
    step = loop.TrainStep(model, loop.make_optimizer(model, cfg), (f, s, y),
                          cfg, torch.Generator().manual_seed(0))
    for _ in range(2):
        step(torch.arange(4), torch.tensor(1e-3), torch.tensor(True))
    assert step.graphs == {}
    predict = loop.Predictor(model, f, s, 4)
    model.sizes.clear()
    logits = predict()
    assert predict.graphs == {} and model.sizes == [4, 4, 4]
    assert logits.shape == (10,) and not model.training
    with torch.no_grad():
        ref = model(f, s)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-6,
                               rtol=0)
    tail = loop.Predictor(model, f[[8, 9, 9, 9]], s[[8, 9, 9, 9]], 4)()
    np.testing.assert_array_equal(logits[8:].numpy(), tail[:2].numpy())


@pytest.fixture(scope="module")
def converted():
    """An f32 CNN8 of the JAX package (init from PRNGKey 4, its BN
    statistics moved off 0 / 1) and the same weights in the port; 10
    clips of 9x32x16."""
    rng = np.random.default_rng(11)
    f = rng.standard_normal((10, 9, 32, 16)).astype(np.float32)
    s = rng.standard_normal((10, 36)).astype(np.float32)
    y = (np.arange(10) % 2).astype(np.float32)
    fm = FlaxCNN8(num_scalar_features=36, dropout_rate=0.0,
                  dtype=jnp.float32)
    v = jax.jit(lambda a, b: fm.init({"params": jax.random.PRNGKey(4)}, a,
                                     b, train=False))(jnp.asarray(f),
                                                      jnp.asarray(s))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.random(x.shape).astype(np.float32),
        v["batch_stats"])
    state = jx_loop.TrainState(params=params, batch_stats=stats,
                               opt_state=None, step=0)
    model = registry.build("cnn8", 36, dropout_rate=0.0)
    model.load_state_dict(FROM_FLAX["cnn8"](params, stats))
    return {"f": f, "s": s, "y": y, "fm": fm, "state": state,
            "model": model}


@pytest.mark.parametrize("drop_last", [False, True])
def test_evaluate_pads_the_tail_as_jax(converted, drop_last):
    """10 rows in batches of 4 (a padded tail of 2; or drop_last, 8 rows)
    through the port's evaluate and the JAX package's: every metric within
    1e-4 abs, and the probability range within 2.5e-5 (the f32 logits'
    bound of tests/test_torch_models.py, 1e-4, through the sigmoid;
    measured: 6e-8 on prob_max, 0 elsewhere)."""
    c = converted
    ref = jx_loop.evaluate(jx_loop.make_eval_step(c["fm"]), c["state"],
                           jnp.asarray(c["f"]), jnp.asarray(c["s"]), c["y"],
                           4, drop_last=drop_last)
    got = loop.evaluate(loop.Predictor(c["model"], torch.from_numpy(c["f"]),
                                       torch.from_numpy(c["s"]), 4),
                        c["y"], drop_last=drop_last)
    assert set(got) == set(ref)
    for k in ref:
        tol = 2.5e-5 if k.startswith("prob") else 1e-4
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def test_predict_probs_pads_the_tail_as_jax(converted):
    """ensemble.predict_probs, 10 rows in batches of 4, against the JAX
    package's: within 2.5e-5 (the f32 logits' 1e-4 through the sigmoid;
    measured 9e-8)."""
    c = converted
    ref = jx_ensemble.predict_probs(c["fm"], c["state"], c["f"], c["s"],
                                    batch_size=4)
    got = ensemble.predict_probs(c["model"], c["f"], c["s"], batch_size=4,
                                 device="cpu")
    assert got.shape == (10,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2.5e-5, rtol=0)


def test_restore_writes_into_the_live_tensors(tmp_path):
    """restore_train_state into a model and optimizer leaves every
    parameter, buffer and optimizer state tensor where it was (a captured
    graph reads them there) and gives them the checkpoint's values, the
    step count included."""
    f, s, y = _data(16, 16, 8, seed=2)
    cfg = TrainCfg(num_epochs=1, batch_size=8, eval_batch_size=8,
                   patience=9)
    loop.fit(registry.build("cnn8", 36, seed=1), (f, s), (f, s), y, y, cfg,
             save_dir=str(tmp_path), log_fn=lambda *_: None, device="cpu")
    path = ckpt_lib.latest_checkpoint(str(tmp_path))
    model = registry.build("cnn8", 36, seed=2)
    opt = loop.make_optimizer(model, cfg)
    live = [*model.state_dict().values(),
            *(t for st in opt.state.values() for t in st.values())]
    ptrs = [t.data_ptr() for t in live]
    step, epoch = ckpt_lib.restore_train_state(path, model, opt)
    assert (step, epoch) == (2, 1)
    now = [*model.state_dict().values(),
           *(t for st in opt.state.values() for t in st.values())]
    assert [t.data_ptr() for t in now] == ptrs
    saved = torch.load(f"{path}/{ckpt_lib.MODEL_FILE}", weights_only=True)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in saved.items())
    opt_saved = torch.load(f"{path}/{ckpt_lib.STATE_FILE}",
                           weights_only=True)["optimizer"]["state"]
    for i, p in enumerate(model.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt_saved[i][k])
    assert int(opt.count) == 2
