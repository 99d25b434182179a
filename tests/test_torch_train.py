"""The port's training path (schedule, augmentation, optimizer chain, one
train step, fit) against the JAX package on the CPU, on inputs made with
numpy. Each test states its tolerance."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import flax.linen as flax_nn
from torch import nn

from tpu_breath import augment as jx_augment
from tpu_breath.config import TrainCfg as JxTrainCfg
from tpu_breath.models.cnn8 import CNN8 as FlaxCNN8
from tpu_breath.models.vgg import VGG as FlaxVGG
from tpu_breath.train import loop as jx_loop
from tpu_breath.train.schedule import warmup_cosine as jx_warmup_cosine
from tpu_breath_torch import augment
from tpu_breath_torch.config import TrainCfg
from tpu_breath_torch.models import registry
from tpu_breath_torch.models.convert import FROM_FLAX
from tpu_breath_torch.train import checkpoint as ckpt_lib
from tpu_breath_torch.train import loop
from tpu_breath_torch.train.schedule import warmup_cosine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this module: its fits are many small ops, which
    parallel test workers slow by orders of magnitude when each spreads
    them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("base_lr,total", [(4e-4, 2 * 100), (1e-3, 2 * 140),
                                           (4e-4, 7 * 100), (1e-3, 8)])
def test_schedule_equals_jax_at_every_step(base_lr, total):
    """Every step of a run (and past its end) within one f32 ulp of JAX's
    warmup_cosine: the same f32 operations in the same order; only the
    cosine's own rounding may differ (measured: 2-7 steps of 700 differ by
    one ulp, the rest are equal)."""
    jx = jx_warmup_cosine(base_lr, total)
    ours = warmup_cosine(base_lr, total)
    steps = range(total + 3)
    ref = np.asarray([float(jx(s)) for s in steps], np.float32)
    got = np.asarray([ours(s) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    assert got[-1] == np.float32(1e-6)


# -------------------------------------------------------------- augmentation

def _batch(b=8, h=16, w=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 9, h, w)).astype(np.float32),
            rng.standard_normal((b, 36)).astype(np.float32),
            rng.integers(0, 2, b).astype(np.float32))


@jax.jit
def _jx_draws(key):
    """The draws jax cutmix (alpha 1) and mixup (alpha 0.2) make from a key
    (augment.py:31-39, 55-58), for a batch of 8 clips of 16x12."""
    kperm, klam, kcx, kcy = jax.random.split(key, 4)
    cut = (jax.random.permutation(kperm, 8), jax.random.beta(klam, 1.0, 1.0),
           jax.random.randint(kcx, (), 0, 12),
           jax.random.randint(kcy, (), 0, 16))
    kperm, klam = jax.random.split(key)
    mix = (jax.random.permutation(kperm, 8), jax.random.beta(klam, 0.2, 0.2))
    return cut, mix


def _port_draws(key):
    (cp, cl, cx, cy), (mp, ml) = jax.tree.map(np.array, _jx_draws(key))
    t = torch.from_numpy
    return (augment.CutMixDraw(t(cp).long(), t(cl), t(cx).long(),
                               t(cy).long()),
            augment.MixUpDraw(t(mp).long(), t(ml)))


def _eq(port: augment.Batch, ref: jx_augment.Batch, exact: bool = True):
    for got, want in zip(port, ref):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_cutmix_given_the_same_draws_equals_jax(seed):
    """Exact: the same box, the same lambda from the integer box, scalars
    untouched."""
    f, s, y = _batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = jx_augment.cutmix(key, jx_augment.Batch(*map(jnp.asarray,
                                                        (f, s, y))), 1.0)
    got = augment.cutmix(augment.Batch(*map(torch.from_numpy, (f, s, y))),
                         _port_draws(key)[0])
    _eq(got, ref)
    np.testing.assert_array_equal(got.scalars.numpy(), s)


@pytest.mark.parametrize("seed", range(4))
def test_mixup_given_the_same_draws_equals_jax(seed):
    """Features, scalars and labels mixed with one lambda: within 1e-6 abs
    and rel (XLA may fuse lam*a + (1-lam)*b differently; measured <= 4
    ulps)."""
    f, s, y = _batch(seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    ref = jx_augment.mixup(key, jx_augment.Batch(*map(jnp.asarray,
                                                       (f, s, y))), 0.2)
    got = augment.mixup(augment.Batch(*map(torch.from_numpy, (f, s, y))),
                        _port_draws(key)[1])
    _eq(got, ref, exact=False)


@pytest.mark.parametrize("probs", [(0.6, 0.4), (0.3, 0.3)])
def test_branch_given_the_same_draws_equals_jax(probs):
    """apply_augmentation picks CutMix / MixUp / nothing from r as
    lax.switch does (within 1e-6, for the MixUp branch), over 16 keys that
    take every branch open at these probabilities."""
    cp, mp = probs
    f, s, y = _batch()
    jb = jx_augment.Batch(*map(jnp.asarray, (f, s, y)))
    tb = augment.Batch(*map(torch.from_numpy, (f, s, y)))
    jx_apply = jax.jit(lambda k: jx_augment.apply_augmentation(
        k, jb, jnp.asarray(True), cp, mp, 1.0, 0.2))
    seen = set()
    for k in range(16):
        key = jax.random.PRNGKey(k)
        kr, kaug = jax.random.split(key)
        r = float(jax.random.uniform(kr, ()))
        draws = augment.AugDraw(torch.tensor(r), *_port_draws(kaug))
        _eq(augment.apply_augmentation(tb, draws, cp, mp), jx_apply(key),
            exact=False)
        seen.add(0 if r < cp else 1 if r < cp + mp else 2)
    assert seen == ({0, 1} if cp + mp >= 1 else {0, 1, 2})


def test_draws_are_valid_and_beta_distributed():
    """The port's own draws: permutations, boxes in range, and Johnk's
    Beta(0.2, 0.2) with the right mean 0.5 and variance 1/5.6 (2,000 draws:
    bounds at ~4 standard errors)."""
    g = torch.Generator().manual_seed(0)
    d = augment.draw(g, 8, 16, 12, 1.0, 0.2, "cpu")
    assert sorted(d.cutmix.perm.tolist()) == list(range(8))
    assert 0 <= int(d.cutmix.cx) < 12 and 0 <= int(d.cutmix.cy) < 16
    lam = np.array([float(augment.beta_symmetric(g, 0.2, "cpu"))
                    for _ in range(2000)])
    assert lam.min() >= 0 and lam.max() <= 1
    assert abs(lam.mean() - 0.5) < 0.04
    assert abs(lam.var() - 1 / 5.6) < 0.02


# ------------------------------------------------------------------ optimizer

def test_bce_matches_jax():
    rng = np.random.default_rng(5)
    z = (rng.standard_normal(64) * 6).astype(np.float32)
    y = rng.random(64).astype(np.float32)
    ref = float(jx_loop.bce_with_logits(jnp.asarray(z), jnp.asarray(y)))
    got = float(loop.bce_with_logits(torch.from_numpy(z), torch.from_numpy(y)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_clip_is_optax_rule():
    """Below the bound the gradients are untouched (bitwise); above it they
    equal optax's (g / norm) * max_norm within 1e-6 relative (the norm's
    sum runs in another order; measured 2 ulps)."""
    rng = np.random.default_rng(6)
    small = [rng.standard_normal(5).astype(np.float32) * 0.1,
             rng.standard_normal((3, 2)).astype(np.float32) * 0.1]
    big = [g * 40 for g in small]
    clip = optax.clip_by_global_norm(1.0)
    for gs in (small, big):
        ref, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(None))
        got = [torch.from_numpy(g.copy()) for g in gs]
        loop.clip_by_global_norm_(got, 1.0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
    got = [torch.from_numpy(g.copy()) for g in small]
    loop.clip_by_global_norm_(got, 1.0)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got, small))


def test_optimizer_chain_matches_optax_over_five_steps():
    """clip 1.0 -> AdamW(0.9, 0.999, 1e-8, wd 1e-4) at warmup_cosine rates,
    each handed to the step as a 0-d f32 tensor, fed the same five
    gradients (norms 0.3 to 30, so some are clipped): parameters within
    1e-6 of optax's after every step, relative to each tensor's largest
    |value| (f32 on both sides; XLA may fuse the moments' products
    otherwise), and the step count on the parameters' device."""
    rng = np.random.default_rng(7)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    p0 = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.standard_normal(sh) * scale).astype(np.float32)
              for sh in shapes] for scale in (0.1, 3.0, 0.05, 10.0, 1.0)]
    cfg = TrainCfg(base_lr=1e-3, weight_decay=1e-4)
    total = 20
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jx_warmup_cosine(1e-3, total), b1=0.9,
                                 b2=0.999, eps=1e-8, weight_decay=1e-4))
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)

    holder = nn.Module()
    holder.ps = nn.ParameterList([nn.Parameter(torch.from_numpy(p.copy()))
                                  for p in p0])
    opt = loop.make_optimizer(holder, cfg)
    schedule = warmup_cosine(1e-3, total)
    for step, gs in enumerate(grads):
        updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                   params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(holder.ps, gs):
            p.grad = torch.from_numpy(g.copy())
        loop.clip_by_global_norm_([p.grad for p in holder.ps], 1.0)
        opt.step(torch.tensor(schedule(step), dtype=torch.float32))
        for a, b in zip(holder.ps, params):
            b = np.asarray(b)
            err = np.abs(a.detach().numpy() - b).max()
            assert err <= 1e-6 * np.abs(b).max(), (step, err)
        assert all(int(opt.state[p]["step"]) == step + 1 for p in holder.ps)


# ------------------------------------------------------------ one train step

def _flax_model(arch):
    return {"cnn8": FlaxCNN8(num_scalar_features=36, dropout_rate=0.0,
                             dtype=jnp.float32),
            "vgg": FlaxVGG(num_scalar_features=36, dropout_rate=0.0,
                           dtype=jnp.float32)}[arch]


@pytest.mark.parametrize("arch", ["cnn8", "vgg"])
def test_one_train_step_matches_flax(arch):
    """Converted weights, f32, dropout 0, augmentation drawn and gated off,
    training mode on 8 clips of 9x32x16, through fit's step program
    (loop.TrainStep at rate 0, the clip's bound infinite, so the gradients
    stay as the backward left them): the loss within 1e-5 relative
    (measured 1.2e-6);
    every gradient within 2e-4 of its tensor's largest |gradient| (sums over
    the batch and the image run in other orders), or within 1e-6 where it is
    zero up to rounding (a bias ahead of a batch norm, e.g. VGG's
    res_bn.bias: |grad| ~3e-8 on both sides); the BN running statistics
    after the step (momentum 0.9, biased variance) within 1e-5 relative."""
    rng = np.random.default_rng(8)
    f = rng.standard_normal((8, 9, 32, 16)).astype(np.float32)
    s = rng.standard_normal((8, 36)).astype(np.float32)
    y = rng.integers(0, 2, 8).astype(np.float32)
    fm = _flax_model(arch)
    v = jax.jit(lambda a, b: fm.init({"params": jax.random.PRNGKey(3)}, a, b,
                                     train=False))(jnp.asarray(f),
                                                   jnp.asarray(s))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.random(x.shape).astype(np.float32),
        v["batch_stats"])

    def loss_fn(p):
        out, mut = fm.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(f), jnp.asarray(s), train=True,
                            mutable=["batch_stats"])
        return jx_loop.bce_with_logits(out, jnp.asarray(y)), mut

    (loss_j, mut), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)
                                 )(params)
    ref = FROM_FLAX[arch](jax.tree.map(np.asarray, g_j),
                          jax.tree.map(np.asarray, mut["batch_stats"]))

    model = registry.build(arch, 36, dropout_rate=0.0)
    model.load_state_dict(FROM_FLAX[arch](params, stats))
    cfg = TrainCfg(batch_size=8, grad_clip_norm=float("inf"))
    step = loop.TrainStep(model, loop.make_optimizer(model, cfg),
                          tuple(map(torch.from_numpy, (f, s, y))), cfg,
                          torch.Generator().manual_seed(0))
    loss_t, _ = step(torch.arange(8), torch.tensor(0.0), torch.tensor(False))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= max(2e-4 * np.abs(want).max(), 1e-6), (name, err)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


# ------------------------------------------------------------------------ fit

def _indexed_data(n=20):
    """Features that carry their row index at [i, 0, 0, 0]."""
    rng = np.random.default_rng(9)
    f = rng.standard_normal((n, 9, 4, 4)).astype(np.float32)
    f[:, 0, 0, 0] = np.arange(n)
    s = rng.standard_normal((n, 36)).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.float32)
    return f, s, y


class _TinyFlax(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, f, s, train=False):
        x = jnp.concatenate([f.mean(axis=(2, 3)), s], axis=-1)
        x = flax_nn.BatchNorm(use_running_average=not train)(x)
        return flax_nn.Dense(1)(x)[:, 0]


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(9 + 36, 1)

    def forward(self, f, s):
        return self.dense(torch.cat([f.mean(dim=(2, 3)), s], -1))[:, 0]


def test_batch_order_equals_jax_fit(monkeypatch):
    """The rows of every step of 3 epochs (20 clips, batch 6, drop last)
    equal those JAX fit gathers."""
    f, s, y = _indexed_data()
    jx_rows, port_rows = [], []
    make = jx_loop.make_train_step

    def spy_make(*a, **k):
        step = make(*a, **k)

        def spy(state, feats, scals, labels, idx, key, use_aug):
            jx_rows.append(np.asarray(idx).tolist())
            return step(state, feats, scals, labels, idx, key, use_aug)
        return spy

    monkeypatch.setattr(jx_loop, "make_train_step", spy_make)
    jx_cfg = JxTrainCfg(num_epochs=3, batch_size=6, eval_batch_size=20,
                        patience=99, seed=4)
    jx_loop.fit(_TinyFlax(), (f, s), (f, s), y, y, jx_cfg,
                log_fn=lambda *_: None)

    step = loop.train_step

    def spy_step(model, optimizer, lr, batch, cfg, draws=None):
        port_rows.append(batch.features[:, 0, 0, 0].long().tolist())
        return step(model, optimizer, lr, batch, cfg, draws)

    monkeypatch.setattr(loop, "train_step", spy_step)
    cfg = TrainCfg(num_epochs=3, batch_size=6, eval_batch_size=20,
                   patience=99, seed=4)
    loop.fit(_Tiny(), (f, s), (f, s), y, y, cfg, log_fn=lambda *_: None,
             device="cpu")
    assert len(port_rows) == 9 and port_rows == jx_rows


@pytest.fixture(scope="module")
def toy_data():
    """32 separable clips of 9x16x16: the class shifts the features and
    scalar 0."""
    rng = np.random.default_rng(42)
    labels = (np.arange(32) % 2).astype(np.float32)
    feats = rng.standard_normal((32, 9, 16, 16)).astype(np.float32) * 0.1
    feats += labels[:, None, None, None] * 2.0
    scals = rng.standard_normal((32, 36)).astype(np.float32)
    scals[:, 0] = labels * 3.0
    return feats, scals, labels


def _fit(data, cfg, save_dir=None, resume=False, log_fn=lambda *_: None):
    f, s, y = data
    model = registry.build("cnn8", 36, seed=cfg.seed)
    return loop.fit(model, (f, s), (f, s), y, y, cfg, save_dir=save_dir,
                    resume=resume, log_fn=log_fn, device="cpu")


def test_smoke_train_learns_and_checkpoints(toy_data, tmp_path):
    cfg = TrainCfg(num_epochs=6, base_lr=1e-3, batch_size=8,
                   eval_batch_size=16, warmup_epochs=99, patience=99)
    res = _fit(toy_data, cfg, save_dir=str(tmp_path))
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
    assert res.best_val_acc > 0.6
    assert set(res.history[0]) == {
        "epoch", "train_loss", "train_acc", "val_loss", "val_acc", "val_auc",
        "val_f1", "val_precision", "val_recall", "lr", "sec"}
    restored = ckpt_lib.restore(res.best_ckpt_path,
                                registry.build("cnn8", 36))
    f = torch.from_numpy(toy_data[0])
    s = torch.from_numpy(toy_data[1])
    with torch.no_grad():
        assert torch.equal(restored.eval()(f, s), res.model.eval()(f, s))


def test_early_stopping_stops(toy_data):
    """At rate 0 only the BN statistics move, improvements dry up and
    patience 2 cuts the run well short of its 50 epochs."""
    cfg = TrainCfg(num_epochs=50, base_lr=0.0, lr_eta_min=0.0, batch_size=8,
                   eval_batch_size=16, warmup_epochs=99, patience=2)
    logs = []
    res = _fit(toy_data, cfg, log_fn=logs.append)
    n = len(res.history)
    assert 3 <= n < cfg.num_epochs
    assert logs[-1].startswith(f"early stopping at epoch {n}")


def test_resume_matches_uninterrupted(toy_data, tmp_path):
    """Kill a run after its 6th epoch line; the resumed run's history
    equals the uninterrupted run's, epoch for epoch and bit for bit
    (augmentation from epoch 3 and dropout 0.3 included)."""
    cfg = TrainCfg(num_epochs=10, base_lr=1e-3, batch_size=8,
                   eval_batch_size=16, warmup_epochs=2, patience=99, seed=3)
    full = _fit(toy_data, cfg, save_dir=str(tmp_path / "full"))

    class Killed(Exception):
        pass

    seen = [0]

    def crash_after_6(msg):
        seen[0] += 1
        if seen[0] >= 6:
            raise Killed

    with pytest.raises(Killed):
        _fit(toy_data, cfg, save_dir=str(tmp_path / "part"),
             log_fn=crash_after_6)
    resumed = _fit(toy_data, cfg, save_dir=str(tmp_path / "part"),
                   resume=True)
    by_epoch = {r["epoch"]: r for r in full.history}
    assert resumed.history and resumed.history[0]["epoch"] > 1
    for row in resumed.history:
        ref = by_epoch[row["epoch"]]
        for k in ("train_loss", "train_acc", "val_loss", "val_acc", "lr"):
            assert row[k] == ref[k], (row["epoch"], k, row[k], ref[k])
    assert resumed.best_val_acc == full.best_val_acc


def test_resume_skips_an_interrupted_checkpoint(toy_data, tmp_path):
    """A newer directory without meta.json is a save that died: resume
    takes the newest complete checkpoint, with its optimizer state."""
    cfg = TrainCfg(num_epochs=3, base_lr=1e-3, batch_size=8,
                   eval_batch_size=16, warmup_epochs=99, patience=99)
    res = _fit(toy_data, cfg, save_dir=str(tmp_path))
    good = ckpt_lib.latest_checkpoint(str(tmp_path))
    (tmp_path / "best_epoch009").mkdir()
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == good
    model = registry.build("cnn8", 36)
    opt = loop.make_optimizer(model, cfg)
    step, epoch = ckpt_lib.restore_train_state(good, model, opt)
    assert epoch == int(good[-3:]) and step == epoch * 4
    assert all(int(opt.state[p]["step"]) == step
               for p in model.parameters())
    logs = []
    cfg5 = TrainCfg(**{**cfg.__dict__, "num_epochs": 5})
    again = _fit(toy_data, cfg5, save_dir=str(tmp_path), resume=True,
                 log_fn=logs.append)
    assert logs[0].startswith(f"resumed from epoch {epoch}")
    assert [r["epoch"] for r in again.history] == list(range(epoch + 1, 6))
    assert res.best_ckpt_path == good


def test_fit_on_cuda_without_card_raises(toy_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, s, y = toy_data
    with pytest.raises(RuntimeError):
        loop.fit(registry.build("cnn8", 36), (f, s), (f, s), y, y,
                 TrainCfg(batch_size=8))


# ----------------------------------------------------------- reproducibility

def _seeded_history(seed):
    """tests/test_reproducibility.py's run on the port: 32 clips of 9x16x8,
    CNN8, 3 epochs at batch 16, augmentation from epoch 2, on the CPU; the
    history without its wall times."""
    rng = np.random.default_rng(7)
    n = 32
    feats = rng.standard_normal((n, 9, 16, 8)).astype(np.float32)
    scals = rng.standard_normal((n, 36)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.float32)
    cfg = TrainCfg(num_epochs=3, base_lr=1e-3, batch_size=16,
                   eval_batch_size=16, warmup_epochs=1, patience=99,
                   seed=seed)
    res = loop.fit(registry.build("cnn8", 36, seed=seed), (feats, scals),
                   (feats, scals), labels, labels, cfg, log_fn=lambda *_: None,
                   device="cpu")
    return [{k: v for k, v in r.items() if k != "sec"} for r in res.history]


def test_same_seed_identical_history():
    """Two fits with one seed: equal histories, every key bit for bit."""
    assert _seeded_history(5) == _seeded_history(5)


def test_different_seed_different_history():
    assert _seeded_history(5) != _seeded_history(6)


def test_fit_runs_inside_the_reproducible_scope(toy_data, monkeypatch):
    """Every step of fit sees cuDNN deterministic and not benchmarking; the
    caller's flags come back after fit returns and after it raises."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    caller = (torch.backends.cudnn.deterministic, True)
    seen, step = [], loop.train_step

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return step(*a, **k)

    monkeypatch.setattr(loop, "train_step", spy)
    cfg = TrainCfg(num_epochs=2, batch_size=8, eval_batch_size=16,
                   warmup_epochs=1, patience=99)
    _fit(toy_data, cfg)
    assert seen == [(True, False)] * 8
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == caller

    def stop(msg):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _fit(toy_data, cfg, log_fn=stop)
    assert seen[8:] == [(True, False)] * 4
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == caller
