"""The port's streaming loader (tpu_breath_torch/data/loader.py) against
the JAX package's (tpu_breath/data/loader.py): the same shards, the same
batch schedule, and a prefetcher that keeps order and depth."""
import numpy as np
import pytest
import torch

from tpu_breath.data import loader as jx_loader
from tpu_breath_torch.data import loader

# (n, world, local batch, seed, epoch); 47 rows over 2 ranks at local batch
# 4 is tests/test_multiprocess.py's uneven split: shards of 24 and 23 rows,
# 5 steps from the smaller
CASES = [(47, 2, 4, 0, 0), (47, 2, 4, 0, 1), (59, 4, 3, 7, 2),
         (16, 2, 8, 1, 0), (10, 3, 2, 5, 3), (5, 4, 1, 2, 0)]


@pytest.mark.parametrize("n, world, lb, seed, epoch", CASES)
def test_shards_and_schedule_equal_the_jax_package(n, world, lb, seed,
                                                   epoch):
    per = -(-n // world)
    steps = (n - (world - 1) * per) // lb  # the smallest shard's
    for rank in range(world):
        shard = loader.host_shard(n, rank, world)
        assert shard == jx_loader.host_shard(n, rank, world)
        idx = np.arange(n)[shard]
        if steps < 1:
            continue
        mine = [b.numpy() for (b,) in loader.stream_batches(
            (idx,), lb, np.random.default_rng([seed + 1, epoch]),
            max_batches=steps)]
        ref = [np.asarray(b) for (b,) in jx_loader.stream_batches(
            (idx,), lb, np.random.default_rng([seed + 1, epoch]),
            max_batches=steps)]
        assert len(mine) == len(ref) == steps
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
        plain = list(loader.batch_indices(
            len(idx), lb, np.random.default_rng([seed + 1, epoch]),
            max_batches=steps))
        for a, b in zip(plain, mine):
            np.testing.assert_array_equal(idx[a], b)


def test_uneven_split_has_five_steps():
    assert [len(range(47)[loader.host_shard(47, r, 2)]) for r in (0, 1)] \
        == [24, 23]
    rng = np.random.default_rng(0)
    assert len(list(loader.batch_indices(24, 4, rng, max_batches=23 // 4))) \
        == 5


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_keeps_order_and_depth(depth):
    """Batch i is handed over in order, once depth batches past it have
    been pulled from the source (fewer at the end), as the JAX package's
    Prefetcher does."""
    def run(prefetcher_cls, **kw):
        pulled = []

        def source():
            for i in range(7):
                pulled.append(i)
                yield (np.full(3, i, np.float32),)

        seen = []
        for (x,) in prefetcher_cls(source(), depth=depth, **kw):
            seen.append((int(np.asarray(x)[0]), len(pulled)))
        return seen

    mine = run(loader.Prefetcher, device="cpu")
    assert mine == [(i, min(i + 1 + depth, 7)) for i in range(7)]
    assert mine == run(jx_loader.Prefetcher)


def test_prefetcher_hands_over_tensors_on_the_device():
    batches = [(np.arange(4, dtype=np.float32), np.ones(2, np.float32))] * 3
    out = list(loader.Prefetcher(iter(batches), depth=2, device="cpu"))
    assert len(out) == 3
    for x, y in out:
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.arange(4.0)) and torch.equal(
            y, torch.ones(2))
