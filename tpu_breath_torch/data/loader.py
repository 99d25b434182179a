"""Streaming host -> device input (counterpart of
tpu_breath/data/loader.py), the input of training under a mesh:

- batch_indices(): the epoch's shuffled, drop-last batches of indices, at
  most max_batches of them (every rank must run the same number of steps,
  the collectives' count);
- host_shard(): the contiguous ceil split of the examples that a rank
  holds;
- Prefetcher: batches copied from pinned host memory `depth` ahead on a
  side stream; the consumer's stream waits on an event, not the host;
- stream_batches(): the three together over parallel host arrays.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch


def batch_indices(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_last: bool = True,
                  max_batches: int | None = None) -> Iterator[np.ndarray]:
    """rng.permutation(n) (or arange) cut into batches of batch_size; the
    last partial batch dropped when drop_last; at most max_batches."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    if max_batches is not None:
        end = min(end, max_batches * batch_size)
    for lo in range(0, end, batch_size):
        yield order[lo: lo + batch_size]


def host_shard(n: int, rank: int, world: int) -> slice:
    """The contiguous [start, stop) of n examples that rank holds: ceil
    split, the last rank's shard the smallest (possibly empty)."""
    per = -(-n // world)
    return slice(rank * per, min((rank + 1) * per, n))


class Prefetcher:
    """Iterate over tuples of host numpy arrays as tuples of tensors on
    `device`, `depth` batches ahead of the consumer. On a CUDA device each
    batch is copied from pinned memory on a side stream (non_blocking) and
    an event marks its end; the consumer's current stream waits on that
    event when the batch is handed over, so neither side waits on the host.
    Elsewhere the arrays are wrapped as they are."""

    def __init__(self, it: Iterable, depth: int = 2, device="cpu"):
        self._it = iter(it)
        self._depth = max(depth, 1)
        self._device = torch.device(device)

    def __iter__(self):
        cuda = self._device.type == "cuda"
        side = torch.cuda.Stream(self._device) if cuda else None

        def put(batch):
            if not cuda:
                return tuple(torch.from_numpy(a) for a in batch), None
            with torch.cuda.stream(side):
                out = tuple(torch.from_numpy(a).pin_memory().to(
                    self._device, non_blocking=True) for a in batch)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        queue = collections.deque()
        for batch in self._it:
            queue.append(put(batch))
            if len(queue) == self._depth:
                break
        while queue:
            out, done = queue.popleft()
            nxt = next(self._it, None)
            if nxt is not None:
                queue.append(put(nxt))
            if done is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(done)
                for t in out:  # freed only after the consumer's use
                    t.record_stream(stream)
            yield out


def stream_batches(arrays: Sequence[np.ndarray], batch_size: int,
                   rng: np.random.Generator, depth: int = 2, device="cpu",
                   shuffle: bool = True, drop_last: bool = True,
                   max_batches: int | None = None) -> Prefetcher:
    """Shuffled, prefetched batches of parallel host arrays (features,
    scalars, labels of one rank's shard), as tensors on device."""
    n = len(arrays[0])

    def gen():
        for idx in batch_indices(n, batch_size, rng, shuffle, drop_last,
                                 max_batches):
            yield tuple(np.ascontiguousarray(a[idx]) for a in arrays)

    return Prefetcher(gen(), depth=depth, device=device)
