"""Input pipeline: host batching + device prefetch.  Port of
kubeshare_tpu/data/pipeline.py.

- the host assembles numpy batches (:class:`ShardedBatchLoader`, in
  exactly the JAX loader's order: the same permutation, the same rows for
  every process, the same dropped tail);
- :func:`prefetch_to_device` keeps ``size`` batches in flight to the
  device.  On a CUDA card each batch is copied from pinned host memory
  on a side stream, so the copy overlaps the step that runs on the
  consumer's stream (``jax.device_put``'s asynchronous transfer);
- under a dp mesh, batches are placed by the port's ``batch_sharding``
  and come out as ``ShardedTensor``s the sharded step consumes as they
  are;
- multi-process: each process loads only its slice of every global
  batch; ``process_count`` / ``process_index`` default to
  ``torch.distributed``'s world size and rank when it is initialised.

Sources are trees (dicts, lists, tuples) of numpy arrays.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Any, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import NamedSharding, _as_device, device_put
from ..parallel.train import tree_map


def _tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves``' order: a dict's values
    by sorted key, lists and tuples in order; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                _tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _tree_leaves(item)]
    return [tree]


def _as_tensor(leaf: Any) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.asarray(leaf))


def _place(x: torch.Tensor, target, non_blocking: bool):
    if isinstance(target, NamedSharding):
        return device_put(x, target, non_blocking=non_blocking)
    return x.to(target, non_blocking=non_blocking)


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    sharding: Optional[Any] = None,
) -> Iterator[Any]:
    """Yield the items of ``iterator`` (trees of numpy arrays or tensors)
    as trees of tensors on the device, with ``size`` of them already
    placed.  ``sharding`` is a device (None: the current CUDA device, as
    every entry point) or a ``NamedSharding`` such as
    ``batch_sharding(mesh, ndim)``, which places every leaf as a
    ``ShardedTensor``.

    On CUDA each item is copied into pinned host memory, then to the
    device with ``non_blocking=True`` on a side stream, so keeping
    ``size`` >= 2 overlaps the next batch's copy with the current step.
    The consumer's stream waits for an item's copy when the item is
    yielded, and every device tensor is recorded on that stream
    (``record_stream``), so the caching allocator does not hand its
    memory to a later copy while the step still reads it; each pinned
    buffer is held until its copy has completed.  On the CPU it is the
    same look-ahead with no streams."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if isinstance(sharding, NamedSharding):
        target = sharding
        devices = list(dict.fromkeys(_as_device(d)
                                     for d in sharding.mesh.local_devices))
    else:
        target = _as_device(resolve_device(sharding))
        devices = [target]
    it = iter(iterator)
    if not all(d.type == "cuda" for d in devices):
        queue: collections.deque = collections.deque()

        def place(item):
            return tree_map(lambda a: _place(_as_tensor(a), target, False),
                             item)

        queue.extend(place(item) for item in itertools.islice(it, size))
        while queue:
            yield queue.popleft()
            queue.extend(place(item) for item in itertools.islice(it, 1))
        return
    yield from _prefetch_cuda(it, size, target, devices)


def _prefetch_cuda(it: Iterator[Any], size: int, target,
                   devices: List[torch.device]) -> Iterator[Any]:
    side = {d: torch.cuda.Stream(d) for d in devices}
    queue: collections.deque = collections.deque()
    copying: collections.deque = collections.deque()  # (events, pinned)

    def enqueue(n: int) -> None:
        for item in itertools.islice(it, n):
            pinned = tree_map(lambda a: _as_tensor(a).pin_memory(), item)
            with contextlib.ExitStack() as streams:
                # no wait on the consumer's stream (that would queue the
                # copy behind the step): the copy writes only memory the
                # allocator hands the side stream, and a yielded tensor's
                # record_stream keeps it from the side stream until the
                # consumer's work on it is done
                for stream in side.values():
                    streams.enter_context(torch.cuda.stream(stream))
                placed = tree_map(lambda t: _place(t, target, True), pinned)
                events = {}
                for d, stream in side.items():
                    events[d] = torch.cuda.Event()
                    events[d].record(stream)
            queue.append((placed, events, pinned))

    def release_copied() -> None:
        while copying and all(e.query() for e in copying[0][0].values()):
            copying.popleft()

    try:
        enqueue(size)
        while queue:
            placed, events, pinned = queue.popleft()
            for d, event in events.items():
                torch.cuda.current_stream(d).wait_event(event)
            for leaf in _tree_leaves(placed):
                shards = getattr(leaf, "shards", [leaf])
                for shard in shards:
                    shard.record_stream(torch.cuda.current_stream(
                        shard.device))
            copying.append((events, pinned))
            del pinned
            yield placed
            release_copied()
            enqueue(1)
    finally:
        for events, _ in copying:
            for event in events.values():
                event.synchronize()
        for _, events, _ in queue:
            for event in events.values():
                event.synchronize()


class ShardedBatchLoader:
    """Deterministic batching over in-memory arrays with per-process
    sharding for multi-process data parallelism — the JAX loader's
    batches, row for row.

    - ``arrays``: a tree of numpy arrays with a common leading dimension
      (e.g. ``{"images": x, "labels": y}``).
    - Each epoch is shuffled by ``np.random.default_rng(seed + epoch)``
      (deterministic resume: restarting at epoch E replays its order).
    - ``process_count`` / ``process_index`` default to
      ``torch.distributed``'s world size and rank when it is initialised,
      else 1 / 0; process p takes rows ``[b * global + p * batch, +batch)``
      of the epoch's order for global batch b, so the union over
      processes covers the epoch once.
    - The trailing partial batch is dropped (static shapes: a captured
      step replays one).

    Iterating yields host (numpy) trees — compose with
    :func:`prefetch_to_device` for the device side.
    """

    def __init__(
        self,
        arrays: Any,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        process_count: Optional[int] = None,
        process_index: Optional[int] = None,
    ):
        leaves = _tree_leaves(arrays)
        if not leaves:
            raise ValueError("arrays pytree has no leaves")
        n = leaves[0].shape[0]
        for leaf in leaves:
            if leaf.shape[0] != n:
                raise ValueError(
                    f"leading dimensions differ: {leaf.shape[0]} vs {n}"
                )
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        distributed = (torch.distributed.is_available()
                       and torch.distributed.is_initialized())
        self._arrays = arrays
        self._n = n
        self._batch = batch_size
        self._seed = seed
        self._shuffle = shuffle
        self._pcount = (process_count if process_count is not None
                        else torch.distributed.get_world_size()
                        if distributed else 1)
        self._pindex = (process_index if process_index is not None
                        else torch.distributed.get_rank()
                        if distributed else 0)
        if not 0 <= self._pindex < self._pcount:
            raise ValueError(
                f"process_index {self._pindex} outside [0, {self._pcount})"
            )
        # every process must agree on the global batch structure
        self._global_batch = batch_size * self._pcount
        self.batches_per_epoch = self._n // self._global_batch
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {n} rows cannot fill one global batch of "
                f"{self._global_batch} (batch_size {batch_size} x "
                f"{self._pcount} processes)"
            )

    def epoch(self, epoch: int = 0) -> Iterator[Any]:
        """Yield this process's batches for one epoch."""
        if self._shuffle:
            order = np.random.default_rng(self._seed + epoch).permutation(
                self._n)
        else:
            order = np.arange(self._n)
        for b in range(self.batches_per_epoch):
            start = b * self._global_batch + self._pindex * self._batch
            idx = order[start:start + self._batch]
            yield tree_map(lambda a: a[idx], self._arrays)

    def epochs(self, start_epoch: int = 0) -> Iterator[Any]:
        """Endless batch stream across epochs, resumable at
        ``start_epoch`` (checkpoint the epoch counter alongside the model
        state)."""
        for e in itertools.count(start_epoch):
            yield from self.epoch(e)
