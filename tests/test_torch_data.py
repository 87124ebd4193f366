"""Port parity: kubeshare_tpu_torch.data against kubeshare_tpu.data on the
CPU — the loader's batches equal the JAX loader's exactly (seeds, epochs,
shuffle on and off, 1-4 process splits, a tree of several arrays, the
same ValueErrors), and prefetch's look-ahead, order and placement onto a
mesh (the CUDA streams' ordering is tests/test_torch_cuda.py's)."""

import itertools

import numpy as np
import pytest
import torch

from kubeshare_tpu.data import ShardedBatchLoader as JaxLoader
from kubeshare_tpu.data import prefetch_to_device as jax_prefetch
from kubeshare_tpu_torch.data import ShardedBatchLoader, prefetch_to_device
from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, P, ShardedTensor,
                                               batch_sharding, make_mesh)

CPU = torch.device("cpu")


def _arrays(n=53):
    rng = np.random.default_rng(0)
    return {"images": rng.standard_normal((n, 4, 4, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (n,)).astype(np.int32),
            "extra": [np.arange(n * 2).reshape(n, 2)]}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["images"], np.asarray(b["images"]))
        np.testing.assert_array_equal(a["labels"], np.asarray(b["labels"]))
        np.testing.assert_array_equal(a["extra"][0],
                                      np.asarray(b["extra"][0]))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("processes", [1, 2, 3, 4])
def test_batches_equal_jax(seed, shuffle, processes):
    arrays = _arrays()
    for index in range(processes):
        kw = dict(batch_size=5, seed=seed, shuffle=shuffle,
                  process_count=processes, process_index=index)
        port, ref = ShardedBatchLoader(arrays, **kw), JaxLoader(arrays, **kw)
        assert port.batches_per_epoch == ref.batches_per_epoch
        for epoch in (0, 1, 3):
            _assert_batches_equal(list(port.epoch(epoch)),
                                  list(ref.epoch(epoch)))
        # the endless stream resumes at an epoch with that epoch's order
        n = 2 * port.batches_per_epoch + 1
        _assert_batches_equal(list(itertools.islice(port.epochs(2), n)),
                              list(itertools.islice(ref.epochs(2), n)))


def test_processes_cover_each_global_batch_once():
    arrays = {"row": np.arange(40)}
    rows = [np.concatenate([b["row"] for b in ShardedBatchLoader(
        arrays, 3, seed=1, process_count=4, process_index=p).epoch(2)])
        for p in range(4)]
    union = np.concatenate(rows)
    assert len(np.unique(union)) == len(union) == 36  # tail of 4 dropped


def _message(cls, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        cls(*args, **kwargs)
    return str(info.value)


@pytest.mark.parametrize("args,kwargs", [
    (({},), dict(batch_size=2)),
    (({"a": np.zeros((4, 1)), "b": np.zeros((5,))},), dict(batch_size=2)),
    (({"a": np.zeros((4, 1))},), dict(batch_size=0)),
    (({"a": np.zeros((4, 1))},), dict(batch_size=2, process_count=2,
                                      process_index=2)),
    (({"a": np.zeros((7, 1))},), dict(batch_size=2, process_count=4,
                                      process_index=1)),
], ids=["no_leaves", "leading_dims", "batch_size", "process_index",
        "global_batch"])
def test_errors_equal_jax(args, kwargs):
    assert _message(ShardedBatchLoader, *args, **kwargs) == \
        _message(JaxLoader, *args, **kwargs)


def test_prefetch_size_error_equals_jax():
    want = str(pytest.raises(ValueError, next, jax_prefetch(iter([]),
                                                            size=0)).value)
    got = str(pytest.raises(ValueError, next, prefetch_to_device(
        iter([]), size=0, sharding="cpu")).value)
    assert got == want


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_keeps_its_look_ahead_and_order(size):
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.full((2, 3), i, dtype=np.float32),
                   "y": [np.array([i, -i])]}

    out = []
    stream = prefetch_to_device(source(), size=size, sharding="cpu")
    for item in stream:
        # when item i is handed out, items up to i + size - 1 are placed
        assert len(pulled) == min(len(out) + size, 6)
        assert isinstance(item["x"], torch.Tensor)
        assert item["x"].device == CPU and item["x"].dtype == torch.float32
        out.append(int(item["x"][0, 0]))
        assert item["y"][0].tolist() == [out[-1], -out[-1]]
    assert out == list(range(6))


def test_prefetch_places_batches_onto_a_mesh():
    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=[CPU] * 4)
    loader = ShardedBatchLoader(_arrays(16), batch_size=4, seed=3)
    host = list(loader.epoch(0))
    placed = list(prefetch_to_device(loader.epoch(0), size=2,
                                     sharding=batch_sharding(mesh, 4)))
    assert len(placed) == len(host) == 4
    for got, want in zip(placed, host):
        images = got["images"]
        assert isinstance(images, ShardedTensor)
        assert images.spec == P("dp", None, None, None)
        # dp splits the rows; tp holds copies
        assert [tuple(s.shape) for s in images.shards] == [(2, 4, 4, 3)] * 4
        np.testing.assert_array_equal(images.gather().numpy(),
                                      want["images"])
        labels = got["labels"]  # one spec for every leaf: rows over dp
        assert isinstance(labels, ShardedTensor)
        np.testing.assert_array_equal(labels.gather().numpy(),
                                      want["labels"])
        np.testing.assert_array_equal(labels.shards[2].numpy(),
                                      want["labels"][2:])


def test_prefetch_defaults_to_the_card(monkeypatch):
    # no sharding: the current CUDA device, which raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([{"x": np.zeros(2)}])))
