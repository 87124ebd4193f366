"""Port parity: ring and Ulysses attention (ops/ring_attention.py,
ops/ulysses.py) against the JAX package's shard_map versions on its
forced 8 host devices, at f32 on tiny shapes (the transformer's
sequence-parallel entries: tests/test_torch_ring_model.py).

The port's meshes name the CPU several times (``[cpu] * n``): one
controller runs every shard's body in turn.  Each case feeds the same
numpy inputs to both packages; the JAX side is jitted (its shard_map
runs op by op otherwise, tens of times slower)."""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.ops.ulysses import \
    ulysses_attention_sharded as jax_ulysses_sharded
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu_torch.ops.ulysses import ulysses_attention_sharded
from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

# the modules themselves (each ops/__init__ re-exports a function that
# shadows its module's name)
ring = importlib.import_module("kubeshare_tpu_torch.ops.ring_attention")
jax_ring = importlib.import_module("kubeshare_tpu.ops.ring_attention")

torch.set_num_threads(1)

# f32 on both sides, only the summation order differs: max |port - JAX|
# over max |JAX|
F32_TOL = 1e-5

CPU = torch.device("cpu")


def _meshes(**axes):
    spec = {"dp": 1, "tp": 1, "sp": 1, **axes}
    n = int(np.prod(list(spec.values())))
    return (jax_mesh.make_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:n]),
            make_mesh(MeshSpec(**spec), devices=[CPU] * n))


def _close(got, want, tol=F32_TOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of max (tol {tol})"


def _qkv(seed, b, h, h_kv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d))]


def _jax_value_and_grads(fn, q, k, v, w):
    def loss(q, k, v):
        out = fn(q, k, v)
        return (out * w).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_value_and_grads(fn, q, k, v, w):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(q, k, v).gather()
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


# (layout, use_flash, window, mesh axes, (b, h, h_kv, s, d)); the port's
# hybrid ring (use_flash=True) runs the flash forward's plain version on
# the CPU, held to JAX's einsum ring
RING_CASES = {
    "contiguous_sp2": ("contiguous", False, None, dict(dp=2, sp=2),
                       (2, 4, 4, 32, 8)),
    "contiguous_gqa_sp4": ("contiguous", False, None, dict(dp=2, sp=4),
                           (2, 4, 2, 32, 8)),
    "hybrid_gqa_sp4": ("contiguous", True, None, dict(dp=2, sp=4),
                       (2, 4, 2, 32, 8)),
    "zigzag_gqa_sp2": ("zigzag", False, None, dict(sp=2), (1, 4, 2, 32, 8)),
    "zigzag_hybrid_sp4": ("zigzag", True, None, dict(dp=2, sp=4),
                          (2, 2, 2, 64, 8)),
    "windowed_sp4": ("contiguous", False, 10, dict(dp=2, sp=4),
                     (2, 4, 2, 32, 8)),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_outputs_and_grads_equal_jax_einsum_ring(name):
    layout, use_flash, window, axes, (b, h, h_kv, s, d) = RING_CASES[name]
    jmesh, mesh = _meshes(**axes)
    q, k, v, w = _qkv(sorted(RING_CASES).index(name), b, h, h_kv, s, d)
    kw = dict(causal=True, batch_axis="dp", head_axis=None, layout=layout,
              window=window)
    want = _jax_value_and_grads(
        lambda q, k, v: jax_ring.ring_attention_sharded(
            q, k, v, jmesh, use_flash=False, **kw), q, k, v, w)
    got = _port_value_and_grads(
        lambda q, k, v: ring.ring_attention_sharded(
            q, k, v, mesh, use_flash=use_flash, **kw), q, k, v, w)
    _close(got[0], want[0], what=f"{name} out")
    for label, g, r in zip("qkv", got[1], want[1]):
        _close(g, r, what=f"{name} d{label}")


def test_hybrid_ring_equals_jax_hybrid_ring_in_interpret_mode():
    # JAX's hybrid ring with the Pallas kernel interpreted, at the
    # smallest shape its kernel blocks tile
    jmesh, mesh = _meshes(sp=2)
    q, k, v, w = _qkv(7, 1, 2, 2, 16, 8)
    kw = dict(causal=True, batch_axis=None, head_axis=None, use_flash=True)
    want = _jax_value_and_grads(
        lambda q, k, v: jax_ring.ring_attention_sharded(
            q, k, v, jmesh, interpret=True, **kw), q, k, v, w)
    got = _port_value_and_grads(
        lambda q, k, v: ring.ring_attention_sharded(q, k, v, mesh, **kw),
        q, k, v, w)
    _close(got[0], want[0], what="out")
    for label, g, r in zip("qkv", got[1], want[1]):
        _close(g, r, what=f"d{label}")


@pytest.mark.parametrize("window", [None, 12])
def test_ulysses_outputs_and_grads_equal_jax(window):
    jmesh, mesh = _meshes(dp=2, sp=2)
    q, k, v, w = _qkv(3, 2, 4, 2, 32, 8)
    kw = dict(causal=True, window=window, batch_axis="dp", head_axis=None)
    want = _jax_value_and_grads(
        lambda q, k, v: jax_ulysses_sharded(q, k, v, jmesh, **kw), q, k, v, w)
    got = _port_value_and_grads(
        lambda q, k, v: ulysses_attention_sharded(q, k, v, mesh, **kw),
        q, k, v, w)
    _close(got[0], want[0], what="out")
    for label, g, r in zip("qkv", got[1], want[1]):
        _close(g, r, what=f"d{label}")


def test_zigzag_layout_equals_jax():
    x = np.arange(2 * 32).reshape(1, 2, 32).astype(np.float32)
    for sp in (2, 4):
        perm, inv = ring.zigzag_permutation(32, sp)
        want_perm, want_inv = jax_ring.zigzag_permutation(32, sp)
        np.testing.assert_array_equal(perm, want_perm)
        np.testing.assert_array_equal(inv, want_inv)
        np.testing.assert_array_equal(
            ring.zigzag_shard(torch.from_numpy(x), sp, axis=2).numpy(),
            np.asarray(jax_ring.zigzag_shard(jnp.asarray(x), sp, axis=2)))
        shards = list(ring.zigzag_shard(torch.from_numpy(x), sp).chunk(sp, 2))
        back = torch.cat(ring.zigzag_to_contiguous(shards), 2)
        np.testing.assert_array_equal(back.numpy(), x)
        positions = torch.cat([ring.zigzag_positions(i, sp, 32 // sp)
                               for i in range(sp)])
        np.testing.assert_array_equal(positions.numpy(), perm)
    assert ring.windowed_ring_steps(10, 8, 4) == jax_ring.windowed_ring_steps(
        10, 8, 4) == 3


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_op_refusals_carry_jax_messages():
    jmesh, mesh = _meshes(dp=2, sp=2)
    # the ops: zigzag non-causal, a window on the flash or zigzag ring,
    # an odd zigzag shard
    q = np.zeros((1, 2, 8, 8), np.float32)
    tq = torch.from_numpy(q)
    for kw in (dict(layout="zigzag", causal=False),
               dict(window=4, use_flash=True),
               dict(window=4, layout="zigzag")):
        assert _message(lambda: ring.ring_attention_sharded(
            tq, tq, tq, mesh, batch_axis=None, head_axis=None, **kw)) == \
            _message(lambda: jax_ring.ring_attention_sharded(
                q, q, q, jmesh, batch_axis=None, head_axis=None, **kw))
    odd = [torch.zeros((1, 2, 3, 8))] * 2
    assert _message(lambda: ring.ring_flash_attention_zigzag(odd, odd, odd)) \
        == "zigzag shard length must be even, got 3"
    assert _message(lambda: ring.ring_attention_zigzag(odd, odd, odd)) \
        == "zigzag shard length must be even, got 3"


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_zigzag_wrapper_counts_calls_and_warns_on_the_second(monkeypatch):
    _, mesh = _meshes(sp=2)
    q = torch.randn((1, 1, 8, 4))
    monkeypatch.setattr(ring, "_zigzag_wrapper_calls", 0)
    logger = logging.getLogger("kubeshare.kubeshare-ops")
    collect = _Collect()
    logger.addHandler(collect)
    try:
        for calls in (1, 2, 3):
            ring.ring_attention_sharded(q, q, q, mesh, batch_axis=None,
                                        head_axis=None, layout="zigzag")
            assert ring.zigzag_wrapper_calls() == calls
            assert len(collect.messages) == (0 if calls == 1 else 1)
    finally:
        logger.removeHandler(collect)
    assert "called more than once" in collect.messages[0]
