"""Port parity: the transformer's sequence-parallel entries
(transformer_apply_ring contiguous and zigzag, transformer_apply_ulysses,
MoE with its aux) and the mesh-aware transformer_apply over a batch
split along the sequence, against the JAX package on its forced 8 host
devices, at f32 on tiny models; the entries' refusals with JAX's
messages (a sharded step with the ring: tests/test_torch_ring_train.py).

The port's meshes name the CPU several times (``[cpu] * n``).  The JAX
side is jitted (its shard_map runs op by op otherwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import transformer as jax_tf
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import transformer as tf
from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, batch_sharding,
                                               device_put, make_mesh,
                                               shard_params)

torch.set_num_threads(1)

# f32 on both sides, only the summation order differs: max |port - JAX|
# over max |JAX|
F32_TOL = 1e-5

CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, max_seq_len=64, positional="rope")


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


def _jax_port_model(seed=0, **overrides):
    cfg = dict(MODEL, **overrides)
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **cfg)
    pcfg = tf.TransformerConfig(dtype=torch.float32, **cfg)
    params = jax.device_get(jax_tf.transformer_init(jax.random.PRNGKey(seed),
                                                    jcfg))
    return jcfg, pcfg, params


def _tokens(seed, shape=(4, 32), vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# (entry, layout, mesh axes, config overrides, with_aux)
ENTRY_CASES = {
    "ring_contiguous": ("ring", "contiguous", dict(dp=2, sp=4), {}, False),
    "ring_zigzag_learned": ("ring", "zigzag", dict(dp=2, sp=2),
                            dict(positional="learned"), False),
    "ring_windowed": ("ring", "contiguous", dict(dp=2, sp=2),
                      dict(attention_window=10), False),
    "ulysses": ("ulysses", None, dict(dp=2, sp=2), {}, False),
    "ring_moe_aux": ("ring", "contiguous", dict(dp=2, sp=2),
                     dict(moe_every=2, moe_num_experts=4, moe_top_k=2), True),
    "ulysses_moe_aux": ("ulysses", None, dict(dp=2, sp=2),
                        dict(moe_every=2, moe_num_experts=4, moe_top_k=2),
                        True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_sequence_parallel_entries_equal_jax(name):
    entry, layout, axes, overrides, with_aux = ENTRY_CASES[name]
    jcfg, pcfg, params = _jax_port_model(**overrides)
    jmesh, mesh = _meshes(**axes)
    tokens = _tokens(1)
    kw = {"layout": layout} if layout else {}
    jfn = getattr(jax_tf, f"transformer_apply_{entry}")
    want = jax.jit(lambda p, t: jfn(p, t, jcfg, jmesh, with_aux=True,
                                    **kw))(params, jnp.asarray(tokens))
    fn = getattr(tf, f"transformer_apply_{entry}")
    got = fn(params_from_jax(params, "cpu"), torch.from_numpy(tokens).long(),
             pcfg, mesh, with_aux=with_aux, **kw)
    logits, aux = got if with_aux else (got, None)
    assert logits.spec == (("dp", "sp", None))
    _close(logits.gather().detach().numpy(), want[0], what="logits")
    if with_aux:
        _close(float(aux), float(want[1]), what="aux")


def test_a_batch_split_along_the_sequence_equals_jax_gspmd():
    # the mesh-aware transformer_apply over tokens placed by
    # batch_sharding(mesh, 2, seq_axis=1): GSPMD's full attention in JAX,
    # the contiguous ring in the port; dp x tp x sp with the base rules
    jcfg, pcfg, params = _jax_port_model(attention="reference")
    jmesh, mesh = _meshes(dp=2, tp=2, sp=2)
    tokens = _tokens(2)
    jparams = jax_mesh.shard_params(params, jax_tf.transformer_sharding_rules(),
                                    jmesh)
    jtokens = jax.device_put(jnp.asarray(tokens),
                             jax_mesh.batch_sharding(jmesh, 2, seq_axis=1))
    want = jax.jit(lambda p, t: jax_tf.transformer_apply(p, t, jcfg))(
        jparams, jtokens)
    placed = shard_params(params_from_jax(params, "cpu"),
                          tf.transformer_sharding_rules(), mesh)
    ptokens = device_put(torch.from_numpy(tokens).long(),
                         batch_sharding(mesh, 2, seq_axis=1))
    got = tf.transformer_apply(placed, ptokens, pcfg)
    assert got.spec == ("dp", "sp", "tp")
    _close(got.gather().detach().numpy(), want, what="logits")


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_refusals_carry_jax_messages():
    jcfg, pcfg, params = _jax_port_model(attention="ring")
    port_params = params_from_jax(params, "cpu")
    jmesh, mesh = _meshes(dp=2, sp=2)
    toks = np.zeros((2, 8), np.int32)
    pt = torch.zeros((2, 8), dtype=torch.long)
    # the one-device entries refuse a sequence-parallel config
    for entry in ("transformer_apply", "transformer_apply_with_aux"):
        assert _message(lambda: getattr(tf, entry)(port_params, pt, pcfg)) \
            == _message(lambda: getattr(jax_tf, entry)(params, toks, jcfg))
    # _validate_sp_entry: no sp axis, Ulysses heads, expert choice
    jnosp = jax_mesh.make_mesh(jax_mesh.MeshSpec(dp=2), devices=jax.devices()[:2])
    nosp = make_mesh(MeshSpec(dp=2), devices=[CPU] * 2)
    assert _message(lambda: tf.transformer_apply_ring(
        port_params, pt, pcfg, nosp, seq_axis="cp")) == _message(
        lambda: jax_tf.transformer_apply_ring(params, toks, jcfg, jnosp,
                                              seq_axis="cp"))
    jm4, m4 = _meshes(sp=4)
    _, ucfg, uparams = _jax_port_model(n_heads=2, n_kv_heads=2, d_model=16)
    ujcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **dict(
        MODEL, n_heads=2, n_kv_heads=2, d_model=16))
    assert _message(lambda: tf.transformer_apply_ulysses(
        params_from_jax(uparams, "cpu"), pt, ucfg, m4)) == _message(
        lambda: jax_tf.transformer_apply_ulysses(uparams, toks, ujcfg, jm4))
    ejcfg, ecfg, eparams = _jax_port_model(moe_every=2, moe_num_experts=4,
                                           moe_routing="experts_choose")
    assert _message(lambda: tf.transformer_apply_ring(
        params_from_jax(eparams, "cpu"), pt, ecfg, mesh)) == _message(
        lambda: jax_tf.transformer_apply_ring(eparams, toks, ejcfg, jmesh))
