"""Port parity: the transformer's pipelined entries
(transformer_apply_pipelined, transformer_train_1f1b with the ring and
Ulysses inside each stage) against the JAX package on its forced host
devices and against the port's one-device forward, at f32 on tiny
models; their refusals with JAX's messages.  The JAX side is jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kubeshare_tpu.models import transformer as jax_tf
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import transformer as tf
from kubeshare_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

# f32 on both sides, only the summation order differs: max |port - JAX|
# over max |JAX|
F32_TOL = 1e-5
CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=4,
             d_ff=64, max_seq_len=32)


def _meshes(pp, sp):
    devices = np.empty(pp * sp, dtype=object)
    devices[:] = [CPU] * (pp * sp)
    return (JaxMesh(np.array(jax.devices()[:pp * sp]).reshape(pp, sp),
                    ("pp", "sp")),
            Mesh(devices.reshape(pp, sp), ("pp", "sp")))


def _close(got, want, tol=F32_TOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of max (tol {tol})"


def _close_trees(got, want, what=""):
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda t: t.detach().numpy(), got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want), what
    for path, leaf in flat_got:
        _close(leaf, flat_want[path], what=f"{what}{jax.tree_util.keystr(path)}")


def _model(attention="ring", seed=0, **overrides):
    cfg = {**MODEL, "attention": attention, "positional": "rope", **overrides}
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **cfg)
    pcfg = tf.TransformerConfig(dtype=torch.float32, **cfg)
    params = jax.device_get(jax_tf.transformer_init(jax.random.PRNGKey(seed),
                                                    jcfg))
    return jcfg, pcfg, params


def _tokens(seed, shape=(4, 16)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_transformer_train_1f1b_equals_jax(attention):
    # pp=2 x sp=2, the sequence-parallel attention inside each stage
    jcfg, pcfg, params = _model(attention)
    jmesh, mesh = _meshes(2, 2)
    tokens, targets = _tokens(1), _tokens(2)
    want = jax.jit(lambda p, t, y: jax_tf.transformer_train_1f1b(
        p, t, y, jcfg, jmesh, num_microbatches=2))(
        params, jnp.asarray(tokens), jnp.asarray(targets))
    loss, grads = tf.transformer_train_1f1b(
        params_from_jax(params, "cpu"), torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long(), pcfg, mesh, num_microbatches=2)
    _close(float(loss), float(want[0]), what="loss")
    _close_trees(grads, jax.device_get(want[1]), "grads")


def test_transformer_apply_pipelined_equals_jax_and_one_device():
    # GPipe with learned positions, no sp, and 1F1B's gradients against
    # autograd through the one-device forward
    jcfg, pcfg, params = _model("reference", positional="learned")
    jmesh, mesh = _meshes(2, 1)
    tokens = _tokens(3)
    want = jax.jit(lambda p, t: jax_tf.transformer_apply_pipelined(
        p, t, jcfg, jmesh, num_microbatches=2))(params, jnp.asarray(tokens))
    port = params_from_jax(params, "cpu")
    got = tf.transformer_apply_pipelined(port, torch.from_numpy(tokens).long(),
                                         pcfg, mesh, num_microbatches=2)
    _close(got.detach().numpy(), want, what="logits")
    one = tf.transformer_apply(port, torch.from_numpy(tokens).long(), pcfg)
    _close(got.detach().numpy(), one.detach().numpy(), what="vs one device")


def test_learned_positions_1f1b_equals_one_device_autograd():
    _, pcfg, params = _model("reference", positional="learned")
    _, mesh = _meshes(2, 1)
    tokens = torch.from_numpy(_tokens(4)).long()
    targets = torch.from_numpy(_tokens(5)).long()
    port = params_from_jax(params, "cpu")
    loss, grads = tf.transformer_train_1f1b(port, tokens, targets, pcfg, mesh,
                                            num_microbatches=2)
    leaves = jax.tree.map(lambda t: t.requires_grad_(), port)
    want = tf.cross_entropy_loss(tf.transformer_apply(leaves, tokens, pcfg),
                                 targets)
    want.backward()
    _close(float(loss), float(want.detach()), what="loss")
    flat = jax.tree_util.tree_leaves_with_path(grads)
    ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.grad, leaves)))
    for path, g in flat:
        _close(g.numpy(), ref[path].numpy(),
               what=jax.tree_util.keystr(path))


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_refusals_carry_jax_messages():
    jmesh, mesh = _meshes(2, 2)
    # MoE on the pipelined path, and a stage count that does not divide
    # the layers
    for overrides in (dict(moe_every=2, moe_num_experts=4),
                      dict(n_layers=3)):
        jcfg, pcfg, mparams = _model("ring", **overrides)
        toks = np.zeros((2, 8), np.int32)
        assert _message(lambda: tf.transformer_apply_pipelined(
            params_from_jax(mparams, "cpu"), torch.zeros((2, 8), dtype=torch.long),
            pcfg, mesh)) == _message(
            lambda: jax_tf.transformer_apply_pipelined(mparams, toks, jcfg,
                                                       jmesh))
