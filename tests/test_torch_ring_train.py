"""Port parity: one sharded AdamW step with the zigzag ring over dp x tp x
sp under the fsdp rules (examples/train_longcontext.py's step) against
the JAX package's jitted step on its forced 8 host devices, at f32 on a
tiny model, and a second step from JAX's state carried by
train_state_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubeshare_tpu.models import transformer as jax_tf
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_ce
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax, train_state_from_jax
from kubeshare_tpu_torch.models import transformer as tf
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

torch.set_num_threads(1)

# f32 on both sides, only the summation order differs
F32_TOL = 1e-5
# parameters after one AdamW step: tests/test_torch_mesh_train.py's bound
PARAM_ATOL = 5e-6
CPU = torch.device("cpu")
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, max_seq_len=64, positional="rope")


def _close(got, want, what=""):
    err = abs(got - want) / max(abs(want), 1e-30)
    assert err <= F32_TOL, f"{what}: {err:.3e} (tol {F32_TOL})"


def _tokens(seed, shape=(4, 32), vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_sharded_ring_training_step_equals_jax_and_carries_its_state():
    # dp=2 x sp=2 (x tp=2) under the fsdp rules, the zigzag einsum ring,
    # as examples/train_longcontext.py trains: step 1 from the same
    # weights, then step 2 from JAX's state carried by train_state_from_jax
    cfg = dict(MODEL, attention="ring")
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **cfg)
    pcfg = tf.TransformerConfig(dtype=torch.float32, **cfg)
    params = jax.device_get(jax_tf.transformer_init(jax.random.PRNGKey(0),
                                                    jcfg))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(dp=2, tp=2, sp=2),
                               devices=jax.devices()[:8])
    mesh = make_mesh(MeshSpec(dp=2, tp=2, sp=2), devices=[CPU] * 8)
    rules = tf.transformer_fsdp_rules()
    tokens, targets = _tokens(3), _tokens(4)
    init, step = jax_make_train_step(
        lambda p, t: jax_tf.transformer_apply_ring(p, t, jcfg, jmesh,
                                                   layout="zigzag",
                                                   use_flash=False),
        mesh=jmesh, param_rules=jax_tf.transformer_fsdp_rules(),
        loss_fn=jax_ce, donate_state=False)
    place = jax_mesh.batch_sharding(jmesh, ndim=2)
    jt, jy = (jax.device_put(jnp.asarray(x), place) for x in (tokens, targets))
    state1, loss1 = step(init(params), jt, jy)
    state2, loss2 = step(state1, jt, jy)

    apply = lambda p, t: tf.transformer_apply_ring(p, t, pcfg, mesh,
                                                   layout="zigzag")
    init_state, train_step = port_train.make_train_step(
        apply, mesh=mesh, param_rules=rules)
    tt, ty = (torch.from_numpy(x).long() for x in (tokens, targets))
    port1, got1 = train_step(init_state(params_from_jax(params, "cpu")),
                             tt, ty)
    _close(float(got1), float(loss1), what="step 1 loss")
    want = dict(port_train.tree_leaves_with_paths(
        jax.device_get(state1.params)))
    for path, leaf in port_train.tree_leaves_with_paths(port1.params):
        np.testing.assert_allclose(leaf.gather().detach().numpy(), want[path],
                                   rtol=0, atol=PARAM_ATOL, err_msg=str(path))
    adam = jax.device_get(state1.opt_state[0])
    carried = train_state_from_jax(jax.device_get(state1.params), adam.mu,
                                   adam.nu, adam.count, mesh=mesh,
                                   param_rules=rules)
    _, got2 = train_step(carried, tt, ty)
    _close(float(got2), float(loss2), what="step 2 loss")
