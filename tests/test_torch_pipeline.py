"""Port parity: pipeline parallelism (parallel/pipeline.py: GPipe's
pipeline_apply and the 1F1B schedule) against the JAX package on its
forced host devices, at f32 on tiny shapes; 1F1B's gradients against
autograd through the port's own GPipe, and its in-flight memory bound
(the transformer's pipelined entries: tests/test_torch_pipeline_model.py).

The port's meshes name the CPU several times; its stage bodies take the
list of a stage's sequence members (``stage_fn(params, xs) -> ys``)
where JAX's take one shard.  The JAX side is jitted."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

from kubeshare_tpu.parallel import pipeline as jax_pipeline
from kubeshare_tpu_torch.parallel import pipeline
from kubeshare_tpu_torch.parallel.mesh import Mesh, P

torch.set_num_threads(1)

# f32 on both sides, only the summation order differs: max |port - JAX|
# over max |JAX|
F32_TOL = 1e-5
CPU = torch.device("cpu")


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


# a stage: tanh(x @ w + b), per token, so it runs on sequence shards too
def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _port_stage(p, xs):
    return [torch.tanh(x @ p["w"] + p["b"]) for x in xs]


def _stage_params(pp, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((pp, d, d)) / np.sqrt(d)).astype(
        np.float32), "b": rng.standard_normal((pp, d)).astype(np.float32)}


def _to_torch(tree, grad=False):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                        .requires_grad_(grad), tree)


# (pp, sp, microbatches): sp > 1 splits the activations P(None, "sp", None)
CASES = [(2, 1, 2), (2, 2, 4), (4, 1, 3)]


@pytest.mark.parametrize("pp,sp,micro", CASES)
def test_pipeline_apply_and_its_gradients_equal_jax(pp, sp, micro):
    jmesh, mesh = _meshes(pp, sp)
    params = _stage_params(pp, 8)
    x = np.random.default_rng(1).standard_normal((6 if micro == 3 else 4, 8,
                                                  8)).astype(np.float32)
    jspec = JaxP(None, "sp", None) if sp > 1 else None
    spec = P(None, "sp", None) if sp > 1 else None

    def jloss(p, x):
        out = jax_pipeline.pipeline_apply(p, x, _jax_stage, jmesh, micro,
                                          activation_spec=jspec)
        return (out ** 2).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)
    tp = _to_torch(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = pipeline.pipeline_apply(tp, tx, _port_stage, mesh, micro,
                                  activation_spec=spec)
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want, what="out")
    _close(tx.grad.numpy(), gx, what="dx")
    for name in ("w", "b"):
        _close(tp[name].grad.numpy(), gp[name], what=f"d{name}")


def _jax_1f1b(params, lparams, x, y, jmesh, micro, jspec):
    def loss_fn(lp, out, y):
        return jnp.mean((out @ lp["head"] - y) ** 2)

    return jax.jit(lambda p, lp, x, y: jax_pipeline.pipeline_train_1f1b(
        p, x, y, _jax_stage, loss_fn, jmesh, micro, activation_spec=jspec,
        loss_params=lp, return_input_grads=True))(params, lparams, x, y)


def _port_loss(lp, out, y):
    return ((out @ lp["head"] - y) ** 2).mean()


@pytest.mark.parametrize("pp,sp,micro", CASES)
def test_1f1b_equals_jax_and_autograd_through_gpipe(pp, sp, micro):
    jmesh, mesh = _meshes(pp, sp)
    d = 8
    params = _stage_params(pp, d, seed=2)
    rng = np.random.default_rng(3)
    batch = 6 if micro == 3 else 4
    x = rng.standard_normal((batch, 8, d)).astype(np.float32)
    y = rng.standard_normal((batch, 8, 4)).astype(np.float32)
    lparams = {"head": rng.standard_normal((d, 4)).astype(np.float32)}
    jspec = JaxP(None, "sp", None) if sp > 1 else None
    spec = P(None, "sp", None) if sp > 1 else None
    want = _jax_1f1b(params, lparams, x, y, jmesh, micro, jspec)
    loss, grads, lgrads, dx = pipeline.pipeline_train_1f1b(
        _to_torch(params), torch.from_numpy(x), torch.from_numpy(y),
        _port_stage, _port_loss, mesh, micro, activation_spec=spec,
        loss_params=_to_torch(lparams), return_input_grads=True)
    _close(float(loss), float(want[0]), what="loss")
    _close_trees(grads, jax.device_get(want[1]), "grads")
    _close_trees(lgrads, jax.device_get(want[2]), "loss-param grads")
    _close(dx.numpy(), want[3], what="dx")

    # the same gradients as autograd through GPipe: the loss is the mean
    # over microbatches (and sequence members) of each piece's mean
    tp, tl = _to_torch(params, grad=True), _to_torch(lparams, grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = pipeline.pipeline_apply(tp, tx, _port_stage, mesh, micro,
                                  activation_spec=spec)
    mb, members = batch // micro, sp
    pieces = [_port_loss(tl, o, t)
              for m in range(micro)
              for o, t in zip(out[m * mb:(m + 1) * mb].chunk(members, 1),
                              torch.from_numpy(y)[m * mb:(m + 1) * mb]
                              .chunk(members, 1))]
    gpipe_loss = torch.stack(pieces).mean()
    gpipe_loss.backward()
    _close(float(loss), float(gpipe_loss.detach()), what="loss vs GPipe")
    for name in ("w", "b"):
        _close(grads[name].numpy(), tp[name].grad.numpy(),
               what=f"d{name} vs GPipe")
    _close(lgrads["head"].numpy(), tl["head"].grad.numpy(),
           what="dhead vs GPipe")
    _close(dx.numpy(), tx.grad.numpy(), what="dx vs GPipe")


def test_1f1b_keeps_at_most_its_slots_in_flight():
    # every stage input alive (held by the schedule or a stage's graph)
    # is tracked by a weak reference; a stage may hold at most
    # min(M, 2 * pp - 1) microbatches, whatever M is
    pp, micro = 3, 8
    _, mesh = _meshes(pp, 1)
    params = _stage_params(pp, 4, seed=4)
    params["tag"] = np.arange(pp, dtype=np.float32)[:, None]
    alive = [weakref.WeakSet() for _ in range(pp)]
    peak = [0] * pp

    def stage(p, xs):
        s = int(p["tag"][0])
        alive[s].update(xs)
        peak[s] = max(peak[s], len(alive[s]))
        return _port_stage(p, xs)

    x = torch.randn((micro * 2, 3, 4))
    pipeline.pipeline_train_1f1b(
        _to_torch(params), x, torch.randn((micro * 2, 3, 4)), stage,
        lambda out, y: ((out - y) ** 2).mean(), mesh, micro)
    slots = min(micro, 2 * pp - 1)
    assert max(peak) <= slots, peak
    # stage s holds the 2 * (pp - 1 - s) + 1 microbatches between its
    # forward and its backward: the first stage's window is the widest
    assert peak == [2 * (pp - 1 - s) + 1 for s in range(pp)], peak
    assert peak[0] == slots


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_refusals_carry_jax_messages():
    jmesh, mesh = _meshes(2, 2)
    params = _stage_params(2, 4)
    x = np.zeros((4, 4, 4), np.float32)
    for spec in ((None, None, "pp"), ("sp", None, None)):
        assert _message(lambda: pipeline.pipeline_apply(
            _to_torch(params), torch.from_numpy(x), _port_stage, mesh, 2,
            activation_spec=P(*spec))) == _message(
            lambda: jax_pipeline.pipeline_apply(
                params, x, _jax_stage, jmesh, 2, activation_spec=JaxP(*spec)))
    assert _message(lambda: pipeline.pipeline_apply(
        _to_torch(params), torch.from_numpy(x), _port_stage, mesh, 3)) == \
        _message(lambda: jax_pipeline.pipeline_apply(
            params, x, _jax_stage, jmesh, 3))
