"""Port parity: the training half of the mesh (parallel/spmd.py, the
mesh path of parallel/train.py, the sharding rules, batch_sharding, the
sharded MoE layer and train_state_from_jax over a mesh) against the JAX
package's sharded training on its forced 8 host devices, at f32 with
attention "reference" on tiny models.

The port's meshes name the CPU eight times (``[cpu] * 8``): one
controller runs every unit's body in turn, the CPU counterpart of a
group that names ``cuda:0`` several times on the card.  Each test feeds
the same numpy inputs to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import \
    transformer_apply_with_aux as jax_apply_with_aux
from kubeshare_tpu.models.transformer import \
    transformer_fsdp_rules as jax_fsdp_rules
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.models.transformer import \
    transformer_sharding_rules as jax_rules
from kubeshare_tpu.ops import moe as jax_moe
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_ce
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax, train_state_from_jax
from kubeshare_tpu_torch.models.decoding import prefill
from kubeshare_tpu_torch.models.transformer import (
    TransformerConfig,
    transformer_apply,
    transformer_apply_with_aux,
    transformer_fsdp_rules,
    transformer_sharding_rules,
)
from kubeshare_tpu_torch.ops import moe
from kubeshare_tpu_torch.parallel import mesh as port_mesh
from kubeshare_tpu_torch.parallel import spmd
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, P, ShardedTensor,
                                               batch_sharding, device_put,
                                               make_mesh, shard_params)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# f32 on both sides: only summation order differs (the sharded program
# sums the tp partial products, the vocab pieces' exponentials and the
# dp copies' gradients in its own order)
LOSS_RTOL = 1e-5
# parameters after three AdamW steps: tests/test_torch_train.py's bound
# and reason, at optax's default eps 1e-8 for the dense models
PARAM_ATOL = 5e-6
# the MoE steps run AdamW with eps 1e-5 in both packages, as
# tests/test_torch_moe.py does and for its reason: a weight whose first
# gradient cancels to ~1e-7 turns the packages' round-off into a step
# difference of up to lr * dg / eps
MOE_ADAM_EPS = 1e-5
# JAX's own bounds (tests/test_compute.py, tests/test_parallel_extra.py)
FSDP_RTOL, FSDP_ATOL = 2e-5, 2e-6
MOE_LOSS_RTOL, MOE_GRAD_RTOL, MOE_GRAD_ATOL = 1e-5, 2e-4, 1e-5

DENSE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=32, n_kv_heads=2)
MOE_MODEL = dict(DENSE, moe_every=2, moe_num_experts=4, moe_top_k=2)


def _configs(**kw):
    return (JaxConfig(dtype=jnp.float32, attention="reference", **kw),
            TransformerConfig(dtype=torch.float32, attention="reference",
                              **kw))


def _batch(seed, shape=(4, 16), vocab=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def _meshes(**axes):
    spec = {"sp": 1, **axes}
    n = int(np.prod(list(spec.values())))
    return (jax_mesh.make_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:n]),
            make_mesh(MeshSpec(**spec), devices=CPU8[:n]))


def _gathered(tree):
    return {path: leaf.gather().detach().numpy()
            for path, leaf in port_train.tree_leaves_with_paths(tree)}


def _assert_replicas_equal(tree):
    """Every copy of every slice equal to the bit."""
    for path, leaf in port_train.tree_leaves_with_paths(tree):
        for group in leaf.copies:
            for i in group[1:]:
                assert torch.equal(leaf.shards[i], leaf.shards[group[0]]), path


def _assert_params_close(tree, jax_tree, atol=PARAM_ATOL):
    want = dict(port_train.tree_leaves_with_paths(jax.device_get(jax_tree)))
    got = _gathered(tree)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=atol,
                                   err_msg=str(path))


def _jax_steps(jmesh, rules, apply, params, tokens, targets, steps,
               optimizer=None, loss_fn=jax_ce):
    init, step = jax_make_train_step(apply, mesh=jmesh, param_rules=rules,
                                     optimizer=optimizer, loss_fn=loss_fn,
                                     donate_state=False)
    state = init(params)
    place = jax_mesh.batch_sharding(jmesh, ndim=2)
    tokens = jax.device_put(jnp.asarray(tokens), place)
    targets = jax.device_put(jnp.asarray(targets), place)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tokens, targets)
        losses.append(float(loss))
    return state, losses


def _port_steps(step, state, tokens, targets, steps):
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.from_numpy(tokens),
                           torch.from_numpy(targets))
        assert loss.shape == () and not loss.requires_grad
        losses.append(float(loss))
        _assert_replicas_equal(state.params)
    return state, losses


def _spec_leaves(tree, path=()):
    """{path: spec as a tuple} of a tree of either package's specs."""
    if isinstance(tree, dict):
        return {k: v for key, value in tree.items()
                for k, v in _spec_leaves(value, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, value in enumerate(tree)
                for k, v in _spec_leaves(value, path + (i,)).items()}
    return {path: tuple(tree)}


def _with_aux(ce):
    return lambda out, targets: ce(out[0], targets) + 0.01 * out[1]


# ---------------------------------------------------------------------------
# the rules and the batch specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["base", "fsdp", "fsdp_ep", "moe_dp",
                                  "moe_ep"])
def test_rules_equal_jax(name):
    port, want = {
        "base": (transformer_sharding_rules(), jax_rules()),
        "fsdp": (transformer_fsdp_rules(), jax_fsdp_rules()),
        "fsdp_ep": (transformer_fsdp_rules("ep"), jax_fsdp_rules("ep")),
        "moe_dp": (moe.moe_sharding_rules(), jax_moe.moe_sharding_rules()),
        "moe_ep": (moe.moe_sharding_rules("ep"),
                   jax_moe.moe_sharding_rules("ep")),
    }[name]
    assert {k: tuple(v) for k, v in port.items()} == \
        {k: tuple(v) for k, v in want.items()}
    if name.startswith("moe"):
        return
    # every leaf of the MoE model (dense and expert layers) placed alike
    jax_cfg, _ = _configs(**MOE_MODEL)
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    got = _spec_leaves(port_mesh.param_spec_tree(
        params_from_jax(params, "cpu"), port))
    assert got == _spec_leaves(jax_mesh.param_spec_tree(params, want))
    assert len(got) == len(port_train.tree_leaves(params))


@pytest.mark.parametrize("axes,ndim,seq_axis", [
    (dict(dp=2, tp=2, sp=2), 2, None),
    (dict(dp=2, tp=2, sp=2), 2, 1),
    (dict(dp=2, ep=2, tp=2), 2, None),
    (dict(dp=2, ep=2, tp=2), 3, None),
    (dict(dp=4, tp=1, sp=2), 3, 1),
    (dict(dp=8), 1, None),
])
def test_batch_sharding_equals_jax(axes, ndim, seq_axis):
    jmesh, mesh = _meshes(**axes)
    want = jax_mesh.batch_sharding(jmesh, ndim, seq_axis).spec
    got = batch_sharding(mesh, ndim, seq_axis)
    assert tuple(got.spec) == tuple(want) and got.mesh is mesh
    # a batch placed under it: each device its rows, the spec kept
    shape = (8, 4, 2)[:ndim]
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    placed = device_put(x, got)
    assert placed.spec == got.spec
    torch.testing.assert_close(placed.gather(), x)


# ---------------------------------------------------------------------------
# training the transformer over a mesh
# ---------------------------------------------------------------------------

def test_transformer_dp_tp_training_equals_jax_and_one_device():
    """dp=2 x tp=2 x sp=2, GQA (2 KV heads, one a tp shard), f32: three
    steps against JAX's sharded step and the port's one-device step."""
    jax_cfg, cfg = _configs(**DENSE)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    tokens, targets = _batch(1)
    jmesh, mesh = _meshes(dp=2, tp=2, sp=2)
    jax_state, jax_losses = _jax_steps(
        jmesh, jax_rules(), lambda p, t: jax_apply(p, t, jax_cfg), params,
        tokens, targets, 3)

    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=transformer_sharding_rules())
    state = init_state(params_from_jax(jax.device_get(params), "cpu"))
    embed = state.params["embed"]
    assert embed.spec == P("tp", None) and embed.shards[0].shape == (32, 32)
    wk = state.params["layers"][0]["attn"]["wk"]
    assert wk.shards[0].shape == (32, 1, 8)  # one KV head a tp shard
    state, losses = _port_steps(train_step, state, tokens, targets, 3)
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    _assert_params_close(state.params, jax_state.params)
    assert all(s.grad is None for leaf in port_train.tree_leaves(state.params)
               for s in leaf.shards)

    one_init, one_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg))
    one = one_init(params_from_jax(jax.device_get(params), "cpu"))
    one_losses = []
    for _ in range(3):
        one, loss = one_step(one, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        one_losses.append(float(loss))
    np.testing.assert_allclose(losses, one_losses, rtol=LOSS_RTOL)
    got = _gathered(state.params)
    for path, leaf in port_train.tree_leaves_with_paths(one.params):
        np.testing.assert_allclose(got[path], leaf.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


@pytest.mark.parametrize("name", ["base", "fsdp", "moe"])
def test_sharded_gradients_equal_one_device_and_jax(name):
    """One backward of the sharded program over dp=2 x tp=2 x sp=2 (sp a
    replica axis), the copies' gradients summed: every gradient equals
    the one-device gradient and JAX's.  AdamW normalises a gradient's
    scale away, so the training tests alone would not see a gradient
    counted twice by replicas."""
    jax_cfg, cfg = _configs(**(MOE_MODEL if name == "moe" else DENSE))
    params = jax_init(jax.random.PRNGKey(5), jax_cfg)
    tokens, targets = _batch(5)
    rules = (transformer_fsdp_rules() if name == "fsdp"
             else transformer_sharding_rules())
    apply = transformer_apply_with_aux if name == "moe" else transformer_apply
    loss_fn = (_with_aux(port_train.cross_entropy_loss) if name == "moe"
               else port_train.cross_entropy_loss)
    _, mesh = _meshes(dp=2, tp=2, sp=2)
    placed = shard_params(params_from_jax(jax.device_get(params), "cpu"),
                          rules, mesh, copy=True)
    leaves = port_train.tree_leaves(placed)
    for leaf in leaves:
        for shard in leaf.shards:
            shard.requires_grad_(True)
    loss = loss_fn(apply(placed, torch.from_numpy(tokens), cfg),
                   torch.from_numpy(targets))
    loss.backward()
    spmd.sum_copies(leaves)
    got = [leaf.grad.gather() for leaf in leaves]

    one = params_from_jax(jax.device_get(params), "cpu")
    one_leaves = port_train.tree_leaves(one)
    for leaf in one_leaves:
        leaf.requires_grad_(True)
    one_loss = loss_fn(apply(one, torch.from_numpy(tokens), cfg),
                       torch.from_numpy(targets))
    want = torch.autograd.grad(one_loss, one_leaves)
    jax_fn = jax_apply_with_aux if name == "moe" else jax_apply
    jax_loss_fn = _with_aux(jax_ce) if name == "moe" else jax_ce
    jax_grads = port_train.tree_leaves(jax.device_get(jax.jit(jax.grad(
        lambda p: jax_loss_fn(jax_fn(p, jnp.asarray(tokens), jax_cfg),
                              jnp.asarray(targets))))(params)))
    np.testing.assert_allclose(float(loss.detach()), float(one_loss.detach()),
                               rtol=LOSS_RTOL)
    for g, w, j in zip(got, want, jax_grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-5 * scale)


def test_fsdp_rules_match_replicated_training():
    """Parameters and Adam moments shard over dp under the fsdp rules,
    and two steps equal the base rules' (JAX's bounds) and JAX's fsdp."""
    jax_cfg, cfg = _configs(**DENSE)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    tokens, _ = _batch(2)
    jmesh, mesh = _meshes(dp=2, tp=2, sp=2)
    runs, sizes = {}, {}
    for name, rules in (("base", transformer_sharding_rules()),
                        ("fsdp", transformer_fsdp_rules())):
        init_state, train_step = port_train.make_train_step(
            lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
            param_rules=rules)
        state = init_state(params_from_jax(jax.device_get(params), "cpu"))
        state, runs[name] = _port_steps(train_step, state, tokens, tokens, 2)
        shards = [s for leaf in port_train.tree_leaves(state.params)
                  for s in leaf.shards]
        for shard in shards:
            moments = state.opt_state.state[shard]
            assert moments["exp_avg"].shape == shard.shape
            assert moments["exp_avg_sq"].shape == shard.shape
        # parameters and moments held by mesh device 0
        sizes[name] = sum(3 * leaf.shards[0].numel()
                          for leaf in port_train.tree_leaves(state.params))
        if name == "fsdp":
            assert state.params["embed"].spec == P("tp", "dp")
            wq = state.params["layers"][0]["attn"]["wq"]
            assert wq.spec == P("dp", "tp", None)
            assert wq.shards[0].shape == (16, 2, 8)
            fsdp_state = state
    np.testing.assert_allclose(runs["fsdp"], runs["base"], rtol=FSDP_RTOL,
                               atol=FSDP_ATOL)
    assert sizes["fsdp"] < sizes["base"]
    jax_state, jax_losses = _jax_steps(
        jmesh, jax_fsdp_rules(), lambda p, t: jax_apply(p, t, jax_cfg),
        params, tokens, tokens, 2)
    np.testing.assert_allclose(runs["fsdp"], jax_losses, rtol=LOSS_RTOL)
    _assert_params_close(fsdp_state.params, jax_state.params)


def test_moe_transformer_dp_tp_training_equals_jax():
    """The MoE transformer (every 2nd MLP 4 experts, top-2, experts over
    tp) at dp=2 x tp=2: three steps of CE + 0.01 aux against JAX's
    sharded step, remat on."""
    jax_cfg, cfg = _configs(**MOE_MODEL, remat=True)
    params = jax_init(jax.random.PRNGKey(3), jax_cfg)
    tokens, targets = _batch(3)
    jmesh, mesh = _meshes(dp=2, tp=2)
    jax_state, jax_losses = _jax_steps(
        jmesh, jax_rules(), lambda p, t: jax_apply_with_aux(p, t, jax_cfg),
        params, tokens, targets, 3,
        optimizer=optax.adamw(1e-3, eps=MOE_ADAM_EPS),
        loss_fn=_with_aux(jax_ce))
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply_with_aux(p, t, cfg), mesh=mesh,
        param_rules=transformer_sharding_rules(),
        optimizer=port_train.adamw(1e-3, eps=MOE_ADAM_EPS),
        loss_fn=_with_aux(port_train.cross_entropy_loss))
    state = init_state(params_from_jax(jax.device_get(params), "cpu"))
    assert state.params["layers"][1]["moe"]["w_in"].spec == P("tp", None,
                                                              None)
    state, losses = _port_steps(train_step, state, tokens, targets, 3)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    _assert_params_close(state.params, jax_state.params)


def test_train_state_from_jax_over_a_mesh_continues_the_run():
    jax_cfg, cfg = _configs(**DENSE)
    params = jax_init(jax.random.PRNGKey(4), jax_cfg)
    tokens, targets = _batch(4)
    jmesh, mesh = _meshes(dp=2, tp=2, sp=2)
    rules = transformer_fsdp_rules()
    init, step = jax_make_train_step(lambda p, t: jax_apply(p, t, jax_cfg),
                                     mesh=jmesh, param_rules=jax_fsdp_rules(),
                                     donate_state=False)
    place = jax_mesh.batch_sharding(jmesh, ndim=2)
    jt = jax.device_put(jnp.asarray(tokens), place)
    jy = jax.device_put(jnp.asarray(targets), place)
    jax_state, _ = step(init(params), jt, jy)
    adam = jax.device_get(jax_state.opt_state[0])
    state = train_state_from_jax(jax.device_get(jax_state.params), adam.mu,
                                 adam.nu, adam.count, mesh=mesh,
                                 param_rules=rules)
    wq = state.params["layers"][0]["attn"]["wq"]
    assert wq.spec == P("dp", "tp", None) and state.step == 1
    # each shard's moments are its slice of optax's
    np.testing.assert_array_equal(
        state.opt_state.state[wq.shards[0]]["exp_avg"].numpy(),
        adam.mu["layers"][0]["attn"]["wq"][:16, :2])
    jax_state, jax_loss = step(jax_state, jt, jy)
    _, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=rules)
    state, (loss,) = _port_steps(train_step, state, tokens, targets, 1)
    np.testing.assert_allclose(loss, float(jax_loss), rtol=LOSS_RTOL)
    _assert_params_close(state.params, jax_state.params)


# ---------------------------------------------------------------------------
# moe_apply under moe_sharding_rules
# ---------------------------------------------------------------------------

def _moe_loss(out, aux):
    x = out.gather() if isinstance(out, ShardedTensor) else out
    return (x ** 2).mean() + 0.01 * aux


def _moe_case(seed, capacity_factor, routing="tokens_choose",
              dispatch="scatter"):
    kw = dict(d_model=16, d_ff=32, num_experts=4, top_k=2,
              capacity_factor=capacity_factor, routing=routing)
    jax_cfg = jax_moe.MoEConfig(**kw, dispatch=dispatch)
    cfg = moe.MoEConfig(**kw, dispatch=dispatch)
    params = jax.device_get(jax_moe.moe_init(jax.random.PRNGKey(seed),
                                             jax_cfg))
    x = np.random.default_rng(seed).standard_normal((8, 4, 16)).astype(
        np.float32)
    return jax_cfg, cfg, params, x


def _port_sharded_moe(cfg, params, x, mesh, ep_axis):
    placed = shard_params(params_from_jax(params, "cpu"),
                          moe.moe_sharding_rules(ep_axis), mesh, copy=True)
    for leaf in placed.values():
        for shard in leaf.shards:
            shard.requires_grad_(True)
    out, aux = moe.moe_apply(placed, device_put(torch.from_numpy(x),
                                                batch_sharding(mesh, 3)), cfg)
    loss = _moe_loss(out, aux)
    loss.backward()
    spmd.sum_copies(placed.values())
    grads = {name: leaf.grad.gather().numpy()
             for name, leaf in placed.items()}
    return float(loss.detach()), out, grads, placed


def _port_unsharded_moe(cfg, params, x):
    tree = params_from_jax(params, "cpu")
    for leaf in tree.values():
        leaf.requires_grad_(True)
    out, aux = moe.moe_apply(tree, torch.from_numpy(x), cfg)
    loss = _moe_loss(out, aux)
    loss.backward()
    return float(loss.detach()), out, {k: v.grad.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("axes,ep_axis,routing,dispatch", [
    (dict(dp=4, tp=2), "dp", "tokens_choose", "scatter"),
    (dict(dp=2, ep=2, tp=2), "ep", "tokens_choose", "scatter"),
    (dict(dp=2, ep=2, tp=2), "ep", "tokens_choose", "einsum"),
    (dict(dp=2, ep=2, tp=2), "ep", "experts_choose", "scatter"),
    (dict(dp=4, tp=2), "dp", "experts_choose", "einsum"),
], ids=["dp_scatter", "ep_scatter", "ep_einsum", "ep_experts_choose",
        "dp_experts_choose_einsum"])
def test_expert_parallel_moe_equals_unsharded_and_jax(axes, ep_axis, routing,
                                                      dispatch):
    """tests/test_parallel_extra.py's expert-parallel cases: loss and
    gradients equal the unsharded port and JAX's sharded computation."""
    jax_cfg, cfg, params, x = _moe_case(0, 8.0, routing, dispatch)
    jmesh, mesh = _meshes(**axes)

    def jax_loss(p, x):
        out, aux = jax_moe.moe_apply(p, x, jax_cfg)
        return jnp.mean(out ** 2) + 0.01 * aux

    jp = jax_mesh.shard_params(params, jax_moe.moe_sharding_rules(ep_axis),
                               jmesh)
    jx = jax.device_put(jnp.asarray(x), jax_mesh.batch_sharding(jmesh, 3))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jp, jx)

    loss, out, grads, placed = _port_sharded_moe(cfg, params, x, mesh,
                                                 ep_axis)
    assert placed["w_in"].spec == P(ep_axis, None, None)
    assert out.spec[0] == batch_sharding(mesh, 3).spec[0]
    base_loss, base_out, base_grads = _port_unsharded_moe(cfg, params, x)
    torch.testing.assert_close(out.gather(), base_out.detach(), rtol=0,
                               atol=0)
    for ref_loss, ref_grads in ((base_loss, base_grads),
                                (float(want_loss),
                                 jax.device_get(want_grads))):
        np.testing.assert_allclose(loss, ref_loss, rtol=MOE_LOSS_RTOL,
                                   atol=1e-6)
        for key in ("router", "w_in", "w_out"):
            np.testing.assert_allclose(grads[key], ref_grads[key],
                                       rtol=MOE_GRAD_RTOL,
                                       atol=MOE_GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_capacity_binding_moe_routes_the_global_batch(dispatch):
    """Capacity factor 1.0 with the tokens piled onto two experts: the
    experts overflow, and which choices drop depends on the whole batch.
    The sharded layer equals the unsharded one; running moe_apply on each
    unit's rows alone (local capacity, local slot order) does not."""
    jax_cfg, cfg, params, x = _moe_case(5, 1.0, dispatch=dispatch)
    # bias the router so most tokens pick experts 0 and 1 first
    params["router"] = params["router"] + np.array(
        [3.0, 2.5, 0.0, 0.0], np.float32) * 0.2
    x = x + 1.0
    _, mesh = _meshes(dp=2, ep=2, tp=2)
    loss, out, grads, _ = _port_sharded_moe(cfg, params, x, mesh, "ep")
    base_loss, base_out, base_grads = _port_unsharded_moe(cfg, params, x)
    _, index, _, kept, _ = moe.tokens_choose_routing(
        moe.router_probs(params_from_jax(params, "cpu"),
                         torch.from_numpy(x).reshape(-1, 16)),
        2, moe.moe_capacity(cfg, 32))
    assert int(kept.sum()) < 2 * 32  # the capacity binds: choices drop
    torch.testing.assert_close(out.gather(), base_out.detach(), rtol=0,
                               atol=0)
    np.testing.assert_allclose(loss, base_loss, rtol=MOE_LOSS_RTOL)
    for key in grads:
        np.testing.assert_allclose(grads[key], base_grads[key],
                                   rtol=MOE_GRAD_RTOL, atol=MOE_GRAD_ATOL)
    jax_out, _ = jax_moe.moe_apply(params, jnp.asarray(x), jax_cfg)
    np.testing.assert_allclose(out.gather().detach().numpy(),
                               np.asarray(jax_out), rtol=1e-5, atol=1e-6)
    per_unit = torch.cat([moe.moe_apply(params_from_jax(params, "cpu"),
                                        torch.from_numpy(x[i:i + 2]), cfg)[0]
                          for i in range(0, 8, 2)])
    assert not torch.allclose(per_unit, base_out.detach(), atol=1e-3)


# ---------------------------------------------------------------------------
# the errors
# ---------------------------------------------------------------------------

def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


@pytest.mark.parametrize("case", ["vocab_over_tp", "fsdp_d_model_over_dp"])
def test_a_non_dividing_axis_raises_jax_message(case):
    kw = (dict(DENSE, vocab_size=63) if case == "vocab_over_tp"
          else dict(DENSE, d_model=36, n_heads=4, n_kv_heads=2))
    jax_cfg, cfg = _configs(**kw)
    rules, jrules, axes = ((transformer_sharding_rules(), jax_rules(),
                            dict(dp=2, tp=2, sp=2))
                           if case == "vocab_over_tp" else
                           (transformer_fsdp_rules(), jax_fsdp_rules(),
                            dict(dp=8)))
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    jmesh, mesh = _meshes(**axes)
    want = _message(lambda: jax_mesh.shard_params(params, jrules, jmesh))
    init_state, _ = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=rules)
    assert _message(lambda: init_state(params_from_jax(params, "cpu"))) \
        == want


def test_an_apply_fn_that_is_not_mesh_aware_raises_type_error():
    # prefill runs on one device (sharded serving is serving.sharded);
    # the message names the mesh-aware entry points
    jax_cfg, cfg = _configs(**DENSE)
    _, mesh = _meshes(dp=2)
    init_state, train_step = port_train.make_train_step(
        lambda p, t: prefill(p, cfg, t)[1], mesh=mesh, param_rules={})
    state = init_state(params_from_jax(jax.device_get(jax_init(
        jax.random.PRNGKey(0), jax_cfg)), "cpu"))
    with pytest.raises(TypeError, match="prefill runs on one device") as info:
        train_step(state, torch.zeros((4, 16), dtype=torch.long),
                   torch.zeros((4,), dtype=torch.long))
    for name in ("transformer_apply", "mnist_apply", "resnet_apply",
                 "moe_apply"):
        assert name in str(info.value)
    assert "10b" not in str(info.value)


def test_a_sequence_split_batch_is_not_ported():
    # (named when the split was refused) a batch placed split along the
    # sequence now trains: the sharded program runs the ring over sp, and
    # the step's loss and parameters equal JAX's GSPMD step on tokens
    # placed by batch_sharding(mesh, 2, seq_axis=1)
    jax_cfg, cfg = _configs(**DENSE)
    jmesh, mesh = _meshes(dp=2, tp=2, sp=2)
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    tokens, targets = _batch(7)
    init, step = jax_make_train_step(
        lambda p, t: jax_apply(p, t, jax_cfg), mesh=jmesh,
        param_rules=jax_rules(), donate_state=False)
    split = jax_mesh.batch_sharding(jmesh, 2, seq_axis=1)
    jstate, jloss = step(init(params), *(jax.device_put(jnp.asarray(x), split)
                                         for x in (tokens, targets)))
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=transformer_sharding_rules())
    state = init_state(params_from_jax(params, "cpu"))
    placed = [device_put(torch.from_numpy(x).long(),
                         batch_sharding(mesh, 2, seq_axis=1))
              for x in (tokens, targets)]
    assert placed[0].spec == P("dp", "sp")
    state, loss = train_step(state, *placed)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_replicas_equal(state.params)
    _assert_params_close(state.params, jstate.params)


def test_capture_refuses_the_cpu_and_distinct_cards():
    _, cfg = _configs(**DENSE)
    params = params_from_jax(jax.device_get(jax_init(
        jax.random.PRNGKey(0), _configs(**DENSE)[0])), "cpu")
    _, mesh = _meshes(dp=2, tp=2)
    init_state, _ = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=transformer_sharding_rules(), capture=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        init_state(params)
    cards = make_mesh(MeshSpec(dp=2, tp=2), devices=[
        torch.device("cuda", i) for i in range(4)])
    with pytest.raises(ValueError, match="one card"):
        port_train.make_train_step(
            lambda p, t: transformer_apply(p, t, cfg), mesh=cards,
            param_rules=transformer_sharding_rules(), capture=True)
