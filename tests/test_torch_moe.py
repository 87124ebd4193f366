"""Port parity: kubeshare_tpu_torch.ops.moe and the MoE half of the model
against the JAX package on the CPU.

The same numpy-seeded inputs and JAX-initialised weights (converted with
``convert.params_from_jax``) go through JAX's ``moe_apply`` /
``transformer_apply_with_aux`` / ``make_train_step`` and the port's, at
f32: outputs, aux losses and gradients agree to 1e-5 in every routing x
dispatch x top_k case, with the derived capacity (choices dropped) and
with an override; JAX's own MoE cases (tests/test_parallel_extra.py
TestMoE, tests/test_compute.py TestMoEFlagship and TestMoECapacity) hold
on the port; expert-choice ties (duplicated token rows) break as
``jax.lax.top_k`` breaks them; every cached path refuses expert-choice
routing with JAX's message."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeshare_tpu.models import decoding as jax_decoding
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import \
    transformer_apply_with_aux as jax_apply_with_aux
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.ops import moe as jax_moe
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_ce
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax, train_state_from_jax
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    transformer_apply,
    transformer_apply_with_aux,
    transformer_init,
)
from kubeshare_tpu_torch.ops import moe
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.serving import EngineConfig, Request, ServingEngine
from kubeshare_tpu_torch.serving import paged
from kubeshare_tpu_torch.serving.kv_blocks import init_paged_pool

torch.set_num_threads(1)

# f32 on both sides: only summation order differs
F32_TOL = 1e-5
# three AdamW steps: tests/test_torch_train.py's bound and reason.  The
# MoE models' steps run AdamW with eps 1e-5 in both packages.  Adam's
# first step is lr * g / (|g| + eps), whose slope in g peaks at lr / eps
# as g -> 0, so a gradient difference dg between the frameworks moves a
# weight by up to lr * dg / eps.  The packages' gradients differ by
# round-off of up to ~5e-9 on weights whose gradient cancels to ~1e-7
# (found on these models: one weight's first step differed by 1.3e-5 at
# optax's default eps 1e-8 and by 5e-6 at 1e-6); at 1e-5 the bound is
# 5e-7, a tenth of PARAM_ATOL, while gradients of 1e-4 and more (nearly
# all of them) still take Adam's normalised steps
PARAM_ATOL = 5e-6
ADAM_EPS = 1e-5
OP = dict(d_model=16, d_ff=32, num_experts=4, capacity_factor=1.5)
# TestMoEFlagship's model, at the default capacity factor (choices drop)
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq_len=32, moe_every=2, moe_num_experts=4)


def op_case(seed=0, shape=(2, 8, 16), **overrides):
    """(JAX config, port config, JAX params, port params, x as numpy)."""
    kw = {**OP, **overrides}
    jax_cfg, cfg = jax_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jax_cfg)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    return jax_cfg, cfg, jp, params_from_jax(jax.device_get(jp), "cpu"), x


def assert_close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# the JAX side jitted (configs static): one compile a shape and config
# instead of one a primitive
JAX_MOE = jax.jit(jax_moe.moe_apply, static_argnums=(2, 3))
JAX_PREFILL = jax.jit(jax_decoding.prefill, static_argnums=1)
JAX_GREEDY = jax.jit(jax_decoding.greedy_decode, static_argnums=(1, 3))

ROUTINGS = ["tokens_choose", "experts_choose"]
DISPATCHES = ["scatter", "einsum"]


@pytest.mark.parametrize("capacity", [None, 3], ids=["derived", "override"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_moe_apply_matches_jax(routing, dispatch, top_k, capacity):
    jax_cfg, cfg, jp, tp, x = op_case(top_k=top_k, routing=routing,
                                      dispatch=dispatch)
    want, want_aux = JAX_MOE(jp, jnp.asarray(x), jax_cfg, capacity)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, capacity)
    assert got.dtype == torch.float32 and aux.shape == ()
    assert_close(got, want)
    assert_close(aux, want_aux)
    if capacity == 3 and routing == "tokens_choose" and top_k == 1:
        # 4 experts x 3 slots for 16 tokens: at least 4 rows dropped
        assert int((got.abs().sum(dim=-1) == 0).sum()) >= 4


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_moe_grads_match_jax(routing, dispatch, top_k):
    jax_cfg, cfg, jp, tp, x = op_case(top_k=top_k, routing=routing,
                                      dispatch=dispatch, capacity_factor=1.25)

    def jax_loss(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, jax_cfg)
        return jnp.mean(out ** 2) + 0.01 * aux

    want_p, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    leaves = {name: t.clone().requires_grad_() for name, t in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_apply(leaves, xt, cfg)
    (torch.mean(out ** 2) + 0.01 * aux).backward()
    for name, leaf in leaves.items():
        assert_close(leaf.grad, want_p[name])
    assert_close(xt.grad, want_x)
    if routing == "tokens_choose":
        # the router learns through the gates and the aux
        assert leaves["router"].grad.abs().sum() > 0


def test_moe_init_shapes_and_scales():
    cfg = moe.MoEConfig(d_model=64, d_ff=256, num_experts=8)
    params = moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), jax_moe.MoEConfig(
        d_model=64, d_ff=256, num_experts=8))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for name, fan_in in (("router", 64), ("w_in", 64), ("w_out", 256)):
        assert params[name].dtype == torch.float32
        assert abs(float(params[name].std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    again = moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def _dense_reference(params, x, k):
    """Every expert densely, then the top-k mixture (TestMoE's closed
    form when nothing drops)."""
    n, d = x.shape[0] * x.shape[1], x.shape[-1]
    tokens = x.reshape(n, d)
    probs = torch.softmax(tokens @ params["router"], dim=-1)
    gate, idx = moe._top_k(probs, k)
    if k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    hidden = torch.nn.functional.gelu(
        torch.einsum("nd,edf->enf", tokens, params["w_in"]), approximate="tanh")
    outs = torch.einsum("enf,efd->end", hidden, params["w_out"])
    rows = torch.arange(n)
    out = sum(gate[:, j, None] * outs[idx[:, j], rows] for j in range(k))
    return out.reshape(x.shape)


def _biased(x_shape, d, e, router_row, seed=1, capacity_factor=1.0, top_k=2,
            dispatch="scatter"):
    """A router hard-biased towards expert 0, then expert 1, and positive
    tokens (TestMoE's overflow cases), in both packages."""
    kw = dict(d_model=d, d_ff=8, num_experts=e,
              capacity_factor=capacity_factor, top_k=top_k)
    jp = dict(jax_moe.moe_init(jax.random.PRNGKey(0), jax_moe.MoEConfig(**kw)))
    jp["router"] = jnp.asarray(np.array([router_row] * d, np.float32))
    x = np.abs(np.random.default_rng(seed).standard_normal(x_shape)
               ).astype(np.float32) + 0.1
    return (jax_moe.MoEConfig(**kw), moe.MoEConfig(dispatch=dispatch, **kw),
            jp, params_from_jax(jax.device_get(jp), "cpu"), x)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_top2_overflow_drops_second_choices_first(dispatch):
    jax_cfg, cfg, jp, tp, x = _biased((1, 6, 4), 4, 2, [4.0, 2.0],
                                      dispatch=dispatch)
    xt = torch.from_numpy(x)
    # capacity 6 fits all six first and all six second choices
    full, _ = moe.moe_apply(tp, xt, cfg, capacity=6)
    torch.testing.assert_close(full, _dense_reference(tp, xt, 2),
                               rtol=F32_TOL, atol=F32_TOL)
    # capacity 3: first choices past 3 drop, no kept gate is reweighted
    small, _ = moe.moe_apply(tp, xt, cfg, capacity=3)
    assert_close(small, JAX_MOE(jp, jnp.asarray(x), jax_cfg, 3)[0])
    kept_rows = (small[0] != 0).any(dim=-1)
    assert int(kept_rows.sum()) >= 3


def test_derived_capacity_includes_k():
    # top_k=2, e=2, n=8, cf=1.0 -> capacity ceil(1.0*2*8/2) = 8: nothing
    # drops although every choice rank is maximally unbalanced
    _, cfg, _, tp, x = _biased((1, 8, 4), 4, 2, [4.0, 2.0])
    xt = torch.from_numpy(x)
    out, _ = moe.moe_apply(tp, xt, cfg)
    torch.testing.assert_close(out, _dense_reference(tp, xt, 2),
                               rtol=F32_TOL, atol=F32_TOL)


def test_capacity_rounds_up():
    # all 5 tokens to expert 0 with cf=1.0, e=4 -> capacity ceil(5/4) = 2
    router = [100.0, 0.0, 0.0, 0.0]
    jax_cfg, cfg, jp, tp, x = _biased((1, 5, 8), 8, 4, router, top_k=1)
    out, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert int((out[0].abs().sum(dim=-1) > 0).sum()) == 2
    assert_close(out, JAX_MOE(jp, jnp.asarray(x), jax_cfg, None)[0])


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_experts_choose_breaks_ties_like_jax(dispatch):
    # eight distinct rows, each twice: every expert's affinities tie in
    # pairs, and capacity 5 cuts through a pair, so which copy an expert
    # keeps decides the output
    jax_cfg, cfg, jp, tp, _ = op_case(routing="experts_choose",
                                      dispatch=dispatch)
    rows = np.random.default_rng(9).standard_normal((8, 16)).astype(np.float32)
    x = np.repeat(rows, 2, axis=0)[None]  # (1, 16, 16)
    want, _ = JAX_MOE(jp, jnp.asarray(x), jax_cfg, 5)
    got, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg, 5)
    assert_close(got, want)
    # the copies of a row came out differently: a tie was cut
    out = got[0].detach().numpy()
    assert (np.abs(out[0::2] - out[1::2]).max(axis=-1) > 1e-3).any()


def test_experts_choose_full_capacity_is_soft_mixture():
    _, cfg, _, tp, x = op_case(routing="experts_choose")
    xt = torch.from_numpy(x)
    out, aux = moe.moe_apply(tp, xt, cfg, capacity=16)
    assert float(aux) == 0.0  # balanced by construction: no aux loss
    tokens = xt.reshape(16, 16)
    probs = torch.softmax(tokens @ tp["router"], dim=-1)
    hidden = torch.nn.functional.gelu(
        torch.einsum("nd,edf->enf", tokens, tp["w_in"]), approximate="tanh")
    outs = torch.einsum("enf,efd->end", hidden, tp["w_out"])
    want = torch.einsum("ne,end->nd", probs, outs).reshape(x.shape)
    torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("overrides,capacity", [
    (dict(top_k=0), None), (dict(top_k=-1), None), (dict(top_k=5), None),
    (dict(routing="coin_flip"), None), (dict(dispatch="bogus"), None),
    ({}, 0),
])
def test_value_errors_match_jax(overrides, capacity):
    jax_cfg, cfg, jp, tp, x = op_case(**overrides)
    want = _message(lambda: jax_moe.moe_apply(jp, jnp.asarray(x), jax_cfg,
                                              capacity))
    assert _message(lambda: moe.moe_apply(tp, torch.from_numpy(x), cfg,
                                          capacity)) == want


def model_case(seed=0, **overrides):
    kw = {**MODEL, "attention": "reference", **overrides}
    jax_cfg = JaxConfig(dtype=jnp.float32, **kw)
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    jp = jax_init(jax.random.PRNGKey(seed), jax_cfg)
    return jax_cfg, cfg, jp, params_from_jax(jax.device_get(jp), "cpu")


def tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], shape).astype(np.int32)


def test_init_places_moe_layers_and_the_module_keys():
    _, cfg, jp, _ = model_case()
    params = transformer_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ["moe" if "moe" in layer else "mlp" for layer in params["layers"]] \
        == ["mlp", "moe", "mlp", "moe"]
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    model = Transformer(cfg, params)
    keys = set(model.state_dict())
    assert {"layers.1.moe.router", "layers.1.moe.w_in", "layers.1.moe.w_out",
            "layers.0.mlp.w_in"} <= keys
    assert not any(k.startswith("layers.1.mlp") for k in keys)
    toks = torch.from_numpy(tokens((1, 8)))
    with torch.no_grad():
        torch.testing.assert_close(model(toks),
                                   transformer_apply(model.tree(), toks, cfg))
    with pytest.raises(ValueError, match="moe_every must be >= 1"):
        transformer_init(dataclasses.replace(cfg, moe_every=0),
                         torch.Generator(), device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(moe_top_k=2, positional="rope", remat=True),
    dict(moe_routing="experts_choose", moe_dispatch="einsum",
         moe_capacity_factor=2.0),
], ids=["top2_rope_remat", "experts_choose_einsum"])
def test_apply_with_aux_and_grads_match_jax(overrides):
    jax_cfg, cfg, jp, tp = model_case(**overrides)
    toks, targets = tokens((2, 16)), tokens((2, 16), seed=2)

    def jax_loss(p):
        logits, aux = jax_apply_with_aux(p, jnp.asarray(toks), jax_cfg)
        return jax_ce(logits, jnp.asarray(targets)) + 0.01 * aux, (logits, aux)

    (_, (want, want_aux)), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jp)
    leaves = port_train.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    logits, aux = transformer_apply_with_aux(tp, torch.from_numpy(toks), cfg)
    assert_close(logits, want)
    assert_close(aux, want_aux)
    if cfg.moe_routing == "tokens_choose":
        assert float(aux.detach()) > 0.0  # two MoE layers add load-balance loss
    else:
        assert float(aux.detach()) == 0.0
    loss = port_train.cross_entropy_loss(logits, torch.from_numpy(targets))
    grads = torch.autograd.grad(loss + 0.01 * aux, leaves)
    want_leaves = jax.tree.leaves(jax.device_get(want_grads))
    assert len(want_leaves) == len(grads)
    for got, ref in zip(grads, want_leaves):
        assert_close(got, ref)
    router_grad = grads[[i for i, (path, _) in enumerate(
        port_train.tree_leaves_with_paths(tp)) if path[-1] == "router"][0]]
    assert router_grad.abs().sum() > 0
    # transformer_apply is the same forward without the aux
    with torch.no_grad():
        torch.testing.assert_close(
            transformer_apply(tp, torch.from_numpy(toks), cfg), logits.detach(),
            rtol=0, atol=0)


def test_remat_grads_equal_plain_grads():
    _, cfg, _, tp = model_case(moe_top_k=2, positional="rope")
    toks, targets = (torch.from_numpy(a) for a in (tokens((2, 16)),
                                                    tokens((2, 16), seed=3)))
    leaves = port_train.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    grads = {}
    for remat in (False, True):
        logits, aux = transformer_apply_with_aux(
            tp, toks, dataclasses.replace(cfg, remat=remat))
        loss = port_train.cross_entropy_loss(logits, targets) + 0.01 * aux
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_prefill_pins_the_capacity_and_decodes_like_jax():
    # TestMoEFlagship: decode equals the dense forward where nothing drops
    # (cf 8), and prefill + greedy decode equal JAX's at the default cf
    jax_cfg, cfg, jp, tp = model_case(moe_top_k=2)
    prompt = tokens((2, 10), seed=3)
    want_cache, want_last = JAX_PREFILL(jp, jax_cfg, jnp.asarray(prompt))
    cache, last = decoding.prefill(tp, cfg, torch.from_numpy(prompt))
    assert_close(last, want_last)
    for name in ("k", "v"):
        assert_close(cache[name], want_cache[name])
    want = JAX_GREEDY(jp, jax_cfg, jnp.asarray(prompt), 6)
    got = decoding.greedy_decode(tp, cfg, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ample = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    dense = transformer_apply(tp, torch.from_numpy(prompt), ample)
    _, incremental = decoding.prefill_incremental(tp, ample,
                                                  torch.from_numpy(prompt))
    torch.testing.assert_close(dense[:, -1], incremental, rtol=2e-4, atol=2e-4)


def test_decode_batch_independent_at_default_capacity():
    # batch 4 over 4 experts: some step routes two rows to one expert,
    # which a factor-derived capacity would drop
    _, cfg, _, tp = model_case()
    prompt = torch.from_numpy(tokens((4, 8), seed=7))
    _, batched = decoding.prefill_incremental(tp, cfg, prompt)
    for row in range(4):
        _, single = decoding.prefill_incremental(tp, cfg, prompt[row:row + 1])
        torch.testing.assert_close(batched[row:row + 1], single,
                                   rtol=2e-4, atol=2e-4)


def test_experts_choose_refuses_every_cached_path():
    jax_cfg, cfg, jp, tp = model_case(moe_routing="experts_choose")
    prompt = tokens((2, 12), seed=9)
    want = _message(lambda: jax_decoding.prefill(jp, jax_cfg,
                                                 jnp.asarray(prompt)))
    assert "expert-choice" in want
    p = torch.from_numpy(prompt)
    pool = init_paged_pool(cfg, 4, 4, "cpu")
    calls = [
        lambda: decoding.prefill(tp, cfg, p),
        lambda: decoding.prefill_chunked(tp, cfg, p, 4),
        lambda: decoding.greedy_decode(tp, cfg, p, 2),
        lambda: decoding.make_decode_step(tp, cfg, 2, capture=False)(
            decoding.init_kv_cache(cfg, 2, "cpu"), p[:, 0]),
        lambda: paged.paged_decode_step(
            tp, cfg, pool.k, pool.v, torch.zeros((1, 2), dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.bool),
            torch.zeros(1, dtype=torch.int64)),
    ]
    for call in calls:
        assert _message(call) == want
    engine = ServingEngine(tp, cfg, EngineConfig(
        num_slots=2, block_size=4, num_blocks=9, max_request_len=24,
        prefill_chunk=4), device="cpu")
    engine.submit(Request("r", prompt[0], 2))
    assert _message(engine.run) == want


def _train(step_fn, state, toks, targets, steps):
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, toks, targets)
        losses.append(float(loss))
    return state, losses


def _with_aux_loss(ce):
    return lambda out, targets: ce(out[0], targets) + 0.01 * out[1]


@pytest.mark.parametrize("overrides", [
    dict(moe_top_k=2),
    dict(moe_top_k=1, moe_dispatch="einsum", positional="rope"),
], ids=["top2_scatter", "top1_einsum_rope"])
def test_train_steps_match_jax(overrides):
    jax_cfg, cfg, jp, tp = model_case(seed=1, **overrides)
    toks, targets = tokens((2, 16), seed=4), tokens((2, 16), seed=5)
    init, step = jax_make_train_step(
        lambda p, t: jax_apply_with_aux(p, t, jax_cfg),
        optimizer=optax.adamw(1e-3, eps=ADAM_EPS),
        loss_fn=_with_aux_loss(jax_ce), donate_state=False)
    jax_state, jax_losses = _train(step, init(jp), jnp.asarray(toks),
                                   jnp.asarray(targets), 3)
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply_with_aux(p, t, cfg),
        optimizer=port_train.adamw(1e-3, eps=ADAM_EPS),
        loss_fn=_with_aux_loss(port_train.cross_entropy_loss))
    state, losses = _train(train_step, init_state(tp), torch.from_numpy(toks),
                           torch.from_numpy(targets), 3)
    np.testing.assert_allclose(losses, jax_losses, rtol=F32_TOL)
    assert losses[-1] < losses[0]
    want = dict(port_train.tree_leaves_with_paths(jax.device_get(
        jax_state.params)))
    for path, leaf in port_train.tree_leaves_with_paths(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


def test_train_state_from_jax_carries_the_moe_subtree():
    jax_cfg, cfg, jp, _ = model_case(seed=2, moe_top_k=2)
    toks, targets = tokens((2, 16), seed=6), tokens((2, 16), seed=7)
    init, step = jax_make_train_step(lambda p, t: jax_apply(p, t, jax_cfg),
                                     donate_state=False)
    jax_state, _ = _train(step, init(jp), jnp.asarray(toks),
                          jnp.asarray(targets), 2)
    adam = jax.device_get(jax_state.opt_state[0])
    state = train_state_from_jax(jax.device_get(jax_state.params), adam.mu,
                                 adam.nu, adam.count, device="cpu")
    jax_state, (jax_loss,) = _train(step, jax_state, jnp.asarray(toks),
                                    jnp.asarray(targets), 1)
    _, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg))
    state, (loss,) = _train(train_step, state, torch.from_numpy(toks),
                            torch.from_numpy(targets), 1)
    np.testing.assert_allclose(loss, jax_loss, rtol=F32_TOL)
    w_in = state.params["layers"][1]["moe"]["w_in"]
    np.testing.assert_allclose(
        w_in.detach().numpy(), np.asarray(jax_state.params["layers"][1]["moe"]["w_in"]),
        rtol=0, atol=PARAM_ATOL)
    moments = state.opt_state.state[w_in]
    np.testing.assert_allclose(
        moments["exp_avg"].numpy(),
        jax.device_get(jax_state.opt_state[0]).mu["layers"][1]["moe"]["w_in"],
        rtol=1e-4, atol=1e-7)
    assert float(moments["step"]) == 3
