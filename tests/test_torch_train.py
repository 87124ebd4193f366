"""Port parity: kubeshare_tpu_torch.parallel.train (loss, autograd and
AdamW) against the JAX package's make_train_step (optax.adamw(1e-3)) on
the CPU, at f32 on the small config of test_torch_transformer.py, with the
JAX weights and optimizer state converted 1:1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_loss
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax, train_state_from_jax
from kubeshare_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    transformer_apply,
)
from kubeshare_tpu_torch.parallel import train as port_train

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)
# f32 end to end: the loss differs only by summation order
LOSS_RTOL = 1e-5
# parameters after three AdamW steps of lr 1e-3: each step moves a weight
# by up to ~lr, and Adam's m / (sqrt(v) + eps) can turn round-off in a
# near-zero gradient into a difference of a sizeable fraction of that
# step, so the bound sits well above the frameworks' round-off (a few
# 1e-7 on these cases) yet below the ~3e-5 that torch's own default
# weight decay (1e-2 in place of optax's 1e-4) leaves after three steps
PARAM_ATOL = 5e-6


def _configs(**overrides):
    kw = {**SMALL, **overrides}
    attention = kw.pop("attention", "reference")
    jax_cfg = JaxConfig(dtype=jnp.float32, attention="reference", **kw)
    torch_cfg = TransformerConfig(dtype=torch.float32, attention=attention,
                                  **kw)
    return jax_cfg, torch_cfg


def _batch(seed=0, shape=(2, 24)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SMALL["vocab_size"], shape).astype(np.int32)
    targets = rng.integers(0, SMALL["vocab_size"], shape).astype(np.int32)
    return tokens, targets


def _flat(tree):
    return {path: leaf for path, leaf in port_train.tree_leaves_with_paths(tree)}


def _assert_params_close(torch_tree, jax_tree):
    got = _flat(torch_tree)
    want = _flat(jax.device_get(jax_tree))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(), leaf,
                                   rtol=0, atol=PARAM_ATOL, err_msg=str(path))


def _jax_run(jax_cfg, params, tokens, targets, steps):
    init_state, step = jax_make_train_step(
        lambda p, t: jax_apply(p, t, jax_cfg), donate_state=False)
    state = init_state(params)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    return state, losses


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = port_train.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 logits are taken to f32 before the log-softmax
    got_bf16 = port_train.cross_entropy_loss(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets))
    want_bf16 = float(jax_loss(jnp.asarray(logits, jnp.bfloat16),
                               jnp.asarray(targets)))
    np.testing.assert_allclose(float(got_bf16), want_bf16, rtol=1e-6)


@pytest.mark.parametrize("positional,n_kv_heads,attention,remat", [
    ("learned", None, "reference", False),
    ("rope", None, "flash", False),
    ("rope", 2, "flash", True),
    ("learned", 2, "reference", True),
    ("rope", 1, "reference", False),
    ("learned", None, "flash", True),
])
def test_train_steps_match_jax(positional, n_kv_heads, attention, remat):
    # the JAX side runs its reference attention (the CPU path); the port's
    # "flash" runs the kernels' plain versions (forward and backward)
    jax_cfg, torch_cfg = _configs(positional=positional,
                                  n_kv_heads=n_kv_heads, attention=attention,
                                  remat=remat)
    params = jax_init(jax.random.PRNGKey(1), jax_cfg)
    tokens, targets = _batch()
    jax_state, jax_losses = _jax_run(jax_cfg, params, tokens, targets, 3)

    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, torch_cfg))
    state = init_state(params_from_jax(jax.device_get(params), device="cpu"))
    losses = []
    for _ in range(3):
        state, loss = train_step(state, torch.from_numpy(tokens),
                                 torch.from_numpy(targets))
        assert loss.shape == () and not loss.requires_grad
        losses.append(float(loss))
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    _assert_params_close(state.params, jax_state.params)
    assert all(leaf.grad is None for leaf in port_train.tree_leaves(state.params))


def test_train_state_from_jax_continues_the_run():
    jax_cfg, torch_cfg = _configs(positional="rope", n_kv_heads=2,
                                  attention="flash")
    params = jax_init(jax.random.PRNGKey(2), jax_cfg)
    tokens, targets = _batch(seed=4)
    jax_state, jax_losses = _jax_run(jax_cfg, params, tokens, targets, 2)
    adam = jax.device_get(jax_state.opt_state[0])
    state = train_state_from_jax(jax.device_get(jax_state.params), adam.mu,
                                 adam.nu, adam.count, device="cpu")
    assert state.step == 2
    _, step = jax_make_train_step(lambda p, t: jax_apply(p, t, jax_cfg),
                                  donate_state=False)
    jax_state, jax_loss = step(jax_state, jnp.asarray(tokens),
                               jnp.asarray(targets))
    _, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, torch_cfg))
    state, loss = train_step(state, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=LOSS_RTOL)
    assert float(loss) < jax_losses[0]
    _assert_params_close(state.params, jax_state.params)
    # the moments went on from JAX's, not from zero
    adam3 = jax.device_get(jax_state.opt_state[0])
    wq = state.params["layers"][0]["attn"]["wq"]
    moments = state.opt_state.state[wq]
    np.testing.assert_allclose(moments["exp_avg"].numpy(),
                               adam3.mu["layers"][0]["attn"]["wq"],
                               rtol=1e-4, atol=1e-7)
    assert float(moments["step"]) == 3


def test_train_state_from_jax_refuses_mismatched_moments():
    jax_cfg, _ = _configs()
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    mu = jax.tree.map(np.zeros_like, params)
    nu = jax.tree.map(np.zeros_like, params)
    mu["lm_head"] = mu["lm_head"][:, :3]
    with pytest.raises(ValueError, match="exp_avg"):
        train_state_from_jax(params, mu, nu, 0, device="cpu")


@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_remat_grads_equal_plain_grads(attention):
    _, cfg = _configs(positional="rope", n_kv_heads=2, attention=attention)
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=5))
    model = Transformer.init(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    grads = {}
    for remat in (False, True):
        model.config = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        port_train.cross_entropy_loss(model(tokens), targets).backward()
        grads[remat] = [p.grad.clone() for p in model.parameters()]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_module_parameters_are_the_tree_tensors():
    # an optimizer over the module trains what transformer_apply reads
    _, cfg = _configs(positional="learned")
    model = Transformer.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tree_ids = {id(t) for t in port_train.tree_leaves(model.tree())}
    assert tree_ids == {id(p) for p in model.parameters()}
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg))
    state = init_state(model.tree())
    before = model.lm_head.detach().clone()
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=6))
    train_step(state, tokens, targets)
    assert not torch.equal(before, model.lm_head.detach())


def test_adamw_defaults_are_optax_defaults():
    opt = port_train.adamw()([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4
    assert not group["amsgrad"]


@pytest.mark.parametrize("kwargs", [{"mesh": object()},
                                    {"param_rules": {"wq": None}}])
def test_mesh_is_not_ported(kwargs):
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        port_train.make_train_step(lambda p, t: None, **kwargs)


def test_captured_step_refuses_the_cpu():
    _, cfg = _configs(positional="rope")
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), capture=True)
    assert isinstance(train_step, port_train.CapturedTrainStep)
    params = Transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu").tree()
    with pytest.raises(RuntimeError, match="CUDA device"):
        init_state(params)
    # a state built by the eager path does not get past the capture either
    eager_init, _ = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg))
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=7))
    with pytest.raises(RuntimeError, match="capture=False"):
        train_step(eager_init(params), tokens, targets)


def test_eager_path_is_unchanged_by_the_capture_option():
    _, cfg = _configs(positional="learned", attention="flash")
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=8))
    runs = []
    for kwargs in ({}, {"capture": False}):
        init_state, train_step = port_train.make_train_step(
            lambda p, t: transformer_apply(p, t, cfg), **kwargs)
        assert not isinstance(train_step, port_train.CapturedTrainStep)
        state = init_state(Transformer.init(
            cfg, torch.Generator().manual_seed(4), device="cpu").tree())
        assert not state.opt_state.param_groups[0]["capturable"]
        losses = []
        for _ in range(2):
            state, loss = train_step(state, tokens, targets)
            losses.append(float(loss))
        runs.append((losses, [p.detach().clone() for p in
                              port_train.tree_leaves(state.params)]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_capturable_adamw_keeps_optax_defaults():
    # the captured step switches the default optimizer to its capturable
    # mode and leaves optax's hyperparameters as they are
    opt = port_train.adamw()([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert not group["capturable"]
    port_train._make_capturable(opt, torch.device("cpu"))
    assert group["capturable"]
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4


def _adamw_run(leaves, opt, steps, seed):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        sum((leaf * torch.randn(leaf.shape, generator=gen)).sum()
            for leaf in leaves).backward()
        opt.step()


@pytest.mark.parametrize("steps_before", [0, 2])
def test_warmup_is_undone_before_the_captured_steps(steps_before):
    # the captured step snapshots the state, trains on its warm-up steps,
    # and puts the state back: the next step must be the one an untouched
    # state takes, whether the optimizer had state (a run carried on) or
    # none yet (a fresh run, whose lazily created moments go back to 0)
    def fresh():
        gen = torch.Generator().manual_seed(0)
        leaves = [torch.randn((3, 4), generator=gen).requires_grad_(),
                  torch.randn((5,), generator=gen).requires_grad_()]
        opt = port_train.adamw()(leaves)
        _adamw_run(leaves, opt, steps_before, seed=1)
        return leaves, opt

    leaves, opt = fresh()
    saved = port_train._snapshot(leaves, opt)
    _adamw_run(leaves, opt, 3, seed=2)  # the warm-up
    port_train._restore(leaves, opt, saved)
    _adamw_run(leaves, opt, 1, seed=3)
    ref_leaves, ref_opt = fresh()
    _adamw_run(ref_leaves, ref_opt, 1, seed=3)
    for got, want in zip(leaves, ref_leaves):
        assert torch.equal(got, want)
        for key, value in ref_opt.state[want].items():
            assert torch.equal(opt.state[got][key], value), key


def test_make_capturable_takes_a_state_carried_over_from_jax():
    jax_cfg, _ = _configs()
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    zeros = jax.tree.map(np.zeros_like, params)
    state = train_state_from_jax(params, zeros, zeros, 5, device="cpu")
    port_train._make_capturable(state.opt_state, torch.device("cpu"))
    assert state.opt_state.param_groups[0]["capturable"]
    steps = [entry["step"] for entry in state.opt_state.state.values()]
    assert steps and all(float(s) == 5 for s in steps)
    sgd = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
    with pytest.raises(TypeError, match="no capturable mode"):
        port_train._make_capturable(sgd, torch.device("cpu"))
