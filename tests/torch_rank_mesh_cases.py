"""The shared half of the mesh-of-ranks parity files for MoE and sequence
parallelism (``tests/test_torch_rank_mesh_moe.py``,
``tests/test_torch_rank_mesh_sp.py``): four gloo ranks started once a
file take three AdamW steps of each case, beside the port's
one-controller mesh over ``[cpu] * 4`` and the JAX package's sharded
step over four CPU devices (the conftest's host devices), at f32.

A case is plain data (mesh axes, the entry point, the model, the rules);
``BUILD`` turns it into the port's step, in the rank processes and in
the test's own.  A file adds its controls to the worker script after the
cases (``WORKER_HEAD`` + its code + ``WORKER_TAIL``) and reads them back
from every rank's record."""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from native_helpers import free_port

from kubeshare_tpu.models import transformer as jax_tf
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_ce
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)
MOE = dict(moe_every=2, moe_num_experts=4, moe_top_k=2)
AUX_COEF = 0.01
# the MoE steps run AdamW with eps 1e-5 in both packages, as
# tests/test_torch_mesh_train.py does and for its reason
MOE_ADAM_EPS = 1e-5
STEPS = 3
WORLD = 4
# f32 end to end; the programs sum the tp partial products, the ring's
# blocks and the copies' gradients in their own order
TOL = 1e-5
RANK_TIMEOUT_S = 150
BATCH = (4, 16)
WINDOW = 6


def case(axes, entry, model=None, jax_ref=False, rules="base", **kw):
    return dict(axes=axes, entry=entry, model=dict(MODEL, **(model or {})),
                jax=jax_ref, rules=rules, kw=kw)


DP_TP = dict(dp=2, tp=2)
DP_EP = dict(dp=2, ep=2)
DP_SP = dict(dp=2, sp=2)
TP_SP = dict(dp=1, tp=2, sp=2)
# the port's side of a case, for the ranks and the one-controller mesh
BUILD = """
    import torch
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply, transformer_apply_ring,
        transformer_apply_ulysses, transformer_apply_with_aux,
        transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel import train as T
    from kubeshare_tpu_torch.parallel.mesh import (P, batch_sharding,
                                                   device_put)

    def build(case, mesh, aux_coef, moe_eps):
        config = TransformerConfig(dtype=torch.float32,
                                   attention="reference", **case["model"])
        entry, kw = case["entry"], case["kw"]
        if entry == "with_aux":
            apply = lambda p, t: transformer_apply_with_aux(p, t, config)
        elif entry == "ring":
            apply = lambda p, t: transformer_apply_ring(p, t, config, mesh,
                                                        **kw)
        elif entry == "ring_aux":
            apply = lambda p, t: transformer_apply_ring(
                p, t, config, mesh, with_aux=True, **kw)
        elif entry == "ulysses":
            apply = lambda p, t: transformer_apply_ulysses(p, t, config,
                                                           mesh, **kw)
        else:
            apply = lambda p, t: transformer_apply(p, t, config)
        rules = transformer_sharding_rules()
        if case["rules"] == "ep":
            rules.update({"moe']['w_in": P("ep", None, None),
                          "moe']['w_out": P("ep", None, None)})
        moe = "moe_every" in case["model"]
        loss_fn = (T.CrossEntropyWithAux(aux_coef) if moe
                   else T.cross_entropy_loss)
        optimizer = T.adamw(1e-3, eps=moe_eps) if moe else None

        def place(tokens):
            if entry == "seq_split":
                return device_put(tokens, batch_sharding(mesh, 2, 1))
            return tokens

        return apply, rules, loss_fn, optimizer, place

    def train(case, mesh, params, tokens, targets, steps, aux_coef,
              moe_eps):
        apply, rules, loss_fn, optimizer, place = build(case, mesh,
                                                        aux_coef, moe_eps)
        init_state, train_step = T.make_train_step(
            apply, mesh=mesh, param_rules=rules, loss_fn=loss_fn,
            optimizer=optimizer)
        state = init_state(params)
        leaves = T.tree_leaves(state.params)
        grads = []
        # every rank runs the hook: the gathers inside it are collectives
        state.opt_state.register_step_pre_hook(lambda *_: grads.append(
            [leaf.grad.gather().numpy() for leaf in leaves])
            if not grads else None)
        losses = []
        for _ in range(steps):
            state, loss = train_step(state, place(tokens), targets)
            losses.append(float(loss))
        return state, losses, grads[0]
"""

WORKER_HEAD = BUILD + """
    import pickle, sys
    import numpy as np
    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.parallel import spmd
    from kubeshare_tpu_torch.parallel.distributed import initialize_from_env
    from kubeshare_tpu_torch.parallel.mesh import (
        MeshSpec, RankMesh, _shard_slices, make_mesh)

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    spec = initialize_from_env(device="cpu")
    rank = spec.process_id
    tokens, targets = (torch.from_numpy(inputs[k])
                       for k in ("tokens", "targets"))
    coef, eps = inputs["aux_coef"], inputs["moe_eps"]

    def run(name, steps=inputs["steps"]):
        case = inputs["cases"][name]
        mesh = make_mesh(MeshSpec(**case["axes"]), device="cpu")
        assert isinstance(mesh, RankMesh)
        params = params_from_jax(inputs["params"][case["model"].get(
            "moe_every") is not None], "cpu")
        return mesh, train(case, mesh, params, tokens, targets, steps,
                           coef, eps)

    record = {}
    for name in inputs["cases"]:
        mesh, (state, losses, grads) = run(name)
        shards = []
        for leaf in T.tree_leaves(state.params):
            [shard] = leaf.shards
            slices = _shard_slices(leaf.shape, leaf.spec, mesh)[mesh.position]
            shards.append((tuple((s.start, s.stop) for s in slices),
                           shard.detach().numpy().tobytes()))
        record[name] = dict(
            losses=losses, shards=shards,
            grads=grads if rank == 0 else None,
            params=[leaf.gather().detach().numpy()
                    for leaf in T.tree_leaves(state.params)])
"""

WORKER_TAIL = """
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(record, f)
    torch.distributed.destroy_process_group()
"""


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


def _start_ranks(out):
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPUSHARE_")}
        env.update(TPUSHARE_GANG_SIZE=str(WORLD),
                   TPUSHARE_GANG_RANK=str(rank),
                   TPUSHARE_COORDINATOR=f"127.0.0.1:{port}",
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(out / "worker.py"), str(out)], env=env,
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _jax_config(case):
    return jax_tf.TransformerConfig(dtype=jnp.float32, attention="reference",
                                    **case["model"])


def _jax_rules(case):
    rules = jax_tf.transformer_sharding_rules()
    if case["rules"] == "ep":
        rules.update({"moe']['w_in": jax_mesh.P("ep", None, None),
                      "moe']['w_out": jax_mesh.P("ep", None, None)})
    return rules


def _jax_apply(case, cfg, jmesh):
    entry, kw = case["entry"], case["kw"]
    if entry == "with_aux":
        return lambda p, t: jax_tf.transformer_apply_with_aux(p, t, cfg)
    if entry in ("ring", "ring_aux"):
        # the port's hybrid ring is held to JAX's einsum ring
        kw = dict(kw, use_flash=False)
        return lambda p, t: jax_tf.transformer_apply_ring(
            p, t, cfg, jmesh, with_aux=entry == "ring_aux", **kw)
    if entry == "ulysses":
        return lambda p, t: jax_tf.transformer_apply_ulysses(p, t, cfg,
                                                             jmesh, **kw)
    # a batch split along sp: GSPMD's program is the dense model's
    return lambda p, t: jax_tf.transformer_apply(p, t, cfg)


def _jax_run(case, params, tokens, targets):
    """JAX's sharded step over four CPU devices: (losses, step 1's
    gradients, parameters)."""
    cfg = _jax_config(case)
    jmesh = jax_mesh.make_mesh(
        jax_mesh.MeshSpec(**{"tp": 1, "sp": 1, **case["axes"]}),
        devices=jax.devices()[:WORLD])
    apply = _jax_apply(case, cfg, jmesh)
    moe = "moe_every" in case["model"]
    if moe:
        loss_fn = lambda out, t: jax_ce(out[0], t) + AUX_COEF * out[1]
        optimizer = optax.adamw(1e-3, eps=MOE_ADAM_EPS)
    else:
        loss_fn, optimizer = jax_ce, None
    # step 1's gradients: the ring and Ulysses compute the dense model's
    # function, so its gradient is taken through the dense forward (one
    # device, a faster compile); the local-MoE entry routes each shard
    # alone and is differentiated as it is
    dense = (apply if case["entry"] == "ring_aux" else
             jax_tf.transformer_apply_with_aux if moe else
             jax_tf.transformer_apply)
    grads = _leaves(jax.jit(jax.grad(lambda p: loss_fn(
        dense(p, jnp.asarray(tokens)) if dense is apply
        else dense(p, jnp.asarray(tokens), cfg),
        jnp.asarray(targets))))(params))
    init_state, step = jax_make_train_step(
        apply, mesh=jmesh, param_rules=_jax_rules(case), loss_fn=loss_fn,
        optimizer=optimizer, donate_state=False)
    state = init_state(params)
    place = jax_mesh.batch_sharding(jmesh, ndim=2)
    jt = jax.device_put(jnp.asarray(tokens), place)
    jy = jax.device_put(jnp.asarray(targets), place)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jt, jy)
        losses.append(float(loss))
    return losses, grads, _leaves(jax.device_get(state.params))


def _one_controller(case, params, tokens, targets):
    """The port's one-controller mesh over [cpu] * 4: (losses, step 1's
    gradients, parameters), gathered."""
    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    space = {}
    exec(textwrap.dedent(BUILD), space)
    mesh = make_mesh(MeshSpec(**case["axes"]),
                     devices=[torch.device("cpu")] * WORLD)
    state, losses, grads = space["train"](
        case, mesh, params_from_jax(params, "cpu"), torch.from_numpy(tokens),
        torch.from_numpy(targets), STEPS, AUX_COEF, MOE_ADAM_EPS)
    return losses, grads, [leaf.gather().detach().numpy()
                           for leaf in space["T"].tree_leaves(state.params)]


def _params(rng, moe):
    cfg = jax_tf.TransformerConfig(dtype=jnp.float32, attention="reference",
                                   **MODEL, **(MOE if moe else {}))
    # numpy draws of the JAX tree's shapes (its init takes seconds), norm
    # scales at one as JAX's init sets them
    shapes = jax.eval_shape(lambda key: jax_tf.transformer_init(key, cfg),
                            jax.random.PRNGKey(1))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones(leaf.shape, np.float32)
                            if "scale" in jax.tree_util.keystr(path) else
                            (0.1 * rng.standard_normal(leaf.shape)).astype(
                                np.float32)), shapes)


def run_cases(out: Path, cases, extra: str = "", qkv=None):
    """The fixture's work: the ranks (``WORKER_HEAD`` + ``extra`` +
    ``WORKER_TAIL``) run every case while JAX's steps (the cases marked
    for it) compile in threads and the one-controller mesh runs; returns
    (each rank's record, JAX's (losses, step 1's gradients, parameters)
    by case, the one-controller's by case)."""
    rng = np.random.default_rng(7)
    params = {False: _params(rng, False), True: _params(rng, True)}
    tokens = rng.integers(0, MODEL["vocab_size"], BATCH).astype(np.int64)
    targets = rng.integers(0, MODEL["vocab_size"], BATCH).astype(np.int64)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(dict(params=params, tokens=tokens, targets=targets,
                         qkv=qkv, steps=STEPS, cases=cases,
                         aux_coef=AUX_COEF, moe_eps=MOE_ADAM_EPS), f)
    (out / "worker.py").write_text(textwrap.dedent(WORKER_HEAD)
                                   + textwrap.dedent(extra)
                                   + textwrap.dedent(WORKER_TAIL))
    procs = _start_ranks(out)
    try:
        # one JAX program at a time: the four ranks run meanwhile, and
        # the timing tests of other files share the host
        want = {name: _jax_run(case, params["moe_every" in case["model"]],
                               tokens, targets)
                for name, case in cases.items() if case["jax"]}
        single = {name: _one_controller(
            case, params["moe_every" in case["model"]], tokens, targets)
            for name, case in cases.items()}
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, f"{stdout}\n{stderr[-3000:]}"
    ranks = []
    for rank in range(WORLD):
        with open(out / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, want, single


def worst(got, want) -> float:
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def bits_equal(got, want) -> bool:
    return all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def check_jax(runs, name) -> None:
    """Losses, step 1's gradients and the parameters after three steps
    within ``TOL`` of JAX's."""
    ranks, want, _ = runs
    losses, grads, params = want[name]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=TOL)
    assert len(got["grads"]) == len(grads)
    assert worst(got["grads"], grads) <= TOL
    assert worst(got["params"], params) <= TOL


def check_copies(runs, name) -> None:
    """Every rank's copy of every slice equal to the bit."""
    ranks, _, _ = runs
    for i in range(len(ranks[0][name]["shards"])):
        held = {}
        for rank in ranks:
            key, data = rank[name]["shards"][i]
            held.setdefault(key, set()).add(data)
        assert all(len(copies) == 1 for copies in held.values()), i
