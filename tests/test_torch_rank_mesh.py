"""Port parity: the mesh of ranks (``make_mesh`` over a gang,
``mesh.RankMesh``), the sharded training step run across processes, one
unit a rank, against the JAX package's ``make_train_step`` over a mesh
of four CPU devices (the conftest's host devices) and against the port's
one-controller mesh over ``[cpu] * 4``, on the CPU at f32.

Four gloo ranks (real OS processes with the gang env), started once for
every case, take three AdamW steps from the same weights (numpy draws
of the JAX tree's shapes, converted 1:1) in each of three meshes: dp=2 x tp=2 under ``transformer_sharding_rules``,
dp=2 x tp=2 under ``transformer_fsdp_rules``, and tp=2 x sp=2 (dp=1; sp
names nothing under the rules, a replica axis).  Every rank passes the
whole global batch and keeps its own shards.

- The losses, step 1's gradients (gathered across the ranks) and the
  parameters after three steps equal JAX's within 1e-5.
- They equal the one-controller mesh's to the bit: every cross-rank sum
  (a psum, the reduce-scatter of an fsdp gather, the sum of a slice's
  copies over up to four ranks, the vocabulary pieces' statistics) is
  made by each rank in the one-controller's member order.
- Every rank's copy of every slice is equal to the bit; each rank holds
  its shards only, a tp-split leaf at 1/tp of its bytes.
- Under tp x sp, the ranks at sp=1 recompute their unit and do not
  differentiate their loss (a constant there).
- A control in the same processes, a psum whose backward drops the
  cross-rank sum, is refused by the gradient check.
- The paths the rank mesh leaves out raise ``ValueError`` naming their
  ROADMAP item: the captured step, ``process_group`` beside the mesh,
  checkpoints; and MoE layers on the pipelined path, which JAX refuses
  too.  (MoE layers, the ring, Ulysses and a batch split along the
  sequence run over ranks: ``tests/test_torch_rank_mesh_moe.py`` and
  ``tests/test_torch_rank_mesh_sp.py``; pipelines, ``data_parallel_apply``,
  any loss and ``ShardedTensor.index_select``:
  ``tests/test_torch_rank_mesh_pp.py``.)"""

import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from native_helpers import free_port

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import \
    transformer_fsdp_rules as jax_fsdp_rules
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.models.transformer import \
    transformer_sharding_rules as jax_rules
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_loss
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import (
    TransformerConfig, transformer_apply, transformer_fsdp_rules,
    transformer_sharding_rules)
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the SMALL config of tests/test_torch_distributed_train.py
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)
STEPS = 3
WORLD = 4
# f32 end to end; the sharded programs sum the tp partial products, the
# vocabulary pieces and the copies' gradients in their own order
TOL = 1e-5
RANK_TIMEOUT_S = 120
# name: (mesh axes, the port's rules, JAX's rules)
CASES = {
    "dp2_tp2": (dict(dp=2, tp=2), transformer_sharding_rules, jax_rules),
    "dp2_tp2_fsdp": (dict(dp=2, tp=2), transformer_fsdp_rules,
                     jax_fsdp_rules),
    "tp2_sp2": (dict(dp=-1, tp=2, sp=2), transformer_sharding_rules,
                jax_rules),
}

WORKER = """
    import pickle, sys, tempfile
    import numpy as np
    import torch
    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply, transformer_apply_pipelined,
        transformer_fsdp_rules, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel import spmd
    from kubeshare_tpu_torch.parallel import train as T
    from kubeshare_tpu_torch.parallel.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)
    from kubeshare_tpu_torch.parallel.distributed import initialize_from_env
    from kubeshare_tpu_torch.parallel.mesh import (
        MeshSpec, RankMesh, _shard_slices, _split_names, make_mesh)

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    spec = initialize_from_env(device="cpu")
    rank = spec.process_id
    config = TransformerConfig(dtype=torch.float32, attention="reference",
                               **inputs["model"])
    tokens, targets = (torch.from_numpy(inputs[k])
                       for k in ("tokens", "targets"))
    rules = {"dp2_tp2": transformer_sharding_rules,
             "dp2_tp2_fsdp": transformer_fsdp_rules,
             "tp2_sp2": transformer_sharding_rules}
    differentiated = []
    shipped = spmd._rank_cross_entropy

    def recording(logits, targets):
        loss = shipped(logits, targets)
        differentiated.append(loss.requires_grad)
        return loss

    spmd._rank_cross_entropy = recording

    def run(mesh, name, steps):
        init_state, train_step = T.make_train_step(
            lambda p, t: transformer_apply(p, t, config), mesh=mesh,
            param_rules=rules[name]())
        state = init_state(params_from_jax(inputs["params"], "cpu"))
        grads = []
        leaves = T.tree_leaves(state.params)
        # every rank runs the hook: the gathers inside it are collectives
        state.opt_state.register_step_pre_hook(lambda opt, *a: grads.append(
            [leaf.grad.gather().numpy() for leaf in leaves])
            if not grads else None)
        losses = []
        for _ in range(steps):
            state, loss = train_step(state, tokens, targets)
            losses.append(float(loss))
        return state, losses, grads[0]

    record, meshes = {}, {}
    for name, axes in inputs["cases"].items():
        mesh = meshes[name] = make_mesh(MeshSpec(**axes), device="cpu")
        assert isinstance(mesh, RankMesh) and mesh.device.type == "cpu"
        del differentiated[:]
        state, losses, grads = run(mesh, name, inputs["steps"])
        shards = []
        for leaf in T.tree_leaves(state.params):
            [shard] = leaf.shards
            slices = _shard_slices(leaf.shape, leaf.spec, mesh)[mesh.position]
            degree = int(np.prod([mesh.shape[a] for axes in leaf.spec
                                  for a in _split_names(axes)]))
            shards.append(dict(
                key=tuple((s.start, s.stop) for s in slices),
                bytes=shard.detach().numpy().tobytes(),
                numel=shard.numel(), whole=leaf.shape.numel(),
                degree=degree, tp="tp" in [a for axes in leaf.spec
                                           for a in _split_names(axes)]))
        optimizer_bytes = sum(p.numel() * p.element_size()
                              for g in state.opt_state.param_groups
                              for p in g["params"])
        record[name] = dict(
            losses=losses, coords=mesh.coords(), shards=shards,
            optimizer_bytes=optimizer_bytes,
            differentiated=list(differentiated),
            grads=grads if rank == 0 else None,
            params=([leaf.gather().detach().numpy()
                     for leaf in T.tree_leaves(state.params)]))

    def local_only(ctx, grad):  # the control: no cross-rank sum
        return grad, None

    psum_backward = spmd._RankPsum.backward
    spmd._RankPsum.backward = staticmethod(local_only)
    _, _, slip_grads = run(meshes["dp2_tp2"], "dp2_tp2", 1)
    spmd._RankPsum.backward = psum_backward
    record["slip_grads"] = slip_grads if rank == 0 else None

    errors = {}

    def refused(label, fn):
        try:
            fn()
        except ValueError as e:
            errors[label] = str(e)
        else:
            errors[label] = None

    mesh = meshes["dp2_tp2"]
    apply = lambda p, t: transformer_apply(p, t, config)
    refused("capture", lambda: T.make_train_step(
        apply, mesh=mesh, param_rules=rules["dp2_tp2"](), capture=True))
    refused("process_group", lambda: T.make_train_step(
        apply, mesh=mesh, process_group=True))
    init_state, _ = T.make_train_step(apply, mesh=mesh,
                                      param_rules=rules["dp2_tp2"]())
    state = init_state(params_from_jax(inputs["params"], "cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        refused("save_checkpoint", lambda: save_checkpoint(tmp, state, 1))
        refused("restore_checkpoint",
                lambda: restore_checkpoint(tmp, 1, into=state))
    moe = TransformerConfig(dtype=torch.float32, attention="reference",
                            moe_every=2, moe_num_experts=4,
                            **inputs["model"])
    refused("pipelined_moe", lambda: transformer_apply_pipelined(
        {}, tokens, moe, mesh, pp_axis="dp"))
    record["errors"] = errors
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


def _jax_run(cfg, params, tokens, targets, axes, rules):
    """JAX's sharded step over four CPU devices: (losses, parameters)."""
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(**{"sp": 1, **axes}),
                               devices=jax.devices()[:WORLD])
    init_state, step = jax_make_train_step(
        lambda p, t: jax_apply(p, t, cfg), mesh=jmesh, param_rules=rules(),
        donate_state=False)
    state = init_state(params)
    place = jax_mesh.batch_sharding(jmesh, ndim=2)
    tokens = jax.device_put(jnp.asarray(tokens), place)
    targets = jax.device_put(jnp.asarray(targets), place)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, tokens, targets)
        losses.append(float(loss))
    return losses, _leaves(jax.device_get(state.params))


def _one_controller(params, tokens, targets, axes, rules):
    """The port's one-controller mesh over [cpu] * 4: (losses, step 1's
    gradients, parameters), gathered."""
    config = TransformerConfig(dtype=torch.float32, attention="reference",
                               **SMALL)
    mesh = make_mesh(MeshSpec(**axes), devices=[torch.device("cpu")] * WORLD)
    init_state, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, config), mesh=mesh,
        param_rules=rules())
    state = init_state(params_from_jax(params, "cpu"))
    leaves = port_train.tree_leaves(state.params)
    grads = []
    state.opt_state.register_step_pre_hook(lambda *_: grads.append(
        [leaf.grad.gather().numpy() for leaf in leaves])
        if not grads else None)
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, torch.from_numpy(tokens),
                                 torch.from_numpy(targets))
        losses.append(float(loss))
    return losses, grads[0], [leaf.gather().detach().numpy()
                              for leaf in leaves]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_mesh")
    cfg = JaxConfig(dtype=jnp.float32, attention="reference", **SMALL)
    rng = np.random.default_rng(5)
    # numpy draws of the JAX tree's shapes (its init, jitted or eager,
    # takes seconds), norm scales at one as JAX's init sets them
    shapes = jax.eval_shape(lambda key: jax_init(key, cfg),
                            jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones(leaf.shape, np.float32)
                            if "scale" in jax.tree_util.keystr(path) else
                            (0.1 * rng.standard_normal(leaf.shape)).astype(
                                np.float32)), shapes)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, 24)).astype(np.int64)
    targets = rng.integers(0, SMALL["vocab_size"], (4, 24)).astype(np.int64)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(dict(model=SMALL, params=params, tokens=tokens, targets=targets, steps=STEPS,
                         cases={name: axes for name, (axes, _, _)
                                in CASES.items()}), f)
    (out / "worker.py").write_text(textwrap.dedent(WORKER))
    procs = _start_ranks(out)
    try:
        # JAX and the one-controller mesh while the ranks run
        def loss_of(p):
            return jax_loss(jax_apply(p, jnp.asarray(tokens), cfg),
                            jnp.asarray(targets))

        # the four JAX programs compile in threads (XLA's compiler
        # releases the interpreter lock)
        with ThreadPoolExecutor(len(CASES) + 1) as pool:
            grads = pool.submit(lambda: _leaves(
                jax.jit(jax.grad(loss_of))(params)))
            runs = {name: pool.submit(_jax_run, cfg, params, tokens,
                                      targets, axes, jrules)
                    for name, (axes, _, jrules) in CASES.items()}
            want_grads = grads.result()
            want = {name: run.result() for name, run in runs.items()}
        single = {name: _one_controller(params, tokens, targets, axes, rules)
                  for name, (axes, rules, _) in CASES.items()}
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
    return ranks, want_grads, want, single


def _worst(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _bits_equal(got, want):
    return all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
def test_losses_equal_jax_and_the_one_controller_mesh(runs, case):
    ranks, _, want, single = runs
    for rank in ranks:
        np.testing.assert_allclose(rank[case]["losses"], want[case][0],
                                   rtol=0, atol=TOL)
        assert rank[case]["losses"] == single[case][0]


@pytest.mark.parametrize("case", list(CASES))
def test_step_one_gradients_equal_jax_and_the_one_controller_mesh(runs,
                                                                   case):
    ranks, want_grads, _, single = runs
    grads = ranks[0][case]["grads"]
    assert len(grads) == len(want_grads)
    assert _worst(grads, want_grads) <= TOL
    assert _bits_equal(grads, single[case][1])


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_after_three_steps(runs, case):
    ranks, _, want, single = runs
    for rank in ranks:
        assert _worst(rank[case]["params"], want[case][1]) <= TOL
        assert _bits_equal(rank[case]["params"], single[case][2])


@pytest.mark.parametrize("case", list(CASES))
def test_every_copy_of_a_slice_is_equal_to_the_bit(runs, case):
    ranks, _, _, _ = runs
    n_leaves = len(ranks[0][case]["shards"])
    for i in range(n_leaves):
        held = {}
        for rank in ranks:
            shard = rank[case]["shards"][i]
            held.setdefault(shard["key"], set()).add(shard["bytes"])
        assert all(len(copies) == 1 for copies in held.values()), i
        # the ranks together hold every slice of the leaf
        assert len(held) == ranks[0][case]["shards"][i]["degree"]


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_shards_only(runs, case):
    ranks, _, _, _ = runs
    for rank in ranks:
        shards = rank[case]["shards"]
        for shard in shards:
            assert shard["numel"] * shard["degree"] == shard["whole"]
            if shard["tp"]:
                assert shard["numel"] * 2 <= shard["whole"]
        assert rank[case]["optimizer_bytes"] == 4 * sum(
            shard["numel"] for shard in shards)
        assert rank[case]["optimizer_bytes"] < 4 * sum(
            shard["whole"] for shard in shards)


def test_replica_ranks_recompute_without_differentiating(runs):
    ranks, _, _, _ = runs
    for rank in ranks:
        run = rank["tp2_sp2"]
        sp = run["coords"][2]
        assert run["differentiated"] == [sp == 0] * STEPS
        assert rank["dp2_tp2"]["differentiated"] == [True] * STEPS


def test_gradient_check_refuses_a_psum_without_the_cross_rank_sum(runs):
    ranks, want_grads, _, _ = runs
    assert _worst(ranks[0]["dp2_tp2"]["grads"], want_grads) <= TOL
    assert _worst(ranks[0]["slip_grads"], want_grads) > 100 * TOL


@pytest.mark.parametrize("path, item", [
    ("capture", "11d"), ("process_group", "average"),
    ("save_checkpoint", "11h"), ("restore_checkpoint", "11h"),
    ("pipelined_moe", "pipelined path")])
def test_paths_left_out_raise_value_error(runs, path, item):
    ranks, _, _, _ = runs
    for rank in ranks:
        message = rank["errors"][path]
        assert message is not None and item in message, (path, message)
