"""Port parity: ``make_train_step(..., process_group=True)``, data
parallelism across processes, against the JAX package's single-process
``make_train_step`` on the global batch, on the CPU at f32.

Two gloo ranks (real OS processes with the gang env) start from the JAX
init, converted 1:1, and take three AdamW steps, each on its half of a
4-row global batch.  Their losses (the group's mean), step 1's gradients
(read after the all-reduce, before the optimizer) and their parameters
after three steps equal JAX's steps on the whole batch within 1e-5, and
the two ranks' parameters are equal to the bit.  A control in the same
processes drops the division by the world size: its step-1 gradients are
twice JAX's, which the gradient check refuses (Adam's update would hide
the factor from the losses and nearly from the parameters)."""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from native_helpers import free_port

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_loss
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)
STEPS = 3
WORLD = 2
# f32 end to end; the ranks' halves and the group's sum reorder the
# gradient's sums, nothing else
TOL = 1e-5
RANK_TIMEOUT_S = 90

WORKER = """
    import pickle, sys
    import numpy as np
    import torch
    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                        transformer_apply)
    from kubeshare_tpu_torch.parallel import train as T
    from kubeshare_tpu_torch.parallel.distributed import initialize_from_env

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    spec = initialize_from_env(device="cpu")
    rank, world = spec.process_id, spec.num_processes
    config = TransformerConfig(dtype=torch.float32, attention="reference",
                               **inputs["model"])
    rows = inputs["tokens"].shape[0] // world
    tokens, targets = (torch.from_numpy(inputs[k][rank * rows:(rank + 1) * rows])
                       for k in ("tokens", "targets"))

    def run(steps):
        init_state, train_step = T.make_train_step(
            lambda p, t: transformer_apply(p, t, config), process_group=True)
        params = params_from_jax(inputs["params"], "cpu")
        # only rank 0's parameters count: init_state broadcasts them
        if rank != 0:
            params = T.tree_map(torch.zeros_like, params)
        state = init_state(params)
        grads = []
        state.opt_state.register_step_pre_hook(lambda opt, *a: grads.append(
            [p.grad.detach().clone() for p in T.tree_leaves(state.params)])
            if not grads else None)
        losses = []
        for _ in range(steps):
            state, loss = train_step(state, tokens, targets)
            losses.append(float(loss))
        return (losses, [g.numpy() for g in grads[0]],
                [p.detach().numpy() for p in T.tree_leaves(state.params)])

    losses, grads, params = run(inputs["steps"])

    def sum_only(self):  # the control: the sum, not the mean
        for bucket, flat in zip(self.buckets, self.flats):
            T._unflatten(flat, bucket)

    T.GroupMean.unflatten = sum_only
    _, slip_grads, _ = run(1)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(dict(losses=losses, grads=grads, params=params,
                         slip_grads=slip_grads), f)
    torch.distributed.destroy_process_group()
"""


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    cfg = JaxConfig(dtype=jnp.float32, attention="reference", **SMALL)
    # jitted: JAX's eager init and grad take seconds op by op
    params = jax.device_get(jax.jit(lambda key: jax_init(key, cfg))(
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, 24)).astype(np.int64)
    targets = rng.integers(0, SMALL["vocab_size"], (4, 24)).astype(np.int64)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(dict(model=SMALL, params=params, tokens=tokens,
                         targets=targets, steps=STEPS), f)
    (out / "worker.py").write_text(textwrap.dedent(WORKER))

    # JAX: one process, the whole batch
    def loss_of(p):
        return jax_loss(jax_apply(p, jnp.asarray(tokens), cfg),
                        jnp.asarray(targets))

    want_grads = _leaves(jax.jit(jax.grad(loss_of))(params))
    init_state, step = jax_make_train_step(
        lambda p, t: jax_apply(p, t, cfg), donate_state=False)
    state = init_state(params)
    want_losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens), jnp.asarray(targets))
        want_losses.append(float(loss))
    want_params = _leaves(jax.device_get(state.params))

    port = free_port()
    procs = []
    try:
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
    return ranks, (want_losses, want_grads, want_params)


def _worst(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def test_losses_equal_jax_on_the_global_batch(runs):
    ranks, (want_losses, _, _) = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want_losses, rtol=0,
                                   atol=TOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_step_one_gradients_equal_jax(runs):
    ranks, (_, want_grads, _) = runs
    for rank in ranks:
        assert len(rank["grads"]) == len(want_grads)
        assert _worst(rank["grads"], want_grads) <= TOL


def test_parameters_after_three_steps_equal_jax_and_each_other(runs):
    ranks, (_, _, want_params) = runs
    for rank in ranks:
        assert _worst(rank["params"], want_params) <= TOL
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        assert a.tobytes() == b.tobytes()


def test_gradient_check_refuses_a_missing_division(runs):
    ranks, (_, want_grads, _) = runs
    for rank in ranks:
        assert _worst(rank["slip_grads"], want_grads) > 100 * TOL
        doubled = [2 * g for g in want_grads]
        assert _worst(rank["slip_grads"], doubled) <= 2 * TOL
