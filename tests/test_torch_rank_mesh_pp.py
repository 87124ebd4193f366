"""Port parity: pipelines, per-sample data parallelism, any loss and
``ShardedTensor.index_select`` over a mesh of ranks (``mesh.RankMesh``,
one unit a rank), against the port's one-controller mesh over
``[cpu] * 4`` and the JAX package's programs over four CPU devices, on
the CPU at f32.

Four gloo ranks, started once for the file, run every case; the test's
own process runs the one-controller mesh and JAX meanwhile.

- GPipe (``pipeline_apply``) at pp=4, differentiated through autograd:
  the output and ``dx`` on every rank and each rank's stage gradients
  equal the one-controller's to the bit, and JAX's within 1e-5.
- 1F1B (``pipeline_train_1f1b``) at pp=4 and at pp=2 x sp=2, with loss
  parameters and ``dx``: the loss, each rank's stage gradients (a
  ``ShardedTensor`` placed ``P(pp)``), the loss parameters' gradients
  and ``dx`` equal the one-controller's to the bit; pp=2 x sp=2 within
  1e-5 of JAX's.
- ``transformer_train_1f1b`` at pp=2 x sp=2 with the ring and with
  Ulysses inside each stage, and ``transformer_apply_pipelined`` with the
  ring: equal to the one-controller's to the bit.
- MNIST and the CIFAR ResNet through ``data_parallel_apply`` over dp=4
  ranks, and the transformer at dp=2 x tp=2 under a mean squared error
  over the gathered logits: three AdamW steps, losses, step 1's
  gradients and the parameters equal to the one-controller's to the
  bit; the ResNet and the squared error within 1e-5 of JAX's steps.
- ``index_select`` of a tensor split over tp, and its gradient.
- Controls the checks refuse: a 1F1B whose gradients are not divided by
  the stage's members, and a gathered loss whose read sums the ranks'
  cotangents (each share counted once a rank).  A GPipe backward run in
  another microbatch order on the odd stages finishes (the hops are
  tagged by microbatch and direction) with ``dx`` equal to the bit."""

import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

from torch_rank_mesh_cases import _start_ranks, bits_equal, worst

from kubeshare_tpu.models import transformer as jax_tf
from kubeshare_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from kubeshare_tpu.models.resnet import resnet_apply as jax_resnet_apply
from kubeshare_tpu.models.resnet import resnet_init as jax_resnet_init
from kubeshare_tpu.models.mnist import MnistConfig as JaxMnistConfig
from kubeshare_tpu.models.mnist import mnist_init as jax_mnist_init
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel import pipeline as jax_pipeline
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step

torch.set_num_threads(1)

WORLD = 4
STEPS = 3
# f32 end to end; the programs sum their microbatches, members and
# copies in their own order
TOL = 1e-5
RANK_TIMEOUT_S = 150
D = 8
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=4,
             d_ff=64, max_seq_len=32)
TOKENS = (4, 16)
MNIST_SMALL = dict(channels1=4, channels2=8, hidden=16)
RESNET_SMALL = dict(widths=(4, 8), blocks_per_stage=(1, 1), groups=2)
ADAM_EPS = 1e-5

# the port's side, run by the ranks and by the one-controller mesh:
# ``mesh(names, sizes)`` builds either
CASES = """
    import numpy as np
    import torch
    import torch.nn.functional as F
    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.models import transformer as tf
    from kubeshare_tpu_torch.models.mnist import mnist_apply
    from kubeshare_tpu_torch.models.resnet import ResNetConfig, resnet_apply
    from kubeshare_tpu_torch.parallel import pipeline, spmd
    from kubeshare_tpu_torch.parallel import train as T
    from kubeshare_tpu_torch.parallel.mesh import P, ShardedTensor, shard_tensor

    def stage(p, xs):
        return [torch.tanh(x @ p["w"] + p["b"]) for x in xs]

    def head_loss(lp, out, y):
        return ((out @ lp["head"] - y) ** 2).mean()

    def tensors(tree, grad=False):
        return {k: torch.from_numpy(v).requires_grad_(grad)
                for k, v in tree.items()}

    def numpy(x):
        if isinstance(x, ShardedTensor):
            x = x.shards[0]
        return x.detach().numpy()

    def gpipe(inputs, mesh):
        params = tensors(inputs["stages4"], grad=True)
        x = torch.from_numpy(inputs["xg"]).requires_grad_()
        out = pipeline.pipeline_apply(params, x, stage, mesh("pp", 4), 4)
        (out ** 2).sum().backward()
        return dict(out=numpy(out), dx=numpy(x.grad),
                    grads={k: numpy(p.grad) for k, p in params.items()})

    def f1b(inputs, mesh, names, sizes, micro, sp):
        loss, grads, lgrads, dx = pipeline.pipeline_train_1f1b(
            tensors(inputs[f"stages{sizes[0]}"]),
            torch.from_numpy(inputs[f"x{sizes[0]}"]),
            torch.from_numpy(inputs[f"y{sizes[0]}"]), stage, head_loss,
            mesh(names, sizes), micro,
            activation_spec=P(None, "sp", None) if sp else None,
            loss_params=tensors(inputs["head"]), return_input_grads=True)
        return dict(loss=float(loss), dx=numpy(dx),
                    grads={k: numpy(g) for k, g in grads.items()},
                    lgrads={k: numpy(g) for k, g in lgrads.items()})

    def tf_config(attention):
        return tf.TransformerConfig(dtype=torch.float32, attention=attention,
                                    positional="rope", **inputs["model"])

    def tf_1f1b(inputs, mesh, attention):
        loss, grads = tf.transformer_train_1f1b(
            params_from_jax(inputs["tf"], "cpu"),
            torch.from_numpy(inputs["tokens"]),
            torch.from_numpy(inputs["targets"]), tf_config(attention),
            mesh(("pp", "sp"), (2, 2)), num_microbatches=2)
        return dict(loss=float(loss),
                    layers=[numpy(g) for g in T.tree_leaves(grads["layers"])],
                    rest=[numpy(leaf) for key, g in grads.items()
                          if key != "layers" for leaf in T.tree_leaves(g)])

    def tf_pipelined(inputs, mesh):
        with torch.no_grad():
            return numpy(tf.transformer_apply_pipelined(
                params_from_jax(inputs["tf"], "cpu"),
                torch.from_numpy(inputs["tokens"]), tf_config("ring"),
                mesh(("pp", "sp"), (2, 2)), num_microbatches=2))

    def mse(logits, targets):
        want = F.one_hot(targets.gather(), logits.shape[-1]).float()
        return ((logits.gather() - want) ** 2).mean()

    def train(inputs, mesh, name, steps):
        if name in ("mnist", "resnet"):
            config = ResNetConfig(**inputs["resnet_config"])
            apply = (mnist_apply if name == "mnist" else
                     lambda p, x: resnet_apply(p, x, config))
            init_state, train_step = T.make_train_step(
                apply, mesh=mesh("dp", 4), param_rules={},
                optimizer=T.adamw(1e-3, eps=inputs["adam_eps"]))
            x, y = inputs[f"{name}_images"], inputs[f"{name}_labels"]
        else:
            config = tf.TransformerConfig(dtype=torch.float32,
                                          attention="reference",
                                          **inputs["model"])
            init_state, train_step = T.make_train_step(
                lambda p, t: tf.transformer_apply(p, t, config),
                mesh=mesh(("dp", "tp"), (2, 2)),
                param_rules=tf.transformer_sharding_rules(), loss_fn=mse)
            x, y = inputs["tokens"], inputs["targets"]
        state = init_state(params_from_jax(inputs[name], "cpu"))
        leaves = T.tree_leaves(state.params)
        grads, losses = [], []
        # every rank runs the hook: the gathers inside it are collectives
        state.opt_state.register_step_pre_hook(lambda *_: grads.append(
            [leaf.grad.gather().numpy() for leaf in leaves])
            if not grads else None)
        for _ in range(steps):
            state, loss = train_step(state, torch.from_numpy(x),
                                     torch.from_numpy(y))
            losses.append(float(loss))
        return dict(losses=losses, grads=grads[0],
                    params=[leaf.gather().detach().numpy() for leaf in leaves])

    def index_select(inputs, mesh):
        m = mesh(("dp", "tp"), (2, 2))
        table = shard_tensor(torch.from_numpy(inputs["table"]),
                             P(None, "tp"), m, copy=True)
        for shard in table.shards:
            shard.requires_grad_()
        rows = table.index_select(0, torch.tensor([5, 0, 5, 2]))
        (rows * torch.from_numpy(inputs["row_weights"])).sum().backward()
        return dict(rows=numpy(rows),
                    grads=[numpy(s.grad) if s.grad is not None else None
                           for s in table.shards])

    def run_all(inputs, mesh):
        out = dict(gpipe=gpipe(inputs, mesh),
                   f1b_pp4=f1b(inputs, mesh, "pp", (4,), 3, False),
                   f1b_pp2_sp2=f1b(inputs, mesh, ("pp", "sp"), (2, 2), 2,
                                   True),
                   tf_ring=tf_1f1b(inputs, mesh, "ring"),
                   tf_ulysses=tf_1f1b(inputs, mesh, "ulysses"),
                   tf_pipelined=tf_pipelined(inputs, mesh),
                   index_select=index_select(inputs, mesh))
        for name in ("mnist", "resnet", "mse"):
            out[name] = train(inputs, mesh, name, inputs["steps"])
        return out
"""

WORKER = CASES + """
    import pickle, sys
    from kubeshare_tpu_torch.parallel.distributed import (
        initialize_from_env, rank_mesh_over)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, RankMesh, make_mesh

    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    with open(f"{out_dir}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    rank = initialize_from_env(device="cpu").process_id

    def mesh(names, sizes):
        names = (names,) if isinstance(names, str) else names
        sizes = (sizes,) if isinstance(sizes, int) else sizes
        if names == ("dp",):
            made = make_mesh(MeshSpec(dp=sizes[0]), device="cpu")
        elif names == ("dp", "tp"):
            made = make_mesh(MeshSpec(dp=sizes[0], tp=sizes[1]),
                             device="cpu")
        else:
            made = rank_mesh_over(names, sizes, device="cpu")
        assert isinstance(made, RankMesh)
        return made

    record = run_all(inputs, mesh)

    # another microbatch order on the odd stages' backward
    shipped_order = pipeline._GPipeRun.backward_order
    pipeline._GPipeRun.backward_order = lambda self, s: (
        reversed(range(self.m_count)) if s % 2 else range(self.m_count))
    record["out_of_order"] = gpipe(inputs, mesh)
    pipeline._GPipeRun.backward_order = shipped_order

    # control: the stage's gradients not divided by its members
    shipped_mean = pipeline._member_mean
    pipeline._member_mean = lambda g, members: g.float()
    record["undivided"] = f1b(inputs, mesh, ("pp", "sp"), (2, 2), 2, True)
    pipeline._member_mean = shipped_mean

    # control: the gathered loss's read sums the ranks' cotangents
    shipped_read = spmd._RankRead.backward

    def summed(ctx, grad):
        line = spmd.mesh_line(grad_mesh[0], grad_mesh[0].axis_names)
        total = spmd._ordered_sum(line.gather(grad.contiguous()))
        return (None if ctx.mine is None else total[ctx.mine],
                None, None, None, None)

    grad_mesh = [mesh(("dp", "tp"), (2, 2))]
    spmd._RankRead.backward = staticmethod(summed)
    record["counted_n_times"] = train(inputs, lambda *a: grad_mesh[0],
                                      "mse", 1)
    spmd._RankRead.backward = shipped_read

    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(record, f)
    torch.distributed.destroy_process_group()
"""


def _one_controller(inputs):
    from kubeshare_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

    space = {"inputs": inputs}
    exec(textwrap.dedent(CASES), space)

    def mesh(names, sizes):
        names = (names,) if isinstance(names, str) else tuple(names)
        sizes = (sizes,) if isinstance(sizes, int) else tuple(sizes)
        if names in (("dp",), ("dp", "tp")):
            return make_mesh(MeshSpec(**dict(zip(names, sizes))),
                             devices=[torch.device("cpu")] * WORLD)
        devices = np.empty(int(np.prod(sizes)), dtype=object)
        devices[:] = [torch.device("cpu")] * devices.size
        return Mesh(devices.reshape(sizes), names)

    return space["run_all"](inputs, mesh)


def _jax_meshes(names, sizes):
    return JaxMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_gpipe(inputs):
    jmesh = _jax_meshes(("pp",), (4,))

    def loss(p, x):
        out = jax_pipeline.pipeline_apply(p, x, _jax_stage, jmesh, 4)
        return (out ** 2).sum(), out

    (_, out), (grads, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(inputs["stages4"], inputs["xg"])
    return dict(out=np.asarray(out), dx=np.asarray(dx),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _jax_f1b_sp(inputs):
    jmesh = _jax_meshes(("pp", "sp"), (2, 2))

    def head_loss(lp, out, y):
        return jnp.mean((out @ lp["head"] - y) ** 2)

    loss, grads, lgrads, dx = jax.jit(
        lambda p, lp, x, y: jax_pipeline.pipeline_train_1f1b(
            p, x, y, _jax_stage, head_loss, jmesh, 2,
            activation_spec=JaxP(None, "sp", None), loss_params=lp,
            return_input_grads=True))(inputs["stages2"], inputs["head"],
                                      inputs["x2"], inputs["y2"])
    return dict(loss=float(loss), dx=np.asarray(dx),
                grads={k: np.asarray(v) for k, v in grads.items()},
                lgrads={k: np.asarray(v) for k, v in lgrads.items()})


def _jax_train(inputs, name):
    """JAX's sharded step over four CPU devices: (losses, parameters)."""
    if name == "resnet":
        cfg = JaxResNetConfig(**RESNET_SMALL)
        jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(dp=4, tp=1, sp=1),
                                   devices=jax.devices()[:WORLD])
        init_state, step = jax_make_train_step(
            lambda p, x: jax_resnet_apply(p, x, cfg), mesh=jmesh,
            param_rules={}, optimizer=optax.adamw(1e-3, eps=ADAM_EPS),
            donate_state=False)
        x = jax.device_put(jnp.asarray(inputs["resnet_images"]),
                           jax_mesh.batch_sharding(jmesh, ndim=4))
        y = jax.device_put(jnp.asarray(inputs["resnet_labels"]),
                           jax_mesh.batch_sharding(jmesh, ndim=1))
    else:
        cfg = jax_tf.TransformerConfig(dtype=jnp.float32,
                                       attention="reference",
                                       **inputs["model"])
        jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(dp=2, tp=2, sp=1),
                                   devices=jax.devices()[:WORLD])

        def mse(logits, targets):
            want = jax.nn.one_hot(targets, logits.shape[-1])
            return jnp.mean((logits - want) ** 2)

        init_state, step = jax_make_train_step(
            lambda p, t: jax_tf.transformer_apply(p, t, cfg), mesh=jmesh,
            param_rules=jax_tf.transformer_sharding_rules(), loss_fn=mse,
            donate_state=False)
        place = jax_mesh.batch_sharding(jmesh, ndim=2)
        x = jax.device_put(jnp.asarray(inputs["tokens"]), place)
        y = jax.device_put(jnp.asarray(inputs["targets"]), place)
    state = init_state(inputs[name])
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return losses, [np.asarray(leaf) for leaf in
                    jax.tree.leaves(jax.device_get(state.params))]


def _draw(init, cfg, rng, scale=None):
    """numpy draws of a JAX init's shapes (its init takes seconds):
    norm scales near one, the rest small normals."""
    shapes = jax.eval_shape(lambda key: init(key, cfg), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            value = 1 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 1
            value = rng.standard_normal(leaf.shape) * (
                scale if scale is not None else (1.0 / fan_in) ** 0.5)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs():
    rng = np.random.default_rng(17)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def stages(pp):
        return {"w": normal(pp, D, D, scale=D ** -0.5), "b": normal(pp, D)}

    tf_cfg = jax_tf.TransformerConfig(dtype=jnp.float32, attention="ring",
                                      positional="rope", **MODEL)
    dense_cfg = jax_tf.TransformerConfig(dtype=jnp.float32,
                                         attention="reference", **MODEL)
    return dict(
        stages4=stages(4), stages2=stages(2), head={"head": normal(D, 4)},
        xg=normal(8, 4, D), x4=normal(6, 4, D), y4=normal(6, 4, 4),
        x2=normal(4, 8, D),
        y2=normal(4, 8, 4), model=MODEL, steps=STEPS, adam_eps=ADAM_EPS,
        tf=_draw(jax_tf.transformer_init, tf_cfg, rng, 0.1),
        mse=_draw(jax_tf.transformer_init, dense_cfg, rng, 0.1),
        tokens=rng.integers(0, MODEL["vocab_size"], TOKENS).astype(np.int64),
        targets=rng.integers(0, MODEL["vocab_size"], TOKENS).astype(np.int64),
        mnist=_draw(jax_mnist_init, JaxMnistConfig(**MNIST_SMALL), rng),
        mnist_images=normal(8, 28, 28, 1),
        mnist_labels=rng.integers(0, 10, 8).astype(np.int64),
        resnet=_draw(jax_resnet_init, JaxResNetConfig(**RESNET_SMALL), rng),
        resnet_config=RESNET_SMALL, resnet_images=normal(8, 16, 16, 3),
        resnet_labels=rng.integers(0, 10, 8).astype(np.int64),
        table=normal(8, 6), row_weights=normal(4, 6))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_mesh_pp")
    inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (out / "worker.py").write_text(textwrap.dedent(WORKER))
    procs = _start_ranks(out)
    try:
        # one program at a time: the four ranks run meanwhile
        want = dict(gpipe=_jax_gpipe(inputs), f1b_pp2_sp2=_jax_f1b_sp(inputs),
                    resnet=_jax_train(inputs, "resnet"),
                    mse=_jax_train(inputs, "mse"))
        single = _one_controller(inputs)
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


def _stage(rank, pp):
    """The pp coordinate of ``rank`` on a mesh (pp, ...) of four ranks."""
    return rank // (WORLD // pp)


def _close(got, want, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e} of max (tol {TOL})"


def test_gpipe_over_ranks_equals_the_one_controller_mesh(runs):
    ranks, _, single = runs
    want = single["gpipe"]
    for rank, record in enumerate(ranks):
        got, s = record["gpipe"], _stage(rank, 4)
        assert bits_equal([got["out"], got["dx"]], [want["out"], want["dx"]])
        for name, grad in got["grads"].items():
            assert grad[s].tobytes() == want["grads"][name][s].tobytes()
            # the other stages' slices are other ranks'
            assert not np.delete(grad, s, axis=0).any()


@pytest.mark.parametrize("name", ["f1b_pp4", "f1b_pp2_sp2"])
def test_1f1b_over_ranks_equals_the_one_controller_mesh(runs, name):
    ranks, _, single = runs
    want = single[name]
    pp = 4 if name == "f1b_pp4" else 2
    for rank, record in enumerate(ranks):
        got, s = record[name], _stage(rank, pp)
        assert got["loss"] == want["loss"]
        assert bits_equal([got["dx"]], [want["dx"]])
        for key, grad in got["grads"].items():
            assert grad.tobytes() == want["grads"][key][s:s + 1].tobytes()
        assert bits_equal(list(got["lgrads"].values()),
                          list(want["lgrads"].values()))


@pytest.mark.parametrize("name", ["tf_ring", "tf_ulysses"])
def test_transformer_1f1b_over_ranks_equals_the_one_controller_mesh(runs,
                                                                    name):
    ranks, _, single = runs
    want = single[name]
    per = len(want["layers"]) // 2
    for rank, record in enumerate(ranks):
        got, s = record[name], _stage(rank, 2)
        assert got["loss"] == want["loss"]
        assert bits_equal(got["rest"], want["rest"])
        # this rank's stage's layers only
        assert len(got["layers"]) == per
        assert bits_equal(got["layers"], want["layers"][s * per:(s + 1) * per])


def test_transformer_pipelined_forward_over_ranks_equals_one_controller(
        runs):
    ranks, _, single = runs
    for record in ranks:
        assert bits_equal([record["tf_pipelined"]], [single["tf_pipelined"]])


@pytest.mark.parametrize("name", ["mnist", "resnet", "mse"])
def test_steps_over_ranks_equal_the_one_controller_mesh(runs, name):
    ranks, _, single = runs
    want = single[name]
    for record in ranks:
        got = record[name]
        assert got["losses"] == want["losses"]
        assert bits_equal(got["grads"], want["grads"])
        assert bits_equal(got["params"], want["params"])


def test_index_select_over_ranks_equals_the_one_controller_mesh(runs):
    ranks, _, single = runs
    want = single["index_select"]
    for rank, record in enumerate(ranks):
        got = record["index_select"]
        assert bits_equal([got["rows"]], [want["rows"]])
        # the owners' shards take the rows' gradient, the copies none
        mine, theirs = got["grads"][0], want["grads"][rank]
        assert (mine is None) == (theirs is None) == (rank >= 2)
        assert mine is None or mine.tobytes() == theirs.tobytes()


def test_gpipe_equals_jax(runs):
    ranks, want, _ = runs
    got = ranks[-1]["gpipe"]
    _close(got["out"], want["gpipe"]["out"], "out")
    _close(got["dx"], want["gpipe"]["dx"], "dx")
    for rank, record in enumerate(ranks):
        for name, grad in record["gpipe"]["grads"].items():
            _close(grad[rank], want["gpipe"]["grads"][name][rank],
                   f"d{name}[{rank}]")


def test_1f1b_with_sp_equals_jax(runs):
    ranks, want, _ = runs
    want = want["f1b_pp2_sp2"]
    for rank, record in enumerate(ranks):
        got, s = record["f1b_pp2_sp2"], _stage(rank, 2)
        _close(got["loss"], want["loss"], "loss")
        _close(got["dx"], want["dx"], "dx")
        for key, grad in got["grads"].items():
            _close(grad, want["grads"][key][s:s + 1], f"d{key}")
        _close(got["lgrads"]["head"], want["lgrads"]["head"], "dhead")


@pytest.mark.parametrize("name", ["resnet", "mse"])
def test_steps_over_ranks_equal_jax(runs, name):
    ranks, want, _ = runs
    losses, params = want[name]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=0)
    assert worst(got["params"], params) <= TOL


def test_an_out_of_order_gpipe_backward_finishes(runs):
    ranks, _, single = runs
    want = single["gpipe"]
    for rank, record in enumerate(ranks):
        got, s = record["out_of_order"], _stage(rank, 4)
        assert bits_equal([got["out"], got["dx"]], [want["out"], want["dx"]])
        for name, grad in got["grads"].items():
            _close(grad[s], want["grads"][name][s], f"d{name}")


def test_1f1b_gradients_not_divided_by_the_members_are_refused(runs):
    ranks, _, single = runs
    want = single["f1b_pp2_sp2"]
    for rank, record in enumerate(ranks):
        got, s = record["undivided"], _stage(rank, 2)
        off = max(worst([g], [want["grads"][k][s:s + 1]])
                  for k, g in got["grads"].items())
        assert off > 100 * TOL, off
        # the loss is the members' mean either way
        assert got["loss"] == want["loss"]


def test_a_loss_counted_once_a_rank_is_refused(runs):
    ranks, _, single = runs
    assert bits_equal(ranks[0]["mse"]["grads"], single["mse"]["grads"])
    assert worst(ranks[0]["counted_n_times"]["grads"],
                 single["mse"]["grads"]) > 100 * TOL
