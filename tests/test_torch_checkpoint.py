"""kubeshare_tpu_torch.parallel.checkpoint and utils.profiling on the CPU:
round trips of a tree, a TrainState and a dp x tp-sharded TrainState
(restored in place, onto the same mesh, another mesh and one device); a
resumed eager run equal to the bit to an uninterrupted one; the files
keep-N leaves and latest_checkpoint equal to the JAX package's functions
over the same step sequence; train_cifar_torch.py's save and resume;
profile_trace and timed.  The in-place restore into a captured step is
tests/test_torch_cuda.py's."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel import checkpoint as jax_checkpoint
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.resnet import (ResNetConfig, resnet_apply,
                                               resnet_init)
from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                    transformer_apply,
                                                    transformer_sharding_rules)
from kubeshare_tpu_torch.parallel import checkpoint
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, ShardedTensor,
                                               make_mesh)
from kubeshare_tpu_torch.utils.profiling import profile_trace, timed

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import train_cifar_torch  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = ResNetConfig(widths=(4, 8), blocks_per_stage=(1, 1), groups=2)
DENSE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=32, n_kv_heads=2)


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, 16, 16, 3),
                                                 dtype=np.float32)),
            torch.from_numpy(rng.integers(0, 10, (n,), dtype=np.int64)))


def _resnet_run(steps, state=None, step_fn=None, first=0):
    if state is None:
        init_state, step_fn = port_train.make_train_step(
            lambda p, x: resnet_apply(p, x, SMALL))
        state = init_state(resnet_init(torch.Generator().manual_seed(0),
                                       SMALL, device="cpu"))
    for i in range(first, first + steps):
        state, _ = step_fn(state, *_batch(i))
    return state, step_fn


def _leaves(tree):
    return [leaf.gather() if isinstance(leaf, ShardedTensor) else leaf
            for leaf in port_train.tree_leaves(tree)]


def _optimizer_tensors(state):
    out = []
    for leaf in port_train.tree_leaves(state.params):
        for shard in getattr(leaf, "shards", [leaf]):
            entry = state.opt_state.state[shard]
            out.append({k: v for k, v in entry.items()
                        if isinstance(v, torch.Tensor)})
    return out


def test_tree_round_trip_in_place(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(2), {"c": torch.full((1,), 7.0)}]}
    path = checkpoint.save_checkpoint(str(tmp_path), tree, step=4)
    assert os.path.basename(path) == "ckpt-4.bin"
    assert not list(tmp_path.glob("*.tmp"))
    raw = torch.load(path, weights_only=True)  # plain tensors, no pickle
    assert raw["kind"] == "tree" and raw["step"] == 4
    loaded = checkpoint.restore_checkpoint(str(tmp_path))
    assert torch.equal(loaded["b"][1]["c"], tree["b"][1]["c"])
    into = {"a": torch.zeros(2, 3), "b": [torch.zeros(2),
                                          {"c": torch.zeros(1)}]}
    pointer = into["a"].data_ptr()
    assert checkpoint.restore_checkpoint(str(tmp_path), 4, into=into) is into
    assert into["a"].data_ptr() == pointer
    for got, want in zip(port_train.tree_leaves(into),
                         port_train.tree_leaves(tree)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no leaf of shape"):
        checkpoint.restore_checkpoint(str(tmp_path),
                                      into={"a": torch.zeros(3, 2)})


def test_train_state_round_trip_in_place(tmp_path):
    state, step_fn = _resnet_run(2)
    checkpoint.save_checkpoint(str(tmp_path), state, step=2)
    fresh, _ = _resnet_run(1)  # another state, its moments built
    pointers = [t.data_ptr() for t in _leaves(fresh.params)]
    moments = [d["exp_avg"].data_ptr() for d in _optimizer_tensors(fresh)]
    restored = checkpoint.restore_checkpoint(str(tmp_path), into=fresh)
    assert restored.step == 2 and restored.opt_state is fresh.opt_state
    assert [t.data_ptr() for t in _leaves(fresh.params)] == pointers
    assert [d["exp_avg"].data_ptr()
            for d in _optimizer_tensors(fresh)] == moments
    for got, want in zip(_leaves(fresh.params), _leaves(state.params)):
        assert torch.equal(got, want)
    for got, want in zip(_optimizer_tensors(fresh), _optimizer_tensors(state)):
        assert got.keys() == want.keys()
        for key in got:
            assert torch.equal(got[key], want[key]), key
    # without into: the file's data, the optimizer keyed by leaf path
    data = checkpoint.restore_checkpoint(str(tmp_path), 2)
    assert data["step"] == 2
    paths = [p for p, _ in port_train.tree_leaves_with_paths(state.params)]
    assert list(data["optimizer"]["state"]) == paths
    assert data["optimizer"]["param_groups"][0]["params"] == paths


def _reordered(tree):
    """The tree with every dict's keys listed in reverse order."""
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reordered(v) for v in tree]
    return tree


def test_restore_matches_moments_by_path_not_by_order(tmp_path):
    # two leaves of one shape whose places swap when the dicts list
    # their keys in the other order (a tree from params_from_jax has
    # sorted keys, one from an init function insertion order)
    def run(params, steps):
        init_state, step_fn = port_train.make_train_step(
            lambda p, x: x @ p["w"] + torch.tanh(x) @ p["v"])
        state = init_state(params)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (4, 3), dtype=np.float32))
        for _ in range(steps):
            state, _ = step_fn(state, x, torch.tensor([0, 1, 2, 0]))
        return state

    def params():
        rng = np.random.default_rng(0)
        return {k: torch.from_numpy(rng.standard_normal(
            (3, 3), dtype=np.float32)) for k in ("w", "v")}

    state = run(params(), 2)
    checkpoint.save_checkpoint(str(tmp_path), state, step=2)
    fresh = run(_reordered(params()), 1)
    assert list(fresh.params) == ["v", "w"]
    checkpoint.restore_checkpoint(str(tmp_path), into=fresh)
    for key in ("w", "v"):
        assert torch.equal(fresh.params[key], state.params[key])
        got = fresh.opt_state.state[fresh.params[key]]
        want = state.opt_state.state[state.params[key]]
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[moment], want[moment]), (key, moment)


def test_restore_refuses_a_moment_of_another_shape(tmp_path):
    state, _ = _resnet_run(1)
    path = checkpoint.save_checkpoint(str(tmp_path), state, step=1)
    payload = torch.load(path, weights_only=True)
    leaf_path = next(iter(payload["optimizer"]["state"]))
    moment = payload["optimizer"]["state"][leaf_path]["exp_avg"]
    payload["optimizer"]["state"][leaf_path]["exp_avg"] = moment.flatten()
    torch.save(payload, path)
    fresh, _ = _resnet_run(1)
    with pytest.raises(ValueError, match="'exp_avg' at .* has shape"):
        checkpoint.restore_checkpoint(str(tmp_path), into=fresh)
    # a file with state for a leaf the tree lacks
    payload["optimizer"]["state"][("nowhere",)] = {"step": torch.tensor(1.)}
    payload["optimizer"]["state"][leaf_path]["exp_avg"] = moment
    torch.save(payload, path)
    with pytest.raises(ValueError, match="which the tree lacks"):
        checkpoint.restore_checkpoint(str(tmp_path), into=fresh)


def test_resume_equals_an_uninterrupted_run_to_the_bit(tmp_path):
    straight, _ = _resnet_run(6)
    first, step_fn = _resnet_run(3)
    checkpoint.save_checkpoint(str(tmp_path), first, step=3)
    # a new process's state: fresh parameters, no optimizer state yet
    init_state, step_fn = port_train.make_train_step(
        lambda p, x: resnet_apply(p, x, SMALL))
    state = init_state(resnet_init(torch.Generator().manual_seed(9), SMALL,
                                   device="cpu"))
    state = checkpoint.restore_checkpoint(str(tmp_path), into=state)
    assert state.step == 3
    resumed, _ = _resnet_run(3, state, step_fn, first=3)
    assert resumed.step == straight.step == 6
    for got, want in zip(_leaves(resumed.params), _leaves(straight.params)):
        assert torch.equal(got, want)


def _sharded(mesh, rules=None, steps=2, seed=0):
    _, cfg = (None, TransformerConfig(dtype=torch.float32,
                                      attention="reference", **DENSE))
    params = params_from_jax(jax.device_get(jax_init(
        jax.random.PRNGKey(seed), JaxConfig(dtype=jnp.float32,
                                            attention="reference",
                                            **DENSE))), "cpu")
    init_state, step_fn = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, cfg), mesh=mesh,
        param_rules=rules if rules is not None
        else transformer_sharding_rules())
    state = init_state(params)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 64, (4, 16)))
    for _ in range(steps):
        state, _ = step_fn(state, tokens, tokens)
    return state


def test_sharded_train_state_round_trip(tmp_path):
    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=[CPU] * 4)
    state = _sharded(mesh)
    checkpoint.save_checkpoint(str(tmp_path), state, step=2)
    data = checkpoint.restore_checkpoint(str(tmp_path))
    # whole tensors in the file, the moments too
    embed = data["params"]["embed"]
    assert tuple(embed.shape) == (64, 32)
    assert torch.equal(embed, state.params["embed"].gather())
    assert tuple(data["optimizer"]["state"][("embed",)]["exp_avg"].shape) \
        == (64, 32)
    want = _optimizer_tensors(state)
    # onto the same mesh, in place; onto a dp=4 mesh of replicated
    # parameters; onto one device
    for target in (make_mesh(MeshSpec(dp=2, tp=2), devices=[CPU] * 4),
                   make_mesh(MeshSpec(dp=4), devices=[CPU] * 4), None):
        fresh = _sharded(target, rules={} if target is not None
                         and target.shape["tp"] == 1 else None,
                         steps=1, seed=5)
        pointers = [s.data_ptr() for leaf in port_train.tree_leaves(
            fresh.params) for s in getattr(leaf, "shards", [leaf])]
        checkpoint.restore_checkpoint(str(tmp_path), into=fresh)
        assert pointers == [s.data_ptr() for leaf in port_train.tree_leaves(
            fresh.params) for s in getattr(leaf, "shards", [leaf])]
        for got, ref in zip(_leaves(fresh.params), _leaves(state.params)):
            assert torch.equal(got, ref)
        got = _optimizer_tensors(fresh)
        for path, leaf in port_train.tree_leaves_with_paths(fresh.params):
            entry = data["optimizer"]["state"][path]
            shards = getattr(leaf, "shards", [leaf])
            placed = (leaf.spec, leaf.mesh) if isinstance(
                leaf, ShardedTensor) else None
            for key in ("exp_avg", "exp_avg_sq"):
                whole = ShardedTensor(
                    [fresh.opt_state.state[s][key] for s in shards],
                    *placed, leaf.shape).gather() if placed else \
                    fresh.opt_state.state[leaf][key]
                assert torch.equal(whole, entry[key])
        assert all(torch.equal(g["step"], w["step"])
                   for g, w in zip(got, want))


def _jax_save(directory, step, keep):
    jax_checkpoint.save_checkpoint(directory, {"w": np.zeros(2)}, step,
                                   keep=keep)


@pytest.mark.parametrize("keep", [3, 1, 0])
def test_keep_n_and_latest_equal_jax(tmp_path, keep):
    steps = [1, 5, 3, 10, 7, 2, 12]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert checkpoint.latest_checkpoint(str(port_dir)) is None
    for step in steps:
        checkpoint.save_checkpoint(str(port_dir), {"w": torch.zeros(2)}, step,
                                   keep=keep)
        _jax_save(str(jax_dir), step, keep)
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
        got = checkpoint.latest_checkpoint(str(port_dir))
        want = jax_checkpoint.latest_checkpoint(str(jax_dir))
        assert (got[0], os.path.basename(got[1])) == \
            (want[0], os.path.basename(want[1]))
    (port_dir / "ckpt-99.bin.tmp").write_bytes(b"")  # a torn write
    assert checkpoint.latest_checkpoint(str(port_dir))[0] == max(steps)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.restore_checkpoint(str(tmp_path / "empty"))


def test_train_cifar_saves_and_resumes(tmp_path, capsys):
    common = ["--small", "--batch", "4", "--device", "cpu", "--ckpt-dir",
              str(tmp_path)]
    straight = train_cifar_torch.main(["--small", "--batch", "4", "--device",
                                       "cpu", "--steps", "5"])
    first = train_cifar_torch.main(common + ["--steps", "3"])
    assert first["start_step"] == 0 and len(first["losses"]) == 3
    assert checkpoint.latest_checkpoint(str(tmp_path))[0] == 3
    second = train_cifar_torch.main(common + ["--steps", "5"])
    assert second["start_step"] == 3 and len(second["losses"]) == 2
    assert "resumed from step 3" in capsys.readouterr().out
    assert first["losses"] + second["losses"] == straight["losses"]
    for got, want in zip(_leaves(second["state"].params),
                         _leaves(straight["state"].params)):
        assert torch.equal(got, want)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None):  # no-op
        pass
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_timed_logs_wall_time(capfd):
    with timed("the block") as result:
        pass
    assert result["seconds"] >= 0
    assert "the block took" in capfd.readouterr().err
