"""The root twins of examples/ at ``--small --device cpu``: each runs its
JAX example's traffic and keeps its checks (the scripts raise where the
examples raise), and the tests hold what the examples print: the
fractional pod preempts and demotes to its host tier with no graph built
after warm-up; the disaggregated router's streams equal the monolithic
engine's and the sharded engine's the single-device engine's, greedy and
sampled; the fleet keeps each prefix family on one replica through a
scale-up and a drain; the MNIST pod's resume equals a straight run to
the bit; and the end-to-end demo's configd files and reclaim equal what
JAX's scheduler and configd give on the same labels."""

import importlib
import sys
from pathlib import Path

import pytest
import torch

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.cell import load_config as jax_load_config
from kubeshare_tpu.cell.allocator import ChipInfo as JaxChipInfo
from kubeshare_tpu.cluster import api as jax_api
from kubeshare_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from kubeshare_tpu.configd import ConfigDaemon as JaxConfigDaemon
from kubeshare_tpu.scheduler import KubeShareScheduler as JaxScheduler
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--small", "--device", "cpu"]


def _twin(name):
    sys.path.insert(0, str(REPO))
    return importlib.import_module(name)


def test_serve_fractional_preempts_and_tiers():
    summary = _twin("serve_fractional_torch").main(SMALL)
    assert summary["device"] == "cpu"
    assert summary["captures_after_warmup"] == 0
    assert summary["preemptions"].get("batch", 0) > 0
    assert "prod" not in summary["preemptions"]  # prod is guaranteed
    assert summary["tier_demoted_blocks"] > 0
    assert summary["tier_promoted_blocks"] > 0
    assert summary["prefix_hit_requests"] > 0
    assert summary["verify_steps"] > 0 and summary["spec_drafted"] > 0
    assert summary["grants"] >= 1 and summary["charged_ms"] > 0
    streams = summary["streams"]
    assert len(streams) == 14 and all(streams.values())


@pytest.mark.parametrize("script,key", [
    ("serve_disagg_torch", "streams_equal_monolithic"),
    ("serve_sharded_torch", "streams_equal_single_device"),
])
def test_streams_equal_their_replay(script, key):
    """The script replays the traffic through the monolithic (disagg) or
    single-device (sharded) engine and raises on a differing stream."""
    summary = _twin(script).main(SMALL)
    assert summary["captures_after_warmup"] == 0
    assert summary[key] == summary["requests"] == 9
    assert len(summary["streams"]["sampled"]) == 24
    if script == "serve_disagg_torch":
        assert summary["delivered"] == summary["migrations"] == 9
        assert summary["ledger"]["migrate"] == summary["migrated_bytes"] > 0
        assert all(cell["grants"] >= 1 and cell["mem_used"] == 0
                   for cell in summary["cells"].values())
    else:
        assert summary["collective_bytes"]["prefill_chunk"] > 0
        assert summary["grants"] >= 1


def test_serve_fleet_affinity_scale_up_and_drain():
    summary = _twin("serve_fleet_torch").main(SMALL)
    assert all(len(reps) == 1 for reps in summary["owners"].values())
    assert sorted(summary["placements"]) == ["r0", "r1", "r2"]
    assert all(cell for _, cell, _ in summary["placements"].values())
    assert summary["states"] == {"active": 2, "draining": 0, "retired": 1}
    assert max(summary["inherited"].values()) >= 32
    assert summary["tier_hits"] >= 1 and summary["prefix_hit_tokens"] > 0
    assert summary["captures_after_warmup"] == 0
    assert len(set(summary["captures_by_replica"].values())) == 1


def test_train_mnist_resume_equals_a_straight_run(tmp_path, monkeypatch):
    mnist = _twin("train_mnist_torch")
    args = SMALL + ["--batch", "32", "--checkpoint-every", "2"]
    straight = mnist.main(args + ["--steps", "6"])
    # the checkpoint directory from $CKPT_DIR, as the pod's manifest sets it
    monkeypatch.setenv("CKPT_DIR", str(tmp_path))
    first = mnist.main(args + ["--steps", "4"])
    resumed = mnist.main(args + ["--steps", "6"])
    assert straight["gate"] == "none" and straight["start_step"] == 0
    assert first["losses"] == straight["losses"][:4]
    assert resumed["start_step"] == 4
    assert resumed["losses"] == straight["losses"][4:]
    for (path, a), (_, b) in zip(_leaves(straight["state"].params),
                                 _leaves(resumed["state"].params)):
        assert torch.equal(a, b), path
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt-2.bin", "ckpt-4.bin", "ckpt-6.bin"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def _jax_demo_tables(tmp_path, chip_uuid):
    """examples/demo_e2e.py's control plane through JAX's scheduler and
    configd on the twin's labels and chip: the tables after binding, and
    after mnist-a's deletion with the leaf's availability."""
    import yaml

    demo = _twin("demo_e2e_torch")
    C, api = jax_constants, jax_api
    cluster = JaxFakeCluster()
    cluster.add_node(api.Node(demo.NODE, {C.NODE_LABEL_FILTER: "true"}))
    chip = JaxChipInfo(chip_uuid, 80 << 30, demo.H100, 0)
    plugin = JaxScheduler(
        jax_load_config(text=yaml.dump(demo.demo_topology(demo.H100))),
        cluster, lambda n: [chip], clock=api.FakeClock(0.0))
    engine = JaxEngine(plugin, cluster, plugin.clock)
    for name in demo.PODS:
        cluster.create_pod(api.Pod(
            name=name, scheduler_name=C.SCHEDULER_NAME,
            labels={C.POD_GPU_REQUEST: "0.5", C.POD_GPU_LIMIT: "1.0",
                    C.POD_GPU_MEMORY: str(demo.POD_MEMORY)}))
    placed = {}
    for result in engine.run_until_idle():
        pod = cluster.get_pod("default", result.pod_key.split("/")[1])
        placed[pod.name] = (result.node,
                            pod.annotations[C.POD_GPU_UUID],
                            int(pod.annotations[C.POD_MANAGER_PORT]))
        cluster.set_pod_phase("default", pod.name, api.PodPhase.RUNNING)
    daemon = JaxConfigDaemon(demo.NODE, cluster=cluster,
                             config_dir=str(tmp_path / "config"),
                             port_dir=str(tmp_path / "ports"))

    def tables():
        return {kind: (tmp_path / kind / chip_uuid).read_text()
                for kind in ("config", "ports")}

    daemon.sync()
    bound = tables()
    cluster.delete_pod("default", "mnist-a")
    daemon.sync()
    leaf = plugin.allocator.leaf_cells[chip_uuid]
    return placed, bound, tables(), leaf.available, leaf.free_memory


def test_demo_e2e_tables_and_reclaim_equal_jaxs(tmp_path):
    summary = _twin("demo_e2e_torch").main(["--device", "cpu"])
    placed, bound, reclaimed, available, free = _jax_demo_tables(
        tmp_path, summary["chip"])
    assert {name: (p["node"], p["uuid"], p["port"])
            for name, p in summary["placements"].items()} == placed
    assert summary["files"] == bound
    assert summary["reclaim"]["files"] == reclaimed
    assert (summary["reclaim"]["available"],
            summary["reclaim"]["free_memory"]) == (available, free)
    assert summary["reclaim"]["pod_managers"] == [
        f"default/mnist-b {placed['mnist-b'][2]}"]
    for name in ("mnist-a", "mnist-b"):
        assert summary["steps"][name]["tokens"] >= 1
        assert summary["tokend"][f"default/{name}"]["grants"] >= 1
        assert summary["tokend"][f"default/{name}"]["mem_cap"] == 4 << 30
    # the injected env names the chip the port's way
    env = summary["placements"]["mnist-a"]["env"]
    assert env["NVIDIA_VISIBLE_DEVICES"] == summary["chip"]
    assert env["POD_NAME"] == "default/mnist-a"
