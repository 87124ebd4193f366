"""The port's scheduler against the JAX package's (tests/test_scheduler.py,
tests/test_multislice.py's placement cases): every scenario runs twice,
once over kubeshare_tpu's cluster / scheduler / cell modules and once over
kubeshare_tpu_torch's, and the two runs must agree on every cycle's
result and message, every pod's node, annotations, volumes and ports,
the allocator's whole state, the gang ranks and slice plans, and the
metric text byte for byte.  The env differs only as the port's plugin
says (its docstring's table): :func:`port_env_of` maps JAX's env onto
the port's, and nothing else is excused.

Then the port's own contracts: the fractional env against the hook's
``hook_env``, the gang env against the port's ``spec_from_env`` /
``multislice_spec_from_env``, the revert list, and a seeded trace of
about 200 pod events through both schedulers over a topology with mesh
coordinates and one of CUDA cards without."""

import random
from types import SimpleNamespace

import pytest

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.cell import load_config as jax_load_config
from kubeshare_tpu.cell.allocator import ChipInfo as JaxChipInfo
from kubeshare_tpu.cluster import api as jax_api
from kubeshare_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from kubeshare_tpu.parallel import distributed as jax_distributed
from kubeshare_tpu.scheduler import framework as jax_framework
from kubeshare_tpu.scheduler import leader as jax_leader
from kubeshare_tpu.scheduler import plugin as jax_plugin
from kubeshare_tpu.scheduler import podspec as jax_podspec
from kubeshare_tpu.utils import promtext as jax_promtext
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.cell import load_config as port_load_config
from kubeshare_tpu_torch.cell.allocator import ChipInfo as PortChipInfo
from kubeshare_tpu_torch.cell.topology import LinkRecord
from kubeshare_tpu_torch.cluster import api as port_api
from kubeshare_tpu_torch.cluster.fake import FakeCluster as PortFakeCluster
from kubeshare_tpu_torch.isolation import hook
from kubeshare_tpu_torch.parallel import distributed as port_distributed
from kubeshare_tpu_torch.scheduler import framework as port_framework
from kubeshare_tpu_torch.scheduler import leader as port_leader
from kubeshare_tpu_torch.scheduler import plugin as port_plugin
from kubeshare_tpu_torch.scheduler import podspec as port_podspec
from kubeshare_tpu_torch.utils import promtext as port_promtext


def _pkg(name, C, load_config, ChipInfo, api, FakeCluster, plugin, framework,
         leader, podspec, promtext, distributed):
    return SimpleNamespace(
        name=name, C=C, load_config=load_config, ChipInfo=ChipInfo,
        Node=api.Node, Pod=api.Pod, PodPhase=api.PodPhase,
        FakeClock=api.FakeClock, ClusterAPI=api.ClusterAPI,
        FakeCluster=FakeCluster, KubeShareScheduler=plugin.KubeShareScheduler,
        SchedulerArgs=plugin.SchedulerArgs,
        SchedulerEngine=framework.SchedulerEngine,
        LeaderElector=leader.LeaderElector, PodStatus=podspec.PodStatus,
        parse_pod_labels=podspec.parse_pod_labels,
        PodLabelError=podspec.PodLabelError,
        encode=promtext.encode_families, distributed=distributed)


JAX = _pkg("jax", jax_constants, jax_load_config, JaxChipInfo, jax_api,
           JaxFakeCluster, jax_plugin, jax_framework, jax_leader,
           jax_podspec, jax_promtext, jax_distributed)
PORT = _pkg("port", constants, port_load_config, PortChipInfo, port_api,
            PortFakeCluster, port_plugin, port_framework, port_leader,
            port_podspec, port_promtext, port_distributed)

# tests/test_scheduler.py's topology and inventory: chips with mesh coords
TOPOLOGY = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  2-V4-NODE:
    childCellType: V4-NODE
    childCellNumber: 2
  V5E-NODE:
    childCellType: "TPU-v5e"
    childCellNumber: 8
    childCellPriority: 80
    isNodeLevel: true
cells:
- cellType: 2-V4-NODE
  cellChildren:
  - cellId: host-a
  - cellId: host-b
- cellType: V5E-NODE
  cellId: host-c
"""
HBM = 32 << 30
INVENTORY = {
    "host-a": [(f"host-a-tpu-{i}", HBM, "TPU-v4", i, (i, 0, 0)) for i in range(4)],
    "host-b": [(f"host-b-tpu-{i}", HBM, "TPU-v4", i, (i, 1, 0)) for i in range(4)],
    "host-c": [(f"host-c-tpu-{i}", 16 << 30, "TPU-v5e", i, None) for i in range(8)],
}

# CUDA cards as the port's collector reports them: NVML UUIDs, no coords
H100 = "NVIDIA-H100-80GB-HBM3"
A100 = "NVIDIA-A100-SXM4-40GB"
GPU_TOPOLOGY = """
cellTypes:
  4-H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 4
    childCellPriority: 100
    isNodeLevel: true
  2-H100-RACK:
    childCellType: 4-H100-NODE
    childCellNumber: 2
  2-A100-NODE:
    childCellType: "NVIDIA-A100-SXM4-40GB"
    childCellNumber: 2
    childCellPriority: 50
    isNodeLevel: true
cells:
- cellType: 2-H100-RACK
  cellChildren:
  - cellId: gpu-a
  - cellId: gpu-b
- cellType: 2-A100-NODE
  cellId: gpu-c
"""
GPU_INVENTORY = {
    "gpu-a": [(f"GPU-a{i}7e3c-0000-4000-8000-00000000000{i}", 80 << 30, H100,
               i, None) for i in range(4)],
    "gpu-b": [(f"GPU-b{i}9f1d-0000-4000-8000-00000000000{i}", 80 << 30, H100,
               i, None) for i in range(4)],
    "gpu-c": [(f"GPU-c{i}2a4b-0000-4000-8000-00000000000{i}", 40 << 30, A100,
               i, None) for i in range(2)],
}

# tests/test_multislice.py's topologies
TWO_SLICE_TOPOLOGY = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  V4-SLICE:
    childCellType: V4-NODE
    childCellNumber: 2
cells:
- cellType: V4-SLICE
  cellId: slice-a
  cellChildren:
  - cellId: a1
  - cellId: a2
- cellType: V4-SLICE
  cellId: slice-b
  cellChildren:
  - cellId: b1
  - cellId: b2
"""
TWO_SLICE_INVENTORY = {
    node: [(f"{node}-tpu-{i}", HBM, "TPU-v4", i, (i, row, 0)) for i in range(4)]
    for node, row in (("a1", 0), ("a2", 1), ("b1", 0), ("b2", 1))}
MARKED_SLICE_TOPOLOGY = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  V4-SLICE:
    childCellType: V4-NODE
    childCellNumber: 1
    isSliceLevel: true
  V4-REGION:
    childCellType: V4-SLICE
    childCellNumber: 2
cells:
- cellType: V4-REGION
  cellId: region-0
  cellChildren:
  - cellId: s0
    cellChildren:
    - cellId: host-1
  - cellId: s1
    cellChildren:
    - cellId: host-2
"""
MARKED_SLICE_INVENTORY = {
    node: [(f"{node}-tpu-{i}", HBM, "TPU-v4", i, (i, 0, 0)) for i in range(4)]
    for node in ("host-1", "host-2")}
UNEVEN_SLICE_TOPOLOGY = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  V4-SLICE:
    childCellType: V4-NODE
    childCellNumber: 2
  V4-SLICE-1:
    childCellType: V4-NODE
    childCellNumber: 1
cells:
- cellType: V4-SLICE
  cellId: slice-a
  cellChildren:
  - cellId: a1
  - cellId: a2
- cellType: V4-SLICE-1
  cellId: slice-b
  cellChildren:
  - cellId: b1
"""
UNEVEN_SLICE_INVENTORY = {n: TWO_SLICE_INVENTORY[n] for n in ("a1", "a2", "b1")}

# the names the port's plugin injects, by pod kind (its docstring's table)
LIBTPU_ONLY = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "MEGASCALE_COORDINATOR_ADDRESS",
               "MEGASCALE_PORT")
GANG_ONLY = ("TPU_PROCESS_BOUNDS", "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID")


def port_env_of(jax_env, annotations):
    """JAX's injected env as the port injects it, through the table of the
    port plugin's docstring and nothing else: the chip indices become
    the cell UUIDs (the pod's ``gpu_uuid`` annotation) with the driver
    capabilities beside them, the JAX shim becomes the CUDA hook, and
    libtpu's own names go; a pod outside a gang keeps no process grid."""
    env = dict(jax_env)
    if env.pop("TPU_VISIBLE_CHIPS", None) is not None:
        env[constants.ENV_VISIBLE_DEVICES] = annotations[constants.POD_GPU_UUID]
        env[constants.ENV_DRIVER_CAPABILITIES] = "compute,utility"
    if env.get("LD_PRELOAD") == jax_constants.SHIM_LIBRARY:
        env["LD_PRELOAD"] = constants.SHIM_LIBRARY
    for name in LIBTPU_ONLY:
        env.pop(name, None)
    if port_distributed.ENV_GANG_NAME not in env:
        for name in GANG_ONLY:
            env.pop(name, None)
    return env


class Side:
    """One package's cluster, scheduler and engine over a topology."""

    def __init__(self, pkg, topology=TOPOLOGY, inventory=INVENTORY,
                 nodes=None, bind_mode="patch", port_pool=None):
        self.p = pkg
        self.topology = topology
        self.inv = {node: [pkg.ChipInfo(*chip) for chip in chips]
                    for node, chips in inventory.items()}
        self.cluster = pkg.FakeCluster()
        for node in (nodes if nodes is not None else inventory):
            self.cluster.add_node(self.node(node))
        self.clock = pkg.FakeClock(1000.0)
        self.args = dict(bind_mode=bind_mode)
        if port_pool is not None:
            self.args["port_pool_size"] = port_pool
        self.plugin, self.engine = self.restart()
        self.results = []
        self.snaps = []

    def node(self, name, ready=True):
        return self.p.Node(name=name, labels={self.p.C.NODE_LABEL_FILTER: "true"},
                           ready=ready)

    def restart(self):
        """A fresh scheduler process over the same cluster."""
        plugin = self.p.KubeShareScheduler(
            topology=self.p.load_config(text=self.topology),
            cluster=self.cluster, inventory=lambda n: self.inv.get(n, []),
            args=self.p.SchedulerArgs(**self.args), clock=self.clock)
        engine = self.p.SchedulerEngine(plugin, self.cluster, self.clock)
        self.plugin, self.engine = plugin, engine
        return plugin, engine

    def pod(self, name, request="0.5", limit="1.0", mem=None, priority=None,
            model=None, group=None, headcount=None, threshold=None,
            namespace="default", labels=None):
        C = self.p.C
        if labels is None:
            labels = {C.POD_GPU_LIMIT: limit}
            if request is not None:
                labels[C.POD_GPU_REQUEST] = request
            if mem is not None:
                labels[C.POD_GPU_MEMORY] = str(mem)
            if priority is not None:
                labels[C.POD_PRIORITY] = str(priority)
            if model is not None:
                labels[C.POD_GPU_MODEL] = model
            if group is not None:
                labels[C.POD_GROUP_NAME] = group
                labels[C.POD_GROUP_HEADCOUNT] = str(headcount)
                labels[C.POD_GROUP_THRESHOLD] = str(threshold)
        self.cluster.create_pod(self.p.Pod(
            namespace=namespace, name=name, labels=dict(labels),
            scheduler_name=C.SCHEDULER_NAME))

    def run(self):
        results = self.engine.run_until_idle()
        self.results.extend(results)
        return results

    def once(self):
        result = self.engine.run_once()
        self.results.append(result)
        return result

    def snap(self):
        self.snaps.append(observe(self))


def observe(side):
    """Everything the two schedulers must agree on, as plain data."""
    plugin = side.plugin
    pods = []
    for pod in sorted(side.cluster.list_pods(), key=lambda p: p.key):
        envs = [c.env for c in pod.containers]
        if side.p is JAX:
            envs = [port_env_of(env, pod.annotations) for env in envs]
        pods.append((pod.key, pod.node_name, pod.phase.value,
                     dict(pod.labels), dict(pod.annotations), envs,
                     [list(c.volume_mounts) for c in pod.containers],
                     list(pod.volumes)))
    ports = {}
    for node, bitmap in sorted(plugin.port_bitmaps.items()):
        ports[node] = ([i for i in range(bitmap.capacity) if bitmap.is_masked(i)],
                       bitmap._current)
    groups = {}
    for key, info in sorted(plugin.pod_groups._groups.items()):
        groups[key] = (info.name, info.priority, info.timestamp,
                       info.min_available, info.head_count, info.threshold,
                       info.deletion_timestamp, dict(info.assigned_ranks),
                       list(info.slice_plan.items()))
    statuses = {}
    for key, s in sorted(plugin.pod_status.items()):
        statuses[key] = (s.limit, s.request, s.memory, s.model, s.priority,
                         s.uuid, [c.id for c in s.cells], s.port,
                         s.node_name, s.pod_group, s.min_available)
    leaves = []
    for uuid, leaf in sorted(plugin.allocator.leaf_cells.items()):
        leaves.append((uuid, leaf.id, leaf.node, round(leaf.available, 9),
                       leaf.free_memory, leaf.full_memory, leaf.healthy))
    roots = []
    for model in sorted(plugin.allocator.free_list):
        for level, cells in sorted(plugin.allocator.free_list[model].items()):
            for root in cells:
                for c in root.walk():
                    roots.append((c.id, round(c.available, 9),
                                  round(c.available_whole_cell, 9),
                                  c.free_memory, c.full_memory, c.healthy,
                                  c.state.value))
    return {
        "results": [(r.pod_key, r.result, r.message, r.node) if r else None
                    for r in side.results],
        "pods": pods, "ports": ports, "groups": groups, "status": statuses,
        "leaves": leaves, "cells": roots, "waiting": side.engine.waiting_count(),
        "metrics": side.p.encode(plugin.collect_metrics()),
    }


def assert_same(port_obs, jax_obs):
    for key in jax_obs:
        assert port_obs[key] == jax_obs[key], key


def twin(scenario, **kwargs):
    """``scenario(side)`` over both packages; returns the port's side.
    Whatever the scenario returns, and every ``side.snap()``, must agree
    too."""
    out, sides = {}, {}
    for pkg in (JAX, PORT):
        side = Side(pkg, **kwargs)
        out[pkg.name] = scenario(side)
        side.snap()
        sides[pkg.name] = side
    assert len(sides["port"].snaps) == len(sides["jax"].snaps)
    for port_obs, jax_obs in zip(sides["port"].snaps, sides["jax"].snaps):
        assert_same(port_obs, jax_obs)
    assert out["port"] == out["jax"]
    return sides["port"]


def env_of(side, name, namespace="default"):
    return side.cluster.get_pod(namespace, name).containers[0].env


# ---- tests/test_scheduler.py: TestSchedulingPipeline ----------------------

def _fractional(side):
    side.pod("mnist1", request="0.5", limit="1.0", priority="100")
    side.run()


def _guarantee_prefers_priority(side):
    side.pod("g", request="0.5", limit="1.0", priority="50")
    side.run()


def _opportunistic_packs(side):
    side.pod("seed", request="0.4", limit="1.0")
    side.run()
    side.pod("opp", request="0.3", limit="1.0")
    side.run()


def _guarantee_spreads(side):
    side.pod("g1", request="0.6", limit="1.0", priority="10")
    side.run()
    side.pod("g2", request="0.6", limit="1.0", priority="10")
    side.run()


def _model_selector(side):
    side.pod("m", request="0.5", limit="1.0", model="TPU-v4")
    side.run()
    side.pod("m9", request="0.5", limit="1.0", model="TPU-v9")
    side.run()


def _multichip(side):
    side.pod("big", request="3.0", limit="3.0")
    side.run()


def _memory_cap(side):
    side.pod("fat", request="0.5", limit="1.0", mem=30 << 30)
    side.run()
    side.pod("fat2", request="0.4", limit="1.0", mem=4 << 30)
    side.run()


def _cluster_full(side):
    for i in range(4):
        side.pod(f"p{i}", request="1.0", limit="1.0")
    side.run()
    side.pod("p5", request="1.0", limit="1.0")
    side.run()


def _regular_pod(side):
    side.cluster.add_node(side.p.Node(name="cpu-node"))
    side.cluster.create_pod(side.p.Pod(name="web",
                                       scheduler_name=side.p.C.SCHEDULER_NAME))
    side.run()


def _delete_reclaims(side):
    side.pod("p", request="0.5", limit="1.0")
    side.run()
    side.snap()
    side.cluster.delete_pod("default", "p")
    side.snap()
    side.pod("q", request="0.5", limit="1.0")
    side.run()


def _completed_reclaims(side):
    side.pod("job", request="0.5", limit="1.0")
    side.run()
    side.cluster.set_pod_phase("default", "job", side.p.PodPhase.SUCCEEDED)


def _shadow(side):
    side.pod("s", request="0.5", limit="1.0")
    side.pod("big", request="2", limit="2")
    side.run()


def _node_delete(side):
    side.pod("p", request="0.5", limit="1.0")
    side.run()
    side.cluster.delete_node("host-a")
    side.pod("q", request="0.5", limit="1.0")
    side.run()
    return sorted(k[0] for k in side.plugin._node_score_cache)


PIPELINE = {
    "fractional": (_fractional, {}),
    "guarantee_prefers_priority": (_guarantee_prefers_priority, {}),
    "opportunistic_packs": (_opportunistic_packs,
                            {"nodes": ("host-a", "host-b")}),
    "guarantee_spreads": (_guarantee_spreads, {"nodes": ("host-a",)}),
    "model_selector": (_model_selector, {}),
    "multichip": (_multichip, {}),
    "memory_cap": (_memory_cap, {"nodes": ("host-a",)}),
    "cluster_full": (_cluster_full, {"nodes": ("host-a",)}),
    "regular_pod": (_regular_pod, {"nodes": ("host-a",)}),
    "delete_reclaims": (_delete_reclaims, {"nodes": ("host-a",)}),
    "completed_reclaims": (_completed_reclaims, {"nodes": ("host-a",)}),
    "shadow": (_shadow, {"bind_mode": "shadow"}),
    "node_delete": (_node_delete, {"nodes": ("host-a", "host-b")}),
    "gpu_fractional": (_fractional, {"topology": GPU_TOPOLOGY,
                                     "inventory": GPU_INVENTORY}),
    "gpu_multichip": (_multichip, {"topology": GPU_TOPOLOGY,
                                   "inventory": GPU_INVENTORY}),
    "gpu_packs": (_opportunistic_packs, {"topology": GPU_TOPOLOGY,
                                         "inventory": GPU_INVENTORY}),
    "gpu_shadow": (_shadow, {"topology": GPU_TOPOLOGY,
                             "inventory": GPU_INVENTORY,
                             "bind_mode": "shadow"}),
}


@pytest.mark.parametrize("case", sorted(PIPELINE))
def test_pipeline_matches(case):
    scenario, kwargs = PIPELINE[case]
    twin(scenario, **kwargs)


def test_shadow_bound_pod_deleted_before_the_next_filter():
    """A pod deleted after its shadow bind gives its cell back in the
    port.  JAX's plugin takes the add event of its own shadow copy,
    which arrives before the copy's uid is known, for a pod bound before
    a restart and queues it for recovery; the node's next Filter then
    reserves the deleted pod's cell again, for nobody."""
    held, tracked = {}, {}
    for pkg in (JAX, PORT):
        side = Side(pkg, topology=GPU_TOPOLOGY, inventory=GPU_INVENTORY,
                    nodes=("gpu-a",), bind_mode="shadow")
        side.pod("p", request="0.5", limit="1.0")
        assert [r.result for r in side.run()] == ["bound"]
        side.cluster.delete_pod("default", "p")
        side.pod("q", request="0.5", limit="1.0")
        assert [r.result for r in side.run()] == ["bound"]
        leaves = side.plugin.allocator.leaf_cells.values()
        held[pkg.name] = sum(1.0 - leaf.available for leaf in leaves)
        tracked[pkg.name] = sorted(side.plugin.pod_status)
    assert held == {"port": 0.5, "jax": 1.0}
    assert tracked == {"port": ["default/q"],
                       "jax": ["default/p", "default/q"]}


def test_fractional_pod_env_is_the_cuda_pods():
    port = twin(_fractional, topology=GPU_TOPOLOGY, inventory=GPU_INVENTORY)
    pod = port.cluster.get_pod("default", "mnist1")
    uuid = pod.annotations[constants.POD_GPU_UUID]
    port_number = int(pod.annotations[constants.POD_MANAGER_PORT])
    memory = int(pod.annotations[constants.POD_GPU_MEMORY])
    leaf = port.plugin.allocator.leaf_cells[uuid]
    assert memory == int(0.5 * leaf.full_memory)
    assert pod.containers[0].env == {
        "NVIDIA_VISIBLE_DEVICES": uuid,
        "NVIDIA_DRIVER_CAPABILITIES": "compute,utility",
        "LD_PRELOAD": "/kubeshare/library/libcudahook.so.1",
        "POD_MANAGER_PORT": str(port_number),
        "POD_NAME": "default/mnist1",
        "TPUSHARE_MEM_BYTES": str(memory),
        "TPUSHARE_MEM_FRACTION": "0.5000",
    }
    assert pod.volumes == [constants.LIBRARY_PATH]
    assert pod.containers[0].volume_mounts == [constants.LIBRARY_PATH]


def test_fractional_env_agrees_with_the_hooks():
    """The hook (csrc/cuda_hook.cc through isolation/hook.py) and the
    scheduler cannot drift apart: every name ``hook_env`` sets, the
    library aside, has the scheduler's value, and the scheduler adds only
    the device visibility and the cap in bytes.  ``POD_MANAGER_IP`` is
    not injected: the hook's client falls back to the node's
    schedulerIP.txt, then to 127.0.0.1."""
    port = twin(_memory_cap, topology=GPU_TOPOLOGY, inventory=GPU_INVENTORY,
                nodes=("gpu-a",))
    for name in ("fat", "fat2"):
        pod = port.cluster.get_pod("default", name)
        env = pod.containers[0].env
        uuid = pod.annotations[constants.POD_GPU_UUID]
        memory = int(pod.annotations[constants.POD_GPU_MEMORY])
        fraction = memory / port.plugin.allocator.leaf_cells[uuid].full_memory
        expected = hook.hook_env(
            int(pod.annotations[constants.POD_MANAGER_PORT]), pod.key,
            mem_fraction=fraction, library=constants.SHIM_LIBRARY)
        assert expected.pop("POD_MANAGER_IP") == "127.0.0.1"
        assert {k: env[k] for k in expected} == expected
        assert set(env) - set(expected) == {
            constants.ENV_VISIBLE_DEVICES, constants.ENV_DRIVER_CAPABILITIES,
            constants.ENV_MEM_BYTES}


def test_multichip_env_has_no_hook_and_no_libtpu_names():
    port = twin(_multichip, topology=GPU_TOPOLOGY, inventory=GPU_INVENTORY)
    pod = port.cluster.get_pod("default", "big")
    uuids = pod.annotations[constants.POD_GPU_UUID]
    assert len(uuids.split(",")) == 3
    assert pod.containers[0].env == {
        "NVIDIA_VISIBLE_DEVICES": uuids,
        "NVIDIA_DRIVER_CAPABILITIES": "compute,utility",
        "POD_NAME": "default/big"}
    assert constants.POD_MANAGER_PORT not in pod.annotations
    assert pod.volumes == []


# ---- TestGangScheduling, TestRecovery, TestReviewRegressions ---------------

def _gang(side, name="team", n=3, headcount=3, threshold=1.0, request="0.5",
          limit="1.0", priority=None, prefix="w", namespace="default"):
    for i in range(n):
        side.pod(f"{prefix}{i}", request=request, limit=limit,
                 priority=priority, group=name, headcount=headcount,
                 threshold=threshold, namespace=namespace)


def _gang_waits(side):
    _gang(side)
    side.run()


def _gang_below_min(side):
    _gang(side, n=1)
    side.run()


def _gang_timeout(side):
    _gang(side, name="gang", n=2, headcount=2, request="3.0", limit="3.0",
          prefix="g")
    side.run()
    side.snap()
    side.clock.advance(10)
    side.engine.expire_waiting_pods()


def _gang_threshold(side):
    _gang(side, name="half", n=2, headcount=4, threshold=0.5, prefix="t")
    side.run()


def _queue_sort(side):
    side.pod("low", request="0.5", limit="1.0", priority="1")
    side.pod("high", request="0.5", limit="1.0", priority="90")
    return [p.key for p in side.engine.pending_pods()]


def _recovery(side):
    side.pod("p", request="0.5", limit="1.0", mem=1 << 30)
    side.pod("big", request="2", limit="2")
    side.run()
    side.snap()
    side.restart()
    side.pod("q", request="0.6", limit="1.0", mem=1 << 30)
    side.run()


def _node_failure(side):
    side.cluster.update_node(side.node("host-a", ready=False))
    side.pod("p", request="0.5", limit="1.0")
    side.run()
    side.cluster.update_node(side.node("host-a"))
    side.pod("q", request="0.5", limit="1.0", priority="20")
    side.run()


def _malformed_priority(side):
    side.pod("bad", labels={side.p.C.POD_PRIORITY: "high",
                            side.p.C.POD_GPU_LIMIT: "1"})
    side.pod("good", request="0.5", limit="1.0")
    side.run()


def _fractional_release(side):
    for name, request in (("a", "0.3"), ("b", "0.1")):
        side.pod(name, request=request, limit="1.0", mem=1)
    side.run()
    side.cluster.delete_pod("default", "a")
    side.cluster.delete_pod("default", "b")
    side.pod("whole", request="1.0", limit="1.0")
    side.run()


def _failed_gang_member(side):
    _gang(side, name="gg", n=2, headcount=2, threshold=0.5, request="0.2",
          prefix="g")
    side.run()
    side.cluster.set_pod_phase("default", "g0", side.p.PodPhase.FAILED)
    side.cluster.delete_pod("default", "g1")
    side.cluster.delete_pod("default", "g0")
    side.snap()
    side.pod("g-new", request="0.2", limit="1.0", group="gg", headcount=2,
             threshold=0.5)
    side.run()
    side.cluster.delete_pod("default", "g-new")
    side.clock.advance(side.p.C.POD_GROUP_EXPIRATION_TIME_SECONDS + 1)
    side.plugin.pod_groups.gc()


def _rank_reuse(side):
    _gang(side, name="ddp")
    side.run()
    victim = next(f"w{i}" for i in range(3)
                  if env_of(side, f"w{i}")["TPUSHARE_GANG_RANK"] == "1")
    side.cluster.delete_pod("default", victim)
    side.pod("w-new", request="0.5", limit="1.0", group="ddp", headcount=3,
             threshold=1.0)
    side.run()


def _recovered_rank(side):
    _gang(side, name="gg2", n=2, headcount=2, prefix="r")
    side.run()
    side.restart()
    side.pod("trigger", request="0.1", limit="1.0")
    side.run()


def _namespaces(side):
    for ns in ("alpha", "beta"):
        _gang(side, n=2, headcount=2, namespace=ns)
    side.run()
    side.cluster.delete_pod("alpha", "w0")
    side.cluster.delete_pod("alpha", "w1")


def _same_pod_name(side):
    for ns in ("alpha", "beta"):
        side.pod("same-name", request="0.5", limit="1.0", namespace=ns)
    side.run()


def _locality(side):
    _gang(side, name="loc", n=2, headcount=2, threshold=0.5, request="1.0",
          priority="50", prefix="g")
    side.run()


def _port_pool_exhausted(side):
    for i in range(5):
        side.pod(f"p{i}", request="0.1", limit="1.0", mem=1)
    side.run()
    side.cluster.delete_pod("default", "p1")
    side.pod("p5", request="0.1", limit="1.0", mem=1)
    side.run()


GANGS = {
    "gang_waits": (_gang_waits, {}),
    "gang_below_min": (_gang_below_min, {}),
    "gang_timeout": (_gang_timeout, {"nodes": ("host-a",)}),
    "gang_threshold": (_gang_threshold, {}),
    "queue_sort": (_queue_sort, {"nodes": ("host-a",)}),
    "recovery": (_recovery, {"nodes": ("host-a",)}),
    "node_failure": (_node_failure, {"nodes": ("host-a", "host-b")}),
    "malformed_priority": (_malformed_priority, {"nodes": ("host-a",)}),
    "fractional_release": (_fractional_release, {"nodes": ("host-a",)}),
    "failed_gang_member": (_failed_gang_member, {"nodes": ("host-a",)}),
    "rank_reuse": (_rank_reuse, {}),
    "recovered_rank": (_recovered_rank, {}),
    "namespaces": (_namespaces, {}),
    "same_pod_name": (_same_pod_name, {"nodes": ("host-a",)}),
    "locality": (_locality, {"nodes": ("host-a", "host-b")}),
    "port_pool_exhausted": (_port_pool_exhausted,
                            {"nodes": ("host-a",), "port_pool": 4}),
    "gpu_gang_timeout": (_gang_timeout, {"topology": GPU_TOPOLOGY,
                                         "inventory": GPU_INVENTORY,
                                         "nodes": ("gpu-c",)}),
    "gpu_recovery": (_recovery, {"topology": GPU_TOPOLOGY,
                                 "inventory": GPU_INVENTORY,
                                 "nodes": ("gpu-a",)}),
    "gpu_locality": (_locality, {"topology": GPU_TOPOLOGY,
                                 "inventory": GPU_INVENTORY,
                                 "nodes": ("gpu-a", "gpu-b")}),
}


@pytest.mark.parametrize("case", sorted(GANGS))
def test_gangs_recovery_and_regressions_match(case):
    scenario, kwargs = GANGS[case]
    twin(scenario, **kwargs)


# four H100 NVL cards bridged in pairs 0-2 and 1-3, each pair on one NUMA
# node (tests/test_torch_topology.py's nvl_pairs node), and their link
# records as the port's collector reports them
NVL_TOPOLOGY = """
cellTypes:
  4-NVL-NODE:
    childCellType: "NVIDIA-H100-NVL"
    childCellNumber: 4
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: 4-NVL-NODE
  cellId: nvl-a
"""
NVL_INVENTORY = {
    "nvl-a": [(f"GPU-d{i}4c1e-0000-4000-8000-00000000000{i}", 94 << 30,
               "NVIDIA-H100-NVL", i, None) for i in range(4)]}
NVL_RECORDS = [
    LinkRecord(f"00000000:{bus:02X}:00.0", numa,
               (f"pci0000:{bus - 2:02x}", f"0000:{bus - 2:02x}:01.0"),
               f"00000000:{peer:02X}:00.0")
    for bus, numa, peer in ((0x4F, 0, 0x4F), (0xCE, 1, 0xCE),
                            (0x52, 0, 0x4F), (0xD1, 1, 0xCE))]


def _whole_card_gang(side):
    """Two guaranteed members asking for one whole card each; returns the
    card each holds."""
    _gang(side, name="nvl", n=2, headcount=2, threshold=0.5, request="1.0",
          priority="50", prefix="m")
    side.run()
    return {key: s.uuid for key, s in sorted(side.plugin.pod_status.items())}


def test_a_whole_card_gang_member_takes_the_nvlink_peer():
    """The first member holds GPU 0.  Without records the second takes
    GPU 1, the nearest cell id, as JAX's scheduler does on the same cells;
    with them it takes GPU 2, GPU 0's NVLink peer (NV, distance 1), over
    GPU 1 and GPU 3 on the other NUMA node (SYS, 6)."""
    uuids = [chip[0] for chip in NVL_INVENTORY["nvl-a"]]
    kwargs = dict(topology=NVL_TOPOLOGY, inventory=NVL_INVENTORY)
    jax_side = Side(JAX, **kwargs)
    assert _whole_card_gang(jax_side) == {
        "default/m0": uuids[0], "default/m1": uuids[1]}
    twin(_whole_card_gang, **kwargs)  # the port without records: JAX's

    side = Side(PORT, **kwargs)
    for chip, record in zip(side.inv["nvl-a"], NVL_RECORDS):
        chip.links = record
    side.restart()
    assert _whole_card_gang(side) == {
        "default/m0": uuids[0], "default/m1": uuids[2]}
    leaves = side.plugin.allocator.leaf_cells
    assert [leaves[u].links for u in uuids] == NVL_RECORDS


def test_gang_env_feeds_the_ports_bootstrap():
    """Each member's injected env, read by the port's spec_from_env, gives
    the size and the rank JAX's scheduler assigned (its TPUSHARE_* env
    through JAX's own spec_from_env)."""
    sides = {}
    for pkg in (JAX, PORT):
        sides[pkg.name] = side = Side(pkg)
        _gang(side, name="ddp")
        side.run()
    ranks = set()
    for i in range(3):
        jax_spec = jax_distributed.spec_from_env(env_of(sides["jax"], f"w{i}"))
        port_spec = port_distributed.spec_from_env(env_of(sides["port"], f"w{i}"))
        assert port_spec is not None and port_spec.num_processes == 3
        assert (port_spec.num_processes, port_spec.process_id,
                port_spec.coordinator_address) == (
            jax_spec.num_processes, jax_spec.process_id,
            jax_spec.coordinator_address)
        assert port_distributed.multislice_spec_from_env(
            env_of(sides["port"], f"w{i}")) is None
        ranks.add(port_spec.process_id)
    assert ranks == {0, 1, 2}


def test_revert_list_removes_every_injected_name():
    """A gang timeout reverts its reserved members: none of the names the
    port's plugin injects (fractional, multi-chip, gang, multi-slice)
    stays in the pod, and the user's own env does."""
    names = set(port_framework.injected_env_names())
    side = Side(PORT, topology=MARKED_SLICE_TOPOLOGY,
                inventory=MARKED_SLICE_INVENTORY, nodes=("host-1",))
    _gang(side, name="big", n=2, headcount=2, request="4.0", limit="4.0",
          priority=100)
    _gang(side, name="frac", n=2, headcount=2, request="0.5", limit="1.0",
          prefix="f")
    pods = side.cluster.list_pods()
    for pod in pods:
        updated = pod.copy()
        updated.containers[0].env["USER_VAR"] = "kept"
        side.cluster.update_pod(updated)
    # a reserved member's env carries every name of its kind
    side.plugin.reserve(side.cluster.get_pod("default", "w0"), "host-1")
    side.plugin.reserve(side.cluster.get_pod("default", "f0"), "host-1")
    injected = set(env_of(side, "w0")) | set(env_of(side, "f0"))
    assert injected - {"USER_VAR"} <= names
    for name in ("w0", "f0"):
        side.engine.unreserve(side.cluster.get_pod("default", name))
        pod = side.cluster.get_pod("default", name)
        assert pod.containers[0].env == {"USER_VAR": "kept"}
        assert pod.volumes == [] and pod.containers[0].volume_mounts == []
        assert not pod.is_bound()
    # every kind of pod the plugin places injects only listed names
    for kind in (_fractional, _multichip, _gang_waits):
        placed = Side(PORT)
        kind(placed)
        for pod in placed.cluster.list_pods():
            assert set(pod.containers[0].env) <= names, pod.key
    cross = Side(PORT, topology=MARKED_SLICE_TOPOLOGY,
                 inventory=MARKED_SLICE_INVENTORY)
    _gang(cross, name="big", n=2, headcount=2, request="4.0", limit="4.0",
          priority=100)
    cross.run()
    seen = set()
    for pod in cross.cluster.list_pods():
        seen |= set(pod.containers[0].env)
    assert {"MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
            "TPU_PROCESS_BOUNDS"} <= seen <= names


# ---- tests/test_multislice.py: slice plans and the megascale env -----------

def _cross_slice(side):
    _gang(side, name="big", n=2, headcount=2, request="4.0", limit="4.0",
          priority=100)
    side.run()
    leaves = [side.plugin.allocator.leaf_cells_by_node(n)[0]
              for n in ("host-1", "host-2")]
    return ([side.plugin.slice_of(leaf) for leaf in leaves],
            side.plugin.cell_distance(*leaves))


def _four_member_grid(side):
    _gang(side, name="grid", n=4, headcount=4, request="4.0", limit="4.0",
          priority=100)
    side.run()


def _same_slice_gang(side):
    _gang(side, name="ring", n=2, headcount=2, request="4.0", limit="4.0",
          priority=100)
    side.run()
    a1, b1 = (side.plugin.allocator.leaf_cells_by_node(n)[0]
              for n in ("a1", "b1"))
    return side.plugin.cell_distance(a1, b1) >= side.plugin.DCN_CROSSING_COST


def _uneven_slices(side):
    _gang(side, name="odd", n=3, headcount=3, request="4.0", limit="4.0",
          priority=100)
    side.run()


def _fractional_gang_in_slices(side):
    _gang(side, name="small", n=2, headcount=2, request="0.5", limit="0.5",
          priority=0)
    side.run()


SLICES = {
    "cross_slice": (_cross_slice, {"topology": MARKED_SLICE_TOPOLOGY,
                                   "inventory": MARKED_SLICE_INVENTORY}),
    "four_member_grid": (_four_member_grid,
                         {"topology": TWO_SLICE_TOPOLOGY,
                          "inventory": TWO_SLICE_INVENTORY}),
    "same_slice_gang": (_same_slice_gang, {"topology": TWO_SLICE_TOPOLOGY,
                                           "inventory": TWO_SLICE_INVENTORY}),
    "uneven_slices": (_uneven_slices, {"topology": UNEVEN_SLICE_TOPOLOGY,
                                       "inventory": UNEVEN_SLICE_INVENTORY}),
    "fractional_gang_in_slices": (_fractional_gang_in_slices,
                                  {"topology": TWO_SLICE_TOPOLOGY,
                                   "inventory": TWO_SLICE_INVENTORY}),
}


@pytest.mark.parametrize("case", sorted(SLICES))
def test_slice_plans_match(case):
    scenario, kwargs = SLICES[case]
    twin(scenario, **kwargs)


@pytest.mark.parametrize("case", ["cross_slice", "four_member_grid"])
def test_slice_env_feeds_the_ports_multislice_spec(case):
    """The port's multislice_spec_from_env over each member's injected
    env gives the slice layout JAX's scheduler planned (its MEGASCALE_*
    env through JAX's own reader)."""
    scenario, kwargs = SLICES[case]
    sides = {}
    for pkg in (JAX, PORT):
        sides[pkg.name] = side = Side(pkg, **kwargs)
        scenario(side)
    names = [p.name for p in sides["port"].cluster.list_pods()]
    slice_ids = set()
    for name in names:
        jax_ms = jax_distributed.multislice_spec_from_env(
            env_of(sides["jax"], name))
        port_ms = port_distributed.multislice_spec_from_env(
            env_of(sides["port"], name))
        assert port_ms is not None
        assert (port_ms.num_slices, port_ms.slice_id,
                port_ms.processes_per_slice) == (
            jax_ms.num_slices, jax_ms.slice_id, jax_ms.processes_per_slice)
        port_spec = port_distributed.spec_from_env(env_of(sides["port"], name))
        jax_spec = jax_distributed.spec_from_env(env_of(sides["jax"], name))
        assert (port_spec.num_processes, port_spec.process_id) == (
            jax_spec.num_processes, jax_spec.process_id)
        slice_ids.add(port_ms.slice_id)
    assert slice_ids == {0, 1}


# ---- the reference's label matrix, the parser fuzz, scoring ---------------

SCENARIOS = [
    ({"r": "2.0", "l": "2.0"}, "bound"), ({"r": "1.0", "l": "1.0"}, "bound"),
    ({"r": "0.3", "l": "1.0"}, "bound"),
    ({"r": "0.3", "l": "1.0", "mem": "3073741824", "prio": "100"}, "bound"),
    ({"r": "2", "l": "2"}, "bound"), ({"r": "2", "l": "2.5"}, "unschedulable"),
    ({"r": "0.5", "l": "0.3"}, "unschedulable"),
    ({"r": "0.3", "l": "1.0", "model": "test"}, "unschedulable"),
    ({"r": "0.2", "l": "1.0"}, "bound"),
]


@pytest.mark.parametrize("spec,expected", SCENARIOS)
def test_reference_matrix_matches(spec, expected):
    def scenario(side):
        side.pod("scenario", request=spec["r"], limit=spec["l"],
                 mem=spec.get("mem"), priority=spec.get("prio"),
                 model=spec.get("model"))
        return side.run()[-1].result

    twin(scenario)
    side = Side(PORT)
    assert scenario(side) == expected


def test_label_parser_fuzz_matches():
    rng = random.Random(0)
    tokens = ["0.5", "1.0", "2", "2.0", "-1", "abc", "", "0x5", "1e3",
              "999999999999999999999", "0.0000001", " 1.0", "1.0 ", "nan",
              "inf", "-0.5", "1,0", "½", "2.5", "01.0", "100"]
    names = [constants.POD_GPU_LIMIT, constants.POD_GPU_REQUEST,
             constants.POD_GPU_MEMORY, constants.POD_PRIORITY,
             constants.POD_GROUP_NAME, constants.POD_GROUP_HEADCOUNT,
             constants.POD_GROUP_THRESHOLD, constants.POD_GPU_MODEL]
    outcomes = set()
    for i in range(500):
        labels = {n: rng.choice(tokens) for n in names if rng.random() < 0.5}
        got = []
        for pkg in (JAX, PORT):
            pod = pkg.Pod(name=f"fuzz-{i}", labels=dict(labels),
                          scheduler_name=pkg.C.SCHEDULER_NAME)
            try:
                status = pkg.parse_pod_labels(pod)
                got.append(None if status is None else (
                    status.limit, status.request, status.memory, status.model,
                    status.priority, status.pod_group, status.min_available))
            except pkg.PodLabelError as e:
                got.append(("error", str(e)))
        assert got[0] == got[1], labels
        outcomes.add("regular" if got[1] is None else
                     "error" if got[1][0] == "error" else "parsed")
    assert outcomes == {"regular", "error", "parsed"}


def _scores(side):
    status_cls = side.p.PodStatus
    opp = status_cls(namespace="default", name="x")
    guar = status_cls(namespace="default", name="x", priority=50)
    got = [side.plugin._opportunistic_node_score("host-a", opp),
           side.plugin._guarantee_node_score("host-a", guar)]
    side.pod("seed", request="0.4", limit="1.0")
    side.run()
    got += [side.plugin._opportunistic_node_score("host-a", opp),
            side.plugin._guarantee_node_score("host-a", guar)]
    side.cluster.delete_pod("default", "seed")
    side.run()
    got += [side.plugin._opportunistic_node_score("host-a", opp),
            side.plugin._guarantee_node_score("host-a", guar)]
    for scores in ({"a": -50.0, "b": 50.0}, {"a": 0.0, "b": 1000.0},
                   {"a": 500.0, "b": 500.0}, {}, {"a": -3.5, "b": 250.25}):
        got.append(side.plugin.normalize_scores(scores))
    return got


def test_scoring_formulas_match():
    port = twin(_scores, nodes=("host-a",))
    side = Side(PORT, nodes=("host-a",))
    got = _scores(side)
    assert abs(got[2] - (4 * 60 + 0.4 * 100 - (3 / 4) * 100) / 4) < 1e-9
    assert abs(got[3] - (4 * 60 - 0.4 * 100) / 4) < 1e-9
    assert got[6] == {"a": 0, "b": 100}
    assert port.plugin.normalize_scores({}) == {}


def test_metric_text_matches_byte_for_byte():
    def scenario(side):
        _gang(side, name="ddp")
        side.pod("big", request="2", limit="2")
        side.pod("frac", request="0.25", limit="0.5", mem=3 << 30)
        side.run()
        return side.p.encode(side.plugin.collect_metrics())

    port = twin(scenario)
    text = port.p.encode(port.plugin.collect_metrics())
    assert 'kubeshare_scheduler_pods{state="placed"} 5' in text
    assert text.startswith("# HELP kubeshare_scheduler_pods")


# ---- leader election (TestLeaderElection) -----------------------------------

def _two_instances(side):
    p = side.p
    plugin_b = p.KubeShareScheduler(
        topology=p.load_config(text=side.topology), cluster=side.cluster,
        inventory=lambda n: side.inv.get(n, []), clock=side.clock)
    engine_b = p.SchedulerEngine(plugin_b, side.cluster, side.clock)
    electors = {name: p.LeaderElector(side.cluster, name, lease_duration_s=15.0,
                                      clock=side.clock) for name in "ab"}
    engines = {"a": side.engine, "b": engine_b}
    side.pod("p1")
    cycles = {"a": 0, "b": 0}
    for _ in range(4):
        for name in "ab":
            if electors[name].is_leader() and engines[name].run_once() is not None:
                cycles[name] += 1
        side.clock.advance(1.0)
    side.clock.advance(20.0)
    side.pod("p2")
    took_over = electors["b"].is_leader()
    result = engine_b.run_once()
    return (cycles, took_over, (result.pod_key, result.result),
            electors["a"].is_leader())


def _steps_down(side):
    p = side.p

    class Flaky(p.FakeCluster):
        broken = False

        def lease_tryhold(self, name, identity, duration_s, now):
            if self.broken:
                raise ConnectionError("apiserver unreachable")
            return super().lease_tryhold(name, identity, duration_s, now)

    cluster, clock = Flaky(), p.FakeClock(0.0)
    elector = p.LeaderElector(cluster, "a", lease_duration_s=15.0, clock=clock)
    seen = [elector.is_leader()]
    cluster.broken = True
    for step in (9.0, 1.5):
        clock.advance(step)
        seen.append(elector.is_leader())
    cluster.broken = False
    clock.advance(1.0)
    seen.append(elector.is_leader())
    return seen


def _escalates(side):
    p = side.p

    class Denied(p.ClusterAPI):
        def lease_tryhold(self, name, identity, duration_s, now):
            raise ConnectionError("403 forbidden")

    clock = p.FakeClock(0.0)
    elector = p.LeaderElector(Denied(), "a", lease_duration_s=15.0, clock=clock)
    calls = 0
    while True:
        calls += 1
        try:
            elector.is_leader()
        except RuntimeError as e:
            return calls, str(e)
        clock.advance(2.1)


@pytest.mark.parametrize("scenario", [_two_instances, _steps_down, _escalates],
                         ids=["two_instances", "steps_down", "escalates"])
def test_leader_election_matches(scenario):
    twin(scenario)


# ---- a seeded trace through both schedulers ---------------------------------

def make_trace(seed, nodes, models, n_events=200):
    """About 200 pod events: fractional and multi-chip pods, gangs of
    fractional or whole-chip members, priorities, deletions, completions,
    node health flips and clock steps (gang timeouts, group GC)."""
    rng = random.Random(seed)
    events, names, serial = [], [], 0
    while len(events) < n_events:
        roll = rng.random()
        if roll < 0.35:
            request = rng.choice(["0.1", "0.25", "0.3", "0.5", "0.5", "1.0"])
            limit = rng.choice([request, "1.0"])
            labels = {"limit": limit, "request": request}
            if rng.random() < 0.3:
                labels["mem"] = rng.choice([1 << 30, 4 << 30, 12 << 30])
            if rng.random() < 0.5:
                labels["priority"] = rng.choice(["-1", "0", "10", "50", "100"])
            if rng.random() < 0.15:
                labels["model"] = rng.choice(models + ["NO-SUCH-MODEL"])
            name = f"f{serial}"
            events.append(("pod", name, labels))
            names.append(name)
        elif roll < 0.45:
            count = rng.choice(["1", "2", "3", "4"])
            name = f"m{serial}"
            events.append(("pod", name, {"limit": count, "request": count,
                                         "priority": rng.choice(["0", "60"])}))
            names.append(name)
        elif roll < 0.55:
            size = rng.choice([2, 3, 4])
            threshold = rng.choice(["1.0", "0.5"])
            whole = rng.random() < 0.4
            request = rng.choice(["1", "2"]) if whole else rng.choice(["0.25", "0.5"])
            limit = request if whole else "1.0"
            present = size if rng.random() < 0.8 else size - 1
            for i in range(present):
                name = f"g{serial}-{i}"
                events.append(("pod", name, {
                    "limit": limit, "request": request, "group": f"g{serial}",
                    "headcount": size, "threshold": threshold,
                    "priority": rng.choice(["0", "40"])}))
                names.append(name)
        elif roll < 0.75 and names:
            events.append(("delete", rng.choice(names)))
        elif roll < 0.8 and names:
            events.append(("phase", rng.choice(names),
                           rng.choice(["Succeeded", "Failed"])))
        elif roll < 0.85:
            events.append(("health", rng.choice(nodes), rng.random() < 0.6))
        elif roll < 0.92:
            events.append(("advance", rng.choice([1.0, 5.0, 30.0, 700.0])))
        else:
            events.append(("idle",))
        serial += 1
    return events


def play(side, events):
    p = side.p
    for i, event in enumerate(events):
        kind = event[0]
        if kind == "pod":
            _, name, labels = event
            side.pod(name, request=labels["request"], limit=labels["limit"],
                     mem=labels.get("mem"), priority=labels.get("priority"),
                     model=labels.get("model"), group=labels.get("group"),
                     headcount=labels.get("headcount"),
                     threshold=labels.get("threshold"))
            side.once()
        elif kind == "delete":
            side.cluster.delete_pod("default", event[1])
        elif kind == "phase":
            if side.cluster.get_pod("default", event[1]) is not None:
                side.cluster.set_pod_phase("default", event[1],
                                           p.PodPhase(event[2]))
        elif kind == "health":
            side.cluster.update_node(side.node(event[1], ready=event[2]))
        elif kind == "advance":
            side.clock.advance(event[1])
            side.once()
        else:
            side.run()
        if i % 25 == 24:
            side.snap()
    side.run()


@pytest.mark.parametrize("topology,inventory,seed", [
    (TOPOLOGY, INVENTORY, 11),
    (GPU_TOPOLOGY, GPU_INVENTORY, 12),
    (TWO_SLICE_TOPOLOGY, TWO_SLICE_INVENTORY, 13),
], ids=["with_coords", "cuda_cards", "two_slices"])
def test_seeded_trace_agrees_decision_for_decision(topology, inventory, seed):
    models = sorted({chip[2] for chips in inventory.values() for chip in chips})
    events = make_trace(seed, sorted(inventory), models)
    port = twin(lambda side: play(side, events), topology=topology,
                inventory=inventory)
    # the trace exercises every outcome a cycle has
    outcomes = {r.result for r in port.results if r is not None}
    assert {"bound", "waiting", "unschedulable"} <= outcomes, outcomes
    assert sum(1 for e in events if e[0] == "pod") >= 90
