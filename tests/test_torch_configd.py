"""The port's config daemon and its control-plane entry points against the
JAX package's (tests/test_daemons.py's configd and metadata-bus cases,
tests/test_cli_daemons.py): the files ``config/<UUID>`` and
``podmanagerport/<UUID>`` that the port's ConfigDaemon writes equal the
JAX daemon's byte for byte after every step, in both decision modes;
``python -m kubeshare_tpu_torch scheduler|configd`` run as daemons; and
the twin of tests/test_torch_discovery.py's full slice places two pods
through the port's scheduler and configd alone, under the real native
tokend and pod managers."""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.aggregator import Aggregator as JaxAggregator
from kubeshare_tpu.cell import load_config as jax_load_config
from kubeshare_tpu.cell.allocator import ChipInfo as JaxChipInfo
from kubeshare_tpu.cluster import api as jax_api
from kubeshare_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from kubeshare_tpu.collector import Collector as JaxCollector
from kubeshare_tpu.collector import FakeEnumerator as JaxFakeEnumerator
from kubeshare_tpu.collector import PromInventory as JaxPromInventory
from kubeshare_tpu.configd import ConfigDaemon as JaxConfigDaemon
from kubeshare_tpu.configd import write_scheduler_ip as jax_write_scheduler_ip
from kubeshare_tpu.scheduler import KubeShareScheduler as JaxScheduler
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine
from kubeshare_tpu.utils.promtext import encode_families as jax_encode
from kubeshare_tpu_torch import cli, constants
from kubeshare_tpu_torch.cell import load_config
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cluster import api as port_api
from kubeshare_tpu_torch.cluster.fake import FakeCluster
from kubeshare_tpu_torch.collector import Collector, FakeEnumerator, PromInventory
from kubeshare_tpu_torch.configd import ConfigDaemon, write_scheduler_ip
from kubeshare_tpu_torch.runtime import ChipSupervisor, find_binary
from kubeshare_tpu_torch.scheduler import KubeShareScheduler, SchedulerEngine

from native_helpers import free_port, wait_listening

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GIB = 1 << 30
H100 = "NVIDIA-H100-80GB-HBM3"
UUIDS = ["GPU-5a8e1f2c-0b1d-4c7e-9f00-1a2b3c4d5e6f",
         "GPU-6b9f2a3d-1c2e-4d8f-8e11-2b3c4d5e6f70"]

JAX = dict(C=jax_constants, api=jax_api, FakeCluster=JaxFakeCluster,
           ConfigDaemon=JaxConfigDaemon)
PORT = dict(C=constants, api=port_api, FakeCluster=FakeCluster,
            ConfigDaemon=ConfigDaemon)


def bound_pod(pkg, cluster, name, uuid, port, request="0.5", limit="1.0",
              memory="1024", node="gpu-a", phase="Running", namespace="default",
              memory_label=None):
    C, api = pkg["C"], pkg["api"]
    labels = {C.POD_GPU_LIMIT: limit, C.POD_GPU_REQUEST: request}
    if memory_label is not None:
        labels[C.POD_GPU_MEMORY] = memory_label
    pod = api.Pod(namespace=namespace, name=name, labels=labels,
                  scheduler_name=C.SCHEDULER_NAME, node_name=node,
                  phase=api.PodPhase(phase))
    if uuid is not None:
        pod.annotations[C.POD_GPU_UUID] = uuid
    if memory is not None:
        pod.annotations[C.POD_GPU_MEMORY] = memory
    if port is not None:
        pod.annotations[C.POD_MANAGER_PORT] = port
    cluster.create_pod(pod)


def tree(root):
    """Every file under ``root`` as {relative path: bytes}."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# each step: ("pod", kwargs) | ("delete", name) | ("phase", name, phase) |
# ("sync",) — the daemon syncs on its own at every shared pod's event
STEPS = {
    "two_pods_one_card": [
        ("pod", dict(name="p1", uuid=UUIDS[0], port="50051")),
        ("pod", dict(name="p2", uuid=UUIDS[0], port="50052", request="0.3")),
    ],
    "reset_on_empty": [
        ("pod", dict(name="p1", uuid=UUIDS[0], port="50051")),
        ("pod", dict(name="p2", uuid=UUIDS[1], port="50052")),
        ("delete", "p1"), ("sync",), ("delete", "p2"), ("sync",),
    ],
    "other_node_and_unplaced_ignored": [
        ("pod", dict(name="px", uuid="GPU-elsewhere", port="50051",
                     node="gpu-b")),
        ("pod", dict(name="unplaced", uuid=None, port=None, memory=None)),
        ("pod", dict(name="whole", uuid=f"{UUIDS[0]},{UUIDS[1]}", port=None,
                     request="2", limit="2")),
        ("pod", dict(name="over", uuid=UUIDS[0], port="50053", limit="1.5",
                     request="1.5")),
        ("pod", dict(name="bad-limit", uuid=UUIDS[0], port="50054",
                     limit="abc")),
        ("sync",),
    ],
    "completed_and_namespaces": [
        ("pod", dict(name="a", uuid=UUIDS[0], port="50051", namespace="alpha")),
        ("pod", dict(name="a", uuid=UUIDS[0], port="50052", namespace="beta")),
        ("pod", dict(name="done", uuid=UUIDS[1], port="50053",
                     memory_label="999")),
        ("phase", "done", "Succeeded"), ("sync",),
        ("pod", dict(name="label-mem", uuid=UUIDS[1], port="50054",
                     memory=None, memory_label=str(8 * GIB))),
    ],
}


def run_steps(pkg, steps, root):
    cluster = pkg["FakeCluster"]()
    changes = []
    daemon = pkg["ConfigDaemon"]("gpu-a", cluster=cluster,
                                 config_dir=str(root / "config"),
                                 port_dir=str(root / "ports"),
                                 on_change=lambda: changes.append(1))
    trees = []
    for step in steps:
        if step[0] == "pod":
            bound_pod(pkg, cluster, **step[1])
        elif step[0] == "delete":
            cluster.delete_pod("default", step[1])
        elif step[0] == "phase":
            cluster.set_pod_phase("default", step[1], pkg["api"].PodPhase(step[2]))
        else:
            daemon.sync()
        trees.append(tree(root))
    return trees, len(changes)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_config_files_match_byte_for_byte(case, tmp_path):
    jax_trees = run_steps(JAX, STEPS[case], tmp_path / "jax")
    port_trees = run_steps(PORT, STEPS[case], tmp_path / "port")
    assert port_trees == jax_trees
    if case == "two_pods_one_card":
        final = port_trees[0][-1]
        assert final[f"config/{UUIDS[0]}"] == (
            b"2\ndefault/p1 1.0 0.5 1024\ndefault/p2 1.0 0.3 1024\n")
        assert final[f"ports/{UUIDS[0]}"] == (
            b"2\ndefault/p1 50051\ndefault/p2 50052\n")
    if case == "reset_on_empty":
        final = port_trees[0][-1]
        assert final[f"config/{UUIDS[0]}"] == b"0\n"
        assert final[f"ports/{UUIDS[1]}"] == b"0\n"
    if case == "other_node_and_unplaced_ignored":
        assert port_trees[0][-1] == {}


def test_unchanged_files_are_not_rewritten(tmp_path):
    cluster = FakeCluster()
    daemon = ConfigDaemon("gpu-a", cluster=cluster,
                          config_dir=str(tmp_path / "config"),
                          port_dir=str(tmp_path / "ports"))
    bound_pod(PORT, cluster, "p1", UUIDS[0], "50051")
    path = tmp_path / "config" / UUIDS[0]
    before = os.stat(path).st_ino
    daemon.sync()
    daemon.sync()
    assert os.stat(path).st_ino == before
    # a hidden temporary of the atomic writer is never reset to 0
    (tmp_path / "config" / ".tmp-x").write_text("junk")
    daemon.sync()
    assert (tmp_path / "config" / ".tmp-x").read_text() == "junk"


def test_needs_a_decision_source():
    with pytest.raises(ValueError, match="cluster API or an aggregator"):
        ConfigDaemon("gpu-a")


def test_aggregator_mode_matches(tmp_path):
    """The port's daemon reading the port's aggregator writes what JAX's
    daemon writes from JAX's aggregator over the same pods; reading JAX's
    aggregator (the cross-check) it writes the same again."""
    from kubeshare_tpu_torch.aggregator import Aggregator

    clusters = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        cluster = clusters[name] = pkg["FakeCluster"]()
        bound_pod(pkg, cluster, "p1", UUIDS[0], "50051")
        bound_pod(pkg, cluster, "p2", UUIDS[0], "50052", request="0.25")
        bound_pod(pkg, cluster, "whole", f"{UUIDS[0]},{UUIDS[1]}", None,
                  request="2", limit="2")
        bound_pod(pkg, cluster, "far", UUIDS[1], "50053", node="gpu-b")
    servers = {"jax": JaxAggregator(clusters["jax"]).serve(port=0),
               "port": Aggregator(clusters["port"]).serve(port=0)}
    try:
        urls = {name: f"http://127.0.0.1:{server.port}/kubeshare-aggregator"
                for name, server in servers.items()}
        for name, daemon_cls, source in (("jax", JaxConfigDaemon, "jax"),
                                         ("port", ConfigDaemon, "port"),
                                         ("cross", ConfigDaemon, "jax")):
            daemon_cls("gpu-a", aggregator_url=urls[source],
                       config_dir=str(tmp_path / name / "config"),
                       port_dir=str(tmp_path / name / "ports")).sync()
        # an unreachable aggregator writes nothing and raises nothing
        ConfigDaemon("gpu-a", aggregator_url=f"http://127.0.0.1:{free_port()}/x",
                     config_dir=str(tmp_path / "dead" / "config"),
                     port_dir=str(tmp_path / "dead" / "ports")).sync()
    finally:
        for server in servers.values():
            server.stop()
    port_files = tree(tmp_path / "port")
    assert port_files == tree(tmp_path / "jax") == tree(tmp_path / "cross")
    assert port_files[f"config/{UUIDS[0]}"].startswith(b"2\n")
    assert tree(tmp_path / "dead") == {}


def test_write_scheduler_ip_matches(tmp_path):
    jax_path = jax_write_scheduler_ip("10.0.0.7", str(tmp_path / "jax"))
    port_path = write_scheduler_ip("10.0.0.7", str(tmp_path / "port"))
    assert Path(port_path).read_bytes() == Path(jax_path).read_bytes() \
        == b"10.0.0.7\n"
    assert os.path.basename(port_path) == os.path.basename(
        constants.SCHEDULER_IP_FILE)


TOPOLOGY = """
cellTypes:
  2-H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 2
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: 2-H100-NODE
  cellId: gpu-a
"""


def _chain(tmp_path, name, collector_cls, enumerator_cls, chip_cls,
           inventory_cls, cluster_cls, api, C, scheduler_cls, engine_cls,
           daemon_cls, load):
    """tests/test_daemons.py's metadata bus: collector scrape -> schedule
    -> configd files, over one package."""
    chips = [chip_cls(uuid, 80 * GIB, H100, i) for i, uuid in enumerate(UUIDS)]
    server = collector_cls(enumerator_cls(chips), node_name="gpu-a").serve(port=0)
    try:
        cluster = cluster_cls()
        cluster.add_node(api.Node("gpu-a", {C.NODE_LABEL_FILTER: "true"}))
        clock = api.FakeClock(0)
        inventory = inventory_cls(
            [f"http://127.0.0.1:{server.port}/kubeshare-collector"], ttl=0)
        plugin = scheduler_cls(load(text=TOPOLOGY), cluster, inventory,
                               clock=clock)
        engine = engine_cls(plugin, cluster, clock)
        daemon_cls("gpu-a", cluster=cluster,
                   config_dir=str(tmp_path / name / "config"),
                   port_dir=str(tmp_path / name / "ports"))
        for pod_name, request, limit in (("mnist1", "0.5", "1.0"),
                                         ("mnist2", "0.5", "1.0"),
                                         ("mnist3", "0.3", "0.5"),
                                         ("big", "1", "1")):
            cluster.create_pod(api.Pod(
                name=pod_name, labels={C.POD_GPU_LIMIT: limit,
                                       C.POD_GPU_REQUEST: request},
                scheduler_name=C.SCHEDULER_NAME))
        results = [(r.pod_key, r.result, r.node) for r in engine.run_until_idle()]
        for pod in cluster.list_pods():
            if pod.is_bound():
                cluster.set_pod_phase("default", pod.name, api.PodPhase.RUNNING)
        metrics = (jax_encode if name == "jax" else
                   __import__("kubeshare_tpu_torch.utils.promtext",
                              fromlist=["encode_families"]).encode_families)(
            plugin.collect_metrics())
        return results, tree(tmp_path / name), metrics
    finally:
        server.stop()


def test_collector_to_configd_chain_matches(tmp_path):
    jax_run = _chain(tmp_path, "jax", JaxCollector, JaxFakeEnumerator,
                     JaxChipInfo, JaxPromInventory, JaxFakeCluster, jax_api,
                     jax_constants, JaxScheduler, JaxEngine, JaxConfigDaemon,
                     jax_load_config)
    port_run = _chain(tmp_path, "port", Collector, FakeEnumerator, ChipInfo,
                      PromInventory, FakeCluster, port_api, constants,
                      KubeShareScheduler, SchedulerEngine, ConfigDaemon,
                      load_config)
    assert port_run == jax_run
    results, files, _ = port_run
    assert [r[1] for r in results].count("bound") == 3
    assert any(content.startswith(b"2\n") for path, content in files.items()
               if path.startswith("config/"))


# ---- the entry points -------------------------------------------------------

def _daemon(args, **kwargs):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, "-m", "kubeshare_tpu_torch", *args],
                            cwd=REPO, env=env, text=True, **kwargs)


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_scheduler_daemon_lifecycle(tmp_path):
    """``python -m kubeshare_tpu_torch scheduler --cluster fake``: it
    serves the scheduler's metrics, equal to JAX's plugin's over the same
    topology, and stops cleanly on SIGTERM."""
    config = tmp_path / "topology.yaml"
    config.write_text(TOPOLOGY)
    proc = _daemon(["scheduler", "--cluster", "fake", "--kubeshare-config",
                    str(config), "--metrics-port", "0", "--idle-interval",
                    "0.1"], stderr=subprocess.PIPE)
    try:
        found = []

        def scan():
            for line in proc.stderr:
                if "scheduler metrics on :" in line:
                    found.append(int(line.rsplit(":", 1)[-1].split("/")[0]))
                    return

        reader = threading.Thread(target=scan, daemon=True)
        reader.start()
        reader.join(timeout=60)
        assert found, "the scheduler never reported its metrics port"
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{found[0]}/metrics", timeout=5).read().decode()
        reference = JaxScheduler(jax_load_config(text=TOPOLOGY),
                                 JaxFakeCluster(), lambda node: [])
        assert body == jax_encode(reference.collect_metrics())
        assert "kubeshare_scheduler_pods" in body
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_configd_daemon_lifecycle(tmp_path):
    proc = _daemon(["configd", "--cluster", "fake", "--node-name", "n1",
                    "--config-dir", str(tmp_path / "config"),
                    "--port-dir", str(tmp_path / "ports"),
                    "--sync-interval", "0.1",
                    "--write-scheduler-ip", "10.1.2.3",
                    "--library-path", str(tmp_path / "lib")],
                   stderr=subprocess.DEVNULL)
    try:
        ip_file = tmp_path / "lib" / "schedulerIP.txt"
        deadline = time.time() + 60
        while time.time() < deadline and not ip_file.exists():
            time.sleep(0.1)
        assert ip_file.read_text() == "10.1.2.3\n"
        assert (tmp_path / "config").is_dir() and (tmp_path / "ports").is_dir()
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_flags_match_the_jax_packages():
    from kubeshare_tpu import cli as jax_cli

    def flags(parser, name):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return sorted((a.dest, a.default) for a in sub.choices[name]._actions
                      if a.dest not in ("help", "fn"))

    jax_parser, port_parser = jax_cli.build_parser(), cli.build_parser()
    for name in ("scheduler", "configd", "collector", "launcher"):
        port_flags = flags(port_parser, name)
        jax_flags = flags(jax_parser, name)
        if name == "collector":  # the fake chips' model and memory
            port_flags = [f for f in port_flags if not f[0].startswith("fake_")]
            jax_flags = [f for f in jax_flags if not f[0].startswith("fake_")]
        assert [f[0] for f in port_flags] == [f[0] for f in jax_flags], name
        defaults = dict(port_flags)
        for dest, default in jax_flags:
            if dest not in ("node_name", "kubeshare_config", "config_dir",
                            "port_dir", "library_path"):
                assert defaults[dest] == default, (name, dest)
    assert cli.build_parser().parse_args(["scheduler"]).kubeshare_config == \
        "/kubeshare/scheduler/kubeshare-config.yaml"
    with pytest.raises(SystemExit, match="kubernetes package is required"):
        cli._make_cluster(argparse.Namespace(cluster="k8s"))
    with pytest.raises(SystemExit, match="unknown cluster backend"):
        cli._make_cluster(argparse.Namespace(cluster="etcd"))
    assert isinstance(cli._make_cluster(argparse.Namespace(cluster="fake")),
                      FakeCluster)


# ---- the whole path on the CPU, through the port alone ----------------------

ONE_CARD = """
cellTypes:
  H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 1
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: H100-NODE
  cellId: e2e-node
"""


def test_full_slice_on_the_ports_scheduler_and_configd(tmp_path):
    """The twin of tests/test_torch_discovery.py's full slice with the
    port's own control plane: the port's scheduler places two 0.5 pods
    on one card, the port's configd writes the files, the port's
    ChipSupervisor runs the real tokend and a pod manager per pod at the
    scheduler's ports, and the port's MNIST trainers, gated through each
    pod's injected POD_MANAGER_PORT, are granted and charged under the
    scheduler's pod keys.  Deleting a pod reclaims its cell and its port;
    the pod that waited binds and its manager starts."""
    if find_binary("tpushare-tokend") is None \
            or find_binary("tpushare-pmgr") is None:
        pytest.skip("native binaries not built")
    from kubeshare_tpu_torch.isolation import ExecutionGuard, TokenClient
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import make_train_step

    uuid = UUIDS[0]
    inventory = {"e2e-node": [ChipInfo(uuid, 80 * GIB, H100, 0)]}
    cluster = FakeCluster()
    cluster.add_node(port_api.Node("e2e-node",
                                   {constants.NODE_LABEL_FILTER: "true"}))
    clock = port_api.FakeClock(0.0)
    plugin = KubeShareScheduler(load_config(text=ONE_CARD), cluster,
                                lambda n: inventory.get(n, []), clock=clock)
    engine = SchedulerEngine(plugin, cluster, clock)
    for name, limit in (("mnist-a", "1.0"), ("mnist-b", "0.5"),
                        ("mnist-c", "0.5")):
        cluster.create_pod(port_api.Pod(
            name=name,
            labels={constants.POD_GPU_REQUEST: "0.5",
                    constants.POD_GPU_LIMIT: limit,
                    constants.POD_GPU_MEMORY: str(8 << 30)},
            scheduler_name=constants.SCHEDULER_NAME))
    results = {r.pod_key: r.result for r in engine.run_until_idle()}
    assert results == {"default/mnist-a": "bound", "default/mnist-b": "bound",
                       "default/mnist-c": "unschedulable"}
    pods = {n: cluster.get_pod("default", n) for n in ("mnist-a", "mnist-b")}
    for pod in pods.values():
        env = pod.containers[0].env
        assert env[constants.ENV_VISIBLE_DEVICES] == uuid
        assert env[constants.ENV_POD_NAME] == pod.key
        cluster.set_pod_phase("default", pod.name, port_api.PodPhase.RUNNING)
    config_dir, port_dir = tmp_path / "config", tmp_path / "ports"
    daemon = ConfigDaemon("e2e-node", cluster=cluster,
                          config_dir=str(config_dir), port_dir=str(port_dir))
    daemon.sync()
    assert (config_dir / uuid).read_text() == (
        f"2\ndefault/mnist-a 1.0 0.5 {8 << 30}\n"
        f"default/mnist-b 0.5 0.5 {8 << 30}\n")

    tokend_port = free_port()
    with ChipSupervisor(uuid, config_dir=str(config_dir),
                        port_dir=str(port_dir), tokend_port=tokend_port,
                        poll_interval=0.1, base_quota_ms=50.0,
                        min_quota_ms=5.0, window_ms=1000.0) as supervisor:
        wait_listening(tokend_port)
        for pod in pods.values():
            wait_listening(int(pod.annotations[constants.POD_MANAGER_PORT]))
        guards = {}
        for name, pod in pods.items():
            env = pod.containers[0].env
            client = TokenClient("127.0.0.1",
                                 int(env[constants.ENV_POD_MANAGER_PORT]),
                                 "name-is-stamped-by-pmgr")
            guard = ExecutionGuard(client=client, from_env=False)
            init_state, train_step = make_train_step(mnist_apply)
            state = init_state(mnist_init(torch.Generator().manual_seed(0),
                                          device="cpu"))
            images = torch.zeros((8, 28, 28, 1))
            labels = torch.zeros((8,), dtype=torch.int64)

            @guard
            def step(state):
                return train_step(state, images, labels)[0]

            for _ in range(3):
                state = step(state)
            guard.finish()
            guards[name] = guard
        assert all(g.tokens_acquired >= 1 and g.total_gated_ms > 0
                   for g in guards.values())
        probe = TokenClient("127.0.0.1", tokend_port, "probe")
        stat = json.loads(probe.stat())
        probe.close()
        for pod in pods.values():
            entry = stat["pods"][pod.key]
            assert entry["grants"] >= 1 and entry["charged_total_ms"] > 0
            assert entry["mem_cap"] == 8 << 30

        # reclaim: b goes, its cell and port come back, c binds there
        b_port = pods["mnist-b"].annotations[constants.POD_MANAGER_PORT]
        cluster.delete_pod("default", "mnist-b")
        daemon.sync()
        assert (config_dir / uuid).read_text().startswith("1\n")
        assert (port_dir / uuid).read_text() == (
            f"1\ndefault/mnist-a "
            f"{pods['mnist-a'].annotations[constants.POD_MANAGER_PORT]}\n")
        deadline = time.time() + 10
        while len(supervisor.pod_managers) > 1 and time.time() < deadline:
            time.sleep(0.1)
        assert list(supervisor.pod_managers) == [
            f"default/mnist-a "
            f"{pods['mnist-a'].annotations[constants.POD_MANAGER_PORT]}"]
        assert not plugin.port_bitmaps["e2e-node"].is_masked(
            int(b_port) - constants.POD_MANAGER_PORT_START)
        assert [r.result for r in engine.run_until_idle()] == ["bound"]
        c = cluster.get_pod("default", "mnist-c")
        c_port = c.annotations[constants.POD_MANAGER_PORT]
        cluster.set_pod_phase("default", "mnist-c", port_api.PodPhase.RUNNING)
        daemon.sync()
        deadline = time.time() + 10
        while f"default/mnist-c {c_port}" not in supervisor.pod_managers \
                and time.time() < deadline:
            time.sleep(0.1)
        assert f"default/mnist-c {c_port}" in supervisor.pod_managers
        wait_listening(int(c_port))
    assert supervisor.tokend is None and not supervisor.pod_managers
