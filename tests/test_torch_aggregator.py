"""The port's aggregator against the JAX package's (tests/test_daemons.py's
TestAggregator): the same pods give the same ``gpu_requirement`` samples
and the same exposition text byte for byte (``time.time`` pinned in both
modules), served over HTTP too; the uuid falls back to
``NVIDIA_VISIBLE_DEVICES`` in the port and to ``TPU_VISIBLE_CHIPS`` in
JAX; and the reference's chain runs through the port alone: the port's
scheduler places pods, the port's aggregator exports them, and the
port's config daemon in aggregator mode writes the files that cluster
mode writes, which equal JAX's scheduler and configd's on the same
labels.  ``python -m kubeshare_tpu_torch aggregator`` runs as a daemon."""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import types
import urllib.request
from pathlib import Path

import pytest

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.aggregator import Aggregator as JaxAggregator
from kubeshare_tpu.aggregator import aggregator as jax_aggregator_module
from kubeshare_tpu.cell import load_config as jax_load_config
from kubeshare_tpu.cell.allocator import ChipInfo as JaxChipInfo
from kubeshare_tpu.cluster import api as jax_api
from kubeshare_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from kubeshare_tpu.configd import ConfigDaemon as JaxConfigDaemon
from kubeshare_tpu.scheduler import KubeShareScheduler as JaxScheduler
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine
from kubeshare_tpu.utils.promtext import encode_families as jax_encode
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.aggregator import Aggregator
from kubeshare_tpu_torch.aggregator import aggregator as port_aggregator_module
from kubeshare_tpu_torch.cell import load_config
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cluster import api as port_api
from kubeshare_tpu_torch.cluster.fake import FakeCluster
from kubeshare_tpu_torch.configd import ConfigDaemon
from kubeshare_tpu_torch.scheduler import KubeShareScheduler, SchedulerEngine
from kubeshare_tpu_torch.utils.promtext import encode_families, parse_text

REPO = Path(__file__).resolve().parent.parent
NOW = 1_760_000_123.75  # time.time() in both modules: the samples' stamp
UUID = "GPU-5a8e1f2c-0b1d-4c7e-9f00-1a2b3c4d5e6f"

JAX = dict(C=jax_constants, api=jax_api, FakeCluster=JaxFakeCluster,
           Aggregator=JaxAggregator)
PORT = dict(C=constants, api=port_api, FakeCluster=FakeCluster,
            Aggregator=Aggregator)


@pytest.fixture(autouse=True)
def pinned_time(monkeypatch):
    for module in (jax_aggregator_module, port_aggregator_module):
        monkeypatch.setattr(module, "time",
                            types.SimpleNamespace(time=lambda: NOW))


def shared_pod(pkg, name, request="0.5", limit="1.0", **labels):
    C, api = pkg["C"], pkg["api"]
    extra = {getattr(C, key): value for key, value in labels.items()}
    return api.Pod(name=name,
                   labels={C.POD_GPU_LIMIT: limit, C.POD_GPU_REQUEST: request,
                           **extra},
                   scheduler_name=C.SCHEDULER_NAME)


def running(pkg, pod, node="host-a", uuid=None, cell="host-a/1",
            memory="1024", port="50051", env=None):
    C, api = pkg["C"], pkg["api"]
    pod.node_name = node
    pod.phase = api.PodPhase.RUNNING
    for key, value in ((C.POD_GPU_UUID, uuid), (C.POD_CELL_ID, cell),
                       (C.POD_GPU_MEMORY, memory),
                       (C.POD_MANAGER_PORT, port)):
        if value is not None:
            pod.annotations[key] = value
    if env:
        pod.containers[0].env.update(env)
    return pod


def daemons_case(pkg):
    """TestAggregator.test_export_and_parse's pods: one running shared pod,
    one pending, one regular."""
    C, api = pkg["C"], pkg["api"]
    return [running(pkg, shared_pod(pkg, "mnist1"), uuid="host-a-tpu-0"),
            shared_pod(pkg, "pending"),
            api.Pod(name="reg", scheduler_name=C.SCHEDULER_NAME)]


def gang_case(pkg):
    """Two gang members with their group labels, a pod of another
    scheduler, a finished pod, one in another namespace, memory from the
    label."""
    api = pkg["api"]
    pods = [running(pkg, shared_pod(pkg, f"w{i}", request="1.0", limit="1.0",
                                    POD_GROUP_NAME="job",
                                    POD_GROUP_MIN_AVAILABLE="2"),
                    uuid=UUID, cell=f"host-a/{i + 1}", port=f"5005{i}")
            for i in range(2)]
    other = running(pkg, shared_pod(pkg, "other"), uuid=UUID)
    other.scheduler_name = "default-scheduler"
    done = running(pkg, shared_pod(pkg, "done"), uuid=UUID)
    done.phase = api.PodPhase.SUCCEEDED
    ns = running(pkg, shared_pod(pkg, "tenant", request="0.25",
                                 POD_GPU_MEMORY=str(8 << 30)),
                 uuid=UUID, memory=None, node="host-b", cell="host-b/1")
    ns.namespace = "beta"
    return pods + [other, done, ns]


def env_case(pkg):
    """No uuid, memory or port annotation: the port comes from the
    POD_MANAGER_PORT env, memory defaults to 0 and the uuid to the
    package's visibility env (absent here: empty)."""
    return [running(pkg, shared_pod(pkg, "bare"), uuid=None, memory=None,
                    port=None, env={"POD_MANAGER_PORT": "50077"})]


CASES = {"test_daemons": daemons_case, "gang": gang_case, "env": env_case}


def build(pkg, case):
    cluster = pkg["FakeCluster"]()
    for pod in CASES[case](pkg):
        # a fake cluster numbers its pods from a process-wide counter
        pod.uid = f"uid-{pod.namespace}-{pod.name}"
        cluster.create_pod(pod)
    return pkg["Aggregator"](cluster)


@pytest.mark.parametrize("case", sorted(CASES))
def test_requirements_and_text_equal_jax(case):
    jax_agg, port_agg = build(JAX, case), build(PORT, case)
    port_pods = [dataclasses.asdict(r) for r in port_agg.get_pods()]
    assert port_pods == [dataclasses.asdict(r) for r in jax_agg.get_pods()]
    text = encode_families(port_agg.collect())
    assert text == jax_encode(jax_agg.collect())
    samples = parse_text(text)
    assert all(s.name == constants.METRIC_REQUIREMENT for s in samples)
    assert len(samples) == len(port_pods) >= 1
    assert all(set(s.labels) == {
        "namespace", "pod", "pod_id", "node", "group_name", "min_available",
        "limit", "request", "memory", "cell_id", "uuid", "port"}
        for s in samples)
    if case == "test_daemons":
        [r] = port_pods  # pending and regular pods are left out
        assert r["uuid"] == "host-a-tpu-0" and r["port"] == "50051"
        assert r["group_name"] == "default/mnist1"  # defaults to the pod key
        assert samples[0].labels["cell_id"] == "host-a/1"
        assert samples[0].labels["memory"] == "1024"
    if case == "env":
        assert port_pods[0]["port"] == "50077" and port_pods[0]["uuid"] == ""
        assert port_pods[0]["memory"] == "0"


def test_uuid_falls_back_to_nvidia_visible_devices():
    """Without the gpu_uuid annotation the port reads the UUID the port's
    scheduler injects (NVIDIA_VISIBLE_DEVICES, as the reference read it);
    JAX reads TPU_VISIBLE_CHIPS, which the port ignores."""
    env = {"NVIDIA_VISIBLE_DEVICES": UUID, "TPU_VISIBLE_CHIPS": "3"}
    (port_r,), (jax_r,) = (
        pkg["Aggregator"](_one(pkg, env)).get_pods() for pkg in (PORT, JAX))
    assert port_r.uuid == UUID and jax_r.uuid == "3"
    assert constants.ENV_VISIBLE_DEVICES == "NVIDIA_VISIBLE_DEVICES"
    (port_only,) = Aggregator(_one(PORT, {"TPU_VISIBLE_CHIPS": "3"})).get_pods()
    assert port_only.uuid == ""
    # the annotation, where the scheduler wrote one, wins over the env
    cluster = FakeCluster()
    cluster.create_pod(running(PORT, shared_pod(PORT, "p"), uuid="GPU-x",
                               env=env))
    assert Aggregator(cluster).get_pods()[0].uuid == "GPU-x"


def _one(pkg, env):
    cluster = pkg["FakeCluster"]()
    cluster.create_pod(running(pkg, shared_pod(pkg, "p"), uuid=None, env=env))
    return cluster


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as response:
        return response.read().decode()


def test_served_text_equals_jax():
    servers = [build(pkg, "gang").serve(port=0) for pkg in (JAX, PORT)]
    try:
        jax_body, port_body = (
            _get(f"http://127.0.0.1:{s.port}/kubeshare-aggregator")
            for s in servers)
        assert port_body == jax_body and "gpu_requirement{" in port_body
        # the generic path too, as the JAX server serves it
        assert _get(f"http://127.0.0.1:{servers[1].port}/metrics") == port_body
    finally:
        for server in servers:
            server.stop()


ONE_CARD = """
cellTypes:
  H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 1
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: H100-NODE
  cellId: agg-node
"""


def _placed(pkg, load, scheduler_cls, engine_cls, chip_cls):
    """Three pods through a package's scheduler on one card: two bound
    and running, the third refused."""
    C, api = pkg["C"], pkg["api"]
    cluster = pkg["FakeCluster"]()
    cluster.add_node(api.Node("agg-node", {C.NODE_LABEL_FILTER: "true"}))
    chip = chip_cls(UUID, 80 << 30, "NVIDIA-H100-80GB-HBM3", 0)
    clock = api.FakeClock(0.0)
    engine = engine_cls(scheduler_cls(load(text=ONE_CARD), cluster,
                                      lambda node: [chip], clock=clock),
                        cluster, clock)
    for name, limit in (("a", "1.0"), ("b", "0.5"), ("c", "0.5")):
        cluster.create_pod(api.Pod(
            name=name, scheduler_name=C.SCHEDULER_NAME,
            labels={C.POD_GPU_REQUEST: "0.5", C.POD_GPU_LIMIT: limit,
                    C.POD_GPU_MEMORY: str(8 << 30)}))
    results = {r.pod_key: r.result for r in engine.run_until_idle()}
    assert results == {"default/a": "bound", "default/b": "bound",
                       "default/c": "unschedulable"}
    for name in ("a", "b"):
        cluster.set_pod_phase("default", name, api.PodPhase.RUNNING)
    return cluster


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_scheduler_aggregator_configd_chain(tmp_path):
    """The port's scheduler -> the port's aggregator on port 0 -> the
    port's configd in aggregator mode: its files equal cluster mode's,
    and JAX's scheduler and configd write the same on the same labels."""
    cluster = _placed(PORT, load_config, KubeShareScheduler, SchedulerEngine,
                      ChipInfo)
    server = Aggregator(cluster).serve(port=0)
    try:
        url = f"http://127.0.0.1:{server.port}/kubeshare-aggregator"
        samples = [s for s in parse_text(_get(url))
                   if s.name == constants.METRIC_REQUIREMENT]
        ConfigDaemon("agg-node", aggregator_url=url,
                     config_dir=str(tmp_path / "agg" / "config"),
                     port_dir=str(tmp_path / "agg" / "ports")).sync()
    finally:
        server.stop()
    assert sorted(s.labels["pod"] for s in samples) == ["a", "b"]
    assert {s.labels["uuid"] for s in samples} == {UUID}
    ConfigDaemon("agg-node", cluster=cluster,
                 config_dir=str(tmp_path / "cluster" / "config"),
                 port_dir=str(tmp_path / "cluster" / "ports")).sync()
    jax_cluster = _placed(JAX, jax_load_config, JaxScheduler, JaxEngine,
                          JaxChipInfo)
    JaxConfigDaemon("agg-node", cluster=jax_cluster,
                    config_dir=str(tmp_path / "jax" / "config"),
                    port_dir=str(tmp_path / "jax" / "ports")).sync()
    files = _tree(tmp_path / "agg")
    assert files == _tree(tmp_path / "cluster") == _tree(tmp_path / "jax")
    assert files[f"config/{UUID}"] == (
        f"2\ndefault/a 1.0 0.5 {8 << 30}\n"
        f"default/b 0.5 0.5 {8 << 30}\n").encode()
    assert files[f"ports/{UUID}"] == b"2\ndefault/a 50051\ndefault/b 50052\n"


def test_aggregator_daemon_serves_and_stops():
    """``python -m kubeshare_tpu_torch aggregator --cluster fake``: serves
    the (empty) requirement family on its path, equal to JAX's, and stops
    on SIGTERM."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch", "aggregator",
         "--cluster", "fake", "--port", "0"], cwd=REPO, env=env, text=True,
        stderr=subprocess.PIPE)
    try:
        found = []

        def scan():
            for line in proc.stderr:
                if "aggregator serving on :" in line:
                    found.append(int(line.rsplit(":", 1)[-1].split("/")[0]))
                    return

        reader = threading.Thread(target=scan, daemon=True)
        reader.start()
        reader.join(timeout=60)
        assert found, "the aggregator never reported its port"
        body = _get(f"http://127.0.0.1:{found[0]}/kubeshare-aggregator")
        assert body == jax_encode(JaxAggregator(JaxFakeCluster()).collect())
        assert body.startswith("# HELP gpu_requirement")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
