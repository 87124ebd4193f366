"""Port parity: device discovery and the node daemons
(``cell.topology.discover_local_chips``, ``collector``,
``runtime.ChipSupervisor``, ``python -m kubeshare_tpu_torch collector``)
against the JAX package's on the CPU.

The collector's exposition text equals the JAX collector's for the same
chips, so a scheduler scraping either reads the same inventory; a card's
link record travels as one more label, which the port's inventory reads
back and the JAX package's ignores; the
CUDA enumerator keeps the JAX enumerator's timeout and failure
semantics; and the port's supervisor runs the real native tokend and pod
managers under the JAX package's scheduler and configd, gating the
port's MNIST trainers (``device="cpu"``), the twin of
tests/test_e2e.py::test_full_slice.  On a host without CUDA devices
discovery finds none; the card test of tests/test_torch_cuda.py holds it
to ``nvidia-smi``."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from native_helpers import free_port, wait_listening

import kubeshare_tpu.collector.collector as jax_collector_module
from kubeshare_tpu.cell.allocator import ChipInfo as JaxChipInfo
from kubeshare_tpu.collector import Collector as JaxCollector
from kubeshare_tpu.collector import FakeEnumerator as JaxFakeEnumerator
from kubeshare_tpu.collector import PromInventory as JaxPromInventory
from kubeshare_tpu.utils.promtext import encode_families as jax_encode
import kubeshare_tpu_torch.collector.collector as collector_module
from kubeshare_tpu_torch.cell import topology
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cell.topology import LinkRecord
from kubeshare_tpu_torch.collector import (Collector, CudaEnumerator,
                                           FakeEnumerator, PromInventory)
from kubeshare_tpu_torch.runtime import ChipSupervisor, find_binary
from kubeshare_tpu_torch.utils.promtext import encode_families

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GIB = 1 << 30
CHIPS = [("GPU-5a8e1f2c-0b1d-4c7e-9f00-1a2b3c4d5e6f", 80 * GIB,
          "NVIDIA-H100-80GB-HBM3", 0, None),
         ("GPU-6b9f2a3d-1c2e-4d8f-8e11-2b3c4d5e6f70", 80 * GIB,
          "NVIDIA-H100-80GB-HBM3", 1, None),
         ("host-a-tpu-0", 32 * GIB, "TPU-v4", 2, (1, 0, 0))]


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "NVIDIA-H100-80GB-HBM3"),
    ("NVIDIA H100 PCIe", "NVIDIA-H100-PCIe"),
    ("  NVIDIA A100-SXM4-40GB ", "NVIDIA-A100-SXM4-40GB"),
    ("NVIDIA GeForce RTX 4090", "NVIDIA-GeForce-RTX-4090"),
])
def test_normalize_kind_on_nvidia_names(name, want):
    assert topology._normalize_kind(name) == want


def test_discovery_reads_each_cuda_device(monkeypatch):
    props = [SimpleNamespace(uuid="5a8e1f2c-0b1d-4c7e-9f00-1a2b3c4d5e6f",
                             total_memory=85_045_231_616,
                             name="NVIDIA H100 80GB HBM3"),
             SimpleNamespace(uuid="6b9f2a3d-1c2e-4d8f-8e11-2b3c4d5e6f70",
                             total_memory=85_045_231_616,
                             name="NVIDIA H100 80GB HBM3")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(props))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props[i])
    chips = topology.discover_local_chips()
    assert chips == [
        ChipInfo(f"GPU-{p.uuid}", p.total_memory, "NVIDIA-H100-80GB-HBM3",
                 i, None) for i, p in enumerate(props)]


def test_a_host_without_cuda_devices_has_no_chips(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert topology.discover_local_chips() == []
    assert CudaEnumerator(timeout_s=5)() == []


def test_hung_discovery_returns_the_last_inventory(monkeypatch):
    """The twin of tests/test_daemons.py::TestJaxEnumeratorTimeout."""
    enumerator = CudaEnumerator(timeout_s=0.2)
    chips = [ChipInfo("GPU-t0", GIB, "NVIDIA-H100-80GB-HBM3", 0)]
    monkeypatch.setattr(topology, "discover_local_chips", lambda: chips)
    assert enumerator() == chips
    # the driver wedges: enumeration hangs, the enumerator returns the
    # last inventory it knew, within its timeout
    monkeypatch.setattr(topology, "discover_local_chips",
                        lambda: time.sleep(10))
    start = time.monotonic()
    assert enumerator() == chips
    assert time.monotonic() - start < 2.0


def test_failed_discovery_exports_nothing(monkeypatch):
    enumerator = CudaEnumerator(timeout_s=5)
    monkeypatch.setattr(topology, "discover_local_chips",
                        lambda: [ChipInfo("GPU-t0", GIB)])
    assert len(enumerator()) == 1

    def broken():
        raise RuntimeError("CUDA driver initialization failed")

    monkeypatch.setattr(topology, "discover_local_chips", broken)
    assert enumerator() == []
    assert Collector(enumerator, node_name="n").collect()[0].samples == []


def test_collector_text_equals_jax(monkeypatch):
    for module in (collector_module, jax_collector_module):
        monkeypatch.setattr(module.time, "time", lambda: 1_700_000_000.5)
    port = Collector(FakeEnumerator([ChipInfo(*c) for c in CHIPS]),
                     node_name="host-a")
    ref = JaxCollector(JaxFakeEnumerator([JaxChipInfo(*c) for c in CHIPS]),
                       node_name="host-a")
    text = encode_families(port.collect())
    assert text == jax_encode(ref.collect())
    assert 'uuid="GPU-5a8e1f2c-0b1d-4c7e-9f00-1a2b3c4d5e6f"' in text
    assert 'coords="1,0,0"' in text


def test_inventory_scrape_parses_the_collector():
    server = Collector(FakeEnumerator([ChipInfo(*c) for c in CHIPS]),
                       node_name="host-a").serve(port=0)
    try:
        inventory = PromInventory(
            [f"http://127.0.0.1:{server.port}/kubeshare-collector"], ttl=0)
        assert inventory("host-a") == [ChipInfo(*c) for c in CHIPS]
        assert inventory("host-b") == []
    finally:
        server.stop()


# link records of the first two chips of CHIPS: an HGX card on the
# NVSwitch fabric and a bridged H100 NVL card
RECORDS = [LinkRecord("00000000:1B:00.0", 0,
                      ("pci0000:18", "0000:18:01.0", "0000:19:00.0",
                       "0000:1a:00.0"), "nvswitch"),
           LinkRecord("00000000:4F:00.0", 1, ("pci0000:4d", "0000:4d:01.0"),
                      "00000000:4F:00.0")]


def _recorded_chips():
    chips = [ChipInfo(*c) for c in CHIPS]
    for chip, record in zip(chips, RECORDS):
        chip.links = record
    return chips


def _scrape(chips, read):
    server = Collector(FakeEnumerator(chips), node_name="host-a").serve(port=0)
    try:
        return read(f"http://127.0.0.1:{server.port}/kubeshare-collector")
    finally:
        server.stop()


def test_link_records_round_trip_through_the_collector():
    """The topo label carries each record to the scheduler's inventory;
    a chip without one exports no topo label and reads back none."""
    chips = _recorded_chips()
    text = encode_families(
        Collector(FakeEnumerator(chips), node_name="host-a").collect())
    assert text.count("topo=") == 2
    assert ('topo="00000000:1B:00.0;0;pci0000:18/0000:18:01.0/0000:19:00.0/'
            '0000:1a:00.0;nvswitch"') in text
    got = _scrape(chips, lambda url: PromInventory([url], ttl=0)("host-a"))
    assert got == chips
    assert [c.links for c in got] == RECORDS + [None]


def test_jax_inventory_reads_the_labelled_text_to_the_same_chips():
    """JAX's PromInventory ignores the topo label: a JAX scheduler reading
    the port's collector sees the chips it would see without records."""
    got = _scrape(_recorded_chips(),
                  lambda url: JaxPromInventory([url], ttl=0)("host-a"))
    assert got == [JaxChipInfo(*c) for c in CHIPS]


def test_a_malformed_topo_label_means_no_record():
    chips = _recorded_chips()
    chips[0].links = SimpleNamespace(label=lambda: "00000000:1B:00.0;zero;;")
    got = _scrape(chips, lambda url: PromInventory([url], ttl=0)("host-a"))
    assert got == [ChipInfo(*c) for c in CHIPS]
    assert [c.links for c in got] == [None, RECORDS[1], None]


def test_collector_subcommand_serves_fake_chips():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch", "collector",
         "--fake-chips", "2", "--port", str(port), "--node-name", "node-1"],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        wait_listening(port, timeout=60)
        inventory = PromInventory(
            [f"http://127.0.0.1:{port}/kubeshare-collector"], ttl=0)
        assert inventory("node-1") == [
            ChipInfo(f"node-1-gpu-{i}", 80 * GIB, "NVIDIA-H100-80GB-HBM3", i)
            for i in range(2)]
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=20)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0


TOPOLOGY = """
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


def test_full_slice_with_the_ports_supervisor_and_trainers(tmp_path):
    """The twin of tests/test_e2e.py::test_full_slice: the JAX package's
    scheduler and configd place two 0.5 pods on one card (their files are
    the port's byte for byte, tests/test_torch_configd.py); the port's ChipSupervisor runs the real
    tokend and a pod manager per pod; the port's MNIST trainers, gated by
    the port's TokenClient + ExecutionGuard, are granted and charged."""
    if find_binary("tpushare-tokend") is None \
            or find_binary("tpushare-pmgr") is None:
        pytest.skip("native binaries not built")
    from kubeshare_tpu import constants as jax_constants
    from kubeshare_tpu.cell import load_config
    from kubeshare_tpu.cluster.api import FakeClock, Node, Pod, PodPhase
    from kubeshare_tpu.cluster.fake import FakeCluster
    from kubeshare_tpu.configd import ConfigDaemon
    from kubeshare_tpu.scheduler import KubeShareScheduler, SchedulerEngine
    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.isolation import ExecutionGuard, TokenClient
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import make_train_step

    uuid = CHIPS[0][0]
    inventory = {"e2e-node": [JaxChipInfo(uuid, 80 * GIB,
                                          "NVIDIA-H100-80GB-HBM3", 0)]}
    cluster = FakeCluster()
    cluster.add_node(Node("e2e-node",
                          {jax_constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(0.0)
    plugin = KubeShareScheduler(load_config(text=TOPOLOGY), cluster,
                                lambda n: inventory.get(n, []), clock=clock)
    engine = SchedulerEngine(plugin, cluster, clock)
    for name in ("mnist-a", "mnist-b"):
        cluster.create_pod(Pod(
            name=name,
            labels={jax_constants.POD_GPU_REQUEST: "0.5",
                    jax_constants.POD_GPU_LIMIT: "1.0",
                    jax_constants.POD_GPU_MEMORY: str(8 << 30)},
            scheduler_name=jax_constants.SCHEDULER_NAME))
    assert all(r.result == "bound" for r in engine.run_until_idle())
    pods = {n: cluster.get_pod("default", n) for n in ("mnist-a", "mnist-b")}
    assert all(p.annotations[jax_constants.POD_GPU_UUID] == uuid
               for p in pods.values())
    for name in pods:
        cluster.set_pod_phase("default", name, PodPhase.RUNNING)
    config_dir, port_dir = tmp_path / "config", tmp_path / "ports"
    daemon = ConfigDaemon("e2e-node", cluster=cluster,
                          config_dir=str(config_dir), port_dir=str(port_dir))
    daemon.sync()
    assert f"default/mnist-a 1.0 0.5 {8 << 30}" in \
        (config_dir / uuid).read_text()

    tokend_port = free_port()
    with ChipSupervisor(uuid, config_dir=str(config_dir),
                        port_dir=str(port_dir), tokend_port=tokend_port,
                        poll_interval=0.1, base_quota_ms=50.0,
                        min_quota_ms=5.0, window_ms=1000.0) as supervisor:
        wait_listening(tokend_port)
        for pod in pods.values():
            wait_listening(int(pod.annotations[jax_constants.POD_MANAGER_PORT]))
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
        # pmgr stamped the pods' names: tokend charged the real pods
        probe = TokenClient("127.0.0.1", tokend_port, "probe")
        stat = json.loads(probe.stat())
        probe.close()
        for name in pods:
            entry = stat["pods"][f"default/{name}"]
            assert entry["grants"] >= 1 and entry["charged_total_ms"] > 0
        assert stat["pods"]["default/mnist-a"]["mem_cap"] == 8 << 30
        families = {f.name: f for f in supervisor.collect_metrics()}
        assert {s.labels["pod"] for s in
                families["tpushare_pod_grants_total"].samples} >= \
            {"default/mnist-a", "default/mnist-b"}

        # pod deletion flows back to the runtime
        cluster.delete_pod("default", "mnist-a")
        daemon.sync()
        deadline = time.time() + 5
        while len(supervisor.pod_managers) > 1 and time.time() < deadline:
            time.sleep(0.1)
        assert len(supervisor.pod_managers) == 1
    assert supervisor.tokend is None and not supervisor.pod_managers
