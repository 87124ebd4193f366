"""Port parity: kubeshare_tpu_torch.parallel.distributed against the JAX
package's multi-process bootstrap on the CPU.

The env half (``spec_from_env``, ``multislice_spec_from_env``) equals
JAX's over one table of env dicts; ``slice_device_mesh``'s
single-process virtual topology partitions ``[cpu] * 8`` as JAX's does
its 8 host devices and raises JAX's ``ValueError``s; and real OS
processes carrying the gang env rendezvous over gloo: a plain
``all_reduce``, the gang env of pods that JAX's scheduler placed, and the
cross-slice sum over the "dcn" column group of the MEGASCALE env."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from native_helpers import free_port

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.parallel import distributed as jax_dist
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.parallel import distributed as dist
from kubeshare_tpu_torch.parallel.mesh import Mesh

REPO = Path(__file__).resolve().parent.parent
# every subprocess's own limit: a hung rendezvous fails the test
RANK_TIMEOUT_S = 60

GANG = "TPUSHARE_GANG_NAME", "TPUSHARE_GANG_SIZE", "TPUSHARE_GANG_RANK"
ENVS = [
    # tests/test_scheduler.py::TestDistributedSpec
    {GANG[0]: "ddp", GANG[1]: "4", GANG[2]: "2",
     "TPUSHARE_COORDINATOR": "10.0.0.5"},
    {GANG[0]: "ddp", GANG[1]: "2", GANG[2]: "0"},
    {},
    {GANG[1]: "1", GANG[2]: "0"},
    {GANG[1]: "4", GANG[2]: "9"},
    # the rest of spec_from_env's guards
    {GANG[1]: "2", GANG[2]: "1", "TPUSHARE_COORDINATOR": "10.0.0.5:1234"},
    {GANG[1]: "2", GANG[2]: "1"},
    {GANG[1]: "two", GANG[2]: "1", GANG[0]: "g"},
    {GANG[1]: "2", GANG[2]: "-1", GANG[0]: "g"},
    {GANG[1]: "2", GANG[0]: "g"},
    # TestMultisliceSpecGuards and multislice_spec_from_env's guards
    {"MEGASCALE_NUM_SLICES": "2"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "junk"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
     "TPU_PROCESS_BOUNDS": "2,1,1"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "0"},
    {"MEGASCALE_NUM_SLICES": "1", "MEGASCALE_SLICE_ID": "0"},
    {"MEGASCALE_NUM_SLICES": "x", "MEGASCALE_SLICE_ID": "0"},
    {"MEGASCALE_NUM_SLICES": "4", "MEGASCALE_SLICE_ID": "4"},
    {"MEGASCALE_NUM_SLICES": "4", "MEGASCALE_SLICE_ID": "3",
     "TPU_PROCESS_BOUNDS": "2,2,1"},
    {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
     "TPU_PROCESS_BOUNDS": "2,x,1"},
]


def _fields(spec):
    return None if spec is None else dict(vars(spec))


def test_env_names_equal_jax():
    for name in ("ENV_MEGASCALE_NUM_SLICES", "ENV_MEGASCALE_SLICE_ID",
                 "ENV_PROCESS_BOUNDS", "METRIC_CAPACITY", "COLLECTOR_PORT",
                 "CHIP_CONFIG_DIR", "POD_MANAGER_PORT_DIR",
                 "TOKEND_BASE_PORT", "TOKEN_BASE_QUOTA_MS",
                 "TOKEN_MIN_QUOTA_MS", "TOKEN_WINDOW_MS", "LOG_DIR",
                 "LIBRARY_PATH", "ENV_POD_MANAGER_PORT", "ENV_POD_NAME"):
        assert getattr(constants, name) == getattr(jax_constants, name), name
    for name in ("ENV_GANG_NAME", "ENV_GANG_SIZE", "ENV_GANG_RANK",
                 "ENV_COORDINATOR", "DEFAULT_COORDINATOR_PORT"):
        assert getattr(dist, name) == getattr(jax_dist, name), name


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_specs_equal_jax(env):
    assert _fields(dist.spec_from_env(env)) == _fields(
        jax_dist.spec_from_env(env))
    assert _fields(dist.multislice_spec_from_env(env)) == _fields(
        jax_dist.multislice_spec_from_env(env))


def test_spec_values():
    spec = dist.spec_from_env(ENVS[0])
    assert (spec.coordinator_address, spec.num_processes, spec.process_id,
            spec.is_multi_process) == ("10.0.0.5:8476", 4, 2, True)
    assert dist.spec_from_env(ENVS[1]).coordinator_address == "ddp-0.ddp:8476"
    ms = dist.multislice_spec_from_env(ENVS[12])
    assert (ms.num_slices, ms.slice_id, ms.processes_per_slice) == (2, 1, 2)


def test_solo_pod_initializes_nothing():
    assert dist.initialize_from_env({}, device="cpu") is None
    assert not torch.distributed.is_initialized()


def test_virtual_topology_partitions_like_jax():
    ms = dist.MultisliceSpec(num_slices=2, slice_id=0, processes_per_slice=1)
    cpu = torch.device("cpu")
    mesh = dist.slice_device_mesh(ms, devices=[cpu] * 8)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("dcn", "device")
    assert mesh.devices.shape == (2, 4) and mesh.shape == {"dcn": 2,
                                                           "device": 4}
    assert all(d == cpu for d in mesh.devices.flat)
    # JAX's over its 8 host devices: the same contiguous partition
    jax_mesh = jax_dist.slice_device_mesh(ms, devices=jax.devices()[:8])
    assert [[d.id for d in row] for row in jax_mesh.devices] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    four = dist.slice_device_mesh(
        dist.MultisliceSpec(4, 3, 1), axis_names=("slice", "local"),
        devices=["cpu"] * 8)
    assert four.axis_names == ("slice", "local")
    assert four.devices.shape == (4, 2)


def test_non_tiling_and_uneven_groupings_raise_jax_messages(monkeypatch):
    ms = dist.MultisliceSpec(num_slices=2, slice_id=0, processes_per_slice=1)
    with pytest.raises(ValueError) as jax_err:
        jax_dist.slice_device_mesh(ms, devices=jax.devices()[:7])
    with pytest.raises(ValueError) as err:
        dist.slice_device_mesh(ms, devices=["cpu"] * 7)
    assert str(err.value) == str(jax_err.value) == \
        "7 devices do not tile 2 slices"

    # several processes: ranks reporting slices 0, 0, 0, 1 group 3 + 1
    class FakeDev:
        def __init__(self, i, s):
            self.id, self.process_index, self.slice_index = i, 0, s

    devs = [FakeDev(0, 0), FakeDev(1, 0), FakeDev(2, 0), FakeDev(3, 1)]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs)
    with pytest.raises(ValueError) as jax_err:
        jax_dist.slice_device_mesh(ms)
    monkeypatch.setattr(dist, "_world_size", lambda: 4)
    monkeypatch.setattr(dist, "_gather_slice_ids", lambda s: [0, 0, 0, 1])
    with pytest.raises(ValueError) as err:
        dist.slice_device_mesh(ms)
    assert str(err.value) == str(jax_err.value)
    assert "unevenly" in str(err.value)
    monkeypatch.setattr(dist, "_gather_slice_ids", lambda s: [0, 1, 1])
    with pytest.raises(ValueError, match="3 devices do not tile 2 slices"):
        dist.slice_device_mesh(ms)
    with pytest.raises(ValueError, match="another process's device"):
        dist.slice_device_mesh(ms, devices=["cpu"] * 4)


def test_rank_grid_orders_ranks_by_slice():
    grid = dist._rank_grid([1, 0, 1, 0], 2)
    assert grid.tolist() == [[1, 3], [0, 2]]


def _run_ranks(tmp_path, code, envs):
    """Run ``code`` in one process per env (each over the repo's
    PYTHONPATH, one thread, its own timeout); returns their stdouts."""
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(code))
    procs = []
    try:
        for extra in envs:
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("TPUSHARE_", "MEGASCALE_", "TPU_"))}
            env.update(extra)
            env.pop("LD_PRELOAD", None)
            env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                       CUDA_VISIBLE_DEVICES="")
            procs.append(subprocess.Popen(
                [sys.executable, str(worker)], env=env, cwd=str(REPO),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{out}\n{err[-3000:]}"
    return [out for out, _ in outs]


def test_two_process_rendezvous(tmp_path):
    """Two OS processes with the gang env rendezvous over gloo and agree
    on an all_reduce (the twin of
    tests/test_scheduler.py::TestDistributedSpec::test_two_process_rendezvous)."""
    port = free_port()
    code = """
        import torch
        from kubeshare_tpu_torch.parallel.distributed import initialize_from_env
        spec = initialize_from_env(device="cpu")
        assert spec is not None and spec.is_multi_process
        assert torch.distributed.get_backend() == "gloo"
        total = torch.ones(1)
        torch.distributed.all_reduce(total)
        assert torch.distributed.get_world_size() == 2
        print(f"rank {spec.process_id} allreduce_ok {float(total)}")
        torch.distributed.destroy_process_group()
    """
    outs = _run_ranks(tmp_path, code, [
        {"TPUSHARE_GANG_NAME": "gg", "TPUSHARE_GANG_SIZE": "2",
         "TPUSHARE_GANG_RANK": str(rank),
         "TPUSHARE_COORDINATOR": f"127.0.0.1:{port}"} for rank in range(2)])
    for rank, out in enumerate(outs):
        assert f"rank {rank} allreduce_ok 2.0" in out


def test_gang_env_drives_distributed_workload(tmp_path):
    """JAX's scheduler places a 2-member gang; two port workers carrying
    each bound pod's injected env rendezvous and all-reduce (the twin of
    tests/test_scheduler.py::TestDistributedSpec::test_gang_env_drives_distributed_workload)."""
    from test_scheduler import make_env, shared_pod

    cluster, _, engine, _ = make_env(nodes=("host-a",))
    for name in ("ddp-0", "ddp-1"):
        cluster.create_pod(shared_pod(name, request="0.5", limit="1.0",
                                      group="ddp", headcount=2,
                                      threshold=1.0))
    engine.run_until_idle()
    pods = [cluster.get_pod("default", n) for n in ("ddp-0", "ddp-1")]
    assert all(p.is_bound() for p in pods)
    port = free_port()
    envs = []
    for pod in pods:
        injected = dict(pod.containers[0].env)
        assert injected[jax_constants.ENV_PROCESS_BOUNDS] == "2,1,1"
        # in-cluster the coordinator resolves via the gang's headless
        # service; here the explicit override
        injected["TPUSHARE_COORDINATOR"] = f"127.0.0.1:{port}"
        envs.append(injected)
    code = """
        import os, torch
        from kubeshare_tpu_torch.parallel.distributed import initialize_from_env
        assert os.environ["TPU_PROCESS_BOUNDS"] == "2,1,1"
        spec = initialize_from_env(device="cpu")
        assert spec is not None and spec.num_processes == 2
        total = torch.ones(1)
        torch.distributed.all_reduce(total)
        print(f"rank {spec.process_id} allreduce_ok {float(total)}")
        torch.distributed.destroy_process_group()
    """
    outs = _run_ranks(tmp_path, code, envs)
    ranks = {line.split()[1] for out in outs for line in out.splitlines()
             if "allreduce_ok 2.0" in line}
    assert ranks == {"0", "1"}


def test_megascale_env_drives_cross_slice_sum(tmp_path):
    """JAX's scheduler places a cross-slice gang; two port workers build
    the rank mesh from each pod's MEGASCALE env and sum over the "dcn"
    column group: 1 (slice 0) + 2 (slice 1) = 3 (the twin of
    tests/test_multislice.py::TestMegascaleBootstrapDrive)."""
    from test_multislice import (MARKED_SLICE_INVENTORY,
                                 MARKED_SLICE_TOPOLOGY, gang_pod, make_env)

    cluster, _, engine = make_env(MARKED_SLICE_TOPOLOGY,
                                  MARKED_SLICE_INVENTORY)
    for i in range(2):
        cluster.create_pod(gang_pod(f"w{i}", "big", 2))
    engine.run_until_idle()
    port = free_port()
    envs = []
    for i in range(2):
        pod = cluster.get_pod("default", f"w{i}")
        assert pod.is_bound()
        injected = dict(pod.containers[0].env)
        assert injected[jax_constants.ENV_MEGASCALE_NUM_SLICES] == "2"
        injected["TPUSHARE_COORDINATOR"] = f"127.0.0.1:{port}"
        envs.append(injected)
    code = """
        import torch
        from kubeshare_tpu_torch.parallel.distributed import (
            RankMesh, initialize_from_env, multislice_spec_from_env,
            slice_device_mesh)
        ms = multislice_spec_from_env()
        assert ms is not None and ms.num_slices == 2, ms
        assert ms.processes_per_slice == 1, ms
        spec = initialize_from_env(device="cpu")
        assert spec is not None and spec.num_processes == 2
        mesh = slice_device_mesh(ms)
        assert isinstance(mesh, RankMesh)
        assert mesh.axis_names == ("dcn", "device")
        assert mesh.devices.shape == (2, 1), mesh.devices.shape
        # this rank lands in its own slice's row
        assert int(mesh.devices[ms.slice_id, 0]) == spec.process_id
        x = torch.full((1,), float(ms.slice_id + 1))
        torch.distributed.all_reduce(x, group=mesh.group("dcn"))
        # the row group holds this rank alone
        row = torch.full((1,), 5.0)
        torch.distributed.all_reduce(row, group=mesh.group("device"))
        assert float(row) == 5.0, row
        assert float(x) == 3.0, x
        print(f"slice {ms.slice_id} dcn_sum_ok {float(x)}")
        torch.distributed.destroy_process_group()
    """
    outs = _run_ranks(tmp_path, code, envs)
    slices = {line.split()[1] for out in outs for line in out.splitlines()
              if "dcn_sum_ok 3.0" in line}
    assert slices == {"0", "1"}
