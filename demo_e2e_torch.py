#!/usr/bin/env python3
"""End-to-end demo: the port's whole stack in one process, the PyTorch
twin of ``examples/demo_e2e.py``.

    python3 demo_e2e_torch.py                 # on the card
    python3 demo_e2e_torch.py --device cpu    # on the CPU (tests)

It starts the port's scheduler on an in-memory cluster, submits two
fractional MNIST pods (request 0.5, limit 1.0, 4 GiB each), lets the
port's config daemon write the chip's share and port tables, starts the
real native token runtime (``tpushare-tokend`` and one ``tpushare-pmgr``
a pod, built from ``native/`` if missing) under a ``ChipSupervisor``,
runs three token-gated MNIST steps for each pod through its pod
manager, then deletes one pod and shows the reclaim: the cell's
availability and memory back, its pod manager reaped.

On the card the chip is ``discover_local_chips()[0]`` and the topology
is built from its model; each pod's step is captured (one CUDA graph
replay).  Under ``--device cpu`` the chip is a named ``ChipInfo``
(``demo-node-gpu-0``, ``NVIDIA-H100-80GB-HBM3``, 80 GiB), as the JAX demo
names its chip, and the steps run eagerly.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time

NODE = "demo-node"
PODS = ("mnist-a", "mnist-b")
POD_MEMORY = 4 << 30
H100 = "NVIDIA-H100-80GB-HBM3"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def demo_topology(model: str) -> dict:
    """examples/demo_e2e.py's TOPOLOGY with a ``model`` leaf."""
    return {"cellTypes": {"DEMO-NODE": {
                "childCellType": model, "childCellNumber": 1,
                "childCellPriority": 80, "isNodeLevel": True}},
            "cells": [{"cellType": "DEMO-NODE", "cellId": NODE}]}


def banner(text: str) -> None:
    print(f"\n=== {text} ===", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from kubeshare_tpu_torch import constants, resolve_device
    from kubeshare_tpu_torch.cell import TopologyConfig, discover_local_chips
    from kubeshare_tpu_torch.cell.allocator import ChipInfo
    from kubeshare_tpu_torch.cell.spec import check_physical_cells
    from kubeshare_tpu_torch.cluster.api import FakeClock, Node, Pod, PodPhase
    from kubeshare_tpu_torch.cluster.fake import FakeCluster
    from kubeshare_tpu_torch.scheduler import KubeShareScheduler, SchedulerEngine

    device = resolve_device(args.device)
    capture = device.type == "cuda"
    if capture:
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False  # f32 convolutions
        chip = discover_local_chips()[device.index or 0]
    else:
        chip = ChipInfo(f"{NODE}-gpu-0", 80 << 30, H100, 0)
    summary = {"device": str(device), "chip": chip.uuid, "model": chip.model}

    banner("1. control plane: scheduler + inventory")
    topology = TopologyConfig.from_dict(demo_topology(chip.model))
    check_physical_cells(topology)
    cluster = FakeCluster()
    cluster.add_node(Node(NODE, {constants.NODE_LABEL_FILTER: "true"}))
    plugin = KubeShareScheduler(topology, cluster, lambda n: [chip],
                                clock=FakeClock(0.0))
    engine = SchedulerEngine(plugin, cluster, plugin.clock)
    print(f"registered node {NODE} with 1 x {chip.model} ({chip.uuid})")

    banner("2. submit two fractional pods (request 0.5 / limit 1.0)")
    for name in PODS:
        cluster.create_pod(Pod(
            name=name,
            labels={constants.POD_GPU_REQUEST: "0.5",
                    constants.POD_GPU_LIMIT: "1.0",
                    constants.POD_GPU_MEMORY: str(POD_MEMORY)},
            scheduler_name=constants.SCHEDULER_NAME,
        ))
    placements = {}
    for result in engine.run_until_idle():
        pod = cluster.get_pod("default", result.pod_key.split("/")[1])
        if result.result != "bound":
            raise RuntimeError(f"{result.pod_key}: {result.result} "
                               f"{result.message}")
        placements[pod.name] = {
            "node": result.node,
            "uuid": pod.annotations[constants.POD_GPU_UUID],
            "port": int(pod.annotations[constants.POD_MANAGER_PORT]),
            "env": {k: v for k, v in pod.containers[0].env.items()
                    if k in (constants.ENV_VISIBLE_DEVICES,
                             constants.ENV_POD_MANAGER_PORT,
                             constants.ENV_POD_NAME)}}
        print(f"  {result.pod_key}: {result.result} on {result.node} "
              f"chip={placements[pod.name]['uuid']} "
              f"port={placements[pod.name]['port']}")
        cluster.set_pod_phase(pod.namespace, pod.name, PodPhase.RUNNING)
    if sorted(placements) != sorted(PODS):
        raise RuntimeError(f"placed {sorted(placements)}, wanted {PODS}")
    summary["placements"] = placements

    workdir = tempfile.mkdtemp(prefix="tpushare-demo-")
    try:
        run_node(summary, chip, cluster, plugin, placements, workdir,
                 device, capture)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("\ndemo complete")
    return summary


def run_node(summary, chip, cluster, plugin, placements, workdir, device,
             capture) -> None:
    """Steps 3-6 on the node: configd, the native runtime, the gated
    steps and the reclaim, with the tables under ``workdir``."""
    import torch

    from kubeshare_tpu_torch.configd import ConfigDaemon
    from kubeshare_tpu_torch.isolation import ExecutionGuard, TokenClient
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import (cross_entropy_loss,
                                                    make_train_step)
    from kubeshare_tpu_torch.runtime import ChipSupervisor, ensure_binary
    from kubeshare_tpu_torch.utils.net import wait_listening

    banner("3. node daemon: configd writes the chip share table")
    config_dir = os.path.join(workdir, "config")
    port_dir = os.path.join(workdir, "ports")
    daemon = ConfigDaemon(NODE, cluster=cluster,
                          config_dir=config_dir, port_dir=port_dir)
    daemon.sync()

    def tables():
        out = {}
        for directory in (config_dir, port_dir):
            with open(os.path.join(directory, chip.uuid)) as f:
                out[os.path.basename(directory)] = f.read()
        return out

    summary["files"] = tables()
    print(summary["files"]["config"].strip())

    banner("4. native runtime: tokend + per-pod pmgr brokers")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        tokend_port = s.getsockname()[1]
    with ChipSupervisor(chip.uuid, config_dir=config_dir, port_dir=port_dir,
                        tokend_port=tokend_port, poll_interval=0.2,
                        tokend_binary=ensure_binary("tpushare-tokend"),
                        pmgr_binary=ensure_binary("tpushare-pmgr")) as sup:
        wait_listening(tokend_port)
        for name in PODS:
            wait_listening(placements[name]["port"])
        print(f"tokend on :{tokend_port}, pod managers: "
              f"{sorted(sup.pod_managers)}")

        banner("5. token-gated training (both pods share the chip)")
        steps = {}
        for name in PODS:
            client = TokenClient("127.0.0.1", placements[name]["port"],
                                 "stamped-by-pmgr")
            guard = ExecutionGuard(client=client, from_env=False)
            init_state, train_step = make_train_step(
                mnist_apply, loss_fn=cross_entropy_loss, capture=capture)
            state = init_state(mnist_init(torch.Generator().manual_seed(0),
                                          device=device))
            images = torch.zeros((8, 28, 28, 1), device=device)
            labels = torch.zeros((8,), dtype=torch.int64, device=device)
            losses = []
            for _ in range(3):
                guard.acquire()
                t0 = time.monotonic()
                state, loss = train_step(state, images, labels)
                losses.append(float(loss))  # waits for the step
                guard.charge((time.monotonic() - t0) * 1e3)
            guard.finish()
            client.close()
            steps[name] = {"losses": losses,
                           "tokens": guard.tokens_acquired,
                           "gated_ms": guard.total_gated_ms}
            print(f"  {name}: 3 steps, loss {losses[-1]:.3f}, "
                  f"tokens {guard.tokens_acquired}")
        summary["steps"] = steps

        stat_client = TokenClient("127.0.0.1", tokend_port, "probe")
        stat = json.loads(stat_client.stat())
        stat_client.close()
        print("tokend accounting:", json.dumps(stat, sort_keys=True))
        summary["tokend"] = {key: {k: entry.get(k) for k in (
            "grants", "charged_total_ms", "mem_cap")}
            for key, entry in stat["pods"].items()}
        for name in PODS:
            entry = stat["pods"].get(f"default/{name}", {})
            if entry.get("grants", 0) < 1 or entry.get("charged_total_ms", 0) <= 0:
                raise RuntimeError(f"tokend charged {name} nothing: {stat}")

        banner("6. teardown: delete mnist-a, watch reclamation")
        cluster.delete_pod("default", "mnist-a")
        daemon.sync()
        wanted = {f"default/mnist-b {placements['mnist-b']['port']}"}
        until = time.monotonic() + 10
        while set(sup.pod_managers) != wanted and time.monotonic() < until:
            time.sleep(0.1)
        leaf = plugin.allocator.leaf_cells[chip.uuid]
        summary["reclaim"] = {"files": tables(),
                              "available": leaf.available,
                              "free_memory": leaf.free_memory,
                              "pod_managers": sorted(sup.pod_managers)}
        print(f"chip availability back to {leaf.available} "
              f"(free memory {leaf.free_memory >> 30} GiB); "
              f"pod managers now: {sorted(sup.pod_managers)}")
        if set(sup.pod_managers) != wanted:
            raise RuntimeError(
                f"pod managers after the reclaim {sorted(sup.pod_managers)}")


if __name__ == "__main__":
    main()
