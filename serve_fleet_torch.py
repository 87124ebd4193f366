#!/usr/bin/env python3
"""Replica-fleet serving on a CUDA card: scheduler-placed replicas,
prefix-affinity routing, a scale-up, and a drain whose cache the
survivors inherit; the PyTorch twin of ``examples/serve_fleet.py``.

    python3 serve_fleet_torch.py                     # the example's model
    python3 serve_fleet_torch.py --small --device cpu     # tests

The example's model (d 256, 2 layers, 8 query heads over 2 KV heads,
f32, rope) served by a ``ReplicaFleet`` of 2 engines (3 slots, 32 blocks
of 16 each, up to 3 replicas, a 4 MiB shared host tier).  Every replica
is a pod that ``FleetPlacementPlane`` pushes through the port's
scheduler (request 0.5, limit 0.5, 1 GiB) on the example's three hosts
of four chips, built with ``TopologyConfig.from_dict`` (the example's
YAML needs PyYAML) with the leaves named after the card's model (on the
card, ``discover_local_chips()``'s; under ``--device cpu``
``NVIDIA-H100-80GB-HBM3``).  Every engine runs on the one device.

The checks are the example's: each replica bound with a cell; the three
prefix families each served by one replica; ``scale_up()`` places and
warms a third replica with no new capture on the others; ``drain()``
retires the "legal" family's owner, its pod is deleted, and the
survivors promote its trie (at least 32 of the 48 prefix tokens
visible, a tier hit on the next family member); the merged metrics show
2 active replicas and 1 retired, prefix tokens skipped, and no graph
captured after warm-up and the scale-up.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

NODES = ("host-a", "host-b", "host-c")
CHIPS_PER_NODE = 4
H100 = "NVIDIA-H100-80GB-HBM3"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--small", action="store_true",
                        help="a narrow model a CPU test serves in seconds")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def fleet_topology(model: str) -> dict:
    """examples/serve_fleet.py's TOPOLOGY with ``model`` leaves."""
    return {
        "cellTypes": {
            "GPU-NODE": {"childCellType": model,
                         "childCellNumber": CHIPS_PER_NODE,
                         "childCellPriority": 60, "isNodeLevel": True},
            "3-GPU-NODE": {"childCellType": "GPU-NODE",
                           "childCellNumber": len(NODES)},
        },
        "cells": [{"cellType": "3-GPU-NODE",
                   "cellChildren": [{"cellId": n} for n in NODES]}],
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from kubeshare_tpu_torch import constants, resolve_device
    from kubeshare_tpu_torch.cell import TopologyConfig, discover_local_chips
    from kubeshare_tpu_torch.cell.allocator import ChipInfo
    from kubeshare_tpu_torch.cell.spec import check_physical_cells
    from kubeshare_tpu_torch.cluster.api import FakeClock, Node
    from kubeshare_tpu_torch.cluster.fake import FakeCluster
    from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                        transformer_init)
    from kubeshare_tpu_torch.scheduler import (FleetPlacementPlane,
                                               KubeShareScheduler,
                                               SchedulerArgs, SchedulerEngine)
    from kubeshare_tpu_torch.serving import EngineConfig, ReplicaFleet, Request

    device = resolve_device(args.device)

    print("=== 1. model + per-replica geometry ===")
    width = (dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
             if args.small else
             dict(d_model=256, n_heads=8, n_kv_heads=2, d_ff=1024))
    config = TransformerConfig(
        n_layers=2, vocab_size=8000, max_seq_len=192, dtype=torch.float32,
        positional="rope", attention="reference", **width)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device=device)
    ec = EngineConfig(num_slots=3, block_size=16, num_blocks=33,
                      max_request_len=160, prefill_chunk=32)
    print(f"each replica: {ec.num_slots} slots, {ec.num_blocks - 1} "
          f"allocatable KV blocks x {ec.block_size} tokens, on {device}")

    print(f"=== 2. control plane: {len(NODES)} nodes, the port's "
          f"scheduler ===")
    if device.type == "cuda":
        card = discover_local_chips()[device.index or 0]
        model, memory = card.model, card.memory
    else:
        model, memory = H100, 80 << 30
    topology = TopologyConfig.from_dict(fleet_topology(model))
    check_physical_cells(topology)
    inventory = {node: [ChipInfo(f"{node}-gpu-{i}", memory, model, i)
                        for i in range(CHIPS_PER_NODE)]
                 for node in NODES}
    cluster = FakeCluster()
    for n in NODES:
        cluster.add_node(Node(
            name=n, labels={constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(1000.0)
    plugin = KubeShareScheduler(
        topology=topology, cluster=cluster,
        inventory=lambda node: inventory.get(node, []),
        args=SchedulerArgs(), clock=clock)
    plane = FleetPlacementPlane(
        SchedulerEngine(plugin, cluster, clock), cluster,
        gpu_request="0.5", gpu_limit="0.5", gpu_memory=1 << 30,
        priority=10)
    print(f"{len(NODES)} x {CHIPS_PER_NODE} x {model}")

    print("=== 3. fleet of 2, every replica a scheduled pod ===")
    fleet = ReplicaFleet(params, config, ec, replicas=2,
                         max_replicas=3, placement=plane,
                         shared_tier_bytes=4 << 20, device=device)
    placements = {}
    for h in fleet.replicas:
        p = h.placement
        placements[h.name] = (p.node, p.cell_id, p.gpu_uuid)
        print(f"{h.name}: pod {p.pod_name} bound on {p.node}, "
              f"cell {p.cell_id}, vGPU {p.gpu_uuid}")
        if p.cell_id == "":
            raise RuntimeError(f"{h.name} bound without a cell")
    fleet.warmup()
    baseline = fleet.capture_counts()

    print("=== 4. shared-prefix traffic, routed by affinity ===")
    rng = np.random.default_rng(7)
    families = {name: rng.integers(0, config.vocab_size, 48)
                for name in ("legal", "chat", "code")}

    def member(fam, i, max_new=8):
        tail = rng.integers(0, config.vocab_size,
                            int(rng.integers(6, 15)))
        return Request(f"{fam}{i}", np.concatenate(
            [families[fam], tail]), max_new)

    def served():
        results = fleet.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return sum(len(r.tokens) for r in results.values())

    start = time.monotonic()
    tokens = 0
    # one opener per family warms a trie somewhere...
    for fam in families:
        fleet.submit(member(fam, 0))
    tokens += served()
    # ...and every later family member should chase its cache
    for i in (1, 2):
        for fam in families:
            fleet.submit(member(fam, i))
        tokens += served()
    owners = {fam: {fleet.owner_of(f"{fam}{i}") for i in range(3)}
              for fam in families}
    for fam, reps in sorted(owners.items()):
        print(f"family {fam!r}: all 3 requests on {sorted(reps)}")
        if len(reps) != 1:
            raise RuntimeError(
                f"family {fam!r} scattered across {sorted(reps)}: "
                f"affinity routing broke")
    print(f"routing decisions so far: {fleet.routing_decisions}")

    print("=== 5. scale up: third replica placed + warmed online ===")

    def captured():
        return {h.name: sum(h.engine.capture_counts().values())
                for h in fleet.replicas}

    before_scale = captured()
    h3 = fleet.scale_up()
    p3 = h3.placement
    placements[h3.name] = (p3.node, p3.cell_id, p3.gpu_uuid)
    after_scale = captured()
    print(f"{h3.name}: pod {p3.pod_name} bound on {p3.node}, "
          f"cell {p3.cell_id}; graphs by replica {before_scale} -> "
          f"{after_scale}")
    if any(after_scale[n] != c for n, c in before_scale.items()):
        raise RuntimeError(
            f"the scale-up captured on the other replicas: "
            f"{before_scale} -> {after_scale}")
    baseline = fleet.capture_counts()  # +1 replica's warm-up programs
    for fam in families:
        fleet.submit(member(fam, 3))
    tokens += served()

    print("=== 6. drain: the retiree's cache outlives it ===")
    victim = fleet.owner_of("legal0")
    survivor_names = [h.name for h in fleet.replicas
                      if h.name != victim and h.state == "active"]
    before = {n: fleet._handle(n).engine.prefix_match_len(
        families["legal"]) for n in survivor_names}
    fleet.drain(victim)
    fleet.run()      # finishes in-flight work, then hands the trie over
    if fleet._handle(victim).state != "retired":
        raise RuntimeError(f"{victim} never retired after drain")
    if cluster.get_pod(plane.namespace, f"fleet-{victim}") is not None:
        raise RuntimeError(f"{victim}'s pod survived its retirement")
    inherited = {n: fleet._handle(n).engine.prefix_match_len(
        families["legal"]) for n in survivor_names}
    print(f"'legal' prefix visible on survivors: {before} tokens "
          f"before drain -> {inherited} after (host-tier handoff)")
    if max(inherited.values()) < 32:
        raise RuntimeError(
            f"survivors inherited only {inherited} tokens of the "
            f"retiree's 48-token prefix")
    # a post-drain family member promotes the inherited blocks
    fleet.submit(member("legal", 4))
    tokens += served()
    heir = fleet.owner_of("legal4")
    hits = fleet._handle(heir).engine.tier_hit_requests
    print(f"legal4 routed to {heir}, tier hits there: {hits}")
    if hits < 1:
        raise RuntimeError(
            "the follow-up request never promoted the inherited cache")
    elapsed = time.monotonic() - start

    print("=== 7. the fleet's merged metrics plane ===")
    metric = {(s.name, tuple(sorted(s.labels.items()))): s.value
              for f in fleet.collect_metrics() for s in f.samples}

    def total(name, **want):
        return sum(v for (n, labels), v in metric.items()
                   if n == name and all(
                       dict(labels).get(k) == w for k, w in want.items()))

    states = {st: int(total("kubeshare_serving_fleet_replicas", state=st))
              for st in ("active", "draining", "retired")}
    hit_tokens = int(total("kubeshare_serving_prefix_hit_tokens_total"))
    scale = {d: int(total("kubeshare_serving_fleet_scale_events_total",
                          direction=d)) for d in ("up", "down")}
    routing = {r: int(total("kubeshare_serving_fleet_routing_decisions_total",
                            reason=r))
               for r in ("affinity", "least_loaded", "spill")}
    print(f"replicas by state: {states}; scale events: up={scale['up']} "
          f"down={scale['down']}; drains observed: "
          f"{int(total('kubeshare_serving_fleet_drain_seconds_count'))}")
    print(f"routing: affinity={routing['affinity']} "
          f"least_loaded={routing['least_loaded']} "
          f"spill={routing['spill']}; prefix tokens skipped: {hit_tokens}")
    recaptures = sum(fleet.capture_counts().values()) - sum(
        baseline.values())
    print(f"aggregate: {tokens} tokens in {elapsed:.2f} s "
          f"({tokens / elapsed:.0f} tok/s); captures after "
          f"warmup/scale-up: {recaptures}")
    if states != {"active": 2, "draining": 0, "retired": 1}:
        raise RuntimeError(f"unexpected fleet state {states}")
    if hit_tokens <= 0:
        raise RuntimeError("affinity routing never skipped a prefix")
    if recaptures:
        raise RuntimeError(
            f"{recaptures} graphs captured after warmup: a static-shape "
            f"leak in a replica")
    print("fleet demo complete")
    return {
        "device": str(device), "tokens": tokens, "seconds": elapsed,
        "tokens_per_s": tokens / elapsed, "placements": placements,
        "owners": {fam: sorted(reps) for fam, reps in owners.items()},
        "captures_by_replica": after_scale, "victim": victim,
        "inherited": inherited, "heir": heir, "tier_hits": hits,
        "states": states, "routing": routing, "prefix_hit_tokens": hit_tokens,
        "captures_after_warmup": recaptures,
    }


if __name__ == "__main__":
    main()
