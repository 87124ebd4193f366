"""Cluster-wide placement exporter (ref pkg/aggregator).

The port's copy of kubeshare_tpu/aggregator/aggregator.py (the port
imports nothing of the JAX package).  It bridges the scheduler's
placement decisions to the node daemons: it lists the Running pods that
kubeshare-scheduler manages and exports one ``gpu_requirement`` sample a
shared pod with the 12 reference labels, in the JAX module's order (ref
pkg/aggregator/aggregator.go:22-38), so its exposition text equals the
JAX aggregator's byte for byte on the same pods.  The port's configd
reads it in aggregator mode (``ConfigDaemon(aggregator_url=...)``).

The card's UUID comes from the ``sharedgpu/gpu_uuid`` annotation, which
the scheduler writes and which is authoritative.  Where a pod has none,
the port falls back to ``NVIDIA_VISIBLE_DEVICES``, the device UUIDs the
port's scheduler injects and the variable the reference read (ref
pkg/aggregator/pod.go:130-154); the JAX aggregator falls back to
``TPU_VISIBLE_CHIPS``, which holds a chip index.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

from .. import constants
from ..cluster.api import ClusterAPI, Pod, PodPhase
from ..utils.promtext import MetricFamily, MetricServer


@dataclass
class PodRequirement:
    namespace: str
    name: str
    pod_id: str
    node: str
    group_name: str
    min_available: str
    limit: str
    request: str
    memory: str
    cell_id: str
    uuid: str
    port: str


def process_pod(pod: Pod) -> Optional[PodRequirement]:
    """ref pkg/aggregator/pod.go:76-128."""
    limit = pod.labels.get(constants.POD_GPU_LIMIT)
    if limit is None:
        return None  # regular pod: not exported

    group_name = pod.labels.get(constants.POD_GROUP_NAME, pod.key)
    min_available = pod.labels.get(constants.POD_GROUP_MIN_AVAILABLE, "1")
    request = pod.labels.get(constants.POD_GPU_REQUEST, "0.0")
    memory = pod.labels.get(
        constants.POD_GPU_MEMORY, pod.annotations.get(constants.POD_GPU_MEMORY, "0")
    )
    uuid = pod.annotations.get(
        constants.POD_GPU_UUID, pod.get_env(constants.ENV_VISIBLE_DEVICES) or ""
    )
    port = pod.annotations.get(
        constants.POD_MANAGER_PORT, pod.get_env(constants.ENV_POD_MANAGER_PORT) or "0"
    )
    cell_id = pod.annotations.get(constants.POD_CELL_ID, "")

    return PodRequirement(
        namespace=pod.namespace,
        name=pod.name,
        pod_id=pod.uid,
        node=pod.node_name,
        group_name=group_name,
        min_available=min_available,
        limit=limit,
        request=request,
        memory=memory,
        cell_id=cell_id,
        uuid=uuid,
        port=port,
    )


class Aggregator:
    def __init__(self, cluster: ClusterAPI) -> None:
        self.cluster = cluster

    def get_pods(self) -> List[PodRequirement]:
        pods = self.cluster.list_pods(
            scheduler_name=constants.SCHEDULER_NAME, phase=PodPhase.RUNNING
        )
        result = []
        for pod in pods:
            requirement = process_pod(pod)
            if requirement is not None:
                result.append(requirement)
        return result

    def collect(self) -> List[MetricFamily]:
        family = MetricFamily(
            constants.METRIC_REQUIREMENT, "Chip requirement of the pod."
        )
        now = float(int(time.time()))
        for r in self.get_pods():
            family.add(
                {
                    "namespace": r.namespace,
                    "pod": r.name,
                    "pod_id": r.pod_id,
                    "node": r.node,
                    "group_name": r.group_name,
                    "min_available": r.min_available,
                    "limit": r.limit,
                    "request": r.request,
                    "memory": r.memory,
                    "cell_id": r.cell_id,
                    "uuid": r.uuid,
                    "port": r.port,
                },
                now,
            )
        return [family]

    def serve(self, port: int = constants.AGGREGATOR_PORT) -> MetricServer:
        server = MetricServer(self.collect, port=port, path="/kubeshare-aggregator")
        server.start()
        return server
