"""Serving replicas as scheduler workloads: the fleet-to-pod adapter.

The port's copy of kubeshare_tpu/scheduler/placement.py.  Each replica
of the port's serving fleet (serving/fleet.py) is rendered as a
pod-shaped request carrying the ``sharedgpu/*`` fractional-cell labels,
pushed through the port's
:class:`~kubeshare_tpu_torch.scheduler.framework.SchedulerEngine` cycle,
and its binding read back from the post-bind annotations
(``cell_id`` / ``gpu_uuid`` / ``gpu_manager_port``), exactly what the
reference scheduler stamps on a placed pod.

The fleet stays decoupled: it sees only ``place(name)`` /
``release(name)``.  What the control plane learns in return is real —
a replica that cannot be placed fails LOUDLY before the fleet builds
an engine for it, and a retired replica's cells are reclaimed through
the same pod-deleted path every other workload uses."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .. import constants
from ..cluster.api import Pod


@dataclass(frozen=True)
class ReplicaPlacement:
    """One replica's binding: the node and fractional cell the
    scheduler reserved, plus the per-cell identity (``gpu_uuid`` keys
    the tokend vGPU pool; ``manager_port`` is the co-located manager's
    port, None when the scheduler did not stamp one)."""

    replica: str
    pod_name: str
    node: str
    cell_id: str
    gpu_uuid: str
    manager_port: Optional[int]


class FleetPlacementPlane:
    """``place``/``release`` for :class:`~kubeshare_tpu_torch.serving.fleet.
    ReplicaFleet`, backed by a live scheduler engine + cluster pair.

    ``gpu_request``/``gpu_limit`` are the fractional-cell ask each
    replica pod carries (strings, exactly as the pod labels spell them
    — ``request < limit`` makes the replica opportunistic, equal makes
    it guaranteed, following podspec.py's parsing).  ``priority`` maps
    onto the scheduler's QoS split the same way the serving tenants do
    (> 0 guarantee, <= 0 opportunistic)."""

    def __init__(
        self,
        engine,
        cluster,
        *,
        namespace: str = "serving",
        gpu_request: str = "0.5",
        gpu_limit: str = "1.0",
        gpu_memory: Optional[int] = None,
        priority: Optional[int] = None,
        model: Optional[str] = None,
        pod_prefix: str = "fleet",
    ) -> None:
        self.engine = engine
        self.cluster = cluster
        self.namespace = namespace
        self.gpu_request = gpu_request
        self.gpu_limit = gpu_limit
        self.gpu_memory = gpu_memory
        self.priority = priority
        self.model = model
        self.pod_prefix = pod_prefix
        # release-cause ledger: "retired" vs crash-recovery causes
        self.release_causes: Dict[str, int] = {}

    def _pod_name(self, replica: str) -> str:
        return f"{self.pod_prefix}-{replica}"

    def place(self, replica: str) -> ReplicaPlacement:
        """Create the replica's pod and drive scheduler cycles until it
        binds; loud when the cluster cannot place it (the fleet must
        not build an engine the control plane has no cell for)."""
        name = self._pod_name(replica)
        labels = {
            constants.POD_GPU_LIMIT: self.gpu_limit,
            constants.POD_GPU_REQUEST: self.gpu_request,
        }
        if self.gpu_memory is not None:
            labels[constants.POD_GPU_MEMORY] = str(self.gpu_memory)
        if self.priority is not None:
            labels[constants.POD_PRIORITY] = str(self.priority)
        if self.model is not None:
            labels[constants.POD_GPU_MODEL] = self.model
        self.cluster.create_pod(Pod(
            namespace=self.namespace, name=name, labels=labels,
            scheduler_name=constants.SCHEDULER_NAME))
        statuses = self.engine.run_until_idle()
        pod = self.cluster.get_pod(self.namespace, name)
        key = f"{self.namespace}/{name}"
        if pod is None or not pod.is_bound() \
                or constants.POD_CELL_ID not in pod.annotations:
            mine = [s for s in statuses if s.pod_key == key]
            detail = (f"{mine[-1].result}: {mine[-1].message}" if mine
                      else "no scheduling cycle reached the pod")
            raise RuntimeError(
                f"replica {replica!r} is unplaceable: pod {key} did "
                f"not bind ({detail})")
        ann = pod.annotations
        port = ann.get(constants.POD_MANAGER_PORT)
        return ReplicaPlacement(
            replica=replica,
            pod_name=name,
            node=pod.node_name,
            cell_id=ann[constants.POD_CELL_ID],
            gpu_uuid=ann.get(constants.POD_GPU_UUID, ""),
            manager_port=int(port) if port else None,
        )

    def release(self, replica: str, cause: str = "retired") -> None:
        """Delete the replica's pod — the scheduler's pod-deleted
        handler reclaims its cells, like any other workload's exit.
        Idempotent: releasing an unknown replica is a no-op (the pod
        may already be gone — which is exactly the crash-recovery
        case: the fleet's health monitor releases a replica whose
        process is already dead, and the reclaim is the same
        pod-deleted path a voluntary retirement takes).  ``cause``
        tags the release in :attr:`release_causes` ("retired" for
        voluntary drain, "liveness"/"watchdog" from crash recovery) so
        operators can tell planned churn from failures at the
        placement plane."""
        self.release_causes[cause] = self.release_causes.get(cause, 0) + 1
        self.cluster.delete_pod(self.namespace, self._pod_name(replica))
