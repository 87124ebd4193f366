"""Pod label parsing + validation: the ``sharedgpu/*`` request contract.

The port's own copy of kubeshare_tpu/scheduler/podspec.py (the port imports nothing
of the JAX package).

Reproduces the reference's validation semantics (ref pkg/scheduler/
pod.go:179-327):

- no gpu labels at all -> regular pod (scheduled only for node fit/score)
- ``gpu_limit`` is mandatory for shared pods; format accepts fractions
  written like 0.5, whole numbers, or whole.0 — "1.5" is invalid (a pod
  needing >1 chip must ask for integers)
- request <= limit; request > 1 requires limit == request (whole chips)
- limit == request == 0 -> regular pod
- ``gpu_mem`` optional bytes; defaulted at reserve time to
  request * device memory (ref pod.go:419-422)
- ``priority`` in [-1, 100]; absent/<=0 -> opportunistic class
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

from .. import constants
from ..cell.cell import Cell
from ..cluster.api import Pod

# ref pod.go:20 — fraction <1, integer, or integer.0; full-match required.
# (the reference's unescaped '.' also admitted strings like "0x5" that then
# failed float parsing with the same user-facing error)
_VALUE_FORMAT = re.compile(r"0+\.[0-9]+|[1-9][0-9]*\.0+|[1-9][0-9]*")


class PodLabelError(ValueError):
    """User-facing validation error (PreFilter -> Unschedulable)."""


@dataclass
class PodStatus:
    """Parsed + validated shared-chip request state for one pod
    (ref pod.go:28-45)."""

    namespace: str
    name: str
    uid: str = ""
    limit: float = 0.0
    request: float = 0.0
    memory: int = 0
    model: str = ""
    priority: int = 0
    uuid: str = ""
    cells: List[Cell] = field(default_factory=list)
    port: int = 0
    node_name: str = ""
    pod_group: str = ""
    min_available: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def is_multi_chip(self) -> bool:
        return self.request > 1.0

    @property
    def is_opportunistic(self) -> bool:
        # priority <= 0 is the opportunistic class (ref pod.go:175-178)
        return self.priority <= 0


def parse_priority(pod: Pod) -> int:
    """ref pod.go:179-199: absent -> 0 (opportunistic); must be an int in
    [-1, 100]."""
    raw = pod.labels.get(constants.POD_PRIORITY)
    if raw is None or raw == "":
        return 0
    try:
        p = int(raw)
    except ValueError as e:
        raise PodLabelError(
            f"Pod {pod.key}: {constants.POD_PRIORITY} set error by user"
        ) from e
    if p > 100 or p < -1:
        raise PodLabelError(
            f"Pod {pod.key}: {constants.POD_PRIORITY} set error by user"
        )
    return p


def _parse_value(pod: Pod, label: str, raw: str) -> float:
    if _VALUE_FORMAT.fullmatch(raw) is None:
        raise PodLabelError(f"Pod {pod.key}: {label} set error by user")
    try:
        value = float(raw)
    except ValueError as e:
        raise PodLabelError(f"Pod {pod.key}: {label} converted error") from e
    if value < 0.0:
        raise PodLabelError(f"Pod {pod.key}: {label} converted error")
    return value


def parse_pod_labels(pod: Pod) -> Optional[PodStatus]:
    """Parse a pod's sharedgpu labels.

    Returns None for regular pods (no chip needed); raises PodLabelError on
    invalid settings; otherwise a populated PodStatus
    (ref pod.go:207-327).
    """
    status = PodStatus(
        namespace=pod.namespace,
        name=pod.name,
        uid=pod.uid,
        node_name=pod.node_name,
    )
    group_name, _headcount, _threshold, min_available = parse_group(pod)
    status.pod_group = group_name
    status.min_available = min_available
    status.priority = parse_priority(pod)

    raw_limit = pod.labels.get(constants.POD_GPU_LIMIT)
    raw_request = pod.labels.get(constants.POD_GPU_REQUEST)
    raw_memory = pod.labels.get(constants.POD_GPU_MEMORY)

    if raw_limit is None and raw_request is None and raw_memory is None:
        return None  # regular pod

    if raw_limit is None:
        raise PodLabelError(
            f"Pod {pod.key}: {constants.POD_GPU_LIMIT} set error by user"
        )
    limit = _parse_value(pod, constants.POD_GPU_LIMIT, raw_limit)

    request = 0.0
    if raw_request is not None:
        request = _parse_value(pod, constants.POD_GPU_REQUEST, raw_request)
        if (limit > 1.0 and limit != request) or request > limit:
            raise PodLabelError(
                f"Pod {pod.key}: {constants.POD_GPU_REQUEST} set or converted error"
            )

    if limit == 0.0 and request == 0.0:
        return None  # degenerate: no chip actually needed

    memory = 0
    if raw_memory is not None:
        try:
            memory = int(raw_memory)
        except ValueError as e:
            raise PodLabelError(
                f"Pod {pod.key}: {constants.POD_GPU_MEMORY} set or converted error"
            ) from e
        if memory < 0:
            raise PodLabelError(
                f"Pod {pod.key}: {constants.POD_GPU_MEMORY} set or converted error"
            )

    status.limit = limit
    status.request = request
    status.memory = memory
    status.model = pod.labels.get(constants.POD_GPU_MODEL, "")
    return status


def parse_group(pod: Pod):
    # implemented in podgroup.py; re-exported here to avoid an import cycle
    from .podgroup import parse_pod_group_labels

    return parse_pod_group_labels(pod)
