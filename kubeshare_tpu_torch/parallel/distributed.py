"""Multi-process bootstrap: gang placement -> torch.distributed.

Port of kubeshare_tpu/parallel/distributed.py.  The scheduler injects
each gang member's coordinates (TPUSHARE_GANG_NAME/SIZE/RANK) at
placement; the coordinator address comes from a headless service or an
explicit env (TPUSHARE_COORDINATOR) — rank 0's address by convention.
The JAX package hands them to ``jax.distributed.initialize``; here
``initialize_from_env()`` hands them to
``torch.distributed.init_process_group`` (the TorchElastic rendezvous of
the reference's DDP workloads, with the address given explicitly), and
``make_train_step(..., process_group=True)`` trains data-parallel over
the processes.

The backend is NCCL when the process's device is CUDA and gloo on the
CPU.  NCCL refuses two ranks on one GPU ("Duplicate GPU detected"), so a
gang that runs several ranks on one card passes ``backend="gloo"``
explicitly.

    spec = initialize_from_env()          # None for a solo pod
    ms = multislice_spec_from_env()       # None unless MEGASCALE_* is set
    mesh = slice_device_mesh(ms)          # ranks on ("dcn", "device")
    init_state, train_step = make_train_step(apply, process_group=mesh.group("dcn"))
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import constants, resolve_device
from ..utils.logger import get_logger
from .mesh import (Mesh, MeshSpec, RankMesh, _device_array, _mesh_axes,
                   _visible_cuda_devices, _world_size)

ENV_GANG_NAME = "TPUSHARE_GANG_NAME"
ENV_GANG_SIZE = "TPUSHARE_GANG_SIZE"
ENV_GANG_RANK = "TPUSHARE_GANG_RANK"
ENV_COORDINATOR = "TPUSHARE_COORDINATOR"
DEFAULT_COORDINATOR_PORT = 8476


@dataclass(frozen=True)
class DistributedSpec:
    coordinator_address: str
    num_processes: int
    process_id: int

    @property
    def is_multi_process(self) -> bool:
        return self.num_processes > 1


def spec_from_env(environ: Optional[Mapping[str, str]] = None) -> Optional[DistributedSpec]:
    """Derive distributed-init arguments from the scheduler-injected env.

    Returns None when the pod is not part of a multi-process gang (solo
    pods and single-process gangs need no distributed init).
    """
    env = environ if environ is not None else os.environ
    size_raw = env.get(ENV_GANG_SIZE)
    rank_raw = env.get(ENV_GANG_RANK)
    if not size_raw or rank_raw is None:
        return None
    try:
        size = int(size_raw)
        rank = int(rank_raw)
    except ValueError:
        return None
    if size <= 1:
        return None
    if not 0 <= rank < size:
        return None
    coordinator = env.get(ENV_COORDINATOR, "")
    if not coordinator:
        # convention: a headless service resolving to rank 0, named after
        # the gang (e.g. k8s `<gang>-0.<gang>` for a StatefulSet)
        gang = env.get(ENV_GANG_NAME, "")
        if not gang:
            return None
        coordinator = f"{gang}-0.{gang}:{DEFAULT_COORDINATOR_PORT}"
    elif ":" not in coordinator:
        coordinator = f"{coordinator}:{DEFAULT_COORDINATOR_PORT}"
    return DistributedSpec(coordinator, size, rank)


@dataclass(frozen=True)
class MultisliceSpec:
    """The DCN tier of the scheduler's bootstrap contract: the
    workload-visible view of the MEGASCALE_* env, so a training script
    can build a mesh whose outer axis is the slice boundary (collectives
    on that axis cross it, everything inner stays within a slice)."""

    num_slices: int
    slice_id: int
    processes_per_slice: int


def multislice_spec_from_env(
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[MultisliceSpec]:
    """Read the scheduler-injected MEGASCALE env; None when single-slice.

    Single-slice gangs get no MEGASCALE env at all (the plugin injects it
    only for cross-slice plans), so None is the common case.
    """
    env = environ if environ is not None else os.environ
    slice_id_raw = env.get(constants.ENV_MEGASCALE_SLICE_ID)
    try:
        num_slices = int(env.get(constants.ENV_MEGASCALE_NUM_SLICES, "1"))
    except ValueError:
        return None
    if num_slices <= 1:
        return None
    # the plugin always injects NUM_SLICES and SLICE_ID together; a
    # multi-slice count with no id is a broken contract, not slice 0
    # (every process defaulting to 0 would build a silently wrong mesh)
    if slice_id_raw is None:
        return None
    try:
        slice_id = int(slice_id_raw)
    except ValueError:
        return None
    if not 0 <= slice_id < num_slices:
        return None
    # the process grid is per slice (the plugin injects the placing
    # slice's member count, uniform across slices)
    processes = 1
    bounds = env.get(constants.ENV_PROCESS_BOUNDS, "")
    if bounds:
        try:
            for b in bounds.split(","):
                processes *= int(b)
        except ValueError:
            processes = 1
    return MultisliceSpec(num_slices, slice_id, max(1, processes))


def _gather_slice_ids(slice_id: int) -> List[int]:
    """Every rank's slice id, in rank order (over the default group)."""
    import torch.distributed as dist

    gathered: List[Optional[int]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, int(slice_id))
    return [int(s) for s in gathered]


def _tile(n: int, num_slices: int) -> int:
    if n % num_slices != 0:
        raise ValueError(f"{n} devices do not tile {num_slices} slices")
    return n // num_slices


def _rank_grid(slice_ids: Sequence[int], num_slices: int) -> np.ndarray:
    """Ranks grouped by the slice each reported, (num_slices, -1), ranks
    in order within a slice; an uneven grouping raises."""
    per_slice = _tile(len(slice_ids), num_slices)
    counts: Dict[int, int] = {}
    for s in slice_ids:
        counts[s] = counts.get(s, 0) + 1
    if counts != {s: per_slice for s in range(num_slices)}:
        # an uneven grouping reshaped anyway would mix slices within a
        # mesh row and run 'dcn' collectives over wrong groups
        raise ValueError(
            f"devices group unevenly across slices: {counts} "
            f"(expected {per_slice} in each of {num_slices})"
        )
    ordered = sorted(range(len(slice_ids)), key=lambda r: (slice_ids[r], r))
    return np.array(ordered, dtype=np.int64).reshape(num_slices, -1)


def _axis_groups(grid: np.ndarray,
                 axis_names: Sequence[str]) -> Dict[Tuple[str, ...], object]:
    """This rank's subgroup over every combination of the axes of
    ``grid`` (keyed by the axis names in grid order): the ranks that
    differ from it only on those axes.  Every rank creates every group,
    in one order, as ``new_group`` requires."""
    import torch.distributed as dist

    rank = dist.get_rank()
    groups: Dict[Tuple[str, ...], object] = {}
    for n in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(range(len(axis_names)), n):
            rest = [a for a in range(grid.ndim) if a not in axes]
            size = int(np.prod([grid.shape[a] for a in axes]))
            lines = np.transpose(grid, rest + list(axes)).reshape(-1, size)
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if rank in members:
                    groups[tuple(axis_names[a] for a in axes)] = group
    return groups


def rank_mesh(spec: MeshSpec, device=None) -> RankMesh:
    """``make_mesh(spec)`` over a gang: the default group's ranks on
    (dp, tp, sp) — (dp, ep, tp, sp) when ep > 1 — in rank order, as JAX
    orders a multi-process ``jax.devices()`` by process, with every
    subgroup of every combination of axes; this rank on ``device``
    (None: its current CUDA device, raising without one)."""
    import torch.distributed as dist

    shape, names = _mesh_axes(spec, dist.get_world_size())
    grid = np.arange(dist.get_world_size(), dtype=np.int64).reshape(shape)
    return RankMesh(grid, names, _axis_groups(grid, names),
                    resolve_device(device))


def rank_mesh_over(axis_names: Sequence[str], shape: Sequence[int],
                   device=None) -> RankMesh:
    """The gang's ranks in rank order on any named axes, e.g.
    ``rank_mesh_over(("pp", "sp"), (2, 2))`` for a pipeline: the
    counterpart of JAX's ``Mesh(np.array(jax.devices()).reshape(shape),
    axis_names)`` over a multi-process ``jax.devices()``, with every
    subgroup of every combination of axes; this rank on ``device`` (as
    :func:`rank_mesh`).  The axes' product must be the world size."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if int(np.prod(shape)) != world or len(shape) != len(axis_names):
        raise ValueError(
            f"axes {tuple(axis_names)} of sizes {tuple(shape)} do not lay "
            f"out a gang of {world} ranks")
    grid = np.arange(world, dtype=np.int64).reshape(tuple(shape))
    names = tuple(axis_names)
    return RankMesh(grid, names, _axis_groups(grid, names),
                    resolve_device(device))


def slice_device_mesh(
    ms: MultisliceSpec,
    axis_names: tuple = ("dcn", "device"),
    devices: Optional[Sequence] = None,
):
    """Global mesh whose OUTER axis is the slice boundary, shaped
    (num_slices, -1): shard data-parallel axes on ``dcn``, keep tensor
    and sequence axes inner.

    - One process (the single-process virtual topology): ``devices``
      (default: every visible CUDA device; a device may repeat, as in
      ``[cuda:0] * 8``) partition contiguously into ``num_slices``
      groups, simulating the boundary; returns a
      :class:`~kubeshare_tpu_torch.parallel.mesh.Mesh`.
    - Several processes (``torch.distributed`` initialised, world size
      > 1): each process knows only its own slice id, so the ranks
      gather their ids once over the default group and are grouped by
      the slice each reported; returns a :class:`RankMesh` of ranks
      (no device of its own: it groups ranks) with a subgroup per row,
      per column and over both.  A ``torch.device``
      cannot name another process's device, so ``devices`` must be
      None here.

    A count that does not tile ``num_slices`` and ranks that group
    unevenly raise ``ValueError``.  The JAX function's third route, the
    ``slice_index`` the TPU runtime stamps on every device, has no CUDA
    counterpart: no CUDA device carries a slice id, so the ranks'
    reported ids are the only source.
    """
    if _world_size() > 1:
        if devices is not None:
            raise ValueError(
                "slice_device_mesh over several processes groups ranks; "
                "a torch.device cannot name another process's device, so "
                "pass devices=None")
        grid = _rank_grid(_gather_slice_ids(ms.slice_id), ms.num_slices)
        return RankMesh(grid, axis_names, _axis_groups(grid, axis_names))
    devices = list(devices) if devices is not None else _visible_cuda_devices()
    per_slice = _tile(len(devices), ms.num_slices)
    return Mesh(_device_array(devices, (ms.num_slices, per_slice)), axis_names)


def initialize_from_env(
    environ: Optional[Mapping[str, str]] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[DistributedSpec]:
    """``torch.distributed.init_process_group`` from the gang env; a
    no-op returning None for a solo pod.

    ``backend``: an explicit one wins; otherwise NCCL when ``device``
    (None: the CUDA card, raising without one) is a CUDA device and gloo
    when it is the CPU.  Two ranks on one card must pass ``"gloo"``:
    NCCL refuses a duplicate GPU.  Returns the spec."""
    import torch.distributed as dist

    log = get_logger("kubeshare-distributed")
    spec = spec_from_env(environ)
    if spec is None:
        log.info("no multi-process gang env; running single-process")
        return None
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    log.info(
        "initializing torch.distributed: backend=%s coordinator=%s size=%d "
        "rank=%d", backend, spec.coordinator_address, spec.num_processes,
        spec.process_id,
    )
    dist.init_process_group(
        backend,
        init_method=f"tcp://{spec.coordinator_address}",
        world_size=spec.num_processes,
        rank=spec.process_id,
    )
    return spec
