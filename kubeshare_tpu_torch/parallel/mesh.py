"""Device meshes and sharding helpers, port of kubeshare_tpu/parallel/mesh.py
(:class:`MeshSpec`, :func:`make_mesh`, :func:`serving_mesh`,
:func:`replicated`, :func:`batch_sharding`, :func:`shard_params`,
:func:`param_spec_tree`).

Axis vocabulary, as in the JAX package:
  dp  data parallel (batch split; the replica axis of a serving fleet)
  fsdp parameter sharding along dp (zero-style), by the rules only
  ep  expert parallel (batch split alongside dp; experts split over it)
  tp  tensor parallel (head/feature split inside layers)
  sp  sequence parallel

The JAX package hands a ``jax.sharding.Mesh`` to XLA, which compiles
the collectives into one program.  Here one controller drives every
device of a group itself: a :class:`Mesh` is a numpy array of
``torch.device``s on named axes, and one device may appear more than
once (a group that names ``cuda:0`` twice runs both shards on one card,
in turn, on its one stream — the port's counterpart of JAX's forced
host-platform device count).  :func:`shard_params` returns, for every
leaf, a :class:`ShardedTensor`: its per-device shards and its
:class:`PartitionSpec`; :func:`device_put` places one tensor (a batch
under :func:`batch_sharding`) the same way.  The sharded program that
runs on such trees (the mesh-aware forwards, the training step) is
built in :mod:`.spmd`.

Across processes (``torch.distributed`` initialised with world size > 1,
one GPU a rank) :func:`make_mesh` with no ``devices`` returns a
:class:`RankMesh`: the gang's ranks on the axes, in rank order, as JAX's
``make_mesh`` over a multi-process ``jax.devices()`` orders devices by
process.  Each rank owns one position and its own device, and a
:class:`ShardedTensor` over it holds that position's shard only; the
sharded program runs each rank's unit and crosses ranks through the
subgroups the mesh creates (``spmd``'s rank collectives).

ep subdivides the batch dimension alongside dp (batch shards over
(dp, ep); experts replicated over dp, sharded over ep): the GShard
layout.  A mesh with ep == 1 keeps the three-axis ("dp", "tp", "sp")
shape; ep > 1 inserts the "ep" axis between dp and tp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True, kw_only=True)
class MeshSpec:
    """Logical mesh shape; -1 on one axis absorbs remaining devices.

    Keyword-only: the ep axis sits between dp and tp, so positional
    construction would silently reinterpret older (dp, tp, sp) calls.
    """

    dp: int = -1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        """Resolve to concrete (dp, ep, tp, sp); every degenerate spec
        fails loudly here:

        - an axis must be -1 (fill) or >= 1;
        - at most ONE axis may be -1;
        - the resolved product must equal ``n_devices`` exactly — an
          over-subscribed spec and an under-subscribed one both raise.
        """
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        axes = (self.dp, self.ep, self.tp, self.sp)
        names = ("dp", "ep", "tp", "sp")
        for name, d in zip(names, axes):
            if d != -1 and d < 1:
                raise ValueError(
                    f"mesh axis {name}={d} is degenerate — every axis "
                    f"must be -1 (absorb remaining devices) or >= 1")
        fills = sum(1 for d in axes if d == -1)
        if fills > 1:
            raise ValueError(
                f"mesh {self} has {fills} fill (-1) axes — the fill is "
                f"ambiguous; at most one axis may be -1")
        known = [d for d in axes if d != -1]
        prod = int(np.prod(known)) if known else 1
        if fills:
            if n_devices % prod != 0:
                raise ValueError(
                    f"mesh {self}: fixed axes need a multiple of {prod} "
                    f"devices, but {n_devices} are available")
            fill = n_devices // prod
        else:
            fill = None
            if prod != n_devices:
                raise ValueError(
                    f"mesh {self} spans {prod} devices != available "
                    f"{n_devices}")
        return tuple((fill if d == -1 else d) for d in axes)


class PartitionSpec(tuple):
    """How a tensor splits over mesh axes, JAX's ``PartitionSpec``: one
    entry a dimension — an axis name, a tuple of names, or None (not
    split); dimensions past the last entry are not split.  ``P()``
    replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """Devices on named axes: ``devices`` a numpy object array of
    ``torch.device`` whose shape is the axes' sizes.  A device may
    appear more than once."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a {devices.ndim}-d device array needs as many axis "
                f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local(self) -> Tuple[int, ...]:
        """The flat positions whose shards this process holds: every one
        (one controller drives the whole mesh)."""
        return tuple(range(self.devices.size))

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of :attr:`local`, in its order."""
        return list(self.devices.flat)


def _axes_key(mesh: Mesh, axes) -> Tuple[str, ...]:
    """``axes`` (one name or several) as a tuple in mesh order."""
    names = {axes} if isinstance(axes, str) else set(axes)
    unknown = names - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"mesh {mesh.axis_names} has no axis "
                         f"{sorted(unknown)}")
    return tuple(a for a in mesh.axis_names if a in names)


class RankMesh(Mesh):
    """The ranks of a process group on named axes: ``devices`` is an int
    array of global ranks (``make_mesh``'s gang mesh in rank order;
    ``slice_device_mesh``'s grouped by slice), so ``devices[i, j]`` is
    the rank at that position.  This process is rank ``rank`` at flat
    position ``position``, on its own ``device`` (None where the mesh
    only groups ranks, as ``slice_device_mesh``'s does); a tensor placed
    over the mesh holds that position's shard only.

    ``group(axes)`` is this rank's ``torch.distributed`` subgroup over
    one axis or several: the ranks that differ from it only on those
    axes.  Every rank created every subgroup of every combination of
    axes, in one order (``distributed._axis_groups``), because
    ``new_group`` must be called alike on every rank; none is created
    later, when only some ranks would call it."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 groups: Dict[Tuple[str, ...], object],
                 device=None) -> None:
        import torch.distributed as dist

        super().__init__(ranks, axis_names)
        self.rank = dist.get_rank()
        self.position = int(np.flatnonzero(ranks.reshape(-1)
                                           == self.rank)[0])
        self.device = None if device is None else _as_device(device)
        self._groups = groups
        self.lines: Dict[Tuple[str, ...], object] = {}  # spmd.mesh_line's

    @property
    def local(self) -> Tuple[int, ...]:
        return (self.position,)

    @property
    def local_devices(self) -> List[torch.device]:
        if self.device is None:
            raise ValueError(
                "this rank mesh names no device for its rank (it groups "
                "ranks only); build it with make_mesh(spec, device=...)")
        return [self.device]

    def coords(self, position: Optional[int] = None) -> Tuple[int, ...]:
        """The coordinates of ``position`` (default: this rank's)."""
        at = self.position if position is None else position
        return tuple(int(i) for i in np.unravel_index(at, self.devices.shape))

    def group(self, axes):
        return self._groups[_axes_key(self, axes)]


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""

    mesh: Mesh
    spec: PartitionSpec


def _as_device(device) -> torch.device:
    """A torch.device with its index: a bare ``"cuda"`` names the
    current CUDA device, so shards placed there compare equal to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _device_array(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    array = np.empty(len(devices), dtype=object)
    array[:] = [_as_device(d) for d in devices]
    return array.reshape(shape)


def _visible_cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none (a mesh
    never falls back to the CPU — pass the devices explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass the mesh's devices "
            "explicitly (e.g. [torch.device('cpu')] * n)")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _mesh_axes(spec: MeshSpec, n: int):
    """(shape, axis names) of ``spec`` over ``n`` devices or ranks."""
    dp, ep, tp, sp = spec.resolve(n)
    if ep > 1:
        return (dp, ep, tp, sp), ("dp", "ep", "tp", "sp")
    return (dp, tp, sp), ("dp", "tp", "sp")


def _world_size() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def make_mesh(spec: MeshSpec = MeshSpec(),
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The mesh of ``spec`` over ``devices`` (None: every visible CUDA
    device), shaped (dp, tp, sp), or (dp, ep, tp, sp) when ep > 1.

    With ``torch.distributed`` initialised at world size > 1 and no
    ``devices``: the :class:`RankMesh` of the gang's ranks in rank order
    (``distributed.rank_mesh``), this rank on ``device`` (None: its
    current CUDA device).  ``device`` with ``devices`` given, or on one
    process, raises ``ValueError``."""
    if devices is None and _world_size() > 1:
        from .distributed import rank_mesh

        return rank_mesh(spec, device)
    if device is not None:
        raise ValueError(
            "device names a rank's own device in a mesh of ranks; a "
            "one-process mesh takes devices=[...]")
    devices = list(devices if devices is not None
                   else _visible_cuda_devices())
    shape, names = _mesh_axes(spec, len(devices))
    return Mesh(_device_array(devices, shape), names)


def serving_mesh(tp: int, dp: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """The serving engine's mesh preset: ``tp``-way tensor parallelism
    (heads/features split inside each dispatch), optional ``dp`` replica
    groups for a fleet front-end.  Uses the leading ``dp * tp`` devices
    so a host with more devices than the serving pod needs still builds
    the exact requested shape instead of failing the strict
    :meth:`MeshSpec.resolve` product check."""
    if tp < 1 or dp < 1:
        raise ValueError(
            f"serving_mesh needs tp >= 1 and dp >= 1, got tp={tp} dp={dp}")
    need = dp * tp
    avail = list(devices if devices is not None
                 else _visible_cuda_devices())
    if len(avail) < need:
        raise ValueError(
            f"serving_mesh(tp={tp}, dp={dp}) needs {need} devices, "
            f"only {len(avail)} available")
    return make_mesh(MeshSpec(dp=dp, tp=tp, sp=1), devices=avail[:need])


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, ndim: int = 2,
                   seq_axis: Optional[int] = None) -> NamedSharding:
    """Shard axis 0 over dp (and ep, when the mesh has one); optionally a
    sequence axis over sp."""
    spec: list = [None] * ndim
    spec[0] = ("dp", "ep") if mesh.shape.get("ep", 1) > 1 else "dp"
    if seq_axis is not None and mesh.shape.get("sp", 1) > 1:
        spec[seq_axis] = "sp"
    return NamedSharding(mesh, P(*spec))


def _split_names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def _shard_slices(shape: Sequence[int], spec: PartitionSpec,
                  mesh: Mesh) -> List[Tuple[slice, ...]]:
    """For every device of ``mesh`` (flat order), the slice of a tensor of
    ``shape`` that it holds under ``spec``."""
    position = {name: i for i, name in enumerate(mesh.axis_names)}
    sizes = mesh.devices.shape
    out = []
    for index in np.ndindex(*sizes):
        slices = []
        for dim, size in enumerate(shape):
            names = _split_names(spec[dim] if dim < len(spec) else None)
            degree, at = 1, 0
            for name in names:  # mixed radix, the first name outermost
                degree *= sizes[position[name]]
                at = at * sizes[position[name]] + index[position[name]]
            piece = size // degree
            slices.append(slice(at * piece, (at + 1) * piece))
        out.append(tuple(slices))
    return out


class ShardedTensor:
    """One tensor laid out over a :class:`Mesh`: ``shards[k]`` is what
    the mesh's local position ``mesh.local[k]`` holds under ``spec`` —
    on one controller every position (``shards[i]`` is device ``i``'s,
    the mesh's flat order), over a :class:`RankMesh` this rank's alone —
    the port's counterpart of a sharded ``jax.Array``.  Shards live on
    their own devices and are updated in place where the tensor is
    state (the serving pool).  Reads that cross shards gather them
    (:meth:`gather`, :meth:`index_select`) — data movement only."""

    def __init__(self, shards: List[torch.Tensor], spec: PartitionSpec,
                 mesh: Mesh, shape: Sequence[int]) -> None:
        self.shards = list(shards)
        self.spec = PartitionSpec(*spec)
        self.mesh = mesh
        self.shape = torch.Size(shape)
        slices = _shard_slices(self.shape, self.spec, mesh)
        # the shards holding each distinct slice, the first of them its
        # owner: a read writes each element once even where the spec
        # replicates
        held: Dict[Tuple, List[int]] = {}
        for i, s in enumerate(slices):
            held.setdefault(tuple((x.start, x.stop) for x in s), []).append(i)
        self.copies = sorted(held.values())
        self._owners = [(group[0], slices[group[0]]) for group in self.copies]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The lead device (the mesh's first), where gathers land."""
        return self.shards[0].device

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @property
    def grad(self) -> Optional["ShardedTensor"]:
        """The shards' gradients laid out as the tensor (after
        ``spmd.sum_copies``, every copy holds its slice's whole
        gradient); None before any backward reached a shard."""
        if all(s.grad is None for s in self.shards):
            return None
        return ShardedTensor([s.grad if s.grad is not None
                              else torch.zeros_like(s) for s in self.shards],
                             self.spec, self.mesh, self.shape)

    @property
    def is_fully_replicated(self) -> bool:
        return len(self._owners) == 1

    def gather(self) -> torch.Tensor:
        """The whole tensor on the lead device.  Over a :class:`RankMesh`
        it is a collective that every rank of the mesh calls, and a
        replicated read: each rank receives the whole tensor on its own
        device, and differentiating the same function of it on every
        rank hands each owned shard its slice of the cotangent once
        (``spmd.replicated_read``)."""
        if isinstance(self.mesh, RankMesh):
            return self._read_across(self.shards[0], self.shape,
                                     self._owners)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for i, slices in self._owners:
            out[slices] = self.shards[i].to(self.device, non_blocking=True)
        return out

    def _read_across(self, piece: torch.Tensor, shape, owners
                     ) -> torch.Tensor:
        from .spmd import replicated_read

        mine = next((slices for i, slices in owners
                     if i == self.mesh.position), None)
        return replicated_read(piece, self.mesh, shape, owners, mine)

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        """``torch.index_select`` of the whole tensor along an unsplit
        ``dim``, each shard selecting its own rows, gathered on the lead
        device (over a :class:`RankMesh`: each rank selects from its own
        shard, then the rows cross the mesh as :meth:`gather`'s do)."""
        if any(s[dim] != slice(0, self.shape[dim]) for _, s in self._owners):
            raise ValueError(
                f"index_select along dim {dim}, which {self.spec} splits")
        shape = list(self.shape)
        shape[dim] = index.numel()
        owners = [(i, slices[:dim] + (slice(None),) + slices[dim + 1:])
                  for i, slices in self._owners]
        if isinstance(self.mesh, RankMesh):
            shard = self.shards[0]
            return self._read_across(
                shard.index_select(dim, index.to(shard.device)), shape,
                owners)
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for i, slices in owners:
            shard = self.shards[i]
            rows = shard.index_select(dim, index.to(shard.device))
            out[slices] = rows.to(self.device, non_blocking=True)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, spec={self.spec!r}, "
                f"shards={len(self.shards)})")


def _check_divides(name: str, shape: Sequence[int], spec: PartitionSpec,
                   mesh: Mesh) -> None:
    """Every split axis of ``shape`` divides its mesh degree (JAX's
    message, naming the tensor and the axis)."""
    for dim, axes in enumerate(spec):
        names = _split_names(axes)
        if not names:
            continue
        degree = 1
        for axis in names:
            degree *= mesh.shape[axis]
        if shape[dim] % degree != 0:
            raise ValueError(
                f"cannot shard {name}: axis {dim} (size "
                f"{shape[dim]}) does not divide mesh "
                f"{'x'.join(names)}={degree}")


def shard_tensor(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh,
                 copy: bool = False,
                 non_blocking: bool = False) -> ShardedTensor:
    """Split ``x`` over ``mesh`` under ``spec``: each device receives its
    slice, contiguous, on its own device (over a :class:`RankMesh`, this
    rank's slice only: every rank passes the same whole ``x``).  ``copy`` gives every shard its
    own storage (state updated in place); otherwise a replicated shard
    already on its device is ``x`` itself.  ``non_blocking`` copies from
    pinned host memory asynchronously, on each device's current stream."""
    _check_divides(f"a tensor of shape {tuple(x.shape)}", x.shape, spec,
                   mesh)
    slices = _shard_slices(x.shape, spec, mesh)
    shards = []
    for device, at in zip(mesh.local_devices, mesh.local):
        piece = x[slices[at]]
        if copy or piece.device != device or not piece.is_contiguous():
            piece = torch.empty(piece.shape, dtype=x.dtype,
                                device=device).copy_(
                                    piece, non_blocking=non_blocking)
        shards.append(piece)
    return ShardedTensor(shards, spec, mesh, x.shape)


def device_put(x: torch.Tensor, sharding: NamedSharding,
               non_blocking: bool = False) -> ShardedTensor:
    """``jax.device_put(x, sharding)``: ``x`` split over the sharding's
    mesh under its spec, e.g. a batch under :func:`batch_sharding`."""
    return shard_tensor(x, sharding.spec, sharding.mesh,
                        non_blocking=non_blocking)


def _keystr(path: Tuple) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` writes it, e.g.
    ``['layers'][0]['attn']['wq']`` — the string the rules match."""
    return "".join(f"[{key!r}]" for key in path)


def _map_with_paths(tree, fn, path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(_keystr(path), tree)


def _spec_for(path: str, ordered) -> PartitionSpec:
    for needle, spec in ordered:
        if needle in path:
            return spec
    return P()


def shard_params(params, rules: Dict[str, PartitionSpec], mesh: Mesh,
                 copy: bool = False):
    """Place a param tree by path-matching rules; unmatched -> replicated
    onto every device of the mesh.

    Rules map a substring of the flattened path (e.g. "attn']['wq") to a
    PartitionSpec.  First match wins, most-specific (longest) first.
    Returns the tree with a :class:`ShardedTensor` at every leaf;
    ``copy`` gives every shard its own storage (:func:`shard_tensor`),
    as trained state needs."""
    ordered = sorted(rules.items(), key=lambda kv: -len(kv[0]))

    def place(path: str, x):
        spec = _spec_for(path, ordered)
        # name the parameter and axis up front (JAX's message)
        _check_divides(path, x.shape, spec, mesh)
        return shard_tensor(x, spec, mesh, copy=copy)

    return _map_with_paths(params, place)


def param_spec_tree(params, rules: Dict[str, PartitionSpec]):
    """Like :func:`shard_params` but returns the PartitionSpec tree."""
    ordered = sorted(rules.items(), key=lambda kv: -len(kv[0]))
    return _map_with_paths(params, lambda path, _: _spec_for(path, ordered))
