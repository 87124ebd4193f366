"""The sharded program: one controller runs the work units of a mesh.

The JAX package places parameters and batches with named shardings and
lets XLA's SPMD partitioner (GSPMD) write the per-device program and its
collectives.  This module is the port's counterpart of that partitioner,
written out by hand for the mesh-aware entry points
(``models.transformer.transformer_apply(_with_aux)``,
``ops.moe.moe_apply``, and through :func:`data_parallel_apply`
``models.mnist.mnist_apply`` and ``models.resnet.resnet_apply``) and the
training step (``parallel.train``).

ONE CONTROLLER, as in ``serving/sharded.py``: one process drives every
shard of a mesh, the collectives are plain functions over lists of
per-device tensors, and a mesh may name one device several times
(``[cuda:0] * 4`` runs four bodies in turn on the card's one stream).
No ``torch.distributed``.

WORK UNITS.  :class:`Units` holds one body per distinct coordinate on
the axes that some spec names (a parameter's or the batch's).  An axis
that nothing names is a pure replica axis — in a ``dp=2 x tp=2 x sp=2``
mesh under the transformer rules that is ``sp`` — and its devices compute
nothing: each unit runs on the device at coordinate 0 of those axes (its
*representative*), and a result placed over the whole mesh
(:meth:`Units.assemble`) hands the replica devices the unit's tensor.

COLLECTIVES, over the members of a group (units equal on every axis but
the group's):

- :func:`all_gather` concatenates, in member order (the first named axis
  outermost, as a spec's tuple splits);
- :func:`psum` sums once, in member order, and copies the sum to every
  member;
- :func:`all_to_all` swaps a split axis for another (Ulysses, serving);
- :func:`ring_shift` hands each member its predecessor's tensor (the
  ring attention's K/V rotation, ``ops/ring_attention.py``).

They are plain tensor operations, so autograd differentiates them: the
transpose of a gather sums each member's slice of the cotangents (a
reduce-scatter: what an fsdp weight's gradient receives), and the
transpose of a psum hands every input the sum of the members'
cotangents, because every member's copy of the sum feeds its own work.

TRAINING.  Every shard of a placed parameter is a leaf of its own;
after the backward a slice held by several shards has a partial
gradient in each unit that used it (a dp replica holds its rows' share).
:func:`sum_copies` sums them and gives every copy the sum — the psum that
GSPMD inserts for a replicated leaf — so an elementwise optimizer keeps
every copy of a slice equal to the bit.  The training loss is counted
once: :func:`sharded_cross_entropy` reads each distinct slice of the
logits once, whatever replicates it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import (Mesh, P, PartitionSpec, ShardedTensor, _map_with_paths,
                   _split_names, batch_sharding, device_put, shard_tensor)


# ---------------------------------------------------------------------------
# the collectives: functions over lists of per-device tensors
# ---------------------------------------------------------------------------

def all_gather(xs: List[torch.Tensor], dim: int,
               devices) -> List[torch.Tensor]:
    """``lax.all_gather(..., tiled=True)``: every member receives the
    members' tensors concatenated along ``dim``, in member order."""
    return [torch.cat([x.to(d, non_blocking=True) for x in xs], dim=dim)
            for d in devices]


def psum(xs: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """``lax.psum``: the members' sum, added once in member order on the
    first member's device and copied to the others (a member on that
    device receives the sum itself)."""
    total = xs[0].to(devices[0], non_blocking=True)
    for x in xs[1:]:
        total = total + x.to(devices[0], non_blocking=True)
    return [total.to(d, non_blocking=True) for d in devices]


def ring_shift(xs: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """``lax.ppermute`` with the perm ``i -> i + 1``: member ``i``
    receives member ``i - 1``'s tensor (member 0 the last member's), in
    the member order of :func:`all_gather` and :func:`psum`.  On one
    device it is a move between list entries."""
    n = len(xs)
    return [xs[(i - 1) % n].to(d, non_blocking=True)
            for i, d in enumerate(devices)]


def all_to_all(xs: List[torch.Tensor], split_dim: int, concat_dim: int,
               devices) -> List[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: member ``i`` receives piece
    ``i`` of every member's ``split_dim``, concatenated along
    ``concat_dim`` in member order."""
    n = len(xs)
    out = []
    for i, d in enumerate(devices):
        pieces = []
        for x in xs:
            size = x.shape[split_dim] // n
            pieces.append(x.narrow(split_dim, i * size, size).to(
                d, non_blocking=True))
        out.append(torch.cat(pieces, dim=concat_dim))
    return out


# ---------------------------------------------------------------------------
# the work units of a mesh
# ---------------------------------------------------------------------------

def mesh_of(*trees) -> Optional[Mesh]:
    """The mesh of the first :class:`ShardedTensor` among the trees'
    leaves; None when no leaf is placed (a one-device call)."""
    found = []
    for tree in trees:
        _map_with_paths(tree, lambda _, leaf: found.append(leaf))
    return next((leaf.mesh for leaf in found
                 if isinstance(leaf, ShardedTensor)), None)


def place_plain(tree, mesh: Mesh):
    """The tree with every leaf that is not placed replicated over
    ``mesh`` (a plain tensor beside placed ones, as JAX replicates an
    unsharded array in a sharded computation)."""
    return _map_with_paths(tree, lambda _, leaf: (
        leaf if isinstance(leaf, ShardedTensor)
        else shard_tensor(leaf, P(), mesh)))


def refuse_sharded(name: str, *trees) -> None:
    """Raise ``TypeError`` when a leaf of ``trees`` is a
    :class:`ShardedTensor`: ``name`` runs on one device, and a mesh runs
    only the mesh-aware entry points (no fallback gathers the tree)."""
    if mesh_of(*trees) is not None:
        raise TypeError(
            f"{name} runs on one device and got a sharded tree; the "
            "mesh-aware entry points are models.transformer_apply, "
            "models.transformer_apply_with_aux, models.mnist_apply, "
            "models.resnet_apply and ops.moe_apply")


def same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat,
                                                     b.devices.flat)))


class Units:
    """The work units of ``mesh`` over ``axes`` (the named ones; the
    others are replica axes): unit ``u`` has coordinates
    ``coords[u]`` on ``self.axes`` (mesh order), runs on
    ``devices[u]``, and reads the shards of mesh device ``rep[u]``."""

    def __init__(self, mesh: Mesh, axes: Iterable[str]) -> None:
        axes = set(axes)
        unknown = axes - set(mesh.axis_names)
        if unknown:
            raise ValueError(f"mesh {mesh.axis_names} has no axis "
                             f"{sorted(unknown)}")
        self.mesh = mesh
        self.axes = tuple(a for a in mesh.axis_names if a in axes)
        self.sizes = {a: mesh.shape[a] for a in self.axes}
        position = [mesh.axis_names.index(a) for a in self.axes]
        self.coords: List[Tuple[int, ...]] = list(
            np.ndindex(*[self.sizes[a] for a in self.axes]))
        unit = {c: u for u, c in enumerate(self.coords)}
        # every mesh device's unit, in the mesh's flat order
        self.unit_of = [unit[tuple(index[p] for p in position)]
                        for index in np.ndindex(*mesh.devices.shape)]
        self.rep = [self.unit_of.index(u) for u in range(len(self.coords))]
        self.devices = [mesh.devices.flat[i] for i in self.rep]

    @classmethod
    def of(cls, mesh: Mesh, specs: Iterable[PartitionSpec]) -> "Units":
        """The units of ``mesh`` over the axes ``specs`` name."""
        return cls(mesh, {name for spec in specs for axes in spec
                          for name in _split_names(axes)})

    def __len__(self) -> int:
        return len(self.coords)

    def coord(self, u: int, axes: Sequence[str]) -> int:
        """Unit ``u``'s index over ``axes`` (mixed radix, the first axis
        outermost, as a spec's tuple splits); 0 for no axes."""
        at = 0
        for a in axes:
            at = at * self.sizes[a] + self.coords[u][self.axes.index(a)]
        return at

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The units equal on every axis but ``axes``, a list a group,
        each in member order (:meth:`coord` over ``axes``)."""
        groups: Dict[Tuple, List[int]] = {}
        for u, c in enumerate(self.coords):
            key = tuple(x for a, x in zip(self.axes, c) if a not in axes)
            groups.setdefault(key, []).append(u)
        return [sorted(g, key=lambda u: self.coord(u, axes))
                for g in groups.values()]

    def _collective(self, fn, xs, axes, *args) -> List[torch.Tensor]:
        out = list(xs)
        if not axes:
            return out
        for group in self.groups(axes):
            results = fn([xs[u] for u in group], *args,
                         [self.devices[u] for u in group])
            for u, y in zip(group, results):
                out[u] = y
        return out

    def all_gather(self, xs, dim: int, axes) -> List[torch.Tensor]:
        """:func:`all_gather` within every group over ``axes``."""
        return self._collective(all_gather, xs, tuple(axes), dim)

    def psum(self, xs, axes) -> List[torch.Tensor]:
        """:func:`psum` within every group over ``axes``."""
        return self._collective(psum, xs, tuple(axes))

    def local(self, x: ShardedTensor,
              keep: Optional[Dict[int, Tuple[str, ...]]] = None
              ) -> List[torch.Tensor]:
        """Each unit's view of ``x``: its representative's shard, with
        every split that ``keep`` ({dim: axis names}) does not name
        all-gathered — an fsdp weight gathered at use, whose gradient
        the gather's transpose reduce-scatters."""
        if not same_mesh(x.mesh, self.mesh):
            raise ValueError("a ShardedTensor placed over another mesh")
        keep = keep or {}
        xs = [x.shards[i] for i in self.rep]
        for dim, axes in enumerate(x.spec):
            names = _split_names(axes)
            if names and keep.get(dim) != names:
                xs = self.all_gather(xs, dim, names)
        return xs

    def assemble(self, xs: List[torch.Tensor], spec: PartitionSpec,
                 shape: Sequence[int]) -> ShardedTensor:
        """The units' tensors as one :class:`ShardedTensor` over the whole
        mesh under ``spec`` (which names unit axes only): a replica
        device holds its unit's tensor (a copy where its device
        differs)."""
        shards = [xs[u].to(d, non_blocking=True)
                  for u, d in zip(self.unit_of, self.mesh.devices.flat)]
        return ShardedTensor(shards, spec, self.mesh, shape)


def data_parallel_apply(fn, params, batch, mesh: Mesh) -> ShardedTensor:
    """``fn(params, batch) -> [rows, ...]``, a one-device function whose
    rows depend only on their own batch rows, as the sharded program over
    ``mesh``: each work unit runs ``fn`` on its rows of the batch (split
    by ``batch_sharding`` unless already placed) with every parameter
    whole (replicated, or gathered at use where a rule splits it), and
    the outputs come back as one :class:`ShardedTensor` split along the
    batch.  The data-parallel program that GSPMD makes of a
    per-sample model (convolutions, group norm) under a dp mesh."""
    if not isinstance(batch, ShardedTensor):
        batch = device_put(batch, batch_sharding(mesh, batch.ndim))
    params = place_plain(params, mesh)
    specs: List[PartitionSpec] = []
    _map_with_paths(params, lambda _, leaf: specs.append(leaf.spec))
    units = Units.of(mesh, [batch.spec] + specs)
    rows = _split_names(batch.spec[0] if batch.spec else None)
    xs = units.local(batch, {0: rows} if rows else None)
    local: Dict[str, List[torch.Tensor]] = {}
    _map_with_paths(params, lambda path, leaf: local.setdefault(
        path, units.local(leaf)))
    outs = [fn(_map_with_paths(params, lambda path, _: local[path][u]), x)
            for u, x in enumerate(xs)]
    return units.assemble(outs, P(batch.spec[0] if batch.spec else None),
                          (batch.shape[0],) + tuple(outs[0].shape[1:]))


def split_axis(batch: Tuple[str, ...], *uses) -> Optional[str]:
    """The one axis over which every ``(tensor, dim)`` of ``uses`` is split
    (and nothing else), when there is one and it is not a batch axis: a
    layer whose weights agree on it computes that split in parallel and
    psums; otherwise it gathers them and computes whole."""
    found = {tuple(_split_names(t.spec[dim] if dim < len(t.spec) else None))
             for t, dim in uses}
    if len(found) != 1:
        return None
    names = found.pop()
    if len(names) != 1 or names[0] in batch:
        return None
    return names[0]


# ---------------------------------------------------------------------------
# training: gradients of copies, the loss counted once
# ---------------------------------------------------------------------------

@torch.no_grad()
def sum_copies(leaves: Iterable[ShardedTensor]) -> None:
    """For every slice of every leaf: the sum of its shards' gradients
    (in mesh order, on the first holder's device), given to each shard
    that holds the slice, every shard its own tensor.  A slice no unit
    used keeps no gradient."""
    for leaf in leaves:
        for group in leaf.copies:
            shards = [leaf.shards[i] for i in group]
            grads = [s.grad for s in shards if s.grad is not None]
            if not grads:
                continue
            total = grads[0]
            if len(grads) > 1:
                total = total.to(shards[0].device, copy=True)
                for g in grads[1:]:
                    total += g.to(total.device, non_blocking=True)
            owner = next((s for s in shards if s.grad is total), shards[0])
            for s in shards:
                s.grad = total if s is owner else total.to(s.device,
                                                           copy=True)


def sharded_cross_entropy(logits: ShardedTensor, targets) -> torch.Tensor:
    """Mean token cross entropy of sharded logits [..., vocab] against
    integer targets [...] (a :class:`ShardedTensor` or a tensor), one f32
    scalar on the logits' lead device.

    Each distinct block of rows is read once; where the vocabulary is
    split, the block's pieces combine into global log-softmax statistics
    (the max over the pieces, their summed exponentials, the target's
    logit from the piece that holds it) — Megatron's vocab-parallel cross
    entropy, without gathering the logits."""
    if isinstance(targets, ShardedTensor):
        targets = targets.gather()
    lead = logits.device
    blocks: Dict[Tuple, List] = {}
    for i, slices in logits._owners:
        blocks.setdefault(slices[:-1], []).append(
            (slices[-1], logits.shards[i]))
    total = None
    for rows, pieces in blocks.items():
        target = targets[rows].to(lead, non_blocking=True).long()
        peak = torch.stack([p.detach().float().amax(dim=-1).to(lead)
                            for _, p in pieces]).amax(dim=0)
        sumexp, picked = None, None
        for vocab, piece in pieces:
            piece = piece.float()
            at = peak.to(piece.device)
            t = target.to(piece.device)
            part = torch.exp(piece - at[..., None]).sum(dim=-1).to(lead)
            sumexp = part if sumexp is None else sumexp + part
            inside = (t >= vocab.start) & (t < vocab.stop)
            index = (t - vocab.start).clamp(0, piece.shape[-1] - 1)
            value = torch.where(
                inside, torch.gather(piece, -1, index[..., None])[..., 0],
                torch.zeros((), dtype=piece.dtype, device=piece.device))
            value = value.to(lead)
            picked = value if picked is None else picked + value
        nll = (peak + torch.log(sumexp) - picked).sum()
        total = nll if total is None else total + nll
    return total / targets.numel()
