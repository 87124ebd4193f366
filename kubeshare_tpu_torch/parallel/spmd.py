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

A MESH OF RANKS (``mesh.RankMesh``: ``make_mesh`` over a gang, one GPU
a rank) runs the same program with one unit a rank: :class:`Units`
holds this rank's unit alone, with its global coordinates, and a
collective over a group that spans ranks runs over that group's
``torch.distributed`` subgroup (:class:`RankLine`), in the member order
of the functions above, through ``torch.autograd.Function``s whose
backward is the transpose stated below.  A rank at a nonzero
coordinate of a replica axis RECOMPUTES its unit, as GSPMD does (every
rank runs a body; none waits to receive one), but its loss is not
differentiated: the loss reads each distinct slice of the logits from
its owner (the first position holding it) and only owners backpropagate,
so no gradient is counted twice.  Each owner differentiates its own
share (its vocabulary piece's terms), while the loss's value is the
global mean, equal to the one-controller's to the bit: each rank sums
what it received in the one-controller's order.

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

Over ranks the same transposes are autograd Functions: a gather's
backward is a reduce-scatter (an ``all_to_all`` of the cotangents'
pieces, each member summing its piece in member order), a psum's
backward psums the cotangents, an all-to-all's backward is the mirrored
all-to-all and a ring shift's backward shifts the other way.  A
replicated read (``ShardedTensor.gather`` and ``index_select`` across
ranks, :func:`replicated_read`) is not such a gather: every rank
computes the same function of the whole tensor (a loss), so its
backward hands each owned shard its slice of this rank's own cotangent
and sums nothing.  A pipeline's hops are point to point
(:meth:`RankLine.send` and :meth:`RankLine.recv`), so a stage waits on
the neighbour that feeds it and on no other rank.

A SEQUENCE GROUP (the ring and Ulysses, ``ops/ring_attention.py``,
``ops/ulysses.py``) is written once over :class:`LocalGroup` (one
controller: every member, in member order, on its devices) or
:class:`RankGroup` (a mesh of ranks: this rank's member alone, at its
index on a :class:`RankLine`): both give the group's size, the indices
of the members held here, the shift and the all-to-all, so no group
size is ever read from the length of a member list.

TRAINING.  Every shard of a placed parameter is a leaf of its own;
after the backward a slice held by several shards has a partial
gradient in each unit that used it (a dp replica holds its rows' share).
:func:`sum_copies` sums them and gives every copy the sum — the psum that
GSPMD inserts for a replicated leaf — so an elementwise optimizer keeps
every copy of a slice equal to the bit (over ranks: the copies' ranks
exchange their gradients and each sums them in mesh order, so every
rank holds the same bits).  The training loss is counted
once: :func:`sharded_cross_entropy` reads each distinct slice of the
logits once, whatever replicates it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import (Mesh, P, PartitionSpec, RankMesh, ShardedTensor,
                   _axes_key, _map_with_paths, _shard_slices, _split_names,
                   batch_sharding, device_put, shard_tensor)


# ---------------------------------------------------------------------------
# the collectives: functions over lists of per-device tensors
# ---------------------------------------------------------------------------

def all_gather(xs: List[torch.Tensor], dim: int,
               devices) -> List[torch.Tensor]:
    """``lax.all_gather(..., tiled=True)``: every member receives the
    members' tensors concatenated along ``dim``, in member order."""
    return [torch.cat([x.to(d, non_blocking=True) for x in xs], dim=dim)
            for d in devices]


class _LocalGather(torch.autograd.Function):
    """:func:`all_gather` with the transpose written out: member ``i``'s
    cotangent is every copy's piece ``i`` summed in member order, the
    reduce-scatter that the gather across ranks makes (autograd would add
    the copies' contributions in its own order, which past two members
    rounds otherwise)."""

    @staticmethod
    def forward(ctx, dim: int, devices, *xs):
        ctx.dim = dim
        ctx.places = [(x.device, x.shape[dim]) for x in xs]
        return tuple(all_gather(list(xs), dim, devices))

    @staticmethod
    def backward(ctx, *grads):
        out, at = [], 0
        for device, size in ctx.places:
            out.append(_ordered_sum([g.narrow(ctx.dim, at, size).to(device)
                                     for g in grads]))
            at += size
        return (None, None, *out)


def psum(xs: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """``lax.psum``: the members' sum, added once in member order on the
    first member's device and copied to the others (a member on that
    device receives the sum itself)."""
    total = xs[0].to(devices[0], non_blocking=True)
    for x in xs[1:]:
        total = total + x.to(devices[0], non_blocking=True)
    return [total.to(d, non_blocking=True) for d in devices]


def ring_shift(xs: List[torch.Tensor], devices,
               offset: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` with the perm ``i -> i + offset``: member ``i``
    receives member ``i - offset``'s tensor (with ``offset`` 1, member 0
    the last member's), in the member order of :func:`all_gather` and
    :func:`psum`.  On one device it is a move between list entries."""
    n = len(xs)
    return [xs[(i - offset) % n].to(d, non_blocking=True)
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
# across ranks: the collectives over a RankMesh's subgroups
# ---------------------------------------------------------------------------

def _ordered_sum(xs: List[torch.Tensor]) -> torch.Tensor:
    """``xs[0] + xs[1] + ...``, in order (:func:`psum`'s arithmetic)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


class RankLine:
    """This rank's subgroup over ``axes`` of a :class:`RankMesh`: the
    ranks that differ from it only on them, in member order (mixed radix
    over ``axes`` as given, the first outermost, as :meth:`Units.groups`
    orders units), and the transport between them.

    A tensor travels as its raw bytes (a ``uint8`` view), so no backend
    needs its dtype, and every sum is made by each member itself, in
    member order, from what it received: the one-controller functions'
    arithmetic, so a psum equals :func:`psum` to the bit and every
    member holds the same bits.  Gloo's transport is host memory: a CUDA
    tensor is copied to the host, exchanged by gloo's CPU collectives
    (``all_gather_into_tensor``, ``all_to_all_single``) and copied
    back.  A gather receives (n - 1) x the tensor's bytes a member, a
    psum as many (a ring all-reduce would move 2 (n - 1) / n x, but in
    its own order), a reduce-scatter (n - 1) / n x, an all-to-all
    (n - 1) / n x, a shift 1 x (nothing where the offset is a multiple
    of n); through the host each also copies its input out and its
    output in."""

    def __init__(self, mesh: RankMesh, axes: Sequence[str]) -> None:
        import torch.distributed as dist

        self.axes = tuple(axes)
        key = _axes_key(mesh, self.axes)
        me = mesh.coords()
        fixed = [i for i, a in enumerate(mesh.axis_names) if a not in key]
        where = [mesh.axis_names.index(a) for a in self.axes]

        def at(coords) -> int:
            index = 0
            for i in where:
                index = index * mesh.devices.shape[i] + coords[i]
            return index

        members = sorted((p for p in range(mesh.devices.size)
                          if all(mesh.coords(p)[i] == me[i] for i in fixed)),
                         key=lambda p: at(mesh.coords(p)))
        self.size = len(members)
        self.index = members.index(mesh.position)
        self.group = mesh.group(key)
        # member m's global rank (where point-to-point hops go) and its
        # rank within the subgroup (where collectives put it)
        self.ranks = [int(mesh.devices.flat[p]) for p in members]
        self.order = [dist.get_group_rank(self.group, r) for r in self.ranks]
        self.via_host = dist.get_backend(self.group) == "gloo"
        self.pending: List[Tuple[object, torch.Tensor]] = []

    def _bytes(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
        return flat.cpu() if self.via_host else flat

    @staticmethod
    def _split(flat: torch.Tensor, likes: Sequence[torch.Tensor],
               device) -> List[torch.Tensor]:
        """``flat``'s bytes as tensors of ``likes``' shapes and dtypes, in
        order, on ``device``."""
        flat, at, out = flat.to(device), 0, []
        for like in likes:
            nbytes = like.numel() * like.element_size()
            out.append(flat[at:at + nbytes].view(like.dtype).view(like.shape))
            at += nbytes
        return out

    def send(self, xs: Sequence[torch.Tensor], member: int, tag: int) -> None:
        """Post ``xs`` (one message, tagged ``tag``) to member ``member``
        without waiting: point to point, so a hop needs no call from the
        members it does not concern.  :meth:`wait` completes the posted
        sends."""
        import torch.distributed as dist

        buf = torch.cat([self._bytes(x) for x in xs])
        self.pending.append((dist.isend(buf, self.ranks[member], tag=tag),
                             buf))

    def recv(self, likes: Sequence[torch.Tensor], member: int,
             tag: int) -> List[torch.Tensor]:
        """The message tagged ``tag`` from member ``member``, as tensors
        of ``likes``' shapes and dtypes on their device (waits for it:
        the tag picks it out of whatever else that member has posted)."""
        import torch.distributed as dist

        nbytes = sum(x.numel() * x.element_size() for x in likes)
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          device="cpu" if self.via_host else likes[0].device)
        dist.recv(buf, self.ranks[member], tag=tag)
        return self._split(buf, likes, likes[0].device)

    def wait(self) -> None:
        """Complete every send this member posted."""
        for work, _ in self.pending:
            work.wait()
        self.pending = []

    def sum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """:func:`psum` of each of ``xs`` across the members, data only:
        each sum added in member order, one gather per dtype."""
        if self.size == 1:
            return list(xs)
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault(x.dtype, []).append(i)
        for where in by_dtype.values():
            flat = torch.cat([xs[i].reshape(-1) for i in where])
            total, at = _ordered_sum(self.gather(flat)), 0
            for i in where:
                out[i] = total[at:at + xs[i].numel()].view_as(xs[i])
                at += xs[i].numel()
        return out

    def broadcast(self, xs: Sequence[torch.Tensor],
                  member: int) -> List[torch.Tensor]:
        """Member ``member``'s ``xs`` on every member, in one message (the
        others pass tensors of the same shapes and dtypes, whose values
        are not read)."""
        import torch.distributed as dist

        if self.size == 1:
            return list(xs)
        buf = torch.cat([self._bytes(x) for x in xs])
        dist.broadcast(buf, self.ranks[member], group=self.group)
        return self._split(buf, xs, xs[0].device)

    def gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``x`` (one shape and dtype on every member), in
        member order, on ``x``'s device."""
        import torch.distributed as dist

        if self.size == 1:
            return [x]
        send = self._bytes(x)
        out = torch.empty(self.size * send.numel(), dtype=torch.uint8,
                          device=send.device)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)  # the older name
        gather(out, send, group=self.group)
        out = out.to(x.device).view(x.dtype).view(self.size, *x.shape)
        return [out[r] for r in self.order]

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A reduce-scatter: member ``i`` receives every member's piece
        ``i`` of ``x`` along ``dim``, summed in member order."""
        import torch.distributed as dist

        n = self.size
        size = x.shape[dim] // n
        by_rank: List[Optional[torch.Tensor]] = [None] * n
        for m, r in enumerate(self.order):
            by_rank[r] = x.narrow(dim, m * size, size)
        send = torch.cat([self._bytes(piece) for piece in by_rank])
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        shape = by_rank[0].shape
        out = out.to(x.device).view(x.dtype).view(n, *shape)
        return _ordered_sum([out[r] for r in self.order])

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """:func:`all_to_all` across the members, data only: this member
        receives piece ``index`` of every member's ``split_dim``,
        concatenated along ``concat_dim`` in member order."""
        import torch.distributed as dist

        n = self.size
        if n == 1:
            return x
        size = x.shape[split_dim] // n
        by_rank: List[Optional[torch.Tensor]] = [None] * n
        for m, r in enumerate(self.order):
            by_rank[r] = x.narrow(split_dim, m * size, size)
        send = torch.cat([self._bytes(piece) for piece in by_rank])
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        shape = by_rank[0].shape
        out = out.to(x.device).view(x.dtype).view(n, *shape)
        return torch.cat([out[r] for r in self.order], dim=concat_dim)

    def shift(self, xs: Sequence[torch.Tensor],
              offset: int = 1) -> List[torch.Tensor]:
        """:func:`ring_shift` across the members, data only: this member
        receives member ``index - offset``'s tensors (one shape and dtype
        each on every member), all of them in one exchange."""
        import torch.distributed as dist

        n = self.size
        if offset % n == 0:
            return list(xs)
        send = torch.cat([self._bytes(x) for x in xs])
        to = self.order[(self.index + offset) % n]
        source = self.order[(self.index - offset) % n]
        sizes = [0] * n
        sizes[to] = send.numel()
        received = [0] * n
        received[source] = send.numel()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, received, sizes, group=self.group)
        out, at = out.to(xs[0].device), 0
        shifted = []
        for x in xs:
            nbytes = x.numel() * x.element_size()
            shifted.append(out[at:at + nbytes].view(x.dtype).view(x.shape))
            at += nbytes
        return shifted

    def exchange(self, pieces: Dict[int, List[torch.Tensor]],
                 expect: Dict[int, int], like: torch.Tensor
                 ) -> Dict[int, List[torch.Tensor]]:
        """Pieces of ``like``'s shape and dtype to and from the members:
        ``pieces[m]`` goes to member ``m``, and ``expect[m]`` pieces come
        back from member ``m`` (this member's own move locally)."""
        import torch.distributed as dist

        n = self.size
        nbytes = like.numel() * like.element_size()
        sizes, received = [0] * n, [0] * n
        by_rank: List[List[torch.Tensor]] = [[] for _ in range(n)]
        for m, sent in pieces.items():
            if m != self.index:
                by_rank[self.order[m]] = sent
                sizes[self.order[m]] = len(sent) * nbytes
        for m, count in expect.items():
            if m != self.index:
                received[self.order[m]] = count * nbytes
        flat = [self._bytes(p) for group in by_rank for p in group]
        send = (torch.cat(flat) if flat else
                self._bytes(like.new_empty((0,))))
        out = torch.empty(sum(received), dtype=torch.uint8,
                          device=send.device)
        dist.all_to_all_single(out, send, received, sizes, group=self.group)
        out = out.to(like.device)
        starts = np.cumsum([0] + received)
        got = {self.index: list(pieces.get(self.index, []))}
        for m, count in expect.items():
            if m == self.index:
                continue
            at = int(starts[self.order[m]])
            got[m] = [out[at + j * nbytes:at + (j + 1) * nbytes]
                      .view(like.dtype).view(like.shape)
                      for j in range(count)]
        return got


def mesh_line(mesh: RankMesh, axes: Sequence[str]) -> RankLine:
    """The mesh's :class:`RankLine` over ``axes`` (in that member
    order), made once."""
    key = tuple(axes)
    if key not in mesh.lines:
        mesh.lines[key] = RankLine(mesh, key)
    return mesh.lines[key]


class _RankGather(torch.autograd.Function):
    """:func:`all_gather` across ranks; backward: the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim: int, line: RankLine):
        ctx.dim, ctx.line = dim, line
        return torch.cat(line.gather(x), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.line.scatter_sum(grad, ctx.dim), None, None


class _RankPsum(torch.autograd.Function):
    """:func:`psum` across ranks; backward: the psum of the cotangents."""

    @staticmethod
    def forward(ctx, x, line: RankLine):
        ctx.line = line
        return _ordered_sum(line.gather(x))

    @staticmethod
    def backward(ctx, grad):
        return _ordered_sum(ctx.line.gather(grad)), None


class _RankAllToAll(torch.autograd.Function):
    """:func:`all_to_all` across ranks; backward: the mirrored
    all-to-all (``concat_dim`` split, ``split_dim`` concatenated)."""

    @staticmethod
    def forward(ctx, x, split_dim: int, concat_dim: int, line: RankLine):
        ctx.dims, ctx.line = (split_dim, concat_dim), line
        return line.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (ctx.line.all_to_all(grad, concat_dim, split_dim), None,
                None, None)


class _RankShift(torch.autograd.Function):
    """:func:`ring_shift` across ranks; backward: the shift the other way
    (the cotangent goes back to the member the tensor came from)."""

    @staticmethod
    def forward(ctx, x, offset: int, line: RankLine):
        ctx.offset, ctx.line = offset, line
        return line.shift([x], offset)[0]

    @staticmethod
    def backward(ctx, grad):
        return ctx.line.shift([grad], -ctx.offset)[0], None, None


class _RankRead(torch.autograd.Function):
    """A replicated read across ranks: every position's ``piece`` (one
    shape and dtype on every rank) gathered over the whole mesh, each
    distinct slice written from its owner (``owners``: (position,
    slices) pairs) into one tensor of ``shape`` on every rank.  Every
    rank then computes the same function of that tensor, so each holds
    the same cotangent: the backward hands this rank's piece its own
    slice of it where the rank owns one (``mine``), and nothing where
    its slice is a copy.  A reduce-scatter of the cotangents, the
    transpose for reads that differ by rank, would count each share once
    a rank."""

    @staticmethod
    def forward(ctx, piece, line: RankLine, shape, owners, mine):
        ctx.mine = mine
        pieces = line.gather(piece)
        out = torch.empty(shape, dtype=piece.dtype, device=piece.device)
        for i, slices in owners:
            out[slices] = pieces[i]
        return out

    @staticmethod
    def backward(ctx, grad):
        mine = None if ctx.mine is None else grad[ctx.mine]
        return mine, None, None, None, None


def replicated_read(piece: torch.Tensor, mesh: RankMesh, shape, owners,
                    mine) -> torch.Tensor:
    """:class:`_RankRead` over the whole mesh (``ShardedTensor.gather``
    and ``index_select`` across ranks)."""
    return _RankRead.apply(piece, mesh_line(mesh, mesh.axis_names),
                           tuple(shape), owners, mine)


class LocalGroup:
    """A group whose members this process holds all of (one controller):
    member ``i`` on ``devices[i]``, the shift and the all-to-all moves
    between list entries."""

    def __init__(self, devices) -> None:
        self.devices = list(devices)
        self.size = len(self.devices)
        self.indices = list(range(self.size))

    def shift(self, lists: Sequence[List[torch.Tensor]],
              offset: int = 1) -> List[List[torch.Tensor]]:
        """Each list of ``lists`` shifted (:func:`ring_shift`)."""
        return [ring_shift(xs, self.devices, offset) for xs in lists]

    def all_to_all(self, xs: List[torch.Tensor], split_dim: int,
                   concat_dim: int) -> List[torch.Tensor]:
        return all_to_all(xs, split_dim, concat_dim, self.devices)

    def exchange_chunks(self, xs: List[torch.Tensor], dim: int, count: int,
                        source) -> List[torch.Tensor]:
        """Member ``j`` receives its ``count`` chunks (of ``xs``' split
        of ``dim`` into ``count`` a member), chunk ``c`` being chunk
        ``source(j, c) = (member, slot)``'s, concatenated in order."""
        size = xs[0].shape[dim] // count
        return [torch.cat([xs[m].narrow(dim, slot * size, size).to(
            d, non_blocking=True) for m, slot in (source(j, c)
                                                  for c in range(count))],
            dim=dim) for j, d in enumerate(self.devices)]


class RankGroup:
    """This rank's member alone of a group that spans ranks (its
    :class:`RankLine`): the lists hold one tensor, the member's, and its
    index and the group's size come from the line."""

    def __init__(self, line: RankLine, device) -> None:
        self.line = line
        self.devices = [device]
        self.size = line.size
        self.indices = [line.index]

    def shift(self, lists: Sequence[List[torch.Tensor]],
              offset: int = 1) -> List[List[torch.Tensor]]:
        """Each list of ``lists`` shifted, all in one exchange (data only:
        the ring's schedules run inside their own autograd Function)."""
        moved = self.line.shift([xs[0] for xs in lists], offset)
        return [[x] for x in moved]

    def all_to_all(self, xs: List[torch.Tensor], split_dim: int,
                   concat_dim: int) -> List[torch.Tensor]:
        return [_RankAllToAll.apply(xs[0], split_dim, concat_dim,
                                    self.line)]

    def exchange_chunks(self, xs: List[torch.Tensor], dim: int, count: int,
                        source) -> List[torch.Tensor]:
        """:meth:`LocalGroup.exchange_chunks` across ranks, differentiable
        (the backward sends each chunk's cotangent back to its source)."""
        return [_RankChunks.apply(xs[0], dim, count, source, self.line)]


def _chunk_moves(line: RankLine, count: int, source):
    """What this member sends and receives in a chunk exchange: ({member:
    [my slots it receives, in its chunk order]}, {member: [(my chunk,
    its slot) that it sends me, in my chunk order]})."""
    sends: Dict[int, List[int]] = {}
    for j in range(line.size):
        for c in range(count):
            m, slot = source(j, c)
            if m == line.index:
                sends.setdefault(j, []).append(slot)
    receives: Dict[int, List[Tuple[int, int]]] = {}
    for c in range(count):
        m, slot = source(line.index, c)
        receives.setdefault(m, []).append((c, slot))
    return sends, receives


class _RankChunks(torch.autograd.Function):
    """A chunk exchange across ranks (:meth:`RankGroup.exchange_chunks`);
    backward: every chunk's cotangent back to the slot it came from."""

    @staticmethod
    def forward(ctx, x, dim: int, count: int, source, line: RankLine):
        ctx.args = (dim, count, source, line)
        size = x.shape[dim] // count
        chunk = x.narrow(dim, 0, size)
        sends, receives = _chunk_moves(line, count, source)
        got = line.exchange(
            {m: [x.narrow(dim, s * size, size) for s in slots]
             for m, slots in sends.items()},
            {m: len(pairs) for m, pairs in receives.items()}, chunk)
        out: List[Optional[torch.Tensor]] = [None] * count
        for m, pairs in receives.items():
            for (c, _), piece in zip(pairs, got[m]):
                out[c] = piece
        return torch.cat(out, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        dim, count, source, line = ctx.args
        size = grad.shape[dim] // count
        chunk = grad.narrow(dim, 0, size)
        sends, receives = _chunk_moves(line, count, source)
        # the transpose: each received chunk's cotangent goes back
        back = line.exchange(
            {m: [grad.narrow(dim, c * size, size) for c, _ in pairs]
             for m, pairs in receives.items()},
            {m: len(slots) for m, slots in sends.items()}, chunk)
        out: List[Optional[torch.Tensor]] = [None] * count
        for m, slots in sends.items():
            for s, piece in zip(slots, back[m]):
                out[s] = piece
        return torch.cat(out, dim=dim), None, None, None, None


def _mine_in_order(mine: torch.Tensor, line: Optional[RankLine]
                   ) -> torch.Tensor:
    """The sum over the line's members of one tensor each, in member
    order: this member's ``mine`` (differentiable) in its place, the
    others' received values (constants).  Its value is the same bits on
    every member; its gradient reaches ``mine`` alone."""
    if line is None:
        return mine
    parts = line.gather(mine.detach())
    parts[line.index] = mine
    return _ordered_sum(parts)


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
            "models.transformer_apply_with_aux, "
            "models.transformer_apply_ring, "
            "models.transformer_apply_ulysses, models.mnist_apply, "
            "models.resnet_apply and ops.moe_apply")


def same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (type(a) is type(b)
                      and a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat,
                                                     b.devices.flat)))


class Units:
    """The work units of ``mesh`` over ``axes`` (the named ones; the
    others are replica axes): unit ``u`` has coordinates
    ``coords[u]`` on ``self.axes`` (mesh order), runs on
    ``devices[u]``, and reads the local shard ``rep[u]`` (on one
    controller, mesh device ``rep[u]``'s).  Over a :class:`RankMesh`
    the one unit is this rank's own: its coordinates are global, its
    device the rank's, and its collectives cross ranks."""

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
        self.ranked = isinstance(mesh, RankMesh)
        # a rank at a nonzero coordinate of a replica axis recomputes its
        # unit and differentiates nothing (one controller: no such unit)
        self.replica = False
        if self.ranked:
            me = mesh.coords()
            self.coords = [tuple(me[p] for p in position)]
            self.unit_of, self.rep = [0], [0]
            self.devices = mesh.local_devices
            self.replica = any(me[i] for i, a in enumerate(mesh.axis_names)
                               if a not in self.axes)
            return
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
        return self.index_of(self.coords[u], axes)

    def index_of(self, coords: Sequence[int], axes: Sequence[str]) -> int:
        """:meth:`coord` of a unit's coordinates on :attr:`axes`."""
        at = 0
        for a in axes:
            at = at * self.sizes[a] + coords[self.axes.index(a)]
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

    def _across(self, op, xs, axes) -> List[torch.Tensor]:
        """``op(x, line)`` for the rank's unit over its line on ``axes``."""
        line = mesh_line(self.mesh, tuple(axes)) if axes else None
        if line is None or line.size == 1:
            return list(xs)
        return [op(x, line) for x in xs]

    def all_gather(self, xs, dim: int, axes) -> List[torch.Tensor]:
        """:func:`all_gather` within every group over ``axes``."""
        if self.ranked:
            return self._across(
                lambda x, line: _RankGather.apply(x, dim, line), xs, axes)
        return self._collective(
            lambda members, d, devices: list(_LocalGather.apply(
                d, devices, *members)), xs, tuple(axes), dim)

    def psum(self, xs, axes) -> List[torch.Tensor]:
        """:func:`psum` within every group over ``axes``."""
        if self.ranked:
            return self._across(_RankPsum.apply, xs, axes)
        return self._collective(psum, xs, tuple(axes))

    def all_to_all(self, xs, split_dim: int, concat_dim: int,
                   axes) -> List[torch.Tensor]:
        """:func:`all_to_all` within every group over ``axes``."""
        if self.ranked:
            return self._across(lambda x, line: _RankAllToAll.apply(
                x, split_dim, concat_dim, line), xs, axes)
        return self._collective(all_to_all, xs, tuple(axes), split_dim,
                                concat_dim)

    def ring_shift(self, xs, axes, offset: int = 1) -> List[torch.Tensor]:
        """:func:`ring_shift` within every group over ``axes``."""
        if self.ranked:
            return self._across(lambda x, line: _RankShift.apply(
                x, offset, line), xs, axes)
        return self._collective(
            lambda members, devices: ring_shift(members, devices, offset),
            xs, tuple(axes))

    def sequence_groups(self, axes) -> List[Tuple[List[int], object]]:
        """Every group of units over ``axes``, as (its units here, in
        member order; the group object a ring or Ulysses runs over):
        one controller, each group as a :class:`LocalGroup`; over ranks,
        this rank's unit in a :class:`RankGroup` of its line."""
        if self.ranked:
            return [([0], RankGroup(mesh_line(self.mesh, tuple(axes)),
                                    self.devices[0]))]
        return [(group, LocalGroup([self.devices[u] for u in group]))
                for group in self.groups(tuple(axes))]

    @property
    def lead(self) -> bool:
        """Whether this process holds the lead unit (all coordinates 0),
        where one-time terms (the routed batch's aux) are differentiated:
        always on one controller; over ranks, on the rank at coordinate 0
        of every axis."""
        return not self.ranked or (not self.replica
                                   and not any(self.coords[0]))

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
                  for u, d in zip(self.unit_of, self.mesh.local_devices)]
        return ShardedTensor(shards, spec, self.mesh, shape)


def data_parallel_apply(fn, params, batch, mesh: Mesh) -> ShardedTensor:
    """``fn(params, batch) -> [rows, ...]``, a one-device function whose
    rows depend only on their own batch rows, as the sharded program over
    ``mesh``: each work unit runs ``fn`` on its rows of the batch (split
    by ``batch_sharding`` unless already placed) with every parameter
    whole (replicated, or gathered at use where a rule splits it), and
    the outputs come back as one :class:`ShardedTensor` split along the
    batch.  The data-parallel program that GSPMD makes of a
    per-sample model (convolutions, group norm) under a dp mesh.  Over a
    :class:`RankMesh` each rank runs its own unit's rows and the result
    holds this rank's shard; a training step sums the copies' gradients
    across the ranks (:func:`sum_copies`), and nothing else crosses them:
    a per-sample model reads no other row."""
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
    used keeps no gradient.  Over a :class:`RankMesh`
    (:func:`_sum_copies_across`) every rank calls it."""
    leaves = list(leaves)
    if leaves and isinstance(leaves[0].mesh, RankMesh):
        _sum_copies_across(leaves)
        return
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


def _sum_copies_across(leaves: List[ShardedTensor]) -> None:
    """:func:`sum_copies` over a :class:`RankMesh`.  The copies of this
    rank's slice of a leaf are the ranks that differ from it only on the
    axes the leaf's spec does not name (its :class:`RankLine` over them,
    in mesh order).  The leaves that share such a line and a dtype travel
    in one gather (a missing gradient as zeros, beside one gather of
    presence flags), and every rank sums the present gradients in mesh
    order, as the one-controller sum does, so every copy ends with the
    same bits."""
    buckets: Dict[Tuple, Tuple[RankLine, List[torch.Tensor]]] = {}
    for leaf in leaves:
        named = {n for axes in leaf.spec for n in _split_names(axes)}
        free = tuple(a for a in leaf.mesh.axis_names if a not in named)
        if not free:
            continue
        line = mesh_line(leaf.mesh, free)
        if line.size == 1:
            continue  # one copy: its gradient is the sum
        shard = leaf.shards[0]
        buckets.setdefault((free, shard.dtype), (line, []))[1].append(shard)
    for line, shards in buckets.values():
        flat = torch.cat([(s.grad if s.grad is not None
                           else torch.zeros_like(s)).reshape(-1)
                          for s in shards])
        grads = line.gather(flat)
        present = line.gather(torch.tensor([s.grad is not None
                                            for s in shards],
                                           dtype=torch.uint8))
        offset = 0
        for j, shard in enumerate(shards):
            n = shard.numel()
            total = None
            for flags, grad in zip(present, grads):
                if flags[j]:
                    part = grad[offset:offset + n].view_as(shard)
                    total = (part.clone() if total is None
                             else total.add_(part))
            shard.grad = total
            offset += n


def sharded_cross_entropy(logits: ShardedTensor, targets) -> torch.Tensor:
    """Mean token cross entropy of sharded logits [..., vocab] against
    integer targets [...] (a :class:`ShardedTensor` or a tensor), one f32
    scalar on the logits' lead device.

    Each distinct block of rows is read once; where the vocabulary is
    split, the block's pieces combine into global log-softmax statistics
    (the max over the pieces, their summed exponentials, the target's
    logit from the piece that holds it) — Megatron's vocab-parallel cross
    entropy, without gathering the logits.  Over a :class:`RankMesh`:
    :func:`_rank_cross_entropy`."""
    if isinstance(logits.mesh, RankMesh):
        return _rank_cross_entropy(logits, targets)
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


def _rank_cross_entropy(logits: ShardedTensor, targets) -> torch.Tensor:
    """:func:`sharded_cross_entropy` over a :class:`RankMesh`, a
    collective every rank calls.  The value is the global mean on every
    rank, equal to the one-controller's to the bit: the vocabulary
    pieces' statistics cross the ranks that split the vocabulary (in
    mesh order, the one-controller's order of the pieces), each block's
    sum crosses the mesh, and each rank adds them in the one-controller's
    order.  The gradient is this rank's share: only its own piece's
    terms are differentiable, and only where the rank owns its slice
    (the first position that holds it); at a replica's position the
    result is a constant, so its backward is skipped and no gradient is
    counted twice."""
    mesh = logits.mesh
    if isinstance(targets, ShardedTensor):
        targets = targets.gather()
    mine = _shard_slices(logits.shape, logits.spec, mesh)[mesh.position]
    owned = any(i == mesh.position for i, _ in logits._owners)
    piece = logits.shards[0] if owned else logits.shards[0].detach()
    ndim = len(logits.shape)
    vocab_axes = _split_names(logits.spec[ndim - 1]
                              if len(logits.spec) >= ndim else None)
    line = (mesh_line(mesh, _axes_key(mesh, vocab_axes))
            if vocab_axes else None)
    if line is not None and line.size == 1:
        line = None
    target = targets[mine[:-1]].to(piece.device).long()
    maxima = piece.detach().float().amax(dim=-1)
    peak = (torch.stack(line.gather(maxima)).amax(dim=0) if line is not None
            else maxima)
    piece = piece.float()
    vocab = mine[-1]
    sumexp = _mine_in_order(torch.exp(piece - peak[..., None]).sum(dim=-1),
                            line)
    inside = (target >= vocab.start) & (target < vocab.stop)
    index = (target - vocab.start).clamp(0, piece.shape[-1] - 1)
    value = torch.where(
        inside, torch.gather(piece, -1, index[..., None])[..., 0],
        torch.zeros((), dtype=piece.dtype, device=piece.device))
    picked = _mine_in_order(value, line)
    nll = (peak + torch.log(sumexp) - picked).sum()
    # the blocks of rows in the one-controller's order, each read from its
    # first owner; this rank's own block from its own (differentiable) sum
    nlls = mesh_line(mesh, mesh.axis_names).gather(nll.detach())
    rows = tuple((x.start, x.stop) for x in mine[:-1])
    blocks: Dict[Tuple, int] = {}
    for i, slices in logits._owners:
        blocks.setdefault(tuple((x.start, x.stop) for x in slices[:-1]), i)
    total = None
    for key, first in blocks.items():
        term = nll if owned and key == rows else nlls[first]
        total = term if total is None else total + term
    return total / targets.numel()
