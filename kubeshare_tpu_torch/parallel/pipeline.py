"""Pipeline parallelism over a ``pp`` mesh axis, port of
kubeshare_tpu/parallel/pipeline.py: GPipe (:func:`pipeline_apply`) and
the 1F1B training schedule (:func:`pipeline_train_1f1b`).

Layer stacks split into stages: every leaf of ``stage_params`` has a
leading axis of size pp, stage ``s`` runs on slice ``s``.  Microbatches
stream through the stages; activations hop from a stage to the next.

ONE CONTROLLER, as in ``parallel/spmd.py``: the JAX functions run a
``shard_map`` body per device and hop with ``ppermute``; here one
process runs the schedule's ticks, stage after stage, and a hop hands a
stage's output to the next stage's devices.  Bubble slots (a stage with
no microbatch at a tick) compute nothing; JAX computes them and throws
the result away.

``activation_spec`` splits the activations over the mesh's other axes
(e.g. ``P(None, "sp", None)``: each stage runs on sequence shards, so
its body can run ring or Ulysses attention over ``sp``).  A stage's
members are the coordinates of the axes the spec names, and the stage
body sees all of them at once:

    stage_fn(stage_params, xs) -> ys

where ``xs`` is the list of the members' pieces of a microbatch in
member order (the first named axis outermost; one piece when nothing is
split) — the one-controller form of JAX's ``stage_fn(params, x)``, whose
collectives over sp need every member.  A stage's members share one
device (the stage's parameters live there).

A MESH OF RANKS (``mesh.RankMesh``, e.g. ``distributed.rank_mesh_over(
("pp", "sp"), (2, 2))``) runs the same schedules with one member a rank:
a rank runs its pp coordinate's stage on its own piece (``xs`` holds one
tensor), a hop is point to point between neighbouring stages' ranks
(``spmd.RankLine.send`` / ``recv``, tagged by microbatch and direction),
the members of a stage sum their gradients over their line after each
microbatch's backward, in member order, and a result is broadcast from
the stage that holds it (the output, the loss, ``dx``, the loss
parameters' gradients), so every rank returns what the one controller
returns, to the bit, with the stage gradients as this rank's stage's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, P, PartitionSpec, RankMesh, ShardedTensor, _split_names
from .train import tree_leaves, tree_map

StageFn = Callable[[Any, List[torch.Tensor]], List[torch.Tensor]]


def _validate_activation_spec(activation_spec, pp_axis: str) -> tuple:
    """Validate an activation PartitionSpec for the pipelined entry points
    and return the tuple of mesh-axis names it shards over."""
    if activation_spec is None:
        return ()
    named = tuple(
        name
        for entry in activation_spec
        if entry is not None
        for name in ((entry,) if isinstance(entry, str) else entry)
    )
    if pp_axis in named:
        raise ValueError(
            f"activation_spec {activation_spec} must not shard over the "
            f"pipeline axis {pp_axis!r} (activations are replicated over "
            "pp and hop via ppermute)"
        )
    if len(activation_spec) > 0 and activation_spec[0] is not None:
        raise ValueError(
            f"activation_spec {activation_spec} must not shard dim 0 — "
            "the microbatch split happens inside the stages on the "
            "global batch"
        )
    return named


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack a list of per-stage param trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _check_pipeline(stage_params, x: torch.Tensor, num_microbatches: int,
                    n_stages: int, pp_axis: str) -> None:
    if x.shape[0] % num_microbatches != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible into {num_microbatches} "
            "microbatches")
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage_params leading axis {leaf.shape[0]} != pipeline "
                f"stages {n_stages} (mesh axis {pp_axis!r})")


FORWARD, BACKWARD = 0, 1


class _Stages:
    """Where a pipeline's pieces live on one controller: stage ``s``'s
    members (one per coordinate of the axes the activation spec names, in
    mesh order, the first outermost) and their device, how a tensor splits
    into the members' pieces under a spec and joins back, and the hops
    (a mailbox: a stage's output handed to the next stage's device).
    Every stage and every member is held here."""

    ranked = False

    def __init__(self, mesh: Mesh, pp_axis: str, axes: Sequence[str]):
        self.mesh, self.pp_axis = mesh, pp_axis
        self.axes = tuple(a for a in mesh.axis_names if a in axes)
        self.n_stages = mesh.shape[pp_axis]
        self.all_coords = list(np.ndindex(*[mesh.shape[a]
                                            for a in self.axes]))
        self.coords = self.all_coords  # the members held here
        self.members = len(self.all_coords)
        self.held = list(range(self.n_stages))
        self.box: Dict[Tuple[int, int, int], List[torch.Tensor]] = {}
        self.devices = []
        for s in range(self.n_stages):
            devices = []
            for coord in self.coords:
                at = dict(zip(self.axes, coord), **{pp_axis: s})
                devices.append(mesh.devices[tuple(
                    at.get(name, 0) for name in mesh.axis_names)])
            if len(set(devices)) > 1:
                raise ValueError(
                    f"stage {s}'s members sit on {sorted(map(str, devices))}:"
                    " the one-controller pipeline runs a stage's members on "
                    "one device (name it for each, e.g. [cuda:0] * n)")
            self.devices.append(devices[0])

    def slices(self, shape, spec, coords=None) -> List[Tuple[slice, ...]]:
        """Each member's slice of a tensor of ``shape`` under ``spec``
        (the members held here, or those of ``coords``)."""
        out = []
        for coord in self.coords if coords is None else coords:
            at = dict(zip(self.axes, coord))
            slices = []
            for dim, size in enumerate(shape):
                names = _split_names(spec[dim] if spec is not None
                                     and dim < len(spec) else None)
                degree, index = 1, 0
                for name in names:
                    degree *= self.mesh.shape[name]
                    index = index * self.mesh.shape[name] + at[name]
                if size % degree:
                    raise ValueError(
                        f"axis {dim} (size {size}) does not divide mesh "
                        f"{'x'.join(names)}={degree}")
                piece = size // degree
                slices.append(slice(index * piece, (index + 1) * piece))
            out.append(tuple(slices))
        return out

    def split(self, x: torch.Tensor, spec, stage: int) -> List[torch.Tensor]:
        device = self.devices[stage]
        return [x[s].to(device) for s in self.slices(x.shape, spec)]

    def join(self, pieces: List[torch.Tensor], spec, shape) -> torch.Tensor:
        """Every member's piece as one tensor on the last stage's device
        (``pieces``: the held members')."""
        out = torch.empty(shape, dtype=pieces[0].dtype,
                          device=self.devices[-1])
        for piece, slices in zip(self.every_member(pieces),
                                 self.slices(shape, spec, self.all_coords)):
            out[slices] = piece.to(out.device)
        return out

    def micro(self, x: torch.Tensor, spec, num_microbatches: int,
              stage: int) -> List[List[torch.Tensor]]:
        """Microbatch ``m``'s member pieces, for each ``m``."""
        mb = x.shape[0] // num_microbatches
        return [self.split(x[m * mb:(m + 1) * mb], spec, stage)
                for m in range(num_microbatches)]

    def join_micro(self, outs: List[List[torch.Tensor]], spec,
                   shape) -> torch.Tensor:
        mb = shape[0] // len(outs)
        return torch.cat([self.join(pieces, spec, (mb, *shape[1:]))
                          for pieces in outs])

    def local(self, leaf, stage: int) -> torch.Tensor:
        """Stage ``stage``'s slice of a stacked leaf, on its device."""
        return leaf[stage].to(self.devices[stage])

    # the hops and the sums over a stage's members: one controller holds
    # every stage and member, so they move tensors between list entries

    def post(self, xs: List[torch.Tensor], stage: int, m: int,
             direction: int) -> None:
        """Hand stage ``stage`` microbatch ``m``'s tensors (the next
        stage's inputs, or the previous stage's output cotangents)."""
        self.box[(stage, m, direction)] = [
            x.detach().to(self.devices[stage], non_blocking=True) for x in xs]

    def take(self, stage: int, m: int, direction: int,
             likes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """What :meth:`post` handed stage ``stage`` for microbatch ``m``
        (``likes``: their shapes and dtypes)."""
        return self.box.pop((stage, m, direction))

    def finish(self) -> None:
        """Complete the hops posted so far."""

    def member_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """A stage's gradients of one microbatch summed over its members
        (one controller: the members share the stage's leaves, so
        autograd has summed them)."""
        return xs

    def every_member(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """One tensor a member, every member's, in member order."""
        return xs

    def share(self, xs: List[torch.Tensor], stage: int) -> List[torch.Tensor]:
        """Stage ``stage``'s ``xs`` wherever the pipeline's result is read
        (one controller: where they are)."""
        return xs


class _RankStages(_Stages):
    """:class:`_Stages` over a :class:`RankMesh`, one member a rank: this
    rank runs stage ``stage`` (its pp coordinate) as member ``coords[0]``
    (its coordinates on the activation spec's axes); a rank at another
    coordinate of an axis that neither names runs the same pipeline as
    its counterpart at 0.  A hop is point to point over the rank's pp
    line (``spmd.RankLine.send`` and ``recv``, tagged by microbatch and
    direction, so a stage waits on the one neighbour that feeds it and on
    nothing else, whatever order its peers run in); a stage's members sum
    their gradients over its member line, in member order; a result
    crosses the pp line from the stage that holds it
    (``RankLine.broadcast``)."""

    ranked = True

    def __init__(self, mesh: RankMesh, pp_axis: str, axes: Sequence[str]):
        from .spmd import mesh_line

        self.mesh, self.pp_axis = mesh, pp_axis
        self.axes = tuple(a for a in mesh.axis_names if a in axes)
        self.n_stages = mesh.shape[pp_axis]
        self.all_coords = list(np.ndindex(*[mesh.shape[a]
                                            for a in self.axes]))
        self.members = len(self.all_coords)
        me = dict(zip(mesh.axis_names, mesh.coords()))
        self.stage = me[pp_axis]
        self.coords = [tuple(me[a] for a in self.axes)]
        self.held = [self.stage]
        self.devices = [mesh.local_devices[0]] * self.n_stages
        self.line = mesh_line(mesh, (pp_axis,))
        self.member_line = mesh_line(mesh, self.axes) if self.axes else None

    def local(self, leaf, stage: int) -> torch.Tensor:
        """This rank's stage's slice: a leaf placed ``P(pp)`` holds it
        alone; a whole stacked leaf (every rank passes the same) is
        sliced."""
        if isinstance(leaf, ShardedTensor):
            return leaf.shards[0][0]
        return super().local(leaf, stage)

    def post(self, xs, stage, m, direction) -> None:
        self.line.send(xs, stage, 2 * m + direction)

    def take(self, stage, m, direction, likes) -> List[torch.Tensor]:
        source = stage + (1 if direction == BACKWARD else -1)
        return self.line.recv(likes, source, 2 * m + direction)

    def finish(self) -> None:
        self.line.wait()

    def member_sum(self, xs):
        if self.member_line is None:
            return xs
        return self.member_line.sum(xs)

    def every_member(self, xs):
        if self.member_line is None:
            return xs
        return self.member_line.gather(xs[0])

    def share(self, xs, stage):
        return self.line.broadcast(xs, stage)


def _stages(mesh: Mesh, pp_axis: str, axes: Sequence[str]) -> _Stages:
    if isinstance(mesh, RankMesh):
        return _RankStages(mesh, pp_axis, axes)
    return _Stages(mesh, pp_axis, axes)


def _pieces_like(stages: _Stages, x: torch.Tensor, spec,
                 num_microbatches: int) -> List[torch.Tensor]:
    """Empty tensors of the shapes of a microbatch's member pieces held
    here (what a hop into a stage carries), of ``x``'s dtype."""
    shape = (x.shape[0] // num_microbatches, *x.shape[1:])
    return [torch.empty(tuple(s.stop - s.start for s in slices),
                        dtype=x.dtype, device=stages.devices[0])
            for slices in stages.slices(shape, spec)]


def _check_hop(stages: _Stages, ys: List[torch.Tensor],
               likes: List[torch.Tensor]) -> None:
    """Across ranks a hop's receiver knows only the stage input's shape
    and dtype: a stage's output must keep them (JAX's carry does)."""
    if stages.ranked and any(y.shape != x.shape or y.dtype != x.dtype
                             for y, x in zip(ys, likes)):
        raise ValueError(
            f"a stage's output {[(tuple(y.shape), y.dtype) for y in ys]} "
            f"must keep its input's shape and dtype "
            f"{[(tuple(x.shape), x.dtype) for x in likes]} to hop across "
            "ranks")


def _grads_of(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each leaf's gradient (zeros where nothing reached it), cleared
    from the leaf: the gradients of one microbatch."""
    out = []
    for leaf in leaves:
        out.append(leaf.grad if leaf.grad is not None
                   else torch.zeros_like(leaf))
        leaf.grad = None
    return out


def _accumulate(acc: Optional[List[torch.Tensor]],
                grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """A stage's gradients summed over its microbatches, in the order
    they run (what accumulating into the leaves adds)."""
    return grads if acc is None else [a + g for a, g in zip(acc, grads)]


class _GPipeRun:
    """One call of :func:`pipeline_apply`: its forward schedule, the
    graphs it keeps, and the backward that runs the schedule in reverse."""

    def __init__(self, stages: _Stages, stage_params, stage_fn: StageFn,
                 spec, num_microbatches: int) -> None:
        self.stages, self.stage_fn, self.spec = stages, stage_fn, spec
        self.m_count = num_microbatches
        self.params = stage_params
        self.graphs: Dict[Tuple[int, int], Tuple[List, List]] = {}

    def backward_order(self, stage: int) -> Sequence[int]:
        """The order in which ``stage`` runs its microbatches' backward."""
        return range(self.m_count)

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        stages, m_count = self.stages, self.m_count
        last = stages.n_stages - 1
        self.x_shape, self.x_device = x.shape, x.device
        self.likes = _pieces_like(stages, x, self.spec, m_count)
        self.local = {s: tree_map(lambda p, s=s: stages.local(p, s).detach()
                                  .requires_grad_(grad), self.params)
                      for s in stages.held}
        micro = (stages.micro(x, self.spec, m_count, 0)
                 if 0 in stages.held else None)
        outs: List[Optional[List[torch.Tensor]]] = [None] * m_count
        for t in range(m_count + last):
            for s in stages.held:
                m = t - s
                if not 0 <= m < m_count:
                    continue
                xs = (micro[m] if s == 0 else
                      stages.take(s, m, FORWARD, self.likes))
                xs = [p.detach().requires_grad_(grad) for p in xs]
                with torch.set_grad_enabled(grad):
                    ys = self.stage_fn(self.local[s], xs)
                if grad:
                    self.graphs[(s, m)] = (xs, ys)
                if s == last:
                    outs[m] = [y.detach() for y in ys]
                else:
                    _check_hop(stages, ys, self.likes)
                    stages.post(ys, s + 1, m, FORWARD)
        stages.finish()
        out = (stages.join_micro(outs, self.spec, x.shape)
               if last in stages.held else
               torch.empty(x.shape, dtype=x.dtype, device=stages.devices[0]))
        return stages.share([out], last)[0]

    def backward(self, grad: torch.Tensor, want_dx: bool, want: List[bool]):
        """(dx, each stacked leaf's gradient) from the output's cotangent:
        the last stage reads its own (every rank holds the same, so it is
        counted once), each stage runs its microbatches' backward and
        hands the input cotangents back a stage."""
        stages, m_count = self.stages, self.m_count
        last = stages.n_stages - 1
        cots = (stages.micro(grad, self.spec, m_count, last)
                if last in stages.held else None)
        dx_parts: List[Optional[List[torch.Tensor]]] = [None] * m_count
        acc: Dict[int, Optional[List[torch.Tensor]]] = {}
        for s in reversed(stages.held):
            leaves = tree_leaves(self.local[s])
            acc[s] = None
            for m in self.backward_order(s):
                xs, ys = self.graphs.pop((s, m))
                cot = (cots[m] if s == last else
                       stages.take(s, m, BACKWARD, ys))
                torch.autograd.backward(ys, cot)
                din = [x.grad if x.grad is not None else torch.zeros_like(x)
                       for x in xs]
                if s > 0:
                    stages.post(din, s - 1, m, BACKWARD)
                else:
                    dx_parts[m] = din
                acc[s] = _accumulate(acc[s],
                                     stages.member_sum(_grads_of(leaves)))
        stages.finish()
        dx = None
        if want_dx:
            dx = (stages.join_micro(dx_parts, self.spec, self.x_shape)
                  if 0 in stages.held else
                  torch.empty(self.x_shape, dtype=self.likes[0].dtype,
                              device=stages.devices[0]))
            dx = stages.share([dx], 0)[0].to(self.x_device)
        grads = []
        for i, leaf in enumerate(tree_leaves(self.params)):
            if not want[i]:
                grads.append(None)
            elif isinstance(leaf, ShardedTensor):
                grads.append(acc[stages.stage][i][None])
            else:
                # a stacked leaf: this process's stages' slices (over
                # ranks, the other stages' slices are zero here: the
                # ranks that run them hold their gradients)
                full = torch.zeros_like(leaf)
                for s in stages.held:
                    full[s] = acc[s][i].to(full.device)
                grads.append(full)
        return dx, grads


class _GPipe(torch.autograd.Function):
    """:func:`pipeline_apply` as one node: the forward runs the schedule
    (each stage's graph kept), the backward runs it in reverse, every hop
    handed back a stage."""

    @staticmethod
    def forward(ctx, run: _GPipeRun, x, *leaves):
        ctx.run = run
        with torch.enable_grad():
            return run.forward(x.detach(), True)

    @staticmethod
    def backward(ctx, grad):
        dx, grads = ctx.run.backward(grad, ctx.needs_input_grad[1],
                                     list(ctx.needs_input_grad[2:]))
        del ctx.run
        return (None, dx, *grads)


def pipeline_apply(
    stage_params: Any,
    x: torch.Tensor,
    stage_fn: StageFn,
    mesh: Mesh,
    num_microbatches: int,
    pp_axis: str = "pp",
    activation_spec: Optional[PartitionSpec] = None,
) -> torch.Tensor:
    """Run x [batch, ...] through the pp stages with microbatch
    pipelining (GPipe): tick ``t`` runs stage ``s`` on microbatch ``t -
    s``.  Returns the last stage's output, x-shaped, on its device.

    Differentiable: the pipeline is one autograd node that keeps every
    microbatch's stage graphs until the backward (as under JAX's
    autodiff) and then runs the schedule in reverse, each stage's
    microbatches in order, the input cotangents handed back a stage.  A
    stage's gradient is its microbatches' summed in that order; the
    stage body's parameters are ``stage_params`` (a tensor it closes over
    receives its gradient as the stage's backward runs).

    ``activation_spec`` splits the activations over other mesh axes (it
    must not mention ``pp_axis``) — e.g. ``P(None, "sp", None)`` runs
    each stage on sequence shards (pp x sp composition).

    Over a :class:`RankMesh` each rank runs its own stage (its pp
    coordinate) as one member, and every rank passes the same ``x``.  A
    leaf of ``stage_params`` is either the whole stack (every rank passes
    the same; its gradient holds this rank's stage's slice, and zeros
    where other ranks' stages are) or placed ``P(pp)`` (its gradient is
    this rank's shard's).  The output is the whole output on every rank,
    as JAX's closing psum over pp replicates it; every rank must
    differentiate the same function of it (the backward reads the last
    stage's cotangent, once), and then ``x``'s gradient is the whole one
    on every rank.  A stage's output keeps its input's shape and dtype."""
    axes = _validate_activation_spec(activation_spec, pp_axis)
    n_stages = mesh.shape[pp_axis]
    _check_pipeline(stage_params, x, num_microbatches, n_stages, pp_axis)
    stages = _stages(mesh, pp_axis, axes)
    run = _GPipeRun(stages, stage_params, stage_fn, activation_spec,
                    num_microbatches)
    leaves = [leaf.shards[0] if isinstance(leaf, ShardedTensor) else leaf
              for leaf in tree_leaves(stage_params)]
    if torch.is_grad_enabled() and (x.requires_grad or any(
            leaf.requires_grad for leaf in leaves)):
        return _GPipe.apply(run, x, *leaves)
    return run.forward(x.detach(), False)


# ---------------------------------------------------------------------------
# 1F1B training schedule.
#
# pipeline_apply + autograd is GPipe: every microbatch's stage activations
# stay alive until the backward, O(num_microbatches) memory per stage.
# The 1F1B schedule runs each microbatch's backward as soon as its
# forward clears the last stage, so a stage keeps only the microbatches
# still in flight — at most 2*(stages-1)+1, whatever the microbatch
# count.
#
# Clock, as in JAX: one loop over ticks, each a forward sub-phase and a
# backward sub-phase:
#     forward  of microbatch  m_f = t - s                    at stage s
#     backward of microbatch  m_b = t - 2*(S-1) + s          at stage s
# The last stage seeds each microbatch's backward from its own same-tick
# forward; cotangents hop back a stage a tick.  Each stage keeps its
# in-flight microbatches' autograd graphs (its inputs and what the
# backward needs), and torch.autograd.backward runs a stage's backward
# for a microbatch when the cotangent arrives, which frees that graph.
# JAX stashes the stage inputs and recomputes the stage under jax.vjp
# (remat); the port keeps the graph instead of recomputing it.  Either
# way a stage holds at most ``slots = min(M, 2*S - 1)`` microbatches.
# ---------------------------------------------------------------------------


def pipeline_train_1f1b(
    stage_params: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    stage_fn: StageFn,
    loss_fn: Callable[..., torch.Tensor],
    mesh: Mesh,
    num_microbatches: int,
    pp_axis: str = "pp",
    activation_spec: Optional[PartitionSpec] = None,
    target_spec: Optional[PartitionSpec] = None,
    loss_params: Any = None,
    return_input_grads: bool = False,
):
    """One pipelined training step under the 1F1B schedule.

    Returns ``(loss, param_grads)`` where loss is the mean of
    ``loss_fn(stage_output, y_microbatch)`` over microbatches and
    ``param_grads`` matches ``stage_params`` (slice ``s`` holding stage
    ``s``'s gradients).  Gradient-equivalent to autograd through
    :func:`pipeline_apply` (same math, another schedule); activation
    memory is O(stages), not O(microbatches).

    ``activation_spec`` composes 1F1B with sequence parallelism as in
    :func:`pipeline_apply`: x and y flow split, the stage body runs its
    sp collectives over the members, every member's loss is a mean over
    its own tokens, the loss is the members' mean and the gradients are
    divided by the member count (the contract of data parallelism; it
    needs ``loss_fn`` to be a mean over the split axis, like
    cross-entropy over tokens).

    ``loss_params`` (optional) is a tree the last stage's loss consumes —
    ``loss_fn(loss_params, out, y)`` — e.g. a model head trained with the
    stages; its gradients are appended to the return.
    ``return_input_grads=True`` also returns ``d(loss)/d(x)``, so the
    caller can continue the backward into what produced ``x``.  Full
    return: ``(loss, param_grads[, loss_param_grads][, dx])``.

    JAX's ``check_vma`` flag has no counterpart: it switches off
    shard_map's varying-axes type check, on which JAX's gradient
    reduction over sp relies (so JAX refuses it with ``activation_spec``
    or ``loss_params``).  The port sums the members' gradients itself,
    after each microbatch's backward, as JAX's autodiff psums them inside
    each ``jax.vjp``.

    Over a :class:`RankMesh` each rank runs its own stage (its pp
    coordinate) as one member, every rank passes the same ``x`` and
    ``y``, and the hops are point to point (``_RankStages``).  The
    return, in the rank mesh's convention: ``loss`` on every rank; the
    stage gradients as a :class:`~.mesh.ShardedTensor` placed ``P(pp)``
    per leaf (``shards[0]`` this rank's stage's, ``.gather()`` the
    stack, a collective); the loss parameters' gradients and ``dx``
    whole, on every rank.  ``stage_params`` leaves may be the whole
    stacks or placed ``P(pp)``."""
    n_stages = mesh.shape[pp_axis]
    axes = _validate_activation_spec(activation_spec, pp_axis)
    _check_pipeline(stage_params, x, num_microbatches, n_stages, pp_axis)
    stages = _stages(mesh, pp_axis, axes)
    m_count, last = num_microbatches, n_stages - 1
    if target_spec is not None:
        y_spec = target_spec
    elif activation_spec is not None:
        y_spec = PartitionSpec(*tuple(activation_spec)[:y.ndim])
    else:
        y_spec = None
    members = stages.members
    # this step's leaves: one set a stage held here, one for the loss's
    # parameters where the last stage is
    local = {s: tree_map(lambda p, s=s: stages.local(p, s).detach()
                         .requires_grad_(), stage_params)
             for s in stages.held}
    lparams = (tree_map(lambda p: p.detach().to(stages.devices[last])
                        .requires_grad_(), loss_params)
               if loss_params is not None and last in stages.held else None)
    likes = _pieces_like(stages, x, activation_spec, m_count)
    with torch.no_grad():
        micro_x = (stages.micro(x.detach(), activation_spec, m_count, 0)
                   if 0 in stages.held else None)
        micro_y = (stages.micro(y, y_spec, m_count, last)
                   if last in stages.held else None)
    seed = 1.0 / m_count
    loss_sums: List[Optional[torch.Tensor]] = [None] * len(stages.coords)
    dx_parts: List[Optional[List[torch.Tensor]]] = [None] * m_count
    acc: Dict[int, Optional[List[torch.Tensor]]] = {s: None
                                                    for s in stages.held}
    in_flight: Dict[int, Dict[int, Tuple]] = {s: {} for s in stages.held}

    def backward(s, m, xs, outputs, cotangents):
        """Stage ``s``'s backward for microbatch ``m``: the input
        cotangents go back a stage (at stage 0 they are ``dx``), the
        stage's gradients (and at the last stage the loss parameters')
        are summed over its members and added to the stage's."""
        torch.autograd.backward(outputs, cotangents)
        grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in xs]
        if s > 0:
            stages.post(grads, s - 1, m, BACKWARD)
        elif return_input_grads:
            dx_parts[m] = grads
        leaves = tree_leaves(local[s])
        if s == last and lparams is not None:
            leaves = leaves + tree_leaves(lparams)
        acc[s] = _accumulate(acc[s], stages.member_sum(_grads_of(leaves)))

    def forward(s, m, xs):
        """Stage ``s``'s forward for microbatch ``m``: its outputs go on
        to the next stage; at the last stage its loss, and its backward
        seeded at once (1/M a microbatch).  The graph lives in
        ``in_flight`` until the backward; nothing else here outlives the
        call."""
        with torch.enable_grad():
            ys = stage_fn(local[s], xs)
            if s < last:
                in_flight[s][m] = (xs, ys)
                _check_hop(stages, ys, likes)
                stages.post(ys, s + 1, m, FORWARD)
                return
            args = (lparams,) if lparams is not None else ()
            losses = [loss_fn(*args, out.float(), target)
                      for out, target in zip(ys, micro_y[m])]
        for j, value in enumerate(losses):
            part = value.detach() / m_count
            loss_sums[j] = part if loss_sums[j] is None else (
                loss_sums[j] + part)
        backward(s, m, xs, losses, [torch.full_like(v, seed) for v in losses])

    def forward_from_previous(s, m):
        xs = (stages.take(s, m, FORWARD, likes) if s > 0 else
              [p.clone() for p in micro_x[m]])
        forward(s, m, [p.requires_grad_(s > 0 or return_input_grads)
                       for p in xs])

    def backward_from_next(s, m):
        xs, ys = in_flight[s].pop(m)
        backward(s, m, xs, ys, stages.take(s, m, BACKWARD, ys))

    for t in range(m_count + 2 * last):
        # ---- forward sub-phase: microbatch m_f = t - s; a stage reads
        # what the one before it sent last tick ----
        for s in reversed(stages.held):
            if 0 <= t - s < m_count:
                forward_from_previous(s, t - s)
        # ---- backward sub-phase: microbatch m_b = t - 2(S-1) + s ----
        for s in stages.held:
            m = t - 2 * last + s
            if s < last and 0 <= m < m_count:
                backward_from_next(s, m)
    stages.finish()

    # every member's loss is a mean over its own tokens: the step's loss
    # is their mean, and each gradient (summed over the members) is
    # divided by the member count
    lead = stages.devices[last]
    loss = torch.zeros((), dtype=torch.float32, device=lead)
    if last in stages.held:
        parts = stages.every_member([part.to(lead) for part in loss_sums])
        loss = parts[0]
        for part in parts[1:]:
            loss = loss + part
        loss = loss / members
    loss = stages.share([loss], last)[0]

    def mean(g, like):
        return _member_mean(g, members).to(like.dtype)

    n_params = len(tree_leaves(stage_params))
    if stages.ranked:
        out_grads = tree_map(
            lambda p, g: ShardedTensor([mean(g, p)[None]], P(pp_axis), mesh,
                                       p.shape),
            stage_params, _unflatten_like(stage_params,
                                          acc[stages.stage][:n_params]))
    else:
        out_grads = tree_map(
            lambda p, *gs: torch.stack([mean(g, p).to(stages.devices[0])
                                        for g in gs]),
            stage_params, *[_unflatten_like(stage_params, acc[s][:n_params])
                            for s in range(n_stages)])
    out = [loss, out_grads]
    if loss_params is not None:
        like = tree_leaves(loss_params)
        lgrads = ([mean(g, p) for g, p in zip(acc[last][n_params:], like)]
                  if last in stages.held else
                  [torch.empty(p.shape, dtype=p.dtype, device=lead)
                   for p in like])
        out.append(_unflatten_like(loss_params, stages.share(lgrads, last)))
    if return_input_grads:
        dx = (stages.join_micro([[_member_mean(g, members) for g in parts]
                                 for parts in dx_parts],
                                activation_spec, x.shape)
              if 0 in stages.held else
              torch.empty(x.shape, dtype=torch.float32, device=lead))
        out.append(stages.share([dx], 0)[0])
    return tuple(out)


def _member_mean(g: torch.Tensor, members: int) -> torch.Tensor:
    """A gradient summed over a stage's members, as the mean of theirs
    (each member's loss is a mean over its own tokens), in f32."""
    return g.float() / members


def _unflatten_like(tree, leaves: List[torch.Tensor]):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
