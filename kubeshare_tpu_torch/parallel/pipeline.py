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
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, PartitionSpec, _split_names, refuse_rank_mesh
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


class _Stages:
    """Where a pipeline's pieces live: stage ``s``'s members (one per
    coordinate of the axes the activation spec names, in mesh order, the
    first outermost) and their device, and how a tensor splits into the
    members' pieces under a spec and joins back."""

    def __init__(self, mesh: Mesh, pp_axis: str, axes: Sequence[str]):
        refuse_rank_mesh(mesh, "pipeline parallelism", "11i")
        self.mesh, self.pp_axis = mesh, pp_axis
        self.axes = tuple(a for a in mesh.axis_names if a in axes)
        self.n_stages = mesh.shape[pp_axis]
        self.coords = list(np.ndindex(*[mesh.shape[a] for a in self.axes]))
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

    def slices(self, shape, spec) -> List[Tuple[slice, ...]]:
        """Each member's slice of a tensor of ``shape`` under ``spec``."""
        out = []
        for coord in self.coords:
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
        """The members' pieces as one tensor on the last stage's device."""
        out = torch.empty(shape, dtype=pieces[0].dtype,
                          device=self.devices[-1])
        for piece, slices in zip(pieces, self.slices(shape, spec)):
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

    def hop(self, xs: List[torch.Tensor], stage: int) -> List[torch.Tensor]:
        device = self.devices[stage]
        return [x.to(device, non_blocking=True) for x in xs]


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
    s``.  Differentiable: autograd runs through the whole schedule (every
    microbatch's activations stay alive until the backward, as under JAX's
    autodiff).  Returns the last stage's output, x-shaped, on its device.

    ``activation_spec`` splits the activations over other mesh axes (it
    must not mention ``pp_axis``) — e.g. ``P(None, "sp", None)`` runs
    each stage on sequence shards (pp x sp composition)."""
    axes = _validate_activation_spec(activation_spec, pp_axis)
    n_stages = mesh.shape[pp_axis]
    _check_pipeline(stage_params, x, num_microbatches, n_stages, pp_axis)
    stages = _Stages(mesh, pp_axis, axes)
    local = [tree_map(lambda p, s=s: p[s].to(stages.devices[s]),
                      stage_params) for s in range(n_stages)]
    micro = stages.micro(x, activation_spec, num_microbatches, 0)
    outs: List[Optional[List[torch.Tensor]]] = [None] * num_microbatches
    current: List[Optional[List[torch.Tensor]]] = [None] * n_stages
    for t in range(num_microbatches + n_stages - 1):
        hopped: List[Optional[List[torch.Tensor]]] = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < num_microbatches:
                continue
            y = stage_fn(local[s], micro[m] if s == 0 else current[s])
            if s == n_stages - 1:
                outs[m] = y
            else:
                hopped[s + 1] = stages.hop(y, s + 1)
        current = hopped
    return stages.join_micro(outs, activation_spec, x.shape)


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
    or ``loss_params``).  The port sums the members' gradients itself."""
    n_stages = mesh.shape[pp_axis]
    axes = _validate_activation_spec(activation_spec, pp_axis)
    _check_pipeline(stage_params, x, num_microbatches, n_stages, pp_axis)
    stages = _Stages(mesh, pp_axis, axes)
    m_count, last = num_microbatches, n_stages - 1
    if target_spec is not None:
        y_spec = target_spec
    elif activation_spec is not None:
        y_spec = PartitionSpec(*tuple(activation_spec)[:y.ndim])
    else:
        y_spec = None
    members = len(stages.coords)
    # this step's leaves: one set a stage, one for the loss's parameters
    local = [tree_map(lambda p, s=s: p[s].detach().to(stages.devices[s])
                      .requires_grad_(), stage_params)
             for s in range(n_stages)]
    lparams = (tree_map(lambda p: p.detach().to(stages.devices[last])
                        .requires_grad_(), loss_params)
               if loss_params is not None else None)
    with torch.no_grad():
        micro_x = stages.micro(x.detach(), activation_spec, m_count, 0)
        micro_y = stages.micro(y, y_spec, m_count, last)
    seed = 1.0 / m_count
    loss_sums: List[Optional[torch.Tensor]] = [None] * members
    dx_parts: List[Optional[List[torch.Tensor]]] = [None] * m_count
    in_flight = [dict() for _ in range(n_stages)]
    fwd_carry: List[Optional[List[torch.Tensor]]] = [None] * n_stages
    bwd_carry: List[Optional[List[torch.Tensor]]] = [None] * n_stages

    def backward(s, m, xs, outputs, cotangents):
        """Stage ``s``'s backward for microbatch ``m``: the stage's
        parameter gradients accumulate; returns the cotangents of its
        inputs for the stage before (None at stage 0, whose input
        cotangents are ``dx``)."""
        torch.autograd.backward(outputs, cotangents)
        grads = [x.grad for x in xs]
        if s > 0:
            return stages.hop(grads, s - 1)
        if return_input_grads:
            dx_parts[m] = grads
        return None

    def forward(s, m, xs):
        """Stage ``s``'s forward for microbatch ``m``: (the next stage's
        inputs, None), or at the last stage (None, the cotangents for
        the stage before), its backward seeded at once (1/M a
        microbatch).  The graph lives in ``in_flight`` until the
        backward; nothing else here outlives the call."""
        with torch.enable_grad():
            ys = stage_fn(local[s], xs)
            if s < last:
                in_flight[s][m] = (xs, ys)
                return [out.detach().to(stages.devices[s + 1])
                        .requires_grad_() for out in ys], None
            args = (lparams,) if lparams is not None else ()
            losses = [loss_fn(*args, out.float(), target)
                      for out, target in zip(ys, micro_y[m])]
        for j, value in enumerate(losses):
            part = value.detach() / m_count
            loss_sums[j] = part if loss_sums[j] is None else (
                loss_sums[j] + part)
        return None, backward(s, m, xs, losses,
                              [torch.full_like(v, seed) for v in losses])

    for t in range(m_count + 2 * last):
        fwd_next: List[Optional[List[torch.Tensor]]] = [None] * n_stages
        bwd_next: List[Optional[List[torch.Tensor]]] = [None] * n_stages
        # ---- forward sub-phase: microbatch m_f = t - s.  Each stage
        # reads what the one before it sent last tick; the last stage runs
        # first, so no stage holds the next tick's input while it runs ----
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < m_count:
                continue
            xs = (fwd_carry[s] if s > 0 else
                  [p.clone().requires_grad_(return_input_grads)
                   for p in micro_x[m]])
            hop, grads = forward(s, m, xs)
            if hop is not None:
                fwd_next[s + 1] = hop
            if grads is not None:
                bwd_next[s - 1] = grads
        # ---- backward sub-phase: microbatch m_b = t - 2(S-1) + s ----
        for s in range(last):
            m = t - 2 * last + s
            if 0 <= m < m_count:
                grads = backward(s, m, *in_flight[s].pop(m), bwd_carry[s])
                if grads is not None:
                    bwd_next[s - 1] = grads
        fwd_carry, bwd_carry = fwd_next, bwd_next

    # every member's loss is a mean over its own tokens: the step's loss
    # is their mean, and each gradient (summed over the members by
    # autograd) is divided by the member count
    lead = stages.devices[last]
    loss = loss_sums[0].to(lead)
    for part in loss_sums[1:]:
        loss = loss + part.to(lead)
    loss = loss / members

    def grad_of(leaf):
        g = (leaf.grad if leaf.grad is not None
             else torch.zeros_like(leaf, dtype=torch.float32))
        return g.float() / members

    grads = tree_map(
        lambda p, *ls: torch.stack([grad_of(leaf).to(stages.devices[0])
                                    for leaf in ls]).to(p.dtype),
        stage_params, *local)
    out = [loss, grads]
    if loss_params is not None:
        out.append(tree_map(lambda p, leaf: grad_of(leaf).to(p.dtype),
                            loss_params, lparams))
    if return_input_grads:
        out.append(stages.join_micro(
            [[g.float() / members for g in parts] for parts in dx_parts],
            activation_spec, x.shape))
    return tuple(out)
