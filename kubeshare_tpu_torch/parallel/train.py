"""Training step: loss, gradients and AdamW, on one device or a mesh.

Port of kubeshare_tpu/parallel/train.py.  The JAX step's
``jax.value_and_grad`` becomes autograd through the apply function (the
flash backward kernels on CUDA), and ``optax.adamw(1e-3)`` becomes
``torch.optim.AdamW`` with optax's defaults.  The step updates the
parameters and the optimizer state in place, which is what the JAX step's
``donate_state=True`` buys there: the old state's buffers are reused.

    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    state = init_state(params)
    state, loss = train_step(state, inputs, targets)

``make_train_step(..., capture=True)`` is the counterpart of ``jax.jit``
on the card: forward, backward and the optimizer step captured in one
CUDA graph and replayed per call (:class:`CapturedTrainStep`), so that a
step is one device burst instead of ~1,500 eager launches paced by the
host.  It needs CUDA tensors and raises on the CPU.

With a ``mesh`` and ``param_rules`` the step trains the sharded program
(``parallel/spmd.py``), as the JAX step trains over a mesh with GSPMD:
the parameters are placed by the rules (every shard its own storage and
a leaf of its own), the batch by ``batch_sharding``, the apply function
runs the mesh-aware forward (``transformer_apply(_with_aux)``;
``moe_apply`` inside a loss), the loss is the global mean, and after the
backward the gradients of every slice held by several shards are summed
and given to each (``spmd.sum_copies``), so AdamW, elementwise over the
shards, keeps every copy of a slice equal to the bit.

    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=[torch.device("cuda")] * 4)
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), mesh=mesh,
        param_rules=transformer_sharding_rules())

With a ``process_group`` the step trains data-parallel across processes
(``parallel/distributed.py`` bootstraps them from the gang env), as the
JAX step does over a multi-process mesh: each process steps on its own
rows of the global batch, the gradients are averaged over the group
after the backward (and after ``sum_copies`` under a ``mesh``, which
still splits each process's work over its own devices), so every
process applies the same update to the same parameters.

    initialize_from_env()
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), process_group=True)

With a mesh of ranks (``make_mesh`` over a gang: ``mesh.RankMesh``, one
GPU a rank) the step is the same sharded program run across the
processes, as JAX's step runs one SPMD program over a multi-process
mesh: each rank places its own shards (every rank passes the same
initial tree, drawn from one seed, and the same global batch), runs its
unit, crosses ranks through the mesh's subgroups, and sums its copies'
gradients with the ranks that hold the same slices.  The mesh's dp axis
is the gang's data parallelism, so it takes no ``process_group``.

    initialize_from_env()
    mesh = make_mesh(MeshSpec(dp=-1, tp=2))      # the gang's ranks
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), mesh=mesh,
        param_rules=transformer_sharding_rules())
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import torch

from .mesh import (RankMesh, ShardedTensor, batch_sharding, device_put,
                   shard_params)
from .spmd import sharded_cross_entropy, sum_copies

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    params: Any  # the parameter tree (nested dicts / lists of tensors)
    opt_state: torch.optim.Optimizer  # holds the moments and step count
    step: int


def tree_leaves_with_paths(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf of a tree of dicts and lists, in the
    tree's own order; a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_leaves_with_paths(value, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from tree_leaves_with_paths(value, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``jax.tree.map`` over trees of dicts, lists and tuples: ``fn`` of
    the trees' leaves at each position, in the first tree's structure; a
    None in the first tree stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy; logits [..., vocab], targets int.
    Sharded logits (a mesh-aware forward's) give the global mean as one
    scalar (``spmd.sharded_cross_entropy``)."""
    if isinstance(logits, ShardedTensor):
        return sharded_cross_entropy(logits, targets)
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    return nll.mean()


class CrossEntropyWithAux:
    """The MoE training loss: ``cross_entropy_loss(logits, targets) +
    aux_coef * aux`` over a forward that returns ``(logits, aux)``
    (``transformer_apply_with_aux``, the sp entries' ``with_aux=True``),
    the form JAX's MoE steps train with.  Over a mesh of ranks each term
    is counted once: the cross entropy by its owners' shares, the aux by
    the rank that differentiates it (``ops.moe.sharded_moe``'s lead, or
    each rank's own share of the sp entries' mean)."""

    def __init__(self, aux_coef: float) -> None:
        self.aux_coef = aux_coef

    def __call__(self, out, targets) -> torch.Tensor:
        logits, aux = out
        return cross_entropy_loss(logits, targets) + self.aux_coef * aux


def adamw(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    """``optax.adamw``'s defaults as a ``torch.optim.AdamW`` factory.

    The update is optax's up to rounding: the decay is applied to the
    pre-step parameter (decoupled), ``eps`` is added after the square root
    of the bias-corrected second moment (optax's ``eps_root`` is 0), and
    every leaf is decayed (no mask).  torch's own default weight decay is
    1e-2, so it is passed explicitly."""
    def make(params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


def make_train_step(
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh: Optional[Any] = None,
    param_rules: Optional[Any] = None,
    optimizer: Optional[OptimizerFactory] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = cross_entropy_loss,
    capture: bool = False,
    process_group: Any = None,
):
    """Returns (init_state_fn, train_step_fn).

    - init_state_fn(params) -> TrainState: the tree's leaves become the
      optimizer's parameters (``requires_grad`` set on them, no copy);
      with a ``mesh``, the tree placed by ``param_rules``
      (``shard_params``, every shard its own storage) and the optimizer
      built over the shards, each moment laid out as its parameter's
      shard (optax's ``zeros_like`` over placed parameters);
    - train_step_fn(state, inputs, targets) -> (state, loss): forward,
      backward, the optimizer step, and the gradients cleared.  The
      parameters and moments are updated in place (the counterpart of the
      JAX step's state donation), and the returned state shares them with
      the one passed in.  The loss is a detached device tensor: the step
      never waits for the device.  With a ``mesh``, ``inputs`` and
      ``targets`` are placed by ``batch_sharding`` (a ``ShardedTensor``
      passes as it is), ``apply_fn`` takes the sharded tree (a function
      that cannot raises ``TypeError``) and ``loss_fn`` its sharded
      output; the returned loss is the global mean; and the gradients of
      a slice's copies are summed before the optimizer step.
      ``param_rules`` without a ``mesh`` are ignored, as in JAX.

    ``capture=True``: the step is a :class:`CapturedTrainStep` (one CUDA
    graph), which switches the optimizer to its capturable mode (step
    counts and bias corrections on the device; the update differs from
    the eager one only by rounding).  Its parameters must be CUDA
    tensors: it raises on the CPU, where the eager step is the one to
    use.  Under a mesh the whole sharded step is one graph, so the mesh
    must name one CUDA device (``[cuda:0] * n``); distinct CUDA devices
    raise ``ValueError``.

    ``process_group``: None (one process), True (the default group of
    ``torch.distributed``) or a group (e.g. a ``RankMesh``'s "dcn"
    column).  ``init_state`` then broadcasts the group's first rank's
    parameters to the others; the step all-reduces the gradients over
    the group and divides them by its size (one flat buffer and one
    collective per dtype, the loss in its dtype's buffer), before the
    optimizer, so the returned loss is the group's mean.  A gloo group
    carries CUDA buffers through host memory.  Captured, the all-reduce
    runs inside the graph under NCCL; gloo cannot be captured, so there
    the step is two graphs, forward and backward, then the optimizer,
    with the all-reduce between them.

    A ``mesh`` of ranks (:class:`~.mesh.RankMesh`): each rank's
    ``init_state`` places its own shards of the tree it is given, the
    step takes the whole global batch on every rank and places this
    rank's part, and the returned loss is the global loss on every rank.
    Any ``loss_fn`` runs, as JAX's step takes any loss over a global
    array.  ``cross_entropy_loss`` and :class:`CrossEntropyWithAux` read
    each rank's share of the logits without gathering them; any other
    loss reads the sharded output through ``gather()`` (or
    ``index_select``), a replicated read: every rank computes the same
    loss from the whole output, and each share's gradient reaches its
    owner once, from the owner's own copy of the loss (the gather's
    backward hands each owned shard its slice, with no sum over the
    ranks, which would count it once a rank).  A ``process_group``
    beside the mesh raises ``ValueError`` (the mesh's dp axis already
    averages over the gang: the two would average twice), and so does
    ``capture=True``: gloo's collectives cannot be captured, and NCCL's
    inside a graph need two cards (ROADMAP queue A item 11d).
    """
    optimizer = optimizer or adamw(1e-3)
    if isinstance(mesh, RankMesh):
        _check_rank_mesh_step(capture, process_group)
    group = _resolve_group(process_group)
    if mesh is not None and capture:
        devices = set(mesh.devices.flat)
        if len(devices) > 1 and all(d.type == "cuda" for d in devices):
            raise ValueError(
                f"mesh devices {sorted(map(str, devices))}: capture=True "
                "records the whole sharded step in one CUDA graph on one "
                "card's stream; name one card for every shard (e.g. "
                "[cuda:0] * n)")

    def init_state(params) -> TrainState:
        if mesh is not None:
            with torch.no_grad():
                params = shard_params(params, param_rules or {}, mesh,
                                      copy=True)
        leaves = _shards(params)
        if capture:
            _cuda_device_of(leaves)
        if group is not None:
            broadcast_from_first(leaves, group)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return TrainState(params=params, opt_state=optimizer(leaves), step=0)

    if capture:
        return init_state, CapturedTrainStep(apply_fn, loss_fn, mesh, group)

    def train_step(state: TrainState, inputs: torch.Tensor,
                   targets: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        if mesh is not None:
            inputs, targets = _place_batch(mesh, inputs, targets)
        loss = loss_fn(apply_fn(state.params, inputs), targets)
        # over ranks a replica's cross entropy is a constant: it has no
        # share (a loss over gather() differentiates, and the read hands
        # a replica's copies nothing)
        if loss.requires_grad or not isinstance(mesh, RankMesh):
            loss.backward()
        if mesh is not None:
            sum_copies(tree_leaves(state.params))
        if group is not None:
            mean = GroupMean(group)
            mean.flatten(state.opt_state, loss)
            mean.all_reduce()
            mean.unflatten()
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        return (TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1),
                loss.detach())

    return init_state, train_step


def _check_rank_mesh_step(capture: bool, process_group) -> None:
    """The ``ValueError``s of a step over a mesh of ranks."""
    if process_group is not None:
        raise ValueError(
            "a mesh of ranks is the gang's data parallelism over its dp "
            "axis; process_group would average the gradients a second "
            "time: pass one or the other")
    if capture:
        raise ValueError(
            "capture=True over a mesh of ranks: gloo's collectives cannot "
            "be captured in a CUDA graph, and NCCL's inside one need a "
            "card a rank, not yet built (ROADMAP queue A item 11d); use "
            "the eager step")


def _resolve_group(process_group):
    """None: one process; True: the default group; else the group."""
    if process_group is None:
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "process_group needs torch.distributed initialised first "
            "(parallel.distributed.initialize_from_env)")
    return dist.group.WORLD if process_group is True else process_group


def _buckets(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in order of appearance."""
    out: dict = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return list(out.values())


def _collective(op, flat: torch.Tensor, via_host: bool) -> None:
    """``op(flat)``, through a host copy when ``via_host`` and ``flat``
    is not on the CPU (gloo's transport is host memory)."""
    if via_host and flat.device.type != "cpu":
        host = flat.cpu()
        op(host)
        flat.copy_(host)
    else:
        op(flat)


@torch.no_grad()
def _unflatten(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_from_first(tensors: List[torch.Tensor], group) -> None:
    """Every tensor set in place to the group's first rank's, one
    broadcast per (dtype, device)."""
    import torch.distributed as dist

    src = dist.get_global_rank(group, 0)
    via_host = dist.get_backend(group) == "gloo"
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        _collective(lambda x: dist.broadcast(x, src, group=group), flat,
                    via_host)
        _unflatten(flat, bucket)


class GroupMean:
    """An optimizer's gradients and a loss averaged over a process group
    in three parts, so that a captured step can run the collective
    between two graphs: :meth:`flatten` (one buffer per dtype and
    device, the loss last in its dtype's), :meth:`all_reduce` (the sums)
    and :meth:`unflatten` (divide by the group's size and copy back: the
    gradients and the loss, in place, become the group's means)."""

    def __init__(self, group) -> None:
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.via_host = dist.get_backend(group) == "gloo"
        self.buckets: List[List[torch.Tensor]] = []
        self.flats: List[torch.Tensor] = []
        self.loss: Optional[torch.Tensor] = None

    @torch.no_grad()
    def flatten(self, optimizer: torch.optim.Optimizer,
                loss: torch.Tensor) -> None:
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        self.loss = loss.detach().reshape(1)
        self.buckets = _buckets(grads + [self.loss])
        self.flats = [torch.cat([t.reshape(-1) for t in bucket])
                      for bucket in self.buckets]

    def all_reduce(self) -> None:
        import torch.distributed as dist

        for flat in self.flats:
            _collective(lambda x: dist.all_reduce(x, group=self.group), flat,
                        self.via_host)

    @torch.no_grad()
    def unflatten(self) -> None:
        for bucket, flat in zip(self.buckets, self.flats):
            flat.div_(self.size)
            _unflatten(flat, bucket)


def _shards(tree: Any) -> List[torch.Tensor]:
    """The optimizer's parameters: every leaf, or every shard of every
    placed leaf."""
    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf.shards if isinstance(leaf, ShardedTensor) else [leaf])
    return out


def _place_batch(mesh, *batch) -> List[ShardedTensor]:
    """Each tensor placed by ``batch_sharding`` (placed ones as given: a
    batch placed along the sequence, ``batch_sharding(mesh, 2,
    seq_axis=1)``, keeps its split, and the loss gathers targets placed
    by rows)."""
    return [x if isinstance(x, ShardedTensor)
            else device_put(x, batch_sharding(mesh, x.ndim)) for x in batch]


# warm-up steps before the capture (PyTorch's whole-network recipe): the
# library handles, the kernels' first loads and the optimizer's lazy state
# come into being outside the graph
CAPTURE_WARMUP_STEPS = 3


@contextlib.contextmanager
def graph_capture(graph: torch.cuda.CUDAGraph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collector off.  A collection inside the capture may free a dead
    reference cycle that holds other CUDA graphs (a finished engine's
    programs); destroying a graph while a stream captures is not
    permitted, so it invalidates the capture and the next launch into it
    fails (cuBLAS reports CUBLAS_STATUS_EXECUTION_FAILED).  Such cycles
    are collected after the capture instead."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


def _cuda_device_of(leaves: List[torch.Tensor]) -> torch.device:
    devices = {leaf.device for leaf in leaves}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(
            "capture=True records the step in a CUDA graph and needs every "
            f"parameter on one CUDA device, got {sorted(map(str, devices))}; "
            "use the eager step (capture=False) on the CPU")
    return next(iter(devices))


def _make_capturable(optimizer: torch.optim.Optimizer,
                     device: torch.device) -> None:
    """Switch an optimizer with a capturable mode (Adam, AdamW) to it and
    move its step counts onto ``device``.  A state carried over from JAX
    (``convert.train_state_from_jax``) holds them on the CPU, where a
    graph cannot advance them."""
    for group in optimizer.param_groups:
        if "capturable" not in group:
            raise TypeError(
                f"{type(optimizer).__name__} has no capturable mode; a "
                "captured step needs one (torch.optim.AdamW does)")
        group["capturable"] = True
    for entry in optimizer.state.values():
        step = entry.get("step")
        if isinstance(step, torch.Tensor) and step.device != device:
            entry["step"] = step.to(device)


def _snapshot(leaves: List[torch.Tensor], optimizer: torch.optim.Optimizer):
    """Copies of the parameters and of the optimizer's tensors."""
    params = [leaf.detach().clone() for leaf in leaves]
    state = {leaf: {key: value.clone()
                    for key, value in optimizer.state[leaf].items()
                    if isinstance(value, torch.Tensor)}
             for leaf in leaves if optimizer.state.get(leaf)}
    return params, state


@torch.no_grad()
def _restore(leaves: List[torch.Tensor], optimizer: torch.optim.Optimizer,
             snapshot) -> None:
    """Put a :func:`_snapshot` back in place (the same tensors, which a
    captured graph reads).  An optimizer entry created after the snapshot
    goes back to zeros, which is what the optimizer's lazy
    initialisation writes (step 0, zero moments)."""
    params, state = snapshot
    for leaf, saved in zip(leaves, params):
        leaf.copy_(saved)
    for leaf in leaves:
        saved = state.get(leaf)
        for key, value in optimizer.state.get(leaf, {}).items():
            if not isinstance(value, torch.Tensor):
                continue
            if saved is None:
                value.zero_()
            else:
                value.copy_(saved[key])


class CapturedTrainStep:
    """A train step captured in one CUDA graph: ``step(state, inputs,
    targets) -> (state, loss)``, the eager step's contract.

    The first call copies ``inputs`` and ``targets`` into static device
    buffers, warms up on a side stream, captures forward, backward and
    ``optimizer.step()`` in one ``torch.cuda.graph``, and replays it; each
    later call copies into the same buffers and replays.  The gradients
    are set to None before the capture, so the backward allocates them
    from the graph's pool and every replay writes them afresh (no
    ``zero_grad`` inside the graph); they stay allocated between calls.
    The graph is bound to the state it was captured with: a call with
    another optimizer raises.  Inputs of another shape or dtype raise.

    The launch counters of ``ops.attention`` are Python increments made
    while the graph is recorded: a replay launches the kernels again but
    does not bump them.  Read them around an eager step or around the
    first call (``CAPTURE_WARMUP_STEPS`` + 1 passes).

    With a ``mesh`` the graph holds the whole sharded step (every unit's
    body, the collectives, the sum of the copies' gradients and the
    optimizer over every shard); the static buffers are placed batches,
    and a call's inputs are placed by ``batch_sharding`` and copied in
    shard by shard.

    With a process ``group`` the gradients' all-reduce over the group is
    part of the step: inside the graph under NCCL.  Gloo's collectives
    cannot be captured, so under gloo ``graph`` holds forward, backward
    and the flattening of the gradients, the all-reduce runs between the
    replays, and ``update_graph`` holds the division, the copy back and
    the optimizer (one memory pool for both).
    """

    def __init__(self, apply_fn, loss_fn, mesh=None, group=None) -> None:
        self.apply_fn = apply_fn
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.mean = GroupMean(group) if group is not None else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.update_graph: Optional[torch.cuda.CUDAGraph] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.inputs: Optional[torch.Tensor] = None
        self.targets: Optional[torch.Tensor] = None
        self.loss: Optional[torch.Tensor] = None

    def __call__(self, state: TrainState, inputs: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        if self.mesh is not None:
            inputs, targets = _place_batch(self.mesh, inputs, targets)
        if self.graph is None:
            self._capture(state, inputs, targets)
        else:
            if state.opt_state is not self.optimizer:
                raise ValueError(
                    "a captured step replays the state it was captured "
                    "with; make another train step for another state")
            for name, static, given in (("inputs", self.inputs, inputs),
                                        ("targets", self.targets, targets)):
                if given.shape != static.shape or given.dtype != static.dtype:
                    raise ValueError(
                        f"{name} {tuple(given.shape)} {given.dtype} differ "
                        f"from the captured {tuple(static.shape)} "
                        f"{static.dtype}")
                if isinstance(static, ShardedTensor):
                    if given.spec != static.spec:
                        raise ValueError(
                            f"{name} placed as {given.spec}, captured as "
                            f"{static.spec}")
                    for buffer, shard in zip(static.shards, given.shards):
                        buffer.copy_(shard)
                else:
                    static.copy_(given)
        self.graph.replay()
        if self.update_graph is not None:
            self.mean.all_reduce()
            self.update_graph.replay()
        # the graph's loss is a static tensor that the next replay
        # overwrites; hand the caller a copy, as JAX returns a fresh array
        return (TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1),
                self.loss.clone())

    def _backward(self, state: TrainState) -> torch.Tensor:
        """Forward and backward (the gradients flattened for the group's
        all-reduce when there is a group)."""
        loss = self.loss_fn(self.apply_fn(state.params, self.inputs),
                            self.targets)
        loss.backward()
        if self.mesh is not None:
            sum_copies(tree_leaves(state.params))
        if self.mean is not None:
            self.mean.flatten(state.opt_state, loss)
        return loss

    def _update(self, state: TrainState) -> None:
        if self.mean is not None:
            self.mean.unflatten()
        state.opt_state.step()

    def _pass(self, state: TrainState) -> torch.Tensor:
        loss = self._backward(state)
        if self.mean is not None:
            self.mean.all_reduce()
        self._update(state)
        return loss

    def _capture(self, state: TrainState, inputs: torch.Tensor,
                 targets: torch.Tensor) -> None:
        leaves = _shards(state.params)
        device = _cuda_device_of(leaves)
        optimizer = state.opt_state
        _make_capturable(optimizer, device)

        def static(x):
            if isinstance(x, ShardedTensor):
                return ShardedTensor([s.to(device, copy=True)
                                      for s in x.shards], x.spec, x.mesh,
                                     x.shape)
            return x.to(device, copy=True)

        self.inputs, self.targets = static(inputs), static(targets)
        # warm-up must not advance the state: PyTorch's recipe trains on
        # its warm-up steps, while JAX's jitted step has no such side
        # effect and the captured step must agree with the eager one from
        # the same state.  Keep the parameters, moments and step counts,
        # and put them back after the capture.
        saved = _snapshot(leaves, optimizer)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP_STEPS):
                optimizer.zero_grad(set_to_none=True)
                self._pass(state)
        torch.cuda.current_stream(device).wait_stream(side)
        optimizer.zero_grad(set_to_none=True)
        # the kernels capture as they are: they launch on the current
        # stream, and their TMA descriptors travel by value as kernel
        # parameters, so the graph-pool addresses baked into them stay
        # valid across replays
        graph = torch.cuda.CUDAGraph()
        if self.mean is not None and self.mean.via_host:
            with graph_capture(graph):
                loss = self._backward(state)
            self.update_graph = torch.cuda.CUDAGraph()
            with graph_capture(self.update_graph, pool=graph.pool()):
                self._update(state)
        else:
            with graph_capture(graph):
                loss = self._pass(state)
        _restore(leaves, optimizer, saved)
        self.graph, self.optimizer, self.loss = graph, optimizer, loss.detach()
