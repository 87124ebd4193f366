"""Training step on one device: loss, gradients and AdamW.

Port of kubeshare_tpu/parallel/train.py for a single device.  The JAX
step's ``jax.value_and_grad`` becomes autograd through the apply
function (the flash backward kernels on CUDA), and ``optax.adamw(1e-3)``
becomes ``torch.optim.AdamW`` with optax's defaults.  The step updates the
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

The mesh and its ``param_rules`` (multi-device sharding) are not ported
yet: ROADMAP.md queue A item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import torch

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


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy; logits [..., vocab], targets int."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    return nll.mean()


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
):
    """Returns (init_state_fn, train_step_fn).

    - init_state_fn(params) -> TrainState: the tree's leaves become the
      optimizer's parameters (``requires_grad`` set on them, no copy);
    - train_step_fn(state, inputs, targets) -> (state, loss): forward,
      backward, the optimizer step, and the gradients cleared.  The
      parameters and moments are updated in place (the counterpart of the
      JAX step's state donation), and the returned state shares them with
      the one passed in.  The loss is a detached device tensor: the step
      never waits for the device.

    ``capture=True``: the step is a :class:`CapturedTrainStep` (one CUDA
    graph), which switches the optimizer to its capturable mode (step
    counts and bias corrections on the device; the update differs from
    the eager one only by rounding).  Its parameters must be CUDA
    tensors: it raises on the CPU, where the eager step is the one to
    use.
    """
    if mesh is not None or param_rules is not None:
        raise NotImplementedError(
            "mesh / param_rules sharding is not ported yet (ROADMAP.md "
            "queue A item 8, parallel/mesh.py over torch.distributed)")
    optimizer = optimizer or adamw(1e-3)

    def init_state(params) -> TrainState:
        leaves = tree_leaves(params)
        if capture:
            _cuda_device_of(leaves)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return TrainState(params=params, opt_state=optimizer(leaves), step=0)

    if capture:
        return init_state, CapturedTrainStep(apply_fn, loss_fn)

    def train_step(state: TrainState, inputs: torch.Tensor,
                   targets: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        loss = loss_fn(apply_fn(state.params, inputs), targets)
        loss.backward()
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        return (TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1),
                loss.detach())

    return init_state, train_step


# warm-up steps before the capture (PyTorch's whole-network recipe): the
# library handles, the kernels' first loads and the optimizer's lazy state
# come into being outside the graph
CAPTURE_WARMUP_STEPS = 3


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
    """

    def __init__(self, apply_fn, loss_fn) -> None:
        self.apply_fn = apply_fn
        self.loss_fn = loss_fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.inputs: Optional[torch.Tensor] = None
        self.targets: Optional[torch.Tensor] = None
        self.loss: Optional[torch.Tensor] = None

    def __call__(self, state: TrainState, inputs: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
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
                static.copy_(given)
        self.graph.replay()
        # the graph's loss is a static tensor that the next replay
        # overwrites; hand the caller a copy, as JAX returns a fresh array
        return (TrainState(params=state.params, opt_state=state.opt_state,
                           step=state.step + 1),
                self.loss.clone())

    def _pass(self, state: TrainState) -> torch.Tensor:
        loss = self.loss_fn(self.apply_fn(state.params, self.inputs),
                            self.targets)
        loss.backward()
        state.opt_state.step()
        return loss

    def _capture(self, state: TrainState, inputs: torch.Tensor,
                 targets: torch.Tensor) -> None:
        leaves = tree_leaves(state.params)
        device = _cuda_device_of(leaves)
        optimizer = state.opt_state
        _make_capturable(optimizer, device)
        self.inputs = inputs.to(device, copy=True)
        self.targets = targets.to(device, copy=True)
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
        with torch.cuda.graph(graph):
            loss = self._pass(state)
        _restore(leaves, optimizer, saved)
        self.graph, self.optimizer, self.loss = graph, optimizer, loss.detach()
