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
    """
    if mesh is not None or param_rules is not None:
        raise NotImplementedError(
            "mesh / param_rules sharding is not ported yet (ROADMAP.md "
            "queue A item 8, parallel/mesh.py over torch.distributed)")
    optimizer = optimizer or adamw(1e-3)

    def init_state(params) -> TrainState:
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return TrainState(params=params, opt_state=optimizer(leaves), step=0)

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
