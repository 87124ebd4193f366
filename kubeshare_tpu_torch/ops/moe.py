"""Mixture-of-Experts layer, port of kubeshare_tpu/ops/moe.py (one device).

Tokens are routed top-k (top-1 Switch style by default, top-2 GShard
style via ``top_k=2``) or experts pick their tokens (``experts_choose``),
and every expert's MLP runs over a ``[capacity, d]`` buffer.  Two
dispatch strategies, the same function up to rounding:

- ``"scatter"`` (default): kept token-choices land in the ``[e,
  capacity, d]`` expert buffers by index and are gathered back out:
  O(k*n*d) memory traffic, no dispatch FLOPs.
- ``"einsum"``: the dense one-hot dispatch and combine products,
  O(n * e * capacity * d) FLOPs.

This is plain PyTorch (sort, cumsum, index_add / index_select, batched
products), as the JAX module is plain XLA: no Pallas kernel, so no
hand-written one.  What the port adds is its contract on the card:

- the op reads nothing back to the host and has no data-dependent
  shape (the capacity comes from shapes), so the captured decode step,
  the engine's graphs and the captured train step can record it;
- no two contributions ever meet at one address of an atomic add whose
  result is kept, so forward and gradient are the same bits run to run:
  a token's k copies are an ``expand`` (its backward sums the k rows in
  a fixed order), kept slots are unique (dropped choices share a
  sentinel row that is sliced off), and expert-choice gathers from and
  scatters into one ``[n, d]`` plane per expert, summed afterwards;
- ``jax.lax.top_k`` keeps the lower index first among equal values;
  ``torch.topk`` promises no order, so top-k is a stable descending sort.

The router runs in f32: JAX multiplies bf16 tokens by the f32 router in
f32 by type promotion, so the tokens are upcast here (casting the router
to bf16 would pick other experts).  The gates are cast to the activation
dtype where JAX casts them.

``moe_sharding_rules`` (expert parallelism over a mesh) waits for the
mesh, ROADMAP.md queue A item 9.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 512
    d_ff: int = 1024
    num_experts: int = 8
    capacity_factor: float = 1.25
    # routing fan-out: 1 = Switch (gate is the raw top prob), >1 = GShard
    # style (gates renormalized over the chosen experts)
    top_k: int = 1
    # "tokens_choose": top-k routing.  "experts_choose": each expert takes
    # its top-capacity tokens (balanced by construction, nothing dropped);
    # training-time only for causal LMs (an expert's choices depend on the
    # whole batch, so the cached paths refuse it)
    routing: str = "tokens_choose"
    # "scatter" (permutation dispatch) or "einsum" (dense one-hot dispatch)
    dispatch: str = "scatter"


def moe_init(config: MoEConfig, generator: torch.Generator,
             device=None) -> Dict:
    """f32 router [d, e], w_in [e, d, f] and w_out [e, f, d] with the JAX
    init's scales (d^-1/2, d^-1/2, f^-1/2), drawn in that order from
    ``generator`` (a CPU generator) and moved to ``device``."""
    device = resolve_device(device)
    d, f, e = config.d_model, config.d_ff, config.num_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * (1.0 / fan_in) ** 0.5).to(device)

    return {
        "router": dense((d, e), d),
        "w_in": dense((e, d, f), d),
        "w_out": dense((e, f, d), f),
    }


def _top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties in
    index order (``jax.lax.top_k``'s order)."""
    ordered, index = torch.sort(values, dim=-1, descending=True, stable=True)
    return ordered[..., :k], index[..., :k]


def router_probs(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Softmax router probabilities [n, e] in f32 of tokens [n, d]: the
    product in the promoted type of tokens and router (f32 for bf16
    tokens and an f32 router, as in JAX)."""
    router = params["router"]
    dtype = torch.promote_types(tokens.dtype, router.dtype)
    logits = tokens.to(dtype) @ router.to(dtype)
    return torch.softmax(logits.to(torch.float32), dim=-1)


def tokens_choose_routing(probs: torch.Tensor, k: int, capacity: int):
    """Top-k routing of probs [n, e] into buffers of ``capacity`` slots:
    (gates [n, k], expert index [n, k], one-hot [n, k, e], kept [k*n, e],
    position [k*n]).  Slots are claimed choice-rank-major (every token's
    first choice before any token's second), so overflow drops the
    weakest assignments first; ``kept`` marks the choices within
    capacity and ``position`` is each choice's slot in its expert."""
    e = probs.shape[1]
    n = probs.shape[0]
    gates, index = _top_k(probs, k)
    if k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    experts = torch.arange(e, device=probs.device)
    onehot = (index[..., None] == experts).to(torch.int32)  # [n, k, e]
    onehot_flat = onehot.transpose(0, 1).reshape(k * n, e)
    # the running count down the k*n choices, scanned along the last axis
    # of the [e, k*n] transpose: a scan down the first axis of [k*n, e]
    # runs as one long serial sweep per column on CUDA (1.39 ms of a
    # 2.11 ms forward at the MoE model's layer shape on an H100)
    position_in_expert = (torch.cumsum(onehot_flat.T.contiguous(), dim=1).T
                          * onehot_flat)  # 1-based
    kept = (position_in_expert <= capacity) & (onehot_flat > 0)
    position = (position_in_expert - 1).amax(dim=-1)  # [k*n]
    return gates, index, onehot, kept, position


def moe_capacity(config: MoEConfig, n: int,
                 capacity: Optional[int] = None) -> int:
    """The per-expert buffer of a call over ``n`` tokens: ``capacity``
    when given, else ``ceil(capacity_factor * fanout * n / e)``."""
    if capacity is None:
        # top_k is a tokens_choose fan-out; expert-choice capacity follows
        # the cf*n/e convention regardless of it
        fanout = config.top_k if config.routing == "tokens_choose" else 1
        return max(1, math.ceil(config.capacity_factor * fanout * n
                                / config.num_experts))
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    return capacity


def moe_apply(params: Dict, x: torch.Tensor, config: MoEConfig,
              capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [batch, seq, d_model] -> (output in x's dtype, aux_loss f32 0-d).

    Top-k routing with capacity-bounded dispatch; aux_loss is the
    load-balancing term (mean first-choice share x mean prob x e).  With
    ``top_k=1`` the gate is the raw top probability, with ``top_k>1`` the
    gates are renormalized over the chosen experts.

    ``capacity`` overrides the derived per-expert buffer
    (:func:`moe_capacity`); ``capacity=n_tokens`` guarantees no
    token-choice is dropped, which the cached paths rely on."""
    b, s, d = x.shape
    k = config.top_k
    if not 1 <= k <= config.num_experts:
        raise ValueError(f"top_k must be in [1, num_experts], got {k}")
    if config.routing not in ("tokens_choose", "experts_choose"):
        raise ValueError(f"unknown routing {config.routing!r}")
    if config.dispatch not in ("scatter", "einsum"):
        raise ValueError(f"unknown dispatch {config.dispatch!r}")
    capacity = moe_capacity(config, b * s, capacity)
    probs = router_probs(params, x.reshape(b * s, d))
    return routed_apply(params, x, probs, config, capacity)


def routed_apply(params: Dict, x: torch.Tensor, probs: torch.Tensor,
                 config: MoEConfig,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` after the router: x [b, s, d] routed by probs
    [b*s, e] into buffers of ``capacity`` slots (checked arguments).  A
    caller holding another device's probabilities gets that device's
    routing here, whatever its own router product would round to."""
    b, s, d = x.shape
    e, k = config.num_experts, config.top_k
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    if config.routing == "experts_choose":
        return _experts_choose(params, x, tokens, probs, config,
                               min(capacity, n))
    gates, index, onehot, kept, position = tokens_choose_routing(
        probs, k, capacity)
    if config.dispatch == "scatter":
        combined = _scatter_dispatch_combine(params, tokens, index, gates,
                                             kept, position, e, capacity,
                                             x.dtype)
    else:
        # per-choice dense dispatch [k, n, e, capacity]; choices occupy
        # disjoint slots, so summing over k gives the 0/1 input dispatch
        slots = torch.arange(capacity, device=x.device)
        dispatch_k = (kept[:, :, None]
                      & (position[:, None] == slots)[:, None, :]
                      ).to(x.dtype).reshape(k, n, e, capacity)
        dispatch = dispatch_k.sum(dim=0)  # [n, e, capacity]
        # combine weights fold in the (kept-masked) per-choice gates
        combine = torch.einsum("kn,knec->nec", gates.T.to(x.dtype),
                               dispatch_k)
        combined = _dispatch_experts_combine(params, tokens, dispatch,
                                             combine, x.dtype)

    # load-balancing auxiliary loss over first choices (Switch/GShard)
    assignment_fraction = onehot[:, 0, :].to(torch.float32).mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux_loss = (assignment_fraction * mean_probs).sum() * e
    return combined.reshape(b, s, d), aux_loss


def _expert_ffn(params: Dict, expert_inputs: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Every expert's MLP over its [e, cap, d] buffer (jax.nn.gelu's
    default tanh form)."""
    hidden = F.gelu(torch.bmm(expert_inputs, params["w_in"].to(dtype)),
                    approximate="tanh")
    return torch.bmm(hidden, params["w_out"].to(dtype))


def _dispatch_experts_combine(params: Dict, tokens: torch.Tensor,
                              dispatch: torch.Tensor, combine: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """Dense dispatch body: token buffers per expert from the [n, e, cap]
    dispatch, every expert's MLP, results weighted back per token by the
    [n, e, cap] combine."""
    expert_inputs = torch.einsum("nec,nd->ecd", dispatch, tokens)
    expert_outputs = _expert_ffn(params, expert_inputs, dtype)
    return torch.einsum("nec,ecd->nd", combine, expert_outputs)


def _scatter_dispatch_combine(params: Dict, tokens: torch.Tensor,
                              index: torch.Tensor, gates: torch.Tensor,
                              kept: torch.Tensor, position: torch.Tensor,
                              e: int, capacity: int,
                              dtype: torch.dtype) -> torch.Tensor:
    """Permutation dispatch: every kept (token, choice) owns a unique
    (expert, position) buffer slot, so the dispatch is an add into zeros
    that never collides on a kept row and the combine a plain gather.
    Dropped choices route to a sentinel row that is sliced off."""
    n, d = tokens.shape
    k = index.shape[1]
    # choice-rank-major flat order, matching position's cumsum order
    flat_expert = index.T.reshape(k * n)
    keep = kept.any(dim=-1)  # [k*n]
    slot = torch.where(keep, flat_expert * capacity + position, e * capacity)
    # each token once per choice as an expand: its backward sums a token's
    # k rows in a fixed order, where a repeated-index gather would add
    # them atomically
    token_rows = tokens.expand(k, n, d).reshape(k * n, d).to(dtype)
    buf = torch.zeros((e * capacity + 1, d), dtype=dtype,
                      device=tokens.device).index_add(0, slot, token_rows)
    expert_outputs = _expert_ffn(params, buf[:-1].reshape(e, capacity, d),
                                 dtype)
    flat_out = torch.cat([expert_outputs.reshape(e * capacity, d),
                          expert_outputs.new_zeros((1, d))])
    flat_gates = gates.T.reshape(k * n).to(dtype) * keep.to(dtype)
    picked = flat_out.index_select(0, slot) * flat_gates[:, None]  # [k*n, d]
    return picked.reshape(k, n, d).sum(dim=0)


def _experts_choose(params: Dict, x: torch.Tensor, tokens: torch.Tensor,
                    probs: torch.Tensor, config: MoEConfig,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-choice routing: every expert selects its ``capacity``
    highest-affinity tokens; no load-balancing aux (returned as 0).  A
    token may be picked by several experts (outputs sum, gated by each
    picking expert's affinity) or by none (output 0)."""
    b, s, d = x.shape
    e = config.num_experts
    n = tokens.shape[0]
    gates, picks = _top_k(probs.T, capacity)  # [e, capacity]
    if config.dispatch == "scatter":
        # an expert's picks are distinct tokens: it gathers from its own
        # copy of the tokens and scatters into its own [n, d] plane, and
        # the planes are summed, so no address takes two contributions
        # (forward or backward)
        rows = picks[..., None].expand(e, capacity, d)
        expert_inputs = torch.gather(tokens.expand(e, n, d), 1, rows)
        expert_outputs = _expert_ffn(params, expert_inputs, x.dtype)
        weighted = expert_outputs * gates.to(x.dtype)[..., None]
        planes = torch.zeros((e, n, d), dtype=x.dtype, device=x.device)
        combined = planes.scatter(1, rows, weighted).sum(dim=0)
    else:
        # dense dispatch [n, e, capacity]: slot c of expert j holds token
        # picks[j, c]
        token_ids = torch.arange(n, device=x.device)
        dispatch = (picks[..., None] == token_ids).permute(2, 0, 1).to(x.dtype)
        combine = dispatch * gates.to(x.dtype)[None, :, :]
        combined = _dispatch_experts_combine(params, tokens, dispatch,
                                             combine, x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return combined.reshape(b, s, d), aux
