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

Expert parallelism: :func:`moe_sharding_rules` places the experts over
a mesh axis, and :func:`moe_apply` given placed parameters and a placed
batch runs :func:`sharded_moe` (routing over the global batch, each
unit its own experts; ``parallel/spmd.py`` holds the units and the
collectives), on one controller's mesh or across a mesh of ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel.mesh import (Mesh, P, PartitionSpec, ShardedTensor,
                             _split_names, batch_sharding, device_put)
from ..parallel.spmd import Units, mesh_of, place_plain


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


def _check_moe(config: MoEConfig) -> None:
    k = config.top_k
    if not 1 <= k <= config.num_experts:
        raise ValueError(f"top_k must be in [1, num_experts], got {k}")
    if config.routing not in ("tokens_choose", "experts_choose"):
        raise ValueError(f"unknown routing {config.routing!r}")
    if config.dispatch not in ("scatter", "einsum"):
        raise ValueError(f"unknown dispatch {config.dispatch!r}")


def moe_apply(params: Dict, x: torch.Tensor, config: MoEConfig,
              capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [batch, seq, d_model] -> (output in x's dtype, aux_loss f32 0-d).

    Top-k routing with capacity-bounded dispatch; aux_loss is the
    load-balancing term (mean first-choice share x mean prob x e).  With
    ``top_k=1`` the gate is the raw top probability, with ``top_k>1`` the
    gates are renormalized over the chosen experts.

    ``capacity`` overrides the derived per-expert buffer
    (:func:`moe_capacity`); ``capacity=n_tokens`` guarantees no
    token-choice is dropped, which the cached paths rely on.

    Mesh-aware, as the JAX function is under GSPMD: given parameters
    placed by ``parallel.mesh.shard_params`` (e.g. under
    :func:`moe_sharding_rules`) and ``x`` placed by ``batch_sharding``
    (a plain ``x`` is placed so), it runs :func:`sharded_moe` and returns
    the output as a ``ShardedTensor`` laid out like ``x``'s batch."""
    mesh = mesh_of(params, x)
    if mesh is not None:
        return _moe_apply_sharded(params, x, config, capacity, mesh)
    b, s, d = x.shape
    _check_moe(config)
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


def _scatter_slots(index: torch.Tensor, kept: torch.Tensor,
                   position: torch.Tensor, capacity: int, first: int = 0,
                   count: Optional[int] = None):
    """(slot [k*n], keep [k*n]) in choice-rank-major order (position's
    cumsum order): every kept choice of an expert in ``[first, first +
    count)`` (default: every expert) owns row ``(expert - first) *
    capacity + position`` of that range's buffers; every other choice
    goes to the sentinel row ``count * capacity``."""
    n, k = index.shape
    count = kept.shape[1] if count is None else count
    flat_expert = index.T.reshape(k * n)
    keep = kept.any(dim=-1)  # [k*n]
    if count != kept.shape[1]:
        flat_expert = flat_expert - first
        keep = keep & (flat_expert >= 0) & (flat_expert < count)
    return torch.where(keep, flat_expert * capacity + position,
                       count * capacity), keep


def _scatter_dispatch(tokens: torch.Tensor, slot: torch.Tensor, k: int,
                      rows: int, dtype: torch.dtype) -> torch.Tensor:
    """The expert buffers [rows + 1, d] (the last the sentinel): each
    token once per choice, added at its slot."""
    n, d = tokens.shape
    # each token once per choice as an expand: its backward sums a token's
    # k rows in a fixed order, where a repeated-index gather would add
    # them atomically
    token_rows = tokens.expand(k, n, d).reshape(k * n, d).to(dtype)
    return torch.zeros((rows + 1, d), dtype=dtype,
                       device=tokens.device).index_add(0, slot, token_rows)


def _scatter_combine(expert_outputs: torch.Tensor, slot: torch.Tensor,
                     gates: torch.Tensor, keep: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Each token's gated sum over its k choices of the outputs at its
    slots: expert_outputs [e, capacity, d], slot and keep [k*n] over the
    n tokens of gates [n, k]."""
    n, k = gates.shape
    d = expert_outputs.shape[-1]
    flat_out = torch.cat([expert_outputs.reshape(-1, d),
                          expert_outputs.new_zeros((1, d))])
    flat_gates = gates.T.reshape(k * n).to(dtype) * keep.to(dtype)
    picked = flat_out.index_select(0, slot) * flat_gates[:, None]  # [k*n, d]
    return picked.reshape(k, n, d).sum(dim=0)


def _scatter_dispatch_combine(params: Dict, tokens: torch.Tensor,
                              index: torch.Tensor, gates: torch.Tensor,
                              kept: torch.Tensor, position: torch.Tensor,
                              e: int, capacity: int,
                              dtype: torch.dtype) -> torch.Tensor:
    """Permutation dispatch: every kept (token, choice) owns a unique
    (expert, position) buffer slot, so the dispatch is an add into zeros
    that never collides on a kept row and the combine a plain gather.
    Dropped choices route to a sentinel row that is sliced off."""
    d = tokens.shape[1]
    slot, keep = _scatter_slots(index, kept, position, capacity)
    buf = _scatter_dispatch(tokens, slot, index.shape[1], e * capacity, dtype)
    expert_outputs = _expert_ffn(params, buf[:-1].reshape(e, capacity, d),
                                 dtype)
    return _scatter_combine(expert_outputs, slot, gates, keep, dtype)


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


def moe_sharding_rules(ep_axis: str = "dp") -> Dict[str, PartitionSpec]:
    """Expert weights sharded over the expert-parallel axis (conventionally
    laid over dp); router replicated."""
    return {
        "w_in": P(ep_axis, None, None),
        "w_out": P(ep_axis, None, None),
        "router": P(),
    }


def _moe_apply_sharded(params: Dict, x, config: MoEConfig,
                       capacity: Optional[int], mesh: Mesh):
    """:func:`moe_apply` on a placed ``x`` and placed parameters (either
    may be plain: ``x`` is then placed by ``batch_sharding``, a weight
    replicated)."""
    if not isinstance(x, ShardedTensor):
        x = device_put(x, batch_sharding(mesh, x.ndim))
    params = place_plain(params, mesh)
    units = Units.of(mesh, [x.spec] + [w.spec for w in params.values()])
    batch = _split_names(x.spec[0] if x.spec else None)
    ys = units.local(x, {0: batch})
    outs, aux = sharded_moe(units, params, ys, config, batch, capacity)
    return units.assemble(outs, P(x.spec[0] if x.spec else None),
                          x.shape), aux


def sharded_moe(units: Units, params: Dict[str, ShardedTensor],
                ys: List[torch.Tensor], config: MoEConfig,
                batch: Tuple[str, ...], capacity: Optional[int] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """:func:`moe_apply` over the work units of a mesh, the JAX function's
    semantics on the global batch: ``ys[u]`` is unit ``u``'s rows
    [b_u, s, d] of a batch split over the ``batch`` axes; returns each
    unit's rows of the output and the aux loss (the lead unit's).

    Routing is a function of the whole batch — the capacity counts every
    token, the slots follow the global row order, the aux averages over
    all tokens and expert choice ranks them all — so every unit gathers
    the batch's tokens (over ``batch``, dp outermost, then ep: the order
    ``batch_sharding`` splits) and routes the WHOLE batch itself, from
    its gathered tokens and its copy of the replicated router: the same
    bits on every unit, so the same routing, and no unit routes on its
    own rows alone.  Each unit's router copy and tokens receive the
    gradient of the gates that unit uses (its own rows', or its own
    experts'), and the aux is differentiated once, on the lead unit:
    the copies' gradients are then summed in mesh order by
    ``spmd.sum_copies``, on one controller and across ranks alike, so
    the two programs agree to the bit.  Over a mesh of ranks each rank
    is one unit; every rank returns the aux's value, and only the lead
    rank (coordinate 0 on every axis) differentiates it.

    Each unit runs its own experts (``w_in``'s axis-0 split: tp under
    the transformer rules, dp or the ep axis under
    :func:`moe_sharding_rules`) over their whole buffers, the outputs are
    gathered over the expert axis, and each unit combines its own rows.
    Units that hold the same experts (dp replicas of them) compute them
    alike."""
    _check_moe(config)
    expert = tuple(_split_names(params["w_in"].spec[0]
                                if params["w_in"].spec else None))
    out_split = tuple(_split_names(params["w_out"].spec[0]
                                   if params["w_out"].spec else None))
    if expert != out_split:
        expert = ()  # the weights disagree: every unit runs every expert
    keep = {0: expert} if expert else {}
    router = units.local(params["router"])
    w_in = units.local(params["w_in"], keep)
    w_out = units.local(params["w_out"], keep)
    e, k = config.num_experts, config.top_k
    local_e = w_in[0].shape[0]
    dtype = ys[0].dtype
    tokens = [y.reshape(-1, y.shape[-1])
              for y in units.all_gather(ys, 0, batch)]
    n, d = tokens[0].shape
    capacity = moe_capacity(config, n, capacity)
    probs = [router_probs({"router": r}, t) for r, t in zip(router, tokens)]

    def own(u):
        """Unit u: (device, first expert, first token, token count)."""
        count = ys[u].shape[0] * ys[u].shape[1]
        return (units.devices[u], units.coord(u, expert) * local_e,
                units.coord(u, batch) * count, count)

    def ffn(u, inputs):
        return _expert_ffn({"w_in": w_in[u], "w_out": w_out[u]}, inputs,
                           dtype)

    outs = []
    if config.routing == "experts_choose":
        # [e, capacity] a unit
        chosen = [_top_k(p.T, min(capacity, n)) for p in probs]
        cap = chosen[0][1].shape[1]
        ran = []
        for u, (gates, picks) in enumerate(chosen):
            dev, first, _, _ = own(u)
            mine = picks[first:first + local_e]
            if config.dispatch == "scatter":
                rows = mine[..., None].expand(local_e, cap, d)
                done = ffn(u, torch.gather(tokens[u].expand(local_e, n, d),
                                           1, rows))
                done = done * gates[first:first + local_e].to(
                    dtype)[..., None]
            else:
                token_ids = torch.arange(n, device=dev)
                dispatch = (mine[..., None] == token_ids).permute(
                    2, 0, 1).to(dtype)
                done = ffn(u, torch.einsum("nec,nd->ecd", dispatch,
                                           tokens[u]))
            ran.append(done)
        ran = units.all_gather(ran, 0, expert)
        for u, (gates, picks) in enumerate(chosen):
            dev, _, start, count = own(u)
            rel = picks - start
            if config.dispatch == "scatter":
                # other units' tokens go to a sentinel row, sliced off
                rel = torch.where((rel >= 0) & (rel < count), rel, count)
                planes = torch.zeros((e, count + 1, d), dtype=dtype,
                                     device=dev)
                combined = planes.scatter(
                    1, rel[..., None].expand(e, cap, d), ran[u]
                ).sum(dim=0)[:count]
            else:
                token_ids = torch.arange(count, device=dev)
                combine = ((rel[..., None] == token_ids).permute(2, 0, 1)
                           .to(dtype) * gates.to(dtype)[None])
                combined = torch.einsum("nec,ecd->nd", combine, ran[u])
            outs.append(combined.reshape(ys[u].shape))
        aux = torch.zeros((), dtype=torch.float32, device=units.devices[0])
        return outs, aux

    routed = [tokens_choose_routing(p, k, capacity) for p in probs]
    if config.dispatch == "scatter":
        ran, slots = [], []
        for u, (gates, index, _, kept, position) in enumerate(routed):
            dev, first, _, _ = own(u)
            slots.append(_scatter_slots(index, kept, position, capacity))
            mine, _ = _scatter_slots(index, kept, position, capacity, first,
                                     local_e)
            buf = _scatter_dispatch(tokens[u], mine, k, local_e * capacity,
                                    dtype)
            ran.append(ffn(u, buf[:-1].reshape(local_e, capacity, d)))
        ran = units.all_gather(ran, 0, expert)
        for u, ((gates, _, _, _, _), (slot, keep_all)) in enumerate(
                zip(routed, slots)):
            dev, _, start, count = own(u)
            rows = slice(start, start + count)
            combined = _scatter_combine(
                ran[u], slot.reshape(k, n)[:, rows].reshape(-1), gates[rows],
                keep_all.reshape(k, n)[:, rows].reshape(-1), dtype)
            outs.append(combined.reshape(ys[u].shape))
    else:
        ran, combines = [], []
        for u, (gates, _, _, kept, position) in enumerate(routed):
            dev, first, _, _ = own(u)
            slots = torch.arange(capacity, device=dev)
            dispatch_k = (kept[:, :, None]
                          & (position[:, None] == slots)[:, None, :]
                          ).to(dtype).reshape(k, n, e, capacity)
            dispatch = dispatch_k.sum(dim=0)  # [n, e, capacity]
            combines.append(torch.einsum("kn,knec->nec", gates.T.to(dtype),
                                         dispatch_k))
            ran.append(ffn(u, torch.einsum(
                "nec,nd->ecd", dispatch[:, first:first + local_e],
                tokens[u])))
        ran = units.all_gather(ran, 0, expert)
        for u, combine in enumerate(combines):
            dev, _, start, count = own(u)
            combined = torch.einsum(
                "nec,ecd->nd", combine[start:start + count], ran[u])
            outs.append(combined.reshape(ys[u].shape))
    onehot = routed[0][2]
    assignment_fraction = onehot[:, 0, :].to(torch.float32).mean(dim=0)
    aux = (assignment_fraction * probs[0].mean(dim=0)).sum() * e
    return outs, (aux if units.lead else aux.detach())
