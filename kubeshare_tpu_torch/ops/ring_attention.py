"""Ring attention: sequence-parallel attention over a group of sequence
shards, port of kubeshare_tpu/ops/ring_attention.py.

The JAX functions run inside ``shard_map`` on one device's shard and
rotate K/V with ``ppermute``.  Here a ring runs over a group
(``parallel/spmd.py``): the lists hold the local q, k, v [batch, heads,
local_seq, head_dim] of the members this process holds, the global
sequence being the members' concatenation in member order (ring
position).  On one controller (``spmd.LocalGroup``, or a plain list of
devices) that is every member and the rotation a move between list
entries; over a mesh of ranks (``spmd.RankGroup``) it is this rank's
member at its index on the sp line, and the rotation crosses ranks.
Each schedule is written once over the group: the group's size and the
held members' indices come from it, never from a list's length.  The
member index and the step are Python ints, so JAX's ``lax.switch`` /
``lax.cond`` over them become choices made on the host: a fully masked
block is skipped, and the step keeps no data-dependent control flow (a
CUDA graph captures it).

Two bodies, as in JAX:

- the einsum ring (:func:`ring_attention`, :func:`ring_attention_zigzag`):
  an online softmax over every block.  JAX differentiates it with
  autodiff; here it keeps its global lse and takes the hand-scheduled
  ring backward below, the hybrid ring's (autograd through the shifts
  would skip, on a member whose later blocks are all masked, the shifts
  that carry the other members' cotangents home across ranks);
- the hybrid ring (:func:`ring_flash_attention`,
  :func:`ring_flash_attention_zigzag`): each step's block partial has a
  static mask shape — fully visible blocks are the einsum partial,
  diagonal blocks the flash forward (``ops/attention.py``
  :func:`flash_forward`: the hand-written Hopper kernel on a CUDA tensor,
  its plain version on a CPU tensor), fully masked blocks are skipped —
  and the partials merge by their logsumexps.  Its backward is the
  hand-scheduled ring backward (a ``torch.autograd.Function``): the
  forward's global lse and delta, JAX's ``_bwd_block`` math in plain
  PyTorch, each dK/dV partial kept with its K/V block.  The flash
  backward kernels are not on this path, in JAX or here.

A CUDA tensor that the flash kernel refuses (a head_dim it does not
take) raises; no block falls back to the einsum partial.

The zigzag layout (:func:`zigzag_shard`) balances the causal ring: member
``i`` holds chunks ``i`` and ``2 * sp - 1 - i`` of a ``2 * sp``-chunk
split.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import (Mesh, NamedSharding, P, ShardedTensor,
                             _split_names, device_put)
from ..parallel.spmd import LocalGroup, RankGroup, Units
from .attention import flash_forward, use_kernel_default

_NEG_INF = float("-inf")


def _devices(xs: Sequence[torch.Tensor], devices) -> List[torch.device]:
    return list(devices) if devices is not None else [x.device for x in xs]


def group_of(xs: Sequence[torch.Tensor], devices):
    """The group a ring or Ulysses runs over: ``devices`` itself when it
    is one (``spmd.LocalGroup`` / ``spmd.RankGroup``), else the
    one-controller group of every member, on ``devices`` (None: the
    members' own)."""
    if isinstance(devices, (LocalGroup, RankGroup)):
        return devices
    return LocalGroup(_devices(xs, devices))


def _block_scores(q: torch.Tensor, k: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """QK^T scores in f32 (the product in the inputs' dtype, then cast),
    GQA-aware: query heads grouped over their shared KV head, K/V never
    widened to the query heads."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    if h == h_kv:
        return torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if h % h_kv != 0:
        raise ValueError(f"query heads {h} not a multiple of kv heads {h_kv}")
    q5 = q.reshape(b, h_kv, h // h_kv, sq, d)
    scores = torch.einsum("bngqd,bnkd->bngqk", q5, k).float() * scale
    return scores.reshape(b, h, sq, sk)


def _block_pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs @ V, GQA-aware (the grouping of :func:`_block_scores`)."""
    b, h, sq, sk = probs.shape
    h_kv, d = v.shape[1], v.shape[-1]
    if h == h_kv:
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    p5 = probs.reshape(b, h_kv, h // h_kv, sq, sk)
    return torch.einsum("bngqk,bnkd->bngqd", p5, v).reshape(b, h, sq, d)


def _finite_or(x: torch.Tensor, other: float) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, other))


# ---------------------------------------------------------------------------
# the two layouts: each member's global positions (device tensors, for the
# masks and RoPE) and their bounds (host ints, for the static skips)
# ---------------------------------------------------------------------------

def _zigzag_shard_positions(index: int, axis_size: int, c: int,
                            device) -> torch.Tensor:
    """Global token positions of the zigzag shard at ring position
    ``index``: chunks ``index`` and ``2 * axis_size - 1 - index``, each of
    length ``c``."""
    low = torch.arange(c, device=device) + index * c
    high = torch.arange(c, device=device) + (2 * axis_size - 1 - index) * c
    return torch.cat([low, high])


def zigzag_positions(index: int, axis_size: int, s_local: int,
                     device=None) -> torch.Tensor:
    """Global token positions of member ``index``'s zigzag shard of local
    (two-chunk) length ``s_local`` (e.g. for RoPE in a zigzag-sharded
    stage); JAX's ``zigzag_positions(axis_name, s_local)``."""
    return _zigzag_shard_positions(index, axis_size, s_local // 2, device)


class _Contiguous:
    def __init__(self, n: int, s_local: int):
        self.n, self.s = n, s_local

    def positions(self, index: int, device) -> torch.Tensor:
        return torch.arange(self.s, device=device) + index * self.s

    def bounds(self, index: int) -> Tuple[int, int]:
        return index * self.s, (index + 1) * self.s - 1


class _Zigzag:
    def __init__(self, n: int, s_local: int):
        self.n, self.c = n, s_local // 2

    def positions(self, index: int, device) -> torch.Tensor:
        return _zigzag_shard_positions(index, self.n, self.c, device)

    def bounds(self, index: int) -> Tuple[int, int]:
        return index * self.c, (2 * self.n - index) * self.c - 1


# ---------------------------------------------------------------------------
# the einsum ring: an online softmax, differentiated by autograd
# ---------------------------------------------------------------------------

def _ring_steps(group, causal: bool, layout,
                window: Optional[int]) -> int:
    """Ring steps (blocks each member visits): the group's size, or on the
    contiguous layout under a causal window :func:`windowed_ring_steps`."""
    if causal and window is not None and isinstance(layout, _Contiguous):
        return windowed_ring_steps(window, layout.s, group.size)
    return group.size


def _ring_online_softmax(qs, ks, vs, group, causal: bool, layout,
                         window: Optional[int] = None):
    """The einsum ring's forward: K/V rotate around the group while each
    held member's streaming softmax accumulates over the blocks it
    receives.  ``layout`` gives the members' global positions.  Returns
    each held member's (out in q's dtype, global lse f32).

    ``window`` (causal only): the band ``q_pos - k_pos < window``; a block
    entirely outside the band (fully future, or fully past the window)
    skips its math, and on the contiguous layout the rotation stops after
    :func:`windowed_ring_steps` steps."""
    n = group.size
    scale = qs[0].shape[-1] ** -0.5
    steps = _ring_steps(group, causal, layout, window)
    state = []
    for q in qs:
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        l = acc[..., 0]
        state.append((l - float("inf"), l, acc))
    q_pos = ([layout.positions(i, q.device)
              for i, q in zip(group.indices, qs)] if causal else None)
    k_cur, v_cur = list(ks), list(vs)
    for t in range(steps):
        for j, (i, q) in enumerate(zip(group.indices, qs)):
            src = (i - t) % n  # the ring position this K/V came from
            if causal:
                q_lo, q_hi = layout.bounds(i)
                k_lo, k_hi = layout.bounds(src)
                # fully out-of-band blocks contribute nothing
                if k_lo > q_hi or (window is not None
                                   and q_lo - k_hi >= window):
                    continue
            m, l, acc = state[j]
            scores = _block_scores(q, k_cur[j], scale)
            if causal:
                k_pos = layout.positions(src, q.device)
                mask = q_pos[j][:, None] >= k_pos[None, :]
                if window is not None:
                    mask &= (q_pos[j][:, None] - k_pos[None, :]) < window
                scores = torch.where(mask, scores,
                                     torch.full_like(scores, _NEG_INF))
            new_m = torch.maximum(m, scores.amax(dim=-1))
            # fully masked rows (new_m = -inf) contribute nothing
            safe_m = _finite_or(new_m, 0.0)
            probs = torch.exp(scores - safe_m[..., None])
            probs = torch.where(torch.isfinite(scores), probs,
                                torch.zeros_like(probs))
            correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                                     torch.zeros_like(m))
            l = l * correction + probs.sum(dim=-1)
            acc = acc * correction[..., None] + _block_pv(
                probs.to(v_cur[j].dtype), v_cur[j]).float()
            state[j] = (new_m, l, acc)
        if t < steps - 1:
            k_cur, v_cur = group.shift([k_cur, v_cur])
    return [((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype),
             m + torch.log(l)) for (m, l, acc), q in zip(state, qs)]


def windowed_ring_steps(window: int, s_local: int, axis_size: int) -> int:
    """Ring steps (blocks visited, own shard included) a causal window
    needs on the contiguous layout: the band's oldest key sits ``window -
    1`` positions back, ``ceil((window - 1) / s_local)`` shards back."""
    n_back = max(0, -(-(window - 1) // s_local))
    return min(axis_size, n_back + 1)


def resolve_windowed_ring(
    window: Optional[int],
    causal: bool = True,
    zigzag: bool = False,
    use_flash: Optional[bool] = None,
) -> Optional[bool]:
    """Which ring variants compose with a sliding window: only the
    contiguous einsum ring does.  Returns the resolved ``use_flash``
    (False when a window is set); raises for the unsupported
    combinations so no caller silently runs full attention."""
    if window is None:
        return use_flash
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not causal:
        raise ValueError("window implies causal attention")
    if zigzag:
        raise ValueError(
            "window is not supported on the zigzag layout (its "
            "load-balance math assumes the full causal band); use "
            "layout='contiguous' or attention='ulysses'"
        )
    if use_flash:
        raise ValueError(
            "windowed ring attention runs the einsum ring; pass "
            "use_flash=False (or leave it unset)"
        )
    return False


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                   vs: List[torch.Tensor], devices=None, causal: bool = True,
                   window: Optional[int] = None) -> List[torch.Tensor]:
    """The einsum ring over contiguous shards: ``qs[i]``, ``ks[i]``,
    ``vs[i]`` are member ``i``'s; returns the members' outputs.

    ``window`` (implies causal): sliding-window band over global
    positions; fully out-of-band ring steps skip their block math."""
    resolve_windowed_ring(window, causal=causal)
    group = group_of(qs, devices)
    layout = _Contiguous(group.size, qs[0].shape[2])
    return _apply_ring(
        lambda q, k, v, g: _ring_online_softmax(q, k, v, g, causal, layout,
                                                window),
        lambda q, k, v, o, l, d, g: _ring_backward(q, k, v, o, l, d, g,
                                                   causal, window),
        qs, ks, vs, group)


# ---------------------------------------------------------------------------
# the hybrid ring: static-mask block partials merged by logsumexp
# ---------------------------------------------------------------------------

def _partial_einsum(q, k, v, causal: bool):
    """Whole-block attention partial in plain PyTorch: (normalized out
    f32, lse [b, h, s] f32, -inf on a row with no visible key)."""
    scale = q.shape[-1] ** -0.5
    scores = _block_scores(q, k, scale)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(s_k, device=q.device)[None, :])
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    block_lse = torch.logsumexp(scores, dim=-1)
    probs = torch.where(
        torch.isfinite(scores),
        torch.exp(scores - _finite_or(block_lse, 0.0)[..., None]),
        torch.zeros_like(scores))
    out = _block_pv(probs.to(v.dtype), v)
    return out.float(), block_lse


def _partial_flash(q, k, v, causal: bool):
    """One block's attention partial by the flash forward (the Hopper
    kernel on CUDA, which already computes lse as the backward's
    residual): (normalized out f32, lse [b, h, s]).  The kernel takes
    contiguous tensors; anything else it refuses raises (JAX falls back
    to the einsum partial where its kernel's blocks do not tile, the port
    does not)."""
    out, lse = flash_forward(q, k, v, causal)
    return out.float(), lse[..., 0]


def _merge_partials(out, lse, out_blk, lse_blk):
    """Combine two normalized attention partials by their logsumexps."""
    new_lse = torch.logaddexp(lse, lse_blk)
    safe = _finite_or(new_lse, 0.0)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - safe),
                        torch.zeros_like(lse))
    w_new = torch.where(torch.isfinite(lse_blk), torch.exp(lse_blk - safe),
                        torch.zeros_like(lse_blk))
    return out * w_old[..., None] + out_blk * w_new[..., None], new_lse


def _merge_into(running, i, blk):
    """Merge ``blk`` into member ``i``'s running (out, lse); the first
    block is taken as it is (merging it into JAX's (0, -inf) start gives
    it back unchanged)."""
    running[i] = blk if running[i] is None else _merge_partials(
        *running[i], *blk)


def _hybrid_ring(qs, ks, vs, group, block_partial):
    """The hybrid ring's schedule: at step ``t`` member ``i`` holds the
    K/V that started at ring position ``(i - t) % n`` and merges
    ``block_partial(i, src, q, k, v)`` (None: fully masked, skipped).
    Returns each held member's (out in q's dtype, lse f32)."""
    n = group.size
    running = [None] * len(qs)
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n):
        for j, (i, q) in enumerate(zip(group.indices, qs)):
            blk = block_partial(i, (i - t) % n, q, k_cur[j], v_cur[j])
            if blk is not None:
                _merge_into(running, j, blk)
        if t < n - 1:
            k_cur, v_cur = group.shift([k_cur, v_cur])
    return [(out.to(q.dtype), lse) for (out, lse), q in zip(running, qs)]


def _ring_flash_forward(qs, ks, vs, group, causal: bool):
    def block_partial(i, src, q, k, v):
        if not causal:
            # every block fully visible: the einsum partial
            return _partial_einsum(q, k, v, False)
        if src == i:
            return _partial_flash(q, k, v, True)  # diagonal: causal
        if src < i:
            return _partial_einsum(q, k, v, False)  # fully visible
        return None  # a later shard: fully masked
    return _hybrid_ring(qs, ks, vs, group, block_partial)


def _sum_heads_to_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[b, h, sk, d] -> [b, h_kv, sk, d]: query-head groups sum onto their
    shared KV head."""
    if group == 1:
        return x
    b, h = x.shape[:2]
    return x.reshape(b, h // group, group, *x.shape[2:]).sum(dim=2)


def _bwd_block(q, k, v, g, lse, delta, mask, scale: float, group: int):
    """Flash backward math for one (q rows x k cols) block given the
    GLOBAL lse / delta slices: (dq, dk, dv) in f32.  ``mask`` is an
    optional [sq, sk] visibility mask; GQA-aware."""
    scores = _block_scores(q, k, scale)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.exp(scores - lse[..., None])
    p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
    dv = _sum_heads_to_kv(torch.einsum("bhqk,bhqd->bhkd", p, g), group)
    dp = _block_scores(g, v.float(), 1.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = _block_pv(ds, k.float())
    dk = _sum_heads_to_kv(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()),
                          group)
    return dq, dk, dv


def _ring_bwd_loop(qs, ks, vs, group, step_math, steps: Optional[int] = None):
    """The backward ring's schedule over ``steps`` steps (default: the
    group's size): K/V rotate as in the forward and each block's dK/dV
    accumulator travels with it (at step ``t`` block ``src`` and its
    accumulator sit with member ``(src + t) % n``); one more shift after
    the loop brings each accumulator home.  ``step_math(i, src, q, k, v,
    dq, dk, dv)`` adds one block's contribution to member ``i``'s dq and
    block ``src``'s dk / dv in place.  Returns the held members' (dqs,
    dks, dvs) in the inputs' dtypes."""
    steps = group.size if steps is None else steps
    n = group.size
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dk_cur = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
    dv_cur = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for v in vs]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(steps):
        for j, (i, q) in enumerate(zip(group.indices, qs)):
            step_math(i, (i - t) % n, q, k_cur[j], v_cur[j], dqs[j],
                      dk_cur[j], dv_cur[j])
        if t < steps - 1:
            k_cur, v_cur, dk_cur, dv_cur = group.shift(
                [k_cur, v_cur, dk_cur, dv_cur])
    # member i holds block (i - steps + 1)'s accumulators: send them home
    dks, dvs = group.shift([dk_cur, dv_cur], -(steps - 1))
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for dk, k in zip(dks, ks)],
            [dv.to(v.dtype) for dv, v in zip(dvs, vs)])


def _residuals(qs, ks, outs, gs):
    """Per member: g in f32 and delta = rowsum(g o out) [b, h, s] f32."""
    g32 = [g.float() for g in gs]
    delta = [(g * out.float()).sum(dim=-1) for g, out in zip(g32, outs)]
    return g32, delta, qs[0].shape[-1] ** -0.5, qs[0].shape[1] // ks[0].shape[1]


def _ring_backward(qs, ks, vs, outs, lses, gs, group, causal: bool,
                   window: Optional[int] = None):
    """The hand-scheduled contiguous ring backward from the forward's
    residuals: each block needs only the flash backward block math with
    the global lse (``p = exp(scores - lse)``), about twice the forward's
    FLOPs, where autodiff through the forward ring would replay it.  A
    causal block from a later ring position is fully masked and skipped,
    as in the forward; under a ``window`` so is a block wholly past the
    band, and the ring stops after :func:`windowed_ring_steps` steps."""
    g32, delta, scale, heads = _residuals(qs, ks, outs, gs)
    s = qs[0].shape[2]
    at = {i: j for j, i in enumerate(group.indices)}
    layout = _Contiguous(group.size, s)

    def step_math(i, src, q, k, v, dq, dk, dv):
        if causal and src > i:
            return
        mask = None
        if causal and window is not None:
            q_lo, _ = layout.bounds(i)
            _, k_hi = layout.bounds(src)
            if q_lo - k_hi >= window:
                return
            q_pos = layout.positions(i, q.device)
            k_pos = layout.positions(src, q.device)
            mask = ((q_pos[:, None] >= k_pos[None, :])
                    & ((q_pos[:, None] - k_pos[None, :]) < window))
        elif causal and src == i:
            mask = (torch.arange(s, device=q.device)[:, None]
                    >= torch.arange(s, device=q.device)[None, :])
        j = at[i]
        dq_blk, dk_blk, dv_blk = _bwd_block(q, k, v, g32[j], lses[j],
                                            delta[j], mask, scale, heads)
        dk += dk_blk
        dv += dv_blk
        dq += dq_blk

    return _ring_bwd_loop(qs, ks, vs, group, step_math,
                          _ring_steps(group, causal, layout, window))


class _RingFunction(torch.autograd.Function):
    """A ring with its hand-scheduled backward over a group, of which
    this process holds ``n`` members (one controller: all of them; over
    ranks: its own): ``apply(forward, backward, group, n, *qs, *ks,
    *vs)`` returns the held members' outputs; the forward saves their q,
    k, v, out and global lse."""

    @staticmethod
    def forward(ctx, forward, backward, group, n, *tensors):
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        results = forward(qs, ks, vs, group)
        outs = [out for out, _ in results]
        lses = [lse for _, lse in results]
        ctx.save_for_backward(*tensors, *outs, *lses)
        ctx.backward_fn, ctx.group, ctx.n = backward, group, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        gs = [torch.zeros_like(out) if g is None else g
              for g, out in zip(gs, outs)]
        dqs, dks, dvs = ctx.backward_fn(qs, ks, vs, outs, lses, gs,
                                        ctx.group)
        return (None, None, None, None, *dqs, *dks, *dvs)


def _apply_ring(forward, backward, qs, ks, vs, group) -> List[torch.Tensor]:
    # the flash kernel reads contiguous tensors (the model's projections
    # are permuted views)
    tensors = [x.contiguous() for x in (*qs, *ks, *vs)]
    return list(_RingFunction.apply(forward, backward,
                                    group_of(qs, group), len(qs), *tensors))


def ring_flash_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], devices=None,
                         causal: bool = True) -> List[torch.Tensor]:
    """The hybrid ring over contiguous shards: the flash forward on the
    diagonal step, einsum partials on fully visible steps, the
    hand-scheduled backward."""
    return _apply_ring(
        lambda q, k, v, d: _ring_flash_forward(q, k, v, d, causal),
        lambda q, k, v, o, l, g, d: _ring_backward(q, k, v, o, l, g, d,
                                                   causal),
        qs, ks, vs, devices)


# ---------------------------------------------------------------------------
# the zigzag (load-balanced) causal ring
# ---------------------------------------------------------------------------

def zigzag_permutation(seq_len: int, sp: int):
    """Global permutation placing the zigzag layout: ``perm[j]`` is the
    source position of output slot ``j`` when the permuted sequence is
    split contiguously over sp members.  Chunk order per member: (i,
    2*sp-1-i).  Returns (perm, inverse_perm) as numpy index arrays."""
    if seq_len % (2 * sp):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*sp={2 * sp}")
    c = seq_len // (2 * sp)
    chunks = []
    for i in range(sp):
        chunks.append(np.arange(i * c, (i + 1) * c))
        j = 2 * sp - 1 - i
        chunks.append(np.arange(j * c, (j + 1) * c))
    perm = np.concatenate(chunks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return perm, inv


def zigzag_shard(x: torch.Tensor, sp: int, axis: int = 2) -> torch.Tensor:
    """Permute a contiguous global sequence axis into zigzag order (before
    splitting it over sp)."""
    perm, _ = zigzag_permutation(x.shape[axis], sp)
    return torch.index_select(x, axis, torch.from_numpy(perm).to(x.device))


def zigzag_unshard(x: torch.Tensor, sp: int, axis: int = 2) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    _, inv = zigzag_permutation(x.shape[axis], sp)
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


def zigzag_to_contiguous(xs: List[torch.Tensor], devices=None,
                         axis: int = 2) -> List[torch.Tensor]:
    """:func:`zigzag_unshard` within a group: member ``j`` of zigzag
    shards ``xs`` (chunks ``j`` and ``2n-1-j`` along ``axis``) receives
    the contiguous shard ``j`` (chunks ``2j`` and ``2j+1``).  Only the
    chunks move, each once: across ranks an exchange over the group's
    line, whose backward sends each chunk's cotangent back."""
    group = group_of(xs, devices)
    n = group.size
    _check_even(xs[0].shape[axis])

    def source(j, c):
        x = 2 * j + c
        return (x, 0) if x < n else (2 * n - 1 - x, 1)

    return group.exchange_chunks(xs, axis, 2, source)


def _check_even(s_local: int) -> int:
    if s_local % 2:
        raise ValueError(f"zigzag shard length must be even, got {s_local}")
    return s_local // 2


def ring_attention_zigzag(qs: List[torch.Tensor], ks: List[torch.Tensor],
                          vs: List[torch.Tensor], devices=None,
                          causal: bool = True) -> List[torch.Tensor]:
    """The einsum ring over zigzag-ordered shards (see
    :func:`zigzag_shard`): each member's local sequence is its two chunks
    concatenated.  Non-causal callers should use :func:`ring_attention`
    (zigzag only helps causal)."""
    _check_even(qs[0].shape[2])
    if not causal:
        return ring_attention(qs, ks, vs, devices, causal=False)
    group = group_of(qs, devices)
    layout = _Zigzag(group.size, qs[0].shape[2])
    return _apply_ring(
        lambda q, k, v, g: _ring_online_softmax(q, k, v, g, True, layout),
        _zigzag_ring_backward, qs, ks, vs, group)


def _zigzag_hybrid_forward(qs, ks, vs, group):
    """The causal zigzag ring with per-quadrant static-mask partials:
    each off-diagonal step computes ONE unmasked half block ([2c x c] for
    earlier sources, [c x 2c] for later); the diagonal step runs the
    causal flash forward on the two diagonal quadrants plus one full
    einsum block.  Work per member per step is constant."""
    b, h, s_local, d = qs[0].shape
    c = _check_even(s_local)

    def block_partial(i, src, q, k, v):
        if src < i:
            # both q chunks attend k-low; k-high fully masked
            return _partial_einsum(q, k[:, :, :c], v[:, :, :c], False)
        q_hi = q[:, :, c:]
        if src > i:
            # only q-high sees anything (both k chunks); q-low masked
            out_hi, lse_hi = _partial_einsum(q_hi, k, v, False)
            zeros = torch.zeros((b, h, c, d), dtype=torch.float32,
                                device=q.device)
            neg_inf = torch.full((b, h, c), _NEG_INF, dtype=torch.float32,
                                 device=q.device)
            return (torch.cat([zeros, out_hi], dim=2),
                    torch.cat([neg_inf, lse_hi], dim=2))
        # the diagonal: q-low x k-low and q-high x k-high causal within
        # the chunk, q-high x k-low fully visible.  The kernel reads
        # contiguous quadrants
        k_lo, v_lo = k[:, :, :c], v[:, :, :c]
        out_ll, lse_ll = _partial_flash(q[:, :, :c].contiguous(),
                                        k_lo.contiguous(), v_lo.contiguous(),
                                        True)
        out_hh, lse_hh = _partial_flash(q_hi.contiguous(),
                                        k[:, :, c:].contiguous(),
                                        v[:, :, c:].contiguous(), True)
        out_hl, lse_hl = _partial_einsum(q_hi, k_lo, v_lo, False)
        out_hi, lse_hi = _merge_partials(out_hh, lse_hh, out_hl, lse_hl)
        return (torch.cat([out_ll, out_hi], dim=2),
                torch.cat([lse_ll, lse_hi], dim=2))

    return _hybrid_ring(qs, ks, vs, group, block_partial)


def _zigzag_ring_backward(qs, ks, vs, outs, lses, gs, group):
    """Quadrant-skipping backward for the zigzag layout: the forward's
    three static cases — earlier sources touch only [2c x c] (all q rows
    x k-low), later sources only [c x 2c] (q-high x all k), the diagonal
    its two causal c x c quadrants plus one full c x c."""
    g32, delta, scale, heads = _residuals(qs, ks, outs, gs)
    c = qs[0].shape[2] // 2
    diag = (torch.arange(c, device=qs[0].device)[:, None]
            >= torch.arange(c, device=qs[0].device)[None, :])
    at = {i: j for j, i in enumerate(group.indices)}

    def step_math(i, src, q, k, v, dq, dk, dv):
        j = at[i]
        g, lse, dl = g32[j], lses[j], delta[j]
        if src < i:
            dq_blk, dk_lo, dv_lo = _bwd_block(
                q, k[:, :, :c], v[:, :, :c], g, lse, dl, None, scale, heads)
            dk[:, :, :c] += dk_lo
            dv[:, :, :c] += dv_lo
            dq += dq_blk
            return
        q_hi, g_hi = q[:, :, c:], g[:, :, c:]
        lse_hi, d_hi = lse[:, :, c:], dl[:, :, c:]
        if src > i:
            dq_hi, dk_blk, dv_blk = _bwd_block(q_hi, k, v, g_hi, lse_hi, d_hi,
                                               None, scale, heads)
            dk += dk_blk
            dv += dv_blk
            dq[:, :, c:] += dq_hi
            return
        k_lo, k_hi = k[:, :, :c], k[:, :, c:]
        v_lo, v_hi = v[:, :, :c], v[:, :, c:]
        dq_ll, dk_ll, dv_ll = _bwd_block(
            q[:, :, :c], k_lo, v_lo, g[:, :, :c], lse[:, :, :c],
            dl[:, :, :c], diag.to(q.device), scale, heads)
        dq_hl, dk_hl, dv_hl = _bwd_block(q_hi, k_lo, v_lo, g_hi, lse_hi,
                                         d_hi, None, scale, heads)
        dq_hh, dk_hh, dv_hh = _bwd_block(q_hi, k_hi, v_hi, g_hi, lse_hi,
                                         d_hi, diag.to(q.device), scale,
                                         heads)
        dq += torch.cat([dq_ll, dq_hl + dq_hh], dim=2)
        dk += torch.cat([dk_ll + dk_hl, dk_hh], dim=2)
        dv += torch.cat([dv_ll + dv_hl, dv_hh], dim=2)

    return _ring_bwd_loop(qs, ks, vs, group, step_math)


def ring_flash_attention_zigzag(qs: List[torch.Tensor],
                                ks: List[torch.Tensor],
                                vs: List[torch.Tensor],
                                devices=None) -> List[torch.Tensor]:
    """The balanced causal ring with hybrid flash / einsum partials (see
    :func:`_zigzag_hybrid_forward`) over zigzag-ordered shards.  Causal
    only."""
    _check_even(qs[0].shape[2])
    return _apply_ring(_zigzag_hybrid_forward, _zigzag_ring_backward,
                       qs, ks, vs, devices)


def ring_flash_auto(mesh: Mesh) -> bool:
    """Every ring entry point's flash auto-select: the hybrid ring where
    the mesh's devices are CUDA devices (the kernel at every length,
    ``ops.attention.use_kernel_default``, in place of the JAX package's
    TPU-measured length threshold), the einsum ring elsewhere."""
    return use_kernel_default(mesh.local_devices[0])


GroupFn = Callable[..., List[torch.Tensor]]


def ring_group_fn(mesh: Mesh, layout: str = "contiguous",
                  use_flash: Optional[bool] = None,
                  window: Optional[int] = None,
                  causal: bool = True) -> GroupFn:
    """The ring every entry point runs over a sequence group,
    ``fn(qs, ks, vs, devices) -> outputs``: a window takes the contiguous
    einsum ring (:func:`resolve_windowed_ring` refuses the others),
    ``use_flash=None`` the hybrid ring on CUDA (:func:`ring_flash_auto`),
    and the layout picks the zigzag or the contiguous body.  The group
    (``fn``'s ``devices``) may be a list of devices (one controller) or
    a ``spmd.RankGroup`` (this rank's member of a group across ranks)."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and not causal:
        raise ValueError("zigzag layout only balances causal attention")
    if window is not None:
        use_flash = resolve_windowed_ring(
            window, causal=causal, zigzag=layout == "zigzag",
            use_flash=use_flash)
    if use_flash is None:
        use_flash = ring_flash_auto(mesh)
    if layout == "zigzag":
        return ring_flash_attention_zigzag if use_flash else ring_attention_zigzag
    if use_flash:
        return lambda qs, ks, vs, devices: ring_flash_attention(
            qs, ks, vs, devices, causal=causal)
    return lambda qs, ks, vs, devices: ring_attention(
        qs, ks, vs, devices, causal=causal, window=window)


# ---------------------------------------------------------------------------
# the sharded wrapper over a mesh
# ---------------------------------------------------------------------------

# calls of the zigzag wrapper (misuse visibility, see
# ring_attention_sharded): the JAX package counts traced calls; the port
# has no tracing and counts calls.  Process-cumulative by design: it
# cannot tell per-layer misuse from two models each calling once
_zigzag_wrapper_calls = 0
_zigzag_counter_lock = threading.Lock()


def zigzag_wrapper_calls() -> int:
    """How many times ring_attention_sharded(layout='zigzag') has been
    called in this process (JAX's ``zigzag_traced_calls``) — more than
    one usually means a model pays the wrapper's two global permutations
    per layer."""
    return _zigzag_wrapper_calls


def over_sequence_groups(fn: Callable, tensors, mesh: Mesh,
                         spec, seq_axis: str) -> ShardedTensor:
    """``fn(*lists, devices) -> outputs`` run on every group of the
    mesh's units that differ only on ``seq_axis`` (each list holds the
    group's local pieces of one of ``tensors`` under ``spec``, in member
    order); the outputs come back as one :class:`ShardedTensor` under
    ``spec`` — the form of a ``shard_map`` whose body runs collectives
    over ``seq_axis``.  Over a mesh of ranks ``fn`` runs this rank's
    member over its line on ``seq_axis`` (its ``devices`` a
    ``spmd.RankGroup``)."""
    units = Units.of(mesh, [spec])
    keep = {dim: _split_names(axes) for dim, axes in enumerate(spec)
            if _split_names(axes)}
    locals_ = []
    for x in tensors:
        if isinstance(x, ShardedTensor):
            x = x.gather()
        locals_.append(units.local(device_put(x, NamedSharding(mesh, spec)),
                                   keep))
    outs: List[Optional[torch.Tensor]] = [None] * len(units)
    for members, group in units.sequence_groups((seq_axis,)):
        results = fn(*[[xs[u] for u in members] for xs in locals_], group)
        for u, y in zip(members, results):
            outs[u] = y
    return units.assemble(outs, spec, tensors[0].shape)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    batch_axis: Optional[str] = "dp",
    seq_axis: str = "sp",
    head_axis: Optional[str] = "tp",
    use_flash: Optional[bool] = None,
    layout: str = "contiguous",
    window: Optional[int] = None,
) -> ShardedTensor:
    """Ring attention over a mesh: q, k, v [batch, heads, seq, head_dim]
    (tensors or ``ShardedTensor``s) with batch over ``batch_axis``, heads
    over ``head_axis`` and sequence over ``seq_axis``; returns the output
    as a :class:`ShardedTensor` under that spec.

    ``window``: sliding-window (causal) attention on the contiguous
    einsum ring.  Not composable with the hybrid ring or the zigzag
    layout; those callers get a loud error rather than full attention.

    ``use_flash=None`` auto-selects the hybrid ring on CUDA
    (:func:`ring_group_fn`).

    ``layout="zigzag"`` (causal only) runs the load-balanced ring: the
    inputs are permuted into zigzag order, split, attended with the
    balanced partials, and the output permuted back — callers see
    contiguous sequences.  Each call permutes globally twice; a
    multi-layer model should keep its activations zigzag-ordered (the
    model's ``transformer_apply_ring(layout="zigzag")`` does) and call
    the in-group entry points."""
    fn = ring_group_fn(mesh, layout, use_flash, window, causal)
    if layout == "zigzag":
        global _zigzag_wrapper_calls
        with _zigzag_counter_lock:
            _zigzag_wrapper_calls += 1
            warn = _zigzag_wrapper_calls == 2
        if warn:
            from ..utils.logger import get_logger

            get_logger("kubeshare-ops").warning(
                "ring_attention_sharded(layout='zigzag') called more than "
                "once in this process — every call permutes globally twice; "
                "a multi-layer model calling it per layer should permute "
                "once (zigzag_shard at embedding) and use the in-group ring "
                "entry points.  (Two separate models also reach this count "
                "— ignore if that is the case.)")
    spec = P(batch_axis, head_axis, seq_axis, None)
    sp = mesh.shape[seq_axis]
    if layout == "zigzag":
        q, k, v = (zigzag_shard(x.gather() if isinstance(x, ShardedTensor)
                                else x, sp) for x in (q, k, v))
    out = over_sequence_groups(fn, (q, k, v), mesh, spec, seq_axis)
    if layout == "zigzag":
        out = device_put(zigzag_unshard(out.gather(), sp),
                         NamedSharding(mesh, spec))
    return out
