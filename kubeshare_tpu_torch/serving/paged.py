"""Paged twins of the dense cached model steps, port of
kubeshare_tpu/serving/paged.py (the non-speculative entries).

``models/decoding._decode_chunk`` reads and writes a dense
[layers, batch, h_kv, max_seq, d] cache whose rows advance in lockstep
(one length for the whole batch).  Serving needs neither property: each
slot sits at its OWN length, and its cache rows live scattered across
pool blocks (kv_blocks.py).  The entry points here keep the dense step's
math — same projections, same rope, same per-query causal band through
the SAME :func:`_attend_cached` — and swap only the cache plumbing:

- :func:`paged_prefill_step`: a width-C prompt chunk writing its K/V
  straight into a slot's blocks;
- :func:`paged_decode_step`: one token for EVERY slot lane at once —
  per-lane positions, scatter-write each lane's K/V into its current
  block, gather each lane's block list into a [S, h_kv, T*bs, d] view,
  and attend under per-row causal bands;
- :func:`paged_decode_span`: ``span`` step-identical decode steps with
  the engine's token pick between them (lanes deactivate themselves on
  budget/EOS);
- :func:`paged_decode_loop`: up to K consecutive span-units in one
  program, emissions in a ring, and the loop's early exit at a span
  boundary the moment any lane deactivates (see
  :func:`_decode_loop_impl` for its graph form);
- :func:`paged_mixed_step`: one bounded prefill chunk for one filling
  slot AND a full decode span for every active lane — the two entry
  points above run back to back, so each side's math is unchanged;
- :func:`paged_verify_span`: the speculative draft-verify dispatch — one
  width-W chunk scores every lane's drafted tokens at once, picks what
  sequential decoding would emit at each position (each column under its
  own emission's seed) and counts the accepted prefix with the dense
  decoder's acceptance rule;
- :func:`paged_mixed_verify_step`: the speculative twin of the mixed
  dispatch (prefill chunk + verify span);
- :func:`paged_spec_loop`: up to K draft-verify units in one program,
  drafting on the device (``drafter.ngram_propose_rows``) and activating
  staged requests from an admission ring into retired lanes (see
  :func:`_spec_loop_impl` for its graph form).

The pool is updated IN PLACE (the JAX engine donates it; on a
fractional-HBM pod a second pool would break the cap), so the entry
points return only what they compute.  Nothing here reads the device
back: positions, tables, masks and budgets are tensors, and every loop
has a length fixed by its arguments' shapes or by Python ints, so the
serving engine captures each entry point as a CUDA graph.

Inactive lanes still execute (static shapes); their writes are routed
to the reserved scratch block 0 and their outputs ignored host-side.

"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.decoding import _attend_cached, _cached_ffn, speculative_acceptance
from ..models.transformer import TransformerConfig, _project, _rms_norm
from ..ops.rope import apply_rope
from .drafter import ngram_propose_rows

# pick_fn(logits [S, vocab] f32, temps [S] f32, seeds [S] int64) -> [S]
PickFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def paged_gather_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    block_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize one slot's virtual K/V view.

    ``pool_k``/``pool_v``: [n_layers, num_blocks, h_kv, bs, d];
    ``block_table``: [T] integer.  Returns (k, v) each
    [n_layers, h_kv, T*bs, d] — virtual position p at row p (block
    ``table[p // bs]``, offset ``p % bs``)."""
    n_layers, _, h_kv, bs, d = pool_k.shape
    t = block_table.shape[0]

    def view(pool):
        blocks = pool[:, block_table]  # [L, T, h_kv, bs, d]
        return blocks.permute(0, 2, 1, 3, 4).reshape(n_layers, h_kv, t * bs, d)

    return view(pool_k), view(pool_v)


def paged_copy_block(pool_k: torch.Tensor, pool_v: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy ONE block's rows (all layers, K and V) ``src`` -> ``dst``, in
    place — the prefix cache's copy-on-write primitive.  ``src``/``dst``
    are [1] int64 device tensors, so one captured copy serves every pair.
    All ``block_size`` rows are copied: rows past the matched prefix are
    stale, but prefill overwrites them before any causal band reaches
    them."""
    pool_k.index_copy_(1, dst, pool_k.index_select(1, src))
    pool_v.index_copy_(1, dst, pool_v.index_select(1, src))


def paged_upload_block(pool_k: torch.Tensor, pool_v: torch.Tensor,
                       dst, k_slab: torch.Tensor,
                       v_slab: torch.Tensor) -> None:
    """Write ONE block's rows (all layers, K and V) from slabs [n_layers,
    kv_heads, block_size, head_dim], in place — the KV tier's promotion
    primitive.  ``dst`` is a block id or a [1] int64 tensor on the pool's
    device; the engine's upload program passes the tensor and its slabs
    as device inputs, so one captured upload serves every block (the
    ``.to`` is then a no-op: nothing is read from host memory inside the
    graph)."""
    if not isinstance(dst, torch.Tensor):
        dst = torch.tensor([dst], dtype=torch.int64, device=pool_k.device)
    pool_k.index_copy_(1, dst, k_slab.to(pool_k.device, pool_k.dtype)[:, None])
    pool_v.index_copy_(1, dst, v_slab.to(pool_v.device, pool_v.dtype)[:, None])


def _layer_views(pk_layer: torch.Tensor, pv_layer: torch.Tensor,
                 tables: torch.Tensor, config: TransformerConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane virtual K/V views for ONE layer: pool [B, h_kv, bs, d]
    gathered through lane tables [P, T] -> [P, h_kv, T*bs, d].  The one
    view construction every paged step attends through."""
    p, t = tables.shape
    bs = pk_layer.shape[2]

    def view(pool):
        return pool[tables].permute(0, 2, 1, 3, 4).reshape(
            p, config.kv_heads, t * bs, config.head_dim)

    return view(pk_layer), view(pv_layer)


def _paged_layers(params: Dict, config: TransformerConfig,
                  pool_k: torch.Tensor, pool_v: torch.Tensor,
                  tables: torch.Tensor, positions: torch.Tensor,
                  blk: torch.Tensor, off: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The layers shared by both paged steps: tokens [P, C] at
    ``positions`` [P, C], K/V written to rows (blk, off) [P, C] of each
    layer's pool first, then attended through the lanes' views.  Returns
    the final-normed hidden states [P, C, d]."""
    dtype = config.dtype
    x = params["embed"][tokens].to(dtype)  # [P, C, d]
    use_rope = config.positional == "rope"
    if not use_rope:
        # clamped like JAX's gather: a verify pad column may sit past the
        # table (its K/V go to the scratch block, its pick is never read)
        rows = positions.clamp(max=params["pos_embed"].shape[0] - 1)
        x = x + params["pos_embed"][rows].to(dtype)
    for layer_idx, layer in enumerate(params["layers"]):
        y = _rms_norm(x, layer["norm1"]["scale"])
        q = _project(y, layer["attn"]["wq"])
        k = _project(y, layer["attn"]["wk"])
        v = _project(y, layer["attn"]["wv"])
        if use_rope:
            q = apply_rope(q, positions)  # [P, C]: per-lane positions
            k = apply_rope(k, positions)
        pk, pv = pool_k[layer_idx], pool_v[layer_idx]
        # rows (blk[p,i], :, off[p,i], :) <- k[p, :, i, :]
        pk[blk, :, off, :] = k.transpose(1, 2)
        pv[blk, :, off, :] = v.transpose(1, 2)
        view_k, view_v = _layer_views(pk, pv, tables, config)
        o = _attend_cached(q, view_k, view_v, positions,
                           window=config.attention_window).to(dtype)
        x = x + torch.einsum("bhsk,hkd->bsd", o, layer["attn"]["wo"].to(dtype))
        y = _rms_norm(x, layer["norm2"]["scale"])
        # MoE capacity pinned to the dispatch's tokens: a co-batched lane
        # cannot perturb another's outputs through expert collisions
        x = x + _cached_ffn(layer, config, y)
    return _rms_norm(x, params["final_norm"]["scale"])


def paged_prefill_step(params: Dict, config: TransformerConfig,
                       pool_k: torch.Tensor, pool_v: torch.Tensor,
                       tables: torch.Tensor, starts: torch.Tensor,
                       active: torch.Tensor, tokens: torch.Tensor,
                       last_rows: torch.Tensor) -> torch.Tensor:
    """One width-C prefill chunk for P slot lanes at once.

    ``tokens`` [P, C] are each lane's chunk at virtual positions
    ``starts[p] .. starts[p]+C-1`` against its own ``tables[p]``;
    ``last_rows`` [P] select each lane's logits row.  Returns logits
    [P, vocab] f32.  The chunk's K/V land in the blocks first, then its
    queries attend the lane's whole gathered view under the per-query
    causal band, as in the dense ``_decode_chunk``.  Only the selected
    rows' lm_head projection is computed.  Inactive lanes write to the
    scratch block."""
    chunk = tokens.shape[1]
    bs = pool_k.shape[3]
    positions = starts[:, None] + torch.arange(
        chunk, device=tokens.device)[None, :]  # [P, C]
    blk = torch.gather(tables, 1, positions // bs)
    blk = torch.where(active[:, None], blk, torch.zeros_like(blk))
    off = positions % bs
    x = _paged_layers(params, config, pool_k, pool_v, tables, positions,
                      blk, off, tokens)
    index = last_rows[:, None, None].expand(-1, 1, x.shape[-1])
    head_in = torch.gather(x, 1, index)  # [P, 1, d]
    logits = (head_in @ params["lm_head"].to(config.dtype)).to(torch.float32)
    return logits[:, 0]


def paged_decode_step(params: Dict, config: TransformerConfig,
                      pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """One decode token for every slot lane at once.

    ``tokens`` [S] (this step's input token per lane), ``lengths`` [S]
    (each lane's cache fill = this write's position), ``block_tables``
    [S, T], ``active`` [S] bool.  Returns logits [S, vocab] f32; inactive
    rows compute garbage the caller ignores — their K/V writes go to the
    scratch block, so the pool's live data is never touched."""
    bs = pool_k.shape[3]
    positions = lengths[:, None]  # [S, 1]
    blk = torch.gather(block_tables, 1, positions // bs)
    blk = torch.where(active[:, None], blk, torch.zeros_like(blk))
    off = positions % bs
    x = _paged_layers(params, config, pool_k, pool_v, block_tables,
                      positions, blk, off, tokens[:, None])
    logits = (x @ params["lm_head"].to(config.dtype)).to(torch.float32)
    return logits[:, 0]


def _span_body(step_fn, pick_fn: PickFn, eos: Optional[int],
               tables, temps, seeds, budgets, state, i: int):
    """One decode step of a span or loop: emission index ``i`` (a Python
    int) consumes ``seeds[:, i]``.  ``state`` is (lens, toks, alive);
    returns the new state and the picks [S]."""
    lens, toks, alive = state
    logits = step_fn(tables, lens, alive, toks)
    nxt = pick_fn(logits, temps, seeds[:, i])
    lens = lens + alive.to(lens.dtype)
    cont = alive & (budgets > i + 1)
    if eos is not None:
        cont = cont & (nxt != eos)
    return (lens, nxt, cont), nxt


def paged_decode_span(params: Dict, config: TransformerConfig,
                      pick_fn: PickFn, span: int, eos: Optional[int],
                      pool_k: torch.Tensor, pool_v: torch.Tensor,
                      tables: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, tokens: torch.Tensor,
                      temps: torch.Tensor, seeds: torch.Tensor,
                      budgets: torch.Tensor) -> torch.Tensor:
    """Advance every active lane up to ``span`` tokens in one program.

    Each iteration is EXACTLY :func:`paged_decode_step` plus
    ``pick_fn(logits, temps, seeds[:, i])``, so the emitted math is
    span-invariant; a lane whose request finishes mid-span (budget spent,
    or EOS) deactivates itself — its remaining iterations write to the
    scratch block and its surplus emissions are ignored host-side.
    ``seeds`` [S, span] int64.  Returns emitted [span, S] int64."""

    def step_fn(tbl, lens, alive, toks):
        return paged_decode_step(params, config, pool_k, pool_v, tbl, lens,
                                 alive, toks)

    state = (lengths, tokens, active)
    emitted = []
    for i in range(span):
        state, nxt = _span_body(step_fn, pick_fn, eos, tables, temps, seeds,
                                budgets, state, i)
        emitted.append(nxt)
    return torch.stack(emitted)


def _decode_loop_impl(step_fn, pick_fn: PickFn, span: int, k_units: int,
                      eos: Optional[int], tables: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      tokens: torch.Tensor, temps: torch.Tensor,
                      seeds: torch.Tensor, budgets: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device-resident multi-step loop, in a form a CUDA graph can
    hold: ``k_units`` span-units, each the exact span body, with the
    emission index flattened across units (unit u, step j consumes
    ``seeds[:, u*span + j]`` and checks ``u*span + j + 1 < budgets``).

    JAX's ``lax.while_loop`` exits at the first span boundary where any
    initially active lane has deactivated (budget or EOS), or where no
    lane is alive.  A graph has no data-dependent exit, so every unit is
    captured and each one starts by computing on the device
    ``go = any(alive) & ~any(active & ~alive)``, which is ANDed into every
    lane's alive mask: from the first failed ``go`` on, every lane writes
    to the scratch block, its picks are ignored, and ``units = sum(go)``
    is what the host reads.  The result equals JAX's loop; the cost is
    the idle units' compute after an exit.

    Returns (ring [k_units*span, S], units [] int64); ring rows at and
    past ``units*span`` are zeros the host never reads."""
    alive = active
    lens, toks = lengths, tokens
    units = torch.zeros((), dtype=torch.int64, device=tokens.device)
    ring = []
    for u in range(k_units):
        go = alive.any() & ~(active & ~alive).any()
        alive = alive & go
        units = units + go.to(torch.int64)
        state = (lens, toks, alive)
        for j in range(span):
            state, nxt = _span_body(step_fn, pick_fn, eos, tables, temps,
                                    seeds, budgets, state, u * span + j)
            ring.append(torch.where(go, nxt, torch.zeros_like(nxt)))
        lens, toks, alive = state
    return torch.stack(ring), units


def paged_decode_loop(params: Dict, config: TransformerConfig,
                      pick_fn: PickFn, span: int, k_units: int,
                      eos: Optional[int], pool_k: torch.Tensor,
                      pool_v: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      tokens: torch.Tensor, temps: torch.Tensor,
                      seeds: torch.Tensor, budgets: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k_units`` consecutive decode span-units in one program —
    the device-resident step loop (``EngineConfig.steps_per_launch``).

    ``seeds`` [S, k_units*span] is the flat seed window (each lane's
    schedule sliced exactly as ``k_units`` back-to-back span dispatches
    would slice it); ``budgets`` [S] the remaining emission budgets at
    launch.  Returns (ring [k_units*span, S], units []) — see
    :func:`_decode_loop_impl`."""

    def step_fn(tbl, lens, alive, toks):
        return paged_decode_step(params, config, pool_k, pool_v, tbl, lens,
                                 alive, toks)

    return _decode_loop_impl(step_fn, pick_fn, span, k_units, eos, tables,
                             lengths, active, tokens, temps, seeds, budgets)


def paged_mixed_step(params: Dict, config: TransformerConfig,
                     pick_fn: PickFn, span: int, eos: Optional[int],
                     pool_k: torch.Tensor, pool_v: torch.Tensor,
                     p_table: torch.Tensor, p_start: torch.Tensor,
                     p_tokens: torch.Tensor, p_last_row: torch.Tensor,
                     p_temp: torch.Tensor, p_seed: torch.Tensor,
                     d_tables: torch.Tensor, d_lengths: torch.Tensor,
                     d_active: torch.Tensor, d_tokens: torch.Tensor,
                     d_temps: torch.Tensor, d_seeds: torch.Tensor,
                     d_budgets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused mixed dispatch: a bounded prefill chunk for ONE filling
    slot + a full decode span for every active decode lane.

    Nothing but :func:`paged_prefill_step` on the prefill lane, then
    :func:`paged_decode_span` over the decode lanes: the prefill lane
    writes only its own (fresh or copy-on-write private) blocks and every
    decode lane only its own current block, so the streams equal the
    split dispatches'.  Returns (p_picked [1], emitted [span, S]);
    ``p_picked`` is meaningful only on the prompt's final chunk."""
    p_logits = paged_prefill_step(
        params, config, pool_k, pool_v, p_table, p_start,
        torch.ones_like(p_start, dtype=torch.bool), p_tokens, p_last_row)
    p_picked = pick_fn(p_logits, p_temp, p_seed)
    emitted = paged_decode_span(
        params, config, pick_fn, span, eos, pool_k, pool_v, d_tables,
        d_lengths, d_active, d_tokens, d_temps, d_seeds, d_budgets)
    return p_picked, emitted


def paged_verify_span(params: Dict, config: TransformerConfig,
                      pick_fn: PickFn, pool_k: torch.Tensor,
                      pool_v: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      tokens: torch.Tensor, widths: torch.Tensor,
                      temps: torch.Tensor, seeds: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every lane's drafted tokens in ONE width-W cached chunk —
    the speculative engine's draft-verify dispatch.

    ``tokens`` [S, W] holds, per lane, its last emitted token at column 0
    and up to W-1 drafted tokens; ``widths`` [S] counts each lane's real
    columns (pad columns hold -1, so they can never be accepted).  Column
    i sits at position ``lengths[s] + i``; the chunk's K/V land in the
    lane's blocks first (pad and inactive-lane columns go to the scratch
    block), then every column attends the lane's view under the
    per-query causal band, as in :func:`paged_prefill_step`, with the
    lm_head at every column.  ``picked`` [S, W] is what sequential
    decoding would emit at each position: column i is picked under
    ``seeds[:, i]``, the seed of that emission.  ``accepts`` [S] counts
    the leading drafted tokens the picks agree with
    (``models.decoding.speculative_acceptance``, on the raw tokens: the
    -1 sentinel is clamped for the embedding gather only).  Columns past
    the accepted prefix leave K/V at positions the rewound length masks;
    the next dispatch overwrites them before any band reaches them.
    Returns (picked [S, W], accepts [S])."""
    s, w = tokens.shape
    bs = pool_k.shape[3]
    col = torch.arange(w, device=tokens.device)[None, :]
    positions = lengths[:, None] + col  # [S, W]
    valid = active[:, None] & (col < widths[:, None])
    blk = torch.gather(tables, 1,
                       (positions // bs).clamp(max=tables.shape[1] - 1))
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    off = positions % bs
    x = _paged_layers(params, config, pool_k, pool_v, tables, positions,
                      blk, off, tokens.clamp(min=0))
    logits = (x @ params["lm_head"].to(config.dtype)).to(torch.float32)
    # column i consumes the seed of its own emission: one pick over the
    # flattened [S*W] rows is the per-column pick, row for row
    picked = pick_fn(logits.reshape(s * w, -1),
                     temps.repeat_interleave(w), seeds.reshape(s * w))
    picked = picked.reshape(s, w)
    return picked, speculative_acceptance(tokens[:, 1:], picked)


def paged_mixed_verify_step(params: Dict, config: TransformerConfig,
                            pick_fn: PickFn, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, p_table: torch.Tensor,
                            p_start: torch.Tensor, p_tokens: torch.Tensor,
                            p_last_row: torch.Tensor, p_temp: torch.Tensor,
                            p_seed: torch.Tensor, d_tables: torch.Tensor,
                            d_lengths: torch.Tensor, d_active: torch.Tensor,
                            d_tokens: torch.Tensor, d_widths: torch.Tensor,
                            d_temps: torch.Tensor, d_seeds: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The speculative twin of :func:`paged_mixed_step`: a bounded
    prefill chunk for ONE filling slot, then a verify chunk for every
    decode lane, in one program over disjoint writable blocks.  Returns
    (p_picked [1], picked [S, W], accepts [S])."""
    p_logits = paged_prefill_step(
        params, config, pool_k, pool_v, p_table, p_start,
        torch.ones_like(p_start, dtype=torch.bool), p_tokens, p_last_row)
    p_picked = pick_fn(p_logits, p_temp, p_seed)
    picked, accepts = paged_verify_span(
        params, config, pick_fn, pool_k, pool_v, d_tables, d_lengths,
        d_active, d_tokens, d_widths, d_temps, d_seeds)
    return p_picked, picked, accepts


def _rows_where(mask: torch.Tensor, new: torch.Tensor,
                cur: torch.Tensor) -> torch.Tensor:
    """``new`` where the lane mask [S] is set, else ``cur``."""
    return torch.where(mask.view(-1, *([1] * (cur.ndim - 1))), new, cur)


def _spec_loop_impl(verify_fn, k_units: int, eos: Optional[int],
                    max_order: int, redraft: float, width: int,
                    tables: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor, tokens: torch.Tensor,
                    temps: torch.Tensor, seeds: torch.Tensor,
                    budgets: torch.Tensor, hist: torch.Tensor,
                    hist_len: torch.Tensor, draft_caps: torch.Tensor,
                    ring_tables: torch.Tensor, ring_lengths: torch.Tensor,
                    ring_tokens: torch.Tensor, ring_temps: torch.Tensor,
                    ring_seeds: torch.Tensor, ring_budgets: torch.Tensor,
                    ring_hist: torch.Tensor, ring_hist_len: torch.Tensor,
                    ring_caps: torch.Tensor, ring_count: torch.Tensor):
    """The speculative device loop in a form a CUDA graph can hold:
    ``k_units`` verify-units, each drafting on the device
    (:func:`~.drafter.ngram_propose_rows` over the right-aligned history
    windows ``hist``), verifying at width W through ``verify_fn(tables,
    lengths, alive, tokens, widths, temps, seeds) -> (picked, accepts)``,
    and advancing every lane by its accepted prefix plus the correction
    pick.  Column i of a lane consumes the seed of emission ``done + i``
    (``done`` counting the lane's in-loop emissions), so a rejected
    column's seed is consumed again at the same emission next unit, as
    the host verify path does: draft content moves only the acceptance
    rate.

    JAX's ``lax.while_loop`` checks its condition after each unit's body
    (ring activations included).  A graph has no data-dependent exit, so
    every unit is recorded and each one first computes on the device
    ``go = any(alive) & ~any(occ & ~alive) & ~rd`` from the previous
    unit's state (``occ`` = the lanes occupied at launch, ``rd`` its
    re-draft flag: aggregate acceptance below ``redraft``, or nothing
    drafted) and ANDs it into ``alive``.  From the first failed ``go``
    on, no lane is alive: every verify column carries -1 and writes to
    the scratch block, no ring entry is activated, ``head`` stays, and
    the unit's outputs are zeros.  ``units = sum(go)``.

    The admission ring ``ring_*`` [R, ...] carries up to R staged lanes
    (prefilled, first token picked, seeds sliced) in admission order,
    ``ring_count`` of them real.  When an occupied lane retires at a unit
    boundary, the next entry is activated into it, in ascending lane
    order (vectorised: the k-th retired lane takes entry ``head + k``).

    Returns (picked [K, S, W], accepted [K, S], drafted [K, S], units [],
    head []); ``accepted`` is already clamped to ``drafted``.  The host
    replays emissions, retirements and activations from these alone."""
    device = tokens.device
    h = hist.shape[1]
    ring_size = ring_tables.shape[0]
    col = torch.arange(width, device=device)[None, :]
    hcol = torch.arange(h, device=device)[None, :]
    tbl, lens, alive, toks, tmp = tables, lengths, active, tokens, temps
    kbuf, rem, hst, hlen, dcap = seeds, budgets, hist, hist_len, draft_caps
    occ = active
    done = torch.zeros_like(lengths)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    units, head = zero, zero
    rd = torch.zeros((), dtype=torch.bool, device=device)
    out_p, out_a, out_d = [], [], []
    for _ in range(k_units):
        go = alive.any() & ~(occ & ~alive).any() & ~rd
        alive = alive & go
        units = units + go.to(torch.int64)

        # draft: the per-lane width is data (cap, budget), never a shape
        cap = torch.minimum(dcap, rem - 1).clamp(0, width - 1)
        cap = torch.where(alive, cap, torch.zeros_like(cap))
        draft, n_draft = ngram_propose_rows(hst, hlen, cap, max_order,
                                            width - 1)
        # verify: column 0 the lane's last emitted token, then the
        # proposal, -1 past it and on every dead lane
        ver = torch.cat([toks[:, None], draft], dim=1)
        ver = torch.where(alive[:, None], ver, torch.full_like(ver, -1))
        kidx = (done[:, None] + col).clamp(0, kbuf.shape[1] - 1)
        picked, accepts = verify_fn(tbl, lens, alive, ver, 1 + n_draft, tmp,
                                    torch.gather(kbuf, 1, kidx))

        # the emission arithmetic (the host replays exactly this)
        m = torch.minimum(accepts, n_draft)
        emit = torch.minimum(m + 1, rem)
        if eos is not None:
            is_eos = (picked == eos) & (col < emit[:, None])
            first_eos = torch.where(is_eos, col, torch.full_like(
                is_eos, width, dtype=col.dtype)).amin(dim=1)
            emit = torch.minimum(emit, first_eos + 1)
            eos_hit = first_eos < width
        else:
            eos_hit = torch.zeros_like(alive)
        emit = torch.where(alive, emit, torch.zeros_like(emit))
        eos_hit = eos_hit & alive
        out_p.append(torch.where(go, picked, torch.zeros_like(picked)))
        out_a.append(torch.where(alive, m, torch.zeros_like(m)))
        out_d.append(torch.where(alive, n_draft, torch.zeros_like(n_draft)))

        # the re-draft flag, on the lanes as they entered the unit
        drafting = alive & (n_draft > 0)
        round_m = torch.where(drafting, m, torch.zeros_like(m)).sum()
        round_n = torch.where(drafting, n_draft, torch.zeros_like(m)).sum()
        rd = ((round_m.to(torch.float32)
               < redraft * round_n.to(torch.float32)) | ~drafting.any())

        # advance lane state by the emitted prefix
        lens = lens + emit
        last = torch.gather(picked, 1,
                            (emit - 1).clamp(0, width - 1)[:, None])[:, 0]
        toks = torch.where(emit > 0, last, toks)
        rem = rem - emit
        done = done + emit
        hst = torch.gather(torch.cat([hst, picked], dim=1), 1,
                           emit[:, None] + hcol)
        hlen = torch.minimum(hlen + emit, torch.full_like(hlen, h))
        alive = alive & (rem > 0) & ~eos_hit

        if ring_size > 0:
            # activate staged lanes into retired ones, ascending lanes
            cand = occ & ~alive & go
            entry = head + torch.cumsum(cand.to(torch.int64), dim=0) - 1
            can = cand & (entry < ring_count)
            sel = entry.clamp(0, ring_size - 1)
            tbl = _rows_where(can, ring_tables[sel], tbl)
            lens = _rows_where(can, ring_lengths[sel], lens)
            toks = _rows_where(can, ring_tokens[sel], toks)
            tmp = _rows_where(can, ring_temps[sel], tmp)
            kbuf = _rows_where(can, ring_seeds[sel], kbuf)
            rem = _rows_where(can, ring_budgets[sel], rem)
            done = torch.where(can, torch.zeros_like(done), done)
            hst = _rows_where(can, ring_hist[sel], hst)
            hlen = _rows_where(can, ring_hist_len[sel], hlen)
            dcap = _rows_where(can, ring_caps[sel], dcap)
            alive = alive | can
            head = head + can.to(torch.int64).sum()
    return (torch.stack(out_p), torch.stack(out_a), torch.stack(out_d),
            units, head)


def paged_spec_loop(params: Dict, config: TransformerConfig,
                    pick_fn: PickFn, k_units: int, eos: Optional[int],
                    max_order: int, redraft: float, width: int,
                    pool_k: torch.Tensor, pool_v: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor,
                    active: torch.Tensor, tokens: torch.Tensor,
                    temps: torch.Tensor, seeds: torch.Tensor,
                    budgets: torch.Tensor, hist: torch.Tensor,
                    hist_len: torch.Tensor, draft_caps: torch.Tensor,
                    ring_tables: torch.Tensor, ring_lengths: torch.Tensor,
                    ring_tokens: torch.Tensor, ring_temps: torch.Tensor,
                    ring_seeds: torch.Tensor, ring_budgets: torch.Tensor,
                    ring_hist: torch.Tensor, ring_hist_len: torch.Tensor,
                    ring_caps: torch.Tensor, ring_count: torch.Tensor):
    """Up to ``k_units`` consecutive draft-verify units in one program —
    the speculative device loop (``EngineConfig.steps_per_launch`` with
    ``speculative``).

    ``seeds`` [S, k_units*width] is each lane's flat seed window from its
    NEXT emission; ``budgets`` [S] the remaining emission budgets at
    launch; ``hist``/``hist_len`` the right-aligned device drafting
    windows; ``draft_caps`` [S] the per-lane adaptive draft widths
    (data, not shape); ``ring_*`` the staged admissions.  Returns
    (picked [K, S, W], accepted [K, S], drafted [K, S], units [],
    head []) — see :func:`_spec_loop_impl`."""

    def verify_fn(tbl, lens, alive, toks, widths, tmp, useeds):
        return paged_verify_span(params, config, pick_fn, pool_k, pool_v,
                                 tbl, lens, alive, toks, widths, tmp, useeds)

    return _spec_loop_impl(
        verify_fn, k_units, eos, max_order, redraft, width, tables, lengths,
        active, tokens, temps, seeds, budgets, hist, hist_len, draft_caps,
        ring_tables, ring_lengths, ring_tokens, ring_temps, ring_seeds,
        ring_budgets, ring_hist, ring_hist_len, ring_caps, ring_count)
