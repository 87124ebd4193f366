"""Tensor-parallel twins of the paged serving dispatches, port of
kubeshare_tpu/serving/sharded.py.

The serving engine (engine.py) executes a single-device model; this
module is the gate to models that don't fit one device.  A
:class:`ShardedServingContext` stands up a serving mesh (``tp`` axis,
``parallel/mesh.py``'s :class:`MeshSpec` reused), shards the transformer
params Megatron-style (column splits for the QKV projections / MLP
``w_in`` / ``lm_head``, row splits for ``wo`` / ``w_out``), head-shards
the paged KV pool over its KV-head axis, and gives every paged entry
point (``paged.py``) a twin that runs one local body per shard, the
collectives between them inside the same dispatch — so on the card each
dispatch is still ONE captured graph, and the dispatch count the engine
already amortizes (spans, fused mixed steps) does not grow with the
device count.

ONE CONTROLLER.  The JAX module runs one host loop and one ``shard_map``
program over a mesh of local devices.  The port keeps that shape: one
process drives every shard of a group, there is one host loop and one
device loop, and the collectives are plain functions over the lists of
shards (``parallel/spmd.py``'s ``all_gather`` and ``all_to_all``, and a
slice of the shard's own index for ``axis_index``).  They concatenate,
slice and copy between the group's devices, and never add: the
training half's ``psum`` (partial sums, as JAX's training step runs
them) is not used here.  A group may name one
device more than once (``[cuda:0] * tp``): its shards' bodies are then
enqueued on that device's one stream, in turn.

BIT-EXACTNESS INVARIANT — collectives move data; no collective ever
carries a partial sum.  The textbook Megatron construction psums the
row-parallel partial products (``wo``, ``w_out``), which changes the
floating-point reduction order and drifts streams by ~1e-6 per layer —
unacceptable here, where every engine property (prefix cache,
preemption-resume, speculation, disagg migration) is locked by
bit-exact stream comparisons.  Instead:

- column-parallel compute is genuinely sharded: QKV projections,
  per-head attention over the local KV-head shard, the MLP's
  ``w_in``/gelu half, and the lm_head's vocab columns — products whose
  contraction axis is UNSHARDED, so a weight-column subset yields an
  exact slice of the full result;
- before every contraction over a previously-sharded axis, the
  activations AND the row-sharded weight are gathered (pure data
  movement), and the contraction runs in single-device operation order
  on every shard, redundantly but exactly.

Streams from a sharded engine are therefore BIT-IDENTICAL to the
single-device engine — greedy and sampled, GQA/windowed/MoE — wherever
the backend computes a product's output elements in the same order
whatever the product's width or batch: the CPU (tests/test_torch_sharded.py
locks it) and the card at bf16.  At f32 cuBLAS computes a batch of ONE
matrix (a one-lane prefill on a shard of one KV head) with other last
bits than the same matrix in a larger batch.

Sharding decision (:func:`plan_sharding`), per config x tp:

- ``kv_heads % tp == 0`` (and >= tp): attention head-sharded — each
  shard owns ``kv_heads/tp`` KV heads and their GQA query-head groups,
  and the pool's KV-head axis is sharded so a head group's cache rows
  live on their owning device;
- ``kv_heads < tp`` (e.g. MQA on a 4-way mesh): attention falls back to
  REPLICATED KV — splitting query heads across devices would break the
  GQA grouping, so attention computes redundantly on every shard while
  the MLP halves stay sharded;
- ``kv_heads >= tp`` but not divisible: loud :class:`ValueError` — a
  silently unbalanced head split is a debugging trap;
- MoE expert weights stay replicated: expert-parallel dispatch psums
  partial outputs, which breaks the no-partial-sums invariant.

LONG-CONTEXT ROUTING (``long_context_threshold``): a prefill chunk at or
past the threshold re-shards Ulysses-style inside the dispatch — an
all-to-all swaps the head shard for a sequence shard (all heads, ``C/tp``
query rows per shard), the KV view is gathered, and each shard attends
its query rows only.  Every step is data movement or per-query-row math,
so the route is bit-exact with the head-sharded path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.decoding import (_attend_cached, _cached_ffn,
                               speculative_acceptance)
from ..models.transformer import TransformerConfig, _project, _rms_norm
from ..ops.rope import apply_rope
from ..parallel.mesh import (Mesh, MeshSpec, P, PartitionSpec, ShardedTensor,
                             _visible_cuda_devices, make_mesh, shard_params,
                             shard_tensor)
from ..parallel.spmd import all_gather as _all_gather
from ..parallel.spmd import all_to_all as _all_to_all
from .paged import (_decode_loop_impl, _span_body, _spec_loop_impl,
                    paged_copy_block, paged_upload_block)

# the paged pool is [n_layers, num_blocks, kv_heads, block_size, head_dim];
# head-sharding splits axis 2, so every block's rows for a shard's KV
# heads are shard-local (writes and gathers never cross devices)
KV_POOL_SPEC = P(None, None, "tp", None, None)


@dataclass(frozen=True)
class ShardDecision:
    """How one (config, tp) pair shards — the module docstring's policy
    made explicit, so tests and the smoke script can print it."""

    tp: int
    attn_sharded: bool   # heads + KV pool split; False = replicated-KV
    mlp_sharded: bool    # dense mlp w_in/w_out split (MoE always repl.)
    lm_head_sharded: bool  # vocab columns split


def plan_sharding(config: TransformerConfig, tp: int) -> ShardDecision:
    """Decide the sharding layout for ``config`` on a ``tp``-way mesh;
    degenerate splits fail loudly, GQA-narrow configs fall back."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    h_kv = config.kv_heads
    if h_kv < tp:
        attn = False
    elif h_kv % tp != 0:
        raise ValueError(
            f"num_kv_heads {h_kv} is not divisible by tp={tp} — an "
            f"unbalanced KV-head split cannot be represented; use a tp "
            f"that divides the KV heads (tp > kv_heads selects the "
            f"replicated-KV fallback instead)")
    else:
        attn = True
    if attn and config.n_heads % tp != 0:
        raise ValueError(
            f"n_heads {config.n_heads} is not divisible by tp={tp}")
    if config.d_ff % tp != 0:
        raise ValueError(
            f"d_ff {config.d_ff} is not divisible by tp={tp} — the MLP "
            f"hidden split would be unbalanced")
    return ShardDecision(
        tp=tp,
        attn_sharded=attn,
        mlp_sharded=True,
        # an uneven vocab split replicates the lm_head: redundant FLOPs,
        # never a wrong answer
        lm_head_sharded=config.vocab_size % tp == 0,
    )


def serving_sharding_rules(decision: ShardDecision) -> Dict[str, PartitionSpec]:
    """Path-substring -> PartitionSpec rules for the serving mesh: embed
    and norms replicate (every shard embeds the chunk), MoE experts
    replicate (see the module docstring), and the row-parallel weights
    (``wo``/``w_out``) are STORED sharded but gathered inside the step
    before their contraction."""
    rules: Dict[str, PartitionSpec] = {}
    if decision.attn_sharded:
        rules.update({
            "wq": P(None, "tp", None),
            "wk": P(None, "tp", None),
            "wv": P(None, "tp", None),
            "wo": P("tp", None, None),
        })
    if decision.mlp_sharded:
        rules.update({
            "w_in": P(None, "tp"),
            "w_out": P("tp", None),
            # longest-needle-first matching keeps MoE expert stacks off
            # the dense mlp rules
            "moe']['w_in": P(),
            "moe']['w_out": P(),
        })
    if decision.lm_head_sharded:
        rules["lm_head"] = P(None, "tp")
    return rules


# ---------------------------------------------------------------------------
# the collectives: data movement between the shards' devices, never a sum
# (all_gather and all_to_all live in parallel/spmd.py with the training
# half's psum, which serving never calls)
# ---------------------------------------------------------------------------

def _replicate(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """A replicated input on every shard's device (no copy where the
    shard shares the input's device)."""
    return [x.to(d, non_blocking=True) for d in devices]


@dataclass(frozen=True)
class _Group:
    """What every local body reads: the shards' param trees and devices
    (one entry a shard, mesh order), the config, the decision and the
    long-context threshold."""

    params: List[Dict]
    devices: List[torch.device]
    config: TransformerConfig
    decision: ShardDecision
    lct: Optional[int]


# ---------------------------------------------------------------------------
# local (per-shard) bodies — the math paged.py runs, on each shard
# ---------------------------------------------------------------------------

def _local_views(pk_layer, pv_layer, tables, head_dim: int):
    """paged._layer_views on a LOCAL pool shard: the head axis is the
    shard's own (``pool.shape[1]``), not ``config.kv_heads`` — under the
    replicated fallback they coincide."""
    p, t = tables.shape
    h_local, bs = pk_layer.shape[1], pk_layer.shape[2]

    def view(pool):
        return pool[tables].permute(0, 2, 1, 3, 4).reshape(
            p, h_local, t * bs, head_dim)

    return view(pk_layer), view(pv_layer)


def _chunk_attend(g: _Group, qs, pks, pvs, tables, positions):
    """One layer's attention for a [P, C] chunk, shard by shard.

    Head-sharded: each q carries its shard's query-head group, its views
    the shard's KV heads — per-head attention is independent, so each
    local output is an exact slice of the full one.  Past the
    long-context threshold, the Ulysses re-shard swaps heads for
    sequence: all-to-all q to [P, H, C/tp, d], gather the KV views,
    attend this shard's query rows, and swap back."""
    cfg, dec = g.config, g.decision
    views = [_local_views(pk, pv, t, cfg.head_dim)
             for pk, pv, t in zip(pks, pvs, tables)]
    c = qs[0].shape[2]
    if (dec.attn_sharded and g.lct is not None and c >= g.lct
            and c % dec.tp == 0):
        q_s = _all_to_all(qs, 2, 1, g.devices)
        vk = _all_gather([k for k, _ in views], 1, g.devices)
        vv = _all_gather([v for _, v in views], 1, g.devices)
        shard = c // dec.tp
        o_s = [_attend_cached(q_s[i], vk[i], vv[i],
                              positions[i][:, i * shard:(i + 1) * shard],
                              window=cfg.attention_window).to(cfg.dtype)
               for i in range(dec.tp)]
        return _all_to_all(o_s, 1, 2, g.devices)
    return [_attend_cached(q, k, v, pos, window=cfg.attention_window
                           ).to(cfg.dtype)
            for q, (k, v), pos in zip(qs, views, positions)]


def _ffn(g: _Group, layer_idx: int, ys):
    """Post-attention feed-forward: dense MLP sharded (w_in columns
    local, hidden + row weight gathered before the second product), MoE
    layers replicated through the cached paths' ``_cached_ffn``."""
    layers = [w["layers"][layer_idx] for w in g.params]
    if "moe" in layers[0] or not g.decision.mlp_sharded:
        return [_cached_ffn(layer, g.config, y) for layer, y in zip(layers, ys)]
    hid = [F.gelu(y @ layer["mlp"]["w_in"].to(y.dtype), approximate="tanh")
           for layer, y in zip(layers, ys)]
    hid = _all_gather(hid, 2, g.devices)
    w_out = _all_gather([layer["mlp"]["w_out"].to(y.dtype)
                         for layer, y in zip(layers, ys)], 0, g.devices)
    return [h @ w for h, w in zip(hid, w_out)]


def _chunk_stack(g: _Group, pool_k: ShardedTensor, pool_v: ShardedTensor,
                 tables, positions, blk, off, tokens) -> List[torch.Tensor]:
    """The full layer stack for a [P, C] chunk against each lane's paged
    view — the ONE local body behind every sharded twin, paged's
    ``_paged_layers`` shard by shard: K/V written to rows (blk, off) of
    each shard's pool first, then attended.  Returns each shard's
    final-normed hidden states [P, C, d] (equal on every shard)."""
    cfg, dec, dtype = g.config, g.decision, g.config.dtype
    tables, positions, blk, off, tokens = (
        _replicate(x, g.devices) for x in (tables, positions, blk, off,
                                           tokens))
    use_rope = cfg.positional == "rope"
    xs = []
    for w, pos, tok in zip(g.params, positions, tokens):
        x = w["embed"][tok].to(dtype)
        if not use_rope:
            rows = pos.clamp(max=w["pos_embed"].shape[0] - 1)
            x = x + w["pos_embed"][rows].to(dtype)
        xs.append(x)
    for layer_idx in range(cfg.n_layers):
        qs, pks, pvs = [], [], []
        for i, w in enumerate(g.params):
            layer = w["layers"][layer_idx]
            y = _rms_norm(xs[i], layer["norm1"]["scale"])
            # column-parallel: sharded weights project the LOCAL heads
            q = _project(y, layer["attn"]["wq"])
            k = _project(y, layer["attn"]["wk"])
            v = _project(y, layer["attn"]["wv"])
            if use_rope:
                q = apply_rope(q, positions[i])
                k = apply_rope(k, positions[i])
            # local KV heads land in the local pool shard (no collective)
            pk = pool_k.shards[i][layer_idx]
            pv = pool_v.shards[i][layer_idx]
            pk[blk[i], :, off[i], :] = k.transpose(1, 2)
            pv[blk[i], :, off[i], :] = v.transpose(1, 2)
            qs.append(q)
            pks.append(pk)
            pvs.append(pv)
        outs = _chunk_attend(g, qs, pks, pvs, tables, positions)
        wos = [w["layers"][layer_idx]["attn"]["wo"].to(dtype)
               for w in g.params]
        if dec.attn_sharded:
            # gather the head-sharded activations AND the row-sharded
            # weight, then contract in single-device order (no psum)
            outs = _all_gather(outs, 1, g.devices)
            wos = _all_gather(wos, 0, g.devices)
        ys = []
        for i, w in enumerate(g.params):
            xs[i] = xs[i] + torch.einsum("bhsk,hkd->bsd", outs[i], wos[i])
            ys.append(_rms_norm(xs[i], w["layers"][layer_idx]["norm2"]["scale"]))
        for i, out in enumerate(_ffn(g, layer_idx, ys)):
            xs[i] = xs[i] + out
    return [_rms_norm(x, w["final_norm"]["scale"])
            for x, w in zip(xs, g.params)]


def _project_rows(g: _Group, xs) -> torch.Tensor:
    """lm_head over [P, R, d] rows: each shard's vocab columns, gathered
    in f32 on the lead device, where the controller picks (column
    subsets are exact slices — the contraction is over unsharded
    d_model)."""
    logits = [(x @ w["lm_head"].to(g.config.dtype)).to(torch.float32)
              for x, w in zip(xs, g.params)]
    if g.decision.lm_head_sharded:
        return torch.cat([x.to(g.devices[0], non_blocking=True)
                          for x in logits], dim=-1)
    return logits[0]


def _local_prefill(g: _Group, pool_k, pool_v, tables, starts, active, tokens,
                   last_rows) -> torch.Tensor:
    """paged_prefill_step's sharded body -> logits [P, vocab] f32."""
    chunk = tokens.shape[1]
    bs = pool_k.shape[3]
    positions = starts[:, None] + torch.arange(
        chunk, device=tokens.device)[None, :]
    blk = torch.gather(tables, 1, positions // bs)
    blk = torch.where(active[:, None], blk, torch.zeros_like(blk))
    off = positions % bs
    xs = _chunk_stack(g, pool_k, pool_v, tables, positions, blk, off, tokens)
    index = last_rows[:, None, None].expand(-1, 1, g.config.d_model)
    head_in = [torch.gather(x, 1, index.to(x.device)) for x in xs]
    return _project_rows(g, head_in)[:, 0]


def _local_decode_step(g: _Group, pool_k, pool_v, tables, lengths, active,
                       tokens) -> torch.Tensor:
    """paged_decode_step as the C=1 chunk -> logits [S, vocab] f32."""
    bs = pool_k.shape[3]
    positions = lengths[:, None]
    blk = torch.gather(tables, 1, positions // bs)
    blk = torch.where(active[:, None], blk, torch.zeros_like(blk))
    off = positions % bs
    xs = _chunk_stack(g, pool_k, pool_v, tables, positions, blk, off,
                      tokens[:, None])
    return _project_rows(g, xs)[:, 0]


def _local_decode_span(g: _Group, pick_fn, span: int, eos, pool_k, pool_v,
                       tables, lengths, active, tokens, temps, seeds,
                       budgets) -> torch.Tensor:
    """paged_decode_span over the sharded step: one span loop, the
    controller's, picking on the gathered logits -> emitted [span, S]."""

    def step_fn(tbl, lens, alive, toks):
        return _local_decode_step(g, pool_k, pool_v, tbl, lens, alive, toks)

    state = (lengths, tokens, active)
    emitted = []
    for i in range(span):
        state, nxt = _span_body(step_fn, pick_fn, eos, tables, temps, seeds,
                                budgets, state, i)
        emitted.append(nxt)
    return torch.stack(emitted)


def _local_verify_span(g: _Group, pick_fn, pool_k, pool_v, tables, lengths,
                       active, tokens, widths, temps, seeds):
    """paged_verify_span's sharded body: width-W chunk, per-column picks
    on the gathered logits, the dense acceptance rule -> (picked [S, W],
    accepts [S])."""
    s, w = tokens.shape
    bs = pool_k.shape[3]
    col = torch.arange(w, device=tokens.device)[None, :]
    positions = lengths[:, None] + col
    valid = active[:, None] & (col < widths[:, None])
    blk = torch.gather(tables, 1,
                       (positions // bs).clamp(max=tables.shape[1] - 1))
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    off = positions % bs
    xs = _chunk_stack(g, pool_k, pool_v, tables, positions, blk, off,
                      tokens.clamp(min=0))
    logits = _project_rows(g, xs)
    picked = pick_fn(logits.reshape(s * w, -1),
                     temps.repeat_interleave(w), seeds.reshape(s * w))
    picked = picked.reshape(s, w)
    return picked, speculative_acceptance(tokens[:, 1:], picked)


# ---------------------------------------------------------------------------
# the context: mesh + placement + the twins of every entry point
# ---------------------------------------------------------------------------

def carve_replica_groups(mesh_spec: MeshSpec, devices=None) -> List[list]:
    """Resolve a ``dp > 1`` serving :class:`MeshSpec` into per-replica
    tp device groups — the fleet's side of the dp axis.

    A single engine never runs dp (slots are its batch axis); instead
    the fleet (serving/fleet.py) stands up ``dp`` engines and hands
    replica ``i`` the contiguous device slice ``[i*tp, (i+1)*tp)``.
    Each group then backs either a plain engine pinned to its one device
    (tp=1) or a tensor-parallel engine over exactly that group.
    ``dp=-1`` fills: as many replicas as the device count covers.  Pure
    list slicing, so validation runs on any list (tests pass strings).
    ``devices=None`` takes every visible CUDA device, and raises when
    there is none — a carve never falls back to the CPU."""
    if mesh_spec.ep != 1 or mesh_spec.sp != 1:
        raise ValueError(
            f"carve_replica_groups carves dp x tp only: mesh_spec must "
            f"have ep=sp=1, got {mesh_spec}")
    tp = mesh_spec.tp
    if tp < 1:
        raise ValueError(
            f"carve_replica_groups needs an explicit tp >= 1 (the "
            f"per-replica mesh width cannot be inferred), got tp={tp}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "carve_replica_groups: no CUDA device is available; pass "
                "the devices to carve explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    avail = list(devices)
    dp = mesh_spec.dp
    if dp == -1:
        dp = len(avail) // tp
        if dp < 1:
            raise ValueError(
                f"mesh_spec {mesh_spec} fills dp from {len(avail)} "
                f"device(s) but tp={tp} does not fit even once")
    elif dp < 1:
        raise ValueError(
            f"dp must be >= 1 or -1 (fill), got dp={dp}")
    need = dp * tp
    if len(avail) < need:
        raise ValueError(
            f"mesh_spec {mesh_spec} needs {need} devices "
            f"({dp} replicas x tp={tp}), only {len(avail)} available")
    return [avail[i * tp: (i + 1) * tp] for i in range(dp)]


class ShardedServingContext:
    """Everything the engine needs to run its dispatches tensor-parallel.

    Built from :class:`EngineConfig.mesh_spec`; owns the mesh, the
    :class:`ShardDecision`, parameter placement, the pool's sharding,
    and one twin per paged entry point, each with the paged function's
    signature less ``(params, config)``.  The engine swaps ONLY its step
    closures — scheduler, allocator, prefix trie, tiering, and migration
    are untouched (host reads of the sharded pool gather, through
    :meth:`ShardedTensor.index_select`; promotions and migration unpacks
    re-scatter through :meth:`upload_block`)."""

    def __init__(
        self,
        config: TransformerConfig,
        mesh_spec: MeshSpec,
        params,
        *,
        long_context_threshold: Optional[int] = None,
        devices=None,
    ) -> None:
        if mesh_spec.dp != 1 or mesh_spec.ep != 1 or mesh_spec.sp != 1:
            raise ValueError(
                f"a SINGLE engine shards tensor-parallel only: "
                f"mesh_spec must have dp=ep=sp=1 (slots are the batch "
                f"axis inside one engine), got {mesh_spec} — dp > 1 is "
                f"the replica axis: hand this spec to "
                f"serving/fleet.ReplicaFleet, which carves it into "
                f"per-replica tp device groups via "
                f"carve_replica_groups and runs one engine per group")
        if (long_context_threshold is not None
                and long_context_threshold < 1):
            raise ValueError(
                f"long_context_threshold must be >= 1 or None, got "
                f"{long_context_threshold}")
        self.config = config
        self.tp = mesh_spec.tp
        if devices is None:
            avail = _visible_cuda_devices()
            if len(avail) < self.tp:
                raise ValueError(
                    f"mesh_spec tp={self.tp} needs {self.tp} devices, "
                    f"only {len(avail)} available")
            devices = avail[: self.tp]
        self.mesh: Mesh = make_mesh(mesh_spec, devices=devices)
        self.devices: List[torch.device] = list(self.mesh.devices.flat)
        self.decision = plan_sharding(config, self.tp)
        self.lct = long_context_threshold
        self.rules = serving_sharding_rules(self.decision)
        self.kv_spec = (KV_POOL_SPEC if self.decision.attn_sharded
                        else P())
        self._n_moe = sum(1 for layer in params["layers"] if "moe" in layer)
        self._group: Optional[_Group] = None

    def place_params(self, params):
        """Split the param tree under the serving rules (sharded weights
        split, everything else replicated onto every shard); the twins
        run on the placed tree.  Returns it (a :class:`ShardedTensor`
        at every leaf)."""
        placed = shard_params(params, self.rules, self.mesh)
        self._group = _Group(
            params=[_local_tree(placed, i) for i in range(self.tp)],
            devices=self.devices, config=self.config,
            decision=self.decision, lct=self.lct)
        return placed

    def place_pool(self, pool_k: torch.Tensor, pool_v: torch.Tensor):
        """Split existing pool buffers under the KV sharding (head axis
        split when attention is sharded, replicated otherwise), every
        shard its own storage on its device."""
        return (shard_tensor(pool_k, self.kv_spec, self.mesh, copy=True),
                shard_tensor(pool_v, self.kv_spec, self.mesh, copy=True))

    # ---- engine-facing twins (paged's signatures less params, config) ----

    def prefill_step(self, pool_k, pool_v, tables, starts, active, tokens,
                     last_rows):
        return _local_prefill(self._group, pool_k, pool_v, tables, starts,
                              active, tokens, last_rows)

    def decode_span(self, pick_fn, span: int, eos, pool_k, pool_v, tables,
                    lengths, active, tokens, temps, seeds, budgets):
        return _local_decode_span(self._group, pick_fn, span, eos, pool_k,
                                  pool_v, tables, lengths, active, tokens,
                                  temps, seeds, budgets)

    def decode_loop(self, pick_fn, span: int, k_units: int, eos, pool_k,
                    pool_v, tables, lengths, active, tokens, temps, seeds,
                    budgets):
        """The device loop's sharded twin: ``paged._decode_loop_impl``
        over the sharded step.  One controller runs one loop, so every
        shard takes the same units by construction (JAX's loop relies
        on the gathered logits giving every device the same picks)."""
        g = self._group

        def step_fn(tbl, lens, alive, toks):
            return _local_decode_step(g, pool_k, pool_v, tbl, lens, alive,
                                      toks)

        return _decode_loop_impl(step_fn, pick_fn, span, k_units, eos,
                                 tables, lengths, active, tokens, temps,
                                 seeds, budgets)

    def mixed_step(self, pick_fn, span: int, eos, pool_k, pool_v, p_table,
                   p_start, p_tokens, p_last_row, p_temp, p_seed, d_tables,
                   d_lengths, d_active, d_tokens, d_temps, d_seeds,
                   d_budgets):
        """The fused prefill + decode-span twin, the same composition
        over disjoint blocks as ``paged_mixed_step``."""
        p_logits = self.prefill_step(
            pool_k, pool_v, p_table, p_start,
            torch.ones_like(p_start, dtype=torch.bool), p_tokens, p_last_row)
        p_picked = pick_fn(p_logits, p_temp, p_seed)
        emitted = self.decode_span(
            pick_fn, span, eos, pool_k, pool_v, d_tables, d_lengths,
            d_active, d_tokens, d_temps, d_seeds, d_budgets)
        return p_picked, emitted

    def verify_span(self, pick_fn, pool_k, pool_v, tables, lengths, active,
                    tokens, widths, temps, seeds):
        return _local_verify_span(self._group, pick_fn, pool_k, pool_v,
                                  tables, lengths, active, tokens, widths,
                                  temps, seeds)

    def mixed_verify_step(self, pick_fn, pool_k, pool_v, p_table, p_start,
                          p_tokens, p_last_row, p_temp, p_seed, d_tables,
                          d_lengths, d_active, d_tokens, d_widths, d_temps,
                          d_seeds):
        p_logits = self.prefill_step(
            pool_k, pool_v, p_table, p_start,
            torch.ones_like(p_start, dtype=torch.bool), p_tokens, p_last_row)
        p_picked = pick_fn(p_logits, p_temp, p_seed)
        picked, accepts = self.verify_span(
            pick_fn, pool_k, pool_v, d_tables, d_lengths, d_active,
            d_tokens, d_widths, d_temps, d_seeds)
        return p_picked, picked, accepts

    def spec_loop(self, pick_fn, k_units: int, eos, max_order: int,
                  redraft: float, width: int, pool_k, pool_v, *lanes):
        """The speculative device loop's sharded twin:
        ``paged._spec_loop_impl`` over the sharded verify span; one
        loop, so the picks, acceptance counts, alive masks, re-draft
        flag and ring head are one set for every shard."""
        g = self._group

        def verify_fn(tbl, lens, alive, toks, widths, tmp, useeds):
            return _local_verify_span(g, pick_fn, pool_k, pool_v, tbl, lens,
                                      alive, toks, widths, tmp, useeds)

        return _spec_loop_impl(verify_fn, k_units, eos, max_order, redraft,
                               width, *lanes)

    def copy_block(self, pool_k, pool_v, src, dst) -> None:
        """Copy-on-write on every shard (each copies its own heads)."""
        for pk, pv in zip(pool_k.shards, pool_v.shards):
            paged_copy_block(pk, pv, src.to(pk.device), dst.to(pk.device))

    def upload_block(self, pool_k, pool_v, dst, k_slab, v_slab) -> None:
        """The promotion / migration upload: the host-shaped slab
        [n_layers, kv_heads, block_size, head_dim] is re-scattered by
        head, each shard writing its own head slice."""
        h = pool_k.shards[0].shape[2]
        for i, (pk, pv) in enumerate(zip(pool_k.shards, pool_v.shards)):
            heads = slice(i * h, (i + 1) * h) if self.decision.attn_sharded \
                else slice(None)
            at = dst.to(pk.device) if isinstance(dst, torch.Tensor) else dst
            paged_upload_block(pk, pv, at, k_slab[:, heads], v_slab[:, heads])

    # ---- observability -------------------------------------------------

    def dispatch_collective_bytes(self, kind: str, *, lanes: int,
                                  chunk: int = 0, span: int = 0,
                                  width: int = 0,
                                  view_rows: int = 0) -> int:
        """ESTIMATED fleet-total bytes one dispatch of ``kind`` moves
        through its collectives, from the shard shapes (the metrics
        plane's ``collective_bytes_total`` counter — the JAX module's
        model, an estimate, not a transport measurement): an all_gather
        of a globally-N-byte tensor lands N*(tp-1) bytes across the
        group; an all_to_all moves N*(tp-1)/tp.  Copy/upload dispatches
        are collective-free (pure local writes) and cost 0."""
        if kind in ("prefill", "prefill_chunk"):
            return self._chunk_bytes(lanes, chunk, 1, view_rows)
        if kind in ("decode", "decode_span"):
            return span * self._chunk_bytes(lanes, 1, 1, view_rows)
        if kind in ("verify", "verify_span"):
            return self._chunk_bytes(lanes, width, width, view_rows)
        if kind in ("cow_copy", "upload"):
            return 0
        raise ValueError(f"unknown dispatch kind {kind!r}")

    def _chunk_bytes(self, lanes: int, c: int, logit_rows: int,
                     view_rows: int) -> int:
        cfg, dec = self.config, self.decision
        size = torch.empty((), dtype=cfg.dtype).element_size()
        tp1 = self.tp - 1
        total = 0
        if dec.attn_sharded:
            o_bytes = lanes * cfg.n_heads * c * cfg.head_dim * size
            wo_bytes = cfg.n_heads * cfg.head_dim * cfg.d_model * size
            total += cfg.n_layers * (o_bytes + wo_bytes) * tp1
            if (self.lct is not None and c >= self.lct
                    and c % self.tp == 0):
                # Ulysses re-route: two all_to_alls on q/o plus the
                # gathered KV views
                q_bytes = lanes * cfg.n_heads * c * cfg.head_dim * size
                view_bytes = (lanes * cfg.kv_heads * view_rows
                              * cfg.head_dim * size)
                total += cfg.n_layers * (
                    2 * q_bytes * tp1 // self.tp + 2 * view_bytes * tp1)
        if dec.mlp_sharded:
            n_dense = cfg.n_layers - self._n_moe
            hid_bytes = lanes * c * cfg.d_ff * size
            w_out_bytes = cfg.d_ff * cfg.d_model * size
            total += n_dense * (hid_bytes + w_out_bytes) * tp1
        if dec.lm_head_sharded:
            total += lanes * logit_rows * cfg.vocab_size * 4 * tp1
        return total

    def describe(self) -> Dict[str, object]:
        """Human/bench-facing summary (the smoke script prints it)."""
        dec = self.decision
        return {
            "tp": self.tp,
            "devices": [str(d) for d in self.devices],
            "attn_sharded": dec.attn_sharded,
            "mlp_sharded": dec.mlp_sharded,
            "lm_head_sharded": dec.lm_head_sharded,
            "kv_pool_spec": str(self.kv_spec),
            "kv_heads_per_device": (
                self.config.kv_heads // self.tp if dec.attn_sharded
                else self.config.kv_heads),
            "long_context_threshold": self.lct,
        }


def _local_tree(tree, i: int):
    """Shard ``i``'s param tree from a placed tree."""
    if isinstance(tree, dict):
        return {k: _local_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_tree(v, i) for v in tree)
    return tree.shards[i]
