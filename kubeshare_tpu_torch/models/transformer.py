"""Flagship decoder-only Transformer LM, port of
kubeshare_tpu/models/transformer.py (one device).

Parameters are a nested dict of f32 tensors with the JAX tree's layout
(``params["layers"][i]["attn"]["wq"]``...), so a JAX checkpoint converts
1:1 (:mod:`kubeshare_tpu_torch.convert`).  :class:`Transformer` holds the
same tensors as an ``nn.Module`` whose ``state_dict`` keys mirror the JAX
tree paths (``layers.0.attn.wq``, ``final_norm.scale``).  Compute casts
to ``config.dtype`` at the points the JAX code does: the embedding after
its gather, every weight at its matmul, the logits back to f32.

With ``moe_every`` set, every ``moe_every``-th layer's MLP is a routed
expert mixture (:mod:`kubeshare_tpu_torch.ops.moe`); the training
forward derives the experts' capacity from the factor and may drop
tokens, every cached path pins it to the call's token count (prefill
here through ``kv_sink``, the decode and paged steps in their own
modules).  :func:`transformer_apply_with_aux` also returns the MoE
load-balancing loss.

Both entry points are mesh-aware, as the JAX functions are under GSPMD:
given a tree placed by ``parallel.mesh.shard_params`` (under
:func:`transformer_sharding_rules` or :func:`transformer_fsdp_rules`)
they run the sharded program (``parallel/spmd.py``) and return the
logits as a ``ShardedTensor``; a batch split along the sequence runs the
ring.

Long context (``attention="ring"`` / ``"ulysses"``) has entry points of
its own, as in JAX: :func:`transformer_apply_ring` (contiguous or
zigzag, hybrid flash or einsum ring) and :func:`transformer_apply_ulysses`
split the sequence over a mesh's ``sp`` axis; the pipelined
:func:`transformer_apply_pipelined` (GPipe) and
:func:`transformer_train_1f1b` (the 1F1B schedule) split the layers over
a ``pp`` axis, with ring or Ulysses attention inside each stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import resolve_device
from ..ops.attention import attention_reference, flash_attention, use_kernel_default
from ..ops.moe import MoEConfig, moe_apply, moe_init, sharded_moe
from ..ops.ring_attention import (ring_group_fn, zigzag_positions,
                                  zigzag_to_contiguous)
from ..ops.rope import apply_rope, rope_positions
from ..ops.ulysses import ulysses_attention
from ..parallel.mesh import (Mesh, NamedSharding, P, PartitionSpec,
                             RankMesh, ShardedTensor, _split_names,
                             batch_sharding, device_put)
from ..parallel.pipeline import (pipeline_apply, pipeline_train_1f1b,
                                 stack_stage_params)
from ..parallel.spmd import (RankGroup, Units, mesh_line, mesh_of,
                             place_plain, split_axis)
from ..parallel.train import cross_entropy_loss, tree_leaves, tree_map


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "auto"  # auto | reference | flash | ring | ulysses
    attention_window: Optional[int] = None  # sliding-window (local) size
    # grouped-query attention: KV heads shared by query-head groups
    # (None = n_heads, plain MHA; 1 = MQA)
    n_kv_heads: Optional[int] = None
    positional: str = "learned"  # learned | rope
    remat: bool = False  # recompute each layer in the backward (memory for FLOPs)
    # MoE: every Nth layer's MLP becomes a top-k-routed expert mixture
    # (ops.moe); None = all-dense
    moe_every: Optional[int] = None
    moe_num_experts: int = 8
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    # "tokens_choose" (top-k) or "experts_choose" (balanced by
    # construction; training-time only: the cached paths refuse it)
    moe_routing: str = "tokens_choose"
    # "scatter" (permutation dispatch, no dispatch FLOPs) or "einsum"
    # (dense one-hot dispatch); see ops.moe
    moe_dispatch: str = "scatter"

    def layer_is_moe(self, layer_idx: int) -> bool:
        return (self.moe_every is not None
                and layer_idx % self.moe_every == self.moe_every - 1)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        """KV head count: n_kv_heads (GQA/MQA) or n_heads (MHA)."""
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def check_config(config: TransformerConfig) -> None:
    """Refuse what this port does not run (loudly, never approximated)."""
    if config.moe_every is not None and config.moe_every < 1:
        raise ValueError(f"moe_every must be >= 1, got {config.moe_every}")
    if config.attention not in ("auto", "reference", "flash", "ring",
                                "ulysses"):
        raise ValueError(f"unknown attention kind {config.attention!r}")
    if config.positional not in ("learned", "rope"):
        raise ValueError(
            f"positional must be 'learned' or 'rope', got {config.positional!r}"
        )
    if config.kv_heads < 1:
        raise ValueError(f"n_kv_heads must be >= 1, got {config.kv_heads}")
    if config.n_heads % config.kv_heads != 0:
        raise ValueError(
            f"n_heads ({config.n_heads}) must be a multiple of n_kv_heads "
            f"({config.kv_heads})"
        )


def transformer_init(config: TransformerConfig, generator: torch.Generator,
                     device=None) -> Dict:
    """f32 parameters with the JAX init's shapes and scales (normal
    scaled by fan_in^-1/2, unit norm scales), drawn from ``generator`` (a
    CPU generator, so one seed gives the same weights on every device)
    and moved to ``device``."""
    check_config(config)
    device = resolve_device(device)
    d, h, f = config.d_model, config.n_heads, config.d_ff
    h_kv, hd = config.kv_heads, config.head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * (1.0 / fan_in) ** 0.5).to(device)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=device)

    params: Dict = {
        "embed": dense((config.vocab_size, d), d),
        "layers": [],
        "final_norm": {"scale": ones()},
        "lm_head": dense((d, config.vocab_size), d),
    }
    if config.positional == "learned":
        params["pos_embed"] = dense((config.max_seq_len, d), d)
    for i in range(config.n_layers):
        layer = {
            "attn": {
                "wq": dense((d, h, hd), d),
                "wk": dense((d, h_kv, hd), d),
                "wv": dense((d, h_kv, hd), d),
                "wo": dense((h, hd, d), d),
            },
            "norm1": {"scale": ones()},
            "norm2": {"scale": ones()},
        }
        if config.layer_is_moe(i):
            layer["moe"] = moe_init(_moe_config(config, d, f,
                                                config.moe_num_experts),
                                    generator, device)
        else:
            layer["mlp"] = {
                "w_in": dense((d, f), d),
                "w_out": dense((f, d), f),
            }
        params["layers"].append(layer)
    return params


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Norm in f32, cast to x's dtype, then two products in x's dtype."""
    norm = torch.rsqrt(
        torch.mean(x.to(torch.float32) ** 2, dim=-1, keepdim=True) + 1e-6)
    return (x * norm.to(x.dtype)) * scale.to(x.dtype)


AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _select_attention(config: TransformerConfig,
                      device: torch.device) -> AttentionFn:
    """``auto``: the flash kernel on CUDA, the reference on the CPU."""
    kind = config.attention
    window = config.attention_window
    if kind == "auto":
        kind = "flash" if use_kernel_default(device) else "reference"
    if kind == "flash":
        return lambda q, k, v: flash_attention(q, k, v, causal=True,
                                               window=window)
    if kind != "reference":
        raise ValueError(f"unknown attention kind {kind!r}")
    return lambda q, k, v: attention_reference(q, k, v, causal=True,
                                               window=window)


def _project(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[b, s, d] x [d, h, k] -> [b, h, s, k] in y's dtype."""
    return torch.einsum("bsd,dhk->bhsk", y, w.to(y.dtype))


def _mlp(y: torch.Tensor, mlp: Dict) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    hidden = F.gelu(y @ mlp["w_in"].to(y.dtype), approximate="tanh")
    return hidden @ mlp["w_out"].to(y.dtype)


def _moe_config(config: TransformerConfig, d: int, f: int,
                e: int) -> MoEConfig:
    return MoEConfig(d_model=d, d_ff=f, num_experts=e,
                     capacity_factor=config.moe_capacity_factor,
                     top_k=config.moe_top_k, routing=config.moe_routing,
                     dispatch=config.moe_dispatch)


def _moe_or_mlp(layer: Dict, config: TransformerConfig, y: torch.Tensor,
                capacity: Optional[int] = None):
    """The post-attention feed-forward of every path: (out in
    ``config.dtype``, aux) with aux the MoE load-balancing loss, None for
    a dense MLP.  ``capacity`` overrides the factor-derived expert buffer
    (the cached paths pin it to the call's token count, so no choice
    drops and a token's routing depends on nothing else in the call)."""
    if "moe" in layer:
        e, d, f = layer["moe"]["w_in"].shape
        out, aux = moe_apply(layer["moe"], y, _moe_config(config, d, f, e),
                             capacity=capacity)
        return out.to(config.dtype), aux
    return _mlp(y, layer["mlp"]), None


def _attention_inputs(layer: Dict, x: torch.Tensor,
                      rope_positions_or_none: Optional[torch.Tensor]):
    """A layer's attention inputs: q, k, v [b, h, s, k] (norm,
    projections, RoPE)."""
    y = _rms_norm(x, layer["norm1"]["scale"])
    q = _project(y, layer["attn"]["wq"])
    k = _project(y, layer["attn"]["wk"])
    v = _project(y, layer["attn"]["wv"])
    if rope_positions_or_none is not None:
        q = apply_rope(q, rope_positions_or_none)
        k = apply_rope(k, rope_positions_or_none)
    return q, k, v


def _layer_tail(layer: Dict, x: torch.Tensor, o: torch.Tensor,
                config: TransformerConfig,
                moe_capacity: Optional[int] = None):
    """A layer after its attention output ``o``: (x, aux)."""
    dtype = config.dtype
    x = x + torch.einsum("bhsk,hkd->bsd", o.to(dtype),
                         layer["attn"]["wo"].to(dtype))
    y = _rms_norm(x, layer["norm2"]["scale"])
    out, aux = _moe_or_mlp(layer, config, y, moe_capacity)
    return x + out, aux


def _layer_forward(layer: Dict, x: torch.Tensor, attention_fn: AttentionFn,
                   config: TransformerConfig,
                   rope_positions_or_none: Optional[torch.Tensor],
                   moe_capacity: Optional[int] = None):
    """One layer; returns (x, aux, (k, v)): aux is the MoE
    load-balancing loss (None for a dense MLP), k/v the roped projections
    (the bulk prefill writes them straight into the decode cache)."""
    q, k, v = _attention_inputs(layer, x, rope_positions_or_none)
    x, aux = _layer_tail(layer, x, attention_fn(q, k, v), config,
                         moe_capacity)
    return x, aux, (k, v)


def _forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
             attention_fn: AttentionFn,
             pos_offset: Union[int, torch.Tensor] = 0,
             apply_head: bool = True,
             kv_sink: Optional[List] = None):
    """Shared forward body; returns (logits, aux) with aux the summed MoE
    load-balancing loss (a 0-d f32 tensor, 0 for all-dense configs).
    ``pos_offset``: a scalar offset, or a [seq] tensor of global
    positions.  ``apply_head=False`` returns the final-normed hidden
    states in place of the logits.  ``kv_sink`` (a list) collects each
    layer's (k, v) projections and pins the MoE capacity to the token
    count (the prefill's contract with the cached steps)."""
    check_config(config)
    dtype = config.dtype
    seq = tokens.shape[1]
    x = params["embed"][tokens].to(dtype)
    explicit_positions = isinstance(pos_offset, torch.Tensor) and pos_offset.ndim == 1
    positions = None
    if config.positional == "rope":
        positions = (pos_offset if explicit_positions
                     else rope_positions(seq, int(pos_offset), tokens.device))
    elif explicit_positions:
        x = x + params["pos_embed"][pos_offset].to(dtype)
    else:
        offset = int(pos_offset)
        x = x + params["pos_embed"][offset: offset + seq].to(dtype)

    # prefill (kv_sink set) pins the expert buffers to the token count:
    # no choice drops, so routing is position- and batch-independent, as
    # in the cached steps
    moe_capacity = (tokens.shape[0] * tokens.shape[1]
                    if kv_sink is not None else None)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        if config.remat and kv_sink is None:
            # keep only each layer's input; its activations are recomputed
            # in the backward (the JAX model's jax.checkpoint per layer)
            x, aux, _ = torch.utils.checkpoint.checkpoint(
                _layer_forward, layer, x, attention_fn, config, positions,
                use_reentrant=False)
        else:
            x, aux, kv = _layer_forward(layer, x, attention_fn, config,
                                        positions, moe_capacity)
            if kv_sink is not None:
                kv_sink.append(kv)
        if aux is not None:
            aux_total = aux_total + aux

    x = _rms_norm(x, params["final_norm"]["scale"])
    if not apply_head:
        return x, aux_total
    return (x @ params["lm_head"].to(dtype)).to(torch.float32), aux_total


def transformer_apply(params: Dict, tokens: torch.Tensor,
                      config: TransformerConfig) -> torch.Tensor:
    """tokens: [batch, seq] integer -> logits [batch, seq, vocab] f32.

    Differentiable: on CUDA with attention ``auto``/``flash`` the
    backward runs the flash backward kernels.  Mesh-aware: a tree of
    ``ShardedTensor`` leaves (``parallel.mesh.shard_params``) runs the
    sharded program (:func:`_sharded_forward`) and returns the logits as
    a ``ShardedTensor``.

    ``attention="ring"`` / ``"ulysses"`` needs a sequence-split caller:
    :func:`transformer_apply_ring` / :func:`transformer_apply_ulysses`."""
    if config.attention in ("ring", "ulysses"):
        raise ValueError(
            f"attention={config.attention!r} shards the sequence axis; call "
            f"transformer_apply_{config.attention}(params, tokens, config, "
            f"mesh) instead"
        )
    mesh = mesh_of(params, tokens)
    if mesh is not None:
        return _sharded_forward(params, tokens, config, mesh)[0]
    logits, _ = _forward(params, tokens, config,
                         _select_attention(config, tokens.device), 0)
    return logits


def transformer_apply_with_aux(params: Dict, tokens: torch.Tensor,
                               config: TransformerConfig):
    """Like :func:`transformer_apply` but also returns the summed MoE
    load-balancing auxiliary loss (0 for all-dense configs): add it to
    the training loss with a small coefficient (conventionally 1e-2)."""
    if config.attention in ("ring", "ulysses"):
        raise ValueError(
            f"attention={config.attention!r} shards the sequence axis")
    mesh = mesh_of(params, tokens)
    if mesh is not None:
        return _sharded_forward(params, tokens, config, mesh)
    return _forward(params, tokens, config,
                    _select_attention(config, tokens.device), 0)


# ---------------------------------------------------------------------------
# the sharded program (parallel/spmd.py): one body per work unit
# ---------------------------------------------------------------------------

def transformer_sharding_rules() -> Dict[str, PartitionSpec]:
    """Path-substring -> PartitionSpec rules over the (dp, tp, sp) mesh.

    tp splits attention heads and MLP hidden; embeddings/lm_head split on
    the vocab axis; norms replicate.  Used with parallel.mesh.shard_params
    / param_spec_tree."""
    return {
        "embed": P("tp", None),
        "pos_embed": P(),
        "wq": P(None, "tp", None),
        "wk": P(None, "tp", None),
        "wv": P(None, "tp", None),
        "wo": P("tp", None, None),
        "w_in": P(None, "tp"),
        "w_out": P("tp", None),
        # MoE layers: experts sharded over tp (ep-over-tp), router
        # replicated.  Needles are keystr substrings; the longer
        # moe-qualified patterns beat the dense "w_in"/"w_out" ones.
        "moe']['w_in": P("tp", None, None),
        "moe']['w_out": P("tp", None, None),
        "router": P(),
        "lm_head": P(None, "tp"),
        "norm": P(),
        "scale": P(),
    }


def transformer_fsdp_rules(axis: str = "dp") -> Dict[str, PartitionSpec]:
    """Zero-style (FSDP) parameter sharding composed WITH tensor
    parallelism: every weight matrix additionally shards a non-tp axis
    over ``axis`` (conventionally dp), so parameter and optimizer-state
    memory scale down with the dp degree.  The sharded forward gathers
    each weight's ``axis`` split at use, and autograd's transpose of the
    gather reduce-scatters its gradient (ZeRO-3 by placement).  The
    optimizer state follows: the training step builds every moment over
    its parameter's shard."""
    return {
        "embed": P("tp", axis),
        "pos_embed": P(),
        "wq": P(axis, "tp", None),
        "wk": P(axis, "tp", None),
        "wv": P(axis, "tp", None),
        "wo": P("tp", None, axis),
        "w_in": P(axis, "tp"),
        "w_out": P("tp", axis),
        # MoE experts: expert axis over tp (as in the base rules), the
        # feature axis over dp
        "moe']['w_in": P("tp", axis, None),
        "moe']['w_out": P("tp", axis, None),
        "router": P(),
        "lm_head": P(axis, "tp"),
        "norm": P(),
        "scale": P(),
    }


GroupAttentionFn = Callable[[List[torch.Tensor], List[torch.Tensor],
                             List[torch.Tensor], List[torch.device]],
                            List[torch.Tensor]]


def _group_attention(config: TransformerConfig, mesh: Mesh, kind: str,
                     layout: str = "contiguous",
                     use_flash: Optional[bool] = None) -> GroupAttentionFn:
    """Causal attention over a sequence group: ``fn(qs, ks, vs, devices)``
    -> the members' outputs.  ``kind`` "ulysses" (``ops/ulysses.py``,
    ``use_flash`` as there) or "ring", resolved by
    ``ops.ring_attention.ring_group_fn`` (a window on the contiguous
    einsum ring, ``use_flash=None`` the hybrid ring on CUDA)."""
    window = config.attention_window
    if kind == "ulysses":
        return lambda qs, ks, vs, devices: ulysses_attention(
            qs, ks, vs, devices, causal=True, window=window,
            use_flash=use_flash)
    return ring_group_fn(mesh, layout, use_flash, window)


@dataclass(frozen=True)
class _SeqSplit:
    """A sharded forward whose sequence is split over the mesh axis
    ``axis``: ``attend`` attends over each group of units that differ
    only on it (:func:`_group_attention`), ``layout`` "contiguous" or
    "zigzag" places the shards.  ``local_moe``: each shard routes its own
    tokens, as the JAX sp entries' shard_map body does; otherwise the
    global batch is routed, as GSPMD routes JAX's ``transformer_apply``
    over a batch split along sp."""

    axis: str
    attend: GroupAttentionFn
    layout: str = "contiguous"
    local_moe: bool = True


def _units_attention(units: Units, config: TransformerConfig,
                     split: Optional[_SeqSplit]):
    """``attend(qs, ks, vs)`` over every unit: each unit's own attention
    over its whole sequence, or, with a sequence split, each group of
    units that differ only on the split axis attending together."""
    if split is None:
        fn = _select_attention(config, units.devices[0])
        return lambda qs, ks, vs: [fn(q, k, v) for q, k, v in zip(qs, ks, vs)]
    group_fn = split.attend
    # one controller: every group of units; over ranks: this rank's unit
    # in its group on the rank line
    groups = units.sequence_groups((split.axis,))

    def attend(qs, ks, vs):
        outs: List[Optional[torch.Tensor]] = [None] * len(qs)
        for members, group in groups:
            results = group_fn([qs[u] for u in members],
                               [ks[u] for u in members],
                               [vs[u] for u in members], group)
            for u, o in zip(members, results):
                outs[u] = o
        return outs

    return attend


def _sharded_moe_layer(units: Units, moe: Dict, ys: List[torch.Tensor],
                       config: TransformerConfig, batch: Tuple[str, ...],
                       split: Optional[_SeqSplit]):
    """An MoE layer over the units: (outs, aux), aux one tensor (the
    global batch routed once) or, for ``split.local_moe``, each unit's
    own (summed over layers and averaged over the mesh by the caller)."""
    e, d, f = moe["w_in"].shape
    moe_config = _moe_config(config, d, f, e)
    if split is None:
        return sharded_moe(units, moe, ys, moe_config, batch)
    if split.local_moe:
        # each shard routes its own tokens through the whole experts (the
        # JAX shard_map body holds the replicated tree); the expert
        # buffers follow the shard's token count
        weights = {name: units.local(leaf) for name, leaf in moe.items()}
        results = [moe_apply({name: w[u] for name, w in weights.items()}, y,
                             moe_config) for u, y in enumerate(ys)]
        return [out for out, _ in results], [aux for _, aux in results]
    # the global batch's routing: each unit gathers its rows' whole
    # sequences, and keeps its own positions of the output
    full = units.all_gather(ys, 1, (split.axis,))
    outs, aux = sharded_moe(units, moe, full, moe_config, batch)
    return [out.narrow(1, units.coord(u, (split.axis,)) * y.shape[1],
                       y.shape[1]) for u, (out, y) in enumerate(zip(outs, ys))], aux


def _sharded_layer(units: Units, layer: Dict, xs: List[torch.Tensor],
                   attend, config: TransformerConfig,
                   positions: Optional[List[torch.Tensor]],
                   batch: Tuple[str, ...], split: Optional[_SeqSplit]):
    """One layer over the units: (xs, aux).  Heads split over an axis on
    which wq / wk / wv (dim 1) and wo (dim 0) agree run per unit on the
    unit's query and KV heads and psum the output projection; the MLP's
    hidden likewise (w_in dim 1, w_out dim 0); every other split of a
    weight (fsdp) is gathered at use.  ``attend`` runs the attention of
    every unit (:func:`_units_attention`)."""
    dtype = config.dtype
    attn = layer["attn"]
    heads = split_axis(batch, (attn["wq"], 1), (attn["wk"], 1),
                       (attn["wv"], 1), (attn["wo"], 0))

    def local(weight, dim, axis):
        return units.local(weight, {dim: (axis,)} if axis else None)

    wq, wk, wv = (local(attn[name], 1, heads) for name in ("wq", "wk", "wv"))
    wo = local(attn["wo"], 0, heads)
    norm1 = units.local(layer["norm1"]["scale"])
    norm2 = units.local(layer["norm2"]["scale"])
    qs, ks, vs = [], [], []
    for u, x in enumerate(xs):
        y = _rms_norm(x, norm1[u])
        q, k, v = _project(y, wq[u]), _project(y, wk[u]), _project(y, wv[u])
        if positions is not None:
            q = apply_rope(q, positions[u])
            k = apply_rope(k, positions[u])
        qs.append(q)
        ks.append(k)
        vs.append(v)
    parts = [torch.einsum("bhsk,hkd->bsd", o.to(dtype), wo[u].to(dtype))
             for u, o in enumerate(attend(qs, ks, vs))]
    if heads:
        parts = units.psum(parts, (heads,))
    xs = [x + part for x, part in zip(xs, parts)]
    ys = [_rms_norm(x, scale) for x, scale in zip(xs, norm2)]
    if "moe" in layer:
        outs, aux = _sharded_moe_layer(units, layer["moe"], ys, config,
                                       batch, split)
        return [x + out.to(dtype) for x, out in zip(xs, outs)], aux
    mlp = layer["mlp"]
    hidden = split_axis(batch, (mlp["w_in"], 1), (mlp["w_out"], 0))
    w_in = local(mlp["w_in"], 1, hidden)
    w_out = local(mlp["w_out"], 0, hidden)
    parts = [_mlp(y, {"w_in": a, "w_out": b})
             for y, a, b in zip(ys, w_in, w_out)]
    if hidden:
        parts = units.psum(parts, (hidden,))
    return [x + part for x, part in zip(xs, parts)], None


def _rank_auxes(units: Units, aux: torch.Tensor) -> List[Tuple]:
    """Over a mesh of ranks: every unit's (coordinates on the unit axes,
    aux), in the one-controller's unit order.  Each rank's aux crosses
    the mesh, and this rank's own (differentiable) stands in its place.
    A rank at a nonzero coordinate of a replica axis is no unit, so it is
    left out, as one controller runs no such unit (and such a rank's own
    aux is never in the sum: it differentiates nothing)."""
    mesh = units.mesh
    parts = mesh_line(mesh, mesh.axis_names).gather(aux.detach())
    at = [mesh.axis_names.index(a) for a in units.axes]
    entries = []
    for p, part in enumerate(parts):
        coords = mesh.coords(p)
        if any(coords[i] for i in range(len(coords)) if i not in at):
            continue
        entries.append((tuple(coords[i] for i in at),
                        aux if p == mesh.position else part))
    return entries


def _mesh_mean_aux(units: Units, auxes: List[torch.Tensor],
                   batch: Tuple[str, ...], seq_axis: str) -> torch.Tensor:
    """The shards' aux losses averaged over the sequence axis, then over
    the batch axes (JAX's pmean over sp, then over dp), on the lead
    unit's device; units that differ only on a replica axis (tp) hold
    copies and count once.  Over a mesh of ranks every rank computes the
    same mean from the units' auxes in the one-controller's order, and
    its gradient reaches each rank's own aux once."""
    lead = units.devices[0]
    other = [a for a in units.axes if a not in batch and a != seq_axis]
    entries = (_rank_auxes(units, auxes[0]) if units.ranked else
               [(units.coords[u], aux) for u, aux in enumerate(auxes)])
    rows: Dict[int, List] = {}
    for coords, aux in entries:
        if units.index_of(coords, other) == 0:
            rows.setdefault(units.index_of(coords, batch), []).append(
                (units.index_of(coords, (seq_axis,)), aux))
    means = []
    for key in sorted(rows):
        members = [aux.to(lead) for _, aux in sorted(rows[key],
                                                     key=lambda m: m[0])]
        means.append(sum(members[1:], members[0]) / len(members))
    return sum(means[1:], means[0]) / len(means)


def _sharded_forward(params: Dict, tokens, config: TransformerConfig,
                     mesh: Mesh, split: Optional[_SeqSplit] = None,
                     batch_axis: Optional[str] = "dp"):
    """:func:`_forward` (causal, from position 0) as the sharded program
    over the work units of the params' and the batch's mesh; returns
    (logits as a ``ShardedTensor`` [batch, seq, vocab] f32, aux).

    Each unit takes its rows of the batch (dp, and ep as a batch axis).
    Under tp the attention heads, the MLP hidden and the vocabulary are
    split: attention runs per unit on ``n_heads/tp`` query and
    ``n_kv_heads/tp`` KV heads, the products that contract a split axis
    (``wo``, ``w_out``) are psummed over tp, the embedding lookup goes to
    the shard that owns the token's row (the others add zeros), and the
    logits stay split by vocabulary (the loss combines their log-softmax
    statistics: ``parallel.spmd.sharded_cross_entropy``).  A weight's
    other splits (fsdp) are gathered at use.  MoE layers run
    ``ops.moe.sharded_moe``; ``config.remat`` recomputes each layer.

    A sequence split (``split``, the sp entries; or a batch placed split
    along the sequence, as ``batch_sharding(mesh, 2, seq_axis=1)``
    places it) gives each unit its shard of the sequence as well: tokens
    placed by rows only (the training step's placement, unplaced tokens
    by ``batch_axis``) are re-split along ``split.axis``, RoPE and the
    learned positions follow the shard's global positions, and attention
    sees the whole sequence through the ring or Ulysses over the units
    that share the rows.  A batch split along the sequence under
    ``transformer_apply`` runs the contiguous ring (the hybrid ring with
    the flash kernel on its diagonal blocks, the einsum ring for
    attention "reference" or a window), since
    the flash kernel needs the queries and keys of one whole sequence;
    its MoE layers route the global batch.  The logits come back split
    along the sequence too, in contiguous order (the zigzag ring's
    hidden states are put back in order before the head)."""
    check_config(config)
    if not isinstance(tokens, ShardedTensor):
        sharding = (batch_sharding(mesh, tokens.ndim) if split is None
                    else NamedSharding(mesh, P(batch_axis, None)))
        tokens = device_put(tokens, sharding)
    seq_split = _split_names(tokens.spec[1] if len(tokens.spec) > 1
                             else None)
    if split is None and seq_split:
        if len(seq_split) != 1:
            raise ValueError(f"a batch split along the sequence over "
                             f"{seq_split}: the ring takes one axis")
        # the hybrid ring where config.attention would run the flash
        # kernel, the einsum ring for "reference" and for a window
        use_flash = (None if config.attention_window is not None else
                     {"reference": False, "flash": True}.get(
                         config.attention))
        split = _SeqSplit(seq_split[0],
                          _group_attention(config, mesh, "ring",
                                           use_flash=use_flash),
                          local_moe=False)
    params = place_plain(params, mesh)
    rows_spec = tokens.spec[0] if tokens.spec else None
    units = Units.of(mesh, [P(rows_spec, split.axis if split else None)]
                     + [leaf.spec for leaf in tree_leaves(params)])
    batch = tuple(_split_names(rows_spec))
    dtype = config.dtype
    seq = tokens.shape[1]
    # every unit's rows, whole sequences (a split along sp is gathered)
    toks = units.local(tokens, {0: batch})
    positions: Optional[List[torch.Tensor]] = None
    if split is not None:
        n = mesh.shape[split.axis]
        zigzag = split.layout == "zigzag"
        if seq % (2 * n if zigzag else n):
            raise ValueError(
                f"seq {seq} not divisible by {'2*' if zigzag else ''}"
                f"{split.axis}={2 * n if zigzag else n}")
        s_local = seq // n
        positions = []
        for u, tok in enumerate(toks):
            j = units.coord(u, (split.axis,))
            pos = (zigzag_positions(j, n, s_local, tok.device) if zigzag
                   else torch.arange(s_local, device=tok.device) + j * s_local)
            toks[u] = tok[:, pos]
            positions.append(pos)

    # the embedding: the vocabulary split over one axis, each unit looks
    # up the tokens in its rows and adds zeros for the others.  The
    # others' lookups are clamped to an edge row, so about (1 - 1/tp) of
    # the batch repeats one index: F.embedding's backward sums repeats by
    # segments (indexing's backward walks each repeat in turn: 0.69 ms a
    # unit at the train-step flagship on an H100)
    vocab = split_axis(batch, (params["embed"], 0))
    embed = units.local(params["embed"], {0: (vocab,)} if vocab else None)
    xs = []
    for u, tok in enumerate(toks):
        rows = embed[u].shape[0]
        first = units.coord(u, (vocab,)) * rows if vocab else 0
        inside = (tok >= first) & (tok < first + rows)
        picked = F.embedding((tok - first).clamp(0, rows - 1), embed[u])
        xs.append(torch.where(inside[..., None], picked,
                              torch.zeros((), dtype=picked.dtype,
                                          device=picked.device)))
    if vocab:
        xs = units.psum(xs, (vocab,))
    xs = [x.to(dtype) for x in xs]
    if config.positional == "rope":
        if positions is None:
            positions = [rope_positions(seq, 0, d) for d in units.devices]
    else:
        pos = units.local(params["pos_embed"])
        xs = [x + (p[positions[u]] if positions is not None
                   else p[:seq]).to(dtype)
              for u, (x, p) in enumerate(zip(xs, pos))]
        positions = None

    attend = _units_attention(units, config, split)
    aux_total = torch.zeros((), dtype=torch.float32,
                            device=units.devices[0])
    aux_units = None
    for layer in params["layers"]:
        if config.remat:
            xs, aux = torch.utils.checkpoint.checkpoint(
                _sharded_layer, units, layer, xs, attend, config, positions,
                batch, split, use_reentrant=False)
        else:
            xs, aux = _sharded_layer(units, layer, xs, attend, config,
                                     positions, batch, split)
        if isinstance(aux, list):
            aux_units = aux if aux_units is None else [
                a + b for a, b in zip(aux_units, aux)]
        elif aux is not None:
            aux_total = aux_total + aux
    if aux_units is not None:
        aux_total = _mesh_mean_aux(units, aux_units, batch, split.axis)

    final = units.local(params["final_norm"]["scale"])
    xs = [_rms_norm(x, scale) for x, scale in zip(xs, final)]
    if split is not None and split.layout == "zigzag":
        # back to contiguous order at hidden width (the logits would be
        # vocab / d_model times wider); across ranks an exchange of
        # chunks over the sp line
        for members, group in units.sequence_groups((split.axis,)):
            ordered = zigzag_to_contiguous([xs[u] for u in members], group,
                                           axis=1)
            for u, x in zip(members, ordered):
                xs[u] = x
    head = split_axis(batch, (params["lm_head"], 1))
    lm_head = units.local(params["lm_head"], {1: (head,)} if head else None)
    logits = [(x @ w.to(dtype)).to(torch.float32)
              for x, w in zip(xs, lm_head)]
    spec = P(rows_spec, split.axis if split else None, head)
    shape = (tokens.shape[0], seq, params["lm_head"].shape[1])
    return units.assemble(logits, spec, shape), aux_total


# ---------------------------------------------------------------------------
# long context: the sequence split over sp (ring, Ulysses)
# ---------------------------------------------------------------------------

def _validate_sp_entry(strategy: str, config: TransformerConfig, mesh: Mesh,
                       seq_axis: str) -> None:
    """Shared preconditions of every sequence-parallel entry point (the
    ring and Ulysses forwards and the pipelined sp path, which adds its
    own MoE refusal).  A mesh of ranks runs each entry with one unit a
    rank, the ring's and Ulysses' collectives over its sp line."""
    if seq_axis not in mesh.shape:
        raise ValueError(
            f"sequence-parallel attention needs a {seq_axis!r} mesh axis "
            f"(got {tuple(mesh.shape)})"
        )
    # a window on the CONTIGUOUS einsum ring is supported (out-of-band
    # ring steps skip their block math); the zigzag / flash ring callers
    # get a loud error at the op layer
    if strategy == "ulysses" and (
            config.n_heads % mesh.shape[seq_axis] != 0
            or config.kv_heads % mesh.shape[seq_axis] != 0):
        raise ValueError(
            f"attention='ulysses' needs n_heads ({config.n_heads}) and "
            f"n_kv_heads ({config.kv_heads}) divisible by the "
            f"{seq_axis!r} mesh degree ({mesh.shape[seq_axis]})"
        )
    if (config.moe_every is not None
            and config.moe_routing == "experts_choose"):
        raise ValueError(
            "expert-choice routing is whole-batch routing (an expert picks "
            "its top-capacity tokens globally, ops/moe.py) — a sequence "
            "shard cannot route it locally; use moe_routing="
            "'tokens_choose' on the sequence-parallel entries"
        )


def transformer_apply_ring(
    params: Dict,
    tokens,
    config: TransformerConfig,
    mesh: Mesh,
    batch_axis: Optional[str] = "dp",
    seq_axis: str = "sp",
    use_flash: Optional[bool] = None,
    layout: str = "contiguous",
    with_aux: bool = False,
):
    """Sequence-parallel forward: tokens split over ``seq_axis`` (and
    their rows over ``batch_axis``), ring attention carrying K/V around
    each group of sequence shards (the long-context path).  ``tokens`` is
    a tensor or a ``ShardedTensor`` (the training step places rows only;
    the sequence is split here); ``params`` a plain tree or one placed by
    ``shard_params`` (tp heads and MLP hidden then split as in
    :func:`_sharded_forward`).  Returns the logits as a ``ShardedTensor``
    ``P(batch_axis, seq_axis, tp)``.

    MoE configs route each sequence shard's tokens locally (routing is
    per token; the expert buffers follow the shard's token count).
    ``with_aux=True`` also returns the load-balancing aux loss averaged
    over the mesh — a per-shard-mean estimate of the dense entry's
    global-mean aux.

    ``use_flash=None`` picks the hybrid ring on CUDA (the flash kernel on
    the diagonal blocks, :func:`~kubeshare_tpu_torch.ops.ring_attention.
    ring_flash_auto`), the einsum ring elsewhere.

    ``layout="zigzag"`` runs the load-balanced causal ring end to end:
    each shard holds two chunks of the sequence (RoPE and learned
    positions follow their global positions), every layer attends with
    the balanced partials, and the hidden states are put back in order
    before the head — callers see contiguous sequences."""
    _validate_sp_entry("ring", config, mesh, seq_axis)
    attend = _group_attention(config, mesh, "ring", layout, use_flash)
    logits, aux = _sharded_forward(
        params, tokens, config, mesh, _SeqSplit(seq_axis, attend, layout),
        batch_axis)
    return (logits, aux) if with_aux else logits


def transformer_apply_ulysses(
    params: Dict,
    tokens,
    config: TransformerConfig,
    mesh: Mesh,
    batch_axis: Optional[str] = "dp",
    seq_axis: str = "sp",
    use_flash: Optional[bool] = None,
    with_aux: bool = False,
):
    """Sequence-parallel forward via all-to-all (Ulysses) attention:
    tokens split over ``seq_axis``; two all-to-alls swap each group's
    shards to head-parallel for a FULL-sequence local attention (the
    flash kernels at their best shapes), then swap back
    (``ops/ulysses.py``).  Supports ``attention_window``; needs the heads
    a unit holds divisible by the ``seq_axis`` degree.  MoE, ``with_aux``
    and the placements as in :func:`transformer_apply_ring`."""
    _validate_sp_entry("ulysses", config, mesh, seq_axis)
    logits, aux = _sharded_forward(
        params, tokens, config, mesh,
        _SeqSplit(seq_axis, _group_attention(config, mesh, "ulysses",
                                             use_flash=use_flash)),
        batch_axis)
    return (logits, aux) if with_aux else logits


def transformer_activation_spec(use_sp: bool = True) -> PartitionSpec:
    """Sharding for the [batch, seq] token array."""
    return P("dp", "sp") if use_sp else P("dp", None)


# ---------------------------------------------------------------------------
# pipelined: the layers split over pp (GPipe, 1F1B), sp inside the stages
# ---------------------------------------------------------------------------

def _group_layer(layer: Dict, xs: List[torch.Tensor], attend,
                 config: TransformerConfig,
                 positions: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """One dense layer over a stage's sequence members; ``attend(qs, ks,
    vs)`` attends over all of them."""
    inputs = [_attention_inputs(layer, x, pos)
              for x, pos in zip(xs, positions)]
    outs = attend(*(list(t) for t in zip(*inputs)))
    return [_layer_tail(layer, x, o, config)[0] for x, o in zip(xs, outs)]


def _pipeline_stage_setup(params: Dict, seq_len: int,
                          config: TransformerConfig, mesh: Mesh,
                          pp_axis: str, seq_axis: str,
                          use_flash: Optional[bool]):
    """Stack the layers into pp stages and build the stage body (ring or
    Ulysses attention over the stage's sequence members when the config
    asks for sequence parallelism).  Returns ``(stacked_params,
    stage_fn, activation_spec)``.

    Over a :class:`RankMesh` the stack is this rank's stage's alone,
    placed ``P(pp)`` (a rank holds no other stage's layers), and the ring
    or Ulysses runs over the rank's sequence line: its member is this
    rank's, its RoPE positions start at its sp coordinate's offset."""
    sp_attention = config.attention in ("ring", "ulysses")
    if sp_attention:
        _validate_sp_entry(config.attention, config, mesh, seq_axis)
    if config.moe_every is not None:
        # the sp branch too: the stage body would drop the aux loss
        raise ValueError(
            "MoE layers are not supported on the pipelined path yet")
    n_stages = mesh.shape[pp_axis]
    if config.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers {config.n_layers} not divisible into {n_stages} stages"
        )
    per_stage = config.n_layers // n_stages
    use_rope = config.positional == "rope"

    def stack(s):
        # stage s's layers stacked: leaves [per_stage, ...]
        return tree_map(lambda *ls: torch.stack(ls),
                        *params["layers"][s * per_stage:(s + 1) * per_stage])

    group = None
    if isinstance(mesh, RankMesh):
        stage = mesh.coords()[mesh.axis_names.index(pp_axis)]
        stacked = tree_map(lambda p: ShardedTensor(
            [p[None]], P(pp_axis), mesh, (n_stages, *p.shape)), stack(stage))
        if sp_attention:
            group = RankGroup(mesh_line(mesh, (seq_axis,)),
                              mesh.local_devices[0])
    else:
        # leaves [pp, per_stage, ...]
        stacked = stack_stage_params([stack(s) for s in range(n_stages)])

    def run_layers(stage_layers, xs, attend, positions):
        for i in range(per_stage):
            xs = _group_layer(tree_map(lambda p, i=i: p[i], stage_layers), xs,
                              attend, config, positions)
        return xs

    if sp_attention:
        group_fn = _group_attention(config, mesh, config.attention,
                                    use_flash=use_flash)

        def stage_fn(stage_layers, xs):
            # the stage's sequence members held here (one controller:
            # every member, contiguous shards in order; over ranks, this
            # rank's), each at its member index's offset
            local_seq = xs[0].shape[1]
            members = (group if group is not None
                       else [x.device for x in xs])
            indices = (group.indices if group is not None
                       else range(len(xs)))
            positions = [rope_positions(local_seq, j * local_seq, x.device)
                         if use_rope else None for j, x in zip(indices, xs)]
            return run_layers(stage_layers, xs,
                              lambda qs, ks, vs: group_fn(qs, ks, vs,
                                                          members),
                              positions)

        return stacked, stage_fn, P(None, seq_axis, None)

    def stage_fn(stage_layers, xs):
        fn = _select_attention(config, xs[0].device)
        positions = [rope_positions(seq_len, 0, xs[0].device)
                     if use_rope else None]
        return run_layers(stage_layers, xs,
                          lambda qs, ks, vs: [fn(qs[0], ks[0], vs[0])],
                          positions)

    return stacked, stage_fn, None


def _embed(params: Dict, tokens: torch.Tensor, config: TransformerConfig):
    """The pipelined paths' input: the embedding rows (and the learned
    positions), run outside the pipeline."""
    x = params["embed"][tokens].to(config.dtype)
    if config.positional != "rope":
        x = x + params["pos_embed"][: tokens.shape[1]].to(config.dtype)
    return x


def transformer_apply_pipelined(
    params: Dict,
    tokens: torch.Tensor,
    config: TransformerConfig,
    mesh: Mesh,
    num_microbatches: int = 2,
    pp_axis: str = "pp",
    seq_axis: str = "sp",
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Pipeline-parallel forward: the layers split into pp stages (GPipe
    over ``pp_axis``, ``parallel.pipeline``); the embedding and the head
    run outside the pipeline.  Requires n_layers % pp == 0.

    pp x sp: with ``attention="ring"`` or ``"ulysses"`` (and
    ``seq_axis`` in the mesh) the activations flow through the pipeline
    split along the sequence, and each stage runs its sequence-parallel
    attention over its members (the contiguous ring, the hybrid ring on
    CUDA unless ``use_flash`` says otherwise).  Returns the logits [batch,
    seq, vocab] f32."""
    stacked, stage_fn, activation_spec = _pipeline_stage_setup(
        params, tokens.shape[1], config, mesh, pp_axis, seq_axis, use_flash)
    x = pipeline_apply(stacked, _embed(params, tokens, config), stage_fn,
                       mesh, num_microbatches, pp_axis,
                       activation_spec=activation_spec)
    x = _rms_norm(x, params["final_norm"]["scale"].to(x.device))
    return (x @ params["lm_head"].to(x.device, config.dtype)).to(
        torch.float32)


def transformer_train_1f1b(
    params: Dict,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    config: TransformerConfig,
    mesh: Mesh,
    num_microbatches: int = 2,
    pp_axis: str = "pp",
    seq_axis: str = "sp",
    use_flash: Optional[bool] = None,
):
    """A whole training step's loss and gradients under the 1F1B pipeline
    schedule: cross-entropy loss and gradients for EVERY parameter — the
    embedding and positional table (from the pipeline's input
    cotangents), the stages' layers (1F1B proper), and the final norm and
    lm_head (trained at the last stage as the pipeline's loss
    parameters).  Composes with sequence parallelism as
    :func:`transformer_apply_pipelined` does (1F1B x sp).  Returns
    ``(loss, grads)`` with ``grads`` matching ``params`` (f32 tensors;
    apply them with any optimizer).

    Over a :class:`RankMesh` (every rank passes the same ``params``,
    ``tokens`` and ``targets``) the loss and the gradients of the
    embedding, the positional table, the final norm and the head are the
    whole ones on every rank (the input cotangents come from stage 0's
    ranks, the head's from the last stage's), and ``grads["layers"]``
    holds this rank's stage's layers only: entry ``i`` is layer ``stage
    * n_layers / pp + i``'s gradient, the stage being the rank's pp
    coordinate.  Other stages' layers are not in it."""
    stacked, stage_fn, activation_spec = _pipeline_stage_setup(
        params, tokens.shape[1], config, mesh, pp_axis, seq_axis, use_flash)
    dtype = config.dtype
    seq = tokens.shape[1]
    with torch.no_grad():
        x = _embed(params, tokens, config)
    loss_params = {"final_norm": params["final_norm"],
                   "lm_head": params["lm_head"]}

    def loss_fn(lp, out, y):
        z = _rms_norm(out.to(dtype), lp["final_norm"]["scale"])
        logits = (z @ lp["lm_head"].to(dtype)).to(torch.float32)
        return cross_entropy_loss(logits, y)

    loss, stage_grads, head_grads, dx = pipeline_train_1f1b(
        stacked, x, targets, stage_fn, loss_fn, mesh, num_microbatches,
        pp_axis=pp_axis, activation_spec=activation_spec,
        loss_params=loss_params, return_input_grads=True)

    # the embedding lookup's backward from the pipeline's input
    # cotangents: d(embed) adds dx at each token's row, d(pos_embed) is
    # the batch sum at each position
    embed = params["embed"]
    dx32 = dx.to(embed.device, torch.float32)
    grads: Dict = {
        "embed": torch.zeros(embed.shape, dtype=torch.float32,
                             device=embed.device).index_add_(
            0, tokens.reshape(-1).to(embed.device),
            dx32.reshape(-1, dx32.shape[-1])).to(embed.dtype),
        "final_norm": head_grads["final_norm"],
        "lm_head": head_grads["lm_head"],
    }
    if config.positional != "rope":
        pos_embed = params["pos_embed"]
        dpos = torch.zeros(pos_embed.shape, dtype=torch.float32,
                           device=pos_embed.device)
        dpos[:seq] = dx32.sum(dim=0)
        grads["pos_embed"] = dpos.to(pos_embed.dtype)
    # the [pp, per_stage, ...] gradients back into the per-layer list
    # (over ranks: this rank's stage's [1, per_stage, ...] shard)
    n_stages = mesh.shape[pp_axis]
    per_stage = config.n_layers // n_stages
    if isinstance(mesh, RankMesh):
        grads["layers"] = [tree_map(lambda g, i=i: g.shards[0][0, i],
                                    stage_grads) for i in range(per_stage)]
    else:
        grads["layers"] = [
            tree_map(lambda g, s=s, i=i: g[s, i], stage_grads)
            for s in range(n_stages) for i in range(per_stage)]
    return loss, {key: grads[key] for key in params if key in grads}


class _Layer(nn.Module):
    def __init__(self, layer: Dict):
        super().__init__()
        # a dense layer has "mlp", an MoE layer "moe", as in the tree
        self.names = [name for name in ("attn", "norm1", "norm2", "mlp", "moe")
                      if name in layer]
        for name in self.names:
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(t) for k, t in layer[name].items()}))

    def tree(self) -> Dict:
        return {name: dict(getattr(self, name).items()) for name in self.names}


class Transformer(nn.Module):
    """The parameters as an ``nn.Module``; ``state_dict`` keys mirror the
    JAX tree paths.  ``forward(tokens)`` is :func:`transformer_apply`.
    ``parameters()`` are the very tensors :meth:`tree` hands out, so an
    optimizer over the module trains what the functional entry points
    read."""

    def __init__(self, config: TransformerConfig, params: Dict):
        super().__init__()
        check_config(config)
        self.config = config
        self.embed = nn.Parameter(params["embed"])
        if "pos_embed" in params:
            self.pos_embed = nn.Parameter(params["pos_embed"])
        self.layers = nn.ModuleList(_Layer(layer) for layer in params["layers"])
        self.final_norm = nn.ParameterDict(
            {"scale": nn.Parameter(params["final_norm"]["scale"])})
        self.lm_head = nn.Parameter(params["lm_head"])

    @classmethod
    def init(cls, config: TransformerConfig, generator: torch.Generator,
             device=None) -> "Transformer":
        return cls(config, transformer_init(config, generator, device))

    def tree(self) -> Dict:
        """The parameters as the JAX-layout nested dict (same tensors),
        for the functional entry points (prefill, decode)."""
        tree = {
            "embed": self.embed,
            "layers": [layer.tree() for layer in self.layers],
            "final_norm": dict(self.final_norm.items()),
            "lm_head": self.lm_head,
        }
        if hasattr(self, "pos_embed"):
            tree["pos_embed"] = self.pos_embed
        return tree

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_apply(self.tree(), tokens, self.config)
