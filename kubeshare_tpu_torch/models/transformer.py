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
logits as a ``ShardedTensor``.

Not in this port yet (ROADMAP.md queue A): the ring / Ulysses /
pipelined entries and a batch split along the sequence (item 11).
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
from ..ops.rope import apply_rope, rope_positions
from ..parallel.mesh import (Mesh, P, PartitionSpec, ShardedTensor,
                             _split_names, batch_sharding, device_put)
from ..parallel.spmd import Units, mesh_of, place_plain, split_axis
from ..parallel.train import tree_leaves


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "auto"  # auto | reference | flash
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
    if config.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={config.attention!r} is not ported yet (ROADMAP.md "
            "queue A item 11, long context)")
    if config.attention not in ("auto", "reference", "flash"):
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


def _layer_forward(layer: Dict, x: torch.Tensor, attention_fn: AttentionFn,
                   config: TransformerConfig,
                   rope_positions_or_none: Optional[torch.Tensor],
                   moe_capacity: Optional[int] = None):
    """One layer; returns (x, aux, (k, v)): aux is the MoE
    load-balancing loss (None for a dense MLP), k/v the roped projections
    (the bulk prefill writes them straight into the decode cache)."""
    dtype = config.dtype
    y = _rms_norm(x, layer["norm1"]["scale"])
    q = _project(y, layer["attn"]["wq"])
    k = _project(y, layer["attn"]["wk"])
    v = _project(y, layer["attn"]["wv"])
    if rope_positions_or_none is not None:
        q = apply_rope(q, rope_positions_or_none)
        k = apply_rope(k, rope_positions_or_none)
    o = attention_fn(q, k, v).to(dtype)
    x = x + torch.einsum("bhsk,hkd->bsd", o, layer["attn"]["wo"].to(dtype))
    y = _rms_norm(x, layer["norm2"]["scale"])
    out, aux = _moe_or_mlp(layer, config, y, moe_capacity)
    return x + out, aux, (k, v)


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
    a ``ShardedTensor``."""
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


def _sharded_layer(units: Units, layer: Dict, xs: List[torch.Tensor],
                   attention_fn: AttentionFn, config: TransformerConfig,
                   positions: Optional[List[torch.Tensor]],
                   batch: Tuple[str, ...]):
    """One layer over the units: (xs, aux).  Heads split over an axis on
    which wq / wk / wv (dim 1) and wo (dim 0) agree run per unit on the
    unit's query and KV heads and psum the output projection; the MLP's
    hidden likewise (w_in dim 1, w_out dim 0); every other split of a
    weight (fsdp) is gathered at use."""
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
    parts = []
    for u, x in enumerate(xs):
        y = _rms_norm(x, norm1[u])
        q, k, v = _project(y, wq[u]), _project(y, wk[u]), _project(y, wv[u])
        if positions is not None:
            q = apply_rope(q, positions[u])
            k = apply_rope(k, positions[u])
        o = attention_fn(q, k, v).to(dtype)
        parts.append(torch.einsum("bhsk,hkd->bsd", o, wo[u].to(dtype)))
    if heads:
        parts = units.psum(parts, (heads,))
    xs = [x + part for x, part in zip(xs, parts)]
    ys = [_rms_norm(x, scale) for x, scale in zip(xs, norm2)]
    if "moe" in layer:
        e, d, f = layer["moe"]["w_in"].shape
        outs, aux = sharded_moe(units, layer["moe"], ys,
                                _moe_config(config, d, f, e), batch)
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


def _sharded_forward(params: Dict, tokens, config: TransformerConfig,
                     mesh: Mesh):
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
    ``ops.moe.sharded_moe``; ``config.remat`` recomputes each layer."""
    check_config(config)
    if not isinstance(tokens, ShardedTensor):
        tokens = device_put(tokens, batch_sharding(mesh, tokens.ndim))
    if any(_split_names(axes) for axes in tokens.spec[1:]):
        raise NotImplementedError(
            "a batch split along the sequence (sp) needs ring or Ulysses "
            "attention, not ported yet (ROADMAP.md queue A item 11)")
    params = place_plain(params, mesh)
    units = Units.of(mesh, [tokens.spec]
                     + [leaf.spec for leaf in tree_leaves(params)])
    batch = tuple(_split_names(tokens.spec[0] if tokens.spec else None))
    dtype = config.dtype
    seq = tokens.shape[1]
    toks = units.local(tokens, {0: batch})

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
    positions = None
    if config.positional == "rope":
        positions = [rope_positions(seq, 0, d) for d in units.devices]
    else:
        pos = units.local(params["pos_embed"])
        xs = [x + p[:seq].to(dtype) for x, p in zip(xs, pos)]

    attention_fn = _select_attention(config, units.devices[0])
    aux_total = torch.zeros((), dtype=torch.float32,
                            device=units.devices[0])
    for layer in params["layers"]:
        if config.remat:
            xs, aux = torch.utils.checkpoint.checkpoint(
                _sharded_layer, units, layer, xs, attention_fn, config,
                positions, batch, use_reentrant=False)
        else:
            xs, aux = _sharded_layer(units, layer, xs, attention_fn, config,
                                     positions, batch)
        if aux is not None:
            aux_total = aux_total + aux

    head = split_axis(batch, (params["lm_head"], 1))
    lm_head = units.local(params["lm_head"], {1: (head,)} if head else None)
    final = units.local(params["final_norm"]["scale"])
    logits = [(_rms_norm(x, scale) @ w.to(dtype)).to(torch.float32)
              for x, scale, w in zip(xs, final, lm_head)]
    spec = P(tokens.spec[0] if tokens.spec else None, None, head)
    shape = (tokens.shape[0], seq, params["lm_head"].shape[1])
    return units.assemble(logits, spec, shape), aux_total


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
