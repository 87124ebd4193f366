"""Flagship decoder-only Transformer LM, port of the dense core of
kubeshare_tpu/models/transformer.py.

Parameters are a nested dict of f32 tensors with the JAX tree's layout
(``params["layers"][i]["attn"]["wq"]``...), so a JAX checkpoint converts
1:1 (:mod:`kubeshare_tpu_torch.convert`).  :class:`Transformer` holds the
same tensors as an ``nn.Module`` whose ``state_dict`` keys mirror the JAX
tree paths (``layers.0.attn.wq``, ``final_norm.scale``).  Compute casts
to ``config.dtype`` at the points the JAX code does: the embedding after
its gather, every weight at its matmul, the logits back to f32.

Not in this port yet (ROADMAP.md queue A): MoE layers (item 9), and the
ring / Ulysses / pipelined entries (item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.attention import attention_reference, flash_attention, use_kernel_default
from ..ops.rope import apply_rope, rope_positions


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
    # MoE layers are not ported yet; a config that sets this raises
    moe_every: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        """KV head count: n_kv_heads (GQA/MQA) or n_heads (MHA)."""
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def check_config(config: TransformerConfig) -> None:
    """Refuse what this port does not run (loudly, never approximated)."""
    if config.moe_every is not None:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md queue A item 9, "
            "ops/moe.py)")
    if config.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={config.attention!r} is not ported yet (ROADMAP.md "
            "queue A item 10, long context)")
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
    for _ in range(config.n_layers):
        params["layers"].append({
            "attn": {
                "wq": dense((d, h, hd), d),
                "wk": dense((d, h_kv, hd), d),
                "wv": dense((d, h_kv, hd), d),
                "wo": dense((h, hd, d), d),
            },
            "norm1": {"scale": ones()},
            "norm2": {"scale": ones()},
            "mlp": {
                "w_in": dense((d, f), d),
                "w_out": dense((f, d), f),
            },
        })
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


def _layer_forward(layer: Dict, x: torch.Tensor, attention_fn: AttentionFn,
                   dtype: torch.dtype,
                   rope_positions_or_none: Optional[torch.Tensor]):
    """One layer; returns (x, (k, v)) with the roped k/v projections (the
    bulk prefill writes them straight into the decode cache)."""
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
    x = x + _mlp(y, layer["mlp"])
    return x, (k, v)


def _forward(params: Dict, tokens: torch.Tensor, config: TransformerConfig,
             attention_fn: AttentionFn,
             pos_offset: Union[int, torch.Tensor] = 0,
             apply_head: bool = True,
             kv_sink: Optional[List] = None) -> torch.Tensor:
    """Shared forward body.  ``pos_offset``: a scalar offset, or a [seq]
    tensor of global positions.  ``apply_head=False`` returns the
    final-normed hidden states instead of logits.  ``kv_sink`` (a list)
    collects each layer's (k, v) projections."""
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

    for layer in params["layers"]:
        x, kv = _layer_forward(layer, x, attention_fn, dtype, positions)
        if kv_sink is not None:
            kv_sink.append(kv)

    x = _rms_norm(x, params["final_norm"]["scale"])
    if not apply_head:
        return x
    return (x @ params["lm_head"].to(dtype)).to(torch.float32)


def transformer_apply(params: Dict, tokens: torch.Tensor,
                      config: TransformerConfig) -> torch.Tensor:
    """tokens: [batch, seq] integer -> logits [batch, seq, vocab] f32.

    On CUDA with attention ``auto``/``flash`` the flash kernel is
    forward-only: call under ``torch.no_grad()`` or
    ``torch.inference_mode()``."""
    return _forward(params, tokens, config,
                    _select_attention(config, tokens.device), 0)


class _Layer(nn.Module):
    def __init__(self, layer: Dict):
        super().__init__()
        for name in ("attn", "norm1", "norm2", "mlp"):
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(t) for k, t in layer[name].items()}))

    def tree(self) -> Dict:
        return {name: dict(getattr(self, name).items())
                for name in ("attn", "norm1", "norm2", "mlp")}


class Transformer(nn.Module):
    """The parameters as an ``nn.Module``; ``state_dict`` keys mirror the
    JAX tree paths.  ``forward(tokens)`` is :func:`transformer_apply`."""

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
