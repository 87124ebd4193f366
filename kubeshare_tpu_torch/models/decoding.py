"""Autoregressive decoding with a dense KV cache, port of
kubeshare_tpu/models/decoding.py (bulk and chunked prefill, greedy and
sampled decode).

The cache is ``{"k": [layers, batch, kv_heads, max_seq, head_dim],
"v": ..., "length": int}`` in ``config.dtype``.  Unlike the JAX
functions, which return a new cache, the port updates the cache tensors
**in place** (a decode step writes its K/V into the slots at
``length``); a function that takes a cache mutates it, and the returned
cache is the same dict, updated.

Bulk :func:`prefill` is one dense forward, so on CUDA its attention runs
the flash kernel (``csrc/flash_fwd.cu``); the cached steps attend with
:func:`_attend_cached`, plain einsums here as in JAX.  Sampling takes a
``torch.Generator`` (on the logits' device) in place of PRNG keys.

The entry points run without autograd (``torch.no_grad``).  Not ported
yet (ROADMAP.md queue A item 4): the speculative decoders.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.rope import apply_rope
from .transformer import (
    TransformerConfig,
    _forward,
    _mlp,
    _project,
    _rms_norm,
    _select_attention,
    check_config,
)


def _check_cache_headroom(cache: Dict, max_new_tokens: int,
                          prefill_length: Optional[int] = None) -> None:
    """Refuse a continuation that would write past the cache's end."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    capacity = cache["k"].shape[3]
    if prefill_length is not None and prefill_length + max_new_tokens > capacity:
        raise ValueError(
            f"prefill_length {prefill_length} + max_new_tokens "
            f"{max_new_tokens} exceeds the cache capacity {capacity}"
        )
    length = int(cache["length"])
    if length + max_new_tokens > capacity:
        raise ValueError(
            f"cache length {length} + max_new_tokens {max_new_tokens} "
            f"exceeds the cache capacity {capacity}"
        )


def _check_prompt_fits(config: TransformerConfig, prompt_len: int) -> None:
    if prompt_len > config.max_seq_len:
        raise ValueError(
            f"prompt length {prompt_len} exceeds max_seq_len "
            f"{config.max_seq_len}"
        )


def _check_total_fits(config: TransformerConfig, prompt_len: int,
                      max_new_tokens: int) -> None:
    total = prompt_len + max_new_tokens
    if total > config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"= {total} exceeds max_seq_len {config.max_seq_len}"
        )


def init_kv_cache(config: TransformerConfig, batch: int, device) -> Dict:
    """Zeroed [layers x batch x kv_heads x max_seq x head_dim] cache."""
    shape = (config.n_layers, batch, config.kv_heads, config.max_seq_len,
             config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
        "length": 0,
    }


def _attend_cached(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, q_positions: torch.Tensor,
                   window: Optional[int] = None) -> torch.Tensor:
    """q: [b,h,Cq,d] against cache [b,h_kv,S,d]; per-query causal band.

    Query i sees cache slots ``k_pos <= q_positions[i]`` (and, with a
    window, ``q_pos - k_pos < window``).  ``q_positions`` [Cq] is shared
    by the batch; [b, Cq] gives each row its own positions.  GQA groups
    the query heads over the shared KV heads ([b, h_kv, g, Cq, d]); KV is
    never repeated.  The score einsum runs in the cache dtype and is cast
    to f32 before scaling, as in JAX.
    """
    b, h, cq, d = q.shape
    h_kv = cache_k.shape[1]
    group = h // h_kv
    scale = d ** -0.5
    qg = q.reshape(b, h_kv, group, cq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, cache_k).to(
        torch.float32) * scale
    k_pos = torch.arange(cache_k.shape[2], device=q.device)
    if q_positions.ndim == 1:
        valid = k_pos[None, :] <= q_positions[:, None]  # [Cq, S]
        if window is not None:
            valid = valid & (q_positions[:, None] - k_pos[None, :] < window)
        valid = valid[None, None, None]  # -> [1,1,1,Cq,S]
    else:
        valid = k_pos[None, None, :] <= q_positions[:, :, None]  # [b, Cq, S]
        if window is not None:
            valid = valid & (
                q_positions[:, :, None] - k_pos[None, None, :] < window)
        valid = valid[:, None, None]  # -> [b,1,1,Cq,S]
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, cache_v)
    return out.reshape(b, h, cq, d)


def _decode_chunk(params: Dict, config: TransformerConfig, cache: Dict,
                  tokens: torch.Tensor, head_last_only: bool = False,
                  head_row: Optional[int] = None):
    """A width-C cached step: tokens [batch, C] at positions
    ``length .. length+C-1`` -> (logits [batch, C, vocab], cache).

    The chunk's K/V are written into the cache (in place) first, then its
    queries attend the whole cache under the per-query causal band.
    ``head_last_only`` projects the final row only ([batch, 1, vocab]);
    ``head_row`` selects one other row instead."""
    dtype = config.dtype
    position = int(cache["length"])
    chunk = tokens.shape[1]
    positions = position + torch.arange(chunk, device=tokens.device)
    x = params["embed"][tokens].to(dtype)  # [b,C,d]
    use_rope = config.positional == "rope"
    if not use_rope:
        x = x + params["pos_embed"][position: position + chunk].to(dtype)

    for layer_idx, layer in enumerate(params["layers"]):
        y = _rms_norm(x, layer["norm1"]["scale"])
        q = _project(y, layer["attn"]["wq"])
        k = _project(y, layer["attn"]["wk"])
        v = _project(y, layer["attn"]["wv"])
        if use_rope:
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        cache_k = cache["k"][layer_idx]
        cache_v = cache["v"][layer_idx]
        cache_k[:, :, position: position + chunk] = k
        cache_v[:, :, position: position + chunk] = v
        o = _attend_cached(q, cache_k, cache_v, positions,
                           window=config.attention_window).to(dtype)
        x = x + torch.einsum("bhsk,hkd->bsd", o,
                             layer["attn"]["wo"].to(dtype))
        y = _rms_norm(x, layer["norm2"]["scale"])
        x = x + _mlp(y, layer["mlp"])

    x = _rms_norm(x, params["final_norm"]["scale"])
    if head_last_only:
        head_in = x[:, -1:]
    elif head_row is not None:
        head_in = x[:, head_row: head_row + 1]
    else:
        head_in = x
    logits = (head_in @ params["lm_head"].to(dtype)).to(torch.float32)
    cache["length"] = position + chunk
    return logits, cache


def _decode_one(params: Dict, config: TransformerConfig, cache: Dict,
                token: torch.Tensor):
    """One decode step: token [batch] -> (logits [batch, vocab], cache)."""
    logits, cache = _decode_chunk(params, config, cache, token[:, None])
    return logits[:, 0], cache


@torch.no_grad()
def prefill(params: Dict, config: TransformerConfig,
            prompt: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Feed the prompt [batch, prompt_len] through a new cache; returns
    (cache, last_logits [batch, vocab] f32).

    One dense forward pass (the flash kernel on CUDA) that also collects
    every layer's roped K/V and writes them into the cache in bulk."""
    check_config(config)
    batch, prompt_len = prompt.shape
    _check_prompt_fits(config, prompt_len)
    kv_sink: list = []
    hidden = _forward(params, prompt, config,
                      _select_attention(config, prompt.device), 0,
                      apply_head=False, kv_sink=kv_sink)
    cache = init_kv_cache(config, batch, prompt.device)
    for layer_idx, (k, v) in enumerate(kv_sink):
        cache["k"][layer_idx, :, :, :prompt_len] = k
        cache["v"][layer_idx, :, :, :prompt_len] = v
    cache["length"] = prompt_len
    last_logits = (
        hidden[:, -1] @ params["lm_head"].to(config.dtype)
    ).to(torch.float32)
    return cache, last_logits


def bucket_width(remainder: int, chunk: int) -> int:
    """The power-of-two chunk width covering ``remainder`` tokens (capped
    at ``chunk``)."""
    if not 0 < remainder <= chunk:
        raise ValueError(f"remainder {remainder} not in 1..{chunk}")
    width = 1
    while width < remainder:
        width *= 2
    return min(width, chunk)


@torch.no_grad()
def prefill_chunked(params: Dict, config: TransformerConfig,
                    prompt: torch.Tensor,
                    chunk: int) -> Tuple[Dict, torch.Tensor]:
    """Prefill in fixed-size cached chunks (:func:`_decode_chunk`), so
    peak activation memory is O(chunk).

    A ragged tail runs as one extra chunk of ``bucket_width`` width that
    slides back over already-written positions (recomputing identical
    K/V) so its last row is the prompt's last token.  A prompt shorter
    than its own bucket pads forward instead; the pad rows' K/V are
    zeroed and the logits taken at the last real row, so the cache and
    logits match the bulk prefill's."""
    check_config(config)
    batch, prompt_len = prompt.shape
    _check_prompt_fits(config, prompt_len)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cache = init_kv_cache(config, batch, prompt.device)
    n_full, remainder = divmod(prompt_len, chunk)
    last_logits = None
    for i in range(n_full):
        logits, cache = _decode_chunk(
            params, config, cache, prompt[:, i * chunk: (i + 1) * chunk],
            head_last_only=True)
        last_logits = logits[:, 0]
    if remainder == 0:
        return cache, last_logits

    # cap at the cache bound: a short model must not pad past its cache
    width = min(bucket_width(remainder, chunk), config.max_seq_len)
    if prompt_len >= width:
        # slide the final chunk back so it ends at the last real token
        cache["length"] = prompt_len - width
        tail_logits, cache = _decode_chunk(
            params, config, cache, prompt[:, prompt_len - width:],
            head_last_only=True)
        return cache, tail_logits[:, 0]

    # n_full == 0 and the bucket overshoots the prompt: pad the tail
    padded = F.pad(prompt, (0, width - prompt_len))
    row_logits, cache = _decode_chunk(params, config, cache, padded,
                                      head_row=prompt_len - 1)
    cache["k"][:, :, :, prompt_len:width] = 0
    cache["v"][:, :, :, prompt_len:width] = 0
    cache["length"] = prompt_len
    return cache, row_logits[:, 0]


@torch.no_grad()
def greedy_decode_with_cache(params: Dict, config: TransformerConfig,
                             cache: Dict, last_logits: torch.Tensor,
                             max_new_tokens: int,
                             prefill_length: Optional[int] = None
                             ) -> torch.Tensor:
    """Greedy continuation from a prefilled cache (updated in place).
    Returns [batch, max_new_tokens] int64 token ids; argmax runs on the
    f32 logits and returns the first maximal index, as jnp.argmax."""
    _check_cache_headroom(cache, max_new_tokens, prefill_length)
    token = torch.argmax(last_logits, dim=-1)
    tokens = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = _decode_one(params, config, cache, token)
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
    return torch.stack(tokens, dim=1)


def greedy_decode(params: Dict, config: TransformerConfig,
                  prompt: torch.Tensor, max_new_tokens: int) -> torch.Tensor:
    """Greedy generation: returns [batch, max_new_tokens] token ids."""
    _check_total_fits(config, prompt.shape[1], max_new_tokens)
    cache, logits = prefill(params, config, prompt)
    return greedy_decode_with_cache(params, config, cache, logits,
                                    max_new_tokens)


def _filter_logits(logits: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Restrict [batch, vocab] logits to the top-k / nucleus (top-p) set,
    -inf elsewhere."""
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, float("-inf")))
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # a token stays if the mass before it is still < top_p
        keep_sorted = torch.cat(
            [torch.ones_like(cum[:, :1], dtype=torch.bool),
             cum[:, :-1] < top_p], dim=-1)
        cutoff = torch.where(
            keep_sorted, sorted_logits,
            torch.full_like(sorted_logits, float("inf"))
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


def _check_sampling_args(temperature: float, top_k, top_p) -> None:
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    _filter_logits(torch.zeros((1, 2)), top_k, top_p)


def sample_decode(params: Dict, config: TransformerConfig,
                  prompt: torch.Tensor, generator: torch.Generator,
                  max_new_tokens: int, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Sampled generation: temperature, then top-k, then nucleus (top-p).
    ``temperature=0`` is exact greedy.  ``generator`` lives on the
    prompt's device; the same seed gives the same stream."""
    _check_total_fits(config, prompt.shape[1], max_new_tokens)
    _check_sampling_args(temperature, top_k, top_p)
    if temperature == 0.0:
        return greedy_decode(params, config, prompt, max_new_tokens)
    cache, logits = prefill(params, config, prompt)
    return sample_decode_with_cache(
        params, config, cache, logits, generator, max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p)


@torch.no_grad()
def sample_decode_with_cache(params: Dict, config: TransformerConfig,
                             cache: Dict, last_logits: torch.Tensor,
                             generator: torch.Generator,
                             max_new_tokens: int, temperature: float = 1.0,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             prefill_length: Optional[int] = None
                             ) -> torch.Tensor:
    """Sampled continuation from a prefilled cache (updated in place)."""
    _check_sampling_args(temperature, top_k, top_p)
    if temperature == 0.0:
        return greedy_decode_with_cache(params, config, cache, last_logits,
                                        max_new_tokens, prefill_length)
    _check_cache_headroom(cache, max_new_tokens, prefill_length)

    def pick(logits):
        filtered = _filter_logits(logits / temperature, top_k, top_p)
        probs = torch.softmax(filtered, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    token = pick(last_logits)
    tokens = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = _decode_one(params, config, cache, token)
        token = pick(logits)
        tokens.append(token)
    return torch.stack(tokens, dim=1)
