"""Autoregressive decoding with a dense KV cache, port of
kubeshare_tpu/models/decoding.py (bulk and chunked prefill, greedy and
sampled decode).

The cache is ``{"k": [layers, batch, kv_heads, max_seq, head_dim],
"v": ..., "length": 0-d int64 tensor}`` in ``config.dtype``, all three
on the cache's device.  Unlike the JAX functions, which return a new
cache, the port updates the cache tensors **in place** (a decode step
writes its K/V into the slots at ``length`` and advances ``length``); a
function that takes a cache mutates it, and the returned cache is the
same dict, updated.  The position stays on the device: a cached step
writes K/V with ``index_copy_`` at ``length + arange(C)`` and gathers
``pos_embed`` rows, so it reads nothing back to the host and can be
captured in a CUDA graph (:func:`make_decode_step`).

Bulk :func:`prefill` is one dense forward, so on CUDA its attention runs
the flash kernel (``csrc/flash_fwd.cu``); the cached steps attend with
:func:`_attend_cached`, plain einsums here as in JAX.  Sampling takes a
``torch.Generator`` in place of PRNG keys: it draws one int64 seed per
emission up front (:func:`sampling_seeds`), and each draw is
``argmax(filtered / T + gumbel)`` with Gumbel noise hashed on the device
from (seed, vocabulary index) (:func:`pick_rows`).  A stream depends on
its seeds only, not on the batch it rides in, and the draw can be
captured; the serving engine uses the same schedule, so a single-slot
engine reproduces :func:`sample_decode_with_cache` token for token.

The speculative decoders (:func:`speculative_greedy_decode`,
:func:`speculative_sample_decode`) run a draft model's width-1 steps and
one width-``draft_len`` verify chunk of the target a round, rewinding
both caches' device ``length`` to the accepted prefix; the greedy one can
record a round in one CUDA graph (``capture=True``).

The entry points run without autograd (``torch.no_grad``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.rope import apply_rope
from ..parallel.train import CAPTURE_WARMUP_STEPS
from .transformer import (
    TransformerConfig,
    _forward,
    _moe_or_mlp,
    _project,
    _rms_norm,
    _select_attention,
    check_config,
)


def _check_moe_decodable(config: TransformerConfig) -> None:
    """The routing contract every cached path shares (decode step, both
    prefills, the paged steps)."""
    if config.moe_routing == "experts_choose":
        raise ValueError(
            "expert-choice routing cannot be replayed token-by-token (an "
            "expert's choices depend on the whole sequence); decode "
            "requires moe_routing='tokens_choose'"
        )
    if config.moe_routing != "tokens_choose":
        raise ValueError(f"unknown moe_routing {config.moe_routing!r}")


def _cached_ffn(layer: Dict, config: TransformerConfig,
                y: torch.Tensor) -> torch.Tensor:
    """The feed-forward of a cached step over y [rows, C, d]: an MoE
    layer's capacity is pinned to the rows x C tokens of the call, so no
    choice ever drops (a token routes to an expert at most once) and a
    token's output depends on no other row or position of the call."""
    if "moe" in layer:
        _check_moe_decodable(config)
    out, _ = _moe_or_mlp(layer, config, y, capacity=y.shape[0] * y.shape[1])
    return out


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
    length = int(cache["length"])  # the one host read, before the loop
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
        "length": torch.zeros((), dtype=torch.int64, device=device),
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
                  head_row: Optional[int] = None,
                  write: Optional[torch.Tensor] = None):
    """A width-C cached step: tokens [batch, C] at positions
    ``length .. length+C-1`` -> (logits [batch, C, vocab], cache).

    The chunk's K/V are written into the cache (in place) first, then its
    queries attend the whole cache under the per-query causal band.
    ``head_last_only`` projects the final row only ([batch, 1, vocab]);
    ``head_row`` selects one other row instead.  ``write`` (a 0-d bool
    tensor) gates the K/V write: where it is false the cache keeps its
    rows and the positions are clamped to the cache, so a step past the
    cache's end (a captured speculative round after completion) stays in
    bounds and changes nothing but ``length``."""
    dtype = config.dtype
    length = cache["length"]
    chunk = tokens.shape[1]
    positions = length + torch.arange(chunk, device=tokens.device)
    if write is not None:
        positions = positions.clamp(max=cache["k"].shape[3] - 1)
    x = params["embed"][tokens].to(dtype)  # [b,C,d]
    use_rope = config.positional == "rope"
    if not use_rope:
        x = x + params["pos_embed"][positions].to(dtype)

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
        if write is not None:
            k = torch.where(write, k, cache_k.index_select(2, positions))
            v = torch.where(write, v, cache_v.index_select(2, positions))
        cache_k.index_copy_(2, positions, k)
        cache_v.index_copy_(2, positions, v)
        o = _attend_cached(q, cache_k, cache_v, positions,
                           window=config.attention_window).to(dtype)
        x = x + torch.einsum("bhsk,hkd->bsd", o,
                             layer["attn"]["wo"].to(dtype))
        y = _rms_norm(x, layer["norm2"]["scale"])
        x = x + _cached_ffn(layer, config, y)

    x = _rms_norm(x, params["final_norm"]["scale"])
    if head_last_only:
        head_in = x[:, -1:]
    elif head_row is not None:
        head_in = x[:, head_row: head_row + 1]
    else:
        head_in = x
    logits = (head_in @ params["lm_head"].to(dtype)).to(torch.float32)
    length.add_(chunk)
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
    # the same refusal as the decode step: the cache this prefill feeds
    # could never be decoded from
    _check_moe_decodable(config)
    kv_sink: list = []
    hidden, _ = _forward(params, prompt, config,
                         _select_attention(config, prompt.device), 0,
                         apply_head=False, kv_sink=kv_sink)
    cache = init_kv_cache(config, batch, prompt.device)
    for layer_idx, (k, v) in enumerate(kv_sink):
        cache["k"][layer_idx, :, :, :prompt_len] = k
        cache["v"][layer_idx, :, :, :prompt_len] = v
    cache["length"].fill_(prompt_len)
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
    _check_moe_decodable(config)
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
        cache["length"].fill_(prompt_len - width)
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
    cache["length"].fill_(prompt_len)
    return cache, row_logits[:, 0]


def prefill_incremental(params: Dict, config: TransformerConfig,
                        prompt: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Token-at-a-time prefill through the decode step: the bulk
    prefill's equivalence oracle.  Exactly :func:`prefill_chunked` at
    width 1."""
    return prefill_chunked(params, config, prompt, 1)


@torch.no_grad()
def greedy_decode_with_cache(params: Dict, config: TransformerConfig,
                             cache: Dict, last_logits: torch.Tensor,
                             max_new_tokens: int,
                             prefill_length: Optional[int] = None,
                             capture: bool = False) -> torch.Tensor:
    """Greedy continuation from a prefilled cache (updated in place).
    Returns [batch, max_new_tokens] int64 token ids; argmax runs on the
    f32 logits and returns the first maximal index, as jnp.argmax.
    ``capture=True`` runs each step as one CUDA graph replay
    (:func:`make_decode_step`); it needs a CUDA cache."""
    _check_cache_headroom(cache, max_new_tokens, prefill_length)
    return _continue(params, config, cache, last_logits, max_new_tokens,
                     lambda logits, i: torch.argmax(logits, dim=-1), capture)


def greedy_decode(params: Dict, config: TransformerConfig,
                  prompt: torch.Tensor, max_new_tokens: int) -> torch.Tensor:
    """Greedy generation: returns [batch, max_new_tokens] token ids."""
    _check_total_fits(config, prompt.shape[1], max_new_tokens)
    cache, logits = prefill(params, config, prompt)
    return greedy_decode_with_cache(params, config, cache, logits,
                                    max_new_tokens)


def _continue(params: Dict, config: TransformerConfig, cache: Dict,
              last_logits: torch.Tensor, max_new_tokens: int, pick,
              capture: bool) -> torch.Tensor:
    """The decode loop: ``pick(logits, i)`` chooses emission ``i`` (the
    first from the prefill's logits), each later one after a cached
    step.  Nothing here reads the device back."""
    step = make_decode_step(params, config, last_logits.shape[0],
                            capture=capture)
    token = pick(last_logits, 0)
    tokens = [token]
    for i in range(1, max_new_tokens):
        token = pick(step(cache, token), i)
        tokens.append(token)
    return torch.stack(tokens, dim=1)


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


# Wellons' 32-bit integer hash ("lowbias"-style, both multipliers below
# 2**31): every intermediate of _hash32 stays under 2**63, so torch's
# int64 arithmetic computes it exactly on any device
_MASK32 = 0xFFFFFFFF
_HASH_MUL = (0x21F0AAAD, 0x735A2D97)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """x: int64 in [0, 2**32) -> int64 in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL[0]) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _HASH_MUL[1]) & _MASK32
    return x ^ (x >> 15)


def sampling_seeds(generator: torch.Generator, rows: int,
                   count: int) -> torch.Tensor:
    """[rows, count] int64 seeds in [0, 2**62), one per emission, drawn
    from ``generator`` on its own device: the whole key schedule of a
    sampled continuation, drawn up front."""
    return torch.randint(0, 2 ** 62, (rows, count), generator=generator,
                         device=generator.device, dtype=torch.int64)


def hash_uniform(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """Uniforms in (0, 1) [..., vocab] f32, a pure function of (seed,
    index): a counter-based hash of the two, 23 bits of it."""
    index = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    low = (seeds & _MASK32)[..., None]
    high = ((seeds >> 32) & _MASK32)[..., None]
    bits = _hash32(_hash32(low ^ index) ^ high)
    return ((bits >> 9).to(torch.float32) * 2 + 1) * 2.0 ** -24


def gumbel_noise(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [..., vocab] f32, a pure function of
    (seed, vocabulary index): -log(-log(u)) of :func:`hash_uniform`."""
    return -torch.log(-torch.log(hash_uniform(seeds, vocab)))


def pick_rows(logits: torch.Tensor, temps: torch.Tensor,
              seeds: torch.Tensor, top_k: Optional[int] = None,
              top_p: Optional[float] = None) -> torch.Tensor:
    """One token per row of [rows, vocab] f32 logits: the argmax where
    ``temps`` [rows] is 0, else a draw from the temperature-scaled,
    top-k / top-p filtered distribution by the Gumbel-max trick under
    that row's ``seeds`` [rows] (int64) -> [rows] int64."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    filtered = _filter_logits(logits / safe_t[:, None], top_k, top_p)
    sampled = torch.argmax(
        filtered + gumbel_noise(seeds, logits.shape[-1]), dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def sample_decode(params: Dict, config: TransformerConfig,
                  prompt: torch.Tensor, generator: torch.Generator,
                  max_new_tokens: int, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Sampled generation: temperature, then top-k, then nucleus (top-p).
    ``temperature=0`` is exact greedy.  The same seed gives the same
    stream."""
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
                             prefill_length: Optional[int] = None,
                             capture: bool = False) -> torch.Tensor:
    """Sampled continuation from a prefilled cache (updated in place).
    The seeds of every row and emission are drawn from ``generator``
    first (:func:`sampling_seeds`, [batch, max_new_tokens]); emission
    ``i`` of row ``b`` is :func:`pick_rows` under seed ``[b, i]``."""
    _check_sampling_args(temperature, top_k, top_p)
    if temperature == 0.0:
        return greedy_decode_with_cache(params, config, cache, last_logits,
                                        max_new_tokens, prefill_length,
                                        capture=capture)
    _check_cache_headroom(cache, max_new_tokens, prefill_length)
    batch = last_logits.shape[0]
    seeds = sampling_seeds(generator, batch, max_new_tokens).to(
        last_logits.device)
    temps = torch.full((batch,), temperature, dtype=torch.float32,
                       device=last_logits.device)
    return _continue(
        params, config, cache, last_logits, max_new_tokens,
        lambda logits, i: pick_rows(logits, temps, seeds[:, i], top_k, top_p),
        capture)


def capture_graph(fn: Callable[[], object], device: torch.device,
                  pool=None, after_warmup: Optional[Callable[[], None]] = None):
    """Warm ``fn`` up on a side stream (``CAPTURE_WARMUP_STEPS`` calls,
    each followed by ``after_warmup``), then record one call of it in a
    CUDA graph drawing on ``pool``; returns (graph, the recorded call's
    outputs: the graph's static tensors, which every replay rewrites)."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP_STEPS):
            fn()
            if after_warmup is not None:
                after_warmup()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outputs = fn()
    return graph, outputs


def make_decode_step(params: Dict, config: TransformerConfig, batch: int,
                     capture: bool = True):
    """A one-token cached step, ``step(cache, token [batch]) -> logits
    [batch, vocab] f32``, writing the token's K/V at ``cache["length"]``
    and advancing it, in place.

    ``capture=True`` returns a :class:`CapturedDecodeStep` (one CUDA
    graph replay a step, the counterpart of JAX's jitted decode step);
    ``capture=False`` the eager step, which is the CPU path and the
    captured one's oracle."""
    check_config(config)
    if capture:
        return CapturedDecodeStep(params, config, batch)

    def step(cache: Dict, token: torch.Tensor) -> torch.Tensor:
        return _decode_one(params, config, cache, token)[0]

    return step


class CapturedDecodeStep:
    """The dense decode step captured in one CUDA graph.

    The first call binds the step to the cache it is given: it copies
    the token into a static buffer, warms up on a side stream (each
    pass's length advance undone; its K/V write lands in the slot the
    first replay overwrites), and captures the step.  Every call then
    copies its token into the buffer and replays; the graph reads the
    position from ``cache["length"]`` on the device and advances it
    there.  A call with another cache raises: make one step per cache.
    The logits returned are a copy (the graph's own tensor is
    overwritten by the next replay)."""

    def __init__(self, params: Dict, config: TransformerConfig,
                 batch: int) -> None:
        self.params = params
        self.config = config
        self.batch = batch
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Tuple = ()
        self.token: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None

    def __call__(self, cache: Dict, token: torch.Tensor) -> torch.Tensor:
        if token.shape != (self.batch,):
            raise ValueError(
                f"token shape {tuple(token.shape)}, the step decodes "
                f"({self.batch},)")
        if self.graph is None:
            self._capture(cache, token)
        elif any(given is not bound for given, bound in zip(
                (cache["k"], cache["v"], cache["length"]), self.bound)):
            raise ValueError(
                "a captured decode step replays the cache it was captured "
                "with; make another step for another cache")
        self.token.copy_(token)
        self.graph.replay()
        return self.logits.clone()

    def _capture(self, cache: Dict, token: torch.Tensor) -> None:
        device = cache["k"].device
        if device.type != "cuda":
            raise RuntimeError(
                "capture=True records the decode step in a CUDA graph and "
                f"needs a CUDA cache, got {device}; use capture=False on "
                "the CPU")
        length = cache["length"]
        self.token = token.to(device=device, dtype=torch.int64, copy=True)
        saved = length.clone()
        self.graph, (self.logits, _) = capture_graph(
            lambda: _decode_one(self.params, self.config, cache, self.token),
            device, after_warmup=lambda: length.copy_(saved))
        self.bound = (cache["k"], cache["v"], length)


def _check_speculative_args(config: TransformerConfig,
                            draft_config: TransformerConfig,
                            prompt_len: int, max_new_tokens: int,
                            draft_len: int) -> None:
    """Shared validation for both speculative decoders: generation
    length, draft width, vocabulary match, and ``draft_len`` slots of
    cache headroom in BOTH models."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if draft_len < 2:
        raise ValueError(f"draft_len must be >= 2, got {draft_len}")
    if config.vocab_size != draft_config.vocab_size:
        raise ValueError(
            f"target and draft vocabularies differ "
            f"({config.vocab_size} vs {draft_config.vocab_size})")
    total = prompt_len + max_new_tokens + draft_len
    for name, c in (("target", config), ("draft", draft_config)):
        if total > c.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens + draft_len = {total} exceeds "
                f"the {name} max_seq_len {c.max_seq_len} (speculation "
                f"needs draft_len slots of cache headroom)")


def speculative_acceptance(proposal: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """The exact-match acceptance rule every speculative decoder here
    shares: the number of leading proposed tokens ``proposal`` [..., k]
    that the target's own picks ``targets`` [..., >= k] agree with, in
    ``0..k`` (int64 [...]).  The emitted round is then
    ``targets[..., :m + 1]``, which is why speculative streams equal the
    non-speculative ones.  Unused proposal slots must carry an
    impossible token (-1), so a pad never matches."""
    k = proposal.shape[-1]
    matches = torch.cumprod((proposal == targets[..., :k]).to(torch.int64),
                            dim=-1)
    return matches.sum(dim=-1)


def _speculative_round(params: Dict, config: TransformerConfig,
                       draft_params: Dict, draft_config: TransformerConfig,
                       state: Dict, max_new_tokens: int,
                       draft_len: int) -> None:
    """One greedy speculative round, in place on ``state``'s device
    tensors, reading nothing back: the draft's ``draft_len`` width-1
    steps (the last feeds p_{k-1}, so the draft cache covers a full
    accept), the target's width-``draft_len`` verify chunk, the batch-min
    acceptance, the stream write at the device offset ``n_done`` and both
    caches' rewind to ``length + m + 1``.  A round entered with
    ``n_done >= max_new_tokens`` changes nothing: every write is gated."""
    cache, dcache = state["cache"], state["dcache"]
    out, n_done, last = state["out"], state["n_done"], state["last"]
    go = n_done < max_new_tokens
    start = cache["length"].clone()
    tok, steps = last, []
    for _ in range(draft_len):
        logits, _ = _decode_chunk(draft_params, draft_config, dcache,
                                  tok[:, None], write=go)
        tok = torch.argmax(logits[:, 0], dim=-1)
        steps.append(tok)
    proposal = torch.stack(steps[: draft_len - 1], dim=1)  # [b, k-1]
    chunk = torch.cat([last[:, None], proposal], dim=1)
    logits, _ = _decode_chunk(params, config, cache, chunk, write=go)
    targets = torch.argmax(logits, dim=-1)  # [b, k]
    m = speculative_acceptance(proposal, targets).min()
    idx = torch.arange(draft_len, device=out.device)
    stream = torch.where(idx[None, :] < m, F.pad(proposal, (0, 1)), targets)
    cols = (n_done + idx).clamp(max=out.shape[1] - 1)
    out.index_copy_(1, cols, torch.where(go, stream,
                                         out.index_select(1, cols)))
    emitted = (m + 1) * go
    cache["length"].copy_(start + emitted)
    dcache["length"].copy_(start + emitted)
    picked = torch.gather(stream, 1, m.expand(stream.shape[0], 1))[:, 0]
    last.copy_(torch.where(go, picked, last))
    n_done.add_(emitted)
    state["rounds"].add_(go.to(torch.int64))


@torch.no_grad()
def speculative_state(params: Dict, config: TransformerConfig,
                      draft_params: Dict, draft_config: TransformerConfig,
                      prompt: torch.Tensor, max_new_tokens: int,
                      draft_len: int) -> Dict:
    """A greedy speculative decode's device state after both prefills:
    the two caches, the stream ``out`` [batch, max_new + draft_len] with
    the first token written, ``last``, ``n_done`` (1) and ``rounds``
    (0), each round updating them in place (:func:`_speculative_round`)."""
    batch, prompt_len = prompt.shape
    _check_speculative_args(config, draft_config, prompt_len,
                            max_new_tokens, draft_len)
    cache, logits = prefill(params, config, prompt)
    dcache, _ = prefill(draft_params, draft_config, prompt)
    first = torch.argmax(logits, dim=-1)
    out = torch.zeros((batch, max_new_tokens + draft_len), dtype=torch.int64,
                      device=prompt.device)
    out[:, 0] = first
    return {"cache": cache, "dcache": dcache, "out": out, "last": first,
            "n_done": torch.ones((), dtype=torch.int64, device=prompt.device),
            "rounds": torch.zeros((), dtype=torch.int64,
                                  device=prompt.device)}


@torch.no_grad()
def make_speculative_round(params: Dict, config: TransformerConfig,
                           draft_params: Dict,
                           draft_config: TransformerConfig, state: Dict,
                           max_new_tokens: int, draft_len: int,
                           capture: bool = False) -> Callable[[], None]:
    """One greedy speculative round on ``state`` as a call: eager, or
    (``capture=True``) one CUDA graph replay.  The capture's warm-up
    passes run with ``n_done`` at the end, so every write is gated off
    and the state is left as it was."""

    def one_round():
        _speculative_round(params, config, draft_params, draft_config, state,
                           max_new_tokens, draft_len)

    if not capture:
        return one_round
    device = state["out"].device
    if device.type != "cuda":
        raise RuntimeError(
            "capture=True records a speculative round in a CUDA graph and "
            f"needs CUDA tensors, got {device}")
    n_done = state["n_done"]
    saved = n_done.clone()
    n_done.fill_(max_new_tokens)
    graph, _ = capture_graph(one_round, device)
    n_done.copy_(saved)
    return graph.replay


@torch.no_grad()
def speculative_greedy_decode(params: Dict, config: TransformerConfig,
                              draft_params: Dict,
                              draft_config: TransformerConfig,
                              prompt: torch.Tensor, max_new_tokens: int,
                              draft_len: int = 4, return_stats: bool = False,
                              capture: bool = False):
    """Greedy generation with draft-model speculation: the token stream
    of :func:`greedy_decode` (up to floating-point argmax ties: the
    width-``draft_len`` verify chunk reduces in another order than
    width-1 steps) in fewer target passes.

    Each round the draft proposes ``draft_len - 1`` tokens one at a time,
    the target scores ``[last, proposal]`` in one cached chunk, and the
    longest matching prefix plus the target's own next pick is emitted
    (:func:`speculative_acceptance`; the batch shares one cache length,
    so acceptance is the minimum over rows).  Rejected positions' K/V are
    masked by the rewound length and overwritten by the next round.

    ``capture=True`` records one round in a CUDA graph
    (:func:`make_speculative_round`).  Either way the host runs
    ``ceil(remaining / draft_len)`` rounds (never more than are needed:
    a round emits at most ``draft_len``) and reads ``n_done`` between
    batches.  With ``return_stats`` the result is ``(tokens, {"rounds":
    r})``, r counting target verify passes."""
    state = speculative_state(params, config, draft_params, draft_config,
                              prompt, max_new_tokens, draft_len)
    one_round = make_speculative_round(
        params, config, draft_params, draft_config, state, max_new_tokens,
        draft_len, capture)
    while True:
        remaining = max_new_tokens - int(state["n_done"])
        if remaining <= 0:
            break
        for _ in range(-(-remaining // draft_len)):
            one_round()
    tokens = state["out"][:, :max_new_tokens]
    if return_stats:
        return tokens, {"rounds": int(state["rounds"])}
    return tokens


@torch.no_grad()
def speculative_sample_decode(params: Dict, config: TransformerConfig,
                              draft_params: Dict,
                              draft_config: TransformerConfig,
                              prompt: torch.Tensor,
                              generator: torch.Generator,
                              max_new_tokens: int, draft_len: int = 4,
                              temperature: float = 1.0,
                              top_k: Optional[int] = None,
                              top_p: Optional[float] = None,
                              return_stats: bool = False):
    """Sampled generation with draft-model speculation: the emitted
    stream has the target model's sampling distribution (accept draft
    token x with probability min(1, p(x)/q(x)); on rejection resample
    from norm(max(p - q, 0)); a fully accepted round earns a bonus token
    from the target's next position).  ``p`` and ``q`` are the
    temperature / top-k / top-p filtered distributions, so the output is
    distributed as :func:`sample_decode`'s with the same filters.

    The round structure is :func:`speculative_greedy_decode`'s.  The
    randomness is the port's seed scheme: one int64 seed a draw from
    ``generator`` (:func:`sampling_seeds`, 2 x ``draft_len`` a round and
    row), each categorical draw the Gumbel-max under its seed and each
    acceptance uniform :func:`hash_uniform` of its seed, so the same
    generator seed gives the same stream (not JAX's: its PRNG differs).
    Eager: the host reads each round's acceptance.  ``temperature == 0``
    delegates to the greedy decoder."""
    batch, prompt_len = prompt.shape
    _check_speculative_args(config, draft_config, prompt_len,
                            max_new_tokens, draft_len)
    _check_sampling_args(temperature, top_k, top_p)
    if temperature == 0.0:
        return speculative_greedy_decode(
            params, config, draft_params, draft_config, prompt,
            max_new_tokens, draft_len, return_stats=return_stats)
    k = draft_len
    device = prompt.device
    vocab = config.vocab_size

    def log_dist(logits):
        flat = logits.reshape(-1, logits.shape[-1])
        filtered = _filter_logits(flat / temperature, top_k, top_p)
        return torch.log_softmax(filtered, dim=-1).reshape(logits.shape)

    def draw(logp, seeds):
        return torch.argmax(logp + gumbel_noise(seeds, vocab), dim=-1)

    def gather(dist, tok):  # [k-1, b, vocab], [b, k-1] -> [k-1, b]
        return torch.gather(dist, 2, tok.T[..., None])[..., 0]

    cache, logits = prefill(params, config, prompt)
    dcache, _ = prefill(draft_params, draft_config, prompt)
    first_seeds = sampling_seeds(generator, batch, 1).to(device)
    last = draw(log_dist(logits), first_seeds[:, 0])
    out = torch.zeros((batch, max_new_tokens + k), dtype=torch.int64,
                      device=device)
    out[:, 0] = last
    n_done, rounds = 1, 0
    rows = torch.arange(batch, device=device)
    while n_done < max_new_tokens:
        # columns [0, k): the draft's draws; [k, 2k-1): the acceptance
        # uniforms; 2k-1: the correction / bonus draw
        seeds = sampling_seeds(generator, batch, 2 * k).to(device)
        tok, props, logqs = last, [], []
        for j in range(k):
            step_logits, _ = _decode_one(draft_params, draft_config, dcache,
                                         tok)
            logq = log_dist(step_logits)
            tok = draw(logq, seeds[:, j])
            props.append(tok)
            logqs.append(logq)
        proposal = torch.stack(props[: k - 1], dim=1)  # [b, k-1]
        logq = torch.stack(logqs[: k - 1])  # [k-1, b, vocab]
        chunk = torch.cat([last[:, None], proposal], dim=1)
        start = cache["length"].clone()
        chunk_logits, _ = _decode_chunk(params, config, cache, chunk)
        logp = log_dist(chunk_logits).transpose(0, 1)  # [k, b, vocab]

        ratio = gather(logp[: k - 1], proposal) - gather(logq, proposal)
        u = hash_uniform(seeds[:, k: 2 * k - 1], 1)[..., 0].T  # [k-1, b]
        accepted = torch.log(u) < ratio.clamp(max=0.0)
        row_accepts = torch.cumprod(accepted.T.to(torch.int64),
                                    dim=1).sum(dim=1)  # [b]
        m = int(row_accepts.min())

        bonus = m == k - 1
        pos = min(m, k - 2)
        p_m = logp[k - 1 if bonus else pos]
        if bonus:
            fix_dist = p_m
        else:
            residual = (p_m.exp() - logq[pos].exp()).clamp(min=0.0)
            # a numerically empty residual (p == q): acceptance almost
            # surely fired first; fall back to p
            empty = residual.sum(dim=-1, keepdim=True) <= 1e-9
            fix_dist = torch.where(empty, p_m, torch.log(torch.where(
                residual > 0, residual, torch.full_like(residual, 1e-38))))
        fix = draw(fix_dist, seeds[:, 2 * k - 1])
        if bonus:
            nxt = fix
        else:
            nxt = torch.where(row_accepts > m, proposal[rows, pos], fix)
        out[:, n_done: n_done + m] = proposal[:, :m]
        out[:, n_done + m] = nxt
        cache["length"].copy_(start + m + 1)
        dcache["length"].copy_(start + m + 1)
        last = nxt
        n_done += m + 1
        rounds += 1
    tokens = out[:, :max_new_tokens]
    return (tokens, {"rounds": rounds}) if return_stats else tokens
