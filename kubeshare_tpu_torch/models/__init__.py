from .decoding import (
    greedy_decode,
    greedy_decode_with_cache,
    init_kv_cache,
    prefill,
    prefill_chunked,
    sample_decode,
    sample_decode_with_cache,
)
from .transformer import (
    Transformer,
    TransformerConfig,
    transformer_apply,
    transformer_init,
)

__all__ = [
    "Transformer",
    "TransformerConfig",
    "greedy_decode",
    "greedy_decode_with_cache",
    "init_kv_cache",
    "prefill",
    "prefill_chunked",
    "sample_decode",
    "sample_decode_with_cache",
    "transformer_apply",
    "transformer_init",
]
