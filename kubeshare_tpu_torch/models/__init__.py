from .decoding import (
    greedy_decode,
    greedy_decode_with_cache,
    init_kv_cache,
    make_decode_step,
    prefill,
    prefill_chunked,
    prefill_incremental,
    sample_decode,
    sample_decode_with_cache,
    speculative_greedy_decode,
    speculative_sample_decode,
)
from .mnist import MnistConfig, mnist_apply, mnist_init
from .transformer import (
    Transformer,
    TransformerConfig,
    transformer_apply,
    transformer_init,
)

__all__ = [
    "MnistConfig",
    "Transformer",
    "TransformerConfig",
    "greedy_decode",
    "greedy_decode_with_cache",
    "init_kv_cache",
    "make_decode_step",
    "mnist_apply",
    "mnist_init",
    "prefill",
    "prefill_chunked",
    "prefill_incremental",
    "sample_decode",
    "sample_decode_with_cache",
    "speculative_greedy_decode",
    "speculative_sample_decode",
    "transformer_apply",
    "transformer_init",
]
