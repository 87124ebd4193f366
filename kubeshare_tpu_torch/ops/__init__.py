from .attention import (
    attention_reference,
    block_sparse_attention,
    block_sparse_reference,
    flash_attention,
    flash_forward,
    flash_forward_reference,
    use_kernel_default,
)
from .rope import apply_rope, rope_frequencies, rope_positions

__all__ = [
    "apply_rope",
    "attention_reference",
    "block_sparse_attention",
    "block_sparse_reference",
    "flash_attention",
    "flash_forward",
    "flash_forward_reference",
    "rope_frequencies",
    "rope_positions",
    "use_kernel_default",
]
