from .attention import (
    attention_reference,
    block_sparse_attention,
    block_sparse_reference,
    flash_attention,
    flash_forward,
    flash_forward_reference,
    use_kernel_default,
)
from .moe import MoEConfig, moe_apply, moe_init, moe_sharding_rules
from .rope import apply_rope, rope_frequencies, rope_positions

__all__ = [
    "MoEConfig",
    "apply_rope",
    "attention_reference",
    "block_sparse_attention",
    "block_sparse_reference",
    "flash_attention",
    "flash_forward",
    "flash_forward_reference",
    "moe_apply",
    "moe_init",
    "moe_sharding_rules",
    "rope_frequencies",
    "rope_positions",
    "use_kernel_default",
]
