"""Rotary position embeddings (RoPE), port of kubeshare_tpu/ops/rope.py.

Split-half convention: pairs (x[..., :d/2], x[..., d/2:]).  Angles and
the rotation run in f32 and the result is cast back to x's dtype.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (f32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate [batch, heads, seq, head_dim] by per-token positions.

    ``positions`` [seq] shares positions across the batch; [batch, seq]
    rotates every batch row by its own positions.
    """
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, device=x.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq  # [(b,)s, d/2]
    if positions.ndim == 1:
        cos = torch.cos(angles)[None, None]
        sin = torch.sin(angles)[None, None]
    else:
        cos = torch.cos(angles)[:, None]  # [b, 1, s, d/2]
        sin = torch.sin(angles)[:, None]
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def rope_positions(seq_len: int, offset: int = 0, device=None) -> torch.Tensor:
    """Global positions for a block starting at ``offset``."""
    return torch.arange(seq_len, dtype=torch.int32, device=device) + offset
