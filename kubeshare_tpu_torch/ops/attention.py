"""Attention ops, port of kubeshare_tpu/ops/attention.py (forward only).

Two plain PyTorch versions with deliberately different numerics:

- :func:`attention_reference` mirrors the JAX ``attention_reference``:
  scores in the input dtype, masked with ``finfo(dtype).min``, softmax in
  f32.  It is the model's ``attention="reference"`` path.
- :func:`flash_forward_reference` mirrors the flash kernel: f32 scores,
  ``-inf`` masking, p cast to v's dtype before the p . v product, f32
  accumulation, and the per-row logsumexp.

:func:`flash_attention` sends a CUDA tensor to the hand-written Hopper
kernel (``csrc/flash_fwd.cu``) and a CPU tensor to
:func:`flash_forward_reference`.  There is no fallback between the two:
a CUDA tensor the kernel does not take raises.

Shapes: q is [batch, heads, seq, head_dim]; k, v are
[batch, kv_heads, seq, head_dim] (GQA when kv_heads < heads).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BACKWARD_ITEM = (
    "the flash backward kernels (ROADMAP.md, queue B items 2-3: "
    "_flash_bwd_dkv_kernel and _flash_bwd_dq_kernel)"
)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


def _check_window(window: Optional[int]) -> None:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """GQA: repeat each KV head over its query group (plain versions only)."""
    if k.shape[1] == q.shape[1]:
        return k, v
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}"
        )
    group = q.shape[1] // k.shape[1]
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def _band_mask(s_q: int, s_k: int, window: Optional[int],
               device) -> torch.Tensor:
    """[s_q, s_k] bool: causal (queries aligned to the end of the keys),
    narrowed to the last ``window`` keys when a window is given."""
    q_pos = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    k_pos = torch.arange(s_k, device=device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain attention with the JAX reference's numerics.

    ``window``: sliding-window causal attention — query i attends keys
    (i - window, i].  Implies causal.
    """
    _check_window(window)
    k, v = _repeat_kv(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal or window is not None:
        mask = _band_mask(scores.shape[-2], scores.shape[-1], window, q.device)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash kernel: (out, lse).

    ``out`` is [b, h, s, d] in q's dtype; ``lse`` is [b, h, s, 1] f32,
    ``-inf`` on a row with no visible key (whose ``out`` is zero).
    """
    _check_window(window)
    k, v = _repeat_kv(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal or window is not None:
        mask = _band_mask(scores.shape[-2], scores.shape[-1], window, q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    probs = torch.exp(scores - safe_m)
    probs = torch.where(torch.isfinite(scores), probs, torch.zeros_like(probs))
    l = probs.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    denom = torch.clamp(l, min=1e-30)
    out = (acc / denom).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, float("-inf")))
    return out, lse


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on anything csrc/flash_fwd.cu does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if h % k.shape[1] != 0:
        raise ValueError(
            f"query heads {h} not a multiple of kv heads {k.shape[1]}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes one dtype of {list(KERNEL_DTYPES)} for "
            f"q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs {name} 16-byte aligned")


def _flash_forward_cuda(q, k, v, causal: bool, window: Optional[int]):
    """Launch csrc/flash_fwd.cu on q's current stream; returns (out, lse)."""
    from . import _build

    _check_kernel_inputs(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, k.shape[1], s, d,
            int(causal), window or 0, d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_forward.launches += 1
    return out, lse


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the Hopper kernel for a CUDA tensor, the plain version
    for a CPU tensor.  ``flash_forward.launches`` counts kernel launches."""
    _check_window(window)
    if q.device.type != "cuda":
        return flash_forward_reference(q, k, v, causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only until "
            f"{BACKWARD_ITEM} land; run under torch.no_grad() or "
            "torch.inference_mode()"
        )
    return _flash_forward_cuda(q, k, v, causal, window)


flash_forward.launches = 0


def use_kernel_default(device: torch.device) -> bool:
    """The flash kernel on CUDA at every sequence length, the plain
    reference elsewhere (in place of the JAX package's TPU-measured
    length threshold)."""
    return torch.device(device).type == "cuda"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention: the Hopper kernel on CUDA, its plain version on
    the CPU.  ``window``: sliding-window causal attention (query i
    attends keys (i - window, i]); the kernel skips K tiles outside the
    band, so its cost is O(s * window).  Inputs in another layout (the
    head-split projections are permuted views) are copied to the
    contiguous layout the kernel reads."""
    return flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal, window)[0]
