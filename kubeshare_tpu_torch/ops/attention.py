"""Attention ops, port of kubeshare_tpu/ops/attention.py (dense and
block-sparse modes).

Plain PyTorch versions with deliberately different numerics:

- :func:`attention_reference` mirrors the JAX ``attention_reference``:
  scores in the input dtype, masked with ``finfo(dtype).min``, softmax in
  f32.  It is the model's ``attention="reference"`` path.
  :func:`block_sparse_reference` is its block-mask counterpart, with the
  JAX oracle's numerics (masked with ``finfo(f32).min`` after the f32
  cast, fully-masked rows zeroed).
- :func:`flash_forward_reference` mirrors the flash kernel: f32 scores,
  ``-inf`` masking, p cast to v's dtype before the p . v product, f32
  accumulation, and the per-row logsumexp.
- :func:`flash_backward_reference` mirrors the two backward kernels:
  p recomputed from the saved logsumexp, f32 products with p and ds
  rounded to the input dtype before their matmuls.
- :func:`block_sparse_forward_reference` and
  :func:`block_sparse_backward_reference` are the same two under a block
  mask: a pair is visible when its (query block, key block) entry is
  nonzero and, if causal, the key is not after the query.

:func:`flash_attention` is a ``torch.autograd.Function``
(:class:`FlashAttention`): on a CUDA tensor its forward launches the
hand-written Hopper kernel (``csrc/flash_fwd.cu``) and its backward the
dK/dV and dQ kernels (``csrc/flash_bwd.cu``); on a CPU tensor both take
the plain versions.  :func:`block_sparse_attention`
(:class:`BlockSparseFlashAttention`) does the same with the masked
instantiations of the three kernels, which visit only the tiles that
hold a visible pair.  There is no fallback between kernel and plain
version: a CUDA tensor the kernels do not take raises.

Shapes: q is [batch, heads, seq, head_dim]; k, v are
[batch, kv_heads, seq, head_dim] (GQA when kv_heads < heads).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
    mask = (_band_mask(q.shape[2], k.shape[2], window, q.device)
            if causal or window is not None else None)
    return _flash_forward_plain(q, k, v, mask)


def _flash_forward_plain(q, k, v, mask: Optional[torch.Tensor]):
    """The flash forward's numerics with the visible pairs given as an
    [s_q, s_k] bool ``mask`` (None: every pair)."""
    k, v = _repeat_kv(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
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


def flash_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv).

    From the forward's ``out`` and ``lse`` ([b, h, s, 1] f32): p =
    exp(q . k^T * scale - lse) in f32, 0 where the score is masked;
    delta = rowsum(dout o out) in f32; dv = p^T . dout with p rounded to
    dout's dtype; dp = dout . v^T in f32, ds = p o (dp - delta); dk =
    scale * ds^T . q and dq = scale * ds . k with ds rounded to q's / k's
    dtype.  Every product accumulates in f32.  GQA: dk, dv are summed over
    each query-head group in f32, then rounded once to k's / v's dtype.
    """
    _check_window(window)
    mask = (_band_mask(q.shape[2], q.shape[2], window, q.device)
            if causal or window is not None else None)
    return _flash_backward_plain(q, k, v, out, lse, dout, mask)


def _flash_backward_plain(q, k, v, out, lse, dout,
                          mask: Optional[torch.Tensor]):
    """The backward kernels' numerics with the visible pairs given as an
    [s, s] bool ``mask`` (None: every pair)."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    k_full, v_full = _repeat_kv(q, k, v)
    scale = d ** -0.5
    f32 = torch.float32
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k_full.to(f32)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - lse)
    probs = torch.where(torch.isfinite(scores), probs, torch.zeros_like(probs))
    delta = _backward_delta(out, dout)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs.to(dout.dtype).to(f32),
                      dout.to(f32))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.to(f32), v_full.to(f32))
    ds = probs * (dp - delta)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(f32),
                              q.to(f32))
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(f32),
                              k_full.to(f32))
    if h_kv != h:
        dk = dk.reshape(b, h_kv, h // h_kv, s, d).sum(dim=2)
        dv = dv.reshape(b, h_kv, h // h_kv, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on anything the flash kernels (csrc/flash_fwd.cu,
    csrc/flash_bwd.cu) do not take."""
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


def _launch_args(q, k, causal: bool, window: Optional[int], stream):
    """The launchers' trailing arguments: dtype, b, h, h_kv, s, d, causal,
    window (0 = none), scale d^-1/2, stream."""
    b, h, s, d = q.shape
    return (KERNEL_DTYPES[q.dtype], b, h, k.shape[1], s, d, int(causal),
            window or 0, d ** -0.5, stream)


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
            lse.data_ptr(), *_launch_args(q, k, causal, window, stream))
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
    return _flash_forward_cuda(q, k, v, causal, window)


flash_forward.launches = 0


def _check_backward_inputs(q, k, v, out, lse, dout) -> None:
    """Raise on anything csrc/flash_bwd.cu does not take (beyond the
    forward's checks on q, k, v)."""
    _check_kernel_inputs(q, k, v)
    b, h, s, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} does not match q "
                f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s, 1) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be [b, h, s, 1] float32, got {tuple(lse.shape)} "
            f"{lse.dtype}")
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash backward kernels need a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash backward kernels need {name} 16-byte aligned")


def _backward_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout o out) in f32, [b, h, s, 1] (JAX computes it
    outside the kernels too, attention.py:409)."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(
        dim=-1, keepdim=True)


def _flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool,
                        window: Optional[int]):
    """Launch the dK/dV kernel of csrc/flash_bwd.cu; returns (dk, dv) at
    k's / v's shape (the GQA group is summed in the kernel)."""
    from . import _build

    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_launch_args(q, k, causal, window, stream))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: CUDA error {err}")
    flash_backward.launches_dkv += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool,
                       window: Optional[int]):
    """Launch the dQ kernel of csrc/flash_bwd.cu; returns dq."""
    from . import _build

    dq = torch.empty_like(q)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_launch_args(q, k, causal, window, stream))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: CUDA error {err}")
    flash_backward.launches_dq += 1
    return dq


def _flash_backward_cuda(q, k, v, out, lse, dout, causal: bool,
                         window: Optional[int]):
    _check_backward_inputs(q, k, v, out, lse, dout)
    delta = _backward_delta(out, dout)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, window)
    dq = _flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, window)
    return dq, dk, dv


def flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the dK/dV and dQ Hopper kernels for a CUDA tensor,
    :func:`flash_backward_reference` for a CPU tensor.
    ``flash_backward.launches_dkv`` / ``launches_dq`` count launches."""
    _check_window(window)
    if q.device.type != "cuda":
        return flash_backward_reference(q, k, v, out, lse, dout, causal,
                                        window)
    return _flash_backward_cuda(q, k, v, out, lse, dout, causal, window)


flash_backward.launches_dkv = 0
flash_backward.launches_dq = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward saves q, k,
    v, out and the logsumexp; the backward recomputes p from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the incoming gradient may be a strided view (a permute's grad)
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.contiguous(),
                                    ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def use_kernel_default(device: torch.device) -> bool:
    """The flash kernel on CUDA at every sequence length, the plain
    reference elsewhere (in place of the JAX package's TPU-measured
    length threshold)."""
    return torch.device(device).type == "cuda"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention, differentiable: the Hopper kernels on CUDA
    (forward, and dK/dV + dQ in the backward), their plain versions on
    the CPU.  ``window``: sliding-window causal attention (query i
    attends keys (i - window, i]); the kernels skip tiles outside the
    band, so their cost is O(s * window).  Inputs in another layout (the
    head-split projections are permuted views) are copied to the
    contiguous layout the kernels read."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window)


# ---------------------------------------------------------------------------
# block-sparse attention: an arbitrary [s // block_q, s // block_k] mask
# ---------------------------------------------------------------------------


def _element_mask(block_mask: torch.Tensor, block_q: int, block_k: int,
                  s: int, causal: bool) -> torch.Tensor:
    """[s, s] bool: pair (i, j) is visible when block_mask[i // block_q,
    j // block_k] is nonzero and, if causal, j <= i."""
    elem = ((block_mask != 0).repeat_interleave(block_q, 0)
            .repeat_interleave(block_k, 1))
    if causal:
        elem = elem & _band_mask(s, s, None, block_mask.device)
    return elem


def block_sparse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_mask: torch.Tensor, causal: bool,
                           block_q: int, block_k: int) -> torch.Tensor:
    """Plain attention under a block mask with the JAX oracle's numerics
    (kubeshare_tpu/ops/attention.py:block_sparse_reference): scores in
    the input dtype, cast to f32, masked with ``finfo(f32).min``, softmax
    in f32, and zeros for a row with no visible key."""
    k, v = _repeat_kv(q, k, v)
    elem = _element_mask(block_mask, block_q, block_k, q.shape[2], causal)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    scores = scores.masked_fill(~elem, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    row_live = elem.any(dim=-1, keepdim=True)  # all-masked rows: zeros
    probs = torch.where(row_live, probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def block_sparse_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_mask: torch.Tensor, causal: bool, block_q: int, block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the masked flash forward: (out, lse) with
    :func:`flash_forward_reference`'s numerics under the block mask
    (``lse`` is ``-inf`` and ``out`` zero on a row with no visible key)."""
    mask = _element_mask(block_mask, block_q, block_k, q.shape[2], causal)
    return _flash_forward_plain(q, k, v, mask)


def block_sparse_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, block_mask: torch.Tensor,
    causal: bool, block_q: int, block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the masked backward kernels: (dq, dk, dv) with
    :func:`flash_backward_reference`'s numerics, p = 0 on every masked
    pair (so a row with no visible key, lse = -inf, gets zeros)."""
    mask = _element_mask(block_mask, block_q, block_k, q.shape[2], causal)
    return _flash_backward_plain(q, k, v, out, lse, dout, mask)


def _check_block_mask(q: torch.Tensor, block_mask, block_q: int,
                      block_k: int) -> None:
    """Raise on a mask the masked kernels do not take: int32 or bool,
    [s // block_q, s // block_k], on q's device, contiguous."""
    if not isinstance(block_mask, torch.Tensor) or block_mask.dtype not in (
            torch.int32, torch.bool):
        raise TypeError("block_mask must be an int32 or bool tensor, got "
                        f"{getattr(block_mask, 'dtype', type(block_mask))}")
    s = q.shape[2]
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(
            f"seq {s} must tile block_q={block_q}, block_k={block_k}")
    expected = (s // block_q, s // block_k)
    if tuple(block_mask.shape) != expected:
        raise ValueError(f"block_mask shape {tuple(block_mask.shape)} != "
                         f"{expected} for seq {s} with blocks "
                         f"({block_q}, {block_k})")
    if block_mask.device != q.device:
        raise ValueError(f"block_mask is on {block_mask.device}, q on "
                         f"{q.device}")
    if not block_mask.is_contiguous():
        raise ValueError("the masked kernels need a contiguous block_mask")


def _mask_args(q: torch.Tensor, block_mask: torch.Tensor, block_q: int,
               block_k: int):
    """(mask bytes, launch arguments) of the masked launchers, after the
    mask's checks: the mask as one byte per block (nonzero keeps it; a
    bool mask is read in place), its columns, block_q, block_k.  The
    caller holds the bytes until the launch is queued."""
    _check_block_mask(q, block_mask, block_q, block_k)
    bits = (block_mask if block_mask.dtype == torch.bool
            else block_mask != 0).view(torch.uint8)
    return bits, (bits.data_ptr(), bits.shape[1], block_q, block_k)


def _block_sparse_forward_cuda(q, k, v, block_mask, causal: bool,
                               block_q: int, block_k: int):
    """Launch the masked csrc/flash_fwd.cu on q's current stream; returns
    (out, lse)."""
    from . import _build

    _check_kernel_inputs(q, k, v)
    bits, mask_args = _mask_args(q, block_mask, block_q, block_k)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_block_sparse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *mask_args,
            *_launch_args(q, k, causal, None, stream))
    if err != 0:
        raise RuntimeError(
            f"flash_fwd_block_sparse launch failed: CUDA error {err}")
    block_sparse_forward.launches += 1
    return out, lse


def block_sparse_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_mask: torch.Tensor, causal: bool, block_q: int, block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) under the block mask: the masked Hopper kernel for a
    CUDA tensor, the plain version for a CPU tensor.
    ``block_sparse_forward.launches`` counts kernel launches."""
    if q.device.type != "cuda":
        return block_sparse_forward_reference(q, k, v, block_mask, causal,
                                              block_q, block_k)
    return _block_sparse_forward_cuda(q, k, v, block_mask, causal, block_q,
                                      block_k)


block_sparse_forward.launches = 0


def _block_sparse_bwd_dkv_cuda(q, k, v, dout, lse, delta, block_mask,
                               causal: bool, block_q: int, block_k: int):
    """Launch the masked dK/dV kernel; returns (dk, dv)."""
    from . import _build

    bits, mask_args = _mask_args(q, block_mask, block_q, block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dkv_block_sparse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *mask_args, *_launch_args(q, k, causal, None, stream))
    if err != 0:
        raise RuntimeError(
            f"flash_bwd_dkv_block_sparse launch failed: CUDA error {err}")
    block_sparse_backward.launches_dkv += 1
    return dk, dv


def _block_sparse_bwd_dq_cuda(q, k, v, dout, lse, delta, block_mask,
                              causal: bool, block_q: int, block_k: int):
    """Launch the masked dQ kernel; returns dq."""
    from . import _build

    bits, mask_args = _mask_args(q, block_mask, block_q, block_k)
    dq = torch.empty_like(q)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dq_block_sparse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *mask_args,
            *_launch_args(q, k, causal, None, stream))
    if err != 0:
        raise RuntimeError(
            f"flash_bwd_dq_block_sparse launch failed: CUDA error {err}")
    block_sparse_backward.launches_dq += 1
    return dq


def block_sparse_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, block_mask: torch.Tensor,
    causal: bool, block_q: int, block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) under the block mask: the masked dK/dV and dQ Hopper
    kernels for a CUDA tensor, :func:`block_sparse_backward_reference` for
    a CPU tensor.  ``block_sparse_backward.launches_dkv`` /
    ``launches_dq`` count launches."""
    if q.device.type != "cuda":
        return block_sparse_backward_reference(q, k, v, out, lse, dout,
                                               block_mask, causal, block_q,
                                               block_k)
    _check_backward_inputs(q, k, v, out, lse, dout)
    delta = _backward_delta(out, dout)
    args = (block_mask, causal, block_q, block_k)
    dk, dv = _block_sparse_bwd_dkv_cuda(q, k, v, dout, lse, delta, *args)
    dq = _block_sparse_bwd_dq_cuda(q, k, v, dout, lse, delta, *args)
    return dq, dk, dv


block_sparse_backward.launches_dkv = 0
block_sparse_backward.launches_dq = 0


class BlockSparseFlashAttention(torch.autograd.Function):
    """Block-sparse flash attention with its flash backward (the
    counterpart of JAX's ``_block_sparse_flash`` custom_vjp): the forward
    saves q, k, v, the mask, out and the logsumexp; the mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, block_mask, causal: bool, block_q: int,
                block_k: int):
        out, lse = block_sparse_forward(q, k, v, block_mask, causal, block_q,
                                        block_k)
        ctx.save_for_backward(q, k, v, block_mask, out, lse)
        ctx.args = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, block_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_backward(q, k, v, out, lse,
                                           dout.contiguous(), block_mask,
                                           *ctx.args)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_mask, causal: bool = False,
                           block_q: int = 512,
                           block_k: int = 1024) -> torch.Tensor:
    """Attention under an arbitrary block mask (document masking,
    prefix-LM, strided sparsity, ...), differentiable.

    ``block_mask`` is [seq // block_q, seq // block_k] (int or bool, a
    tensor or an array): entry 0 masks the whole (query block, key block)
    tile, and the kernels skip every tile of theirs that holds no visible
    pair, so the cost follows the mask's density.  ``causal=True`` also
    masks keys after the query.  Query rows with no visible key yield
    zeros.  The blocks are the mask's granularity, not the kernels' tiles:
    any divisors of seq (each capped at seq) will do.  The masked Hopper
    kernels on CUDA, their plain versions on the CPU."""
    s = q.shape[2]
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q != 0 or s % block_k != 0:
        raise ValueError(
            f"seq {s} must tile block_q={block_q}, block_k={block_k}")
    block_mask = torch.as_tensor(block_mask, device=q.device)
    expected = (s // block_q, s // block_k)
    if tuple(block_mask.shape) != expected:
        raise ValueError(f"block_mask shape {tuple(block_mask.shape)} != "
                         f"{expected} for seq {s} with blocks "
                         f"({block_q}, {block_k})")
    if block_mask.dtype != torch.bool:
        block_mask = block_mask.to(torch.int32)
    return BlockSparseFlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        block_mask.contiguous(), causal, block_q, block_k)
