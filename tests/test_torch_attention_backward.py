"""Port parity: the flash backward (kubeshare_tpu_torch.ops.attention:
flash_backward_reference and the autograd FlashAttention) against the JAX
package's Pallas backward on the CPU.  Inputs and the output gradient come
from numpy with a seed and go through both; the JAX side is jax.vjp of
flash_attention(use_pallas=True, interpret=True, block_q=16), i.e. the
Pallas dK/dV and dQ kernels in interpret mode (at s=200 the JAX forward
does not tile and its custom_vjp takes the reference's vjp instead)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.ops import attention as jax_attention
from kubeshare_tpu_torch.ops import attention as torch_attention

torch.set_num_threads(1)

# f32 on both sides: only summation order differs (the JAX kernel tests'
# own tolerance, tests/test_compute.py TestFlashBackwardKernels)
F32_TOL = 2e-4
# bf16: both round p and ds to bf16 before their products and the results
# to bf16 at the end, from f32 values summed in another order, so an
# element may land on the neighbouring bf16 value; allow a few bf16 ulps
# (2^-8 relative) of the largest gradient of the call
BF16_TOL = 2e-2

B, H, D = 1, 4, 16


def _inputs(seed, h_kv, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, s, D)).astype(np.float32)
    k = rng.standard_normal((B, h_kv, s, D)).astype(np.float32)
    v = rng.standard_normal((B, h_kv, s, D)).astype(np.float32)
    dout = rng.standard_normal((B, H, s, D)).astype(np.float32)
    return q, k, v, dout


def _jax_grads(q, k, v, dout, causal, window, dtype):
    def f(q, k, v):
        return jax_attention.flash_attention(
            q, k, v, causal=causal, block_q=16, use_pallas=True,
            interpret=True, window=window)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(dout, jdt))
    return (np.asarray(out, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _assert_grads_close(got, want, dtype):
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        return
    scale = max(float(np.abs(w).max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(g - w).max())
        assert err <= BF16_TOL * scale, (name, err, scale)


CASES = [
    # h_kv, s, causal, window
    (4, 64, True, None),
    (4, 64, False, None),
    (2, 64, True, None),
    (1, 64, True, None),
    (4, 64, True, 8),
    (2, 64, True, 8),
    (4, 64, True, 1),
    (4, 200, True, None),
    (2, 200, False, None),
    (1, 200, True, 8),
    # ragged across the Hopper kernels' 64-row steps and 128-row tiles, a
    # window narrower than a step, GQA (s tiles block_q: the Pallas path)
    (2, 144, True, 48),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h_kv,s,causal,window", CASES)
def test_flash_attention_grads_match_pallas_interpret(h_kv, s, causal, window,
                                                      dtype):
    q, k, v, dout = _inputs(s + h_kv, h_kv, s)
    want_out, want = _jax_grads(q, k, v, dout, causal, window, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tdout = torch.from_numpy(dout).to(tdt)
    out = torch_attention.flash_attention(tq, tk, tv, causal, window)
    got = torch.autograd.grad(out, (tq, tk, tv), tdout)
    for g, t in zip(got, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
    _assert_grads_close([g.float().numpy() for g in got], want, dtype)

    # the plain backward called directly, from the plain forward's out/lse
    with torch.no_grad():
        o, lse = torch_attention.flash_forward_reference(tq, tk, tv, causal,
                                                         window)
        direct = torch_attention.flash_backward_reference(
            tq, tk, tv, o, lse, tdout, causal, window)
    for a, b in zip(direct, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.detach().float().numpy(), want_out,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("h_kv,causal,window", [
    (4, True, None), (4, False, None), (2, True, 8), (1, False, None),
])
def test_grads_equal_autograd_through_the_plain_forward(h_kv, causal, window):
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(7, h_kv, 40))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch_attention.flash_attention(*leaves, causal, window)
    got = torch.autograd.grad(out, leaves, dout)
    leaves_ref = [t.clone().requires_grad_() for t in (q, k, v)]
    out_ref, _ = torch_attention.flash_forward_reference(*leaves_ref, causal,
                                                         window)
    want = torch.autograd.grad(out_ref, leaves_ref, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_permuted_inputs_and_strided_grad():
    # the model hands in permuted projections and receives a permuted
    # gradient: both are copied to the contiguous layout the kernels read
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(8, 2, 32))
    views = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    out = torch_attention.flash_attention(*(t.transpose(1, 2) for t in views),
                                          True, None)
    (out.transpose(1, 2) * dout.transpose(1, 2)).sum().backward()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch_attention.flash_attention(*leaves, True, None).backward(dout)
    for a, b in zip(views, leaves):
        torch.testing.assert_close(a.grad.transpose(1, 2), b.grad,
                                   rtol=1e-6, atol=1e-6)


def test_cpu_tensor_never_reaches_the_backward_kernels(monkeypatch):
    monkeypatch.setattr(torch_attention.flash_backward, "launches_dkv", 0)
    monkeypatch.setattr(torch_attention.flash_backward, "launches_dq", 0)

    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a backward kernel")

    for name in ("_flash_backward_cuda", "_flash_bwd_dkv_cuda",
                 "_flash_bwd_dq_cuda", "_flash_forward_cuda"):
        monkeypatch.setattr(torch_attention, name, no_launch)
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(9, 2, 24))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch_attention.flash_attention(*leaves, True, None).backward(dout)
    assert all(t.grad is not None for t in leaves)
    assert torch_attention.flash_backward.launches_dkv == 0
    assert torch_attention.flash_backward.launches_dq == 0


@pytest.mark.parametrize("change,error", [
    ("dout_dtype", ValueError), ("dout_shape", ValueError),
    ("dout_layout", ValueError), ("lse_dtype", ValueError),
    ("lse_shape", ValueError), ("head_dim", ValueError),
])
def test_backward_input_checks_raise(change, error):
    # the wrapper's checks run before any launch, so they are testable on
    # the CPU: anything the kernels do not take raises, never falls back
    b, h, s, d = 1, 4, 16, 64
    q = torch.zeros((b, h, s, d), dtype=torch.bfloat16)
    k = torch.zeros((b, 2, s, d), dtype=torch.bfloat16)
    v = torch.zeros((b, 2, s, d), dtype=torch.bfloat16)
    out = torch.zeros_like(q)
    dout = torch.zeros_like(q)
    lse = torch.zeros((b, h, s, 1), dtype=torch.float32)
    if change == "dout_dtype":
        dout = dout.float()
    elif change == "dout_shape":
        dout = dout[:, :, :8]
    elif change == "dout_layout":
        dout = torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    elif change == "lse_dtype":
        lse = lse.bfloat16()
    elif change == "lse_shape":
        lse = lse[..., 0]
    elif change == "head_dim":
        q, k, v, out, dout = (t[..., :32].contiguous()
                              for t in (q, k, v, out, dout))
    with pytest.raises(error):
        torch_attention._check_backward_inputs(q, k, v, out, lse, dout)
