"""Port parity: kubeshare_tpu_torch.ops (attention, rope) against the JAX
package on the CPU.  Inputs come from numpy with a seed and go through
both; the JAX flash kernel runs in Pallas interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.ops import attention as jax_attention
from kubeshare_tpu.ops.rope import apply_rope as jax_apply_rope
from kubeshare_tpu_torch.ops import attention as torch_attention
from kubeshare_tpu_torch.ops.rope import apply_rope as torch_apply_rope

torch.set_num_threads(1)

# f32 on both sides: only summation order differs
F32_TOL = 1e-5
# bf16 inputs and outputs: the two frameworks may round a result to the
# neighbouring bf16 value (one ulp is 2^-7 relative)
BF16_TOL = 2e-2


def _qkv(seed, b, h, h_kv, s, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(dtype)
    k = rng.standard_normal((b, h_kv, s, d)).astype(dtype)
    v = rng.standard_normal((b, h_kv, s, d)).astype(dtype)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("h_kv,causal,window", [
    (4, True, None), (4, False, None), (2, True, None), (1, True, None),
    (4, True, 8), (2, True, 8),
])
def test_attention_reference_matches_jax(h_kv, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(0, 2, 4, h_kv, 32, 16))
    want = jax_attention.attention_reference(jq, jk, jv, causal, window)
    got = torch_attention.attention_reference(tq, tk, tv, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("h_kv,causal,window", [
    (4, True, None), (4, False, None), (2, True, None), (4, True, 24),
])
def test_flash_forward_reference_matches_pallas_interpret(h_kv, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(1, 1, 4, h_kv, 64, 16))
    want_out, want_lse = jax_attention._flash_forward(
        jq, jk, jv, causal, block_q=16, interpret=True, block_k=32,
        window=window)
    got_out, got_lse = torch_attention.flash_forward_reference(
        tq, tk, tv, causal, window)
    assert got_lse.shape == want_lse.shape == (1, 4, 64, 1)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=F32_TOL, atol=F32_TOL)


def test_flash_forward_reference_bf16_matches_pallas_interpret():
    q, k, v = _qkv(2, 1, 2, 2, 64, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want_out, want_lse = jax_attention._flash_forward(
        jq, jk, jv, True, block_q=16, interpret=True, block_k=32)
    got_out, got_lse = torch_attention.flash_forward_reference(tq, tk, tv, True)
    assert got_out.dtype == torch.bfloat16
    np.testing.assert_allclose(got_out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    # lse is f32 from bf16 inputs whose products are exact in f32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=F32_TOL, atol=F32_TOL)


def test_flash_attention_ragged_length_matches_jax():
    # s = 50 tiles no block: JAX falls back to its reference, the port's
    # kernel masks the tail (its plain version here on the CPU)
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(3, 2, 4, 2, 50, 16))
    want = jax_attention.flash_attention(jq, jk, jv, causal=True,
                                         use_pallas=True, interpret=True)
    got = torch_attention.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_flash_forward_reference_window_one_is_the_diagonal():
    # a window of 1 leaves each query its own key only: out == v and
    # lse == that one scaled score
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 2, 8, 16))
    out, lse = torch_attention.flash_forward_reference(q, k, v, False, 1)
    torch.testing.assert_close(out, v, rtol=F32_TOL, atol=F32_TOL)
    scores = (q * k).sum(-1, keepdim=True) * 16 ** -0.5
    torch.testing.assert_close(lse, scores, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(dtype, tol, batched):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
    if batched:
        positions = np.stack([np.arange(12) + 5, np.arange(12) + 40])
    else:
        positions = np.arange(12) + 7
    positions = positions.astype(np.int32)
    if dtype == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jax_apply_rope(jx, jnp.asarray(positions))
    got = torch_apply_rope(tx, torch.from_numpy(positions))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_use_kernel_default_by_device():
    assert torch_attention.use_kernel_default(torch.device("cuda"))
    assert not torch_attention.use_kernel_default(torch.device("cpu"))


def test_window_must_be_positive():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="window"):
        torch_attention.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="window"):
        torch_attention.attention_reference(q, k, v, window=-1)


@pytest.mark.parametrize("change,error", [
    ("dtype", TypeError), ("head_dim", ValueError),
    ("layout", ValueError), ("heads", ValueError),
])
def test_kernel_input_checks_raise(change, error):
    # the wrapper's checks run before any launch, so they are testable on
    # the CPU: anything the kernel does not take raises, never falls back
    b, h, s, d = 1, 4, 16, 64
    q = torch.zeros((b, h, s, d), dtype=torch.bfloat16)
    k = torch.zeros((b, 2, s, d), dtype=torch.bfloat16)
    v = torch.zeros((b, 2, s, d), dtype=torch.bfloat16)
    if change == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif change == "head_dim":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif change == "layout":
        q = torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    elif change == "heads":
        k = torch.zeros((b, 3, s, d), dtype=torch.bfloat16)
        v = torch.zeros((b, 3, s, d), dtype=torch.bfloat16)
    with pytest.raises(error):
        torch_attention._check_kernel_inputs(q, k, v)
