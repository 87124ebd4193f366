"""Port parity: block-sparse attention (kubeshare_tpu_torch.ops.attention:
block_sparse_attention and its plain versions) against the JAX package on
the CPU.

Inputs, masks and the output gradient come from numpy with a seed and go
through both.  The JAX side of the gradient tests is jax.vjp of
block_sparse_attention(use_pallas=True, interpret=True): the Pallas forward
and backward kernels in their has_mask mode, in interpret mode.  The port's
side on the CPU is its plain versions (the masked kernels run only on a
card; chip_smoke.py holds them against the same plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.ops import attention as jax_attention
from kubeshare_tpu_torch.ops import _build
from kubeshare_tpu_torch.ops import attention as torch_attention

torch.set_num_threads(1)

# the tolerances of tests/test_torch_attention_backward.py: f32 differs
# only in summation order; bf16 rounds p and ds at the same points from
# f32 values summed in another order, so allow a few bf16 ulps (2^-8
# relative) of the call's largest value
F32_TOL = 2e-4
BF16_TOL = 2e-2
# the two oracles (XLA and torch einsums in f32) differ in summation order
REFERENCE_TOL = 1e-5

B, H, D = 1, 4, 16
BQ = BK = 16  # the JAX tests' mask blocks (tests/test_compute.py)


def _mask(n, seed, density=0.6):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, n)) < density).astype(np.int32)
    mask[0, 0] = 1  # at least one live block
    return mask


def _inputs(seed, h_kv, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, s, D)).astype(np.float32)
    k = rng.standard_normal((B, h_kv, s, D)).astype(np.float32)
    v = rng.standard_normal((B, h_kv, s, D)).astype(np.float32)
    dout = rng.standard_normal((B, H, s, D)).astype(np.float32)
    return q, k, v, dout


def _close(got, want, dtype):
    """Each array within the dtype's tolerance (bf16: of the largest
    magnitude among ``want``)."""
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        return
    scale = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        assert err <= BF16_TOL * scale, (i, err, scale)


@pytest.mark.parametrize("h_kv,causal", [(4, True), (2, False), (1, True)])
def test_block_sparse_reference_matches_jax(h_kv, causal):
    q, k, v, _ = _inputs(10 + h_kv, h_kv, 64)
    mask = _mask(4, h_kv)
    want = jax_attention.block_sparse_reference(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), causal, BQ,
        BK)
    got = torch_attention.block_sparse_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
        causal, BQ, BK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=REFERENCE_TOL, atol=REFERENCE_TOL)


def _jax_grads(q, k, v, dout, mask, causal, dtype):
    def f(q, k, v):
        return jax_attention.block_sparse_attention(
            q, k, v, mask, causal=causal, block_q=BQ, block_k=BK,
            use_pallas=True, interpret=True)

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(dout, jdt))
    return (np.asarray(out, np.float32),
            [np.asarray(g, np.float32) for g in grads])


@pytest.mark.parametrize("h_kv,causal,s,dtype", [
    (4, True, 64, "float32"),
    (2, False, 64, "float32"),
    (1, True, 32, "float32"),
    (4, False, 32, "bfloat16"),
    (2, True, 64, "bfloat16"),
    (1, False, 32, "bfloat16"),
])
def test_block_sparse_grads_match_pallas_interpret(h_kv, causal, s, dtype):
    q, k, v, dout = _inputs(s + h_kv, h_kv, s)
    mask = _mask(s // BQ, s + h_kv)
    want_out, want = _jax_grads(q, k, v, dout, mask, causal, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tdout = torch.from_numpy(dout).to(tdt)
    out = torch_attention.block_sparse_attention(tq, tk, tv, mask, causal,
                                                 BQ, BK)
    got = torch.autograd.grad(out, (tq, tk, tv), tdout)
    for g, t in zip(got, (tq, tk, tv)):
        assert g.dtype == tdt and g.shape == t.shape
    _close([out.detach().float().numpy()], [want_out], dtype)
    _close([g.float().numpy() for g in got], want, dtype)

    # the plain versions called directly give the autograd path's results
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        o, lse = torch_attention.block_sparse_forward_reference(
            tq, tk, tv, tmask, causal, BQ, BK)
        direct = torch_attention.block_sparse_backward_reference(
            tq, tk, tv, o, lse, tdout, tmask, causal, BQ, BK)
    torch.testing.assert_close(o, out.detach(), rtol=0, atol=0)
    for a, b in zip(direct, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dead_rows_are_zero_and_finite():
    # query block 2 sees no key: its rows are exactly 0, lse is -inf, and
    # the gradients are finite, with dq zero on those rows
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(3, 2, 64))
    mask = np.ones((4, 4), np.int32)
    mask[2, :] = 0
    rows = slice(2 * BQ, 3 * BQ)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch_attention.block_sparse_attention(*leaves, mask, False, BQ, BK)
    grads = torch.autograd.grad(out, leaves, dout)
    assert torch.all(out[:, :, rows] == 0)
    assert not torch.isnan(out).any()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert torch.all(grads[0][:, :, rows] == 0)
    _, lse = torch_attention.block_sparse_forward_reference(
        q, k, v, torch.from_numpy(mask), False, BQ, BK)
    assert torch.isneginf(lse[:, :, rows]).all()
    assert torch.isfinite(lse[:, :, :rows.start]).all()
    want = jax_attention.block_sparse_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(mask),
        False, BQ, BK)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("mask_shape,s,match", [
    ((3, 4), 64, "block_mask shape"),
    ((4, 4), 56, "must tile"),
])
def test_validation_errors(mask_shape, s, match):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4, 4, s))
    with pytest.raises(ValueError, match=match):
        torch_attention.block_sparse_attention(
            q, k, v, np.ones(mask_shape, np.int32), block_q=BQ, block_k=BK)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_ones_mask_is_the_dense_plain_version_bit_for_bit(causal, dtype):
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in _inputs(5, 2, 48))
    ones = torch.ones((3, 3), dtype=torch.int32)
    out, lse = torch_attention.flash_forward_reference(q, k, v, causal)
    got_out, got_lse = torch_attention.block_sparse_forward_reference(
        q, k, v, ones, causal, BQ, BK)
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)
    want = torch_attention.flash_backward_reference(q, k, v, out, lse, dout,
                                                    causal)
    got = torch_attention.block_sparse_backward_reference(
        q, k, v, out, lse, dout, ones, causal, BQ, BK)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("change,error", [
    ("float", TypeError), ("int64", TypeError), ("numpy", TypeError),
    ("shape", ValueError), ("layout", ValueError), ("device", ValueError),
])
def test_mask_input_checks_raise(change, error):
    # the masked wrappers' checks run before any launch, so they are
    # testable on the CPU: a mask the kernels do not take raises
    q = torch.zeros((1, 4, 64, 64), dtype=torch.bfloat16)
    mask = torch.ones((4, 4), dtype=torch.int32)
    if change == "float":
        mask = mask.float()
    elif change == "int64":
        mask = mask.long()
    elif change == "numpy":
        mask = mask.numpy()
    elif change == "shape":
        mask = mask[:3]
    elif change == "layout":
        mask = torch.ones((4, 8), dtype=torch.int32)[:, ::2]
    elif change == "device":
        mask = mask.to("meta")
    with pytest.raises(error):
        torch_attention._check_block_mask(q, mask, BQ, BK)


def test_cpu_tensor_never_reaches_the_masked_kernels(monkeypatch):
    monkeypatch.setattr(torch_attention.block_sparse_forward, "launches", 0)
    monkeypatch.setattr(torch_attention.block_sparse_backward,
                        "launches_dkv", 0)
    monkeypatch.setattr(torch_attention.block_sparse_backward,
                        "launches_dq", 0)

    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a masked kernel")

    for name in ("_block_sparse_forward_cuda", "_block_sparse_bwd_dkv_cuda",
                 "_block_sparse_bwd_dq_cuda"):
        monkeypatch.setattr(torch_attention, name, no_launch)
    monkeypatch.setattr(_build, "load", no_launch)
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(9, 2, 32))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch_attention.block_sparse_attention(
        *leaves, np.ones((2, 2), np.int32), True, BQ, BK).backward(dout)
    assert all(t.grad is not None for t in leaves)
    assert torch_attention.block_sparse_forward.launches == 0
    assert torch_attention.block_sparse_backward.launches_dkv == 0
    assert torch_attention.block_sparse_backward.launches_dq == 0
