"""Port parity: the fused LoRA adapter-dropout matmul's plain version against
the JAX package's Pallas kernels (``fused_dropout_matmul(bits=...)`` in
interpret mode on the CPU), and the port's own hash mask.

bf16 inputs from numpy with a seed, as the JAX package's own test draws
them. Tolerance: one bf16 rounding of the largest value (2^-8 x max|ref|) on
the output and on the x and A gradients: both sides round the same products
the same way and differ only in the order of f32 sums. The hash mask is
held to a pure-Python transcription of its definition, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops.lora_fused import fused_dropout_matmul as j_fused
from phantom_vlb_tpu_torch.ops.lora_fused import (
    dropout_threshold,
    fused_dropout_bwd,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
)

M, K, R = 256, 512, 16
P = 0.1
THR, KEEP = dropout_threshold(P)
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    a = (rng.standard_normal((K, R)) * 0.05).astype(np.float32)
    bits = rng.integers(0, 256, (M, K)).astype(np.uint8)
    return x, a, bits


def _bf16(x):
    """A numpy array rounded to bf16, as a bf16 tensor and a JAX array."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close(got: torch.Tensor, want, scale=None):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ULP * scale, rtol=0)


def test_threshold_and_keep_match_the_reference():
    assert (THR, KEEP) == (26, 1.0 - 26 / 256)
    assert dropout_threshold(0.0) == (0, 1.0)


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_bits_mode_matches_jax_forward_and_grads(data, p):
    x, a, bits = data
    (xt, xj), (at, aj) = _bf16(x), _bf16(a)
    out_j = j_fused(xj, aj, 0, p, bits=jnp.asarray(bits), block_m=128, block_k=128)
    xt.requires_grad_()
    at.requires_grad_()
    out_t = fused_dropout_matmul(xt, at, 0, p, bits=torch.from_numpy(bits))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (M, R)
    _close(out_t.detach(), out_j)

    import jax

    def loss(x_, a_):
        o = j_fused(x_, a_, 0, p, bits=jnp.asarray(bits), block_m=128, block_k=128)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    gx_j, ga_j = jax.grad(loss, argnums=(0, 1))(xj, aj)
    out_t.float().square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and at.grad.dtype == torch.bfloat16
    _close(xt.grad, gx_j)
    _close(at.grad, ga_j)
    # Dropped elements get no gradient, on both sides.
    dead = bits < dropout_threshold(p)[0]
    assert (xt.grad.float().numpy()[dead] == 0).all()
    assert (np.asarray(gx_j, np.float32)[dead] == 0).all()


def test_zero_rate_is_a_plain_product(data):
    x, a, bits = data
    (xt, xj), (at, aj) = _bf16(x), _bf16(a)
    out_j = j_fused(xj, aj, 0, 0.0, bits=jnp.asarray(bits))
    _close(fused_dropout_matmul(xt, at, 0, 0.0), out_j)


def _py_fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _py_byte(seed, row, col):
    """The mask byte's definition in plain Python integers."""
    key = _py_fmix32((seed ^ (row * 0x9E3779B1)) & 0xFFFFFFFF)
    return (_py_fmix32(key ^ (col >> 2)) >> (8 * (col & 3))) & 0xFF


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31, 2**32 - 1])
def test_hash_bytes_follow_their_definition(seed):
    m, k = 37, 64
    got = hash_bytes(seed, m, k)
    assert got.dtype == torch.uint8 and got.shape == (m, k)
    rng = np.random.default_rng(seed % 1000)
    for row, col in zip(rng.integers(0, m, 200), rng.integers(0, k, 200)):
        assert got[row, col].item() == _py_byte(seed, int(row), int(col))
    # Large rows: row * 0x9E3779B1 wraps past 2^32 (and past int32).
    big = hash_bytes(seed, 70000, 8)
    assert big[69999, 5].item() == _py_byte(seed, 69999, 5)


def test_hash_mask_rate_determinism_and_tile_independence():
    m, k = 512, 4096
    mask = hash_bytes(3, m, k) >= THR
    assert abs(mask.float().mean().item() - KEEP) < 1e-3          # std ~2e-4 at 2M draws
    assert torch.equal(mask, hash_bytes(3, m, k) >= THR)
    other = hash_bytes(4, m, k) >= THR
    assert 0.15 < (mask != other).float().mean().item() < 0.21     # 2 p (1 - p) = 0.183
    # A function of (seed, row, col) alone: any sub-block is the same.
    assert torch.equal(hash_bytes(3, 64, 128), hash_bytes(3, m, k)[:64, :128])
    assert torch.equal(hash_bytes(3, 300, 256)[200:, 64:], hash_bytes(3, m, 512)[200:300, 64:256])


def test_hash_mode_is_bits_mode_on_the_hash_bytes(data):
    x, a, _ = data
    xt, at = torch.from_numpy(x).bfloat16(), torch.from_numpy(a).bfloat16()
    bits = hash_bytes(11, M, K)
    assert torch.equal(fused_dropout_matmul(xt, at, 11, P),
                       fused_dropout_matmul(xt, at, 0, P, bits=bits))
    dmid = torch.randn(M, R, generator=torch.Generator().manual_seed(0)).bfloat16()
    for got, want in zip(fused_dropout_bwd(xt, at, dmid, 11, P),
                         fused_dropout_bwd_plain(xt, at, dmid, 0, THR, bits)):
        assert torch.equal(got, want)


def test_autograd_runs_the_plain_backward(data):
    x, a, bits = data
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    at = torch.from_numpy(a).requires_grad_()                      # an f32 master, cast at use
    mid = fused_dropout_matmul(xt, at.bfloat16(), 5, P)
    dmid = torch.randn(mid.shape, generator=torch.Generator().manual_seed(1)).bfloat16()
    mid.backward(dmid)
    dx, da = fused_dropout_bwd_plain(xt.detach(), at.detach().bfloat16(), dmid, 5, THR)
    assert torch.equal(xt.grad, dx)
    assert at.grad.dtype == torch.float32 and torch.equal(at.grad, da.bfloat16().float())
    assert torch.equal(mid, fused_dropout_matmul_plain(xt.detach(), at.detach().bfloat16(), 5, THR))
