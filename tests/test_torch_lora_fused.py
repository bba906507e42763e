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


# ---- the forward's and dA's plans (clusters of blocks that split the
# reduction and fold it in the launch): checked here, on the CPU, by
# replaying the kernel's split of the work ----

from phantom_vlb_tpu_torch.ops import lora_fused as lf  # noqa: E402

PLAN_SHAPES = [(6144, 4096), (6144, 14336), (3072, 4096), (6144, 2048), (6144, 7168),
               (1, 4096), (100, 4096), (6145, 4096)]


def _chunks(m, k, which):
    """(output tiles, reduced chunks) of the forward or dA at (m, k)."""
    rows, cols = -(-m // 64), k // 64
    return (rows, cols) if which == "fwd" else (cols, rows)


@pytest.mark.parametrize("m,k", PLAN_SHAPES)
@pytest.mark.parametrize("r", [16, 32, 64, 128])
@pytest.mark.parametrize("which", ["fwd", "da"])
@pytest.mark.parametrize("bits", [False, True])
def test_plan_owns_every_chunk_once_and_fits_the_card(m, k, r, which, bits):
    plan = (lf._fwd_plan if which == "fwd" else lf._da_plan)(m, k, r, bits)
    cs, clusters, resident = plan
    n_out, n_red = _chunks(m, k, which)
    assert cs in lf.CLUSTER_SIZES and cs <= 8 and cs <= n_red and 1 <= clusters <= n_out
    # The kernel's split: cluster c's output tiles, its rank q's reduced chunks.
    owned = np.zeros((n_out, n_red), np.int64)
    for c in range(clusters):
        outs = list(range(c, n_out, clusters))
        assert outs
        for q in range(cs):
            r0, r1 = n_red * q // cs, n_red * (q + 1) // cs
            assert r1 > r0
            owned[outs, r0:r1] += 1
    assert (owned == 1).all()                                    # every x tile read by one block
    assert lf.plan_smem_bytes(plan, n_red, r, bits) <= 227 * 1024
    assert resident == (lf.smem_bytes(r, -(-n_red // cs), bits) <= lf.SMEM_PER_BLOCK)
    # One wave of an H100: at most as many clusters of cs as it holds at
    # once, one block an SM (132).
    assert clusters <= lf.H100_CLUSTERS[lf.CLUSTER_SIZES.index(cs)] and cs * clusters <= 132


def test_plans_at_the_path_shapes():
    # The grids csrc/lora_dropout.cu's design note states, at r 16: (cs,
    # clusters, resident) of the forward and of dA.
    want = {(6144, 4096): ((1, 96, False), (2, 64, False)), (6144, 14336): ((8, 14, True), (1, 112, False)),
            (3072, 4096): ((2, 48, True), (2, 64, True)), (6144, 2048): ((1, 96, True), (2, 32, False)),
            (6144, 7168): ((1, 96, False), (1, 112, False))}
    for (m, k), (fwd, da) in want.items():
        assert (lf._fwd_plan(m, k, 16), lf._da_plan(m, k, 16)) == (fwd, da)


@pytest.mark.parametrize("caps", [(114, 57, 26, 13), (132, 66, 32, 16), (8, 4, 2, 1)])
def test_plans_follow_the_card(caps):
    for m, k in PLAN_SHAPES:
        for which in ("fwd", "da"):
            cs, clusters, _ = (lf._fwd_plan if which == "fwd" else lf._da_plan)(m, k, 16, caps=caps)
            assert clusters <= caps[lf.CLUSTER_SIZES.index(cs)]


def test_the_kernel_mirrors_the_plans_constants():
    src = lf.LORA_FWD.source.read_text()
    assert "return R == 16 ? 12 : R == 32 ? 8 : R == 64 ? 6 : 2;" in src
    assert lf.STAGES == {16: 12, 32: 8, 64: 6, 128: 2}
    assert "groups(int R) { return R <= 32 ? 4 : 2; }" in src and lf.GROUPS == {16: 4, 32: 4, 64: 2, 128: 2}
    assert "constexpr uint32_t SMEM_LIMIT = 232448;" in src and lf.SMEM_PER_BLOCK == 232448
    # layout_of at R 16 with 16 resident chunks, hash mode: rings, chunks,
    # the stages' row keys, four groups' padded partials and three of the
    # block's, barriers, slack.
    assert "constexpr int PART_SLOTS = 3;" in src
    assert lf.smem_bytes(16, 16, False) == 12 * 8192 + 16 * 2048 + 12 * 256 + (4 + 3) * 64 * 20 * 4 + 8 * 25 + 1024
