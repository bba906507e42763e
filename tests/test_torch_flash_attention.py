"""Port parity: the flash-attention forward's plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU), in f32.

Inputs come from numpy with a seed and are handed to both sides. Tolerance
1e-5 absolute on out and lse: the same f32 arithmetic in another summation
order (and, in JAX, over 128-wide kv tiles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops import flash_attention as jfa
from phantom_vlb_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    attention_packed,
    attention_packed_plain,
    kv_bias,
)

TOL = 1e-5
D = 32


def _inputs(seed, b, s, hq, hkv, valid=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq * D)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    mask = None
    if valid is not None:
        mask = (np.arange(s)[None] < np.asarray(valid)[:, None]).astype(np.int32)
    return q, k, v, mask


def _jax_out_lse(q, k, v, hq, hkv, mask):
    """out via the public attention_packed, lse via the same forward impl."""
    jm = None if mask is None else jnp.asarray(mask)
    out = jfa.attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hq, hkv,
                               kv_mask=jm, interpret=True)
    s = q.shape[1]
    bq, bk = min(1024, max(s, 8)), jfa._pick_kv_block(s, 1024)
    _, lse, _, _ = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, True,
                                 1.0 / np.sqrt(D), bq, bk, True, 0, heads=(hq, hkv))
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize(
    "case,b,s,hq,hkv,valid",
    [
        ("causal", 2, 128, 4, 2, None),
        ("right_padding", 2, 128, 4, 2, [128, 77]),
        ("ragged_s", 2, 200, 4, 2, [200, 131]),
        ("gqa_group_4", 1, 96, 8, 2, [90]),
        ("all_keys_masked_row", 2, 64, 2, 1, [0, 64]),
    ],
)
def test_plain_matches_jax_pallas(case, b, s, hq, hkv, valid):
    q, k, v, mask = _inputs(len(case), b, s, hq, hkv, valid)
    out_j, lse_j = _jax_out_lse(q, k, v, hq, hkv, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    out_t, lse_t = attention_packed_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), hq, hkv, kv_mask=tm
    )
    assert out_t.shape == (b, s, hq * D) and lse_t.shape == (b, hq, s)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=TOL * np.abs(lse_j).max(), rtol=0)


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v, mask = _inputs(7, 2, 70, 4, 1, [70, 30])
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4, 1)
    out_w, lse_w = attention_packed(*args, kv_mask=torch.from_numpy(mask))
    out_p, lse_p = attention_packed_plain(*args, kv_mask=torch.from_numpy(mask))
    assert torch.equal(out_w, out_p) and torch.equal(lse_w, lse_p)


def test_kv_bias_is_additive_mask_value():
    bias = kv_bias(torch.tensor([[1, 1, 0], [0, 2, 1]]))
    assert bias.dtype == torch.float32
    m32 = float(np.float32(MASK_VALUE))
    assert bias.tolist() == [[0.0, 0.0, m32], [m32, 0.0, 0.0]]
    assert MASK_VALUE == jfa.MASK_VALUE
    assert kv_bias(None) is None


def test_masked_row_is_uniform_not_nan():
    q, k, v, _ = _inputs(3, 1, 16, 2, 1)
    mask = torch.zeros(1, 16, dtype=torch.int32)
    out, lse = attention_packed_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2, 1, kv_mask=mask
    )
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    # Row r averages keys 0..r uniformly (the causal mask still applies).
    vt = torch.from_numpy(v)[0]
    expect = torch.cumsum(vt, 0) / torch.arange(1, 17)[:, None]
    torch.testing.assert_close(out[0, :, :D], expect, atol=1e-5, rtol=0)
