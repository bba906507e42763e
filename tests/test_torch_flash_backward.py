"""Port parity: the flash-attention backward against the JAX package's fused
Pallas backward (``jax.vjp`` of ``attention_packed``, interpret mode on the
CPU), in f32.

Two port routes are held against it: autograd through the plain forward
(what a CPU tensor runs) and ``attention_packed_bwd_plain`` (the arithmetic
the CUDA kernel is held to on the card). Inputs and cotangents come from
numpy with a seed. Tolerance: 1e-5 x max|ref| on dq, dk and dv (the same
f32 arithmetic in another summation order).

One corner differs: a query row whose keys are all masked. Its scores and
its lse all round to MASK_VALUE, so ``p = exp(s - lse)`` (reference
``phantom_vlb_tpu/ops/flash_attention.py:332``) is 1 per key where the
forward averaged with 1/n. The port's kernel and plain backward read the
saved lse as it is and give p = 1; autograd of the plain forward gives the
1/n weights; the reference's own backward gives p = 0, because its
``_col8`` round trip of the statistics (:155-170) moves lse by one ulp
(-2.3819761e38 against -2.3819763e38 on the CPU). Batch rows with every key
masked are therefore compared with JAX on neither route, and
:func:`test_fully_masked_row_corner` pins each route's value there.
"""

import jax
import jax.ad_checkpoint  # noqa: F401  (the JAX forward names its residuals through it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops import flash_attention as jfa
from phantom_vlb_tpu_torch.ops.flash_attention import (
    attention_packed,
    attention_packed_bwd,
    attention_packed_bwd_plain,
)

TOL = 1e-5
D = 32

CASES = [
    ("gqa_group_2", 2, 128, 4, 2, None),
    ("gqa_group_4", 1, 96, 8, 2, [90]),
    ("ragged_s", 2, 200, 4, 2, [200, 131]),
    ("padded_kv", 2, 128, 4, 2, [128, 77]),
    ("all_keys_masked_row", 2, 64, 2, 1, [0, 64]),
]


def _inputs(seed, b, s, hq, hkv, valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq * D)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * D)).astype(np.float32)
    do = rng.standard_normal((b, s, hq * D)).astype(np.float32)
    mask = None
    if valid is not None:
        mask = (np.arange(s)[None] < np.asarray(valid)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, hq, hkv, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jfa.attention_packed(q_, k_, v_, hq, hkv, kv_mask=jm, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, rows=slice(None)):
    want = want[rows]
    np.testing.assert_allclose(got[rows], want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("case,b,s,hq,hkv,valid", CASES)
def test_backward_matches_jax(case, b, s, hq, hkv, valid):
    q, k, v, do, mask = _inputs(len(case), b, s, hq, hkv, valid)
    want = _jax_grads(q, k, v, do, hq, hkv, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = attention_packed(qt, kt, vt, hq, hkv, kv_mask=tm)
    autograd = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    plain = attention_packed_bwd_plain(qt.detach(), kt.detach(), vt.detach(), out.detach(), lse.detach(),
                                       torch.from_numpy(do), hq, hkv, kv_mask=tm)
    # Batch rows with at least one valid key (see the module docstring).
    live = slice(None) if valid is None else np.asarray(valid) > 0
    for g_auto, g_plain, w in zip(autograd, plain, want):
        assert g_plain.shape == w.shape and g_plain.dtype == torch.float32
        _close(g_plain.numpy(), w, live)
        _close(g_auto.numpy(), w, live)


def test_fully_masked_row_corner():
    """dv of a batch row whose keys are all masked: key j is seen by query
    rows i >= j, with p = 1 each in the plain backward (the kernel's
    arithmetic), 1/(i + 1) under autograd, and 0 in the reference."""
    b, s, hq, hkv = 1, 16, 2, 1
    q, k, v, do, _ = _inputs(5, b, s, hq, hkv, None)
    mask = torch.zeros(b, s, dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    dot = torch.from_numpy(do)
    out, lse = attention_packed(qt, kt, vt, hq, hkv, kv_mask=mask)
    dv_auto = torch.autograd.grad(out, vt, dot)[0]
    _, _, dv_plain = attention_packed_bwd_plain(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                                lse.detach(), dot, hq, hkv, kv_mask=mask)
    per_row = dot.reshape(b, s, hq, D).sum(2)                        # summed over the group

    def from_below(x):                                               # sum over rows i >= j
        return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])

    torch.testing.assert_close(dv_plain, from_below(per_row), atol=1e-4, rtol=1e-5)
    n = torch.arange(1, s + 1, dtype=torch.float32)[None, :, None]
    torch.testing.assert_close(dv_auto, from_below(per_row / n), atol=1e-4, rtol=1e-5)
    assert np.abs(_jax_grads(q, k, v, do, hq, hkv, mask.numpy())[2]).max() == 0.0


def test_cpu_bwd_wrapper_runs_the_plain_version():
    q, k, v, do, mask = _inputs(7, 2, 70, 4, 1, [70, 30])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tm = torch.from_numpy(mask)
    out, lse = attention_packed(*args, 4, 1, kv_mask=tm)
    got = attention_packed_bwd(*args, out, lse, torch.from_numpy(do), 4, 1, kv_mask=tm)
    want = attention_packed_bwd_plain(*args, out, lse, torch.from_numpy(do), 4, 1, kv_mask=tm)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_plain_backward_rounds_like_the_kernel_in_bf16():
    """bf16 inputs: p and ds are rounded to bf16 before their products and
    dk/dv are summed over the GQA group in f32 before one cast, so the
    plain backward lands within a bf16 rounding of the f32 one."""
    q, k, v, do, mask = _inputs(11, 1, 64, 4, 1, [50])
    f32 = [torch.from_numpy(x) for x in (q, k, v, do)]
    b16 = [x.bfloat16() for x in f32]
    tm = torch.from_numpy(mask)
    out, lse = attention_packed(*b16[:3], 4, 1, kv_mask=tm)
    got = attention_packed_bwd_plain(*b16[:3], out, lse, b16[3], 4, 1, kv_mask=tm)
    want = attention_packed_bwd_plain(*[x.float() for x in b16[:3]], out.float(), lse,
                                      b16[3].float(), 4, 1, kv_mask=tm)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        rel = ((g.float() - w).abs().max() / w.abs().max()).item()
        assert rel <= 2e-2, rel
