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

import math

import jax
import jax.ad_checkpoint  # noqa: F401  (the JAX forward names its residuals through it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops import flash_attention as jfa
from phantom_vlb_tpu_torch.ops import _build
from phantom_vlb_tpu_torch.ops.flash_attention import (
    BWD_Q_TILE,
    attention_packed,
    attention_packed_bwd,
    attention_packed_bwd_plain,
    bwd_padded_len,
    flash_bwd_post_plain,
    flash_bwd_prep_plain,
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


@pytest.mark.parametrize("b,s,hq", [(2, 70, 4), (1, 128, 8)])
def test_prep_matches_the_reference_inputs(b, s, hq):
    """The prep's plain version against the reference's own arithmetic
    (``_bwd_impl``, phantom_vlb_tpu/ops/flash_attention.py:509-529) on bf16
    inputs: q pre-scaled in bf16 bit for bit, di within 1e-6 of max|di|; the
    statistics zero-padded to whole q tiles and the dq accumulator zeroed."""
    rng = np.random.default_rng(s)
    q, o, do = (rng.standard_normal((b, s, hq * D)).astype(np.float32) for _ in range(3))
    lse = rng.standard_normal((b, hq, s)).astype(np.float32)
    qt, ot, dot = (torch.from_numpy(x).bfloat16() for x in (q, o, do))
    got = flash_bwd_prep_plain(qt, ot, dot, torch.from_numpy(lse), hq)
    jq, jo, jdo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (qt, ot, dot))
    want_qs = jq * jnp.asarray(1.0 / math.sqrt(D), jq.dtype)
    want_di = jnp.sum((jo.astype(jnp.float32) * jdo.astype(jnp.float32)).reshape(b, s, hq, D),
                      axis=-1).transpose(0, 2, 1)
    s_pad = bwd_padded_len(s)
    assert s_pad % BWD_Q_TILE == 0 and s <= s_pad < s + BWD_Q_TILE
    assert got.qs.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.qs.float().numpy(), np.asarray(want_qs.astype(jnp.float32)))
    # di: f32 sums of D products in another order, so 1e-6 of max|di| (a row
    # sum near 0 after cancellation has no relative bound of its own).
    want_di = np.asarray(want_di)
    np.testing.assert_allclose(got.di[..., :s].numpy(), want_di, rtol=0, atol=1e-6 * np.abs(want_di).max())
    assert got.di.shape == got.lse.shape == (b, hq, s_pad)
    assert torch.equal(got.lse[..., :s], torch.from_numpy(lse))
    assert not got.di[..., s:].any() and not got.lse[..., s:].any()
    assert got.acc.shape == (b, hq, s_pad, D) and not got.acc.any()


def test_post_matches_the_ring_step_arithmetic():
    """The post's plain version: ``bf16(acc * scale)`` as the packed path
    cast its dq, and the accumulate form as the ring added each step's dq
    (``dq.add_(dq_acc.mul_(scale).to(bf16))``), bit for bit, with the
    accumulator's rows below S zeroed for the next step."""
    b, s, h = 2, 70, 4
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((b, h, bwd_padded_len(s), D)).astype(np.float32))
    dq32 = torch.from_numpy(rng.standard_normal((b, s, h * D)).astype(np.float32))
    scale = 1.0 / math.sqrt(D)
    packed = acc[:, :, :s].permute(0, 2, 1, 3).reshape(b, s, h * D)
    assert torch.equal(flash_bwd_post_plain(acc, s, scale), (packed * scale).to(torch.bfloat16))
    want = dq32.clone().add_(packed.clone().mul_(scale).to(torch.bfloat16))
    got = flash_bwd_post_plain(acc, s, scale, dq32=dq32)
    assert got is dq32 and torch.equal(got, want) and not acc[:, :, :s].any()


@pytest.mark.parametrize("s,q_tiles", [(2048, 32), (512, 8), (1000, 16), (4608, 72)])
def test_backward_pads_to_whole_q_tiles(s, q_tiles):
    """The main kernel reads lse, di and dq's accumulator in whole 64-row q
    tiles by bulk copies and reduce-adds: the prep pads them to the q tiles
    that cover S, and the rows past S hold zeros."""
    s_pad = bwd_padded_len(s)
    assert s_pad == q_tiles * BWD_Q_TILE and s_pad - BWD_Q_TILE < s <= s_pad
    b, hq = 1, 2
    x = torch.ones(b, s, hq * D)
    got = flash_bwd_prep_plain(x, x, x, torch.ones(b, hq, s), hq)
    assert got.lse.shape == got.di.shape == (b, hq, s_pad) and got.acc.shape == (b, hq, s_pad, D)
    assert got.lse[..., :s].eq(1).all() and got.di[..., :s].eq(D).all()
    assert not got.lse[..., s:].any() and not got.di[..., s:].any() and not got.acc.any()


@pytest.mark.parametrize("probe", ["NO_DQ_REDUCE", "NO_EXP", "GROUPED"])
def test_cost_probe_builds_are_separate_libraries(probe):
    """A cost probe of ``flash_bwd.cu`` (a macro its header names) builds
    into a library of its own, with the macro defined, beside the kernel
    as it stands; nothing is compiled here."""
    macro = f"FLASH_BWD_PROBE_{probe}"
    source = _build.CSRC_DIR / "flash_bwd.cu"
    assert f"#ifdef {macro}" in source.read_text()
    kernel = _build.CudaKernel("flash_bwd.cu", "flash_bwd_launch", [], defines=(macro,))
    assert kernel.target == (source, (macro,))
    assert _build._split(kernel.target) == (source, (macro,)) and _build._split(source) == (source, ())
    assert f"-D{macro}" in _build._flags(source, (macro,)) and f"-D{macro}" not in _build._flags(source)
    assert _build._library(source, (macro,)) != _build._library(source)
    assert _build._library(source, (macro,)).parent == _build._library(source).parent == _build.BUILD_DIR
