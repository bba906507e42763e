"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip without a CUDA card; whether one exists is decided inside the
fixture, never at import. On the card (which has no JAX, so the JAX test
harness in conftest.py is left out)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from phantom_vlb_tpu_torch.core.mesh import SequenceRing
from phantom_vlb_tpu_torch.ops.context_parallel import ring_attention
from phantom_vlb_tpu_torch.ops.flash_attention import (
    FLASH_BWD,
    FLASH_BWD_POST,
    FLASH_BWD_PREP,
    FLASH_FWD,
    attention_packed,
    attention_packed_bwd,
    attention_packed_bwd_plain,
    attention_packed_plain,
    attention_with_stats,
    flash_bwd_post,
    flash_bwd_post_plain,
    flash_bwd_prep,
    flash_bwd_prep_plain,
)
from phantom_vlb_tpu_torch.ops.lora_epilogue import (
    EPI_DB,
    EPI_DZ,
    EPI_FWD,
    lora_epilogue,
    lora_epilogue_db,
    lora_epilogue_db_plain,
    lora_epilogue_dz,
    lora_epilogue_dz_plain,
    lora_epilogue_fwd,
    lora_epilogue_plain,
)
from phantom_vlb_tpu_torch.ops.lora_fused import (
    LORA_DA,
    LORA_DX,
    LORA_FWD,
    fused_dropout_bwd,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
)

from phantom_vlb_tpu_torch.ops.ring_fused import RING_FWD, ring_flash_fused, ring_fwd, ring_fwd_plain
from phantom_vlb_tpu_torch.ops.quant import int8_matmul, int8_matmul_w8a8, int8_matmul_w8a8g8, quantize_int8
from phantom_vlb_tpu_torch.ops.rowquant import (
    ROW_QUANT,
    ROW_QUANT_SCALED,
    row_quant,
    row_quant_plain,
    row_quant_scaled,
)

pytestmark = pytest.mark.gpu

D = 128
# bf16 out (2^-8 relative at |out| <= ~1, bf16 P in PV); f32 lse, order only.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
# Backward, as max|err| / max|ref| of dq, dk, dv: bf16 outputs (2^-9), and
# bf16 p and ds whose roundings may flip where exp2 and exp differ by an ulp.
BWD_REL_TOL = 2e-2
# The backward's prep kernel's di, max|err| / max|ref|: f32 sums of 128
# products in another order (~128 * 2^-24).
DI_REL_TOL = 1e-5
# LoRA kernels vs plain, as max|err| / max|ref|: bf16 mid and dx (one
# rounding after f32 sums in another order); dA is f32 (order only).
MID_REL_TOL, DX_REL_TOL, DA_REL_TOL = 1e-2, 1e-2, 1e-3
P, THR = 0.1, 26
# Epilogue kernels vs plain, max|err| / max|ref|: bf16 outputs after f32
# sums in another order (the forward also rounds acc and acc * s to bf16).
EPI_REL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, b, s, hq, hkv, valid=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, hq * D, generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, s, hkv * D, generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, s, hkv * D, generator=g, device=dev, dtype=torch.bfloat16)
    mask = None
    if valid is not None:
        mask = (torch.arange(s, device=dev)[None] < torch.tensor(valid, device=dev)[:, None]).int()
    return q, k, v, mask


def _reference(q, k, v, hq, hkv, mask, causal_offset=0):
    q_s = q * torch.tensor(D ** -0.5, dtype=q.dtype, device=q.device)
    return attention_packed_plain(q_s.float(), k.float(), v.float(), hq, hkv,
                                  sm_scale=1.0, kv_mask=mask, causal_offset=causal_offset)


@pytest.mark.parametrize(
    "b,s,hq,hkv,valid",
    [
        (1, 64, 4, 1, None),            # one tile
        (2, 200, 8, 2, [200, 150]),     # ragged S, right padding
        (2, 1000, 32, 8, [1000, 613]),  # serving heads, ragged S
        (1, 2048, 32, 8, None),         # serving length
        (3, 129, 4, 4, [129, 1, 64]),   # group 1, one valid key
        (2, 256, 16, 4, [0, 256]),      # a row with every key masked
    ],
)
def test_flash_fwd_matches_plain(cuda, b, s, hq, hkv, valid):
    q, k, v, mask = _inputs(cuda, b, s, hq, hkv, valid)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=mask)
    torch.cuda.synchronize()
    out_ref, lse_ref = _reference(q, k, v, hq, hkv, mask)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - out_ref).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_flash_fwd_counts_launches(cuda):
    q, k, v, _ = _inputs(cuda, 1, 128, 4, 2)
    before = FLASH_FWD.launches
    attention_packed(q, k, v, 4, 2)
    attention_packed(q, k, v, 4, 2)
    assert FLASH_FWD.launches == before + 2


def test_flash_fwd_raises_on_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, 1, 128, 4, 2)
    with pytest.raises(ValueError):
        attention_packed(q.float(), k.float(), v.float(), 4, 2)       # f32
    with pytest.raises(ValueError):
        attention_packed(q[:, ::2], k[:, ::2], v[:, ::2], 4, 2)       # strided
    with pytest.raises(ValueError):
        attention_packed(q, k, v, 8, 4)                               # head dim 64
    with pytest.raises(ValueError):
        attention_packed(q, k.cpu(), v, 4, 2)                         # mixed devices


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize(
    "b,s,hq,hkv,valid",
    [
        (1, 64, 4, 1, None),            # one tile, group 4
        (2, 200, 8, 4, [200, 150]),     # ragged S, group 2, right padding
        (2, 1000, 32, 8, [1000, 613]),  # training heads, ragged S
        (3, 129, 4, 4, [129, 1, 64]),   # group 1, one valid key
        (2, 256, 16, 4, [0, 256]),      # a row with every key masked
        (1, 4608, 8, 2, [4000]),        # past the reference's fused-backward limit
    ],
)
def test_flash_bwd_matches_plain(cuda, b, s, hq, hkv, valid):
    q, k, v, mask = _inputs(cuda, b, s, hq, hkv, valid)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=mask)
    do = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda, dtype=torch.bfloat16)
    got = attention_packed_bwd(q, k, v, out, lse, do, hq, hkv, kv_mask=mask)
    torch.cuda.synchronize()
    want = attention_packed_bwd_plain(q, k, v, out, lse, do, hq, hkv, kv_mask=mask)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= BWD_REL_TOL


@pytest.mark.parametrize(
    "b,s,hq,hkv,valid,offset",
    [
        (2, 200, 8, 8, [200, 150], 0),        # group 1, S < one 128-row kv tile
        (2, 1000, 16, 8, [1000, 613], 0),     # group 2, S not a multiple of 64 or 128
        (2, 1000, 32, 8, None, 64),           # group 4, a tile's offset
        (2, 300, 32, 4, [300, 211], 0),       # group 8
        (1, 4608, 8, 1, [4000], 0),           # group 8, past the reference's fused limit
        (3, 512, 32, 8, [512, 400, 300], 512),  # the ring's step: a whole chunk back
        (3, 512, 8, 2, None, 64),             # a tile back, no mask
        (1, 130, 4, 2, None, 0),              # two q tiles, one row past the first kv tile
    ],
)
def test_flash_bwd_tiles_match_plain(cuda, b, s, hq, hkv, valid, offset):
    """The backward at lengths off its 64-row q and 128-row kv tiles, every
    GQA group size the model family uses, and the ring's causal offsets."""
    q, k, v, mask = _inputs(cuda, b, s, hq, hkv, valid, seed=s + offset)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=mask, causal_offset=offset)
    do = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda,
                     dtype=torch.bfloat16)
    counts = (FLASH_BWD_PREP.launches, FLASH_BWD.launches, FLASH_BWD_POST.launches)
    got = attention_packed_bwd(q, k, v, out, lse, do, hq, hkv, kv_mask=mask, causal_offset=offset)
    torch.cuda.synchronize()
    assert (FLASH_BWD_PREP.launches, FLASH_BWD.launches, FLASH_BWD_POST.launches) == tuple(
        c + 1 for c in counts)
    want = attention_packed_bwd_plain(q, k, v, out, lse, do, hq, hkv, kv_mask=mask,
                                      causal_offset=offset)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert _rel(g, w) <= BWD_REL_TOL


@pytest.mark.parametrize("b,s,hq", [(2, 200, 8), (3, 512, 32), (1, 1000, 16)])
def test_flash_bwd_prep_and_post_match_plain(cuda, b, s, hq):
    """The prep kernel (q_s and the padded lse bit for bit, di to f32
    order, the accumulator zeroed) and the post kernel in both forms (bit
    for bit) against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, out, do = (torch.randn(b, s, hq * D, generator=g, device=cuda, dtype=torch.bfloat16)
                  for _ in range(3))
    lse = torch.randn(b, hq, s, generator=g, device=cuda)
    got, want = flash_bwd_prep(q, out, do, lse, hq), flash_bwd_prep_plain(q, out, do, lse, hq)
    torch.cuda.synchronize()
    assert torch.equal(got.qs, want.qs) and torch.equal(got.lse, want.lse)
    assert _rel(got.di, want.di) <= DI_REL_TOL and bool((got.acc == 0).all())
    acc = torch.randn(want.acc.shape, generator=g, device=cuda)
    dq32 = torch.randn(q.shape, generator=g, device=cuda)
    acc2, dq32_2 = acc.clone(), dq32.clone()
    assert torch.equal(flash_bwd_post(acc, s, 0.125), flash_bwd_post_plain(acc, s, 0.125))
    flash_bwd_post(acc, s, 0.125, dq32=dq32)
    flash_bwd_post_plain(acc2, s, 0.125, dq32=dq32_2)
    torch.cuda.synchronize()
    assert torch.equal(dq32, dq32_2) and torch.equal(acc, acc2) and not acc[:, :, :s].any()


def test_gradients_flow_through_the_kernels(cuda):
    q, k, v, mask = _inputs(cuda, 2, 300, 8, 2, [300, 211])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = attention_packed(q, k, v, 8, 2, kv_mask=mask)
    do = torch.randn_like(out)
    before = FLASH_BWD.launches
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    assert FLASH_BWD.launches == before + 1
    want = attention_packed_bwd(q.detach(), k.detach(), v.detach(), out.detach(), lse, do, 8, 2,
                                kv_mask=mask)
    # The same kernels twice; dq's reduce-adds may sum in another order.
    for g, w in zip((dq, dk, dv), want):
        assert g.abs().max() > 0 and _rel(g, w) <= BWD_REL_TOL


def _lora_inputs(dev, m, k, r, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    a = (0.05 * torch.randn(k, r, generator=g, device=dev)).to(torch.bfloat16)
    dmid = torch.randn(m, r, generator=g, device=dev, dtype=torch.bfloat16)
    bits = torch.randint(0, 256, (m, k), generator=g, device=dev, dtype=torch.uint8)
    return x, a, dmid, bits


@pytest.mark.parametrize("m,k,r", [(256, 512, 16), (200, 192, 32), (96, 4096, 16), (64, 256, 128)])
@pytest.mark.parametrize("mode", ["bits", "hash"])
def test_lora_kernels_match_plain(cuda, m, k, r, mode):
    x, a, dmid, bits = _lora_inputs(cuda, m, k, r)
    bits = bits if mode == "bits" else None
    mid = fused_dropout_matmul(x, a, 7, P, bits=bits)
    dx, da = fused_dropout_bwd(x, a, dmid, 7, P, bits=bits)
    torch.cuda.synchronize()
    assert _rel(mid, fused_dropout_matmul_plain(x, a, 7, THR, bits)) <= MID_REL_TOL
    dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, 7, THR, bits)
    assert _rel(dx, dx_ref) <= DX_REL_TOL
    assert (dx == 0).equal(dx_ref == 0)                  # the same elements dropped
    assert _rel(da, da_ref) <= DA_REL_TOL


def test_lora_hash_mask_is_exact(cuda):
    m, k, r = 320, 1024, 16
    x = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    a = torch.zeros(k, r, device=cuda, dtype=torch.bfloat16)
    a[:, 0] = 1
    dmid = torch.zeros(m, r, device=cuda, dtype=torch.bfloat16)
    dmid[:, 0] = 1
    for seed in (0, 1, 2**32 - 1):
        dx, _ = fused_dropout_bwd(x, a, dmid, seed, P, need_da=False)
        torch.cuda.synchronize()
        assert torch.equal(dx != 0, hash_bytes(seed, m, k, cuda) >= THR)


def test_lora_gradients_and_launch_counts(cuda):
    x, a, _, _ = _lora_inputs(cuda, 128, 256, 16)
    x.requires_grad_()
    a = a.float().requires_grad_()
    counts = [t.launches for t in (LORA_FWD, LORA_DX, LORA_DA)]
    mid = fused_dropout_matmul(x, a.to(torch.bfloat16), 3, P)
    mid.float().square().sum().backward()
    assert [t.launches for t in (LORA_FWD, LORA_DX, LORA_DA)] == [c + 1 for c in counts]
    assert x.grad.abs().max() > 0 and a.grad.abs().max() > 0 and a.grad.dtype == torch.float32


def test_backward_and_lora_raise_on_what_they_do_not_take(cuda):
    q, k, v, _ = _inputs(cuda, 1, 128, 4, 2)
    out, lse = attention_packed(q, k, v, 4, 2)
    with pytest.raises(ValueError):
        attention_packed_bwd(q, k, v, out, lse, out.float(), 4, 2)          # f32 do
    with pytest.raises(ValueError):
        attention_packed_bwd(q, k, v, out, lse[:, :2], out, 4, 2)            # wrong lse
    x, a, _, bits = _lora_inputs(cuda, 64, 256, 16)
    with pytest.raises(ValueError):
        fused_dropout_matmul(x.float(), a.float(), 0, P)                     # f32
    with pytest.raises(ValueError):
        fused_dropout_matmul(x[:, :200].contiguous(), a[:200], 0, P)        # K % 64
    with pytest.raises(ValueError):
        fused_dropout_matmul(x, a[:, :8].contiguous(), 0, P)                 # rank 8
    with pytest.raises(ValueError):
        fused_dropout_matmul(x, a, 0, P, bits=bits[:, :128])                 # bits shape


@pytest.mark.parametrize("rows,n", [(64, 4096), (24, 14336), (13, 1000), (5, 7), (3, 30000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_quant_kernels_match_plain_bit_for_bit(cuda, rows, n, dtype):
    """Any row count and width (odd, unaligned, longer than shared memory
    holds), zero rows included: q and s equal the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(rows + n)
    x = (3 * torch.randn(rows, n, generator=g, device=cuda)).to(dtype)
    x[rows // 2] = 0
    w = torch.rand(n, generator=g, device=cuda) * 2 + 0.01
    for got, want in ((row_quant(x), row_quant_plain(x)), (row_quant_scaled(x, w), row_quant_plain(x, w))):
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1][rows // 2].item() == torch.tensor(1e-12).item()


def test_row_quant_counts_and_raises(cuda):
    x = torch.randn(4, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = (ROW_QUANT.launches, ROW_QUANT_SCALED.launches)
    q, s = row_quant(x)
    row_quant_scaled(x, torch.ones(64, device=cuda))
    assert q.shape == x.shape and s.shape == (4, 2, 1)
    assert (ROW_QUANT.launches, ROW_QUANT_SCALED.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        row_quant(x.half())                                              # fp16
    with pytest.raises(ValueError):
        row_quant(x[..., ::2])                                           # strided
    with pytest.raises(ValueError):
        row_quant_scaled(x, torch.ones(32, device=cuda))                 # scale width
    with pytest.raises(ValueError):
        row_quant_scaled(x, torch.ones(64, device=cuda, dtype=torch.bfloat16))


def _epi_inputs(dev, m, n, r, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(m, n, generator=g, device=dev, dtype=torch.bfloat16)
    z = torch.randn(m, r, generator=g, device=dev, dtype=torch.bfloat16)
    b = (torch.randn(r, n, generator=g, device=dev) / r ** 0.5).to(torch.bfloat16)
    dy = torch.randn(m, n, generator=g, device=dev, dtype=torch.bfloat16)
    return y, z, b, dy


@pytest.mark.parametrize("m,n,r", [(256, 1024, 16), (6144, 4096, 16), (100, 300, 4), (70, 1000, 37),
                                   (64, 256, 128), (33, 9, 16)])
def test_epilogue_kernels_match_plain(cuda, m, n, r):
    """Forward, dz and dB at model widths, with M and N tails, odd N and
    ranks padded to 16, 64 and 128."""
    y, z, b, dy = _epi_inputs(cuda, m, n, r)
    got = (lora_epilogue_fwd(y, z, b, 2.0), lora_epilogue_dz(dy, b, 2.0), lora_epilogue_db(z, dy, 2.0))
    torch.cuda.synchronize()
    want = (lora_epilogue_plain(y, z, b, 2.0), lora_epilogue_dz_plain(dy, b, 2.0),
            lora_epilogue_db_plain(z, dy, 2.0))
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and gt.dtype == torch.bfloat16 and torch.isfinite(gt).all()
        assert _rel(gt, wt) <= EPI_REL_TOL


@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_epilogue_autograd_and_launch_counts(cuda, backward):
    y, z, b, dy = _epi_inputs(cuda, 512, 768, 16)
    y, z, b = (t.requires_grad_() for t in (y, z, b))
    counts = [k.launches for k in (EPI_FWD, EPI_DZ, EPI_DB)]
    out = lora_epilogue(y.view(2, 256, 768), z.view(2, 256, 16), b, 2.0, backward=backward)
    out.backward(dy.view(2, 256, 768))
    extra = 1 if backward == "pallas" else 0
    assert [k.launches for k in (EPI_FWD, EPI_DZ, EPI_DB)] == [counts[0] + 1, counts[1] + extra,
                                                              counts[2] + extra]
    assert torch.equal(y.grad, dy)
    assert _rel(z.grad, lora_epilogue_dz_plain(dy, b.detach(), 2.0)) <= EPI_REL_TOL
    assert _rel(b.grad, lora_epilogue_db_plain(z.detach(), dy, 2.0)) <= EPI_REL_TOL


def test_epilogue_raises_on_what_it_does_not_take(cuda):
    y, z, b, dy = _epi_inputs(cuda, 64, 256, 16)
    with pytest.raises(ValueError):
        lora_epilogue_fwd(y.float(), z.float(), b.float(), 2.0)                 # f32
    with pytest.raises(ValueError):
        lora_epilogue_fwd(y[:, ::2], z, b[:, ::2], 2.0)                          # strided
    big_z = torch.zeros(64, 129, device=cuda, dtype=torch.bfloat16)
    big_b = torch.zeros(129, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_fwd(y, big_z, big_b, 2.0)                                  # r > 128
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_dz(dy, big_b, 2.0)
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_db(big_z, dy, 2.0)


@pytest.mark.parametrize("name", ["int8_matmul", "int8_matmul_w8a8", "int8_matmul_w8a8g8"])
def test_int8_matmuls_on_the_card_match_the_cpu(cuda, name):
    """The card (row-quant kernels, ``torch._int_mm``, cuBLAS) against the
    CPU (plain row quant, exact f64 int product) on the same bf16 inputs and
    int8 weights stored (out, in): outputs and dx within 2e-2 of their
    largest value (bf16 outputs; an activation code may flip where f32
    scaling differs by an ulp)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, s = quantize_int8(0.02 * torch.randn(1024, 512, generator=g, device=cuda), axis=1)
    x = torch.randn(4, 64, 512, generator=g, device=cuda, dtype=torch.bfloat16)
    dy = torch.randn(4, 64, 1024, generator=g, device=cuda, dtype=torch.bfloat16)
    fn = {"int8_matmul": int8_matmul, "int8_matmul_w8a8": int8_matmul_w8a8,
          "int8_matmul_w8a8g8": int8_matmul_w8a8g8}[name]
    results = []
    for dev in (cuda, "cpu"):
        xd = x.detach().to(dev).requires_grad_()
        y = fn(xd, q.to(dev).t(), s.to(dev), torch.bfloat16)
        y.backward(dy.to(dev))
        results.append((y.detach().cpu(), xd.grad.cpu()))
    (y_c, dx_c), (y_r, dx_r) = results
    assert y_c.dtype == torch.bfloat16 and dx_c.dtype == torch.bfloat16
    assert _rel(y_c, y_r) <= 2e-2 and _rel(dx_c, dx_r) <= 2e-2


@pytest.mark.parametrize("offset", [64, 100, 512])
def test_flash_kernels_with_a_causal_offset_match_plain(cuda, offset):
    """The forward and backward kernels with the ring's causal offsets (a
    whole chunk back, a tile, a ragged shift) against their plain versions."""
    q, k, v, mask = _inputs(cuda, 2, 512, 8, 2, [512, 400], seed=offset)
    out, lse = attention_with_stats(q, k, v, 8, 2, kv_mask=mask, causal_offset=offset)
    do = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda, dtype=torch.bfloat16)
    got = attention_packed_bwd(q, k, v, out, lse, do, 8, 2, kv_mask=mask, causal_offset=offset)
    torch.cuda.synchronize()
    out_ref, lse_ref = _reference(q, k, v, 8, 2, mask, offset)
    assert (out.float() - out_ref).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    want = attention_packed_bwd_plain(q, k, v, out, lse, do, 8, 2, kv_mask=mask, causal_offset=offset)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w) <= BWD_REL_TOL


@pytest.mark.parametrize("n,s,valid", [(2, 1024, None), (4, 1024, [1024, 700]), (2, 1000, [1000, 613]),
                                       (4, 2048, [2048, 1500])])
def test_ring_fwd_on_one_card_matches_plain(cuda, n, s, valid):
    """n ranks on one card (S_loc 500 is not a multiple of 64): the kernel,
    one launch per rank, against its plain version on the same inputs."""
    q, k, v, mask = _inputs(cuda, 2, s, 8, 2, valid, seed=n)
    ring = SequenceRing([cuda] * n)
    before = RING_FWD.launches
    out, lse = ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask)
    torch.cuda.synchronize()
    assert RING_FWD.launches == before + n
    out_ref, lse_ref = ring_fwd_plain(q, k, v, 8, 2, ring, kv_mask=mask)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_ring_fwd_passes_never_read_an_earlier_pass(cuda):
    """Pass after pass on one ring (the flags carry epochs and are never
    reset): each pass's result is its own inputs'."""
    ring = SequenceRing([cuda] * 4)
    for seed in range(3):
        q, k, v, mask = _inputs(cuda, 1, 512, 4, 1, [450], seed=seed)
        out, _ = ring_fwd(q, k, v, 4, 1, ring, kv_mask=mask)
        out_ref, _ = ring_fwd_plain(q, k, v, 4, 1, ring, kv_mask=mask)
        torch.cuda.synchronize()
        assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL


def test_ring_flash_fused_gradients_match_the_plain_ring(cuda):
    """Kernel forward and per-step flash backward on a 4-rank card ring
    against autograd through the plain ring (f32 on the same bf16 inputs)."""
    q, k, v, mask = _inputs(cuda, 2, 512, 8, 2, [512, 300])
    ring = SequenceRing([cuda] * 4)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda,
                     dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (RING_FWD.launches, FLASH_BWD.launches)
    got = torch.autograd.grad(ring_flash_fused(*leaves, 8, 2, ring, kv_mask=mask), leaves, do)
    assert (RING_FWD.launches, FLASH_BWD.launches) == (counts[0] + 4, counts[1] + 10)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ring_attention(*ref_leaves, 8, 2, ring, kv_mask=mask), ref_leaves,
                               do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all() and _rel(g, w) <= BWD_REL_TOL


def test_ring_over_two_cards(cuda):
    """Ranks on cuda:0 and cuda:1: chunks and flags cross by peer copies."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a ring over distinct cards waits for a machine that has them")
    q, k, v, mask = _inputs(cuda, 2, 1024, 8, 2, [1024, 800])
    ring = SequenceRing([torch.device("cuda", 0), torch.device("cuda", 1)] * 2)
    out, lse = ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask)
    torch.cuda.synchronize()
    out_ref, lse_ref = ring_fwd_plain(q, k, v, 8, 2, ring, kv_mask=mask)
    assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ring_flash_fused(*leaves, 8, 2, ring, kv_mask=mask), leaves, out)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ring_attention(*ref_leaves, 8, 2, ring, kv_mask=mask), ref_leaves,
                               out.float())
    for g, w in zip(got, want):
        assert g.device == q.device and _rel(g, w) <= BWD_REL_TOL


def test_ring_fwd_raises_on_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, 1, 256, 4, 2)
    ring = SequenceRing([cuda] * 2)
    with pytest.raises(ValueError):
        ring_fwd(q.float(), k.float(), v.float(), 4, 2, ring)                  # f32
    with pytest.raises(ValueError):
        ring_fwd(q, k, v, 8, 4, ring)                                          # head dim 64
    with pytest.raises(ValueError):
        ring_fwd(q, k, v, 4, 2, SequenceRing([cuda] * 3))                      # 256 % 3
    with pytest.raises(ValueError):
        ring_fwd(q, k, v, 4, 2, SequenceRing([cuda, "cpu"]))                   # a CPU rank
