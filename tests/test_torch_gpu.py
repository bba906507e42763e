"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip without a CUDA card; whether one exists is decided inside the
fixture, never at import. On the card (which has no JAX, so the JAX test
harness in conftest.py is left out)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from phantom_vlb_tpu_torch.cli.predict import predict_batches, synthetic_batches
from phantom_vlb_tpu_torch.core.distributed import MULTI_CARD_OPT_IN, maybe_initialize_distributed, shutdown_distributed
from phantom_vlb_tpu_torch.core.mesh import MeshConfig, SequenceRing, build_mesh
from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig
from phantom_vlb_tpu_torch.models.convert import SafetensorsDir, init_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig
from phantom_vlb_tpu_torch.models.mistral import MistralConfig
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, VLBConfig
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
    EPI_DZDB,
    EPI_FWD,
    lora_epilogue,
    lora_epilogue_db,
    lora_epilogue_db_plain,
    lora_epilogue_dz,
    lora_epilogue_dz_plain,
    lora_epilogue_dzdb,
    lora_epilogue_fwd,
    lora_epilogue_plain,
)
from phantom_vlb_tpu_torch.ops.lora_fused import (
    LORA_DA,
    LORA_DX,
    LORA_FWD,
    LORA_KEEP,
    fused_dropout_bwd,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
    keep_bytes,
    keep_bytes_plain,
)

from phantom_vlb_tpu_torch.ops.ring_fused import (
    RING_FWD,
    RING_STATS,
    ring_flash_fused,
    ring_fwd,
    ring_fwd_plain,
)
from phantom_vlb_tpu_torch.ops.quant import int8_matmul, int8_matmul_w8a8, int8_matmul_w8a8g8, quantize_int8
from phantom_vlb_tpu_torch.ops.rowquant import (
    ROW_ABSMAX,
    ROW_QUANT,
    ROW_QUANT_GIVEN,
    ROW_QUANT_SCALED,
    row_absmax,
    row_absmax_plain,
    row_quant,
    row_quant_given,
    row_quant_given_plain,
    row_quant_plain,
    row_quant_scaled,
    row_quant_split,
)
from phantom_vlb_tpu_torch.parallel.sharding import whole
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer
from phantom_vlb_tpu_torch.train.optim import OptimConfig

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
        (3, 2048, 16, 4, None),         # one rank's heads at mesh.tensor=2
        (3, 2048, 4, 1, [2048, 1500, 2048]),  # one rank's heads at mesh.tensor=8
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


@pytest.mark.parametrize(
    "b,s,hq,hkv,valid,offset",
    [
        (1, 4608, 8, 2, [4000], 0),          # long: 36 kv tiles of 128
        (2, 512, 8, 2, [512, 400], 192),     # an offset not a multiple of the 128-row tile
        (2, 512, 8, 2, None, 100),           # the diagonal inside a tile, no mask
        (2, 100, 4, 2, [100, 37], 0),        # one q tile shorter than 128 rows
        (2, 300, 8, 8, [300, 211], 64),      # a short last q tile and half a tile's offset
        (1, 129, 4, 1, None, 0),             # one row past the first tile (bias stride 516 B)
        (3, 512, 32, 8, [512, 400, 300], 512),  # the ring's step: a whole chunk back
    ],
)
def test_flash_fwd_tiles_and_offsets_match_plain(cuda, b, s, hq, hkv, valid, offset):
    """The forward at lengths off its 128-row tiles and at the ring's causal
    offsets, against its plain version."""
    q, k, v, mask = _inputs(cuda, b, s, hq, hkv, valid, seed=s + offset)
    out, lse = attention_with_stats(q, k, v, hq, hkv, kv_mask=mask, causal_offset=offset)
    torch.cuda.synchronize()
    out_ref, lse_ref = _reference(q, k, v, hq, hkv, mask, offset)
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
        (3, 2048, 16, 4, None),         # one rank's heads at mesh.tensor=2
        (3, 2048, 4, 1, [2048, 1500, 2048]),  # one rank's heads at mesh.tensor=8
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


# One tensor rank's row-parallel inputs: columns [col0, col0 + K) of the
# o projection's 4096 and the down projection's 14336 at mesh.tensor=2, and
# a first column off the 64-column tile.
@pytest.mark.parametrize("m,k,col0", [(256, 2048, 2048), (128, 7168, 7168), (96, 512, 68)])
def test_lora_kernels_from_a_first_column_match_plain(cuda, m, k, col0):
    x, a, dmid, _ = _lora_inputs(cuda, m, k, 16)
    mid = fused_dropout_matmul(x, a, 7, P, row0=40, col0=col0)
    dx, da = fused_dropout_bwd(x, a, dmid, 7, P, row0=40, col0=col0)
    torch.cuda.synchronize()
    assert _rel(mid, fused_dropout_matmul_plain(x, a, 7, THR, row0=40, col0=col0)) <= MID_REL_TOL
    dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, 7, THR, row0=40, col0=col0)
    assert _rel(dx, dx_ref) <= DX_REL_TOL and _rel(da, da_ref) <= DA_REL_TOL
    assert torch.equal(dx != 0, hash_bytes(7, m, k, cuda, row0=40, col0=col0) >= THR)
    assert not torch.equal(dx != 0, hash_bytes(7, m, k, cuda, row0=40) >= THR)


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


# ---- the 32-bit rule: keep bytes bit for bit torch.rand's, the kernels'
# bits mode on them ----

KEEP_SEEDS = [0, 1, 2, 7, 99, 12345, 65537, 2**20 + 5, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1,
              3_000_000_019, 2**40 + 3, 2**63 - 1, 0xDEADBEEFCAFE]
KEEP_SHAPES = [(6144, 4096), (6144, 14336), (1,), (3,), (5, 7), (1000,), (3, 2048, 13), (2, 300001),
               (3, 1100, 1001)]
BF16_KEEP = float(torch.tensor(0.9, dtype=torch.bfloat16))
# A bf16 model's gradients, kernel route against eager route, as max|err| /
# max|ref|: the mids' one-rounding differences (MID_REL_TOL) carried through
# two layers' backward, beside flash bwd's run-to-run dq.
ROUTE_REL_TOL = 5e-2


def _torch_keep(shape, seed, keep, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(shape, generator=gen, device=dev) < keep).to(torch.uint8)


@pytest.mark.parametrize("shape", KEEP_SHAPES)
def test_keep_bytes_are_torch_rand_on_the_card(cuda, shape):
    before = LORA_KEEP.launches
    for seed in KEEP_SEEDS:
        got = keep_bytes(shape, seed, 0.9, cuda)
        assert got.dtype == torch.uint8 and got.shape == shape
        assert torch.equal(got, _torch_keep(shape, seed, 0.9, cuda)), seed
    assert LORA_KEEP.launches - before == len(KEEP_SEEDS)


@pytest.mark.parametrize("keep", [0.5, 0.7, 0.95, 0.999])
def test_keep_bytes_at_other_rates(cuda, keep):
    for seed in KEEP_SEEDS[:4]:
        assert torch.equal(keep_bytes((3, 2048, 512), seed, keep, cuda), _torch_keep((3, 2048, 512), seed, keep, cuda))


def test_keep_bytes_plain_is_the_kernel_on_this_card(cuda):
    props = torch.cuda.get_device_properties(cuda)
    for shape, seed in (((3, 1100, 1001), 5), ((777,), 2**33 + 1), ((2, 300001), 41)):
        want = keep_bytes(shape, seed, 0.9, cuda).cpu()
        got = keep_bytes_plain(shape, seed, 0.9, props.multi_processor_count, props.max_threads_per_multi_processor)
        assert torch.equal(got, want), (shape, seed)


def test_keep_table_is_torch_rand_on_the_card(cuda):
    """The CPU test's table (``tests/keep_table.json``) read again from
    ``torch.rand`` here, where the card is the H100 SXM it was read on."""
    import hashlib
    import json
    from pathlib import Path

    props = torch.cuda.get_device_properties(cuda)
    if (props.multi_processor_count, props.max_threads_per_multi_processor) != (132, 2048):
        pytest.skip("the table holds an H100 SXM's draws")
    table = json.loads((Path(__file__).parent / "keep_table.json").read_text(encoding="utf-8"))
    for case in table["cases"]:
        keep = _torch_keep(tuple(case["shape"]), case["seed"], table["keep"], cuda).reshape(-1).cpu()
        assert int(keep.sum()) == case["kept"]
        assert hashlib.sha256(keep.numpy().tobytes()).hexdigest() == case["sha256"]
        assert [int(keep[i]) for i in case["at"]] == case["bytes"]


def _wide_bf16(m, k, dev, seed):
    """bf16 values over a wide range of exponents."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev)
    return (x * torch.exp2(torch.randint(-30, 30, (m, k), generator=g, device=dev).float())).bfloat16()


def test_32bit_rule_drops_x_as_the_eager_division(cuda):
    """The forward and dA on one-hot operands read the dropped x back
    exactly: it equals ``torch.where(keep, x / bf16(0.9), 0)`` bit for bit."""
    m, k, r = 6144, 4096, 16
    x = _wide_bf16(m, k, cuda, 3)
    keep = keep_bytes((m, k), 11, 0.9, cuda)
    want = torch.where(keep.bool(), x / BF16_KEEP, 0.0)
    j = torch.arange(r, device=cuda)
    for c0 in (0, 2048, k - r):
        a = torch.zeros(k, r, device=cuda, dtype=torch.bfloat16)
        a[c0 + j, j] = 1
        mid = fused_dropout_matmul(x, a, 11, 0.1, bits=keep, dropout_bits=32)
        assert torch.equal(mid, want[:, c0:c0 + r]), c0
    for r0 in (0, 3000, m - r):
        dmid = torch.zeros(m, r, device=cuda, dtype=torch.bfloat16)
        dmid[r0 + j, j] = 1
        _, da = fused_dropout_bwd(x, a, dmid, 11, 0.1, bits=keep, need_dx=False, dropout_bits=32)
        assert torch.equal(da, want[r0:r0 + r].float().T), r0


@pytest.mark.parametrize("m,k", [(6144, 4096), (6144, 14336), (300, 1024), (1, 64)])
def test_32bit_rule_matches_the_eager_route(cuda, m, k):
    """mid, dx and dA against the eager route on the same keep bytes:
    bf16 roundings after f32 sums in another order."""
    x, a, dmid, _ = _lora_inputs(cuda, m, k, 16, seed=m)
    keep = keep_bytes((m, k), 5, 0.9, cuda)
    xe, ae = x.clone().requires_grad_(), a.clone().requires_grad_()
    ze = torch.where(keep.bool(), xe / BF16_KEEP, 0.0) @ ae
    ze.backward(dmid)
    xk, ak = x.clone().requires_grad_(), a.clone().requires_grad_()
    zk = fused_dropout_matmul(xk, ak, 5, 0.1, bits=keep, dropout_bits=32)
    zk.backward(dmid)
    torch.cuda.synchronize()
    assert _rel(zk, ze) <= MID_REL_TOL and _rel(xk.grad, xe.grad) <= DX_REL_TOL
    assert _rel(ak.grad, ae.grad) <= MID_REL_TOL
    assert not xk.grad[keep == 0].any()


def _route_pair(monkeypatch, run):
    """``run()`` through the kernel route, then through the eager route
    (the same masks: torch.rand's), with the keep kernel's launches."""
    from phantom_vlb_tpu_torch.models import lora as lora_mod

    before = LORA_KEEP.launches
    kernel = run()
    launches = LORA_KEEP.launches - before
    with monkeypatch.context() as mp:
        mp.setattr(lora_mod, "takes_keep_bytes", lambda *args: False)
        eager = run()
    assert LORA_KEEP.launches - before == launches
    return kernel, eager, launches


@pytest.mark.parametrize("policy", ["nothing", "attn", "mids", "flash", "dots"])
def test_lora_kernel_route_matches_eager_under_each_policy(cuda, monkeypatch, policy):
    from phantom_vlb_tpu_torch.models.mistral import MistralModel

    layers = 2
    cfg = MistralConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=2, num_key_value_heads=1,
                             head_dim=D, dtype=torch.bfloat16, num_hidden_layers=layers, remat=True,
                             remat_policy=policy, lora=LoRAConfig())
    torch.manual_seed(0)
    model = MistralModel(cfg).to(cuda).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn_like(p, dtype=torch.float32) * (0.05 if "lora" in name else 0.02)
                    + (1.0 if "norm" in name else 0.0))
    g = torch.Generator(device=cuda).manual_seed(1)
    emb = torch.randn(2, 256, 256, generator=g, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(2, 256, dtype=torch.int32, device=cuda)

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(emb, mask, seed=9).float().square().mean()
        loss.backward()
        return loss.detach(), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

    (lk, gk), (le, ge), launches = _route_pair(monkeypatch, run)
    assert launches == 2 * 7 * layers                    # the forward's and the replay's
    assert abs(lk.item() - le.item()) <= 1e-2 * abs(le.item())
    assert gk.keys() == ge.keys() and sum("lora_" in n for n in gk) == 2 * 7 * layers
    worst = max((_rel(grad, ge[n]), n) for n, grad in gk.items())
    assert worst[0] <= ROUTE_REL_TOL, worst


def test_lora_kernel_route_on_a_ranks_rows_and_columns(cuda, monkeypatch):
    """x holding rows [2, 5) of a batch of 8 and columns [256, 512) of a
    width 1024 (a tensor rank's row-parallel input): the route draws the
    whole batch's and width's bytes and keeps its part, as the eager route."""
    from phantom_vlb_tpu_torch.models import lora as lora_mod
    from phantom_vlb_tpu_torch.models.lora import LoRALinear, keep_rows

    lin = LoRALinear(256, 128, LoRAConfig()).to(cuda).train()
    with torch.no_grad():
        lin.weight.normal_(std=0.05)
        lin.lora_b.normal_(std=0.05)
    x0 = torch.randn(3, 64, 256, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda,
                     dtype=torch.bfloat16)
    monkeypatch.setattr(lora_mod, "input_columns", lambda split, x: (256, 1024))

    def run():
        lin.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        y = lin(x, seed=77, rows=(2, 8))
        y.float().square().sum().backward()
        return y.detach(), x.grad, lin.lora_a.grad

    (yk, dxk, dak), (ye, dxe, dae), launches = _route_pair(monkeypatch, run)
    assert launches == 1
    assert _rel(yk, ye) <= MID_REL_TOL and _rel(dxk, dxe) <= DX_REL_TOL and _rel(dak, dae) <= MID_REL_TOL
    want = keep_rows(x0, (2, 8), lambda shape: _torch_keep(shape, 77, 0.9, cuda), (256, 1024))
    assert torch.equal(keep_rows(x0, (2, 8), lambda shape: keep_bytes(shape, 77, 0.9, cuda), (256, 1024)), want)


def test_lora_draw_over_one_launch_takes_the_eager_route(cuda, monkeypatch):
    """A rank's rows of a global batch whose draw PyTorch splits into
    several launches (19 rows of 2048 x 14336 > 2^29 - 1 values) take
    adapter_dropout: no keep launch, the eager route's output."""
    from phantom_vlb_tpu_torch.models.lora import LoRALinear

    lin = LoRALinear(14336, 128, LoRAConfig()).to(cuda).train()
    with torch.no_grad():
        lin.weight.normal_(std=0.01)
        lin.lora_b.normal_(std=0.05)
    x = torch.randn(1, 2048, 14336, generator=torch.Generator(device=cuda).manual_seed(4), device=cuda,
                    dtype=torch.bfloat16)
    got, want, launches = _route_pair(monkeypatch, lambda: lin(x, seed=31, rows=(18, 19)))
    assert launches == 0 and torch.equal(got, want)
    _, _, launches = _route_pair(monkeypatch, lambda: lin(x, seed=31, rows=(17, 18)))
    assert launches == 1


# The one-launch forward and dA (clusters of blocks that fold their partials
# in the launch): M tails (a single row, a partial tile, one row past 48
# tiles), every rank, bits and hash modes, a rank's first row and a first
# column off the 64-column tile; dx rides along.
@pytest.mark.parametrize("m", [1, 100, 6145])
@pytest.mark.parametrize("r", [16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["bits", "hash"])
def test_lora_fwd_and_da_tails_and_ranks_match_plain(cuda, m, r, mode):
    k = 512
    x, a, dmid, bits = _lora_inputs(cuda, m, k, r, seed=m + r)
    bits = bits if mode == "bits" else None
    row0, col0 = (40, 68) if mode == "hash" else (0, 0)
    mid = fused_dropout_matmul(x, a, 7, P, bits=bits, row0=row0, col0=col0)
    dx, da = fused_dropout_bwd(x, a, dmid, 7, P, bits=bits, row0=row0, col0=col0)
    torch.cuda.synchronize()
    assert mid.shape == (m, r) and mid.dtype == torch.bfloat16 and da.shape == (k, r) and da.dtype == torch.float32
    assert _rel(mid, fused_dropout_matmul_plain(x, a, 7, THR, bits, row0, col0)) <= MID_REL_TOL
    dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, 7, THR, bits, row0, col0)
    assert _rel(dx, dx_ref) <= DX_REL_TOL and (dx == 0).equal(dx_ref == 0)
    assert _rel(da, da_ref) <= DA_REL_TOL


# The path's widths: K 4096 and 14336 at batch 3's rows, and a tensor rank's.
@pytest.mark.parametrize("m,k,col0", [(6144, 4096, 0), (6144, 14336, 0), (3072, 4096, 0), (6144, 2048, 2048),
                                      (6144, 7168, 7168)])
def test_lora_fwd_and_da_at_the_path_widths_repeat_bit_for_bit(cuda, m, k, col0):
    x, a, dmid, _ = _lora_inputs(cuda, m, k, 16)
    first = (fused_dropout_matmul(x, a, 5, P, row0=77, col0=col0),
             fused_dropout_bwd(x, a, dmid, 5, P, need_dx=False, row0=77, col0=col0)[1])
    second = (fused_dropout_matmul(x, a, 5, P, row0=77, col0=col0),
              fused_dropout_bwd(x, a, dmid, 5, P, need_dx=False, row0=77, col0=col0)[1])
    torch.cuda.synchronize()
    assert all(torch.equal(f, g) for f, g in zip(first, second))
    assert _rel(first[0], fused_dropout_matmul_plain(x, a, 5, THR, row0=77, col0=col0)) <= MID_REL_TOL
    assert _rel(first[1], fused_dropout_bwd_plain(x, a, dmid, 5, THR, row0=77, col0=col0)[1]) <= DA_REL_TOL


def test_lora_fwd_and_da_calls_are_one_kernel(cuda):
    from torch.profiler import ProfilerActivity, profile

    x, a, dmid, _ = _lora_inputs(cuda, 6144, 4096, 16)
    for fn, name in ((lambda: fused_dropout_matmul(x, a, 3, P), "lora_fwd_kernel"),
                     (lambda: fused_dropout_bwd(x, a, dmid, 3, P, need_dx=False), "lora_da_kernel")):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0], kernels


def test_lora_fwd_and_da_with_unaligned_bases_match_plain(cuda):
    """Bases off 16 bytes (no TMA): the producer warp's plain loads."""
    m, k, r = 300, 1024, 16
    x0, a0, d0, bits0 = _lora_inputs(cuda, m, k, r, seed=3)
    x = torch.empty(m * k + 3, dtype=torch.bfloat16, device=cuda)[3:].view(m, k)
    a = torch.empty(k * r + 1, dtype=torch.bfloat16, device=cuda)[1:].view(k, r)
    dmid = torch.empty(m * r + 5, dtype=torch.bfloat16, device=cuda)[5:].view(m, r)
    bits = torch.empty(m * k + 7, dtype=torch.uint8, device=cuda)[7:].view(m, k)
    for dst, src in ((x, x0), (a, a0), (dmid, d0), (bits, bits0)):
        dst.copy_(src)
    for b in (bits, None):
        mid = fused_dropout_matmul(x, a, 9, P, bits=b, row0=3)
        _, da = fused_dropout_bwd(x, a, dmid, 9, P, bits=b, need_dx=False, row0=3)
        torch.cuda.synchronize()
        assert _rel(mid, fused_dropout_matmul_plain(x0, a0, 9, THR, None if b is None else bits0, 3)) <= MID_REL_TOL
        assert _rel(da, fused_dropout_bwd_plain(x0, a0, d0, 9, THR, None if b is None else bits0, 3)[1]) <= DA_REL_TOL


def test_lora_cluster_capacity_is_the_plans_default(cuda):
    """The clusters of each size the card holds at once, for both kernels
    at two ranks: the CPU tests' table where the card is the H100 SXM it
    was read on, and enough for every plan at the path's widths."""
    from phantom_vlb_tpu_torch.ops import lora_fused as lf

    caps = {(r, da): lf._cluster_capacity(cuda, r, da) for r in (16, 128) for da in (False, True)}
    if "H100" in torch.cuda.get_device_name(cuda) and torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert set(caps.values()) == {lf.H100_CLUSTERS}, caps
    for m, k in ((6144, 4096), (6144, 14336), (3072, 4096), (6144, 2048), (6144, 7168)):
        for da, plan in ((False, lf._fwd_plan(m, k, 16, caps=caps[16, False])),
                         (True, lf._da_plan(m, k, 16, caps=caps[16, True]))):
            assert plan[1] <= caps[16, da][lf.CLUSTER_SIZES.index(plan[0])]


def test_lora_fwd_and_da_raise_on_what_they_do_not_take(cuda):
    x, a, dmid, bits = _lora_inputs(cuda, 128, 256, 16)
    with pytest.raises(ValueError):
        fused_dropout_bwd(x, a, dmid[:64], 0, P, need_dx=False)                  # dmid rows
    with pytest.raises(ValueError):
        fused_dropout_bwd(x.t().contiguous().t(), a, dmid, 0, P, need_dx=False)  # strided x
    with pytest.raises(ValueError):
        fused_dropout_matmul(x, a.t().contiguous().t(), 0, P)                    # strided A
    with pytest.raises(ValueError):
        fused_dropout_bwd(x, a, dmid, 0, P, bits=bits.cpu(), need_dx=False)      # bits on the CPU


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


@pytest.mark.parametrize("rows,n", [(64, 2048), (24, 7168), (13, 1000), (5, 7)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_row_quant_kernels_match_plain_bit_for_bit(cuda, rows, n, dtype):
    """The kernel's passes alone (one tensor rank's columns of a row): the
    maxima and the codes from a given scale equal the plain versions', and
    two halves with the maximum of their maxima give the whole row's
    codes and scale."""
    g = torch.Generator(device=cuda).manual_seed(rows * n)
    x = (3 * torch.randn(rows, 2 * n, generator=g, device=cuda)).to(dtype)
    x[rows // 2] = 0
    w = torch.rand(2 * n, generator=g, device=cuda) * 2 + 0.01
    counts = (ROW_ABSMAX.launches, ROW_QUANT_GIVEN.launches)
    for ws in (None, w):
        q, s = row_quant_plain(x, ws)
        halves = [(x[:, :n].contiguous(), None if ws is None else ws[:n].contiguous()),
                  (x[:, n:].contiguous(), None if ws is None else ws[n:].contiguous())]
        maxima = [row_absmax(h, hw) for h, hw in halves]
        for (h, hw), m in zip(halves, maxima):
            torch.cuda.synchronize()
            assert torch.equal(m, row_absmax_plain(h, hw))
            assert torch.equal(row_quant_given(h, s, hw), row_quant_given_plain(h, s, hw))
        for i, (h, hw) in enumerate(halves):
            qh, sh = row_quant_split(h, lambda m: torch.maximum(*maxima), hw)
            torch.cuda.synchronize()
            assert torch.equal(sh, s) and torch.equal(qh, q[:, i * n:(i + 1) * n])
    assert (ROW_ABSMAX.launches, ROW_QUANT_GIVEN.launches) == (counts[0] + 8, counts[1] + 8)


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


# Model widths, M and N tails, odd N (the plain-load path: N % 8 != 0 or
# r not a padded rank), ranks 1 to 128, the two extreme grids (one row
# chunk; one column chunk), and a grid of more blocks than the card holds
# at once (r 128 at N 9000: 141 column groups; the last-block fold).
EPI_SHAPES = [(256, 1024, 16), (6144, 4096, 16), (100, 300, 4), (70, 1000, 37), (64, 256, 128),
              (33, 9, 16), (64, 14336, 16), (6144, 64, 16), (256, 1024, 1), (512, 2048, 128),
              (128, 9000, 128),
              # One tensor rank's column-parallel widths at mesh.tensor=2: q, k/v, gate/up.
              (6144, 2048, 16), (6144, 512, 16), (6144, 7168, 16)]


@pytest.mark.parametrize("m,n,r", EPI_SHAPES)
def test_epilogue_kernels_match_plain(cuda, m, n, r):
    """Forward, the fused dz + dB, and dz and dB alone against plain."""
    y, z, b, dy = _epi_inputs(cuda, m, n, r)
    dz_f, db_f = lora_epilogue_dzdb(z, dy, b, 2.0)
    got = (lora_epilogue_fwd(y, z, b, 2.0), lora_epilogue_dz(dy, b, 2.0), lora_epilogue_db(z, dy, 2.0),
           dz_f, db_f)
    torch.cuda.synchronize()
    dz_p, db_p = lora_epilogue_dz_plain(dy, b, 2.0), lora_epilogue_db_plain(z, dy, 2.0)
    want = (lora_epilogue_plain(y, z, b, 2.0), dz_p, db_p, dz_p, db_p)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and gt.dtype == torch.bfloat16 and torch.isfinite(gt).all()
        assert _rel(gt, wt) <= EPI_REL_TOL


# The forward alone where a block walks more than one row tile of its strip
# and around its rings: N = 1024 at M = 6144 (3 row chunks a block, 12
# tiles through 8 slots), the plain loads at r 37 (10 tiles), and r 128 (8
# row chunks through 4 z slots).
@pytest.mark.parametrize("m,n,r", [(6144, 1024, 16), (4096, 1000, 37), (16384, 256, 128)])
def test_epilogue_forward_walks_its_strip(cuda, m, n, r):
    y, z, b, _ = _epi_inputs(cuda, m, n, r, seed=4)
    got = lora_epilogue_fwd(y, z, b, 2.0)
    torch.cuda.synchronize()
    assert got.shape == y.shape and torch.isfinite(got).all()
    assert _rel(got, lora_epilogue_plain(y, z, b, 2.0)) <= EPI_REL_TOL


def test_epilogue_forward_with_an_unaligned_y(cuda):
    """y a contiguous view at an odd element offset (not 16-byte aligned):
    the kernel's plain loads, and its TMA store into the new, aligned out."""
    y0, z, b, _ = _epi_inputs(cuda, 300, 1024, 16, seed=5)
    y = torch.empty(y0.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(y0.shape)
    y.copy_(y0)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    got = lora_epilogue_fwd(y, z, b, 2.0)
    torch.cuda.synchronize()
    assert got.data_ptr() % 16 == 0 and torch.isfinite(got).all()
    assert _rel(got, lora_epilogue_plain(y0, z, b, 2.0)) <= EPI_REL_TOL


@pytest.mark.parametrize("m,n,r", [(6144, 4096, 16), (6144, 1024, 16), (100, 300, 4), (16384, 256, 128)])
def test_epilogue_forward_repeats_and_leaves_y(cuda, m, n, r):
    """Two calls of the forward give the same bits, and y is left as it was
    (the kernel writes its result over y's tile in shared memory only)."""
    y, z, b, _ = _epi_inputs(cuda, m, n, r, seed=6)
    y0 = y.clone()
    first, second = lora_epilogue_fwd(y, z, b, 2.0), lora_epilogue_fwd(y, z, b, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(y, y0)


@pytest.mark.parametrize("m,n,r", [(6144, 4096, 16), (100, 300, 4), (6144, 64, 16), (512, 2048, 128),
                                   (128, 9000, 128)])
def test_epilogue_backward_repeats_bit_for_bit(cuda, m, n, r):
    """Two calls of each backward entry point give the same bits (fixed
    summation order; the group counters are back at zero after a launch),
    and the fused call's outputs agree with the single entry points'."""
    _, z, b, dy = _epi_inputs(cuda, m, n, r, seed=3)
    first = (*lora_epilogue_dzdb(z, dy, b, 2.0), lora_epilogue_dz(dy, b, 2.0), lora_epilogue_db(z, dy, 2.0))
    second = (*lora_epilogue_dzdb(z, dy, b, 2.0), lora_epilogue_dz(dy, b, 2.0), lora_epilogue_db(z, dy, 2.0))
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    # Same tiles and sums; the grids may differ, so the partials' order may too.
    assert _rel(first[0], first[2]) <= EPI_REL_TOL and _rel(first[1], first[3]) <= EPI_REL_TOL


@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_epilogue_autograd_and_launch_counts(cuda, backward):
    """backward='pallas' launches the fused backward once (dz and dB from one
    pass over dy) and neither single entry point; 'xla' none of them."""
    y, z, b, dy = _epi_inputs(cuda, 512, 768, 16)
    y, z, b = (t.requires_grad_() for t in (y, z, b))
    kernels = (EPI_FWD, EPI_DZ, EPI_DB, EPI_DZDB)
    counts = [k.launches for k in kernels]
    out = lora_epilogue(y.view(2, 256, 768), z.view(2, 256, 16), b, 2.0, backward=backward)
    out.backward(dy.view(2, 256, 768))
    fused = 1 if backward == "pallas" else 0
    assert [k.launches for k in kernels] == [counts[0] + 1, counts[1], counts[2], counts[3] + fused]
    assert torch.equal(y.grad, dy)
    assert _rel(z.grad, lora_epilogue_dz_plain(dy, b.detach(), 2.0)) <= EPI_REL_TOL
    assert _rel(b.grad, lora_epilogue_db_plain(z.detach(), dy, 2.0)) <= EPI_REL_TOL


def test_epilogue_raises_on_what_it_does_not_take(cuda):
    y, z, b, dy = _epi_inputs(cuda, 64, 256, 16)
    with pytest.raises(ValueError):
        lora_epilogue_fwd(y.float(), z.float(), b.float(), 2.0)                 # f32
    with pytest.raises(ValueError):
        lora_epilogue_fwd(y[:, ::2], z, b[:, ::2], 2.0)                          # strided
    with pytest.raises(ValueError):
        lora_epilogue_dzdb(z.float(), dy.float(), b.float(), 2.0)                # f32
    with pytest.raises(ValueError):
        lora_epilogue_dzdb(z, dy[:, ::2], b[:, ::2], 2.0)                        # strided
    with pytest.raises(ValueError):
        lora_epilogue_dzdb(z[:32], dy, b, 2.0)                                   # z rows
    big_z = torch.zeros(64, 129, device=cuda, dtype=torch.bfloat16)
    big_b = torch.zeros(129, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_fwd(y, big_z, big_b, 2.0)                                  # r > 128
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_dz(dy, big_b, 2.0)
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_db(big_z, dy, 2.0)
    with pytest.raises(ValueError, match="rank"):
        lora_epilogue_dzdb(big_z, dy, big_b, 2.0)


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


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_pass_sends_only_what_is_read(cuda, n):
    """A pass makes n(n-1)/2 chunk sends (chunk i travels while a later rank
    reads it), as the C launcher counts what it enqueued, and its result is
    still the plain version's."""
    q, k, v, mask = _inputs(cuda, 2, 256 * n, 8, 2, [256 * n, 200], seed=10 + n)
    ring = SequenceRing([cuda] * n)
    before = RING_STATS.sends
    out, lse = ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask)
    ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask)
    torch.cuda.synchronize()
    assert RING_STATS.sends == before + n * (n - 1)
    out_ref, lse_ref = ring_fwd_plain(q, k, v, 8, 2, ring, kv_mask=mask)
    assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_ring_fwd_under_inference_mode(cuda):
    """Serving runs under ``torch.inference_mode``, whose tensors keep no
    version counter: a pass on such inputs and mask is still the plain
    version's."""
    ring = SequenceRing([cuda] * 4)
    with torch.inference_mode():
        q, k, v, mask = _inputs(cuda, 2, 1024, 8, 2, [1024, 600], seed=5)
        out, lse = ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask)
        out_ref, lse_ref = ring_fwd_plain(q, k, v, 8, 2, ring, kv_mask=mask)
    assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_ring_passes_reuse_their_slots(cuda):
    """Passes back to back on one 4-rank ring with changing inputs (the
    landing slots persist, so each pass's sends wait for the previous
    pass's readers), a change of shape (new slots) and back: each result is
    its own inputs'. Inputs are made before the passes, so nothing but the
    ring's own ordering keeps a slot's next send after its last read."""
    ring = SequenceRing([cuda] * 4)
    cases = [(2, 1024, [1024, 700], seed) for seed in range(4)] + [(3, 512, [500, 512, 64], 7),
                                                                  (2, 1024, None, 8), (2, 1024, [900, 1024], 9)]
    inputs = [_inputs(cuda, b, s, 8, 2, valid, seed=seed) for b, s, valid, seed in cases]
    outs = [ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask) for q, k, v, mask in inputs]
    torch.cuda.synchronize()
    # Last, the last mask tensor changed in place: the pass reads it as it is now.
    q, k, v, mask = inputs[-1]
    mask[1, 300:] = 0
    inputs.append((q, k, v, mask))
    outs.append(ring_fwd(q, k, v, 8, 2, ring, kv_mask=mask))
    for i, ((q, k, v, mask), (out, lse)) in enumerate(zip(inputs, outs)):
        if i == len(cases) - 1:
            continue                     # its mask has changed since
        out_ref, lse_ref = ring_fwd_plain(q, k, v, 8, 2, ring, kv_mask=mask)
        assert (out.float() - out_ref.float()).abs().max().item() <= OUT_TOL
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL


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


# The vision path: narrow towers at the serving geometry (336 px, 12 frames
# -> 1183 tokens: 2 CLIP layers 256 wide, an STC of depth 1, 256 -> 512 ->
# 256) before a 2-layer decoder 256 wide (head dim 128, as the kernels take).
# bf16 on the card against the same weights in f32 on the CPU, the video
# tokens as max|err| / max|ref|: bf16 activations (2^-8 relative each)
# through the patch conv, 2 layers and a block of four convolutions, each
# after a LayerNorm rounded to bf16.
TOWER_TOKENS_TOL = 5e-2
TOWER_ROWS = 3 * 12 * 577          # the tower's projection rows at batch 3


def _narrow_vision_config(dtype):
    return VLBConfig.full(
        mistral=MistralConfig.tiny(vocab_size=32000, hidden_size=256, intermediate_size=512,
                                   num_attention_heads=2, num_key_value_heads=1, head_dim=D, dtype=dtype),
        clip=CLIPVisionConfig(hidden_size=256, intermediate_size=1024, num_attention_heads=4,
                              num_hidden_layers=3, dtype=dtype),
        stc=STCConfig(encoder_hidden_size=256, hidden_size=512, output_hidden_size=256, depth=1, dtype=dtype))


def _narrow_vision_model(dev):
    cfg = _narrow_vision_config(torch.bfloat16)
    sd = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    return VideoLLaMA2VLB.from_state_dict(cfg, sd), sd


def test_tower_bf16_matches_f32_plain_at_narrow_width(cuda):
    model, sd = _narrow_vision_model(cuda)
    cpu = VideoLLaMA2VLB.from_state_dict(_narrow_vision_config(torch.float32), sd, device="cpu")
    frames = torch.randn(1, 12, 3, 336, 336, generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    got = model.encode_video(frames)
    want = cpu.encode_video(frames.cpu())
    assert got.shape == want.shape == (1, 1183, 256) and got.dtype == torch.bfloat16
    assert _rel(got.cpu(), want) <= TOWER_TOKENS_TOL


@pytest.mark.parametrize("n", [1024, 4096])
def test_row_quant_at_the_tower_shapes(cuda, n):
    """(20772, n) bf16: rows not a multiple of 8; q and s bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (3 * torch.randn(TOWER_ROWS, n, generator=g, device=cuda)).to(torch.bfloat16)
    got, want = row_quant(x), row_quant_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_frames_path_equals_the_token_path_on_the_card(cuda):
    """Served from frames, and fed the tokens ``encode_video`` gives for the
    same frames: the same kernels on the same inputs, bit for bit."""
    model, _ = _narrow_vision_model(cuda)
    batches = synthetic_batches(model.cfg, 1, 2, np.random.default_rng(0),
                                torch.Generator(device=cuda).manual_seed(2), cuda, frames=True)
    before = FLASH_FWD.launches
    from_frames = predict_batches(model, batches, cuda)["predicted"]
    assert FLASH_FWD.launches == before + 2                      # the decoder's two layers
    tokens = model.encode_video(batches[0]["vision"])
    from_tokens = predict_batches(model, [dict(batches[0], vision=tokens)], cuda)["predicted"]
    assert np.isfinite(from_frames).all() and np.array_equal(from_frames, from_tokens)


def _narrow_lora_model(dev):
    mistral = dataclasses.replace(_narrow_vision_config(torch.bfloat16).mistral, lora=LoRAConfig(), remat=True)
    cfg = dataclasses.replace(_narrow_vision_config(torch.bfloat16), mistral=mistral, freeze_backbone=False)
    sd = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    return VideoLLaMA2VLB.from_state_dict(cfg, sd)


def test_trainer_fits_saves_and_resumes_on_the_card(cuda, tmp_path):
    """A narrow LoRA model from cached tokens: 1 epoch of 2 steps with one
    validation, best and last saved; a fresh trainer resumed from last
    holds the same tensors and AdamW state bit for bit, and its fit over 2
    epochs runs the second alone."""
    model = _narrow_lora_model(cuda)
    batches = synthetic_batches(model.cfg, 3, 2, np.random.default_rng(0),
                                torch.Generator(device=cuda).manual_seed(3), cuda)

    def trainer(epochs):
        loop = TrainLoopConfig(max_epochs=epochs, val_check_interval=0.0, log_every_n_steps=1,
                               output_dir=str(tmp_path), run_name="gpu", num_target=model.cfg.num_target)
        return VLBTrainer(model if epochs == 1 else _narrow_lora_model(cuda), OptimConfig(), loop, device=cuda)

    first = trainer(1)
    before = FLASH_FWD.launches
    first.fit(batches[:2], batches[2:])
    assert FLASH_FWD.launches - before == 2 * (2 * 2) + 2        # 2 steps under remat, 1 val batch
    assert first.global_step == 2 and (tmp_path / "last" / "state.pt").exists()
    assert [p.name for p in tmp_path.glob("best_brainloss_*")] == ["best_brainloss_0-2"]
    resumed = trainer(2)
    assert resumed.maybe_resume() and resumed.global_step == 2
    for name, p in first.trainable.items():
        assert torch.equal(resumed.trainable[name], p), name
    a, b = first.optimizer.state_dict()["adamw"]["state"], resumed.optimizer.state_dict()["adamw"]["state"]
    assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])
    resumed.fit(batches[:2], batches[2:])
    assert resumed.global_step == 4 and np.isfinite(resumed.last_val_metrics["val/brain_loss"])


def _first_step(model, batch, tmp_path, mesh=None) -> dict:
    """A fresh trainer's first step on ``batch``: its loss, and its adapter
    gradients (whole, after the clip) on the CPU."""
    loop = TrainLoopConfig(max_epochs=1, checkpoint=False, output_dir=str(tmp_path), run_name="step",
                           num_target=model.cfg.num_target)
    trainer = VLBTrainer(model, OptimConfig(), loop, device=next(model.parameters()).device, mesh=mesh)
    out = trainer.train_one(batch)
    grads = {k: whole(p.grad).float().cpu() for k, p in trainer.trainable.items() if "lora_" in k}
    return {"loss": float(out["brain_loss"]), "grads": grads}


def test_world_one_nccl_step_is_the_unsharded_step(cuda, tmp_path, monkeypatch):
    """A narrow LoRA model (32-bit adapter dropout 0.1, remat) sharded by
    FSDP2 over an NCCL group of one process: its first loss bit-equal to
    the unsharded trainer's on the same weights, batch and seed; its
    adapter gradients within the flash backward's tolerance of each other
    (dq's reduce-adds sum in a run-dependent order)."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    assert maybe_initialize_distributed("cuda", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = build_mesh(MeshConfig(), "cuda")
        assert mesh.sharded and mesh.n_devices == 1
        model = _narrow_lora_model(cuda)
        batch = {k: torch.as_tensor(v).to(cuda) for k, v in synthetic_batches(
            model.cfg, 1, 2, np.random.default_rng(0), torch.Generator(device=cuda).manual_seed(3), cuda)[0].items()}
        plain = _first_step(model, batch, tmp_path / "plain")
        sharded = _first_step(_narrow_lora_model(cuda), batch, tmp_path / "sharded", mesh)
    finally:
        shutdown_distributed()
    assert sharded["loss"] == plain["loss"]
    assert sharded["grads"].keys() == plain["grads"].keys()
    for k, g in plain["grads"].items():
        assert _rel(sharded["grads"][k], g) <= BWD_REL_TOL, k


def test_two_cards_step_is_the_one_card_step(cuda, tmp_path, monkeypatch):
    """2 NCCL ranks (one card each, ``tests/torch_ranks.py``, opted in to a
    group over more than one card) at a global batch of 4 against one card
    at 4: the first loss within 1e-3 relative (each card's bf16 activations
    over its 2 rows) and the adapter gradients within the flash backward's
    tolerance."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: 2 NCCL ranks wait for a machine that has them")
    from torch_ranks import run_ranks

    monkeypatch.setenv(MULTI_CARD_OPT_IN, "1")
    cfg = _narrow_lora_model(cuda).cfg
    sd = {k: v.cpu() for k, v in init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0)).items()}
    batch = {k: torch.as_tensor(v).cpu() for k, v in synthetic_batches(
        cfg, 1, 4, np.random.default_rng(0), torch.Generator(device=cuda).manual_seed(3), cuda)[0].items()}
    ranks = run_ranks("steps", 2, tmp_path / "ranks", device="cuda", scenarios=[
        {"name": "narrow", "cfg": cfg, "sd": sd, "batches": [batch], "seeds": [5]}])
    model = VideoLLaMA2VLB.from_state_dict(cfg, sd, device=cuda)
    one = _first_step(model, {k: v.to(cuda) for k, v in batch.items()}, tmp_path / "one")
    for res in (r["narrow"] for r in ranks):
        assert abs(res["loss"][0] - one["loss"]) <= 1e-3 * abs(one["loss"])
        for k, g in one["grads"].items():
            assert _rel(res["grads"][k].float(), g) <= BWD_REL_TOL, k


def test_safetensors_reader_on_a_bf16_file(cuda, tmp_path):
    """A bf16 (and an int8) tensor written in the safetensors layout, read
    straight to the card bit for bit."""
    from chip_smoke import write_safetensors

    g = torch.Generator(device=cuda).manual_seed(4)
    tensors = {"w": torch.randn(1000, 257, generator=g, device=cuda).to(torch.bfloat16),
               "q": torch.randint(-127, 128, (33,), generator=g, device=cuda, dtype=torch.int8)}
    write_safetensors(tmp_path / "m.safetensors", tensors)
    sd = SafetensorsDir(tmp_path, cuda)
    for key, t in tensors.items():
        got = sd[key]
        assert got.device == t.device and got.dtype == t.dtype and torch.equal(got, t), key
    sd.close()


def test_support_gather_on_the_card_matches_the_cpu(cuda):
    """The feature cache's gather at the production geometry (bf16 hidden
    states of a served batch of 5): the same values on the card and on the
    CPU, bit for bit."""
    from phantom_vlb_tpu_torch.core.geometry import REFERENCE_GEOMETRY as G
    from phantom_vlb_tpu_torch.train.precompute import support_gather

    batch = synthetic_batches(VLBConfig.full(), 1, 5, np.random.default_rng(0),
                              torch.Generator(device=cuda).manual_seed(5), cuda)[0]
    hidden = torch.randn(5, G.feature_len, 4096, generator=torch.Generator(device=cuda).manual_seed(6),
                         device=cuda, dtype=torch.bfloat16)
    args = [torch.as_tensor(batch[k]) for k in ("padvals", "vis_weights", "lang_weights")]
    got = support_gather(hidden, *(a.to(cuda) for a in args), G)
    want = support_gather(hidden.cpu(), *args, G)
    assert got[0].shape == (5, G.num_vis_tokens + G.onsets_width, 4096)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_narrow_cached_head_matches_the_full_forward(cuda):
    """A narrow frozen model from frames: the feature cache (an in-memory
    store) built with 2 flash forwards a batch, the head over it against
    the full forward within the bound of tests/test_precompute.py:110."""
    from phantom_vlb_tpu_torch.data.schemas import MemoryStore
    from phantom_vlb_tpu_torch.train.precompute import CachedFeatureLoader, build_feature_cache, head_forward

    model, _ = _narrow_vision_model(cuda)
    batches = synthetic_batches(model.cfg, 2, 2, np.random.default_rng(0),
                                torch.Generator(device=cuda).manual_seed(7), cuda, frames=True)
    store = MemoryStore()
    before = FLASH_FWD.launches
    assert build_feature_cache(model, batches, store) == 4
    assert FLASH_FWD.launches == before + 2 * 2
    k = model.cfg.geometry.num_vis_tokens + model.cfg.geometry.onsets_width
    assert store["3"]["3_features"].shape == (k, 256) and store["3"]["3_features"].dtype == np.float16
    full = predict_batches(model, batches, cuda)["predicted"]
    before = FLASH_FWD.launches
    cached = []
    for cb in CachedFeatureLoader(store, 2, shuffle=False):
        with torch.no_grad():
            pred, _ = head_forward(torch.nn.ModuleDict({"head": model.head}),
                                   {key: torch.as_tensor(v).to(cuda) for key, v in cb.items()})
        cached.append(pred.cpu().numpy())
    assert FLASH_FWD.launches == before
    np.testing.assert_allclose(np.concatenate(cached), full, atol=2e-2, rtol=2e-2)


def test_extraction_with_the_card_preprocessor(cuda):
    """An episode through extract_episode with the card's preprocessor
    against the same preprocessor on the CPU: the text rows equal, the
    frames within the CPU tests' 1e-4 of each other."""
    from phantom_vlb_tpu_torch.data.extract import extract_episode
    from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY
    from phantom_vlb_tpu_torch.data.text import SentencePieceTestTokenizer
    from phantom_vlb_tpu_torch.data.video import ArrayVideoSource
    from phantom_vlb_tpu_torch.ops.preprocess import DevicePreprocessor

    geom = dataclasses.replace(TEST_GEOMETRY, model_max_length=256)
    frames = np.random.default_rng(0).integers(0, 256, (int(6 * geom.tr * 30) + 9, 48, 80, 3), np.uint8)
    transcript = {"text_per_tr": ["hey Ross ", float("nan")] * 3, "words_per_tr": ["['hey', 'Ross']", ""] * 3,
                  "onsets_per_tr": ["[0.5, 1.0]", ""] * 3}
    seg = {"scene": [1, 2], "onset": [0.0, 4.0]}
    eps = [extract_episode(transcript, seg, ArrayVideoSource(frames, 30.0), geom, SentencePieceTestTokenizer(),
                           preprocess_batch=DevicePreprocessor(geom.image_size, device=dev))
           for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(eps[0].transcript_features, eps[1].transcript_features)
    assert eps[0].video_features.shape == (6, geom.num_frames, 3, geom.image_size, geom.image_size)
    np.testing.assert_allclose(eps[0].video_features, eps[1].video_features, atol=1e-4, rtol=0)


# The span recorder's clock against the device records' (PERF.md §6): a
# span's start or end may fall this far on the wrong side of the kernel it
# brackets (the measured offset, with room), and the kernel starts and the
# synchronize returns within the slack of the span's edges.
SPAN_CLOCK_NS, SPAN_SLACK_NS = 50_000, 2_000_000


def test_span_brackets_the_device_record_under_a_cuda_only_profile(cuda):
    """A span around a ~1 ms spin kernel and the synchronize after it,
    under the device-only profile the benchmark's traced pass uses: the
    recorder is on, and its start and end bracket the kernel's record."""
    from torch.profiler import ProfilerActivity, profile

    from phantom_vlb_tpu_torch.utils.profiling import SPANS, span

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    SPANS.records.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            with span("spin"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
    records = sorted((r for r in SPANS.records if r.name == "spin"), key=lambda r: r.start_ns)
    SPANS.records.clear()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA" and "spin" in e.name().lower())
    assert len(records) == len(kernels) == 10
    for r, (k0, k1) in zip(records, kernels):
        assert -SPAN_CLOCK_NS <= k0 - r.start_ns <= SPAN_SLACK_NS, (r, k0, k1)
        assert -SPAN_CLOCK_NS <= r.end_ns - k1 <= SPAN_SLACK_NS, (r, k0, k1)
