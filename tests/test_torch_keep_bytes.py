"""The 32-bit adapter dropout's keep bytes and the fused kernels' 32-bit rule,
on the CPU (their plain versions).

The keep bytes are ``torch.rand(shape, generator=torch.Generator("cuda")
.manual_seed(seed)) < keep`` on the card. The plain draw
(``keep_bytes_plain``, int64 torch ops) is held to a table read on an
NVIDIA H100 80GB HBM3 from ``torch.rand`` itself (``tests/keep_table.json``:
per seed and shape the kept count, the sha256 of every byte and the bytes
at the grid's edges; ``python3 chip_smoke.py --keep-table PATH`` reads it, and
the card's test ``test_keep_table_is_torch_rand_on_the_card`` reads it
again), to Random123's published Philox4x32-10 vectors, and to a transcription of
PyTorch's grid-stride draw in Python integers. The 32-bit rule's scale makes
the dropped x bit-equal to the eager route's ``x / bf16(keep)`` for every
bf16 value; its plain forward and backward meet the eager route at the
tolerances of ``tests/test_torch_lora_fused.py``. The route in
``LoRALinear`` (taken on the CPU here by patching its test) gives the eager
route's output on the same bytes, and each route counts its site calls
while a profiler runs.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from phantom_vlb_tpu_torch.models import lora as lora_mod
from phantom_vlb_tpu_torch.models.lora import LoRAConfig, LoRALinear
from phantom_vlb_tpu_torch.ops import lora_fused as lf
from phantom_vlb_tpu_torch.ops.lora_fused import (
    dropout_rule,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    keep_bytes,
    keep_bytes_plain,
    philox4x32_10,
)
from phantom_vlb_tpu_torch.utils import profiling

TABLE = json.loads((Path(__file__).parent / "keep_table.json").read_text(encoding="utf-8"))
BF16_ULP = 2.0 ** -8
U32 = 0xFFFFFFFF


def _py_philox(ctr, key):
    """Philox4x32-10 in Python integers (Random123's definition)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & U32, (p0 >> 32) ^ c3 ^ k1, p0 & U32
        k0, k1 = (k0 + 0x9E3779B9) & U32, (k1 + 0xBB67AE85) & U32
    return c0, c1, c2, c3


# Random123's known-answer vectors for philox4x32-10 (kat_vectors):
# counter, key, output.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((U32, U32, U32, U32), (U32, U32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_matches_random123s_vectors(ctr, key, want):
    assert tuple(int(w) for w in philox4x32_10(ctr, key)) == want
    assert _py_philox(ctr, key) == want


def test_philox_on_tensors_is_the_integer_definition():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (5, 64), dtype=np.uint64).astype(np.int64)
    got = philox4x32_10(tuple(torch.from_numpy(w) for w in words[:4]), (int(words[4, 0]), int(words[4, 1])))
    for i in range(64):
        want = _py_philox(tuple(int(w) for w in words[:4, i]), (int(words[4, 0]), int(words[4, 1])))
        assert tuple(int(g[i]) for g in got) == want


def _torch_draw_in_python(numel, seed, keep, blocks):
    """PyTorch's grid-stride uniform draw (DistributionTemplates.h) and the
    compare, element by element in Python: thread t's curand state (subsequence t,
    offset 0), its i-th uniform4 to elements t + 4 T i + T j."""
    t_all = blocks * 256
    out = [None] * numel
    keep32 = np.float32(keep)
    for t in range(t_all):
        i = 0
        while t + 4 * t_all * i < numel:
            words = _py_philox((i, 0, t & U32, t >> 32), (seed & U32, (seed >> 32) & U32))
            for j, w in enumerate(words):
                e = t + 4 * t_all * i + t_all * j
                if e < numel:
                    u = np.float32(np.float32(w) * np.float32(2.0 ** -32)) + np.float32(2.0 ** -33)
                    u = np.float32(0.0) if u == np.float32(1.0) else u
                    out[e] = int(u < keep32)
            i += 1
    return out


@pytest.mark.parametrize("numel,sms,threads", [(1500, 1, 256), (2049, 2, 512), (700, 4, 2048), (5, 1, 256)])
def test_plain_draw_is_torchs_grid_stride_walk(numel, sms, threads):
    for seed in (3, 2**32 + 5):
        got = keep_bytes_plain((numel,), seed, 0.9, sms, threads)
        blocks = lf._rand_blocks(numel, sms, threads)
        assert got.tolist() == _torch_draw_in_python(numel, seed, 0.9, blocks)


def test_rand_blocks_follow_the_card():
    assert lf._rand_blocks(1000, 132, 2048) == 4
    assert lf._rand_blocks(270336, 132, 2048) == 1056
    assert lf._rand_blocks(6144 * 4096, 132, 2048) == 1056
    assert lf._rand_blocks(6144 * 4096, 114, 2048) == 912
    assert lf._rand_blocks(6144 * 4096, 132, 1536) == 792


@pytest.mark.parametrize("case", TABLE["cases"], ids=lambda c: f"{c['seed']}-{'x'.join(map(str, c['shape']))}")
def test_plain_draw_is_torch_rand_on_an_h100(case):
    got = keep_bytes_plain(tuple(case["shape"]), case["seed"], TABLE["keep"]).reshape(-1)
    assert got.dtype == torch.uint8 and int(got.sum()) == case["kept"]
    assert [int(got[i]) for i in case["at"]] == case["bytes"]
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == case["sha256"]


@pytest.mark.parametrize("keep", [0.9, 0.5, 0.95, 0.999, 0.1])
def test_the_kernels_word_compare_is_the_float_rule(keep):
    """The kernel keeps a word's element iff w < lo or w >= hi: the
    uniform, the fold of 1 and the f32 compare, at and around both edges
    and at random words."""
    lo, hi = lf._keep_words(keep)
    rng = np.random.default_rng(int(keep * 1000))
    words = np.concatenate([np.arange(lo - 300, lo + 300), np.arange(hi - 300, 2**32),
                            rng.integers(0, 2**32, 20000), [0, 1]]).astype(np.int64)
    words = torch.from_numpy(words[(words >= 0) & (words < 2**32)])
    u = words.to(torch.float32) * 2.0 ** -32 + 2.0 ** -33
    want = torch.where(u == 1.0, 0.0, u) < float(np.float32(keep))
    assert torch.equal((words < lo) | (words >= hi), want)
    assert hi == 2**32 - 128                                  # from here u rounds to 1


def test_table_covers_the_draws_edges():
    t = 132 * 2048
    numels = {int(np.prod(c["shape"])) for c in TABLE["cases"]}
    assert min(numels) < t and any(t < n < 4 * t for n in numels)        # one grid; words 1-3
    assert any(n > 8 * t for n in numels) and any(n % 4 for n in numels)  # iterations; a tail
    assert {c["seed"] for c in TABLE["cases"]} >= {0, 2**40 + 3}           # both key words


def test_keep_bytes_on_the_cpu_is_the_plain_draw():
    assert torch.equal(keep_bytes((3, 50, 64), 7, 0.9, "cpu"), keep_bytes_plain((3, 50, 64), 7, 0.9))
    assert keep_bytes((0, 64), 7, 0.9, "cpu").shape == (0, 64)
    with pytest.raises(ValueError):
        keep_bytes_plain((2**29 + 1,), 0, 0.9)                        # PyTorch splits such a draw


def test_keep_rate_and_seeds():
    a = keep_bytes_plain((512, 4096), 3, 0.9)
    assert abs(a.float().mean().item() - 0.9) < 1e-3
    b = keep_bytes_plain((512, 4096), 4, 0.9)
    assert 0.15 < (a != b).float().mean().item() < 0.21                 # 2 p (1 - p) = 0.18
    assert torch.equal(a, keep_bytes_plain((512, 4096), 3 + 2**64, 0.9))  # the seed's 64 bits


def _all_bf16():
    x = torch.arange(0, 65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x)]


@pytest.mark.parametrize("p", [0.05, 0.1, 0.3, 0.5])
def test_32bit_scale_is_the_eager_division_for_every_bf16(p):
    thr, scale, inv = dropout_rule(p, 32, torch.bfloat16)
    assert thr == 1 and scale == inv == float(np.float32(1.0) / np.float32(float(torch.tensor(1 - p).bfloat16())))
    x = _all_bf16()
    keep = float(torch.tensor(1 - p, dtype=torch.bfloat16))
    assert torch.equal((x.float() * scale).to(torch.bfloat16).view(torch.int16), (x / keep).view(torch.int16))


def test_the_u8_rule_is_unchanged():
    assert dropout_rule(0.1, 8, torch.bfloat16) == (26, 1.109375, 1.0 / (1.0 - 26 / 256))
    assert dropout_rule(0.0, 32, torch.bfloat16)[0] == 0
    with pytest.raises(ValueError):
        dropout_rule(0.1, 16, torch.bfloat16)


M, K, R = 256, 512, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).bfloat16()
    a = torch.from_numpy((rng.standard_normal((K, R)) * 0.05).astype(np.float32)).bfloat16()
    dmid = torch.from_numpy(rng.standard_normal((M, R)).astype(np.float32)).bfloat16()
    return x, a, dmid, keep_bytes_plain((M, K), 11, 0.9)


def _close(got, want, roundings=1):
    """Within ``roundings`` bf16 roundings of the largest value (2^-8 x
    max|want| each)."""
    want = want.float()
    assert (got.float() - want).abs().max() <= roundings * BF16_ULP * want.abs().max()


def test_32bit_rule_against_the_eager_route(data):
    x, a, dmid, keep = data
    bf16_keep = float(torch.tensor(0.9, dtype=torch.bfloat16))
    _, scale, _ = dropout_rule(0.1, 32, torch.bfloat16)
    eager_x = torch.where(keep.bool(), x / bf16_keep, 0.0)
    assert torch.equal(lf._dropped(x, keep.bool(), scale), eager_x)            # the dropped x, bit for bit
    xe, ae = x.clone().requires_grad_(), a.clone().requires_grad_()
    (torch.where(keep.bool(), xe / bf16_keep, 0.0) @ ae).backward(dmid)
    mid = fused_dropout_matmul_plain(x, a, 11, 1, keep, scale=scale)
    _close(mid, (eager_x.float() @ a.float()))
    dx, da = fused_dropout_bwd_plain(x, a, dmid, 11, 1, keep, scale=scale)
    _close(dx, xe.grad, roundings=2)          # the eager route rounds dmid @ A^T before its scale
    _close(da, ae.grad)
    assert not dx[keep == 0].any()


def test_32bit_rule_through_autograd(data):
    x, a, dmid, keep = data
    xt, at = x.clone().requires_grad_(), a.float().requires_grad_()
    mid = fused_dropout_matmul(xt, at.bfloat16(), 11, 0.1, bits=keep, dropout_bits=32)
    mid.backward(dmid)
    _, scale, _ = dropout_rule(0.1, 32, torch.bfloat16)
    assert torch.equal(mid, fused_dropout_matmul_plain(x, a, 11, 1, keep, scale=scale))
    dx, da = fused_dropout_bwd_plain(x, a, dmid, 11, 1, keep, scale=scale)
    assert torch.equal(xt.grad, dx) and torch.equal(at.grad, da.bfloat16().float())
    with pytest.raises(ValueError):
        fused_dropout_matmul(x, a, 11, 0.1, dropout_bits=32)                 # no bytes


def _lora(seed=0):
    torch.manual_seed(seed)
    lin = LoRALinear(64, 48, LoRAConfig(rank=16), dtype=torch.bfloat16).train()
    with torch.no_grad():
        lin.weight.normal_(std=0.1)
        lin.lora_b.normal_(std=0.1)
    return lin


def test_route_is_taken_only_where_the_kernels_take_the_input():
    a = torch.zeros(64, 16, dtype=torch.bfloat16)
    assert not lora_mod.takes_keep_bytes(torch.zeros(2, 64, dtype=torch.bfloat16), a)   # the CPU
    meta = torch.empty(2, 64, dtype=torch.bfloat16, device="meta")
    assert not lora_mod.takes_keep_bytes(meta, a)


def test_route_decides_by_the_drawn_shape(monkeypatch):
    """On the card's tensors (fake ones: shapes, no memory) the route takes
    a draw that PyTorch makes in one launch, the global batch's rows and the
    whole width, and leaves a larger one to the eager route: at 2048 tokens
    and K 14336, 18 global rows fit and 19 do not, whole or as a rank's
    half of the columns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(3, 2048, 14336, dtype=torch.bfloat16, device="cuda")
        a = torch.empty(14336, 16, dtype=torch.bfloat16, device="cuda")
        half = torch.empty(3, 2048, 7168, dtype=torch.bfloat16, device="cuda")
        a_half = torch.empty(7168, 16, dtype=torch.bfloat16, device="cuda")
        assert lora_mod.takes_keep_bytes(x, a)
        assert lora_mod.takes_keep_bytes(x, a, rows=(15, 18))
        assert not lora_mod.takes_keep_bytes(x, a, rows=(15, 19))
        assert lora_mod.takes_keep_bytes(half, a_half, rows=(0, 18), cols=(7168, 14336))
        assert not lora_mod.takes_keep_bytes(half, a_half, rows=(0, 19), cols=(7168, 14336))
        assert not lora_mod.takes_keep_bytes(torch.empty(3, 2048, 14336, device="cuda"), a)
        assert not lora_mod.takes_keep_bytes(torch.empty(3, 2048, 14300, dtype=torch.bfloat16, device="cuda"),
                                             torch.empty(14300, 16, dtype=torch.bfloat16, device="cuda"))
        assert not lora_mod.takes_keep_bytes(x, torch.empty(14336, 8, dtype=torch.bfloat16, device="cuda"))
        monkeypatch.setattr(lf, "KEEP_MAX_NUMEL", 3 * 2048 * 14336 - 1)
        assert not lora_mod.takes_keep_bytes(x, a)
        assert lora_mod.takes_keep_bytes(half, a_half)


def test_route_is_asked_with_the_rows_and_columns_it_draws(monkeypatch):
    asked = []
    monkeypatch.setattr(lora_mod, "takes_keep_bytes",
                        lambda x, a, rows, cols: asked.append((tuple(x.shape), rows, cols)) or False)
    monkeypatch.setattr(lora_mod, "input_columns", lambda split, x: (64, 256))
    lin = _lora()
    x = torch.randn(3, 10, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    with profile(activities=[ProfilerActivity.CPU]):
        lin(x, seed=5, rows=(2, 8))
    assert asked == [((3, 10, 64), (2, 8), (64, 256))]
    assert profiling.COUNTS == {"lora_dropout32.eager": 1}
    profiling.COUNTS.clear()


def test_drawn_shape_is_what_keep_rows_draws():
    x = torch.zeros(3, 10, 64)
    for rows, cols in ((None, None), ((2, 8), None), (None, (64, 256)), ((2, 8), (64, 256))):
        shapes = []
        lora_mod.keep_rows(x, rows, lambda shape: shapes.append(tuple(shape)) or torch.zeros(shape), cols)
        assert shapes == [lora_mod.drawn_shape(x, rows, cols)]


@pytest.mark.parametrize("rows,cols", [(None, None), ((2, 8), None), ((2, 8), (64, 256))])
def test_route_gives_the_eager_route_on_the_same_bytes(monkeypatch, rows, cols):
    """The route (taken on the CPU by patching its test) against the eager
    route's arithmetic on the same keep bytes: the global batch's and
    width's bytes, the part x holds kept."""
    lin = _lora()
    x = torch.randn(3, 10, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    monkeypatch.setattr(lora_mod, "takes_keep_bytes", lambda *args: True)
    monkeypatch.setattr(lora_mod, "input_columns", lambda split, x: cols)
    got = lin(x, seed=5, rows=rows)
    keep = lora_mod.keep_rows(x, rows, lambda shape: keep_bytes_plain(shape, 5, 0.9), cols)
    a = lin.lora_a.bfloat16()
    z = torch.where(keep.bool(), x / float(torch.tensor(0.9).bfloat16()), 0.0).reshape(-1, 64)
    mid = (z.float() @ a.float()).bfloat16().reshape(3, 10, 16)
    want = F.linear(x, lin.weight) + (mid @ lin.lora_b.bfloat16()) * 2.0
    assert torch.equal(got, want)


def test_each_route_counts_its_site_calls_under_a_profiler(monkeypatch):
    lin = _lora()
    x = torch.randn(2, 4, 64).bfloat16()
    profiling.COUNTS.clear()
    lin(x, seed=1)
    assert not profiling.COUNTS                                          # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        lin(x, seed=1)
        lin(x, seed=2)
        lin.eval()(x, seed=3)                                            # no dropout: no count
        lin.train()
        monkeypatch.setattr(lora_mod, "takes_keep_bytes", lambda *args: True)
        lin(x, seed=4)
    assert profiling.COUNTS == {"lora_dropout32.eager": 2, "lora_dropout32.kernel": 1}
    profiling.COUNTS.clear()
