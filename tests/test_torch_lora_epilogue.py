"""Port parity: the fused LoRA epilogue (plain versions, the CPU path) against
JAX ``lora_epilogue(interpret=True)``, and a LoRA decoder with the flag on
against the flag off.

Inputs are made with numpy from a seed. Tolerance 1e-6 of the largest value
in f32: out is the same f32 arithmetic; dz and dB are f32 sums over N and M
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops.lora_epilogue import lora_epilogue as j_epilogue
from phantom_vlb_tpu_torch.models import mistral as tm
from phantom_vlb_tpu_torch.models.lora import LoRAConfig
from phantom_vlb_tpu_torch.ops import lora_epilogue as epi
from phantom_vlb_tpu_torch.ops.lora_epilogue import (
    lora_epilogue,
    lora_epilogue_db,
    lora_epilogue_db_plain,
    lora_epilogue_dz,
    lora_epilogue_dz_plain,
    lora_epilogue_dzdb,
    lora_epilogue_dzdb_plain,
    lora_epilogue_fwd,
    lora_epilogue_plain,
)

TOL = 1e-6
SCALING = 2.0
# The shared memory a block may take on an H100 (227 KB).
SMEM_PER_BLOCK = 232448


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("backward", ["pallas", "xla"])
@pytest.mark.parametrize("lead,n", [((64,), 256), ((2, 24), 384)], ids=["2d", "3d"])
@pytest.mark.parametrize("r", [4, 16])
def test_epilogue_matches_jax(backward, lead, n, r):
    rng = np.random.default_rng(r + n)
    y = rng.standard_normal((*lead, n)).astype(np.float32)
    z = rng.standard_normal((*lead, r)).astype(np.float32)
    b = (rng.standard_normal((r, n)) / np.sqrt(r)).astype(np.float32)
    dout = rng.standard_normal((*lead, n)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda *a: j_epilogue(*a, SCALING, interpret=True, backward=backward),
                         jnp.asarray(y), jnp.asarray(z), jnp.asarray(b))
    dy_j, dz_j, db_j = vjp(jnp.asarray(dout))

    yt, zt, bt = (torch.from_numpy(a).requires_grad_() for a in (y, z, b))
    out = lora_epilogue(yt, zt, bt, SCALING, backward=backward)
    out.backward(torch.from_numpy(dout))
    assert out.shape == y.shape and zt.grad.shape == z.shape and bt.grad.shape == b.shape
    assert _rel(out.detach().numpy(), out_j) <= TOL
    np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(dy_j))      # passed through
    assert _rel(zt.grad.numpy(), dz_j) <= TOL
    assert _rel(bt.grad.numpy(), db_j) <= TOL


@pytest.mark.parametrize("lead,n", [((64,), 256), ((2, 24), 384)], ids=["2d", "3d"])
@pytest.mark.parametrize("r", [4, 16])
def test_dzdb_plain_matches_the_jax_vjp(lead, n, r):
    """The fused backward's plain version (dz and dB from one call) against
    the reference's vjp in interpret mode, f32."""
    rng = np.random.default_rng(3 * r + n)
    y = rng.standard_normal((*lead, n)).astype(np.float32)
    z = rng.standard_normal((*lead, r)).astype(np.float32)
    b = (rng.standard_normal((r, n)) / np.sqrt(r)).astype(np.float32)
    dout = rng.standard_normal((*lead, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_epilogue(*a, SCALING, interpret=True),
                     jnp.asarray(y), jnp.asarray(z), jnp.asarray(b))
    _, dz_j, db_j = vjp(jnp.asarray(dout))
    dz, db = lora_epilogue_dzdb_plain(torch.from_numpy(z.reshape(-1, r)),
                                      torch.from_numpy(dout.reshape(-1, n)), torch.from_numpy(b), SCALING)
    assert dz.shape == (z.size // r, r) and db.shape == (r, n)
    assert _rel(dz.numpy(), np.asarray(dz_j).reshape(-1, r)) <= TOL
    assert _rel(db.numpy(), db_j) <= TOL


def test_bf16_roundings_follow_the_reference():
    """bf16: acc rounded, times the bf16 scaling, rounded, plus y, rounded
    (``_fwd_kernel`` :45-48); dz and dB round the scaled f32 sums once."""
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    z = jnp.asarray(rng.standard_normal((64, 16)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((16, 256)), jnp.bfloat16)
    dout = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    out_j, vjp = jax.vjp(lambda *a: j_epilogue(*a, 1.7, interpret=True), y, z, b)
    _, dz_j, db_j = vjp(dout)
    yt, zt, bt, dt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in (y, z, b, dout))
    got = (lora_epilogue_plain(yt, zt, bt, 1.7), lora_epilogue_dz_plain(dt, bt, 1.7),
           lora_epilogue_db_plain(zt, dt, 1.7))
    for g, w in zip(got, (out_j, dz_j, db_j)):
        assert g.dtype == torch.bfloat16
        # f32 sums in another order may flip a rounding of a few elements.
        mism = (g.float().numpy() != np.asarray(w.astype(jnp.float32))).mean()
        assert mism <= 1e-2 and _rel(g.float().numpy(), w.astype(jnp.float32)) <= 1e-2


def test_cpu_wrappers_are_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    y, z, b = torch.randn(8, 32, generator=g), torch.randn(8, 4, generator=g), torch.randn(4, 32, generator=g)
    assert torch.equal(lora_epilogue_fwd(y, z, b, 2.0), lora_epilogue_plain(y, z, b, 2.0))
    assert torch.equal(lora_epilogue_dz(y, b, 2.0), lora_epilogue_dz_plain(y, b, 2.0))
    assert torch.equal(lora_epilogue_db(z, y, 2.0), lora_epilogue_db_plain(z, y, 2.0))
    with pytest.raises(ValueError, match="backward"):
        lora_epilogue(y, z, b, 2.0, backward="triton")


def test_cpu_dzdb_wrapper_is_the_plain_version():
    g = torch.Generator().manual_seed(1)
    z, dy, b = torch.randn(40, 8, generator=g), torch.randn(40, 96, generator=g), torch.randn(8, 96, generator=g)
    got, want = lora_epilogue_dzdb(z, dy, b, 1.5), lora_epilogue_dzdb_plain(z, dy, b, 1.5)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(want[0], lora_epilogue_dz_plain(dy, b, 1.5))
    assert torch.equal(want[1], lora_epilogue_db_plain(z, dy, 1.5))


@pytest.mark.parametrize("m,n,r", [(6144, 4096, 16), (6144, 14336, 16), (6144, 1024, 16), (64, 14336, 16),
                                   (6144, 64, 16), (33, 9, 16), (100, 300, 4), (70, 1000, 37), (64, 256, 128),
                                   (512, 2048, 128), (256, 1024, 1)])
@pytest.mark.parametrize("which", ["dzdb", "dz", "db"])
def test_backward_grid_fits_the_kernel(m, n, r, which):
    """The grid the wrapper gives the backward kernel: every block owns at
    least one tile and at most CHUNKS_PER_BLOCK column chunks, the grid is
    one wave of 132 blocks where N allows, and the choice does not change
    from call to call (the kernel's sums then repeat bit for bit)."""
    dz, db = which != "db", which != "dz"
    rp = epi._padded_rank(r)
    mb, nb = epi._grid(m, n, rp, dz, db, 132)
    rc, cc = -(-m // epi.CHUNK), -(-n // epi.CHUNK)
    assert 1 <= mb <= rc and 1 <= nb <= cc
    assert -(-cc // nb) <= epi.CHUNKS_PER_BLOCK[rp]
    assert mb * nb <= max(132, -(-cc // epi.CHUNKS_PER_BLOCK[rp]))
    epi._grid.cache_clear()
    assert epi._grid(m, n, rp, dz, db, 132) == (mb, nb)
    want = 4 * rp * (dz * m * nb + db * cc * epi.CHUNK * mb)
    assert epi.partial_bytes(m, n, r, dz, db) == want


def test_backward_grid_at_the_path_shapes():
    """The fused grid at M = 6144, r = 16: at N = 4096 and 14336 the
    partials stay well below dy's bytes (7.5 MB against 50.3 MB at 4096)."""
    for n, (mb, nb) in ((1024, (24, 4)), (4096, (16, 8)), (14336, (8, 14))):
        assert epi._grid(6144, n, 16, True, True, 132) == (mb, nb)
        assert n == 1024 or epi.partial_bytes(6144, n, 16) < 0.16 * 6144 * n * 2


@pytest.mark.parametrize("m,n", [(33, 9), (100, 300), (70, 1000), (6144, 1024), (6144, 4096), (6144, 14336)])
@pytest.mark.parametrize("r", [1, 16, 32, 64, 128])
@pytest.mark.parametrize("sms", [132, 114])
def test_forward_grid_fits_the_kernel(m, n, r, sms):
    """The grid the wrapper gives the forward kernel, replayed as the kernel
    walks it (block (gj, gi) owns row chunks [rc gi / mb, rc (gi + 1) / mb)
    and column chunks [cc gj / nb, cc (gj + 1) / nb)): every (row tile,
    column strip) is covered exactly once, every block owns a tile and at
    most FWD_CHUNKS_PER_BLOCK column chunks, fits its shared memory, and the
    grid is one wave of ``sms`` blocks; the choice repeats from call to call."""
    rp = epi._padded_rank(r)
    mb, nb = epi._fwd_grid(m, n, rp, sms)
    rc, cc = -(-m // epi.CHUNK), -(-n // epi.CHUNK)
    assert 1 <= mb <= rc and 1 <= nb <= cc and mb * nb <= sms
    cover = np.zeros((rc, cc), np.int64)
    for gi in range(mb):
        for gj in range(nb):
            rows = range(rc * gi // mb, rc * (gi + 1) // mb)
            cols = range(cc * gj // nb, cc * (gj + 1) // nb)
            assert len(rows) >= 1 and 1 <= len(cols) <= epi.FWD_CHUNKS_PER_BLOCK[rp]
            assert epi.fwd_smem_bytes(rp, len(cols)) <= SMEM_PER_BLOCK
            cover[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (cover == 1).all()
    epi._fwd_grid.cache_clear()
    assert epi._fwd_grid(m, n, rp, sms) == (mb, nb)


def test_forward_grid_at_the_path_shapes():
    """At M = 6144, r = 16 on 132 SMs the forward's grid fills at least 112
    SMs at every width of the path, N = 1024 (16 column chunks) among them."""
    for n, (mb, nb) in ((1024, (32, 4)), (4096, (16, 8)), (14336, (8, 14))):
        assert epi._fwd_grid(6144, n, 16, 132) == (mb, nb)
        assert 112 <= mb * nb <= 132


def test_autograd_backward_takes_the_fused_entry_point_when_both_grads_are_needed(monkeypatch):
    """backward='pallas': one fused call when z and B both need grads, the
    single entry point otherwise (CPU tensors: each runs its plain version)."""
    calls = []
    for name in ("lora_epilogue_dzdb", "lora_epilogue_dz", "lora_epilogue_db"):
        fn = getattr(epi, name)
        monkeypatch.setattr(epi, name, lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))
    g = torch.Generator().manual_seed(2)
    y, z, b = torch.randn(16, 64, generator=g), torch.randn(16, 4, generator=g), torch.randn(4, 64, generator=g)
    for grads, want in (((True, True), ["lora_epilogue_dzdb"]), ((True, False), ["lora_epilogue_dz"]),
                        ((False, True), ["lora_epilogue_db"])):
        calls.clear()
        zt, bt = z.clone().requires_grad_(grads[0]), b.clone().requires_grad_(grads[1])
        lora_epilogue(y.clone().requires_grad_(), zt, bt, 2.0).sum().backward()
        assert calls == want
        assert (zt.grad is not None) == grads[0] and (bt.grad is not None) == grads[1]


@pytest.mark.parametrize("flag", ["pallas", "fwd"])
def test_lora_decoder_with_the_flag_matches_the_flag_off(flag):
    """The tiny LoRA decoder, f32: outputs and every adapter gradient with
    ``fused_epilogue`` on equal the unfused epilogue's (1e-6)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 24, 64)).astype(np.float32))
    runs = []
    for fused in ("", flag):
        model = tm.MistralModel(tm.MistralConfig.tiny(
            lora=LoRAConfig(rank=4, alpha=8.0, dropout=0.0, fused_epilogue=fused)))
        gen = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            p.requires_grad_("lora_" in name)
            with torch.no_grad():           # the same seeded weights for both runs
                if "norm" in name:
                    p.fill_(1.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5)
        out = model(x)
        out.square().mean().backward()
        runs.append((out.detach(), {n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
    (out0, g0), (out1, g1) = runs
    assert _rel(out1.numpy(), out0.numpy()) <= TOL
    assert g0.keys() == g1.keys() and len(g0) == 28
    for name in g0:
        assert _rel(g1[name].numpy(), g0[name].numpy()) <= TOL, name
