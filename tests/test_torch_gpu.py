"""Card-only tests of the port's CUDA kernel (marker ``gpu``).

They skip without a CUDA card; whether one exists is decided inside the
fixture, never at import. On the card (which has no JAX, so the JAX test
harness in conftest.py is left out)::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from phantom_vlb_tpu_torch.ops.flash_attention import (
    FLASH_FWD,
    attention_packed,
    attention_packed_plain,
)

pytestmark = pytest.mark.gpu

D = 128
# bf16 out (2^-8 relative at |out| <= ~1, bf16 P in PV); f32 lse, order only.
OUT_TOL, LSE_TOL = 2e-2, 1e-3


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


def _reference(q, k, v, hq, hkv, mask):
    q_s = q * torch.tensor(D ** -0.5, dtype=q.dtype, device=q.device)
    return attention_packed_plain(q_s.float(), k.float(), v.float(), hq, hkv,
                                  sm_scale=1.0, kv_mask=mask)


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
