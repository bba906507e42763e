"""Port parity: the per-row int8 quant (plain version, the CPU path) against
the JAX package, on inputs made with numpy from a seed.

The port's q and s follow the jnp path of ``phantom_vlb_tpu/ops/quant.py``
(``_act_quant``, the JAX package's default) bit for bit: s = absmax / 127 by
IEEE division. The JAX Pallas kernel in interpret mode computes
s = absmax * f32(1/127) (XLA's rewrite of a division by a constant), one ulp
off at some rows, so s is held to it within rtol 1e-6 (the JAX package's own
tolerance, tests/test_rowquant.py) and q bit-equal wherever the JAX kernel
agrees with its own jnp path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.ops.quant import _act_quant, _act_quant_scaled
from phantom_vlb_tpu.ops.rowquant import row_quant as j_row_quant
from phantom_vlb_tpu.ops.rowquant import row_quant_scaled as j_row_quant_scaled
from phantom_vlb_tpu_torch.ops.rowquant import row_quant, row_quant_plain, row_quant_scaled

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _check(q, s, kernel, jnp_path):
    """q bit-equal to the jnp path, and to the kernel wherever the kernel
    agrees with the jnp path; s bit-equal to the jnp path, rtol 1e-6 to the kernel."""
    (qk, sk), (qj, sj) = [(np.asarray(a), np.asarray(b)) for a, b in (kernel, jnp_path)]
    q, s = q.numpy(), s.numpy()
    assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == qk.shape and s.shape == sk.shape
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(q[qk == qj], qk[qk == qj])
    np.testing.assert_allclose(s, sk, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(16, 256), (2, 8, 384), (8, 128)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_row_quant_matches_jax(shape, dtype):
    x = 3.0 * np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    _check(*row_quant(xt), j_row_quant(xj, interpret=True), _act_quant(xj))


@pytest.mark.parametrize("shape", [(16, 256), (2, 8, 384)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_row_quant_scaled_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    dy = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.01, 2.0, shape[-1]).astype(np.float32)
    dj, dt = _pair(dy, dtype)
    got = row_quant_scaled(dt, torch.from_numpy(w))
    _check(*got, j_row_quant_scaled(dj, jnp.asarray(w), interpret=True), _act_quant_scaled(dj, w))


def test_zero_row_takes_the_scale_floor():
    x = np.zeros((8, 256), np.float32)
    x[3] = np.random.default_rng(2).standard_normal(256)
    q, s = row_quant(torch.from_numpy(x).to(torch.bfloat16))
    qk, sk = j_row_quant(jnp.asarray(x, jnp.bfloat16), interpret=True)
    zero = np.arange(8) != 3
    assert np.all(q.numpy()[zero] == 0) and np.all(np.asarray(qk)[zero] == 0)
    assert np.all(s.numpy()[zero] == np.float32(1e-12))
    np.testing.assert_array_equal(s.numpy()[zero], np.asarray(sk)[zero])


@pytest.mark.parametrize("shape", [(5, 100), (3, 7, 130), (1, 33)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_odd_shapes_match_the_jnp_path(shape, dtype):
    """Row counts and widths the TPU kernel refuses (rows % 8, N % 128)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.01, 2.0, shape[-1]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    for got, want in ((row_quant(xt), _act_quant(xj)),
                      (row_quant_scaled(xt, torch.from_numpy(w)), _act_quant_scaled(xj, w))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    for got, want in zip(row_quant(x), row_quant_plain(x)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="device"):
        row_quant(x.to("meta"))
