"""Port parity: the STC connector against the JAX package.

At depth 2 with distinct encoder and hidden widths (48 -> 80 -> 64), so
stage s1's first block carries the 1x1 + LayerNorm shortcut and the
squeeze-excite widths differ between blocks (round(48 / 4) = 12 in s1.b1,
round(80 / 4) = 20 elsewhere), in f32 on the CPU, on weights drawn with
numpy from a seed and carried across by ``from_flax_params``. Tolerance:
max|err| / max|ref| of the tokens <= 1e-4 (f32 LayerNorms, convolutions
and products summed in another order).

The independent oracle is ``tests/test_stc_hf_oracle.py``'s connector over
HF's RegNet-Y blocks (random weights, carried by the JAX package's
``convert_stc_connector`` and ``from_flax_params``): 2e-4, the JAX
connector's own bound there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import stc_connector as js
from phantom_vlb_tpu_torch.models import stc_connector as ts
from phantom_vlb_tpu_torch.models.convert import from_flax_params

TOL = 1e-4
WIDTHS = dict(encoder_hidden_size=48, hidden_size=80, output_hidden_size=64, depth=2)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_connector(params, cfg: ts.STCConfig) -> ts.STCConnector:
    sd = {k[len("mm_projector."):]: v for k, v in from_flax_params({"mm_projector": params}).items()}
    with torch.device("meta"):
        stc = ts.STCConnector(cfg)
    stc.load_state_dict(sd, strict=True, assign=True)
    return stc.eval()


@pytest.mark.parametrize("t,grid", [(4, 4), (5, 6), (12, 3)])
def test_connector_matches_jax(t, grid):
    """(B, T, g, g, 48) -> (B, (T//2+1) (g//2+1)^2, 64) tokens in (t, h, w) order."""
    jcfg = js.STCConfig.tiny(**WIDTHS)
    x = np.random.default_rng(t).standard_normal((2, t, grid, grid, 48)).astype(np.float32)
    shapes = jax.eval_shape(js.STCConnector(jcfg).init, jax.random.key(0), x)["params"]
    params = _leaves(shapes, np.random.default_rng(7))
    want = js.STCConnector(jcfg).apply({"params": params}, x)
    stc = port_connector(params, ts.STCConfig.tiny(**WIDTHS))
    assert stc.s1.b1.se.fc1.weight.shape == (12, 80, 1, 1) and stc.s1.b2.se.fc1.weight.shape == (20, 80, 1, 1)
    assert stc.s1.b1.downsample_conv is not None and stc.s1.b2.downsample_conv is None
    with torch.no_grad():
        got = stc(torch.from_numpy(x))
    ds = (t // 2 + 1) * (grid // 2 + 1) ** 2
    assert got.shape == want.shape == (2, ds, 64)
    assert _rel(got.numpy(), want) <= TOL


def test_full_connector_has_the_reference_shapes():
    """At VideoLLaMA2's widths (1024 -> 4096, depth 4): the squeeze-excite
    width comes from the block's input (256 in s1.b1, 1024 elsewhere), the
    sampler is 2x2x2 and 12 x 24 x 24 gives 7 x 13 x 13 = 1183 tokens (the
    JAX connector's eval_shape; the port's on the meta device)."""
    jcfg = js.STCConfig()
    x = jax.ShapeDtypeStruct((1, 12, 24, 24, 1024), jnp.float32)
    shapes = jax.eval_shape(js.STCConnector(jcfg).init, jax.random.key(0), x)["params"]
    out = jax.eval_shape(js.STCConnector(jcfg).apply, {"params": shapes}, x)
    with torch.device("meta"):
        stc = ts.STCConnector(ts.STCConfig())
        got = stc(torch.empty(1, 12, 24, 24, 1024))
    assert got.shape == out.shape == (1, 1183, 4096)
    for stage in ("s1", "s2"):
        for b in range(1, 5):
            jse = shapes[stage][f"b{b}"]["se"]["fc1"]["kernel"].shape            # (1, 1, in, rd)
            pse = getattr(getattr(stc, stage), f"b{b}").se.fc1.weight.shape       # (rd, in, 1, 1)
            assert pse == (jse[3], jse[2], 1, 1) == ((256 if (stage, b) == ("s1", 1) else 1024), 4096, 1, 1)
    assert "downsample_conv" in shapes["s1"]["b1"] and "downsample_conv" not in shapes["s1"]["b2"]
    assert stc.sampler_conv.weight.shape == (4096, 4096, 2, 2, 2)
    assert shapes["sampler_conv"]["kernel"].shape == (2, 2, 2, 4096, 4096)


def test_connector_matches_the_hf_regnet_oracle():
    pytest.importorskip("transformers")
    from test_stc_hf_oracle import HFSTCOracle, _randomize, _remap

    from phantom_vlb_tpu.models.convert import convert_stc_connector

    enc, hidden, out, depth = 16, 24, 16, 2
    oracle = HFSTCOracle(enc, hidden, out, depth=depth)
    _randomize(oracle)
    oracle.eval()
    sd = _remap({k: v.detach().numpy() for k, v in oracle.state_dict().items()})
    params = convert_stc_connector(sd, depth=depth, mlp_depth=2, prefix="")
    stc = port_connector(params, ts.STCConfig.tiny(encoder_hidden_size=enc, hidden_size=hidden,
                                                   output_hidden_size=out, depth=depth))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 6, 6, enc)).astype(np.float32))
    with torch.no_grad():
        want, got = oracle(x), stc(x)
    assert got.shape == want.shape == (2, 3 * 4 * 4, out)
    assert _rel(got.numpy(), want.numpy()) <= 2e-4
