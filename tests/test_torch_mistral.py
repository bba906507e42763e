"""Port parity: the Mistral decoder's pieces against the JAX package, in f32.

The JAX side runs its tiny config with ``attention_impl="pallas"`` (the
packed flash kernel in interpret mode); the port runs the plain attention.
Parameters are drawn with numpy from a seed and loaded into both sides.
Tolerance 1e-5 absolute on unit-scale activations: f32 arithmetic in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import mistral as jm
from phantom_vlb_tpu_torch.models import mistral as tm
from phantom_vlb_tpu_torch.models.convert import from_flax_params

TOL = 1e-5
B, S = 2, 40          # S is not a multiple of the JAX kv tile (128)


def _randomize(tree, rng):
    """Seeded numpy weights in the Flax tree's shapes (norm weights near 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "weight":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            fan_in = v.shape[0] if k == "kernel" else 1
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _inputs(seed, valid=(S, 29)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    mask = (np.arange(S)[None] < np.asarray(valid)[:, None]).astype(np.int32)
    return rng, x, mask


def _load(module: torch.nn.Module, flax_tree: dict, prefix: str):
    sd = {k[len(prefix):]: v for k, v in from_flax_params(flax_tree).items() if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_rmsnorm_hf_order():
    rng, x, _ = _inputs(0)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ref = jm.RMSNorm(1e-5, jnp.float32, jnp.float32).apply({"params": {"weight": w}}, x)
    norm = tm.RMSNorm(64, 1e-5)
    norm.weight.data = torch.from_numpy(w)
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_rmsnorm_casts_before_weight_in_bf16():
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    norm = tm.RMSNorm(16)
    norm.weight.data = torch.full((16,), 1.5)
    h = x.float()
    expect = (h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-5)).bfloat16() * torch.tensor(1.5).bfloat16()
    assert norm(x).dtype == torch.bfloat16 and torch.equal(norm(x), expect)


@pytest.mark.parametrize("heads", [4, 2])
def test_rope_packed(heads):
    _, x, _ = _inputs(1)
    pos = np.arange(S, dtype=np.int32)[None]
    d = 64 // heads
    ref = jm.apply_rope_packed(jnp.asarray(x), jm.rope_tables(jnp.asarray(pos), d, 1e6), heads)
    rope = tm.rope_tables(torch.from_numpy(pos), d, 1e6)
    out = tm.apply_rope_packed(torch.from_numpy(x), rope, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_decoder_layer():
    rng, x, mask = _inputs(2)
    cfg = jm.MistralConfig.tiny(attention_impl="pallas")
    layer = jm.MistralDecoderLayer(cfg)
    rope = jm.rope_tables(jnp.arange(S)[None], cfg.head_dim, cfg.rope_theta)
    params = _randomize(jax.eval_shape(layer.init, jax.random.key(0), x, rope, mask)["params"], rng)
    ref = layer.apply({"params": params}, x, rope, mask)

    port = _load(tm.MistralDecoderLayer(tm.MistralConfig.tiny()),
                 {"model": {"layers_0": params}}, "model.layers.0.")
    trope = tm.rope_tables(torch.arange(S)[None], 16, 1e6)
    with torch.no_grad():
        out = port(torch.from_numpy(x), trope, torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_mistral_model():
    rng, x, mask = _inputs(3)
    cfg = jm.MistralConfig.tiny(attention_impl="pallas")
    model = jm.MistralModel(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0), x, None, mask)["params"]
    params = _randomize(params, rng)
    ref = model.apply({"params": params}, x, None, mask)

    port = tm.MistralModel(tm.MistralConfig.tiny())
    sd = {k[len("model."):]: v for k, v in from_flax_params({"model": params}).items()}
    missing = port.load_state_dict(sd, strict=False).missing_keys
    assert set(missing) <= {"embed_tokens.weight"}   # the JAX init only embeds if asked
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    assert out.shape == (B, S, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_configs():
    full = tm.MistralConfig.full()
    assert (full.hidden_size, full.num_hidden_layers, full.num_attention_heads,
            full.num_key_value_heads, full.head_dim, full.intermediate_size,
            full.rope_theta, full.dtype) == (4096, 32, 32, 8, 128, 14336, 1e6, torch.bfloat16)
    jt, tt = jm.MistralConfig.tiny(), tm.MistralConfig.tiny()
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta"):
        assert getattr(jt, f) == getattr(tt, f), f
