"""Port parity: int8 weight quantization, the three int8 matmuls and the
tiny Mistral decoder in every ``base_quant`` mode, against the JAX package
on the CPU, on weights and inputs made with numpy from a seed.

Tolerances: ``quantize_int8``, the state-dict quantizer and the converted
leaves are bit-equal. The matmuls and their dx are held at 1e-6 of their
largest value in f32 (the int32 products are exact on both sides; what is
left is f32 scaling in the same order, and w8a8's dx is a bf16 product,
the same on both sides). The decoder's outputs and gradients are held
against the largest value of each, per mode: 'int8' at 1e-5 (f32 sums in
another order, as the f32 decoder parity test); 'w8a8g8' at 1e-3 (each
side rounds activations and dy * scale to int8 codes, and a value that
upstream f32 sums in another order move across a .5 boundary changes its
code by one, a step of max|row| / 127 in one input of the next product;
measured 2.3e-4); 'w8a8' at 1e-2 (its dx is a bf16 product on both sides,
and a rounding that flips moves an element by 2^-8 = 3.9e-3 of itself;
measured 2.8e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import mistral as jm
from phantom_vlb_tpu.models.convert import stack_layer_params
from phantom_vlb_tpu.models.lora import LoRAConfig as JLoRA
from phantom_vlb_tpu.ops import quant as jq
from phantom_vlb_tpu_torch.models import mistral as tm
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig as TLoRA
from phantom_vlb_tpu_torch.ops import quant as tq

MODES = ["int8", "w8a8", "w8a8g8"]
B, S, E = 2, 24, 64
MATMUL_TOL = 1e-6
MODEL_TOL = {"int8": 1e-5, "w8a8": 1e-2, "w8a8g8": 1e-3}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape,axis", [((64, 32), 0), ((48, 80), 1), ((3, 16, 8), 1)])
def test_quantize_int8_is_bit_equal_to_numpy(shape, axis):
    rng = np.random.default_rng(0)
    w = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    w[(slice(None),) * (1 - axis) + (0,)] = 0.0          # a zero channel: scale 1.0
    q, s = jq.quantize_int8(w, axis=axis)
    tq_, ts = tq.quantize_int8(torch.from_numpy(w), axis=axis)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)
    assert np.any(ts.numpy() == 1.0)


@pytest.fixture(scope="module")
def int8_weights():
    rng = np.random.default_rng(1)
    q, s = jq.quantize_int8((0.05 * rng.standard_normal((96, 40))).astype(np.float32))
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 40)).astype(np.float32)
    return q, s, x, dy


@pytest.mark.parametrize("name", ["int8_matmul", "int8_matmul_w8a8", "int8_matmul_w8a8g8"])
@pytest.mark.parametrize("layout", ["in_out", "out_in_view"])
def test_int8_matmuls_and_dx_match_jax(int8_weights, name, layout):
    """Outputs and dx against ``jax.vjp`` in f32; the port's q is either the
    (in, out) array or the transposed view of the (out, in) buffer a module
    stores."""
    q, s, x, dy = int8_weights
    y, vjp = jax.vjp(lambda a: getattr(jq, name)(a, jnp.asarray(q), jnp.asarray(s), jnp.float32),
                     jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dy))
    tq_ = torch.from_numpy(q) if layout == "in_out" else torch.from_numpy(q.T.copy()).t()
    xt = torch.from_numpy(x).requires_grad_()
    yt = getattr(tq, name)(xt, tq_, torch.from_numpy(s), torch.float32)
    yt.backward(torch.from_numpy(dy))
    assert yt.dtype == torch.float32 and xt.grad.dtype == torch.float32
    assert _rel(yt.detach().numpy(), y) <= MATMUL_TOL
    assert _rel(xt.grad.numpy(), dx) <= MATMUL_TOL


@pytest.mark.parametrize("name", ["int8_matmul_w8a8", "int8_matmul_w8a8g8"])
def test_int8_backward_skips_dx_when_not_needed(int8_weights, name):
    q, s, x, _ = int8_weights
    y = getattr(tq, name)(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), torch.float32)
    assert not y.requires_grad
    with pytest.raises(ValueError, match="base_quant"):
        tq.quant_matmul("int4", torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                        torch.float32)


def _randomize(tree, rng):
    """Seeded numpy leaves: int8 codes, positive per-channel scales, norm
    weights near 1, adapters and kernels of unit fan-in scale."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "kernel_q":
            out[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k == "kernel_scale":
            out[k] = (rng.uniform(0.5, 1.5, v.shape) / (127.0 * np.sqrt(E))).astype(np.float32)
        elif k == "weight":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "lora_b":
            out[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
    return out


def _lora_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _lora_leaves(v, prefix + (k,))
        elif k in ("lora_a", "lora_b"):
            yield prefix + (k,), v


def _set(tree, path, value):
    if len(path) == 1:
        return {**tree, path[0]: value}
    return {**tree, path[0]: _set(tree[path[0]], path[1:], value)}


@pytest.mark.parametrize("use_lora", [False, True], ids=["frozen", "lora"])
@pytest.mark.parametrize("mode", MODES)
def test_tiny_decoder_matches_jax(mode, use_lora):
    """Outputs, input gradients and (with LoRA) every adapter gradient of
    ``mean(out^2)`` through the same converted int8 weights."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([[S], [17]])).astype(np.int32)
    jlora = JLoRA(rank=4, alpha=8.0, dropout=0.0) if use_lora else None
    jcfg = jm.MistralConfig.tiny(lora=jlora, base_quant=mode)
    jmodel = jm.MistralModel(jcfg)
    params = _randomize(jax.eval_shape(jmodel.init, jax.random.key(0), x, None, mask)["params"], rng)
    paths = [p for p, _ in _lora_leaves(params)]

    def j_loss(leaves, xx):
        p = params
        for path, leaf in zip(paths, leaves):
            p = _set(p, path, leaf)
        return jnp.mean(jmodel.apply({"params": p}, xx, None, mask) ** 2)

    leaves = [jnp.asarray(v) for _, v in _lora_leaves(params)]
    out_j = jmodel.apply({"params": params}, x, None, mask)
    g_leaves, g_x = jax.grad(j_loss, argnums=(0, 1))(leaves, jnp.asarray(x))

    tlora = TLoRA(rank=4, alpha=8.0, dropout=0.0) if use_lora else None
    port = tm.MistralModel(tm.MistralConfig.tiny(lora=tlora, base_quant=mode))
    sd = {k[len("model."):]: v for k, v in from_flax_params({"model": params}).items()}
    assert set(port.load_state_dict(sd, strict=False).missing_keys) <= {"embed_tokens.weight"}
    port.eval().requires_grad_(False)
    named = {n: p for n, p in port.named_parameters() if "lora_" in n}
    for p in named.values():
        p.requires_grad_(True)
    assert port.layers[1].mlp.up_proj.weight_q.dtype == torch.int8
    xt = torch.from_numpy(x).requires_grad_()
    out_t = port(xt, torch.from_numpy(mask))
    out_t.square().mean().backward()

    tol = MODEL_TOL[mode]
    assert _rel(out_t.detach().numpy(), out_j) <= tol
    assert _rel(xt.grad.numpy(), g_x) <= tol
    assert len(named) == len(paths) == (14 * jcfg.num_hidden_layers if use_lora else 0)
    for path, g in zip(paths, g_leaves):
        name = ".".join(path).replace("layers_", "layers.")
        assert _rel(named[name].grad.numpy(), g) <= tol, name


def test_state_dict_quantizer_matches_quantize_tree():
    rng = np.random.default_rng(3)
    cfg = jm.MistralConfig.tiny(lora=JLoRA(rank=4, alpha=8.0, dropout=0.0))
    x = np.zeros((1, 8, E), np.float32)
    params = _randomize(jax.eval_shape(jm.MistralModel(cfg).init, jax.random.key(0), x)["params"], rng)
    targets = tq.BASE_PROJECTIONS
    want = from_flax_params({"model": jq.quantize_tree(params, lambda p, w: any(t in p for t in targets))})
    sd = from_flax_params({"model": params})
    n_weights = sum(k.endswith("proj.weight") for k in sd)
    got = tq.quantize_state_dict(sd)
    assert got is sd and sum(k.endswith("weight_q") for k in got) == n_weights == 14
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("form", ["unrolled", "layers_scan"])
def test_from_flax_params_reads_quantized_leaves(form):
    """``kernel_q`` (in, out) and ``kernel_scale``, unrolled or stacked
    (L, in, out), load as ``weight_q`` (out, in) and ``weight_scale``."""
    rng = np.random.default_rng(4)
    cfg = jm.MistralConfig.tiny(lora=JLoRA(rank=4, alpha=8.0, dropout=0.0), base_quant="w8a8g8")
    x = np.zeros((1, 8, E), np.float32)
    params = _randomize(jax.eval_shape(jm.MistralModel(cfg).init, jax.random.key(0), x)["params"], rng)
    tree = params if form == "unrolled" else stack_layer_params(params, cfg.num_hidden_layers)
    sd = from_flax_params({"model": tree})
    leaf = params["layers_1"]["mlp"]["gate_proj"]
    assert sd["model.layers.1.mlp.gate_proj.weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(sd["model.layers.1.mlp.gate_proj.weight_q"].numpy(), leaf["kernel_q"].T)
    np.testing.assert_array_equal(sd["model.layers.1.mlp.gate_proj.weight_scale"].numpy(),
                                  leaf["kernel_scale"])
    assert not any(k.endswith(".weight") and "proj" in k for k in sd)
    port = tm.MistralModel(tm.MistralConfig.tiny(lora=TLoRA(rank=4, alpha=8.0, dropout=0.0),
                                                 base_quant="w8a8g8"))
    strip = {k[len("model."):]: v for k, v in sd.items()}
    assert set(port.load_state_dict(strip, strict=False).missing_keys) <= {"embed_tokens.weight"}


def test_unknown_base_quant_raises():
    with pytest.raises(ValueError, match="base_quant"):
        tm.MistralModel(dataclasses.replace(tm.MistralConfig.tiny(), base_quant="int4"))
