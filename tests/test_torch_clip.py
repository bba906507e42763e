"""Port parity: the CLIP vision tower against the JAX package, and against HF.

The tiny tower (56 px, 64 wide, the selected layer of 2) in f32 on the CPU,
from weights drawn with numpy from a seed and carried across by
``from_flax_params``, in both tree forms (``layers_{i}`` and
``layers_scan``) and in every ``base_quant`` mode (the int8 leaves made by
the JAX package's ``quantize_tree``, as its weight loader makes them).
Tolerances, as max|err| / max|ref| of the features:

- f32: 1e-4 (a few f32 LayerNorms, softmaxes and products summed in
  another order);
- quantized: the bounds ``tests/test_torch_quant.py`` holds the decoder
  to: 'int8' 1e-5, 'w8a8g8' 1e-3 and 'w8a8' 1e-2 (each side rounds the
  projections' inputs to int8 codes, and an f32 value that upstream sums in
  another order move across a .5 boundary changes its code by one). The
  forward of 'w8a8' is the forward of 'w8a8g8'.

The independent oracle is HF's ``CLIPVisionModel`` with random weights
(``hidden_states[-2][:, 1:]``, as ``tests/test_model_parity.py`` holds the
JAX tower), its weights carried by the JAX package's ``convert_clip_vision``
and ``from_flax_params``: 2e-4, the JAX tower's own bound there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import clip_vit as jc
from phantom_vlb_tpu.models.lora import FrozenQuantDense as JFrozenQuantDense
from phantom_vlb_tpu.ops.flash_attention import xla_attention
from phantom_vlb_tpu.ops.quant import quantize_tree
from phantom_vlb_tpu_torch.models import clip_vit as tc
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.lora import FrozenQuantDense
from phantom_vlb_tpu_torch.ops.flash_attention import attention_noncausal
from phantom_vlb_tpu_torch.ops.quant import TOWER_PROJECTIONS

F32_TOL = 1e-4
QUANT_TOL = {None: F32_TOL, "int8": 1e-5, "w8a8": 1e-2, "w8a8g8": 1e-3}
MODES = [None, "int8", "w8a8", "w8a8g8"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def random_leaves(shapes, rng):
    """Seeded f32 numpy leaves for a Flax shape tree: norm scales near 1,
    kernels N(0, 1/fan_in), biases and embeddings N(0, 0.25)."""

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def quantize_tower(params):
    return quantize_tree(params, lambda path, w: any(t in path for t in TOWER_PROJECTIONS))


def tower_params(cfg: jc.CLIPVisionConfig, seed: int):
    """Seeded float params of the tiny JAX tower (quantized if ``cfg`` is)."""
    float_cfg = dataclasses.replace(cfg, base_quant=None)
    x = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
    shapes = jax.eval_shape(jc.CLIPVisionTower(float_cfg).init, jax.random.key(0), x)["params"]
    params = random_leaves(shapes, np.random.default_rng(seed))
    return params if cfg.base_quant is None else quantize_tower(params)


def port_tower(params, cfg: tc.CLIPVisionConfig) -> tc.CLIPVisionTower:
    sd = {k[len("vision_tower."):]: v for k, v in from_flax_params({"vision_tower": params}).items()}
    with torch.device("meta"):
        tower = tc.CLIPVisionTower(cfg)
    tower.load_state_dict(sd, strict=True, assign=True)
    return tower.eval()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_noncausal_matches_xla_attention(dtype):
    """The plain version against ``xla_attention(causal=False)``: f32 at
    1e-6 of max|ref|; bf16 at one bf16 ulp of max|ref| (2^-7: the same f32
    softmax, P rounded to bf16 on both sides, an output rounding apart)."""
    rng = np.random.default_rng(0)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v = (rng.standard_normal((2, 4, 37, 16)).astype(np.float32) for _ in range(3))
    want = xla_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=False)
    got = attention_noncausal(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (2, 4, 37, 16)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (1e-6 if dtype == "f32" else 2 ** -7)


@pytest.mark.parametrize("mode", MODES[1:])
def test_frozen_quant_dense_with_bias_matches_jax(mode):
    """The tower's quantized projection: the int8 product then the bias."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    layer = JFrozenQuantDense(40, use_bias=True, dtype=jnp.float32, act_quant=mode != "int8",
                              grad_quant=mode == "w8a8g8")
    params = {"kernel": (rng.standard_normal((48, 40)) / 7).astype(np.float32),
              "bias": rng.standard_normal(40).astype(np.float32)}
    params = quantize_tree({"p": params}, lambda path, w: True)["p"]
    want = layer.apply({"params": params}, x)
    port = FrozenQuantDense(48, 40, mode, torch.float32, bias=True)
    port.load_state_dict({"weight_q": torch.from_numpy(params["kernel_q"].T.copy()),
                          "weight_scale": torch.from_numpy(params["kernel_scale"]),
                          "bias": torch.from_numpy(params["bias"])})
    got = port(torch.from_numpy(x))
    assert _rel(got.detach().numpy(), want) <= 1e-6
    assert FrozenQuantDense(48, 40, mode).bias is None        # no bias unless asked: the decoder's


@pytest.mark.parametrize("mode", MODES, ids=["f32", *MODES[1:]])
@pytest.mark.parametrize("scan", [False, True], ids=["layers", "layers_scan"])
def test_tower_matches_jax(scan, mode):
    """Features (N, 16, 64) from (N, 3, 56, 56) frames; the JAX tower takes
    the same frames in NHWC, as ``encode_video`` transposes them."""
    jcfg = jc.CLIPVisionConfig.tiny(scan_layers=scan, base_quant=mode, num_hidden_layers=3)
    params = tower_params(jcfg, seed=2)
    frames = np.random.default_rng(3).standard_normal((3, 3, 56, 56)).astype(np.float32)
    want = jc.CLIPVisionTower(jcfg).apply({"params": params}, frames.transpose(0, 2, 3, 1))
    tower = port_tower(params, tc.CLIPVisionConfig.tiny(base_quant=mode, num_hidden_layers=3))
    assert len(tower.layers) == 2                       # the selected layer and those before it
    with torch.no_grad():
        got = tower(torch.from_numpy(frames))
    assert got.shape == want.shape == (3, 16, 64)
    assert _rel(got.numpy(), want) <= QUANT_TOL[mode]


def test_scan_and_unrolled_trees_give_one_state_dict():
    params = tower_params(jc.CLIPVisionConfig.tiny(num_hidden_layers=4), seed=4)
    layers = [params[f"layers_{i}"] for i in range(3)]
    scanned = {k: v for k, v in params.items() if not k.startswith("layers_")}
    scanned["layers_scan"] = jax.tree.map(lambda *a: np.stack(a), *layers)
    a, b = (from_flax_params({"vision_tower": t}) for t in (params, scanned))
    assert a.keys() == b.keys() and len([k for k in a if ".layers.2." in k]) == 16
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(a["vision_tower.patch_embedding.weight"].numpy(),
                                  params["patch_embedding"]["kernel"].transpose(3, 2, 0, 1))


def test_full_tower_builds_23_layers_of_the_reference_shapes():
    """ViT-L/14-336 at select_layer -2: 23 layers, 577 positions, the JAX
    tower's stacked shapes (eval_shape only; the port's on the meta device)."""
    jcfg = jc.CLIPVisionConfig(scan_layers=True)
    shapes = jax.eval_shape(jc.CLIPVisionTower(jcfg).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 336, 336, 3), jnp.float32))["params"]
    with torch.device("meta"):
        port = tc.CLIPVisionTower(tc.CLIPVisionConfig()).state_dict()
    assert len({k.split(".")[1] for k in port if k.startswith("layers.")}) == 23 == jcfg.effective_layers
    assert shapes["layers_scan"]["mlp"]["fc1"]["kernel"].shape == (23, 1024, 4096)
    assert port["layers.22.mlp.fc1.weight"].shape == (4096, 1024)
    assert port["position_embedding"].shape == shapes["position_embedding"].shape == (577, 1024)
    assert port["patch_embedding.weight"].shape == (1024, 3, 14, 14)


@pytest.fixture(scope="module")
def hf_clip():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    cfg = transformers.CLIPVisionConfig(
        image_size=56, patch_size=14, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, hidden_act="quick_gelu",
        attn_implementation="eager",
    )
    return transformers.CLIPVisionModel(cfg).eval()


def test_tower_matches_hf_clip(hf_clip):
    from phantom_vlb_tpu.models.convert import convert_clip_vision, state_dict_to_numpy

    cfg = tc.CLIPVisionConfig.tiny()
    params = convert_clip_vision(state_dict_to_numpy(hf_clip.state_dict()), cfg.effective_layers)
    tower = port_tower(params, cfg)
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 3, 56, 56)).astype(np.float32))
    with torch.no_grad():
        want = hf_clip(frames, output_hidden_states=True).hidden_states[-2][:, 1:]
        got = tower(frames)
    assert got.shape == want.shape == (3, 16, 64)
    assert _rel(got.numpy(), want.numpy()) <= 2e-4
