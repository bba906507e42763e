"""Port: weights carried across from the JAX package's Flax tree, and random
weights made for a config, checked at the tiny config on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.models.convert import stack_layer_params
from phantom_vlb_tpu_torch.core.geometry import VIDEO_TOKEN_ID
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params, init_params
from phantom_vlb_tpu_torch.models.lora import lora_merge

LAYERS = 4


@pytest.fixture(scope="module")
def flax_tree():
    """Unrolled Flax params of a 4-layer tiny VLB, as seeded numpy leaves."""
    cfg = jv.VLBConfig.tiny()
    cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, num_hidden_layers=LAYERS))
    g = cfg.geometry
    lang = np.ones((1, g.max_lang_tokens), np.int32)
    lang[0, 3] = VIDEO_TOKEN_ID
    shapes = jax.eval_shape(
        jv.VideoLLaMA2VLB(cfg).init,
        jax.random.key(0), lang, np.zeros((1, g.num_vis_tokens, 64), np.float32),
        np.zeros((1, 3), np.int32), np.zeros((1, g.num_ds_frames), np.float32),
        np.zeros((1, g.onsets_width), np.float32),
    )["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _port_config():
    return tv.VLBConfig.tiny(mistral=tv.MistralConfig.tiny(vocab_size=1000, num_hidden_layers=LAYERS))


def test_unrolled_tree_loads_strictly(flax_tree):
    sd = from_flax_params(flax_tree)
    model = tv.VideoLLaMA2VLB.from_state_dict(_port_config(), sd)
    q = flax_tree["model"]["layers_2"]["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(model.model.layers[2].self_attn.q_proj.weight.numpy(), q.T)
    np.testing.assert_array_equal(model.model.embed_tokens.weight.numpy(),
                                  flax_tree["model"]["embed_tokens"]["embedding"])
    np.testing.assert_array_equal(model.head.layer_norm1.weight.numpy(),
                                  flax_tree["head"]["layer_norm1"]["scale"])
    np.testing.assert_array_equal(model.head.ridge.linear.weight.numpy(),
                                  flax_tree["head"]["ridge"]["linear"]["kernel"].T)


@pytest.mark.parametrize("group", [1, 2])
def test_scan_tree_gives_the_same_state_dict(flax_tree, group):
    unrolled = from_flax_params(flax_tree)
    scanned = dict(flax_tree, model=stack_layer_params(flax_tree["model"], LAYERS, group=group))
    assert "layers_scan" in scanned["model"] and "layers_0" not in scanned["model"]
    sd = from_flax_params(scanned)
    assert sd.keys() == unrolled.keys()
    for k in sd:
        assert torch.equal(sd[k], unrolled[k]), k


def test_vision_subtrees_are_set_aside(flax_tree):
    """Nothing of the vision path is set aside any more: a tree made on
    cached tokens has no vision subtree and gives no vision key, and a leaf
    under ``vision_tower`` or ``mm_projector`` that the towers do not have
    raises like any other."""
    assert not any(k.startswith(("vision_tower.", "mm_projector.")) for k in from_flax_params(flax_tree))
    for subtree in ("vision_tower", "mm_projector"):
        tree = dict(flax_tree, **{subtree: {"x": {"kernel": np.zeros((2, 2))}}})
        with pytest.raises(ValueError, match="unconsumed"):
            from_flax_params(tree)


@pytest.mark.parametrize(
    "where,leaf",
    [
        (("model", "layers_1", "self_attn"), "rotary"),
        (("head",), "extra"),
        (("model",), "lm_head"),
    ],
)
def test_unknown_key_raises(flax_tree, where, leaf):
    tree = jax.tree.map(lambda x: x, flax_tree)     # a copy we may edit
    node = tree
    for k in where:
        node = node[k]
    node[leaf] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        from_flax_params(tree)


@pytest.fixture(scope="module")
def lora_pair():
    """A 4-layer tiny LoRA VLB: (JAX config, seeded unrolled Flax params, a batch)."""
    cfg = jv.VLBConfig.tiny(use_lora=True)
    cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, num_hidden_layers=LAYERS))
    rng = np.random.default_rng(1)
    g = cfg.geometry
    lang = rng.integers(3, 1000, (2, g.max_lang_tokens)).astype(np.int32)
    lang[:, 5] = VIDEO_TOKEN_ID
    lang[1, -7:] = 0                                 # right padding
    batch = (lang, rng.standard_normal((2, g.num_vis_tokens, 64)).astype(np.float32),
             np.array([[7, 4, 10], [0, 4, 12]], np.int32),
             rng.uniform(0, 0.3, (2, g.num_ds_frames)).astype(np.float32),
             rng.uniform(0, 0.3, (2, g.onsets_width)).astype(np.float32))
    shapes = jax.eval_shape(jv.VideoLLaMA2VLB(cfg).init, jax.random.key(0), *batch)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name in ("weight", "scale"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "lora_b":
            return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)

    return cfg, jax.tree_util.tree_map_with_path(leaf, shapes), batch


@pytest.mark.parametrize("form", ["unrolled", "layers_scan", "layers_scan_group_2"])
def test_lora_leaves_convert_and_reproduce_the_jax_forward(lora_pair, form):
    """LoRA ``lora_a`` (in, r) / ``lora_b`` (r, out) load as they are from
    either tree form, and the port's LoRA model then matches the JAX LoRA
    forward (eval mode, f32; 1e-4 as the serving parity test)."""
    cfg, params, batch = lora_pair
    tree, jcfg = params, cfg
    if form != "unrolled":
        group = 2 if form.endswith("2") else 1
        tree = dict(params, model=stack_layer_params(params["model"], LAYERS, group=group))
        jcfg = dataclasses.replace(cfg, mistral=dataclasses.replace(
            cfg.mistral, scan_layers=True, scan_group=group))
    sd = from_flax_params(tree)
    lora_keys = [k for k in sd if k.endswith((".lora_a", ".lora_b"))]
    assert len(lora_keys) == 2 * 7 * LAYERS
    a = params["model"]["layers_3"]["mlp"]["down_proj"]["lora_a"]
    np.testing.assert_array_equal(sd["model.layers.3.mlp.down_proj.lora_a"].numpy(), a)
    port_cfg = tv.VLBConfig.tiny(use_lora=True, mistral=tv.MistralConfig.tiny(
        vocab_size=1000, num_hidden_layers=LAYERS, lora=tv.LoRAConfig(rank=4, alpha=8.0, dropout=0.0)))
    model = tv.VideoLLaMA2VLB.from_state_dict(port_cfg, sd)
    assert model.model.layers[3].mlp.down_proj.lora_a.dtype == torch.float32
    pred_j, l2_j = jv.VideoLLaMA2VLB(jcfg).apply({"params": tree}, *batch)
    with torch.no_grad():
        pred_t, l2_t = model(*(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(l2_t.item(), float(l2_j), rtol=1e-6)


def test_lora_merge_matches_jax(lora_pair):
    """Adapters folded into the base weights as the reference folds them;
    the merged plain model gives the LoRA model's forward."""
    from phantom_vlb_tpu.models.lora import lora_merge as j_merge

    cfg, params, batch = lora_pair
    scaling = cfg.mistral.lora.scaling
    merged = lora_merge(from_flax_params(params), scaling)
    want = from_flax_params(j_merge(params, scaling))
    assert merged.keys() == want.keys() and not any("lora_" in k for k in merged)
    for k in want:
        torch.testing.assert_close(merged[k], want[k], atol=1e-6, rtol=1e-6)
    plain_cfg = tv.VLBConfig.tiny(mistral=tv.MistralConfig.tiny(vocab_size=1000, num_hidden_layers=LAYERS))
    lora_cfg = tv.VLBConfig.tiny(use_lora=True, mistral=tv.MistralConfig.tiny(
        vocab_size=1000, num_hidden_layers=LAYERS, lora=tv.LoRAConfig(rank=4, alpha=8.0, dropout=0.0)))
    args = [torch.from_numpy(x) for x in batch]
    with torch.no_grad():
        pred_m, _ = tv.VideoLLaMA2VLB.from_state_dict(plain_cfg, merged)(*args)
        pred_l, _ = tv.VideoLLaMA2VLB.from_state_dict(lora_cfg, from_flax_params(params))(*args)
    torch.testing.assert_close(pred_m, pred_l, atol=1e-4, rtol=0)


def _bf16_round_once(v: np.ndarray) -> np.ndarray:
    """f64 values rounded once to bf16's 8 significant bits, half to even
    (normal numbers), as f32."""
    m, e = np.frexp(v)
    return np.ldexp(np.round(m * 256.0) / 256.0, e).astype(np.float32)


def test_lora_merge_in_bf16_rounds_once(lora_pair):
    """A bf16 base (as the port stores it at full width) with f32 adapters:
    each merged weight is w + s * (A B)^T rounded once to bf16, bit for bit
    (0 ulp); adding in f32 and then casting would round twice."""
    cfg, params, _ = lora_pair
    scaling = cfg.mistral.lora.scaling
    sd = {k: (v.to(torch.bfloat16) if k.endswith("proj.weight") else v)
          for k, v in from_flax_params(params).items()}
    merged = lora_merge(sd, scaling)
    n = twice_off = 0
    for key, w in sd.items():
        if not key.endswith("proj.weight"):
            continue
        base = key[: -len(".weight")]
        a, b = (sd[f"{base}.lora_{x}"].double().numpy() for x in "ab")
        want = _bf16_round_once(w.double().numpy() + scaling * (a @ b).T)
        got = merged[key]
        assert got.dtype == torch.bfloat16 and f"{base}.lora_a" not in merged
        np.testing.assert_array_equal(got.float().numpy(), want)
        a32, b32 = (sd[f"{base}.lora_{x}"].float() for x in "ab")
        twice = (w.float() + scaling * (a32 @ b32).T).to(torch.bfloat16)
        twice_off += int((twice.float().numpy() != want).sum())
        n += w.numel()
    # The data reaches the double-rounding case: f32 then bf16 misses the
    # one-rounding merge somewhere (at 9 of the 147,456 elements when this
    # test was written; the count depends on the f32 product's sum order).
    assert n == 147456 and twice_off > 0


def test_lora_merge_leaves_a_quantized_base_unmerged(lora_pair):
    """Adapters on an int8 base stay, as the reference merges only where
    ``kernel`` is present; the merge then changes nothing."""
    from phantom_vlb_tpu.models.lora import lora_merge as j_merge
    from phantom_vlb_tpu.ops.quant import quantize_tree

    cfg, params, _ = lora_pair
    tree = quantize_tree(params, lambda p, w: "proj" in p)
    merged = lora_merge(from_flax_params(tree), cfg.mistral.lora.scaling)
    want = from_flax_params(j_merge(tree, cfg.mistral.lora.scaling))
    assert merged.keys() == want.keys()
    assert sum(k.endswith(".lora_a") for k in merged) == 7 * LAYERS
    assert sum(k.endswith(".weight_q") for k in merged) == 7 * LAYERS
    for k in want:
        assert torch.equal(merged[k], want[k]), k


def test_init_params_dtypes_and_shapes():
    """A bf16 decoder with the tiny f32 towers: the head and the towers in
    f32, the decoder in bf16."""
    cfg = tv.VLBConfig.tiny(mistral=tv.MistralConfig.tiny(vocab_size=1000, dtype=torch.bfloat16))
    sd = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    again = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, sd)
    for name, p in model.named_parameters():
        f32 = name.startswith(("head.", "vision_tower.", "mm_projector."))
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert p.data_ptr() == sd[name].data_ptr(), name      # assigned, not copied
        assert torch.equal(sd[name], again[name]), name       # seeded
    assert torch.all(sd["model.norm.weight"] == 1)
    assert 0.015 < sd["model.layers.0.mlp.up_proj.weight"].float().std() < 0.025
