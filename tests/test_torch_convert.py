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
    tree = dict(flax_tree, vision_tower={"x": {"kernel": np.zeros((2, 2))}},
                mm_projector={"y": {"bias": np.zeros(2)}})
    assert from_flax_params(tree).keys() == from_flax_params(flax_tree).keys()


@pytest.mark.parametrize(
    "where,leaf",
    [
        (("model", "layers_1", "self_attn", "q_proj"), "lora_a"),
        (("model", "layers_1", "mlp", "down_proj"), "lora_b"),
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
    with pytest.raises(ValueError, match="LoRA slice" if leaf.startswith("lora") else "unconsumed"):
        from_flax_params(tree)


def test_init_params_dtypes_and_shapes():
    cfg = tv.VLBConfig.tiny(mistral=tv.MistralConfig.tiny(vocab_size=1000, dtype=torch.bfloat16))
    sd = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    again = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, sd)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.startswith("head.") else torch.bfloat16), name
        assert p.data_ptr() == sd[name].data_ptr(), name      # assigned, not copied
        assert torch.equal(sd[name], again[name]), name       # seeded
    assert torch.all(sd["model.norm.weight"] == 1)
    assert 0.015 < sd["model.layers.0.mlp.up_proj.weight"].float().std() < 0.025
