"""Port parity: the VLB model from raw frames against the JAX package.

The tiny config (TEST_GEOMETRY: 4 frames of 56 px -> 27 video tokens; the
tiny tower, connector and decoder) in f32 on the CPU, on weights drawn with
numpy from a seed and carried across by ``from_flax_params`` from a Flax
tree initialised on frames, so it holds ``vision_tower`` and
``mm_projector``. Tolerances, as max|err| / max|ref|: 1e-4 for the video
tokens, the predictions (served and through ``predict_batches``), the LoRA
loss and the adapter gradients (f32 towers and a two-layer decoder summed in
another order); the l2 penalty 1e-6 relative (the same f32 weights); a
whole LoRA ``train_step``'s update at 1e-3 x lr plus two ulps per element,
the bound of ``tests/test_torch_train_step.py``. The frames path and the
cached-token path of one port model agree bit for bit.

Also: ``from_flax_params`` consumes every leaf of such a tree and raises on
a stray one, and ``preprocess`` against the JAX ``device_preprocess`` on
non-square uint8 frames (1e-4 absolute on normalised values: both resample
with the same Keys cubic weights, computed in f32 from sample positions
that round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.ops.preprocess import device_preprocess
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu.train.step import (
    _masked_mse,
    combine_params,
    init_train_state,
    make_train_step,
    partition_params,
)
from phantom_vlb_tpu_torch.cli.predict import predict_batches, synthetic_batches
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY, synth_language_row
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params, init_params
from phantom_vlb_tpu_torch.ops.preprocess import preprocess
from phantom_vlb_tpu_torch.train.loop import train_batches
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig
from phantom_vlb_tpu_torch.train.step import loss_fn, train_step

G = TEST_GEOMETRY
TOL = 1e-4
FRAMES = (G.num_frames, 3, G.image_size, G.image_size)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "weight"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("kernel", "lora_a"):
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "lora_b":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(rng, b, row_mask=None):
    rows = [synth_language_row(G, rng, (i + 1) * G.tr) for i in range(b)]
    return {
        "language": np.stack([r[0] for r in rows]).astype(np.int32),
        "vision": rng.standard_normal((b, *FRAMES)).astype(np.float32),
        "padvals": np.stack([r[2] for r in rows]).astype(np.int32),
        "vis_weights": rng.uniform(0, 0.3, (b, G.num_ds_frames)).astype(np.float32),
        "lang_weights": rng.uniform(0, 0.3, (b, G.onsets_width)).astype(np.float32),
        "timeseries": rng.standard_normal((b, G.num_parcels)).astype(np.float32),
        "row_mask": np.ones(b, np.float32) if row_mask is None else np.asarray(row_mask, np.float32),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _args(batch):
    return [batch[k] for k in ("language", "vision", "padvals", "vis_weights", "lang_weights")]


def _pair(use_lora=False, clip_scan=False):
    """(JAX model, its seeded params initialised on frames, port model)."""
    jcfg = jv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0)
    jcfg = dataclasses.replace(jcfg, clip=dataclasses.replace(jcfg.clip, scan_layers=clip_scan))
    jmodel = jv.VideoLLaMA2VLB(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), *_args(_batch(np.random.default_rng(0), 1)))
    params = _leaves(shapes["params"], np.random.default_rng(1))
    port = tv.VideoLLaMA2VLB.from_state_dict(tv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0),
                                             from_flax_params(params))
    return jmodel, params, port


@pytest.fixture(scope="module")
def serve_pair():
    return _pair()


def test_encode_video_matches_jax(serve_pair):
    jmodel, params, port = serve_pair
    frames = np.random.default_rng(2).standard_normal((3, *FRAMES)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(frames), method=jv.VideoLLaMA2VLB.encode_video)
    got = port.encode_video(torch.from_numpy(frames))
    assert not got.requires_grad and got.shape == want.shape == (3, G.num_vis_tokens, 64)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("clip_scan", [False, True], ids=["layers", "layers_scan"])
def test_forward_from_frames_matches_jax(clip_scan):
    jmodel, params, port = _pair(clip_scan=clip_scan)
    assert port.vision_tower is not None
    rng = np.random.default_rng(3)
    batches = [_batch(rng, 3), _batch(rng, 2, [1, 0])]
    preds = []
    for batch in batches:
        pred_j, l2_j = jmodel.apply({"params": params}, *(jnp.asarray(a) for a in _args(batch)))
        with torch.no_grad():
            pred_t, l2_t = port(*_args(_torch(batch)))
        assert pred_t.shape == pred_j.shape
        assert _rel(pred_t.numpy(), pred_j) <= TOL
        np.testing.assert_allclose(l2_t.item(), float(l2_j), rtol=1e-6)
        preds.append(np.asarray(pred_j)[batch["row_mask"] > 0])
    served = predict_batches(port, batches, device="cpu")
    assert served["predicted"].shape == (4, G.num_parcels)
    assert _rel(served["predicted"], np.concatenate(preds)) <= TOL


def test_frames_and_cached_tokens_give_the_same_predictions(serve_pair):
    _, _, port = serve_pair
    batch = _torch(_batch(np.random.default_rng(4), 2))
    tokens = port.encode_video(batch["vision"])
    with torch.no_grad():
        from_frames, _ = port(*_args(batch))
        from_tokens, _ = port(*_args(dict(batch, vision=tokens)))
    assert torch.equal(from_frames, from_tokens)


def test_lora_loss_and_adapter_grads_from_frames_match_jax():
    """One tiny LoRA step's loss and every trainable gradient (adapters and
    head) from frames, against ``jax.value_and_grad`` of the reference's
    loss; the towers get no gradient."""
    jmodel, params, port = _pair(use_lora=True)
    batch = _batch(np.random.default_rng(5), 3, [1, 1, 0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    labels = joptim.trainable_labels(params, jv.trainable_predicate)
    trainable, frozen = partition_params(params, labels)
    forward = jv.vlb_forward_fn(jmodel)

    def jloss(tr):
        pred, l2 = forward(combine_params(tr, frozen), jb, jax.random.key(0), True)
        return _masked_mse(pred, jb["timeseries"], jb["row_mask"]) + l2

    loss_j, grads_j = jax.value_and_grad(jloss)(trainable)
    full = jax.tree.map(lambda g, p: np.asarray(np.zeros_like(p) if g is None else g), grads_j, params,
                        is_leaf=lambda x: x is None)
    grads_j = from_flax_params(full)
    trained = tv.trainable_parameters(port)
    port.train()
    loss_t = loss_fn(port, _torch(batch), seed=0)[0]
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    names = [n for n, p in port.named_parameters() if p.requires_grad]
    assert len(trained) == len(names) and any("lora_" in n for n in names)
    for name, p in port.named_parameters():
        if name in names:
            assert _rel(p.grad.numpy(), grads_j[name].numpy()) <= TOL, name
        else:
            assert p.grad is None, name
    assert not any(n.startswith(tv.VISION_PREFIXES) for n in names)


def test_lora_train_step_from_frames_matches_jax():
    """One whole LoRA ``train_step`` from frames (forward, backward, clip,
    AdamW) against ``make_train_step``: the loss at 1e-4 relative, and each
    trainable parameter's update at 1e-3 x lr plus two f32 ulps of it, the
    bound of ``tests/test_torch_train_step.py`` (Adam's first step is lr x
    g / (|g| + eps)); nothing else moves."""
    jmodel, params, port = _pair(use_lora=True)
    batch = _batch(np.random.default_rng(6), 2)
    labels = joptim.trainable_labels(params, jv.trainable_predicate)
    tx = joptim.make_optimizer(joptim.OptimConfig())
    state, frozen = init_train_state(params, tx, labels)
    step = make_train_step(jv.vlb_forward_fn(jmodel), tx, labels, donate=False)
    new_state, metrics = step(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(0))
    full = jax.tree.map(lambda t, p: np.asarray(p if t is None else t), new_state.params, params,
                        is_leaf=lambda x: x is None)
    want, before = from_flax_params(full), from_flax_params(params)
    optimizer = AdamWCosine(tv.trainable_parameters(port), OptimConfig())
    port.train()
    out = train_step(port, optimizer, _torch(batch), seed=0)
    assert out["finite"] and abs(out["brain_loss"].item() - float(metrics["brain_loss"])) <= TOL * abs(
        float(metrics["brain_loss"]))
    lr = OptimConfig().lr
    for name, p in port.named_parameters():
        delta = (p.detach() - before[name]).numpy()
        if p.requires_grad:
            ulps = 2 * np.spacing(np.abs(before[name].numpy()).max())
            np.testing.assert_allclose(delta, (want[name] - before[name]).numpy(), atol=1e-3 * lr + ulps,
                                       rtol=0, err_msg=name)
        else:
            assert not delta.any(), name


def test_train_batches_from_frames_on_the_cpu():
    cfg = tv.VLBConfig.tiny(use_lora=True)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, "cpu", torch.Generator().manual_seed(0)))
    batches = synthetic_batches(cfg, 2, 2, np.random.default_rng(0), torch.Generator().manual_seed(0),
                                "cpu", frames=True)
    assert batches[0]["vision"].shape == (2, *FRAMES) and batches[0]["vision"].dtype == torch.float32
    optimizer = AdamWCosine(tv.trainable_parameters(model))
    res = train_batches(model, batches, device="cpu", generator=torch.Generator().manual_seed(0),
                        optimizer=optimizer)
    assert res["finite"].all() and optimizer.step == 2
    tower = [p for n, p in model.named_parameters() if n.startswith(tv.VISION_PREFIXES)]
    assert tower and all(p.grad is None and not p.requires_grad for p in tower)


def test_from_flax_params_consumes_every_vision_leaf(serve_pair):
    _, params, port = serve_pair
    sd = from_flax_params(params)
    n_leaves = len(jax.tree.leaves(params))
    assert sd.keys() == port.state_dict().keys() and len(sd) == n_leaves
    assert sum(k.startswith(tv.VISION_PREFIXES) for k in sd) == n_leaves - sum(
        len(jax.tree.leaves(params[k])) for k in ("model", "head"))
    np.testing.assert_array_equal(sd["mm_projector.s1.b1.conv2.weight"].numpy(),
                                  params["mm_projector"]["s1"]["b1"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["mm_projector.sampler_conv.weight"].numpy(),
                                  params["mm_projector"]["sampler_conv"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["mm_projector.readout.1.weight"].numpy(),
                                  params["mm_projector"]["readout_1"]["kernel"].T)


@pytest.mark.parametrize("where,leaf", [
    (("vision_tower",), "post_layernorm"),
    (("vision_tower", "layers_0", "self_attn"), "rotary"),
    (("mm_projector", "s1", "b1"), "bn_running_mean"),
    (("mm_projector", "s2", "b1", "norm1", "LayerNorm_0"), "mean"),
])
def test_stray_vision_leaf_raises(serve_pair, where, leaf):
    _, params, _ = serve_pair
    tree = jax.tree.map(lambda x: x, params)          # a copy we may edit
    node = tree
    for k in where:
        node = node[k]
    node[leaf] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        from_flax_params(tree)


@pytest.mark.parametrize("h,w,size", [(45, 80, 56), (120, 70, 56), (240, 320, 336)])
def test_preprocess_matches_device_preprocess(h, w, size):
    frames = np.random.default_rng(h).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    want = device_preprocess(frames, size)
    got = preprocess(frames, size, device="cpu")
    assert got.shape == want.shape == (3, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
