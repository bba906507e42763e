"""Port parity: the train step against the JAX package at the tiny config.

Both regimes (LoRA: head + adapters train; frozen baseline: the head alone),
with head and adapter dropout at 0 so both sides compute the same function:
the loss and every trainable gradient against ``jax.value_and_grad`` of the
reference's loss, and the trainable parameters after one update against
``make_train_step`` with ``make_optimizer``. Weights are seeded numpy leaves
carried across by ``from_flax_params``; batches are drawn with numpy.
Tolerances (all f32): loss 1e-5 relative; gradients 1e-4 x max|g| (a
two-layer stack and an f32 head, summed in another order); the update
1e-3 x lr per element (Adam's first step is lr x g/(|g| + eps), so only the
gradient's sign and size relative to eps matter) plus two f32 ulps of the
parameter, at whose magnitude the updated value is rounded.

Also: the cosine schedule past ``t_max``, optax's clip formula, a NaN loss
leaving the state untouched, and per-layer checkpointing giving the same
gradients as none with adapter dropout live (masks from per-site seeds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu.train.step import (
    _masked_mse,
    combine_params,
    init_train_state,
    make_train_step,
    partition_params,
)
from phantom_vlb_tpu_torch.cli.predict import synthetic_batches
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY, synth_language_row
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params, init_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig
from phantom_vlb_tpu_torch.train.loop import train_batches
from phantom_vlb_tpu_torch.train.optim import (
    AdamWCosine,
    OptimConfig,
    clip_by_global_norm_,
    learning_rate,
)
from phantom_vlb_tpu_torch.train.step import loss_fn, train_step

G = TEST_GEOMETRY
E = 64
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-3


def _randomize(tree, rng, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, path + (k,))
        elif k in ("weight", "scale"):
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("kernel", "lora_a"):
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
        elif k == "lora_b":
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _batch(rng, b, row_mask=None):
    rows = [synth_language_row(G, rng, (i + 1) * G.tr) for i in range(b)]
    return {
        "language": np.stack([r[0] for r in rows]).astype(np.int32),
        "vision": rng.standard_normal((b, G.num_vis_tokens, E)).astype(np.float32),
        "padvals": np.stack([r[2] for r in rows]).astype(np.int32),
        "vis_weights": rng.uniform(0, 0.3, (b, G.num_ds_frames)).astype(np.float32),
        "lang_weights": rng.uniform(0, 0.3, (b, G.onsets_width)).astype(np.float32),
        "timeseries": rng.standard_normal((b, G.num_parcels)).astype(np.float32),
        "row_mask": np.ones(b, np.float32) if row_mask is None else np.asarray(row_mask, np.float32),
    }


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(use_lora):
    """(JAX model, its seeded params, port config) without dropout."""
    jcfg = jv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0)
    jmodel = jv.VideoLLaMA2VLB(jcfg)
    b = _batch(np.random.default_rng(10), 1)
    params = jax.eval_shape(jmodel.init, jax.random.key(0), b["language"], b["vision"], b["padvals"],
                            b["vis_weights"], b["lang_weights"])["params"]
    params = _randomize(params, np.random.default_rng(11))
    return jmodel, params, tv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0)


def _port_model(cfg, params):
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, from_flax_params(params))
    trainable = tv.trainable_parameters(model)
    model.train()
    return model, trainable


def _labels(params):
    return joptim.trainable_labels(params, jv.trainable_predicate)


def _as_state_dict(tree, params):
    """A trainable subtree (None where frozen) as port names, frozen filled in."""
    full = jax.tree.map(lambda t, p: np.asarray(p if t is None else t), tree, params,
                        is_leaf=lambda x: x is None)
    return from_flax_params(full)


@pytest.mark.parametrize("use_lora", [True, False], ids=["lora", "baseline"])
def test_loss_and_grads_match_jax(use_lora):
    jmodel, params, cfg = _pair(use_lora)
    batch = _batch(np.random.default_rng(12), 3, [1, 1, 0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    trainable, frozen = partition_params(params, _labels(params))
    forward = jv.vlb_forward_fn(jmodel)

    def jloss(tr):
        pred, l2 = forward(combine_params(tr, frozen), jb, jax.random.key(0), True)
        return _masked_mse(pred, jb["timeseries"], jb["row_mask"]) + l2

    loss_j, grads_j = jax.value_and_grad(jloss)(trainable)
    grads_j = _as_state_dict(grads_j, jax.tree.map(np.zeros_like, params))

    model, trainable_t = _port_model(cfg, params)
    loss_t = loss_fn(model, _torch(batch), seed=0)[0]
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_TOL)
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    assert names == {n for n in grads_j if tv.trainable_predicate(n)}
    assert any("lora_" in n for n in names) == use_lora
    assert len(trainable_t) == len(names)
    for name, p in model.named_parameters():
        if name in names:
            want = grads_j[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, atol=GRAD_TOL * np.abs(want).max(),
                                       rtol=0, err_msg=name)
        else:
            assert p.grad is None, name


@pytest.mark.parametrize("use_lora", [True, False], ids=["lora", "baseline"])
def test_one_update_matches_jax(use_lora):
    jmodel, params, cfg = _pair(use_lora)
    batch = _batch(np.random.default_rng(13), 3)
    labels = _labels(params)
    tx = joptim.make_optimizer(joptim.OptimConfig())
    state, frozen = init_train_state(params, tx, labels)
    step = make_train_step(jv.vlb_forward_fn(jmodel), tx, labels, donate=False)
    new_state, metrics = step(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.key(0))
    want = _as_state_dict(new_state.params, params)
    before = from_flax_params(params)

    model, trainable = _port_model(cfg, params)
    optimizer = AdamWCosine(trainable, OptimConfig())
    out = train_step(model, optimizer, _torch(batch), seed=0)
    assert out["finite"] and optimizer.step == 1 and out["lr"] == OptimConfig().lr
    np.testing.assert_allclose(out["brain_loss"].item(), float(metrics["brain_loss"]), rtol=LOSS_TOL)
    for name, p in model.named_parameters():
        if p.requires_grad:
            delta_t = (p.detach() - before[name]).numpy()
            delta_j = (want[name] - before[name]).numpy()
            assert np.abs(delta_j).max() > 0, name
            ulps = 2 * np.spacing(np.abs(before[name].numpy()).max())
            np.testing.assert_allclose(delta_t, delta_j, atol=UPDATE_TOL * OptimConfig().lr + ulps,
                                       rtol=0, err_msg=name)
        else:
            assert torch.equal(p.detach(), before[name].to(p.dtype)), name


def test_cosine_schedule_is_torchs_periodic_form():
    cfg = OptimConfig(t_max=100)
    jsched = joptim.make_schedule(joptim.OptimConfig(t_max=100))
    for t in (0, 1, 37, 50, 100, 150, 199, 200, 275):
        np.testing.assert_allclose(learning_rate(cfg, t), float(jsched(t)), rtol=1e-6, atol=1e-12)
    assert learning_rate(cfg, 100) == 0.0 and learning_rate(cfg, 150) > 0.0     # not clamped
    assert learning_rate(cfg, 200) == pytest.approx(cfg.lr)
    assert learning_rate(dataclasses.replace(cfg, lr_scheduler_name="constant"), 77) == cfg.lr


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "above"])
def test_clip_is_optax_global_norm(scale):
    rng = np.random.default_rng(3)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 1.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if scale < 1:
        assert all(np.array_equal(g.numpy(), h) for g, h in zip(got, grads))     # untouched


def test_non_finite_loss_leaves_the_state_untouched():
    _, params, cfg = _pair(True)
    model, trainable = _port_model(cfg, params)
    optimizer = AdamWCosine(trainable, OptimConfig())
    good = _torch(_batch(np.random.default_rng(14), 2))
    assert train_step(model, optimizer, good, seed=0)["finite"]
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {id(p): {k: v.clone() for k, v in optimizer.adamw.state[p].items()} for p in trainable}
    bad = dict(good, timeseries=torch.full_like(good["timeseries"], float("nan")))
    out = train_step(model, optimizer, bad, seed=1)
    assert not out["finite"] and "lr" not in out and optimizer.step == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), snapshot[n]), n
    for p in trainable:
        for k, v in optimizer.adamw.state[p].items():
            assert torch.equal(v, moments[id(p)][k]), k
    assert train_step(model, optimizer, good, seed=2)["finite"] and optimizer.step == 2


@pytest.mark.parametrize(
    "bits,fused,shared",
    [(32, False, False), (8, False, False), (8, False, True), (8, True, False)],
    ids=["bernoulli", "u8", "u8_shared", "fused_plain"],
)
def test_remat_gives_the_same_gradients_with_dropout(bits, fused, shared):
    """Per-layer checkpointing replays each layer in the backward; its
    dropout masks must be the ones the forward drew."""
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.3, dropout_bits=bits, fused_dropout=fused,
                      shared_dropout=shared)
    grads = {}
    for remat, p in ((False, 0.3), (True, 0.3), (False, 0.0)):
        base = tv.VLBConfig.tiny(use_lora=True, dropout_rate=0.0)
        cfg = dataclasses.replace(base, mistral=dataclasses.replace(
            base.mistral, lora=dataclasses.replace(lora, dropout=p), remat=remat))
        sd = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
        for key in sd:
            if key.endswith("lora_b"):
                sd[key] = 0.1 * torch.randn(sd[key].shape, generator=torch.Generator().manual_seed(1))
        model = tv.VideoLLaMA2VLB.from_state_dict(cfg, sd)
        tv.trainable_parameters(model)
        model.train()
        batch = synthetic_batches(cfg, 1, 2, np.random.default_rng(0), torch.Generator().manual_seed(0),
                                  "cpu")[0]
        loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()}, seed=123)[0].backward()
        grads[(remat, p)] = {n: q.grad for n, q in model.named_parameters() if q.requires_grad}
    off, on, none = grads[(False, 0.3)], grads[(True, 0.3)], grads[(False, 0.0)]
    assert all(torch.equal(off[n], on[n]) for n in off)
    assert any(not torch.allclose(off[n], none[n]) for n in off)         # dropout was live


@pytest.mark.parametrize("kwargs", [{"base_quant": "int4"}, {"fused_epilogue": "triton"}],
                         ids=["int8_base", "fused_epilogue"])
def test_later_slice_modes_raise(kwargs):
    """The int8 base and the fused epilogue came with slice 3; a mode that
    neither the port nor the reference has still raises."""
    from phantom_vlb_tpu_torch.models.lora import LoRALinear

    lora = LoRAConfig(fused_epilogue=kwargs.get("fused_epilogue", ""))
    with pytest.raises(ValueError, match=next(iter(kwargs))):
        LoRALinear(64, 64, lora, base_quant=kwargs.get("base_quant"))


def test_train_mode_needs_a_seed():
    cfg = tv.VLBConfig.tiny(use_lora=True)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, "cpu", torch.Generator().manual_seed(0)))
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batches(
        cfg, 1, 1, np.random.default_rng(0), torch.Generator().manual_seed(0), "cpu")[0].items()}
    loss_fn(model, batch)                                      # eval mode: no seed needed
    model.train()
    with pytest.raises(ValueError, match="seed"):
        loss_fn(model, batch)


def test_train_batches_on_the_cpu():
    cfg = tv.VLBConfig.tiny(use_lora=True)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, "cpu", torch.Generator().manual_seed(0)))
    batches = synthetic_batches(cfg, 3, 2, np.random.default_rng(0), torch.Generator().manual_seed(0), "cpu")
    optimizer = AdamWCosine(tv.trainable_parameters(model))
    res = train_batches(model, batches, device="cpu", generator=torch.Generator().manual_seed(0),
                        optimizer=optimizer)
    assert res["step_ms"].shape == res["brain_loss"].shape == res["grad_norm"].shape == (3,)
    assert np.isfinite(res["brain_loss"]).all() and res["finite"].all() and optimizer.step == 3
    assert model.training
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained and all(tv.trainable_predicate(n) for n in trained)
