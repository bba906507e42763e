"""Port parity: the VLB serving path against the JAX package at the tiny config.

Splice, HRF weight mask, readout head, synthetic rows, streaming Pearson, and
the whole tiny forward + eval step (JAX with the Pallas flash kernel in
interpret mode; the port with its plain attention). Inputs and weights are
drawn with numpy from a seed and handed to both sides. Tolerances: exact for
integer/gather results; 1e-5 for single f32 modules; 1e-4 for the whole
forward, loss and Pearson r (a 2-layer stack, a LayerNorm'd pooled head and
a ratio of sums, all f32 in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.data.synthetic import synth_language_row as j_synth_row
from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.models.heads import BrainReadoutHead as JHead
from phantom_vlb_tpu.ops.weight_mask import build_weight_mask as j_weight_mask
from phantom_vlb_tpu.train import metrics as jmetrics
from phantom_vlb_tpu.train.step import make_eval_step
from phantom_vlb_tpu_torch.cli.predict import predict_batches
from phantom_vlb_tpu_torch.core.geometry import REFERENCE_GEOMETRY, VIDEO_TOKEN_ID
from phantom_vlb_tpu_torch.data.synthetic import TEST_GEOMETRY, synth_language_row
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params, init_params
from phantom_vlb_tpu_torch.models.heads import BrainReadoutHead
from phantom_vlb_tpu_torch.ops.weight_mask import build_weight_mask
from phantom_vlb_tpu_torch.train import metrics as tmetrics
from phantom_vlb_tpu_torch.train.step import eval_step

G = TEST_GEOMETRY
E = 64


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("weight", "scale"):
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
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


def test_geometry_matches_reference():
    from phantom_vlb_tpu.core import geometry as jg
    from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY as J_TEST

    assert VIDEO_TOKEN_ID == jg.VIDEO_TOKEN_ID
    for tg, jgeo in ((REFERENCE_GEOMETRY, jg.REFERENCE_GEOMETRY), (G, J_TEST)):
        assert dataclasses.asdict(tg) == dataclasses.asdict(jgeo)
        for prop in ("num_vis_tokens", "max_lang_tokens", "feature_len", "tokens_per_frame",
                     "num_ds_frames"):
            assert getattr(tg, prop) == getattr(jgeo, prop)
    assert (REFERENCE_GEOMETRY.num_vis_tokens, REFERENCE_GEOMETRY.max_lang_tokens,
            REFERENCE_GEOMETRY.feature_len) == (1183, 866, 2048)


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_language_row_same_stream(seed):
    a = synth_language_row(REFERENCE_GEOMETRY, np.random.default_rng(seed), 7.0)
    b = j_synth_row(REFERENCE_GEOMETRY, np.random.default_rng(seed), 7.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_splice_multimodal():
    rng = np.random.default_rng(0)
    b, lt, v = 3, 12, 5
    ids = rng.integers(1, 50, (b, lt))
    ids[0, 3] = ids[1, 0] = ids[2, 11] = VIDEO_TOKEN_ID
    ids[0, -2:] = 0                      # right padding
    ids[1, 6] = 0                        # a genuine id 0 is masked too
    text = rng.standard_normal((b, lt, E)).astype(np.float32)
    vid = rng.standard_normal((b, v, E)).astype(np.float32)
    ej, vj = jv.splice_multimodal(jnp.asarray(text), jnp.asarray(ids), jnp.asarray(vid))
    et, vt = tv.splice_multimodal(torch.from_numpy(text), torch.from_numpy(ids), torch.from_numpy(vid))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("geom", [G, REFERENCE_GEOMETRY], ids=["tiny", "reference"])
def test_build_weight_mask(geom):
    rng = np.random.default_rng(1)
    rows = [synth_language_row(geom, rng, 10.0) for _ in range(4)]
    padvals = np.stack([r[2] for r in rows])
    vis = rng.uniform(0, 1, (4, geom.num_ds_frames)).astype(np.float32)
    lang = rng.uniform(0, 1, (4, geom.onsets_width)).astype(np.float32)
    ref = j_weight_mask(jnp.asarray(padvals), jnp.asarray(vis), jnp.asarray(lang), geom)
    out = build_weight_mask(torch.from_numpy(padvals), torch.from_numpy(vis), torch.from_numpy(lang), geom)
    assert out.shape == (4, geom.feature_len)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_head():
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 64, E)).astype(np.float32)
    wmask = rng.uniform(0, 0.3, (3, 64)).astype(np.float32)
    jhead = JHead(hidden_size=E, num_target=8)
    params = _randomize(jax.eval_shape(jhead.init, jax.random.key(0), hidden, wmask)["params"], rng)
    head = BrainReadoutHead(E, 8)
    head.load_state_dict({k[len("head."):]: v for k, v in from_flax_params({"head": params}).items()})
    with torch.no_grad():
        pt, l2t = head.eval()(torch.from_numpy(hidden).bfloat16(), torch.from_numpy(wmask))
    hb = np.asarray(jnp.asarray(hidden, jnp.bfloat16))     # the head upcasts a bf16 backbone
    pj, l2j = jhead.apply({"params": params}, hb, wmask)
    assert pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(l2t.item(), float(l2j), rtol=1e-6)


def test_pearson_streaming():
    rng = np.random.default_rng(3)
    js, ts = jmetrics.pearson_init(6), tmetrics.pearson_init(6)
    for rows in ([1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 0]):
        x = rng.standard_normal((4, 6)).astype(np.float32)
        y = (x + rng.standard_normal((4, 6))).astype(np.float32)
        m = np.asarray(rows, np.float32)
        js = jmetrics.pearson_update(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
        ts = tmetrics.pearson_update(ts, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    for f in dataclasses.fields(tmetrics.PearsonState):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tmetrics.pearson_compute(ts).numpy(),
                               np.asarray(jmetrics.pearson_compute(js)), atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, its params, port model) with the same seeded weights."""
    jcfg = jv.VLBConfig.tiny()
    jcfg = dataclasses.replace(jcfg, mistral=dataclasses.replace(jcfg.mistral, attention_impl="pallas"))
    jmodel = jv.VideoLLaMA2VLB(jcfg)
    b = _batch(np.random.default_rng(10), 2)
    params = jax.eval_shape(jmodel.init, jax.random.key(0), b["language"], b["vision"],
                            b["padvals"], b["vis_weights"], b["lang_weights"])["params"]
    params = _randomize(params, np.random.default_rng(11))
    port = tv.VideoLLaMA2VLB.from_state_dict(tv.VLBConfig.tiny(), from_flax_params(params))
    return jmodel, params, port


def test_tiny_forward_and_eval_step(tiny_pair):
    jmodel, params, port = tiny_pair
    jstep = make_eval_step(jv.vlb_forward_fn(jmodel))
    forward = jax.jit(jv.vlb_forward_fn(jmodel), static_argnums=3)
    rng = np.random.default_rng(12)
    jp, tp = jmetrics.pearson_init(G.num_parcels), tmetrics.pearson_init(G.num_parcels)
    for row_mask in ([1, 1, 1], [1, 0, 1]):
        batch = _batch(rng, 3, row_mask)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        pred_j, l2_j = forward(params, jb, jax.random.key(0), False)
        jp, jm = jstep(params, jb, jp, jax.random.key(0))
        tp, tm = eval_step(port, _torch(batch), tp)
        assert tm["pred"].shape == (3, G.num_parcels)
        np.testing.assert_allclose(tm["pred"].numpy(), np.asarray(pred_j), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tm["brain_loss"].item(), float(jm["brain_loss"]), atol=1e-4, rtol=0)
        assert tm["n"].item() == float(jm["n"])
    np.testing.assert_allclose(tmetrics.pearson_compute(tp).numpy(),
                               np.asarray(jmetrics.pearson_compute(jp)), atol=1e-4)


def test_predict_batches_matches_jax(tiny_pair):
    jmodel, params, port = tiny_pair
    forward = jax.jit(jv.vlb_forward_fn(jmodel), static_argnums=3)
    rng = np.random.default_rng(13)
    batches = [_batch(rng, 3), _batch(rng, 3, [1, 1, 0])]
    jp = jmetrics.pearson_init(G.num_parcels)
    preds = []
    for batch in batches:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        pred, _ = forward(params, jb, jax.random.key(0), False)
        jp = jmetrics.pearson_update(jp, pred, jb["timeseries"], jb["row_mask"])
        preds.append(np.asarray(pred)[batch["row_mask"] > 0])
    out = predict_batches(port, batches, device="cpu")
    assert out["predicted"].shape == (5, G.num_parcels) == out["actual"].shape
    np.testing.assert_allclose(out["predicted"], np.concatenate(preds), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["val_corr_roi"], np.asarray(jmetrics.pearson_compute(jp)), atol=1e-4)
    assert out["brain_loss"].shape == (2,) and np.isfinite(out["brain_loss"]).all()


def test_raw_frames_wait_for_the_vision_slice(tiny_pair):
    """Raw frames need the vision towers: a model loaded from a tree made on
    cached tokens (which holds none, as the reference creates them lazily)
    refuses them by name, and one that holds the towers takes them."""
    _, _, port = tiny_pair
    batch = _torch(_batch(np.random.default_rng(14), 1))
    frames = torch.zeros(1, G.num_frames, 3, G.image_size, G.image_size)
    args = (batch["language"], frames, batch["padvals"], batch["vis_weights"], batch["lang_weights"])
    assert port.vision_tower is None
    with pytest.raises(ValueError, match="no vision towers"):
        port(*args)
    cfg = tv.VLBConfig.tiny()
    with_towers = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, "cpu", torch.Generator().manual_seed(0)))
    with torch.no_grad():
        pred, _ = with_towers(*args)
    assert pred.shape == (1, G.num_parcels) and torch.isfinite(pred).all()
