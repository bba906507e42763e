"""Port parity: ``scripts/quant_quality_run_torch.py`` and
``scripts/plateau_run_torch.py`` at their narrow preset against the JAX
scripts' lines, run with the JAX package's own functions.

The narrow preset is the tiny geometry (56 px frames, 64-token sequences,
the tiny tower, connector and a 2-layer decoder, f32, rank-4 adapters).
JAX trees are initialised as the JAX scripts initialise them (with
``scan_layers``, so the decoder's leaves are stacked (L, ...)), and
carried to the port by ``from_flax_params``; the JAX side of each check is
the JAX script's own lines, on those trees.

Teacher-student (``scripts/quant_quality_run.py``):
- the batches byte for byte (``__graft_entry__._example_batch`` with the
  script's frame noise);
- the teacher's ``lora_b`` bit for bit from the same normals: 0.5 / L (L =
  2 layers, rank 4, so a 0.5 / r rule fails), nothing else perturbed;
- the teacher's targets within TARGET_TOL (below);
- the int8 codes, scales and the set of quantized keys bit for bit against
  the script's ``q8_dev`` on the same weights;
- the bf16 and w8a8g8 students' curves over 3 steps, evaluated at every
  step, within CURVE_TOL; the JSON lines' keys are the JAX script's.

Plateau (``scripts/plateau_run.py``):
- the host rows byte for byte, the pixels, the bf16 tokens and token means
  within a bf16 ulp of their largest value (f32 towers summing in another
  order round to the neighbouring bf16 value near a tie), the token plant
  within PLANT_TOL;
- for two configs (bf16, then w8a8g8) on the JAX tokens: the pooled reps
  within REPS_TOL; the self plant (its R drawn from the one plant stream
  across the configs) and the probe from the JAX reps within ARITH_TOL;
  then ``--plant self --probe`` end to end on the port's own reps, each
  value within PROBE_TOL;
- the fit through the trainer of record at lr 0, patience 1 (the second
  validation does not improve on the first, so it stops there): its
  record's keys, ``stop_step`` and ``stopped_early``, and the curve read
  back from ``metrics.csv`` against the JAX trainer's (at lr 0 the weights
  never move, so the validations are deterministic in spite of dropout).

Tolerances, each with its reason (f32 throughout, the port and JAX summing
in other orders):
- TARGET_TOL 2e-4 absolute on z-scored targets: the predictions agree
  within 1e-4 of their scale (``tests/test_torch_vision_vlb.py``), and the
  z-score over 3 rows divides by a std of that scale (measured 1.0e-5);
- CURVE_TOL on r: bf16 1e-4 absolute, the trainer tests' CORR_TOL, over
  3 updates each within the train-step tolerance, (1 + 1e-5)^3 - 1 ~ 3e-5
  of the loss (measured 1.8e-6; the fit's curve 1.2e-7, its losses within
  LOSS_TOL 1e-4 relative, measured 2.4e-7 absolute); w8a8g8 3e-3, its
  forward's tolerance (1e-3 of max|value|, ``tests/test_torch_quant.py``
  and ``tests/test_torch_clip.py``: each side rounds activations to int8
  codes, and a value that f32 sums in another order move across a .5
  changes its code by one, in the tower and the decoder) compounded over
  3 updates, (1 + 1e-3)^3 - 1 (measured 1.01e-3);
- REPS_TOL and PROBE_TOL (r is scale-free, so the reps' relative error
  carries over): bf16 1e-4 of max|rep|, a 2-layer f32 forward then an f32
  pooling sum (``tests/test_torch_vision_vlb.py``'s tolerance; measured
  2.7e-7 and 1.3e-7); w8a8g8 5e-3, code flips as above: the port's own
  reps move 1.6e-3 when its embeddings move by 2^-22 of themselves, and
  lie 2.3e-3 from JAX's (the probe 2.4e-3);
- PLANT_TOL 1e-3 absolute on the token plant's targets of unit scale (LN,
  two z-scores and two projections of token means within a bf16 ulp;
  measured 0.0); ARITH_TOL 1e-5 absolute where both sides run the same
  numpy arithmetic on the same reps (LN, the self plant, the float64 ridge).
"""

import copy
import csv
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from __graft_entry__ import _example_batch  # noqa: E402
from phantom_vlb_tpu.data.synthetic import synth_language_row as j_synth_language_row  # noqa: E402
from phantom_vlb_tpu.models import videollama2 as jv  # noqa: E402
from phantom_vlb_tpu.models.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from phantom_vlb_tpu.ops.weight_mask import build_weight_mask as j_build_weight_mask  # noqa: E402
from phantom_vlb_tpu.train.loop import TrainLoopConfig as JLoopConfig  # noqa: E402
from phantom_vlb_tpu.train.loop import VLBTrainer as JTrainer  # noqa: E402
from phantom_vlb_tpu.train.metrics import CSVMetricsLogger as JCSVLogger  # noqa: E402
from phantom_vlb_tpu.train.metrics import pearson_compute, pearson_init, pearson_update  # noqa: E402
from phantom_vlb_tpu.train.optim import OptimConfig as JOptimConfig  # noqa: E402
from phantom_vlb_tpu.train.optim import make_optimizer, trainable_labels  # noqa: E402
from phantom_vlb_tpu.train.step import combine_params, init_train_state, make_train_step  # noqa: E402
from phantom_vlb_tpu_torch.models.convert import from_flax_params  # noqa: E402
from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB  # noqa: E402

import plateau_run_torch as pr  # noqa: E402
import quant_quality_run_torch as qq  # noqa: E402

LAYERS, BATCH, N_TRAIN, N_VAL, STEPS = 2, 3, 2, 1, 3
TARGET_TOL = 2e-4
REPS_TOL = PROBE_TOL = {"bf16": 1e-4, "w8a8g8": 5e-3}
PLANT_TOL, ARITH_TOL = 1e-3, 1e-5
CURVE_TOL = {"bf16": 1e-4, "w8a8g8": 3e-3}
LOSS_TOL = 1e-4
BF16_ULP = 2.0 ** -7                    # the spacing of bf16 values, relative to the value, at most


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Teacher-student: the JAX script's lines on the tiny geometry

QQ_ARGV = ["--preset", "narrow", "--layers", str(LAYERS), "--batch", str(BATCH), "--steps", str(STEPS),
           "--eval-every", "1", "--n-train", str(N_TRAIN), "--n-val", str(N_VAL), "--configs", "bf16,w8a8g8",
           "--device", "cpu"]


def qq_jax_cfg(quant):
    """The JAX script's ``build_cfg`` on the tiny configs (f32)."""
    base = jv.VLBConfig.tiny(use_lora=True, dropout_rate=0.0)
    cfg = dataclasses.replace(
        base, clip=dataclasses.replace(base.clip, scan_layers=True, base_quant=quant),
        mistral=dataclasses.replace(base.mistral, num_hidden_layers=LAYERS, scan_layers=True, base_quant=quant),
        freeze_backbone=False)
    cfg.validate()
    return cfg


def q8_dev(w):
    w32 = w.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(w32), axis=-2, keepdims=True)
    scale = jnp.where(absmax == 0.0, 1.0, absmax / 127.0)
    q = jnp.clip(jnp.rint(w32 / scale), -127, 127).astype(jnp.int8)
    return q, jnp.squeeze(scale, axis=-2)


def quantize_tree_dev(node, should, prefix=""):
    out = {}
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel" in v and not isinstance(v["kernel"], dict) and should(path):
            q, s = q8_dev(v["kernel"])
            nv = {kk: quantize_tree_dev(vv, should, f"{path}/{kk}") if isinstance(vv, dict) else vv
                  for kk, vv in v.items() if kk != "kernel"}
            nv["kernel_q"], nv["kernel_scale"] = q, s
            out[k] = nv
        elif isinstance(v, dict):
            out[k] = quantize_tree_dev(v, should, path)
        else:
            out[k] = v
    return out


TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "out_proj", "fc1", "fc2")


def jax_quantize(params):
    return quantize_tree_dev(params, lambda path: "mm_projector" not in path and any(t in path for t in TARGETS))


def _path_name(path) -> str:
    return "/".join(str(getattr(p, "key", p)) for p in path)


@pytest.fixture(scope="module")
def jax_params0():
    """The tiny VLB's Flax init at key 0, as both JAX scripts make it (the
    teacher's and every student's, and every plateau config's, whose
    shapes are the same: dropout holds no parameters)."""
    cfg = qq_jax_cfg(None)
    b = _example_batch(cfg.geometry, BATCH, cfg.mistral.vocab_size)
    model = jv.VideoLLaMA2VLB(cfg)
    init = jax.jit(lambda key: model.init(key, b["language"], b["vision"], b["padvals"], b["vis_weights"],
                                          b["lang_weights"])["params"])
    return jax.tree.map(np.asarray, init(jax.random.key(0)))


@pytest.fixture(scope="module")
def teacher_student(jax_params0):
    """The JAX script's batches, init, teacher and targets; the normals its
    ``perturb`` drew, as a port state dict."""
    cfg0 = qq_jax_cfg(None)
    g = cfg0.geometry
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(N_TRAIN + N_VAL):
        b = dict(_example_batch(g, BATCH, cfg0.mistral.vocab_size))
        b["language"] = np.asarray(b["language"])
        b["vision"] = np.asarray(b["vision"]) + rng.standard_normal(b["vision"].shape).astype(np.float32) * 0.3
        batches.append(b)
    model0 = jv.VideoLLaMA2VLB(cfg0)
    params0 = jax.tree.map(jnp.asarray, jax_params0)
    t_rng = np.random.default_rng(7)
    normals = {}

    def perturb(path, leaf):
        name = _path_name(path)
        if "lora_b" in name:
            normals[name] = t_rng.standard_normal(leaf.shape).astype(np.float32)
            return jnp.asarray(normals[name] * (0.5 / max(1, leaf.shape[0]))).astype(leaf.dtype)
        return leaf

    teacher_params = jax.tree_util.tree_map_with_path(perturb, params0)
    teacher_fwd = jax.jit(lambda p, lang, vis, pv, vw, lw: model0.apply(
        {"params": p}, lang, vis, pv, vw, lw, deterministic=True)[0])
    batches_before_targets = copy.deepcopy(batches)
    for b in batches:
        pred = teacher_fwd(teacher_params, b["language"], jnp.asarray(b["vision"]), b["padvals"],
                           b["vis_weights"], b["lang_weights"])
        y = np.asarray(pred, np.float32)
        y = (y - y.mean(0)) / (y.std(0) + 1e-6)
        b["timeseries"] = y + rng.standard_normal(y.shape).astype(np.float32) * 0.3
    normal_tree = jax.tree_util.tree_map_with_path(lambda path, leaf: normals.get(_path_name(path), leaf), params0)
    params0 = jax.tree.map(np.asarray, params0)
    return {"batches0": batches_before_targets, "batches": batches, "params0": params0,
            "teacher": jax.tree.map(np.asarray, teacher_params), "normals": from_flax_params(normal_tree)}


def _state(params):
    return lambda cfg, device: from_flax_params(params)


def test_batches_are_the_jax_scripts_byte_for_byte(teacher_student):
    cfg = qq.build_cfg(None, LAYERS, "narrow")
    got = qq.make_batches(cfg, N_TRAIN + N_VAL, BATCH, np.random.default_rng(qq.DATA_SEED), torch.device("cpu"))
    for g, w in zip(got, teacher_student["batches0"]):
        assert set(g) == set(w)
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key


def test_teacher_lora_b_is_scaled_by_the_depth(teacher_student):
    params0, normals = teacher_student["params0"], teacher_student["normals"]
    rank = qq.build_cfg(None, LAYERS, "narrow").mistral.lora.rank
    assert rank != LAYERS                          # so a 0.5 / rank rule gives other values
    got = qq.teacher_adapters(from_flax_params(params0), LAYERS, lambda key, shape: normals[key])
    want = from_flax_params(teacher_student["teacher"])
    before = from_flax_params(params0)
    lora_b = [k for k in want if k.endswith(".lora_b")]
    assert len(lora_b) == 7 * LAYERS and got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
        if key not in lora_b:
            assert torch.equal(want[key], before[key]), key
    for key in lora_b:
        assert torch.equal(got[key], normals[key] * (0.5 / LAYERS))
        assert not torch.equal(got[key], normals[key] * (0.5 / rank))


def test_teacher_targets_match_jax(teacher_student):
    cfg = qq.build_cfg(None, LAYERS, "narrow")
    rng = np.random.default_rng(qq.DATA_SEED)
    batches = qq.make_batches(cfg, N_TRAIN + N_VAL, BATCH, rng, torch.device("cpu"))
    normals = teacher_student["normals"]
    sd = qq.teacher_adapters(from_flax_params(teacher_student["params0"]), LAYERS, lambda key, shape: normals[key])
    qq.set_teacher_targets(VideoLLaMA2VLB.from_state_dict(cfg, sd), batches, rng)
    for g, w in zip(batches, teacher_student["batches"]):
        assert np.isfinite(g["timeseries"]).all() and g["timeseries"].dtype == w["timeseries"].dtype
        np.testing.assert_allclose(g["timeseries"], w["timeseries"], rtol=0, atol=TARGET_TOL)


def test_int8_codes_scales_and_keys_match_q8_dev(teacher_student):
    params0 = teacher_student["params0"]
    want = from_flax_params(jax.tree.map(np.asarray, jax_quantize(params0)))
    got = qq.quantize_base(from_flax_params(params0))
    assert got.keys() == want.keys()
    quantized = sorted(k[: -len(".weight_q")] for k in got if k.endswith(".weight_q"))
    assert len(quantized) == 7 * LAYERS + 6 * qq.build_cfg(None, LAYERS, "narrow").clip.effective_layers
    assert not any(k.startswith("mm_projector.") for k in quantized)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def jax_curve(teacher_student, quant_name):
    """The JAX script's student loop for one config, eval at every step."""
    quant = None if quant_name == "bf16" else quant_name
    cfg = qq_jax_cfg(quant)
    model = jv.VideoLLaMA2VLB(cfg)
    params = jax.tree.map(jnp.asarray, teacher_student["params0"])
    if quant is not None:
        params = jax_quantize(params)
    labels = trainable_labels(params, jv.trainable_predicate)
    tx = make_optimizer(JOptimConfig(lr=1e-3))
    state, frozen = init_train_state(params, tx, labels)
    step = make_train_step(jv.vlb_forward_fn(model), tx, labels, donate=True)
    key = jax.random.key(3, impl="rbg")
    batches = teacher_student["batches"]
    # The script's eager model.apply, jitted (the same function, compiled once).
    fwd = jax.jit(lambda p, lang, vis, pv, vw, lw: model.apply(
        {"params": p}, lang, vis, pv, vw, lw, deterministic=True)[0])
    curve = []
    for it in range(STEPS):
        b = batches[it % N_TRAIN]
        state, _ = step(state, frozen, b, jax.random.fold_in(key, it))
        full = combine_params(state.params, frozen)
        pear = pearson_init(cfg.num_target)
        for vb in batches[N_TRAIN:]:
            pred = fwd(full, vb["language"], jnp.asarray(vb["vision"]), vb["padvals"], vb["vis_weights"],
                       vb["lang_weights"])
            pear = pearson_update(pear, pred, jnp.asarray(vb["timeseries"]), jnp.ones(BATCH))
        curve.append((it + 1, float(np.nanmean(np.asarray(pearson_compute(pear))))))
    return curve


def test_student_curves_match_jax(teacher_student, capsys):
    normals = teacher_student["normals"]
    got = qq.run(qq.parse_args(QQ_ARGV), draw=lambda key, shape: normals[key],
                 state=_state(teacher_student["params0"]))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in got] == [r["config"] for r in lines] == ["bf16", "w8a8g8"]
    for rec, line in zip(got, lines):
        assert list(line) == ["config", "geometry", "curve"]
        assert line["geometry"] == f"{LAYERS}L/64/seq64/batch{BATCH}"
        assert [list(p) for p in line["curve"]] == [["step", "val_pearson_avg"]] * STEPS
        assert [p["val_pearson_avg"] for p in line["curve"]] == [round(r, 4) for _, r in rec["curve"]]
        want = jax_curve(teacher_student, rec["config"])
        assert [s for s, _ in rec["curve"]] == [s for s, _ in want] == [1, 2, 3]
        for (_, r), (_, w) in zip(rec["curve"], want):
            assert abs(r - w) <= CURVE_TOL[rec["config"]], (rec["config"], r, w)


# ---------------------------------------------------------------------------
# Plateau: the JAX script's lines on the tiny geometry

PR_ARGV = ["--preset", "narrow", "--layers", str(LAYERS), "--batch", str(BATCH), "--train-batches", str(N_TRAIN),
           "--val-batches", str(N_VAL), "--device", "cpu"]


def pr_jax_cfg(quant):
    base = jv.VLBConfig.tiny(use_lora=True)
    cfg = dataclasses.replace(
        base, clip=dataclasses.replace(base.clip, scan_layers=True),
        mistral=dataclasses.replace(base.mistral, num_hidden_layers=LAYERS, scan_layers=True, base_quant=quant,
                                    lora=JLoRAConfig(rank=4, alpha=8.0, dropout=0.1, dropout_bits=8)),
        freeze_backbone=False)
    cfg.validate()
    return cfg


def _zs(a):
    return (a - a.mean(0)) / (a.std(0) + 1e-9)


def _ln(a):
    mu = a.mean(-1, keepdims=True)
    var = ((a - mu) ** 2).mean(-1, keepdims=True)
    return (a - mu) / np.sqrt(var + 1e-6)


@pytest.fixture(scope="module")
def plateau(jax_params0):
    """The JAX script's host data, tokens and token plant, and each
    config's init (its towers kept: the port's encoder takes the bf16 one)."""
    cfg0 = pr_jax_cfg(None)
    g, B = cfg0.geometry, BATCH
    n_batches = N_TRAIN + N_VAL
    rng = np.random.default_rng(0)
    lang_rows, padval_rows, visw_rows, langw_rows = [], [], [], []
    for i in range(n_batches * B):
        ids, _onsets, maskvals = j_synth_language_row(g, rng, tr_time=(i % 40 + 1) * g.tr,
                                                      vocab_size=cfg0.mistral.vocab_size)
        lang_rows.append(ids)
        padval_rows.append(maskvals)
        visw_rows.append(rng.uniform(0, 0.3, g.num_ds_frames))
        langw_rows.append(rng.uniform(0, 0.3, g.onsets_width))
    language = np.stack(lang_rows).astype(np.int32)
    padvals = np.stack(padval_rows).astype(np.int32)
    vis_w = np.stack(visw_rows).astype(np.float32)
    lang_w = np.stack(langw_rows).astype(np.float32)

    def clip_pixels(i):
        return np.random.default_rng(10_000 + i).standard_normal(
            (g.num_frames, 3, g.image_size, g.image_size)).astype(np.float32)

    # The w8a8g8 config's decoder base: the bf16 init quantized by q8_dev
    # (the JAX script's init draws its own codes; any codes test the path).
    params = {"bf16": jax_params0, "w8a8g8": jax.tree.map(np.asarray, quantize_tree_dev(
        jax_params0, lambda path: path.split("/")[0] not in ("vision_tower", "mm_projector")
        and any(t in path for t in TARGETS)))}
    enc_model = jv.VideoLLaMA2VLB(cfg0)
    encode = jax.jit(lambda p, v: enc_model.apply({"params": p}, v, method=jv.VideoLLaMA2VLB.encode_video)
                     .astype(jnp.bfloat16))
    batches, tok_means = [], []
    for bi in range(n_batches):
        s = bi * B
        tokens = encode(params["bf16"], jnp.asarray(np.stack([clip_pixels(s + j) for j in range(B)])))
        tok_means.append(np.asarray(tokens.reshape(B, g.num_ds_frames, g.tokens_per_frame, -1).mean(2), np.float32))
        batches.append({"language": language[s:s + B], "vision": tokens, "padvals": padvals[s:s + B],
                        "vis_weights": vis_w[s:s + B], "lang_weights": lang_w[s:s + B],
                        "row_mask": np.ones((B,), np.float32)})
    tok_mean = np.concatenate(tok_means)
    prng = np.random.default_rng(42)
    e_llm = tok_mean.shape[-1]
    r_tok = prng.standard_normal((e_llm, 32)).astype(np.float32) / np.sqrt(e_llm)
    p_out = prng.standard_normal((32, g.num_parcels)).astype(np.float32) / np.sqrt(32)
    z = np.einsum("nd,ndk->nk", vis_w, tok_mean @ r_tok)
    y = _zs(_zs(z) @ p_out)
    y = y + 0.3 * rng.standard_normal(y.shape).astype(np.float32)
    for bi in range(n_batches):
        batches[bi]["timeseries"] = y[bi * B:(bi + 1) * B]
    return {"rows": {"language": language, "padvals": padvals, "vis_weights": vis_w, "lang_weights": lang_w},
            "clip_pixels": clip_pixels, "params": params, "batches": batches, "tok_mean": tok_mean, "y": y,
            "p_out": p_out, "prng": prng, "g": g}


def _pr_state(plateau):
    return lambda cfg, device: from_flax_params(plateau["params"]["bf16" if cfg.mistral.base_quant is None
                                                                  else cfg.mistral.base_quant])


def _port_data(plateau) -> pr.PlateauData:
    """The JAX side's tokens and plant as the port's data."""
    batches = [{**b, "vision": torch.from_numpy(np.array(b["vision"].astype(jnp.float32))).to(torch.bfloat16)}
               for b in plateau["batches"]]
    return pr.PlateauData(batches, plateau["tok_mean"], plateau["y"], plateau["p_out"],
                          copy.deepcopy(plateau["prng"]), 1.0 / np.sqrt(1.09))


def test_plateau_data_matches_jax(plateau):
    args = pr.parse_args(PR_ARGV)
    cfg = pr.build_cfg(None, LAYERS, "narrow")
    rows = pr.host_rows(cfg, (N_TRAIN + N_VAL) * BATCH, np.random.default_rng(pr.DATA_SEED))
    for key, want in plateau["rows"].items():
        assert rows[key].dtype == want.dtype and rows[key].tobytes() == want.tobytes(), key
    assert pr.clip_pixels(plateau["g"], 5).tobytes() == plateau["clip_pixels"](5).tobytes()
    data = pr.prepare(args, _pr_state(plateau))
    for got, want in zip(data.batches, plateau["batches"]):
        tokens = np.asarray(want["vision"].astype(jnp.float32))
        assert got["vision"].dtype == torch.bfloat16 and got["vision"].shape == tokens.shape
        assert _rel(got["vision"].float().numpy(), tokens) <= BF16_ULP
        for key in ("language", "padvals", "vis_weights", "lang_weights", "row_mask"):
            assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    assert _rel(data.tok_mean, plateau["tok_mean"]) <= BF16_ULP
    assert data.p_out.tobytes() == plateau["p_out"].tobytes()
    np.testing.assert_allclose(data.y, plateau["y"], rtol=0, atol=PLANT_TOL)
    assert data.ceiling == pytest.approx(1.0 / np.sqrt(1.09), rel=1e-15)


def jax_pooled_reps(plateau, name):
    cfg = pr_jax_cfg(None if name == "bf16" else name)
    model, g = jv.VideoLLaMA2VLB(cfg), cfg.geometry
    params = {k: v for k, v in plateau["params"][name].items() if k not in ("vision_tower", "mm_projector")}
    pooled_fn = jax.jit(lambda p, b: (lambda hidden_valid: jnp.einsum(
        "bse,bs->be", hidden_valid[0].astype(jnp.float32),
        j_build_weight_mask(b["padvals"], b["vis_weights"], b["lang_weights"], g)))(
        model.apply({"params": p}, b["language"], b["vision"], method=lambda m, l, v: m.backbone(l, v))))
    return np.concatenate([np.asarray(pooled_fn(params, {k: jnp.asarray(v) for k, v in bt.items()}), np.float32)
                           for bt in plateau["batches"]])


def test_pooled_reps_self_plant_and_probe_match_jax(plateau, capsys):
    """bf16, then w8a8g8 on one plant stream: each config's pooled reps;
    its self plant and probe from the JAX reps (the arithmetic alone); then
    ``--plant self --probe`` end to end on the port's own reps."""
    args = pr.parse_args([*PR_ARGV, "--plant", "self", "--probe"])
    data = _port_data(plateau)
    prng_port, prng_jax = copy.deepcopy(data.prng), copy.deepcopy(plateau["prng"])
    n_tr = N_TRAIN * BATCH
    want_probe = []
    for name in ("bf16", "w8a8g8"):
        cfg = pr.build_cfg(None if name == "bf16" else name, LAYERS, "narrow")
        sd = {k: v for k, v in _pr_state(plateau)(cfg, "cpu").items()
              if not k.startswith(("vision_tower.", "mm_projector."))}
        reps = pr.pooled_reps(VideoLLaMA2VLB.from_state_dict(cfg, sd), data.batches)
        want_reps = jax_pooled_reps(plateau, name)
        assert reps.dtype == np.float32 and _rel(reps, want_reps) <= REPS_TOL[name], name
        # The JAX script's self plant and probe lines.
        x0 = _ln(want_reps)
        r_self = prng_jax.standard_normal((x0.shape[-1], 32)).astype(np.float32) / np.sqrt(x0.shape[-1])
        y_cfg = _zs(_zs(x0 @ r_self) @ plateau["p_out"])
        y_cfg = y_cfg + 0.3 * np.random.default_rng(7).standard_normal(y_cfg.shape).astype(np.float32)
        xt, xv, yt, yv = x0[:n_tr], x0[n_tr:], y_cfg[:n_tr], y_cfg[n_tr:]
        probe = []
        for alpha in (1e0, 1e2, 1e4):
            w = np.linalg.solve(xt.T @ xt + alpha * np.eye(x0.shape[1], dtype=np.float64), xt.T @ yt)
            pv = xv @ w
            num = ((pv - pv.mean(0)) * (yv - yv.mean(0))).sum(0)
            den = (np.linalg.norm(pv - pv.mean(0), axis=0) * np.linalg.norm(yv - yv.mean(0), axis=0) + 1e-9)
            probe.append((alpha, float(np.mean(num / den))))
        x = pr.layer_norm(want_reps)
        np.testing.assert_allclose(x, x0, rtol=0, atol=ARITH_TOL)
        got_y = pr.self_plant(x, prng_port, data.p_out, 0.3)
        np.testing.assert_allclose(got_y, y_cfg, rtol=0, atol=ARITH_TOL)
        for (alpha, r), (want_alpha, want) in zip(pr.probe(x0, y_cfg, n_tr), probe):
            assert alpha == want_alpha and abs(r - want) <= ARITH_TOL, (name, alpha, r, want)
        want_probe += [(name, alpha, r) for alpha, r in probe]
    got = pr.run(args, data=data, state=_pr_state(plateau))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [list(line) for line in lines] == [["config", "probe_alpha", "probe_val_r"]] * 6
    assert [(r["config"], r["probe_alpha"]) for r in got] == [(n, a) for n, a, _ in want_probe]
    for rec, line, (_, _, want) in zip(got, lines, want_probe):
        assert line["probe_val_r"] == round(rec["probe_val_r"], 4)
        assert abs(rec["probe_val_r"] - want) <= PROBE_TOL[rec["config"]], (rec, want)
    assert data.prng.bit_generator.state == plateau["prng"].bit_generator.state   # run drew from a copy


def test_plateau_fit_record_and_curve_match_jax(plateau, tmp_path, capsys):
    """lr 0, patience 1: both trainers stop at the second validation with
    the same curve; the record has the JAX script's keys."""
    args = pr.parse_args([*PR_ARGV, "--configs", "bf16", "--lr", "0", "--patience", "1", "--max-epochs", "4",
                          "--out", str(tmp_path / "port")])
    (rec,) = pr.run(args, data=_port_data(plateau), state=_pr_state(plateau))
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert list(line) == ["config", "layers", "noise_ceiling_r", "final_val_corr_avg", "stopped_early",
                          "stop_step", "walltime_s", "curve"]
    assert rec["stopped_early"] and rec["stop_step"] == 2 * N_TRAIN and len(rec["curve"]) == 2
    assert line["curve"] == [[s, round(r, 4), round(loss, 4)] for s, r, loss in rec["curve"]]
    run_dir = tmp_path / f"port_bf16_{LAYERS}L" / "plateau" / "version_0"
    with open(run_dir / "metrics.csv", newline="") as f:
        val_rows = [r for r in csv.DictReader(f) if r.get("val_corr_avg")]
    assert [(int(r["step"]), float(r["val_corr_avg"]), float(r["val/brain_loss"])) for r in val_rows] == rec["curve"]
    assert rec["final_val_corr_avg"] == rec["curve"][-1][1]

    model = jv.VideoLLaMA2VLB(pr_jax_cfg(None))
    params = {k: v for k, v in plateau["params"]["bf16"].items() if k not in ("vision_tower", "mm_projector")}
    out_dir = str(tmp_path / "jax")
    batches = [dict(b) for b in plateau["batches"]]
    trainer = JTrainer(
        jv.vlb_forward_fn(model), params, JOptimConfig(lr=0.0),
        JLoopConfig(max_epochs=4, val_check_interval=0.0, log_every_n_steps=N_TRAIN, output_dir=out_dir,
                    run_name="plateau", num_target=plateau["g"].num_parcels, checkpoint=False,
                    early_stop_patience=1, early_stop_min_delta=1e-4),
        trainable_label_tree=trainable_labels(params, jv.trainable_predicate),
        csv_logger=JCSVLogger(out_dir, "plateau"))
    final = trainer.fit(batches[:N_TRAIN], batches[N_TRAIN:])
    assert trainer.stopped_early and trainer.global_step == rec["stop_step"]
    with open(trainer.csv_logger.path, newline="") as f:
        want = [(int(r["step"]), float(r["val_corr_avg"]), float(r["val/brain_loss"]))
                for r in csv.DictReader(f) if r.get("val_corr_avg")]
    assert [s for s, _, _ in rec["curve"]] == [s for s, _, _ in want]
    for (_, r, loss), (_, wr, wloss) in zip(rec["curve"], want):
        assert abs(r - wr) <= CURVE_TOL["bf16"] and abs(loss - wloss) <= LOSS_TOL * abs(wloss)
    assert abs(rec["final_val_corr_avg"] - float(final["val_corr_avg"])) <= CURVE_TOL["bf16"]
