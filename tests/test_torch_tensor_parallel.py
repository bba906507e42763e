"""The ``tensor`` axis across processes, on gloo ranks of the CPU.

``mesh.tensor`` = 2 (2 processes) and ``fsdp`` 2 x ``tensor`` 2 (4
processes, ``tests/torch_ranks.py``, one launch each; and one 32-bit
dropout LoRA step on ``data`` 2 x ``tensor`` 2, HSDP): the tiny VLB's
LoRA and baseline steps with dropout 0.1 (32-bit and 8-bit generator
masks, the fused u8 hash's plain version, one mask per layer input; on
2 processes also the fused epilogue's plain version)
against the one-process step on the same global batch, at
``tests/test_torch_sharded.py``'s tolerances; a batch whose second
coordinate's rows are all padding, and a non-finite loss that every rank
skips. On the 2-process mesh also: the step without dropout against JAX's
under ``MeshConfig(fsdp=1, tensor=2)`` on 2 of the 8 virtual CPU devices
(``tests/test_torch_train_step.py``'s tolerances); the five
``remat_policy``s, each step bit-equal to ``'nothing'``'s; the
w8a8g8 LoRA step; and each decoder projection's base product and x's
gradient under every ``base_quant`` against one process's. ``last``
restores bit for bit across mesh shapes: ``fsdp`` 2 x ``tensor`` 2 -> one
process, and one process -> ``tensor`` 2 and -> 2 x 2. In this process:
``hash_bytes`` and the fused dropout's plain version from a first column
``col0``, the generator masks of a rank's columns, the split row quant,
and a ``tensor`` size that does not divide the heads.

Tolerances: ``tests/test_torch_sharded.py``'s for the loss, the gradients
and the AdamW moments (the ranks add f32 partial sums in another order);
an updated tensor likewise, except an element whose first-step gradient
lies within the gradient tolerance of zero: Adam divides by sqrt(v) + eps,
so such an element's step may take any value within lr of the other's
(first seen on ``up_proj.lora_a`` of the 8-bit-mask scenario and on
``k_proj.lora_b`` against JAX), and is held within 2 lr per step.

Under the int8 modes the base products are bit-equal where the one-card
arithmetic is kept whole: every column-parallel product (the rank's output
columns of the same contraction), w8a8's and w8a8g8's row-parallel
products (the row's scale the maximum over the ranks, the int32 partials
summed before the dequant), w8a8g8's column-parallel dx (likewise) and
every row-parallel dx (the rank's columns of the same contraction). The
weight-only int8 row-parallel product and int8's column-parallel dx add
f32 partials over the ranks, and are held within 1e-6 of their largest
value; w8a8's column-parallel dx, the straight-through product rounded to
bf16 on each rank before the sum (one card rounds the whole sum once),
within 2^-8.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.core.mesh import MeshConfig as JMeshConfig
from phantom_vlb_tpu.core.mesh import build_mesh as jbuild_mesh
from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.parallel.sharding import shard_params
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu.train.step import init_train_state, make_train_step
from phantom_vlb_tpu_torch.core.mesh import MeshEnv
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.lora import LoRAConfig, adapter_dropout
from phantom_vlb_tpu_torch.ops.lora_fused import (
    dropout_threshold,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
)
from phantom_vlb_tpu_torch.ops.quant import quantize_state_dict
from phantom_vlb_tpu_torch.ops.rowquant import row_absmax, row_quant_plain, row_quant_scaled, row_quant_split
from phantom_vlb_tpu_torch.parallel.sharding import _projections, split_decoder
from phantom_vlb_tpu_torch.train.optim import OptimConfig
from test_torch_sharded import RANK_GRAD_TOL, _dropout_pair, _fit_data, _one_process_fit, _same_state
from test_torch_sharded import _check_against_one_process as _check_sharded
from test_torch_train_step import GRAD_TOL, LOSS_TOL, UPDATE_TOL, _as_state_dict, _batch, _labels
from torch_ranks import make_model, run_ranks, tiny_config

LR = OptimConfig().lr
POLICIES = ("nothing", "attn", "mids", "flash", "dots")
QUANT_MODES = ("int8", "w8a8", "w8a8g8")
PRODUCT_TOL, STE_TOL = 1e-6, 2.0**-8


def _update_atol(base: float, grad: torch.Tensor, grad_tol: float, steps: int) -> np.ndarray:
    """``base`` per element, or 2 lr a step more where the first-step
    gradient lies within ``grad_tol`` x max|g| of zero (see the module's note)."""
    near_zero = (grad.abs() <= grad_tol * float(grad.abs().max())).numpy()
    return np.where(near_zero, base + steps * 2 * LR, base)


def _check_against_one_process(run, name):
    """``tests/test_torch_sharded.py``'s check, the updates held as the
    module's note says."""
    _check_sharded(run, name, lambda base, grad, steps: _update_atol(base, grad, RANK_GRAD_TOL, steps))


# ---------------------------------------------------------------------------
# In this process: masks and row quant of a rank's columns.

@pytest.mark.parametrize("col0", [0, 64, 2048])
def test_hash_bytes_of_a_rank_are_the_columns_of_the_one_card_mask(col0):
    m, k, seed, row0 = 12, 64, 99, 5
    whole = hash_bytes(seed, m, col0 + k + 64, row0=row0)
    assert torch.equal(hash_bytes(seed, m, k, row0=row0, col0=col0), whole[:, col0:col0 + k])
    rng = np.random.default_rng(col0)
    x = torch.from_numpy(rng.standard_normal((m, col0 + k)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((col0 + k, 4)).astype(np.float32))
    dmid = torch.from_numpy(rng.standard_normal((m, 4)).astype(np.float32))
    thr, _ = dropout_threshold(0.1)
    cols = slice(col0, col0 + k)
    dx, da = fused_dropout_bwd_plain(x[:, cols], a[cols], dmid, seed, thr, row0=row0, col0=col0)
    dx_w, da_w = fused_dropout_bwd_plain(x, a, dmid, seed, thr, row0=row0)
    assert torch.equal(dx, dx_w[:, cols]) and torch.equal(da, da_w[cols])
    # The mids of the column blocks add up to the whole mid.
    parts = [fused_dropout_matmul_plain(x[:, c:c + k], a[c:c + k], seed, thr, row0=row0, col0=c)
             for c in range(0, col0 + k, k)]
    want = fused_dropout_matmul_plain(x, a, seed, thr, row0=row0)
    np.testing.assert_allclose(sum(parts).numpy(), want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))
    got = fused_dropout_matmul(x[:, cols].contiguous().requires_grad_(), a[cols], seed, 0.1, row0=row0, col0=col0)
    assert torch.equal(got, fused_dropout_matmul_plain(x[:, cols], a[cols], seed, thr, row0=row0, col0=col0))
    with pytest.raises(ValueError, match="multiples of 4"):
        hash_bytes(seed, m, k, col0=2)


@pytest.mark.parametrize("bits", [32, 8])
def test_generator_masks_of_a_rank_are_the_columns_of_the_global_draw(bits):
    cfg = LoRAConfig(dropout=0.3, dropout_bits=bits)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 5, 32)).astype(np.float32))
    want = adapter_dropout(x, cfg, seed=9)
    for r0 in (0, 2):
        for c0 in (0, 16):
            got = adapter_dropout(x[r0:r0 + 2, :, c0:c0 + 16], cfg, 9, rows=(r0, 4), cols=(c0, 32))
            assert torch.equal(got, want[r0:r0 + 2, :, c0:c0 + 16])


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
def test_split_row_quant_is_the_whole_rows_quant(scaled):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((9, 96)).astype(np.float32))
    x[3] = 0.0                                                       # a zero row: s = 1e-12
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 96).astype(np.float32)) if scaled else None
    q, s = row_quant_scaled(x, w) if scaled else row_quant_plain(x)
    blocks = [slice(0, 32), slice(32, 64), slice(64, 96)]
    maxima = [row_absmax(x[:, b], None if w is None else w[b]) for b in blocks]
    for b in blocks:
        qb, sb = row_quant_split(x[:, b], lambda m: torch.stack(maxima).amax(0), None if w is None else w[b])
        assert torch.equal(sb, s) and torch.equal(qb, q[:, b])


def test_tensor_size_must_divide_the_heads():
    model = tv.VideoLLaMA2VLB(tv.VLBConfig.tiny(use_lora=True), vision=False)
    mesh = MeshEnv({"data": 1, "fsdp": 1, "tensor": 3, "sequence": 1}, rank=0)
    with pytest.raises(ValueError, match="mesh.tensor=3 does not divide the decoder's 4 attention heads"):
        split_decoder(model, mesh)


# ---------------------------------------------------------------------------
# The launches.

def _scenarios(lora_sd, base_sd, quant_sd, two_by_two: bool):
    rng = np.random.default_rng(40)
    b4 = [_batch(rng, 4), _batch(rng, 4, [1, 1, 1, 0])]
    nan = _batch(rng, 4)
    nan["timeseries"][3] = np.nan                                       # a row of the last coordinate
    out = [
        {"name": "lora_dropout32", "sd": lora_sd, "cfg": tiny_config(use_lora=True, dropout=0.1, remat=True),
         "batches": b4, "seeds": [5, 6]},
        {"name": "lora_dropout8", "sd": lora_sd, "cfg": tiny_config(use_lora=True, dropout=0.1, bits=8),
         "batches": b4, "seeds": [5, 6]},
        {"name": "lora_fused_u8", "sd": lora_sd,
         "cfg": tiny_config(use_lora=True, dropout=0.1, bits=8, fused=True), "batches": b4, "seeds": [5, 6]},
        {"name": "baseline_dropout", "sd": base_sd, "cfg": tiny_config(use_lora=False, dropout=0.1),
         "batches": b4, "seeds": [5, 6]},
        {"name": "rank1_padding", "sd": lora_sd, "cfg": tiny_config(use_lora=True),
         "batches": [_batch(rng, 4, [1, 1, 0, 0])], "seeds": [3]},
        {"name": "non_finite", "sd": lora_sd, "cfg": tiny_config(use_lora=True, dropout=0.1),
         "batches": [b4[0], nan], "seeds": [5, 6]},
    ]
    if two_by_two:
        return out
    out += [
        {"name": "lora_shared32", "sd": lora_sd,
         "cfg": tiny_config(use_lora=True, dropout=0.1, shared=True), "batches": b4[:1], "seeds": [5]},
        {"name": "lora_epilogue", "sd": lora_sd,
         "cfg": tiny_config(use_lora=True, dropout=0.1, fused_epilogue="pallas"), "batches": b4, "seeds": [5, 6]},
        {"name": "lora_w8a8g8", "sd": quant_sd,
         "cfg": tiny_config(use_lora=True, dropout=0.1, base_quant="w8a8g8"), "batches": b4[:1], "seeds": [5]},
        {"name": "jax_lora", "sd": lora_sd, "cfg": tiny_config(use_lora=True), "batches": [_batch(rng, 4)],
         "seeds": [0]},
        {"name": "jax_baseline", "sd": base_sd, "cfg": tiny_config(use_lora=False), "batches": [_batch(rng, 4)],
         "seeds": [0]},
    ]
    out += [{"name": f"remat_{p}", "sd": lora_sd,
             "cfg": tiny_config(use_lora=True, dropout=0.1, bits=8, fused=True, remat=True, remat_policy=p),
             "batches": b4[:1], "seeds": [7]} for p in POLICIES]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches, and the one-process fits they restore from and into."""
    (lora_params, lora_sd), (base_params, base_sd) = _dropout_pair(True), _dropout_pair(False)
    quant_sd = quantize_state_dict(dict(lora_sd))
    root = tmp_path_factory.mktemp("tp")
    fit_cfg = tiny_config(use_lora=True, dropout=0.1, bits=32)
    train, val = _fit_data()
    one = _one_process_fit(lora_sd, fit_cfg, train, val, root / "one", 1)
    for copy in ("one_tp2", "one_grid"):                    # each launch resumes (and writes) its own copy
        shutil.copytree(root / "one", root / copy)
    fit = dict(sd=lora_sd, cfg=fit_cfg, train=train, val=val)
    products = [("products", {"cfg": tiny_config(use_lora=True, base_quant=m), "sd": quant_sd, "seed": 3})
                for m in QUANT_MODES]
    tp2_sc = _scenarios(lora_sd, base_sd, quant_sd, two_by_two=False)
    tp2 = run_ranks("many", 2, root / "tp2", mesh={"fsdp": 1, "tensor": 2}, jobs=[
        ("steps", {"scenarios": tp2_sc}), *products,
        ("fit", {**fit, "out_dir": str(root / "one_tp2"), "max_epochs": 2, "resume": True})])
    grid_sc = _scenarios(lora_sd, base_sd, quant_sd, two_by_two=True)
    grid = run_ranks("many", 4, root / "grid", mesh={"fsdp": 2, "tensor": 2}, jobs=[
        ("steps", {"scenarios": grid_sc}),
        ("fit", {**fit, "out_dir": str(root / "grid_fit"), "max_epochs": 1, "resume": False}),
        ("fit", {**fit, "out_dir": str(root / "one_grid"), "max_epochs": 2, "resume": True})])
    hsdp_sc = [sc for sc in grid_sc if sc["name"] == "lora_dropout32"]
    hsdp = run_ranks("steps", 4, root / "hsdp", mesh={"data": 2, "fsdp": 1, "tensor": 2}, scenarios=hsdp_sc)
    return {"tp2": {"scenarios": {s["name"]: s for s in tp2_sc}, "ranks": [r[0] for r in tp2],
                    "products": [r[1:4] for r in tp2], "resume": [r[4] for r in tp2]},
            "grid": {"scenarios": {s["name"]: s for s in grid_sc}, "ranks": [r[0] for r in grid],
                     "fit": [r[1] for r in grid], "resume": [r[2] for r in grid]},
            "hsdp": {"scenarios": {s["name"]: s for s in hsdp_sc}, "ranks": hsdp},
            "one": one, "fit": fit, "root": root, "quant_sd": quant_sd,
            "params": {True: lora_params, False: base_params}}


TP2_CASES = ["lora_dropout32", "lora_dropout8", "lora_fused_u8", "baseline_dropout", "rank1_padding",
             "non_finite", "lora_shared32", "lora_epilogue", "lora_w8a8g8"]
GRID_CASES = ["lora_dropout32", "lora_dropout8", "lora_fused_u8", "baseline_dropout", "rank1_padding",
              "non_finite"]


@pytest.mark.parametrize("name", TP2_CASES)
def test_tensor2_step_is_the_one_process_step(runs, name):
    _check_against_one_process(runs["tp2"], name)


@pytest.mark.parametrize("name", GRID_CASES)
def test_fsdp2_tensor2_step_is_the_one_process_step(runs, name):
    _check_against_one_process(runs["grid"], name)


def test_hsdp_tensor2_step_is_the_one_process_step(runs):
    """data 2 x tensor 2: FSDP2 over a 2-D (data, fsdp) slice of the mesh."""
    _check_against_one_process(runs["hsdp"], "lora_dropout32")
    assert runs["hsdp"]["ranks"][0]["lora_dropout32"]["placements"][
        "model.layers.0.self_attn.q_proj.lora_b"] == "(Replicate(), Shard(dim=0))"


def test_tensor2_placements_split_the_decoder(runs):
    """The adapters of a layer lie as parallel/sharding.py says: on
    ``tensor`` 2 a column-parallel lora_b and a row-parallel lora_a hold
    half the whole tensor on each rank (FSDP2 over one rank: Shard(0))."""
    res = runs["tp2"]["ranks"][0]["lora_dropout32"]
    assert res["placements"]["model.layers.0.self_attn.q_proj.lora_b"] == "(Shard(dim=0),)"
    model = make_model(tiny_config(use_lora=True), runs["fit"]["sd"])
    split_decoder(model, MeshEnv({"data": 1, "fsdp": 1, "tensor": 2, "sequence": 1}, rank=1))
    layer = model.model.layers[0]
    assert tuple(layer.self_attn.q_proj.lora_b.shape) == (4, 32) and tuple(layer.self_attn.q_proj.lora_a.shape) == (64, 4)
    assert tuple(layer.self_attn.o_proj.lora_a.shape) == (32, 4) and tuple(layer.self_attn.o_proj.lora_b.shape) == (4, 64)
    assert tuple(layer.self_attn.k_proj.weight.shape) == (16, 64) and tuple(layer.mlp.down_proj.weight.shape) == (64, 64)


def test_remat_policies_under_tensor2_are_bit_equal(runs):
    """Each policy's step against ``'nothing'``'s on the same rank: the
    replay runs the same collectives on the same values."""
    for res in runs["tp2"]["ranks"]:
        ref = res["remat_nothing"]
        for policy in POLICIES[1:]:
            got = res[f"remat_{policy}"]
            assert got["loss"] == ref["loss"] and got["grad_norm"] == ref["grad_norm"], policy
            assert all(torch.equal(got["grads"][k], g) for k, g in ref["grads"].items()), policy
    _check_against_one_process(runs["tp2"], "remat_dots")


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_int8_base_products_match_one_process(runs, mode):
    """Each projection of the tiny int8 model on the same x and output
    gradient: the products bit-equal as the module's note says."""
    cfg = tiny_config(use_lora=True, base_quant=mode)
    model = make_model(cfg, runs["quant_sd"])
    got = runs["tp2"]["products"][0][QUANT_MODES.index(mode)]
    other = runs["tp2"]["products"][1][QUANT_MODES.index(mode)]
    for i, (name, proj) in enumerate(_projections(model)):
        key = f"{i}.{name}"
        row = name in ("o_proj", "down_proj")
        x = got[key]["x"].clone().requires_grad_()
        y = proj._base_product(x)
        y.backward(got[key]["dy"])
        for part, want in (("y", y.detach()), ("dx", x.grad)):
            assert torch.equal(got[key][part], other[key][part]), (key, part)        # both ranks hold it
            exact = part == "dx" and (row or mode == "w8a8g8") or part == "y" and (not row or mode != "int8")
            if exact:
                assert torch.equal(got[key][part], want), (key, part)
            else:
                tol = STE_TOL if mode == "w8a8" else PRODUCT_TOL
                np.testing.assert_allclose(got[key][part].numpy(), want.numpy(), rtol=0,
                                           atol=tol * float(want.abs().max()), err_msg=f"{key} {part}")


def test_tensor2_step_matches_jax(runs, cpu_devices):
    run = runs["tp2"]
    for use_lora, name in ((True, "jax_lora"), (False, "jax_baseline")):
        sc = run["scenarios"][name]
        params = runs["params"][use_lora]
        jmodel = jv.VideoLLaMA2VLB(jv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0))
        env = jbuild_mesh(JMeshConfig(data=1, fsdp=1, tensor=2), devices=cpu_devices[:2])
        labels = _labels(params)
        tx = joptim.make_optimizer(joptim.OptimConfig())
        state, frozen = init_train_state(shard_params(params, env)[0], tx, labels)
        batch = {k: jax.device_put(jnp.asarray(v), env.batch()) for k, v in sc["batches"][0].items()}
        new_state, metrics = make_train_step(jv.vlb_forward_fn(jmodel), tx, labels, donate=False)(
            state, frozen, batch, jax.random.key(0))
        want = _as_state_dict(new_state.params, params)
        before = from_flax_params(params)
        for res in (r[name] for r in run["ranks"]):
            np.testing.assert_allclose(res["loss"][0], float(metrics["brain_loss"]), rtol=LOSS_TOL)
            assert set(res["params"]) == {k for k in want if tv.trainable_predicate(k)}
            for k, p in res["params"].items():
                delta_t, delta_j = (p - before[k]).numpy(), (want[k] - before[k]).numpy()
                assert np.abs(delta_j).max() > 0, k
                ulps = 2 * np.spacing(np.abs(before[k].numpy()).max())
                atol = _update_atol(UPDATE_TOL * LR + ulps, res["grads"][k], GRAD_TOL, 1)
                assert (np.abs(delta_t - delta_j) <= atol).all(), k


def test_last_restores_across_mesh_shapes(runs, tmp_path):
    fit = runs["fit"]
    # fsdp 2 x tensor 2 -> one process: the ranks' last, whole and bit for bit.
    grid = runs["grid"]["fit"]
    assert all(r["step"] == runs["one"]["step"] == 3 for r in grid)
    saved = torch.load(runs["root"] / "grid_fit" / "last" / "state.pt", weights_only=True)
    for r in grid:
        _same_state(saved, r["state"])
    back = _one_process_fit(fit["sd"], fit["cfg"], fit["train"], fit["val"], runs["root"] / "grid_fit", 2,
                            resume=True)
    _same_state(back["resumed"], saved)
    # one process -> tensor 2 and -> fsdp 2 x tensor 2: each rank resumes it whole.
    for r in runs["tp2"]["resume"] + runs["grid"]["resume"]:
        _same_state(r["resumed"], runs["one"]["state"])
        assert r["step"] == 6
