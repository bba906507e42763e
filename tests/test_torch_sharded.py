"""The port's multi-process training path on 2 gloo ranks of the CPU.

``core/mesh.py`` against the JAX ``MeshConfig`` (sizes and errors, the
cases of ``tests/test_mesh.py``); ``parallel/sharding.py``'s rule table
against the JAX ``infer_param_shardings`` on ``VLBConfig.tiny(use_lora=True)``
under ``MeshConfig(fsdp=4, tensor=2)`` (each JAX leaf's ``fsdp`` axis found
in the port's tensor by carrying an index array through
``from_flax_params``), and the placements ``fully_shard`` gave on 2 ranks;
the dropout masks of a rank's rows (``row0`` of the hash, the generator
paths' global draw); the sharded LoRA and baseline steps on 2 ranks
(``tests/torch_ranks.py``) against the one-process step on the same global
batch with dropout at 0.1 (32-bit generator masks and the fused u8 path's
plain version), the first of them also on a 2-D mesh (``data`` 2 x
``fsdp`` 1: HSDP), and against JAX's step under ``MeshConfig(fsdp=2)`` on
the 8-device virtual mesh without dropout; a batch whose rank-1 rows are all
padding, the L2 penalty counted once, and a non-finite loss that every
rank skips; ``VLBTrainer.fit`` on 2 ranks against one process (metrics.csv
with the merged Pearson; ``last`` restored 2 -> 1 and 1 -> 2 bit for bit);
the loader's rank split.

Tolerances, f32 throughout: the ranks sum their rows' squared errors and
gradients apart, then add the two sums, so only the order of f32 sums
differs from one process: the loss and the gradient norm 1e-6 relative,
each gradient 1e-5 x its max|g|, the AdamW moments 1e-5 relative to their
max; an updated tensor 2 x 1e-3 x lr per step plus two f32 ulps of its
magnitude (Adam divides by sqrt(v) + eps, so a gradient near eps moves its
update by up to its own relative error). Against JAX:
``tests/test_torch_train_step.py``'s tolerances.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.core.mesh import MeshConfig as JMeshConfig
from phantom_vlb_tpu.core.mesh import build_mesh as jbuild_mesh
from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.parallel.sharding import infer_param_shardings as jinfer
from phantom_vlb_tpu.parallel.sharding import shard_params
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu.train.step import init_train_state, make_train_step
from phantom_vlb_tpu_torch.core import distributed
from phantom_vlb_tpu_torch.core.mesh import MeshConfig, MeshEnv, build_mesh
from phantom_vlb_tpu_torch.data.loader import Batch, BatchLoader, RankRows
from phantom_vlb_tpu_torch.data.schemas import LazySample
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.heads import BrainReadoutHead
from phantom_vlb_tpu_torch.models.lora import LoRAConfig, adapter_dropout
from phantom_vlb_tpu_torch.ops.lora_fused import (
    dropout_threshold,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
)
from phantom_vlb_tpu_torch.parallel.sharding import fsdp_dim, infer_param_shardings, shard_model
from phantom_vlb_tpu_torch.train.metrics import pearson_init, pearson_merge, pearson_update
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig
from phantom_vlb_tpu_torch.train.step import train_step
from test_torch_train_step import GRAD_TOL, LOSS_TOL, UPDATE_TOL, _as_state_dict, _batch, _labels, _pair
from torch_ranks import fit_run, make_model, run_ranks, tiny_config

WORLD = 2
RANK_LOSS_TOL, RANK_GRAD_TOL, RANK_MOMENT_TOL, RANK_UPDATE_TOL = 1e-6, 1e-5, 1e-5, 1e-3
LR = OptimConfig().lr


# ---------------------------------------------------------------------------
# The mesh and the rule table.

MESH_CASES = [((), 8), ((("data", 2), ("fsdp", 2), ("tensor", 2)), 8), ((("data", 3), ("fsdp", -1)), 8),
              ((("data", -1), ("fsdp", -1)), 8), ((("fsdp", 2),), 4), ((("fsdp", -1), ("tensor", 2)), 6),
              ((("fsdp", -1),), 1)]


@pytest.mark.parametrize("axes,n", MESH_CASES, ids=[f"{dict(a)}-{n}" for a, n in MESH_CASES])
def test_mesh_sizes_and_errors_match_jax(axes, n):
    kw = dict(axes)
    try:
        want = JMeshConfig(**kw).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[").replace("]", r"\]")):
            MeshConfig(**kw).sizes(n)
    else:
        assert MeshConfig(**kw).sizes(n) == want


def test_one_process_mesh_shards_nothing():
    assert not distributed.maybe_initialize_distributed("cpu")          # no launcher's variables
    assert distributed.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                          "global_devices": 1}
    assert not distributed.is_multihost()
    env = build_mesh(MeshConfig(), "cpu")
    assert not env.sharded and env.n_devices == env.batch_divisor == 1 and env.local_rows(3) == slice(0, 3)
    assert MeshConfig.from_config({"fsdp": 1, "data": 1}) == MeshConfig(fsdp=1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        build_mesh(MeshConfig(fsdp=2), "cpu")
    two = MeshEnv({"data": 1, "fsdp": 2, "tensor": 1, "sequence": 1}, rank=1)
    assert two.local_rows(4) == slice(2, 4) and two.rows(2) == (2, 4)
    with pytest.raises(ValueError, match="3 rows does not split over the mesh's batch axes of 2"):
        two.local_rows(3)


def test_nccl_over_more_than_one_card_needs_the_opt_in(monkeypatch):
    """An NCCL group of 2 is refused by name, before any card or group is
    touched, unless ``VLB_NCCL_MULTI_CARD=1``; with it the call goes on
    (here to the missing card)."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv(distributed.MULTI_CARD_OPT_IN, raising=False)
    with pytest.raises(NotImplementedError, match="VLB_NCCL_MULTI_CARD=1.*ROADMAP|ROADMAP.*VLB_NCCL_MULTI_CARD=1"):
        distributed.maybe_initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv(distributed.MULTI_CARD_OPT_IN, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        distributed.maybe_initialize_distributed("cuda")


def _jax_tiny_params():
    from __graft_entry__ import _example_batch

    cfg = jv.VLBConfig.tiny(use_lora=True)
    b = _example_batch(cfg.geometry, 2, cfg.mistral.vocab_size)
    return jax.eval_shape(jv.VideoLLaMA2VLB(cfg).init, jax.random.key(0), b["language"], b["vision"],
                          b["padvals"], b["vis_weights"], b["lang_weights"])["params"]


def test_rule_table_matches_jax(cpu_devices):
    """Each JAX leaf's fsdp axis carried into the port's layout: a leaf
    becomes an array whose values index that axis (-1 everywhere when no
    axis is sharded), and the port tensor from_flax_params makes of it
    varies along exactly that axis's dim."""
    params = _jax_tiny_params()
    specs = jinfer(params, jbuild_mesh(JMeshConfig(data=1, fsdp=4, tensor=2)))

    def mark(spec, leaf):
        axis = next((i for i, e in enumerate(spec) if e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e)),
                    None)
        return np.full(leaf.shape, -1) if axis is None else np.indices(leaf.shape)[axis]

    marked = from_flax_params(jax.tree.map(mark, specs, params,
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    with torch.device("meta"):
        model = tv.VideoLLaMA2VLB(tv.VLBConfig.tiny(use_lora=True))
    got = infer_param_shardings(model, MeshEnv({"data": 1, "fsdp": 4, "tensor": 2, "sequence": 1}))
    assert set(got) == set(marked)
    sharded = 0
    for name, t in marked.items():
        varying = [d for d in range(t.dim()) if (t.amax(d) != t.amin(d)).any()]
        want = None if bool((t < 0).all()) else (varying[0] if varying else 0)
        assert fsdp_dim(got[name]) == want, (name, got[name])
        sharded += want is not None
    assert sharded > 20


def test_mesh_refuses_what_is_not_ported(monkeypatch):
    """What a mesh of processes still refuses by name: the rings and
    ``sequence`` > 1 (``tensor`` > 1 and ``base_quant`` run:
    ``tests/test_torch_tensor_parallel.py``; the caches:
    ``tests/test_torch_mesh_caches.py``)."""
    fake = MeshEnv({"data": 1, "fsdp": 2, "tensor": 1, "sequence": 1}, rank=0, device_mesh=object())
    from phantom_vlb_tpu_torch.models.mistral import set_attention_impl

    ring = tv.VideoLLaMA2VLB(tv.VLBConfig.tiny(use_lora=True), vision=False)
    set_attention_impl(ring, "ring_fused")
    with pytest.raises(NotImplementedError, match="ring_fused"):
        shard_model(ring, fake)
    # build_mesh refuses sequence > 1 across processes before it builds a DeviceMesh.
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="sequence axis across processes"):
        build_mesh(MeshConfig(fsdp=1, sequence=2), "cpu")


# ---------------------------------------------------------------------------
# A rank's rows of each dropout mask.

@pytest.mark.parametrize("row0", [0, 3, 64])
def test_hash_bytes_of_a_rank_are_the_rows_of_the_one_card_mask(row0):
    m, k, seed = 16, 96, 1234
    whole = hash_bytes(seed, row0 + m + 5, k)
    assert torch.equal(hash_bytes(seed, m, k, row0=row0), whole[row0:row0 + m])
    rng = np.random.default_rng(row0)
    x = torch.from_numpy(rng.standard_normal((row0 + m, k)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((k, 4)).astype(np.float32))
    dmid = torch.from_numpy(rng.standard_normal((row0 + m, 4)).astype(np.float32))
    thr, _ = dropout_threshold(0.1)
    rows = slice(row0, row0 + m)
    assert torch.equal(fused_dropout_matmul_plain(x[rows], a, seed, thr, row0=row0),
                       fused_dropout_matmul_plain(x, a, seed, thr)[rows])
    dx, _ = fused_dropout_bwd_plain(x[rows], a, dmid[rows], seed, thr, row0=row0)
    assert torch.equal(dx, fused_dropout_bwd_plain(x, a, dmid, seed, thr)[0][rows])
    got = fused_dropout_matmul(x[rows].requires_grad_(), a, seed, 0.1, row0=row0)
    assert torch.equal(got, fused_dropout_matmul_plain(x, a, seed, thr)[rows].to(got.dtype))


@pytest.mark.parametrize("bits", [32, 8])
def test_generator_masks_of_a_rank_are_the_rows_of_the_global_draw(bits):
    cfg = LoRAConfig(dropout=0.3, dropout_bits=bits)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 5, 32)).astype(np.float32))
    want = adapter_dropout(x, cfg, seed=9)
    for r0 in (0, 2):
        assert torch.equal(adapter_dropout(x[r0:r0 + 2], cfg, 9, rows=(r0, 4)), want[r0:r0 + 2])
    head = BrainReadoutHead(8, 3, dropout_rate=0.5).train()
    h, w = torch.randn(4, 6, 8), torch.rand(4, 6)
    full = head(h, w, seed=11)[0]
    assert torch.equal(head(h[2:], w[2:], seed=11, rows=(2, 4))[0], full[2:])


# ---------------------------------------------------------------------------
# The sharded step on 2 ranks.

def _dropout_pair(use_lora):
    _, params, _ = _pair(use_lora)
    return params, from_flax_params(params)


def _scenarios(lora_sd, base_sd):
    rng = np.random.default_rng(20)
    b4 = [_batch(rng, 4), _batch(rng, 4, [1, 1, 1, 0])]
    nan = _batch(rng, 4)
    nan["timeseries"][3] = np.nan                                       # a row of rank 1
    lora32 = tiny_config(use_lora=True, dropout=0.1, bits=32, remat=True)
    return [
        {"name": "lora_dropout32", "sd": lora_sd, "cfg": lora32, "batches": b4, "seeds": [5, 6]},
        {"name": "lora_fused_u8", "sd": lora_sd, "cfg": tiny_config(use_lora=True, dropout=0.1, bits=8, fused=True),
         "batches": b4, "seeds": [5, 6]},
        {"name": "baseline_dropout", "sd": base_sd, "cfg": tiny_config(use_lora=False, dropout=0.1),
         "batches": b4, "seeds": [5, 6]},
        {"name": "rank1_padding", "sd": lora_sd, "cfg": tiny_config(use_lora=True),
         "batches": [_batch(rng, 4, [1, 1, 0, 0])], "seeds": [3]},
        {"name": "l2_once", "sd": base_sd, "cfg": tiny_config(use_lora=False, l2_lambda=1.0),
         "batches": [_batch(rng, 4)], "seeds": [3]},
        {"name": "non_finite", "sd": lora_sd, "cfg": lora32, "batches": [b4[0], nan], "seeds": [5, 6]},
        {"name": "jax_lora", "sd": lora_sd, "cfg": tiny_config(use_lora=True), "batches": [_batch(rng, 4)],
         "seeds": [0]},
        {"name": "jax_baseline", "sd": base_sd, "cfg": tiny_config(use_lora=False), "batches": [_batch(rng, 4)],
         "seeds": [0]},
    ]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    (lora_params, lora_sd), (base_params, base_sd) = _dropout_pair(True), _dropout_pair(False)
    scenarios = _scenarios(lora_sd, base_sd)
    ranks = run_ranks("steps", WORLD, tmp_path_factory.mktemp("steps"), scenarios=scenarios)
    return {"scenarios": {s["name"]: s for s in scenarios}, "ranks": ranks,
            "params": {True: lora_params, False: base_params}}


def _one_process(sc):
    model = make_model(sc["cfg"], sc["sd"])
    tv.trainable_parameters(model)
    model.train()
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    optimizer = AdamWCosine(trainable.values(), OptimConfig())
    res = {"loss": [], "grad_norm": [], "finite": [], "l2": []}
    for i, batch in enumerate(sc["batches"]):
        r = train_step(model, optimizer, {k: torch.as_tensor(v) for k, v in batch.items()}, sc["seeds"][i])
        res["loss"].append(r["brain_loss"].item())
        res["l2"].append(r["l2_reg"].item())
        res["grad_norm"].append(r["grad_norm"].item())
        res["finite"].append(r["finite"])
        if i == 0:
            res["grads"] = {k: p.grad.clone() for k, p in trainable.items()}
    res["params"] = {k: p.detach().clone() for k, p in trainable.items()}
    res["optimizer"] = optimizer.state_dict()
    return res


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * max(float(want.abs().max()), 1e-30), err_msg=name)


STEP_CASES = ["lora_dropout32", "lora_fused_u8", "baseline_dropout", "rank1_padding", "l2_once", "non_finite"]


@pytest.fixture(scope="module")
def hsdp(tmp_path_factory):
    """The 32-bit dropout LoRA scenario on a 2-D mesh: data 2 x fsdp 1 (HSDP)."""
    _, lora_sd = _dropout_pair(True)
    (sc,) = [s for s in _scenarios(lora_sd, lora_sd) if s["name"] == "lora_dropout32"]
    ranks = run_ranks("steps", WORLD, tmp_path_factory.mktemp("hsdp"), scenarios=[sc],
                      mesh={"data": 2, "fsdp": 1})
    return {"scenarios": {sc["name"]: sc}, "ranks": ranks}


@pytest.mark.parametrize("name", STEP_CASES)
def test_sharded_step_is_the_one_process_step(sharded, name):
    _check_against_one_process(sharded, name)


def test_hsdp_step_is_the_one_process_step(hsdp):
    _check_against_one_process(hsdp, "lora_dropout32")
    assert hsdp["ranks"][0]["lora_dropout32"]["placements"]["model.layers.0.self_attn.q_proj.lora_a"] == \
        "(Replicate(), Shard(dim=0))"


def _check_against_one_process(run, name, update_atol=None):
    """Each rank's steps against one process's; ``update_atol(base, grad,
    steps)`` may widen an updated tensor's per-element bound ``base`` from
    its first-step gradient (``tests/test_torch_tensor_parallel.py``)."""
    sc = run["scenarios"][name]
    want = _one_process(sc)
    steps = len(sc["batches"])
    for rank, res in enumerate(r[name] for r in run["ranks"]):
        assert res["finite"] == want["finite"], rank
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=RANK_LOSS_TOL)
        np.testing.assert_allclose(res["grad_norm"], want["grad_norm"], rtol=RANK_LOSS_TOL)
        assert res["l2"] == want["l2"]
        for k, g in want["grads"].items():
            _close(res["grads"][k], g, RANK_GRAD_TOL, k)
        for k, p in want["params"].items():
            ulps = 2 * np.spacing(np.float32(p.abs().max()))
            atol = steps * 2 * RANK_UPDATE_TOL * LR + ulps
            if update_atol is None:
                np.testing.assert_allclose(res["params"][k].numpy(), p.numpy(), rtol=0, atol=atol, err_msg=k)
            else:
                bound = update_atol(atol, want["grads"][k], steps)
                assert (np.abs(res["params"][k].numpy() - p.numpy()) <= bound).all(), k
        opt, opt_want = res["optimizer"], want["optimizer"]
        assert opt["step"] == opt_want["step"]
        for i, s in opt_want["adamw"]["state"].items():
            for key, v in s.items():
                if key == "step":
                    assert torch.equal(opt["adamw"]["state"][i][key], v)
                else:
                    _close(opt["adamw"]["state"][i][key], v, RANK_MOMENT_TOL, f"{i}.{key}")
    if name == "non_finite":
        assert want["finite"] == [True, False]
        assert all(r[name]["unchanged"] for r in run["ranks"])
        assert all(r[name]["optimizer"]["step"] == 1 for r in run["ranks"])
    if name == "l2_once":
        assert want["l2"][0] > 0.1 * want["loss"][0]        # the penalty weighs on loss and gradient


def test_fully_shard_placements_follow_the_table(sharded):
    res = sharded["ranks"][0]["jax_lora"]
    model = make_model(sharded["scenarios"]["jax_lora"]["cfg"], sharded["scenarios"]["jax_lora"]["sd"])
    specs = infer_param_shardings(model, MeshEnv({"data": 1, "fsdp": WORLD, "tensor": 1, "sequence": 1}))
    assert set(res["placements"]) == set(specs)
    for name, spec in specs.items():
        d = fsdp_dim(spec)
        assert res["placements"][name] == f"(Shard(dim={0 if d is None else d}),)", name
    assert any(fsdp_dim(s) == 1 for s in specs.values())


@pytest.mark.parametrize("use_lora", [True, False], ids=["lora", "baseline"])
def test_sharded_step_matches_jax_fsdp2(sharded, use_lora, cpu_devices):
    name = "jax_lora" if use_lora else "jax_baseline"
    sc = sharded["scenarios"][name]
    params = sharded["params"][use_lora]
    jmodel = jv.VideoLLaMA2VLB(jv.VLBConfig.tiny(use_lora=use_lora, dropout_rate=0.0))
    env = jbuild_mesh(JMeshConfig(data=1, fsdp=2, tensor=1), devices=cpu_devices[:2])
    labels = _labels(params)
    tx = joptim.make_optimizer(joptim.OptimConfig())
    state, frozen = init_train_state(shard_params(params, env)[0], tx, labels)
    batch = {k: jax.device_put(jnp.asarray(v), env.batch()) for k, v in sc["batches"][0].items()}
    new_state, metrics = make_train_step(jv.vlb_forward_fn(jmodel), tx, labels, donate=False)(
        state, frozen, batch, jax.random.key(0))
    want = _as_state_dict(new_state.params, params)
    before = from_flax_params(params)
    for res in (r[name] for r in sharded["ranks"]):
        np.testing.assert_allclose(res["loss"][0], float(metrics["brain_loss"]), rtol=LOSS_TOL)
        assert set(res["params"]) == {k for k in want if tv.trainable_predicate(k)}
        for k, p in res["params"].items():
            delta_t, delta_j = (p - before[k]).numpy(), (want[k] - before[k]).numpy()
            assert np.abs(delta_j).max() > 0, k
            ulps = 2 * np.spacing(np.abs(before[k].numpy()).max())
            np.testing.assert_allclose(delta_t, delta_j, atol=UPDATE_TOL * LR + ulps, rtol=0, err_msg=k)
        assert max(float(g.abs().max()) for g in res["grads"].values()) > GRAD_TOL


# ---------------------------------------------------------------------------
# The trainer on 2 ranks, and checkpoints across world sizes.

def _fit_data():
    rng = np.random.default_rng(30)
    train = [_batch(rng, 4), _batch(rng, 4), _batch(rng, 4, [1, 1, 1, 0])]
    val = [_batch(rng, 4), _batch(rng, 4, [1, 1, 0, 0])]
    return train, val


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _one_process_fit(sd, cfg, train, val, out, epochs, resume=False):
    return fit_run(sd, cfg, [dict(b) for b in train], [dict(b) for b in val], str(out), epochs, resume, None,
                   lambda loader: loader)


def _same_state(a, b):
    assert a["step"] == b["step"] and set(a["params"]) == set(b["params"])
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert a["optimizer"]["step"] == b["optimizer"]["step"] and sa.keys() == sb.keys()
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


def test_fit_on_two_ranks_and_resume_across_world_sizes(tmp_path):
    _, sd = _dropout_pair(True)
    cfg = tiny_config(use_lora=True, dropout=0.1, bits=32)
    train, val = _fit_data()
    two = run_ranks("fit", WORLD, tmp_path / "ranks", sd=sd, cfg=cfg, train=train, val=val,
                    out_dir=str(tmp_path / "two"), max_epochs=1, resume=False)
    one = _one_process_fit(sd, cfg, train, val, tmp_path / "one", 1)
    assert two[0]["step"] == two[1]["step"] == one["step"] == 3
    assert two[1]["csv"] == ""                                       # rank 1 writes nothing
    assert sorted(p.name for p in (tmp_path / "two" / "run").iterdir()) == ["version_0"]
    got, want = _csv(two[0]["csv"]), _csv(one["csv"])
    assert len(got) == len(want) == 6 and got[0].keys() == want[0].keys()
    assert sum(1 for r in got if r["val_corr_avg"]) == 3
    for g, w in zip(got, want):
        for key, value in w.items():
            if key == "train/steps_per_sec" or value == "":
                assert (g[key] == "") == (value == ""), key
                continue
            np.testing.assert_allclose(float(g[key]), float(value), rtol=1e-5, atol=1e-6, err_msg=key)
    for rank in two:
        np.testing.assert_allclose(rank["state"]["params"]["head.ridge.linear.weight"].numpy(),
                                   one["state"]["params"]["head.ridge.linear.weight"].numpy(), atol=1e-6)
    # 2 -> 1: one process resumes the ranks' last, whole and bit for bit.
    saved = torch.load(tmp_path / "two" / "last" / "state.pt", weights_only=True)
    _same_state(saved, two[0]["state"])
    back = _one_process_fit(sd, cfg, train, val, tmp_path / "two", 2, resume=True)
    _same_state(back["resumed"], saved)
    assert back["step"] == 6
    # 1 -> 2: each rank resumes one process's last bit for bit (gathered whole).
    forth = run_ranks("fit", WORLD, tmp_path / "ranks2", sd=sd, cfg=cfg, train=train, val=val,
                      out_dir=str(tmp_path / "one"), max_epochs=2, resume=True)
    for rank in forth:
        _same_state(rank["resumed"], one["state"])
        assert rank["step"] == 6


def test_pearson_merge_of_ranks_is_the_one_state():
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.standard_normal((10, 5)).astype(np.float32)) for _ in range(2))
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    one = pearson_update(pearson_init(5), x, y, mask)
    ranks = [pearson_update(pearson_init(5), x[r:r + 5], y[r:r + 5], mask[r:r + 5]) for r in (0, 5)]
    merged = pearson_merge(ranks[0], ranks[1])
    empty = pearson_update(pearson_init(5), x[6:], y[6:], mask[6:])          # n = 0
    assert torch.equal(pearson_merge(merged, empty).cxy, merged.cxy)
    for f in dataclasses.fields(merged):
        np.testing.assert_allclose(getattr(merged, f.name).numpy(), getattr(one, f.name).numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The loader's rank split.

class CountingDataset:
    def __init__(self, n):
        rng = np.random.default_rng(5)
        self.samples = [LazySample(timeseries=rng.standard_normal(3).astype(np.float32),
                                   vision=rng.standard_normal((2, 4)).astype(np.float32),
                                   vis_weights=rng.uniform(0, 1, 2), language=rng.integers(0, 9, 6),
                                   lang_weights=rng.uniform(0, 1, 3), padvals=rng.integers(0, 5, 3))
                        for _ in range(n)]
        self.reads = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.reads.append(i)
        return self.samples[i]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_rank_split(prefetch):
    n, batch = 9, 4                                 # the last global batch: 1 real row, rank 1 all padding
    whole = list(BatchLoader(CountingDataset(n), batch, shuffle=True, seed=3, prefetch=prefetch))
    order = np.concatenate(BatchLoader(CountingDataset(n), batch, shuffle=True, seed=3)._batch_indices())
    per_rank = []
    for rank in range(WORLD):
        ds = CountingDataset(n)
        loader = BatchLoader(ds, batch, shuffle=True, seed=3, prefetch=prefetch, mesh=MeshEnv(
            {"data": 1, "fsdp": WORLD, "tensor": 1, "sequence": 1}, rank=rank))
        per_rank.append(list(loader))
        mine = [order[i] for i in range(n) if (i % batch) // (batch // WORLD) == rank]
        # Only its own rows, plus the one sample a rank of padding rows repeats.
        assert sorted(ds.reads) == sorted(mine + ([order[-1]] if rank == 1 else []))
    assert len(per_rank[0]) == len(per_rank[1]) == len(whole) == 3
    for g, parts in zip(whole, zip(*per_rank)):
        for field, value in g.as_dict().items():
            joined = np.concatenate([p.as_dict()[field] for p in parts])
            assert joined.dtype == value.dtype and joined.tobytes() == value.tobytes(), field
    assert per_rank[1][-1].row_mask.tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="global batch of 3 rows does not split over the mesh's batch axes of 2"):
        BatchLoader(CountingDataset(n), 3, mesh=MeshEnv({"data": 1, "fsdp": 2, "tensor": 1, "sequence": 1}))
    ranked = list(RankRows([g.as_dict() for g in whole], MeshEnv(
        {"data": 1, "fsdp": 2, "tensor": 1, "sequence": 1}, rank=1)))
    assert all(np.array_equal(r["timeseries"], p.timeseries) for r, p in zip(ranked, per_rank[1]))
    assert isinstance(per_rank[0][0], Batch)
