"""Port: the JAX trainer's Orbax checkpoints, converted by
``scripts/orbax_to_torch.py`` (``phantom_vlb_tpu_torch/train/from_jax.py``),
resumed, served and loaded by the port on the CPU.

A tiny LoRA run of the JAX package (``build_trainer`` over lazy-load files
that the JAX stages built, 1 epoch of 3 steps, dropout off: the two
packages draw other masks) starts from an Orbax full param tree given as
``model.checkpoint_path`` and writes its checkpoint root (``last``,
``best_brainloss_*``, ``trainer_state.json``, ``adapters``). Both are
converted (the root whole; the param tree one leaf at a time). Then:

- the port resumes the converted root at JAX's step: trainable tensors and
  both AdamW moments bit-equal to the Orbax state after layout, the
  schedule's and Adam's step counts, the rate, and ``trainer_state.json``
  carried; its next step is held against JAX's next step from the same
  state: loss, tensors, ``exp_avg`` and ``exp_avg_sq`` within
  ``tests/test_torch_trainer.py``'s STEPS_TOL (relative to each tensor's
  largest magnitude), as its resume test holds 10 updates;
- ``vlb-predict-torch`` from the converted ``last`` and param tree
  against ``vlb-predict`` from the Orbax ones: predictions and targets
  within 1e-4 of their largest magnitude, r within 1e-4
  (``tests/test_torch_predict.py``'s bounds);
- the converted adapters export against JAX's ``load_adapters``, and the
  converted param tree as ``model.checkpoint_path`` against the Orbax
  tree: bit-equal;
- conversion cases: f32 and bf16 leaves, the per-layer and stacked decoder
  trees, an optax state under ``multi_transform``, a state sharded over
  the 8 virtual devices (restored whole), and a stray leaf raising by name;
- an unconverted Orbax directory given to the port names the converter.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from phantom_vlb_tpu.data.synthetic import TEST_GEOMETRY, write_synthetic_bold_file, write_synthetic_features_file
from phantom_vlb_tpu.models.convert import stack_layer_params
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import PORT_LAYOUT, SafetensorsDir, from_flax_params
from phantom_vlb_tpu_torch.train.checkpoint import ADAPTERS_FILE, STATE_FILE
from phantom_vlb_tpu_torch.train.from_jax import convert
from phantom_vlb_tpu_torch.train.loop import is_adapter
from phantom_vlb_tpu_torch.train.optim import learning_rate
from test_torch_train_step import _pair
from test_torch_trainer import LR_TOL, STEPS_TOL

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import orbax_to_torch  # noqa: E402

G = TEST_GEOMETRY
CONFIGS = ROOT / "configs"
PRED_TOL = 1e-4


def _args(pattern, out, ckpt, run_name):
    return [
        "experiment=vlb_friends_lora", "subject=sub-01", f"datamodule.lazyload_path={pattern}",
        "datamodule.seasons=[s1]", "datamodule.batch_size=4", "datamodule.num_workers=2",
        "model.preset=tiny", "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0",
        "model.dropout_rate=0.0", f"model.checkpoint_path={ckpt}", "trainer.max_epochs=1",
        "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=1", "optim.t_max=100",
        f"output_dir={out}", f"run_name={run_name}",
    ]


def _jax_args(*args):
    # The JAX builder lays the model over the 8-device CPU mesh (batch 4 on fsdp 4).
    return [*_args(*args), "mesh.fsdp=4", "mesh.tensor=2"]


def _port_args(*args):
    return [*_args(*args), "mesh.fsdp=1"]


def _save_orbax(path, tree):
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(Path(path).resolve(), tree)
    ckpt.wait_until_finished()


def _restore_raw(path):
    return orbax_to_torch.make_restore()(Path(path))


def _convert(src, dst):
    assert orbax_to_torch.main([str(src), str(dst)]) == 0


def _numpy(tree):
    """Host copies (a zero-copy view of a donated buffer would not last)."""
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX run, its predictions from Orbax, and both conversions."""
    from phantom_vlb_tpu.cli.build_lazyload import main as build_lazyload
    from phantom_vlb_tpu.cli.predict import run_predict
    from phantom_vlb_tpu.core.config import load_config
    from phantom_vlb_tpu.train import builder as jbuilder

    root = tmp_path_factory.mktemp("from_jax")
    eps = {"s01e01a": 7, "s01e01b": 7, "s01e02a": 7}          # 3 train batches of 4
    write_synthetic_features_file(root / "features_s1.h5", eps, G, seed=0)
    write_synthetic_bold_file(root / "bold.h5", eps, G, seed=1)
    (root / "lazy").mkdir()
    assert build_lazyload([
        "--features_path", str(root / "features_s1.h5"), "--timeseries_path", str(root / "bold.h5"),
        "--lazyload_path", str(root / "lazy"), "--subject", "sub-01", "--season", "s1",
        "--n_split", "2", "--window", str(G.window), "--delay", str(G.delay)]) == 0
    pattern = str(root / "lazy" / "friends_llFile_sub-01_s*_n*.h5")

    # The full param tree as model.checkpoint_path, from another seed than the run's.
    jconfig = load_config(str(CONFIGS), "base", _jax_args(pattern, root / "jax", root / "full", "r"))
    jmodel = jbuilder.VideoLLaMA2VLB(jbuilder.build_model_config(jconfig.model))
    full = _numpy(jbuilder.init_model_params(jmodel, G, jmodel.config.mistral.vocab_size, 5))
    _save_orbax(root / "full", full)

    trainer, train_loader, val_loader = jbuilder.build_trainer(jconfig)
    trainer.fit(train_loader, val_loader)
    batch = next(iter(train_loader))
    batch = {k: np.asarray(v) for k, v in (batch.as_dict() if hasattr(batch, "as_dict") else batch).items()}
    saved, jparams = _numpy(trainer.state), _numpy(trainer.full_params())
    # JAX's next step from the state last holds (dropout off: the key is unused).
    state, metrics = trainer.train_step(trainer.state, trainer.frozen, trainer._put(batch),
                                        jax.random.key(0))
    run_predict(load_config(str(CONFIGS), "base", [
        *_jax_args(pattern, root / "jax_pred", root / "full", "p"),
        f"predict.checkpoint={root / 'jax' / 'last'}", f"predict.out={root / 'jax.h5'}"]))

    _convert(root / "jax", root / "port")
    _convert(root / "full", root / "full_t")
    return {"root": root, "pattern": pattern, "full": full, "saved": saved, "batch": batch,
            "next_state": _numpy(state), "next_loss": float(metrics["brain_loss"]),
            "steps": trainer.global_step, "jparams": jparams}


def _port_config(run, out, run_name, *extra):
    from phantom_vlb_tpu_torch.core.config import load_config

    return load_config(CONFIGS, "base", [*_port_args(run["pattern"], out, run["root"] / "full_t", run_name),
                                         *extra])


def _moments(opt_state):
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return adam


def _assert_state(trainer, params, adam, tol=0.0):
    """The trainer's tensors and moments against a JAX trainable tree and
    Adam state, after layout: bit-equal at tol 0, else within tol of each
    tensor's largest magnitude."""
    want = {"param": from_flax_params(params), "exp_avg": from_flax_params(_numpy(adam.mu)),
            "exp_avg_sq": from_flax_params(_numpy(adam.nu))}
    opt = trainer.optimizer.state_dict()
    names = list(trainer.trainable)
    assert set(want["param"]) == set(names)
    for i, name in enumerate(names):
        got = {"param": trainer.trainable[name].detach(), "exp_avg": opt["adamw"]["state"][i]["exp_avg"],
               "exp_avg_sq": opt["adamw"]["state"][i]["exp_avg_sq"]}
        for kind, g in got.items():
            w = want[kind][name]
            if tol == 0.0:
                assert torch.equal(g, w), (name, kind)
            else:
                bound = tol * float(w.abs().max())
                assert float((g - w).abs().max()) <= bound, (name, kind, float((g - w).abs().max()), bound)


def test_resume_across_packages(run, tmp_path):
    from phantom_vlb_tpu_torch.train.builder import build_trainer

    root = run["root"]
    config = _port_config(run, root / "port", "resumed")
    trainer, _, _ = build_trainer(config, device="cpu")
    assert trainer.maybe_resume()
    steps = run["steps"]
    assert steps == 3 and trainer.global_step == trainer.optimizer.step == steps == int(run["saved"].step)
    opt = trainer.optimizer.state_dict()
    assert {float(s["step"]) for s in opt["adamw"]["state"].values()} == {float(steps)}
    adam = _moments(run["saved"].opt_state)
    assert int(adam.count) == steps
    _assert_state(trainer, run["saved"].params, adam)
    ocfg = trainer.optimizer.config
    schedule = joptim.make_schedule(joptim.OptimConfig(lr=ocfg.lr, t_max=ocfg.t_max))
    assert abs(learning_rate(ocfg, trainer.optimizer.step) - float(schedule(steps))) <= LR_TOL * float(schedule(steps))
    jmeta = json.loads((root / "jax" / "trainer_state.json").read_text())
    tmeta = json.loads((root / "port" / "trainer_state.json").read_text())
    assert {k: tmeta[k] for k in ("es_best", "es_strikes", "best_metric", "epoch", "global_step")} == {
        k: jmeta[k] for k in ("es_best", "es_strikes", "best_metric", "epoch", "global_step")}
    assert Path(tmeta["best_path"]) == (root / "port").resolve() / Path(jmeta["best_path"]).name
    assert trainer.ckpt.best_path == Path(tmeta["best_path"]) and trainer.ckpt.best_path.is_dir()
    assert trainer.ckpt.best_metric == jmeta["best_metric"]

    out = trainer.train_one(run["batch"])
    assert trainer.optimizer.step == steps + 1
    loss = float(out["brain_loss"])
    assert abs(loss - run["next_loss"]) <= STEPS_TOL * abs(run["next_loss"])
    _assert_state(trainer, run["next_state"].params, _moments(run["next_state"].opt_state), STEPS_TOL)


def _read(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in f}


def test_predict_from_converted_last(run):
    from phantom_vlb_tpu_torch.cli.predict import main as predict_main

    root = run["root"]
    args = _port_args(run["pattern"], root / "port_pred", root / "full_t", "p")
    assert predict_main([*args, f"predict.checkpoint={root / 'port' / 'last'}",
                         f"predict.out={root / 'port.h5'}", "--device", "cpu"]) == 0
    got, want = _read(root / "port.h5"), _read(root / "jax.h5")
    for key in ("predicted", "actual"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key] - want[key]).max() <= PRED_TOL * np.abs(want[key]).max(), key
    np.testing.assert_allclose(got["val_corr_roi"], want["val_corr_roi"], atol=PRED_TOL, rtol=0)


def test_adapters_export_as_jax_loads_it(run):
    from phantom_vlb_tpu.train.checkpoint import load_adapters as jload_adapters
    from phantom_vlb_tpu_torch.train.checkpoint import load_adapters

    root = run["root"]

    def keep(path):
        return path.startswith("head") or "lora_a" in path or "lora_b" in path

    base = _numpy(run["full"])
    want = from_flax_params(_numpy(jload_adapters(base, root / "jax" / "adapters", keep)))
    got = load_adapters(from_flax_params(base), root / "port" / "adapters", is_adapter)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    exported = torch.load(root / "port" / "adapters" / ADAPTERS_FILE, weights_only=True)
    assert set(exported) == {k for k in want if is_adapter(k)}
    assert all(torch.equal(exported[k], from_flax_params(run["jparams"])[k]) for k in exported)


def test_param_tree_as_checkpoint_path(run):
    from phantom_vlb_tpu_torch.train.builder import build_model

    root = run["root"]
    shards = sorted((root / "full_t").glob("*.safetensors"))
    assert shards and SafetensorsDir(root / "full_t").metadata == PORT_LAYOUT
    model = build_model(_port_config(run, root / "unused", "m").model, 0, torch.device("cpu"))
    want = from_flax_params(run["full"])
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in want)


def test_orbax_given_to_the_port_names_the_converter(run, tmp_path):
    from phantom_vlb_tpu_torch.cli.predict import main as predict_main
    from phantom_vlb_tpu_torch.train.builder import build_trainer

    root = run["root"]
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        predict_main([*_port_args(run["pattern"], tmp_path / "o", root / "full_t", "p"),
                      f"predict.checkpoint={root / 'jax' / 'last'}", f"predict.out={tmp_path / 'p.h5'}",
                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        build_trainer(_port_config(run, tmp_path / "o", "m", f"model.checkpoint_path={root / 'full'}"),
                      device="cpu")
    trainer, _, _ = build_trainer(_port_config(run, root / "jax", "m"), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax_to_torch"):
        trainer.maybe_resume()
    with pytest.raises(FileExistsError):
        _convert(root / "jax", root / "port")
    with pytest.raises(ValueError, match="inside"):
        convert(root / "jax", root / "jax" / "converted", _restore_raw)


# ---------------------------------------------------------------------------
# Conversion cases, without a run

def _bf16(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16)
                        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["per_layer", "stacked", "grouped"])
def test_param_tree_forms_and_dtypes(tmp_path, form, dtype):
    """A param tree in each decoder form and leaf dtype, through Orbax and
    the converter's shards (leaf by leaf), into ``load_pretrained_params``:
    every tensor bit-equal to the per-layer f32 tree's after rounding."""
    from phantom_vlb_tpu_torch.train.builder import load_pretrained_params

    _, params, cfg = _pair(use_lora=True)
    params = _numpy(params)
    tree = dict(params)
    if form != "per_layer":
        tree["model"] = stack_layer_params(params["model"], cfg.mistral.num_hidden_layers,
                                           group=2 if form == "grouped" else 1)
    if dtype == "bf16":
        tree = _bf16(tree)
    _save_orbax(tmp_path / "orbax", tree)
    _convert(tmp_path / "orbax", tmp_path / "shards")
    want = from_flax_params(_bf16(params) if dtype == "bf16" else params)
    assert all(t.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32) for t in want.values())
    # The model's own tensors (the tree's structure: no towers), other values.
    base = {k: torch.full_like(t, 0.5) for k, t in from_flax_params(params).items()}
    got = load_pretrained_params(cfg, tmp_path / "shards", base)
    assert got.keys() == base.keys() == want.keys()
    for k in want:
        assert got[k].dtype == base[k].dtype and torch.equal(got[k], want[k].to(base[k].dtype)), k


def _train_state(params, labels, tx, steps=2):
    """A JAX TrainState after ``steps`` updates of random gradients."""
    from phantom_vlb_tpu.train.step import TrainState, partition_params

    trainable, _ = partition_params(params, labels)
    opt_state = tx.init(trainable)
    rng = np.random.default_rng(3)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), trainable)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
    return TrainState(step=jnp.asarray(steps, jnp.int32), params=trainable, opt_state=opt_state)


@pytest.mark.parametrize("case", ["chain", "multi_transform", "sharded", "bf16"])
def test_train_state_cases(tmp_path, case):
    """optax's state by structure: the chain of record, the chain under
    ``multi_transform`` (the frozen leaves' branch empty), a state sharded
    over the 8 virtual devices (restored whole), and bf16 leaves."""
    from phantom_vlb_tpu.models import videollama2 as jv
    from phantom_vlb_tpu.train.step import TrainState
    from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer
    from phantom_vlb_tpu_torch.train.optim import OptimConfig

    _, params, cfg = _pair(use_lora=True)
    labels = joptim.trainable_labels(params, jv.trainable_predicate)
    tx = joptim.make_optimizer(joptim.OptimConfig(lr=1e-3))
    if case == "multi_transform":
        # Over the trainable subtree, as the JAX step keeps it: every leaf
        # labelled "train"; the "freeze" branch holds an empty state.
        tx = optax.multi_transform({"train": tx, "freeze": optax.set_to_zero()},
                                   lambda tree: jax.tree.map(lambda _: "train", tree))
    state = _train_state(params, labels, tx)
    if case == "sharded":
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("fsdp",))

        def shard(a):
            spec = jax.sharding.PartitionSpec("fsdp") if a.ndim and a.shape[0] % 8 == 0 else (
                jax.sharding.PartitionSpec())
            return jax.device_put(a, jax.sharding.NamedSharding(mesh, spec))

        state = jax.tree.map(shard, state)
        assert any(len(a.sharding.device_set) == 8 and not a.sharding.is_fully_replicated
                   for a in jax.tree.leaves(state))
    if case == "bf16":
        state = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, state)
    _save_orbax(tmp_path / "last", state)
    _convert(tmp_path / "last", tmp_path / "port")
    saved = torch.load(tmp_path / "port" / STATE_FILE, weights_only=True)
    assert saved["step"] == 2 and saved["optimizer"]["step"] == 2
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, from_flax_params(_numpy(params)))
    trainer = VLBTrainer(model, OptimConfig(lr=1e-3), TrainLoopConfig(output_dir=str(tmp_path / "port"),
                                                                       checkpoint=False), device="cpu")
    trainer.load_params(saved["params"])
    trainer.optimizer.load_state_dict(saved["optimizer"])
    adam = _moments(state.opt_state)
    want = {"param": from_flax_params(_numpy(state.params)), "exp_avg": from_flax_params(_numpy(adam.mu)),
            "exp_avg_sq": from_flax_params(_numpy(adam.nu))}
    opt = trainer.optimizer.state_dict()
    for i, name in enumerate(trainer.trainable):
        got = {"param": saved["params"][name], "exp_avg": opt["adamw"]["state"][i]["exp_avg"],
               "exp_avg_sq": opt["adamw"]["state"][i]["exp_avg_sq"]}
        for kind, g in got.items():
            w = want[kind][name]
            assert torch.equal(g, w.to(g.dtype)), (name, kind)
        assert float(opt["adamw"]["state"][i]["step"]) == 2.0
    # The schedule and AdamW's own settings come from the port's config.
    assert opt["adamw"]["param_groups"][0]["weight_decay"] == OptimConfig().weight_decay
    assert isinstance(state, TrainState)


@pytest.mark.parametrize("where", ["params", "opt_state", "state"])
def test_a_stray_leaf_raises_by_name(tmp_path, where):
    from phantom_vlb_tpu.models import videollama2 as jv

    _, params, _ = _pair(use_lora=True)
    labels = joptim.trainable_labels(params, jv.trainable_predicate)
    state = _train_state(params, labels, joptim.make_optimizer(joptim.OptimConfig()), steps=1)
    _save_orbax(tmp_path / "last", state)
    raw = _restore_raw(tmp_path / "last")
    if where == "params":
        raw["params"]["model"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        match = "unconsumed Flax parameter model/extra/kernel"
    elif where == "opt_state":
        raw["opt_state"][0] = {"stray": np.zeros(3, np.float32)}
        match = "unconsumed optimizer state leaf opt_state/0/stray"
    else:
        raw["ema"] = np.zeros(3, np.float32)
        match = r"unconsumed TrainState field\(s\) \['ema'\]"
    with pytest.raises(ValueError, match=match):
        convert(tmp_path / "last", tmp_path / "port", lambda path: raw)


def test_bf16_leaves_need_no_ml_dtypes_in_the_port():
    """``to_tensor`` reads an ml_dtypes bf16 array through its bits."""
    from phantom_vlb_tpu_torch.models.convert import to_tensor

    a = np.asarray([1.0, -2.5, 3.140625, 1e-3], np.float32)
    got = to_tensor(a.astype(ml_dtypes.bfloat16)[::-1])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(a[::-1].copy()).to(torch.bfloat16))
