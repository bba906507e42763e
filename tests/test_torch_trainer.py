"""Port parity: ``VLBTrainer`` against the JAX package's, from the same weights
and batches, without dropout.

Mirrors ``tests/test_resume.py`` and ``tests/test_early_stopping.py`` on the
readout head (all of it trains), then a tiny VLB in the LoRA regime (head
+ adapters) through 2 epochs with mid-epoch validations. The two trainers
must agree on: the metrics.csv columns and the (epoch, step) of every row;
``train/brain_loss`` and ``val/brain_loss`` within LOSS_TOL compounded over
the at most 10 updates a run makes, ``(1 + 1e-5)**10 - 1 = 1.00005e-4``
relative (each update adds at most one step's tolerance); every
``val_corr_ROI_*`` within 1e-4 absolute; ``lr-AdamW`` within 1e-6
relative (JAX computes the same formula in f32); the best checkpoint's
name; early stopping at the same
validation; resume to the same step; the NaN abort at the same step.
Within the port, a resumed trainer's tensors and AdamW state are
bit-equal to those it saved, and a non-finite step leaves them as they
were.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantom_vlb_tpu.models import videollama2 as jv
from phantom_vlb_tpu.models.heads import BrainReadoutHead as JHead
from phantom_vlb_tpu.train import optim as joptim
from phantom_vlb_tpu.train.loop import TrainLoopConfig as JLoopConfig
from phantom_vlb_tpu.train.loop import VLBTrainer as JTrainer
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import from_flax_params
from phantom_vlb_tpu_torch.models.heads import BrainReadoutHead as THead
from phantom_vlb_tpu_torch.train.checkpoint import ADAPTERS_FILE
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer, is_adapter
from phantom_vlb_tpu_torch.train.optim import OptimConfig
from test_torch_train_step import LOSS_TOL, _batch, _pair

STEPS_TOL = (1 + LOSS_TOL) ** 10 - 1
CORR_TOL = 1e-4
LR_TOL = 1e-6
H, S, P, B = 16, 8, 4, 8


# ---------------------------------------------------------------------------
# The readout head alone (the JAX tests' model)

def _head_data(n, seed, learnable=True, nan_steps=()):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(7).standard_normal((H, P)).astype(np.float32)
    out = []
    for i in range(n):
        x = rng.standard_normal((B, S, H)).astype(np.float32)
        m = rng.uniform(0, 1, (B, S)).astype(np.float32)
        y = (np.einsum("bse,bs->be", x, m) @ w if learnable
             else rng.standard_normal((B, P)).astype(np.float32) * 100.0)
        if i in nan_steps:
            y = np.full_like(y, np.nan)
        out.append({"hidden": x, "weights": m, "timeseries": y, "row_mask": np.ones(B, np.float32)})
    return out


def _head_pair(out_dir, lr=1e-3, **loop):
    """(JAX trainer, port trainer) from the same head weights."""
    head = JHead(hidden_size=H, num_target=P, dropout_rate=0.0)
    params = head.init(jax.random.key(0), jnp.zeros((1, S, H)), jnp.zeros((1, S)))["params"]

    def jfwd(p, batch, rng, train):
        return head.apply({"params": p}, batch["hidden"], batch["weights"], deterministic=True)

    def loop_cfg(cls, sub):
        return cls(run_name="r", num_target=P, output_dir=str(out_dir / sub),
                   **{"val_check_interval": 0.0, "log_every_n_steps": 100, **loop})

    optim = dict(lr=lr, t_max=500)
    jt = JTrainer(jfwd, params, joptim.OptimConfig(**optim), loop_cfg(JLoopConfig, "jax"))
    sd = {k[len("head."):]: v for k, v in from_flax_params({"head": params}).items()}
    model = THead(H, P, dropout_rate=0.0)
    model.load_state_dict(sd)
    tt = VLBTrainer(model, OptimConfig(**optim), loop_cfg(TrainLoopConfig, "port"),
                    trainable=lambda name: True, forward=lambda m, b, seed: m(b["hidden"], b["weights"]),
                    device="cpu")
    return jt, tt


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _close(a, b, rtol):
    a, b = float(a), float(b)
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= rtol * abs(b)


def _assert_csv_agrees(port_path, jax_path):
    got, want = _rows(port_path), _rows(jax_path)
    assert list(got[0]) == list(want[0])
    assert [(r["epoch"], r["step"]) for r in got] == [(r["epoch"], r["step"]) for r in want]
    for g, w in zip(got, want):
        for key, value in w.items():
            if value == "" or key in ("epoch", "step", "train/steps_per_sec"):
                assert (g[key] == "") == (value == ""), key
            elif key in ("train/brain_loss", "val/brain_loss"):
                assert _close(g[key], value, STEPS_TOL), (g["step"], key, g[key], value)
            elif key == "lr-AdamW":
                assert _close(g[key], value, LR_TOL), (g["step"], key)
            elif key.startswith("val_corr"):
                assert abs(float(g[key]) - float(value)) <= CORR_TOL, (g["step"], key)
            else:
                assert _close(g[key], value, 0.0), key
    return got


def _port_state(t):
    return {k: p.detach().clone() for k, p in t.trainable.items()}, t.optimizer.state_dict()


def _assert_same_state(a, b):
    (pa, oa), (pb, ob) = a, b
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert oa["step"] == ob["step"]
    sa, sb = oa["adamw"]["state"], ob["adamw"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_resume_continues_as_jax_does(tmp_path):
    train, val = _head_data(5, 0), _head_data(2, 1)
    jt1, tt1 = _head_pair(tmp_path, max_epochs=2)
    jt1.fit(train, val)
    tt1.fit(train, val)
    assert tt1.global_step == jt1.global_step == 10
    saved = _port_state(tt1)

    jt2, tt2 = _head_pair(tmp_path, max_epochs=4)
    assert jt2.maybe_resume() and tt2.maybe_resume()
    assert tt2.global_step == jt2.global_step == 10
    _assert_same_state(_port_state(tt2), saved)
    jt2.fit(train, val)
    tt2.fit(train, val)
    assert tt2.global_step == jt2.global_step == 20
    _assert_csv_agrees(tt2.csv_logger.path, jt2.csv_logger.path)
    for name, p in tt2.trainable.items():
        ref = from_flax_params({"head": jax.tree.map(np.asarray, jt2.state.params)})["head." + name]
        np.testing.assert_allclose(p.detach().numpy(), ref.numpy(), rtol=0,
                                   atol=STEPS_TOL * float(np.abs(ref.numpy()).max()), err_msg=name)
    assert not tt2.maybe_resume("absent")


EARLY_STOP_CASES = {
    # Unlearnable noise at lr 0: patience 2 stops after 1 best + 2 strikes.
    "end_of_epoch": dict(n=3, learnable=False, lr=0.0, patience=2, interval=0.0, epochs=10,
                         steps=9, stopped=True),
    "mid_epoch": dict(n=6, learnable=False, lr=0.0, patience=2, interval=0.5, epochs=10,
                      steps=9, stopped=True),
    "disabled": dict(n=3, learnable=False, lr=0.0, patience=0, interval=0.0, epochs=4,
                     steps=12, stopped=False),
    "improving": dict(n=6, learnable=True, lr=1e-2, patience=2, interval=0.0, epochs=6,
                      steps=36, stopped=False),
}


@pytest.mark.parametrize("case", list(EARLY_STOP_CASES))
def test_early_stop_at_the_same_validation(tmp_path, case):
    c = EARLY_STOP_CASES[case]
    train = _head_data(c["n"], 0, learnable=c["learnable"])
    val = _head_data(2, 1, learnable=c["learnable"])
    jt, tt = _head_pair(tmp_path, lr=c["lr"], max_epochs=c["epochs"], early_stop_patience=c["patience"],
                        val_check_interval=c["interval"], checkpoint=False)
    jt.fit(train, val)
    tt.fit(train, val)
    assert tt.stopped_early == jt.stopped_early == c["stopped"]
    assert tt.global_step == jt.global_step == c["steps"] and tt.epoch == jt.epoch
    rows = _assert_csv_agrees(tt.csv_logger.path, jt.csv_logger.path)
    assert (rows[-1].get("early_stopped_epoch", "") != "") == c["stopped"]


def test_early_stop_state_survives_resume(tmp_path):
    train, val = _head_data(3, 0, learnable=False), _head_data(2, 1, learnable=False)
    kw = dict(lr=0.0, max_epochs=1, early_stop_patience=3)
    jt1, tt1 = _head_pair(tmp_path, **kw)
    for t in (jt1, tt1):
        t.fit(train, val)
        t.validate(val)
    assert tt1._es_strikes == jt1._es_strikes == 1
    jt2, tt2 = _head_pair(tmp_path, **kw)
    assert tt2.maybe_resume() and jt2.maybe_resume()
    assert tt2._es_strikes == 1 and _close(tt2._es_best, jt2._es_best, STEPS_TOL)
    assert tt2.ckpt.best_path.name == jt2.ckpt.best_path.name
    for t in (jt2, tt2):
        t.validate(val)
        t.validate(val)
        assert t.stopped_early


def test_nan_abort_at_the_same_step(tmp_path):
    """Non-finite targets at steps 3-5: the streak reaches 3 at step 5, where
    both raise; the port's state is that after step 2."""
    train, val = _head_data(8, 0, nan_steps=(2, 3, 4)), _head_data(2, 1)
    jt, tt = _head_pair(tmp_path, max_epochs=1, log_every_n_steps=1)
    after_two = []

    class Snapshot:
        def log_metrics(self, metrics, step, epoch):
            if step == 2:
                after_two.append(_port_state(tt))

    tt.extra_loggers.append(Snapshot())
    with pytest.raises(FloatingPointError, match="at step 5") as jerr:
        jt.fit(train, val)
    with pytest.raises(FloatingPointError, match="at step 5"):
        tt.fit(train, val)
    assert "3 consecutive" in str(jerr.value)
    assert tt.global_step == jt.global_step == 5 and int(jt.state.step) == tt.optimizer.step == 2
    _assert_same_state(_port_state(tt), after_two[0])
    _assert_csv_agrees(tt.csv_logger.path, jt.csv_logger.path)


# ---------------------------------------------------------------------------
# A tiny VLB in the LoRA regime

def test_tiny_vlb_lora_fit_matches_jax(tmp_path):
    jmodel, params, cfg = _pair(use_lora=True)
    rng = np.random.default_rng(20)
    train = [_batch(rng, 3, [1, 1, 0] if i == 3 else None) for i in range(4)]
    val = [_batch(rng, 3), _batch(rng, 2)]
    loop = dict(max_epochs=2, val_check_interval=0.5, log_every_n_steps=2, run_name="r",
                num_target=cfg.num_target)
    labels = joptim.trainable_labels(params, jv.trainable_predicate)
    jt = JTrainer(jv.vlb_forward_fn(jmodel), params, joptim.OptimConfig(lr=1e-3),
                  JLoopConfig(output_dir=str(tmp_path / "jax"), **loop), trainable_label_tree=labels)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, from_flax_params(params))
    tt = VLBTrainer(model, OptimConfig(lr=1e-3), TrainLoopConfig(output_dir=str(tmp_path / "port"), **loop),
                    device="cpu")
    assert set(tt.trainable) == {n for n, _ in model.named_parameters() if tv.trainable_predicate(n)}
    jt.fit(train, val)
    tt.fit(train, val)
    assert tt.global_step == jt.global_step == 8
    rows = _assert_csv_agrees(tt.csv_logger.path, jt.csv_logger.path)
    assert [r["step"] for r in rows if r["val/brain_loss"]] == ["2", "4", "6", "8"]
    assert [r["step"] for r in rows if r["train/brain_loss"]] == ["2", "4", "6", "8"]
    assert tt.ckpt.best_path.name == jt.ckpt.best_path.name
    assert (tmp_path / "port" / "last").is_dir()
    adapters = torch.load(tmp_path / "port" / "adapters" / ADAPTERS_FILE, weights_only=True)
    assert set(adapters) == {n for n in model.state_dict() if is_adapter(n)}
    assert any("lora_a" in n for n in adapters) and all(
        n.startswith("head.") or "lora_" in n for n in adapters)
