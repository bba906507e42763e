"""Port: checkpoints, the adapters export and the optimizer's state.

The best/last policy of the JAX ``CheckpointManager`` (a best directory
``best_brainloss_{epoch}-{step}`` replaced only on improvement, ``last``,
``trainer_state.json``) over ``torch.save`` files read back with
``weights_only=True``; the export keeps the selected tensors only and
merges back; an ``AdamWCosine`` saved and loaded mid-run continues bit for
bit as the run that never stopped.
"""

import pytest
import torch

from phantom_vlb_tpu_torch.train.checkpoint import (
    ADAPTERS_FILE,
    STATE_FILE,
    CheckpointManager,
    export_adapters,
    load_adapters,
)
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig


def _state(step):
    return {"step": step, "params": {"head.w": torch.full((2, 3), float(step))},
            "optimizer": {"step": step, "adamw": {"state": {}, "param_groups": []}}}


def test_best_is_replaced_only_on_improvement(tmp_path):
    ckpt = CheckpointManager(tmp_path / "ck")
    saved = [ckpt.save_on_validation(_state(s), m, e, s)
             for s, m, e in ((2, 1.0, 0), (4, 1.5, 0), (6, 0.5, 1), (8, 0.5, 1))]
    assert saved == [True, False, True, False]
    assert sorted(p.name for p in ckpt.directory.iterdir()) == ["best_brainloss_1-6"]
    assert ckpt.best_path.name == "best_brainloss_1-6" and ckpt.best_metric == 0.5
    ckpt.save_last(_state(8))
    back = ckpt.restore("last")
    assert back["step"] == 8 and torch.equal(back["params"]["head.w"], torch.full((2, 3), 8.0))
    assert ckpt.restore_path(ckpt.best_path)["step"] == 6
    # Three saves: step 2's best (since replaced, the same size as step 6's), step 6's, last.
    best, last = (ckpt.directory / n / STATE_FILE for n in ("best_brainloss_1-6", "last"))
    assert ckpt.bytes_written == 2 * best.stat().st_size + last.stat().st_size
    ckpt.save_metadata({"es_best": 0.5, "es_strikes": 1})
    assert CheckpointManager(tmp_path / "ck").load_metadata() == {"es_best": 0.5, "es_strikes": 1}
    (ckpt.directory / "trainer_state.json").write_text("{not json")
    assert ckpt.load_metadata() == {}


def test_a_checkpoint_loads_with_weights_only(tmp_path):
    opt = AdamWCosine([torch.nn.Parameter(torch.ones(4))])
    opt.params[0].grad = torch.ones(4)
    opt.apply()
    ckpt = CheckpointManager(tmp_path)
    ckpt.save("last", {"step": 1, "params": {"p": opt.params[0].detach()}, "optimizer": opt.state_dict()})
    raw = torch.load(tmp_path / "last" / STATE_FILE, weights_only=True)
    assert raw["step"] == 1 and raw["optimizer"]["step"] == 1
    assert set(raw["optimizer"]["adamw"]["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}


def test_adapters_export_and_merge(tmp_path):
    params = {"head.ridge.linear.weight": torch.randn(3, 4),
              "model.layers.0.self_attn.q_proj.lora_a": torch.randn(4, 2),
              "model.layers.0.self_attn.q_proj.weight": torch.randn(4, 4, dtype=torch.bfloat16)}

    def keep(name):
        return name.startswith("head") or "lora_" in name

    kept = export_adapters(params, tmp_path / "adapters", keep)
    assert set(kept) == {"head.ridge.linear.weight", "model.layers.0.self_attn.q_proj.lora_a"}
    on_disk = torch.load(tmp_path / "adapters" / ADAPTERS_FILE, weights_only=True)
    assert set(on_disk) == set(kept)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    merged = load_adapters(fresh, tmp_path / "adapters", keep)
    for k in kept:
        assert torch.equal(merged[k], params[k])
    assert torch.equal(merged["model.layers.0.self_attn.q_proj.weight"], fresh["model.layers.0.self_attn.q_proj.weight"])
    with pytest.raises(ValueError, match="selected no parameters"):
        export_adapters(params, tmp_path / "none", lambda name: False)
    with pytest.raises(ValueError, match="unlike"):
        load_adapters(fresh, tmp_path / "adapters", lambda name: True)


def test_optimizer_state_continues_bit_for_bit(tmp_path):
    def run(steps, opt=None, p=None):
        gen = torch.Generator().manual_seed(5)
        if p is None:
            p = torch.nn.Parameter(torch.randn(16, generator=gen))
            opt = AdamWCosine([p], OptimConfig(lr=1e-2, t_max=7))
        for s in range(steps):
            p.grad = torch.randn(16, generator=torch.Generator().manual_seed(100 + opt.step))
            opt.clip_()
            opt.apply()
        return p, opt

    p_full, opt_full = run(6)
    p_half, opt_half = run(3)
    torch.save({"p": p_half.detach(), "opt": opt_half.state_dict()}, tmp_path / "s.pt")
    back = torch.load(tmp_path / "s.pt", weights_only=True)
    p_new = torch.nn.Parameter(back["p"].clone())
    opt_new = AdamWCosine([p_new], OptimConfig(lr=1e-2, t_max=7))
    opt_new.load_state_dict(back["opt"])
    assert opt_new.step == 3
    run(3, opt_new, p_new)
    assert opt_new.step == opt_full.step == 6
    assert torch.equal(p_new, p_full)
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(opt_new.adamw.state[p_new][k], opt_full.adamw.state[p_full][k])
