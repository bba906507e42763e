"""A run with the timed path broken underneath reads as not correct: the
harness's run on the CPU at the tiny preset, its look for a card skipped,
once for each fault a training cell on one card can have."""

from __future__ import annotations

import pytest

from test_cardbench_reference import tiny_run
from conftest import CELLS


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from phantom_vlb_tpu_torch.train.optim import AdamWCosine, learning_rate

    def apply(self):                               # counts the update, changes nothing
        self.step += 1
        return learning_rate(self.config, self.step - 1)

    monkeypatch.setattr(AdamWCosine, "apply", apply)
    result = tiny_run(cell)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from phantom_vlb_tpu_torch.train.loop import VLBTrainer

    put = VLBTrainer._put

    def half(self, batch):                         # the mean over the first rows only
        dev = put(self, batch)
        keep = (dev["row_mask"].shape[0] + 1) // 2
        return {k: v[:keep] for k, v in dev.items()}

    monkeypatch.setattr(VLBTrainer, "_put", half)
    result = tiny_run(cell)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]
