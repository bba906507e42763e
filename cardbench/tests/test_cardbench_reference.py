"""The plain reference against the port on the CPU at the tiny preset,
through the harness's own run, and the benchmark's tensors against the
port's state dict."""

from __future__ import annotations

import time

import pytest
import torch

from cardbench.harness import run
from cardbench.weights import state_spec
from conftest import BENCH, CELLS, ROOT, cell_files, tiny


def tiny_run(cell: str, seed: int = 2**33 + 5, trace: bool = False) -> dict:
    config, traffic = tiny(cell)
    per_layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    return run(config, traffic, per_layer, BENCH["end_to_end"], seed, 0.2, trace, "cpu",
               time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_spec_is_the_ports_state_dict(cell):
    from phantom_vlb_tpu_torch.core.config import load_config
    from phantom_vlb_tpu_torch.models.videollama2 import VideoLLaMA2VLB, stored_dtype
    from phantom_vlb_tpu_torch.train.builder import build_model_config

    for config in (cell_files(cell)[0], tiny(cell)[0]):
        composed = load_config(ROOT / "configs", "base", [f"experiment={config['experiment']}", *config["overrides"]])
        model_cfg = build_model_config(composed.model)
        with torch.device("meta"):
            sd = VideoLLaMA2VLB(model_cfg).state_dict()
        port = {k: (tuple(t.shape), stored_dtype(k, model_cfg)) for k, t in sd.items()}
        assert port == {n: (tuple(s), d) for n, s, d in state_spec(config["model"])}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_run_agrees_with_the_reference(cell):
    result = tiny_run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert result["checks"][name]["value"] < 1e-5, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_clips_per_s", "peak_device_gb", "setup_s"}


def test_tiny_traced_run_prints_a_breakdown():
    result = tiny_run("lora-frames-b3", trace=True)
    assert result["correct"] and {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    assert "step_ms_max" in result["metrics"] and result["device"]["window_s"] > 0


@pytest.mark.parametrize("change", [{"fused_dropout": True}, {"dropout_bits": 8}, {"shared_dropout": True}],
                         ids=["fused", "8-bit", "shared"])
def test_reference_refuses_a_dropout_it_does_not_model(change):
    from cardbench.reference.vlb import Reference, dropout_mode

    config, _ = tiny("lora-frames-b3")
    assert dropout_mode(config["model"]["lora"]) == "unfused-32"
    config["model"]["lora"].update(change)
    with pytest.raises(ValueError, match="does not model the adapter dropout"):
        Reference(config["model"], 0, torch.device("cpu"))
