"""Shared pieces of the benchmark's tests: the checkout on the import path,
the tiny configurations the CPU runs, and the card fixture."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
CELLS = {c["name"]: c for c in BENCH["workloads"]}
TINY_TEXT = {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-5,
             "rope_theta": 1e6}
TINY_VISION = {"image_size": 56, "patch_size": 14, "hidden_size": 64, "intermediate_size": 128,
               "num_hidden_layers": 2, "num_attention_heads": 4, "layer_norm_eps": 1e-5, "select_layer": -2}
TINY_GEOMETRY = {"tr": 1.49, "frames_per_tr": 2, "window": 2, "model_max_length": 64, "image_size": 56,
                 "patch_size": 14, "onsets_width": 16}


def cell_files(cell: str) -> tuple[dict, dict]:
    """The configuration and traffic files of a cell."""
    c = CELLS[cell]
    config = json.loads((ROOT / "cardbench" / "configs" / f"{c['config']}.json").read_text(encoding="utf-8"))
    traffic = json.loads((ROOT / "cardbench" / "workloads" / f"{c['traffic']}.json").read_text(encoding="utf-8"))
    return config, traffic


def tiny(cell: str) -> tuple[dict, dict]:
    """A cell's files with the port's tiny preset (f32, 2 layers, 64-token
    sequences, 56 px frames) in place of the full widths, its recipe and
    limits kept."""
    config, traffic = cell_files(cell)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    m = config["model"]
    lora = m["trainable"] == "lora+head"
    config["overrides"] = ["subject=sub-01", "model.preset=tiny"] + (
        ["model.lora_r=4", "model.lora_alpha=8"] if lora else [])
    m.update(dtype="float32", text=dict(TINY_TEXT), vision=dict(TINY_VISION), geometry=dict(TINY_GEOMETRY),
             connector={"hidden_size": 96, "depth": 1, "mlp_depth": 2, "se_ratio": 0.25})
    if lora:
        m["lora"].update(r=4, alpha=8.0)
    m["head"]["num_target"] = 8
    traffic["pool_batches"] = 4
    return config, traffic


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
