"""Port: ``scripts/full_width_parity_torch.py`` at narrow widths, against
``transformers`` and the HF STC oracle.

The script's functions (the HF-layout shard writers, the port's loading
through ``load_pretrained_params`` with its key accounting, the decoder's
hidden states at explicit positions, the oracles) run at narrow widths
here; ``make parity-torch`` runs them at full width (``docs/parity_runs.md``).
Each component is within the script's tolerance (2e-3 relative to the
oracle's largest magnitude; f32 on both sides, so the errors found are
~1e-7). A port whose RoPE is off (theta 1e4 in place of 1e6) fails, at
the end of the window too, and the script exits 1; a shard key the port
does not read is reported.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import full_width_parity_torch as fw  # noqa: E402

MISTRAL = dict(vocab=300, hidden=64, inter=160, heads=4, kv_heads=2, head_dim=16, rope_theta=1e6, eps=1e-5)
CLIP = dict(hidden=64, inter=128, heads=4, layers=3, image=56, patch=14)
STC = dict(encoder=32, hidden=48, output=40, depth=2, mlp_depth=2, frames=4, grid=6)


@pytest.mark.parametrize("component", ["mistral", "clip", "stc"])
def test_component_matches_its_oracle(tmp_path, component):
    if component == "mistral":
        failures, worst = fw.run_mistral(tmp_path / "m", 2, 8, widths=MISTRAL)
    elif component == "clip":
        failures, worst = fw.run_clip(tmp_path / "c", widths=CLIP)
    else:
        failures, worst = fw.run_stc(tmp_path / "s", widths=STC)
    assert failures == [] and worst < fw.TOL


def test_hidden_states_follow_hf_convention(tmp_path):
    """L + 1 states: the embeddings, L - 1 layer outputs, the final norm."""
    fw.generate_mistral_shards(tmp_path, 3, MISTRAL)
    cfg = fw.mistral_config(3, MISTRAL)
    model, unread = fw.load_port_decoder(tmp_path, cfg)
    assert unread == []
    ids = np.arange(3, 11)[None].astype(np.int64)
    states = fw.decoder_states(model, ids, np.arange(8)[None])
    assert len(states) == 4 and states[0].shape == (1, 8, 64)
    np.testing.assert_array_equal(states[0], model.embed(torch.from_numpy(ids)).numpy())


def test_a_rope_fault_fails_at_the_window_end(tmp_path, monkeypatch, capsys):
    from phantom_vlb_tpu_torch.models import mistral

    fw.generate_mistral_shards(tmp_path / "m", 2, MISTRAL)
    real = mistral.rope_tables
    monkeypatch.setattr(fw, "rope_tables", lambda positions, d, theta: real(positions, d, 1e4))
    failures, _ = fw.run_mistral(tmp_path / "m", 2, 8, widths=MISTRAL)
    assert {tag for tag, _, _ in failures} == {"pos 0..", "pos 2040.."}
    monkeypatch.setattr(fw, "MISTRAL_FULL", MISTRAL)
    fw.generate_mistral_shards(tmp_path / "cli", 2, MISTRAL)
    assert fw.main(["--component", "mistral", "--layers", "2", "--seq", "8", "--out", str(tmp_path / "cli")]) == 1
    assert "FULL-WIDTH PORT PARITY FAILED" in capsys.readouterr().out


def test_an_unread_shard_key_fails(tmp_path):
    from phantom_vlb_tpu_torch.models.convert import write_safetensors

    fw.generate_mistral_shards(tmp_path, 2, MISTRAL)
    write_safetensors(tmp_path / "extra.safetensors", {"model.layers.0.mlp.extra.weight": np.zeros(4, np.float32)})
    _, unread = fw.load_port_decoder(tmp_path, fw.mistral_config(2, MISTRAL))
    assert unread == ["model.layers.0.mlp.extra.weight"]
