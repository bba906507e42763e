"""Port: ``scripts/parity_real_torch.py``, the real-weights runbook, on the
tiny fixture checkpoint with VideoLLaMA2's key layout
(``tests/test_pretrained_loading.py``'s, as ``tests/test_parity_real.py``
drives the JAX runbook) and the local HF tokenizer
(``data/hf_tokenizer.py``): exit 0 when the checkpoint is coherent (every
stage within 2e-3, every key read), 1 on an architecture mismatch (a
BatchNorm statistic in the STC) or a key the port never reads, and a clean
skip (exit 0, one line) without ``--ckpt`` or without weights.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import parity_real_torch  # noqa: E402
from test_pretrained_loading import _make_checkpoint, _tiny_cfg  # noqa: E402


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("real_ckpt_torch")
    cfg = _tiny_cfg(scan=False)
    _make_checkpoint(tmp, cfg)
    m = cfg.mistral
    (tmp / "config.json").write_text(json.dumps({
        "vocab_size": m.vocab_size, "hidden_size": m.hidden_size, "intermediate_size": m.intermediate_size,
        "num_hidden_layers": m.num_hidden_layers, "num_attention_heads": m.num_attention_heads,
        "num_key_value_heads": m.num_key_value_heads, "rope_theta": m.rope_theta,
        "rms_norm_eps": m.rms_norm_eps}))
    return tmp, cfg


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    from phantom_vlb_tpu_torch.data.hf_tokenizer import build_llama_fast_tokenizer

    out = tmp_path_factory.mktemp("tokenizer")
    build_llama_fast_tokenizer().save_pretrained(out)
    return out


def _copy_with(src, dst, extra):
    from safetensors.numpy import load_file, save_file

    sd = {}
    for shard in sorted(src.glob("*.safetensors")):
        sd.update(load_file(shard))
    sd.update(extra)
    dst.mkdir()
    save_file(sd, dst / "model.safetensors")
    (dst / "config.json").write_text((src / "config.json").read_text())
    return dst


def test_runbook_passes_on_coherent_checkpoint(tiny_ckpt, tokenizer_dir, capsys):
    tmp, cfg = tiny_ckpt
    assert parity_real_torch.main(["--ckpt", str(tmp), "--tiny", "--clip-heads", str(cfg.clip.num_attention_heads),
                                   "--seq", "8", "--tokenizer", str(tokenizer_dir)]) == 0
    out = capsys.readouterr().out
    for line in ("inventory:", "every checkpoint key read", "mistral pos2040: final norm", "clip: select(-2)",
                 "joiner re-derivation (+2/+4 accounting) PASS", "PARITY-REAL-TORCH OK"):
        assert line in out, line


@pytest.mark.parametrize("extra", ["bn_running_mean", "unread_key"])
def test_runbook_fails_on_a_mismatch(tiny_ckpt, tmp_path, extra, capsys):
    tmp, cfg = tiny_ckpt
    key = ("model.mm_projector.s1.b1.conv1.bn.running_mean" if extra == "bn_running_mean"
           else "model.layers.0.mlp.extra_proj.weight")
    bad = _copy_with(tmp, tmp_path / "bad", {key: np.zeros(cfg.stc.hidden_size, np.float32)})
    assert parity_real_torch.main(["--ckpt", str(bad), "--tiny", "--skip", "mistral,clip"]) == 1
    out = capsys.readouterr().out
    assert "PARITY-REAL-TORCH FAILED" in out and ("mm_projector" in out if extra == "bn_running_mean"
                                                   else "extra_proj" in out)


@pytest.mark.parametrize("case", ["no_ckpt", "no_weights"])
def test_runbook_skips_cleanly(tmp_path, capsys, case):
    argv = [] if case == "no_ckpt" else ["--ckpt", str(tmp_path)]
    assert parity_real_torch.main(argv) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1 and "SKIP" in lines[0]
