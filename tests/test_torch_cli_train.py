"""Port: ``vlb-train-torch`` end to end on the CPU, and the branches it refuses.

The lazy-load files are built by the JAX package's own stages (synthetic
features + BOLD -> ``vlb-build-lazyload``), as ``tests/test_cli_e2e.py``
builds them; the port's ``cli.train.main`` then trains on them with that
test's arguments, less the vision-token cache (run by
``tests/test_torch_token_cache.py``) and the 8-device mesh, plus
``--device cpu``: the CSV with a validation row of per-ROI columns, the
best and last checkpoints, the adapters and ``hparams.yaml`` (the composed
config, then the file lists) are written. Each branch the port does not
have raises by name, and the default device is the card. Launched by
``torchrun`` on 2 gloo ranks with ``mesh.fsdp=-1`` and adapter dropout
0.1, it writes the one metrics.csv that one process writes (f32 sums of
each rank's rows added apart: 1e-5 relative); so does it with
``mesh.fsdp=1 mesh.tensor=2``, the ranks splitting the decoder.
"""

import csv
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from phantom_vlb_tpu.data.synthetic import (
    TEST_GEOMETRY,
    write_synthetic_bold_file,
    write_synthetic_features_file,
)
from phantom_vlb_tpu_torch.cli.train import main
from phantom_vlb_tpu_torch.train.checkpoint import ADAPTERS_FILE, STATE_FILE

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lazy_pattern(tmp_path_factory):
    from phantom_vlb_tpu.cli.build_lazyload import main as build_lazyload

    root = tmp_path_factory.mktemp("port_e2e")
    eps = {"s01e01a": 9, "s01e01b": 8, "s01e02a": 8}
    write_synthetic_features_file(root / "features_s1.h5", eps, TEST_GEOMETRY, seed=0)
    write_synthetic_bold_file(root / "bold.h5", eps, TEST_GEOMETRY, seed=1)
    (root / "lazy").mkdir()
    assert build_lazyload([
        "--features_path", str(root / "features_s1.h5"), "--timeseries_path", str(root / "bold.h5"),
        "--lazyload_path", str(root / "lazy"), "--subject", "sub-01", "--season", "s1",
        "--n_split", "2", "--window", str(TEST_GEOMETRY.window), "--delay", str(TEST_GEOMETRY.delay),
    ]) == 0
    return str(root / "lazy" / "friends_llFile_sub-01_s*_n*.h5")


def _args(pattern, out):
    return [
        "experiment=vlb_friends_lora", "subject=sub-01",
        f"datamodule.lazyload_path={pattern}", "datamodule.seasons=[s1]",
        "datamodule.batch_size=4", "datamodule.num_workers=2",
        "model.preset=tiny", "model.lora_r=4", "model.lora_alpha=8", "model.lora_dropout=0.0",
        "trainer.max_epochs=1", "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=2",
        "optim.t_max=100", f"output_dir={out}", "run_name=e2e", "mesh.fsdp=1",
    ]


def test_train_cli_on_the_cpu(lazy_pattern, tmp_path):
    out = tmp_path / "results"
    assert main([*_args(lazy_pattern, out), "--device", "cpu"]) == 0
    import pandas as pd

    (csv_path,) = glob.glob(str(out / "e2e" / "*" / "metrics.csv"))
    df = pd.read_csv(csv_path)
    assert df["val/brain_loss"].notna().sum() >= 1
    assert len([c for c in df.columns if "ROI" in c]) == TEST_GEOMETRY.num_parcels
    assert np.isfinite(df["val_corr_avg"].dropna()).all()
    assert (out / "last" / STATE_FILE).exists()
    (best,) = out.glob("best_brainloss_*")
    assert (best / STATE_FILE).exists()
    adapters = torch.load(out / "adapters" / ADAPTERS_FILE, weights_only=True)
    assert adapters and all(k.startswith("head.") or "lora_" in k for k in adapters)
    hparams = yaml.safe_load((out / "e2e" / "version_0" / "hparams.yaml").read_text())
    assert hparams["model"]["lora_r"] == 4 and hparams["run_name"] == "e2e"
    assert len(hparams["train_set"]) == 1 and len(hparams["val_set"]) == 1


# A mesh of 4 devices in one process: sharded training runs one process per
# card, so the error names the launch that would give it 4. The grain loader
# trains (tests/test_torch_grain_loader.py); the vision-token cache, which
# swaps the native loaders' datasets, refuses it.
UNPORTED = {
    "grain": (["datamodule.loader=grain", "datamodule.vision_token_cache={orbax}"], ValueError,
              "vision_token_cache requires the native loader"),
    "mesh": (["mesh.fsdp=4"], ValueError, "needs 4 devices, have 1.*torchrun --nproc_per_node=4"),
    "orbax": (["model.checkpoint_path={orbax}"], NotImplementedError, "Orbax"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_branches_raise_by_name(lazy_pattern, tmp_path, case):
    extra, error, match = UNPORTED[case]
    (tmp_path / "orbax" / "d").mkdir(parents=True)
    extra = [e.format(orbax=tmp_path / "orbax") for e in extra]
    with pytest.raises(error, match=match):
        main([*_args(lazy_pattern, tmp_path / "out"), *extra, "--device", "cpu"])


def test_the_card_is_the_default(lazy_pattern, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_args(lazy_pattern, tmp_path / "out"))


MODEL_CASES = {
    "lora_full": ["experiment=vlb_friends_lora"],
    "lora_fused_w8a8g8": ["experiment=vlb_friends_lora", "model.lora_fused_dropout=true",
                          "model.lora_dropout_bits=8", "model.base_quant=w8a8g8"],
    "lora_tiny": ["experiment=vlb_friends_lora", "model.preset=tiny", "model.lora_r=4"],
    "baseline_full": ["experiment=vlb_friends_baseline"],
    "baseline_tiny_int8": ["experiment=vlb_friends_baseline", "model.preset=tiny", "model.base_quant=int8"],
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_config_matches_jax(case):
    """``build_model_config`` gives the JAX package's model config: regime,
    adapters, base quantization, widths and depth, remat, head."""
    from phantom_vlb_tpu.core.config import load_config as jload
    from phantom_vlb_tpu.train.builder import build_model_config as jbuild
    from phantom_vlb_tpu_torch.core.config import load_config
    from phantom_vlb_tpu_torch.train.builder import build_model_config

    args = ["subject=sub-01", *MODEL_CASES[case]]
    got = build_model_config(load_config(CONFIGS, "base", args).model)
    want = jbuild(jload(CONFIGS, "base", args).model)
    for field in ("num_target", "l2_lambda", "dropout_rate", "freeze_backbone"):
        assert getattr(got, field) == getattr(want, field), field
    gm, wm = got.mistral, want.mistral
    for field in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "head_dim", "vocab_size", "remat", "base_quant"):
        assert getattr(gm, field) == getattr(wm, field), field
    assert got.clip.base_quant == want.clip.base_quant
    assert got.clip.effective_layers == want.clip.effective_layers
    assert (gm.lora is None) == (wm.lora is None)
    if wm.lora is not None:
        for field in ("rank", "alpha", "dropout", "shared_dropout", "dropout_bits", "fused_dropout"):
            assert getattr(gm.lora, field) == getattr(wm.lora, field), field


def _csv_rows(out):
    (path,) = glob.glob(str(out / "e2e" / "*" / "metrics.csv"))
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_torchrun_two_ranks_write_what_one_process_writes(lazy_pattern, tmp_path):
    args = [a for a in _args(lazy_pattern, tmp_path / "two") if a != "mesh.fsdp=1"]
    args = [a.replace("model.lora_dropout=0.0", "model.lora_dropout=0.1") for a in args]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                           "-m", "phantom_vlb_tpu_torch.cli.train", *args, "mesh.fsdp=-1", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final val/brain_loss") == 1                   # rank 0 alone
    one = [a.replace(str(tmp_path / "two"), str(tmp_path / "one")) for a in args]
    assert main([*one, "mesh.fsdp=1", "--device", "cpu"]) == 0
    got, want = _csv_rows(tmp_path / "two"), _csv_rows(tmp_path / "one")
    assert [p.name for p in (tmp_path / "two" / "e2e").iterdir()] == ["version_0"]
    assert len(got) == len(want) and got[0].keys() == want[0].keys()
    assert any(r["val_corr_avg"] for r in got)
    for g, w in zip(got, want):
        for key, value in w.items():
            if key == "train/steps_per_sec" or value == "":
                assert (g[key] == "") == (value == ""), key
            else:
                np.testing.assert_allclose(float(g[key]), float(value), rtol=1e-5, atol=1e-6, err_msg=key)
    saved = torch.load(tmp_path / "two" / "last" / STATE_FILE, weights_only=True)
    assert set(saved["params"]) == set(torch.load(tmp_path / "one" / "last" / STATE_FILE,
                                                  weights_only=True)["params"])


def test_torchrun_tensor_two_writes_what_one_process_writes(lazy_pattern, tmp_path):
    """``mesh.fsdp=1 mesh.tensor=2``: the 2 ranks split the tiny decoder's
    heads and MLP width, hold the same rows, and write the metrics.csv and
    ``last`` of one process (the row-parallel partials add in f32 apart:
    1e-5 relative)."""
    args = [a for a in _args(lazy_pattern, tmp_path / "two") if a != "mesh.fsdp=1"]
    args = [a.replace("model.lora_dropout=0.0", "model.lora_dropout=0.1") for a in args]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                           "-m", "phantom_vlb_tpu_torch.cli.train", *args, "mesh.fsdp=1", "mesh.tensor=2",
                           "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final val/brain_loss") == 1                   # rank 0 alone
    one = [a.replace(str(tmp_path / "two"), str(tmp_path / "one")) for a in args]
    assert main([*one, "mesh.fsdp=1", "--device", "cpu"]) == 0
    got, want = _csv_rows(tmp_path / "two"), _csv_rows(tmp_path / "one")
    assert len(got) == len(want) and got[0].keys() == want[0].keys()
    for g, w in zip(got, want):
        for key, value in w.items():
            if key == "train/steps_per_sec" or value == "":
                assert (g[key] == "") == (value == ""), key
            else:
                np.testing.assert_allclose(float(g[key]), float(value), rtol=1e-5, atol=1e-6, err_msg=key)
    saved = torch.load(tmp_path / "two" / "last" / STATE_FILE, weights_only=True)
    whole = torch.load(tmp_path / "one" / "last" / STATE_FILE, weights_only=True)
    assert {k: tuple(v.shape) for k, v in saved["params"].items()} == \
        {k: tuple(v.shape) for k, v in whole["params"].items()}
