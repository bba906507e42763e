"""Port: what the card's machine lacks is never imported, and entry points
raise rather than fall back when there is no card.

The card's machine has no jax, h5py or libav development files; every
module of the port and ``chip_smoke.py`` import with those and the other
optional packages (flax, optax, yaml, pandas, PIL, transformers,
tokenizers, ml_dtypes, safetensors, orbax, comet_ml) blocked: the
trainer's modules among them, those of the stages around it (predict, the
feature and token caches, the brain maps) and those of the first two
stages (extraction and the lazy-load builder, with their CLIs),
those of the multi-process path (the process group, the mesh, FSDP2
sharding), and the checkpoint policies, the grain-order loader (which
imports no ``grain``), the profiling hooks, the dtype policies and the
model registry; the hand kernels' forward ops are registered. The two
quality-run scripts (``scripts/quant_quality_run_torch.py``,
``scripts/plateau_run_torch.py``) import with the same modules and
``__graft_entry__`` blocked, and raise without a card unless asked for the
CPU.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from phantom_vlb_tpu_torch.cli.predict import predict_batches
from phantom_vlb_tpu_torch.core.device import resolve_device
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "h5py", "yaml", "phantom_vlb_tpu", "transformers", "timm",
           "PIL", "safetensors", "orbax", "comet_ml", "pandas", "ml_dtypes", "tokenizers")

# Blocks the modules (a None entry in sys.modules makes their import fail),
# then imports every module of the port and chip_smoke without running it.
_CHILD = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import phantom_vlb_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
assert not leaked, leaked
ring = {{"phantom_vlb_tpu_torch.core.mesh", "phantom_vlb_tpu_torch.ops.context_parallel",
        "phantom_vlb_tpu_torch.ops.ring_fused"}}
assert ring <= set(names), sorted(ring - set(names))
vision = {{"phantom_vlb_tpu_torch.models.clip_vit", "phantom_vlb_tpu_torch.models.stc_connector",
          "phantom_vlb_tpu_torch.ops.preprocess"}}
assert vision <= set(names), sorted(vision - set(names))
trainer = {{"phantom_vlb_tpu_torch.core.config", "phantom_vlb_tpu_torch.data.loader",
           "phantom_vlb_tpu_torch.data.schemas", "phantom_vlb_tpu_torch.train.builder",
           "phantom_vlb_tpu_torch.train.checkpoint", "phantom_vlb_tpu_torch.train.loop",
           "phantom_vlb_tpu_torch.utils.logging", "phantom_vlb_tpu_torch.cli.train"}}
assert trainer <= set(names), sorted(trainer - set(names))
stages = {{"phantom_vlb_tpu_torch.cli.predict", "phantom_vlb_tpu_torch.train.precompute",
          "phantom_vlb_tpu_torch.data.token_cache", "phantom_vlb_tpu_torch.postprocessing.nifti",
          "phantom_vlb_tpu_torch.postprocessing.brainmaps", "phantom_vlb_tpu_torch.cli.brainmaps"}}
assert stages <= set(names), sorted(stages - set(names))
first = {{"phantom_vlb_tpu_torch.data.hrf", "phantom_vlb_tpu_torch.data.text",
         "phantom_vlb_tpu_torch.data.hf_tokenizer", "phantom_vlb_tpu_torch.data.video",
         "phantom_vlb_tpu_torch.data.video_reader", "phantom_vlb_tpu_torch.data.extract",
         "phantom_vlb_tpu_torch.data.lazyload_build", "phantom_vlb_tpu_torch.cli.extract",
         "phantom_vlb_tpu_torch.cli.build_lazyload"}}
assert first <= set(names), sorted(first - set(names))
sharded = {{"phantom_vlb_tpu_torch.core.distributed", "phantom_vlb_tpu_torch.core.mesh",
           "phantom_vlb_tpu_torch.parallel", "phantom_vlb_tpu_torch.parallel.sharding"}}
assert sharded <= set(names), sorted(sharded - set(names))
remat = {{"phantom_vlb_tpu_torch.core.remat", "phantom_vlb_tpu_torch.core.dtypes",
         "phantom_vlb_tpu_torch.core.registry", "phantom_vlb_tpu_torch.data.grain_loader",
         "phantom_vlb_tpu_torch.utils.profiling"}}
assert remat <= set(names), sorted(remat - set(names))
import torch
assert hasattr(torch.ops.vlb, "flash_fwd") and hasattr(torch.ops.vlb, "lora_dropout_fwd")
assert "grain" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_h5py_yaml_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = len(list((ROOT / "phantom_vlb_tpu_torch").rglob("*.py"))) - 1
    assert int(proc.stdout.split()[-1]) == modules      # every module was imported


QUALITY_SCRIPTS = ("quant_quality_run_torch", "plateau_run_torch")

_SCRIPT_CHILD = f"""
import importlib, sys
for name in {BLOCKED + ("__graft_entry__",)!r}:
    sys.modules[name] = None
sys.path.insert(0, "scripts")
importlib.import_module(sys.argv[1])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED + ("__graft_entry__",)!r}
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("script", QUALITY_SCRIPTS)
def test_quality_scripts_import_without_jax_or_the_jax_package(script):
    proc = subprocess.run([sys.executable, "-c", _SCRIPT_CHILD, script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], proc.stderr


@pytest.mark.parametrize("script", QUALITY_SCRIPTS)
def test_quality_scripts_raise_without_a_card(script, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    module = __import__(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(["--preset", "narrow", "--layers", "2"])


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tv.VLBConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_batches(model, [])
    assert resolve_device("cpu") == torch.device("cpu")
