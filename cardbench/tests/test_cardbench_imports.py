"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

MODULES = ["cardbench.run", "cardbench.harness", "cardbench.calibrate", "cardbench.trace", "cardbench.flops",
           "cardbench.weights", "cardbench.batches", "cardbench.compare", "cardbench.reference.vlb"]


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", f"{code}\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_forbidden_is_whole_top_level_names():
    from cardbench.run import FORBIDDEN

    def flagged(names):
        return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

    assert flagged(["phantom_vlb_tpu_torch", "phantom_vlb_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert flagged(["phantom_vlb_tpu", "phantom_vlb_tpu.models", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "phantom_vlb_tpu", "phantom_vlb_tpu.models"]


def test_harness_and_port_import_no_jax():
    from cardbench.run import FORBIDDEN

    code = "\n".join(f"import {m}" for m in MODULES)
    code += "\nimport phantom_vlb_tpu_torch.train.builder, phantom_vlb_tpu_torch.train.loop"
    found = {n for n in _modules_after(code) if n.split(".", 1)[0] in FORBIDDEN}
    assert found == set()


def test_reference_imports_nothing_of_the_program():
    # the adapters' dropout file too, which the reference loads when it is built
    names = _modules_after("import json\nimport cardbench.reference.vlb as vlb\n"
                           "vlb._dropout_keep(json.load(open('cardbench/configs/videollama2-7b-lora.json'))"
                           "['model']['lora'])")
    assert not {n for n in names if n.split(".", 1)[0] in ("phantom_vlb_tpu_torch", "phantom_vlb_tpu", "jax")}
