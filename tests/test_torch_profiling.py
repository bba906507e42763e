"""Port parity: ``utils/profiling.py``, ``core/dtypes.py`` and ``core/registry.py``.

``StepTimer`` on a fake clock gives the JAX one's EMA and ``summary()`` to
the bit; ``trace`` writes a Chrome trace of the block and hands back the
profiler; without a card ``device_memory_stats`` lists no device (as the
JAX one lists none for CPU devices, which keep no memory stats). The dtype
policies and the model registry hold the JAX package's names, dtypes and
factories (the registered names build the JAX ``VLBConfig.full``'s
decoder and head).
"""

import json
import time

import jax.numpy as jnp
import pytest
import torch

from phantom_vlb_tpu.core import dtypes as jdtypes
from phantom_vlb_tpu.core import registry as jregistry
from phantom_vlb_tpu.utils import profiling as jprofiling
from phantom_vlb_tpu_torch.core import dtypes, registry
from phantom_vlb_tpu_torch.utils import profiling

JNP_TO_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def test_step_timer_on_a_fake_clock_matches_jax(monkeypatch):
    ticks = iter([0.0, 0.25, 1.0, 1.125, 2.0, 2.5, 3.0, 3.0078125, 4.0, 4.001, 5.0, 5.75])
    clock = [next(ticks) for _ in range(12)]
    timers = {"port": profiling.StepTimer(ema=0.8), "jax": jprofiling.StepTimer(ema=0.8)}
    for name, timer in timers.items():
        stamps = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(stamps))
        for stage in ("data", "step", "data", "step", "data", "step"):
            with timer.stage(stage):
                pass
    port, ref = timers["port"], timers["jax"]
    assert port.summary() == ref.summary() and dict(port.avg) == dict(ref.avg)
    assert dict(port.count) == dict(ref.count) == {"data": 3, "step": 3}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    (path,) = (tmp_path / "t").glob("trace.*.json")
    assert json.loads(path.read_text())["traceEvents"]


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == jprofiling.device_memory_stats() == []


@pytest.mark.parametrize("name", sorted(jdtypes.POLICIES))
def test_dtype_policies_match_jax(name):
    assert sorted(dtypes.POLICIES) == sorted(jdtypes.POLICIES)
    port, ref = dtypes.POLICIES[name], jdtypes.POLICIES[name]
    for field in ("param_dtype", "compute_dtype", "head_dtype", "metric_dtype"):
        assert getattr(port, field) == JNP_TO_TORCH[getattr(ref, field)], field
    x = [[0.1, -2.5], [3.0, 1e-3]]
    assert port.cast_compute(x).dtype == port.compute_dtype
    assert torch.equal(port.cast_head(x), torch.tensor(x, dtype=port.head_dtype))


def test_registry_matches_jax():
    assert registry.available_models() == jregistry.available_models() == ["videollama2",
                                                                          "videollama2_mistral"]
    for name in registry.available_models():
        port, ref = registry.get_model_config(name), jregistry.get_model_config(name)
        assert port.mistral.num_hidden_layers == ref.mistral.num_hidden_layers == 32
        assert port.mistral.hidden_size == ref.mistral.hidden_size
        assert port.num_target == ref.num_target
    lora = registry.get_model_config("videollama2", use_lora=True)
    assert lora.mistral.lora is not None
    for name in ("videollama2_llama", "videollama2_qwen2"):
        with pytest.raises(NotImplementedError, match="videollama2, videollama2_mistral"):
            registry.get_model_config(name)
    registry.register_model("tiny_probe")(lambda **kw: "made")
    try:
        assert registry.get_model_config("tiny_probe") == "made"
    finally:
        registry._REGISTRY.pop("tiny_probe")
