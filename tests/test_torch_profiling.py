"""Port parity: ``utils/profiling.py``, ``core/dtypes.py`` and ``core/registry.py``.

``span`` records nothing without a profiler; under a CPU profile its
records form the tree of the spans as they nested (parents, one step id
per root), each also a ``record_function`` range of the same name within
1 ms of it, and a tiny ``VLBTrainer.train_one`` from frames records
``train_one > put, forward > vision, backward, clip, finite_sync, update``
once a step (no ``update`` after a non-finite loss). ``trace`` writes a
Chrome trace of the block and hands back the profiler; without a card
``device_memory_stats`` lists no device (as the JAX one lists none for CPU
devices, which keep no memory stats). The dtype policies and the model
registry hold the JAX package's names, dtypes and factories (the
registered names build the JAX ``VLBConfig.full``'s decoder and head).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phantom_vlb_tpu.core import dtypes as jdtypes
from phantom_vlb_tpu.core import registry as jregistry
from phantom_vlb_tpu.utils import profiling as jprofiling
from phantom_vlb_tpu_torch.cli.predict import synthetic_batches
from phantom_vlb_tpu_torch.core import dtypes, registry
from phantom_vlb_tpu_torch.models import videollama2 as tv
from phantom_vlb_tpu_torch.models.convert import init_params
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer
from phantom_vlb_tpu_torch.train.optim import OptimConfig
from phantom_vlb_tpu_torch.utils import profiling

JNP_TO_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
STEP = {"train_one": "", "put": "train_one", "forward": "train_one", "vision": "forward",
        "backward": "train_one", "clip": "train_one", "finite_sync": "train_one", "update": "train_one"}


@pytest.fixture
def spans():
    profiling.SPANS.records.clear()
    yield profiling.SPANS
    profiling.SPANS.records.clear()


def _nested():
    with profiling.span("root"):
        with profiling.span("a"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        with profiling.span("b"):
            with profiling.span("c"):
                torch.ones(8).sum()


def _tree(records) -> list[dict[str, str]]:
    """Each step's spans as {name: parent's name}, in the order the steps began."""
    by_index = {r.index: r for r in records}
    steps: dict[int, dict[str, str]] = {}
    for r in sorted(records, key=lambda r: r.index):
        steps.setdefault(r.step, {})[r.name] = by_index[r.parent].name if r.parent >= 0 else ""
    return [steps[k] for k in sorted(steps)]


def test_span_records_nothing_without_a_profiler(spans):
    assert not torch.autograd._profiler_enabled()
    _nested()
    assert list(spans.records) == []


def test_count_records_only_under_a_profiler():
    profiling.COUNTS.clear()
    assert not torch.autograd._profiler_enabled()
    profiling.count("x", 3)
    assert not profiling.COUNTS
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x")
        profiling.count("x", 2)
        profiling.count("y")
    profiling.count("y")
    assert profiling.COUNTS == {"x": 3, "y": 1}
    profiling.COUNTS.clear()


def _metric(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "cardbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("counts,want", [({}, None), ({"other": 4}, None),
                                         ({"lora_dropout32.kernel": 448}, 100.0),
                                         ({"lora_dropout32.kernel": 3, "lora_dropout32.eager": 1}, 75.0),
                                         ({"lora_dropout32.eager": 448}, 0.0)])
def test_dropout_kernel_share_reads_the_counts(monkeypatch, counts, want):
    """The benchmark's reader of the route's counters on a fake run:
    nothing where nothing was counted."""
    import collections

    monkeypatch.setattr(profiling, "COUNTS", collections.Counter(counts))
    assert _metric("dropout_kernel_share").read(object()) == want


def test_dropout_kernel_share_without_the_counters(monkeypatch):
    monkeypatch.delattr(profiling, "COUNTS")
    assert _metric("dropout_kernel_share").read(object()) is None


def test_span_tree_under_a_cpu_profile(spans):
    with profile(activities=[ProfilerActivity.CPU]):
        _nested()
        _nested()
    records = list(spans.records)
    assert [r.name for r in records] == ["a", "c", "b", "root"] * 2           # as they closed
    assert _tree(records) == [{"root": "", "a": "root", "b": "root", "c": "b"}] * 2
    roots = [r for r in records if r.parent == -1]
    assert len(roots) == 2 and all(r.step == r.index for r in roots)
    for r in records:
        root = next(x for x in roots if x.index == r.step)
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    assert len({r.index for r in records}) == len(records)


def _ranges(spans) -> tuple[list, dict]:
    """The profiled ranges named as ``_nested``'s spans, and the records."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in ("root", "a", "b", "c")]
    return ranges, {r.name: r for r in spans.records}


def test_each_span_is_a_record_function_range(spans):
    ranges, records = _ranges(spans)
    assert sorted(name for name, _, _ in ranges) == sorted(records) == ["a", "b", "c", "root"]


def test_span_and_range_agree_within_a_millisecond(spans):
    ranges, records = _ranges(spans)
    for name, start, end in ranges:
        r = records[name]
        assert abs(r.start_ns - start) < 1_000_000 and abs(r.end_ns - end) < 1_000_000, r


def _tiny_trainer(tmp_path, n_batches: int):
    cfg = tv.VLBConfig.tiny(use_lora=True)
    model = tv.VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, "cpu", torch.Generator().manual_seed(0)))
    trainer = VLBTrainer(model, OptimConfig(lr=1e-3), TrainLoopConfig(output_dir=str(tmp_path), checkpoint=False),
                         device="cpu")
    model.train()
    batches = synthetic_batches(cfg, n_batches, 2, np.random.default_rng(0), torch.Generator().manual_seed(0),
                                "cpu", frames=True)
    return trainer, batches


def test_train_one_records_its_stages_once_a_step(tmp_path, spans):
    trainer, batches = _tiny_trainer(tmp_path, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [trainer.train_one(b) for b in batches]
    assert all(o["finite"] for o in outs) and trainer.optimizer.step == 2
    records = list(spans.records)
    assert _tree(records) == [STEP, STEP] and len(records) == 2 * len(STEP)
    trainer.train_one(batches[0])                     # no profiler: no records
    assert len(spans.records) == 2 * len(STEP)


def test_a_non_finite_step_records_no_update(tmp_path, spans):
    trainer, batches = _tiny_trainer(tmp_path, 1)
    batch = {**batches[0], "timeseries": np.full_like(batches[0]["timeseries"], np.nan)}
    with profile(activities=[ProfilerActivity.CPU]):
        out = trainer.train_one(batch)
    assert not out["finite"] and trainer.optimizer.step == 0
    assert _tree(list(spans.records)) == [{k: v for k, v in STEP.items() if k != "update"}]


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
