"""The span readers (``spans.py`` and the four ``program_span`` metrics) on
hand-made span records and a hand-made device-only trace, and through the
harness's own traced run on the CPU."""

from __future__ import annotations

import dataclasses

import pytest

from cardbench.harness import Run, load_plugin
from cardbench.spans import OUTSIDE, idle_by_span, issuing_idle_ns, table
from cardbench.trace import DeviceOp, Trace
from test_cardbench_reference import tiny_run

METRICS = ("host_issue_ms", "finite_sync_ms", "put_ms", "idle_while_issuing_ms")


def _trace() -> Trace:
    """The device-only pass: a window [1000, 2000) ns, busy [1100, 1200),
    [1300, 1500), [1700, 1900): 500 ns idle over 2 steps."""
    ops = [DeviceOp("k", "eager", a, b - a, -1) for a, b in ((1100, 1200), (1300, 1500), (1700, 1900))]
    return Trace(ops, (1000, 2000), 1e-6, 500, 2, [], {}, {})


def _records():
    from phantom_vlb_tpu_torch.utils.profiling import SpanRecord

    spans = [  # index, name, start, end, parent
        (0, "train_one", 1050, 1600, -1), (1, "put", 1060, 1120, 0), (2, "forward", 1120, 1400, 0),
        (3, "vision", 1150, 1250, 2), (4, "finite_sync", 1400, 1590, 0),
        (5, "train_one", 1650, 1950, -1), (6, "put", 1660, 1700, 5), (7, "finite_sync", 1800, 1950, 5),
        # the step traced with the host, after the window: longer spans
        (8, "train_one", 2100, 2900, -1), (9, "put", 2110, 2500, 8), (10, "finite_sync", 2600, 2890, 8),
    ]
    roots = {}
    out = []
    for index, name, start, end, parent in spans:
        roots[index] = index if parent == -1 else roots[parent]
        out.append(SpanRecord(index, name, start, end, parent, roots[index]))
    return out


@pytest.fixture
def recorded(monkeypatch):
    from phantom_vlb_tpu_torch.utils import profiling

    def fill(records):
        recorder = profiling.SpanRecorder()
        recorder.records.extend(records)
        monkeypatch.setattr(profiling, "SPANS", recorder)
        r = Run({}, 1, 0.0, None)
        r.trace = _trace()
        return r

    return fill


def _read(run) -> dict:
    return {name: load_plugin("metrics", name).read(run) for name in METRICS}


def test_per_step_means(recorded):
    got = _read(recorded(_records()))
    assert got == pytest.approx({
        "host_issue_ms": ((550 - 190) + (300 - 150)) / 2 / 1e6,
        "finite_sync_ms": (190 + 150) / 2 / 1e6,
        "put_ms": (60 + 40) / 2 / 1e6,
        # idle under train_one, not under finite_sync: A 10 + 40 + 50 + 50 + 10, B 10 + 40
        "idle_while_issuing_ms": (160 + 50) / 2 / 1e6,
    })


def test_a_second_profiled_pass_is_ignored(recorded):
    records = _records()
    assert _read(recorded(records)) == _read(recorded([r for r in records if r.step != 8]))


def _idle_by_name(tr, records) -> dict[str, int]:
    names = {r.index: r.name for r in records}
    by_name: dict[str, int] = {}
    for index, ns in idle_by_span(tr, records).items():
        key = "outside" if index == OUTSIDE else names[index]
        by_name[key] = by_name.get(key, 0) + ns
    return by_name


def test_every_idle_ns_falls_in_one_bucket():
    tr, records = _trace(), _records()
    by_name = _idle_by_name(tr, records)
    assert by_name == {"outside": 50 + 50 + 50, "train_one": 10 + 10 + 10, "put": 40 + 40, "vision": 50,
                       "forward": 50, "finite_sync": 90 + 50}
    assert sum(by_name.values()) == (tr.window_ns[1] - tr.window_ns[0]) - tr.busy_ns


def test_the_table_by_span_name():
    tr, records = _trace(), _records()
    got = table(tr, records)
    assert got["steps"] == 2 and got["idle_ms"] == 500 / 2 / 1e6
    assert got["idle_ms_by_span"] == pytest.approx({k: v / 2 / 1e6 for k, v in _idle_by_name(tr, records).items()})
    assert sum(got["idle_ms_by_span"].values()) == pytest.approx(got["idle_ms"])
    # the window's two steps only; self time is length less the children's
    assert got["ms_by_span"] == pytest.approx({k: v / 2 / 1e6 for k, v in {
        "train_one": 550 + 300, "put": 60 + 40, "forward": 280, "vision": 100, "finite_sync": 190 + 150}.items()})
    assert got["self_ms_by_span"] == pytest.approx({k: v / 2 / 1e6 for k, v in {
        "train_one": (550 - 60 - 280 - 190) + (300 - 40 - 150), "put": 100, "forward": 280 - 100, "vision": 100,
        "finite_sync": 340}.items()})


def test_a_zero_wait_reads_zero(recorded):
    records = [dataclasses.replace(r, end_ns=r.start_ns) if r.name == "finite_sync" else r for r in _records()]
    got = _read(recorded(records))
    assert got["finite_sync_ms"] == 0.0 and got["host_issue_ms"] == pytest.approx((550 + 300) / 2 / 1e6)
    # a span of no length takes no idle: the waits' idle falls to their train_one roots
    assert _idle_by_name(_trace(), records) == {"outside": 150, "train_one": 10 + 10 + 10 + 90 + 50,
                                                "put": 40 + 40, "vision": 50, "forward": 50}
    assert issuing_idle_ns(_trace(), records) == (250 + 100, 2)
    assert got["idle_while_issuing_ms"] == pytest.approx((250 + 100) / 2 / 1e6)


def test_no_spans_give_nothing(recorded, monkeypatch):
    from phantom_vlb_tpu_torch.utils import profiling

    assert _read(recorded([])) == dict.fromkeys(METRICS)
    r = recorded(_records())
    r.trace = None
    assert _read(r) == dict.fromkeys(METRICS)
    r = recorded(_records())
    monkeypatch.delattr(profiling, "SPANS")               # a program without the recorder
    assert _read(r) == dict.fromkeys(METRICS)


def test_tiny_traced_run_reports_the_span_metrics():
    result = tiny_run("lora-frames-b3", trace=True)
    assert result["correct"]
    for name in ("host_issue_ms", "finite_sync_ms", "put_ms"):
        value = result["metrics"][name]["value"]
        assert value >= 0 and value < float("inf"), name
    assert result["metrics"]["host_issue_ms"]["value"] > result["metrics"]["put_ms"]["value"]
