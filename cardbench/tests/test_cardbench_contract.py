"""BENCHMARK.json and the files it names, against the benchmark's contract."""

from __future__ import annotations

import json
import re

from conftest import BENCH, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok|_dim$|_rank$)")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and not p.endswith("_torch")
                                                   for p in BENCH["paths"])
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its time: 2 + 14 x cells runs, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"]), e["name"]
    for c in BENCH["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"]) and c["chips"] in (1, 4)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {c["config"] for c in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["source"].startswith("https://") and _line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"])) and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text(encoding="utf-8"))
        assert body["name"] == c["name"] and body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and not any(WIDTHS.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per_layer = BENCH["per_layer"]
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len({(c["config"], c["traffic"]) for c in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in per_layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (ROOT / "cardbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for cell in CELLS:
        reports = [m for m in e2e.values() if cell in m.get("workloads", CELLS)]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert any(cell in m.get("workloads", CELLS) and m["moves"] in {r["name"] for r in reports}
                   for m in per_layer)


def test_every_cell_has_its_files():
    for c in BENCH["workloads"]:
        traffic = json.loads((ROOT / "cardbench" / "workloads" / f"{c['traffic']}.json").read_text(encoding="utf-8"))
        assert set(traffic["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
        assert traffic["check_steps"] >= 1 and traffic["trace_steps"] >= 1
        for name in traffic.get("setup", []):
            assert (ROOT / "cardbench" / "setup" / f"{name}.py").is_file()
