"""BENCHMARK.json against the contract the benchmark is written to, and
the files it names."""

import json
import re

import pytest

from benchmark.harness.common import BENCH, ROOT, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = load_manifest()
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"] and MAN["command"][1] == "benchmark/run.py"
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if entry in MAN["configs"]:
        texts.append(entry["source"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_read(m):
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    moves = e2e[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in moves.get("workloads", CELLS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    def reported(group):
        return [m["name"] for m in group if cell in m.get("workloads", CELLS)]

    e2e = reported(MAN["end_to_end"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported(MAN["per_layer"])
    w = CELLS[cell]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert (BENCH / "limits" / f"{cell}.json").exists()


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configurations(c):
    assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert c["source"].startswith("https://") and c["reduced"] == []
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and "assumed" in cfg
    for w in (cfg.get("extractor_weights"), cfg.get("effect_model_weights")):
        assert w is None or (ROOT / w).exists()


def test_four_chip_cells_and_budget():
    cells = MAN["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
