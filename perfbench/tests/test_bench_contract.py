"""BENCHMARK.json's form, and every file a cell names is found by its name."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.load_bench()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to compile
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            for key in ("why", "layer") + (("source",) if group == "configs" else ()):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, cfg, traffic = harness.load_cell(BENCH, cell)
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"].startswith("perfbench/") and cfg["reduced"] == config["reduced"]
    assert {"source", "assumed", "reduced"} <= set(cfg)
    for kind, name in [("scenes", cfg["scene"]), ("pipelines", traffic["pipeline"]),
                       ("references", traffic["reference"])] + [("taps", t) for t in traffic["taps"]]:
        assert (harness.BENCH / kind / f"{name}.py").is_file(), (kind, name)
    e2e, layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e:
        assert (harness.BENCH / "end_to_end" / f"{harness.reader_name('end_to_end', m['name'])}.py").is_file()
    for m in layer:
        assert (harness.BENCH / "metrics" / f"{harness.reader_name('metrics', m['name'])}.py").is_file()
        assert m["moves"] in names


def test_every_config_used_and_metric_cells_exist():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_a_split_quantity_is_read_by_its_base(tmp_path, monkeypatch):
    assert harness.reader_name("end_to_end", "frames_per_s.scan") == "frames_per_s"
    assert harness.reader_name("metrics", "device_idle.tabletop") == "device_idle"
    assert harness.reader_name("metrics", "normals_ms") == "normals_ms"
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.y.py").write_text("")
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert harness.reader_name("metrics", "x.y.z") == "x.y"


def test_traffic_files_are_data():
    for w in BENCH["workloads"]:
        path = harness.BENCH / "traffic" / f"{w['traffic']}.json"
        assert isinstance(json.loads(path.read_text())["limits"], dict)
