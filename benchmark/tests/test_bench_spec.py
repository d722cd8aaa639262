# -*- coding: utf-8 -*-
"""BENCHMARK.json and the files it names: every one loads, its names and
units keep to the allowed characters, and a cell added as files only is
found and run."""
import json
import os
import shutil

import pytest

from benchmark.harness import runner, spec
from benchmark.tests.conftest import tiny

BENCH = spec.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= allowed[section], e
        assert spec.NAME_RE.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_loads():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert spec.NAME_RE.match(w["traffic"]) and w["chips"] in (1, 4)
        entry, check, config, traffic = spec.cell(w["name"])
        assert entry == w and config["name"] == w["config"]
        assert {"flip_share", "search_gap", "cue_ms"} <= set(check["limits"]) <= {
            "flip_share", "soft_gap", "search_gap", "cue_ms"}
        assert callable(spec.entry(traffic["entry"]).request)
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}


def test_the_check_budget_fits():
    # 2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s of compile a cell
    # and 1200 s spare, with the full 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_cell_is_found_without_code(tmp_path, monkeypatch, cpu_program):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "film90-new", "config": "film90",
                               "traffic": "cli_new", "chips": 1, "why": "a new mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = spec.traffic("cli_default")
    traffic["offset_bound_seconds"] = 3
    (bench_dir / "traffic" / "cli_new.json").write_text(json.dumps(traffic))
    shutil.copy(bench_dir / "workloads" / "film90-default.json",
                bench_dir / "workloads" / "film90-new.json")
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    line, rc = runner.run("film90-new", 11, 1.0, False, require_cuda=False,
                          overrides=tiny("film90-new"))
    assert rc == 0 and line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"film_h_per_s", "setup_s"}
