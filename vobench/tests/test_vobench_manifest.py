"""BENCHMARK.json against the contract's form, and the harness finding each
configuration, mix and reader from its files by name."""

import json
import os
import re
import shutil

import pytest

from vobench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["vobench"] and 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for what in ("configs", "workloads"):
        names = [e["name"] for e in bench[what]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_file_present(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        for key in c["reduced"]:
            assert NAME.match(key)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(manifest.HERE, "traffic", w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(manifest.READER_DIR, m["name"] + ".py"))


def test_each_cell_reports_what_its_layer_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert manifest.for_cell(moved, cell), (m["name"], cell)
    for cell in cells:
        c = manifest.load_cell(cell)
        names = {e["name"] for e in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path, bench):
    """A cell added as files and entries only: the harness loads it by name."""
    root = tmp_path / "repo"
    shutil.copytree(manifest.HERE, root / "vobench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    new = json.loads(json.dumps(bench))
    with open(os.path.join(manifest.HERE, "configs", "d435i.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "newrig"
    (root / "vobench" / "configs" / "newrig.json").write_text(json.dumps(cfg))
    (root / "vobench" / "traffic" / "newmix.json").write_text(
        json.dumps({"mode": "stream", "pass_frames": 9, "chunk_frames": 0}))
    (root / "vobench" / "layer_metrics" / "new.metric.py").write_text(
        "def read(window):\n    return 42.0\n")
    new["configs"].append({"name": "newrig", "source": "x", "file": "vobench/configs/newrig.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "newrig.newmix", "config": "newrig", "traffic": "newmix",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "x", "moves": "step_p50_ms",
                             "workloads": ["newrig.newmix"]})
    for m in new["end_to_end"]:
        if "workloads" in m and m["name"].startswith("step_"):
            m["workloads"].append("newrig.newmix")
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.load_cell("newrig.newmix", root=str(root))
    assert cell.config["name"] == "newrig" and cell.traffic["pass_frames"] == 9
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert cell.readers["new.metric"](None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "step_p50_ms", "step_p95_ms"}
