"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration, traffic mix and metrics; the
configuration's file is the one its entry names, the mix is
``vobench/traffic/<traffic>.json`` and each per-layer metric's reader is
``vobench/layer_metrics/<metric>.py``. No list of them lives in code, so a
later change adds a configuration, a mix or a metric by adding files and
entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
READER_DIR = os.path.join(HERE, "layer_metrics")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]        # the cell's end-to-end metrics, setup_s among them
    per_layer: List[dict]         # the cell's per-layer metrics
    readers: Dict[str, Callable]  # per-layer metric name -> read(window)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def for_cell(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str, reader_dir: str = READER_DIR) -> Callable:
    """``read(window)`` of ``layer_metrics/<name>.py``, loaded by path (a
    metric's name may hold dots)."""
    path = os.path.join(reader_dir, name + ".py")
    spec = importlib.util.spec_from_file_location("vobench_layer_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if for_cell(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name, config_name=w["config"], config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(root, "vobench", "traffic", w["traffic"] + ".json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=layer,
        readers={m["name"]: reader(m["name"], os.path.join(root, "vobench", "layer_metrics"))
                 for m in layer},
    )
