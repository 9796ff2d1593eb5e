"""Small cells for the CPU tests: a configuration and a traffic mix of the
benchmark's, found by name whether or not ``BENCHMARK.json`` runs the pair,
cut to a few frames of 240x320 and run with the port's eager CPU path."""

import copy
import os

from vobench import manifest


def small_cell(name: str, frames: int = 7, chunk: int = 3) -> manifest.Cell:
    config_name, traffic_name = name.split(".")
    cfg = copy.deepcopy(manifest.load_json(
        os.path.join(manifest.HERE, "configs", config_name + ".json")))
    cfg["camera"].update(width=320, height=240, cx=160.0, cy=120.0)
    cfg["world"]["n_points"] = 600
    traffic = manifest.load_json(os.path.join(manifest.HERE, "traffic", traffic_name + ".json"))
    traffic = dict(traffic, pass_frames=frames,
                   chunk_frames=chunk if traffic["chunk_frames"] else 0)
    # the per-layer metrics of the benchmark's cells of this mix
    per_layer = [m for m in manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
                 ["per_layer"] if any(w.endswith("." + traffic_name) for w in m["workloads"])]
    return manifest.Cell(
        name=name, config_name=config_name, config=cfg, traffic_name=traffic_name,
        traffic=traffic, chips=1,
        end_to_end=[{"name": "setup_s", "unit": "s"},
                    {"name": "step_p50_ms" if traffic["mode"] == "stream" else "replay_fps",
                     "unit": "ms" if traffic["mode"] == "stream" else "frames/s"}],
        per_layer=per_layer, readers={m["name"]: manifest.reader(m["name"]) for m in per_layer},
    )
