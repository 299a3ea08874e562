"""Where a cell's parts are found: BENCHMARK.json names the cell's
configuration, traffic mix and metrics, and each is a file of its own under
the benchmark's folder, found by its name:

    rtbench/configs/<config>.py     the scene, its size, checks and limits
    rtbench/traffic/<traffic>.json  the traffic generator's parameters
    rtbench/metrics/<metric>.py     a reader: read(run) -> number or None

So a later change adds a configuration, a mix or a metric by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Cell(NamedTuple):
    name: str
    config: object  # the configuration's module
    traffic: dict  # the traffic file's parameters
    end_to_end: list  # BENCHMARK.json entries of the cell's end-to-end metrics
    per_layer: list  # ... and of its per-layer metrics
    readers: dict  # metric name -> its read(run)
    chips: int


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files under
    root/rtbench."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[workload]
    base = os.path.join(root, "rtbench")
    config = load_module(os.path.join(base, "configs", f"{w['config']}.py"),
                         f"rtbench_config_{w['config']}")
    with open(os.path.join(base, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: load_module(os.path.join(base, "metrics", f"{m['name']}.py"),
                                      f"rtbench_metric_{m['name'].replace('.', '_')}").read
               for m in e2e + layer}
    return Cell(workload, config, traffic, e2e, layer, readers, int(w["chips"]))
