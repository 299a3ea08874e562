"""BENCHMARK.json against the benchmark's contract, and a configuration,
traffic mix and metric added as new files only."""
import json
import os
import re
import shutil
import time

from rtbench.core import runner, spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_names_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["rtbench"] and b["command"][1] == "rtbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("rtbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "rtbench", "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert os.path.exists(os.path.join(ROOT, "rtbench", "metrics", f"{m['name']}.py"))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_loads_with_its_metrics():
    for w in bench()["workloads"]:
        cell = spec.load_cell(w["name"])
        assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}
        for key in ("WIDTH", "HEIGHT", "OVERRIDES", "CHECK", "TRACE", "LIMITS", "SOURCE"):
            assert hasattr(cell.config, key)


NEW_CONFIG = '''
import importlib.util, os
_s = importlib.util.spec_from_file_location("demo_for_new", {demo!r})
demo = importlib.util.module_from_spec(_s)
_s.loader.exec_module(demo)
SOURCE, ASSUMED, REDUCED = demo.SOURCE, [], []
WIDTH, HEIGHT = 16, 8
OVERRIDES = {{"max_soft_samples": 1, "samples_per_pixel": 1}}
CHECK = {{"start_frames": 1, "window_frames": 1}}
TRACE = demo.TRACE
LIMITS = demo.LIMITS
meshes = demo.meshes
scene = demo.scene
'''
NEW_METRIC = '''
def read(run):
    return float(len(run.frames))
'''


def test_a_new_config_traffic_and_metric_are_found_and_run(tmp_path):
    b = bench()
    b["configs"].append({"name": "tiny", "source": "test", "file": "rtbench/configs/tiny.py",
                         "reduced": [], "why": "test"})
    b["workloads"] = [{"name": "tiny.pan", "config": "tiny", "traffic": "pan", "chips": 1,
                       "why": "test"}]
    b["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.1, "source": "host_clock"})
    for d in ("configs", "traffic"):
        os.makedirs(tmp_path / "rtbench" / d)
    shutil.copytree(os.path.join(ROOT, "rtbench", "metrics"), tmp_path / "rtbench" / "metrics")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "rtbench" / "configs" / "tiny.py").write_text(NEW_CONFIG.format(
        demo=os.path.join(ROOT, "rtbench", "configs", "demo.py")))
    (tmp_path / "rtbench" / "traffic" / "pan.json").write_text(json.dumps({
        "start_azimuth_deg": [10, 20], "degrees_per_frame": 5.0, "update_scene": "every_frame",
        "warmup_frames": 1}))
    (tmp_path / "rtbench" / "metrics" / "frames_done.py").write_text(NEW_METRIC)
    cell = spec.load_cell("tiny.pan", str(tmp_path))
    res = runner.run_cell(cell, 2**31 + 11, 2.0, False, "cpu", time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["frames_done"]["value"] == res["frames"] >= 1
    assert set(res["metrics"]) >= {"frame_ms", "setup_s", "frames_done"}
    assert all(v["value"] == 0 for v in res["check"].values())
