"""One run of a cell: the window (window.py), the metrics its files read,
the correctness check (check.py), and the result line."""
from __future__ import annotations

import gc
import statistics
import subprocess
import sys

from . import check, window

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracevs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: raytracevs_tpu_torch is the port)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_info() -> str:
    """The card's name and power limit by nvidia-smi, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_process: float,
             size=None) -> dict:
    """Run `cell` and return its result: the fields of the result line
    (without "device") and the check's numbers beside their limits."""
    out = window.run_window(cell, seed, seconds, trace, device, t_process, size)
    run = out["run"]
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = cell.readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = len(out["checked"])
    numbers = check.compare(cell.config, out["traffic"], out["checked"], out["size"], device)
    out["checked"] = None
    gc.collect()
    limits = cell.config.LIMITS
    correct = (out["failed"] == 0
               and all(numbers[k] <= limits[k] for k in check.NUMBERS))
    return {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "memory_peak_bytes": out["memory_peak_bytes"],
            "trace": run.trace, "breakdown": out["breakdown"], "frames": len(run.frames),
            "median_ms": statistics.median((f.end - f.start) * 1e3 for f in run.frames),
            "last_rays": out["last_rays"], "compared": compared,
            "check": {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}}
