"""Run one cell of the benchmark of raytracevs_tpu_torch.

    python3 rtbench/run.py --workload demo.orbit --seed 7 --seconds 30 --trace 0

from the root of a checkout holding BENCHMARK.json, rtbench/ and the port.
Prints the cell's metrics as the last line of standard output, one JSON
object ({"correct", "attempted", "failed", "metrics", "device", with
--trace 1 also "breakdown", and "check" last: each compared number with its
limit}), and the compared numbers beside their limits as the last lines of
standard error. Exits 2 without a result when PyTorch sees no CUDA card or
fewer than the cell asks for, and 3 when JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from rtbench.core import runner, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(f"card: {runner.card_info()}", flush=True)
    res = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if args.trace:
        device["busy_s"] = res["trace"].busy_us * 1e-6
        device["window_s"] = res["trace"].window_us * 1e-6
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    print(f"frames {res['frames']} (median {res['median_ms']:.4f} ms); rays a frame "
          f"(Engine.last_rays) {res['last_rays']}; compared frames {res['compared']}",
          flush=True)
    print(f"frames compared: {res['compared']}", file=sys.stderr)
    for k, v in res["check"].items():
        ok = "within" if v["value"] <= v["limit"] else "OVER"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
