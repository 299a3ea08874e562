"""Readings behind the correctness limits: the program's compared numbers
and its control's, on many seeds in one process, at the cell's own size.

    python3 rtbench/control.py --workload demo.orbit --seeds 11,12,13 --seconds 4

For each seed: a run of the cell with a short window (set-up, warm-up, the
window, the check's frames), then the reference over the compared frames
once, which gives the program's numbers and the control's: the reference
with its radiance planes and denoiser history stored as bfloat16, put in
the program's place on the same frames from the same history. Prints one
JSON line a seed, and last the largest program reading and the smallest
control reading of each number. The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, seconds, device, size=None):
    """[(seed, program numbers, control numbers)]."""
    from rtbench.core import check, window

    rows = []
    for seed in seeds:
        out = window.run_window(cell, seed, seconds, False, device, time.perf_counter(), size)
        prog, low = check.compare(cell.config, out["traffic"], out["checked"], out["size"],
                                  device, control=True)
        rows.append((seed, prog, low))
        print(json.dumps({"seed": seed, "frames": len(out["run"].frames),
                          "compared": len(out["checked"]), "program": prog, "control": low}),
              flush=True)
        del out
        gc.collect()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=4.0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from rtbench.core import check, runner, spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {runner.card_info()}", flush=True)
    cell = spec.load_cell(args.workload, ROOT)
    rows = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, "cuda")
    summary = {k: {"program_max": max(r[1][k] for r in rows),
                   "control_min": min(r[2][k] for r in rows),
                   "limit": cell.config.LIMITS[k]} for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
