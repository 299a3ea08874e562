"""The Engine's spans (runtime/profiler.py::annotate) in a benchmark cell's
traced stretch, on the CUDA card: where the host is while the device idles.

Runs the cell as `rtbench/run.py --trace 1` does (rtbench's window, its
torch.profiler stretch and its reduction of the profile, which this script
leaves as it is), keeps the profile's events and reads the "rtvs." spans
on the profiler's clock, a mean over the traced frames:

- render_issue_ms: host ms from the start of rtvs.render to the start of
  its rtvs.render.readback, the time the host takes to issue the frame;
- readback_wait_ms: host ms inside rtvs.render.readback, the wait for the
  device to drain and the RGBA8 copy;
- launch_gap_ms: the device's idle ms between those two points;
- render_host_ms, update_host_ms: the harness's rtbench.render and
  rtbench.update_scene ranges, and the share of them that rtvs.render and
  rtvs.update_scene cover;
- each span's host ms, and the device's idle ms by the innermost span open
  on the host at each idle gap's midpoint (the harness's gap name where
  none is open);
- the longest idle gaps, each with that span and the innermost host event
  of any kind open at its midpoint;
- device_spans: names of device-side events that carry a span's name (none
  is expected: the spans are host events alone);
- photon_pass, in a caustics cell: the host ms of rtvs.render.caustics'
  three spans (emit_trace, hash, gather) and the device's idle ms under
  each, and on the device, a pass at a time (K5's start to the next K6's
  end, as rtbench's photon_pass_ms reads it): K5's ms, the hash build's
  (the device's busy and idle ms between K5's end and K6's start) and
  K6's.

It prints the card's name and power limit, and as its last line a JSON
object of the readings.

    python3 scripts/torch_spans.py --workload demo.orbit --seed 7 --seconds 10
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = "rtvs."
TOP = 10
CAUSTICS = "rtvs.render.caustics"
PHOTON_SPANS = ("emit_trace", "hash", "gather")


def keep_events(trace_mod) -> dict:
    """Make trace_mod.reduce_events keep what it reduces: the events as
    (name, start_us, end_us, on the device) under "events", and its
    TraceData under "trace"."""
    from torch.autograd import DeviceType

    kept, reduce = {}, trace_mod.reduce_events

    def keeping(events, skip_frames=1):
        kept["events"] = [(e.name, float(e.time_range.start), float(e.time_range.end),
                           e.device_type == DeviceType.CUDA) for e in events]
        kept["trace"] = reduce(events, skip_frames)
        return kept["trace"]

    trace_mod.reduce_events = keeping
    return kept


def overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def innermost(ranges, t):
    """The range of `ranges` [(name, start, end)] open at t that started
    last (the innermost, for ranges nested by call), or None."""
    best = None
    for r in ranges:
        if r[1] <= t < r[2] and (best is None or r[1] >= best[1]):
            best = r
    return best


def photon_pass(trace, span_ms, idle_ms) -> dict:
    """The photon_pass readings of the module's docstring (None without a
    K5 in the traced stretch); span_ms and idle_ms are read_spans' own.
    The passes are rtbench's photon_pass_ms reader's."""
    from rtbench.core import spec
    from rtbench.core.trace import busy_union, kernel_base

    metric = spec.load_module(os.path.join(ROOT, "rtbench", "metrics", "photon_pass_ms.py"),
                              "rtbench_metric_photon_pass_ms")
    passes = metric.passes(trace)
    if not passes:
        return None
    ops = [(kernel_base(n), s, e) for n, s, e in trace.device_ops]
    k5 = k6 = busy = idle = 0.0
    for start, end in passes:
        k5_end = min(e for k, s, e in ops if k == metric.EMIT and s == start)
        k6_start = max(s for k, s, e in ops if k == metric.GATHER and e == end)
        between, _ = busy_union([(s, e) for k, s, e in ops
                                 if k not in (metric.EMIT, metric.GATHER)], k5_end, k6_start)
        k5 += k5_end - start
        k6 += end - k6_start
        busy += between
        idle += max(0.0, k6_start - k5_end) - between
    n = len(passes)
    sub = {k: {"host_ms": span_ms.get(f"{CAUSTICS}.{k}", 0.0),
               "idle_ms": idle_ms.get(f"{CAUSTICS}.{k}", 0.0)} for k in PHOTON_SPANS}
    return {"passes": n, "spans": sub, "k5_ms": k5 * 1e-3 / n,
            "hash_busy_ms": busy * 1e-3 / n, "hash_idle_ms": idle * 1e-3 / n,
            "k6_ms": k6 * 1e-3 / n}


def read_spans(events, trace, gap_name) -> dict:
    """The readings of the module's docstring, from the kept events and the
    harness's TraceData; gap_name(trace, gap) is the harness's name."""
    lo, hi = trace.start_us, trace.start_us + trace.window_us
    host = [(n, s, e) for n, s, e, dev in events if not dev and s >= lo and e <= hi]
    spans = [r for r in host if r[0].startswith(SPAN)]
    frames = trace.frames
    issue = wait = gap = 0.0
    renders = [r for r in spans if r[0] == "rtvs.render"]
    for _, s, e in renders:
        (rb,) = [r for r in spans if r[0] == "rtvs.render.readback" and s <= r[1] and r[2] <= e]
        issue += rb[1] - s
        wait += rb[2] - rb[1]
        gap += sum(overlap(g0, g1, s, rb[1]) for g0, g1 in trace.gaps)

    def cover(outer, inner):
        """(host ms a frame of the harness's `outer` ranges, the % of it
        that the `inner` spans cover, None where there are none: a still
        cell's traced frames run no update_scene)."""
        outs = [r for r in host if r[0] == outer]
        total = sum(o[2] - o[1] for o in outs)
        covered = sum(overlap(o[1], o[2], i[1], i[2])
                      for o in outs for i in spans if i[0] == inner)
        return total * 1e-3 / frames, 100.0 * covered / total if total else None

    render_host, render_cover = cover("rtbench.render", "rtvs.render")
    update_host, update_cover = cover("rtbench.update_scene", "rtvs.update_scene")
    span_ms, idle_ms = {}, {}
    for n, s, e in spans:
        span_ms[n] = span_ms.get(n, 0.0) + (e - s) * 1e-3 / frames

    def name_of(g):
        sp = innermost(spans, 0.5 * (g[0] + g[1]))
        return sp[0] if sp else gap_name(trace, g)

    for g in trace.gaps:
        k = name_of(g)
        idle_ms[k] = idle_ms.get(k, 0.0) + (g[1] - g[0]) * 1e-3 / frames
    top = []
    for g in sorted(trace.gaps, key=lambda g: g[0] - g[1])[:TOP]:
        op = innermost(host, 0.5 * (g[0] + g[1]))
        top.append([name_of(g), (g[1] - g[0]) * 1e-3, op[0] if op else None])
    n = len(renders)
    return {
        "frames": frames, "renders": n,
        "render_issue_ms": issue * 1e-3 / n if n else None,
        "readback_wait_ms": wait * 1e-3 / n if n else None,
        "launch_gap_ms": gap * 1e-3 / n if n else None,
        "render_host_ms": render_host, "render_span_cover_pct": render_cover,
        "update_host_ms": update_host, "update_span_cover_pct": update_cover,
        "idle_ms_a_frame": (trace.window_us - trace.busy_us) * 1e-3 / frames,
        "span_ms": dict(sorted(span_ms.items())),
        "idle_ms_by_span": dict(sorted(idle_ms.items(), key=lambda kv: -kv[1])),
        "idle_gaps_ms": top,
        "device_spans": sorted({name for name, _, _, dev in events
                                if dev and name.startswith(SPAN)}),
        "photon_pass": photon_pass(trace, span_ms, idle_ms),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="demo.orbit")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from rtbench.core import runner, spec
    from rtbench.core import trace as trace_mod

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {runner.card_info()}", flush=True)
    kept = keep_events(trace_mod)
    cell = spec.load_cell(args.workload, ROOT)
    res = runner.run_cell(cell, args.seed, args.seconds, True, "cuda", T_PROCESS)
    out = read_spans(kept["events"], kept["trace"], trace_mod.gap_name)
    out.update(workload=args.workload, seed=args.seed, correct=res["correct"],
               metrics={k: v["value"] for k, v in res["metrics"].items()})
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
