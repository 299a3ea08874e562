"""The harness's own modules: where a cell's files are found (spec), the
traffic generator (traffic), the timed loop (window), the trace reduction
(trace) and the correctness check (check)."""
