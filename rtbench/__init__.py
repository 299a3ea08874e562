"""rtbench: the end-to-end benchmark of raytracevs_tpu_torch on one card.

`python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json; see README.md.
"""
