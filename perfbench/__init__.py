"""The benchmark of ucfp_tpu_torch on one H100: served lookups over HTTP.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output (perfbench/run.py says what a run does)."""
