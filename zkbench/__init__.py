"""The benchmark of zolt_tpu_torch: see README.md and BENCHMARK.json."""
