"""Per-layer metrics, one module a metric, named as in BENCHMARK.json.
Each has `read(run)`, which returns the metric's value or None when the
run holds nothing to read it from."""
