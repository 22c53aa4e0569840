"""The benchmark of the PyTorch/CUDA port (`lsd_slam_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
camera model or per-layer metric is a file of its own under `configs/`,
`traffic/`, `cameras/` and `metrics/`, found by the name that
`BENCHMARK.json` gives it.
"""
