#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a configuration (a camera and the engine's settings,
`configs/<name>.json`) under a traffic mix (`traffic/<name>.json`): one
camera stream, a closed loop, with its scene texture, trajectory jitter
and sensor noise drawn from the seed. Set-up builds the kernels (once per
checkout, into `lsd_slam_tpu_torch/_build/`), warms the engine up at the
cell's camera, renders the stream's path on the card and seeds the map
from frame 0's true depth. Then the stream calls the program (the
undistorter where the camera has one, then `SlamSystem.track_frame`) for
`--seconds`. After the window the program's outputs are judged against
the plain reference (`harness/reference.py`), each number beside its
limit on standard error and under "checks", last, in the result line.

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (read by `metrics/<name>.py`), the device's busy time
from torch.profiler, and a breakdown. Extra options, not used by a
check: `--control` also prints the control's readings, `--seeds a,b,...`
runs several seeds one after another in this process (the readings that
set the limits), `--device cpu` runs the program on the CPU (tests only).
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lsd_slam_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`lsd_slam_tpu_torch` is neither)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def set_environment(root: Path):
    """Caches inside the checkout at fixed paths, few threads a process."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def finite(x) -> float:
    """x as a float that JSON can hold: an infinite or NaN reading (a check
    with nothing sound to compare) as the largest float."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else sys.float_info.max


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seeds", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class Prepared:
    """What a cell's runs share in one process: the camera, the program's
    camera and undistorter, the raw image's rays."""

    def __init__(self, cell, device):
        import torch
        from benchmark.harness import spec
        from benchmark.harness.stream import engine_config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from lsd_slam_tpu_torch.ops import build
            build.build()
        self.camera = spec.camera_model(
            cell.config["camera"]["model"]).Setup(cell.config["camera"])
        self.program_cam, self.undistorter = self.camera.program(self.device)
        self.cfg = engine_config(cell, self.program_cam)
        from lsd_slam_tpu_torch.system import warmup
        warmup(self.program_cam, self.cfg,
               enable_slam=bool(cell.config["engine"].get("enable_slam",
                                                          True)),
               device=self.device)
        self.dirs_cam = self.camera.dirs_cam(self.device)


def run_once(cell, prep, seed, seconds, trace, t_start_ns, control=False):
    """One measured window of `cell` with `seed`; returns (result line,
    the control's readings or None, the stream's summary)."""
    import torch
    from benchmark.harness import reference, stats
    from benchmark.harness.stream import Stream
    from benchmark.harness.trace import DeviceTrace
    from benchmark.harness.window import Run

    dev = prep.device
    on_card = dev.type == "cuda"
    stream = Stream(cell, seed, dev, prep.camera, prep.dirs_cam, trace=trace)
    stream.setup(prep.program_cam, prep.cfg, prep.undistorter)
    tracer = DeviceTrace(torch) if trace and on_card else None
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter_ns() + 20_000_000
    t_end = t0 + int(seconds * 1e9)
    setup_s = (t0 - t_start_ns) / 1e9
    stream.run(t0, t_end)
    names = events = launches = None
    if tracer is not None:
        names, events, launches = tracer.stop()
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    size = (prep.program_cam.width, prep.program_cam.height)
    run = Run(cell, stream, t0, t_end, size, names, events, launches)

    frames = run.window_frames()
    if not frames:
        raise RuntimeError("no frame completed inside the window")
    metrics = {}
    if not trace:
        values = {
            # a lost frame (no pose) is not a completed frame
            "frames_per_s": stats.rate(
                sum(f.pose is not None for f in frames), run.seconds),
            "frame_ms_p95": stats.percentile(
                [(f.t_end - f.t_start) / 1e6 for f in frames], 95),
            "frame_ms_p99": stats.percentile(
                [(f.t_end - f.t_start) / 1e6 for f in frames], 99),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from benchmark.harness import spec
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = run.frames_called()
    failed = sum(f.pose is None for f in stream.frames)
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if tracer is not None:
        device["busy_s"] = run.busy_s()
        device["window_s"] = run.seconds
        breakdown = {"device_ops": run.device_ops(),
                     "idle_gaps": run.idle_gaps()}

    # the program's state goes before the reference runs
    output = stream.take_outputs()
    summary = stream.summary
    del run, stream, frames, events, launches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = reference.judge(cell, output, prep.camera, prep.program_cam)
    ctrl = reference.control(output, prep.camera) if control else None
    result = {"correct": reference.passed(numbers), "attempted": attempted,
              "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in numbers.items()}
    return result, ctrl, summary


def main(argv=None) -> int:
    args = parse(argv)
    set_environment(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    prep = Prepared(cell, args.device)
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])
    result = None
    t_start = T_START
    for seed in seeds:
        result, ctrl, summary = run_once(cell, prep, seed, args.seconds,
                                           bool(args.trace), t_start,
                                           args.control)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": result["checks"], "control": ctrl,
                          "metrics": result["metrics"],
                          "stream": summary}),
              file=sys.stderr, flush=True)
        t_start = time.perf_counter_ns()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
