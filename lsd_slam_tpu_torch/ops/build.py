"""Build and load the port's CUDA kernels (nvcc -> .so -> ctypes).

Each source under `lsd_slam_tpu_torch/csrc/` is compiled on first use into
`lsd_slam_tpu_torch/_build/` (listed in .gitignore) as a shared library
with a plain C interface, named by the hash of its source and flags, so an
edited source never loads a stale build. Nothing here runs at import:
the CPU tests import every module on a host with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source file under csrc/
SOURCES = {
    "regularize_stencil": "regularize_stencil.cu",
    "segment_sum": "segment_sum.cu",
    "lm_track": "lm_track.cu",
    "sim3_track": "sim3_track.cu",
    "epl_stereo": "epl_stereo.cu",
    "fill_holes": "fill_holes.cu",
}

# -fmad=false: the kernels must round like the JAX lattice, which never
# contracts a multiply and an add into one FMA
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# first use may come from several threads of one process at once (the
# engine's workers); `build` names its temp file by pid, so the build and
# the load run under one lock
_load_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, source: Optional[Path] = None) -> Path:
    """The build of kernel `name`, from `source` (default: its file under
    csrc/)."""
    src = Path(source or CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Optional[Iterable[str]] = None, verbose: bool = False,
          sources: Optional[Dict[str, Path]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together; `sources` adds builds
    of other files by name (e.g. an earlier version of a kernel to time
    against). Returns the wall seconds per kernel built; raises with nvcc's
    output on failure."""
    todo = {n: CSRC / SOURCES[n] for n in (SOURCES if names is None
                                           else names)}
    todo.update(sources or {})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, src in todo.items():
        out = library_path(name, src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log.strip():
            print(f"[nvcc {name}]\n{log.strip()}", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed;
    safe to call from several threads (one build, one load)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib
