"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source `presto_tpu_torch/csrc/<name>.cu` has a plain C interface and
compiles on its own into `build/lib<name>-<hash>.so` at the repository
root (the hash is of the source text, so an edited source rebuilds).
The build runs at first use, never at import.  Nothing here runs
without a CUDA toolkit: the CPU paths never call it.
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
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
# C signatures of the exported functions, by source
SIGNATURES = {
    "fused_group_sums": {
        "fused_group_sums_f64": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, *[ctypes.c_int] * 8, _P, _P, _P]),
        "fused_group_sums_f32in": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, *[ctypes.c_int] * 8, _P, _P, _P]),
        "fused_group_sums_bounds": (
            None, [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]),
        "presto_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "block_gather": {
        "block_gather_u32": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, ctypes.c_longlong,
             *[ctypes.c_int] * 7, _P, _P, ctypes.c_int, _P]),
        "block_gather_bounds": (
            None, [ctypes.POINTER(ctypes.c_int)] * 5),
        "presto_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: per source: {"seconds": build wall time, "log": nvcc's output}
build_info: Dict[str, dict] = {}


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, else the one on PATH, else the toolkit's
    default install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    per source, all started together.  Raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    paths = {}
    for name in names:
        path = paths[name] = library_path(name)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        jobs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, paths[name])  # atomic: a reader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (res, args) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _loaded[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    msg = lib.presto_cuda_error_string(int(code))
    return f"{msg.decode()} (cudaError {code})"
