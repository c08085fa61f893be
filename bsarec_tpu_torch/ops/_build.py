"""Build and load the port's CUDA kernels.

Each source in `bsarec_tpu_torch/csrc/` has a plain C interface and is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `build/kernels/<name>-<hash>.so` at the root of the checkout, then
loaded with ctypes. The hash covers the source and every header of
`csrc/` (`*.cuh`), so an edited header never loads a stale library. Nothing here runs at import time:
the CPU tests import every module on hosts with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {
    "streaming_rank": _PKG / "csrc" / "streaming_rank.cu",
    "streaming_ce": _PKG / "csrc" / "streaming_ce.cu",
    "fused_dropout": _PKG / "csrc" / "fused_dropout.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(SOURCES[name].parent.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: path}. Raises with nvcc's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log, flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
