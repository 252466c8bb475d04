"""Build the port's CUDA C++ sources into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for `sm_90a` into `build/kernels/lib<name>-<hash>.so` under the
repository root (a directory git ignores), keyed on the source text and
the flags, then loaded with `ctypes`. Nothing is built when a module is
imported: the first launch (or an explicit `build`) compiles. A machine
without `nvcc` raises here; the CPU path never gets this far.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> float | None:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    seconds `nvcc` took, or None when the library was there. The
    compiler's output (ptxas register/spill report) is kept beside the
    library as `<lib>.log`."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(res.stdout)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler output kept from the last build of `name`."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
