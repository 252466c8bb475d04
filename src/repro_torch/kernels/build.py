"""Build the port's CUDA C++ sources into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for `sm_90a` into `build/kernels/lib<name>-<hash>.so` under the
repository root (a directory git ignores), keyed on the source text, the
headers of `csrc/` and the flags, then loaded with `ctypes`. Nothing is built when a module is
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
    """The library's path, keyed on the source, every header of `csrc/`
    (a source may include one) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def compile_source(src: Path, out: Path) -> str:
    """Compile the CUDA source `src` into the shared library `out` with
    the port's flags; returns the compiler's output (ptxas's register and
    spill report) and raises with it when nvcc fails. Its `#include "…"`
    finds a header beside `src` first, then in `csrc/`."""
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                          str(out), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        out.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stdout}")
    return res.stdout


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
    t0 = time.perf_counter()
    try:
        log = compile_source(CSRC / f"{name}.cu", tmp)
    except RuntimeError as e:
        out.with_suffix(".log").write_text(str(e))
        raise
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(log)
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
