"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface and loaded with `ctypes`. One `nvcc` process
per source, all started together. A build happens at first use, into
`vfmreg_tpu_torch/_build/` (git-ignored), and is reused while a hash of the
source and the flags stays the same. Nothing is built when a module is
imported, and a missing or failing `nvcc` raises with its output: there is no
fallback.

Every wrapper counts its launches in `LAUNCHES`, so that a run can show which
kernels the path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch count per kernel, bumped by each wrapper right where it launches.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, spills, shared memory) per source.
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, in parallel."""
    names = [n for n in names if not _target(n).exists()]
    if not names:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = _target(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def launcher(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """`symbol` of `csrc/<name>.cu`'s library, typed: pointers and the stream
    as c_void_p (a bare Python int would be cut to 32 bits), returning the
    cudaError_t as c_int."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
