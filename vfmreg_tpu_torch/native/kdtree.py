"""ctypes binding of the host KD-tree (`native/kdtree.cpp`).

Counterpart of `vfmreg_tpu/native/kdtree.py`. `kdtree.cpp` is a copy of the
reference's source and is compiled with the reference Makefile's flags
(`vfmreg_tpu/native/Makefile`: `-O3 -march=native -fPIC -shared -std=c++17
-fopenmp`), so that on one host the two builds give the same kNN tie order,
the same Boruvka MST and the same single linkage, bit for bit.

The library is built by `g++` at first use into `vfmreg_tpu_torch/_build/`
(git-ignored), beside the CUDA kernels of `ops/_build.py`, and reused while
a hash of the source, the flags and the host's resolved `-march=native`
target options stays the same: a library built for one CPU is never loaded
on another. Nothing is built when the module is imported. A missing or
failing `g++` raises with the compiler's output: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vfmreg_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "kdtree.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native KD-tree cannot be built")
    return path


def _target(gxx: str) -> Path:
    """The library's path, keyed by the source, the flags and what
    `-march=native` resolves to on this host."""
    probe = subprocess.run([gxx, "-march=native", "-Q", "--help=target"], capture_output=True, text=True)
    if probe.returncode != 0:
        raise RuntimeError(f"g++ could not resolve -march=native (exit {probe.returncode}):\n"
                           f"{probe.stdout}{probe.stderr}")
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + probe.stdout.encode()
    return BUILD_DIR / f"libkdtree_{hashlib.sha256(key).hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded KD-tree library, built first if needed, with every
    function typed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        gxx = _gxx()
        target = _target(gxx)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.run([gxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kd_build.restype = ctypes.c_void_p
        lib.kd_build.argtypes = [f64p, ctypes.c_int64, ctypes.c_int]
        lib.kd_free.restype = None
        lib.kd_free.argtypes = [ctypes.c_void_p]
        lib.kd_knn.restype = None
        lib.kd_knn.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64, ctypes.c_int, i64p, f64p]
        lib.kd_mst_mutual_reachability.restype = ctypes.c_int64
        lib.kd_mst_mutual_reachability.argtypes = [ctypes.c_void_p, f64p, i64p, i64p, f64p]
        lib.kd_single_linkage.restype = None
        lib.kd_single_linkage.argtypes = [i64p, i64p, f64p, ctypes.c_int64, f64p]
        _lib = lib
        return _lib


def _f64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeKDTree:
    """Median-split KD-tree over [n, d] float64 points: squared-L2 k-NN and
    the mutual-reachability Boruvka MST, OpenMP-parallel queries."""

    def __init__(self, points: np.ndarray):
        self._lib = library()
        pts = _f64(np.atleast_2d(points))
        self.n, self.dim = pts.shape
        self._h = self._lib.kd_build(_ptr(pts, ctypes.c_double), ctypes.c_int64(self.n), ctypes.c_int(self.dim))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kd_free(h)
            self._h = None

    def knn(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest neighbours per query: ([nq, k] indices, [nq, k] squared
        distances), ascending; index -1 and distance inf pad where k > n."""
        q = _f64(np.atleast_2d(queries))
        if q.shape[1] != self.dim:
            raise ValueError(f"queries have {q.shape[1]} columns, the tree {self.dim}")
        # k < 1 would read an empty heap in the C++.
        if k < 1:
            raise ValueError(f"knn requires k >= 1, got {k}")
        nq = q.shape[0]
        idx = np.empty((nq, k), dtype=np.int64)
        d2 = np.empty((nq, k), dtype=np.float64)
        self._lib.kd_knn(self._h, _ptr(q, ctypes.c_double), ctypes.c_int64(nq), ctypes.c_int(k),
                         _ptr(idx, ctypes.c_int64), _ptr(d2, ctypes.c_double))
        return idx, d2

    def mst_mutual_reachability(self, core: np.ndarray) -> np.ndarray:
        """Exact MST of mr(a, b) = max(core_a, core_b, ||a - b||): [n - 1, 3]
        rows (a, b, weight)."""
        c = _f64(core).reshape(-1)
        if c.shape[0] != self.n:
            raise ValueError(f"{c.shape[0]} core distances for {self.n} points")
        m = max(self.n - 1, 1)
        a, b = np.empty(m, dtype=np.int64), np.empty(m, dtype=np.int64)
        w = np.empty(m, dtype=np.float64)
        n_edges = self._lib.kd_mst_mutual_reachability(
            self._h, _ptr(c, ctypes.c_double), _ptr(a, ctypes.c_int64), _ptr(b, ctypes.c_int64),
            _ptr(w, ctypes.c_double))
        return np.column_stack([a[:n_edges].astype(np.float64), b[:n_edges].astype(np.float64), w[:n_edges]])


def single_linkage_native(edges: np.ndarray, n: int) -> np.ndarray:
    """Union-find single linkage over the [n - 1, 3] (a, b, weight) MST edges
    of n points -> [n - 1, 4] merge rows (root_a, root_b, weight, size):
    a stable sort by weight, internal node ids n .. 2n - 2 in merge order.

    Needs the complete spanning tree: with fewer than n - 1 edges
    (disconnected input, e.g. non-finite coordinates) every internal id
    would shift, so that raises."""
    edges = np.asarray(edges)
    m = edges.shape[0]
    if m != n - 1:
        raise ValueError(
            f"single linkage needs the complete MST: got {m} edges for n={n} "
            "points (disconnected input, e.g. non-finite coordinates)"
        )
    if m == 0:
        return np.empty((0, 4), dtype=np.float64)
    lib = library()
    ea = np.ascontiguousarray(edges[:, 0], dtype=np.int64)
    eb = np.ascontiguousarray(edges[:, 1], dtype=np.int64)
    ew = _f64(edges[:, 2])
    out = np.empty((m, 4), dtype=np.float64)
    lib.kd_single_linkage(_ptr(ea, ctypes.c_int64), _ptr(eb, ctypes.c_int64), _ptr(ew, ctypes.c_double),
                          ctypes.c_int64(n), _ptr(out, ctypes.c_double))
    return out
