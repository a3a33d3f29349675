"""Point-cloud utilities on the host (`vfmreg_tpu/utils/pcl.py`).

`transform_pcl` (`:20`) transforms the xyz columns and carries the
descriptor columns. `KNeighbors` (`:48-88`) is the reference's clone of
FaissKNeighbors on the port's native KD-tree (`native/kdtree.py`), with
faiss `IndexFlatL2` semantics: SQUARED L2 distances, zero-distance
(self / duplicate) hits dropped, `query` strict `d2 < r` and
`n_neighbors_in_radius` inclusive `d2 <= r`. The cluster-removal experiment
runs them on ragged host data. `_brute_knn` is the plain version the tests
hold the tree against.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vfmreg_tpu_torch.native.kdtree import NativeKDTree


def transform_pcl(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Transform the xyz columns of [N, 3 + D] points by a 4x4 pose; the
    descriptor columns ride along. Keeps the points' dtype."""
    pts = np.asarray(points)
    xyz = pts[:, :3] @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    if pts.shape[1] > 3:
        return np.c_[xyz.astype(pts.dtype), pts[:, 3:]]
    return xyz.astype(pts.dtype)


def _brute_knn(data: np.ndarray, queries: np.ndarray, k: int, chunk: int = 1024):
    """Chunked brute-force k-NN: ([nq, k] indices, [nq, k] squared
    distances), ascending, ties to the lower index."""
    nq = queries.shape[0]
    idx = np.empty((nq, k), dtype=np.int64)
    d2 = np.empty((nq, k), dtype=np.float64)
    for b in range(0, nq, chunk):
        q = queries[b : b + chunk]
        dist2 = (
            np.sum(q * q, axis=1)[:, None]
            - 2.0 * q @ data.T
            + np.sum(data * data, axis=1)[None, :]
        )
        np.maximum(dist2, 0.0, out=dist2)
        part = np.argpartition(dist2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(dist2, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx[b : b + chunk] = np.take_along_axis(part, order, axis=1)
        d2[b : b + chunk] = np.take_along_axis(pd, order, axis=1)
    return idx, d2


class KNeighbors:
    """The API of FaissKNeighbors (`vfm_reg/utils.py:19-44`) on the native
    KD-tree."""

    def __init__(self, k: int = 5):
        self.k = k
        self._tree: Optional[NativeKDTree] = None
        self._data: Optional[np.ndarray] = None
        self._payload: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: Optional[np.ndarray] = None):
        # faiss indexes float32 copies: keep that quantization.
        self._data = np.ascontiguousarray(X, dtype=np.float32).astype(np.float64)
        self._tree = NativeKDTree(self._data)
        self._payload = np.arange(X.shape[0]) if y is None else np.asarray(y)
        return self

    def _knn(self, X: np.ndarray, k: int):
        q = np.ascontiguousarray(X, dtype=np.float32).astype(np.float64)
        return self._tree.knn(q, min(k, self._data.shape[0]))

    def query(self, X: np.ndarray, k: int, r: float) -> np.ndarray:
        """Payload values of up to k neighbours with 0 < squared distance < r,
        flattened and deduplicated (`vfm_reg/utils.py:30-38`)."""
        idx, d2 = self._knn(X, k)
        idx, d2 = idx.ravel(), d2.ravel()
        keep = (d2 > 0.0) & (d2 < r)
        return np.unique(self._payload[idx[keep]])

    def n_neighbors_in_radius(self, X: np.ndarray, k: int, r: float) -> np.ndarray:
        """Per query, the number of neighbours with 0 < squared distance <= r,
        capped at k (`vfm_reg/utils.py:39-44`)."""
        _, d2 = self._knn(X, k)
        return np.sum((d2 > 0.0) & (d2 <= r), axis=1)
