"""The port's HDBSCAN (`vfmreg_tpu_torch/utils/hdbscan.py`) against the
reference's (`vfmreg_tpu/utils/hdbscan.py`) on its native path.

The labels must equal the reference's, values included: the cluster-removal
experiment draws one normal per label in label order, so the same partition
numbered otherwise removes other trees. Cases: blobs with background noise at
two settings, exact duplicates (zero-distance merges), a lattice (distance
ties everywhere), degenerate inputs (fewer points than a cluster, all points
equal) and one unimodal blob (all noise, the root never selected). The
native path is also held against the plain one (dense Prim MST, Python
union-find): the same partition, numbered as its own walk meets it.
"""

import numpy as np
import pytest

from vfmreg_tpu.utils.hdbscan import hdbscan_labels as ref_labels
from vfmreg_tpu_torch.utils import hdbscan as thdb


def _plain(pts, mcs, ms):
    n = pts.shape[0]
    edges = thdb._mst_mutual_reachability(pts, thdb._core_distances(pts, ms))
    return thdb._condense_and_extract(thdb._single_linkage(edges, n), n, mcs)


def _blobs(rng, n_blob=150, n_noise=60):
    centers = np.array([[0, 0, 0], [12, 0, 0], [0, 14, 0], [8, 8, 6]], float)
    return np.concatenate([c + rng.normal(0, 1.0, (n_blob, 3)) for c in centers]
                          + [rng.uniform(-20, 25, (n_noise, 3))])


def _case(name, rng):
    if name == "blobs_25_10":
        return _blobs(rng), 25, 10
    if name == "blobs_100_25":  # the removal's settings
        return _blobs(rng, n_blob=400, n_noise=200), 100, 25
    if name == "duplicates":
        blob = rng.normal(0, 0.5, (80, 3))
        return np.concatenate([blob, blob[:20], rng.normal(8, 0.5, (80, 3))]), 30, 5
    if name == "lattice":
        g = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        return np.concatenate([g, g + [20.0, 0, 0]]), 40, 5
    if name == "single_blob":
        return np.random.RandomState(0).normal(0, 0.5, (200, 3)), 50, 10
    if name == "too_few":
        return rng.normal(size=(99, 3)), 100, 25
    return np.zeros((3, 3)), 100, 25  # "all_equal"


CASES = ["blobs_25_10", "blobs_100_25", "duplicates", "lattice", "single_blob", "too_few", "all_equal"]


def _canon(labels):
    """Labels renumbered by first appearance: equal iff the partitions are."""
    out = np.full_like(labels, -1)
    seen = {}
    for i, v in enumerate(labels):
        if v >= 0:
            out[i] = seen.setdefault(v, len(seen))
    return out


@pytest.mark.parametrize("name", CASES)
def test_labels_equal_reference(name, rng):
    pts, mcs, ms = _case(name, rng)
    got = thdb.hdbscan_labels(pts, min_cluster_size=mcs, min_samples=ms)
    want = ref_labels(pts, min_cluster_size=mcs, min_samples=ms)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    n_clusters = {"blobs_25_10": 4, "blobs_100_25": 4, "duplicates": 2, "lattice": 2}.get(name, 0)
    assert got.max() + 1 == n_clusters, got.max()
    # Label values follow the condensed tree's walk, not the points' order:
    # numbering by first appearance would give other values here.
    if n_clusters:
        assert not np.array_equal(got, _canon(got))


@pytest.mark.parametrize("name", ["blobs_25_10", "duplicates", "lattice", "single_blob"])
def test_native_equals_plain(name, rng):
    """The same partition; the numbering may differ, since the two MSTs may
    take other edges among equal weights and the condensed walk then meets
    the clusters in another order. That is why the port builds the
    reference's native MST rather than taking the plain path."""
    pts, mcs, ms = _case(name, rng)
    native = thdb.hdbscan_labels(pts, min_cluster_size=mcs, min_samples=ms)
    np.testing.assert_array_equal(_canon(native), _canon(_plain(pts, mcs, ms)))
