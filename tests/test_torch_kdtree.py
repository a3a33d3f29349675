"""The port's native KD-tree (`vfmreg_tpu_torch/native/kdtree.{cpp,py}`) and
`utils.pcl.KNeighbors` against the reference's (`vfmreg_tpu/native/kdtree.py`,
`vfmreg_tpu/utils/pcl.py`) on the same host.

The two libraries are built from the same source with the same flags, so
everything is compared bit for bit: kNN indices and squared distances (tie
order included: duplicates, k > n), the Boruvka MST edges, the single
linkage, and `KNeighbors.query` / `n_neighbors_in_radius`. The native
results are also held against the plain versions: `_brute_knn`, the dense
Prim MST (equal weight; its edge set may differ among ties) and the Python
union-find. The build goes to the port's `_build/`, keyed by a hash, and a
failing build raises with g++'s output.
"""

import numpy as np
import pytest

from vfmreg_tpu.native import kdtree as jkd
from vfmreg_tpu.utils import hdbscan as jhdb
from vfmreg_tpu.utils import pcl as jpcl
from vfmreg_tpu_torch.native import kdtree as tkd
from vfmreg_tpu_torch.ops._build import BUILD_DIR
from vfmreg_tpu_torch.utils import hdbscan as thdb
from vfmreg_tpu_torch.utils import pcl as tpcl


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference's library is its only path under comparison here."""
    assert jkd.native_kdtree_available(), "the reference's native KD-tree did not build"


def _cloud(kind, rng):
    if kind == "random":
        return rng.normal(size=(3000, 3)), rng.normal(size=(500, 3))
    if kind == "duplicates":
        pts = np.repeat(rng.normal(size=(40, 3)), 4, axis=0)
        return pts, pts
    if kind == "lattice":  # many exact distance ties
        g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        return g, g[::7] + 0.5
    return rng.normal(size=(5, 3)), rng.normal(size=(9, 3))  # "k_exceeds_n"


@pytest.mark.parametrize("kind,k", [("random", 9), ("duplicates", 4), ("lattice", 7), ("k_exceeds_n", 8)])
def test_knn_matches_reference(kind, k, rng):
    pts, q = _cloud(kind, rng)
    idx, d2 = tkd.NativeKDTree(pts).knn(q, k)
    ref_idx, ref_d2 = jkd.NativeKDTree(pts).knn(q, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(d2, ref_d2)
    if kind == "k_exceeds_n":
        assert np.all(idx[:, 5:] == -1) and np.all(np.isinf(d2[:, 5:]))
    if kind == "random":  # no ties: the plain version's order
        b_idx, b_d2 = tpcl._brute_knn(pts, q, k)
        np.testing.assert_array_equal(idx, b_idx)
        np.testing.assert_allclose(d2, b_d2, rtol=0, atol=1e-12)


def test_knn_rejects_bad_arguments(rng):
    tree = tkd.NativeKDTree(rng.normal(size=(10, 3)))
    for k in (0, -3):
        with pytest.raises(ValueError, match="k >= 1"):
            tree.knn(np.zeros((2, 3)), k)
    with pytest.raises(ValueError, match="columns"):
        tree.knn(np.zeros((2, 2)), 1)


@pytest.mark.parametrize("kind", ["random", "duplicates", "lattice"])
def test_mst_matches_reference(kind, rng):
    pts = _cloud(kind, rng)[0][:600]
    k = 5
    tree = tkd.NativeKDTree(pts)
    core = np.sqrt(tree.knn(pts, k)[1][:, k - 1])
    edges = tree.mst_mutual_reachability(core)
    assert edges.shape == (pts.shape[0] - 1, 3)
    np.testing.assert_array_equal(edges, jkd.NativeKDTree(pts).mst_mutual_reachability(core))
    np.testing.assert_array_equal(edges, thdb._mst_native(pts, k))
    # The plain version: dense Prim has the same (unique) total weight.
    dense = thdb._mst_mutual_reachability(pts, thdb._core_distances(pts, k))
    np.testing.assert_allclose(edges[:, 2].sum(), dense[:, 2].sum(), rtol=1e-12)
    np.testing.assert_array_equal(dense, jhdb._mst_mutual_reachability(pts, jhdb._core_distances(pts, k)))


def test_single_linkage_matches_reference(rng):
    n = 500
    perm = rng.permutation(n)
    b = np.array([perm[rng.randint(0, i)] for i in range(1, n)])
    w = np.round(rng.uniform(0, 1, n - 1), 2)  # many exact ties: the stable sort decides
    edges = np.column_stack([perm[1:].astype(np.float64), b.astype(np.float64), w])
    got = tkd.single_linkage_native(edges, n)
    np.testing.assert_array_equal(got, jkd.single_linkage_native(edges, n))
    np.testing.assert_array_equal(got, thdb._single_linkage(edges, n))
    assert tkd.single_linkage_native(np.empty((0, 3)), 1).shape == (0, 4)
    for fn in (tkd.single_linkage_native, thdb._single_linkage):
        with pytest.raises(ValueError, match="complete MST"):
            fn(edges[:-1], n)


@pytest.mark.parametrize("k,r", [(12, 0.8), (50, 0.5), (10, 0.5)])
def test_kneighbors_matches_reference(k, r, rng):
    """faiss IndexFlatL2 semantics, as the reference: float32 data, squared
    distances, zero-distance hits dropped, `query` strict and
    `n_neighbors_in_radius` inclusive."""
    data = rng.uniform(-3, 3, size=(800, 3))
    data[700:] = data[:100]  # duplicates: zero-distance hits
    payload = rng.permutation(10_000)[:800]
    queries = data[rng.permutation(800)[:300]] + rng.normal(0, 0.01, (300, 3))
    got = tpcl.KNeighbors().fit(data, payload)
    ref = jpcl.KNeighbors().fit(data, payload)
    np.testing.assert_array_equal(got.query(queries, k, r), ref.query(queries, k, r))
    np.testing.assert_array_equal(got.n_neighbors_in_radius(queries, k, r), ref.n_neighbors_in_radius(queries, k, r))
    # The plain version (k-NN by brute force on the float32 copies), without
    # the duplicates: which of two tied rows the k-th place takes is the
    # tree's own order.
    got = tpcl.KNeighbors().fit(data[:700], payload[:700])
    b_idx, b_d2 = tpcl._brute_knn(got._data, np.float32(queries).astype(np.float64), k)
    keep = (b_d2 > 0) & (b_d2 < r)
    np.testing.assert_array_equal(got.query(queries, k, r), np.unique(payload[b_idx[keep]]))
    np.testing.assert_array_equal(got.n_neighbors_in_radius(queries, k, r), np.sum((b_d2 > 0) & (b_d2 <= r), 1))


def test_kneighbors_on_an_empty_fit_raises_as_the_reference(rng):
    """An empty selection has no neighbour to ask for: both raise."""
    for mod in (tpcl, jpcl):
        kn = mod.KNeighbors().fit(np.zeros((0, 3)), np.zeros(0, dtype=np.int64))
        with pytest.raises(ValueError, match="k >= 1"):
            kn.n_neighbors_in_radius(np.zeros((0, 3)), 10, 0.5)


def test_build_lands_in_the_port_and_raises_on_failure(tmp_path, monkeypatch):
    lib = tkd.library()
    path = tkd._target(tkd._gxx())
    assert path.parent == BUILD_DIR and path.name.startswith("libkdtree_") and path.exists()
    assert lib._name == str(path)
    broken = tmp_path / "kdtree.cpp"
    broken.write_text('extern "C" void kd_build( { }\n')
    monkeypatch.setattr(tkd, "SOURCE", broken)
    monkeypatch.setattr(tkd, "_lib", None)
    monkeypatch.setattr(tkd, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g.. failed on kdtree.cpp") as err:
        tkd.library()
    assert "error" in str(err.value)
    # A missing compiler raises too.
    monkeypatch.setattr(tkd.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tkd.library()
