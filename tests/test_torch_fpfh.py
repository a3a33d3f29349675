"""Parity of the port's FPFH, radius k-NN and descriptor matching with `vfmreg_tpu`.

The same seeded numpy inputs go through the JAX functions and the port's
(`vfmreg_tpu_torch.ops.knn`, `ops.matching.mutual_nn_correspondences`,
`descriptors.fpfh`) on the CPU:

* `radius_knn` on a cloud with duplicate points and an isolated point:
  neighbour masks and indices equal (ties at duplicates go to the lower
  candidate position in both), distances within 1e-6 m;
* `mutual_nn_correspondences` in both modes, with padding rows on both
  sides and duplicate descriptors: equal pairs and masks, distances
  within 1e-4 (the -2ab expansion rounds at the squared norms, ~33);
* the histogram's bins for values on every bin edge: equal to the
  reference's `_histogram` (the same f32 arithmetic);
* normals: within 1e-5 wherever the neighbourhood is well conditioned
  (the two smallest covariance eigenvalues apart by 1 % of the largest,
  and the normal off the xy plane, whose sign rule reads its z);
  elsewhere any eigenvector of the degenerate eigenspace is right, and
  LAPACK builds differ;
* FPFH fed the reference's normals: every row within cosine 0.9995 and at
  least 95 % of them within 1e-3 (the pair angles differ by a few ulps, as
  XLA contracts multiply-adds, and a pair near a bin edge may move by one
  bin, in its own SPFH and in its neighbours' FPFH);
* `extract_fpfh_features` with and without `normalize` on the test's
  structured cloud: the points equal; at least 99 % of the rows within
  cosine 0.99 and the median within 1e-7 of 1 (the normals above; the
  port's are Jacobi's, `geometry/linalg3`, within ~1e-6 of LAPACK's);
* FPFH + mutual NN + RANSAC recovers a transform
  (`tests/test_fpfh.py::test_fpfh_registration_end_to_end`'s case and bar).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation as R  # noqa: E402

from vfmreg_tpu.descriptors import fpfh as jfpfh  # noqa: E402
from vfmreg_tpu.ops.hash_grid import build_hash_grid as jbuild  # noqa: E402
from vfmreg_tpu.ops.knn import radius_knn as jknn  # noqa: E402
from vfmreg_tpu.ops.matching import mutual_nn_correspondences as jmnn  # noqa: E402
from vfmreg_tpu.ops.voxel import voxel_down_sample_masked as jvoxel  # noqa: E402
from vfmreg_tpu_torch.descriptors import fpfh as tfpfh  # noqa: E402
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid as tbuild  # noqa: E402
from vfmreg_tpu_torch.ops.knn import radius_knn as tknn  # noqa: E402
from vfmreg_tpu_torch.ops.matching import mutual_nn_correspondences as tmnn  # noqa: E402
from vfmreg_tpu_torch.registration.ransac import ransac_registration  # noqa: E402


def make_structured_cloud(rng, n=1200):
    """`tests/test_fpfh.py:9`: a box corner, a floor, a wall and a sphere."""
    m = n // 3
    floor = np.c_[rng.uniform(0, 4, (m, 2)), np.zeros((m, 1))]
    wall_a = np.c_[rng.uniform(0, 4, (m, 1)), np.zeros((m, 1)), rng.uniform(0, 4, (m, 1))]
    sphere = rng.normal(size=(m, 3))
    sphere = sphere / np.linalg.norm(sphere, axis=1, keepdims=True) + [2, 2, 1]
    pts = np.concatenate([floor, wall_a, sphere]).astype(np.float32)
    return pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)


def _padded(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    return out, np.arange(n) < len(pts)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_radius_knn_matches_reference(exclude_self):
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 3, (700, 3)).astype(np.float32)
    # Duplicates (ties broken by candidate position) and one isolated point
    # (an empty neighbourhood once itself is excluded).
    pts = np.concatenate([pts, pts[:40], pts[:10], [[40.0, 40.0, 40.0]]]).astype(np.float32)
    P, M = _padded(pts, 1024)
    g = jbuild(jnp.asarray(P), 0.5, mask=jnp.asarray(M), max_points_per_voxel=48)
    want = jknn(g, jnp.asarray(P), jnp.asarray(M), k=16, radius=0.5, exclude_self=exclude_self)
    tg = tbuild(torch.from_numpy(P), 0.5, mask=torch.from_numpy(M), max_points_per_voxel=48)
    got = tknn(tg, torch.from_numpy(P), torch.from_numpy(M), k=16, radius=0.5, exclude_self=exclude_self)
    jm = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), jm)
    np.testing.assert_array_equal(got.idx.numpy()[jm], np.asarray(want.idx)[jm])
    np.testing.assert_allclose(got.dist.numpy()[jm], np.asarray(want.dist)[jm], atol=1e-6)
    assert jm[len(pts) - 1].sum() == (0 if exclude_self else 1)
    assert (jm.sum(1) == 16).any()  # some neighbourhoods are cut at k


@pytest.mark.parametrize("mutual", [True, False])
def test_mutual_nn_matches_reference(mutual):
    rng = np.random.RandomState(1)
    f0 = rng.normal(size=(300, 33)).astype(np.float32)
    f1 = np.concatenate([f0[:200] + rng.normal(0, 0.05, (200, 33)), rng.normal(size=(250, 33))]).astype(np.float32)
    f1[-5:] = f1[:5]  # duplicate rows: the lower index wins in both directions
    F0, F1 = np.zeros((512, 33), np.float32), np.zeros((512, 33), np.float32)
    F0[:300], F1[:450] = f0, f1
    m0, m1 = np.arange(512) < 300, np.arange(512) < 450
    want = jmnn(jnp.asarray(F0), jnp.asarray(m0), jnp.asarray(F1), jnp.asarray(m1), mutual_filter=mutual,
                n_points=120, chunk=128)
    got = tmnn(torch.from_numpy(F0), torch.from_numpy(m0), torch.from_numpy(F1), torch.from_numpy(m1),
               mutual_filter=mutual, n_points=120, chunk=128)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.idx1.numpy()[:300], np.asarray(want.idx1)[:300])
    # The -2ab expansion rounds at the squared norms (~33), so the distances
    # agree to 1e-4.
    np.testing.assert_allclose(got.dist.numpy()[:300], np.asarray(want.dist)[:300], atol=1e-4)
    assert got.mask.sum() == (int(np.asarray(want.mask).sum()) if mutual else 120)


def test_histogram_bins_on_edges():
    """Values on every bin edge (and the ends) land in the reference's bins."""
    for lo, hi in ((-1.0, 1.0), (-math.pi, math.pi)):
        edges = np.float32(lo) + np.arange(12, dtype=np.float32) * np.float32((hi - lo) / 11)
        f = np.concatenate([edges, np.nextafter(edges, np.float32(-10)), np.nextafter(edges, np.float32(10))])
        f = f.astype(np.float32)[None, :]
        w = np.ones_like(f)
        want = np.asarray(jax.jit(jfpfh._histogram, static_argnums=(1, 2))(jnp.asarray(f), lo, hi, jnp.asarray(w)))
        got = tfpfh._histogram(torch.from_numpy(f), lo, hi, torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cloud():
    return make_structured_cloud(np.random.RandomState(42), 3000)


def test_normals_match_reference(cloud):
    P, M = _padded(cloud, 4096)
    want = np.asarray(jfpfh.estimate_normals(jnp.asarray(P), jnp.asarray(M), 0.2, 30))
    got = tfpfh.estimate_normals(torch.from_numpy(P), torch.from_numpy(M), 0.2, 30).numpy()
    # The well-conditioned neighbourhoods, from the reference's own k-NN.
    g = jbuild(jnp.asarray(P), 0.2, mask=jnp.asarray(M), max_points_per_voxel=38)
    knn = jknn(g, jnp.asarray(P), jnp.asarray(M), k=30, radius=0.2)
    w = np.asarray(knn.mask).astype(np.float64)
    nbr = np.asarray(g.points)[np.asarray(knn.idx)].astype(np.float64)
    cnt = np.maximum(w.sum(1, keepdims=True), 1)
    diff = (nbr - (nbr * w[..., None]).sum(1)[:, None] / cnt[..., None]) * w[..., None]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", diff, diff) / cnt[..., None])
    good = M & (ev[:, 1] - ev[:, 0] > 1e-2 * ev[:, 2]) & (np.abs(want[:, 2]) > 1e-3)
    assert good.sum() > 0.8 * M.sum()
    np.testing.assert_allclose(got[good], want[good], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[M], axis=1), 1.0, atol=1e-5)


def test_fpfh_with_reference_normals(cloud):
    P, M = _padded(cloud, 4096)
    normals = jfpfh.estimate_normals(jnp.asarray(P), jnp.asarray(M), 0.2, 30)
    dp, dn, dm = (np.asarray(a) for a in jvoxel(jnp.asarray(P), 0.1, mask=jnp.asarray(M), feats=normals))
    want = np.asarray(jfpfh._fpfh_on_cloud(jnp.asarray(dp), jnp.asarray(dn), jnp.asarray(dm), 0.5, 100))[dm]
    got = tfpfh.fpfh_on_cloud(torch.from_numpy(dp), torch.from_numpy(dn.copy()), torch.from_numpy(dm), 0.5,
                              100).numpy()[dm]
    # A pair on a bin edge moves one bin in its own SPFH and, weighted, in
    # the FPFH of each neighbour: every row within cosine 0.9995, most
    # within 1e-3.
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.9995, cos.min()
    assert (np.abs(got - want).max(axis=1) < 1e-3).mean() >= 0.95
    np.testing.assert_allclose(got.reshape(-1, 3, 11).sum(-1), want.reshape(-1, 3, 11).sum(-1), atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_extract_fpfh_features_matches_reference(cloud, normalize):
    want_pts, want = jfpfh.extract_fpfh_features(cloud, 0.1, normalize=normalize)
    got_pts, got = tfpfh.extract_fpfh_features(cloud, 0.1, normalize=normalize, device="cpu")
    np.testing.assert_array_equal(got_pts, want_pts)
    assert got.shape == want.shape == (want_pts.shape[0], 33)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert (cos > 0.99).mean() >= 0.99, (cos > 0.99).mean()
    assert np.median(cos) > 1 - 1e-7, np.median(cos)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_fpfh_registration_end_to_end():
    """FPFH + mutual NN + RANSAC on the structured corner recovers the
    transform within the reference test's 0.7 m."""
    pts = make_structured_cloud(np.random.RandomState(42), n=1500)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.from_euler("z", 30, degrees=True).as_matrix()
    T[:3, 3] = [1.0, -2.0, 0.3]
    scan = (pts - T[:3, 3]) @ T[:3, :3]
    p_map, f_map = tfpfh.extract_fpfh_features(pts, 0.1, device="cpu")
    p_scan, f_scan = tfpfh.extract_fpfh_features(scan, 0.1, device="cpu")

    def pad(x, n=2048):
        out = np.zeros((n, x.shape[1]), np.float32)
        out[: x.shape[0]] = x
        return torch.from_numpy(out), torch.arange(n) < x.shape[0]

    fs, ms = pad(f_scan)
    fm, mm = pad(f_map)
    mnn = tmnn(fs, ms, fm, mm, mutual_filter=True, chunk=512)
    ps, _ = pad(p_scan)
    pm, _ = pad(p_map)
    res = ransac_registration(ps[mnn.idx0], pm[mnn.idx1], mnn.mask, torch.Generator().manual_seed(0),
                              num_hypotheses=2000)
    assert np.linalg.norm(res.pose.numpy()[:3, 3] - T[:3, 3]) < 0.7
