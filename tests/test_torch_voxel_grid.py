"""Parity of the port's voxel ops and hash grid with `vfmreg_tpu` (exact).

Seeded inputs go through both packages on the CPU: the voxel hash bit for bit
(negative coordinates included, which exercises the reference's
two's-complement uint32 view), the first-point-wins downsample, the grid
arrays, the 27-voxel candidate slabs and the champion cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.ops import voxel as jvox  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402
from vfmreg_tpu_torch.ops import voxel as tvox  # noqa: E402


def _cloud(seed, n, extent, dup=0.3):
    """Uniform points plus near-duplicates, so voxels hold several points."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    k = int(n * dup)
    pts[-k:] = pts[:k] + rng.normal(0, 0.05, (k, 3)).astype(np.float32)
    return pts, rng.rand(n) > 0.1


_jax_build = jax.jit(jhg.build_hash_grid, static_argnames=("voxel_size", "max_points_per_voxel"))


def _grid_pair(pts, mask, voxel, cap, feats=None):
    jg = _jax_build(
        jnp.asarray(pts), voxel, mask=jnp.asarray(mask),
        feats=None if feats is None else jnp.asarray(feats), max_points_per_voxel=cap,
    )
    tg = thg.build_hash_grid(
        torch.from_numpy(pts), voxel, mask=torch.from_numpy(mask),
        feats=None if feats is None else torch.from_numpy(feats), max_points_per_voxel=cap,
    )
    return jg, tg


def test_voxel_hash_bit_exact():
    rng = np.random.RandomState(0)
    coords = rng.randint(-(2**20), 2**20, (20000, 3)).astype(np.int32)
    coords[:8] = [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -(2**31), 0], [-(2**31), 5, -7],
                  [1, 0, 0], [0, 1, 0], [0, 0, 1], [123, -456, 789]]
    a = np.asarray(jvox.voxel_hash(jnp.asarray(coords))).astype(np.int64)
    b = tvox.voxel_hash(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        tvox.int32_view(torch.from_numpy(b)).numpy(), a.astype(np.uint32).view(np.int32)
    )


@pytest.mark.parametrize("voxel", [0.5, 5.0])
def test_voxel_down_sample_selects_same_rows(voxel):
    pts, mask = _cloud(1, 3000, 20.0)
    feats = np.random.RandomState(2).normal(size=(3000, 8)).astype(np.float32)
    ja = jax.jit(jvox.voxel_down_sample_masked, static_argnums=1)(
        jnp.asarray(pts), voxel, jnp.asarray(mask), jnp.asarray(feats)
    )
    tb = tvox.voxel_down_sample_masked(torch.from_numpy(pts), voxel, torch.from_numpy(mask),
                                       torch.from_numpy(feats))
    for a, b in zip(ja, tb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("cap", [20, 40])
def test_build_hash_grid_identical(cap):
    pts, mask = _cloud(3, 4000, 6.0)
    feats = np.random.RandomState(4).normal(size=(4000, 16)).astype(np.float32)
    jg, tg = _grid_pair(pts, mask, 1.0, cap, feats)
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(tg.points.numpy(), np.asarray(jg.points))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    np.testing.assert_array_equal(tg.feats.numpy(), np.asarray(jg.feats))
    # The last slab row only absorbs the writes of unstored rows (several
    # land there, in no fixed order on CUDA); nothing reads it.
    np.testing.assert_array_equal(tg.bucket_slab.numpy()[:-1], np.asarray(jg.bucket_slab)[:-1])
    assert tg.bucket_slab.shape == jg.bucket_slab.shape


@pytest.mark.parametrize("cap", [20, 40])
def test_candidates_and_champions_identical(cap):
    pts, mask = _cloud(5, 4000, 6.0)
    jg, tg = _grid_pair(pts, mask, 1.0, cap)
    rng = np.random.RandomState(6)
    q = np.concatenate([
        pts[rng.choice(4000, 400)] + rng.normal(0, 0.3, (400, 3)).astype(np.float32),
        rng.uniform(-12, 12, (100, 3)).astype(np.float32),  # many empty neighbourhoods
    ])
    qmask = rng.rand(500) > 0.1
    jc = jax.jit(jhg.gather_candidate_slabs)(jg, jnp.asarray(q), jnp.asarray(qmask))
    tc = thg.gather_candidate_slabs(tg, torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_array_equal(tc.slabs.numpy(), np.asarray(jc.slabs))

    jcache = jax.jit(jhg.build_nn_cache)(jc, jnp.asarray(q), jnp.asarray(qmask))
    tcache = thg.build_nn_cache(tc, torch.from_numpy(q), torch.from_numpy(qmask))
    for f in ("cx", "cy", "cz", "rows"):
        np.testing.assert_array_equal(getattr(tcache, f).numpy(), np.asarray(getattr(jcache, f)))

    jn = jhg.nn_from_cache(jcache, jg.points, jnp.asarray(q), jnp.asarray(qmask), use_pallas=False)
    tn = thg.nn_from_cache(tcache, torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))  # neighbour
    np.testing.assert_array_equal(tn[2].numpy(), np.asarray(jn[2]))  # found
    # dist = sqrt(d2) of equal d2: PyTorch's vectorized CPU sqrt is not
    # correctly rounded for ~0.6% of f32 inputs, so allow one ulp.
    np.testing.assert_allclose(tn[1].numpy(), np.asarray(jn[1]), rtol=2.0**-23, atol=0)
