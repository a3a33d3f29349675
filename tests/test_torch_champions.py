"""Parity of the port's "planes" champion rebuild (kernel B3) with `vfmreg_tpu`.

* `Candidates.planes` of the port's own grid and gather equals the
  reference's, array for array;
* `champions_from_planes_plain` (what the port's wrapper runs for CPU
  tensors) is bit-identical to the Pallas `champions_from_planes` in
  interpret mode and to the reference's `build_nn_cache` planes, on one slab
  gather with duplicated points (ties), empty neighbourhoods, masked queries
  and one NaN query coordinate (a dead row: the reference's min propagates
  NaN).

Tolerance: none, every comparison is exact; -0.0 and +0.0 compare equal
(the Pallas body selects by a one-hot sum, which turns -0.0 into +0.0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import champion_kernel as jck  # noqa: E402
from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu_torch.ops import champion_kernel as tck  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402

_jax_build = jax.jit(jhg.build_hash_grid, static_argnames=("voxel_size", "max_points_per_voxel"))


def _case(seed, cap, m=4096, n=512):
    """The reference test's fixture (`tests/test_hash_grid.py:236-263`),
    seeded: duplicated points for ties, far queries with empty
    neighbourhoods, the last 8 queries masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    pts[100:140] = pts[60:100]
    # A dense clump, so some voxels hold more points than the cap.
    pts[200:260] = pts[199] + rng.uniform(0, 0.2, (60, 3)).astype(np.float32)
    q = np.concatenate([
        pts[rng.choice(m, n - 64)] + rng.normal(0, 0.3, (n - 64, 3)).astype(np.float32),
        rng.uniform(200, 300, (64, 3)).astype(np.float32),
    ]).astype(np.float32)
    qm = np.ones(n, bool)
    qm[-8:] = False
    mask = np.ones(m, bool)
    jgrid = _jax_build(jnp.asarray(pts), 1.0, mask=jnp.asarray(mask), max_points_per_voxel=cap)
    tgrid = thg.build_hash_grid(torch.from_numpy(pts), 1.0, mask=torch.from_numpy(mask),
                                max_points_per_voxel=cap)
    return jgrid, tgrid, q, qm


def _group(cap, slabs):
    return min(-(-cap // 8) * 8, 32 * slabs.shape[2])


@pytest.mark.parametrize("cap", [20, 40])
def test_candidates_planes_match_jax(cap):
    jgrid, tgrid, q, qm = _case(0, cap)
    jc = jhg.gather_candidate_slabs(jgrid, jnp.asarray(q), jnp.asarray(qm))
    tc = thg.gather_candidate_slabs(tgrid, torch.from_numpy(q), torch.from_numpy(qm))
    group = _group(cap, tc.slabs)
    assert group == _group(cap, jc.slabs) and group == (24 if cap == 20 else 40)
    for a, b in zip(tc.planes(group), jc.planes(group)):
        assert tuple(a.shape) == (27 * group, q.shape[0]) and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,cap", [(0, 20), (1, 20), (2, 40)])
def test_champions_plain_bit_identical_to_jax(seed, cap):
    jgrid, _, q, qm = _case(seed, cap)
    cands = jhg.gather_candidate_slabs(jgrid, jnp.asarray(q), jnp.asarray(qm))
    group = _group(cap, cands.slabs)
    planes = [np.array(p) for p in cands.planes(group)]
    qn = q.copy()
    qn[5, 1] = np.nan  # gathered at a finite position, rebuilt at NaN
    ref_pallas = jck.champions_from_planes(
        *(jnp.asarray(p) for p in planes), jnp.asarray(qn), jnp.asarray(qm),
        group=group, block_q=128, interpret=True,
    )
    ref_cache = jhg.build_nn_cache(cands, jnp.asarray(qn), jnp.asarray(qm))
    got = tck.champions_from_planes(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(qn), torch.from_numpy(qm), group
    )
    for g, rp, rc in zip(got, ref_pallas, (ref_cache.cx, ref_cache.cy, ref_cache.cz)):
        assert tuple(g.shape) == (32, q.shape[0])
        np.testing.assert_array_equal(g.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rc))
    cx = got[0].numpy()
    assert np.all(cx[27:] == np.float32(thg.INVALID_COORD))  # sentinel rows
    assert np.all(cx[:, 5] == np.float32(thg.INVALID_COORD))  # the NaN query is dead
    assert np.all(cx[:, -8:] == np.float32(thg.INVALID_COORD))  # masked queries
    alive = (cx[:27] < 1e19).any(axis=0)
    assert alive[:5].all() and alive[6:-64].all() and not alive[-64:].any()


def test_champions_wrapper_checks_inputs():
    planes = [torch.zeros(27 * 24, 16) for _ in range(3)]
    q, qm = torch.zeros(16, 3), torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="groups"):
        tck.champions_from_planes(*planes, q, qm, 25)
    with pytest.raises(TypeError, match="bool"):
        tck.champions_from_planes(*planes, q, qm.to(torch.uint8), 24)
    with pytest.raises(ValueError, match="contiguous"):
        tck.champions_from_planes(*planes, torch.zeros(3, 16).T, qm, 24)
    with pytest.raises(ValueError, match="shape"):
        tck.champions_from_planes(*planes, torch.zeros(15, 3), qm, 24)
