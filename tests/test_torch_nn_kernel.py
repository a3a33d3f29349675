"""Parity of the port's cached nearest neighbour (kernel B4) with `vfmreg_tpu`.

* `nn_argmin_plain` (what the port's wrapper runs for CPU tensors) against
  the Pallas `nn_argmin` in interpret mode, on the champion cache of the
  reference test (`tests/test_hash_grid.py::test_nn_kernel_matches_fallback`:
  900 points in [-10, 10]^3, 1 m voxels, 130 queries), seeded, plus one NaN
  query and one query far from every point (an empty neighbourhood); also
  its first 7 rows and its first 129 queries, the shapes the CUDA kernel
  reads apart (a K other than 32; n not a multiple of 4);
* the port's `hash_grid.nn_from_cache`, which goes through `nn_argmin`,
  against the reference's plain branch (`use_pallas=False`) on the same
  cache, the NaN query included.

Tolerance: k, the neighbour and `found` are exact, and so are the NaN and
+inf positions of d2. Finite d2 against the Pallas kernel allow rtol 1e-6,
the reference test's own bar: XLA's CPU compiler contracts the interpreted
body's dx*dx + dy*dy + dz*dz into FMAs, which round once where the plain
version (and the CUDA kernel, which must equal it bit for bit) rounds at
every step. The distance of `nn_from_cache` allows one ulp, because
PyTorch's vectorised CPU sqrt is not correctly rounded for ~0.6 % of f32
inputs (as `tests/test_torch_voxel_grid.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.ops.nn_kernel import nn_argmin as jax_nn_argmin  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402
from vfmreg_tpu_torch.ops import nn_kernel as tnn  # noqa: E402


def _cache(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, 10, (900, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (130, 3)).astype(np.float32)
    q[7] = [300.0, 300.0, 300.0]  # empty neighbourhood
    grid = jax.jit(jhg.build_hash_grid, static_argnames=("voxel_size",))(jnp.asarray(pts), 1.0)
    cands = jhg.gather_candidate_slabs(grid, jnp.asarray(q))
    cache = jhg.build_nn_cache(cands, jnp.asarray(q))
    q_moved = q + rng.normal(0, 0.2, q.shape).astype(np.float32)  # champion-approximate after motion
    q_moved[3, 2] = np.nan
    return grid, cache, q_moved


def _torch_cache(cache):
    return thg.NNCache(*(torch.from_numpy(np.array(getattr(cache, f))) for f in ("cx", "cy", "cz", "rows")))


@pytest.mark.parametrize("seed, k, n", [
    pytest.param(0, 32, 130, id="0"),
    pytest.param(1, 32, 130, id="1"),
    pytest.param(0, 7, 130, id="k7"),
    pytest.param(1, 32, 129, id="n129"),
])
def test_nn_argmin_plain_matches_pallas(seed, k, n):
    """The full cache, its first 7 rows (the CUDA kernel's generic runtime-K
    form) and its first 129 queries (n not a multiple of 4: the CUDA
    kernel's plain-load form)."""
    _, cache, q = _cache(seed)
    cx, cy, cz = (np.ascontiguousarray(np.asarray(c)[:k, :n]) for c in (cache.cx, cache.cy, cache.cz))
    q = np.ascontiguousarray(q[:n])
    d2_j, k_j = jax_nn_argmin(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cz), jnp.asarray(q), block_q=64,
                              interpret=True)
    d2_t, k_t = tnn.nn_argmin(*(torch.from_numpy(c) for c in (cx, cy, cz, q)))
    assert d2_t.dtype == torch.float32 and k_t.dtype == torch.int32
    d2_t, d2_j = d2_t.numpy(), np.asarray(d2_j)
    fin = np.isfinite(d2_j)
    np.testing.assert_array_equal(np.isfinite(d2_t), fin)
    np.testing.assert_array_equal(d2_t[~fin], d2_j[~fin])  # NaN == NaN here
    np.testing.assert_allclose(d2_t[fin], d2_j[fin], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert np.isnan(d2_t[3]) and int(k_t[3]) == tnn.NO_ROW
    assert np.isinf(d2_t[7]) and int(k_t[7]) == 0
    assert fin.sum() > (100 if k == 32 else 60)  # most queries have a live champion among the first k


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_from_cache_matches_jax(seed):
    grid, cache, q = _cache(seed)
    qmask = np.ones(q.shape[0], bool)
    qmask[-5:] = False
    jn = jhg.nn_from_cache(cache, grid.points, jnp.asarray(q), jnp.asarray(qmask), use_pallas=False)
    tn = thg.nn_from_cache(_torch_cache(cache), torch.from_numpy(q), torch.from_numpy(qmask))
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))  # neighbour
    np.testing.assert_array_equal(tn[2].numpy(), np.asarray(jn[2]))  # found
    np.testing.assert_allclose(tn[1].numpy(), np.asarray(jn[1]), rtol=2.0**-23, atol=0)
    assert not bool(tn[2][3]) and not bool(tn[2][7]) and bool(tn[2].sum() > 100)
    assert torch.equal(tn[0][3], torch.zeros(3))


def test_nn_argmin_wrapper_checks_inputs():
    c = torch.zeros((32, 4))
    with pytest.raises(ValueError):
        tnn.nn_argmin(c, c, c, torch.zeros((5, 3)))
    with pytest.raises(TypeError):
        tnn.nn_argmin(c.double(), c, c, torch.zeros((4, 3)))
