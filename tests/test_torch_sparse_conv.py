"""Parity of the port's gather-based sparse convolution with `vfmreg_tpu.ops.sparse_conv`.

The same seeded numpy inputs go through both packages on the CPU:

* `lookup_rows`: the same rows and found flags, with absent, masked,
  negative and duplicated coordinates (of duplicates both find the lowest
  row), and a neighbour past the 21-bit range reads as absent in the port;
* `kernel_offsets`: equal for every size and order;
* `sparse_conv_apply` (one lookup per offset) and `sparse_conv_apply_map`
  on a `kernel_map`: within 1e-5 of the reference for a stride-1, a
  stride-2 and a transposed (negated) offset set, and equal to each other;
* `downsample_coords`: the same coordinates in the same order and the same
  mask count, negative coordinates included (floor division);
* the reference's own cases (`tests/test_sparse_conv.py`): the identity
  kernel, the 27-neighbour count, the downsample example, and two distinct
  coordinates that collide on the reference's 32-bit hash, each finding
  its own row and both surviving the downsample.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import sparse_conv as jsc  # noqa: E402
from vfmreg_tpu.ops.voxel import voxel_hash  # noqa: E402
from vfmreg_tpu_torch.ops import sparse_conv as tsc  # noqa: E402

CONV_ATOL = 1e-5  # f32 matmuls summed in the same offset order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both_lookups(coords, mask):
    return jsc.build_coord_lookup(jnp.asarray(coords), jnp.asarray(mask)), tsc.build_coord_lookup(_t(coords), _t(mask))


def test_lookup_rows_match_reference():
    rng = np.random.RandomState(0)
    coords = rng.randint(-7, 7, (400, 3)).astype(np.int32)  # duplicates and negatives
    mask = rng.rand(400) > 0.2
    jl, tl = _both_lookups(coords, mask)
    queries = np.concatenate([coords, rng.randint(-9, 9, (600, 3)).astype(np.int32)])
    valid = rng.rand(queries.shape[0]) > 0.1
    jr, jf = jsc.lookup_rows(jl, jnp.asarray(queries), jnp.asarray(valid))
    tr, tf = tsc.lookup_rows(tl, _t(queries), _t(valid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 0 < int(tf.sum()) < queries.shape[0]
    # Duplicates find their lowest valid row.
    hit = tf.numpy()
    rows = tr.numpy()
    for q, r in zip(queries[hit], rows[hit]):
        same = np.flatnonzero((coords == q).all(1) & mask)
        assert r == same[0]
    # Past the 21-bit range: absent, never an aliased row.
    far = np.array([[(1 << 20) + c[0], c[1], c[2]] for c in coords[:5]], np.int32)
    _, ff = tsc.lookup_rows(tl, _t(far), torch.ones(5, dtype=torch.bool))
    assert not bool(ff.any())


@pytest.mark.parametrize("order", ["last_fastest", "first_fastest"])
def test_kernel_offsets_match_reference(order):
    for k in (1, 3, 5, 7):
        for s in (1, 2, 4, 8):
            np.testing.assert_array_equal(tsc.kernel_offsets(k, s, order), jsc.kernel_offsets(k, s, order))
    assert tuple(tsc.kernel_offsets(3, 1)[13]) == (0, 0, 0)
    assert tuple(tsc.kernel_offsets(3, 1)[1]) == (-1, -1, 0)  # the last axis fastest


@pytest.mark.parametrize("kind", ["stride1", "stride2", "transposed"])
def test_sparse_conv_apply_matches_reference(kind):
    rng = np.random.RandomState({"stride1": 1, "stride2": 2, "transposed": 3}[kind])
    n_in, n_out, c_in, c_out = 500, 400, 16, 8
    coords = rng.randint(-10, 10, (n_in, 3)).astype(np.int32)
    in_mask = rng.rand(n_in) > 0.15
    if kind == "stride1":
        offs, out_coords = jsc.kernel_offsets(3, 1), coords[:n_out]
    elif kind == "stride2":
        offs, out_coords = jsc.kernel_offsets(3, 2), 2 * rng.randint(-5, 5, (n_out, 3)).astype(np.int32)
    else:
        offs, out_coords = -jsc.kernel_offsets(3, 2), rng.randint(-10, 10, (n_out, 3)).astype(np.int32)
    out_mask = rng.rand(n_out) > 0.1
    feats = rng.normal(size=(n_in, c_in)).astype(np.float32)
    W = rng.normal(size=(27, c_in, c_out)).astype(np.float32)
    jl, tl = _both_lookups(coords, in_mask)
    want = np.asarray(jsc.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(coords), jl, jnp.asarray(in_mask),
                                            jnp.asarray(out_coords), jnp.asarray(out_mask), jnp.asarray(W),
                                            jnp.asarray(offs)))
    got = tsc.sparse_conv_apply(_t(feats), _t(coords), tl, _t(in_mask), _t(out_coords), _t(out_mask), _t(W), offs)
    err = float(np.abs(got.numpy() - want).max())
    print(f"{kind}: max abs error {err:.3g}")
    assert err <= CONV_ATOL
    rows = tsc.kernel_map(tl, _t(in_mask), _t(out_coords), _t(out_mask), offs)
    assert rows.shape == (27, n_out)
    np.testing.assert_array_equal(tsc.sparse_conv_apply_map(_t(feats), rows, _t(out_mask), _t(W)).numpy(),
                                  got.numpy())
    assert (got.numpy()[~out_mask] == 0).all() and np.abs(want).max() > 1.0


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_downsample_coords_matches_reference(stride):
    rng = np.random.RandomState(stride)
    coords = (stride * rng.randint(-12, 12, (700, 3))).astype(np.int32)
    mask = rng.rand(700) > 0.2
    jc, jm = jsc.downsample_coords(jnp.asarray(coords), jnp.asarray(mask), stride)
    tc, tm = tsc.downsample_coords(_t(coords), _t(mask), stride)
    k = int(np.asarray(jm).sum())
    assert int(tm.sum()) == k and bool(tm[:k].all())
    np.testing.assert_array_equal(tc[:k].numpy(), np.asarray(jc)[:k])
    floored = np.floor_divide(coords[mask], 2 * stride) * 2 * stride
    assert {tuple(r) for r in tc[:k].tolist()} == {tuple(r) for r in floored.tolist()}
    assert (tc[:k].numpy() < 0).any()


def test_identity_kernel_and_neighbour_sum():
    rng = np.random.RandomState(42)
    coords = np.unique(rng.randint(-20, 20, (100, 3)), axis=0).astype(np.int32)
    mask = np.ones(coords.shape[0], bool)
    feats = rng.normal(size=(coords.shape[0], 8)).astype(np.float32)
    lk = tsc.build_coord_lookup(_t(coords), _t(mask))
    W = np.zeros((27, 8, 8), np.float32)
    W[13] = np.eye(8)  # the centre offset (0, 0, 0)
    out = tsc.sparse_conv_apply(_t(feats), _t(coords), lk, _t(mask), _t(coords), _t(mask), _t(W),
                                tsc.kernel_offsets(3, 1))
    np.testing.assert_allclose(out.numpy(), feats, atol=1e-6)

    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    m = np.ones(64, bool)
    lk = tsc.build_coord_lookup(_t(g), _t(m))
    out = tsc.sparse_conv_apply(torch.ones(64, 1), _t(g), lk, _t(m), _t(g), _t(m), torch.ones(27, 1, 1),
                                tsc.kernel_offsets(3, 1))[:, 0].numpy()
    assert out[np.flatnonzero((g == 1).all(1))[0]] == 27.0  # interior voxel
    assert out[np.flatnonzero((g == 0).all(1))[0]] == 8.0  # corner


def test_downsample_example():
    coords = np.array([[0, 0, 0], [1, 1, 1], [2, 0, 0], [3, 1, 0], [5, 5, 5]], np.int32)
    out, m = tsc.downsample_coords(_t(coords), torch.ones(5, dtype=torch.bool), 1)
    assert {tuple(c) for c in out[m].tolist()} == {(0, 0, 0), (2, 0, 0), (4, 4, 4)}


def _hash_collision():
    """Two distinct coordinates with the same 32-bit hash of the reference
    (a birthday search, as `tests/test_sparse_conv.py`)."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        coords = rng.randint(-500, 500, size=(200_000, 3)).astype(np.int32)
        h = np.asarray(voxel_hash(jnp.asarray(coords)))
        vals, counts = np.unique(h, return_counts=True)
        for dh in vals[counts > 1][:50]:
            rows = np.flatnonzero(h == dh)
            for a in rows:
                for b in rows:
                    if a < b and np.any(coords[a] != coords[b]):
                        return coords[a], coords[b]
    return None


def test_hash_collision_pair_keeps_its_rows():
    pair = _hash_collision()
    assert pair is not None
    ca, cb = pair
    filler = np.arange(12, dtype=np.int32)[:, None] * 3 + np.array([[7, 11, 13]], np.int32)
    coords = np.vstack([filler, ca[None], cb[None]])
    mask = np.ones(coords.shape[0], bool)
    jl, tl = _both_lookups(coords, mask)
    tr, tf = tsc.lookup_rows(tl, _t(coords), _t(mask))
    jr, jf = jsc.lookup_rows(jl, jnp.asarray(coords), jnp.asarray(mask))
    assert bool(tf.all()) and bool(np.asarray(jf).all())
    np.testing.assert_array_equal(tr.numpy(), np.arange(coords.shape[0]))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    c2 = np.vstack([ca[None] * 2, cb[None] * 2, ca[None] * 2])  # the third a duplicate of the first
    out, m = tsc.downsample_coords(_t(c2), torch.ones(3, dtype=torch.bool), 1)
    assert {tuple(r) for r in out[m].tolist()} == {tuple((ca * 2).tolist()), tuple((cb * 2).tolist())}
