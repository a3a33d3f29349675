"""Parity of the port's descriptor matching with `vfmreg_tpu.ops.matching`.

Kernel B1's plain version (what the port's wrapper runs for CPU tensors) is
held against the Pallas `cosine_argmax` run in interpret mode, as
`tests/test_matching.py` runs it. The tolerance is the one `chip_smoke.py`
holds the CUDA kernel to: similarities within atol 1e-5, indices equal on
every query whose top-2 similarity gap exceeds 1e-5 (below that, f32
summation order may pick either row).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import matching as jm  # noqa: E402
from vfmreg_tpu.ops.cosine_kernel import cosine_argmax as j_cosine_argmax  # noqa: E402
from vfmreg_tpu_torch.ops import matching as tm  # noqa: E402
from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax, cosine_argmax_plain  # noqa: E402

SIM_ATOL = 1e-5
GAP = 1e-5


def _unit(rng, shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _decisive(q, db, mask):
    """Queries whose best and second-best masked similarities differ by > GAP (f64)."""
    sim = np.where(mask[None, :], q.astype(np.float64) @ db.astype(np.float64).T, -np.inf)
    top2 = np.sort(sim, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > GAP


def _assert_b1_agrees(sim, idx, ref_sim, ref_idx, q, db, mask, min_decisive=0.9):
    np.testing.assert_allclose(sim, ref_sim, atol=SIM_ATOL, rtol=0)
    ok = _decisive(q, db, mask)
    assert ok.mean() > min_decisive  # the data leaves most queries decisive
    np.testing.assert_array_equal(idx[ok], ref_idx[ok])


@pytest.mark.parametrize("case", ["partial_mask", "ties", "all_masked"])
def test_cosine_argmax_plain_matches_pallas_interpret(case):
    rng = np.random.RandomState(0)
    q, db = _unit(rng, (100, 32)), _unit(rng, (500, 32))
    mask = np.ones(500, dtype=bool)
    mask[450:] = False
    if case == "ties":
        db[300:320] = db[10:30]  # exact duplicates: the lower row must win
        q[:20] = db[10:30]
    if case == "all_masked":
        mask[:] = False
    ref_sim, ref_idx = j_cosine_argmax(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(mask), block_q=64, block_m=128, interpret=True
    )
    ref_sim, ref_idx = np.asarray(ref_sim), np.asarray(ref_idx)
    sim, idx = cosine_argmax(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(mask))
    assert sim.dtype == torch.float32 and idx.dtype == torch.int32
    sim, idx = sim.numpy(), idx.numpy()
    if case == "all_masked":
        np.testing.assert_array_equal(sim, ref_sim)  # -1e30 everywhere
        np.testing.assert_array_equal(idx, ref_idx)  # 0 everywhere
        return
    # Exact duplicates make every query that picks one of them a tie.
    _assert_b1_agrees(sim, idx, ref_sim, ref_idx, q, db, mask,
                      min_decisive=0.7 if case == "ties" else 0.9)
    if case == "ties":
        np.testing.assert_array_equal(idx[:20], np.arange(10, 30))
        np.testing.assert_array_equal(ref_idx[:20], np.arange(10, 30))


def test_cosine_argmax_plain_is_chunk_invariant():
    rng = np.random.RandomState(1)
    q, db = _unit(rng, (64, 16)), _unit(rng, (1000, 16))
    db[700:710] = db[5:15]
    mask = rng.rand(1000) > 0.2
    args = (torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(mask))
    s0, i0 = cosine_argmax_plain(*args, chunk=4096)
    for chunk in (7, 128, 999):
        s, i = cosine_argmax_plain(*args, chunk=chunk)
        np.testing.assert_array_equal(i.numpy(), i0.numpy())
        np.testing.assert_allclose(s.numpy(), s0.numpy(), atol=SIM_ATOL, rtol=0)


@pytest.mark.parametrize(
    "bad",
    ["float64", "noncontiguous", "mask_dtype", "shape"],
)
def test_cosine_argmax_wrapper_rejects_bad_input(bad):
    q, db = torch.zeros(4, 8), torch.zeros(10, 8)
    mask = torch.ones(10, dtype=torch.bool)
    if bad == "float64":
        q = q.double()
    elif bad == "noncontiguous":
        db = torch.zeros(8, 10).T
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    else:
        db = torch.zeros(10, 9)
    with pytest.raises((TypeError, ValueError)):
        cosine_argmax(q, db, mask)


def test_l2_normalize_and_masked_mad_match_jax():
    rng = np.random.RandomState(2)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    x[3] = 0.0  # zero vectors stay zero
    np.testing.assert_allclose(
        tm.l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(jm.l2_normalize(jnp.asarray(x))),
        atol=1e-7, rtol=0,
    )
    v = rng.exponential(size=(6, 41)).astype(np.float32)
    m = rng.rand(6, 41) > 0.4
    m[0] = False  # empty -> 0
    m[1] = False
    m[1, 7] = True  # single element
    m[2, :] = True  # odd count
    m[3, :40] = True
    m[3, 40] = False  # even count
    for b in range(6):
        jmed, jmad = jm.masked_mad(jnp.asarray(v[b]), jnp.asarray(m[b]))
        tmed, tmad = tm.masked_mad(torch.from_numpy(v[b]), torch.from_numpy(m[b]))
        assert float(tmed) == float(jmed) and float(tmad) == float(jmad)
    # The batched form (leading axis) gives the per-row results.
    bmed, bmad = tm.masked_mad(torch.from_numpy(v), torch.from_numpy(m))
    for b in range(6):
        tmed, tmad = tm.masked_mad(torch.from_numpy(v[b]), torch.from_numpy(m[b]))
        assert float(bmed[b]) == float(tmed) and float(bmad[b]) == float(tmad)


def _scene(seed, b, n, m, d):
    rng = np.random.RandomState(seed)
    map_pts = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    map_feats = rng.randn(m, d).astype(np.float32)
    map_mask = rng.rand(m) > 0.1
    sel = rng.choice(m, (b, n))
    scan_pts = map_pts[sel] + rng.normal(0, 0.05, (b, n, 3)).astype(np.float32)
    scan_feats = map_feats[sel] + rng.normal(0, 0.4, (b, n, d)).astype(np.float32)
    scan_mask = rng.rand(b, n) > 0.2
    return map_pts, map_feats, map_mask, scan_pts, scan_feats, scan_mask


def _assert_corr_agree(tc, jc, feats_q, feats_db, map_mask):
    sim, jsim = tc.similarity.numpy(), np.asarray(jc.similarity)
    np.testing.assert_allclose(sim, jsim, atol=SIM_ATOL, rtol=0)
    qn = feats_q / np.linalg.norm(feats_q, axis=-1, keepdims=True)
    dbn = feats_db / np.linalg.norm(feats_db, axis=-1, keepdims=True)
    ok = _decisive(qn.reshape(-1, qn.shape[-1]), dbn, map_mask).reshape(sim.shape)
    ok &= np.abs(jsim - 0.8) > SIM_ATOL  # acceptance not on the gate's edge
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(tc.target.numpy()[ok], np.asarray(jc.target)[ok])
    np.testing.assert_array_equal(tc.mask.numpy()[ok], np.asarray(jc.mask)[ok])
    if ok.all():
        for f in ("mean_similarity", "median_distance", "mad_distance"):
            np.testing.assert_allclose(
                getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), rtol=1e-5, atol=1e-6
            )


def test_get_vfm_correspondences_batched_matches_jax():
    mp, mf, mm, sp, sf, sm = _scene(3, 4, 64, 512, 32)
    jc = jm.get_vfm_correspondences_batched(*(jnp.asarray(a) for a in (mp, mf, mm, sp, sf, sm)))
    tc = tm.get_vfm_correspondences_batched(*(torch.from_numpy(a) for a in (mp, mf, mm, sp, sf, sm)))
    assert 0 < tc.mask.sum() < tc.mask.numel()  # the 0.8 gate both accepts and rejects
    _assert_corr_agree(tc, jc, sf, mf, mm)


def test_get_vfm_correspondences_single_matches_jax():
    mp, mf, mm, sp, sf, sm = _scene(4, 1, 200, 700, 16)
    sp, sf, sm = sp[0], sf[0], sm[0]
    jc = jm.get_vfm_correspondences(*(jnp.asarray(a) for a in (mp, mf, mm, sp, sf, sm)))
    tc = tm.get_vfm_correspondences(*(torch.from_numpy(a) for a in (mp, mf, mm, sp, sf, sm)))
    _assert_corr_agree(tc, jc, sf, mf, mm)
