"""Parity of the port's descriptor matching with `vfmreg_tpu.ops.matching`.

Kernel B1's plain version (what the port's wrapper runs for CPU tensors) is
held against the Pallas `cosine_argmax` run in interpret mode, as
`tests/test_matching.py` runs it. The tolerance is the one `chip_smoke.py`
holds the CUDA kernel to: similarities within atol 1e-5, indices equal on
every query whose top-2 similarity gap exceeds 1e-5 (below that, f32
summation order may pick either row). The port hands B1 the scan mask and
computes live queries only, so a correspondence's `similarity` and `target`
are compared on `scan_mask` rows, and a masked row must carry B1's fill
(-1e30, map row 0); `test_no_consumer_reads_a_masked_row` shows that the
method row and the scan-to-map path give the same results either way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import matching as jm  # noqa: E402
from vfmreg_tpu.ops.cosine_kernel import cosine_argmax as j_cosine_argmax  # noqa: E402
from vfmreg_tpu_torch import scan_to_map as s2m  # noqa: E402
from vfmreg_tpu_torch.ops import cosine_kernel as ck  # noqa: E402
from vfmreg_tpu_torch.ops import matching as tm  # noqa: E402
from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax, cosine_argmax_plain  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene  # noqa: E402

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
    ["float64", "noncontiguous", "mask_dtype", "shape", "q_mask_dtype", "q_mask_shape"],
)
def test_cosine_argmax_wrapper_rejects_bad_input(bad):
    q, db = torch.zeros(4, 8), torch.zeros(10, 8)
    mask = torch.ones(10, dtype=torch.bool)
    q_mask = None
    if bad == "float64":
        q = q.double()
    elif bad == "noncontiguous":
        db = torch.zeros(8, 10).T
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "q_mask_dtype":
        q_mask = torch.ones(4, dtype=torch.uint8)
    elif bad == "q_mask_shape":
        q_mask = torch.ones(5, dtype=torch.bool)
    else:
        db = torch.zeros(10, 9)
    with pytest.raises((TypeError, ValueError)):
        cosine_argmax(q, db, mask, q_mask)


def test_cosine_argmax_q_mask_fills_masked_rows():
    """A live row gets what it gets with every row live, bit for bit; a
    masked row gets (-1e30, 0), the value of a query whose every map row is
    masked."""
    rng = np.random.RandomState(5)
    q, db = _unit(rng, (300, 24)), _unit(rng, (900, 24))
    mask = torch.from_numpy(rng.rand(900) > 0.1)
    args = (torch.from_numpy(q), torch.from_numpy(db), mask)
    for live in (np.zeros(300, bool), np.arange(300) == 7, rng.rand(300) > 0.6, np.ones(300, bool)):
        qm = torch.from_numpy(live)
        sim, idx = cosine_argmax(*args, qm)
        dsim, didx = cosine_argmax(*args)
        assert torch.equal(sim[qm], dsim[qm]) and torch.equal(idx[qm], didx[qm])
        assert bool((sim[~qm] == -1e30).all()) and bool((idx[~qm] == 0).all())
        assert sim.dtype == torch.float32 and idx.dtype == torch.int32


def _tiles_per_split_dense(n, m_tiles, target):
    """The dense split of M: about `target` blocks for ceil(n / 128) query
    tiles, every row computed."""
    q_tiles = -(-n // ck._BQ)
    splits = max(1, min(m_tiles, -(-target // q_tiles)))
    return -(-m_tiles // splits)


@pytest.mark.parametrize("target", [1056, 264, 7])
def test_split_plan_keeps_the_dense_grid_and_fits_every_live_count(target):
    """B1's decomposition (`_split_plan`, which the kernel computes on the
    card from the live count): with every row live it is the grid the kernel
    launched before it took a query mask; for every live count the live
    tiles' blocks fit in that grid (the partial scratch is the grid's blocks
    x 128 pairs), the splits cover M with none empty, and fewer live tiles
    never take fewer splits."""
    clamped = 0
    for n in (1, 127, 128, 129, 1000, 1280, 4096, 16384, 131072):
        for m in (1, 128, 1000, 60000, 524288):
            q_tiles, m_tiles = -(-n // ck._BQ), -(-m // ck._BM)
            tps, splits = ck._split_plan(q_tiles, m_tiles, target)
            assert tps == _tiles_per_split_dense(n, m_tiles, target)
            capacity = q_tiles * splits
            assert ck._split_plan(q_tiles, m_tiles, target, capacity) == (tps, splits)
            for lt in range(1, q_tiles + 1) if q_tiles <= 128 else (1, 2, 13, 14, q_tiles - 1, q_tiles):
                t, s = ck._split_plan(lt, m_tiles, target, capacity)
                assert lt * s <= capacity and t * s >= m_tiles and t * (s - 1) < m_tiles
                clamped += s < ck._split_plan(lt, m_tiles, target)[1]
                if lt < q_tiles and q_tiles <= 128:
                    assert ck._split_plan(lt + 1, m_tiles, target, capacity)[1] <= s
    assert clamped > 0  # the grid's bound binds somewhere in this range


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


def _assert_corr_agree(tc, jc, feats_q, feats_db, map_mask, map_pts, scan_mask):
    """`similarity` and `target` on the scan_mask rows, as tightly as the
    kernel's gate; masked rows hold B1's fill and are never accepted."""
    sim, jsim = tc.similarity.numpy(), np.asarray(jc.similarity)
    live = scan_mask
    assert 0 < live.sum() < live.size  # both kinds of row are present
    np.testing.assert_allclose(sim[live], jsim[live], atol=SIM_ATOL, rtol=0)
    np.testing.assert_array_equal(sim[~live], np.float32(-1e30))
    np.testing.assert_array_equal(tc.target.numpy()[~live], np.broadcast_to(map_pts[0], (int((~live).sum()), 3)))
    assert not tc.mask.numpy()[~live].any() and not np.asarray(jc.mask)[~live].any()
    qn = feats_q / np.linalg.norm(feats_q, axis=-1, keepdims=True)
    dbn = feats_db / np.linalg.norm(feats_db, axis=-1, keepdims=True)
    ok = _decisive(qn.reshape(-1, qn.shape[-1]), dbn, map_mask).reshape(sim.shape)
    ok &= np.abs(jsim - 0.8) > SIM_ATOL  # acceptance not on the gate's edge
    ok &= live
    assert ok[live].mean() > 0.9
    np.testing.assert_array_equal(tc.target.numpy()[ok], np.asarray(jc.target)[ok])
    np.testing.assert_array_equal(tc.mask.numpy()[ok], np.asarray(jc.mask)[ok])
    if ok[live].all():
        for f in ("mean_similarity", "median_distance", "mad_distance"):
            np.testing.assert_allclose(
                getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), rtol=1e-5, atol=1e-6
            )


def test_get_vfm_correspondences_batched_matches_jax():
    mp, mf, mm, sp, sf, sm = _scene(3, 4, 64, 512, 32)
    jc = jm.get_vfm_correspondences_batched(*(jnp.asarray(a) for a in (mp, mf, mm, sp, sf, sm)))
    tc = tm.get_vfm_correspondences_batched(*(torch.from_numpy(a) for a in (mp, mf, mm, sp, sf, sm)))
    assert 0 < tc.mask.sum() < tc.mask.numel()  # the 0.8 gate both accepts and rejects
    _assert_corr_agree(tc, jc, sf, mf, mm, mp, sm)


def test_get_vfm_correspondences_single_matches_jax():
    mp, mf, mm, sp, sf, sm = _scene(4, 1, 200, 700, 16)
    sp, sf, sm = sp[0], sf[0], sm[0]
    jc = jm.get_vfm_correspondences(*(jnp.asarray(a) for a in (mp, mf, mm, sp, sf, sm)))
    tc = tm.get_vfm_correspondences(*(torch.from_numpy(a) for a in (mp, mf, mm, sp, sf, sm)))
    _assert_corr_agree(tc, jc, sf, mf, mm, mp, sm)


def _dense_b1(monkeypatch):
    """Kernel B1 as it was before it took the scan mask: every query row
    computed, masked rows included."""
    dense = tm.cosine_argmax
    monkeypatch.setattr(tm, "cosine_argmax", lambda q, db, mask, q_mask=None: dense(q, db, mask))


def _run_twice(monkeypatch, run):
    """run() with B1 on the live rows, then with B1 on every row; also the
    masked query rows that the first run handed B1."""
    masked_rows = []
    live_only = tm.cosine_argmax

    def counting(q, db, mask, q_mask=None):
        masked_rows.append(int((~q_mask).sum()))
        return live_only(q, db, mask, q_mask)

    with monkeypatch.context() as mp:
        mp.setattr(tm, "cosine_argmax", counting)
        masked = run()
    with monkeypatch.context() as mp:
        _dense_b1(mp)
        every = run()
    return masked, every, masked_rows


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "seconds":  # the stage clock's wall times
                _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("case", ["row", "row_retry_overflow", "scan_to_map"])
def test_no_consumer_reads_a_masked_row(monkeypatch, capsys, case):
    """The method row and the scan-to-map path give identical results with
    B1 computing every query row and with B1 computing the live rows only
    (masked rows then carry the fill): poses, correspondence and snap counts,
    retries, the snapped pairs RANSAC kept, iterations and loop counts. So no
    consumer reads a masked row's `similarity` or `target`. `row_retry_overflow`
    crops one scan to an 8 m radius (the 1 m retry) under a query budget of
    4 (the full-width re-match). The scan-to-map queries: each scan's 1,024
    rows of 5 m voxels (`n_vfm` 2,048), ~160 of them masked."""
    if case == "scan_to_map":
        scene = s2m.shared_map_batch(2, 8192, 1024, 24, seed=3)

        def run():
            r = s2m.scan_to_map(scene.map_points, scene.map_feats, scene.scans, scene.scan_feats,
                                n_vfm=2048, device="cpu")
            return r._asdict()

        masked, every, masked_rows = _run_twice(monkeypatch, run)
        assert masked_rows[0] > 100 and 0 < masked["n_correspondences"].min()
        _assert_same(masked, every)
        return
    scene, local_map, _ = make_synthetic_scene(3, 16384, 1024, 24, seed=1, extent=60.0)
    budget = 2048
    if case == "row_retry_overflow":
        c = scene["scene_point_clouds"][1]
        scene["scene_point_clouds"][1] = c[np.linalg.norm(c[:, :2], axis=1) < 8.0]
        budget = 4

    def run():
        return trn.precompute_scene_batched(scene, local_map, device="cpu", q5_budget=budget, viz=True)

    masked, every, masked_rows = _run_twice(monkeypatch, run)
    assert masked_rows[-1] > 0
    if case == "row_retry_overflow":
        assert masked["retried"] == [1] and "re-matching them at full width" in capsys.readouterr().out
        assert len(masked_rows) == 3 and min(masked_rows[1:]) > 0, masked_rows  # 5 m, re-match, retry
    assert all(len(src) > 0 for src, _ in masked["viz_corr"])
    _assert_same(masked, every)
