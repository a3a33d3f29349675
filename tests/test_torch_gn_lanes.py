"""The lane-batched GN loop of the port: kernels B2 and B3 over all lanes of
an ICP row, and `geometric_icp_loop_lanes`.

* `gn_step_lanes` (its plain version, which the wrapper runs for CPU
  tensors) is, lane for lane and bit for bit, one iteration of the per-lane
  loop it replaced: `gn_moments_plain` -> `assemble_gn_system` -> a host
  `gn_step` (`_host_gn_step`: the reference's floor, unrolled Cholesky and
  gate in numpy f32) -> `exp_se3` -> the conjugation by the centre ->
  `transform_points` (one lane of `geometry.se3.*_lanes`: the products
  written out in kernel B2's order), with the stop tests in numpy f32. Held on a normal lane, an empty lane, a
  lane with a NaN query, a one-point (rank-deficient) lane and a frozen lane,
  and on crafted moments whose system is not positive definite;
* the lane-batched B3 equals per-lane `champions_from_planes_plain` (and
  `build_nn_cache`) and leaves unflagged lanes alone; `mark_rebuilt` marks
  the flagged lanes rebuilt;
* `geometric_icp_loop_lanes` over lanes with different iteration counts, an
  `it0 > 0` and a lane that starts finished, equals the B = 1 runs lane for
  lane for 1, 4 and 16 steps per read, and matches the JAX
  `geometric_icp_loop`'s iteration counts on `tests/test_torch_icp.py`'s
  map;
* the batched reductions the loop relies on equal the per-lane ones, and
  the lane-state layout of the B2 CUDA source equals the Python one.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.registration import icp as jicp  # noqa: E402
from vfmreg_tpu_torch.convert import grid_from_numpy  # noqa: E402
from vfmreg_tpu_torch.geometry.se3 import (  # noqa: E402
    conjugate_translation_lanes,
    exp_se3,
    exp_se3_lanes,
    matmul_lanes,
    transform_points_lanes,
)
from vfmreg_tpu_torch.ops import champion_kernel as tck  # noqa: E402
from vfmreg_tpu_torch.ops import gn_kernel as tgn  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402

KERNEL, MAX_DIST = 0.667, 1.5
THR = ticp.ESTIMATION_THRESHOLD
R = ticp.REFRESH_INTERVAL
CSRC = Path(ticp.__file__).resolve().parent.parent / "csrc"
_f32 = np.float32


def _norm(v):
    """The per-lane loop's |v|: numpy's f32 sum of the squares."""
    return np.sqrt(np.sum(v * v, dtype=np.float32), dtype=np.float32)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _cholesky_solve6(A, b):
    """The reference's unrolled 6x6 Cholesky solve in numpy f32 scalars,
    every sum from 0 in ascending order."""
    z = _f32(0.0)
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        L[j][j] = np.sqrt(A[j][j] - sum((L[j][k] * L[j][k] for k in range(j)), z))
        for i in range(j + 1, 6):
            L[i][j] = (A[i][j] - sum((L[i][k] * L[j][k] for k in range(j)), z)) / L[j][j]
    y = [None] * 6
    for i in range(6):
        y[i] = (b[i] - sum((L[i][k] * y[k] for k in range(i)), z)) / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = (y[i] - sum((L[k][i] * x[k] for k in range(i + 1, 6)), z)) / L[i][i]
    return np.array(x, dtype=np.float32)


def _host_gn_step(JTJ, JTr, n_corr):
    """The reference's `gn_step` on the host, one system at a time: (dx, n)
    with the 1e-8 floor and dx zero when n is 0 or the solve not finite."""
    A = JTJ.numpy() + _f32(1e-8) * np.eye(6, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        dx = _cholesky_solve6([[_f32(v) for v in r] for r in A], [_f32(v) for v in -JTr.numpy()])
    n = int(n_corr)
    if n > 0 and np.all(np.isfinite(dx)):
        return dx, n
    return np.zeros(6, dtype=np.float32), n


def _est(dx, center):
    """One lane's pose update: `exp_se3` of dx conjugated by the centre."""
    return conjugate_translation_lanes(exp_se3_lanes(torch.from_numpy(dx)[None]), center[None])[0]


class _Lane:
    """One lane of the per-lane loop: its host state and the old loop body."""

    def __init__(self, it, s, dxn, moved, r_max, slack, T):
        self.it, self.s, self.dxn, self.moved = it, s, _f32(dxn), _f32(moved)
        self.r_max, self.slack, self.T = _f32(r_max), _f32(slack), T.clone()
        self.done = self.confirmed = False

    def step(self, cx, cy, cz, source, center):
        m = tgn.gn_moments_plain(cx, cy, cz, source, center.tolist(), KERNEL, MAX_DIST)
        JTJ, JTr, n_corr = tgn.assemble_gn_system(m)
        dx, n_corr = _host_gn_step(JTJ, JTr, n_corr)
        est = _est(dx, center)
        source = transform_points_lanes(source[None], est[None])[0]
        self.T = matmul_lanes(est[None], self.T[None])[0]
        self.dxn = _norm(dx)
        self.confirmed = self.s == 0 and self.dxn < _f32(THR)
        self.moved = self.moved + _norm(dx[:3]) + _norm(dx[3:]) * self.r_max
        self.done = n_corr == 0
        self.it += 1
        self.s += 1
        return m, dx, est, source

    def live(self, phase, max_it):
        """The per-lane loop's inner-loop condition."""
        return (phase == tgn.STEP and self.s < R and self.it < max_it and not self.done
                and not self.confirmed and self.moved < self.slack
                and (self.s == 0 or self.dxn >= _f32(THR)))

    def phase(self, max_it):
        more = self.it < max_it and not self.done and not self.confirmed
        if more and self.s < R and self.moved < self.slack and self.dxn >= _f32(THR):
            return tgn.STEP
        if not more:
            return tgn.FINISHED
        return tgn.REBUILD if self.moved < self.slack else tgn.GATHER


def _map(seed=5, n_map=1500):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, 10, (n_map, 3)).astype(np.float32)
    return rng, pts, thg.build_hash_grid(torch.from_numpy(pts), 1.0)


@pytest.fixture(scope="module")
def lanes_case():
    """Five lanes of 96 queries on one map: normal, empty (far from the map),
    a NaN query, one accepted query (rank-deficient system), and a lane that
    is frozen (phase REBUILD)."""
    rng, pts, grid = _map()
    n, b = 96, 5
    src = np.empty((b, n, 3), np.float32)
    for j in range(b):
        src[j] = pts[rng.choice(len(pts), n, replace=False)] + rng.normal(0, 0.1, (n, 3)) + [0.3, -0.2, 0.1]
    src[1] += 100.0  # empty
    src[2, 0] = np.nan  # NaN query
    src[3, 1:] += 100.0  # one query near the map
    mask = rng.rand(b, n) > 0.1
    mask[3, 0] = True
    source = torch.from_numpy(src)
    masks = torch.from_numpy(mask)
    group = ticp.champion_group(grid)
    caches = [tck.champions_from_planes_plain(
        *thg.gather_candidate_slabs(grid, source[j], masks[j]).planes(group), source[j], masks[j], group)
        for j in range(b)]
    champs = torch.stack([torch.stack(c) for c in caches], dim=1).contiguous()
    finite = np.where(np.isnan(src), 0.0, src)
    center = torch.from_numpy((finite.sum(axis=1) / n).astype(np.float32))
    T0 = exp_se3(torch.from_numpy(rng.normal(0, 0.05, (b, 6)).astype(np.float32)))
    return source, masks, champs, center, T0


def _state(T0, its, ss, dxns, moveds, phases, r_max, n, max_it=1000):
    st = tgn.new_gn_lanes(T0, its, max_it, torch.tensor(r_max, dtype=torch.float32), 0.5, n)
    st.ints[:, tgn.S] = torch.tensor(ss, dtype=torch.int32)
    st.ints[:, tgn.PHASE] = torch.tensor(phases, dtype=torch.int32)
    st.floats[:, tgn.DXN] = torch.tensor(dxns, dtype=torch.float32)
    st.floats[:, tgn.MOVED] = torch.tensor(moveds, dtype=torch.float32)
    return st


@pytest.mark.parametrize("steps", [1, 3])
def test_gn_step_lanes_plain_equals_per_lane_sequence(lanes_case, steps):
    source, masks, champs, center, T0 = lanes_case
    b, n = source.shape[:2]
    its, ss = [0, 3, 5, 7, 2], [0, 2, 0, 1, 0]
    dxns, moveds, r_max = [np.inf, 0.5, np.inf, 0.5, np.inf], [0.0, 0.1, 0.0, 0.2, 0.0], [9.0, 8.0, 7.5, 6.0, 5.0]
    phases = [tgn.STEP] * 4 + [tgn.REBUILD]
    st = _state(T0, its, ss, dxns, moveds, phases, r_max, n)
    frozen = st.clone()
    lanes = [_Lane(its[j], ss[j], dxns[j], moveds[j], r_max[j], 0.5, T0[j]) for j in range(b)]
    ref_src = [source[j].clone() for j in range(b)]
    src = source.clone()
    for _ in range(steps):
        live = tgn.lanes_live(st, THR, R).tolist()
        tgn.gn_step_lanes(champs[0], champs[1], champs[2], src, center, KERNEL, MAX_DIST, THR, R, st)
        for j, lane in enumerate(lanes):
            assert live[j] == lane.live(phases[j], 1000), j
            if not live[j]:
                continue
            m, dx, est, ref_src[j] = lane.step(champs[0, j], champs[1, j], champs[2, j], ref_src[j], center[j])
            phases[j] = lane.phase(1000)
            assert _same(st.moments[j], m) and _same(st.dx[j], dx) and _same(st.est[j], est)
            assert _same(st.T[j], lane.T) and _same(src[j], ref_src[j])
            assert st.floats[j, tgn.DXN].item() == lane.dxn and st.floats[j, tgn.MOVED].item() == lane.moved
            ints = st.ints[j].tolist()
            assert ints[tgn.IT] == lane.it and ints[tgn.S] == lane.s and ints[tgn.STEPPED] == 1
            assert bool(ints[tgn.DONE]) == lane.done and bool(ints[tgn.CONF]) == lane.confirmed
            assert ints[tgn.PHASE] == phases[j]
    # The edge lanes did what they should: the empty lane stops, the NaN row
    # stays NaN and the rest of its lane moves, the frozen lane is untouched.
    assert st.ints[1, tgn.DONE] == 1 and st.ints[1, tgn.PHASE] == tgn.FINISHED
    assert torch.isnan(src[2, 0]).all() and torch.isfinite(src[2, 1:]).all()
    assert not torch.equal(src[2, 1:], source[2, 1:])
    assert torch.equal(st.ints[4, :tgn.STEPPED], frozen.ints[4, :tgn.STEPPED]) and st.ints[4, tgn.STEPPED] == 0
    assert torch.equal(st.floats[4], frozen.floats[4]) and torch.equal(st.T[4], frozen.T[4])
    assert torch.equal(src[4], source[4])


def _crafted_moments():
    """Moment vectors of systems the per-lane solve must gate or survive."""
    rng = np.random.RandomState(11)
    p = rng.normal(0, 3, (50, 3)).astype(np.float32)
    r = rng.normal(0, 0.1, (50, 3)).astype(np.float32)
    good = np.r_[50, 50, p.sum(0), (p * p).sum(0), (p[:, 0] * p[:, 1]).sum(), (p[:, 0] * p[:, 2]).sum(),
                 (p[:, 1] * p[:, 2]).sum(), r.sum(0), np.cross(p, r).sum(0)].astype(np.float32)
    indefinite = good.copy()
    indefinite[5:8] = [400.0, -300.0, 10.0]  # tr I - S2 not positive definite: the Cholesky NaNs
    empty = np.zeros(17, np.float32)
    flat = np.zeros(17, np.float32)
    flat[0] = 3  # n > 0 with a zero system: A = 1e-8 I, dx = 0
    one = good.copy()
    one[0:2] = 1  # one point: rank-deficient, its pivots round below 0
    one[2:5], one[5:11] = p[0], [p[0, 0] ** 2, p[0, 1] ** 2, p[0, 2] ** 2, p[0, 0] * p[0, 1],
                                 p[0, 0] * p[0, 2], p[0, 1] * p[0, 2]]
    huge = good.copy()
    huge[1] = np.inf  # an overflowed weight sum
    return np.stack([good, indefinite, empty, flat, one, huge]).astype(np.float32)


def test_gn_finish_lanes_plain_on_crafted_systems():
    m = torch.from_numpy(_crafted_moments())
    b = m.shape[0]
    center = torch.tensor([[1.0, -2.0, 0.5]] * b)
    st = tgn.new_gn_lanes(torch.eye(4).repeat(b, 1, 1), 0, 1000, torch.full((b,), 5.0), 0.5, 8)
    st.ints[:, tgn.PHASE] = tgn.STEP
    live = tgn.lanes_live(st, THR, R)
    assert live.all()
    tgn.gn_finish_lanes_plain(m, st, center, live, THR, R)
    zero_step = []
    for j in range(b):
        JTJ, JTr, n_corr = tgn.assemble_gn_system(m[j])
        dx, n = _host_gn_step(JTJ, JTr, n_corr)
        assert _same(st.dx[j], dx), (j, st.dx[j], dx)
        est = _est(dx, center[j])
        assert _same(st.est[j], est) and _same(st.T[j], matmul_lanes(est[None], torch.eye(4)[None])[0])
        assert st.floats[j, tgn.DXN].item() == _norm(dx)
        assert st.ints[j, tgn.DONE].item() == (n == 0)
        assert st.ints[j, tgn.CONF].item() == (_norm(dx) < _f32(THR))
        zero_step.append(not dx.any())
    # Only the well-posed system moves; the others give the zero step.
    assert zero_step == [False, True, True, True, True, True], zero_step


def test_champions_from_planes_lanes_plain():
    rng, pts, grid = _map(seed=6)
    b, n, group = 4, 80, ticp.champion_group(grid)
    src = torch.from_numpy((pts[rng.choice(len(pts), (b, n))] + rng.normal(0, 0.3, (b, n, 3))).astype(np.float32))
    src[2, 5] = float("nan")
    masks = torch.from_numpy(rng.rand(b, n) > 0.2)
    cands = [thg.gather_candidate_slabs(grid, src[j], masks[j]) for j in range(b)]
    per_lane = [c.planes(group) for c in cands]
    planes = [torch.stack([p[i] for p in per_lane]) for i in range(3)]
    out = tck.new_champion_buffer(b, n, "cpu")
    out[:, 1, :27] = 7.0  # an unflagged lane keeps whatever it held
    before = out.clone()
    flags = torch.tensor([tgn.REBUILT, tgn.KEEP, tgn.GATHERED, tgn.REBUILT], dtype=torch.int32)
    st = tgn.new_gn_lanes(torch.eye(4).repeat(b, 1, 1), 0, 1000, torch.ones(b), 0.5, n)
    st.ints[:, tgn.S] = 5
    st.ints[:, tgn.PHASE] = torch.tensor([tgn.REBUILD, tgn.STEP, tgn.GATHER, tgn.REBUILD])
    st.floats[:, tgn.MOVED] = 0.3
    tck.champions_from_planes_lanes(*planes, src, masks, flags, group, out)
    tgn.mark_rebuilt(st, flags)
    for j in range(b):
        if flags[j] == tgn.KEEP:
            assert torch.equal(out[:, j], before[:, j])
            continue
        plain = tck.champions_from_planes_plain(planes[0][j], planes[1][j], planes[2][j], src[j], masks[j], group)
        cache = thg.build_nn_cache(cands[j], src[j], masks[j])
        for c, ref in enumerate((cache.cx, cache.cy, cache.cz)):
            assert torch.equal(out[c, j], plain[c]) and torch.equal(out[c, j], ref)
    assert st.ints[:, tgn.REBUILDS].tolist() == [1, 0, 1, 1]
    assert st.ints[:, tgn.S].tolist() == [0, 5, 0, 0]
    assert st.ints[:, tgn.PHASE].tolist() == [tgn.STEP] * 4
    assert st.floats[:, tgn.MOVED].tolist() == pytest.approx([0.3, 0.3, 0.0, 0.3])


def test_lane_wrappers_check_their_arguments():
    st = tgn.new_gn_lanes(torch.eye(4).repeat(2, 1, 1), 0, 10, torch.ones(2), 0.5, 16)
    c = torch.zeros(2, 32, 16)
    src, center = torch.zeros(2, 16, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="source"):
        tgn.gn_step_lanes(c, c, c, torch.zeros(2, 15, 3), center, KERNEL, MAX_DIST, THR, R, st)
    with pytest.raises(TypeError, match="center"):
        tgn.gn_step_lanes(c, c, c, src, center.double(), KERNEL, MAX_DIST, THR, R, st)
    planes = torch.zeros(2, 27 * 8, 16)
    out = tck.new_champion_buffer(2, 16, "cpu")
    masks = torch.ones(2, 16, dtype=torch.bool)
    with pytest.raises(TypeError, match="lane_flag"):
        tck.champions_from_planes_lanes(planes, planes, planes, src, masks, torch.ones(2), 8, out)
    with pytest.raises(ValueError, match="groups"):
        tck.champions_from_planes_lanes(planes, planes, planes, src, masks,
                                        torch.ones(2, dtype=torch.int32), 7, out)


@pytest.fixture(scope="module")
def far_field():
    """One shared map and four scans at growing offsets (the layout of
    `tests/test_torch_batched_icp.py`'s fixture, smaller)."""
    rng = np.random.RandomState(42)
    b, m, n = 4, 4000, 500
    pts = np.c_[rng.uniform(-30, 30, (m, 2)), rng.uniform(0, 6, (m, 1))].astype(np.float32)
    scans = np.zeros((b, n, 3), np.float32)
    for j in range(b):
        ang = np.deg2rad(rng.uniform(-4, 4) * (j + 1) / b)
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        t = np.r_[rng.uniform(-1.0, 1.0, 2) * (j + 1), 0.0]
        scans[j] = (pts[rng.choice(m, n, replace=False)] - t) @ Rz
    mask = np.ones((b, n), bool)
    mask[:, ::13] = False
    grid = thg.build_hash_grid(torch.from_numpy(pts), 1.0)
    src, msk = torch.from_numpy(scans), torch.from_numpy(mask)
    center = torch.where(msk[..., None], src, 0.0).sum(dim=1) / msk.sum(dim=1)[:, None]
    return grid, src, msk, center


@pytest.mark.parametrize("steps_per_read", [1, 4, 16])
def test_loop_lanes_equals_one_lane_runs(far_field, steps_per_read, monkeypatch):
    grid, src, msk, center = far_field
    monkeypatch.setattr(ticp, "GN_STEPS_PER_READ", steps_per_read)
    it0 = [0, 4, 0, 1000]  # lane 3 starts finished
    b = src.shape[0]
    eye = torch.eye(4).repeat(b, 1, 1)
    got = ticp.geometric_icp_loop_lanes(grid, src, msk, eye, center, 3.0, 0.5, 1000, THR, it0)
    its = []
    for j in range(b):
        one = ticp.geometric_icp_loop(grid, src[j], msk[j], torch.eye(4), center[j], 3.0, 0.5, 1000, THR,
                                      it0=it0[j])
        assert torch.equal(got.T_icp[j], one.T_icp) and torch.equal(got.source[j], one.source), j
        assert (got.it[j], got.done[j], got.confirmed[j], got.rebuilds[j]) == (
            one.it, one.done, one.confirmed, one.rebuilds), j
        its.append(one.it - it0[j])
    assert got.it[3] == 1000 and got.rebuilds[3] == 0 and torch.equal(got.T_icp[3], torch.eye(4))
    assert len(set(its[:3])) == 3 and min(got.rebuilds[:3]) > 1  # lanes of different lengths
    loop = got.loop
    assert loop["step_calls"] == steps_per_read * (loop["reads"] - 1)
    assert loop["lane_rebuilds"] == got.rebuilds.sum() and loop["rebuild_rounds"] <= loop["reads"] - 1
    assert loop["step_calls"] >= max(its)
    if steps_per_read == 1:  # no lane ever waits for a rebuild: the longest lane sets the count
        assert loop["step_calls"] == max(its)


def test_loop_lanes_match_jax_iterations():
    """`tests/test_torch_icp.py`'s map and scan, plus two more scans of it at
    other offsets, in one lane-batched loop against the JAX loop per lane."""
    rng = np.random.RandomState(3)
    n_map, n_scan = 6000, 1500
    mp = np.c_[rng.uniform(-15, 15, (n_map, 2)), rng.uniform(0, 4, (n_map, 1))].astype(np.float32)
    scans, masks = [], []
    for ang_deg, t in ((4.0, [0.6, -0.4, 0.1]), (-2.0, [-0.3, 0.5, 0.0]), (1.0, [0.9, 0.2, -0.1])):
        src = mp[rng.choice(n_map, n_scan, replace=False)] + rng.normal(0, 0.02, (n_scan, 3))
        ang = np.deg2rad(ang_deg)
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        scans.append((src @ Rz.T + np.array(t)).astype(np.float32))
        masks.append(rng.rand(n_scan) > 0.05)
    scans, masks = np.stack(scans), np.stack(masks)
    centers = np.stack([(s[m].sum(axis=0) / m.sum()).astype(np.float32) for s, m in zip(scans, masks)])
    jgrid = jhg.build_hash_grid(jnp.asarray(mp), 1.0)

    @jax.jit
    def run(grid, src, mask, center):
        s = jicp.geometric_icp_loop(
            grid, src, mask, jnp.eye(4, dtype=jnp.float32), center, jnp.float32(MAX_DIST),
            jnp.float32(KERNEL), 1000, jicp.ESTIMATION_THRESHOLD, it0=0,
        )
        return s.T_icp, s.it, s.confirmed

    grid = grid_from_numpy(
        np.asarray(jgrid.table), np.asarray(jgrid.points), np.asarray(jgrid.bucket_slab), None,
        np.asarray(jgrid.valid), 1.0, jgrid.max_points_per_voxel, device="cpu",
    )
    got = ticp.geometric_icp_loop_lanes(
        grid, torch.from_numpy(scans), torch.from_numpy(masks), torch.eye(4).repeat(3, 1, 1),
        torch.from_numpy(centers), MAX_DIST, KERNEL, 1000, THR, it0=0,
    )
    for j in range(3):
        jT, jit, jconf = run(jgrid, *(jnp.asarray(a[j]) for a in (scans, masks, centers)))
        assert got.it[j] == int(jit) and got.confirmed[j] == bool(jconf), (j, got.it, int(jit))
        np.testing.assert_allclose(got.T_icp[j].numpy(), np.asarray(jT), atol=2e-5, rtol=0)
    assert got.it.max() > ticp.REFRESH_INTERVAL


@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_reductions_equal_per_lane(b):
    """What `register_frames_icp_stats` and `geometric_icp_loop_lanes`
    compute over the lane axis, against the per-lane expressions they
    replaced: the masked centre, the lever arm r_max, and the norms."""
    rng = np.random.RandomState(b)
    n = 1537
    src = torch.from_numpy((rng.randn(b, n, 3) * 30 + rng.randn(3) * 100).astype(np.float32))
    mask = torch.from_numpy(rng.rand(b, n) > 0.1)
    center = torch.where(mask[..., None], src, 0.0).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1)[:, None]
    r_max = torch.sqrt(torch.amax(torch.where(mask, torch.sum(torch.square(src - center[:, None]), dim=-1),
                                              0.0), dim=1))
    for j in range(b):
        cj = torch.where(mask[j][:, None], src[j], 0.0).sum(dim=0) / torch.clamp(mask[j].sum(), min=1)
        assert torch.equal(center[j], cj)
        d2c = torch.sum(torch.square(src[j] - cj), dim=-1)
        assert r_max[j].item() == np.float32(torch.sqrt(torch.amax(torch.where(mask[j], d2c, 0.0))).item())
    v = torch.from_numpy((rng.randn(4000, 6) * 10.0 ** rng.randint(-7, 2, (4000, 6))).astype(np.float32))
    sq = tgn._sq_sum(v)
    assert all(sq[i].item() == np.sum(v[i].numpy() * v[i].numpy(), dtype=np.float32) for i in range(len(v)))


def _constants(text):
    return {k: int(v) for k, v in re.findall(r"\b([IFP]_[A-Z_]+|NI|NF)\s*=\s*(\d+)", text)}


def test_lane_state_layout_matches_cuda_sources():
    py = {f"I_{k}": getattr(tgn, k) for k in ("IT", "S", "DONE", "CONF", "PHASE", "REBUILDS", "MAX_IT", "STEPPED")}
    py.update({f"F_{k}": getattr(tgn, k) for k in ("DXN", "MOVED", "RMAX", "SLACK")})
    py.update({f"P_{k}": getattr(tgn, k) for k in ("STEP", "REBUILD", "GATHER", "FINISHED")})
    py.update(NI=8, NF=4)
    got = _constants((CSRC / "gn_moments.cu").read_text())
    assert got and all(py[k] == v for k, v in got.items()), got
