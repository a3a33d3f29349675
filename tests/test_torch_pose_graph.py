"""Parity of the port's pose-graph optimiser with `vfmreg_tpu.registration.pose_graph`.

`tests/test_pose_graph.py`'s five pose-graph cases, each run through both
packages on the CPU from the same seeded numpy inputs: the port's poses
within 1e-4 m (translations) and 1e-4 (rotation entries) of the JAX
optimiser's (f32 Gauss-Newton on both sides; the sums of H and the solve
differ in rounding, ~2e-6 measured), and the reference test's own bounds on
the port's result:

* a square loop with drifting odometry pulled back to the origin;
* perfect measurements recovering the truth;
* `IncrementalPoseGraph`: chained initial estimates, the optimise-on-loop
  policy step by step, and the warm-started active-window updates ending
  near the batch solution and the truth;
* a loop between tail vertices moving no upstream pose;
* no new factor, no solve.
The Jacobians (forward-mode derivatives) are also held to the reference's
`jax.jacfwd` ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation as R  # noqa: E402

from vfmreg_tpu.geometry import se3 as jse3  # noqa: E402
from vfmreg_tpu.registration import pose_graph as jpg  # noqa: E402
from vfmreg_tpu_torch.registration import pose_graph as tpg  # noqa: E402

T_ATOL, R_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _se3(t, yaw_deg=0.0):
    T = np.eye(4)
    T[:3, :3] = R.from_euler("z", yaw_deg, degrees=True).as_matrix()
    T[:3, 3] = t
    return T


def _same(a_list, b_list):
    for a, b in zip(a_list, b_list):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= T_ATOL, (a, b)
        assert np.abs(a[:3, :3] - b[:3, :3]).max() <= R_ATOL, (a, b)


def _both(build, num_iters):
    out = []
    for opt in (jpg.PoseGraphOptimizer(), tpg.PoseGraphOptimizer(device="cpu")):
        build(opt)
        out.append(opt.optimize(num_iters=num_iters))
    _same(out[1], out[0])
    return out[1]


def test_odometry_chain_with_loop():
    rng = np.random.RandomState(42)
    gt = [_se3([0, 0, 0], 0), _se3([10, 0, 0], 90), _se3([10, 10, 0], 180), _se3([0, 10, 0], 270),
          _se3([0, 0, 0], 0)]
    est = [T.copy() for T in gt]
    for k in range(1, 5):
        est[k][:3, 3] += rng.normal(0, 0.3, 3)
    odo = []
    for k in range(4):
        rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        rel[:3, 3] += rng.normal(0, 0.05, 3)
        odo.append(rel)

    def build(opt):
        for e in est:
            opt.add_pose(e)
        opt.add_prior(0, gt[0])
        for k in range(4):
            opt.add_odometry(k, k + 1, odo[k])
        opt.add_loop_closure(0, 4, np.eye(4))

    poses = _both(build, 15)
    assert np.linalg.norm(poses[0][:3, 3]) < 1e-3
    assert np.linalg.norm(poses[4][:3, 3]) < 0.15


def test_consistency():
    rng = np.random.RandomState(42)
    gt = [_se3([i * 2.0, 0, 0], 10 * i) for i in range(6)]
    noisy = [T.copy() for T in gt]
    for T in noisy:
        T[:3, 3] += rng.normal(0, 0.5, 3)

    def build(opt):
        for T in noisy:
            opt.add_pose(T)
        opt.add_prior(0, gt[0])
        for k in range(5):
            opt.add_odometry(k, k + 1, np.linalg.inv(gt[k]) @ gt[k + 1])

    for T, G in zip(_both(build, 15), gt):
        assert np.linalg.norm(T[:3, 3] - G[:3, 3]) < 1e-2


def test_jacobians_match_jacfwd():
    rng = np.random.RandomState(0)
    Ti = np.stack([_se3(rng.normal(0, 3, 3), rng.uniform(-180, 180)) for _ in range(5)]).astype(np.float32)
    Tj = np.stack([_se3(rng.normal(0, 3, 3), rng.uniform(-180, 180)) for _ in range(5)]).astype(np.float32)
    Z = np.stack([_se3(rng.normal(0, 3, 3), rng.uniform(-180, 180)) for _ in range(5)]).astype(np.float32)
    prior = np.array([False, True, False, False, True])
    Tj[prior] = np.eye(4, dtype=np.float32)

    def res(eps, a, b, z, p):
        a = jse3.exp_se3(eps[:6]) @ a
        b = jse3.exp_se3(eps[6:]) @ b
        zi = jse3.inverse_se3(z)
        return jnp.where(p, jse3.log_se3(zi @ a), jse3.log_se3(zi @ jse3.inverse_se3(a) @ b))

    want = np.asarray(jax.jit(jax.vmap(lambda a, b, z, p: jax.jacfwd(res)(jnp.zeros(12), a, b, z, p)))(
        Ti, Tj, Z, prior))
    r, J = tpg._jacobians(*(torch.from_numpy(x) for x in (Ti, Tj, Z, prior)))
    assert J.shape == (5, 6, 12)
    np.testing.assert_allclose(J.numpy(), want, atol=2e-4, rtol=1e-4)
    assert (J.numpy()[prior][:, :, 6:] == 0).all()


def _square_twice():
    gt = [_se3([0, 0, 0], 0)]
    for _ in range(2):
        for t, yaw in (([10, 0, 0], 90), ([10, 10, 0], 180), ([0, 10, 0], 270), ([0, 0, 0], 0)):
            gt.append(_se3(t, yaw))
    return gt


def test_incremental_matches_reference_behaviour():
    rng = np.random.RandomState(42)
    gt = _square_twice()
    noisy_rel = []
    for k in range(1, len(gt)):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        rel[:3, 3] += rng.normal(0, 0.05, 3)
        noisy_rel.append(rel)
    graphs = {"jax": jpg.IncrementalPoseGraph(min_factors=100),
              "torch": tpg.IncrementalPoseGraph(min_factors=100, device="cpu")}
    batch = tpg.PoseGraphOptimizer(device="cpu")
    batch.add_pose(gt[0])
    batch.add_prior(0, gt[0])
    for inc in graphs.values():
        inc.add_prior_factor_pose(0, gt[0])
        assert inc.size() == 1 and np.allclose(inc.pose_at(-1), gt[0])
    inc = graphs["torch"]
    for k in range(1, len(gt)):
        rel = noisy_rel[k - 1]
        fired = {}
        for name, g in graphs.items():
            g.add_odom_edge(k, rel, sigma=0.01)
            np.testing.assert_allclose(g.pose_at(k), g.pose_at(k - 1) @ rel, atol=1e-9)
            fired[name] = g.optimize_if_needed()
        assert fired["torch"] is fired["jax"] is (k > 5)
        batch.add_pose(inc.pose_at(k))
        batch.add_odometry(k - 1, k, rel, sigmas=np.full(6, 0.01))
        if k == 5:
            for g in graphs.values():
                g.add_loop_edge(1, 5, np.eye(4), sigma=0.05)
                assert g.optimize_if_needed() is True
            batch.add_loop_closure(1, 5, np.eye(4), sigmas=np.full(6, 0.05))
        if k == 8:
            for g in graphs.values():
                g.add_loop_edge(0, 8, np.eye(4), sigma=0.05)
                assert g.optimize_if_needed() is False
            batch.add_loop_closure(0, 8, np.eye(4), sigmas=np.full(6, 0.05))
        _same(graphs["torch"].poses, graphs["jax"].poses)
    batch_poses = batch.optimize(num_iters=25)
    for g in graphs.values():
        g.optimize(num_iters=25)
    _same(graphs["torch"].poses, graphs["jax"].poses)
    for k in range(len(gt)):
        assert np.linalg.norm(inc.pose_at(k)[:3, 3] - batch_poses[k][:3, 3]) < 0.05
        assert np.linalg.norm(inc.pose_at(k)[:3, 3] - gt[k][:3, 3]) < 0.3


def _chain(graphs, rels):
    for g in graphs:
        g.add_prior_factor_pose(0, _se3([0, 0, 0]))
        for k, rel in enumerate(rels, start=1):
            g.add_odom_edge(k, rel, sigma=0.01)
            g.optimize_if_needed()


def test_active_window_freezes_upstream():
    """The reference test's 12-vertex chain on the port; the same with 7
    vertices against the JAX graph step by step (each JAX solve of a new
    size compiles)."""
    rng = np.random.RandomState(42)
    rels = []
    for _ in range(11):
        rel = _se3([1.0, 0, 0])
        rel[:3, 3] += rng.normal(0, 0.01, 3)
        rels.append(rel)
    inc = tpg.IncrementalPoseGraph(min_factors=1, device="cpu")
    _chain([inc], rels)
    frozen = [inc.pose_at(k).copy() for k in range(8)]
    loop = np.linalg.inv(inc.pose_at(9)) @ inc.pose_at(11)
    loop[:3, 3] += 0.2
    inc.add_loop_edge(9, 11, loop, sigma=0.05)
    assert inc.optimize_if_needed() is True
    for k in range(8):
        np.testing.assert_allclose(inc.pose_at(k), frozen[k], atol=1e-6)
    assert np.abs(inc.pose_at(11) - frozen[7]).max() > 1e-3

    graphs = [jpg.IncrementalPoseGraph(min_factors=1), tpg.IncrementalPoseGraph(min_factors=1, device="cpu")]
    _chain(graphs, rels[:6])
    _same(graphs[1].poses, graphs[0].poses)
    loop = np.linalg.inv(graphs[1].pose_at(4)) @ graphs[1].pose_at(6)
    loop[:3, 3] += 0.2
    for g in graphs:
        g.add_loop_edge(4, 6, loop, sigma=0.05)
        assert g.optimize_if_needed() is True
    _same(graphs[1].poses, graphs[0].poses)


def test_skips_solve_without_new_information(monkeypatch):
    g = tpg.IncrementalPoseGraph(min_factors=100, device="cpu")
    g.add_prior_factor_pose(0, np.eye(4))
    T = np.eye(4)
    T[0, 3] = 1.0
    g.add_odom_edge(1, T)
    g.add_loop_edge(0, 1, np.eye(4), sigma=0.1)
    assert g.optimize_if_needed()
    after = [p.copy() for p in g.poses]
    calls = {"n": 0}
    orig = tpg._optimize

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tpg, "_optimize", counting)
    assert g.optimize_if_needed()
    assert calls["n"] == 0
    for a, b in zip(g.poses, after):
        np.testing.assert_array_equal(a, b)
