"""Parity of the port's exact max clique and TEASER solver with `vfmreg_tpu`.

* `max_clique`: the same clique mask as the reference's on seeded random
  graphs and on the planted-clique graph of `tests/test_teaser.py:66`
  (the same host algorithm, so bit for bit);
* `teaser_registration_exact` at 0 / 50 / 90 % outliers: the same inlier
  mask (the graph and the clique are host work in both), and poses within
  1e-4 of the reference (the GNC-TLS and TLS solves differ only in f32
  rounding of the SVD and the sums, ~4e-7 measured);
* the GNC loop's fixed `max_iters` steps with a live flag equal, bit for
  bit, a loop written here that stops on the reference's cost condition
  and reads the cost every step;
* `_scalar_tls` within 1e-6 of the reference's on the reference test's
  voting problem;
* the greedy form: `_consistency_graph` and `_greedy_clique` equal to the
  reference's on random and planted-clique graphs (ties included: the
  stable seed order and the first maximum), the growth's early stop equal
  to the full n steps, and `teaser_registration` at 0 / 50 / 90 % outliers
  with masked rows and past the 512-node budget: the same inlier mask and
  poses within 1e-4, on the device of the inputs.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

from vfmreg_tpu.registration import max_clique as jclique  # noqa: E402
from vfmreg_tpu.registration import teaser as jteaser  # noqa: E402
from vfmreg_tpu_torch.registration import max_clique as tclique  # noqa: E402
from vfmreg_tpu_torch.registration import teaser as tteaser  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its torch operations are small,
    gain nothing from more threads, and slow to a crawl when the suite's
    workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n, outlier_frac, noise=0.01):
    rng = np.random.RandomState(seed)
    R = Rotation.from_euler("zyx", [35, 10, -5], degrees=True).as_matrix().astype(np.float32)
    t = np.array([2.0, -1.0, 0.5], np.float32)
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    tgt = src @ R.T + t + rng.normal(0, noise, (n, 3)).astype(np.float32)
    k = int(n * outlier_frac)
    idx = rng.choice(n, k, replace=False)
    tgt[idx] = rng.uniform(-8, 8, (k, 3)).astype(np.float32)
    return src, tgt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_clique_matches_jax_on_random_graphs(seed):
    rng = np.random.RandomState(seed)
    for n, p in ((14, 0.5), (40, 0.3), (120, 0.1)):
        a = rng.rand(n, n) < p
        a = a | a.T
        np.fill_diagonal(a, False)
        got, ref = tclique.max_clique(a), jclique.max_clique(a)
        np.testing.assert_array_equal(got, ref)
        sub = a[np.ix_(np.flatnonzero(got), np.flatnonzero(got))]
        assert np.all(sub | np.eye(int(got.sum()), dtype=bool))
    # Brute force on the smallest size: the clique is a maximum one.
    a = rng.rand(12, 12) < 0.5
    a = a | a.T
    np.fill_diagonal(a, False)
    best = max(k for k in range(1, 13) for comb in itertools.combinations(range(12), k)
               if np.all(a[np.ix_(comb, comb)] | np.eye(k, dtype=bool)))
    assert tclique.max_clique(a).sum() == best


def test_max_clique_matches_jax_on_planted_clique():
    """A 12-clique hidden among hubs of higher degree (`tests/test_teaser.py:96`)."""
    rng = np.random.RandomState(42)
    n = 80
    a = np.zeros((n, n), dtype=bool)
    a[:12, :12] = True
    for h in range(12, 20):
        others = rng.choice(np.arange(20, n), 40, replace=False)
        a[h, others] = True
        a[others, h] = True
    a = a | a.T
    np.fill_diagonal(a, False)
    got = tclique.max_clique(a)
    np.testing.assert_array_equal(got, jclique.max_clique(a))
    np.testing.assert_array_equal(np.flatnonzero(got), np.arange(12))


@pytest.mark.parametrize("outlier_frac", [0.0, 0.5, 0.9])
def test_teaser_exact_matches_jax(outlier_frac):
    src, tgt = _problem(3, 200, outlier_frac)
    mask = np.ones(200, bool)
    mask[::37] = False  # a few masked rows, behind the graph's budget order
    ref = jteaser.teaser_registration_exact(src, tgt, mask, noise_bound=0.05)
    got = tteaser.teaser_registration_exact(src, tgt, mask, noise_bound=0.05, device="cpu")
    np.testing.assert_array_equal(got.inlier_mask, np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    np.testing.assert_allclose(got.rotation_weights.numpy(), np.asarray(ref.rotation_weights), atol=1e-4)
    assert got.inlier_mask.sum() >= 15


def test_gnc_fixed_steps_equal_the_stopping_loop():
    src, tgt = _problem(5, 120, 0.3, noise=0.03)
    a = torch.from_numpy(src[1:] - src[:-1])
    b = torch.from_numpy(tgt[1:] - tgt[:-1])
    w_mask = torch.ones(a.shape[0], dtype=torch.bool)
    w_mask[::5] = False

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    nb, cbar2, factor, thr = f32(0.05), f32(1.0), f32(1.4), f32(1e-16)
    R_fixed, w_fixed = tteaser._gnc_tls_rotation(a, b, w_mask, nb, cbar2, factor, 100, thr)

    # The reference's while_loop, stop condition read every step.
    eps2 = torch.clamp(nb * nb, min=1e-12)
    R, mu = tteaser._gnc_init(a, b, w_mask, eps2, cbar2)
    w = w_mask.to(torch.float32)
    prev, cost, it = float("inf"), torch.tensor(0.0), 0
    while it < 100 and abs(cost.item() - prev) > thr.item():
        R, w, cost_new = tteaser._gnc_step(a, b, w_mask, R, mu, eps2, cbar2)
        prev, cost = cost.item(), cost_new
        mu = mu * factor
        it += 1
    assert 1 < it < 100, it  # the loop stopped on its cost, before the budget
    assert torch.equal(R_fixed, R) and torch.equal(w_fixed, w)


def test_scalar_tls_matches_jax():
    rng = np.random.RandomState(42)
    v = (np.full(100, 3.0) + rng.normal(0, 0.01, 100)).astype(np.float32)
    v[:60] = rng.uniform(-50, 50, 60)
    m = np.ones(100, bool)
    m[90:] = False
    ref = float(jteaser._scalar_tls(jnp.asarray(v), jnp.asarray(m), jnp.float32(0.05), jnp.float32(1.0)))
    got = float(tteaser._scalar_tls(torch.from_numpy(v), torch.from_numpy(m), torch.tensor(0.05),
                                    torch.tensor(1.0)))
    assert abs(got - ref) < 1e-6 and abs(got - 3.0) < 0.02


def _graph_both(adj):
    return tteaser._greedy_clique(torch.from_numpy(adj)).numpy(), np.asarray(jteaser._greedy_clique(jnp.asarray(adj)))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_clique_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for n, p in ((30, 0.5), (90, 0.2), (200, 0.05)):
        a = rng.rand(n, n) < p
        a = a | a.T
        np.fill_diagonal(a, False)
        got, ref = _graph_both(a)
        np.testing.assert_array_equal(got, ref)
        sub = a[np.ix_(np.flatnonzero(got), np.flatnonzero(got))]
        assert np.all(sub | np.eye(int(got.sum()), dtype=bool))
    # A planted 12-clique among hubs, and a graph of equal degrees (ties).
    n = 80
    a = np.zeros((n, n), dtype=bool)
    a[:12, :12] = True
    for h in range(12, 20):
        others = rng.choice(np.arange(20, n), 40, replace=False)
        a[h, others] = a[others, h] = True
    np.fill_diagonal(a, False)
    got, ref = _graph_both(a)
    np.testing.assert_array_equal(got, ref)
    ring = np.zeros((24, 24), dtype=bool)
    for i in range(24):
        ring[i, (i + 1) % 24] = ring[(i + 1) % 24, i] = True
    got, ref = _graph_both(ring)
    np.testing.assert_array_equal(got, ref)


def test_consistency_graph_matches_jax():
    src, tgt = _problem(4, 150, 0.5)
    mask = np.ones(150, bool)
    mask[::11] = False
    ref = np.asarray(jteaser._consistency_graph(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), 0.05, 1.0))
    got = tteaser._consistency_graph(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
                                     torch.tensor(0.05), torch.tensor(1.0)).numpy()
    # The threshold comparison turns on the last ulp of a norm difference
    # for pairs on its edge: count them, allow no other difference.
    d_src = np.linalg.norm(src[:, None] - src[None], axis=-1)
    d_tgt = np.linalg.norm(tgt[:, None] - tgt[None], axis=-1)
    edge = np.abs(np.abs(d_src - d_tgt) - 0.1) < 1e-5
    assert np.all((got == ref) | edge) and got.sum() > 0


@pytest.mark.parametrize("outlier_frac", [0.0, 0.5, 0.9])
def test_teaser_greedy_matches_jax(outlier_frac):
    n = 600 if outlier_frac == 0.5 else 200  # past the 512-node budget once
    src, tgt = _problem(6, n, outlier_frac)
    mask = np.ones(n, bool)
    mask[::37] = False
    ref = jteaser.teaser_registration(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), noise_bound=0.05)
    got = tteaser.teaser_registration(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
                                      noise_bound=0.05)
    np.testing.assert_array_equal(got.inlier_mask, np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    np.testing.assert_allclose(got.rotation_weights.numpy(), np.asarray(ref.rotation_weights), atol=1e-4)
    assert got.pose.device.type == "cpu" and got.inlier_mask.sum() >= 15
    assert got.inlier_mask[~mask].sum() == 0 and got.inlier_mask[np.flatnonzero(mask)[512:]].sum() == 0
