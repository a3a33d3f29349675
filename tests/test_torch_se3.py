"""Parity of the port's SE(3) / SO(3) maps (`vfmreg_tpu_torch.geometry.se3`)
with `vfmreg_tpu.geometry.se3` on seeded random twists, including rotation
angles near 0 (series branches) and near pi (the symmetric-part branch).
Both run in float32 on the CPU; atol 1e-6, plus two f32 ulps of the value
(rtol 2^-22) for translations of several metres, where one ulp is ~1e-6.

Between the series threshold (theta = 1e-4) and ~0.3 rad the reference's f32
formulas are ill-conditioned: (1 - cos t) / t^2 and (t - sin t) / t^3 cancel,
and arccos near 1 amplifies an ulp of its argument by 1 / sin(theta). The two
packages' f32 sin, cos and arccos differ by an ulp, so there the translation
of `exp_se3` differs by up to ~1.6e-3 and `log_so3` by ~2e-6 (ROADMAP.md
section C). That band is held to the exact (float64) maps instead: the port
may be no farther from them than the reference is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.geometry import se3 as jse3  # noqa: E402
from vfmreg_tpu_torch.geometry import se3 as tse3  # noqa: E402

ATOL = 1e-6
RTOL = 2.0**-22
_LOG10_THETA = {"series": (-9, -4), "cancel_band": (-4, -0.5)}


def _twists(regime, n=64):
    rng = np.random.RandomState(["generic", "series", "near_pi", "cancel_band"].index(regime))
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if regime == "near_pi":
        theta = np.pi - 10.0 ** rng.uniform(-7, -2.5, n)
    elif regime == "generic":
        theta = rng.uniform(0.3, 2.8, n)
    else:
        theta = 10.0 ** rng.uniform(*_LOG10_THETA[regime], n)
    omega = axis * theta[:, None]
    upsilon = rng.uniform(-5, 5, (n, 3))
    return np.concatenate([upsilon, omega], axis=1).astype(np.float32)


def _both(fn_name, x):
    a = np.asarray(getattr(jse3, fn_name)(jnp.asarray(x)))
    b = getattr(tse3, fn_name)(torch.from_numpy(x.copy())).numpy()
    return a, b


REGIMES = ["generic", "series", "near_pi"]


@pytest.mark.parametrize("regime", REGIMES)
def test_exp_se3_matches_jax(regime):
    a, b = _both("exp_se3", _twists(regime))
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("regime", REGIMES + ["cancel_band"])
def test_exp_so3_and_hat_match_jax(regime):
    w = _twists(regime)[:, 3:].copy()
    for fn_name in ("exp_so3", "hat_so3"):
        a, b = _both(fn_name, w)
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fn_name", ["exp_se3", "log_so3", "log_se3"])
def test_cancel_band_no_worse_than_reference(fn_name):
    dx = _twists("cancel_band")
    if fn_name == "exp_se3":
        x = dx
    elif fn_name == "log_so3":
        x = np.asarray(jse3.exp_so3(jnp.asarray(dx[:, 3:])))
    else:
        x = np.asarray(jse3.exp_se3(jnp.asarray(dx)))
    a, b = _both(fn_name, x)
    exact = getattr(tse3, fn_name)(torch.from_numpy(x.astype(np.float64))).numpy()
    err_ref = np.abs(a - exact).max()
    err_port = np.abs(b - exact).max()
    assert err_port <= 2.0 * err_ref, (err_port, err_ref)
    if fn_name == "exp_se3":  # the rotation block is well-conditioned throughout
        np.testing.assert_allclose(b[:, :3, :3], a[:, :3, :3], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("regime", REGIMES)
def test_log_so3_matches_jax(regime):
    R = np.asarray(jse3.exp_so3(jnp.asarray(_twists(regime)[:, 3:])))
    a, b = _both("log_so3", R)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("regime", ["generic", "series"])
def test_log_se3_matches_jax(regime):
    T = np.asarray(jse3.exp_se3(jnp.asarray(_twists(regime))))
    a, b = _both("log_se3", T)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("regime", REGIMES)
def test_inverse_and_transform_match_jax(regime):
    T = np.asarray(jse3.exp_se3(jnp.asarray(_twists(regime))))
    a, b = _both("inverse_se3", T)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)
    pts = np.random.RandomState(3).uniform(-1, 1, (64, 50, 3)).astype(np.float32)
    a = np.asarray(jse3.transform_points(jnp.asarray(pts), jnp.asarray(T)))
    b = tse3.transform_points(torch.from_numpy(pts), torch.from_numpy(T.copy())).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)
