"""Parity of the port's learned baseline descriptors (DIP, GeDi, SpinNet) with `vfmreg_tpu`.

On the CPU, with seeded numpy inputs:

* the PointNet++ operators (`ops/pointnet2.py`) against the reference's
  six: furthest-point sampling with ties and the near-origin guard, gather,
  ball query (first hits in index order, short rows filled with the first,
  an empty ball, a cloud smaller than the sample budget), grouping, three-NN
  and its interpolation; and `nn_distance` / `chamfer_loss`: indices equal,
  values within 1e-6;
* each network at the reference's full width, fed the reference's random
  parameters (`init_*_params`) through `convert.*_params_from_numpy`, on a
  few patches: DIP and GeDi descriptors within 1e-5, GeDi's quaternions
  within 1e-6, SpinNet's descriptors within 1e-4 (9 x 30 x 60 cells,
  thousands of f32 convolution terms);
* each network loaded from the reference torch modules' own state dicts
  (`tests/golden/*.npz`) reproduces their activations at
  `tests/test_reference_goldens.py`'s tolerances: 1e-4 for DIP and GeDi,
  1e-5 for GeDi's quaternions and for `var_to_invar`, 2e-4 for SpinNet's
  trunk, 1e-9 for the voxel grid;
* the LRF patches of DIP and GeDi fed the reference's draws (its
  `jax.random` permutations, keys and replicas): within 1e-5 wherever the
  local frame is well conditioned (at least 4 neighbours; below that the
  covariance's small eigenvalues tie and any eigenvector is right);
* the extractors on small clouds with the reference's draws injected (DIP,
  GeDi) or the same `RandomState` seed (SpinNet): the points equal, the
  descriptors of well-conditioned points within 1e-4 (DIP, GeDi) and every
  SpinNet descriptor within 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.descriptors import dip as jdip_x  # noqa: E402
from vfmreg_tpu.descriptors import gedi as jgedi_x  # noqa: E402
from vfmreg_tpu.descriptors import spinnet as jspin_x  # noqa: E402
from vfmreg_tpu.descriptors.fpfh import _grid_input_order  # noqa: E402
from vfmreg_tpu.kiss.voxelization import voxel_down_sample  # noqa: E402
from vfmreg_tpu.models import dip as jdip  # noqa: E402
from vfmreg_tpu.models import gedi as jgedi  # noqa: E402
from vfmreg_tpu.models import spinnet as jspin  # noqa: E402
from vfmreg_tpu.ops import nndistance as jnnd  # noqa: E402
from vfmreg_tpu.ops import pointnet2 as jp2  # noqa: E402
from vfmreg_tpu.ops.hash_grid import build_hash_grid as jbuild  # noqa: E402
from vfmreg_tpu.ops.knn import radius_knn as jknn  # noqa: E402
from vfmreg_tpu.ops.voxel import bucket_size  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.descriptors import dip as tdip_x  # noqa: E402
from vfmreg_tpu_torch.descriptors import gedi as tgedi_x  # noqa: E402
from vfmreg_tpu_torch.descriptors import spinnet as tspin_x  # noqa: E402
from vfmreg_tpu_torch.models import dip as tdip  # noqa: E402
from vfmreg_tpu_torch.models import gedi as tgedi  # noqa: E402
from vfmreg_tpu_torch.models import spinnet as tspin  # noqa: E402
from vfmreg_tpu_torch.ops import nndistance as tnnd  # noqa: E402
from vfmreg_tpu_torch.ops import pointnet2 as tp2  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden(name):
    data = np.load(GOLDEN / f"{name}_reference_golden.npz")
    return ({k[4:]: data[k] for k in data.files if k.startswith("sd::")},
            {k: data[k] for k in data.files if not k.startswith("sd::")})


# ------------------------------------------------------------------ operators
@pytest.mark.parametrize("op", ["fps", "gather", "ball_query", "grouping", "three_nn", "three_interpolate"])
def test_pointnet2_ops_match_reference(op):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    xyz[:, 100:110] = xyz[:, 50:60]  # duplicate points: FPS and NN ties
    xyz[:, 5] = 0.0  # near the origin: skipped by the guard
    if op == "fps":
        for skip in (False, True):
            want = np.asarray(jp2.furthest_point_sampling(jnp.asarray(xyz), 64, skip_near_origin=skip))
            got = tp2.furthest_point_sampling(_t(xyz), 64, skip_near_origin=skip).numpy()
            np.testing.assert_array_equal(got, want)
    elif op in ("gather", "grouping"):
        feats = rng.normal(size=(2, 7, 300)).astype(np.float32)
        idx = rng.randint(0, 300, (2, 40) if op == "gather" else (2, 40, 9))
        jf, tf = (jp2.gather_operation, tp2.gather_operation) if op == "gather" else (
            jp2.grouping_operation, tp2.grouping_operation)
        np.testing.assert_array_equal(tf(_t(feats), _t(idx)).numpy(), np.asarray(jf(jnp.asarray(feats), jnp.asarray(idx))))
    elif op == "ball_query":
        centers = np.concatenate([xyz[:, :20], np.full((2, 1, 3), 9.0, np.float32)], axis=1)  # an empty ball
        for radius, ns, pts in ((0.3, 16, xyz), (0.5, 32, xyz), (2.0, 16, xyz[:, :10])):
            want = np.asarray(jp2.ball_query(radius, ns, jnp.asarray(pts), jnp.asarray(centers)))
            got = tp2.ball_query(radius, ns, _t(pts), _t(centers)).numpy()
            np.testing.assert_array_equal(got, want)
    else:
        known = xyz[:, :40]
        dist_w, idx_w = jp2.three_nn(jnp.asarray(xyz), jnp.asarray(known))
        dist_g, idx_g = tp2.three_nn(_t(xyz), _t(known))
        np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_w))
        np.testing.assert_allclose(dist_g.numpy(), np.asarray(dist_w), atol=1e-6)
        if op == "three_interpolate":
            feats = rng.normal(size=(2, 5, 40)).astype(np.float32)
            w = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
            want = jp2.three_interpolate(jnp.asarray(feats), idx_w, jnp.asarray(w))
            got = tp2.three_interpolate(_t(feats), idx_g, _t(w))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_nn_distance_matches_reference():
    rng = np.random.RandomState(4)
    a = rng.normal(size=(2, 50, 3)).astype(np.float32)
    b = rng.normal(size=(2, 70, 3)).astype(np.float32)
    want = jnnd.nn_distance(jnp.asarray(a), jnp.asarray(b))
    got = tnnd.nn_distance(_t(a), _t(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(float(tnnd.chamfer_loss(_t(a), _t(b))),
                               float(jnnd.chamfer_loss(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


# ------------------------------------------------------------ network forwards
def test_dip_forward_matches_reference():
    params = jdip.init_dip_params(jax.random.PRNGKey(0))
    net = tdip.load_dip_state_dict(convert.dip_params_from_numpy(_np(params)), device="cpu")
    patches = np.random.RandomState(5).normal(0, 0.4, (3, 256, 3)).astype(np.float32)
    want = np.asarray(jdip.dip_forward(params, jnp.asarray(patches)))
    np.testing.assert_allclose(tdip.dip_forward(net, _t(patches)).numpy(), want, atol=1e-5)


def test_gedi_forward_matches_reference():
    params = jgedi.init_gedi_params(jax.random.PRNGKey(0))
    net = tgedi.load_gedi_state_dict(convert.gedi_params_from_numpy(_np(params)), device="cpu")
    patches = np.random.RandomState(6).uniform(-1, 1, (2, 512, 3)).astype(np.float32)
    with torch.no_grad():
        q = net.qnet(_t(patches)).numpy()
    np.testing.assert_allclose(q, np.asarray(jgedi._qnet(params["qnet"], jnp.asarray(patches))), atol=1e-6)
    want = np.asarray(jgedi.gedi_forward(params, jnp.asarray(patches)))
    np.testing.assert_allclose(tgedi.gedi_forward(net, _t(patches)).numpy(), want, atol=1e-5)


def test_spinnet_forward_matches_reference():
    params = jspin.init_spinnet_params(jax.random.PRNGKey(0))
    net = tspin.load_spinnet_state_dict(convert.spinnet_params_from_numpy(_np(params)), device="cpu")
    grid = jspin.get_voxel_coordinate(2.0, 9, 60, 30).astype(np.float32)
    patches = np.random.RandomState(7).uniform(-1.5, 1.5, (2, 256, 3)).astype(np.float32)
    want = np.asarray(jspin.spinnet_forward(params, jnp.asarray(patches), jnp.asarray(grid)))
    got = tspin.spinnet_forward(net, _t(patches), _t(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


# --------------------------------------------------------------------- goldens
def test_dip_golden():
    sd, g = _golden("dip")
    net = tdip.load_dip_state_dict(sd, device="cpu")
    got = tdip.dip_forward(net, _t(np.transpose(g["patches"], (0, 2, 1)))).numpy()
    np.testing.assert_allclose(got, g["descriptors"], atol=1e-4)


def test_gedi_golden():
    sd, g = _golden("gedi")
    net = tgedi.load_gedi_state_dict(sd, device="cpu")
    patches = _t(np.transpose(g["patches"], (0, 2, 1)))
    with torch.no_grad():
        np.testing.assert_allclose(net.qnet(patches).numpy(), g["quat"], atol=1e-5)
    np.testing.assert_allclose(tgedi.gedi_forward(net, patches).numpy(), g["descriptors"], atol=1e-4)


def test_spinnet_golden():
    sd, g = _golden("spinnet")
    net = tspin.load_spinnet_state_dict(sd, device="cpu")
    rel = _t(np.transpose(g["new_points"], (0, 2, 3, 1)))
    np.testing.assert_allclose(tspin.spinnet_trunk(net, rel, 9, 60, 30).numpy(), g["trunk_out"], atol=2e-4)
    np.testing.assert_allclose(tspin.var_to_invar(_t(g["vpts"]), 9, 60, 30).numpy(), g["var_to_invar_out"],
                               atol=1e-5)
    np.testing.assert_allclose(tspin.get_voxel_coordinate(2.0, 9, 60, 30), g["grid"].reshape(-1, 3), atol=1e-9)


# ------------------------------------------------------------ patches, draws
def _cloud(n, seed, extent=3.0):
    rng = np.random.RandomState(seed)
    return np.c_[rng.uniform(-extent, extent, (n, 2)), rng.uniform(0, 2, (n, 1))].astype(np.float32)


def _dip_reference_draws(down):
    """The reference extractor's permutations: one `jax.random` key per
    padded row of PRNGKey(0)."""
    m0 = down.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), bucket_size(m0))[:m0]
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, tdip_x.K_NEIGHBOURS)[:256])(keys))


def _gedi_reference_draws(down):
    """The reference extractor's sort keys and replicas: per batch of 256
    rows, split(key, 3); one subkey per row of k1, split again for the
    uniform keys and the replica draw. Also the neighbour counts."""
    m0 = down.shape[0]
    n = bucket_size(m0)
    P = np.zeros((n, 3), np.float32)
    P[:m0] = down
    M = np.arange(n) < m0
    g = jbuild(jnp.asarray(P), 0.5, mask=jnp.asarray(M), max_points_per_voxel=32)
    cnt = np.maximum(np.asarray(jknn(g, jnp.asarray(P), jnp.asarray(M), k=768, radius=0.5).mask).sum(1), 1)
    keys, reps = [], []
    key = jax.random.PRNGKey(0)

    def draw(sk, c):
        a, b = jax.random.split(sk)
        return jax.random.uniform(a, (768,)), jax.random.randint(b, (512,), 0, c)

    for b in range(0, n, 256):
        key, k1, _ = jax.random.split(key, 3)
        r, rep = jax.vmap(draw)(jax.random.split(k1, min(256, n - b)), jnp.asarray(cnt[b : b + 256]))
        keys.append(np.asarray(r))
        reps.append(np.asarray(rep))
    return np.concatenate(keys)[:m0], np.concatenate(reps)[:m0].astype(np.int64), cnt[:m0]


def test_lrf_patches_match_reference():
    rng = np.random.RandomState(8)
    pts = _cloud(400, 8, extent=1.5)
    P = np.zeros((512, 3), np.float32)
    P[:400] = pts
    M = np.arange(512) < 400
    g = jbuild(jnp.asarray(P), jdip.LRF_KERNEL, mask=jnp.asarray(M), max_points_per_voxel=24)
    knn = jknn(g, jnp.asarray(P), jnp.asarray(M), k=384, radius=jdip.LRF_KERNEL)
    order = np.asarray(_grid_input_order(jnp.asarray(P), jnp.asarray(M), g.voxel_size))
    nbr_idx = order[np.asarray(knn.idx)]
    key = jax.random.PRNGKey(1)
    want, frames = jdip.compute_lrf_patches(jnp.asarray(P), jnp.asarray(M), jnp.asarray(nbr_idx), knn.mask, key)
    perm = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 384)[:256])(jax.random.split(key, 512)))
    got, tframes = tdip.compute_lrf_patches(_t(P), _t(nbr_idx), _t(np.asarray(knn.mask)), _t(perm))
    good = np.asarray(knn.mask).sum(1) >= 4
    good[400:] = False
    np.testing.assert_allclose(got.numpy()[good], np.asarray(want)[good], atol=1e-5)
    np.testing.assert_allclose(tframes.numpy()[good], np.asarray(frames)[good], atol=1e-5)

    # GeDi's patches, with its garbage-slot case (masked slots far away).
    k, n_valid = 64, 5
    centers = np.zeros((2, 3), np.float32)
    nbr = np.full((2, k, 3), 37.0, np.float32)
    nbr[:, :n_valid] = rng.uniform(-0.4, 0.4, (2, n_valid, 3))
    nbr[1, n_valid : 2 * n_valid] = rng.uniform(-0.4, 0.4, (n_valid, 3))
    m = np.zeros((2, k), bool)
    m[0, :n_valid] = True
    m[1, : 2 * n_valid] = True
    key = jax.random.PRNGKey(2)
    want = np.asarray(jgedi.gedi_lrf_patches(jnp.asarray(centers), jnp.asarray(nbr), jnp.asarray(m), key,
                                             r_lrf=0.5, samples_per_patch_out=32))

    def draw(sk, c):
        a, b = jax.random.split(sk)
        return jax.random.uniform(a, (k,)), jax.random.randint(b, (32,), 0, c)

    keys, reps = jax.vmap(draw)(jax.random.split(key, 2), jnp.asarray(m.sum(1)))
    got = tgedi.gedi_lrf_patches(_t(centers), _t(nbr), _t(m), _t(keys), _t(reps).to(torch.int64), r_lrf=0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.linalg.norm(got.numpy(), axis=-1).max() < 2.0


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference extractors' random parameters, as port checkpoints."""
    tmp = tmp_path_factory.mktemp("weights")
    out = {}
    for name, fn, mod in (("dip", convert.dip_params_from_numpy, jdip_x),
                          ("gedi", convert.gedi_params_from_numpy, jgedi_x),
                          ("spinnet", convert.spinnet_params_from_numpy, jspin_x)):
        out[name] = tmp / f"{name}.pt"
        torch.save(fn(_np(mod._get_params())), out[name])
    return out


def test_dip_extractor_matches_reference(weights):
    pts = _cloud(900, 9)
    want_pts, want = jdip_x.extract_dip_features(pts, 0.3)
    perm = _dip_reference_draws(voxel_down_sample(pts, 0.3).astype(np.float32))
    got_pts, got = tdip_x.extract_dip_features(pts, 0.3, weight_path=str(weights["dip"]), device="cpu",
                                               perm=_t(perm))
    np.testing.assert_array_equal(got_pts, want_pts)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (got * want).sum(1)
    assert np.median(cos) > 1 - 1e-9 and (cos > 0.9999).mean() > 0.97, (np.median(cos), (cos > 0.9999).mean())


def test_gedi_extractor_matches_reference(weights):
    pts = _cloud(700, 10, extent=2.0)
    want_pts, want = jgedi_x.extract_gedi_features(pts, 0.3)
    keys, reps, cnt = _gedi_reference_draws(voxel_down_sample(pts, 0.3).astype(np.float32))
    got_pts, got = tgedi_x.extract_gedi_features(pts, 0.3, weight_path=str(weights["gedi"]), device="cpu",
                                                 draws=(_t(keys), _t(reps)))
    np.testing.assert_array_equal(got_pts, want_pts)
    good = cnt >= 4
    assert good.mean() > 0.8
    np.testing.assert_allclose(got[good], want[good], atol=1e-4)


def test_spinnet_extractor_matches_reference(weights):
    pts = np.random.RandomState(11).uniform(-3, 3, (300, 3)).astype(np.float32)
    want_kp, want = jspin_x.extract_spinnet_features(pts, 3, batch_size=3)
    got_kp, got = tspin_x.extract_spinnet_features(pts, 3, weight_path=str(weights["spinnet"]), device="cpu")
    np.testing.assert_array_equal(got_kp, want_kp)
    np.testing.assert_allclose(got, want, atol=1e-4)
