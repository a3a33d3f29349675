"""Parity of the port's PointDSC (`vfmreg_tpu_torch.models.pointdsc`) with `vfmreg_tpu`.

On the CPU, with seeded numpy correspondences (a rigid motion, noise and
outliers, `tests/test_pointdsc.py`'s `make_corrs`):

* the reference torch module's golden (`tests/golden/pointdsc_reference_
  golden.npz`, 12 layers of 128): the encoder's features and confidence
  and the full inference's `final_trans` within 2e-4, its labels equal
  (`tests/test_reference_goldens.py`'s bars);
* `pointdsc_forward` fed the reference's random parameters
  (`init_pointdsc_params`) through `convert.pointdsc_params_from_numpy`,
  at 2 layers and at the full 12 x 128: confidence within 1e-4, the seed
  labels equal, `final_trans` within 1e-4;
* 28 padding rows change no real row's confidence (1e-5) nor the pose
  (1e-5);
* `PointDSCModel.register` against the reference's, with 600
  correspondences above a `max_corr` of 256 (the even subsample) and below
  it (512-doubling buckets, the seed count rounded up to 32): poses within
  1e-4;
* `get_pointdsc_model` raises FileNotFoundError without
  `VFMREG_POINTDSC_WEIGHTS` and loads the file it names.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation as R  # noqa: E402

from vfmreg_tpu.models import pointdsc as jpd  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.models import pointdsc as tpd  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "pointdsc_reference_golden.npz"


def make_corrs(rng, n=400, outlier_frac=0.6, noise=0.03):
    """`tests/test_pointdsc.py:9`."""
    T = np.eye(4)
    T[:3, :3] = R.from_euler("xyz", rng.uniform(-40, 40, 3), degrees=True).as_matrix()
    T[:3, 3] = rng.uniform(-5, 5, 3)
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (n, 3))).astype(np.float32)
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    tgt[out_idx] = rng.uniform(-15, 15, (n_out, 3))
    return src, tgt, T


def _t(a):
    return torch.from_numpy(np.array(a))


def _nets(num_layers):
    params = jpd.init_pointdsc_params(jax.random.PRNGKey(0), num_layers=num_layers)
    sd = convert.pointdsc_params_from_numpy(jax.tree.map(np.asarray, params))
    return params, tpd.load_pointdsc_state_dict(sd, num_layers=num_layers, device="cpu")


def test_golden():
    data = np.load(GOLDEN)
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    net = tpd.load_pointdsc_state_dict(sd, num_layers=12, device="cpu")
    src, tgt, corr = data["src"], data["tgt"], data["corr_pos"]
    d_src = np.linalg.norm(src[:, None] - src[None], axis=-1)
    d_tgt = np.linalg.norm(tgt[:, None] - tgt[None], axis=-1)
    compat = np.clip(1.0 - (d_src - d_tgt) ** 2 / 1.2**2, 0.0, None).astype(np.float32)
    feat, conf = tpd.pointdsc_encode(net, _t(corr), _t(compat))
    np.testing.assert_allclose(feat.numpy(), data["encoder_feat"], atol=2e-4)
    np.testing.assert_allclose(conf.numpy(), data["confidence"], atol=2e-4)
    n = src.shape[0]
    out = tpd.pointdsc_forward(net, _t(corr), _t(src), _t(tgt), torch.ones(n, dtype=torch.bool),
                               ratio_num=int(n * 0.1))
    np.testing.assert_allclose(out["final_trans"].numpy(), data["final_trans"], atol=2e-4)
    np.testing.assert_array_equal(out["final_labels"].numpy(), data["final_labels"].astype(bool))
    np.testing.assert_allclose(out["final_trans"].numpy()[:3, 3], data["gt_t"], atol=0.05)


@pytest.mark.parametrize("num_layers,n", [(2, 256), (12, 200)])
def test_forward_matches_reference(num_layers, n):
    params, net = _nets(num_layers)
    src, tgt, _ = make_corrs(np.random.RandomState(num_layers), n=n, outlier_frac=0.3, noise=0.01)
    corr = (np.c_[src, tgt] - np.c_[src, tgt].mean(0)).astype(np.float32)
    mask = np.ones(n, bool)
    want = jpd.pointdsc_forward(params, jnp.asarray(corr), jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                                ratio_num=32)
    got = tpd.pointdsc_forward(net, _t(corr), _t(src), _t(tgt), _t(mask), ratio_num=32)
    np.testing.assert_allclose(got["confidence"].numpy(), np.asarray(want["confidence"]), atol=1e-4)
    np.testing.assert_array_equal(got["final_labels"].numpy(), np.asarray(want["final_labels"]))
    np.testing.assert_allclose(got["final_trans"].numpy(), np.asarray(want["final_trans"]), atol=1e-4)


def test_padding_is_inert():
    _, net = _nets(2)
    src, tgt, _ = make_corrs(np.random.RandomState(0), n=100, outlier_frac=0.2)
    corr = np.c_[src, tgt] - np.c_[src, tgt].mean(0)

    def run(n_pad):
        rows = 100 + n_pad
        c, s, t = np.zeros((rows, 6), np.float32), np.zeros((rows, 3), np.float32), np.zeros((rows, 3), np.float32)
        c[:100], s[:100], t[:100] = corr, src, tgt
        return tpd.pointdsc_forward(net, _t(c), _t(s), _t(t), torch.arange(rows) < 100)

    a, b = run(0), run(28)
    np.testing.assert_allclose(a["final_trans"].numpy(), b["final_trans"].numpy(), atol=1e-5)
    np.testing.assert_allclose(a["confidence"].numpy()[:100], b["confidence"].numpy()[:100], atol=1e-5)


@pytest.mark.parametrize("max_corr", [256, 10000])
def test_register_matches_reference(max_corr):
    params, net = _nets(2)
    src, tgt, T = make_corrs(np.random.RandomState(5), n=600, outlier_frac=0.3, noise=0.005)
    want = jpd.PointDSCModel(params, max_corr=max_corr).register(src, tgt)
    got = tpd.PointDSCModel(net, max_corr=max_corr, device="cpu").register(src, tgt)
    assert got.dtype == np.float64 and got.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_get_pointdsc_model(monkeypatch, tmp_path):
    monkeypatch.delenv("VFMREG_POINTDSC_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="VFMREG_POINTDSC_WEIGHTS"):
        tpd.get_pointdsc_model("cpu")
    _, net = _nets(12)
    path = tmp_path / "pointdsc.pt"
    torch.save(net.state_dict(), path)
    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(path))
    model = tpd.get_pointdsc_model("cpu")
    assert model.device.type == "cpu" and model.max_corr == 10000
    for k, v in net.state_dict().items():
        assert torch.equal(model.net.state_dict()[k], v)
