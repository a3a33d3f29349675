"""Parity of the port's FCGF / GCL ResUNet and extractors with `vfmreg_tpu`.

On the CPU, at the published widths (channels 32/64/128/256; TR channels
64/64/64/128 with a 7^3 conv1 for FCGF, 128/128/128/256 with 5^3 for GCL):

* the reference torch modules' goldens (`tests/golden/{fcgf,gcl}_reference_
  golden.npz`: their state dicts, inputs and descriptors) through the port's
  `load_me_state_dict`, within 1e-4 (`tests/test_reference_goldens.py`'s
  tolerance);
* `resunet_forward` against the JAX one with the JAX seeded parameters
  carried across by `convert.resunet_params_from_numpy`, on padded inputs
  (a mask), within 1e-4, the measured error printed;
* `extract_{fcgf,gcl}_features` against the JAX extractors, both loading
  one checkpoint file written from the golden's `sd::` entries (the
  MinkowskiEngine layout, nested under 'state_dict' as the published
  files are): the points bit for bit, the descriptors within 1e-4;
* `sparse_quantize` equal to the reference's, the model registry equal,
  the loader's tolerance of 3-D 1 x 1 kernels and missing
  `num_batches_tracked`, the seeded init, and translation invariance by a
  multiple of the stride pyramid.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.descriptors import fcgf as jfcgf  # noqa: E402
from vfmreg_tpu.descriptors import gcl as jgcl  # noqa: E402
from vfmreg_tpu.models import sparse_resunet as jres  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.descriptors import fcgf as tfcgf  # noqa: E402
from vfmreg_tpu_torch.descriptors import gcl as tgcl  # noqa: E402
from vfmreg_tpu_torch.models import sparse_resunet as tres  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"
ATOL = 1e-4  # tests/test_reference_goldens.py's tolerance for these networks
CONFIGS = {"fcgf": (tres.FCGF_CONFIG, jres.FCGF_CONFIG), "gcl": (tres.GCL_CONFIG, jres.GCL_CONFIG)}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden(name):
    g = np.load(GOLDEN / f"{name}_reference_golden.npz")
    return {k[4:]: g[k] for k in g.files if k.startswith("sd::")}, {k: g[k] for k in g.files if not k.startswith("sd::")}


def _forward(net, coords, feats, mask):
    return tres.resunet_forward(net, torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("name", ["fcgf", "gcl"])
def test_golden_through_me_state_dict(name):
    sd, g = _golden(name)
    net = tres.load_me_state_dict(sd, CONFIGS[name][0], device="cpu")
    n = g["coords"].shape[0]
    got = _forward(net, g["coords"], g["feats"], np.ones(n, bool))
    err = float(np.abs(got - g["descriptors"]).max())
    print(f"{name}: golden max abs error {err:.3g}")
    assert err <= ATOL


@pytest.mark.parametrize("name", ["fcgf", "gcl"])
def test_forward_matches_jax_with_converted_params(name):
    tcfg, jcfg = CONFIGS[name]
    params = jres.init_resunet_params(jax.random.PRNGKey(3), jcfg)
    net = tres.load_me_state_dict(
        convert.resunet_params_from_numpy(jax.tree.map(np.asarray, params), tcfg), tcfg, device="cpu")
    rng = np.random.RandomState(5)
    n, live = 1024, 900
    coords = rng.randint(-24, 24, (n, 3)).astype(np.int32)
    mask = np.arange(n) < live
    feats = np.where(mask[:, None], 1.0, 0.0).astype(np.float32)
    want = np.asarray(jres.resunet_forward(params, jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), jcfg))
    got = _forward(net, coords, feats, mask)
    err = float(np.abs(got - want).max())
    print(f"{name}: max abs error against the JAX forward {err:.3g}")
    assert err <= ATOL
    assert (got[~mask] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[mask], axis=1), 1.0, atol=1e-4)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A MinkowskiEngine-layout checkpoint file per model, from its golden."""
    d = tmp_path_factory.mktemp("resunet_ckpt")
    out = {}
    for name in ("fcgf", "gcl"):
        sd, _ = _golden(name)
        out[name] = d / f"{name}.pth"
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, out[name])
    return out


def _cloud(seed):
    rng = np.random.RandomState(seed)
    ground = np.c_[rng.uniform(-12, 12, (2500, 2)), rng.normal(0, 0.03, 2500)]
    box = np.c_[rng.uniform(2, 5, (700, 1)), rng.uniform(-3, 0, (700, 1)), rng.uniform(0, 2.5, (700, 1))]
    return np.concatenate([ground, box]).astype(np.float32)


@pytest.mark.parametrize("name", ["fcgf", "gcl"])
def test_extractor_matches_jax_with_one_checkpoint(name, checkpoints, monkeypatch):
    env = f"VFMREG_{name.upper()}_WEIGHTS"
    monkeypatch.setenv(env, str(checkpoints[name]))
    jmod, jfn = {"fcgf": (jfcgf, jfcgf.extract_fcgf_features), "gcl": (jgcl, jgcl.extract_gcl_features)}[name]
    tfn = {"fcgf": tfcgf.extract_fcgf_features, "gcl": tgcl.extract_gcl_features}[name]
    monkeypatch.setattr(jmod, "_PARAMS", None)
    pcl = _cloud(7)
    jp, jf = jfn(pcl, 0.3)
    tp, tf = tfn(pcl, 0.3, device="cpu")
    assert tp.dtype == jp.dtype == np.float32 and tf.dtype == jf.dtype == np.float64
    np.testing.assert_array_equal(tp, jp)
    err = float(np.abs(tf - jf).max())
    print(f"{name}: extractor max abs error {err:.3g} over {len(tp)} voxels")
    assert err <= ATOL and tf.shape == (len(tp), 32)
    # The file's weights, not the seeded ones: the golden network's output.
    sd, _ = _golden(name)
    coords, _ = tfcgf.sparse_quantize(pcl, 0.3)
    want = _forward(tres.load_me_state_dict(sd, CONFIGS[name][0], device="cpu"), coords,
                    np.ones((len(coords), 1), np.float32), np.ones(len(coords), bool))
    np.testing.assert_array_equal(tf, want.astype(np.float64))


def test_sparse_quantize_and_registry_match_reference():
    rng = np.random.RandomState(1)
    pcl = rng.uniform(-30, 30, (5000, 3)).astype(np.float32)
    for v in (0.3, 1.0, 2.5):
        tc, ti = tfcgf.sparse_quantize(pcl, v)
        jc, ji = jfcgf.sparse_quantize(pcl, v)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ti, ji)
    assert tc.dtype == np.int32 and (np.diff(ti) > 0).all()
    with pytest.raises(ValueError, match="2\\^20"):
        tfcgf.sparse_quantize(np.array([[2e6, 0.0, 0.0]]), 1.0)
    assert set(tres.MODEL_REGISTRY) == set(jres.MODEL_REGISTRY)
    for k, cfg in tres.MODEL_REGISTRY.items():
        j = jres.MODEL_REGISTRY[k]
        assert (cfg.channels, cfg.tr_channels, cfg.conv1_kernel_size) == (j.channels, j.tr_channels,
                                                                         j.conv1_kernel_size)
    assert tres.load_model("ResUNetFatBN") is tres.GCL_CONFIG
    with pytest.raises(ValueError, match="Unknown model"):
        tres.load_model("nope")


def test_loader_layouts_and_seeded_init():
    sd, g = _golden("fcgf")
    sd3 = {k: (v[None] if k in ("conv1_tr.kernel", "final.kernel") else v) for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    a = tres.load_me_state_dict(sd, tres.FCGF_CONFIG, device="cpu").state_dict()
    b = tres.load_me_state_dict(sd3, tres.FCGF_CONFIG, device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(KeyError, match="lacks"):
        tres.load_me_state_dict({k: v for k, v in sd.items() if k != "block2.conv1.kernel"}, tres.FCGF_CONFIG,
                                device="cpu")
    nets = [tres.init_resunet_params(torch.Generator().manual_seed(0), tres.FCGF_CONFIG, device="cpu")
            for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(nets[0].state_dict().values(), nets[1].state_dict().values()))
    w = nets[0].block2.conv1.kernel
    assert w.shape == (27, 64, 64) and abs(float(w.detach().std()) - np.sqrt(2.0 / (27 * 64))) < 0.01
    rng = np.random.RandomState(2)
    coords = rng.randint(0, 20, (256, 3)).astype(np.int32)
    feats, mask = np.ones((256, 1), np.float32), np.ones(256, bool)
    out0 = _forward(nets[0], coords, feats, mask)
    out1 = _forward(nets[0], coords + 8 * 5, feats, mask)  # a multiple of the stride pyramid
    np.testing.assert_allclose(out0, out1, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out0, axis=1), 1.0, atol=1e-4)
