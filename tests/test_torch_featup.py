"""Parity of the port's FeatUp upsamplers (`vfmreg_tpu_torch.models.featup`) and
the generator's upsampling and PCA paths with `vfmreg_tpu`.

Inputs are made with numpy from a seed; the learned stack's parameters are
the reference's `init_jbu_stack_params` converted by
`convert.jbu_stack_params_from_numpy`.

* the exact torch-bicubic x2 and the adaptive-average-pool matrices at odd
  sizes, against the reference's and against `F.interpolate` /
  `F.adaptive_avg_pool2d` themselves; the guidance's area-average resize
  against `jax.image.resize(method="linear")`: atol 1e-5;
* the classical `jbu_upsample` (its default and radius 2) and the learned
  `jbu_stack_upsample`: atol 2e-5 (f32 sums in different orders over
  features of unit scale);
* the hub checkpoint loader, with and without the `upsampler.` prefix:
  exactly the state dict that the reference's loader and the converter give;
* `ImageFeatureGenerator(use_featup=True)` at `tests_vit_config.SMALL_VIT`
  with the learned stack (parameters passed, and read from
  `VFMREG_FEATUP_WEIGHTS`) and without parameters (classical JBU), against
  the JAX generator: atol 2e-4 (the ViTs' bar, tests/test_vit.py);
* `get_image_features_pca` and `run_pca` with a fit file: the same images
  (uint8 RGB may differ by one level where the ViTs' last bits differ)
  and the fit reloaded from the file.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests_vit_config import SMALL_VIT  # noqa: E402
from vfmreg_tpu.models import featup as jfu  # noqa: E402
from vfmreg_tpu.models import image_features as jif  # noqa: E402
from vfmreg_tpu.models.vit import init_vit_params  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.models import featup as tfu  # noqa: E402
from vfmreg_tpu_torch.models import image_features as tif  # noqa: E402
from vfmreg_tpu_torch.models.vit import ViTConfig  # noqa: E402

PORT_SMALL = ViTConfig(**{f.name: getattr(SMALL_VIT, f.name) for f in dataclasses.fields(ViTConfig)
                          if hasattr(SMALL_VIT, f.name)})
UP_ATOL, GEN_ATOL = 2e-5, 2e-4


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _hub_state_dict(params, prefix="upsampler."):
    """The reference's stack pytree in the FeatUp hub layout (test_vit.py's
    recipe)."""
    sd = {}
    for i, st in enumerate(_tree(params)["stages"], start=1):
        p = f"{prefix}up{i}."
        sd[p + "range_temp"] = np.asarray(st["range_temp"])
        sd[p + "sigma_spatial"] = np.asarray(st["sigma_spatial"])
        sd[p + "range_proj.0.weight"] = st["proj1_w"].T[:, :, None, None]
        sd[p + "range_proj.0.bias"] = st["proj1_b"]
        sd[p + "range_proj.3.weight"] = st["proj2_w"].T[:, :, None, None]
        sd[p + "range_proj.3.bias"] = st["proj2_b"]
    sd[prefix + "fixup_proj.1.weight"] = np.asarray(params["fixup_w"]).T[:, :, None, None]
    sd[prefix + "fixup_proj.1.bias"] = np.asarray(params["fixup_b"])
    return sd


def _perturbed_stack_params(key, d):
    """`init_jbu_stack_params` with temperatures, sigmas and biases moved off
    their init values, so that every parameter reaches the output."""
    params = jfu.init_jbu_stack_params(key, d)
    rng = np.random.RandomState(d)
    for st in params["stages"]:
        st["range_temp"] = jnp.asarray(rng.uniform(-0.5, 0.5), jnp.float32)
        st["sigma_spatial"] = jnp.asarray(rng.uniform(0.6, 1.4), jnp.float32)
        st["proj1_b"] = jnp.asarray(rng.normal(size=st["proj1_b"].shape) * 0.1, jnp.float32)
        st["proj2_b"] = jnp.asarray(rng.normal(size=st["proj2_b"].shape) * 0.1, jnp.float32)
    params["fixup_b"] = jnp.asarray(rng.normal(size=(d,)) * 0.1, jnp.float32)
    return params


@pytest.mark.parametrize("h,w", [(5, 7), (1, 3), (16, 20)])
def test_bicubic_x2_matches_reference_and_torch(h, w):
    x = np.random.RandomState(h * w).normal(size=(h, w, 6)).astype(np.float32)
    got = tfu._bicubic_x2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfu._bicubic_x2(jnp.asarray(x))), atol=1e-5, rtol=0)
    ref = F.interpolate(torch.from_numpy(x).permute(2, 0, 1)[None], scale_factor=2, mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,out", [((13, 21), (6, 10)), ((7, 9), (10, 13)), ((224, 280), (32, 40))])
def test_adaptive_pool_matches_reference_and_torch(hw, out):
    x = np.random.RandomState(hw[0]).normal(size=(*hw, 3)).astype(np.float32)
    got = tfu._adaptive_avg_pool(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, np.asarray(jfu._adaptive_avg_pool(jnp.asarray(x), *out)), atol=1e-5, rtol=0)
    ref = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(2, 0, 1), out).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(1232, 16), (61, 7), (9, 9), (5, 12)])
def test_linear_resize_matrix_matches_jax(n_in, n_out):
    x = np.random.RandomState(n_in).uniform(size=(n_in, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, 4), method="linear"))
    got = (tfu._linear_resize_matrix(n_in, n_out) @ torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,out,radius", [((5, 6), (61, 83), 1), ((16, 20), (120, 150), 1), ((4, 4), (37, 29), 2)])
def test_jbu_upsample_matches_jax(hw, out, radius):
    rng = np.random.RandomState(out[0])
    feats = rng.normal(size=(*hw, 8)).astype(np.float32)
    guide = rng.uniform(size=(*out, 3)).astype(np.float32)
    ref = np.asarray(jfu.jbu_upsample(jnp.asarray(feats), jnp.asarray(guide), *out, radius=radius))
    got = tfu.jbu_upsample(torch.from_numpy(feats), torch.from_numpy(guide), *out, radius=radius).numpy()
    assert got.shape == (*out, 8)
    np.testing.assert_allclose(got, ref, atol=UP_ATOL, rtol=0)
    image = (guide * 255).astype(np.uint8)
    np.testing.assert_allclose(tfu.upsample_features(feats, image, radius=radius, device="cpu"),
                               np.asarray(jfu.upsample_features(feats, image, radius=radius)), atol=UP_ATOL, rtol=0)


@pytest.mark.parametrize("hw,guide_hw,d", [((3, 5), (42, 70), 24), ((16, 20), (224, 280), 32)])
def test_jbu_stack_matches_jax(hw, guide_hw, d):
    params = _perturbed_stack_params(jax.random.PRNGKey(d), d)
    rng = np.random.RandomState(d)
    src = rng.normal(size=(*hw, d)).astype(np.float32)
    guide = rng.normal(size=(*guide_hw, 3)).astype(np.float32)
    ref = np.asarray(jfu.jbu_stack_upsample(params, jnp.asarray(src), jnp.asarray(guide)))
    stack = tfu.stack_from_state_dict(convert.jbu_stack_params_from_numpy(_tree(params)), device="cpu")
    got = tfu.jbu_stack_upsample(stack, torch.from_numpy(src), torch.from_numpy(guide)).numpy()
    assert got.shape == (16 * hw[0], 16 * hw[1], d)
    np.testing.assert_allclose(got, ref, atol=UP_ATOL, rtol=0)
    # One stage on its own.
    g1 = np.asarray(jfu._adaptive_avg_pool(jnp.asarray(guide), 2 * hw[0], 2 * hw[1]))
    ref1 = np.asarray(jfu.jbu_learned_one(params["stages"][0], jnp.asarray(src), jnp.asarray(g1)))
    with torch.no_grad():
        got1 = stack.up1(torch.from_numpy(src), torch.from_numpy(g1)).numpy()
    np.testing.assert_allclose(got1, ref1, atol=UP_ATOL, rtol=0)


def test_init_jbu_stack_scales():
    stack = tfu.init_jbu_stack(64, torch.Generator().manual_seed(0), device="cpu")
    w = stack.fixup_proj["1"].weight
    assert tuple(w.shape) == (64, 64, 1, 1) and abs(float(w.detach().std()) - 0.02) < 2e-3
    assert float(stack.up1.range_temp) == 0.0 and float(stack.up4.sigma_spatial) == 1.0
    assert abs(float(stack.up2.range_proj["0"].weight.detach().std()) - 0.2) < 0.05


@pytest.mark.parametrize("prefix", ["upsampler.", ""])
def test_featup_loader_matches_reference(prefix):
    params = _perturbed_stack_params(jax.random.PRNGKey(5), 12)
    sd = _hub_state_dict(params, prefix)
    want = convert.jbu_stack_params_from_numpy(_tree(jfu.load_featup_state_dict(sd)))
    got = tfu.load_featup_state_dict(sd)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    got_t = tfu.load_featup_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert all(torch.equal(got_t[k], want[k]) for k in want)
    tfu.stack_from_state_dict(got, device="cpu")


@pytest.fixture(scope="module")
def vit_params():
    params = init_vit_params(jax.random.PRNGKey(3), SMALL_VIT)
    return params, convert.vit_params_from_numpy(_tree(params), PORT_SMALL)


IMG = np.random.RandomState(2).randint(0, 256, (112, 140, 3)).astype(np.uint8)


@pytest.mark.parametrize("source", ["params", "env", "none"])
def test_featup_generator_matches_jax(vit_params, source, tmp_path, monkeypatch):
    jparams, tparams = vit_params
    stack = _perturbed_stack_params(jax.random.PRNGKey(9), SMALL_VIT.hidden_size)
    jfp = tfp = None
    if source == "params":
        jfp, tfp = stack, convert.jbu_stack_params_from_numpy(_tree(stack))
    if source == "env":
        path = tmp_path / "featup_jbu_stack.pt"
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in _hub_state_dict(stack).items()}, path)
        monkeypatch.setenv("VFMREG_FEATUP_WEIGHTS", str(path))
    else:
        monkeypatch.delenv("VFMREG_FEATUP_WEIGHTS", raising=False)
    jgen = jif.ImageFeatureGenerator("dinov2", use_featup=True, params=jparams, config=SMALL_VIT, featup_params=jfp)
    tgen = tif.ImageFeatureGenerator("dinov2", use_featup=True, params=tparams, config=PORT_SMALL,
                                     featup_params=tfp, device="cpu")
    ref = jgen.get_image_features(IMG, upsample=True)
    got = tgen.get_image_features(IMG, upsample=True)
    assert got.shape == ref.shape == (112, 140, SMALL_VIT.hidden_size)
    np.testing.assert_allclose(got, ref, atol=GEN_ATOL, rtol=0)
    assert (tgen._featup_stack is None) == (source == "none")
    # Without upsampling the patch grid is the same as use_featup=False's.
    np.testing.assert_allclose(tgen.get_image_features(IMG), jgen.get_image_features(IMG), atol=GEN_ATOL, rtol=0)


def test_pca_paths_match_jax(vit_params, tmp_path):
    jparams, tparams = vit_params
    jgen = jif.ImageFeatureGenerator("dinov2", params=jparams, config=SMALL_VIT, pca_fit_file=tmp_path / "j.pkl")
    tgen = tif.ImageFeatureGenerator("dinov2", params=tparams, config=PORT_SMALL, pca_fit_file=tmp_path / "t.pkl",
                                     device="cpu")
    f_ref, rgb_ref = jgen.get_image_features_pca(IMG, upsample=True)
    f_got, rgb_got = tgen.get_image_features_pca(IMG, upsample=True)
    np.testing.assert_allclose(f_got, f_ref, atol=GEN_ATOL, rtol=0)
    assert rgb_got.dtype == np.uint8 and rgb_got.shape == (112, 140, 3)
    assert np.abs(rgb_got.astype(int) - rgb_ref.astype(int)).max() <= 1
    _, proj5 = tgen.get_image_features_pca(IMG, n_components=5)
    assert proj5.dtype == np.float32 and proj5.shape == (16, 20, 5) and set(tgen.fit_pca) == {3, 5}

    points = np.random.RandomState(4).normal(size=(200, SMALL_VIT.hidden_size)).astype(np.float32)
    points[:9] = 0.0
    got = tgen.run_pca(points, refit_pca=True)
    ref = jgen.run_pca(points, refit_pca=True)
    assert got.dtype == np.uint8 and np.all(got[:9] == 0)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # The refit is pickled; a new generator reads it back and projects alike.
    assert (tmp_path / "t.pkl").exists()
    again = tif.ImageFeatureGenerator("dinov2", params=tparams, config=PORT_SMALL, pca_fit_file=tmp_path / "t.pkl",
                                      device="cpu")
    assert set(again.fit_pca) == {3, 5}
    np.testing.assert_array_equal(again.run_pca(points), got)
    np.testing.assert_array_equal(again.run_pca(points[::-1])[::-1], got)
