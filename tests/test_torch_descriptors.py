"""Parity of the port's descriptor pass with `vfmreg_tpu`.

Inputs are made with numpy from a seed; the ViT weights are the reference's
`init_vit_params` (a small config) converted by `vit_params_from_numpy`.

* `preprocess_image` at the real 1232 x 1616 -> 224 x 280 shape (jax.image
  bilinear without antialiasing against F.interpolate with
  align_corners=False): atol 1e-5;
* `sample_patch_features` at random pixels, edges included: atol 1e-5
  (XLA's CPU compiler fuses the source-coordinate map into an FMA, so the
  coordinate can differ by one ulp of ~15, about 1e-6, which the unit-normal
  patch gradient carries into the value);
* `ImageFeatureGenerator.get_image_features` with and without upsampling,
  and its `.npy` cache naming: atol 1e-4;
* `create_descriptors` on `SyntheticCameraRig` (five overlapping cameras,
  black hood rows) over ~2,000 points: the rows with a descriptor must be
  the same rows, and the values within atol 1e-4 (the two ViTs sum in
  different orders). The case must contain points seen by two cameras whose
  descriptors differ (first wins) and points whose first pixel is empty.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests_vit_config import SMALL_VIT  # noqa: E402
from vfmreg_tpu.models import image_features as jif  # noqa: E402
from vfmreg_tpu.models.vit import init_vit_params  # noqa: E402
from vfmreg_tpu.ops.projection import sample_patch_features as jax_sample  # noqa: E402
from vfmreg_tpu.pipeline.prepare_scenes import create_descriptors as jax_create  # noqa: E402
from vfmreg_tpu_torch.convert import vit_params_from_numpy  # noqa: E402
from vfmreg_tpu_torch.models import image_features as tif  # noqa: E402
from vfmreg_tpu_torch.models.vit import ViTConfig  # noqa: E402
from vfmreg_tpu_torch.ops.projection import sample_patch_features  # noqa: E402
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud  # noqa: E402

PORT_SMALL = ViTConfig(**{f.name: getattr(SMALL_VIT, f.name) for f in dataclasses.fields(ViTConfig)
                          if hasattr(SMALL_VIT, f.name)})


@pytest.fixture(scope="module")
def generators():
    params = init_vit_params(jax.random.PRNGKey(3), SMALL_VIT)
    jgen = jif.ImageFeatureGenerator("dinov2", params=params, config=SMALL_VIT)
    sd = vit_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), PORT_SMALL)
    tgen = tif.ImageFeatureGenerator("dinov2", params=sd, config=PORT_SMALL, device="cpu")
    return jgen, tgen


def test_preprocess_image_matches_jax_at_full_size():
    img = np.random.RandomState(0).randint(0, 256, (1232, 1616, 3)).astype(np.uint8)
    ref, hw_ref = jif.preprocess_image(img, 14, 16)
    got, hw = tif.preprocess_image(img, 14, 16, device="cpu")
    assert hw == hw_ref == (1232, 1616) and tuple(got.shape) == ref.shape == (1, 224, 280, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_sample_patch_features_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.normal(size=(16, 20, 24)).astype(np.float32)
    u = np.r_[rng.randint(0, 1616, 500), 0, 1615, 0, 1615]
    v = np.r_[rng.randint(0, 1232, 500), 0, 1231, 1231, 0]
    ref = np.asarray(jax_sample(jnp.asarray(feats), jnp.asarray(u), jnp.asarray(v), 1232, 1616))
    got = sample_patch_features(torch.from_numpy(feats), torch.from_numpy(u), torch.from_numpy(v), 1232, 1616)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("upsample", [False, True])
def test_image_features_match_jax(generators, upsample):
    jgen, tgen = generators
    img = np.random.RandomState(2).randint(0, 256, (112, 140, 3)).astype(np.uint8)
    ref = jgen.get_image_features(img, upsample=upsample)
    got = tgen.get_image_features(img, upsample=upsample)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert got.shape == ((112, 140, 32) if upsample else (16, 20, 32))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_feature_cache_naming(generators, tmp_path):
    _, tgen = generators
    img = np.random.RandomState(4).randint(0, 256, (56, 56, 3)).astype(np.uint8)
    f1 = tgen.get_image_features(img, cache_file=tmp_path / "img0.npy")
    path = tmp_path / "img0_False_False.npy"
    assert path.exists()
    np.save(path, np.full_like(f1, 7.25))  # the next call must read the cache
    np.testing.assert_array_equal(tgen.get_image_features(img, cache_file=tmp_path / "img0.npy"),
                                  np.full_like(f1, 7.25))


def test_pca_to_rgb_matches_jax():
    feats = np.random.RandomState(6).normal(size=(300, 32)).astype(np.float32)
    feats[:7] = 0.0
    ref, jfit = jif.pca_to_rgb(feats)
    got, fit = tif.pca_to_rgb(feats)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0
    again, _ = tif.pca_to_rgb(feats[::-1], fit_pca=fit)  # a kept fit projects the same way
    np.testing.assert_allclose(again[::-1], got, atol=1e-6, rtol=0)


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="Unsupported foundation model"):
        tif.ImageFeatureGenerator("sam", device="cpu")


def test_create_descriptors_matches_jax(generators):
    jgen, tgen = generators
    rig = SyntheticCameraRig(seed=5)
    pcl = make_rig_cloud(2048, seed=5)
    files = [f"scan0/{cam}.png" for cam in rig.cameras]
    ref = jax_create(files, rig, jgen, pcl)
    got = create_descriptors(files, rig, tgen, pcl)
    assert got.shape == ref.shape == (2048, 32) and got.dtype == np.float32
    covered = np.any(got != 0, axis=1)
    np.testing.assert_array_equal(covered, np.any(ref != 0, axis=1))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    seen, first_empty = rig.coverage(pcl, rig.read_images(files))
    assert (seen >= 2).sum() > 20 and first_empty.sum() > 20 and (seen == 0).sum() > 20
    np.testing.assert_array_equal(covered, (seen > 0) & ~first_empty)
    # First wins: a point two cameras see keeps the first camera's sample,
    # which a later camera's would not reproduce.
    pcl_h = np.insert(pcl, 3, values=1, axis=1).T
    images = rig.read_images(files)
    cam0, cam1 = rig.cameras[:2]
    _, _, i0 = rig.project_pcl_to_image(pcl_h, images[cam0], cam0)
    u1, v1, i1 = rig.project_pcl_to_image(pcl_h, images[cam1], cam1)
    both = np.isin(i1, i0) & covered[i1]
    assert both.sum() > 5
    second = sample_patch_features(torch.from_numpy(tgen.get_image_features(images[cam1])),
                                   torch.from_numpy(u1[both]), torch.from_numpy(v1[both]),
                                   rig.height, rig.width).numpy()
    assert np.abs(second - got[i1[both]]).max() > 1e-2
