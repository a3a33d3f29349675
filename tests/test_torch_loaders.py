"""Parity of the port's dataset loaders and scene preparation
(`vfmreg_tpu_torch.data.*`, `vfmreg_tpu_torch.pipeline.prepare_scenes`) with
`vfmreg_tpu`, on synthetic dataset trees.

* `robotcar_sdk`: SE(3) / Euler / quaternion helpers (every trace branch),
  pose interpolation from lists and from an INS file, the bilinear demosaic
  for both Bayer patterns, `CameraModel` (intrinsics, LUT, undistort,
  project) and `load_image`: equal to the reference's bit for bit (the same
  numpy arithmetic);
* `NCLT` on the mini dataset of `tests/test_data.py` (its `mini_nclt`
  fixture, rebuilt once per module): undistorted, cropped and rotated images
  (also uncropped and subsampled), clouds, poses and projections equal;
* `OxfordRobotcar` and `KittiOdometry` on `tests/test_dataloaders.py`'s
  synthetic trees (one tree per package, so each runs its own caches):
  timestamps, poses, clouds, images and projections equal; KITTI's scan
  correction within 1e-5 m (both in f32, the reference through XLA);
* the 50 shipped scene specs load and validate to the same dicts, and the
  spec writers and `update_release_gt_pose` write the same files;
* `prepare_scene` on the mini NCLT scene with `tests_vit_config.SMALL_VIT`
  and with a tiny MaskCLIP with the 512-d head: the written file, read back
  by the port's `h5io.read_scenes`, holds the voxel-downsampled clouds, and
  their descriptors match the JAX `create_descriptors` on the same frames
  and weights through NCLT's rotated-camera branch: the same rows covered,
  values within atol 2e-4 (the ViTs' bar, tests/test_vit.py); and `main`.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

import jax  # noqa: E402

from test_dataloaders import _make_kitti_tree, _make_robotcar_tree  # noqa: E402
from tests_vit_config import SMALL_VIT  # noqa: E402
from vfmreg_tpu.data import kitti_odometry as jkitti  # noqa: E402
from vfmreg_tpu.data import nclt as jnclt  # noqa: E402
from vfmreg_tpu.data import oxford_robotcar as jrc  # noqa: E402
from vfmreg_tpu.data import robotcar_sdk as jsdk  # noqa: E402
from vfmreg_tpu.data import scene as jscene  # noqa: E402
from vfmreg_tpu.models import image_features as jif  # noqa: E402
from vfmreg_tpu.models.maskclip import MaskCLIPConfig as JMaskCLIPConfig  # noqa: E402
from vfmreg_tpu.models.maskclip import init_maskclip_params  # noqa: E402
from vfmreg_tpu.models.vit import init_vit_params  # noqa: E402
from vfmreg_tpu.pipeline.prepare_scenes import create_descriptors as jax_create  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.data import h5io  # noqa: E402
from vfmreg_tpu_torch.data import kitti_odometry as tkitti  # noqa: E402
from vfmreg_tpu_torch.data import nclt as tnclt  # noqa: E402
from vfmreg_tpu_torch.data import oxford_robotcar as trc  # noqa: E402
from vfmreg_tpu_torch.data import robotcar_sdk as tsdk  # noqa: E402
from vfmreg_tpu_torch.data import scene as tscene  # noqa: E402
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample  # noqa: E402
from vfmreg_tpu_torch.models import image_features as tif  # noqa: E402
from vfmreg_tpu_torch.models.maskclip import MaskCLIPConfig  # noqa: E402
from vfmreg_tpu_torch.models.vit import ViTConfig  # noqa: E402
from vfmreg_tpu_torch.pipeline import prepare_scenes  # noqa: E402

DESC_ATOL = 2e-4
NCLT_CAMS = ("Cam1", "Cam2", "Cam3", "Cam4", "Cam5")


def _equal_nested(a, b):
    """Equal dicts / lists / arrays / scalars, arrays bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_nested(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_nested(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------- robotcar_sdk
def test_robotcar_sdk_transforms_match_reference():
    rng = np.random.RandomState(0)
    for _ in range(20):
        xyzrpy = rng.uniform(-1.4, 1.4, 6)
        T = tsdk.build_se3_transform(xyzrpy)
        np.testing.assert_array_equal(T, jsdk.build_se3_transform(xyzrpy))
        np.testing.assert_array_equal(tsdk.so3_to_euler(T[:3, :3]), jsdk.so3_to_euler(T[:3, :3]))
    from scipy.spatial.transform import Rotation as R

    rots = list(R.random(20, random_state=1).as_matrix())
    rots += [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]  # trace < 0
    for m in rots:
        np.testing.assert_array_equal(tsdk.so3_to_quaternion(m), jsdk.so3_to_quaternion(m))
        np.testing.assert_array_equal(tsdk._quaternion_to_matrix(tsdk.so3_to_quaternion(m)),
                                      jsdk._quaternion_to_matrix(jsdk.so3_to_quaternion(m)))
    with pytest.raises(ValueError):
        tsdk.build_se3_transform([0.0] * 5)


def test_robotcar_sdk_interpolation_matches_reference(tmp_path):
    rng = np.random.RandomState(2)
    ts = np.cumsum(rng.randint(50, 150, 12)).astype(np.int64) + 1_000_000
    poses = [jsdk.build_se3_transform(np.r_[rng.normal(size=3), rng.uniform(-1, 1, 3)]) for _ in ts]
    poses[5] = poses[4].copy()  # nearly-parallel quaternions take the linear branch
    req = list(rng.randint(ts[0], ts[-1], 15))
    _equal_nested(tsdk.interpolate_poses(ts, poses, req, int(ts[2])),
                  jsdk.interpolate_poses(ts, poses, req, int(ts[2])))
    rows = ["timestamp,a,b,c,d,northing,easting,down,e,f,g,h,i,roll,pitch,yaw"]
    for t in ts:
        v = rng.normal(size=8)
        rows.append(f"{t},0,0,0,0," + ",".join(str(x) for x in v[:3]) + ",0,0,0," + ",".join(str(x) for x in v[3:]))
    (tmp_path / "ins.csv").write_text("\n".join(rows) + "\n")
    for rtk in (False, True):
        _equal_nested(tsdk.interpolate_ins_poses(tmp_path / "ins.csv", req[:6], int(ts[1]), use_rtk=rtk),
                      jsdk.interpolate_ins_poses(tmp_path / "ins.csv", req[:6], int(ts[1]), use_rtk=rtk))


def test_robotcar_sdk_images_match_reference(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(3)
    raw = rng.randint(0, 256, (12, 18)).astype(np.uint8)
    for pattern in ("RGGB", "GBRG"):
        np.testing.assert_array_equal(tsdk.demosaic_bilinear(raw, pattern), jsdk.demosaic_bilinear(raw, pattern))
    np.testing.assert_array_equal(tsdk.demosaic_bilinear(np.dstack([raw] * 3)), jsdk.demosaic_bilinear(raw))

    h, w = 12, 18
    (tmp_path / "mono_left.txt").write_text("20.0 21.0 9.0 6.0\n" + "\n".join(
        " ".join(str(float(i == j)) for j in range(4)) for i in range(4)) + "\n")
    u = np.tile(np.arange(w, dtype=np.float64), h) + rng.uniform(-0.4, 0.4, h * w)
    v = np.repeat(np.arange(h, dtype=np.float64), w) + rng.uniform(-0.4, 0.4, h * w)
    np.concatenate([u, v]).tofile(tmp_path / "mono_left_distortion_lut.bin")
    tcam, jcam = tsdk.CameraModel(tmp_path, "mono_left"), jsdk.CameraModel(tmp_path, "mono_left")
    assert tcam.focal_length == jcam.focal_length and tcam.principal_point == jcam.principal_point
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tcam.undistort(img), jcam.undistort(img))
    xyz = np.r_[rng.uniform(-2, 2, (2, 40)), rng.uniform(-1, 5, (1, 40))]
    _equal_nested(tcam.project(xyz, (h, w)), jcam.project(xyz, (h, w)))
    Image.fromarray(raw, mode="L").save(tmp_path / "raw.png")
    np.testing.assert_array_equal(tsdk.load_image(tmp_path / "raw.png", None, "GBRG"),
                                  jsdk.load_image(tmp_path / "raw.png", None, "GBRG"))
    np.testing.assert_array_equal(tsdk.load_image(tmp_path / "raw.png", tcam, "RGGB"),
                                  jsdk.load_image(tmp_path / "raw.png", jcam, "RGGB"))


# ------------------------------------------------------------------- NCLT
@pytest.fixture(scope="module")
def mini_nclt(tmp_path_factory):
    """`tests/test_data.py`'s mini NCLT dataset (five cameras, two frames),
    built once for the module."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("data") / "nclt"
    seq = "2012-01-08"
    cam_params = root / "cam_params"
    cam_params.mkdir(parents=True)

    H, W = 1232, 1616
    for cam in NCLT_CAMS:
        # Identity-ish undistortion map (subsampled grid, SDK format).
        with open(cam_params / f"U2D_{cam}_1616X1232.txt", "w") as f:
            f.write(f"{W},{H}\n")
            for r in range(0, H, 8):
                for c in range(0, W, 8):
                    f.write(f"{r} {c} {float(r)} {float(c)}\n")
        cid = cam[-1]
        K = np.array([[400.0, 0, 808], [0, 400.0, 616], [0, 0, 1]])
        np.savetxt(cam_params / f"K_cam{cid}.csv", K, delimiter=",")
        np.savetxt(cam_params / f"x_lb3_c{cid}.csv", np.r_[rng.uniform(-0.1, 0.1, 3), [0.0, 0.0, 72.0 * int(cid)]])

    ts = [1326030000000000, 1326030001000000]
    for c in NCLT_CAMS:
        d = root / "images" / seq / "lb3" / c
        d.mkdir(parents=True)
        for t in ts:
            cv2.imwrite(str(d / f"{t}.tiff"), rng.randint(30, 255, (H, W, 3), dtype=np.uint8))

    pcl_dir = root / "velodyne_data" / seq / "velodyne_sync"
    pcl_dir.mkdir(parents=True)
    for t in ts:
        pts = rng.uniform(-30, 30, (500, 3))
        data = np.zeros((500, 4), dtype=np.int16)
        data[:, :3] = np.round((pts + 100.0) / 0.005).astype(np.int16)
        data.tofile(pcl_dir / f"{t}.bin")

    gt_dir = root / "ground_truth"
    gt_dir.mkdir(parents=True)
    with open(gt_dir / f"groundtruth_{seq}.csv", "w") as f:
        f.write("utime,x,y,z,r,p,h\n")
        for i, t in enumerate([ts[0] - 1000, ts[0] + 500000, ts[1] + 1000]):
            f.write(f"{t},{i * 1.0},0.0,0.0,0.0,0.0,0.0\n")
    return root, seq, ts


@pytest.fixture(scope="module")
def nclt_pair(mini_nclt):
    root, seq, _ = mini_nclt
    return jnclt.NCLT(seq, root), tnclt.NCLT(seq, root)


def test_nclt_matches_reference(nclt_pair, mini_nclt):
    jds, tds = nclt_pair
    root, seq, ts = mini_nclt
    assert len(tds) == len(jds) == 2 and tds.cameras == jds.cameras
    _equal_nested(tds.timestamps_abs, jds.timestamps_abs)
    _equal_nested(tds.timestamps, jds.timestamps)
    _equal_nested(tds.calib, jds.calib)
    _equal_nested(tds.camera_parameters, jds.camera_parameters)
    _equal_nested(tds.undistortion_maps, jds.undistortion_maps)
    _equal_nested(tds.read_poses(), jds.read_poses())
    _equal_nested(tds.read_poses(absolute_poses=True, interpolate_pcl=False),
                  jds.read_poses(absolute_poses=True, interpolate_pcl=False))
    _equal_nested(tds.read_image_files(1), jds.read_image_files(1))
    for i in range(2):
        np.testing.assert_array_equal(tds.read_pcl(i), jds.read_pcl(i))
    images = tds.read_images(0)
    _equal_nested(images, jds.read_images(0))
    assert images["Cam1"].shape == (700, 820, 3)
    files = [root / "images" / seq / "lb3" / c / f"{ts[1]}.tiff" for c in NCLT_CAMS]
    _equal_nested(tds.read_images(filenames=files, crop=False), jds.read_images(filenames=files, crop=False))

    pcl_h = np.insert(tds.read_pcl(0), 3, values=1, axis=1).T
    n_seen = 0
    for cam, image in images.items():
        unrotated = np.rot90(image, k=1, axes=(0, 1))
        got, want = tds.project_pcl_to_image(pcl_h, unrotated, cam), jds.project_pcl_to_image(pcl_h, unrotated, cam)
        _equal_nested(got, want)
        n_seen += len(got[2])
    assert n_seen > 20


def test_nclt_subsampled_matches_reference(mini_nclt):
    root, seq, _ = mini_nclt
    jds, tds = jnclt.NCLT(seq, root, image_subsample=3), tnclt.NCLT(seq, root, image_subsample=3)
    images = tds.read_images(1)
    _equal_nested(images, jds.read_images(1))
    assert images["Cam2"].shape == (233, 273, 3)
    pcl_h = np.insert(tds.read_pcl(1), 3, values=1, axis=1).T
    for cam, image in images.items():
        unrotated = np.rot90(image, k=1, axes=(0, 1))
        _equal_nested(tds.project_pcl_to_image(pcl_h, unrotated, cam), jds.project_pcl_to_image(pcl_h, unrotated, cam))


# ------------------------------------------------------- RobotCar, KITTI
def test_oxford_robotcar_matches_reference(tmp_path):
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / name
        seq = _make_robotcar_tree(roots[name])
    kw = {n: dict(models_dir=r / "models", extrinsics_dir=r / "extrinsics") for n, r in roots.items()}
    jds = jrc.OxfordRobotcar(seq, roots["jax"], **kw["jax"])
    tds = trc.OxfordRobotcar(seq, roots["port"], **kw["port"])
    assert len(tds) == len(jds) == 4
    _equal_nested(tds.timestamps_abs, jds.timestamps_abs)
    _equal_nested(tds.timestamps, jds.timestamps)
    _equal_nested(tds.calib, jds.calib)
    _equal_nested(tds.gt_poses, jds.gt_poses)
    _equal_nested(tds.read_poses(absolute_poses=True), jds.read_poses(absolute_poses=True))
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.read_pcl(i), jds.read_pcl(i))
    for i in (0, 2):
        _equal_nested(tds.read_images(i), jds.read_images(i))  # writes the undistorted-PNG cache
        _equal_nested(tds.read_images(i), jds.read_images(i))  # reads it
    names = [f.relative_to(roots["port"]) for f in tds.read_image_files(1).values()]
    _equal_nested(tds.read_images(filenames=[roots["port"] / n for n in names]),
                  jds.read_images(filenames=[roots["jax"] / n for n in names]))
    for cam in tds.cameras:
        assert (tds.img_undistorted_files[cam][0]).exists()
    rng = np.random.RandomState(5)
    pcl_h = np.r_[rng.uniform(-3, 3, (2, 300)), rng.uniform(-1, 8, (1, 300)), np.ones((1, 300))]
    img = tds.read_images(0)["stereo/centre"]
    for cam in tds.cameras:
        _equal_nested(tds.project_pcl_to_image(pcl_h, img, cam), jds.project_pcl_to_image(pcl_h, img, cam))
    high = trc.OxfordRobotcar(seq, roots["port"], high_level_api=True, **kw["port"])
    assert high.timestamps_abs is None and high.gt_poses is None
    _equal_nested(high.calib, tds.calib)


def test_kitti_odometry_matches_reference(tmp_path):
    _make_kitti_tree(tmp_path)
    jds, tds = jkitti.KittiOdometry(0, tmp_path), tkitti.KittiOdometry(0, tmp_path)
    assert len(tds) == len(jds) == 3 and tds.cameras == jds.cameras == ["camera"]
    _equal_nested(tds.calib, jds.calib)
    _equal_nested(tds.gt_poses, jds.gt_poses)
    _equal_nested(tds.timestamps, jds.timestamps)
    for i in range(3):
        got, want = tds.read_pcl(i), jds.read_pcl(i)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (500, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        _equal_nested(tds.read_images(i), jds.read_images(i))
    pcl_h = np.r_[np.random.RandomState(6).uniform(-2, 2, (2, 100)), np.full((1, 100), 5.0), np.ones((1, 100))]
    img = tds.read_images(0)["camera"]
    _equal_nested(tds.project_pcl_to_image(pcl_h, img, "camera"), jds.project_pcl_to_image(pcl_h, img, "camera"))
    half = tkitti.KittiOdometry(0, tmp_path, image_subsample=2)
    _equal_nested(half.read_images(1), jkitti.KittiOdometry(0, tmp_path, image_subsample=2).read_images(1))


# ------------------------------------------------------------ scene specs
@pytest.mark.parametrize("dataset", ["nclt", "robotcar"])
def test_shipped_scene_specs_match_reference(dataset):
    files = sorted((Path(__file__).resolve().parents[1] / "data" / dataset).glob("scene_*.json"))
    assert len(files) == 25
    for path in files:
        spec = tscene.load_scene_spec(path)
        _equal_nested(spec, jscene.load_scene_spec(path))
        tscene.validate_scene_spec(spec)


def test_scene_spec_writers_match_reference(tmp_path):
    rng = np.random.RandomState(7)
    poses = [np.eye(4) + np.pad(rng.normal(size=(3, 4)) * 0.01, ((0, 1), (0, 0))) for _ in range(3)]
    args = (["a/0.bin", "a/1.bin"], [["a/c0.png", "a/c1.png"]] * 2, poses[:2], ["b/0.bin"], [["b/c0.png"]],
            poses[2:])
    spec = tscene.make_scene_spec(*args)
    assert spec == jscene.make_scene_spec(*args)
    tscene.write_scene_spec(tmp_path / "port" / "scene.json", spec)
    jscene.write_scene_spec(tmp_path / "jax" / "scene.json", spec)
    tscene.update_release_gt_pose(tmp_path / "port" / "scene.json", 0, poses[0])
    jscene.update_release_gt_pose(tmp_path / "jax" / "scene.json", 0, poses[0])
    assert (tmp_path / "port" / "scene.json").read_bytes() == (tmp_path / "jax" / "scene.json").read_bytes()
    bad = json.loads(json.dumps(spec))
    bad["mapping"]["poses"] = bad["mapping"]["poses"][:1]
    for mod in (tscene, jscene):
        with pytest.raises(ValueError):
            mod.validate_scene_spec(bad)


# ---------------------------------------------------------- prepare_scene
def _scene_file(mini_nclt, path):
    _, seq, ts = mini_nclt
    scene = {
        "mapping": {
            "point_clouds": [f"velodyne_data/{seq}/velodyne_sync/{ts[0]}.bin"],
            "images": [[f"images/{seq}/lb3/{c}/{ts[0]}.tiff" for c in NCLT_CAMS]],
            "poses": [np.eye(4).tolist()],
        },
        "registration": [{
            "point_cloud": f"velodyne_data/{seq}/velodyne_sync/{ts[1]}.bin",
            "images": [f"images/{seq}/lb3/{c}/{ts[1]}.tiff" for c in NCLT_CAMS],
            "pose": np.diag([1.0, 1.0, 1.0, 1.0]).tolist(),
        }],
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(scene))
    return path


MASKCLIP_512 = JMaskCLIPConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=16, embed_dim=512,
                               pretrain_img_size=64)


def _generators(model):
    if model == "dinov2":
        params = init_vit_params(jax.random.PRNGKey(3), SMALL_VIT)
        pcfg = ViTConfig(**{f.name: getattr(SMALL_VIT, f.name) for f in dataclasses.fields(ViTConfig)
                            if hasattr(SMALL_VIT, f.name)})
        sd = convert.vit_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg)
        return (jif.ImageFeatureGenerator("dinov2", params=params, config=SMALL_VIT),
                tif.ImageFeatureGenerator("dinov2", params=sd, config=pcfg, device="cpu"))
    params = init_maskclip_params(jax.random.PRNGKey(4), MASKCLIP_512)
    pcfg = MaskCLIPConfig(**dataclasses.asdict(MASKCLIP_512))
    sd = convert.maskclip_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg)
    return (jif.ImageFeatureGenerator("maskclip", params=params, config=MASKCLIP_512),
            tif.ImageFeatureGenerator("maskclip", params=sd, config=pcfg, device="cpu"))


@pytest.mark.parametrize("model,width", [("dinov2", SMALL_VIT.hidden_size), ("maskclip", 512)])
def test_prepare_scene_matches_jax_descriptors(mini_nclt, nclt_pair, tmp_path, model, width):
    root, seq, ts = mini_nclt
    jds, _ = nclt_pair
    jgen, tgen = _generators(model)
    assert tgen.feature_size == width
    scene_file = _scene_file(mini_nclt, tmp_path / "scenes" / "scene_007.json")
    out = prepare_scenes.prepare_scene(root, scene_file, tmp_path / "processed", feature_generator=tgen)
    assert out == tmp_path / "processed" / "scene_007.h5"
    loaded = h5io.read_scenes(out)
    assert len(loaded["map_point_clouds"]) == len(loaded["scene_point_clouds"]) == 1
    np.testing.assert_array_equal(loaded["map_poses"][0], np.eye(4))

    for cloud, t, voxel in ((loaded["map_point_clouds"][0], ts[0], 0.2), (loaded["scene_point_clouds"][0], ts[1], 0.1)):
        pcl = jds.read_pcl(filename=root / "velodyne_data" / seq / "velodyne_sync" / f"{t}.bin")
        pcl = voxel_down_sample(pcl, voxel).astype(pcl.dtype)
        assert cloud.shape == (pcl.shape[0], 3 + width)
        np.testing.assert_array_equal(cloud[:, :3], pcl)
        files = [root / "images" / seq / "lb3" / c / f"{t}.tiff" for c in NCLT_CAMS]
        ref = jax_create(files, jds, jgen, pcl)
        got = cloud[:, 3:]
        covered = np.any(got != 0, axis=1)
        np.testing.assert_array_equal(covered, np.any(ref != 0, axis=1))
        assert covered.sum() > 10
        np.testing.assert_allclose(got, ref, atol=DESC_ATOL, rtol=0)


def test_prepare_scenes_main(mini_nclt, tmp_path):
    root, _, _ = mini_nclt
    scene_dir = tmp_path / "scenes"
    _scene_file(mini_nclt, scene_dir / "scene_001.json")
    prepare_scenes.main([str(root), str(scene_dir), "--device", "cpu"])
    loaded = h5io.read_scenes(scene_dir / "processed_scenes" / "scene_001.h5")
    assert loaded["map_point_clouds"][0].shape[1] == 3 + 384
    assert np.any(loaded["scene_point_clouds"][0][:, 3:] != 0)
    with pytest.raises(ValueError, match="Unknown dataset"):
        prepare_scenes.prepare_scene(tmp_path, scene_dir / "scene_001.json", tmp_path / "out")
    shutil.rmtree(scene_dir / "processed_scenes")
