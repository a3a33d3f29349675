"""Parity of the port's PLY writers, cloud readers and `--dump-viz` files with `vfmreg_tpu`.

* `write_ply` and `write_ply_segments`: the same bytes as the reference's
  for f32 and f64 inputs, negative and empty ones;
* `data/cloud_io`: `read_ply` / `read_ply_xyz` / `read_pcd` / `read_pcd_xyz`
  equal to the reference's on files either package writes (the writers
  above, binary PLY in both byte orders, ascii and binary PCD with a
  COUNT > 1 field), and binary_compressed PCD refused by both;
* `RegistrationNode._dump_scan_viz`: the same files with the same bytes as
  the reference node's method on the same inputs (scan 0 with the map, a
  later scan, the flagship key chosen both ways, no correspondences);
* `visualize_scene` on a scene file: the same drawn points and PLY bytes.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu.data import cloud_io as jio  # noqa: E402
from vfmreg_tpu.data import h5io as jh5  # noqa: E402
from vfmreg_tpu.pipeline import visualize_scenes as jvis  # noqa: E402
from vfmreg_tpu.pipeline.registration_node import RegistrationNode as JNode  # noqa: E402
from vfmreg_tpu_torch.data import cloud_io as tio  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline import visualize_scenes as tvis  # noqa: E402


def _points(seed, n, dtype):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-80, 80, (n, 3)) * rng.choice([1, 1e-3], (n, 1))).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writers_byte_equal(tmp_path, dtype):
    pts, tgt = _points(0, 300, dtype), _points(1, 300, dtype)
    for name, args in (("cloud", (pts,)), ("coloured", (pts, (1, 2, 3))), ("empty", (pts[:0],))):
        tvis.write_ply(tmp_path / f"t_{name}.ply", *args)
        jvis.write_ply(tmp_path / f"j_{name}.ply", *args)
        assert (tmp_path / f"t_{name}.ply").read_bytes() == (tmp_path / f"j_{name}.ply").read_bytes()
    for name, args in (("seg", (pts, tgt)), ("seg_empty", (pts[:0], tgt[:0])),
                       ("seg_col", (pts[:7], tgt[:7], (0, 0, 0), (255, 255, 255)))):
        tvis.write_ply_segments(tmp_path / f"t_{name}.ply", *args)
        jvis.write_ply_segments(tmp_path / f"j_{name}.ply", *args)
        assert (tmp_path / f"t_{name}.ply").read_bytes() == (tmp_path / f"j_{name}.ply").read_bytes()


def _equal_columns(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def _binary_ply(path, cols, endian):
    names = list(cols)
    dtype = np.dtype([(n, endian + cols[n].dtype.str[1:]) for n in names])
    arr = np.empty(len(cols[names[0]]), dtype=dtype)
    for n in names:
        arr[n] = cols[n]
    types = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u2": "ushort"}
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    head = f"ply\nformat {fmt} 1.0\nelement vertex {len(arr)}\n"
    head += "".join(f"property {types[cols[n].dtype.str[1:]]} {n}\n" for n in names)
    head += "element face 0\nproperty list uchar int vertex_indices\nend_header\n"
    Path(path).write_bytes(head.encode() + arr.tobytes())


def _pcd(path, cols, mode):
    fields = ["x", "y", "z", "intensity", "rgb"]
    n = len(cols["x"])
    head = ("# .PCD v0.7\nVERSION 0.7\nFIELDS " + " ".join(fields) + "\nSIZE 4 4 4 2 1\nTYPE F F F U U\n"
            "COUNT 1 1 1 1 3\nWIDTH " + str(n) + "\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS " + str(n)
            + f"\nDATA {mode}\n")
    if mode == "ascii":
        body = "".join(f"{x!r} {y!r} {z!r} {i} {r} {g} {b}\n" for x, y, z, i, (r, g, b) in
                       zip(cols["x"].tolist(), cols["y"].tolist(), cols["z"].tolist(), cols["intensity"].tolist(),
                           cols["rgb"].tolist())).encode()
    else:
        dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<u2"), ("rgb", "u1", (3,))])
        arr = np.empty(n, dtype=dt)
        for k in ("x", "y", "z", "intensity", "rgb"):
            arr[k] = cols[k]
        body = arr.tobytes()
    Path(path).write_bytes(head.encode() + body)


def test_readers_equal_on_files_either_package_writes(tmp_path):
    pts, tgt = _points(2, 200, np.float32), _points(3, 200, np.float32)
    tvis.write_ply(tmp_path / "t.ply", pts)
    jvis.write_ply(tmp_path / "j.ply", pts)
    tvis.write_ply_segments(tmp_path / "s.ply", pts, tgt)
    for f in ("t.ply", "j.ply", "s.ply"):
        _equal_columns(tio.read_ply(tmp_path / f), jio.read_ply(tmp_path / f))
        np.testing.assert_array_equal(tio.read_ply_xyz(tmp_path / f), jio.read_ply_xyz(tmp_path / f))
    np.testing.assert_allclose(tio.read_ply_xyz(tmp_path / "t.ply"), pts, atol=5e-5)
    assert tio.read_ply_xyz(tmp_path / "s.ply").shape == (400, 3)

    rng = np.random.RandomState(4)
    cols = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "intensity": rng.randint(0, 255, 200).astype(np.uint8),
            "t": rng.rand(200)}
    for endian in ("<", ">"):
        _binary_ply(tmp_path / f"b{endian == '<'}.ply", cols, endian)
        got = tio.read_ply(tmp_path / f"b{endian == '<'}.ply")
        _equal_columns(got, jio.read_ply(tmp_path / f"b{endian == '<'}.ply"))
        np.testing.assert_array_equal(got["t"], cols["t"])

    pcd_cols = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": rng.randint(0, 60000, 200).astype(np.uint16),
                "rgb": rng.randint(0, 255, (200, 3)).astype(np.uint8)}
    for mode in ("ascii", "binary"):
        _pcd(tmp_path / f"{mode}.pcd", pcd_cols, mode)
        got = tio.read_pcd(tmp_path / f"{mode}.pcd")
        _equal_columns(got, jio.read_pcd(tmp_path / f"{mode}.pcd"))
        np.testing.assert_array_equal(got["rgb_2"], pcd_cols["rgb"][:, 2])
        np.testing.assert_array_equal(tio.read_pcd_xyz(tmp_path / f"{mode}.pcd"), pts.astype(np.float64))
    raw = (tmp_path / "binary.pcd").read_bytes().replace(b"DATA binary", b"DATA binary_compressed")
    (tmp_path / "c.pcd").write_bytes(raw)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="binary_compressed"):
            mod.read_pcd(tmp_path / "c.pcd")


def _tree(d: Path):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_dump_scan_viz_same_files_as_reference(tmp_path):
    rng = np.random.RandomState(5)
    local_map = np.c_[_points(6, 800, np.float32), rng.rand(800, 4).astype(np.float32)]
    scan = _points(7, 300, np.float32)
    gt = np.eye(4)
    gt[:3, 3] = [1.5, -2.0, 0.25]
    est = gt.copy()
    est[:3, 3] += 0.01
    initial = np.eye(4)
    initial[:3, 3] = [0.5, 0.0, 0.0]
    corr = (_points(8, 40, np.float32), _points(9, 40, np.float32))
    calls = [
        (0, {"fpfh_ransac": None, "fpfh_ransac_icp": est, "vfm_ransac_icp": est @ gt, "icp": gt}, corr),
        (1, {"fpfh_ransac": None, "dip_ransac": est, "icp": gt}, (corr[0][:0], corr[1][:0])),
        (2, {"icp": None}, None),
    ]
    trees = {}
    for name, cls, kw in (("jax", JNode, {}), ("torch", trn.RegistrationNode, {"device": "cpu"})):
        out = tmp_path / name
        node = cls(tmp_path, methods_ransac=[], methods_teaser=[], methods_pointdsc=[], dump_viz_dir=out, **kw)
        node.scene_idx = 3
        node._viz_initial = initial
        for i, results, c in calls:
            node._dump_scan_viz(i, local_map, scan, gt, results, c)
        trees[name] = _tree(out)
    assert trees["torch"].keys() == trees["jax"].keys()
    assert set(trees["torch"]) == {"scene_003/map.ply", "scene_003/scan_00_gt.ply",
                                   "scene_003/scan_00_est_vfm_ransac_icp.ply", "scene_003/scan_00_correspondences.ply",
                                   "scene_003/scan_01_gt.ply", "scene_003/scan_01_est_dip_ransac.ply",
                                   "scene_003/scan_02_gt.ply"}
    for k in trees["jax"]:
        assert trees["torch"][k] == trees["jax"][k], k


def test_visualize_scene_same_points_and_files(tmp_path):
    rng = np.random.RandomState(10)
    clouds = [np.c_[_points(11 + i, 500, np.float32), rng.rand(500, 3).astype(np.float32)] for i in range(4)]
    poses = []
    for i in range(4):
        T = np.eye(4)
        T[:3, 3] = [i, -i, 0.1 * i]
        poses.append(T)
    jh5.save_scene(tmp_path / "scene_000.h5", ["m", "a", "b"], poses[:2], clouds[:2], poses[2:], clouds[2:])
    got = tvis.visualize_scene(tmp_path / "scene_000.h5", export_ply_dir=tmp_path / "t", max_points=400)
    want = jvis.visualize_scene(tmp_path / "scene_000.h5", export_ply_dir=tmp_path / "j", max_points=400)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == 400 and got[1].shape[0] == 100  # both subsampled
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j") and len(_tree(tmp_path / "t")) == 2
    tvis.main([str(tmp_path), "--ply-dir", str(tmp_path / "cli")])
    assert set(_tree(tmp_path / "cli")) == {"scene_000_map.ply", "scene_000_scans.ply"}
