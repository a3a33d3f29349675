"""The descriptor assembly (`ops/projection.assemble_descriptors`, and
`pipeline/prepare_scenes.create_descriptors` around it) on the CPU.

The oracle is the host assembly that `create_descriptors` ran before the
grids stayed on the device, kept here: each camera's grid read back as
numpy, `sample_patch_features` at every projected pixel, empty pixels
zeroed, every camera's rows concatenated, `np.unique` for the first
occurrence of each point, a scatter into zeros. The new pass must equal it
bit for bit (the float32 bits of every value) on a scripted sequence whose
projections hold: cameras that overlap, points whose first camera sees them
on an empty pixel (so a later camera must not fill them), a camera that
sees no point, a point listed twice by one camera, and images of different
sizes (so grids of different widths); plainly and as an NCLT sequence (the
image and the grid rotated). Also: `assemble_descriptors_plain` row by row
against `sample_patch_features`, two calls' outputs sharing no memory,
`assemble_stats()`, and the wrapper's refusals.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu_torch.data.nclt import NCLT  # noqa: E402
from vfmreg_tpu_torch.models import vit  # noqa: E402
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator  # noqa: E402
from vfmreg_tpu_torch.ops import projection  # noqa: E402
from vfmreg_tpu_torch.ops.projection import (  # noqa: E402
    MAX_CAMERAS, assemble_descriptors, assemble_descriptors_plain, sample_patch_features,
)
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors  # noqa: E402

N_POINTS = 300
# Image sizes per camera: 16 patch rows each, so 20, 21, 20 and 16 patch
# columns (the grid's width follows the image's aspect).
IMAGE_HW = {"cam0": (112, 140), "cam1": (96, 126), "cam2": (112, 140), "cam3": (140, 140)}


class ScriptedRig:
    """A sequence whose images and projections are fixed: `read_images`
    returns seeded noise images with black bottom rows, and
    `project_pcl_to_image` the scripted (u, v, idx) of the camera, given the
    image in the frame the projection works in."""

    def __init__(self, seed: int, rotated: bool = False):
        rng = np.random.RandomState(seed)
        self.images, self.projections = {}, {}
        for cam, (h, w) in IMAGE_HW.items():
            img = rng.randint(1, 256, (h, w, 3)).astype(np.uint8)
            img[-h // 5:] = 0  # the hood: empty pixels
            self.images[cam] = img
            frame = np.rot90(img, k=1, axes=(0, 1)) if rotated else img  # the projection's frame
            lo, hi = {"cam0": (0, 160), "cam1": (100, 240), "cam2": (0, 0), "cam3": (220, 280)}[cam]
            idx = np.arange(lo, hi)  # cam2 sees no point; 280-299 none sees
            if cam == "cam1":
                idx = np.r_[idx, idx[100]]  # a point only cam1 sees, listed twice
            u = rng.randint(0, frame.shape[1], idx.size)
            v = rng.randint(0, frame.shape[0], idx.size)
            black = np.argwhere(np.all(frame == 0, axis=-1))
            v[: idx.size // 4], u[: idx.size // 4] = black[rng.randint(0, len(black), idx.size // 4)].T
            self.projections[cam] = (u, v, idx)
        self.rotated = rotated

    def read_images(self, filenames):
        return {cam: img.copy() for cam, img in self.images.items()}

    def project_pcl_to_image(self, pcl_h, image, camera):
        h, w = IMAGE_HW[camera]
        assert image.shape[:2] == ((w, h) if self.rotated else (h, w))
        return self.projections[camera]


class ScriptedNCLT(ScriptedRig, NCLT):
    """The scripted rig as an NCLT sequence: its images come rotated and
    its projections are in the unrotated frame."""

    def __init__(self, seed: int):
        ScriptedRig.__init__(self, seed, rotated=True)


def host_assembly(sequence, generator, pcl):
    """The host assembly `create_descriptors` ran before: numpy grids,
    sampled rows, empty pixels zeroed, the first occurrence scattered."""
    images = sequence.read_images(filenames=None)
    pcl_h = np.insert(pcl, 3, values=1, axis=1).T
    indices, features = [], []
    for camera, image in images.items():
        patch_feats = generator.get_image_features(image, upsample=False)
        if isinstance(sequence, NCLT):
            image = np.rot90(image, k=1, axes=(0, 1))
            patch_feats = np.ascontiguousarray(np.rot90(patch_feats, k=1, axes=(0, 1)))
        u, v, idx = sequence.project_pcl_to_image(pcl_h, image, camera)
        if len(idx) == 0:
            continue
        feats = sample_patch_features(torch.from_numpy(patch_feats), torch.from_numpy(u), torch.from_numpy(v),
                                      image.shape[0], image.shape[1]).numpy()
        feats[np.all(image[v, u] == 0, axis=-1)] = 0.0
        indices.append(idx)
        features.append(feats)
    descriptors = np.zeros((pcl.shape[0], generator.feature_size), dtype=np.float32)
    all_idx = np.concatenate(indices)
    _, first = np.unique(all_idx, return_index=True)
    descriptors[all_idx[first]] = np.concatenate(features)[first]
    return descriptors


@pytest.fixture(scope="module")
def generator():
    cfg = dataclasses.replace(vit.PRESETS["dinov2_vits14"], hidden_size=32, num_layers=1, num_heads=2)
    return ImageFeatureGenerator("dinov2", config=cfg, seed=3, device="cpu")


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("nclt", [False, True])
def test_create_descriptors_equals_the_host_assembly_bit_for_bit(generator, nclt):
    seq = ScriptedNCLT(seed=1) if nclt else ScriptedRig(seed=1)
    pcl = np.random.RandomState(2).normal(size=(N_POINTS, 3)).astype(np.float32)
    want = host_assembly(seq, generator, pcl)
    got = create_descriptors(["a", "b", "c", "d"], seq, generator, pcl)
    assert got.shape == want.shape == (N_POINTS, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))

    # The case holds what it is meant to hold: overlaps, first pixels that
    # are empty and block a later camera, points no camera sees.
    images = seq.read_images(None)
    frame = {cam: np.rot90(img, k=1, axes=(0, 1)) if nclt else img for cam, img in images.items()}
    u0, v0, i0 = seq.projections["cam0"]
    _, _, i1 = seq.projections["cam1"]
    empty0 = np.all(frame["cam0"][v0, u0] == 0, axis=-1)
    blocked = np.intersect1d(i0[empty0], i1)
    covered = np.any(got != 0, axis=1)
    assert blocked.size > 3 and not covered[blocked].any()
    assert np.intersect1d(i0[~empty0], i1).size > 10
    assert (~covered).sum() > blocked.size and covered.sum() > 100


def test_the_grids_have_different_widths(generator):
    widths = {cam: generator.patch_features(img).shape[1] for cam, img in ScriptedRig(seed=1).images.items()}
    assert widths == {"cam0": 20, "cam1": 21, "cam2": 20, "cam3": 16}


def test_patch_features_is_the_grid_of_get_image_features(generator):
    img = ScriptedRig(seed=4).images["cam1"]
    grid = generator.patch_features(img)
    assert isinstance(grid, torch.Tensor) and grid.device.type == "cpu" and tuple(grid.shape) == (16, 21, 32)
    np.testing.assert_array_equal(_bits(grid.numpy()), _bits(generator.get_image_features(img)))


def _random_case(seed, d, n=500):
    """Three grids of different widths, owners in {-2, -1, 0, 1, 2}."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(16, 20), (16, 23), (20, 16)]
    sizes = [(1232, 1616), (1232, 1771), (1616, 1232)]
    grids = [torch.randn((h, w, d), generator=g) for h, w in shapes]
    owner = torch.randint(-2, 3, (n,), generator=g, dtype=torch.int32)
    hw = torch.tensor(sizes, dtype=torch.int32)[owner.clamp(min=0).long()]
    u = (torch.rand(n, generator=g) * hw[:, 1]).to(torch.int32)
    v = (torch.rand(n, generator=g) * hw[:, 0]).to(torch.int32)
    u[:3], v[:3] = 0, 0  # the grid's corners and edges
    u[3:6], v[3:6] = hw[3:6, 1] - 1, hw[3:6, 0] - 1
    return grids, sizes, owner, u, v


@pytest.mark.parametrize("d", [24, 384, 1536])
def test_plain_rows_are_sample_patch_features(d):
    grids, sizes, owner, u, v = _random_case(d, d)
    out = assemble_descriptors_plain(grids, sizes, owner, u, v)
    assert out.shape == (owner.shape[0], d) and out.dtype == torch.float32
    for i in range(owner.shape[0]):
        c = int(owner[i])
        if c < 0:
            assert not out[i].any()
            continue
        want = sample_patch_features(grids[c], u[i : i + 1].long(), v[i : i + 1].long(), *sizes[c])[0]
        assert torch.equal(out[i].view(torch.int32), want.view(torch.int32)), i
    assert torch.equal(assemble_descriptors(grids, sizes, owner, u, v), out)


def test_assemble_stats_count_scans_rows_and_samples(generator):
    seq = ScriptedRig(seed=1)
    pcl = np.zeros((N_POINTS, 3), dtype=np.float32)
    projection.reset_assemble_stats()
    a = create_descriptors(None, seq, generator, pcl)
    b = create_descriptors(None, seq, generator, pcl)
    grids, sizes, owner, u, v = _random_case(0, 8)
    assemble_descriptors(grids, sizes, owner, u, v)
    stats = projection.assemble_stats()
    sampled = 2 * int(np.any(a != 0, axis=1).sum()) + int((owner >= 0).sum())
    assert stats == {"scans": 3, "rows_written": 2 * N_POINTS + owner.shape[0], "rows_sampled": sampled}
    projection.reset_assemble_stats()
    assert projection.assemble_stats() == {"scans": 0, "rows_written": 0, "rows_sampled": 0}
    np.testing.assert_array_equal(a, b)


def test_two_calls_share_no_memory(generator):
    seq = ScriptedRig(seed=1)
    pcl = np.zeros((N_POINTS, 3), dtype=np.float32)
    a = create_descriptors(None, seq, generator, pcl)
    kept = a.copy()
    b = create_descriptors(None, seq, generator, pcl)
    assert not np.shares_memory(a, b)
    b[:] = 7.0
    np.testing.assert_array_equal(a, kept)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    grids, sizes, owner, u, v = _random_case(1, 8)
    with pytest.raises(ValueError, match="at most"):
        assemble_descriptors(grids * 3, sizes * 3, owner, u, v)
    assert 3 * len(grids) > MAX_CAMERAS
    with pytest.raises(ValueError, match="grids"):
        assemble_descriptors(grids[:2], sizes, owner, u, v)
    with pytest.raises(ValueError, match=r"grids\[1\]"):
        assemble_descriptors([grids[0], grids[1][..., :4]], sizes[:2], owner, u, v)
    with pytest.raises(TypeError, match="owner"):
        assemble_descriptors(grids, sizes, owner.long(), u, v)
    with pytest.raises(ValueError, match="contiguous"):
        assemble_descriptors([grids[0].transpose(0, 1), *grids[1:]], sizes, owner, u, v)
    with pytest.raises(ValueError, match="out"):
        assemble_descriptors(grids, sizes, owner, u, v, out=torch.empty((owner.shape[0], 9)))
    assert assemble_descriptors(grids, sizes, owner[:0], u[:0], v[:0]).shape == (0, 8)


def test_the_rows_go_into_a_given_output():
    grids, sizes, owner, u, v = _random_case(2, 8)
    out = torch.full((owner.shape[0], 8), 7.0)
    assert assemble_descriptors(grids, sizes, owner, u, v, out=out) is out
    assert torch.equal(out, assemble_descriptors_plain(grids, sizes, owner, u, v))
