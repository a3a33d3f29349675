"""The descriptor assembly kernel (`csrc/assemble_descriptors.cu`) on an
NVIDIA card (each test skips without one).

Run on the card: `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_assemble_card.py -q` (`--noconftest`: `tests/conftest.py`
imports JAX, which this file does not need).

The kernel against `assemble_descriptors_plain` on the same card tensors,
the float32 bits of every value: at a rig scan's 16,384 rows from five
16 x 20 grids at 384, 512 and 1536 wide (the float4 path), with grids of
different widths and image sizes, at a width that is not a multiple of 4
and from a grid whose address is not 16-byte aligned (the float path); into
pinned host memory, and not into pageable memory. One launch a call,
`assemble_stats()` counting its rows; and
`create_descriptors` on the card equal bit for bit to the host assembly it
replaced (`tests/test_torch_assemble.py`'s oracle), its output in host
memory that the next call does not touch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_assemble import N_POINTS, ScriptedNCLT, ScriptedRig, _bits, host_assembly
from vfmreg_tpu_torch.models import vit
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator
from vfmreg_tpu_torch.ops import _build, projection
from vfmreg_tpu_torch.ops.projection import assemble_descriptors, assemble_descriptors_plain
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors

N = 16_384


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this machine has no CUDA device")
    return torch.device("cuda", 0)


def _case(card, d, shapes, sizes, seed, offset=0):
    """Grids of `shapes` (the first `offset` floats into its storage), owners
    in {-2, -1, 0, ...}, pixels within each owner's image, edges included."""
    g = torch.Generator().manual_seed(seed)
    grids = []
    for h, w in shapes:
        flat = torch.randn(h * w * d + offset, generator=g)
        grids.append(flat.to(card)[offset:].view(h, w, d))
    owner = torch.randint(-2, len(shapes), (N,), generator=g, dtype=torch.int32)
    hw = torch.tensor(sizes, dtype=torch.int32)[owner.clamp(min=0).long()]
    u = (torch.rand(N, generator=g) * hw[:, 1]).to(torch.int32)
    v = (torch.rand(N, generator=g) * hw[:, 0]).to(torch.int32)
    u[:4], v[:4] = 0, 0
    u[4:8], v[4:8] = hw[4:8, 1] - 1, hw[4:8, 0] - 1
    return grids, sizes, owner.to(card), u.to(card), v.to(card)


def _assert_kernel_equals_plain(grids, sizes, owner, u, v):
    _build.reset_launches()
    projection.reset_assemble_stats()
    got = assemble_descriptors(grids, sizes, owner, u, v)
    assert dict(_build.LAUNCHES) == {"assemble_descriptors": 1}
    want = assemble_descriptors_plain(grids, sizes, owner, u, v)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert projection.assemble_stats() == {"scans": 1, "rows_written": N, "rows_sampled": int((owner >= 0).sum())}


@pytest.mark.card
@pytest.mark.parametrize("d", [384, 512, 1536])
def test_rig_shape(card, d):
    _assert_kernel_equals_plain(*_case(card, d, [(16, 20)] * 5, [(1232, 1616)] * 5, seed=d))


@pytest.mark.card
def test_grids_of_different_widths(card):
    # NCLT's cropped cameras, rotated: grids of 20 x 16 and 21 x 16 over
    # images of 1616 x 1232 and 1700 x 1232.
    _assert_kernel_equals_plain(*_case(card, 1536, [(20, 16), (21, 16), (16, 20)],
                                       [(1616, 1232), (1700, 1232), (1232, 1616)], seed=7))


@pytest.mark.card
@pytest.mark.parametrize("d, offset", [(30, 0), (384, 1)])
def test_float_path(card, d, offset):
    grids, sizes, owner, u, v = _case(card, d, [(16, 20)] * 3, [(1232, 1616)] * 3, seed=d, offset=offset)
    assert d % 4 or grids[0].data_ptr() % 16
    _assert_kernel_equals_plain(grids, sizes, owner, u, v)


@pytest.mark.card
def test_into_pinned_host_memory(card):
    grids, sizes, owner, u, v = _case(card, 1536, [(16, 20)] * 5, [(1232, 1616)] * 5, seed=3)
    out = torch.empty((N, 1536), dtype=torch.float32, pin_memory=True)
    assert assemble_descriptors(grids, sizes, owner, u, v, out=out) is out
    torch.cuda.synchronize()
    want = assemble_descriptors_plain(grids, sizes, owner, u, v).cpu()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="pinned"):
        assemble_descriptors(grids, sizes, owner, u, v, out=torch.empty((N, 1536)))


@pytest.mark.card
@pytest.mark.parametrize("nclt", [False, True])
def test_create_descriptors_on_the_card_equals_the_host_assembly(card, nclt):
    # Heads of 32, a width kernel B5 takes.
    cfg = dataclasses.replace(vit.PRESETS["dinov2_vits14"], hidden_size=64, num_layers=1, num_heads=2)
    gen = ImageFeatureGenerator("dinov2", config=cfg, seed=3, device=card)
    seq = ScriptedNCLT(seed=1) if nclt else ScriptedRig(seed=1)
    pcl = np.zeros((N_POINTS, 3), dtype=np.float32)
    got = create_descriptors(None, seq, gen, pcl)
    kept = got.copy()
    again = create_descriptors(None, seq, gen, pcl)
    want = host_assembly(seq, gen, pcl)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.shares_memory(got, again)
    again[:] = 7.0
    np.testing.assert_array_equal(got, kept)
