"""Patch-feature sampling at projected pixels, and a scan's descriptor assembly.

`sample_patch_features` is the counterpart of
`vfmreg_tpu/ops/projection.py:sample_patch_features`: the ViT patch grid is
sampled directly at the projected pixel coordinates with the
align_corners=False bilinear mapping, which equals bilinear upsampling of
the grid to the full image followed by a gather at (v, u), without the
[H, W, D] map. Plain tensor code, as the reference's is plain XLA.

`assemble_descriptors` writes a scan's [N, D] descriptors from its cameras'
patch grids in one launch: row i is the sample of its owner camera's grid
at (u[i], v[i]), or zeros where the owner is negative (no camera, or an
empty pixel of the first camera that sees the point). The owners are
decided on the host (`pipeline/prepare_scenes.create_descriptors`). The
CUDA kernel is `csrc/assemble_descriptors.cu`, which the reference has no
counterpart of (it assembles in numpy); `assemble_descriptors_plain` is the
same function in plain PyTorch, and each row equals `sample_patch_features`
of that row bit for bit. The wrapper runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from vfmreg_tpu_torch.ops import _build

NAME = "assemble_descriptors"
# The kernel's fixed table of grids; every loader has at most 5 cameras.
MAX_CAMERAS = 8


def sample_patch_features(
    patch_feats: torch.Tensor,  # [h, w, D]
    u: torch.Tensor,  # [N] integer pixel column in the full image
    v: torch.Tensor,  # [N] integer pixel row
    img_h: int,
    img_w: int,
) -> torch.Tensor:
    """bilinear-upsample(patch_feats -> img_h x img_w)[v, u], [N, D], with
    torch's align_corners=False mapping src = (dst + 0.5) * (src / dst) - 0.5,
    edge-clamped."""
    h, w, _ = patch_feats.shape
    y = ((v.to(torch.float32) + 0.5) * (h / img_h) - 0.5).clamp(0.0, h - 1.0)
    x = ((u.to(torch.float32) + 0.5) * (w / img_w) - 0.5).clamp(0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    return (
        patch_feats[y0, x0] * (1 - wy) * (1 - wx)
        + patch_feats[y0, x1] * (1 - wy) * wx
        + patch_feats[y1, x0] * wy * (1 - wx)
        + patch_feats[y1, x1] * wy * wx
    )


# Scans assembled and rows written (counted on the host), and, per device,
# the rows sampled from a grid (an int64 on the card that the kernel adds
# to): read by `assemble_stats`, never on the timed path.
_scans = 0
_rows_written = 0
_rows_sampled: Dict[torch.device, torch.Tensor] = {}


def assemble_stats() -> Dict[str, int]:
    """{"scans", "rows_written", "rows_sampled"} of the assemblies since
    `reset_assemble_stats`. Reads the card (a synchronisation): for tools
    and tests."""
    return {"scans": _scans, "rows_written": _rows_written,
            "rows_sampled": sum(int(t.item()) for t in _rows_sampled.values())}


def reset_assemble_stats() -> None:
    global _scans, _rows_written
    _scans = _rows_written = 0
    for t in _rows_sampled.values():
        t.zero_()


def assemble_descriptors_plain(
    grids: Sequence[torch.Tensor], image_sizes: Sequence[Tuple[int, int]],
    owner: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
) -> torch.Tensor:
    """[N, D] f32: row i is `sample_patch_features(grids[owner[i]], u[i],
    v[i], *image_sizes[owner[i]])`, zeros where owner[i] < 0."""
    out = torch.zeros((owner.shape[0], grids[0].shape[-1]), dtype=torch.float32, device=owner.device)
    for cam, (grid, (img_h, img_w)) in enumerate(zip(grids, image_sizes)):
        rows = torch.nonzero(owner == cam).squeeze(1)
        out[rows] = sample_patch_features(grid, u[rows], v[rows], img_h, img_w)
    return out


def _check(grids, image_sizes, owner, u, v, out):
    if not grids or len(grids) != len(image_sizes):
        raise ValueError(f"{NAME}: {len(grids)} grids for {len(image_sizes)} image sizes")
    if len(grids) > MAX_CAMERAS:
        raise ValueError(f"{NAME}: {len(grids)} cameras, the kernel takes at most {MAX_CAMERAS}")
    d = grids[0].shape[-1]
    for c, g in enumerate(grids):
        if g.ndim != 3 or g.numel() == 0 or g.shape[-1] != d:
            raise ValueError(f"{NAME}: grids[{c}] has shape {tuple(g.shape)}, expected [h, w, {d}]")
    n, dev = owner.shape[0], owner.device
    _build.check_args(NAME, [("owner", owner, (n,), torch.int32), ("u", u, (n,), torch.int32),
                             ("v", v, (n,), torch.int32)]
                      + [(f"grids[{c}]", g, g.shape, torch.float32) for c, g in enumerate(grids)], dev)
    if out is not None:
        host = dev.type == "cuda" and out.device.type == "cpu"
        if host and not out.is_pinned():
            raise ValueError(f"{NAME}: out in host memory must be pinned, so that the kernel can write it")
        _build.check_args(NAME, [("out", out, (n, d), torch.float32)], out.device if host else dev)


def assemble_descriptors(
    grids: Sequence[torch.Tensor], image_sizes: Sequence[Tuple[int, int]],
    owner: torch.Tensor, u: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A scan's [N, D] f32 descriptors: row i samples camera owner[i]'s patch
    grid `grids[owner[i]]` ([h_c, w_c, D] f32, contiguous) at pixel (u[i],
    v[i]) of its image of `image_sizes[owner[i]]` = (H_c, W_c), as
    `sample_patch_features`; zeros where owner[i] < 0. `owner`, `u`, `v`:
    [N] int32 on the grids' device. At most `MAX_CAMERAS` grids; D and the
    shapes are read from the tensors. Written into `out` when given ([N, D]
    f32, contiguous: on the device, or pinned host memory, which the kernel
    writes across the bus, so that the rows need no buffer on the card and
    no copy; read it after synchronizing the stream), else into a new
    tensor on the device. One launch, nothing read back."""
    global _scans, _rows_written
    _check(grids, image_sizes, owner, u, v, out)
    dev = owner.device
    n, d = owner.shape[0], grids[0].shape[-1]
    sampled = _rows_sampled.get(dev)
    if sampled is None:
        sampled = _rows_sampled[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    _scans += 1
    _rows_written += n
    if dev.type == "cpu":
        sampled += (owner >= 0).sum()
        rows = assemble_descriptors_plain(grids, image_sizes, owner, u, v)
        return rows if out is None else out.copy_(rows)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {dev}")
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0:
        return out

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "assemble_descriptors_launch", [P, P, P, I, P, P, P, I, I, P, I, P, P])
    cams = len(grids)
    ptrs = (ctypes.c_void_p * cams)(*(g.data_ptr() for g in grids))
    hw = (ctypes.c_int * (2 * cams))(*(s for g in grids for s in g.shape[:2]))
    # h / H rounded to f32, as torch rounds the Python scalar in `sample_patch_features`.
    scale = (ctypes.c_float * (2 * cams))(*(s for g, (ih, iw) in zip(grids, image_sizes)
                                            for s in (g.shape[0] / ih, g.shape[1] / iw)))
    err = fn(ptrs, hw, scale, cams, owner.data_ptr(), u.data_ptr(), v.data_ptr(), n, d, out.data_ptr(),
             int(out.device.type == "cpu"), sampled.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out
