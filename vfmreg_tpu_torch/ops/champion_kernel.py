"""Kernel B3: single-pass champion-cache rebuild from transposed candidates.

Counterpart of `vfmreg_tpu/ops/champion_kernel.py:champions_from_planes`.
The geometric ICP loop (`registration/icp.py`) transposes each slab
gather once (`Candidates.planes`) and rebuilds the per-voxel champions from
it with one streaming pass per rebuild: per (voxel group, query) the in-voxel
nearest candidate, as three [32, N] planes (rows 27..31 the sentinel). The
result is bit-identical to `hash_grid.build_nn_cache`'s cx / cy / cz: the
same f32 squared distance, lowest row on ties, alive = finite minimum and
query mask, else INVALID_COORD. The geometric path never reads the cache's
row ids, so none are produced.

`champions_from_planes_lanes` rebuilds every flagged lane of an ICP row in
one launch, into the row's persistent champion buffer
(`new_champion_buffer`). `champions_from_planes` is its one-lane case with a
fresh output.

The CUDA kernel is `csrc/champions_from_planes.cu`;
`champions_from_planes_plain` is the same function in plain PyTorch, written
as the Pallas body is (minimum, first row equal to it, one-hot select), and
`champions_from_planes_lanes_plain` runs it per flagged lane. The wrappers
run the plain versions for CPU tensors only; for CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vfmreg_tpu_torch.ops import _build
from vfmreg_tpu_torch.ops.hash_grid import INVALID_COORD

NAME = "champions_from_planes"
_K = 32  # rows of the champion planes
_BIG = 2**30


def champions_from_planes_plain(
    cxt: torch.Tensor, cyt: torch.Tensor, czt: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor, group: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cx, cy, cz) [32, N] in plain PyTorch."""
    kg, n = cxt.shape
    v = kg // group
    xs, ys, zs = (a.reshape(v, group, n) for a in (cxt, cyt, czt))
    dx = xs - queries[:, 0]
    dy = ys - queries[:, 1]
    dz = zs - queries[:, 2]
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    best = torch.amin(d2, dim=1, keepdim=True)  # NaN propagates, as jnp.min
    iota = torch.arange(group, device=cxt.device)[None, :, None]
    ksel = torch.amin(torch.where(d2 == best, iota, _BIG), dim=1, keepdim=True)
    onehot = iota == ksel
    alive = torch.isfinite(best[:, 0]) & query_mask[None, :]
    pad = torch.full((_K - v, n), INVALID_COORD, dtype=torch.float32, device=cxt.device)

    def plane(a):
        champ = torch.sum(torch.where(onehot, a, 0.0), dim=1)
        return torch.cat([torch.where(alive, champ, INVALID_COORD), pad])

    return plane(xs), plane(ys), plane(zs)


def _check(cxt, cyt, czt, queries, query_mask, group):
    kg, n = cxt.shape
    if group <= 0 or kg % group or kg // group > _K:
        raise ValueError(f"{NAME}: {kg} rows do not make at most {_K} groups of {group}")
    _build.check_args(NAME, [
        ("cxt", cxt, (kg, n), torch.float32), ("cyt", cyt, (kg, n), torch.float32),
        ("czt", czt, (kg, n), torch.float32), ("queries", queries, (n, 3), torch.float32),
        ("query_mask", query_mask, (n,), torch.bool),
    ], cxt.device)
    if n == 0:
        raise ValueError(f"{NAME}: no queries")


def champions_from_planes(
    cxt: torch.Tensor, cyt: torch.Tensor, czt: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor, group: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cx, cy, cz) champion planes [32, N] (see the module docstring).

    cxt, cyt, czt: [27 * group, N] candidate planes (`Candidates.planes`);
    queries: [N, 3] current source positions; query_mask: [N] bool."""
    _check(cxt, cyt, czt, queries, query_mask, group)
    if cxt.device.type == "cpu":
        return champions_from_planes_plain(cxt, cyt, czt, queries, query_mask, group)
    if cxt.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {cxt.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "champions_from_planes_launch", [P] * 5 + [I] * 3 + [P] * 4)
    kg, n = cxt.shape
    out = torch.empty((3, _K, n), dtype=torch.float32, device=cxt.device)
    stream = torch.cuda.current_stream(cxt.device).cuda_stream
    err = fn(
        cxt.data_ptr(), cyt.data_ptr(), czt.data_ptr(), queries.data_ptr(),
        query_mask.data_ptr(), kg // group, group, n,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out[0], out[1], out[2]


def new_champion_buffer(b: int, n: int, device) -> torch.Tensor:
    """[3, B, 32, N] champion planes of B lanes, all the sentinel: rows
    27..31 stay so, rows 0..26 are written by each rebuild."""
    return torch.full((3, b, _K, n), INVALID_COORD, dtype=torch.float32, device=device)


def champions_from_planes_lanes_plain(cxt, cyt, czt, queries, query_mask, lane_flag, group: int,
                                      out: torch.Tensor) -> None:
    """`champions_from_planes_lanes` in plain PyTorch: one
    `champions_from_planes_plain` per flagged lane."""
    for j in torch.nonzero(lane_flag).flatten().tolist():
        planes = champions_from_planes_plain(cxt[j], cyt[j], czt[j], queries[j], query_mask[j], group)
        v = cxt.shape[1] // group
        for c in range(3):
            out[c, j, :v] = planes[c][:v]


def champions_from_planes_lanes(
    cxt: torch.Tensor, cyt: torch.Tensor, czt: torch.Tensor, queries: torch.Tensor,
    query_mask: torch.Tensor, lane_flag: torch.Tensor, group: int, out: torch.Tensor,
) -> None:
    """Rebuild the champion planes of every flagged lane in one launch.

    cxt, cyt, czt: [B, 27 * group, N] per-lane candidate planes; queries:
    [B, N, 3]; query_mask: [B, N] bool; lane_flag: [B] int32, not 0 where
    the lane is rebuilt; out: [3, B, 32, N] (`new_champion_buffer`), whose
    rows 0..26 of the flagged lanes are written."""
    b, kg, n = cxt.shape
    if group <= 0 or kg % group or kg // group > 27:
        raise ValueError(f"{NAME}: {kg} rows do not make at most 27 groups of {group}")
    f32 = torch.float32
    specs = [("cxt", cxt, (b, kg, n), f32), ("cyt", cyt, (b, kg, n), f32), ("czt", czt, (b, kg, n), f32),
             ("queries", queries, (b, n, 3), f32), ("query_mask", query_mask, (b, n), torch.bool),
             ("lane_flag", lane_flag, (b,), torch.int32), ("out", out, (3, b, _K, n), f32)]
    _build.check_args(NAME, specs, cxt.device)
    if n == 0:
        raise ValueError(f"{NAME}: no queries")
    if cxt.device.type == "cpu":
        champions_from_planes_lanes_plain(cxt, cyt, czt, queries, query_mask, lane_flag, group, out)
        return
    if cxt.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {cxt.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "champions_lanes_launch", [P] * 6 + [I] * 4 + [P] * 4)
    err = fn(
        cxt.data_ptr(), cyt.data_ptr(), czt.data_ptr(), queries.data_ptr(), query_mask.data_ptr(),
        lane_flag.data_ptr(), b, kg // group, group, n,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        torch.cuda.current_stream(cxt.device).cuda_stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
