"""Kernel B2: one fused Gauss-Newton pass over the champion cache.

Counterpart of `vfmreg_tpu/ops/gn_kernel.py`. Per query: nearest cached
champion (lowest k on ties), the `best < max_d2` gate, the Geman-McClure
weight k^2 / (k + d^2)^2, and 17 moments summed over all queries:

  0 count | 1 sum w | 2-4 sum w s_c | 5-7 diag sum w s_c s_c^T
  8-10 off-diagonal (xy, xz, yz) | 11-13 sum w r | 14-16 sum w (s_c x r)

with s_c = s - center and r = s - champion. `assemble_gn_system` turns them
into the 6x6 robust normal equations of `registration.icp.build_linear_system`.

The CUDA kernel is `csrc/gn_moments.cu`; `gn_moments_plain` is the same
function in plain PyTorch. The wrapper runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.ops import _build

NAME = "gn_moments_from_cache"
_NT = 256  # threads per block of the CUDA kernel
_NPART = 17


def gn_terms_plain(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, source: torch.Tensor,
    center, kernel: float, max_dist: float,
) -> torch.Tensor:
    """[17, N] per-query terms of the moments, in plain PyTorch."""
    kernel = torch.tensor(kernel, dtype=torch.float32, device=cx.device)
    max_d2 = torch.tensor(np.float32(max_dist) ** 2, device=cx.device)
    center = torch.as_tensor(center, dtype=torch.float32, device=cx.device)
    sx, sy, sz = source[:, 0], source[:, 1], source[:, 2]
    dx = cx - sx
    dy = cy - sy
    dz = cz - sz
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    best = torch.amin(d2, dim=0, keepdim=True)
    iota = torch.arange(cx.shape[0], device=cx.device)[:, None]
    ksel = torch.amin(torch.where(d2 == best, iota, 2**30), dim=0, keepdim=True)
    bx, by, bz = (torch.gather(c, 0, ksel)[0] for c in (cx, cy, cz))
    best = best[0]

    accept = best < max_d2
    w = torch.where(accept, (kernel * kernel) / torch.square(kernel + best), 0.0)
    rx, ry, rz = (torch.where(accept, s - b, 0.0) for s, b in ((sx, bx), (sy, by), (sz, bz)))
    px, py, pz = (torch.where(accept, s - c, 0.0) for s, c in zip((sx, sy, sz), center))
    return torch.stack([
        accept.to(torch.float32), w,
        w * px, w * py, w * pz,
        w * px * px, w * py * py, w * pz * pz,
        w * px * py, w * px * pz, w * py * pz,
        w * rx, w * ry, w * rz,
        w * (py * rz - pz * ry), w * (pz * rx - px * rz), w * (px * ry - py * rx),
    ])


def gn_moments_plain(cx, cy, cz, source, center, kernel: float, max_dist: float) -> torch.Tensor:
    """[17] moments in plain PyTorch: the per-query terms, one sum each."""
    return gn_terms_plain(cx, cy, cz, source, center, kernel, max_dist).sum(dim=1)


def _check(cx, cy, cz, source):
    k, n = cx.shape
    for name, t, shape in (("cx", cx, (k, n)), ("cy", cy, (k, n)), ("cz", cz, (k, n)),
                           ("source", source, (n, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.device != cx.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, cx on {cx.device}")
    if n == 0:
        raise ValueError(f"{NAME}: no queries")


def gn_moments_from_cache(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, source: torch.Tensor,
    center: Sequence[float], kernel: float, max_dist: float,
) -> torch.Tensor:
    """[17] moment vector (see the module docstring) in one cache pass.

    cx, cy, cz: [K, N] champion coordinates (sentinel 2e19 in dead lanes);
    source: [N, 3] current source positions; center: 3 host floats."""
    _check(cx, cy, cz, source)
    if cx.device.type == "cpu":
        return gn_moments_plain(cx, cy, cz, source, center, kernel, max_dist)
    if cx.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {cx.device}")

    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn = _build.launcher("gn_moments", "gn_moments_launch", [P] * 4 + [F] * 5 + [I] * 2 + [P] * 3)
    k, n = cx.shape
    c0, c1, c2 = (float(v) for v in center)
    max_d2 = float(np.float32(max_dist) ** 2)
    partials = torch.empty((-(-n // _NT), _NPART), dtype=torch.float32, device=cx.device)
    out = torch.empty(_NPART, dtype=torch.float32, device=cx.device)
    stream = torch.cuda.current_stream(cx.device).cuda_stream
    err = fn(
        cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), source.data_ptr(),
        c0, c1, c2, float(kernel), max_d2, k, n,
        partials.data_ptr(), out.data_ptr(), stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out


def assemble_gn_system(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """17 moments -> (JTJ [6, 6], JTr [6], n_corr), on the moments' device."""
    sw = m[1]
    s1 = m[2:5]
    sxx, syy, szz, sxy, sxz, syz = m[5], m[6], m[7], m[8], m[9], m[10]
    zero = torch.zeros_like(sw)
    hat = torch.stack([
        torch.stack([zero, -s1[2], s1[1]]),
        torch.stack([s1[2], zero, -s1[0]]),
        torch.stack([-s1[1], s1[0], zero]),
    ])
    S2 = torch.stack([
        torch.stack([sxx, sxy, sxz]),
        torch.stack([sxy, syy, syz]),
        torch.stack([sxz, syz, szz]),
    ])
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    tr = sxx + syy + szz
    JTJ = torch.cat([
        torch.cat([sw * eye, -hat], dim=1),
        torch.cat([hat, tr * eye - S2], dim=1),
    ])
    return JTJ, m[11:17], m[0].to(torch.int32)
