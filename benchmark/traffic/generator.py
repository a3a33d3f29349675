"""The benchmark's one scene generator, driven by a traffic file's parameters.

Two kinds of scene, both made on the device from `--seed` with one
`torch.Generator` in a few large calls:

* `shared_map`: one world map (points uniform in a box, descriptors
  sin(p W * feature_scale) of a normal 3 x D matrix W) and batches of scans,
  each `n_scan` map points drawn without replacement, jittered by a normal
  `point_noise_m`, and observed from a frame misaligned by a rotation of
  `offset_deg` about a random axis and a translation of `offset_m` in a
  random direction; a scan's true pose maps it back into the map.
  The scene of the paper's headline scan-to-map registration, as the JAX
  package's benchmark draws it (the same distributions; other numbers from
  the same seed, which numpy drew there).
* `regions`: the evaluation driver's scene: `ground_share` of the map's
  points on the ground (z below `ground_height_m`), the rest up to
  `height_m`; each scan samples the map within `region_radius_m` of a
  centre drawn in `centre_share` x the extent, in the scan's own frame (the
  map frame shifted to the centre), with its map descriptors; its stored GT
  pose is the true one (the shift) with a release GT's error: a rotation of
  `gt_error_deg`, a translation of `gt_error_m`.

Every scan has the same point count, so every seed runs the same shapes.
`batches` distinct batches of `batch` scans are made, which the window
cycles through. The scans' poses (offsets, or centres and GT errors) are
one set drawn from `pose_seed`, batch by batch, the same for every run;
`--seed` draws the order of the batches, the map, its descriptors and the
scans' points. The registration work, whose iteration counts follow the
poses, is then the same set of batches in every run, in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class SharedMapScene:
    seed: int
    map_points: torch.Tensor  # [M, 3] f32
    map_feats: torch.Tensor  # [M, D] f32
    batches: List[Dict]  # "scans" [B, N, 3], "feats" [B, N, D], "true_poses" [B, 4, 4] f64 numpy


@dataclasses.dataclass
class RegionScene:
    seed: int
    local_map: torch.Tensor  # [M, 3 + D] f32
    batches: List[Dict]  # "raw" [B, N, 3 + D], "mask" [B, N], "gt_poses", "true_poses" [B, 4, 4] f64 numpy


def _uniform(g, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev, dtype=torch.float64)


def _descriptors(points: torch.Tensor, W: torch.Tensor, scale: float) -> torch.Tensor:
    """sin(p W * scale) with the 3-term product written out in f32, so that
    no matmul setting changes it."""
    pw = points[:, 0:1] * W[0] + points[:, 1:2] * W[1] + points[:, 2:3] * W[2]
    return torch.sin(pw * scale)


def _rotations(g, n: int, deg_lo: float, deg_hi: float, dev) -> torch.Tensor:
    """[n, 3, 3] f64 rotations by an angle in [deg_lo, deg_hi] about a uniformly random axis."""
    axis = torch.randn((n, 3), generator=g, device=dev, dtype=torch.float64)
    axis = axis / torch.linalg.vector_norm(axis, dim=1, keepdim=True)
    ang = torch.deg2rad(_uniform(g, (n,), deg_lo, deg_hi, dev))
    z = torch.zeros(n, dtype=torch.float64, device=dev)
    K = torch.stack([torch.stack([z, -axis[:, 2], axis[:, 1]], -1),
                     torch.stack([axis[:, 2], z, -axis[:, 0]], -1),
                     torch.stack([-axis[:, 1], axis[:, 0], z], -1)], -2)
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    return eye + torch.sin(ang)[:, None, None] * K + (1 - torch.cos(ang))[:, None, None] * (K @ K)


def _translations(g, n: int, lo: float, hi: float, dev) -> torch.Tensor:
    d = torch.randn((n, 3), generator=g, device=dev, dtype=torch.float64)
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True) * _uniform(g, (n, 1), lo, hi, dev)


def shared_map(cfg: Dict, traffic: Dict, seed: int, dev: torch.device) -> SharedMapScene:
    g = torch.Generator(device=dev).manual_seed(int(seed))
    m, n, d = cfg["n_map"], cfg["n_scan"], cfg["descriptor_dim"]
    ext = traffic["extent_m"]
    mp = torch.cat([_uniform(g, (m, 2), -ext, ext, dev), _uniform(g, (m, 1), 0.0, traffic["height_m"], dev)],
                   dim=1).float()
    W = torch.randn((3, d), generator=g, device=dev)
    mf = _descriptors(mp, W, traffic["feature_scale"])
    b, nb = traffic["batch"], traffic["batches"]
    gp = torch.Generator(device=dev).manual_seed(int(traffic["pose_seed"]))
    R_all = _rotations(gp, nb * b, *traffic["offset_deg"], dev)
    t_all = _translations(gp, nb * b, *traffic["offset_m"], dev)
    batches = []
    for k in torch.randperm(nb, generator=g, device=dev).tolist():
        sel = torch.stack([torch.randperm(m, generator=g, device=dev)[:n] for _ in range(b)])  # [B, N]
        pts = mp[sel] + traffic["point_noise_m"] * torch.randn((b, n, 3), generator=g, device=dev)
        R, t = R_all[k * b:(k + 1) * b], t_all[k * b:(k + 1) * b]
        # The scan frame: (p - t) R, so T = [R | t] maps it back onto the map.
        local = ((pts.double() - t[:, None, :]) @ R).float()
        T = torch.eye(4, dtype=torch.float64, device=dev).repeat(b, 1, 1)
        T[:, :3, :3], T[:, :3, 3] = R, t
        batches.append({"scans": local.contiguous(), "feats": mf[sel].contiguous(),
                        "true_poses": T.cpu().numpy()})
    return SharedMapScene(int(seed), mp, mf, batches)


def regions(cfg: Dict, traffic: Dict, seed: int, dev: torch.device) -> RegionScene:
    g = torch.Generator(device=dev).manual_seed(int(seed))
    m, n, d = cfg["n_map"], cfg["n_scan"], cfg["descriptor_dim"]
    ext = traffic["extent_m"]
    n_ground = int(m * traffic["ground_share"])
    xy = _uniform(g, (m, 2), -ext, ext, dev)
    z = torch.cat([_uniform(g, (n_ground,), 0.0, traffic["ground_height_m"], dev),
                   _uniform(g, (m - n_ground,), 0.0, traffic["height_m"], dev)])
    z = z[torch.randperm(m, generator=g, device=dev)]
    mp = torch.cat([xy, z[:, None]], dim=1).float()
    W = torch.randn((3, d), generator=g, device=dev)
    local_map = torch.cat([mp, _descriptors(mp, W, traffic["feature_scale"])], dim=1)
    b, nb, radius = traffic["batch"], traffic["batches"], traffic["region_radius_m"]
    span = ext * traffic["centre_share"]
    gp = torch.Generator(device=dev).manual_seed(int(traffic["pose_seed"]))
    centres_all = _uniform(gp, (nb * b, 2), -span, span, dev)
    R_all = _rotations(gp, nb * b, *traffic["gt_error_deg"], dev)
    t_all = _translations(gp, nb * b, *traffic["gt_error_m"], dev)
    batches = []
    for k in torch.randperm(nb, generator=g, device=dev).tolist():
        centres = centres_all[k * b:(k + 1) * b]
        raws, true = [], []
        for c in centres:
            d2 = ((mp[:, :2].double() - c) ** 2).sum(dim=1)
            near = d2 < radius * radius
            if int(near.sum()) < n:
                raise ValueError(f"{int(near.sum())} map points within {radius} m of a centre, fewer than {n}")
            # n of the near points, uniformly without replacement.
            key = torch.where(near, torch.rand(m, generator=g, device=dev), 2.0)
            sel = torch.topk(key, n, largest=False).indices
            pts = mp[sel] + traffic["point_noise_m"] * torch.randn((n, 3), generator=g, device=dev)
            T = torch.eye(4, dtype=torch.float64, device=dev)
            T[:2, 3] = c
            local = (pts.double() - T[:3, 3]).float()
            raws.append(torch.cat([local, local_map[sel, 3:]], dim=1))
            true.append(T)
        R, t = R_all[k * b:(k + 1) * b], t_all[k * b:(k + 1) * b]
        true_t = torch.stack(true)
        noisy = true_t.clone()
        noisy[:, :3, :3] = R @ true_t[:, :3, :3]
        noisy[:, :3, 3] += t
        batches.append({"raw": torch.stack(raws).contiguous(),
                        "mask": torch.ones((b, n), dtype=torch.bool, device=dev),
                        "gt_poses": noisy.cpu().numpy(), "true_poses": true_t.cpu().numpy()})
    return RegionScene(int(seed), local_map.contiguous(), batches)


KINDS = {"shared_map": shared_map, "regions": regions}


def make(cfg: Dict, traffic: Dict, seed: int, dev: torch.device):
    """The scene that the traffic file's "scene" names, at the configuration's sizes."""
    return KINDS[traffic["scene"]](cfg, traffic, seed, dev)
