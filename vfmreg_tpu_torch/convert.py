"""State carried across from the JAX package: the map index and ViT weights.

Scan-to-map registration has no learned weights; its state is the voxel hash
grid of the map. `grid_from_numpy` takes the arrays of a `vfmreg_tpu`
`HashGrid` (as numpy arrays, so this module needs no JAX) and returns the
port's `HashGrid` with the same layout, which lets the tests check matching
and ICP apart from the grid build. `vit_params_from_numpy` does the same for
the descriptor pass's ViT: the reference's parameter pytree, as numpy
arrays, becomes the port's `models.vit.ViT` state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vfmreg_tpu_torch.models.vit import ViTConfig
from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.utils.device import resolve_device


def grid_from_numpy(
    table, points, bucket_slab, feats, valid, voxel_size, max_points_per_voxel: int, device=None
) -> HashGrid:
    """The port's `HashGrid` from the reference grid's arrays
    (`table` [H/2, 24] int32, `points` [M, 3], `bucket_slab` [R, 128],
    `feats` [M, D] or None, `valid` [M] bool), on `device` (default: the card)."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    table = put(table, np.int32)
    if table.ndim != 2 or table.shape[1] != 24:
        raise ValueError(f"table must be [H/2, 24], got {tuple(table.shape)}")
    return HashGrid(
        table=table,
        points=put(points, np.float32),
        bucket_slab=put(bucket_slab, np.float32),
        feats=None if feats is None else put(feats, np.float32),
        valid=put(valid, np.bool_),
        voxel_size=float(np.asarray(voxel_size)),
        max_points_per_voxel=int(max_points_per_voxel),
    )


def vit_params_from_numpy(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """The port's `ViT` state dict (CPU tensors) from the reference's ViT
    parameter pytree (`init_vit_params` / `load_torch_state_dict`, leaves as
    numpy arrays): dense `w` [in, out] becomes `Linear.weight` [out, in], the
    patch weight goes from HWIO to OIHW. Load with `ViT(cfg).load_state_dict`."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if len(params["blocks"]) != cfg.num_layers:
        raise ValueError(f"{len(params['blocks'])} blocks for a {cfg.num_layers}-layer config")
    out = {
        "patch_embed.weight": t(np.asarray(params["patch_embed"]["w"]).transpose(3, 2, 0, 1)),
        "patch_embed.bias": t(params["patch_embed"]["b"]),
        "cls_token": t(params["cls_token"]),
        "pos_embed": t(params["pos_embed"]),
        "norm.weight": t(params["final_norm"]["scale"]),
        "norm.bias": t(params["final_norm"]["bias"]),
    }
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            out[f"{pre}{name}.weight"] = t(blk[name]["scale"])
            out[f"{pre}{name}.bias"] = t(blk[name]["bias"])
        for src, dst in (("q", "attn.q"), ("k", "attn.k"), ("v", "attn.v"), ("proj", "attn.proj"),
                         ("fc1", "fc1"), ("fc2", "fc2")):
            out[f"{pre}{dst}.weight"] = t(np.asarray(blk[src]["w"]).T)
            out[f"{pre}{dst}.bias"] = t(blk[src]["b"])
        out[f"{pre}ls1"] = t(blk["ls1"])
        out[f"{pre}ls2"] = t(blk["ls2"])
    return out
