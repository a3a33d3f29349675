"""State carried across from the JAX package: the map index and model weights.

Scan-to-map registration has no learned weights; its state is the voxel hash
grid of the map. `grid_from_numpy` takes the arrays of a `vfmreg_tpu`
`HashGrid` (as numpy arrays, so this module needs no JAX) and returns the
port's `HashGrid` with the same layout, which lets the tests check matching
and ICP apart from the grid build. `vit_params_from_numpy` does the same for
the descriptor pass's ViT: the reference's parameter pytree, as numpy
arrays, becomes the port's `models.vit.ViT` state dict;
`maskclip_params_from_numpy`, `jbu_stack_params_from_numpy` and
`clip_text_params_from_numpy` do it for MaskCLIP's visual tower, FeatUp's
JBU stack and CLIP's text tower, and `{dip,gedi,spinnet,pointdsc}_params_
from_numpy` for the baseline descriptor networks and PointDSC, whose port
modules keep the reference checkpoints' own layout, and
`resunet_params_from_numpy` for the FCGF / GCL ResUNet (the
MinkowskiEngine checkpoint's layout). Dense weights `w`
[in, out] become [out, in] as the checkpoints hold them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vfmreg_tpu_torch.models.clip_text import CLIPTextConfig
from vfmreg_tpu_torch.models.maskclip import MaskCLIPConfig
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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _clip_blocks(blocks, names) -> Dict[str, torch.Tensor]:
    """`transformer.resblocks.N.*` of the port's CLIP towers from the
    reference's block dicts; `names` = the reference's (ln_1, qkv, out, ln_2,
    fc, proj) keys and its LayerNorm (scale, bias) keys."""
    (ln1, qkv, out_, ln2, fc, proj), (scale, bias) = names
    out = {}
    for i, blk in enumerate(blocks):
        pre = f"transformer.resblocks.{i}."
        for src, dst in ((ln1, "ln_1"), (ln2, "ln_2")):
            out[f"{pre}{dst}.weight"] = _t(blk[src][scale])
            out[f"{pre}{dst}.bias"] = _t(blk[src][bias])
        out[f"{pre}attn.in_proj_weight"] = _t(np.asarray(blk[qkv]["w"]).T)
        out[f"{pre}attn.in_proj_bias"] = _t(blk[qkv]["b"])
        for src, dst in ((out_, "attn.out_proj"), (fc, "mlp.c_fc"), (proj, "mlp.c_proj")):
            out[f"{pre}{dst}.weight"] = _t(np.asarray(blk[src]["w"]).T)
            out[f"{pre}{dst}.bias"] = _t(blk[src]["b"])
    return out


def vit_params_from_numpy(params: Mapping[str, Any], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """The port's `ViT` state dict (CPU tensors) from the reference's ViT
    parameter pytree (`init_vit_params` / `load_torch_state_dict`, leaves as
    numpy arrays): dense `w` [in, out] becomes `Linear.weight` [out, in], the
    patch weight goes from HWIO to OIHW. Load with `ViT(cfg).load_state_dict`."""
    if len(params["blocks"]) != cfg.num_layers:
        raise ValueError(f"{len(params['blocks'])} blocks for a {cfg.num_layers}-layer config")
    out = {
        "patch_embed.weight": _t(np.asarray(params["patch_embed"]["w"]).transpose(3, 2, 0, 1)),
        "patch_embed.bias": _t(params["patch_embed"]["b"]),
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "norm.weight": _t(params["final_norm"]["scale"]),
        "norm.bias": _t(params["final_norm"]["bias"]),
    }
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            out[f"{pre}{name}.weight"] = _t(blk[name]["scale"])
            out[f"{pre}{name}.bias"] = _t(blk[name]["bias"])
        for src, dst in (("q", "attn.q"), ("k", "attn.k"), ("v", "attn.v"), ("proj", "attn.proj"),
                         ("fc1", "fc1"), ("fc2", "fc2")):
            out[f"{pre}{dst}.weight"] = _t(np.asarray(blk[src]["w"]).T)
            out[f"{pre}{dst}.bias"] = _t(blk[src]["b"])
        out[f"{pre}ls1"] = _t(blk["ls1"])
        out[f"{pre}ls2"] = _t(blk["ls2"])
    return out


def maskclip_params_from_numpy(params: Mapping[str, Any], cfg: MaskCLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's `models.maskclip.MaskCLIP` state dict from the reference's
    MaskCLIP pytree (`init_maskclip_params` / `load_clip_visual_state_dict`,
    leaves as numpy arrays): the patch weight from HWIO to OIHW, the fused
    qkv [D, 3D] to `in_proj_weight` [3D, D]. Load with
    `MaskCLIP(cfg).load_state_dict`."""
    if len(params["blocks"]) != cfg.num_layers:
        raise ValueError(f"{len(params['blocks'])} blocks for a {cfg.num_layers}-layer config")
    out = {
        "conv1.weight": _t(np.asarray(params["patch_embed"]).transpose(3, 2, 0, 1)),
        "class_embedding": _t(params["cls_embed"]),
        "positional_embedding": _t(params["pos_embed"]),
        "ln_pre.weight": _t(params["ln_pre"]["scale"]),
        "ln_pre.bias": _t(params["ln_pre"]["bias"]),
        "ln_post.weight": _t(params["ln_post"]["scale"]),
        "ln_post.bias": _t(params["ln_post"]["bias"]),
        "proj": _t(params["proj"]),
    }
    out.update(_clip_blocks(params["blocks"], (("ln1", "qkv", "out", "ln2", "fc1", "fc2"), ("scale", "bias"))))
    return out


def clip_text_params_from_numpy(params: Mapping[str, Any], cfg: CLIPTextConfig) -> Dict[str, torch.Tensor]:
    """The port's `models.clip_text.CLIPText` state dict from the reference's
    text-tower pytree (`init_clip_text_params` / `load_clip_text_state_dict`,
    leaves as numpy arrays). Load with `CLIPText(cfg).load_state_dict`."""
    if len(params["blocks"]) != cfg.num_layers:
        raise ValueError(f"{len(params['blocks'])} blocks for a {cfg.num_layers}-layer config")
    out = {
        "token_embedding.weight": _t(params["token_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "ln_final.weight": _t(params["ln_final"]["gamma"]),
        "ln_final.bias": _t(params["ln_final"]["beta"]),
        "text_projection": _t(params["text_projection"]),
    }
    out.update(_clip_blocks(params["blocks"], (("ln_1", "qkv", "out", "ln_2", "fc", "proj"), ("gamma", "beta"))))
    return out


def jbu_stack_params_from_numpy(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's `models.featup.JBUStack` state dict from the reference's JBU
    stack pytree (`init_jbu_stack_params` / `load_featup_state_dict`, leaves
    as numpy arrays): the 1 x 1 projections [in, out] become conv weights
    [out, in, 1, 1]. Load with `featup.stack_from_state_dict`."""
    out = {}
    for i, stage in enumerate(params["stages"], start=1):
        p = f"up{i}."
        out[p + "range_temp"] = _t(stage["range_temp"]).reshape(())
        out[p + "sigma_spatial"] = _t(stage["sigma_spatial"]).reshape(())
        for src, j in (("proj1", "0"), ("proj2", "3")):
            out[f"{p}range_proj.{j}.weight"] = _t(np.asarray(stage[src + "_w"]).T[:, :, None, None])
            out[f"{p}range_proj.{j}.bias"] = _t(stage[src + "_b"])
    out["fixup_proj.1.weight"] = _t(np.asarray(params["fixup_w"]).T[:, :, None, None])
    out["fixup_proj.1.bias"] = _t(params["fixup_b"])
    return out


# ----- baseline descriptors and PointDSC: the reference's pytrees -> the
# reference checkpoints' torch layout, which the port's modules keep.


def _dense_sd(out, key, p, ndim=2):
    """A dense {w [in, out], b} as `key.weight` [out, in, 1...] (+ bias)."""
    w = np.asarray(p["w"]).T
    out[key + ".weight"] = _t(w.reshape(w.shape + (1,) * (ndim - 2)))
    if p.get("b") is not None:
        out[key + ".bias"] = _t(p["b"])


def _bn_sd(out, key, p):
    """A BatchNorm {gamma, beta, mean, var} (affine=False: mean, var)."""
    if "gamma" in p:
        out[key + ".weight"] = _t(p["gamma"])
        out[key + ".bias"] = _t(p["beta"])
    out[key + ".running_mean"] = _t(p["mean"])
    out[key + ".running_var"] = _t(p["var"])
    out[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def dip_params_from_numpy(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`models.dip.DIPNet`'s state dict from the reference's DIP pytree
    (`init_dip_params` / `load_dip_state_dict`, leaves as numpy arrays).
    Load with `models.dip.load_dip_state_dict`."""
    out: Dict[str, torch.Tensor] = {}

    def tower(prefix, p, bn5):
        for i in (1, 2, 3):
            _dense_sd(out, f"{prefix}conv{i}.0", p[f"conv{i}"], 3)
            _bn_sd(out, f"{prefix}conv{i}.1", p[f"bn{i}"])
        _dense_sd(out, f"{prefix}fc1.0", p["fc1"])
        _bn_sd(out, f"{prefix}fc1.1", p["bn4"])
        _dense_sd(out, f"{prefix}fc2.0", p["fc2"])
        _bn_sd(out, f"{prefix}{bn5}", p["bn5"])
        _dense_sd(out, f"{prefix}fc3.0", p["fc3"])

    tower("", params, "fc2.2")  # a Dropout at fc2.1 in the main tower
    tower("stn3d.", params["stn"], "fc2.1")
    return out


def gedi_params_from_numpy(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`models.gedi.GeDiNet`'s state dict from the reference's GeDi pytree
    (`init_gedi_params` / `load_gedi_state_dict`, leaves as numpy arrays).
    Load with `models.gedi.load_gedi_state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    q = params["qnet"]
    for i in (1, 2, 3):
        _dense_sd(out, f"qnet.conv{i}.0", q[f"conv{i}"], 3)
        _bn_sd(out, f"qnet.conv{i}.1", q[f"bn{i}"])
    _dense_sd(out, "qnet.fc1.0", q["fc1"])
    _bn_sd(out, "qnet.fc1.1", q["bn4"])
    _dense_sd(out, "qnet.fc2.0", q["fc2"])
    _bn_sd(out, "qnet.fc2.1", q["bn5"])
    _dense_sd(out, "qnet.fc3", q["fc3"])
    for j in (1, 2, 3):
        for i, layer in enumerate(params[f"sa{j}"]):
            _dense_sd(out, f"samodule{j}.mlps.0.{3 * i}", layer["conv"], 4)
            _bn_sd(out, f"samodule{j}.mlps.0.{3 * i + 1}", layer["bn"])
    for layer, (d, b) in zip(params["fc"], ((0, 1), (3, 4), (7, None))):
        _dense_sd(out, f"fc_layer.{d}", layer["dense"])
        if b is not None:
            _bn_sd(out, f"fc_layer.{b}", layer["bn"])
    return out


def spinnet_params_from_numpy(params: Mapping[str, Any], dim: int = 32) -> Dict[str, torch.Tensor]:
    """`models.spinnet.SpinNet`'s state dict from the reference's SpinNet
    pytree (`init_spinnet_params` / `load_spinnet_state_dict`, leaves as
    numpy arrays): DHWIO / HWIO kernels to OIDHW / OIHW; `bn_mapping`, which
    the reference's pytree lacks and no forward reads, is the identity.
    Load with `models.spinnet.load_spinnet_state_dict`."""
    from vfmreg_tpu_torch.models.spinnet import SpinNet

    out: Dict[str, torch.Tensor] = {
        "xyz_raising.weight": _t(np.asarray(params["xyz_raising"]["w"]).transpose(3, 2, 0, 1)),
        "xyz_raising.bias": _t(params["xyz_raising"]["b"]),
    }
    _bn_sd(out, "bn_xyz_raising", params["bn_xyz"])
    _bn_sd(out, "bn_mapping", {"gamma": np.ones(16), "beta": np.zeros(16), "mean": np.zeros(16), "var": np.ones(16)})
    convs = iter(list(params["conv3d"]) + list(params["conv2d"]))
    layer = None
    for i, op in enumerate(SpinNet(dim).conv_net.ops):
        if isinstance(op, (torch.nn.Conv3d, torch.nn.Conv2d)):
            layer = next(convs)
            w = np.asarray(layer["w"])
            perm = (4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1)
            out[f"conv_net.ops.{i}.weight"] = _t(w.transpose(perm))
            out[f"conv_net.ops.{i}.bias"] = _t(layer["b"])
        elif isinstance(op, (torch.nn.BatchNorm3d, torch.nn.BatchNorm2d)):
            _bn_sd(out, f"conv_net.ops.{i}", layer["bn"])
    return out


def pointdsc_params_from_numpy(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """`models.pointdsc.PointDSCNet`'s state dict from the reference's
    PointDSC pytree (`init_pointdsc_params` / `load_pointdsc_state_dict`,
    leaves as numpy arrays); `sigma_spat`, which no forward reads, is 1.
    Load with `models.pointdsc.load_pointdsc_state_dict`."""
    out: Dict[str, torch.Tensor] = {
        "sigma": _t(params["sigma"]).reshape(1),
        "sigma_spat": torch.ones(1),
    }
    _dense_sd(out, "encoder.layer0", params["layer0"], 3)
    for i, blk in enumerate(params["blocks"]):
        pcn, nl = f"encoder.blocks.PointCN_layer_{i}", f"encoder.blocks.NonLocal_layer_{i}"
        _dense_sd(out, f"{pcn}.0", blk["pointcn"]["dense"], 3)
        _bn_sd(out, f"{pcn}.1", blk["pointcn"]["bn"])
        for name in ("q", "k", "v"):
            _dense_sd(out, f"{nl}.projection_{name}", blk[name], 3)
        _dense_sd(out, f"{nl}.fc_message.0", blk["msg1"]["dense"], 3)
        _bn_sd(out, f"{nl}.fc_message.1", blk["msg1"]["bn"])
        _dense_sd(out, f"{nl}.fc_message.3", blk["msg2"]["dense"], 3)
        _bn_sd(out, f"{nl}.fc_message.4", blk["msg2"]["bn"])
        _dense_sd(out, f"{nl}.fc_message.6", blk["msg3"], 3)
    for layer, j in zip(params["classification"], (0, 2, 4)):
        _dense_sd(out, f"classification.{j}", layer, 3)
    return out


def resunet_params_from_numpy(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """`models.sparse_resunet.SparseResUNet`'s state dict (the
    MinkowskiEngine checkpoint's layout) from the reference's ResUNet pytree
    (`init_resunet_params` / `load_me_state_dict`, leaves as numpy arrays)
    for the configuration `cfg`. Load with
    `models.sparse_resunet.load_me_state_dict`."""
    out: Dict[str, torch.Tensor] = {}

    def kern(key, w):
        w = np.asarray(w)
        out[key + ".kernel"] = _t(w[0] if w.shape[0] == 1 else w)  # 1 x 1 kernels are 2-D

    def norm(key, p):
        out[key + ".bn.weight"] = _t(p["gamma"])
        out[key + ".bn.bias"] = _t(p["beta"])
        out[key + ".bn.running_mean"] = _t(p["mean"])
        out[key + ".bn.running_var"] = _t(p["var"])
        out[key + ".bn.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    for i in ("1", "2", "3", "4", "4_tr", "3_tr", "2_tr"):
        kern(f"conv{i}", params[f"conv{i}"])
        norm(f"norm{i}", params[f"norm{i}"])
        blk = params[f"block{i}"]
        for j in (1, 2):
            kern(f"block{i}.conv{j}", blk[f"conv{j}"])
            norm(f"block{i}.norm{j}", blk[f"bn{j}"])
    kern("conv1_tr", params["conv1_tr"])
    kern("final", params["final"]["w"])
    out["final.bias"] = _t(params["final"]["b"]).reshape(1, cfg.out_channels)
    return out
