"""Plain reference of the `dinov2-vitg14-reg` configuration: the descriptor
pass with DINOv2 ViT-g/14 with registers.

Written from the published model (Oquab et al., arXiv:2304.07193; Darcet et
al., arXiv:2309.16588; facebookresearch/dinov2's hub `dinov2_vitg14_reg`)
in plain PyTorch, float32 with TF32 off. Nothing here imports the program.
With D the width, H heads of hd = D / H, F the SwiGLU's hidden width and R
register tokens:

* the image, uint8 [H, W, 3], resized bilinearly (align_corners=False, no
  antialias) to 14 * patch_h rows and 14 * int(14 * patch_h / H * W / 14)
  columns, over 255, ImageNet-normalised;
* patch embedding: the 14 x 14 / stride-14 convolution with bias as an
  unfold and a matmul; x = [cls + pos_0 ; patches + resize(pos_1..)] with
  resize the bicubic F.interpolate (align_corners=False, antialias as the
  configuration says) of the 37 x 37 grid to (h, w); then the R registers
  inserted after cls, with no position embedding: T = 1 + R + h w tokens;
* each block: x += ls1 * Proj(MHSA(LN1(x))), with qkv bias and the softmax
  of q k^T / sqrt(hd) written out; x += ls2 * W3(silu(a) * b), [a ; b] =
  W12 LN2(x) split in halves; a final LN (eps 1e-6); the patch features
  are x[1 + R:] as [h, w, D];
* each point projected into each camera by the pinhole model: p_c = E
  [p; 1] with the camera's LiDAR-to-camera extrinsic E, kept where its depth
  z > 0, u = f x / z + cx and v = f y / z + cy truncated to pixels, and
  dropped where u or v falls outside the image;
* the patch grid sampled bilinearly at each projected pixel (u, v) with
  align_corners=False, edge-clamped (`F.grid_sample`, border padding);
  zeros where the pixel is empty; the first camera that sees a point gives
  its descriptor; points no camera sees get zeros.

It runs one image at a time. The rig's images and calibration (extrinsics,
focal length, principal point) are data, as a dataset's images and
calibration files would be; the weights are the scene's
(`traffic/rig_scene.hub_weights`, drawn before the program runs), in the
hub's layout (`blocks.i.attn.qkv`, `mlp.w12`, `mlp.w3`, `register_tokens`,
`ls1.gamma`).

Departures from the published model, as the benchmark runs it: random
weights drawn from the seed, not the released checkpoint; LayerScale 1.0
(the hub's init value); seeded noise images in place of camera images.

`answers` gives, for each distinct batch, every scan's covered points and
the descriptors of its kept rows; `judge` holds every call's output to them.
With `tf32=True` every product runs on TF32-rounded operands
(`plain.mm`): the control that the comparison must reject.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """x [T, in] @ w [out, in]^T + b."""
    return plain.mm(x, w.T.contiguous(), tf32) + b


def preprocess(image: np.ndarray, patch: int, patch_h: int, dev) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalised [1, 3, patch * patch_h, patch * patch_w] f32."""
    img_h, img_w = image.shape[:2]
    patch_w = int((patch * patch_h) / img_h * img_w / patch)
    x = torch.from_numpy(np.ascontiguousarray(image)).to(dev).float().permute(2, 0, 1)[None] / 255.0
    x = F.interpolate(x, size=(patch * patch_h, patch * patch_w), mode="bilinear", align_corners=False,
                      antialias=False)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=dev)[None, :, None, None]
    return (x - mean) / std


def vit_patches(w: Dict[str, torch.Tensor], cfg: Dict, image: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The ViT's patch features [h, w, D] of one normalised image [1, 3, H, W]."""
    p, d, heads, eps = cfg["patch_size"], cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = d // heads
    f = cfg["ffn_hidden_size"]
    gh, gw = image.shape[2] // p, image.shape[3] // p
    cols = F.unfold(image, kernel_size=p, stride=p)[0].T  # [h w, 3 p p] in (c, kh, kw) order
    patches = linear(cols, w["patch_embed.proj.weight"].reshape(d, -1), w["patch_embed.proj.bias"], tf32)
    pos = w["pos_embed"][0]
    g = int(math.isqrt(pos.shape[0] - 1))
    grid = pos[1:].reshape(g, g, d).permute(2, 0, 1)[None]
    if (gh, gw) != (g, g):
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False,
                             antialias=cfg["interpolate_antialias"])
    x = torch.cat([w["cls_token"][0] + pos[:1], patches + grid[0].permute(1, 2, 0).reshape(gh * gw, d)])
    regs = w["register_tokens"][0] if cfg["num_register_tokens"] else x[:0]
    x = torch.cat([x[:1], regs, x[1:]])
    t = x.shape[0]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        h = F.layer_norm(x, (d,), w[b + "norm1.weight"], w[b + "norm1.bias"], eps)
        qkv = linear(h, w[b + "attn.qkv.weight"], w[b + "attn.qkv.bias"], tf32).reshape(t, 3, heads, hd)
        q, k, v = (qkv[:, j].transpose(0, 1).contiguous() for j in range(3))  # [heads, T, hd]
        logits = plain.mm(q, k.transpose(1, 2).contiguous(), tf32) / math.sqrt(hd)  # [heads, T, T]
        e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        probs = e / e.sum(dim=-1, keepdim=True)
        att = plain.mm(probs, v, tf32).transpose(0, 1).reshape(t, d)
        x = x + w[b + "ls1.gamma"] * linear(att, w[b + "attn.proj.weight"], w[b + "attn.proj.bias"], tf32)
        h = F.layer_norm(x, (d,), w[b + "norm2.weight"], w[b + "norm2.bias"], eps)
        ab = linear(h, w[b + "mlp.w12.weight"], w[b + "mlp.w12.bias"], tf32)
        a, g2 = ab[:, :f], ab[:, f:]
        hidden = a * torch.sigmoid(a) * g2
        x = x + w[b + "ls2.gamma"] * linear(hidden, w[b + "mlp.w3.weight"], w[b + "mlp.w3.bias"], tf32)
    x = F.layer_norm(x, (d,), w["norm.weight"], w["norm.bias"], eps)
    return x[1 + cfg["num_register_tokens"]:].reshape(gh, gw, d)


def sample(feats: torch.Tensor, u: np.ndarray, v: np.ndarray, img_h: int, img_w: int) -> torch.Tensor:
    """The patch grid [h, w, D] upsampled bilinearly (align_corners=False)
    to img_h x img_w and read at the pixels (v, u): [n, D]."""
    dev = feats.device
    gx = (torch.from_numpy(u).to(dev, torch.float32) + 0.5) * (2.0 / img_w) - 1.0
    gy = (torch.from_numpy(v).to(dev, torch.float32) + 0.5) * (2.0 / img_h) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None, None]  # [1, 1, n, 2]
    out = F.grid_sample(feats.permute(2, 0, 1)[None], grid, mode="bilinear", padding_mode="border",
                        align_corners=False)
    return out[0, :, 0].T


def project(calibration: Dict, camera: int, cloud: np.ndarray, img_h: int, img_w: int):
    """(u, v, idx): the pixels of the points of `cloud` [N, 3] that land in
    camera `camera`'s img_h x img_w image, and their rows."""
    pc = calibration["extrinsics"][camera] @ np.insert(cloud, 3, values=1, axis=1).T  # [4, N]
    idx = np.flatnonzero(pc[2] > 0)
    (x, y, z), (cx, cy) = pc[:3, idx], calibration["principal_point"]
    u = calibration["focal"] * x / z + cx
    v = calibration["focal"] * y / z + cy
    inside = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    return u[inside].astype(np.int64), v[inside].astype(np.int64), idx[inside]


def descriptors(state: Dict, images: List[np.ndarray], cloud: np.ndarray, tf32: bool = False):
    """(descriptors [n, D], covered [n] bool) of one scan from its camera
    images (camera order) and its cloud [n, 3]."""
    cfg, w = state["cfg"], state["weights"]
    dev = w["cls_token"].device
    n = cloud.shape[0]
    out = torch.zeros((n, cfg["hidden_size"]), dtype=torch.float32, device=dev)
    taken = np.zeros(n, dtype=bool)
    covered = np.zeros(n, dtype=bool)
    for camera, image in enumerate(images):
        u, v, idx = project(state["calibration"], camera, cloud, image.shape[0], image.shape[1])
        feats = vit_patches(w, cfg, preprocess(image, cfg["patch_size"], cfg["patch_h"], dev), tf32)
        if len(idx) == 0:
            continue
        vals = sample(feats, u, v, image.shape[0], image.shape[1])
        empty = np.all(image[v, u] == 0, axis=-1)
        vals[torch.from_numpy(empty).to(dev)] = 0.0
        new = ~taken[idx]  # a camera sees a point once: the first camera that sees it decides
        rows = torch.from_numpy(idx[new]).to(dev)
        out[rows] = vals[torch.from_numpy(new).to(dev)]
        covered[idx[new]] = ~empty[new]
        taken[idx] = True
    return out, covered


def prepare(data, cfg: Dict) -> Dict:
    """The scene, its weights (hub layout) and its calibration, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"data": data, "cfg": cfg, "weights": data.weights, "calibration": data.calibration}


def answers(state: Dict, tf32: bool = False, batches: Optional[List[int]] = None) -> List[Optional[Dict]]:
    """[{"covered": [B] x [N] bool, "kept": [B] x [K, D] f32}] for each
    distinct batch (None for those left out of `batches`, when given)."""
    data, cfg = state["data"], state["cfg"]
    out = []
    with torch.no_grad():
        for k, batch in enumerate(data.batches):
            if batches is not None and k not in batches:
                out.append(None)
                continue
            covered, kept = [], []
            for files, cloud, rows in zip(batch["files"], batch["clouds"], batch["kept"]):
                images = [data.rig.images[str(f)] for f in files]  # camera order
                desc, cov = descriptors(state, images, cloud, tf32)
                covered.append(cov)
                kept.append(desc[torch.from_numpy(rows).to(desc.device)].cpu().numpy())
            out.append({"covered": covered, "kept": kept})
    return out


def judge(state: Dict, outputs: List[Dict], reference: List[Dict]) -> Dict[str, float]:
    """The compared numbers over every call of the window: `outputs[i]` is
    call i's {"batch": k, "covered", "kept"}, `reference[k]` batch k's
    answers. coverage_diff: the most points of one scan whose coverage
    differs; desc_rel_err_max: the largest |program - reference| /
    |reference| (Euclidean, per kept row) over every scan."""
    cov = err = 0.0
    for o in outputs:
        ref = reference[o["batch"]]
        for c, rc, kp, rk in zip(o["covered"], ref["covered"], o["kept"], ref["kept"]):
            cov = max(cov, float(np.count_nonzero(np.asarray(c) != rc)))
            a, r = np.asarray(kp, dtype=np.float64), rk.astype(np.float64)
            rel = np.linalg.norm(a - r, axis=1) / np.maximum(np.linalg.norm(r, axis=1), 1e-30)
            err = max(err, float(np.nan_to_num(rel, nan=np.inf).max(initial=0.0)))
    return {"coverage_diff": cov, "desc_rel_err_max": err}
