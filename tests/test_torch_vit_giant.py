"""The port's DINOv2 ViT-g/14 with registers (`models.vit`, preset
`dinov2_vitg14_reg`) against the benchmark's plain reference
(`benchmark/reference/descriptor_pass.py`, plain PyTorch written from the
published model), on seeded random weights in the hub's checkpoint layout
loaded through `load_dinov2_state_dict`:

* at small widths (D 48, 4 layers, 3 heads of 16, SwiGLU F 128, 4
  registers, the preset's 37 x 37 position grid resized to 16 x 20 with
  antialias) on one 224 x 280 image, with B5's wrapper and plain attention;
* the SwiGLU hidden-width rule, the antialiased resize against
  `F.interpolate`, patches that exclude the registers, both checkpoint
  layouts, `init_vit`'s scales, the preset's parameter count on the `meta`
  device (1,136,485,376) and `create_descriptors` at 1536-d (one block) on
  a small rig, coverage exact.

Tolerances. Patch features: atol 2e-5 at small widths (values of order 1-3;
the two sum the f32 products in other orders: the reference's patch
embedding unfolds in (c, kh, kw) order, the port's in (kh, kw, c); its
attention is one batched product, the port's per head; readings ~3e-6).
At 1536-d: descriptors within atol 1e-4 (sums over 1,536 terms; readings
~1e-5). Resize weights 1e-6 against `F.interpolate` (one matmul against
torch's separable passes). Converted weights exactly equal.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from benchmark.reference import descriptor_pass as ref  # noqa: E402
from vfmreg_tpu_torch.models import vit  # noqa: E402
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, preprocess_image  # noqa: E402
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PRESET = vit.PRESETS["dinov2_vitg14_reg"]
SMALL = dataclasses.replace(PRESET, hidden_size=48, num_layers=4, num_heads=3)
ATOL, DESC_ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_config(cfg: vit.ViTConfig) -> dict:
    """The reference's configuration (the benchmark file's keys) of a port config."""
    return {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "ffn_hidden_size": cfg.ffn_hidden,
            "num_register_tokens": cfg.num_register_tokens, "patch_size": cfg.patch_size,
            "layer_norm_eps": cfg.layernorm_eps, "interpolate_antialias": cfg.interpolate_antialias,
            "patch_h": 16}


def hub_checkpoint(cfg: vit.ViTConfig, layout: str = "facebook", seed: int = 0) -> dict:
    """A random checkpoint in facebookresearch/dinov2's ("facebook") or
    transformers' layout, numpy-valued, with the unused mask token."""
    rng = np.random.RandomState(seed)
    d, p, f = cfg.hidden_size, cfg.patch_size, cfg.ffn_hidden

    def r(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    fb = {"patch_embed.proj.weight": r(d, 3, p, p, std=0.02), "patch_embed.proj.bias": r(d, std=0.02),
          "cls_token": r(1, 1, d, std=0.02), "pos_embed": r(1, 1 + cfg.pos_grid**2, d, std=0.02),
          "register_tokens": r(1, cfg.num_register_tokens, d, std=0.02), "mask_token": r(1, d),
          "norm.weight": 1 + r(d, std=0.1), "norm.bias": r(d, std=0.1)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}."
        fb.update({b + "norm1.weight": 1 + r(d, std=0.1), b + "norm1.bias": r(d, std=0.1),
                   b + "attn.qkv.weight": r(3 * d, d, std=d**-0.5), b + "attn.qkv.bias": r(3 * d, std=0.1),
                   b + "attn.proj.weight": r(d, d, std=d**-0.5), b + "attn.proj.bias": r(d, std=0.1),
                   b + "ls1.gamma": 1 + r(d, std=0.1), b + "norm2.weight": 1 + r(d, std=0.1),
                   b + "norm2.bias": r(d, std=0.1), b + "mlp.w12.weight": r(2 * f, d, std=d**-0.5),
                   b + "mlp.w12.bias": r(2 * f, std=0.1), b + "mlp.w3.weight": r(d, f, std=f**-0.5),
                   b + "mlp.w3.bias": r(d, std=0.1), b + "ls2.gamma": 1 + r(d, std=0.1)})
    if layout == "facebook":
        return fb
    tf = {"embeddings.patch_embeddings.projection.weight": fb["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias": fb["patch_embed.proj.bias"],
          "embeddings.cls_token": fb["cls_token"], "embeddings.mask_token": fb["mask_token"],
          "embeddings.position_embeddings": fb["pos_embed"], "embeddings.register_tokens": fb["register_tokens"],
          "layernorm.weight": fb["norm.weight"], "layernorm.bias": fb["norm.bias"]}
    for i in range(cfg.num_layers):
        s, b = f"blocks.{i}.", f"encoder.layer.{i}."
        for j, name in enumerate(("query", "key", "value")):
            tf[f"{b}attention.attention.{name}.weight"] = fb[s + "attn.qkv.weight"][j * d:(j + 1) * d]
            tf[f"{b}attention.attention.{name}.bias"] = fb[s + "attn.qkv.bias"][j * d:(j + 1) * d]
        for p_ in ("weight", "bias"):
            tf[f"{b}attention.output.dense.{p_}"] = fb[f"{s}attn.proj.{p_}"]
            tf[f"{b}norm1.{p_}"], tf[f"{b}norm2.{p_}"] = fb[f"{s}norm1.{p_}"], fb[f"{s}norm2.{p_}"]
            tf[f"{b}mlp.weights_in.{p_}"], tf[f"{b}mlp.weights_out.{p_}"] = fb[f"{s}mlp.w12.{p_}"], fb[f"{s}mlp.w3.{p_}"]
        tf[f"{b}layer_scale1.lambda1"], tf[f"{b}layer_scale2.lambda1"] = fb[s + "ls1.gamma"], fb[s + "ls2.gamma"]
    return tf


def port_model(cfg, checkpoint, flash=True):
    cfg = dataclasses.replace(cfg, use_flash_attention=flash)
    model = vit.ViT(cfg)
    model.load_state_dict(vit.load_dinov2_state_dict(checkpoint, cfg))
    return model.eval()


def rig_image(seed=0, size=(1232, 1616)):
    return np.random.RandomState(seed).randint(0, 256, (*size, 3)).astype(np.uint8)


@pytest.mark.parametrize("flash", [True, False])
def test_patch_features_match_the_reference(flash):
    ckpt = hub_checkpoint(SMALL)
    weights = {k: torch.from_numpy(v) for k, v in ckpt.items()}
    image = rig_image()
    with torch.no_grad():
        x, _ = preprocess_image(image, 14, 16, device="cpu")
        got = port_model(SMALL, ckpt, flash)(x)["patches"][0]
        want = ref.vit_patches(weights, ref_config(SMALL), ref.preprocess(image, 14, 16, "cpu"))
    assert tuple(got.shape) == tuple(want.shape) == (16, 20, 48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert float(want.abs().max()) > 0.5


@pytest.mark.parametrize("d, ratio, want", [(1536, 4, 4096), (1024, 4, 2736), (384, 4, 1024), (48, 4, 128)])
def test_swiglu_hidden_width(d, ratio, want):
    cfg = dataclasses.replace(PRESET, hidden_size=d, mlp_ratio=ratio)
    assert cfg.ffn_hidden == want == (int(d * ratio * 2 / 3) + 7) // 8 * 8
    assert dataclasses.replace(cfg, ffn="mlp").ffn_hidden == d * ratio
    with pytest.raises(ValueError, match="unknown FFN kind"):
        _ = dataclasses.replace(cfg, ffn="geglu").ffn_hidden


@pytest.mark.parametrize("g, gh, gw", [(37, 16, 20), (37, 4, 5), (37, 30, 41), (4, 6, 8)])
def test_antialiased_resize_matches_interpolate(g, gh, gw):
    rng = np.random.RandomState(g + gh)
    pos = torch.from_numpy(rng.normal(size=(1, 1 + g * g, 8)).astype(np.float32))
    cfg = dataclasses.replace(PRESET, hidden_size=8, num_heads=1, pretrain_img_size=14 * g)
    got = vit.interpolate_pos_embed(pos, gh, gw, cfg, antialias=True)
    grid = pos[0, 1:].reshape(1, g, g, 8).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False, antialias=True)
    np.testing.assert_allclose(got[0, 1:].reshape(gh, gw, 8).numpy(), want[0].permute(1, 2, 0).numpy(),
                               atol=1e-6, rtol=0)
    assert torch.equal(got[:, :1], pos[:, :1])
    # torch's antialiased bicubic widens the kernel when shrinking and takes PIL's a = -0.5 (the plain one
    # a = -0.75), so it differs from the plain resize at every size.
    plain = vit.interpolate_pos_embed(pos, gh, gw, cfg)
    assert float((plain - got).abs().max()) > 1e-3


def test_patches_exclude_the_registers():
    model = port_model(SMALL, hub_checkpoint(SMALL, seed=1), flash=False)
    x = torch.from_numpy(np.random.RandomState(2).normal(size=(2, 56, 70, 3)).astype(np.float32))
    with torch.no_grad():
        tokens = model.tokens(x)
        out = model(x)
        h = tokens
        for blk in model.blocks:
            h = blk(h)
        h = model.norm(h)
    r = SMALL.num_register_tokens
    assert tokens.shape[1] == 1 + r + 4 * 5
    # The registers sit after cls with no position embedding.
    assert torch.equal(tokens[:, 1:1 + r], model.register_tokens.expand(2, -1, -1))
    assert torch.equal(out["patches"], h[:, 1 + r:].reshape(2, 4, 5, -1))
    assert torch.equal(out["cls"], h[:, 0])
    # The registers take part in attention: other register tokens move the patches.
    with torch.no_grad():
        model.register_tokens.add_(torch.randn(model.register_tokens.shape, generator=torch.Generator().manual_seed(0)))
        moved = model(x)["patches"]
    assert float((moved - out["patches"]).abs().max()) > 1e-3


def test_load_dinov2_state_dict_in_both_layouts():
    fb = hub_checkpoint(SMALL, "facebook", seed=3)
    tf = hub_checkpoint(SMALL, "transformers", seed=3)
    a, b = vit.load_dinov2_state_dict(fb, SMALL), vit.load_dinov2_state_dict(tf, SMALL)
    assert a.keys() == b.keys() == vit.ViT(SMALL).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["register_tokens"], torch.from_numpy(fb["register_tokens"]))
    assert torch.equal(a["blocks.2.w12.weight"], torch.from_numpy(tf["encoder.layer.2.mlp.weights_in.weight"]))
    assert torch.equal(a["blocks.3.w3.bias"], torch.from_numpy(fb["blocks.3.mlp.w3.bias"]))
    assert torch.equal(a["blocks.1.attn.k.weight"], torch.from_numpy(fb["blocks.1.attn.qkv.weight"][48:96]))
    assert not any("mask_token" in k for k in a)


def test_load_dinov2_state_dict_of_tensors_makes_the_ports_own_copies():
    """A tensor-valued checkpoint (one drawn on the card is one) loads without
    a pass through numpy, and the port's tensors share no storage with it."""
    fb = {k: torch.from_numpy(v) for k, v in hub_checkpoint(SMALL, "facebook", seed=6).items()}
    out = vit.load_dinov2_state_dict(fb, SMALL)
    held = {t.untyped_storage().data_ptr() for t in fb.values()}
    assert not any(t.untyped_storage().data_ptr() in held for t in out.values())
    assert all(t.device == fb["cls_token"].device and t.dtype == torch.float32 for t in out.values())
    assert torch.equal(out["blocks.2.attn.v.bias"], fb["blocks.2.attn.qkv.bias"][96:])
    assert torch.equal(out["blocks.0.ls2"], fb["blocks.0.ls2.gamma"])


def test_init_vit_swiglu_and_registers():
    model = vit.init_vit(SMALL, torch.Generator().manual_seed(0), device="cpu")
    sd = model.state_dict()
    d, f = SMALL.hidden_size, SMALL.ffn_hidden
    assert tuple(sd["register_tokens"].shape) == (1, 4, d)
    assert tuple(sd["blocks.0.w12.weight"].shape) == (2 * f, d) and tuple(sd["blocks.0.w3.weight"].shape) == (d, f)
    assert not any(".fc1." in k or ".fc2." in k for k in sd)
    assert abs(float(sd["register_tokens"].std()) - 0.02) < 0.01
    w12 = torch.stack([sd[f"blocks.{i}.w12.weight"] for i in range(4)])
    w3 = torch.stack([sd[f"blocks.{i}.w3.weight"] for i in range(4)])
    assert abs(float(w12.std()) * math.sqrt(d) - 1) < 0.05 and abs(float(w3.std()) * math.sqrt(f) - 1) < 0.05
    assert all(float(sd[f"blocks.{i}.{b}.bias"].abs().max()) == 0 for i in range(4) for b in ("w12", "w3"))
    assert torch.equal(sd["blocks.0.ls1"], torch.ones(d)) and torch.equal(sd["norm.weight"], torch.ones(d))
    again = vit.init_vit(SMALL, torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_preset_and_its_parameter_count():
    assert (PRESET.hidden_size, PRESET.num_layers, PRESET.num_heads, PRESET.ffn_hidden) == (1536, 40, 24, 4096)
    assert (PRESET.num_register_tokens, PRESET.patch_size, PRESET.pos_grid) == (4, 14, 37)
    assert (PRESET.layernorm_eps, PRESET.layerscale_init, PRESET.ffn, PRESET.interpolate_antialias) == (
        1e-6, 1.0, "swiglu", True)
    with torch.device("meta"):
        model = vit.ViT(PRESET)
    assert sum(p.numel() for p in model.parameters()) == 1_136_485_376
    assert sum(p.numel() for p in model.blocks[0].parameters()) == 28_336_640
    # The benchmark's configuration states these numbers.
    cfg = json.loads((ROOT / "benchmark" / "configs" / "dinov2-vitg14-reg.json").read_text())
    assert cfg["parameters"] == 1_136_485_376 and cfg["reduced"] == []
    assert ref_config(PRESET) == {k: cfg[k] for k in ref_config(PRESET)}
    # The ViT-S/B/L presets keep the GELU MLP without registers.
    for name in ("dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14"):
        p = vit.PRESETS[name]
        assert (p.ffn, p.num_register_tokens, p.interpolate_antialias) == ("mlp", 0, False)


def test_create_descriptors_1536_wide_against_the_reference():
    cfg = dataclasses.replace(PRESET, num_layers=1, use_flash_attention=True)
    ckpt = hub_checkpoint(cfg, seed=4)
    gen = ImageFeatureGenerator("dinov2", config=cfg, params=vit.load_dinov2_state_dict(ckpt, cfg), device="cpu")
    assert gen.feature_size == 1536
    rig = SyntheticCameraRig(seed=5)
    cloud = make_rig_cloud(600, seed=5)
    files = [f"scan/{cam}.png" for cam in rig.cameras]
    before = dict(vit.FORWARD_COUNTS)
    with torch.no_grad():
        got = create_descriptors(files, rig, gen, cloud)
    assert vit.FORWARD_COUNTS["images"] - before.get("images", 0) == 5
    assert vit.FORWARD_COUNTS["tokens"] - before.get("tokens", 0) == 5 * 325
    images = rig.read_images(files)
    calibration = {"extrinsics": np.stack([rig.extrinsics[cam] for cam in rig.cameras]), "focal": rig.focal,
                   "principal_point": rig.principal_point}
    state = {"cfg": ref_config(cfg), "weights": {k: torch.from_numpy(v) for k, v in ckpt.items()},
             "calibration": calibration}
    with torch.no_grad():
        want, covered = ref.descriptors(state, list(images.values()), cloud)
    seen, first_empty = rig.coverage(cloud, images)
    assert np.array_equal(covered, (seen > 0) & ~first_empty)
    assert np.array_equal(np.any(got != 0, axis=1), covered)
    assert got.shape == (600, 1536) and covered.sum() > 100 and (seen > 1).any() and first_empty.any()
    np.testing.assert_allclose(got, want.numpy(), atol=DESC_ATOL, rtol=0)
