"""Parity of the port's DINOv2 ViT (`vfmreg_tpu_torch.models.vit`) with `vfmreg_tpu`.

The reference's random parameters (`init_vit_params`, from a PRNG key) go
through `convert.vit_params_from_numpy` into the port's `ViT`; both forwards
then see the same images, made with numpy from a seed:

* `tests/test_vit.py`'s SMALL config (64 wide, 4 heads, 4 x 4 position
  grid) on its own grid (56 x 56) and on an interpolated 6 x 8 grid, and
  `tests_vit_config.SMALL_VIT`, with the port's attention through the kernel
  wrapper and through the plain path;
* ViT-S/14 width (384, 6 heads of 64, pretrain 518, i.e. a 37 x 37 position
  grid) cut to 2 layers, on a 56 x 70 image, so the 37 -> 4 x 5 bicubic
  resize of the descriptor pass runs.

Also: the bicubic weight matrices against the reference's and against
`F.interpolate`, and `load_dinov2_state_dict` on synthetic checkpoints in the
transformers and the facebook/FeatUp layouts, which must give the state dict
that the reference's `load_torch_state_dict` followed by
`vit_params_from_numpy` gives.

Tolerance: atol 2e-4 on the ViT outputs (`tests/test_vit.py`'s bar: f32
matmuls and LayerNorms sum in different orders), 2e-5 on the resize
weights, and exact equality for the converted weights.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests_vit_config import SMALL_VIT  # noqa: E402
from vfmreg_tpu.models import vit as jvit  # noqa: E402
from vfmreg_tpu_torch.convert import vit_params_from_numpy  # noqa: E402
from vfmreg_tpu_torch.models import vit as tvit  # noqa: E402

ATOL = 2e-4

# tests/test_vit.py's SMALL.
SMALL = jvit.ViTConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
                       pretrain_img_size=56, use_flash_attention=False)
VITS_2 = dataclasses.replace(jvit.PRESETS["dinov2_vits14"], num_layers=2)


def _port_config(cfg, flash=True):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tvit.ViTConfig) if hasattr(cfg, f.name)}
    return tvit.ViTConfig(**{**fields, "use_flash_attention": flash})


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, cfg, flash=True):
    pcfg = _port_config(cfg, flash)
    model = tvit.ViT(pcfg)
    model.load_state_dict(vit_params_from_numpy(_numpy_tree(params), pcfg))
    return model.eval()


@pytest.mark.parametrize("cfg,hw,flash", [
    (SMALL, (56, 56), True),
    (SMALL, (84, 112), True),
    (SMALL, (84, 112), False),
    (SMALL_VIT, (56, 70), True),
    (VITS_2, (56, 70), True),
])
def test_vit_matches_jax(cfg, hw, flash):
    params = jvit.init_vit_params(jax.random.PRNGKey(hw[1] + cfg.hidden_size), cfg)
    rng = np.random.RandomState(hw[0])
    img = rng.normal(size=(1, *hw, 3)).astype(np.float32)
    ref = jvit.vit_forward(params, jnp.asarray(img), dataclasses.replace(cfg, use_flash_attention=False))
    with torch.no_grad():
        got = _port_model(params, cfg, flash)(torch.from_numpy(img))
    gh, gw = hw[0] // 14, hw[1] // 14
    assert tuple(got["patches"].shape) == (1, gh, gw, cfg.hidden_size)
    np.testing.assert_allclose(got["cls"].numpy(), np.asarray(ref["cls"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["patches"].numpy(), np.asarray(ref["patches"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("g,gh,gw", [(37, 16, 20), (37, 4, 5), (4, 6, 8)])
def test_bicubic_matrix_matches_jax_and_torch(g, gh, gw):
    import torch.nn.functional as F

    for n_out in (gh, gw):
        np.testing.assert_allclose(tvit._torch_bicubic_matrix(g, n_out).numpy(),
                                   np.asarray(jvit._torch_bicubic_matrix(g, n_out)), atol=2e-5, rtol=0)
    rng = np.random.RandomState(g)
    pos = torch.from_numpy(rng.normal(size=(1, 1 + g * g, 8)).astype(np.float32))
    cfg = tvit.ViTConfig(hidden_size=8, num_heads=1, pretrain_img_size=14 * g)
    got = tvit.interpolate_pos_embed(pos, gh, gw, cfg)
    grid = pos[0, 1:].reshape(1, g, g, 8).permute(0, 3, 1, 2)
    ref = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got[0, 1:].reshape(gh, gw, 8).numpy(),
                               ref[0].permute(1, 2, 0).numpy(), atol=2e-5, rtol=0)
    assert torch.equal(got[:, :1], pos[:, :1])


def _synthetic_checkpoint(cfg, layout, seed=0):
    """A numpy state dict in `layout` ("transformers" or "facebook")."""
    rng = np.random.RandomState(seed)
    d, p, f = cfg.hidden_size, cfg.patch_size, cfg.hidden_size * cfg.mlp_ratio

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tf = layout == "transformers"
    sd = {
        ("embeddings.patch_embeddings.projection.weight" if tf else "patch_embed.proj.weight"): r(d, 3, p, p),
        ("embeddings.patch_embeddings.projection.bias" if tf else "patch_embed.proj.bias"): r(d),
        ("embeddings.cls_token" if tf else "cls_token"): r(1, 1, d),
        ("embeddings.position_embeddings" if tf else "pos_embed"): r(1, 1 + cfg.pos_grid**2, d),
        ("layernorm.weight" if tf else "norm.weight"): r(d),
        ("layernorm.bias" if tf else "norm.bias"): r(d),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}." if tf else f"blocks.{i}."
        if tf:
            for name in ("query", "key", "value"):
                sd[f"{pre}attention.attention.{name}.weight"] = r(d, d)
                sd[f"{pre}attention.attention.{name}.bias"] = r(d)
            sd[f"{pre}attention.output.dense.weight"] = r(d, d)
            sd[f"{pre}attention.output.dense.bias"] = r(d)
            sd[f"{pre}layer_scale1.lambda1"] = r(d)
            sd[f"{pre}layer_scale2.lambda1"] = r(d)
        else:
            sd[f"{pre}attn.qkv.weight"] = r(3 * d, d)
            sd[f"{pre}attn.qkv.bias"] = r(3 * d)
            sd[f"{pre}attn.proj.weight"] = r(d, d)
            sd[f"{pre}attn.proj.bias"] = r(d)
            sd[f"{pre}ls1.gamma"] = r(d)
            sd[f"{pre}ls2.gamma"] = r(d)
        for name in ("norm1", "norm2"):
            sd[f"{pre}{name}.weight"] = r(d)
            sd[f"{pre}{name}.bias"] = r(d)
        sd[f"{pre}mlp.fc1.weight"] = r(f, d)
        sd[f"{pre}mlp.fc1.bias"] = r(f)
        sd[f"{pre}mlp.fc2.weight"] = r(d, f)
        sd[f"{pre}mlp.fc2.bias"] = r(d)
    return sd


@pytest.mark.parametrize("layout", ["transformers", "facebook"])
def test_load_dinov2_state_dict_both_layouts(layout):
    sd = _synthetic_checkpoint(SMALL, layout)
    pcfg = _port_config(SMALL)
    got = tvit.load_dinov2_state_dict(sd, pcfg)
    ref = vit_params_from_numpy(_numpy_tree(jvit.load_torch_state_dict(sd, SMALL)), pcfg)
    assert set(got) == set(ref) == set(tvit.ViT(pcfg).state_dict())
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    tvit.ViT(pcfg).load_state_dict(got)  # strict: every key, every shape


def test_init_vit_shapes_and_scales():
    cfg = tvit.PRESETS["dinov2_vits14"]
    model = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _numpy_tree(jvit.init_vit_params(jax.random.PRNGKey(0), jvit.PRESETS["dinov2_vits14"]))
    sd = model.state_dict()
    conv = vit_params_from_numpy(ref, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in conv.items()}
    assert abs(float(sd["blocks.0.fc1.weight"].std()) * np.sqrt(384) - 1.0) < 0.01
    assert abs(float(sd["pos_embed"].std()) / 0.02 - 1.0) < 0.02
    again = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
