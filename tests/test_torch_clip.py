"""Parity of the port's CLIP modules (`vfmreg_tpu_torch.models.{clip_text,maskclip}`)
with `vfmreg_tpu`.

The reference's random parameters (`init_clip_text_params`,
`init_maskclip_params`, from PRNG keys) go through
`convert.clip_text_params_from_numpy` / `convert.maskclip_params_from_numpy`
into the port; both forwards then see the same inputs, made with numpy from
a seed:

* the tokenizer over the repository's merge table: ids equal the
  reference's exactly, on prompts with unicode, HTML entities, digits,
  contractions and one longer than 77 tokens (cut, end token kept);
* the text tower against `clip_text_forward` at a small config and at full
  width (512, 8 heads, vocabulary 49,408, context 77) cut to 2 layers;
* MaskCLIP against `maskclip_forward` at `tests/test_maskclip.py`'s SMALL on
  its own 4 x 4 grid and on an interpolated 3 x 5 grid, with the value-only
  last block and with `standard_last_layer=True`, and once at ViT-B/16 width
  (768, 12 heads of 64, 14 x 14 position grid) cut to 2 layers. The port's
  attention is kernel B5's wrapper, which runs its plain version on the CPU;
* the checkpoint loaders on synthetic OpenAI-layout state dicts (with and
  without the `visual.` / `model.` prefixes): the port's loader must give
  exactly the state dict that the reference's loader followed by the
  converter gives;
* the generator's "maskclip" branch against the JAX generator, and
  `compute_similarity` with a prompt and with its embedding.

Tolerance: atol 2e-4 on every forward (tests/test_vit.py's bar: f32 matmuls
and LayerNorms sum in different orders), 1e-5 on the similarities, exact
equality for token ids and converted weights.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.models import clip_text as jct  # noqa: E402
from vfmreg_tpu.models import image_features as jif  # noqa: E402
from vfmreg_tpu.models import maskclip as jmc  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.models import clip_text as tct  # noqa: E402
from vfmreg_tpu_torch.models import image_features as tif  # noqa: E402
from vfmreg_tpu_torch.models import maskclip as tmc  # noqa: E402

ATOL = 2e-4

# tests/test_maskclip.py's SMALL.
SMALL = jmc.MaskCLIPConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=16,
                           embed_dim=32, pretrain_img_size=64)
VITB16_2 = jmc.MaskCLIPConfig(num_layers=2)
TEXT_SMALL = jct.CLIPTextConfig(vocab_size=600, width=32, num_layers=2, num_heads=4, embed_dim=16,
                                context_length=12)
TEXT_FULL_2 = jct.CLIPTextConfig(num_layers=2)

PROMPTS = [
    "a photo of a cat",
    "Café naïve façade — 東京 tower 🚗!!",
    "fish &amp; chips &lt;tag&gt; &#39;quoted&#39; &amp;amp;",
    "It's the car's 2nd wheel; they'll've   gone\tnow",
    " ".join(f"word{i} building" for i in range(60)),  # > 77 tokens
]


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def tokenizers():
    return jct.SimpleTokenizer(), tct.SimpleTokenizer()


def test_tokenizer_ids_equal_reference(tokenizers):
    jtok, ttok = tokenizers
    ref = jtok.tokenize(PROMPTS)
    got = ttok.tokenize(PROMPTS)
    assert got.dtype == np.int32 and got.shape == ref.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, ref)
    # The long prompt is cut to 76 tokens and the end-of-text token.
    assert got[-1, -1] == ttok.encoder["<|endoftext|>"] and np.all(got[-1] != 0)
    assert [int(x) for x in got[0] if x] == [49406, 320, 1125, 539, 320, 2368, 49407]
    for p in PROMPTS:
        assert ttok.encode(p) == jtok.encode(p)


def test_tokenizer_small_merge_table():
    merges = ["l o", "lo w</w>", "h e"]
    jtok, ttok = jct.SimpleTokenizer(merges=merges), tct.SimpleTokenizer(merges=merges)
    assert ttok.encoder == jtok.encoder
    for ctx in (4, 8):
        np.testing.assert_array_equal(ttok.tokenize(["low", "low low low low low", "he"], ctx),
                                      jtok.tokenize(["low", "low low low low low", "he"], ctx))


@pytest.mark.parametrize("cfg", [TEXT_SMALL, TEXT_FULL_2], ids=["small", "width512_2layers"])
def test_text_tower_matches_jax(cfg):
    params = jct.init_clip_text_params(jax.random.PRNGKey(cfg.width), cfg)
    pcfg = _port(cfg, tct.CLIPTextConfig)
    model = tct.CLIPText(pcfg)
    model.load_state_dict(convert.clip_text_params_from_numpy(_tree(params), pcfg))
    rng = np.random.RandomState(cfg.width)
    L = cfg.context_length
    tokens = rng.randint(1, cfg.vocab_size - 1, (3, L)).astype(np.int32)
    for i, n in enumerate((5, L - 1, L)):  # end token, then zero padding
        tokens[i, n - 1] = cfg.vocab_size - 1
        tokens[i, n:] = 0
    ref = np.asarray(jct.clip_text_forward(params, jnp.asarray(tokens), cfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(tokens)).numpy()
    assert got.shape == (3, cfg.embed_dim)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cfg,hw,standard", [
    (SMALL, (64, 64), False),
    (SMALL, (64, 64), True),
    (SMALL, (48, 80), False),
    (SMALL, (48, 80), True),
    (VITB16_2, (64, 96), False),
], ids=["same_grid", "same_grid_standard", "interp_grid", "interp_grid_standard", "vitb16_2layers"])
def test_maskclip_matches_jax(cfg, hw, standard):
    params = jmc.init_maskclip_params(jax.random.PRNGKey(hw[1] + cfg.hidden_size), cfg)
    pcfg = _port(cfg, tmc.MaskCLIPConfig)
    model = tmc.MaskCLIP(pcfg)
    model.load_state_dict(convert.maskclip_params_from_numpy(_tree(params), pcfg))
    img = np.random.RandomState(hw[0]).normal(size=(1, *hw, 3)).astype(np.float32)
    ref = jmc.maskclip_forward(params, jnp.asarray(img), cfg, standard_last_layer=standard)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img), standard_last_layer=standard)
    gh, gw = hw[0] // 16, hw[1] // 16
    assert tuple(got["patches"].shape) == (1, gh, gw, cfg.embed_dim)
    np.testing.assert_allclose(got["patches"].numpy(), np.asarray(ref["patches"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["cls"].numpy(), np.asarray(ref["cls"]), atol=ATOL, rtol=0)


def _openai_visual_sd(cfg, rng):
    d, e, g = cfg.hidden_size, cfg.embed_dim, cfg.pos_grid
    p = cfg.patch_size
    sd = {"conv1.weight": rng.normal(size=(d, 3, p, p)), "class_embedding": rng.normal(size=(d,)),
          "positional_embedding": rng.normal(size=(1 + g * g, d)), "proj": rng.normal(size=(d, e))}
    for name in ("ln_pre", "ln_post"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rng.normal(size=(d,)), rng.normal(size=(d,))
    for i in range(cfg.num_layers):
        sd.update(_openai_block(f"transformer.resblocks.{i}.", d, rng))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _openai_block(pre, d, rng):
    shapes = {"ln_1.weight": (d,), "ln_1.bias": (d,), "attn.in_proj_weight": (3 * d, d),
              "attn.in_proj_bias": (3 * d,), "attn.out_proj.weight": (d, d), "attn.out_proj.bias": (d,),
              "ln_2.weight": (d,), "ln_2.bias": (d,), "mlp.c_fc.weight": (4 * d, d),
              "mlp.c_fc.bias": (4 * d,), "mlp.c_proj.weight": (d, 4 * d), "mlp.c_proj.bias": (d,)}
    return {pre + k: rng.normal(size=s) for k, s in shapes.items()}


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_clip_visual_loader_matches_reference(prefix):
    sd = _openai_visual_sd(SMALL, np.random.RandomState(7))
    ckpt = {prefix + k: v for k, v in sd.items()}
    if prefix:  # a full CLIP checkpoint also holds the text tower
        ckpt["token_embedding.weight"] = np.zeros((8, 4), np.float32)
    pcfg = _port(SMALL, tmc.MaskCLIPConfig)
    want = convert.maskclip_params_from_numpy(_tree(jmc.load_clip_visual_state_dict(ckpt, SMALL)), pcfg)
    got = tmc.load_clip_visual_state_dict(ckpt, pcfg)
    _assert_same_state(got, want)
    tmc.MaskCLIP(pcfg).load_state_dict(got)
    # Tensor-valued checkpoints load the same way.
    _assert_same_state(tmc.load_clip_visual_state_dict({k: torch.from_numpy(v) for k, v in ckpt.items()}, pcfg),
                       want)


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_clip_text_loader_matches_reference(prefix):
    cfg = TEXT_SMALL
    rng = np.random.RandomState(8)
    w = cfg.width
    sd = {"token_embedding.weight": rng.normal(size=(cfg.vocab_size, w)),
          "positional_embedding": rng.normal(size=(cfg.context_length, w)),
          "ln_final.weight": rng.normal(size=(w,)), "ln_final.bias": rng.normal(size=(w,)),
          "text_projection": rng.normal(size=(w, cfg.embed_dim))}
    for i in range(cfg.num_layers):
        sd.update(_openai_block(f"transformer.resblocks.{i}.", w, rng))
    ckpt = {prefix + k: v.astype(np.float32) for k, v in sd.items()}
    ckpt[prefix + "visual.proj"] = np.zeros((4, 2), np.float32)  # ignored
    pcfg = _port(cfg, tct.CLIPTextConfig)
    want = convert.clip_text_params_from_numpy(_tree(jct.load_clip_text_state_dict(ckpt, cfg)), pcfg)
    got = tct.load_clip_text_state_dict(ckpt, pcfg)
    _assert_same_state(got, want)
    tct.CLIPText(pcfg).load_state_dict(got)


@pytest.fixture(scope="module")
def maskclip_generators():
    params = jmc.init_maskclip_params(jax.random.PRNGKey(11), SMALL)
    jgen = jif.ImageFeatureGenerator("maskclip", params=params, config=SMALL)
    pcfg = _port(SMALL, tmc.MaskCLIPConfig)
    tgen = tif.ImageFeatureGenerator("maskclip", params=convert.maskclip_params_from_numpy(_tree(params), pcfg),
                                     config=pcfg, device="cpu")
    return jgen, tgen


@pytest.mark.parametrize("upsample", [False, True])
def test_maskclip_generator_matches_jax(maskclip_generators, upsample):
    jgen, tgen = maskclip_generators
    assert tgen.patch_size == 16 and tgen.feature_size == 32
    img = np.random.RandomState(12).randint(0, 256, (120, 150, 3)).astype(np.uint8)
    ref = jgen.get_image_features(img, upsample=upsample)
    got = tgen.get_image_features(img, upsample=upsample)
    assert got.shape == ref.shape == ((120, 150, 32) if upsample else (16, 20, 32))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_compute_similarity_with_prompt(maskclip_generators):
    jgen, tgen = maskclip_generators
    cfg = jct.CLIPTextConfig(vocab_size=64 + 2 * len(jct.bytes_to_unicode()) + 3, width=16, num_layers=1,
                             num_heads=2, embed_dim=32, context_length=8)
    merges = ["l o", "lo w</w>", "h e"]
    params = jct.init_clip_text_params(jax.random.PRNGKey(0), cfg)
    jgen.set_text_encoder(params, cfg, jct.SimpleTokenizer(merges=merges))
    pcfg = _port(cfg, tct.CLIPTextConfig)
    tgen.set_text_encoder(convert.clip_text_params_from_numpy(_tree(params), pcfg), pcfg,
                          tct.SimpleTokenizer(merges=merges))

    feats = np.random.RandomState(1).randn(6, 32).astype(np.float32)
    feats[2] = 0.0
    np.testing.assert_allclose(tgen.encode_text("low he"), jgen.encode_text("low he"), atol=ATOL, rtol=0)
    sims = tgen.compute_similarity(feats, "low he")
    assert sims.shape == (6,) and sims[2] == 0.0
    np.testing.assert_allclose(sims, jgen.compute_similarity(feats, "low he"), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sims, tgen.compute_similarity(feats, tgen.encode_text("low he")), atol=1e-6)
    with pytest.raises(RuntimeError, match="set_text_encoder"):
        tif.ImageFeatureGenerator("maskclip", config=_port(SMALL, tmc.MaskCLIPConfig), device="cpu").encode_text("x")
