"""Operations and bytes of the ViT's forward and of its attention kernel
(B5), counted from a configuration file's widths (`configs/*.json`, the
transformers names: `hidden_size`, `num_hidden_layers`,
`num_attention_heads`, `ffn_hidden_size`, `use_swiglu_ffn`,
`num_register_tokens`, `patch_size`); the peaks are `roofline.py`'s.
"""

from __future__ import annotations

from typing import Dict

from benchmark import roofline


def vit_flops(cfg: Dict, tokens: int) -> float:
    """Model flops of one image's forward at `tokens` tokens (cls and
    registers included): 2 flops a multiply-add of every product, the patch
    embedding's, each block's q, k, v and output projections, its two
    attention products (4 T^2 D) and its FFN (SwiGLU: D -> 2F -> F -> D;
    MLP: D -> F -> D). LayerNorms, the softmax and elementwise work left out."""
    d, layers, f, p = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["ffn_hidden_size"], cfg["patch_size"]
    patches = tokens - 1 - cfg.get("num_register_tokens", 0)
    ffn = 6.0 * tokens * d * f if cfg.get("use_swiglu_ffn") else 4.0 * tokens * d * f
    block = 8.0 * tokens * d * d + 4.0 * tokens * tokens * d + ffn
    return 2.0 * patches * 3 * p * p * d + layers * block


def attention_work(batch: int, tokens: int, heads: int, head_dim: int) -> tuple:
    """(flops, bytes) of one call of B5 on q, k, v [batch, tokens, heads,
    head_dim] f32: the two products' 4 B H T^2 hd flops; q, k and v read
    once and the output written once (4 B T H hd floats)."""
    flops = 4.0 * batch * heads * tokens * tokens * head_dim
    return flops, 16.0 * batch * tokens * heads * head_dim


def attention_seconds(batch: int, tokens: int, heads: int, head_dim: int) -> float:
    """The least time of that call on the card: B5 runs both products as
    three TF32 products (3xTF32), so 3 x flops at the TF32 peak, or the bytes
    at the HBM bandwidth, whichever is larger."""
    flops, nbytes = attention_work(batch, tokens, heads, head_dim)
    return max(3.0 * flops / roofline.TF32_FLOPS, nbytes / roofline.HBM_BYTES_PER_S)


def profiled_forwards(ctx: Dict):
    """(images, tokens an image) of the ViT forwards in the traced window's
    profiled calls, from the program's counter (`models.vit.FORWARD_COUNTS`,
    per call in the entry's `counters`); None where the program counts none.
    Every image of the cell has the same token count."""
    calls = ctx["outputs"][:ctx.get("trace_calls") or 0]
    images = sum(o.get("counters", {}).get("vit_images", 0) for o in calls)
    tokens = sum(o.get("counters", {}).get("vit_tokens", 0) for o in calls)
    if not images:
        return None
    return images, tokens / images
