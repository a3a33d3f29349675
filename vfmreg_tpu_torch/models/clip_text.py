"""CLIP's text tower: the BPE tokenizer and the causal transformer encoder.

Counterpart of `vfmreg_tpu/models/clip_text.py`, the prompt side of
`ImageFeatureGenerator.compute_similarity` (the reference's
`image_features.py:194-208`: CLIP's `tokenize(prompt)` then `encode_text`).

Tokenizer: OpenAI CLIP's `SimpleTokenizer` as the reference implements it:
byte-level unicode mapping, HTML unescaping, whitespace folding and
lowercasing (no ftfy), the CLIP word regex restricted to ASCII letters and
digits, BPE merges with the trailing `</w>`, start and end-of-text tokens,
zero padding to the context length and truncation that keeps the
end-of-text token. The merge table is the repository's
`data/clip/bpe_simple_vocab_16e6.txt.gz`.

Encoder (`CLIPText`, OpenAI `CLIP.encode_text`): token plus position
embedding -> `num_layers` pre-LN blocks (causal softmax attention,
quickGELU MLP) -> `ln_final` -> the end-of-text token's features (the
argmax of the token ids) @ `text_projection`. The causal attention is plain
PyTorch matmuls, as the reference computes it outside Pallas (kernel B5 is
non-causal). Parameter names follow the OpenAI checkpoint, so
`load_clip_text_state_dict` only drops a `model.` prefix. All f32.
"""

from __future__ import annotations

import dataclasses
import gzip
import html
import math
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfmreg_tpu_torch.utils.device import resolve_device

CONTEXT_LENGTH = 77

# The merge table at the repository root's data/clip/.
DEFAULT_BPE_PATH = (
    Path(__file__).resolve().parents[2] / "data" / "clip" / "bpe_simple_vocab_16e6.txt.gz"
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 512
    num_layers: int = 12
    num_heads: int = 8
    embed_dim: int = 512
    context_length: int = CONTEXT_LENGTH


# ----------------------------------------------------------------- tokenizer
@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode table (GPT-2 / CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word):
    return set(zip(word[:-1], word[1:]))


# CLIP's word pattern with \p{L} -> [a-zA-Z] and \p{N} -> [0-9], as the
# reference writes it for the standard library's `re`.
_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


class SimpleTokenizer:
    """CLIP BPE tokenizer over a merge table: `merges` (the decoded merge
    lines), or `bpe_path` (a gzip in the standard layout), or by default the
    repository's `data/clip/bpe_simple_vocab_16e6.txt.gz`."""

    def __init__(self, bpe_path: str = None, merges: List[str] = None):
        self.byte_encoder = bytes_to_unicode()
        if merges is None and bpe_path is None:
            bpe_path = DEFAULT_BPE_PATH
            if not bpe_path.exists():
                raise FileNotFoundError(f"CLIP BPE merge table not found at {bpe_path}; pass bpe_path or merges")
        if merges is None:
            with gzip.open(bpe_path, "rt", encoding="utf8") as f:
                merges = f.read().split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """[B, context_length] int32 token ids (`clip.tokenize`): start token,
        BPE ids, end token, zero padding; a longer prompt is cut to
        `context_length - 1` tokens and the end token."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [sot] + self.encode(text) + [eot]
            if len(tokens) > context_length:
                tokens = tokens[: context_length - 1] + [eot]
            out[i, : len(tokens)] = tokens
        return out


# --------------------------------------------------------------- text tower
def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class Attention(nn.Module):
    """Multi-head attention with CLIP's fused input projection
    (`in_proj_weight` [3W, W], `in_proj_bias`, `out_proj`). The softmax is
    the caller's `attend(q, k, v)` on [B, T, H, hd]: the text tower's causal
    `causal_attention`, or kernel B5 in the visual tower."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def _project(self, x: torch.Tensor, i: int) -> torch.Tensor:
        w = x.shape[-1]
        return F.linear(x, self.in_proj_weight[i * w : (i + 1) * w], self.in_proj_bias[i * w : (i + 1) * w])

    def qkv(self, x: torch.Tensor):
        """q, k, v [B, T, H, hd], each contiguous, of the normalised tokens
        x [B, T, W] (one product per third of the fused weight)."""
        b, t, w = x.shape
        return tuple(self._project(x, i).reshape(b, t, self.num_heads, w // self.num_heads) for i in range(3))

    def forward(self, x: torch.Tensor, attend) -> torch.Tensor:
        return self.out_proj(attend(*self.qkv(x)).reshape(x.shape))

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """MaskCLIP's value path: out_proj(v(x)), no softmax mixing."""
        return self.out_proj(self._project(x, 2))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over q, k, v [B, T, H, hd] with each query seeing
    itself and the keys before it."""
    t, hd = q.shape[1], q.shape[-1]
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    att = att + torch.full((t, t), -math.inf, device=q.device).triu(1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(att, dim=-1), v)


class Block(nn.Module):
    """CLIP's residual attention block: pre-LN attention, pre-LN quickGELU MLP."""

    def __init__(self, width: int, num_heads: int, eps: float = 1e-5):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=eps)
        self.attn = Attention(width, num_heads)
        self.ln_2 = nn.LayerNorm(width, eps=eps)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor, attend=None) -> torch.Tensor:
        """`attend=None` is MaskCLIP's value-only block."""
        y = self.ln_1(x)
        x = x + (self.attn.value(y) if attend is None else self.attn(y, attend))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, num_layers: int, num_heads: int, eps: float = 1e-5):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(width, num_heads, eps) for _ in range(num_layers))


class CLIPText(nn.Module):
    """`forward(tokens [B, L] int)` -> [B, embed_dim] text embeddings."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.transformer = Transformer(w, cfg.num_layers, cfg.num_heads)
        self.ln_final = nn.LayerNorm(w, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, L = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[:L]
        for blk in self.transformer.resblocks:
            x = blk(x, causal_attention)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def init_clip_text(cfg: CLIPTextConfig, generator: torch.Generator, device=None) -> CLIPText:
    """A `CLIPText` with random weights in the reference's shapes and scales
    (`init_clip_text_params`): dense N(0, 1/n_in), zero biases, token
    embedding N(0, 0.02^2), position embedding N(0, 0.01^2), projection
    N(0, 1/width), unit norms. Drawn on the CPU from `generator`, then moved
    to `device` (default: the card)."""
    dev = resolve_device(device)
    model = CLIPText(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    w = cfg.width
    with torch.no_grad():
        for blk in model.transformer.resblocks:
            blk.attn.in_proj_weight.copy_(normal((3 * w, w), w ** -0.5))
            for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                lin.weight.copy_(normal(lin.weight.shape, lin.in_features ** -0.5))
                lin.bias.zero_()
        model.token_embedding.weight.copy_(normal((cfg.vocab_size, w), 0.02))
        model.positional_embedding.copy_(normal((cfg.context_length, w), 0.01))
        model.text_projection.copy_(normal((w, cfg.embed_dim), w ** -0.5))
    return model.to(dev).eval()


def load_clip_text_state_dict(state_dict: Mapping[str, object], cfg: CLIPTextConfig) -> Dict[str, torch.Tensor]:
    """The port's `CLIPText` state dict from an OpenAI CLIP checkpoint's
    (numpy- or tensor-valued; keys with or without a `model.` prefix): the
    text tower's entries, which already carry the port's names and layouts.
    Load with `CLIPText(cfg).load_state_dict(...)`."""
    sd = {}
    for k, v in state_dict.items():
        sd[k[len("model."):] if k.startswith("model.") else k] = v
    with torch.device("meta"):
        names = list(CLIPText(cfg).state_dict())
    return {n: torch.as_tensor(np.asarray(sd[n]), dtype=torch.float32).clone() for n in names}
