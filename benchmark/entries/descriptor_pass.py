"""Drives `vfmreg_tpu_torch.pipeline.prepare_scenes.create_descriptors`, the
offline descriptor pass, with the configuration's DINOv2 ViT: one call is one
batch of scans, each scan's camera images through the program's
`ImageFeatureGenerator` (one image a forward, on the card) and projected
onto its cloud.

Set-up looks the configuration's preset up first (a program without it
fails at once), then makes the scene (`traffic/rig_scene.py`): the ViT's
weights drawn on the card from the seed in facebookresearch/dinov2's
layout, and every batch's clouds and images, which the rig serves from
memory. The program takes the weights through its checkpoint loader
(`vit.load_dinov2_state_dict`, into tensors of its own); the plain
reference reads the scene's copy.

A scan's descriptors are [N, D] f32 on the host (100 MB at 16,384 x 1536),
and the harness keeps every call's output, so a call keeps per scan the
covered points (a row is covered where one of its first `COVER_COLUMNS`
values is not zero, which costs ~1 ms where reading every value costs ~15)
and the whole descriptors of the configuration's `kept_rows` covered points
drawn from the seed. Traced, nothing is wrapped: the metrics read the
program's spans (`vfmreg.descriptors`, `vfmreg.vit`,
`vfmreg.descriptors.assemble`) and its counter of forwarded images and
tokens; once the harness times its spans, `create_descriptors` is given a
stage clock too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark.traffic import rig_scene

COVER_COLUMNS = 8


def attempted(out: Dict) -> int:
    """Scans whose descriptors one call made."""
    return out["scans"]


def vit_config(cfg: Dict, presets: Dict):
    """The program's `ViTConfig`: the configuration's preset, with every
    width and setting the file states (so the file is what runs)."""
    vit_cfg = dataclasses.replace(
        presets[cfg["preset"]], hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], mlp_ratio=cfg["mlp_ratio"], patch_size=cfg["patch_size"],
        pretrain_img_size=cfg["image_size"], layernorm_eps=cfg["layer_norm_eps"],
        layerscale_init=cfg["layerscale_value"], ffn="swiglu" if cfg["use_swiglu_ffn"] else "mlp",
        num_register_tokens=cfg["num_register_tokens"], interpolate_antialias=cfg["interpolate_antialias"])
    if vit_cfg.ffn_hidden != cfg["ffn_hidden_size"]:
        raise ValueError(f"the program's FFN width {vit_cfg.ffn_hidden} is not the file's {cfg['ffn_hidden_size']}")
    return vit_cfg


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, dev: torch.device):
        from vfmreg_tpu_torch.models import vit

        vit_cfg = vit_config(cfg, vit.PRESETS)
        from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator
        from vfmreg_tpu_torch.pipeline import prepare_scenes
        from vfmreg_tpu_torch.utils.precision import full_precision
        from vfmreg_tpu_torch.utils.profiling import Timer

        full_precision()
        self.module, self.counts, self.timer_cls = prepare_scenes, vit.FORWARD_COUNTS, Timer
        self.data = rig_scene.make(cfg, traffic, seed, dev)
        self.generator = ImageFeatureGenerator(
            "dinov2", config=vit_cfg, params=vit.load_dinov2_state_dict(self.data.weights, vit_cfg), device=dev)
        if self.generator.patch_h != cfg["patch_h"]:
            raise ValueError(f"the program resizes to {self.generator.patch_h} patch rows, the file says "
                             f"{cfg['patch_h']}")
        self.n_batches = len(self.data.batches)
        self.spans = None

    def call(self, k: int) -> Dict:
        b = self.data.batches[k]
        timer = self.timer_cls() if self.spans is not None and self.spans.timed else None
        images, tokens = self.counts["images"], self.counts["tokens"]
        covered, kept = [], []
        for files, cloud, rows in zip(b["files"], b["clouds"], b["kept"]):
            d = self.module.create_descriptors(files, self.data.rig, self.generator, cloud, timer=timer)
            covered.append(np.any(d[:, :COVER_COLUMNS] != 0, axis=1))
            kept.append(d[rows])
        return {"batch": k, "scans": len(covered), "covered": covered, "kept": kept,
                "stages": dict(timer.totals) if timer is not None else {},
                "counters": {"vit_images": self.counts["images"] - images,
                             "vit_tokens": self.counts["tokens"] - tokens}}

    def failed(self, out: Dict) -> int:
        """Scans with a non-finite kept value, or whose covered points are not
        those the rig's projection covers."""
        truth = self.data.batches[out["batch"]]["covered"]
        return sum(not (np.isfinite(kp).all() and np.array_equal(c, t))
                   for c, kp, t in zip(out["covered"], out["kept"], truth))

    @contextlib.contextmanager
    def traced(self, spans):
        self.spans = spans
        try:
            yield
        finally:
            self.spans = None

    def stage_ms(self, outputs: List[Dict], spans) -> Dict[str, List[float]]:
        """Per span of the generator's clock, ms per call (calls that ran it)."""
        out: Dict[str, List[float]] = {}
        for o in outputs:
            for name, s in o["stages"].items():
                out.setdefault(name, []).append(s * 1e3)
        return out

    def close(self) -> None:
        """Lets the program go."""
        self.generator = None
        self.module = None
