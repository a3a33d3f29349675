"""Weights of the learned extractors: a checkpoint, or seeded random ones."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

_CACHE: Dict[str, torch.nn.Module] = {}


def learned_net(env: str, load: Callable, init: Callable, device: torch.device,
                weight_path: Optional[str] = None, unwrap: Optional[str] = None) -> torch.nn.Module:
    """The network for an extractor on `device`: from `weight_path` or the
    file named by $`env` (`torch.load`, the reference checkpoint's layout;
    `unwrap` picks a state dict out of a checkpoint dict), else the
    reference's random init from a generator seeded with 0, as its
    `_get_params`. Cached per (source, device)."""
    path = weight_path if weight_path is not None else os.environ.get(env)
    have = bool(path) and os.path.exists(path)
    key = f"{env}:{os.path.abspath(path) if have else 'random'}@{device}"
    if key not in _CACHE:
        if have:
            sd = torch.load(path, map_location="cpu")
            if unwrap is not None and unwrap in sd:
                sd = sd[unwrap]
            _CACHE[key] = load(sd, device=device)
        else:
            _CACHE[key] = init(torch.Generator().manual_seed(0), device=device)
    return _CACHE[key]
