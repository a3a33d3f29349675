"""Drives `vfmreg_tpu_torch.scan_to_map.scan_to_map`, the paper's headline
scan-to-map registration: one call is one scene, the map's grid built and
one batch of scans registered from the identity.

The scene lives on the card before the window. Traced, the module's
functions that the entry calls run as spans (marks for the profiler, then
timed): `build_hash_grid`, `vfm_queries`, `get_vfm_correspondences_batched`
(whose span marks the matching's kernels) and `register_frames_vfm_lanes`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference import plain
from benchmark.traffic import generator

SPANS = {"build_hash_grid": "grid_build", "vfm_queries": "queries",
         "get_vfm_correspondences_batched": "match", "register_frames_vfm_lanes": "vfm_icp"}


def attempted(out: Dict) -> int:
    """Scans registered by one call."""
    return out["scans"]


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, dev: torch.device):
        from vfmreg_tpu_torch import scan_to_map

        self.module = scan_to_map
        self.cfg, self.dev = cfg, dev
        self.data = generator.make(cfg, traffic, seed, dev)
        self.n_batches = len(self.data.batches)

    def call(self, k: int) -> Dict:
        b = self.data.batches[k]
        res = self.module.scan_to_map(self.data.map_points, self.data.map_feats, b["scans"], b["feats"],
                                      n_vfm=self.cfg["n_vfm"], max_iterations=self.cfg["max_iterations"],
                                      device=self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return {"batch": k, "scans": len(res.poses), "poses": res.poses, "n_corr": res.n_correspondences,
                "counters": {"vfm_steps": res.loop.get("vfm_steps", 0),
                             "step_calls": res.loop.get("step_calls", 0)}}

    def failed(self, out: Dict) -> int:
        """Scans whose pose misses the recall gate against their true pose."""
        truth = self.data.batches[out["batch"]]["true_poses"]
        return sum(not plain.truth_gate(p, t) for p, t in zip(out["poses"], truth))

    def traced(self, spans) -> contextlib.AbstractContextManager:
        return spans.patch(self.module, SPANS, {"match": roofline.matching_work})

    def stage_ms(self, outputs: List[Dict], spans) -> Dict[str, List[float]]:
        return {name: list(np.array(s) * 1e3) for name, s in spans.seconds.items()}

    def close(self) -> None:
        self.module = None
