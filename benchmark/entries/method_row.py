"""Drives `vfmreg_tpu_torch.pipeline.registration_node.precompute_scene_batched`,
the evaluation driver's batched method row: one call is one scene, the
map's grid built and one batch of scans through the whole row.

The map and the stacked scans live on the card before the window, as the
driver's device-resident scene. Traced, `get_vfm_correspondences_batched`,
as the row's module calls it, runs as the span that marks the matching's
kernels; once the spans are timed, the row runs its own stage clock too
(`VFMREG_PROFILE_DRIVER=1`: a synchronize after every stage, the seconds
per stage in its stats).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference import plain
from benchmark.traffic import generator

ROWS = ("gt", "vfm_ransac_ortho", "vfm_ransac_icp", "icp")


def attempted(out: Dict) -> int:
    """Scans registered by one call."""
    return out["scans"]


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, dev: torch.device):
        from vfmreg_tpu_torch.pipeline import registration_node

        self.module = registration_node
        self.cfg, self.dev = cfg, dev
        self.data = generator.make(cfg, traffic, seed, dev)
        self.scenes = [{"scene_poses": list(b["gt_poses"]), "scene_point_clouds_device": (b["raw"], b["mask"])}
                       for b in self.data.batches]
        self.n_batches = len(self.scenes)
        self.spans = None

    def call(self, k: int) -> Dict:
        clock = self.spans is not None and self.spans.timed
        if clock:
            os.environ["VFMREG_PROFILE_DRIVER"] = "1"
        try:
            res = self.module.precompute_scene_batched(self.scenes[k], self.data.local_map, device=self.dev,
                                                       q5_budget=self.cfg["query_budget"])
        finally:
            if clock:
                del os.environ["VFMREG_PROFILE_DRIVER"]
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        loops = res["stats"]["loop"]
        out = {"batch": k, "scans": len(res["gt"]), "corr_counts": list(res["corr_counts"]),
               "snap_counts": list(res["snap_counts"]), "retried": list(res["retried"]),
               "stages": dict(res["stats"]["seconds"]),
               "iterations": res["stats"]["iterations"], "settled": res["stats"]["settled"],
               "counters": {f"{row}.{key}": v for row, c in loops.items() for key, v in c.items()}}
        out.update({r: res[r] for r in ROWS})
        return out

    def failed(self, out: Dict) -> int:
        """Scans whose RANSAC + ICP pose misses the recall gate against their true pose."""
        truth = self.data.batches[out["batch"]]["true_poses"]
        return sum(not plain.truth_gate(p, t) for p, t in zip(out["vfm_ransac_icp"], truth))

    @contextlib.contextmanager
    def traced(self, spans):
        self.spans = spans
        try:
            with spans.patch(self.module, {"get_vfm_correspondences_batched": "match"},
                             {"match": roofline.matching_work}):
                yield
        finally:
            self.spans = None

    def stage_ms(self, outputs: List[Dict], spans) -> Dict[str, List[float]]:
        """Per stage of the row's own clock, ms per call (calls that ran it)."""
        out: Dict[str, List[float]] = {}
        for o in outputs:
            for name, s in o["stages"].items():
                if name != "total":
                    out.setdefault(name, []).append(s * 1e3)
        return out

    def close(self) -> None:
        self.module = None
        self.scenes = None
