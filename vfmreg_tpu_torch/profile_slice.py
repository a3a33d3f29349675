"""Where the scan-to-map slice spends its time on the card.

    python -m vfmreg_tpu_torch.profile_slice

Builds the same full-width scene as `chip_smoke.py` (B = 8 scans x 16,384
points, 524,288-point map, 384-d descriptors, seed 0), warms up once, then
prints JSON lines:

* `stages`: host-clock seconds of each stage run on its own with a
  synchronize after it (grid build, 5 m voxelize, matching, each lane's
  VFM-ICP), summed over `--reps` runs;
* `profile`: one `scan_to_map` call under `torch.profiler`: wall seconds,
  device-busy seconds (the sum of device self time, which on one stream does
  not overlap), the idle share, and the kernels that took the most device
  time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType

from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences_batched
from vfmreg_tpu_torch.registration.vfm_icp import register_frame_vfm
from vfmreg_tpu_torch.scan_to_map import (
    KERNEL,
    MAP_VOXEL_SIZE,
    MAX_CORRESPONDENCE_DISTANCE,
    scan_to_map,
    shared_map_batch,
    vfm_queries,
)
from vfmreg_tpu_torch.utils.device import resolve_device
from vfmreg_tpu_torch.utils.precision import full_precision


def _timed(acc, key, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    full_precision()
    scene = shared_map_batch(8, 524288, 16384, 384, seed=0)
    mp, mf, sp, sf = (torch.from_numpy(a).to(dev) for a in scene[:4])
    sm = torch.ones(sp.shape[:2], dtype=torch.bool, device=dev)
    scan_to_map(mp, mf, sp, sf, device=dev)  # warm-up
    torch.cuda.synchronize()

    acc = {}
    eye = torch.eye(4)
    for _ in range(args.reps):
        grid = _timed(acc, "grid_build", lambda: build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf))
        p5, f5, m5 = _timed(acc, "voxelize_5m", lambda: vfm_queries(sp, sf, sm, 512))
        corrs = _timed(acc, "matching", lambda: get_vfm_correspondences_batched(
            grid.points, grid.feats, grid.valid, p5, f5, m5))
        for i in range(sp.shape[0]):
            _timed(acc, "vfm_icp_lanes", lambda: register_frame_vfm(
                grid, sp[i], sm[i], corrs.lane(i), eye, MAX_CORRESPONDENCE_DISTANCE, KERNEL))
    print(json.dumps({"stages": acc, "reps": args.reps, "device": torch.cuda.get_device_name(0)}))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scan_to_map(mp, mf, sp, sf, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # Device-side events only: a CPU op's device time repeats its kernels'.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(us for _, us, _ in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[: args.top]
    print(json.dumps({
        "profile": {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
                    "top_kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                                    for k, us, c in top]},
    }))


if __name__ == "__main__":
    main()
