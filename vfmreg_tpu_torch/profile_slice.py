"""Where a path of the port spends its time on the card.

    python -m vfmreg_tpu_torch.profile_slice [--path slice|driver|node|descriptor]
        [--reps N] [--steps-per-read 1,4,16]

Builds the same full-width inputs as `chip_smoke.py` for the path, seed 0:
the scan-to-map slice, the evaluation driver's method row
(`pipeline.registration_node.precompute_scene_batched` on
`pipeline.synthetic`'s scene), or the scene loop around it
(`RegistrationNode.run_scene`, batched, with the vfm RANSAC and TEASER
columns, on that scene in a scene file's layout), each B = 8 scans x
16,384 points against a 524,288-point map with 384-d descriptors; or the
descriptor pass
(`pipeline.prepare_scenes.create_descriptors` at ViT-S/14 with random
seeded weights, 8 clouds x 16,384 points, 40 rig images of 1232 x 1616).
It warms up once, then prints JSON lines:

* `stages`: host-clock seconds of each stage with a synchronize after it,
  summed over `--reps` runs (slice: grid build, 5 m voxelize, matching, each
  lane's VFM-ICP; driver: the row's own stage clock, with the GN iterations
  of each ICP row and, per ICP row, its loop's kernel B2 step calls, device
  reads, kernel B3 launches and per-lane iterations and rebuilds; with
  `--steps-per-read 1,4,16` one such line per value of
  `registration.icp.GN_STEPS_PER_READ`, the values run in turns; node: the
  node's own stage clock and the kernels' launches per scene; descriptor: the
  whole pass, then its images and its ViT features timed apart, and the
  rest, projection, sampling and dedupe, as the difference);
* `profile`: one call without the profiler, timed on the host clock
  (`wall_s`), then one call under `torch.profiler`: its device-busy seconds
  (the sum of device self time, which on one stream does not overlap), the
  idle share 1 - busy / wall_s, the profiled call's own wall time and idle
  share (the profiler slows the host, so these overstate idling), the
  kernels that took the most device time, and the host operations that took
  the most host time.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import tempfile
import time

import torch
from torch.autograd import DeviceType

from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator
from vfmreg_tpu_torch.models.vit import PRESETS
from vfmreg_tpu_torch.ops import _build
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences_batched
from vfmreg_tpu_torch.pipeline import registration_node as rn
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors
from vfmreg_tpu_torch.pipeline.synthetic import (
    SyntheticCameraRig,
    make_rig_cloud,
    make_synthetic_scene,
    scene_file_layout,
)
from vfmreg_tpu_torch.registration import icp
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


def _driver(reps, dev, steps_per_read):
    """The driver row's stage clock over `reps` runs for each GN steps-per-
    read value, the values taken in turns; returns one call at the first."""
    scene, local_map, _ = make_synthetic_scene(8, 524288, 16384, 384, seed=0)
    raw, raw_mask = rn.stack_scans(scene["scene_point_clouds"], local_map.shape[1])
    scene["scene_point_clouds_device"] = (
        torch.from_numpy(raw).to(dev), torch.from_numpy(raw_mask).to(dev)
    )
    lm = torch.from_numpy(local_map).to(dev)

    def run(k=steps_per_read[0]):
        kept, icp.GN_STEPS_PER_READ = icp.GN_STEPS_PER_READ, k
        try:
            return rn.precompute_scene_batched(scene, lm, device=dev)
        finally:
            icp.GN_STEPS_PER_READ = kept

    run()  # warm-up
    out = {k: {"stages": {}, "gn_iterations": {}} for k in steps_per_read}
    for _ in range(reps):
        for k in steps_per_read:
            st = run(k)["stats"]
            acc = out[k]
            for key, v in st["seconds"].items():
                acc["stages"][key] = acc["stages"].get(key, 0.0) + v
            for key, v in st["iterations"].items():
                acc["gn_iterations"][key] = acc["gn_iterations"].get(key, 0) + sum(v)
            # Per ICP row of the last run: kernel B2 step calls, device reads,
            # kernel B3 launches (rebuild rounds), per-lane iterations and rebuilds.
            acc["icp_rows"] = {row: {**loop, "iterations": st["iterations"][row],
                                     "rebuilds": st["rebuilds"][row]}
                               for row, loop in st["loop"].items()}
    for k in steps_per_read:
        print(json.dumps({"gn_steps_per_read": k, **out[k], "reps": reps,
                          "device": torch.cuda.get_device_name(0)}))
    return run


def _node(reps, dev):
    """The scene loop's stage clock over `reps` runs of `run_scene`; returns
    one run. The node's printing goes to a buffer."""
    scene, local_map, _ = make_synthetic_scene(8, 524288, 16384, 384, seed=0)
    layout = scene_file_layout(scene, local_map)
    with tempfile.TemporaryDirectory() as empty, contextlib.redirect_stdout(io.StringIO()):
        node = rn.RegistrationNode(empty, device=dev, methods_ransac=[("vfm", True)],
                                   methods_teaser=[("vfm", True)], methods_pointdsc=[])

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            node.run_scene(layout)

    run()  # warm-up
    acc = {}
    for _ in range(reps):
        _build.reset_launches()
        run()
        for key, v in node.stage_seconds.items():
            acc[key] = acc.get(key, 0.0) + v
    print(json.dumps({"stages": acc, "total": sum(acc.values()), "launches_per_scene": dict(_build.LAUNCHES),
                      "serial_vfm_searches_per_scene": node.vfm_searches // (reps + 1), "reps": reps,
                      "device": torch.cuda.get_device_name(0)}))
    return run


def _descriptor(reps, dev):
    """The descriptor pass's stages over `reps` runs; returns one pass."""
    gen = ImageFeatureGenerator("dinov2", config=PRESETS["dinov2_vits14"], seed=0, device=dev)
    rig = SyntheticCameraRig(seed=0)
    clouds = [make_rig_cloud(16384, seed=i) for i in range(8)]
    files = [[f"cloud{i}/{cam}.png" for cam in rig.cameras] for i in range(8)]

    def run():
        return [create_descriptors(f, rig, gen, c) for f, c in zip(files, clouds)]

    run()  # warm-up
    acc = {}
    for _ in range(reps):
        _timed(acc, "pass", run)
        images = _timed(acc, "read_images", lambda: [rig.read_images(f) for f in files])
        _timed(acc, "vit_features", lambda: [gen.get_image_features(im)
                                             for ims in images for im in ims.values()])
    acc["projection_sampling_dedupe"] = acc["pass"] - acc["read_images"] - acc["vit_features"]
    print(json.dumps({"stages": acc, "images": 8 * len(rig.cameras) * reps, "reps": reps,
                      "device": torch.cuda.get_device_name(0)}))
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=["slice", "driver", "node", "descriptor"], default="slice")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--steps-per-read", default="",
                    help="driver: comma-separated GN_STEPS_PER_READ values to time in turns "
                         "(default: the module's; the profile runs at the first)")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    full_precision()
    if args.path == "driver":
        steps = [int(k) for k in args.steps_per_read.split(",")] if args.steps_per_read else [
            icp.GN_STEPS_PER_READ]
        _profile(_driver(args.reps, dev, steps), args.top)
        return
    if args.path == "node":
        _profile(_node(args.reps, dev), args.top)
        return
    if args.path == "descriptor":
        _profile(_descriptor(args.reps, dev), args.top)
        return
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
    _profile(lambda: scan_to_map(mp, mf, sp, sf, device=dev), args.top)


def _profile(run, top_n):
    """One call of `run` on the host clock, then one under `torch.profiler`,
    summarised as one JSON line."""
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    events = prof.key_averages()
    # Device-side events only: a CPU op's device time repeats its kernels'.
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA]
    busy = sum(us for _, us, _ in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:top_n]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:top_n]
    print(json.dumps({
        "profile": {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
                    "wall_s_profiled": wall_profiled,
                    "idle_share_profiled": 1.0 - busy / wall_profiled,
                    "top_kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                                    for k, us, c in top],
                    "top_host_ops": [{"name": k[:90], "host_self_ms": us / 1e3, "calls": c}
                                     for k, us, c in host]},
    }))


if __name__ == "__main__":
    main()
