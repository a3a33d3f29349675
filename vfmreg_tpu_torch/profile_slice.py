"""Where a path of the port spends its time on the card.

    python -m vfmreg_tpu_torch.profile_slice [--path slice|vfm|driver|node|descriptor|odometry|train]
        [--reps N] [--steps-per-read 1,4,16] [--vfm-steps-per-read 1,2,4] [--entries lanes,one_lane]
        [--frames N]

Builds the same full-width inputs as `chip_smoke.py` for the path, seed 0:
the scan-to-map slice, the evaluation driver's method row
(`pipeline.registration_node.precompute_scene_batched` on
`pipeline.synthetic`'s scene), or the scene loop around it
(`RegistrationNode.run_scene`, batched, with the vfm RANSAC and TEASER
columns, on that scene in a scene file's layout), each B = 8 scans x
16,384 points against a 524,288-point map with 384-d descriptors; or the
descriptor pass
(`pipeline.prepare_scenes.create_descriptors` at ViT-S/14 with random
seeded weights, 8 clouds x 16,384 points, 40 rig images of 1232 x 1616);
or the KISS odometry (`kiss.kiss_icp.KissICP` with the default config, its
map resident on the card, over the first `--frames` frames of
`pipeline.synthetic.SyntheticDrive`: 122,880-point sweeps, 1 m a frame);
or the trainer (`train.trainer` on one device, `mesh=None`, at ViT-S/14
with plain attention and the default `TrainConfig`, 8 pairs of 224 x 280
views, 256 corresponding patches a pair, as chip_smoke's train phase).
It warms up once, then prints JSON lines:

* `stages`: host-clock seconds of each stage with a synchronize after it,
  summed over `--reps` runs (slice: grid build, 5 m voxelize, matching, the
  batch's VFM-ICP lane loop, with its iterations and loop counts; vfm:
  VFM-ICP alone on the slice's grid and correspondences, the batch as one
  lane loop and as 8 one-lane `register_frame_vfm` calls, one line per
  entry and `registration.vfm_icp.VFM_STEPS_PER_READ` value, the values
  run in turns, with the phase-1 reads and steps of each call; driver:
  the row's own stage clock under VFMREG_PROFILE_DRIVER=1, with the GN
  iterations of each ICP row and, per ICP row, its loop's kernel B2 step
  calls, device reads, kernel B3 launches and per-lane iterations and
  rebuilds; with `--steps-per-read 1,4,16` one such line per value of
  `registration.icp.GN_STEPS_PER_READ`, the values run in turns; node: the
  node's own stage clock, the kernels' launches and the TEASER solves' GNC
  steps per scene; descriptor: the whole pass, then its images and its ViT features timed apart, and the
  rest, the host projection and the assembly that the forwards do not hide, as the difference; odometry: per
  frame, the median and p90 seconds of each stage of `run_odometry`, and
  frames per second, then the seconds of each free-running run of the same
  frames (`odometry_wall`: one synchronize at the end), with the map's
  lagged point count and with a synchronize after every map update); train:
  the step's stage clock (forward, backward, gradient_all_reduce,
  optimizer) summed over `--reps` steps, and steps per second;
* `profile`: one call without the profiler (odometry: a free-running run), timed on the host clock
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
import dataclasses
import io
import json
import os
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from vfmreg_tpu_torch.config import load_config
from vfmreg_tpu_torch.kiss import kiss_icp
from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator
from vfmreg_tpu_torch.models.vit import PRESETS
from vfmreg_tpu_torch.ops import _build
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences_batched
from vfmreg_tpu_torch.pipeline import registration_node as rn
from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors
from vfmreg_tpu_torch.pipeline.synthetic import (
    SyntheticCameraRig,
    SyntheticDrive,
    make_rig_cloud,
    make_synthetic_scene,
    scene_file_layout,
)
from vfmreg_tpu_torch.registration import icp, teaser, vfm_icp
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
from vfmreg_tpu_torch.utils.profiling import Timer, span


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

    def run_by_stage(k):
        """`run` under VFMREG_PROFILE_DRIVER=1: a synchronize after every
        stage and its seconds in the stats (the row's printed breakdown goes
        to a buffer)."""
        kept = os.environ.get("VFMREG_PROFILE_DRIVER")
        os.environ["VFMREG_PROFILE_DRIVER"] = "1"
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                return run(k)
        finally:
            if kept is None:
                del os.environ["VFMREG_PROFILE_DRIVER"]
            else:
                os.environ["VFMREG_PROFILE_DRIVER"] = kept

    run()  # warm-up
    out = {k: {"stages": {}, "gn_iterations": {}} for k in steps_per_read}
    for _ in range(reps):
        for k in steps_per_read:
            st = run_by_stage(k)["stats"]
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


def _vfm(reps, dev, steps_per_read, entries):
    """VFM-ICP alone on the slice's grid and correspondences, for each
    phase-1 steps-per-read value in turns (None: the module's): the batch
    as one lane loop (`lanes`) and as B one-lane `register_frame_vfm`
    calls (`one_lane`), seconds summed over `reps` runs; returns one call
    of the first entry at the first value."""
    scene = shared_map_batch(8, 524288, 16384, 384, seed=0)
    mp, mf, sp, sf = (torch.from_numpy(a).to(dev) for a in scene[:4])
    sm = torch.ones(sp.shape[:2], dtype=torch.bool, device=dev)
    grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
    corrs = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, *vfm_queries(sp, sf, sm, 512))
    eye = torch.eye(4)
    b = sp.shape[0]

    def lanes():
        r = vfm_icp.register_frames_vfm_lanes(grid, sp, sm, corrs, eye.expand(b, 4, 4),
                                              MAX_CORRESPONDENCE_DISTANCE, KERNEL)
        return r.vfm_iterations.tolist(), r.iterations.tolist(), [dict(r.loop)]

    def one_lane():
        rs = [vfm_icp.register_frame_vfm(grid, sp[j], sm[j], corrs.lane(j), eye, MAX_CORRESPONDENCE_DISTANCE,
                                         KERNEL) for j in range(b)]
        return [r.vfm_iterations for r in rs], [r.iterations for r in rs], [dict(r.loop) for r in rs]

    runs = {"lanes": lanes, "one_lane": one_lane}

    def at(k, entry):
        if k is None:
            return runs[entry]()
        kept, vfm_icp.VFM_STEPS_PER_READ = vfm_icp.VFM_STEPS_PER_READ, k
        try:
            return runs[entry]()
        finally:
            vfm_icp.VFM_STEPS_PER_READ = kept

    for entry in entries:  # warm-up
        at(steps_per_read[0], entry)
    acc = {(k, e): 0.0 for k in steps_per_read for e in entries}
    last = {}
    for _ in range(reps):
        for k in steps_per_read:
            for e in entries:
                t0 = time.perf_counter()
                last[k, e] = at(k, e)
                torch.cuda.synchronize()
                acc[k, e] += time.perf_counter() - t0
    for (k, e), seconds in acc.items():
        vfm_it, it, loops = last[k, e]
        print(json.dumps({"vfm_steps_per_read": k, "entry": e, "seconds": seconds, "reps": reps,
                          "vfm_iterations": vfm_it, "iterations": it, "loops": loops,
                          "device": torch.cuda.get_device_name(0)}))
    return lambda: at(steps_per_read[0], entries[0])


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
        teaser.GNC_STEPS.clear()
        run()
        for key, v in node.stage_seconds.items():
            acc[key] = acc.get(key, 0.0) + v
    print(json.dumps({"stages": acc, "total": sum(acc.values()), "launches_per_scene": dict(_build.LAUNCHES),
                      "gnc_per_scene": dict(teaser.GNC_STEPS),
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
    timer = Timer()
    for _ in range(reps):
        with span("pass", timer, dev):
            run()
        with span("read_images", timer, dev):
            images = [rig.read_images(f) for f in files]
        with span("vit_features", timer, dev):
            for ims in images:
                for im in ims.values():
                    gen.get_image_features(im)
    acc = dict(timer.totals)
    acc["projection_and_assembly"] = acc["pass"] - acc["read_images"] - acc["vit_features"]
    print(json.dumps({"stages": acc, "images": 8 * len(rig.cameras) * reps, "reps": reps,
                      "device": torch.cuda.get_device_name(0)}))
    return run


def _train(reps, dev):
    """The trainer's stage clock over `reps` steps; returns one step."""
    from vfmreg_tpu_torch.train import trainer as T

    cfg = dataclasses.replace(PRESETS["dinov2_vits14"], use_flash_attention=False)
    tcfg = T.TrainConfig()
    state, _, _ = T.create_train_state(torch.Generator().manual_seed(0), cfg, None, tcfg, dev)
    step = T.make_train_step(cfg, None, tcfg)
    rng = np.random.RandomState(0)
    ia = rng.normal(size=(8, 224, 280, 3)).astype(np.float32)
    ib = ia + 0.05 * rng.normal(size=ia.shape).astype(np.float32)
    idx = rng.randint(0, 16 * 20, (8, 256)).astype(np.int32)
    batch = [torch.from_numpy(x).to(dev) for x in (ia, ib, idx)]

    def run():
        step(state, *batch)

    run()  # warm-up
    timer = Timer()
    for _ in range(reps):
        step(state, *batch, timer=timer)
    total = sum(timer.totals.values())
    print(json.dumps({"stages": dict(timer.totals), "total": total, "steps_per_s": reps / total, "reps": reps,
                      "images_per_step": 2 * ia.shape[0], "device": torch.cuda.get_device_name(0)}))
    return run


ODOMETRY_STAGES = ("preprocess_voxelize", "registration", "map_update", "total")


def run_odometry(kiss, dataset, frames, use_descriptors: bool = False, after_frame=None):
    """Register `dataset[i]` for each i of `frames` with `kiss` (a KissICP)
    and time each frame by stage on the host clock, with a synchronize after
    each stage: `registration` (`kiss.registration.register_frame`),
    `map_update` (`VoxelHashMap.update`) and `preprocess_voxelize`, the rest
    of the frame (range crop, both voxelizations, threshold, guess). Reading
    a frame is not timed. `after_frame(i)`, if given, runs after frame i's
    clock stops. Returns one dict of seconds per frame."""
    sync = torch.cuda.synchronize if kiss.local_map.device.type == "cuda" else (lambda: None)
    clock = {}

    def timed(key, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            clock[key] = time.perf_counter() - t0
            return out
        return wrapped

    register = kiss_icp.register_frame
    kiss_icp.register_frame = timed("registration", register)
    kiss.local_map.update = timed("map_update", kiss.local_map.update)
    rows = []
    try:
        for i in frames:
            frame = dataset[i]
            clock.clear()
            t0 = time.perf_counter()
            kiss.register_frame(frame, None, use_descriptors=use_descriptors)
            sync()
            total = time.perf_counter() - t0
            reg, upd = clock.get("registration", 0.0), clock.get("map_update", 0.0)
            rows.append({"frame": i, "total": total, "registration": reg, "map_update": upd,
                         "preprocess_voxelize": total - reg - upd})
            if after_frame is not None:
                after_frame(i)
    finally:
        kiss_icp.register_frame = register
        del kiss.local_map.update
    return rows


def odometry_wall(kiss, frames, use_descriptors: bool = False, sync_update: bool = False) -> float:
    """Seconds for `kiss` (a KissICP) to register every frame of `frames`
    (arrays already read) with one synchronize at the end, as
    `OdometryPipeline` runs it: the map's merge on the card may overlap the
    next frame's host work. With `sync_update` a synchronize follows every
    map update, as a point count read at once after each merge would force."""
    sync = torch.cuda.synchronize if kiss.local_map.device.type == "cuda" else (lambda: None)
    if sync_update:
        update = kiss.local_map.update

        def synced(*args, **kwargs):
            out = update(*args, **kwargs)
            sync()
            return out
        kiss.local_map.update = synced
    try:
        t0 = time.perf_counter()
        for frame in frames:
            kiss.register_frame(frame, None, use_descriptors=use_descriptors)
        sync()
        return time.perf_counter() - t0
    finally:
        if sync_update:
            del kiss.local_map.update


def odometry_stats(rows):
    """Median and p90 seconds per frame of each stage, and frames per second."""
    out = {}
    for key in ODOMETRY_STAGES:
        v = np.array([r[key] for r in rows])
        out[key] = {"median_s": float(np.median(v)), "p90_s": float(np.percentile(v, 90))}
    out["frames_per_s"] = len(rows) / sum(r["total"] for r in rows)
    return out


def _odometry(reps, dev, n_frames):
    """The odometry's stage clock over `reps` runs of a fresh KissICP over
    the drive's first `n_frames` frames, then the same frames free-running
    (`odometry_wall`) with the lagged count and with a synchronize after
    each update; returns one free-running run."""
    drive = SyntheticDrive(n_frames=n_frames, seed=0)
    config = load_config(None)
    frames = [drive[i] for i in range(n_frames)]

    def run(sync_update=False):
        return odometry_wall(kiss_icp.KissICP(config, device=dev), frames, sync_update=sync_update)

    run()  # warm-up
    rows = [r for _ in range(reps) for r in run_odometry(kiss_icp.KissICP(config, device=dev), drive,
                                                         range(n_frames))]
    walls = {k: [run(k == "synced_update") for _ in range(reps)] for k in ("free", "synced_update")}
    print(json.dumps({"stages": odometry_stats(rows), "frames": n_frames, "points_per_frame": drive.n_points,
                      "free_running_s": walls, "reps": reps, "device": torch.cuda.get_device_name(0)}))
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=["slice", "vfm", "driver", "node", "descriptor", "odometry", "train"],
                    default="slice")
    ap.add_argument("--frames", type=int, default=60, help="odometry: frames of the drive per run")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--steps-per-read", default="",
                    help="driver: comma-separated GN_STEPS_PER_READ values to time in turns "
                         "(default: the module's; the profile runs at the first)")
    ap.add_argument("--vfm-steps-per-read", default="",
                    help="vfm: comma-separated VFM_STEPS_PER_READ values to time in turns (default: the module's)")
    ap.add_argument("--entries", default="lanes,one_lane",
                    help="vfm: which of lanes,one_lane to time (the profile runs the first)")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    full_precision()
    if args.path == "driver":
        steps = [int(k) for k in args.steps_per_read.split(",")] if args.steps_per_read else [
            icp.GN_STEPS_PER_READ]
        _profile(_driver(args.reps, dev, steps), args.top)
        return
    if args.path == "vfm":
        steps = [int(k) for k in args.vfm_steps_per_read.split(",")] if args.vfm_steps_per_read else [None]
        _profile(_vfm(args.reps, dev, steps, args.entries.split(",")), args.top)
        return
    if args.path == "node":
        _profile(_node(args.reps, dev), args.top)
        return
    if args.path == "descriptor":
        _profile(_descriptor(args.reps, dev), args.top)
        return
    if args.path == "odometry":
        _profile(_odometry(args.reps, dev, args.frames), args.top)
        return
    if args.path == "train":
        _profile(_train(args.reps, dev), args.top)
        return
    scene = shared_map_batch(8, 524288, 16384, 384, seed=0)
    mp, mf, sp, sf = (torch.from_numpy(a).to(dev) for a in scene[:4])
    sm = torch.ones(sp.shape[:2], dtype=torch.bool, device=dev)
    scan_to_map(mp, mf, sp, sf, device=dev)  # warm-up
    torch.cuda.synchronize()

    timer = Timer()
    eye = torch.eye(4).expand(sp.shape[0], 4, 4)
    for _ in range(args.reps):
        with span("grid_build", timer, dev):
            grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
        with span("voxelize_5m", timer, dev):
            p5, f5, m5 = vfm_queries(sp, sf, sm, 512)
        with span("matching", timer, dev):
            corrs = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, p5, f5, m5)
        with span("vfm_icp_lanes", timer, dev):
            lanes = vfm_icp.register_frames_vfm_lanes(grid, sp, sm, corrs, eye, MAX_CORRESPONDENCE_DISTANCE, KERNEL)
    print(json.dumps({"stages": dict(timer.totals), "reps": args.reps, "device": torch.cuda.get_device_name(0),
                      "vfm_iterations": lanes.vfm_iterations.tolist(), "iterations": lanes.iterations.tolist(),
                      "vfm_icp_loop": dict(lanes.loop)}))
    _profile(lambda: scan_to_map(mp, mf, sp, sf, device=dev), args.top)


def _profile(run, top_n):
    """`profile_run`, printed as one JSON line."""
    print(json.dumps({"profile": profile_run(run, top_n)}))


def profile_run(run, top_n: int = 12) -> dict:
    """One call of `run` on the host clock, then one under `torch.profiler`:
    device-busy seconds, idle share over the unprofiled wall, and the top
    kernels and host operations."""
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
    # Device-side kernels only: a CPU op's device time repeats its kernels',
    # and so does a user annotation's device range (torch's own
    # "Optimizer.step#AdamW.step" in the train path).
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(us for _, us, _ in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:top_n]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:top_n]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "wall_s_profiled": wall_profiled, "idle_share_profiled": 1.0 - busy / wall_profiled,
            "top_kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": c} for k, us, c in top],
            "top_host_ops": [{"name": k[:90], "host_self_ms": us / 1e3, "calls": c} for k, us, c in host]}


if __name__ == "__main__":
    main()
