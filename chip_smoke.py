#!/usr/bin/env python3
"""Drive the PyTorch / H100 port of scan-to-map VFM registration on one card.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; takes no arguments. It builds the port's CUDA
kernels from `vfmreg_tpu_torch/csrc/`, holds each against its plain PyTorch
version at the shapes of the main path, then registers B = 8 scans of 16,384
points against a 524,288-point map with 384-d descriptors (bench.py's
primary workload, 1000-iteration budget, random data from a seed) through
`vfmreg_tpu_torch.scan_to_map`, and checks every lane against its true pose.

It prints one JSON line per phase (device, build, data, warmup, kernel_check
for each kernel, slice), then the `kernels` line, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Any failed check raises and
the script exits nonzero; without CUDA, or without the port package beside
it, it exits nonzero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:326-327, the reference's production shapes.
BATCH, N_MAP, N_SCAN, DIM, N_VFM, MAX_ITERATIONS = 8, 524288, 16384, 384, 512, 1000
SEED = 0
DEVICE = "cuda"
# Recall gate of every lane (.claude/skills/verify/SKILL.md's drive recipe).
RTE_GATE_M, RRE_GATE_DEG = 0.3, 1.5
# Kernel tolerances. B1: similarities within SIM_ATOL; indices equal wherever
# the top-2 similarity gap exceeds GAP (below it, the f32 summation order may
# pick either row). B2: each moment within MOMENT_RTOL of the sum of the
# absolute values of its terms (the kernel sums in another order).
SIM_ATOL, GAP, MOMENT_RTOL = 1e-5, 1e-5, 1e-4
# Published peaks of an H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3
# rate and f32 CUDA-core rate. The PCIe card is slower.
PEAKS = {"SXM": (3.35e12, 67e12), "PCIe": (2.0e12, 51e12)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card (CUDA events after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def top2_gap(q, db, mask, chunk=8192):
    """Best minus second-best masked similarity per query (plain, chunked)."""
    import torch

    top = torch.full((q.shape[0], 2), -float("inf"), device=q.device)
    for off in range(0, db.shape[0], chunk):
        sim = q @ db[off : off + chunk].T
        sim = torch.where(mask[None, off : off + chunk], sim, -float("inf"))
        top = torch.topk(torch.cat([top, sim], dim=1), 2, dim=1).values
    return top[:, 0] - top[:, 1]


def check_cosine(qn, dbn, valid, peaks):
    import torch

    from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax, cosine_argmax_plain

    t0 = time.perf_counter()
    sim_k, idx_k = cosine_argmax(qn, dbn, valid)
    sim_p, idx_p = cosine_argmax_plain(qn, dbn, valid)
    decisive = top2_gap(qn, dbn, valid) > GAP
    torch.cuda.synchronize()
    err = float((sim_k - sim_p).abs().max())
    idx_bad = int(((idx_k != idx_p) & decisive).sum())
    ok = err <= SIM_ATOL and idx_bad == 0 and bool(decisive.float().mean() > 0.5)

    def library():
        sim = torch.mm(qn, dbn.T)
        sim.masked_fill_(~valid[None, :], -1e30)
        return sim.max(dim=1)

    ms = cuda_time_ms(lambda: cosine_argmax(qn, dbn, valid), reps=5)
    plain_ms = cuda_time_ms(lambda: cosine_argmax_plain(qn, dbn, valid), reps=3)
    library_ms = cuda_time_ms(library, reps=3)
    n, d = qn.shape
    m_valid = int(valid.sum())
    flops = 2.0 * n * m_valid * d
    nbytes = 4.0 * (n * d + m_valid * d) + dbn.shape[0] + 8.0 * n
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    row = {
        "name": "cosine_argmax", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/cosine_argmax.cu",
        "replaces": "vfmreg_tpu/ops/cosine_kernel.py:56",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": library_ms,
    }
    emit({"phase": "kernel_check", "kernel": "cosine_argmax", "shape": [n, dbn.shape[0], d],
          "m_valid": m_valid, "idx_disagree_decisive": idx_bad,
          "idx_disagree_within_gap": int(((idx_k != idx_p) & ~decisive).sum()),
          "decisive_queries": int(decisive.sum()), "tflops": flops / ms / 1e9,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"cosine_argmax disagrees with its plain version: err={err} idx_bad={idx_bad}")
    return row


def check_gn(cache, source, center, peaks):
    import torch

    from vfmreg_tpu_torch.ops.gn_kernel import gn_moments_from_cache, gn_terms_plain
    from vfmreg_tpu_torch.scan_to_map import KERNEL, MAX_CORRESPONDENCE_DISTANCE as MAX_DIST

    t0 = time.perf_counter()
    args = (cache.cx, cache.cy, cache.cz, source, center, KERNEL, MAX_DIST)
    m_k = gn_moments_from_cache(*args)
    terms = gn_terms_plain(*args)
    m_p, scale = terms.sum(dim=1), terms.abs().sum(dim=1)
    torch.cuda.synchronize()
    diff = (m_k - m_p).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= MOMENT_RTOL * scale)) and float(m_p[0]) > 0
    ms = cuda_time_ms(lambda: gn_moments_from_cache(*args), reps=200, warmup=10)
    plain_ms = cuda_time_ms(lambda: gn_terms_plain(*args).sum(dim=1), reps=20)
    k, n = cache.cx.shape
    nbytes = 4.0 * (3 * k * n + 3 * n + 17)
    flops = float(n) * (8 * k + 60)
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    row = {
        "name": "gn_moments_from_cache", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/gn_moments.cu",
        "replaces": "vfmreg_tpu/ops/gn_kernel.py:98",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }
    emit({"phase": "kernel_check", "kernel": "gn_moments_from_cache", "shape": [k, n],
          "max_rel_err_of_scale": float((diff / scale.clamp(min=1e-30)).max()),
          "accepted": float(m_p[0]), "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"gn_moments_from_cache disagrees with its plain version: {diff.tolist()}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from vfmreg_tpu_torch.geometry.metrics import compute_errors
        from vfmreg_tpu_torch.ops import _build
        from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid, build_nn_cache, gather_candidate_slabs
        from vfmreg_tpu_torch.ops.matching import l2_normalize
        from vfmreg_tpu_torch.scan_to_map import MAP_VOXEL_SIZE, scan_to_map, shared_map_batch, vfm_queries
        from vfmreg_tpu_torch.utils.precision import full_precision
    except ImportError as e:
        print(f"chip_smoke: the vfmreg_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]
    emit({"phase": "device", "nvidia_smi": smi, "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peak_bytes_per_s": peaks[0], "peak_f32_flops": peaks[1]})

    t0 = time.perf_counter()
    _build.build(["cosine_argmax", "gn_moments"])
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    t0 = time.perf_counter()
    full_precision()
    scene = shared_map_batch(BATCH, N_MAP, N_SCAN, DIM, seed=SEED)
    mp, mf, sp, sf = (torch.from_numpy(a).to(dev) for a in scene[:4])
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "map": list(mp.shape), "map_feats": list(mf.shape), "scans": list(sp.shape)})

    def drive():
        res = scan_to_map(mp, mf, sp, sf, n_vfm=N_VFM, max_iterations=MAX_ITERATIONS, device=dev)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    drive()
    emit({"phase": "warmup", "seconds": time.perf_counter() - t0})

    # Kernel inputs at the main path's shapes: the flattened batch of VFM
    # queries against the grid's descriptors (B1); lane 0's champion cache
    # at its initial position (B2).
    grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
    sm = torch.ones(sp.shape[:2], dtype=torch.bool, device=dev)
    _, f5, _ = vfm_queries(sp, sf, sm, N_VFM)
    qn = l2_normalize(f5.reshape(-1, DIM)).contiguous()
    dbn = l2_normalize(grid.feats).contiguous()
    rows = [check_cosine(qn, dbn, grid.valid, peaks)]
    del qn, dbn
    src = sp[0]
    cache = build_nn_cache(gather_candidate_slabs(grid, src, sm[0]), src, sm[0])
    center = src.mean(dim=0).tolist()
    rows.append(check_gn(cache, src.contiguous(), center, peaks))
    del grid, cache
    torch.cuda.empty_cache()

    # The main path, counted and timed end to end (grid build included).
    _build.reset_launches()
    t0 = time.perf_counter()
    res = drive()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    errs = [compute_errors(p.astype("float64"), t) for p, t in zip(res.poses, scene.true_poses)]
    phase2 = int((res.iterations - res.vfm_iterations).sum())
    lanes_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for rte, rre in errs)
    launches_ok = launches.get("cosine_argmax", 0) >= 1 and launches.get("gn_moments_from_cache", 0) == phase2
    emit({"phase": "slice", "ok": lanes_ok and launches_ok, "seconds": seconds,
          "reg_per_s": BATCH / seconds, "batch": BATCH, "map_points": N_MAP, "scan_points": N_SCAN,
          "dim": DIM, "n_vfm": N_VFM, "max_iterations": MAX_ITERATIONS,
          "iterations": res.iterations.tolist(), "vfm_iterations": res.vfm_iterations.tolist(),
          "phase2_iterations": phase2, "n_correspondences": res.n_correspondences.tolist(),
          "rte_m": [e[0] for e in errs], "rre_deg": [e[1] for e in errs], "launches": launches,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not lanes_ok:
        raise RuntimeError(f"recall gate failed: {errs}")
    if not launches_ok:
        raise RuntimeError(f"the main path did not go through every kernel: {launches}, phase 2 = {phase2}")
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
