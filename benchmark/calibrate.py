"""Readings that the limits of `correct` are set from, on this machine's card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... [--control-seeds 3]
        [--fault-seeds 3] [--witness] [--cycles 1] [--out readings.jsonl]

For every seed, in one process: the cell's scene, every distinct batch
driven `cycles` times through the program after one warm-up call each (the
calls a run's window makes), and the compared numbers of those outputs
against the plain reference (the lower readings). For the first
`--control-seeds` seeds the control besides: the plain reference computed
on TF32-rounded operands, standing in the program's place on the first
batch (the cell's own size), and judged the same way (the upper readings).
For the first `--fault-seeds` seeds, every batch once more through the
program with each of the entry's planted faults (`FAULTS`), judged the same
way. `--witness` (the method row): for every scan whose vanilla pose lies
over 1 mm from the reference's, the reference's vanilla row again in f64
and on the scan's points in reverse order, with the gaps between all of
them. One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import plain  # noqa: E402


@contextlib.contextmanager
def _patched(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def _ransac_hypotheses(n):
    from vfmreg_tpu_torch.pipeline import registration_node
    return _patched(registration_node, "RANSAC_HYPOTHESES", n)


def _snap_drops_a_tenth():
    """Scan 0 of every call loses every tenth of its snapped pairs."""
    from vfmreg_tpu_torch.pipeline import registration_node
    orig = registration_node.snap_correspondences

    def snap(*a, **k):
        src, tgt, mask = orig(*a, **k)
        mask = mask.clone()
        rows = torch.nonzero(mask[0])[:, 0]
        mask[0, rows[::10]] = False
        return src, tgt, mask
    return _patched(registration_node, "snap_correspondences", snap)


def _vanilla_minority_moved(metres):
    """Scans 0, 3 and 6 of every call: the vanilla pose `metres` off along x."""
    from vfmreg_tpu_torch.pipeline import registration_node
    orig = registration_node.batched_icp_two_phase

    def two_phase(*a, **k):
        res = orig(*a, **k)
        poses = res.poses.clone()
        poses[0::3, 0, 3] += metres
        return res._replace(poses=poses)
    return _patched(registration_node, "batched_icp_two_phase", two_phase)


def _vanilla_phase_2_skipped():
    """The vanilla row stops after its first phase: a scan that has not
    settled keeps its phase-1 pose."""
    from vfmreg_tpu_torch.parallel import mesh
    from vfmreg_tpu_torch.pipeline import registration_node

    def first_phase(grid, points, mask, guesses, max_dist, kernel, *a, **k):
        return registration_node.batched_icp_stats(grid, points, mask, guesses, max_dist, kernel,
                                                   mesh.FAR_FIELD_PHASE1_ITERATIONS)
    return _patched(registration_node, "batched_icp_two_phase", first_phase)


FAULTS = {
    "method_row": {
        "ransac_10_hypotheses": lambda: _ransac_hypotheses(10),
        "ransac_500_hypotheses": lambda: _ransac_hypotheses(500),
        "snap_drops_a_tenth_of_scan_0": _snap_drops_a_tenth,
        "vanilla_3_of_8_moved_5cm": lambda: _vanilla_minority_moved(0.05),
        "vanilla_3_of_8_moved_1m": lambda: _vanilla_minority_moved(1.0),
        "vanilla_phase_2_skipped": _vanilla_phase_2_skipped,
    },
}


def witness(reference, state, outputs, ref, out):
    """The method row's vanilla poses on the scans where the program parts
    from the reference by over 1 mm: the reference again in f64 and on
    reversed points, and the gaps between them all."""
    grid64 = state["grid"]._replace(points=state["grid"].points.double())
    seen = set()
    for o in outputs:
        k = o["batch"]
        for j in range(len(o["icp"])):
            gap = plain.pose_gap(o["icp"][j], ref[k]["icp"][j])
            if gap[0] <= 1e-3 or (k, j) in seen:
                continue
            seen.add((k, j))
            p3 = reference.scans(state, state["data"].batches[k])[j][0]
            t0 = time.perf_counter()
            eye64 = torch.eye(4, dtype=torch.float64, device=p3.device)
            far = reference.FAR
            r = plain.icp(grid64, p3.double(), eye64, *far, reference.FAR_FIELD_PHASE1_ITERATIONS,
                          reference.ESTIMATION_THRESHOLD)
            if not r.settled:
                r = plain.icp(grid64, p3.double(), torch.as_tensor(r.pose, device=p3.device), *far,
                              reference.MAX_ITERATIONS - reference.FAR_FIELD_PHASE1_ITERATIONS,
                              reference.ESTIMATION_THRESHOLD)
            f64 = r.pose
            rev = reference.vanilla(state, p3.flip(0).contiguous())
            poses = {"program": o["icp"][j], "ref32": ref[k]["icp"][j], "ref64": f64, "ref32_reversed": rev}
            names = list(poses)
            pair_gaps = {f"{a}-{b}": plain.pose_gap(poses[a], poses[b])
                         for i, a in enumerate(names) for b in names[i + 1:]}
            out({"kind": "witness", "batch": k, "scan": j, "gaps": pair_gaps,
                 "program_iterations": o["iterations"]["icp"][j], "program_settled": o["settled"]["icp"][j],
                 "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell.load(args.workload)
    dev = torch.device("cuda", 0)
    entry_name = cell.config["entry"]
    entry_mod = importlib.import_module(f"benchmark.entries.{entry_name}")
    reference = importlib.import_module(f"benchmark.reference.{entry_name}")
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        entry = entry_mod.Entry(cell.config, cell.traffic, seed, dev)
        for k in range(entry.n_batches):
            entry.call(k)
        outputs, seconds = [], []
        for _ in range(args.cycles):
            for k in range(entry.n_batches):
                t = time.perf_counter()
                outputs.append(entry.call(k))
                seconds.append(time.perf_counter() - t)
        repeat_equal = None
        if args.cycles > 1:
            first, again = outputs[:entry.n_batches], outputs[entry.n_batches:2 * entry.n_batches]
            keys = [key for key, v in first[0].items() if isinstance(v, np.ndarray)]
            repeat_equal = all(np.array_equal(a[key], b[key]) for a, b in zip(first, again) for key in keys)
        faulted = {}
        if i < args.fault_seeds:
            for name, plant in FAULTS.get(entry_name, {}).items():
                with plant():
                    faulted[name] = [entry.call(k) for k in range(entry.n_batches)]
        failed = sum(entry.failed(o) for o in outputs)
        data, n_batches = entry.data, entry.n_batches
        entry.close()
        del entry
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        state = reference.prepare(data, cell.config)
        ref = reference.answers(state)
        numbers = reference.judge(state, outputs, ref)
        detail = reference.gaps(state, outputs[:n_batches], ref) if hasattr(reference, "gaps") else None
        emit({"cell": cell.name, "seed": seed, "kind": "program", "numbers": numbers, "failed": failed,
              "repeat_equal": repeat_equal, "gaps": detail,
              "iterations": [o.get("iterations") for o in outputs[:n_batches]],
              "settled": [o.get("settled") for o in outputs[:n_batches]],
              "scans": sum(o["scans"] for o in outputs), "call_s": seconds,
              "reference_s": time.perf_counter() - t1, "seed_s": time.perf_counter() - t0})
        for name, outs in faulted.items():
            emit({"cell": cell.name, "seed": seed, "kind": f"fault:{name}",
                  "numbers": reference.judge(state, outs, ref)})
        if args.witness:
            witness(reference, state, outputs[:n_batches], ref,
                    lambda obj: emit(dict({"cell": cell.name, "seed": seed}, **obj)))
        if i < args.control_seeds:
            t2 = time.perf_counter()
            control = reference.answers(state, tf32=True, batches=[0])
            numbers = reference.judge(state, [dict(control[0], batch=0)], ref)
            emit({"cell": cell.name, "seed": seed, "kind": "control_tf32", "numbers": numbers,
                  "control_s": time.perf_counter() - t2})
        del state, data
        torch.cuda.empty_cache()
    found = harness.banned_modules()
    if found:
        print(f"calibrate: imported {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
