"""Readings that the `desc.g14.b8` limits of `correct` are set from, on this machine's card.

    python3 benchmark/calibrate_descriptors.py --workload desc.g14.b8 --seeds 11,12,...
        [--control-seeds 3] [--fault-seeds 3] [--out readings.jsonl]

The descriptor pass's counterpart of `calibrate.py`. For every seed, in one
process: the cell's scene and weights, every distinct batch driven through
the program after one warm-up call each (the calls a run's window makes),
and the compared numbers of those outputs against the plain reference (the
lower readings). For the first `--control-seeds` seeds besides, the control:
the plain reference computed on TF32-rounded operands, standing in the
program's place on the first batch, judged the same way (an upper reading).
For the first `--fault-seeds` seeds, every batch once more through the
program with each planted fault of `FAULTS`, judged the same way. One JSON
line per seed and kind.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


@contextlib.contextmanager
def _block_skipped(entry):
    """The middle block of the ViT passes its input through."""
    blk = entry.generator.model.blocks[len(entry.generator.model.blocks) // 2]
    blk.forward = lambda x: x
    try:
        yield
    finally:
        del blk.forward


@contextlib.contextmanager
def _registers_in_patches(entry):
    """The patch features read from token 1: the registers in, the last patches out."""
    model = entry.generator.model

    def forward(images):
        p = model.cfg.patch_size
        gh, gw = images.shape[1] // p, images.shape[2] // p
        x = model.tokens(images)
        for blk in model.blocks:
            x = blk(x)
        x = model.norm(x)
        return {"cls": x[:, 0], "patches": x[:, 1:1 + gh * gw].reshape(images.shape[0], gh, gw, -1)}

    model.forward = forward
    try:
        yield
    finally:
        del model.forward


@contextlib.contextmanager
def _resize_without_antialias(entry):
    """The position grid resized by the plain bicubic, as the models without registers resize it."""
    model = entry.generator.model
    kept = model.cfg
    model.cfg = dataclasses.replace(kept, interpolate_antialias=False)
    try:
        yield
    finally:
        model.cfg = kept


@contextlib.contextmanager
def _camera_dropped(entry):
    """The rig serves every camera but the last."""
    rig = entry.data.rig
    served = rig.read_images
    rig.read_images = lambda filenames: dict(list(served(filenames).items())[:-1])
    try:
        yield
    finally:
        del rig.read_images


@contextlib.contextmanager
def _program_in_tf32(entry):
    """The program's f32 matmuls in TF32 (cuBLAS; B5 keeps its 3xTF32); nothing changes on the CPU."""
    kept = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = kept


FAULTS = {
    "block_skipped": _block_skipped,
    "registers_in_patches": _registers_in_patches,
    "resize_without_antialias": _resize_without_antialias,
    "camera_dropped": _camera_dropped,
    "program_in_tf32": _program_in_tf32,
}


def readings(cell, seed: int, dev: torch.device, control: bool, faults: bool, emit) -> None:
    """Every reading of one seed, through `emit`."""
    entry_mod = importlib.import_module(f"benchmark.entries.{cell.config['entry']}")
    reference = importlib.import_module(f"benchmark.reference.{cell.config['entry']}")
    t0 = time.perf_counter()
    entry = entry_mod.Entry(cell.config, cell.traffic, seed, dev)
    for k in range(entry.n_batches):
        entry.call(k)
    outputs, seconds = [], []
    for k in range(entry.n_batches):
        t = time.perf_counter()
        outputs.append(entry.call(k))
        seconds.append(time.perf_counter() - t)
    faulted = {}
    if faults:
        for name, plant in FAULTS.items():
            with plant(entry):
                faulted[name] = [entry.call(k) for k in range(entry.n_batches)]
    failed = sum(entry.failed(o) for o in outputs)
    data = entry.data
    entry.close()
    del entry
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    state = reference.prepare(data, cell.config)
    ref = reference.answers(state)
    emit({"cell": cell.name, "seed": seed, "kind": "program", "numbers": reference.judge(state, outputs, ref),
          "failed": failed, "scans": sum(o["scans"] for o in outputs), "call_s": seconds,
          "reference_s": time.perf_counter() - t1, "seed_s": time.perf_counter() - t0})
    for name, outs in faulted.items():
        emit({"cell": cell.name, "seed": seed, "kind": f"fault:{name}", "numbers": reference.judge(state, outs, ref)})
    if control:
        t2 = time.perf_counter()
        answer = reference.answers(state, tf32=True, batches=[0])[0]
        emit({"cell": cell.name, "seed": seed, "kind": "control_tf32",
              "numbers": reference.judge(state, [dict(answer, batch=0)], ref), "control_s": time.perf_counter() - t2})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="desc.g14.b8")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_descriptors: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell.load(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    dev = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        readings(cell, seed, dev, i < args.control_seeds, i < args.fault_seeds, emit)
        torch.cuda.empty_cache()
    found = harness.banned_modules()
    if found:
        print(f"calibrate_descriptors: imported {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
