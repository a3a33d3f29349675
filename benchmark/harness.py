"""The benchmark's one harness: every cell runs through `run`.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. The
configuration's file names the entry that drives the program
(`entries/<entry>.py`) and holds the sizes and the limits of the
comparison; the traffic file (`traffic/<traffic>.json`) holds the scene
generator's parameters. A metric is `metrics/<name>.py`, whose `read(ctx)`
returns its value or None. New cells, configurations and
metrics are new files and entries of `BENCHMARK.json`: nothing here names
one.

A run: set-up makes the scene on the device from the seed, drives every
distinct batch once (every kernel built, every shape warmed), then the
window calls the entry in a closed loop with one caller, cycling the
batches, each call ending in a synchronize, until `seconds` have passed.
After the window the peak memory is read, the program's state is freed and
the plain reference answers each distinct batch; every call's output is
held against it (`correct`). With `trace` the window's first `trace_calls`
calls run under `torch.profiler` with the entry's spans as marks alone, so
that the trace sees the program as the window runs it; the rest of the
window runs with the spans timed (a synchronize at each end) and the
program's own stage clocks on. Without `trace`, `trace_calls` further calls
after the window run under the profiler, for the device's busy time. Every
metric, end-to-end or per layer, is the reader `metrics/<name>.py` of what
the run gathered (`ctx`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import roofline

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level module names that a run may not hold: JAX and the JAX package.
BANNED = ("jax", "jaxlib", "flax", "vfmreg_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc; the clock tick is 10 ms)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def banned_modules() -> List[str]:
    """The banned top-level names that `sys.modules` holds, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: Dict  # BENCHMARK.json
    workload: Dict  # its entry in "workloads"
    config: Dict  # the configuration's file
    traffic: Dict  # the traffic file

    @classmethod
    def load(cls, name: str, spec: Optional[Dict] = None, traffic_dir: Optional[Path] = None) -> "Cell":
        """Cell `name` of `spec` (default: BENCHMARK.json); a configuration's
        file is relative to the checkout's root, a traffic file lies in
        `traffic_dir` (default: the benchmark's traffic/)."""
        spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
        traffic_dir = Path(traffic_dir) if traffic_dir is not None else BENCH / "traffic"
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        return cls(name, spec, w, load_json(ROOT / conf["file"]), load_json(traffic_dir / f"{w['traffic']}.json"))

    def metrics(self, kind: str) -> List[Dict]:
        """The metrics of `kind` ("end_to_end" or "per_layer") this cell reports."""
        return [m for m in self.spec[kind] if self.name in m.get("workloads", [self.name])]


class Spans:
    """Spans around functions of the program, marked for the profiler
    (`bench.<name>`); once `timed`, each also a host-clock time ending in a
    synchronize."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.timed = False
        self.seconds: Dict[str, List[float]] = {}
        self.notes: Dict[str, List] = {}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def wrap(self, name: str, fn: Callable, note: Optional[Callable] = None) -> Callable:
        def wrapped(*args, **kwargs):
            timed = self.timed
            if timed:
                self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
                if timed:
                    self._sync()
            if timed:
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            if note is not None:
                self.notes.setdefault(name, []).append(note(*args, **kwargs))
            return out
        return wrapped

    @contextlib.contextmanager
    def patch(self, module, names: Dict[str, str], notes: Optional[Dict[str, Callable]] = None):
        """Wrap `module.<attr>` as span `names[attr]` for the block."""
        kept = {attr: getattr(module, attr) for attr in names}
        try:
            for attr, span in names.items():
                setattr(module, attr, self.wrap(span, kept[attr], (notes or {}).get(span)))
            yield self
        finally:
            for attr, fn in kept.items():
                setattr(module, attr, fn)


def load_metric(name: str, metrics_dir: Optional[Path] = None):
    """The reader `metrics/<name>.py` (or in `metrics_dir`)."""
    path = Path(metrics_dir if metrics_dir is not None else BENCH / "metrics") / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace_events(prof, window_name: str = "bench.window"):
    """(device ops [(name, start_us, end_us, is_kernel)], host ops of the
    thread that ran the window [(name, start_us, end_us)], the window's
    (start_us, end_us), the device-side extents of the benchmark's marks
    {name: [(start_us, end_us)]}) from a finished profile."""
    from torch.autograd import DeviceType

    ops, host, marks, window, thread = [], [], {}, None, None
    events = list(prof.events())
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name == window_name:
            window, thread = (float(e.time_range.start), float(e.time_range.end)), e.thread
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                if e.name.startswith("bench."):
                    marks.setdefault(e.name[len("bench."):], []).append((float(tr.start), float(tr.end)))
                continue
            kernel = not (e.name.startswith("Memcpy") or e.name.startswith("Memset"))
            ops.append((e.name, float(tr.start), float(tr.end), kernel))
        elif e.thread == thread:
            host.append((e.name, float(tr.start), float(tr.end)))
    return ops, host, window, marks


def busy_seconds(ops) -> float:
    """Seconds in which some operation ran on the device: the union of the ops' intervals."""
    return sum(b - a for a, b in union_intervals([(a, b) for _, a, b, _ in ops])) * 1e-6


def union_intervals(intervals) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def breakdown(ops, host, window) -> Dict:
    """The device operations that took most time, and the idle gaps of the
    window summed by the innermost host operation running at each gap's
    middle ("python" where none ran, the benchmark's own spans left out)."""
    per_op: Dict[str, float] = {}
    for name, a, b, _ in ops:
        per_op[name] = per_op.get(name, 0.0) + (b - a) * 1e-6
    busy = union_intervals([(a, b) for _, a, b, _ in ops])
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    # One thread's operations nest, so a sweep in time order with a stack of
    # the open ones finds each middle's innermost operation.
    marks = sorted([(0.5 * (a + b), 1, b - a) for a, b in gaps]
                   + [(a, 0, (name, b)) for name, a, b in host if not name.startswith("bench.")],
                   key=lambda m: (m[0], m[1]))
    per_gap: Dict[str, float] = {}
    stack: List[tuple] = []
    for t, kind, what in marks:
        while stack and stack[-1][1] < t:
            stack.pop()
        if kind == 0:
            stack.append(what)
        else:
            name = stack[-1][0] if stack else "python"
            per_gap[name] = per_gap.get(name, 0.0) + what * 1e-6

    def top(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(per_op), "idle_gaps": top(per_gap)}


def checked_batches(traffic: Dict, n_batches: int, seed: int) -> List[int]:
    """The batches whose every call the reference checks: all of them, or
    the traffic's `checked_batches` of them drawn from the seed."""
    n = int(traffic.get("checked_batches", n_batches))
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    return sorted(int(k) for k in rng.choice(n_batches, size=min(n, n_batches), replace=False))


def run(name: str, seed: int, seconds: float, trace: bool, device: Optional[torch.device] = None,
        spec: Optional[Dict] = None, traffic_dir: Optional[Path] = None, metrics_dir: Optional[Path] = None,
        log=sys.stderr) -> Dict:
    """One run of cell `name`; returns the result line's object (with its
    "checks" last). `device` None is the card; `spec`, `traffic_dir` and
    `metrics_dir` replace BENCHMARK.json, traffic/ and metrics/ (the
    tests' small cells)."""
    cell = Cell.load(name, spec, traffic_dir)
    dev = device if device is not None else torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    entry_mod = importlib.import_module(f"benchmark.entries.{cell.config['entry']}")
    reference = importlib.import_module(f"benchmark.reference.{cell.config['entry']}")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ---- set-up: the scene from the seed, every batch driven once.
    entry = entry_mod.Entry(cell.config, cell.traffic, seed, dev)
    for k in range(entry.n_batches):
        entry.call(k)
    sync()
    setup_s = process_age()

    # ---- the window.
    spans = Spans(dev)
    outputs, latencies = [], []
    trace_calls = int(cell.traffic.get("trace_calls", 2 * entry.n_batches))

    def profiler():
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))

    prof = None
    stack = contextlib.ExitStack()
    with stack:
        if trace:
            stack.enter_context(entry.traced(spans))
            prof = profiler()
            prof.__enter__()
            window_mark = torch.profiler.record_function("bench.window")
            window_mark.__enter__()
            profiled_t0 = time.perf_counter()
        t_start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            out = entry.call(i % entry.n_batches)
            sync()
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            outputs.append(out)
            i += 1
            if prof is not None and i == trace_calls:
                profiled_s = time.perf_counter() - profiled_t0
                window_mark.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                profiled, prof = prof, None
                spans.timed = True
            # A traced window also times every batch once after the profiled calls.
            if t1 - t_start >= seconds and prof is None and (not trace or i >= trace_calls + entry.n_batches):
                break
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # ---- after the window, without trace: the device's busy time over
    # `trace_calls` more calls, under the profiler.
    post_busy_s = post_scans = None
    if not trace:
        post = profiler()
        with post:
            with torch.profiler.record_function("bench.window"):
                post_out = [entry.call(k % entry.n_batches) for k in range(trace_calls)]
                sync()
        post_scans = sum(entry_mod.attempted(o) for o in post_out)
        post_busy_s = busy_seconds(_trace_events(post)[0]) if cuda else None
        del post, post_out

    # ---- the program's state freed, the reference.
    attempted = sum(entry_mod.attempted(o) for o in outputs)
    failed = sum(entry.failed(o) for o in outputs)
    counters: Dict[str, float] = {}
    for o in outputs:
        for k, v in o.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
    data = entry.data
    stage_ms = entry.stage_ms(outputs, spans)
    entry.close()
    del entry
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checked = checked_batches(cell.traffic, len(data.batches), seed)
    state = reference.prepare(data, cell.config)
    ref_answers = reference.answers(state, batches=checked)
    numbers = reference.judge(state, [o for o in outputs if o["batch"] in checked], ref_answers)
    ref_s = time.perf_counter() - t_ref
    limits = cell.config["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and set(limits) == set(numbers)

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"] + cell.spec["per_layer"]}
    metrics: Dict[str, Dict] = {}
    result: Dict = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    ctx = {"cell": cell.name, "config": cell.config, "outputs": outputs, "latencies_s": latencies,
           "window_s": window_s, "attempted": attempted, "setup_s": setup_s, "peak_bytes": peak,
           "stage_ms": stage_ms, "counters": counters, "post_busy_s": post_busy_s, "post_scans": post_scans}
    if trace:
        ops, host, window, marks = _trace_events(profiled) if cuda else ([], [], (0.0, profiled_s * 1e6), {})
        busy = busy_seconds(ops)
        ctx.update(trace_window_s=profiled_s, busy_s=busy, ops=ops, host=host, trace_calls=trace_calls,
                   trace_attempted=sum(entry_mod.attempted(o) for o in outputs[:trace_calls]),
                   device_spans=marks, notes=spans.notes)
        device_info.update(busy_s=busy, window_s=profiled_s)
        if cuda:
            result["breakdown"] = breakdown(ops, host, window)
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        v = load_metric(m["name"], metrics_dir).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    print(f"[bench] {cell.name} seed {seed}: {len(outputs)} calls in {window_s:.3f} s, set-up "
          f"{setup_s:.3f} s, reference {ref_s:.3f} s, power {_power()}", file=log)
    per_batch: Dict[int, List[float]] = {}
    for o, s_ in zip(outputs, latencies):
        per_batch.setdefault(o["batch"], []).append(s_ * 1e3)
    print("[bench] call ms by batch (median min max): " + "; ".join(
        f"{k} {statistics.median(v):.2f} {min(v):.2f} {max(v):.2f}" for k, v in sorted(per_batch.items())),
        file=log)
    return result


def _power() -> str:
    return roofline.power_limit() or "not read"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on this machine's card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.load(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    return emit(result)


def emit(result: Dict, out=None, err=None) -> int:
    """Print the result: each compared number beside its limit as the last
    lines of standard error, the result as the last line of standard
    output; or, where the process holds JAX or the JAX package, neither,
    and a nonzero code."""
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    found = banned_modules()
    if found:
        print(f"[bench] the run imported {', '.join(found)}: no result", file=err)
        return 4
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
