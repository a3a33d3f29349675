"""Parity of the port's `utils/profiling.py` and the driver's two profiling
switches with `vfmreg_tpu`.

* `Timer.report` gives the reference's lines for the same totals and
  counts, `summarize_durations` the reference's numbers;
* `trace` writes a Chrome trace on the CPU in which an `annotate` name
  appears, and is a no-op without a directory;
* `VFMREG_PROFILE_DRIVER=1`: `precompute_scene_batched` gives every stage's
  seconds and prints the reference's breakdown line; without it
  `stats["seconds"]` holds the row's total only. Both runs' results are
  equal bit for bit;
* `VFMREG_PROFILE_ICP_ITERS=1`: each ICP row prints its lanes' iterations
  and settled flags in the reference's line (equal to the row's stats), and
  the vanilla row runs as one full-budget loop in place of the two-phase
  row. On this scene every vanilla lane settles within the first phase, so
  the results equal those without the switch bit for bit.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu.utils import profiling as jprof  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene  # noqa: E402
from vfmreg_tpu_torch.registration.icp import FAR_FIELD_PHASE1_ITERATIONS  # noqa: E402
from vfmreg_tpu_torch.utils import profiling as tprof  # noqa: E402

STAGES = {"grid_build", "preprocess", "match", "snap", "ransac", "gt_refine_icp", "vanilla_icp", "final_read"}
RESULT_KEYS = ("gt", "vfm_ransac_raw", "vfm_ransac_ortho", "vfm_ransac_icp", "icp", "corr_counts", "snap_counts",
               "map_size", "scan_sizes", "retried")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_node.py sets it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_timer_and_summary_match_reference():
    totals = {"icp": 1.25, "match": 0.003125, "a_long_stage_name_of_thirty_two_": 12.5}
    counts = {"icp": 4, "match": 1, "a_long_stage_name_of_thirty_two_": 3}
    timers = [jprof.Timer(), tprof.Timer()]
    for t in timers:
        t.totals.update(totals)
        t.counts.update(counts)
    assert timers[1].report() == timers[0].report()
    assert len(timers[1].report().splitlines()) == 3
    t = tprof.Timer()
    with t.span("work"):
        pass
    with t.span("work"):
        pass
    assert t.counts["work"] == 2 and "x2" in t.report()
    t.reset()
    assert t.report() == ""
    assert isinstance(tprof.GLOBAL_TIMER, tprof.Timer)
    for d in ([0.01, 0.02, 0.5, 0.03, 0.04], [0.2], []):
        assert tprof.summarize_durations(d) == jprof.summarize_durations(d)


def test_trace_writes_annotated_chrome_trace(tmp_path):
    with tprof.trace(None):
        pass
    assert list(tmp_path.iterdir()) == []
    with tprof.trace(str(tmp_path / "tr")):
        with tprof.annotate("vfmreg_probe_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "vfmreg_probe_region" for e in events)


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_driver.py's scene."""
    return make_synthetic_scene(3, 16384, 1024, 24, seed=0, extent=60.0)[:2]


def _row(scene, monkeypatch, capsys, env=None):
    if env is not None:
        monkeypatch.setenv(env, "1")
    res = trn.precompute_scene_batched(*scene, device="cpu")
    if env is not None:
        monkeypatch.delenv(env)
    return res, capsys.readouterr().out


def _equal(a, b, keys=RESULT_KEYS):
    for k in keys:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_driver_profile_switch(scene, monkeypatch, capsys):
    monkeypatch.delenv("VFMREG_PROFILE_DRIVER", raising=False)
    monkeypatch.delenv("VFMREG_PROFILE_ICP_ITERS", raising=False)
    plain, out = _row(scene, monkeypatch, capsys)
    assert set(plain["stats"]["seconds"]) == {"total"}
    assert "[profile]" not in out
    prof, out = _row(scene, monkeypatch, capsys, "VFMREG_PROFILE_DRIVER")
    seconds = prof["stats"]["seconds"]
    assert set(seconds) == STAGES | {"total"}
    line = [ln for ln in out.splitlines() if ln.startswith("[profile] driver stage breakdown (s): ")]
    assert len(line) == 1
    stages = re.findall(r"(\w+)=([0-9.]+)", line[0].split(" | ")[0])
    assert [k for k, _ in stages] == [k for k in seconds if k != "total"]
    assert line[0].endswith(f" | total={sum(v for k, v in seconds.items() if k != 'total'):.3f}")
    _equal(plain, prof)
    for k in ("iterations", "settled", "rebuilds", "loop"):
        assert plain["stats"][k] == prof["stats"][k], k


def test_icp_iters_switch(scene, monkeypatch, capsys):
    monkeypatch.delenv("VFMREG_PROFILE_DRIVER", raising=False)
    calls = []
    two_phase = trn.batched_icp_two_phase

    def counting(*a, **kw):
        calls.append(1)
        return two_phase(*a, **kw)

    monkeypatch.setattr(trn, "batched_icp_two_phase", counting)
    plain, _ = _row(scene, monkeypatch, capsys)
    assert len(calls) == 1
    # Precondition of the equality below: every vanilla lane settles in phase 1.
    its = plain["stats"]["iterations"]["icp"]
    assert all(plain["stats"]["settled"]["icp"]) and max(its) < FAR_FIELD_PHASE1_ITERATIONS, its
    prof, out = _row(scene, monkeypatch, capsys, "VFMREG_PROFILE_ICP_ITERS")
    assert len(calls) == 1  # the vanilla row took the single full-budget loop
    lines = [ln for ln in out.splitlines() if ln.startswith("[profile] icp lane iters")]
    st = prof["stats"]
    want = [f"[profile] icp lane iters ({mode}): {st['iterations'][row]} settled={st['settled'][row]}"
            for row, mode in (("gt", "slabs"), ("refine", "slabs"), ("icp", "planes"))]
    assert lines == want
    _equal(plain, prof)
    for k in ("iterations", "settled", "rebuilds"):
        assert plain["stats"][k] == prof["stats"][k], k
