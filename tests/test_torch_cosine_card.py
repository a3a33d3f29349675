"""Kernel B1 on the live query rows, on an NVIDIA card (each test skips
without one).

Run on the card: `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cosine_card.py -q` (`--noconftest`: `tests/conftest.py`
imports JAX, which this file does not need).

The masked call (`q_mask`) against the dense call (`q_mask=None`) of the same
kernel: every live row's similarity and index bit for bit, every masked row
(-1e30, 0); at live counts around a tile of 128, at the method row's layout
(1,700 live rows of 16,384, packed at the front of each 2,048-row scan block
or scattered), with every row live, at N not a multiple of 128, and where
the launched grid bounds the split of M. The masked call is captured in a
CUDA graph, which fails on any host synchronisation, and replayed on a new
mask. `row_stats` counts the rows passed and the live rows computed.
"""

import pytest
import torch

from vfmreg_tpu_torch.ops import cosine_kernel as ck

D = 384
M = 60_000  # 468.75 tiles of 128
SIM_ATOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this machine has no CUDA device")
    return torch.device("cuda", 0)


def _unit(g, *shape):
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    return (x / x.norm(dim=-1, keepdim=True)).float()


@pytest.fixture(scope="module")
def database(card):
    g = torch.Generator().manual_seed(11)
    db = _unit(g, M, D).to(card)
    mask = (torch.rand(M, generator=g) > 0.1).to(card)
    return db, mask


def _queries(card, n, seed):
    return _unit(torch.Generator().manual_seed(seed), n, D).to(card)


def _scattered(card, n, live, seed):
    g = torch.Generator().manual_seed(seed)
    qm = torch.zeros(n, dtype=torch.bool)
    qm[torch.randperm(n, generator=g)[:live]] = True
    return qm.to(card)


def _assert_live_rows_equal_dense(q, db, mask, qm):
    sim, idx = ck.cosine_argmax(q, db, mask, qm)
    dsim, didx = ck.cosine_argmax(q, db, mask)
    torch.cuda.synchronize()
    assert torch.equal(sim[qm], dsim[qm]) and torch.equal(idx[qm], didx[qm])
    assert bool((sim[~qm] == -1e30).all()) and bool((idx[~qm] == 0).all())
    return sim, idx


@pytest.mark.card
@pytest.mark.parametrize("live", [0, 1, 127, 128, 129])
def test_live_counts_around_a_tile(card, database, live):
    db, mask = database
    q = _queries(card, 1000, live)
    qm = _scattered(card, 1000, live, live)
    sim, _ = _assert_live_rows_equal_dense(q, db, mask, qm)
    psim, _ = ck.cosine_argmax_plain(q, db, mask, qm)
    assert float((sim - psim).abs().max()) <= SIM_ATOL


@pytest.mark.card
@pytest.mark.parametrize("layout", ["packed", "scattered"])
def test_the_method_rows_layout(card, database, layout):
    """1,700 live rows of 8 x 2,048: the row's 5 m queries at the front of
    each scan's block (`_preprocess_scans_device`), or anywhere."""
    db, mask = database
    n = 8 * 2048
    q = _queries(card, n, 7)
    if layout == "packed":
        per_scan = [213] * 4 + [212] * 4
        qm = torch.cat([torch.arange(2048) < k for k in per_scan]).to(card)
    else:
        qm = _scattered(card, n, 1700, 7)
    assert int(qm.sum()) == 1700
    _assert_live_rows_equal_dense(q, db, mask, qm)


@pytest.mark.card
@pytest.mark.parametrize("n", [4096, 1000, 3001])
def test_every_row_live_is_the_dense_call(card, database, n):
    db, mask = database
    q = _queries(card, n, n)
    qm = torch.ones(n, dtype=torch.bool, device=card)
    sim, idx = ck.cosine_argmax(q, db, mask, qm)
    dsim, didx = ck.cosine_argmax(q, db, mask)
    assert torch.equal(sim, dsim) and torch.equal(idx, didx)


@pytest.mark.card
def test_the_grid_bounds_the_split(card, database):
    """10 query tiles and 9 live ones: the plan for 9 tiles would take more
    blocks than the grid launched for 10 has, and is cut to fit."""
    db, mask = database
    n, live = 1280, 1100
    q_tiles, m_tiles = 10, -(-M // ck._BM)
    target = ck._target_blocks(card)
    capacity = q_tiles * ck._split_plan(q_tiles, m_tiles, target)[1]
    lt = -(-live // ck._BQ)
    assert lt * ck._split_plan(lt, m_tiles, target)[1] > capacity  # H100: 1,062 blocks against 940
    _assert_live_rows_equal_dense(_queries(card, n, 3), db, mask, _scattered(card, n, live, 3))


@pytest.mark.card
def test_masked_call_is_captured_in_a_cuda_graph(card, database):
    """Captured with one mask, replayed on another written into the same
    tensor: the live count and the split are read on the card."""
    db, mask = database
    n = 4096
    q = _queries(card, n, 5)
    qm = _scattered(card, n, 600, 5)
    ck.cosine_argmax(q, db, mask, qm)  # the counter and the library exist before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sim, idx = ck.cosine_argmax(q, db, mask, qm)
    for live, seed in ((600, 5), (3000, 6), (1, 8)):
        qm.copy_(_scattered(card, n, live, seed))
        graph.replay()
        want_sim, want_idx = ck.cosine_argmax(q, db, mask, qm)
        torch.cuda.synchronize()
        assert torch.equal(sim, want_sim) and torch.equal(idx, want_idx), live


@pytest.mark.card
def test_row_stats_count_the_live_rows(card, database):
    db, mask = database
    n = 2048
    q = _queries(card, n, 9)
    qm = _scattered(card, n, 300, 9)
    ck.reset_row_stats()
    ck.cosine_argmax(q, db, mask, qm)
    ck.cosine_argmax(q, db, mask, qm)
    assert ck.row_stats() == {"rows_passed": 2 * n, "live_rows": 600}
    ck.cosine_argmax(q, db, mask)
    assert ck.row_stats() == {"rows_passed": 3 * n, "live_rows": 600 + n}
