"""Exact maximum clique via bitset branch-and-bound with coloring bounds.

A numpy copy of `vfmreg_tpu/registration/max_clique.py:22-118`. The
reference TEASER++ configuration selects inliers with PMC's EXACT max
clique (`registration_node.py:117`, INLIER_SELECTION_MODE::PMC_EXACT). This is
the host-side equivalent: a Tomita-style MCQ — vertices expanded in greedy-
coloring order, the color number as the branch upper bound — with Python
integers as bitsets (512-node graphs fit in eight 64-bit limbs).

Registration consistency graphs prune well (the inlier clique is large and
dense, outlier edges are sparse), so exact search is cheap at the <=512-node
budget the solver uses. A node-expansion budget guards adversarial inputs;
if exhausted, the best clique found so far is returned (never smaller than
the greedy seed).
"""

from __future__ import annotations

import numpy as np


def _greedy_seed(nbr, nodes):
    """Greedy clique from the highest-degree vertex (lower bound / fallback)."""
    if not nodes:
        return 0
    deg = {v: (nbr[v]).bit_count() for v in nodes}
    v = max(nodes, key=deg.get)
    clique = 1 << v
    cand = nbr[v]
    while cand:
        best, best_d = -1, -1
        c = cand
        while c:
            u = (c & -c).bit_length() - 1
            c &= c - 1
            d = (nbr[u] & cand).bit_count()
            if d > best_d:
                best, best_d = u, d
        clique |= 1 << best
        cand &= nbr[best]
    return clique


def max_clique(adj: np.ndarray, node_budget: int = 2_000_000) -> np.ndarray:
    """adj: [N, N] bool symmetric (diagonal ignored) -> bool [N] clique mask."""
    import sys

    n = adj.shape[0]
    if sys.getrecursionlimit() < 4 * n + 100:
        sys.setrecursionlimit(4 * n + 100)
    a = np.asarray(adj, dtype=bool)
    a = a & a.T
    np.fill_diagonal(a, False)

    nbr = []
    for i in range(n):
        bits = 0
        for j in np.flatnonzero(a[i]):
            bits |= 1 << int(j)
        nbr.append(bits)

    nodes = [i for i in range(n) if nbr[i]]
    best_bits = _greedy_seed(nbr, nodes)
    best_size = best_bits.bit_count()
    budget = [node_budget]

    def color_order(P):
        """Greedy coloring: returns [(vertex, color#)] in ascending color."""
        order = []
        color = 0
        uncolored = P
        while uncolored:
            color += 1
            avail = uncolored
            while avail:
                v = (avail & -avail).bit_length() - 1
                avail &= avail - 1
                order.append((v, color))
                uncolored &= ~(1 << v)
                avail &= ~nbr[v]
        return order

    def expand(R_bits, R_size, P):
        nonlocal best_bits, best_size
        if budget[0] <= 0:
            return
        order = color_order(P)
        # Expand highest-color vertices first; prune when R + color <= best.
        for v, c in reversed(order):
            if budget[0] <= 0:
                return
            if R_size + c <= best_size:
                return  # colors below c cannot beat the incumbent either
            budget[0] -= 1
            vb = 1 << v
            R2 = R_bits | vb
            P2 = P & nbr[v]
            if P2:
                expand(R2, R_size + 1, P2)
            elif R_size + 1 > best_size:
                best_bits, best_size = R2, R_size + 1
            P &= ~vb

    all_bits = 0
    for v in nodes:
        all_bits |= 1 << v
    if nodes:
        expand(0, 0, all_bits)

    out = np.zeros(n, dtype=bool)
    b = best_bits
    while b:
        v = (b & -b).bit_length() - 1
        b &= b - 1
        out[v] = True
    if not out.any() and n:
        out[0] = True  # empty graph: a single vertex is the maximum clique
    return out
