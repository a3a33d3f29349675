"""HDBSCAN (Euclidean, excess-of-mass cluster extraction) on the host.

Counterpart of `vfmreg_tpu/utils/hdbscan.py`, the
`hdbscan.HDBSCAN(min_cluster_size=100, min_samples=25)` of the cluster-removal
experiment, without sklearn. Every stage is the reference's (Campello et al.
2013):

  1. core distance = distance to the `min_samples`-th nearest neighbour,
     self included;
  2. mutual reachability mr(a, b) = max(core_a, core_b, d(a, b));
  3. the MST of the mutual-reachability graph: the native KD-tree's exact
     Boruvka (`native/kdtree.cpp`, the reference's source and flags);
  4. the single-linkage hierarchy of the sorted MST edges (union-find,
     `kd_single_linkage`);
  5. tree condensation at `min_cluster_size`;
  6. stability-based excess-of-mass selection; noise is -1.

The label VALUES matter here, not only the partition: the removal loop
draws one `standard_normal()` per label in label order
(`pipeline/registration_node.py:_apply_cluster_removal`), so equal
partitions numbered otherwise remove other trees. The labels are numbered
in the order the condensed tree's walk first meets each selected cluster,
as the reference numbers them, and the port's native build gives the
reference's MST, so `hdbscan_labels` returns the reference's labels.

The dense Prim MST (`_core_distances`, `_mst_mutual_reachability`) and the
Python union-find (`_single_linkage`) are the plain versions the tests hold
the native stages against.
"""

from __future__ import annotations

import numpy as np

from vfmreg_tpu_torch.native.kdtree import NativeKDTree, single_linkage_native


def _core_distances(x: np.ndarray, min_samples: int, chunk: int = 2048) -> np.ndarray:
    n = x.shape[0]
    k = min(min_samples, n)
    out = np.empty(n, dtype=np.float64)
    for b in range(0, n, chunk):
        d2 = np.sum((x[b : b + chunk, None, :] - x[None, :, :]) ** 2, axis=-1)
        # k-th smallest including self (self distance 0 is column b+i).
        out[b : b + chunk] = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
    return out


def _mst_native(x: np.ndarray, min_samples: int) -> np.ndarray:
    """KD-tree core distances and the exact Boruvka MST: [n - 1, 3]."""
    tree = NativeKDTree(x)
    k = min(min_samples, x.shape[0])
    _, d2 = tree.knn(x, k)
    core = np.sqrt(d2[:, k - 1])
    return tree.mst_mutual_reachability(core)


def _mst_mutual_reachability(x: np.ndarray, core: np.ndarray):
    """Prim's MST over mr(a,b) without materializing the [n, n] matrix."""
    n = x.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    best_from = np.zeros(n, dtype=np.int64)
    edges = np.empty((n - 1, 3), dtype=np.float64)  # (a, b, weight)

    cur = 0
    in_tree[cur] = True
    for i in range(n - 1):
        d = np.sqrt(np.sum((x - x[cur]) ** 2, axis=-1))
        mr = np.maximum(np.maximum(core, core[cur]), d)
        upd = mr < best
        best[upd] = mr[upd]
        best_from[upd] = cur
        best[cur] = np.inf
        masked = np.where(in_tree, np.inf, best)
        nxt = int(np.argmin(masked))
        edges[i] = (best_from[nxt], nxt, masked[nxt])
        in_tree[nxt] = True
        cur = nxt
    return edges


def _single_linkage(edges: np.ndarray, n: int):
    """Sorted-edge union-find -> merge list [(left_node, right_node, dist, size)]."""
    if edges.shape[0] != n - 1:
        raise ValueError(
            f"single linkage needs the complete MST: got {edges.shape[0]} edges "
            f"for n={n} points (disconnected input, e.g. non-finite coordinates)"
        )
    order = np.argsort(edges[:, 2], kind="stable")
    parent = np.arange(2 * n - 1, dtype=np.int64)
    size = np.concatenate([np.ones(n, dtype=np.int64), np.zeros(n - 1, dtype=np.int64)])

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    merges = np.empty((n - 1, 4), dtype=np.float64)
    nxt = n
    for i, e in enumerate(order):
        a, b, w = int(edges[e, 0]), int(edges[e, 1]), edges[e, 2]
        ra, rb = find(a), find(b)
        merges[i] = (ra, rb, w, size[ra] + size[rb])
        size[nxt] = size[ra] + size[rb]
        parent[ra] = parent[rb] = nxt
        nxt += 1
    return merges


def _condense_and_extract(merges: np.ndarray, n: int, min_cluster_size: int) -> np.ndarray:
    """Condense the hierarchy and select clusters by excess of mass."""
    # Children of each internal node (ids n .. 2n-2).
    left = merges[:, 0].astype(np.int64)
    right = merges[:, 1].astype(np.int64)
    dist = merges[:, 2]
    node_size = np.concatenate([np.ones(n, dtype=np.int64), merges[:, 3].astype(np.int64)])
    root = 2 * n - 2

    # Condensed tree: rows (cluster_id, child_or_point, lambda, child_size).
    # cluster ids are fresh sequential ids; id 0 = root cluster.
    rows_parent, rows_child, rows_lam, rows_size = [], [], [], []
    cluster_of = {root: 0}
    n_clusters = 1
    # Iterative top-down walk.
    stack = [root]
    while stack:
        node = stack.pop()
        cid = cluster_of[node]
        # Descend through chains where one side is too small (points fall out).
        todo = [node]
        while todo:
            cur = todo.pop()
            if cur < n:
                # a singleton that IS the cluster (shouldn't happen for roots)
                rows_parent.append(cid)
                rows_child.append(cur)
                rows_lam.append(np.inf)
                rows_size.append(1)
                continue
            i = cur - n
            l, r, d = left[i], right[i], dist[i]
            lam = 1.0 / d if d > 0 else np.inf
            ls, rs = node_size[l], node_size[r]
            if ls >= min_cluster_size and rs >= min_cluster_size:
                # True split: two new condensed clusters.
                for ch in (l, r):
                    cluster_of[ch] = n_clusters
                    rows_parent.append(cid)
                    rows_child.append(-n_clusters)  # negative = cluster ref
                    rows_lam.append(lam)
                    rows_size.append(int(node_size[ch]))
                    n_clusters += 1
                    stack.append(ch)
            else:
                # Points of small children fall out of `cid` at lambda.
                for ch, s in ((l, ls), (r, rs)):
                    if s >= min_cluster_size:
                        todo.append(ch)  # cluster continues through this child
                    else:
                        # enumerate leaf points of ch
                        sub = [ch]
                        while sub:
                            c2 = sub.pop()
                            if c2 < n:
                                rows_parent.append(cid)
                                rows_child.append(int(c2))
                                rows_lam.append(lam)
                                rows_size.append(1)
                            else:
                                j = c2 - n
                                sub.append(int(left[j]))
                                sub.append(int(right[j]))

    rows_parent = np.asarray(rows_parent)
    rows_child = np.asarray(rows_child)
    rows_lam = np.asarray(rows_lam)
    rows_size = np.asarray(rows_size)

    # Birth lambda per condensed cluster; infinite exit lambdas (duplicate
    # points, d=0 merges) are clamped to the largest finite lambda so they
    # contribute maximal (not negative) stability, as in the hdbscan library.
    finite_lams = rows_lam[np.isfinite(rows_lam)]
    lam_cap = float(finite_lams.max()) if len(finite_lams) else 0.0
    rows_lam = np.where(np.isfinite(rows_lam), rows_lam, lam_cap)
    cluster_rows = rows_child < 0  # rows referencing child clusters
    birth = np.zeros(n_clusters)
    birth[-rows_child[cluster_rows]] = rows_lam[cluster_rows]
    # Stability = sum over exits (individual points and child-split exits,
    # each weighted by its size).
    stability = np.zeros(n_clusters)
    np.add.at(stability, rows_parent, (rows_lam - birth[rows_parent]) * rows_size)

    # Children map (cluster rows only — 2 per split, so this stays tiny).
    kids = [[] for _ in range(n_clusters)]
    for p, c in zip(rows_parent[cluster_rows], rows_child[cluster_rows]):
        kids[p].append(-c)

    # EOM bottom-up: selected[c] = own if stability >= sum(child subtree scores)
    score = stability.copy()
    selected = np.ones(n_clusters, dtype=bool)
    for cid in range(n_clusters - 1, -1, -1):
        if kids[cid]:
            child_sum = sum(score[k] for k in kids[cid])
            if child_sum > stability[cid] and cid != 0:
                score[cid] = child_sum
                selected[cid] = False
    # The root is never selected (it is "all data"), even when the condensed
    # tree has no split at all — hdbscan/sklearn with allow_single_cluster=False
    # then return all-noise, not one all-points cluster.
    selected[0] = False
    # Deselect descendants of selected clusters.
    keep = np.zeros(n_clusters, dtype=bool)
    stack = [(0, False)]
    while stack:
        cid, covered = stack.pop()
        take = selected[cid] and not covered
        keep[cid] = take
        for k in kids[cid]:
            stack.append((k, covered or take))

    # Point labels: a point belongs to the nearest selected ancestor of the
    # condensed cluster it falls out of. Resolve the ancestor walk once per
    # CLUSTER (tens), then label all point rows by one vectorized gather.
    cparent = np.full(n_clusters, -1, dtype=np.int64)
    cparent[-rows_child[cluster_rows]] = rows_parent[cluster_rows]
    kept_anc = np.full(n_clusters, -1, dtype=np.int64)
    for cid0 in range(n_clusters):
        cid = cid0
        while cid >= 0 and not keep[cid]:
            cid = cparent[cid]
        kept_anc[cid0] = cid
    # Label ids in the order the walk first meets each selected cluster's
    # point rows: the reference's numbering, which the removal's draws follow.
    point_rows = ~cluster_rows
    anc = kept_anc[rows_parent[point_rows]]
    labeled = anc >= 0
    uniq, first_idx = np.unique(anc[labeled], return_index=True)
    label_of = np.argsort(np.argsort(first_idx))  # rank = encounter order
    labels = np.full(n, -1, dtype=np.int64)
    pts = rows_child[point_rows][labeled]
    labels[pts] = label_of[np.searchsorted(uniq, anc[labeled])]
    return labels


def hdbscan_labels(points: np.ndarray, min_cluster_size: int = 100, min_samples: int = 25) -> np.ndarray:
    """[N, d] points -> labels [N] (noise = -1), the reference's values."""
    x = np.asarray(points, dtype=np.float64)
    n = x.shape[0]
    if n < max(min_cluster_size, 2):
        return np.full(n, -1, dtype=np.int64)
    merges = single_linkage_native(_mst_native(x, min_samples), n)
    return _condense_and_extract(merges, n, min_cluster_size)
