// Native KD-tree — host-side nearest-neighbor runtime for vfmreg_tpu_torch.
//
// A copy of `vfmreg_tpu/native/kdtree.cpp`, built with the same flags
// (`native/kdtree.py`), so that kNN tie order, the Boruvka MST and the single
// linkage agree bit for bit with the reference's build on the same host.
// It serves the host-side (ragged, data-dependent) neighbor work of the
// cluster-removal experiment: `utils.pcl.KNeighbors` (faiss IndexFlatL2
// semantics) for the region growth and the KD-tree Boruvka MST behind
// `utils.hdbscan`. Dense batched matching stays on the card
// (`ops/matching.py`); this covers the host-only callers.
//
// Capabilities (plain C ABI for ctypes — no pybind11 in this toolchain):
//   * kd_build / kd_free            — median-split tree over [n, dim] doubles
//   * kd_knn                        — OpenMP-parallel k-NN (squared L2)
//   * kd_mst_mutual_reachability    — exact Boruvka MST of the HDBSCAN
//     mutual-reachability graph mr(a,b) = max(core_a, core_b, ||a-b||), using
//     single-tree nearest-foreign-component queries with bbox + min-core
//     pruning and per-round same-component subtree skipping.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kLeafSize = 16;

struct Node {
    int left = -1, right = -1;  // children (-1 for leaf)
    int start = 0, end = 0;     // range in `order`
    // bbox stored in KdTree::bbox at [2 * dim * node_id]
    double min_core = 0.0;      // min core distance under this node (MST only)
    int comp = -1;              // component tag if whole subtree is one component
};

struct KdTree {
    int dim = 0;
    int64_t n = 0;
    std::vector<double> pts;     // n * dim, reordered by `order` at build
    std::vector<int64_t> order;  // tree position -> original index
    std::vector<Node> nodes;
    std::vector<double> bbox;    // per node: dim mins then dim maxs

    const double* point(int64_t tree_pos) const { return &pts[tree_pos * dim]; }
};

int build_node(KdTree& t, int start, int end, std::vector<double>& scratch) {
    int id = int(t.nodes.size());
    t.nodes.emplace_back();
    t.bbox.resize(t.bbox.size() + 2 * t.dim);
    {
        Node& nd = t.nodes[id];
        nd.start = start;
        nd.end = end;
    }
    double* bb = &t.bbox[size_t(2) * t.dim * id];
    for (int d = 0; d < t.dim; ++d) {
        bb[d] = std::numeric_limits<double>::infinity();
        bb[t.dim + d] = -std::numeric_limits<double>::infinity();
    }
    for (int i = start; i < end; ++i) {
        const double* p = t.point(i);
        for (int d = 0; d < t.dim; ++d) {
            bb[d] = std::min(bb[d], p[d]);
            bb[t.dim + d] = std::max(bb[t.dim + d], p[d]);
        }
    }
    if (end - start <= kLeafSize) return id;

    int split_dim = 0;
    double widest = -1.0;
    for (int d = 0; d < t.dim; ++d) {
        double w = bb[t.dim + d] - bb[d];
        if (w > widest) { widest = w; split_dim = d; }
    }
    if (widest <= 0.0) return id;  // all points identical: keep as leaf

    int mid = (start + end) / 2;
    // Partition rows [start, end) of the SoA arena around the median of
    // split_dim. Sort an index permutation, then apply it to pts + order.
    int m = end - start;
    std::vector<int> perm(m);
    std::iota(perm.begin(), perm.end(), 0);
    std::nth_element(perm.begin(), perm.begin() + (mid - start), perm.end(),
                     [&](int a, int b) {
                         return t.pts[size_t(start + a) * t.dim + split_dim] <
                                t.pts[size_t(start + b) * t.dim + split_dim];
                     });
    scratch.resize(size_t(m) * t.dim);
    std::vector<int64_t> ord(m);
    for (int i = 0; i < m; ++i) {
        std::memcpy(&scratch[size_t(i) * t.dim], t.point(start + perm[i]),
                    sizeof(double) * t.dim);
        ord[i] = t.order[start + perm[i]];
    }
    std::memcpy(&t.pts[size_t(start) * t.dim], scratch.data(), sizeof(double) * m * t.dim);
    std::copy(ord.begin(), ord.end(), t.order.begin() + start);

    int l = build_node(t, start, mid, scratch);
    int r = build_node(t, mid, end, scratch);
    t.nodes[id].left = l;
    t.nodes[id].right = r;
    return id;
}

inline double bbox_min_d2(const KdTree& t, int node, const double* q) {
    const double* bb = &t.bbox[size_t(2) * t.dim * node];
    double d2 = 0.0;
    for (int d = 0; d < t.dim; ++d) {
        double lo = bb[d], hi = bb[t.dim + d];
        double v = q[d] < lo ? lo - q[d] : (q[d] > hi ? q[d] - hi : 0.0);
        d2 += v * v;
    }
    return d2;
}

inline double dist2(const double* a, const double* b, int dim) {
    double s = 0.0;
    for (int d = 0; d < dim; ++d) {
        double v = a[d] - b[d];
        s += v * v;
    }
    return s;
}

// Bounded max-heap of (d2, original index) pairs for k-NN.
struct KnnHeap {
    int k;
    int size = 0;
    double* d2;
    int64_t* idx;

    double worst() const { return size < k ? std::numeric_limits<double>::infinity() : d2[0]; }

    void push(double d, int64_t i) {
        if (size < k) {
            d2[size] = d; idx[size] = i; ++size;
            int c = size - 1;
            while (c > 0) {
                int p = (c - 1) / 2;
                if (d2[p] >= d2[c]) break;
                std::swap(d2[p], d2[c]); std::swap(idx[p], idx[c]); c = p;
            }
        } else if (d < d2[0]) {
            d2[0] = d; idx[0] = i;
            int p = 0;
            for (;;) {
                int l = 2 * p + 1, r = l + 1, m = p;
                if (l < k && d2[l] > d2[m]) m = l;
                if (r < k && d2[r] > d2[m]) m = r;
                if (m == p) break;
                std::swap(d2[p], d2[m]); std::swap(idx[p], idx[m]); p = m;
            }
        }
    }

    void sort_ascending() {
        // heap-sort in place, then reverse (max-heap pops give descending).
        int full = size;
        while (size > 1) {
            --size;
            std::swap(d2[0], d2[size]); std::swap(idx[0], idx[size]);
            int p = 0;
            for (;;) {
                int l = 2 * p + 1, r = l + 1, m = p;
                if (l < size && d2[l] > d2[m]) m = l;
                if (r < size && d2[r] > d2[m]) m = r;
                if (m == p) break;
                std::swap(d2[p], d2[m]); std::swap(idx[p], idx[m]); p = m;
            }
        }
        size = full;
    }
};

void knn_recurse(const KdTree& t, int node, const double* q, KnnHeap& heap) {
    const Node& nd = t.nodes[node];
    if (nd.left < 0) {
        for (int i = nd.start; i < nd.end; ++i)
            heap.push(dist2(t.point(i), q, t.dim), t.order[i]);
        return;
    }
    double dl = bbox_min_d2(t, nd.left, q);
    double dr = bbox_min_d2(t, nd.right, q);
    int first = nd.left, second = nd.right;
    if (dr < dl) { std::swap(first, second); std::swap(dl, dr); }
    if (dl < heap.worst()) knn_recurse(t, first, q, heap);
    if (dr < heap.worst()) knn_recurse(t, second, q, heap);
}

// ------------------------------------------------------------------ MST ----

struct MstCtx {
    const KdTree* t;
    std::vector<double> core;        // by ORIGINAL index
    std::vector<double> core_tree;   // by tree position
    std::vector<int> comp;           // by original index (union-find root id)
    std::vector<int> uf;             // union-find parent
};

int uf_find(std::vector<int>& uf, int a) {
    int root = a;
    while (uf[root] != root) root = uf[root];
    while (uf[a] != root) { int nxt = uf[a]; uf[a] = root; a = nxt; }
    return root;
}

// Recompute per-node (min_core, single-component tag) for the current round.
void refresh_tags(KdTree& t, MstCtx& c, int node) {
    Node& nd = t.nodes[node];
    if (nd.left < 0) {
        double mc = std::numeric_limits<double>::infinity();
        int comp = c.comp[t.order[nd.start]];
        for (int i = nd.start; i < nd.end; ++i) {
            mc = std::min(mc, c.core_tree[i]);
            if (c.comp[t.order[i]] != comp) comp = -1;
        }
        nd.min_core = mc;
        nd.comp = comp;
        return;
    }
    refresh_tags(t, c, nd.left);
    refresh_tags(t, c, nd.right);
    nd.min_core = std::min(t.nodes[nd.left].min_core, t.nodes[nd.right].min_core);
    int cl = t.nodes[nd.left].comp, cr = t.nodes[nd.right].comp;
    nd.comp = (cl >= 0 && cl == cr) ? cl : -1;
}

struct Candidate {
    double w = std::numeric_limits<double>::infinity();
    int64_t other = -1;
};

// Nearest point NOT in component `qc` under the mutual-reachability metric.
void mst_query(const KdTree& t, const MstCtx& c, int node, const double* q,
               double q_core, int qc, Candidate& best) {
    const Node& nd = t.nodes[node];
    if (nd.comp == qc) return;  // whole subtree already merged with q
    if (nd.left < 0) {
        for (int i = nd.start; i < nd.end; ++i) {
            int64_t oi = t.order[i];
            if (c.comp[oi] == qc) continue;
            double w = std::sqrt(dist2(t.point(i), q, t.dim));
            w = std::max(w, std::max(q_core, c.core_tree[i]));
            if (w < best.w || (w == best.w && oi < best.other)) {
                best.w = w;
                best.other = oi;
            }
        }
        return;
    }
    double dl = std::max({std::sqrt(bbox_min_d2(t, nd.left, q)), q_core,
                          t.nodes[nd.left].min_core});
    double dr = std::max({std::sqrt(bbox_min_d2(t, nd.right, q)), q_core,
                          t.nodes[nd.right].min_core});
    int first = nd.left, second = nd.right;
    if (dr < dl) { std::swap(first, second); std::swap(dl, dr); }
    if (dl <= best.w) mst_query(t, c, first, q, q_core, qc, best);
    if (dr <= best.w) mst_query(t, c, second, q, q_core, qc, best);
}

}  // namespace

extern "C" {

void* kd_build(const double* pts, int64_t n, int dim) {
    auto* t = new KdTree();
    t->dim = dim;
    t->n = n;
    t->pts.assign(pts, pts + n * dim);
    t->order.resize(n);
    std::iota(t->order.begin(), t->order.end(), int64_t(0));
    std::vector<double> scratch;
    build_node(*t, 0, int(n), scratch);
    return t;
}

void kd_free(void* handle) { delete static_cast<KdTree*>(handle); }

// queries: [nq, dim]; outputs [nq, k] (squared L2, ascending; index -1 pads
// when k > n).
void kd_knn(void* handle, const double* queries, int64_t nq, int k,
            int64_t* out_idx, double* out_d2) {
    const KdTree& t = *static_cast<KdTree*>(handle);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t i = 0; i < nq; ++i) {
        std::vector<double> hd(k);
        std::vector<int64_t> hi(k, -1);
        KnnHeap heap{k, 0, hd.data(), hi.data()};
        knn_recurse(t, 0, queries + i * t.dim, heap);
        heap.sort_ascending();
        for (int j = 0; j < k; ++j) {
            out_idx[i * k + j] = j < heap.size ? hi[j] : -1;
            out_d2[i * k + j] = j < heap.size ? hd[j] : std::numeric_limits<double>::infinity();
        }
    }
}

// Exact Boruvka MST of the mutual-reachability graph. `core` is [n] (by
// original index). Writes n-1 edges; returns the number written.
int64_t kd_mst_mutual_reachability(void* handle, const double* core,
                                   int64_t* out_a, int64_t* out_b, double* out_w) {
    KdTree& t = *static_cast<KdTree*>(handle);
    int64_t n = t.n;
    if (n <= 1) return 0;

    MstCtx c;
    c.t = &t;
    c.core.assign(core, core + n);
    c.core_tree.resize(n);
    for (int64_t i = 0; i < n; ++i) c.core_tree[i] = core[t.order[i]];
    c.uf.resize(n);
    std::iota(c.uf.begin(), c.uf.end(), 0);
    c.comp.resize(n);

    int64_t n_edges = 0;
    std::vector<Candidate> best(n);
    while (n_edges < n - 1) {
        for (int64_t i = 0; i < n; ++i) c.comp[i] = uf_find(c.uf, int(i));
        refresh_tags(t, c, 0);

        // Per-point nearest foreign neighbor under mutual reachability
        // (points iterated in tree order; results keyed by original index).
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
        for (int64_t i = 0; i < n; ++i) {
            best[i] = Candidate();
            mst_query(t, c, 0, t.point(i), c.core_tree[i], c.comp[t.order[i]], best[i]);
        }

        // Reduce to one minimum outgoing edge per component (tie-break by
        // (w, min_endpoint, max_endpoint) so ties cannot form cycles).
        struct Edge { double w; int64_t a, b; };
        std::vector<Edge> comp_best(n, {std::numeric_limits<double>::infinity(), -1, -1});
        for (int64_t i = 0; i < n; ++i) {
            if (best[i].other < 0) continue;
            int64_t a = t.order[i], b = best[i].other;
            int ca = c.comp[a];
            Edge e{best[i].w, std::min(a, b), std::max(a, b)};
            Edge& cur = comp_best[ca];
            if (e.w < cur.w || (e.w == cur.w && (e.a < cur.a || (e.a == cur.a && e.b < cur.b))))
                cur = e;
        }
        bool merged_any = false;
        for (int64_t ci = 0; ci < n; ++ci) {
            const Edge& e = comp_best[ci];
            if (e.a < 0) continue;
            int ra = uf_find(c.uf, int(e.a)), rb = uf_find(c.uf, int(e.b));
            if (ra == rb) continue;
            c.uf[ra] = rb;
            out_a[n_edges] = e.a;
            out_b[n_edges] = e.b;
            out_w[n_edges] = e.w;
            ++n_edges;
            merged_any = true;
        }
        if (!merged_any) break;  // disconnected (cannot happen for finite input)
    }
    return n_edges;
}

// Sorted-edge union-find single linkage over an MST edge list. Matches the
// Python fallback exactly: stable sort by weight, path-compressed find,
// merge rows (root_a, root_b, weight, merged_size) with fresh internal node
// ids n..2n-2 assigned in merge order. out_merges is [n-1, 4] doubles.
void kd_single_linkage(const int64_t* ea, const int64_t* eb, const double* ew,
                       int64_t n, double* out_merges) {
    if (n <= 1) return;
    std::vector<int64_t> order(n - 1);
    std::iota(order.begin(), order.end(), int64_t(0));
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t x, int64_t y) { return ew[x] < ew[y]; });
    std::vector<int64_t> parent(2 * n - 1), size(2 * n - 1, 0);
    std::iota(parent.begin(), parent.end(), int64_t(0));
    std::fill(size.begin(), size.begin() + n, int64_t(1));
    auto find = [&](int64_t a) {
        int64_t root = a;
        while (parent[root] != root) root = parent[root];
        while (parent[a] != root) { int64_t nxt = parent[a]; parent[a] = root; a = nxt; }
        return root;
    };
    int64_t nxt = n;
    for (int64_t i = 0; i < n - 1; ++i) {
        int64_t e = order[i];
        int64_t ra = find(ea[e]), rb = find(eb[e]);
        int64_t s = size[ra] + size[rb];
        out_merges[i * 4 + 0] = double(ra);
        out_merges[i * 4 + 1] = double(rb);
        out_merges[i * 4 + 2] = ew[e];
        out_merges[i * 4 + 3] = double(s);
        size[nxt] = s;
        parent[ra] = parent[rb] = nxt;
        ++nxt;
    }
}

}  // extern "C"
