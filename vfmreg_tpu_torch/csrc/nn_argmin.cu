// Nearest cached champion per query: squared distance and lowest index.
//
// Replaces: vfmreg_tpu/ops/nn_kernel.py, nn_argmin (Pallas, TPU).
//
// cx, cy, cz: the transposed champion cache [K, n] f32 (dead champions hold
// the 2e19 sentinel, whose square overflows to +inf); q: [n, 3] f32. Per
// query: d2_k = (dx*dx + dy*dy) + dz*dz, best = min_k d2_k, and the lowest
// k with d2_k == best. An empty neighbourhood gives best = +inf and k = 0.
// The reference's min propagates NaN, so a NaN anywhere among a query's d2
// (a NaN query coordinate) gives best = NaN and k = 2^30, which no row
// equals.
//
// The contract is bit-identity with `nn_argmin_plain`: d2 is written with
// non-contracting intrinsics (nvcc would otherwise fuse a*b + c into an FMA
// that rounds once), each running minimum uses a strict '<' so the first
// minimum wins, and the first NaN stands beside it, since '<' skips NaN.
//
// What bounds it on an H100: bytes. It reads 3 K n + 3 n floats and writes
// 2 n words, 4 (3 K n + 3 n) + 8 n bytes (at K = 32, n = 16,384: 6.6 MB,
// 1.98 us at 3.35 TB/s), with 8 operations per champion. The cache is read
// once, so the kernel has to keep enough loads in flight on every SM to
// cover the device memory's latency. Design:
// - Query tiles: a block of NS = 4 warps takes BQ = 32 consecutive queries,
//   so n = 8,192 gives 256 blocks and n = 16,384 gives 512 (132 SMs).
// - K split: warp s takes champions [s K / 4, (s + 1) K / 4) of the tile's
//   queries, one query a lane, so each of its loads is 32 consecutive
//   floats of one cache row (128 bytes). With K = 32 compiled in, a lane's
//   8 champions x 3 coordinates are 24 independent loads, unrolled and all
//   in flight at once; any other K takes the generic runtime-K loop. Lane j
//   of warp 0 merges the four partial results (best, lowest k, first NaN)
//   in ascending slice order with the same strict '<', so ties and NaNs
//   resolve as in one pass over k.
// - Ordinary loads, no staging: a form that copied each tile's 96 rows into
//   shared memory with Hopper's 1-D bulk asynchronous copies (one mbarrier
//   per tile) was measured no faster cold and slower warm (PERF.md, B4:
//   96 copies of 128 bytes a tile cost more to issue than the loads), so it
//   was dropped. A ragged n or the last partial tile needs no other path.
// No atomics; each query's two words are written once, by warp 0.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;         // queries per tile: one per lane
constexpr int NS = 4;          // champion slices per query: one per warp
constexpr int NT = BQ * NS;    // threads per block
constexpr int NO_ROW = 1 << 30;

// One champion into a running (best, kb, first NaN) of increasing k.
__device__ __forceinline__ void visit(float x, float y, float z, float sx, float sy, float sz,
                                      int k, float& best, int& kb, float& nan_d2) {
  const float dx = __fsub_rn(x, sx);
  const float dy = __fsub_rn(y, sy);
  const float dz = __fsub_rn(z, sz);
  const float d2 =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  if (d2 != d2 && nan_d2 == nan_d2) nan_d2 = d2;  // the first NaN
  if (d2 < best) {  // strict: the first minimum wins
    best = d2;
    kb = k;
  }
}

// KC > 0: K = KC compiled in, its loads unrolled; KC = 0: runtime K.
template <int KC>
__global__ void __launch_bounds__(NT) nn_argmin_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ q, int K, int n,
    float* __restrict__ best_d2, int* __restrict__ best_k) {
  static_assert(KC % NS == 0, "a compiled-in K splits evenly over the warps");
  __shared__ float s_best[NS][BQ], s_nan[NS][BQ];
  __shared__ int s_k[NS][BQ];

  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const int qi = blockIdx.x * BQ + lane;
  const int ks = KC > 0 ? KC / NS : (K + NS - 1) / NS;
  const int lo = s * ks;
  float best = __int_as_float(0x7f800000);  // +inf
  int kb = lo;
  float nan_d2 = 0.f;

  if (qi < n) {
    const float sx = q[3 * (size_t)qi], sy = q[3 * (size_t)qi + 1], sz = q[3 * (size_t)qi + 2];
    if constexpr (KC > 0) {
#pragma unroll
      for (int i = 0; i < KC / NS; ++i) {
        const size_t o = (size_t)(lo + i) * n + qi;
        visit(cx[o], cy[o], cz[o], sx, sy, sz, lo + i, best, kb, nan_d2);
      }
    } else {
      const int hi = min(K, lo + ks);
#pragma unroll 4
      for (int k = lo; k < hi; ++k) {
        const size_t o = (size_t)k * n + qi;
        visit(cx[o], cy[o], cz[o], sx, sy, sz, k, best, kb, nan_d2);
      }
    }
  }

  s_best[s][lane] = best;
  s_k[s][lane] = kb;
  s_nan[s][lane] = nan_d2;
  __syncthreads();
  if (s == 0 && qi < n) {
    float b = s_best[0][lane], nd = s_nan[0][lane];
    int kbm = s_k[0][lane];
#pragma unroll
    for (int t = 1; t < NS; ++t) {
      const float bt = s_best[t][lane];
      if (bt < b) {  // ascending slices, strict: the lowest k of the minimum
        b = bt;
        kbm = s_k[t][lane];
      }
      if (nd == nd) nd = s_nan[t][lane];  // the first NaN in k order
    }
    const bool nan = nd != nd;
    best_d2[qi] = nan ? nd : b;
    best_k[qi] = nan ? NO_ROW : kbm;
  }
}

}  // namespace

// cx, cy, cz: [K, n]; q: [n, 3]; best_d2: [n] f32; best_k: [n] int32.
// Returns the cudaError_t of the launch.
extern "C" int nn_argmin_launch(const float* cx, const float* cy,
                                const float* cz, const float* q, int K, int n,
                                float* best_d2, int* best_k,
                                cudaStream_t stream) {
  const int blocks = (n + BQ - 1) / BQ;
  if (K == 32)
    nn_argmin_kernel<32><<<blocks, NT, 0, stream>>>(cx, cy, cz, q, K, n, best_d2, best_k);
  else
    nn_argmin_kernel<0><<<blocks, NT, 0, stream>>>(cx, cy, cz, q, K, n, best_d2, best_k);
  return (int)cudaGetLastError();
}
