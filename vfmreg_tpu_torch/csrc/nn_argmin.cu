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
// that rounds once), the running minimum uses a strict '<' so the first
// minimum wins, and a NaN flag stands beside it, since '<' skips NaN.
//
// What bounds it on an H100: bytes. It reads 3 K n + 3 n floats and writes
// 2 n words (at K = 32, n = 16384: 6.5 MB, ~2 us at 3.35 TB/s) with ~8
// operations per champion. Design: one thread per query; the cache is
// [K, n] with queries contiguous, so each warp reads 32 consecutive floats
// of every row. No shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int NO_ROW = 1 << 30;

__global__ void __launch_bounds__(NT) nn_argmin_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ q, int K, int n,
    float* __restrict__ best_d2, int* __restrict__ best_k) {
  const int qi = blockIdx.x * NT + threadIdx.x;
  if (qi >= n) return;
  const float sx = q[3 * qi], sy = q[3 * qi + 1], sz = q[3 * qi + 2];
  float best = __int_as_float(0x7f800000);  // +inf
  int kb = 0;
  float nan_d2 = 0.f;
  bool nan = false;
  for (int k = 0; k < K; ++k) {
    const size_t o = (size_t)k * n + qi;
    const float dx = __fsub_rn(cx[o], sx);
    const float dy = __fsub_rn(cy[o], sy);
    const float dz = __fsub_rn(cz[o], sz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (d2 != d2 && !nan) {
      nan = true;
      nan_d2 = d2;
    }
    if (d2 < best) {  // strict: the first minimum wins
      best = d2;
      kb = k;
    }
  }
  best_d2[qi] = nan ? nan_d2 : best;
  best_k[qi] = nan ? NO_ROW : kb;
}

}  // namespace

// cx, cy, cz: [K, n]; q: [n, 3]; best_d2: [n] f32; best_k: [n] int32.
// Returns the cudaError_t of the launch.
extern "C" int nn_argmin_launch(const float* cx, const float* cy,
                                const float* cz, const float* q, int K, int n,
                                float* best_d2, int* best_k,
                                cudaStream_t stream) {
  nn_argmin_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(cx, cy, cz, q, K, n,
                                                         best_d2, best_k);
  return (int)cudaGetLastError();
}
