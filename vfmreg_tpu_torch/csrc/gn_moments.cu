// One fused Gauss-Newton pass over the transposed champion cache.
//
// Replaces: vfmreg_tpu/ops/gn_kernel.py, gn_moments_from_cache (Pallas, TPU).
//
// Per query: nearest of its K cached champions (lowest k on ties), the
// `best < max_d2` acceptance gate (the 2e19 sentinel squares to +inf and
// never passes), the Geman-McClure weight k^2 / (k + d^2)^2, and 17 moments
// (count, sum w, sum w s_c, sum w s_c s_c^T (6), sum w r, sum w s_c x r)
// summed over all queries; `assemble_gn_system` turns them into the 6x6
// system. Rejected lanes are zeroed by selection, never by multiplication,
// so sentinel or NaN lanes cannot poison the sums.
//
// What bounds it on an H100: bytes and latency. At N = 16384 queries and
// K = 32 it reads ~6.5 MB once (about 2 us at 3.35 TB/s) and does ~4 MFLOP,
// so a call is dominated by launch latency and the two-stage reduction.
//
// Design: one thread per query streams its K champions (coalesced: the cache
// is [K, N], queries contiguous), computes its 17 terms in registers, and a
// fixed-shape shared-memory tree sums them per block into [blocks, 17]
// partials. The TPU kernel accumulated across a sequential grid; on the GPU
// blocks run in no order, so a second single-block kernel sums the partials
// in ascending block order. No atomics: the order of every sum is fixed, so
// the result is the same from run to run, which the ICP's |dx| < 1e-4
// termination test depends on. The squared distances use non-contracting
// intrinsics (no FMA), so the champion choice and the gate agree bit for bit
// with the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int NPART = 17;

__global__ void __launch_bounds__(NT) gn_partial_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ src, float c0,
    float c1, float c2, float kern, float max_d2, int K, int n,
    float* __restrict__ partials) {
  __shared__ float sh[NPART][NT];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * NT + tid;

  float p[NPART];
#pragma unroll
  for (int j = 0; j < NPART; ++j) p[j] = 0.f;

  if (qi < n) {
    const float sx = src[3 * qi], sy = src[3 * qi + 1], sz = src[3 * qi + 2];
    float best = __int_as_float(0x7f800000);  // +inf
    int kb = 0;
    for (int k = 0; k < K; ++k) {
      const size_t o = (size_t)k * n + qi;
      const float dx = __fsub_rn(cx[o], sx);
      const float dy = __fsub_rn(cy[o], sy);
      const float dz = __fsub_rn(cz[o], sz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < best) {  // strict: the first minimum wins
        best = d2;
        kb = k;
      }
    }
    const size_t ob = (size_t)kb * n + qi;
    const bool acc = best < max_d2;
    if (acc) {
      const float den = kern + best;
      const float w = (kern * kern) / (den * den);
      const float rx = sx - cx[ob], ry = sy - cy[ob], rz = sz - cz[ob];
      const float px = sx - c0, py = sy - c1, pz = sz - c2;
      p[0] = 1.f;
      p[1] = w;
      p[2] = w * px;
      p[3] = w * py;
      p[4] = w * pz;
      p[5] = w * px * px;
      p[6] = w * py * py;
      p[7] = w * pz * pz;
      p[8] = w * px * py;
      p[9] = w * px * pz;
      p[10] = w * py * pz;
      p[11] = w * rx;
      p[12] = w * ry;
      p[13] = w * rz;
      p[14] = w * (py * rz - pz * ry);
      p[15] = w * (pz * rx - px * rz);
      p[16] = w * (px * ry - py * rx);
    }
  }

#pragma unroll
  for (int j = 0; j < NPART; ++j) sh[j][tid] = p[j];
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int j = 0; j < NPART; ++j) sh[j][tid] += sh[j][tid + s];
    }
    __syncthreads();
  }
  if (tid < NPART) partials[(size_t)blockIdx.x * NPART + tid] = sh[tid][0];
}

__global__ void gn_reduce_kernel(const float* __restrict__ partials, int blocks,
                                 float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= NPART) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * NPART + j];
  out[j] = s;
}

}  // namespace

// cx, cy, cz: [K, n]; src: [n, 3]; partials: [ceil(n/256), 17] scratch;
// out: [17]. Returns the cudaError_t of the launches.
extern "C" int gn_moments_launch(const float* cx, const float* cy,
                                 const float* cz, const float* src, float c0,
                                 float c1, float c2, float kern, float max_d2,
                                 int K, int n, float* partials, float* out,
                                 cudaStream_t stream) {
  const int blocks = (n + NT - 1) / NT;
  gn_partial_kernel<<<blocks, NT, 0, stream>>>(cx, cy, cz, src, c0, c1, c2, kern,
                                               max_d2, K, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_reduce_kernel<<<1, 32, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
