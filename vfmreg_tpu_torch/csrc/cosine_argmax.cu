// Masked inner-product arg-max of pre-normalized queries against a database,
// without materializing the [N, M] similarity matrix.
//
// Replaces: vfmreg_tpu/ops/cosine_kernel.py, cosine_argmax (Pallas, TPU).
//
// Contract (the Pallas kernel's): masked database rows score -1e30; ties go
// to the lowest database index; a query whose every row is masked gets
// (-1e30, 0); the index is clamped to M-1.
//
// What bounds it on an H100: operations. The products run on the tensor
// cores in 3xTF32 (below), three TF32 products per f32 product, so at the
// scan-to-map shape (N = 4,096 queries, M = 524,288 rows, D = 384) the work
// is 3 x 2 N M D = 4.95 TFLOP: 10.0 ms at the SXM card's dense TF32 peak of
// 495 TFLOP/s, and 40.0 ms at the driver's N = 16,384. Bytes: the database
// (805 MB) comes from HBM once, 0.24 ms at 3.35 TB/s, and from L2 once per
// 128-query tile after that.
//
// 3xTF32: every operand x is split in registers into big(x) =
// cvt.rna.tf32.f32(x) and small(x) = cvt.rna.tf32.f32(x - big(x)), and
// a.b is summed as small(a).big(b) + big(a).small(b) + big(a).big(b), the
// small terms first, each an mma.sync m16n8k8 .tf32 with f32 accumulation.
// That keeps about 21 bits of each operand where one TF32 pass keeps 10.
//
// Design: a block of 8 warps owns 128 queries and sweeps a contiguous range
// of 128-row database tiles (a "split" of M). Each warp computes a 64-query
// x 32-row part of the 128 x 128 similarity tile. Both operands are K-major
// as they lie in memory; 32-deep slices of both are staged with 16-byte
// cp.async copies in a 3-stage ring in shared memory (rows padded to 36
// floats, so the fragment loads hit 32 distinct banks), so the copies of the
// next two slices overlap the products of this one. 110.6 KB of shared
// memory and 126 registers a thread let two blocks (16 warps) share an SM;
// on the card this beat 16-deep slices in a 4-stage ring at one block per
// SM, and a pass that splits each stage once in shared memory (sparing the
// warps' repeated cvt) was slower than both. The k loop runs in
// ascending order for every tile, so each similarity is summed in the same
// order however M is split and wherever its row sits in a tile.
// After each database tile, every thread takes the masked first arg-max over
// its columns (ascending within a thread, strict '>'), the four lanes that
// share a query row merge theirs by (value, lower index), and the result is
// folded into a running (max, argmax) per row in registers (tiles ascend, so
// a strict '>' keeps the lowest index); no similarity leaves the SM. At the
// end the four warps that share a query row merge by (value, lower index).
// On the GPU blocks run in no order, so each split writes its partial result
// and a second kernel merges the splits in ascending order with a strict '>',
// which keeps the lowest-index tie-break and makes the result independent of
// the number of splits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;     // queries per block
constexpr int BM = 128;     // database rows per tile
constexpr int BK = 32;      // depth of one shared-memory stage
constexpr int SA = BK + 4;  // padded row stride of a stage, in floats
constexpr int STAGES = 3;
constexpr int NT = 256;     // 8 warps: 2 along the queries x 4 along the rows
constexpr int WQ = 64;      // queries per warp
constexpr int WM = 32;      // database rows per warp
constexpr int MF = WQ / 16; // m16 fragments per warp
constexpr int NF = WM / 8;  // n8 fragments per warp
constexpr float NEG = -1e30f;
constexpr int STAGE_FLOATS = (BQ + BM) * SA;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

// Take (ov, oi) if it is larger, or equal with a lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both rounded to TF32 (to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, zero-filled where `ok` is false (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Stage one BK-deep slice of `rows` rows starting at row r0 of x [nrows, d]
// into s [rows][SA]: 16-byte copies when every row is 16-byte aligned
// (vec), four 4-byte copies otherwise. Rows past nrows and columns past d
// are zero.
template <int ROWS>
__device__ __forceinline__ void load_slice(float* s, const float* __restrict__ x, int r0,
                                           int nrows, int k0, int d, bool vec, int tid) {
#pragma unroll
  for (int u = 0; u < ROWS * BK / 4 / NT; ++u) {
    const int e = tid + u * NT;
    const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
    const int row = r0 + r, col = k0 + c;
    const bool row_ok = row < nrows;
    float* dst = s + r * SA + c;
    if (vec) {
      const bool ok = row_ok && col < d;
      cp_async16(dst, ok ? x + (size_t)row * d + col : x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && col + j < d;
        cp_async4(dst + j, ok ? x + (size_t)row * d + col + j : x, ok);
      }
    }
  }
}

__global__ void __launch_bounds__(NT) cosine_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const uint8_t* __restrict__ mask, float* __restrict__ part_sim,
    int* __restrict__ part_idx, int n, int m, int d, int tiles_per_split, int vec) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  const int wq = warp & 1, wm = warp >> 1;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int m_tiles = (m + BM - 1) / BM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, m_tiles);
  const int k_slices = (d + BK - 1) / BK;
  const int total = (t_end - t_begin) * k_slices;  // stages this block consumes

  auto load_stage = [&](int s) {
    float* st = smem + (s % STAGES) * STAGE_FLOATS;
    const int tile = t_begin + s / k_slices;
    const int k0 = (s % k_slices) * BK;
    load_slice<BQ>(st, q, q0, n, k0, d, vec, tid);
    load_slice<BM>(st + BQ * SA, db, tile * BM, m, k0, d, vec, tid);
  };

  // Running (max, argmax) of the rows this thread's fragments hold:
  // [mi][h] is query row wq*64 + mi*16 + g + 8h.
  float run_v[MF][2];
  int run_i[MF][2];
  float acc[MF][NF][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    run_v[mi][0] = run_v[mi][1] = NEG;
    run_i[mi][0] = run_i[mi][1] = 0;
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s);
    asm volatile("cp.async.commit_group;");
  }

  for (int s = 0; s < total; ++s) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2));
    __syncthreads();  // stage s has landed for every thread; stage s-1 is no longer read
    if (s + STAGES - 1 < total) load_stage(s + STAGES - 1);
    asm volatile("cp.async.commit_group;");

    const float* As = smem + (s % STAGES) * STAGE_FLOATS + (wq * WQ) * SA;
    const float* Bs = smem + (s % STAGES) * STAGE_FLOATS + (BQ + wm * WM) * SA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bb[NF][2], bs[NF][2];
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) {
        const float* p = Bs + (ni * 8 + g) * SA + kk + t;
        split_tf32(p[0], bb[ni][0], bs[ni][0]);
        split_tf32(p[4], bb[ni][1], bs[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        const float* p = As + (mi * 16 + g) * SA + kk + t;
        uint32_t ab[4], as[4];
        split_tf32(p[0], ab[0], as[0]);
        split_tf32(p[8 * SA], ab[1], as[1]);
        split_tf32(p[4], ab[2], as[2]);
        split_tf32(p[8 * SA + 4], ab[3], as[3]);
#pragma unroll
        for (int ni = 0; ni < NF; ++ni) {
          mma_tf32(acc[mi][ni], as, bb[ni]);
          mma_tf32(acc[mi][ni], ab, bs[ni]);
          mma_tf32(acc[mi][ni], ab, bb[ni]);
        }
      }
    }

    if (s % k_slices == k_slices - 1) {
      // Epilogue of a database tile. This thread holds columns
      // c0 + ni*8 + 2t + j, ascending in (ni, j).
      const int c0 = (t_begin + s / k_slices) * BM + wm * WM;
      bool ok[NF][2];
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + ni * 8 + 2 * t + j;
          ok[ni][j] = c < m && mask[c] != 0;
        }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = NEG;
          int idx = 0x7fffffff;
#pragma unroll
          for (int ni = 0; ni < NF; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float x = acc[mi][ni][2 * h + j];
              if (ok[ni][j] && x > v) {
                v = x;
                idx = c0 + ni * 8 + 2 * t + j;
              }
            }
          // The four lanes of a row hold interleaved columns: merge by
          // (value, lower index).
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
            take_better(v, idx, ov, oi);
          }
          if (v > run_v[mi][h]) {
            run_v[mi][h] = v;
            run_i[mi][h] = idx;
          }
        }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }

  // Merge the four warps that share each query row, in a fixed order.
  asm volatile("cp.async.wait_all;");
  __syncthreads();
  float* red_v = smem;                                    // [4][BQ]
  int* red_i = reinterpret_cast<int*>(smem + 4 * BQ);     // [4][BQ]
  if (t == 0) {
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wq * WQ + mi * 16 + g + 8 * h;
        red_v[wm * BQ + r] = run_v[mi][h];
        red_i[wm * BQ + r] = run_i[mi][h];
      }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < n) {
    float v = red_v[tid];
    int idx = red_i[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) take_better(v, idx, red_v[w * BQ + tid], red_i[w * BQ + tid]);
    part_sim[(size_t)split * n + q0 + tid] = v;
    part_idx[(size_t)split * n + q0 + tid] = idx;
  }
}

__global__ void cosine_merge_kernel(const float* __restrict__ part_sim,
                                    const int* __restrict__ part_idx,
                                    float* __restrict__ out_sim,
                                    int* __restrict__ out_idx, int n, int m,
                                    int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n) return;
  float v = NEG;
  int idx = 0;
  for (int s = 0; s < splits; ++s) {
    const float ov = part_sim[(size_t)s * n + qi];
    if (ov > v) {
      v = ov;
      idx = part_idx[(size_t)s * n + qi];
    }
  }
  out_sim[qi] = v;
  out_idx[qi] = min(idx, m - 1);
}

}  // namespace

// part_sim / part_idx: [splits, n] scratch; splits = ceil(ceil(m/128) / tiles_per_split).
// Returns the cudaError_t of the launches.
extern "C" int cosine_argmax_launch(const float* q, const float* db,
                                    const uint8_t* mask, float* part_sim,
                                    int* part_idx, float* out_sim, int* out_idx,
                                    int n, int m, int d, int tiles_per_split,
                                    cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      cosine_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int m_tiles = (m + BM - 1) / BM;
  const int splits = (m_tiles + tiles_per_split - 1) / tiles_per_split;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)db % 16 == 0;
  const dim3 grid((n + BQ - 1) / BQ, splits);
  cosine_partial_kernel<<<grid, NT, SMEM_BYTES, stream>>>(q, db, mask, part_sim, part_idx,
                                                          n, m, d, tiles_per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cosine_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part_sim, part_idx, out_sim, out_idx, n, m, splits);
  return (int)cudaGetLastError();
}
