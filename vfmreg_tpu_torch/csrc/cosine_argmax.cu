// Masked inner-product arg-max of pre-normalized queries against a database,
// without materializing the [N, M] similarity matrix.
//
// Replaces: vfmreg_tpu/ops/cosine_kernel.py, cosine_argmax (Pallas, TPU).
//
// Contract (the Pallas kernel's): masked database rows score -1e30; ties go
// to the lowest database index; a query whose every row is masked gets
// (-1e30, 0); the index is clamped to M-1.
//
// What bounds it on an H100: operations. At the scan-to-map shape
// (N = 4096 queries, M = 524288 rows, D = 384) the work is 2*N*M*D = 1.65
// TFLOP against 805 MB of database, so even at the f32 CUDA-core peak
// (67 TFLOP/s) the card needs ~25 ms while reading the database once takes
// ~0.24 ms.
//
// Design: an f32 register-tiled product on CUDA cores with the arg-max fused
// into its epilogue. A block owns 128 queries and sweeps a contiguous range
// of 128-row database tiles (a "split" of M); each thread accumulates an
// 8 x 8 tile in registers, staging 8-deep slices of both operands in shared
// memory. After each database tile, the block folds the tile's masked
// (max, argmax) into a running (max, argmax) per query held in registers,
// so no similarity leaves the SM. The TPU kernel instead carried the running
// result across a sequential grid; on the GPU blocks run in no order, so each
// split writes its partial result and a second kernel merges the splits in
// ascending order with a strict '>', which keeps the lowest-index tie-break.
// Splitting M gives the card enough blocks (N = 4096 alone is 32 query
// tiles for 132 SMs). Each similarity is one thread's FMA chain in ascending
// k, so the result does not depend on the number of splits.
// Tensor cores (TF32/bf16 via wgmma) and TMA pipelining are later work; each
// will need its own arg-max agreement check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // queries per block
constexpr int BM = 128;  // database rows per tile
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int TQ = 8;    // queries per thread
constexpr int TM = 8;    // database rows per thread
constexpr int NT = 256;  // (BQ / TQ) * (BM / TM)
constexpr float NEG = -1e30f;

// Thread-tile element e of lane-group g: elements 0..3 sit at 4g..4g+3,
// elements 4..7 at 64+4g..64+4g+3, so a quarter-warp's float4 reads of a
// shared-memory row are contiguous (no bank conflicts). Ascending in e.
__device__ __forceinline__ int tile_pos(int g, int e) {
  return (e < 4) ? 4 * g + e : 64 + 4 * g + (e - 4);
}

// Take (ov, oi) if it is larger, or equal with a lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(NT) cosine_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const uint8_t* __restrict__ mask, float* __restrict__ part_sim,
    int* __restrict__ part_idx, int n, int m, int d, int tiles_per_split) {
  __shared__ __align__(16) float As[BK][BQ];
  __shared__ __align__(16) float Bs[BK][BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // database lane group
  const int ty = tid / 16;  // query lane group
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int m_tiles = (m + BM - 1) / BM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, m_tiles);

  // Loader: each thread copies 4 consecutive k of one row of each operand.
  const int lr = tid / 2;
  const int lk = (tid % 2) * 4;
  const int qa = q0 + lr;

  float run_v[TQ];
  int run_i[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    run_v[i] = NEG;
    run_i[i] = 0;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * BM;
    const int mb = m0 + lr;
    float acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + lk + u;
        As[lk + u][lr] = (qa < n && k < d) ? q[(size_t)qa * d + k] : 0.f;
        Bs[lk + u][lr] = (mb < m && k < d) ? db[(size_t)mb * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
        const float a[TQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: masked first arg-max over the tile's columns.
    bool ok[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = m0 + tile_pos(tx, j);
      ok[j] = c < m && mask[c] != 0;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float v = NEG;
      int idx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float s = ok[j] ? acc[i][j] : NEG;
        if (s > v) {
          v = s;
          idx = m0 + tile_pos(tx, j);
        }
      }
      // The 16 lanes sharing these queries are one half of a warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        take_better(v, idx, ov, oi);
      }
      // Tiles arrive in ascending order: strict '>' keeps the lowest index.
      if (v > run_v[i]) {
        run_v[i] = v;
        run_i[i] = idx;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = q0 + tile_pos(ty, i);
      if (qi < n) {
        part_sim[(size_t)split * n + qi] = run_v[i];
        part_idx[(size_t)split * n + qi] = run_i[i];
      }
    }
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
  const int m_tiles = (m + BM - 1) / BM;
  const int splits = (m_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid((n + BQ - 1) / BQ, splits);
  cosine_partial_kernel<<<grid, NT, 0, stream>>>(q, db, mask, part_sim, part_idx,
                                                 n, m, d, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cosine_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part_sim, part_idx, out_sim, out_idx, n, m, splits);
  return (int)cudaGetLastError();
}
