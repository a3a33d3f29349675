// A scan's point descriptors from its cameras' patch grids, first camera wins.
//
// Replaces: no TPU kernel. The reference assembles on the host (numpy over
// each camera's sampled rows, `np.unique` for the first camera, a scatter
// into a zeroed [N, D] array); the port decides the owner of each point on
// the host (O(N) integers a camera) and writes every row here, so the patch
// grids stay on the card and the scan's descriptors leave it in one copy.
//
// Per row i of out [N, D] f32: owner[i] < 0 gives zeros; otherwise the
// bilinear sample of grid c = owner[i] ([h_c, w_c, D] f32) at the pixel
// (u[i], v[i]) of that camera's image (H_c x W_c), with torch's
// align_corners=False map, edge-clamped: `ops/projection.sample_patch_features`.
//
// The contract is bit-identity with `assemble_descriptors_plain`: the same
// f32 operations in the same order, written with non-contracting intrinsics
// (nvcc would otherwise fuse a multiply and an add into an FMA that rounds
// once): y = clamp((v + 0.5) * sy - 0.5, 0, h - 1) with sy = h / H rounded to
// f32 on the host, as torch rounds a Python scalar; y0 = floor(y), y1 =
// min(y0 + 1, h - 1), wy = y - y0; the same for x; then
// ((g00 (1 - wy)) (1 - wx) + (g01 (1 - wy)) wx) + (g10 wy) (1 - wx)) + (g11 wy) wx
// summed left to right.
//
// What bounds it on an H100: bytes. It writes N D floats (16,384 x 1536:
// 100.7 MB, 30 us at 3.35 TB/s into device memory) and reads the grids (5
// of 16 x 20 x 1536: 9.8 MB, which stay in the 50 MB L2 while four rows a
// sample are read) and 3 N ints. Written into pinned host memory, the bus
// bounds it instead (~2 ms at PCIe 5's ~50 GB/s), as a copy of the block
// would. Design: one warp a row; the owner, u and v are one broadcast
// load each; lanes walk the row's D floats as float4 where D % 4 == 0 and
// every pointer is 16-byte aligned (else as floats), four grid loads and
// one store per step. A block counts its sampled rows and adds them to a
// device counter with one atomic. No memset: zero rows are written here.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_CAMERAS = 8;
constexpr int WARPS = 8;  // rows a block
constexpr int THREADS = 32 * WARPS;

struct Grids {
  const float* ptr[MAX_CAMERAS];
  int h[MAX_CAMERAS];
  int w[MAX_CAMERAS];
  float sy[MAX_CAMERAS];  // h / H, rounded to f32
  float sx[MAX_CAMERAS];  // w / W
};

__device__ __forceinline__ float lerp4(float g00, float g01, float g10, float g11,
                                       float wy, float wx, float wy1, float wx1) {
  const float t0 = __fmul_rn(__fmul_rn(g00, wy1), wx1);
  const float t1 = __fmul_rn(__fmul_rn(g01, wy1), wx);
  const float t2 = __fmul_rn(__fmul_rn(g10, wy), wx1);
  const float t3 = __fmul_rn(__fmul_rn(g11, wy), wx);
  return __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
assemble_kernel(Grids grids, const int* __restrict__ owner, const int* __restrict__ us,
                const int* __restrict__ vs, int n, int d, float* __restrict__ out,
                unsigned long long* __restrict__ sampled) {
  __shared__ int block_sampled;
  if (threadIdx.x == 0) block_sampled = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row < n) {
    const int cam = owner[row];
    float* dst = out + row * d;
    if (cam < 0) {
      if (VEC) {
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int j = lane; j < d / 4; j += 32) dst4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int j = lane; j < d; j += 32) dst[j] = 0.f;
      }
    } else {
      if (lane == 0) atomicAdd(&block_sampled, 1);
      const int h = grids.h[cam], w = grids.w[cam];
      float y = __fsub_rn(__fmul_rn(__fadd_rn((float)vs[row], 0.5f), grids.sy[cam]), 0.5f);
      float x = __fsub_rn(__fmul_rn(__fadd_rn((float)us[row], 0.5f), grids.sx[cam]), 0.5f);
      y = fminf(fmaxf(y, 0.f), (float)(h - 1));
      x = fminf(fmaxf(x, 0.f), (float)(w - 1));
      const int y0 = (int)floorf(y), x0 = (int)floorf(x);
      const int y1 = min(y0 + 1, h - 1), x1 = min(x0 + 1, w - 1);
      const float wy = __fsub_rn(y, (float)y0), wx = __fsub_rn(x, (float)x0);
      const float wy1 = __fsub_rn(1.f, wy), wx1 = __fsub_rn(1.f, wx);
      const float* g = grids.ptr[cam];
      const float* p00 = g + ((long long)y0 * w + x0) * d;
      const float* p01 = g + ((long long)y0 * w + x1) * d;
      const float* p10 = g + ((long long)y1 * w + x0) * d;
      const float* p11 = g + ((long long)y1 * w + x1) * d;
      if (VEC) {
        const float4* a4 = reinterpret_cast<const float4*>(p00);
        const float4* b4 = reinterpret_cast<const float4*>(p01);
        const float4* c4 = reinterpret_cast<const float4*>(p10);
        const float4* e4 = reinterpret_cast<const float4*>(p11);
        float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
        for (int j = lane; j < d / 4; j += 32) {
          const float4 a = __ldg(a4 + j), b = __ldg(b4 + j), c = __ldg(c4 + j), e = __ldg(e4 + j);
          dst4[j] = make_float4(lerp4(a.x, b.x, c.x, e.x, wy, wx, wy1, wx1),
                                lerp4(a.y, b.y, c.y, e.y, wy, wx, wy1, wx1),
                                lerp4(a.z, b.z, c.z, e.z, wy, wx, wy1, wx1),
                                lerp4(a.w, b.w, c.w, e.w, wy, wx, wy1, wx1));
        }
      } else {
        for (int j = lane; j < d; j += 32)
          dst[j] = lerp4(__ldg(p00 + j), __ldg(p01 + j), __ldg(p10 + j), __ldg(p11 + j), wy, wx, wy1, wx1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_sampled) atomicAdd(sampled, (unsigned long long)block_sampled);
}

}  // namespace

// grid_ptrs, grid_hw ([h, w] a camera), scale_yx ([sy, sx] a camera): host
// arrays of `cameras` entries. `out`: device memory, or pinned host memory
// where `out_on_host` is set. Returns the cudaError_t of the launch.
extern "C" int assemble_descriptors_launch(const void* const* grid_ptrs, const int* grid_hw,
                                           const float* scale_yx, int cameras, const int* owner,
                                           const int* us, const int* vs, int n, int d, float* out,
                                           int out_on_host, unsigned long long* sampled,
                                           cudaStream_t stream) {
  if (cameras < 1 || cameras > MAX_CAMERAS || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (out_on_host) {
    // Pinned host memory, written through its device mapping (the same
    // address under unified addressing).
    void* mapped = nullptr;
    const cudaError_t err = cudaHostGetDevicePointer(&mapped, out, 0);
    if (err != cudaSuccess) return (int)err;
    out = static_cast<float*>(mapped);
  }
  Grids grids;
  bool aligned = d % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  for (int c = 0; c < cameras; ++c) {
    grids.ptr[c] = static_cast<const float*>(grid_ptrs[c]);
    grids.h[c] = grid_hw[2 * c];
    grids.w[c] = grid_hw[2 * c + 1];
    grids.sy[c] = scale_yx[2 * c];
    grids.sx[c] = scale_yx[2 * c + 1];
    aligned = aligned && reinterpret_cast<size_t>(grid_ptrs[c]) % 16 == 0;
  }
  for (int c = cameras; c < MAX_CAMERAS; ++c) {
    grids.ptr[c] = nullptr;
    grids.h[c] = grids.w[c] = 1;
    grids.sy[c] = grids.sx[c] = 0.f;
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  if (aligned)
    assemble_kernel<true><<<blocks, THREADS, 0, stream>>>(grids, owner, us, vs, n, d, out, sampled);
  else
    assemble_kernel<false><<<blocks, THREADS, 0, stream>>>(grids, owner, us, vs, n, d, out, sampled);
  return (int)cudaGetLastError();
}
