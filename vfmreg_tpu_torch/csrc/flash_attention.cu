// Non-causal multi-head attention with an online softmax, all in f32.
//
// Replaces: vfmreg_tpu/ops/flash_attention.py, flash_attention (Pallas, TPU).
//
// q, k, v, out: [B, T, H, HD] f32, contiguous. Per (b, h) and query row t:
//   out = softmax((q * scale) k^T) v, scale = 1 / sqrt(HD) rounded to f32 and
//   applied to q before the product, as the Pallas body does. Keys are
//   streamed in tiles of 64 with a running max m, a running sum l and an
//   accumulator, rescaled once per tile; key columns past T are masked to
//   -1e30, so they add exactly 0 to l and to the accumulator once the first
//   tile (which always holds key 0) has set m; out = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations. At the ViT-S/14 descriptor pass's
// shape (B = 1, T = 321, H = 6, HD = 64) a call does 4 B H T^2 HD = 158
// MFLOP (2.4 us at the 67 TFLOP/s f32 CUDA-core peak) and moves 4 x 0.49 MB
// (0.6 us at 3.35 TB/s). This first version runs on CUDA cores in f32 and
// is far from that bound: 6 query tiles x 6 heads = 36 blocks leave most of
// the 132 SMs idle at B = 1. Tensor cores (TF32 or bf16 mma / wgmma) are
// later work with their own agreement check.
//
// Design: one block per (query tile of 64 rows, b * H + h), 256 threads.
// Four neighbouring threads share a query row: thread j of the four owns
// the dims d = 4 i + j of q and of the accumulator (HD / 4 each, in
// registers), so the four read distinct shared-memory banks. Per key tile
// the block stages K and V (2 x 64 x HD f32, 32 KB at HD = 64) in shared
// memory with float4 loads; each thread forms its partial dot products for
// the 64 keys, two xor-shuffles complete them, and all four threads of a
// row then hold the same 64 scores, max, sum and rescale factor. Query rows
// past T are computed from zeros and not stored.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int TQ = NT / 4;  // query rows per block
constexpr int TK = 64;      // keys per tile
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int T, int H,
    float scale) {
  constexpr int DPT = HD / 4;  // dims per thread
  constexpr int V4 = HD / 4;   // float4 per row
  __shared__ float4 ks[TK * V4];
  __shared__ float4 vs[TK * V4];

  const int tid = threadIdx.x;
  const int lane4 = tid & 3;
  const int row = blockIdx.x * TQ + (tid >> 2);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row_stride = (size_t)H * HD;  // floats between tokens
  const size_t base = (size_t)b * T * row_stride + (size_t)h * HD;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < T ? q[base + (size_t)row * row_stride + 4 * i + lane4] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += TK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < TK * V4; e += NT) {
      const int kr = e / V4, c = e % V4;
      const int key = k0 + kr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < T) {
        const size_t o = base + (size_t)key * row_stride;
        kv = reinterpret_cast<const float4*>(k + o)[c];
        vv = reinterpret_cast<const float4*>(v + o)[c];
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();
    const float* kf = reinterpret_cast<const float*>(ks);
    const float* vf = reinterpret_cast<const float*>(vs);

    float s[TK];
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * kf[j * HD + 4 * i + lane4];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = (k0 + j < T) ? part : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += s[j] * vf[j * HD + 4 * i + lane4];
    }
    m = m_new;
  }

  if (row < T) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o = out + base + (size_t)row * row_stride;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[4 * i + lane4] = acc[i] * inv;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int T, int H, float scale, cudaStream_t stream) {
  const dim3 grid((T + TQ - 1) / TQ, B * H);
  flash_kernel<HD><<<grid, NT, 0, stream>>>(q, k, v, out, T, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, T, H, hd] f32 contiguous; hd in {32, 64} (64: every
// DINOv2 preset; 32: the reference test's shape).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for another hd).
extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, float* out, int B, int T,
                                      int H, int hd, float scale,
                                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, T, H, scale, stream);
    case 64: return launch<64>(q, k, v, out, B, T, H, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
