// Non-causal multi-head attention with an online softmax.
//
// Replaces: vfmreg_tpu/ops/flash_attention.py, flash_attention (Pallas, TPU).
//
// q, k, v, out: [B, T, H, HD] f32, contiguous. Per (b, h) and query row t:
//   out = softmax((q * scale) k^T) v, scale = 1 / sqrt(HD) rounded to f32 and
//   applied to q in f32 before the product, as the Pallas body does. Keys are
//   streamed in tiles of 32 with a running max m, a running sum l and an
//   accumulator, rescaled once per tile; key columns past T are masked to
//   -1e30 before the tile's max, so they add exactly 0 to l and to the
//   accumulator once m has been set from a tile that holds a real key;
//   out = acc / max(l, 1e-30).
//
// What bounds it on an H100: launch latency in practice, operations in
// principle. Both products run on the tensor cores in 3xTF32 (below), three
// TF32 products per f32 product: at the ViT-S/14 descriptor pass's shape
// (B = 1, T = 321, H = 6, HD = 64) a call does 3 x 4 B H T^2 HD = 3 x 158
// MFLOP, 0.96 us at the SXM card's dense TF32 peak of 495 TFLOP/s, and moves
// 4 x 0.49 MB (0.6 us at 3.35 TB/s); a launch alone costs a few us.
//
// 3xTF32: every operand x is split in registers into big(x) =
// cvt.rna.tf32.f32(x) and small(x) = cvt.rna.tf32.f32(x - big(x)), and
// a.b is summed as small(a).big(b) + big(a).small(b) + big(a).big(b), the
// small terms first, each an mma.sync m16n8k8 .tf32 with f32 accumulation:
// q once per block, K and V per tile, P after the exp.
//
// Design: one block of four warps per (16-query tile, b * H + h), so B = 1
// already gives 21 x 6 = 126 blocks for the card's 132 SMs. Warp w takes key
// tiles w, w + 4, w + 8, ... of the head and keeps its own (m, l, acc) for
// the 16 rows; each warp stages its K and V tiles with 16-byte cp.async
// copies into its own two-stage ring in shared memory (rows padded to HD + 4
// floats, so the fragment loads hit 32 distinct banks), so the next tile's
// copy overlaps this tile's products. S = (q scale) K^T comes out of the mma
// in the accumulator layout (row g, keys 2t and 2t + 1); P is fed back as
// the A operand of P V with the keys of each 8-key step taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7), and V's rows are read in the same order, so P
// needs no shuffle. The running max, sum and rescale stay in f32 registers,
// per accumulator row. At the end the four warps' (m, l, acc) are merged in
// shared memory in warp order 0..3, so a rerun gives the same bits. A warp
// whose first key tile is past T keeps m = -1e30, l = 0 and adds exactly 0.
// Query rows past T are computed from zeros and not stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int TQ = 16;  // query rows per block
constexpr int TK = 32;  // keys per tile
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Layout {
  static constexpr int S = HD + 4;                   // padded row stride, floats
  static constexpr int TILE = TK * S;                // one K or V tile
  static constexpr int WARP_FLOATS = 2 * 2 * TILE;   // two stages of K and V
  static constexpr int BYTES = WARPS * WARP_FLOATS * 4;
  static_assert(2 * TQ + TQ * HD <= WARP_FLOATS, "the merge area fits in a warp's ring");
};

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

// acc += a.b in 3xTF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab, const uint32_t* as,
                                           const uint32_t* bb, const uint32_t* bs) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// 16 bytes, zero-filled where `ok` is false (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int T, int H,
    float scale) {
  using L = Layout<HD>;
  constexpr int KS = HD / 8;  // k8 steps of S = q K^T; n8 fragments of P V
  constexpr int NS = TK / 8;  // n8 fragments of S; k8 steps of P V
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row_stride = (size_t)H * HD;  // floats between tokens
  const size_t base = (size_t)b * T * row_stride + (size_t)h * HD;
  float* ring = smem + warp * L::WARP_FLOATS;

  // Copy key tile j (keys 32j..32j+31; past T zero) into stage st.
  auto load_tile = [&](int j, int st) {
    float* ks = ring + st * 2 * L::TILE;
    float* vs = ks + L::TILE;
    constexpr int CHUNKS = TK * HD / 4;
#pragma unroll
    for (int e = lane; e < CHUNKS; e += 32) {
      const int kr = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const int key = j * TK + kr;
      const bool ok = key < T;
      const size_t o = ok ? base + (size_t)key * row_stride + c : 0;
      cp_async16(ks + kr * L::S + c, k + o, ok);
      cp_async16(vs + kr * L::S + c, v + o, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const int n_tiles = (T + TK - 1) / TK;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;
  if (mine > 0) load_tile(warp, 0);

  // q fragments (rows q0 + g and q0 + g + 8), scaled in f32, then split.
  uint32_t qb[KS][4], qs[KS][4];
  {
    const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d0 = kk * 8 + t;
      const float a0 = r0 < T ? q[base + (size_t)r0 * row_stride + d0] * scale : 0.f;
      const float a1 = r1 < T ? q[base + (size_t)r1 * row_stride + d0] * scale : 0.f;
      const float a2 = r0 < T ? q[base + (size_t)r0 * row_stride + d0 + 4] * scale : 0.f;
      const float a3 = r1 < T ? q[base + (size_t)r1 * row_stride + d0 + 4] * scale : 0.f;
      split_tf32(a0, qb[kk][0], qs[kk][0]);
      split_tf32(a1, qb[kk][1], qs[kk][1]);
      split_tf32(a2, qb[kk][2], qs[kk][2]);
      split_tf32(a3, qb[kk][3], qs[kk][3]);
    }
  }

  // [dn][e]: rows g (e = 0, 1) and g + 8 (e = 2, 3), dims dn*8 + 2t + (e & 1).
  float acc[KS][4];
#pragma unroll
  for (int dn = 0; dn < KS; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's columns only

  for (int i = 0; i < mine; ++i) {
    const int j = warp + i * WARPS;
    if (i + 1 < mine) {
      load_tile(j + WARPS, (i + 1) & 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();
    const float* ks = ring + (i & 1) * 2 * L::TILE;
    const float* vs = ks + L::TILE;

    // S = (q scale) K^T: [nf][e] is row g + 8(e >> 1), key 8nf + 2t + (e & 1).
    float s[NS][4];
#pragma unroll
    for (int nf = 0; nf < NS; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float* p = ks + (nf * 8 + g) * L::S + kk * 8 + t;
        uint32_t bb[2], bs[2];
        split_tf32(p[0], bb[0], bs[0]);
        split_tf32(p[4], bb[1], bs[1]);
        mma_3xtf32(s[nf], qb[kk], qs[kk], bb, bs);
      }
    }

    // Online softmax, per accumulator row.
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cur = NEG_INF;
#pragma unroll
      for (int nf = 0; nf < NS; ++nf)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = j * TK + nf * 8 + 2 * t + c;
          if (key >= T) s[nf][2 * r + c] = NEG_INF;
          cur = fmaxf(cur, s[nf][2 * r + c]);
        }
      cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 1));
      cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 2));
      m_new[r] = fmaxf(m[r], cur);
      alpha[r] = expf(m[r] - m_new[r]);
      float psum = 0.f;
#pragma unroll
      for (int nf = 0; nf < NS; ++nf)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[nf][2 * r + c] - m_new[r]);
          s[nf][2 * r + c] = p;
          psum += p;
        }
      l[r] = l[r] * alpha[r] + psum;
      m[r] = m_new[r];
    }
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // acc += P V. A operand of k8 step ks = keys 8ks + (0, 2, 4, 6, 1, 3, 5, 7):
    // column t is key 2t, column t + 4 is key 2t + 1, straight from S's layout.
#pragma unroll
    for (int kq = 0; kq < NS; ++kq) {
      uint32_t pb[4], ps[4];
      split_tf32(s[kq][0], pb[0], ps[0]);  // row g,     key 2t
      split_tf32(s[kq][2], pb[1], ps[1]);  // row g + 8, key 2t
      split_tf32(s[kq][1], pb[2], ps[2]);  // row g,     key 2t + 1
      split_tf32(s[kq][3], pb[3], ps[3]);  // row g + 8, key 2t + 1
      const float* p = vs + (kq * 8 + 2 * t) * L::S + g;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t bb[2], bs[2];
        split_tf32(p[dn * 8], bb[0], bs[0]);          // key 2t,     dim 8dn + g
        split_tf32(p[L::S + dn * 8], bb[1], bs[1]);   // key 2t + 1, dim 8dn + g
        mma_3xtf32(acc[dn], pb, ps, bb, bs);
      }
    }
    __syncwarp();  // this stage is read before the next-but-one copy lands in it
  }

  // Merge the four warps' (m, l, acc) in warp order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp is done with its ring
  float* wm = ring;           // [TQ]
  float* wl = ring + TQ;      // [TQ]
  float* wacc = ring + 2 * TQ;  // [TQ][HD]
  if (t == 0) {
    wm[g] = m[0];
    wm[g + 8] = m[1];
    wl[g] = l[0];
    wl[g + 8] = l[1];
  }
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
    const int d = dn * 8 + 2 * t;
    wacc[g * HD + d] = acc[dn][0];
    wacc[g * HD + d + 1] = acc[dn][1];
    wacc[(g + 8) * HD + d] = acc[dn][2];
    wacc[(g + 8) * HD + d + 1] = acc[dn][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    if (q0 + r >= T) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, smem[w * L::WARP_FLOATS + r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* wr = smem + w * L::WARP_FLOATS;
      const float f = expf(wr[r] - mx);
      lsum += f * wr[TQ + r];
      o += f * wr[2 * TQ + r * HD + d];
    }
    out[base + (size_t)(q0 + r) * row_stride + d] = o / fmaxf(lsum, 1e-30f);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int T, int H, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + TQ - 1) / TQ, B * H);
  flash_kernel<HD><<<grid, NT, Layout<HD>::BYTES, stream>>>(q, k, v, out, T, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, T, H, hd] f32 contiguous, 16-byte aligned; hd in
// {32, 64} (64: every DINOv2 preset; 32: the reference test's shape).
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
