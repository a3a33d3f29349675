// Kernel B2: Gauss-Newton steps of every lane of an ICP row, on the card.
//
// Replaces: vfmreg_tpu/ops/gn_kernel.py, gn_moments_from_cache (Pallas,
// TPU), and with it the rest of one GN iteration of the reference's vmapped
// loop, vfmreg_tpu/registration/icp.py:geometric_icp_loop (`one_gn_step`
// under `inner_live`): the 6x6 solve, exp_se3, the pose update and the stop
// tests.
//
// Per query: nearest of its K cached champions (lowest k on ties), the
// `best < max_d2` acceptance gate (the 2e19 sentinel squares to +inf and
// never passes), the Geman-McClure weight k^2 / (k + d^2)^2, and 17 moments
// (count, sum w, sum w s_c, sum w s_c s_c^T (6), sum w r, sum w s_c x r)
// summed over the lane's queries. Rejected queries are zeroed by selection,
// never by multiplication, so sentinel or NaN lanes cannot poison the sums.
//
// What bounds it on an H100: latency, then bytes. One step of the driver's
// row (8 lanes of 8,192 queries, K = 32) reads ~25 MB of champions once
// (~7.5 us at 3.35 TB/s) and does ~20 MFLOP; the solve and the pose update
// are a few hundred dependent scalar operations per lane. Before this design
// each GN iteration of each lane was one launch of 32 blocks, a copy of the
// system to the host, a numpy solve and ~36 small launches; the host, not
// the card, set the pace.
//
// Design: one C call, `gn_step_lanes_launch`, is one GN step of every lane,
// in three kernels on the caller's stream:
//  (a) gn_partial_kernel, grid (query blocks, lanes): one thread per query
//      streams its K champions (coalesced: the cache is [K, N] per lane),
//      computes its 17 terms in registers, and a fixed-shape shared-memory
//      tree sums them per block into [lanes, blocks, 17] partials. A lane
//      that is not live skips its loads and writes zeros.
//  (b) gn_finish_kernel, one warp per lane: the lane's partials summed in a
//      fixed order (a strided pass per thread, then a shuffle tree), then on
//      one thread the reference's inner-loop predicate and, for a live
//      lane, `assemble_gn_system`, the 1e-8 Tikhonov floor, the unrolled
//      Cholesky in `_cholesky_solve6`'s exact order, the `n > 0 && finite`
//      gate, exp_se3, the conjugation by the centre, T <- est @ T, the
//      norms and the stop flags. A frozen lane is left bit for bit as it
//      was, which is what makes the lockstep run equal each lane's own run.
//  (c) gn_move_kernel, grid (query blocks, lanes): each lane that stepped
//      moves its source by est, with an explicit three-term dot.
// No atomics: the order of every sum is fixed, so reruns give the same bits,
// which the |dx| < 1e-4 termination test depends on. The arithmetic of
// (b) and (c) and the squared distances of (a) use non-contracting
// intrinsics: nvcc contracts a*b + c into an FMA by default, which rounds
// once where the plain PyTorch version rounds twice.
//
// `gn_moments_launch` is the single-lane moment pass (kernels (a) and the
// sum of (b) with no lane state), the `gn_moments_from_cache` wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NPART = 17;

// Lane state, one row per lane; the layout of ops/gn_kernel.py (int32 and
// f32 columns, phases). tests/test_torch_gn_lanes.py holds the two equal.
constexpr int I_IT = 0, I_S = 1, I_DONE = 2, I_CONF = 3, I_PHASE = 4, I_REBUILDS = 5,
              I_MAX_IT = 6, I_STEPPED = 7, NI = 8;
constexpr int F_DXN = 0, F_MOVED = 1, F_RMAX = 2, F_SLACK = 3, NF = 4;
constexpr int P_STEP = 0, P_REBUILD = 1, P_GATHER = 2, P_FINISHED = 3;

// The reference's `inner_live` (vfmreg_tpu/registration/icp.py:294-304),
// and the lane's phase says it is inside a champion epoch.
__device__ __forceinline__ bool lane_live(const int* I, const float* F, float thr,
                                          int refresh) {
  return I[I_PHASE] == P_STEP && I[I_S] < refresh && I[I_IT] < I[I_MAX_IT] &&
         !I[I_DONE] && !I[I_CONF] && F[F_MOVED] < F[F_SLACK] &&
         (I[I_S] == 0 || F[F_DXN] >= thr);
}

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// ((a0 b0 + a1 b1) + a2 b2), rounded after every operation.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return fadd(fadd(fmul(a0, b0), fmul(a1, b1)), fmul(a2, b2));
}

__global__ void __launch_bounds__(NT) gn_partial_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ src,
    const float* __restrict__ center, float kern, float max_d2, int K, int n,
    const int* __restrict__ ist, const float* __restrict__ fst, float thr, int refresh,
    float* __restrict__ partials) {
  __shared__ float sh[NPART][NT];
  const int tid = threadIdx.x;
  const int l = blockIdx.y;
  float* out = partials + ((size_t)l * gridDim.x + blockIdx.x) * NPART;
  // Uniform over the block, so the early return skips no barrier.
  if (ist != nullptr && !lane_live(ist + l * NI, fst + l * NF, thr, refresh)) {
    if (tid < NPART) out[tid] = 0.f;
    return;
  }
  const size_t lane = (size_t)l * K * n;
  cx += lane;
  cy += lane;
  cz += lane;
  src += (size_t)l * 3 * n;
  const float c0 = center[3 * l], c1 = center[3 * l + 1], c2 = center[3 * l + 2];
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
      const float dx = fsub(cx[o], sx);
      const float dy = fsub(cy[o], sy);
      const float dz = fsub(cz[o], sz);
      const float d2 = fadd(fadd(fmul(dx, dx), fmul(dy, dy)), fmul(dz, dz));
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
  if (tid < NPART) out[tid] = sh[tid][0];
}

// exp_se3 of dx = [upsilon, omega], conjugated by the centre c:
// E (row-major 3 x 4) = [R | (t + c) - R c], in the order of
// geometry/se3.py:exp_se3_lanes and conjugate_translation_lanes.
__device__ void exp_se3_conjugated(const float* dx, const float* c, float* E) {
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float theta2 = dot3(w0, w1, w2, w0, w1, w2);
  const bool small = theta2 < 1e-8f;
  const float theta2_safe = small ? 1.f : theta2;
  const float theta = __fsqrt_rn(theta2_safe);
  const float K[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[i][j] = dot3(K[i][0], K[i][1], K[i][2], K[0][j], K[1][j], K[2][j]);
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? fsub(1.f, fdiv(theta2, 6.f)) : fdiv(sn, theta);
  const float b = small ? fsub(0.5f, fdiv(theta2, 24.f)) : fdiv(fsub(1.f, cs), theta2_safe);
  const float cc = small ? fsub((float)(1.0 / 6.0), fdiv(theta2, 120.f))
                         : fdiv(fsub(theta, sn), fmul(theta2_safe, theta));
  float R[3][3], J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      R[i][j] = fadd(fadd(eye, fmul(a, K[i][j])), fmul(b, K2[i][j]));
      J[i][j] = fadd(fadd(eye, fmul(b, K[i][j])), fmul(cc, K2[i][j]));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = dot3(J[i][0], J[i][1], J[i][2], dx[0], dx[1], dx[2]);
    E[4 * i] = R[i][0];
    E[4 * i + 1] = R[i][1];
    E[4 * i + 2] = R[i][2];
    E[4 * i + 3] = fsub(fadd(t, c[i]), dot3(R[i][0], R[i][1], R[i][2], c[0], c[1], c[2]));
  }
}

// One GN step of one live lane from its 17 moments (see the file comment).
__device__ void gn_finish_lane(const float* m, const float* c, int* I, float* F, float thr,
                               int refresh, float* T, float* est, float* dxo) {
  const float sw = m[1], s1x = m[2], s1y = m[3], s1z = m[4];
  const float sxx = m[5], syy = m[6], szz = m[7], sxy = m[8], sxz = m[9], syz = m[10];
  const float tr = fadd(fadd(sxx, syy), szz);
  const float fl = 1e-8f;
  // The lower triangle of assemble_gn_system's JTJ plus the floor (gn_step
  // adds 1e-8 on the diagonal and 0 off it); sw * 0 and tr * 0 are kept as
  // products, as the reference's `sw * eye` and `tr * eye` compute them.
  float A[6][6];
  A[0][0] = fadd(fmul(sw, 1.f), fl);
  A[1][0] = fadd(fmul(sw, 0.f), 0.f);
  A[1][1] = fadd(fmul(sw, 1.f), fl);
  A[2][0] = fadd(fmul(sw, 0.f), 0.f);
  A[2][1] = fadd(fmul(sw, 0.f), 0.f);
  A[2][2] = fadd(fmul(sw, 1.f), fl);
  A[3][0] = fadd(0.f, 0.f);
  A[3][1] = fadd(-s1z, 0.f);
  A[3][2] = fadd(s1y, 0.f);
  A[3][3] = fadd(fsub(fmul(tr, 1.f), sxx), fl);
  A[4][0] = fadd(s1z, 0.f);
  A[4][1] = fadd(0.f, 0.f);
  A[4][2] = fadd(-s1x, 0.f);
  A[4][3] = fadd(fsub(fmul(tr, 0.f), sxy), 0.f);
  A[4][4] = fadd(fsub(fmul(tr, 1.f), syy), fl);
  A[5][0] = fadd(-s1y, 0.f);
  A[5][1] = fadd(s1x, 0.f);
  A[5][2] = fadd(0.f, 0.f);
  A[5][3] = fadd(fsub(fmul(tr, 0.f), sxz), 0.f);
  A[5][4] = fadd(fsub(fmul(tr, 0.f), syz), 0.f);
  A[5][5] = fadd(fsub(fmul(tr, 1.f), szz), fl);
  float bv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) bv[i] = -m[11 + i];

  // _cholesky_solve6: every sum starts from 0 and adds in ascending k.
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = fadd(acc, fmul(L[j][k], L[j][k]));
    L[j][j] = __fsqrt_rn(fsub(A[j][j], acc));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < j; ++k) s = fadd(s, fmul(L[i][k], L[j][k]));
      L[i][j] = fdiv(fsub(A[i][j], s), L[j][j]);
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < i; ++k) acc = fadd(acc, fmul(L[i][k], y[k]));
    y[i] = fdiv(fsub(bv[i], acc), L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = 0.f;
#pragma unroll
    for (int k = i + 1; k < 6; ++k) acc = fadd(acc, fmul(L[k][i], x[k]));
    x[i] = fdiv(fsub(y[i], acc), L[i][i]);
  }
  const int n_corr = (int)m[0];
  bool ok = n_corr > 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
  float dx[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = ok ? x[i] : 0.f;

  float E[12];
  exp_se3_conjugated(dx, c, E);
  float Tn[16];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = fadd(fadd(fadd(fmul(E[4 * i], T[j]), fmul(E[4 * i + 1], T[4 + j])),
                                fmul(E[4 * i + 2], T[8 + j])),
                           fmul(E[4 * i + 3], T[12 + j]));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    Tn[12 + j] = fadd(fadd(fadd(fmul(0.f, T[j]), fmul(0.f, T[4 + j])), fmul(0.f, T[8 + j])),
                      fmul(1.f, T[12 + j]));
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = Tn[i];
#pragma unroll
  for (int i = 0; i < 12; ++i) est[i] = E[i];
  est[12] = 0.f;
  est[13] = 0.f;
  est[14] = 0.f;
  est[15] = 1.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) dxo[i] = dx[i];

  // _norm: sqrt of the squares summed in ascending order.
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) sq = i == 0 ? fmul(dx[0], dx[0]) : fadd(sq, fmul(dx[i], dx[i]));
  const float dxn = __fsqrt_rn(sq);
  const float n_t = __fsqrt_rn(dot3(dx[0], dx[1], dx[2], dx[0], dx[1], dx[2]));
  const float n_w = __fsqrt_rn(dot3(dx[3], dx[4], dx[5], dx[3], dx[4], dx[5]));
  const int s = I[I_S];
  const bool conf = s == 0 && dxn < thr;
  const float moved = fadd(fadd(F[F_MOVED], n_t), fmul(n_w, F[F_RMAX]));
  const bool done = n_corr == 0;
  const int it = I[I_IT] + 1;
  const int s1 = s + 1;
  // Where the lane goes next: on in the inner loop, or a champion rebuild
  // (middle loop), or a new slab gather (outer loop), or nowhere.
  const bool more = it < I[I_MAX_IT] && !done && !conf;
  const bool inner = more && s1 < refresh && moved < F[F_SLACK] && dxn >= thr;
  I[I_IT] = it;
  I[I_S] = s1;
  I[I_DONE] = done;
  I[I_CONF] = conf;
  I[I_PHASE] = inner ? P_STEP : !more ? P_FINISHED : moved < F[F_SLACK] ? P_REBUILD : P_GATHER;
  I[I_STEPPED] = 1;
  F[F_DXN] = dxn;
  F[F_MOVED] = moved;
}

// One warp per lane. With `ist` null it only sums the moments.
__global__ void __launch_bounds__(32) gn_finish_kernel(
    const float* __restrict__ partials, int blocks, float* __restrict__ moments,
    const float* __restrict__ center, int* __restrict__ ist, float* __restrict__ fst,
    float thr, int refresh, float* __restrict__ T, float* __restrict__ est,
    float* __restrict__ dxo) {
  const int l = blockIdx.x, t = threadIdx.x;
  if (ist != nullptr && !lane_live(ist + l * NI, fst + l * NF, thr, refresh)) {
    if (t == 0) ist[l * NI + I_STEPPED] = 0;
    return;
  }
  __shared__ float m[NPART];
  const float* p = partials + (size_t)l * blocks * NPART;
  for (int j = 0; j < NPART; ++j) {
    float acc = 0.f;
    for (int b = t; b < blocks; b += 32) acc = fadd(acc, p[(size_t)b * NPART + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = fadd(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (t == 0) m[j] = acc;
  }
  if (t != 0) return;
  for (int j = 0; j < NPART; ++j) moments[l * NPART + j] = m[j];
  if (ist == nullptr) return;
  gn_finish_lane(m, center + 3 * l, ist + l * NI, fst + l * NF, thr, refresh, T + 16 * l,
                 est + 16 * l, dxo + 6 * l);
}

__global__ void __launch_bounds__(NT) gn_move_kernel(float* __restrict__ src,
                                                     const int* __restrict__ ist,
                                                     const float* __restrict__ est, int n) {
  const int l = blockIdx.y;
  const int qi = blockIdx.x * NT + threadIdx.x;
  if (!ist[l * NI + I_STEPPED] || qi >= n) return;
  const float* E = est + 16 * l;
  float* s = src + ((size_t)l * n + qi) * 3;
  const float sx = s[0], sy = s[1], sz = s[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    s[i] = fadd(dot3(sx, sy, sz, E[4 * i], E[4 * i + 1], E[4 * i + 2]), E[4 * i + 3]);
}

}  // namespace

// One GN step of every live lane. cx, cy, cz: [B, K, n]; src: [B, n, 3]
// (moved in place); center: [B, 3]; ist / fst: [B, NI] int32 / [B, NF] f32
// lane state; T, est: [B, 4, 4]; dx: [B, 6]; moments: [B, 17];
// partials: [B, ceil(n / 256), 17] scratch. Returns the cudaError_t.
extern "C" int gn_step_lanes_launch(const float* cx, const float* cy, const float* cz,
                                    float* src, const float* center, float kern,
                                    float max_d2, float thr, int refresh, int K, int n,
                                    int B, int* ist, float* fst, float* T, float* est,
                                    float* dx, float* moments, float* partials,
                                    cudaStream_t stream) {
  const int blocks = (n + NT - 1) / NT;
  const dim3 grid(blocks, B);
  gn_partial_kernel<<<grid, NT, 0, stream>>>(cx, cy, cz, src, center, kern, max_d2, K, n,
                                             ist, fst, thr, refresh, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finish_kernel<<<B, 32, 0, stream>>>(partials, blocks, moments, center, ist, fst, thr,
                                         refresh, T, est, dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_move_kernel<<<grid, NT, 0, stream>>>(src, ist, est, n);
  return (int)cudaGetLastError();
}

// The moments of one lane. cx, cy, cz: [K, n]; src: [n, 3]; center: [3] on
// the card; partials: [ceil(n / 256), 17] scratch; out: [17].
extern "C" int gn_moments_launch(const float* cx, const float* cy, const float* cz,
                                 const float* src, const float* center, float kern,
                                 float max_d2, int K, int n, float* partials, float* out,
                                 cudaStream_t stream) {
  const int blocks = (n + NT - 1) / NT;
  gn_partial_kernel<<<dim3(blocks, 1), NT, 0, stream>>>(cx, cy, cz, src, center, kern, max_d2,
                                                        K, n, nullptr, nullptr, 0.f, 0,
                                                        partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finish_kernel<<<1, 32, 0, stream>>>(partials, blocks, out, nullptr, nullptr, nullptr,
                                         0.f, 0, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}
