// Single-pass champion-cache rebuild from transposed candidate planes.
//
// Replaces: vfmreg_tpu/ops/champion_kernel.py, champions_from_planes
// (Pallas, TPU).
//
// Input: the candidates of one slab gather, transposed to [27 * G, n] per
// coordinate (G candidate rows per neighbour voxel, queries along the row),
// the queries' current positions [n, 3] and their mask [n]. Output: three
// [32, n] champion planes. Row v < 27 holds, per query, the in-voxel nearest
// candidate of voxel group v; rows 27..31 and dead rows hold the sentinel
// 2e19 (its square overflows f32 to +inf).
//
// The contract is bit-identity with `build_nn_cache` (and the Pallas body):
// * d2 = (dx*dx + dy*dy) + dz*dz in f32 with non-contracting intrinsics:
//   nvcc contracts a*b + c to an FMA by default, which rounds once instead
//   of twice and can move a champion;
// * the first (lowest) row of the group wins ties;
// * a row is alive when the group's minimum is finite and the query's mask
//   holds; the reference's min propagates NaN, so a NaN anywhere in the
//   group (a NaN query coordinate) gives a dead row, which a plain running
//   '<' would not see;
// * the selected candidate's value itself is written.
//
// What bounds it on an H100: bytes. Per call it reads 3 * 27 * G * n floats
// and writes 3 * 32 * n (at G = 24, n = 8192: ~67 MB, ~20 us at 3.35 TB/s),
// with ~5 operations per byte-sized candidate, far below the compute roof.
//
// Design: the TPU kernel put queries in lanes and candidate rows in
// sublanes. Here one thread owns one (query, voxel group) pair, so a warp
// reads 32 consecutive floats of a row (coalesced, no transpose) and the
// 27 groups of a query run in parallel blocks (grid.y = 32: groups 27..31
// write the sentinel rows), which keeps ~27x more loads in flight than one
// thread per query would. No shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr int KOUT = 32;
constexpr float INVALID_COORD = 2e19f;

__global__ void __launch_bounds__(NT) champions_kernel(
    const float* __restrict__ cxt, const float* __restrict__ cyt,
    const float* __restrict__ czt, const float* __restrict__ q,
    const unsigned char* __restrict__ qmask, int n_groups, int G, int n,
    float* __restrict__ ocx, float* __restrict__ ocy, float* __restrict__ ocz) {
  const int qi = blockIdx.x * NT + threadIdx.x;
  const int v = blockIdx.y;
  if (qi >= n) return;
  const size_t out = (size_t)v * n + qi;
  if (v >= n_groups) {
    ocx[out] = INVALID_COORD;
    ocy[out] = INVALID_COORD;
    ocz[out] = INVALID_COORD;
    return;
  }
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  float best = __int_as_float(0x7f800000);  // +inf
  int kb = 0;
  bool nan = false;
  const size_t base = (size_t)v * G * n + qi;
#pragma unroll 4
  for (int k = 0; k < G; ++k) {
    const size_t o = base + (size_t)k * n;
    const float dx = __fsub_rn(cxt[o], qx);
    const float dy = __fsub_rn(cyt[o], qy);
    const float dz = __fsub_rn(czt[o], qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    nan |= (d2 != d2);
    if (d2 < best) {  // strict: the first minimum wins
      best = d2;
      kb = k;
    }
  }
  const bool alive = !nan && best < __int_as_float(0x7f800000) && qmask[qi] != 0;
  const size_t sel = base + (size_t)kb * n;
  ocx[out] = alive ? cxt[sel] : INVALID_COORD;
  ocy[out] = alive ? cyt[sel] : INVALID_COORD;
  ocz[out] = alive ? czt[sel] : INVALID_COORD;
}

}  // namespace

// cxt, cyt, czt: [n_groups * G, n]; q: [n, 3]; qmask: [n] (bool bytes);
// ocx, ocy, ocz: [32, n]. Returns the cudaError_t of the launch.
extern "C" int champions_from_planes_launch(
    const float* cxt, const float* cyt, const float* czt, const float* q,
    const unsigned char* qmask, int n_groups, int G, int n, float* ocx,
    float* ocy, float* ocz, cudaStream_t stream) {
  const dim3 grid((n + NT - 1) / NT, KOUT);
  champions_kernel<<<grid, NT, 0, stream>>>(cxt, cyt, czt, q, qmask, n_groups,
                                            G, n, ocx, ocy, ocz);
  return (int)cudaGetLastError();
}
