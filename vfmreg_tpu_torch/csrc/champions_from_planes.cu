// Single-pass champion-cache rebuild from transposed candidate planes, for
// every flagged lane of an ICP row in one launch.
//
// Replaces: vfmreg_tpu/ops/champion_kernel.py, champions_from_planes
// (Pallas, TPU), which the reference's vmapped loop runs for all lanes.
//
// Input per lane: the candidates of one slab gather, transposed to
// [27 * G, n] per coordinate (G candidate rows per neighbour voxel, queries
// along the row), the queries' current positions [n, 3] and their mask [n].
// Output per lane: three [32, n] champion planes. Row v < 27 holds, per
// query, the in-voxel nearest candidate of voxel group v; rows 27..31 and
// dead rows hold the sentinel 2e19 (its square overflows f32 to +inf).
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
// What bounds it on an H100: bytes. Per lane it reads 3 * 27 * G * n floats
// and writes 3 * 27 * n (at G = 24, n = 8192: ~64 MB, ~19 us at 3.35 TB/s),
// with ~5 operations per byte-sized candidate, far below the compute roof.
// One lane of 8,192 queries fills 64 x 27 blocks of 128 threads; a row's
// lanes rebuild in one launch, so the fixed cost of a launch is paid once
// per rebuild round, not once per lane.
//
// Design: one thread owns one (query, voxel group, lane), so a warp reads 32
// consecutive floats of a row (coalesced, no transpose); grid (query
// blocks, 27 groups, lanes). A lane whose flag is 0 returns at once. Rows
// 27..31 of the loop's persistent champion buffer are written once, when it
// is allocated; the single-lane entry writes them itself (grid.y = 32). No
// shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr int KOUT = 32;
constexpr float INVALID_COORD = 2e19f;

__global__ void __launch_bounds__(NT) champions_kernel(
    const float* __restrict__ cxt, const float* __restrict__ cyt,
    const float* __restrict__ czt, const float* __restrict__ q,
    const unsigned char* __restrict__ qmask, const int* __restrict__ flags, int n_groups,
    int G, int n, float* __restrict__ ocx, float* __restrict__ ocy, float* __restrict__ ocz) {
  const int l = blockIdx.z;
  if (flags != nullptr && flags[l] == 0) return;
  const int qi = blockIdx.x * NT + threadIdx.x;
  const int v = blockIdx.y;
  if (qi >= n) return;
  const size_t out = ((size_t)l * KOUT + v) * n + qi;
  if (v >= n_groups) {
    ocx[out] = INVALID_COORD;
    ocy[out] = INVALID_COORD;
    ocz[out] = INVALID_COORD;
    return;
  }
  const size_t plane = (size_t)n_groups * G * n;
  cxt += l * plane;
  cyt += l * plane;
  czt += l * plane;
  q += (size_t)l * 3 * n;
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
  const bool alive =
      !nan && best < __int_as_float(0x7f800000) && qmask[(size_t)l * n + qi] != 0;
  const size_t sel = base + (size_t)kb * n;
  ocx[out] = alive ? cxt[sel] : INVALID_COORD;
  ocy[out] = alive ? cyt[sel] : INVALID_COORD;
  ocz[out] = alive ? czt[sel] : INVALID_COORD;
}

}  // namespace

// Every flagged lane at once. cxt, cyt, czt: [B, n_groups * G, n];
// q: [B, n, 3]; qmask: [B, n] (bool bytes); flags: [B] int32 on the card;
// ocx, ocy, ocz: [B, 32, n], of which rows 0..n_groups-1 of the flagged
// lanes are written. Returns the cudaError_t of the launch.
extern "C" int champions_lanes_launch(const float* cxt, const float* cyt, const float* czt,
                                      const float* q, const unsigned char* qmask,
                                      const int* flags, int B, int n_groups, int G, int n,
                                      float* ocx, float* ocy, float* ocz,
                                      cudaStream_t stream) {
  const dim3 grid((n + NT - 1) / NT, n_groups, B);
  champions_kernel<<<grid, NT, 0, stream>>>(cxt, cyt, czt, q, qmask, flags, n_groups, G, n,
                                            ocx, ocy, ocz);
  return (int)cudaGetLastError();
}

// One lane. cxt, cyt, czt: [n_groups * G, n]; q: [n, 3]; qmask: [n];
// ocx, ocy, ocz: [32, n], all rows written. Returns the cudaError_t.
extern "C" int champions_from_planes_launch(const float* cxt, const float* cyt,
                                            const float* czt, const float* q,
                                            const unsigned char* qmask, int n_groups, int G,
                                            int n, float* ocx, float* ocy, float* ocz,
                                            cudaStream_t stream) {
  const dim3 grid((n + NT - 1) / NT, KOUT, 1);
  champions_kernel<<<grid, NT, 0, stream>>>(cxt, cyt, czt, q, qmask, nullptr, n_groups, G,
                                            n, ocx, ocy, ocz);
  return (int)cudaGetLastError();
}
