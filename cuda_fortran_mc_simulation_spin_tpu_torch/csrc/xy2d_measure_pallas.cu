// The periodic XY observables of a state in one pass on Hopper (sm_90a).
//
//   measure_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                  xy2d_measure_pallas.py:_kernel (pallas_call at :121,
//                  _measure -> measure, measure_plain): per replica
//                  (Σ S_x, Σ S_y, e, A) of the four float32 state planes,
//                  e = -Σ S·(S_right + S_down) (each bond once) and, against
//                  the four t=0 snapshot planes, A = Σ S·S0 (0 without a
//                  snapshot).  The disorder protocols run it where the
//                  sums cannot be fused into a Metropolis phase: after the
//                  over-relaxation sweeps and for the fix1mcs row at t=1.
//
// One thread a (replica, y, i): both colours' sites there, their right and
// down neighbours (core/lattice.py right_down_neighbors: colour 0's right
// neighbour is b[y, i + (y & 1)], colour 1's a[y, i + 1 - (y & 1)], the
// down ones the other colour's (y + 1, i), rows wrapping at ny and columns
// at half) and the snapshot.  Every site term is float64 of the widened
// float32 spins, written with __dmul_rn / __dadd_rn in the order of the
// plain version (ops/xy2d_measure_pallas.measure_sums_plain), so kernel and
// plain differ only in the order of the float64 sums: block partials and
// the fixed-order reduce_kernel of xy2d_site.cuh, no atomics, so runs
// repeat bitwise.
//
// Bound on the H100: bytes.  The launch reads the 4 state planes and the 4
// snapshot planes once, 16 B a site (8 B without the snapshot), against
// ~20 float64 operations a site.
#include "xy2d_site.cuh"

namespace {

using xy::Sums;
using xy::THREADS;

struct Measure {
  const float* ax;
  const float* ay;
  const float* bx;
  const float* by;
  const float* sax;        // t=0 snapshot, or all null
  const float* say;
  const float* sbx;
  const float* sby;
  double* partials;        // (R, gridDim.x, 4)
  int ny, half;
};

__device__ __forceinline__ double wide(const float* p, size_t i) {
  return static_cast<double>(__ldg(p + i));
}

// v * (right + down)
__device__ __forceinline__ double bond(double v, double right, double down) {
  return __dmul_rn(v, __dadd_rn(right, down));
}

__global__ void __launch_bounds__(THREADS) measure_kernel(Measure m) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (w < m.ny * m.half) {
    const int y = w / m.half, i = w - y * m.half;
    const size_t base = static_cast<size_t>(r) * m.ny * m.half;
    const size_t row = base + static_cast<size_t>(y) * m.half;
    const size_t idx = row + i;
    const size_t ip = row + (i == m.half - 1 ? 0 : i + 1);
    const size_t dn =
        base + static_cast<size_t>(y == m.ny - 1 ? 0 : y + 1) * m.half + i;
    const bool odd = (y & 1) == 1;
    const size_t ra = odd ? ip : idx;   // colour 0's right neighbour in b
    const size_t rb = odd ? idx : ip;   // colour 1's right neighbour in a
    const double ax = wide(m.ax, idx), ay = wide(m.ay, idx);
    const double bx = wide(m.bx, idx), by = wide(m.by, idx);
    const double ea = __dadd_rn(bond(ax, wide(m.bx, ra), wide(m.bx, dn)),
                                bond(ay, wide(m.by, ra), wide(m.by, dn)));
    const double eb = __dadd_rn(bond(bx, wide(m.ax, rb), wide(m.ax, dn)),
                                bond(by, wide(m.ay, rb), wide(m.ay, dn)));
    t.mx = __dadd_rn(ax, bx);
    t.my = __dadd_rn(ay, by);
    t.e = __dadd_rn(ea, eb);
    if (m.sax != nullptr) {
      const double aa = __dadd_rn(__dmul_rn(ax, wide(m.sax, idx)),
                                  __dmul_rn(ay, wide(m.say, idx)));
      const double ab = __dadd_rn(__dmul_rn(bx, wide(m.sbx, idx)),
                                  __dmul_rn(by, wide(m.sby, idx)));
      t.a = __dadd_rn(aa, ab);
    }
  }
  xy::block_sums<xy::NSUMS>(m.partials, r, gridDim.x, blockIdx.x, t);
}

}  // namespace

extern "C" {

// (Σ S_x, Σ S_y, e, A) of (nrep, ny, half) planes into obs ((nrep, 4)
// float64), through partials ((nrep, blocks, 4) float64): grid
// (ceil(ny*half/256), nrep) of 256 threads, then reduce_kernel.  snap is
// null (A = 0) or the four t=0 snapshot planes (ax, ay, bx, by).
int xy_measure(const void* ax, const void* ay, const void* bx,
               const void* by, const void* const* snap, void* partials,
               void* obs, int nrep, int ny, int half, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if (partials == nullptr || obs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Measure m;
  m.ax = static_cast<const float*>(ax);
  m.ay = static_cast<const float*>(ay);
  m.bx = static_cast<const float*>(bx);
  m.by = static_cast<const float*>(by);
  const float* sn[4] = {nullptr, nullptr, nullptr, nullptr};
  if (snap != nullptr)
    for (int k = 0; k < 4; ++k) sn[k] = static_cast<const float*>(snap[k]);
  m.sax = sn[0];
  m.say = sn[1];
  m.sbx = sn[2];
  m.sby = sn[3];
  m.partials = static_cast<double*>(partials);
  m.ny = ny;
  m.half = half;
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  measure_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(m);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<xy::NSUMS><<<nrep, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

const char* xy_measure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
