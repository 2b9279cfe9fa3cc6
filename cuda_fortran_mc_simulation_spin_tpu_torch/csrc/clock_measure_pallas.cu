// The int8 clock observables of a state in one pass on Hopper (sm_90a).
//
//   measure_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                  clock_measure_pallas.py:_kernel (pallas_call at :85,
//                  _measure -> measure): per replica (Σ cos θ, Σ sin θ, E)
//                  of (R, ny, half) int8 states, E = -Σ cos(θ - θ_right) +
//                  cos(θ - θ_down), each bond once.
//
// One thread a unit of two columns of one row, both colours (csrc/
// clock_int8.cuh measure_unit), each term float64 from the float64 table;
// per-block sums in a fixed order (xy::block_sums), then reduce_kernel adds
// a replica's blocks in a fixed order and negates the bond sum into E.  No
// float atomics, so every run gives the same bits.  The JAX kernel sums
// float32 across row blocks.
//
// Bound on the H100: bytes.  It reads both colours once, 1 B a site,
// against ~14 instructions a site (two gathers a component, the bond
// products and three float64 adds; chip_smoke.py's OPS_CLOCK8_MEASURE).
#include "clock_int8.cuh"

namespace {

using clock8::Geometry;
using clock8::TABLE;
using clock8::THREADS;

__global__ void __launch_bounds__(THREADS)
    measure_kernel(const int8_t* a, const int8_t* b, const double* tab,
                   double* partials, Geometry g) {
  __shared__ double tc[TABLE], ts[TABLE];
  clock8::stage(tab, tc, ts);
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  xy::Sums t = {0.0, 0.0, 0.0, 0.0};
  if (u < clock8::units_per_rep(g)) {
    const int j = static_cast<int>(u % g.units);
    const int y = static_cast<int>(u / g.units);
    clock8::measure_unit(a, b, g, tc, ts, r, y, j, t);
  }
  xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

}  // namespace

extern "C" {

// (Σ cos, Σ sin, E) of each replica of the colour planes a, b into obs
// (R, 3) float64; tab the (2, 128) float64 table; partials (R, blocks, 3)
// float64 scratch, blocks = ceil(ny * ceil(half / 2) / 256).
int clock_int8_measure(const void* a, const void* b, const void* tab,
                       void* partials, void* obs, int nrep, int ny, int half,
                       int q, void* stream) {
  const Geometry g = clock8::geometry(ny, half);
  if (!clock8::launchable(g, nrep, q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk =
      static_cast<int>((clock8::units_per_rep(g) + THREADS - 1) / THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  measure_kernel<<<dim3(nblk, nrep), THREADS, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const double*>(tab), static_cast<double*>(partials), g);
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, s>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_measure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
