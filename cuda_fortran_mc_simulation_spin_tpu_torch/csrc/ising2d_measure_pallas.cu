// The int8 Ising observables of a state in one pass on Hopper (sm_90a).
//
//   measure_kernel<2> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising2d_measure_pallas.py:_kernel (pallas_call at
//                     :74, _measure -> measure): per replica the exact
//                     (Σ s, E) of (R, ny, half) int8 planes,
//                     E = -Σ s (s_right + s_down), each bond once.
//   measure_kernel<3> the same for (R, nz, ny, half) volumes with the back
//                     (z + 1) bond.  The JAX package sums the 3-D
//                     observables in jnp outside any kernel (models/
//                     ising3d.py:144-171); in PyTorch their int64
//                     temporaries at 500^3 x 2 would cost gigabytes.
//
// One thread a unit of four columns of one row, both colours (csrc/
// ising_int8.cuh measure_unit); int32 partials reduced per block, then one
// 64-bit atomic add per block and observable into an (R, 2) int64 buffer
// the caller zeroes (the pattern of csrc/ising3d_multispin.cu).  Integer
// sums are exact in any order, so the result is the plain version's
// bitwise; JAX accumulates f32 across row blocks.
//
// Bound on the H100: bytes.  It reads both colours once, 1 B a site,
// against 5 instructions a site (6 in 3-D; chip_smoke.py's count).
#include "ising_int8.cuh"

namespace {

using ising8::Geometry;
using ising8::THREADS;

template <int D>
__global__ void __launch_bounds__(THREADS)
    measure_kernel(const int8_t* a, const int8_t* b, long long* obs,
                   Geometry g) {
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int m = 0, e = 0;
  if (u < ising8::units_per_rep(g)) {
    const int j = static_cast<int>(u % g.units);
    const int row = static_cast<int>(u / g.units);
    ising8::measure_unit<D>(a, b, g, r, row / g.ny, row % g.ny, j, m, e);
  }
  ising8::block_add(m, e, obs + 2 * static_cast<size_t>(r));
}

}  // namespace

extern "C" {

// (m, e) of each replica of the colour planes a, b into obs (R, 2) int64,
// zeroed by the caller; dims = 2 ((R, ny, half), nz = 1) or 3.
int ising_int8_measure(const void* a, const void* b, void* obs, int nrep,
                       int dims, int nz, int ny, int half, void* stream) {
  const Geometry g = ising8::geometry(nz, ny, half);
  if (!ising8::launchable(g, nrep) || (dims == 3 && nz < 2) ||
      (dims == 2 && nz != 1) || (dims != 2 && dims != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(
      static_cast<unsigned>((ising8::units_per_rep(g) + THREADS - 1) /
                            THREADS),
      nrep);
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* po = static_cast<long long*>(obs);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dims == 2)
    measure_kernel<2><<<grid, THREADS, 0, s>>>(pa, pb, po, g);
  else
    measure_kernel<3><<<grid, THREADS, 0, s>>>(pa, pb, po, g);
  return static_cast<int>(cudaGetLastError());
}

const char* ising_int8_measure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
