// The int8 q-state clock checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                clock_pallas.py:_phase_kernel (pallas_call at :106,
//                _metropolis_phase).  One colour phase of (R, ny, half)
//                int8 states, in place; its uniforms from Philox, or
//                injected (R, ny, half) float32 (u_cand, u_acc) planes
//                (the mode the checks use, as JAX's sharded_phase takes
//                u_cand=, u_acc=).
//
// The site rule, the tables, the unit of two sites and the word layout are
// in csrc/clock_int8.cuh.  One thread a unit, a grid (units of a replica /
// 256, R); the tail unit of a row whose half is odd is masked, so every
// even nx and ny runs (JAX's nx/2 % 128 and ny % 32 tiling gates are TPU
// artefacts).  In place: a phase reads only the other colour and its own
// site, so the updated colour is written where it is read, as the TPU
// kernel aliases it.
//
// Bound on the H100: operations.  A site of the colour updated moves 3 B
// (its own byte read and written, the other colour's read once) against
// about 60 instructions (half its unit's Philox4x32-10 call, the four
// gathers a component, the field, ΔE and expf; chip_smoke.py's
// OPS_CLOCK8_PHASE).
#include "clock_int8.cuh"

namespace {

using clock8::Geometry;
using clock8::Phase;
using clock8::TABLE;
using clock8::THREADS;

__global__ void __launch_bounds__(THREADS)
    phase_kernel(Phase p, Geometry g, const float* tab) {
  __shared__ float tc[TABLE], ts[TABLE];
  clock8::stage(tab, tc, ts);
  const clock8::Tables tb = {tc, ts, nullptr, nullptr};
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (u >= clock8::units_per_rep(g)) return;
  const int j = static_cast<int>(u % g.units);
  const int y = static_cast<int>(u / g.units);
  xy::Sums t = {0.0, 0.0, 0.0, 0.0};
  clock8::update_unit<false, false>(p, g, tb, r, y, j, t);
}

}  // namespace

extern "C" {

// One colour phase of x (R, ny, half) int8 in place given o; tab is the
// (2, 128) float32 (cos, sin) table of the q states; ucand, uacc are
// (R, ny, half) float32 or both null (then Philox words under (s0, s1)).
int clock_int8_phase(void* x, const void* o, const void* tab,
                     const void* ucand, const void* uacc, int nrep, int ny,
                     int half, int q, int color, float neg_beta,
                     unsigned int s0, unsigned int s1, void* stream) {
  const Geometry g = clock8::geometry(ny, half);
  if (!clock8::launchable(g, nrep, q) ||
      (ucand == nullptr) != (uacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.ucand = static_cast<const float*>(ucand);
  p.uacc = static_cast<const float*>(uacc);
  p.key = make_uint2(s0, s1);
  p.neg_beta = neg_beta;
  p.q = q;
  p.color = color;
  const dim3 grid(
      static_cast<unsigned>((clock8::units_per_rep(g) + THREADS - 1) /
                            THREADS),
      nrep);
  phase_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, static_cast<const float*>(tab));
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
