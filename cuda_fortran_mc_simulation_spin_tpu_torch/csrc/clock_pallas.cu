// The int8 q-state clock checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                clock_pallas.py:_phase_kernel (pallas_call at :106,
//                _metropolis_phase).  One colour phase of (R, ny, half)
//                int8 states, in place; its uniforms from Philox, or
//                injected (R, ny, half) float32 (u_cand, u_acc) planes
//                (the mode the checks use, as JAX's sharded_phase takes
//                u_cand=, u_acc=).
//   phase_kernel<true, .> replaces clock_pallas.py:_halo_phase_kernel
//                (pallas_call at :294, sharded_phase).  The same phase on a
//                shard of a (y[, x]) mesh (parallel/domain.py): rows, and
//                with an x split columns, past the shard's edges come from
//                the exchanged halos; parity and the Philox counter from
//                global coordinates, so a shard draws what the whole
//                lattice draws and a sharded run equals the unsharded one
//                bit for bit.  A unit is a global unit of two columns: a
//                shard at an odd col0 cuts its first and last units, and
//                its neighbour draws the same Philox call for the other
//                column.  MEASURE adds the shard's float64 (Σ cos, Σ sin,
//                e) partials of a measuring phase b, per block in a fixed
//                order and then per replica by xy::reduce_kernel.
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

// One thread a unit.  HALO: x is a shard's, its edges read s's halos;
// MEASURE writes its block's float64 sums to partials (phase b).
template <bool HALO, bool MEASURE>
__global__ void __launch_bounds__(THREADS)
    phase_kernel(Phase p, clock8::Shard s, Geometry g, const float* tab,
                 const double* tab64, double* partials) {
  __shared__ float tc[TABLE], ts[TABLE];
  __shared__ double tc64[MEASURE ? TABLE : 1], ts64[MEASURE ? TABLE : 1];
  clock8::stage(tab, tc, ts);
  if constexpr (MEASURE) clock8::stage(tab64, tc64, ts64);
  const clock8::Tables tb = {tc, ts, tc64, ts64};
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  xy::Sums t = {0.0, 0.0, 0.0, 0.0};
  if constexpr (MEASURE) {
    if (u < clock8::units_per_rep(g))
      clock8::update_unit<false, true, HALO>(
          p, s, g, tb, r, static_cast<int>(u / g.units),
          static_cast<int>(u % g.units), t);
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
    return;
  }
  if (u >= clock8::units_per_rep(g)) return;
  const int j = static_cast<int>(u % g.units);
  const int y = static_cast<int>(u / g.units);
  clock8::update_unit<false, false, HALO>(p, s, g, tb, r, y, j, t);
}

Phase make_phase(void* x, const void* o, const void* ucand,
                 const void* uacc, int q, int color, float neg_beta,
                 unsigned int s0, unsigned int s1) {
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.ucand = static_cast<const float*>(ucand);
  p.uacc = static_cast<const float*>(uacc);
  p.key = make_uint2(s0, s1);
  p.neg_beta = neg_beta;
  p.q = q;
  p.color = color;
  return p;
}

dim3 grid_of(const Geometry& g, int nrep) {
  return dim3(static_cast<unsigned>((clock8::units_per_rep(g) + THREADS - 1) /
                                    THREADS),
              nrep);
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
  const Phase p =
      make_phase(x, o, ucand, uacc, q, color, neg_beta, s0, s1);
  phase_kernel<false, false>
      <<<grid_of(g, nrep), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          p, clock8::Shard{}, g, static_cast<const float*>(tab), nullptr,
          nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Blocks a row of a shard's partials: ceil(ny * shard_units / 256).
int clock_int8_halo_blocks(int ny, int half, int col0) {
  Geometry g = clock8::geometry(ny, half);
  g.units = clock8::shard_units(col0, half);
  return static_cast<int>((clock8::units_per_rep(g) + THREADS - 1) /
                          THREADS);
}

// One colour phase of a shard x (R, ny, half) int8 in place given o and
// the halos up, dn (R, 1, half) and lf, rt (R, ny, 1) or null; (rep0,
// row0, col0) the shard's global offsets.  With partials ((R, blocks, 3)
// float64, clock_int8_halo_blocks) and obs ((R, 3) float64) the launch
// measures (Σ cos, Σ sin, e) into obs; tab64 is the (2, 128) float64
// table of the sums.
int clock_int8_halo_phase(void* x, const void* o, const void* tab,
                          const void* tab64, const void* ucand,
                          const void* uacc, const void* up, const void* dn,
                          const void* lf, const void* rt, void* partials,
                          void* obs, int nrep, int ny, int half, int q,
                          int color, int rep0, int row0, int col0,
                          float neg_beta, unsigned int s0, unsigned int s1,
                          void* stream) {
  Geometry g = clock8::geometry(ny, half);
  g.units = clock8::shard_units(col0, half);
  if (!clock8::launchable(g, nrep, q) || rep0 < 0 || row0 < 0 ||
      col0 < 0 || (ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr) ||
      (partials != nullptr && tab64 == nullptr) ||
      (lf == nullptr) != (rt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Phase p =
      make_phase(x, o, ucand, uacc, q, color, neg_beta, s0, s1);
  clock8::Shard s;
  s.up = static_cast<const int8_t*>(up);
  s.dn = static_cast<const int8_t*>(dn);
  s.lf = static_cast<const int8_t*>(lf);
  s.rt = static_cast<const int8_t*>(rt);
  s.rep0 = rep0;
  s.row0 = row0;
  s.col0 = col0;
  const dim3 grid = grid_of(g, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t32 = static_cast<const float*>(tab);
  const double* t64 = static_cast<const double*>(tab64);
  double* part = static_cast<double*>(partials);
  if (partials == nullptr) {
    phase_kernel<true, false><<<grid, THREADS, 0, st>>>(p, s, g, t32, t64,
                                                        part);
    return static_cast<int>(cudaGetLastError());
  }
  phase_kernel<true, true><<<grid, THREADS, 0, st>>>(p, s, g, t32, t64, part);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, st>>>(
      part, static_cast<double*>(obs), static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
