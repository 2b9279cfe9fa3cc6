// The int8 2-D Ising checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel<false, .> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                ising2d_pallas.py:_phase_kernel (pallas_call at :126,
//                _metropolis_phase).  One colour phase of (R, ny, half)
//                int8 planes, in place; its random words from Philox, or
//                injected (R, ny, half) uint32 words (the mode the checks
//                use, as JAX's sharded_phase takes bits= at :397).
//   phase_kernel<true, .> replaces ising2d_pallas.py:_halo_phase_kernel
//                (pallas_call at :397, sharded_phase).  The same phase on a
//                shard of a (y[, x]) mesh (parallel/domain.py): rows, and
//                with an x split columns, past the shard's edges come from
//                the exchanged halos; parity and the Philox counter from
//                global coordinates, so a shard draws what the whole
//                lattice draws and a sharded run equals the unsharded one
//                bit for bit.  A unit is a global unit of four columns:
//                at an x offset col0 % 4 != 0 a shard's first and last
//                units are partial, and its neighbour draws the same
//                Philox call for the other columns.  MEASURE adds the
//                shard's exact int64 (m, e) partials (phase b).
//
// The site rule, the unit of four sites and the word layout are in
// csrc/ising_int8.cuh.  One thread a unit (one Philox call feeds its four
// sites), a grid (units of a replica / 256, R); the tail unit of a row
// whose half is not a multiple of 4 is masked, so every even nx and ny
// runs (JAX's nx/2 % 128 and ny % 32 tiling gates are TPU artefacts).  In
// place: a phase reads only the other colour, so the updated colour is
// written where it is read, as the TPU kernel aliases it.
//
// Bound on the H100: bytes.  A site of the colour updated moves 3 B (its
// own byte read and written, the other colour's read once) and costs
// 26.5 instructions (a quarter of its unit's Philox4x32-10 call, 58, and
// 12 for the stencil, the compare and the flip), chip_smoke.py's count:
// at 4000^2 x 8, 0.0573 ms by bytes (3.35 TB/s) against 0.0507 ms by
// operations (33.4 T/s).  The byte loads hit L1 (the other colour's rows
// are read by three rows of units).
#include "ising_int8.cuh"

namespace {

using ising8::Geometry;
using ising8::Phase;
using ising8::THREADS;

// One thread a unit.  HALO: x is a shard's, its edges read s's halos;
// MEASURE adds its exact int64 (m, e) partials into s.obs (phase b).
template <bool HALO, bool MEASURE>
__global__ void __launch_bounds__(THREADS)
    phase_kernel(Phase p, ising8::Shard s, Geometry g) {
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int m = 0, e = 0;
  if (u < ising8::units_per_rep(g))
    ising8::update_unit<MEASURE, HALO>(
        p, s, g, r, static_cast<int>(u / g.units),
        static_cast<int>(u % g.units), m, e);
  if (MEASURE) ising8::block_add(m, e, s.obs + 2 * r);
}

}  // namespace

extern "C" {

// One colour phase of x (R, ny, half) int8 in place given o; bits is
// (R, ny, half) uint32 or null (then Philox words under (s0, s1)).
int ising2d_int8_phase(void* x, const void* o, const void* bits, int nrep,
                       int ny, int half, int color, unsigned int s0,
                       unsigned int s1, unsigned int t4, unsigned int t8,
                       void* stream) {
  const Geometry g = ising8::geometry(1, ny, half);
  if (!ising8::launchable(g, nrep))
    return static_cast<int>(cudaErrorInvalidValue);
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.bits = static_cast<const uint32_t*>(bits);
  p.key = make_uint2(s0, s1);
  p.t4 = t4;
  p.t8 = t8;
  p.t12 = t8;
  p.color = color;
  const dim3 grid(
      static_cast<unsigned>((ising8::units_per_rep(g) + THREADS - 1) /
                            THREADS),
      nrep);
  phase_kernel<false, false>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          p, ising8::Shard{}, g);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a shard x (R, ny, half) int8 in place given o and
// the halos up, dn (R, 1, half) and lf, rt (R, ny, 1) or null; (rep0,
// row0, col0) the shard's global offsets; obs an (R, 2) int64 buffer
// zeroed by the caller, or null.
int ising2d_int8_halo_phase(void* x, const void* o, const void* bits,
                            const void* up, const void* dn, const void* lf,
                            const void* rt, void* obs, int nrep, int ny,
                            int half, int color, int rep0, int row0,
                            int col0, unsigned int s0, unsigned int s1,
                            unsigned int t4, unsigned int t8, void* stream) {
  Geometry g = ising8::geometry(1, ny, half);
  g.units = ising8::shard_units(col0, half);
  if (!ising8::launchable(g, nrep) || col0 < 0 || row0 < 0 || rep0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.bits = static_cast<const uint32_t*>(bits);
  p.key = make_uint2(s0, s1);
  p.t4 = t4;
  p.t8 = t8;
  p.t12 = t8;
  p.color = color;
  ising8::Shard s;
  s.up = static_cast<const int8_t*>(up);
  s.dn = static_cast<const int8_t*>(dn);
  s.lf = static_cast<const int8_t*>(lf);
  s.rt = static_cast<const int8_t*>(rt);
  s.obs = static_cast<long long*>(obs);
  s.rep0 = rep0;
  s.row0 = row0;
  s.col0 = col0;
  const dim3 grid(
      static_cast<unsigned>((ising8::units_per_rep(g) + THREADS - 1) /
                            THREADS),
      nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs != nullptr)
    phase_kernel<true, true><<<grid, THREADS, 0, st>>>(p, s, g);
  else
    phase_kernel<true, false><<<grid, THREADS, 0, st>>>(p, s, g);
  return static_cast<int>(cudaGetLastError());
}

const char* ising2d_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
