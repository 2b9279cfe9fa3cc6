// The int8 3-D Ising checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel<false, .> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                ising3d_pallas.py:_phase_kernel (pallas_call at :85,
//                _metropolis_phase).  One colour phase of (R, nz, ny,
//                half) int8 volumes, in place; six neighbours (z -+ 1 and
//                y -+ 1 periodic, the side one by (y + z) parity and
//                colour), three thresholds t4, t8, t12; Philox words or
//                injected (R, nz, ny, half) uint32 words (JAX's
//                sharded_phase takes bits= at :237).
//   phase_kernel<true, .> replaces ising3d_pallas.py:_halo_phase_kernel
//                (pallas_call at :237, sharded_phase).  The same phase on a
//                z-shard of a (dp, y) mesh (parallel/domain.py): the planes
//                before its first and after its last come from the
//                exchanged halo planes; parity (z0 + z + y) & 1 and the
//                Philox row (z0 + z) * ny + y are global, so a sharded
//                run equals the unsharded one bit for bit.  MEASURE adds
//                the shard's exact int64 (m, e) partials (phase b).
//
// The site rule, the unit of four sites and the word layout (row
// z * ny + y) are in csrc/ising_int8.cuh.  One thread a unit, a grid
// (units of a replica / 256, R), the tail unit masked: every even nx, ny,
// nz runs.  JAX holds one z-plane a grid step in VMEM and fetches z -+ 1
// through extra block specs; here each thread reads its neighbours from
// device memory through L1/L2, and the launch walks the whole volume.
//
// Bound on the H100: bytes, as the 2-D phase.  3 B a site against 28.5
// instructions (a quarter Philox call and 14 for the six-neighbour
// stencil, the compare and the flip), chip_smoke.py's count: at 500^3 x
// 2, 0.1119 ms by bytes against 0.1065 ms by operations.
#include "ising_int8.cuh"

namespace {

using ising8::Geometry;
using ising8::Phase;
using ising8::THREADS;

// One thread a unit.  HALO: x is a z-shard's, its first and last planes
// read s's halo planes; MEASURE adds its exact int64 (m, e) partials into
// s.obs (phase b).
template <bool HALO, bool MEASURE>
__global__ void __launch_bounds__(THREADS)
    phase_kernel(Phase p, ising8::Shard s, Geometry g) {
  const int r = blockIdx.y;
  const long long u =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int m = 0, e = 0;
  if (u < ising8::units_per_rep(g)) {
    const int row = static_cast<int>(u / g.units);
    ising8::update_unit<3, false, MEASURE, HALO>(
        p, s, g, r, row / g.ny, row % g.ny, static_cast<int>(u % g.units), m,
        e);
  }
  if (MEASURE) ising8::block_add(m, e, s.obs + 2 * r);
}

}  // namespace

extern "C" {

// One colour phase of x (R, nz, ny, half) int8 in place given o; bits is
// (R, nz, ny, half) uint32 or null (then Philox words under (s0, s1)).
int ising3d_int8_phase(void* x, const void* o, const void* bits, int nrep,
                       int nz, int ny, int half, int color, unsigned int s0,
                       unsigned int s1, unsigned int t4, unsigned int t8,
                       unsigned int t12, void* stream) {
  const Geometry g = ising8::geometry(nz, ny, half);
  if (!ising8::launchable(g, nrep) || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.bits = static_cast<const uint32_t*>(bits);
  p.key = make_uint2(s0, s1);
  p.t4 = t4;
  p.t8 = t8;
  p.t12 = t12;
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

// One colour phase of a z-shard x (R, nz, ny, half) int8 in place given o
// and the halo planes zm, zp (R, 1, ny, half); (rep0, z0) the shard's
// global offsets; obs an (R, 2) int64 buffer zeroed by the caller, or null.
int ising3d_int8_halo_phase(void* x, const void* o, const void* bits,
                            const void* zm, const void* zp, void* obs,
                            int nrep, int nz, int ny, int half, int color,
                            int rep0, int z0, unsigned int s0,
                            unsigned int s1, unsigned int t4,
                            unsigned int t8, unsigned int t12,
                            void* stream) {
  const Geometry g = ising8::geometry(nz, ny, half);
  if (!ising8::launchable(g, nrep) || nz < 1 || z0 < 0 || rep0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Phase p;
  p.x = static_cast<int8_t*>(x);
  p.o = static_cast<const int8_t*>(o);
  p.bits = static_cast<const uint32_t*>(bits);
  p.key = make_uint2(s0, s1);
  p.t4 = t4;
  p.t8 = t8;
  p.t12 = t12;
  p.color = color;
  ising8::Shard s;
  s.up = static_cast<const int8_t*>(zm);
  s.dn = static_cast<const int8_t*>(zp);
  s.lf = nullptr;
  s.rt = nullptr;
  s.obs = static_cast<long long*>(obs);
  s.rep0 = rep0;
  s.row0 = z0;
  s.col0 = 0;
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

const char* ising3d_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
