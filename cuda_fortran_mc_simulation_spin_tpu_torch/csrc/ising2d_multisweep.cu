// S int8 2-D Ising sweeps in one cooperative launch on Hopper (sm_90a).
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising2d_multisweep.py:_kernel (pallas_call at :128,
//                     _multisweep -> multisweep): S full sweeps (phase a,
//                     then phase b) of (R, ny, half) int8 planes, in place,
//                     with each sweep's exact (m, e) fused into phase b as
//                     JAX's :84-90 fuses them (m = Σ new + Σ o,
//                     e = -Σ new * nsum), into an (R, S, 2) int64 buffer.
//
// The TPU kernel keeps one replica in VMEM a grid step.  A 1000x1000
// replica is 1 MB and the ensemble 16 MB, which sits in the 50 MB L2, so
// here the planes stay in device memory: a cooperative grid walks every
// tile of a phase (a tile = 256 units of one replica, csrc/ising_int8.cuh)
// and waits at a grid barrier before the next phase reads what it wrote;
// the loads after a barrier bypass L1 (__ldcg).  Sweep s, phase p draws
// under the key seeds[s][p] (ops/multispin_rng.sweep_phase_keys), so S
// sweeps here equal S pairs of phase_kernel launches (csrc/
// ising2d_pallas.cu) and measure_kernel, bitwise.
//
// Bound on the H100: operations.  A launch reads and writes the planes
// once (4 B a site) but runs 2 S phases of 26.5 instructions a site and
// S fused sums of 4 (chip_smoke.py's count); it saves the host's launches
// of 3 S kernels and keeps the planes in L2.
#include <cooperative_groups.h>

#include "ising_int8.cuh"

namespace cg = cooperative_groups;

namespace {

using ising8::Geometry;
using ising8::Phase;
using ising8::THREADS;

struct Multisweep {
  int8_t* a;             // (R, ny, half), updated in place
  int8_t* b;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, sweeps;
  uint32_t t4, t8;
};

__global__ void __launch_bounds__(THREADS)
    multisweep_kernel(Multisweep ms, Geometry g) {
  cg::grid_group grid = cg::this_grid();
  const long long per_rep = ising8::units_per_rep(g);
  const int chunks = static_cast<int>((per_rep + THREADS - 1) / THREADS);
  const int tiles = ms.nrep * chunks;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      Phase p;
      p.x = phase ? ms.b : ms.a;
      p.o = phase ? ms.a : ms.b;
      p.bits = nullptr;
      p.key = make_uint2(
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2 + 1]));
      p.t4 = ms.t4;
      p.t8 = ms.t8;
      p.t12 = ms.t8;
      p.color = phase;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const long long u =
            static_cast<long long>(t - r * chunks) * THREADS + threadIdx.x;
        const bool live = u < per_rep;
        const int j = live ? static_cast<int>(u % g.units) : 0;
        const int y = live ? static_cast<int>(u / g.units) : 0;
        int m = 0, e = 0;
        if (phase == 0) {
          if (live)
            ising8::update_unit<true, false>(p, ising8::Shard{}, g, r, y, j,
                                             m, e);
        } else {
          if (live)
            ising8::update_unit<true, true>(p, ising8::Shard{}, g, r, y, j,
                                            m, e);
          ising8::block_add(
              m, e,
              ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2);
        }
      }
      grid.sync();
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid: as many as can be resident at once on
// the current device (0 if none fits).
int ising2d_int8_multisweep_grid(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, THREADS, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// S sweeps of a, b (R, ny, half) int8 in place under seeds (S, 2, 2);
// per-sweep (m, e) into obs (R, S, 2) int64, zeroed by the caller.
int ising2d_int8_multisweep(void* a, void* b, const void* seeds, void* obs,
                            int nrep, int ny, int half, int sweeps,
                            unsigned int t4, unsigned int t8, void* stream) {
  const Geometry g = ising8::geometry(1, ny, half);
  if (!ising8::launchable(g, nrep) || sweeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>(nrep) *
      ((ising8::units_per_rep(g) + THREADS - 1) / THREADS);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = ising2d_int8_multisweep_grid(&resident);
  if (err != 0) return err;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = tiles < resident ? static_cast<int>(tiles) : resident;
  Multisweep ms;
  ms.a = static_cast<int8_t*>(a);
  ms.b = static_cast<int8_t*>(b);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.obs = static_cast<long long*>(obs);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.t4 = t4;
  ms.t8 = t8;
  Geometry geo = g;
  void* args[] = {&ms, &geo};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ising2d_int8_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
