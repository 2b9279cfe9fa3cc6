// S int8 q-state clock sweeps in one cooperative launch on Hopper (sm_90a).
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     clock_multisweep.py:_kernel (pallas_call at :127,
//                     _multisweep -> multisweep): S full sweeps (phase a,
//                     then phase b) of (R, ny, half) int8 states, in place,
//                     with each sweep's (Σ cos, Σ sin, E) fused into phase b
//                     as JAX's :87-95 fuses them (each a-b bond once, from
//                     the b site's field), into (R, S, 3) float64.
//
// The TPU kernel keeps one replica in VMEM a grid step.  Here the planes
// stay in device memory (a 1000x1000 ensemble of 16 replicas is 16 MB, in
// the 50 MB L2): a cooperative grid walks every tile of a phase (a tile =
// 256 units of one replica, csrc/clock_int8.cuh) and waits at a grid
// barrier before the next phase reads what it wrote; the loads after a
// barrier bypass L1 (__ldcg).  Sweep s, phase p draws under the key
// seeds[s][p] (ops/multispin_rng.sweep_phase_keys) and the counter of
// phase_kernel (csrc/clock_pallas.cu), so S sweeps here equal S pairs of
// phase_kernel launches, bitwise in the state.  The fused sums are float64
// terms from the float64 table, per tile in a fixed order, then a fixed
// order over a (replica, sweep)'s tiles (xy::reduce_kernel): no float
// atomics.  They equal measure_kernel's right-and-down sums to float64
// rounding.
//
// Bound on the H100: operations.  A launch reads and writes the planes
// once (4 B a site) but runs 2 S phases of ~60 instructions a site and S
// fused sums (chip_smoke.py's count); it saves the host 3 S launches.
#include <cooperative_groups.h>

#include "clock_int8.cuh"

namespace cg = cooperative_groups;

namespace {

using clock8::Geometry;
using clock8::Phase;
using clock8::TABLE;
using clock8::THREADS;

struct Multisweep {
  int8_t* a;             // (R, ny, half), updated in place
  int8_t* b;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  const float* tab;      // (2, 128) float32 (cos, sin)
  const double* tab64;   // (2, 128) float64 (cos, sin)
  double* partials;      // (R, S, chunks, 3)
  int nrep, sweeps, q;
  float neg_beta;
};

__global__ void __launch_bounds__(THREADS)
    multisweep_kernel(Multisweep ms, Geometry g) {
  __shared__ float tc[TABLE], ts[TABLE];
  __shared__ double tc64[TABLE], ts64[TABLE];
  clock8::stage(ms.tab, tc, ts);
  clock8::stage(ms.tab64, tc64, ts64);
  const clock8::Tables tb = {tc, ts, tc64, ts64};
  cg::grid_group grid = cg::this_grid();
  const long long per_rep = clock8::units_per_rep(g);
  const int chunks = static_cast<int>((per_rep + THREADS - 1) / THREADS);
  const int tiles = ms.nrep * chunks;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      Phase p;
      p.x = phase ? ms.b : ms.a;
      p.o = phase ? ms.a : ms.b;
      p.ucand = nullptr;
      p.uacc = nullptr;
      p.key = make_uint2(
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2 + 1]));
      p.neg_beta = ms.neg_beta;
      p.q = ms.q;
      p.color = phase;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const int chunk = t - r * chunks;
        const long long u =
            static_cast<long long>(chunk) * THREADS + threadIdx.x;
        const bool live = u < per_rep;
        const int j = live ? static_cast<int>(u % g.units) : 0;
        const int y = live ? static_cast<int>(u / g.units) : 0;
        xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
        if (phase == 0) {
          if (live)
            clock8::update_unit<true, false>(p, clock8::Shard{}, g, tb, r, y,
                                               j, sums);
        } else {
          if (live)
            clock8::update_unit<true, true>(p, clock8::Shard{}, g, tb, r, y,
                                               j, sums);
          xy::block_sums<3, true>(
              ms.partials, static_cast<size_t>(r) * ms.sweeps + s, chunks,
              chunk, sums);
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
int clock_int8_multisweep_grid(int* blocks) {
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
// tab, tab64 the (2, 128) float32 and float64 tables; partials
// (R, S, chunks, 3) float64 scratch, chunks = ceil(ny * ceil(half / 2) /
// 256); per-sweep (Σ cos, Σ sin, E) into obs (R, S, 3) float64.
int clock_int8_multisweep(void* a, void* b, const void* seeds,
                          const void* tab, const void* tab64, void* partials,
                          void* obs, int nrep, int ny, int half, int q,
                          int sweeps, float neg_beta, void* stream) {
  const Geometry g = clock8::geometry(ny, half);
  if (!clock8::launchable(g, nrep, q) || sweeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks =
      static_cast<int>((clock8::units_per_rep(g) + THREADS - 1) / THREADS);
  const long long tiles = static_cast<long long>(nrep) * chunks;
  if (tiles >= (1LL << 31) ||
      static_cast<long long>(nrep) * sweeps >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = clock_int8_multisweep_grid(&resident);
  if (err != 0) return err;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = tiles < resident ? static_cast<int>(tiles) : resident;
  Multisweep ms;
  ms.a = static_cast<int8_t*>(a);
  ms.b = static_cast<int8_t*>(b);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.tab = static_cast<const float*>(tab);
  ms.tab64 = static_cast<const double*>(tab64);
  ms.partials = static_cast<double*>(partials);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.q = q;
  ms.neg_beta = neg_beta;
  Geometry geo = g;
  void* args[] = {&ms, &geo};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs),
      chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
