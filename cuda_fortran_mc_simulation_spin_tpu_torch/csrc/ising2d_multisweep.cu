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
// tile of a phase and waits at a grid barrier before the next phase reads
// what it wrote.  Sweep s, phase p draws under the key seeds[s][p]
// (ops/multispin_rng.sweep_phase_keys), its round keys taken once a
// phase, and the counter of phase_kernel (csrc/ising2d_pallas.cu,
// csrc/ising_int8.cuh): unit j of row y, sites 4j .. 4j + 3, one
// Philox4x32-10 call at (replica, y, j, 0), site 4j + k taking output k.
// So S sweeps here equal S pairs of phase_kernel launches and
// measure_kernel (csrc/ising2d_measure_pallas.cu), bitwise.
//
// Tiles (csrc/byte_tiles.cuh RowTiles; ops/ising2d_multisweep.ms_tiles
// computes the constants, the entry point takes them as passed), the
// int8 clock multisweep's (csrc/clock_multisweep.cu).  A tile is `rows`
// whole rows of one replica (past MAX_COLUMNS columns one row's chunk),
// staged in shared memory by cp.async and updated four sites a 32-bit
// word by byte-SIMD: csrc/ising_int8.cuh tile, the body the int8 phase
// kernel (csrc/ising2d_pallas.cu) runs one tile a block, whose header
// gives the staging, the windows and the rule.  Here blocks walk the
// tiles replica major, gridDim.x apart, by carries: no division in the
// walk; phase b adds each sweep's fused (m, e) per tile by
// ising8::block_add (int64 atomics, exact in any order).
//
// Bound on the H100: operations.  A launch reads and writes the planes
// once (4 B a site) but runs 2 S phases of 26.5 instructions a site and S
// fused sums of 4 (chip_smoke.py's count); it saves the host's launches
// of 3 S kernels and keeps the planes in L2.  The first design, one thread
// a unit with 64-bit divisions, five byte loads from L2 a site and the
// round keys recomputed in every Philox call, ran at 14% of it; this one
// at 27%, with 64 registers and 4 blocks an SM, one a tile of the class's
// 512 (with the round keys in registers 80 and 3, and 44% slower; PERF.md
// §6).
#include <cooperative_groups.h>

#include <cstring>

#include "byte_tiles.cuh"
#include "ising_int8.cuh"

namespace cg = cooperative_groups;

namespace {

using ising8::THREADS;
using tiles8::RowTiles;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

struct Multisweep {
  int8_t* a;             // (R, ny, half), updated in place
  int8_t* b;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, ny, half, sweeps;
  uint32_t t4, t8;
  int step[3];           // the walk's steps (tiles8::row_tile_steps)
  RowTiles t;
};

__global__ void __launch_bounds__(THREADS) multisweep_kernel(Multisweep ms) {
  extern __shared__ __align__(16) uint8_t sm[];
  cg::grid_group grid = cg::this_grid();
  const RowTiles& t = ms.t;
  // the block's first tile (r, yt, cx): block b of the walk
  const int per_rep = t.nty * t.nch;
  const int r0 = blockIdx.x / per_rep;
  const int rest = blockIdx.x - r0 * per_rep;
  const int yt0 = rest / t.nch;
  const int cx0 = rest - yt0 * t.nch;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      int8_t* x = phase ? ms.b : ms.a;
      const int8_t* o = phase ? ms.a : ms.b;
      // the phase's round keys in shared memory (in registers they took
      // 16 more and a block an SM, PERF.md §6); the tile's first barrier
      // comes before they are read, the last grid barrier after the last
      // read of the phase before
      __shared__ uint2 rk[10];
      if (threadIdx.x == 0)
        philox_round_keys(
            static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2]),
            static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2 + 1]), rk);
      int r = r0, yt = yt0, cx = cx0;
      while (r < ms.nrep) {
        // phase b adds sweep s's fused (m, e) of replica r
        const auto dst = [&] {
          return ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2;
        };
        if (phase)
          ising8::tile<true, false, false>(ms, sm, rk, x, o, 1, r, yt, cx,
                                           dst);
        else
          ising8::tile<false, false, false>(ms, sm, rk, x, o, 0, r, yt, cx,
                                            dst);
        tiles8::next_row_tile(t, ms.step, r, yt, cx);
      }
      grid.sync();
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid for the tiles (the 10 ints of
// ops/ising2d_multisweep.ms_tiles): as many as can be resident at once on
// the current device with the tile's shared memory (0 if none fits).
int ising2d_int8_multisweep_grid(const int* tiles, int* blocks) {
  RowTiles t;
  std::memcpy(&t, tiles, sizeof(RowTiles));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, THREADS, t.smem);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// S sweeps of a, b (R, ny, half) int8 in place under seeds (S, 2, 2);
// per-sweep (m, e) into obs (R, S, 2) int64, zeroed by the caller; t4 >=
// t8 the thresholds; tiles the 10 ints of ops/ising2d_multisweep.ms_tiles.
int ising2d_int8_multisweep(void* a, void* b, const void* seeds, void* obs,
                            int nrep, int ny, int half, int sweeps,
                            unsigned int t4, unsigned int t8,
                            const int* tiles, void* stream) {
  const ising8::Geometry g = ising8::geometry(1, ny, half);
  Multisweep ms{};
  std::memcpy(&ms.t, tiles, sizeof(RowTiles));
  if (!ising8::launchable(g, nrep) || sweeps < 1 || t8 > t4 ||
      !tiles8::row_tiles_ok(ms.t, ny, half))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(nrep) * ms.t.nty * ms.t.nch;
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = ising2d_int8_multisweep_grid(tiles, &resident);
  if (err != 0) return err;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = total < resident ? static_cast<int>(total) : resident;
  ms.a = static_cast<int8_t*>(a);
  ms.b = static_cast<int8_t*>(b);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.obs = static_cast<long long*>(obs);
  ms.nrep = nrep;
  ms.ny = ny;
  ms.half = half;
  ms.sweeps = sweeps;
  ms.t4 = t4;
  ms.t8 = t8;
  tiles8::row_tile_steps(ms.t, blocks, ms.step);
  void* args[] = {&ms};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, static_cast<size_t>(ms.t.smem),
      static_cast<cudaStream_t>(stream));
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
