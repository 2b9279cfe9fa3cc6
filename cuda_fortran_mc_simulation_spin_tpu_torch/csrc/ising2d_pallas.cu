// The int8 2-D Ising checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel<false, ., .> replaces cuda_fortran_mc_simulation_spin_tpu/
//                ops/ising2d_pallas.py:_phase_kernel (pallas_call at :126,
//                _metropolis_phase).  One colour phase of (R, ny, half)
//                int8 planes, in place; its random words from Philox, or
//                injected (R, ny, half) uint32 words (INJECT, the mode the
//                checks use, as JAX's sharded_phase takes bits= at :397).
//   phase_kernel<true, ., .> replaces ising2d_pallas.py:_halo_phase_kernel
//                (pallas_call at :397, sharded_phase).  The same phase on a
//                shard of a (y[, x]) mesh (parallel/domain.py): rows, and
//                with an x split columns, past the shard's edges come from
//                the exchanged halos; parity and the Philox counter from
//                global coordinates, so a shard draws what the whole
//                lattice draws and a sharded run equals the unsharded one
//                bit for bit.  A unit is a global unit of four columns:
//                at an x offset col0 % 4 != 0 a shard's rows start their
//                words col0 % 4 columns early, and its neighbour draws the
//                same Philox call for the other columns.  MEASURE adds the
//                shard's exact int64 (m, e) partials (phase b).
//
// One tile a block, on the tile body of the cooperative multisweep
// (csrc/ising_int8.cuh tile, whose header gives the site rule, the word
// layout and the staging): `rows` whole rows of one replica (up to
// ops/ising2d_pallas.TILE_BYTES of sites), or past MAX_COLUMNS columns
// one row's chunk, staged by cp.async (csrc/byte_tiles.cuh), four sites
// a 32-bit word by byte-SIMD, one Philox call a word under round keys
// taken once a launch on the host, each new word stored to the plane by
// its thread (DIRECT: no second barrier and no write-back; 5-14% faster
// at 1000^2 x 1, where the launch is one wave of one-word blocks, and 2%
// at 4000^2 x 8, PERF.md §6).  A grid (chunks, row tiles,
// replicas), the row tiles past the grid's y extent walked gridDim.y
// apart: no division, and no grid barrier, since a phase reads only the
// other colour and its own site.  In place: the updated colour is
// written where it is read, as the TPU kernel aliases it.  Every even nx
// and ny runs (JAX's nx/2 % 128 and ny % 32 tiling gates are TPU
// artefacts); ops/ising2d_pallas.phase_tiles computes the constants
// (ops/ising2d_multisweep.ms_tiles), the entry points take them as
// passed after tiles8::row_tiles_ok.
//
// Bound on the H100: bytes.  A site of the colour updated moves 3 B (its
// own byte read and written, the other colour's read once) and costs
// 26.5 instructions (a quarter of its unit's Philox4x32-10 call, 58, and
// 12 for the stencil, the compare and the flip), chip_smoke.py's count:
// at 4000^2 x 8, 0.0573 ms by bytes (3.35 TB/s) against 0.0507 ms by
// operations (33.4 T/s).  The first design, one thread a unit over device
// memory with a 64-bit / and % a thread, six scalar byte accesses a site
// and the round keys recomputed in every Philox call, ran at 27% of it
// (PERF.md §6).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "byte_tiles.cuh"
#include "ising_int8.cuh"
#include "philox.cuh"

namespace {

using ising8::THREADS;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

constexpr int MAX_GRID = 65535;

struct Args {
  int8_t* x;             // colour being updated, in place
  const int8_t* o;       // the other colour
  const uint32_t* bits;  // INJECT: words (R, ny, half)
  const int8_t* up;      // HALO: (R, 1, half), the row above row 0
  const int8_t* dn;      // HALO: (R, 1, half), the row below the last
  const int8_t* lf;      // HALO: (R, ny, 1), the column left of column 0,
  const int8_t* rt;      // and right of the last; null: periodic in x
  long long* obs;        // MEASURE: (R, 2) int64 (m, e), zeroed
  uint2 rk[10];          // Philox round keys of the phase key
  uint32_t t4, t8;       // t8 <= t4
  int ny, half, color;
  int rep0, row0, col0;  // HALO: the shard's global offsets
  tiles8::RowTiles t;
};

// One colour phase: a grid of (chunks, min(row tiles, 65535), replicas)
// blocks of THREADS, a.t.smem bytes of dynamic shared memory.  Four
// blocks an SM under the bound (64 registers).
template <bool HALO, bool MEASURE, bool INJECT>
__global__ void __launch_bounds__(THREADS, 4) phase_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int r = blockIdx.z;
  for (int yt = blockIdx.y; yt < a.t.nty; yt += gridDim.y)
    ising8::tile<MEASURE, HALO, INJECT, true>(
        a, sm, a.rk, a.x, a.o, a.color, r, yt, blockIdx.x,
        [&] { return a.obs + 2 * static_cast<size_t>(r); });
}

// The launch's arguments; false if the geometry, the thresholds or the
// tiles cannot run
bool make_args(Args& a, void* x, const void* o, const void* bits, int nrep,
               int ny, int half, int color, unsigned s0, unsigned s1,
               unsigned t4, unsigned t8, const int* tiles) {
  a = Args{};
  std::memcpy(&a.t, tiles, sizeof(tiles8::RowTiles));
  if (!ising8::launchable(ising8::geometry(1, ny, half), nrep) || t8 > t4 ||
      !tiles8::row_tiles_ok(a.t, ny, half))
    return false;
  a.x = static_cast<int8_t*>(x);
  a.o = static_cast<const int8_t*>(o);
  a.bits = static_cast<const uint32_t*>(bits);
  philox_round_keys(s0, s1, a.rk);
  a.t4 = t4;
  a.t8 = t8;
  a.ny = ny;
  a.half = half;
  a.color = color;
  return true;
}

template <bool HALO, bool MEASURE>
int launch(const Args& a, int nrep, cudaStream_t st) {
  const dim3 grid(a.t.nch, std::min(a.t.nty, MAX_GRID), nrep);
  if (a.bits != nullptr)
    phase_kernel<HALO, MEASURE, true><<<grid, THREADS, a.t.smem, st>>>(a);
  else
    phase_kernel<HALO, MEASURE, false><<<grid, THREADS, a.t.smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One colour phase of x (R, ny, half) int8 in place given o; bits is
// (R, ny, half) uint32 or null (then Philox words under (s0, s1)); t4 >=
// t8 the thresholds; tiles the 10 ints of ops/ising2d_pallas.phase_tiles.
int ising2d_int8_phase(void* x, const void* o, const void* bits, int nrep,
                       int ny, int half, int color, unsigned int s0,
                       unsigned int s1, unsigned int t4, unsigned int t8,
                       const int* tiles, void* stream) {
  Args a;
  if (!make_args(a, x, o, bits, nrep, ny, half, color, s0, s1, t4, t8,
                 tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, false>(a, nrep, static_cast<cudaStream_t>(stream));
}

// One colour phase of a shard x (R, ny, half) int8 in place given o and
// the halos up, dn (R, 1, half) and lf, rt (R, ny, 1) or both null;
// (rep0, row0, col0) the shard's global offsets; obs an (R, 2) int64
// buffer zeroed by the caller, or null.
int ising2d_int8_halo_phase(void* x, const void* o, const void* bits,
                            const void* up, const void* dn, const void* lf,
                            const void* rt, void* obs, int nrep, int ny,
                            int half, int color, int rep0, int row0,
                            int col0, unsigned int s0, unsigned int s1,
                            unsigned int t4, unsigned int t8,
                            const int* tiles, void* stream) {
  Args a;
  // the global unit, row and replica of every site fit an int
  if (!make_args(a, x, o, bits, nrep, ny, half, color, s0, s1, t4, t8,
                 tiles) ||
      rep0 < 0 || row0 < 0 || col0 < 0 ||
      static_cast<long long>(rep0) + nrep >= (1LL << 31) ||
      static_cast<long long>(row0) + ny >= (1LL << 31) ||
      static_cast<long long>(col0) + half >= (1LL << 31) ||
      up == nullptr || dn == nullptr || (lf == nullptr) != (rt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.up = static_cast<const int8_t*>(up);
  a.dn = static_cast<const int8_t*>(dn);
  a.lf = static_cast<const int8_t*>(lf);
  a.rt = static_cast<const int8_t*>(rt);
  a.obs = static_cast<long long*>(obs);
  a.rep0 = rep0;
  a.row0 = row0;
  a.col0 = col0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return obs != nullptr ? launch<true, true>(a, nrep, st)
                        : launch<true, false>(a, nrep, st);
}

const char* ising2d_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
