// Bit-packed (multispin) checkerboard Metropolis for the 2-D Ising
// model on Hopper (sm_90a): the kernels of the relaxation main path and
// of its domain-decomposed (mesh) form.
//
//   phase_kernel<false> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising2d_multispin.py:_phase_kernel (pallas_call at
//                     :355 _metropolis_phase_packed and :393
//                     phase_packed_with_bits).  One colour phase; a
//                     runtime flag takes injected b4/b8 planes instead of
//                     Philox words, another fuses the exact (m, e).
//   multisweep_kernel replaces ising2d_multispin.py:_ms_kernel (pallas_call
//                     at :495 _multisweep_packed).  S full sweeps with the
//                     (m, e) of every sweep, in one cooperative launch.
//   phase_kernel<true> replaces ising2d_multispin.py:_sharded_phase_kernel
//                     (pallas_call at :783 sharded_phase_packed).  The
//                     same phase on a shard of a (y[, x]) mesh
//                     (parallel/domain.py): the carry into word row 0 is
//                     the exchanged bit of the row above (bit 0 of a 0/1
//                     plane, spliced in at bit 31 as JAX splices it), the
//                     carry out of the last word row the bit below; with
//                     an x split the words left of column 0 and right of
//                     the last are exchanged word columns.  The Philox
//                     counter is (rep0 + r, wrow0 + Y, col0 + X, draw / 4),
//                     the word's global position, so a sharded run equals
//                     the unsharded one bit for bit.  The edge tiles of a
//                     shard may be partial: any shard shape runs.
//
// Layout: (R, nyp, half) int32 planes, one per colour; bit k of word row
// Y is lattice row 32Y+k (ops/ising2d_multispin.pack_color).  What is
// computed, per word of the updated colour:
//   y+-1 neighbours   1-bit funnel shifts carrying from word rows Y-1/Y+1
//   x+-1 neighbours   the words at columns i-1/i+1 (periodic)
//   side select       row parity = bit parity: masks 0xAAAAAAAA/0x55555555
//   count             bit-sliced 4:3 counter -> ones/twos/fours planes
//   B4, B8            20-digit Bernoulli chains over Philox words
//                     (csrc/philox.cuh), digits LSB->MSB, trailing zero
//                     digits skipped
//   flip              ops/ising2d_multispin._flip_plane
// The TPU tiling (8-row granules, pltpu.roll, SMEM seeds, the 128-lane
// obs row) is not carried over.  A block of 32x8 threads owns a tile of
// 8 word rows x 32 words, one thread per word, and loads the other
// colour's tile with its halo rows and columns into shared memory.
//
// Random words: the key is the (s0, s1) Philox key of the (sample, t,
// phase); the counter is (replica, word row, column, draw / 4).  So a
// trajectory depends on neither the block shape, the host chunking nor
// the kernel (phase_kernel pairs and multisweep_kernel give the same
// bits, and so does the plain PyTorch version).
//
// Observables: m and e are exact integers.  Each block reduces its
// words' contributions and adds them with one 64-bit integer atomic per
// tile into an (R, 2) (or (R, S, 2)) int64 buffer.  Integer addition is
// associative, so the order of the atomics cannot change the sums, and
// int64 never wraps at any lattice a card holds: the JAX package's
// tiled_obs mode (its int32 partials above OBS_INT32_MAX_SITES) has no
// counterpart here.
//
// Bound on the H100: integer operations.  A word costs about 11 Philox
// calls per phase at Tc (about 35-40 chain words), some 700 int32
// operations against 12 bytes of traffic; the bytes would allow 10x the
// rate.  The design keeps the state in L2-resident planes and spends no
// shared memory beyond the 1.4 KB halo tile; making Philox cheaper per
// word is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bernoulli.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_Y = 8;   // word rows per tile (blockDim.y)
constexpr int TILE_X = 32;  // words per tile row (blockDim.x, one warp)
constexpr uint32_t ODD_BITS = 0xAAAAAAAAu;
constexpr uint32_t EVEN_BITS = 0x55555555u;

struct PhaseArgs {
  const int32_t* x_in;   // (R, nyp, half) colour being updated
  int32_t* x_out;        // may alias x_in
  const int32_t* o;      // (R, nyp, half) other colour
  const int32_t* b4;     // injected Bernoulli planes, or nullptr
  const int32_t* b8;
  long long* obs;        // (m, e) of replica r at obs[r * obs_stride], or nullptr
  int obs_stride;
  int nyp, half, color;
  uint2 key;             // Philox key of this (sample, t, phase)
  uint32_t q4, q8;       // chain digits: round(p * 2^20)
  // A shard's halos and global offsets (read only by phase_tile<true>):
  const uint32_t* hup;   // (R, 1, half) 0/1: the site above word row 0
  const uint32_t* hdn;   // (R, 1, half) 0/1: the site below the last
  const uint32_t* hlf;   // (R, nyp, 1) word column left of column 0, or null
  const uint32_t* hrt;   // (R, nyp, 1) right of the last, or null
  uint32_t rep0, wrow0, col0;
};

// One tile of one colour phase.  Every thread of the block calls it
// with the same (r, y0, x0); it ends with a barrier, so the caller may
// reuse the shared tile at once.  HALO: the planes are a shard's, whose
// neighbours past word row 0 and the last (and, when hlf is set, past
// column 0 and the last) are its halos, and whose Philox counter is
// offset by (rep0, wrow0, col0); its edge tiles may be partial, so any
// shard shape runs.  Otherwise the planes are periodic and tile whole.
template <bool HALO>
__device__ __forceinline__ void phase_tile(
    const PhaseArgs& a, int r, int y0, int x0,
    uint32_t (&tile)[TILE_Y + 2][TILE_X + 2]) {
  __shared__ int red_m[TILE_Y];
  __shared__ int red_e[TILE_Y];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nyp = a.nyp, half = a.half;
  const size_t base = static_cast<size_t>(r) * nyp * half;
  const uint32_t* o = reinterpret_cast<const uint32_t*>(a.o) + base;
  const int Y = y0 + ty, X = x0 + tx;
  const bool in = !HALO || (Y < nyp && X < half);
  const size_t row = static_cast<size_t>(Y) * half;
  const size_t idx = row + X;

  // __ldcg: the multisweep kernel rewrites the planes between grid
  // barriers, so loads bypass the (non-coherent) L1.  The thread of the
  // last row (column) also loads the row (column) past it, which in a
  // partial tile lies inside the shared tile.
  if (in) {
    tile[ty + 1][tx + 1] = __ldcg(o + idx);
    if (ty == 0)
      tile[0][tx + 1] =
          HALO && y0 == 0
              ? __ldcg(a.hup + static_cast<size_t>(r) * half + X) << 31
              : __ldcg(o + static_cast<size_t>((y0 - 1 + nyp) % nyp) * half +
                       X);
    if (ty == TILE_Y - 1 || (HALO && Y == nyp - 1))
      tile[ty + 2][tx + 1] =
          HALO && Y == nyp - 1
              ? __ldcg(a.hdn + static_cast<size_t>(r) * half + X)
              : __ldcg(o + static_cast<size_t>((Y + 1) % nyp) * half + X);
    const size_t col = static_cast<size_t>(r) * nyp + Y;
    if (tx == 0)
      tile[ty + 1][0] = HALO && x0 == 0 && a.hlf != nullptr
                            ? __ldcg(a.hlf + col)
                            : __ldcg(o + row + (x0 - 1 + half) % half);
    if (tx == TILE_X - 1 || (HALO && X == half - 1))
      tile[ty + 1][tx + 2] = HALO && X == half - 1 && a.hrt != nullptr
                                 ? __ldcg(a.hrt + col)
                                 : __ldcg(o + row + (X + 1) % half);
  }
  __syncthreads();

  int m = 0, e = 0;
  if (in) {
    const uint32_t oc = tile[ty + 1][tx + 1];
    const uint32_t o_prev = tile[ty][tx + 1];
    const uint32_t o_next = tile[ty + 2][tx + 1];
    const uint32_t minus = tile[ty + 1][tx];
    const uint32_t plus = tile[ty + 1][tx + 2];
    const uint32_t x =
        __ldcg(reinterpret_cast<const uint32_t*>(a.x_in) + base + idx);

    const uint32_t up = (oc << 1) | (o_prev >> 31);
    const uint32_t dn = (oc >> 1) | (o_next << 31);
    const uint32_t side = a.color == 0
                              ? (plus & ODD_BITS) | (minus & EVEN_BITS)
                              : (minus & ODD_BITS) | (plus & EVEN_BITS);
    uint32_t ones, twos, fours;
    count4(up, dn, oc, side, ones, twos, fours);

    uint32_t b4, b8;
    if (a.b4 != nullptr) {
      b4 = __ldcg(reinterpret_cast<const uint32_t*>(a.b4) + base + idx);
      b8 = __ldcg(reinterpret_cast<const uint32_t*>(a.b8) + base + idx);
    } else {
      WordStream s(static_cast<uint32_t>(r) + (HALO ? a.rep0 : 0u),
                   static_cast<uint32_t>(Y) + (HALO ? a.wrow0 : 0u),
                   static_cast<uint32_t>(X) + (HALO ? a.col0 : 0u), a.key);
      b4 = bern_word(s, a.q4);
      b8 = bern_word(s, a.q8);
    }
    const uint32_t nw = x ^ flip4(x, ones, twos, fours, b4, b8);
    reinterpret_cast<uint32_t*>(a.x_out)[base + idx] = nw;

    if (a.obs != nullptr) {
      // s = 2*bit - 1, neighbour sum = 2c - 4: this word's 32 sites give
      // m = 2(pc(new) + pc(oc)) - 64 and
      // e = -(4 pc(new & c) - 8 pc(new) - 2 pc(c) + 128)  (every bond once)
      const int s_x = __popc(nw);
      const int s_c = __popc(ones) + 2 * __popc(twos) + 4 * __popc(fours);
      const int s_xc = __popc(nw & ones) + 2 * __popc(nw & twos) +
                       4 * __popc(nw & fours);
      m = 2 * (s_x + __popc(oc)) - 64;
      e = -(4 * s_xc - 8 * s_x - 2 * s_c + 128);
    }
  }

  if (a.obs != nullptr) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      m += __shfl_down_sync(0xFFFFFFFFu, m, off);
      e += __shfl_down_sync(0xFFFFFFFFu, e, off);
    }
    if (tx == 0) {
      red_m[ty] = m;
      red_e[ty] = e;
    }
    __syncthreads();
    if (tx == 0 && ty == 0) {
      long long bm = 0, be = 0;
#pragma unroll
      for (int w = 0; w < TILE_Y; ++w) {
        bm += red_m[w];
        be += red_e[w];
      }
      unsigned long long* dst =
          reinterpret_cast<unsigned long long*>(a.obs) +
          static_cast<size_t>(r) * a.obs_stride;
      atomicAdd(dst, static_cast<unsigned long long>(bm));
      atomicAdd(dst + 1, static_cast<unsigned long long>(be));
    }
  }
  __syncthreads();
}

template <bool HALO>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    phase_kernel(PhaseArgs a) {
  __shared__ uint32_t tile[TILE_Y + 2][TILE_X + 2];
  phase_tile<HALO>(a, blockIdx.z, blockIdx.y * TILE_Y, blockIdx.x * TILE_X,
                   tile);
}

struct MultisweepArgs {
  const int32_t* wa_in;
  const int32_t* wb_in;
  int32_t* wa;           // (R, nyp, half) outputs, updated in place
  int32_t* wb;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, nyp, half, sweeps;
  uint32_t q4, q8;
};

// S sweeps on the whole ensemble.  A 2048^2 replica is 512 KiB, more
// than one SM's shared memory, so the state stays in device memory (the
// reference's 16-replica ensemble, 16 MiB, sits in the 50 MB L2): a
// cooperative grid walks all tiles of a phase, then waits at a
// grid-wide barrier before the next phase reads what it wrote.
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    multisweep_kernel(MultisweepArgs a) {
  __shared__ uint32_t tile[TILE_Y + 2][TILE_X + 2];
  cg::grid_group grid = cg::this_grid();
  const size_t n = static_cast<size_t>(a.nrep) * a.nyp * a.half;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * TILE_X * TILE_Y;
  for (size_t i = blockIdx.x * static_cast<size_t>(TILE_X * TILE_Y) +
                  threadIdx.y * TILE_X + threadIdx.x;
       i < n; i += nthreads) {
    a.wa[i] = a.wa_in[i];
    a.wb[i] = a.wb_in[i];
  }
  grid.sync();

  const int tiles_x = a.half / TILE_X;
  const int tiles_rep = tiles_x * (a.nyp / TILE_Y);
  const int tiles = a.nrep * tiles_rep;
  for (int s = 0; s < a.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      PhaseArgs p{};
      p.x_in = phase ? a.wb : a.wa;
      p.x_out = phase ? a.wb : a.wa;
      p.o = phase ? a.wa : a.wb;
      p.b4 = nullptr;
      p.b8 = nullptr;
      p.obs = phase ? a.obs + 2 * s : nullptr;
      p.obs_stride = 2 * a.sweeps;
      p.nyp = a.nyp;
      p.half = a.half;
      p.color = phase;
      p.key = make_uint2(static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
                         static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]));
      p.q4 = a.q4;
      p.q8 = a.q8;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / tiles_rep;
        const int rem = t - r * tiles_rep;
        const int tyi = rem / tiles_x;
        phase_tile<false>(p, r, tyi * TILE_Y, (rem - tyi * tiles_x) * TILE_X,
                          tile);
      }
      grid.sync();
    }
  }
}

}  // namespace

extern "C" {

// One colour phase: grid (half/32, nyp/8, R) of 32x8 blocks.  b4/b8 are
// injected planes or null (then Philox words under (s0, s1)); obs is an
// (R, 2) int64 buffer zeroed by the caller, or null.
int ising2d_phase(const void* x_in, void* x_out, const void* o,
                  const void* b4, const void* b8, void* obs, int nrep,
                  int nyp, int half, int color, unsigned int s0,
                  unsigned int s1, unsigned int q4, unsigned int q8,
                  void* stream) {
  PhaseArgs a{};
  a.x_in = static_cast<const int32_t*>(x_in);
  a.x_out = static_cast<int32_t*>(x_out);
  a.o = static_cast<const int32_t*>(o);
  a.b4 = static_cast<const int32_t*>(b4);
  a.b8 = static_cast<const int32_t*>(b8);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  a.key = make_uint2(s0, s1);
  a.q4 = q4;
  a.q8 = q8;
  const dim3 grid(half / TILE_X, nyp / TILE_Y, nrep);
  phase_kernel<false><<<grid, dim3(TILE_X, TILE_Y), 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a shard: grid (ceil(half/32), ceil(nyp/8), R).
// hup/hdn are (R, 1, half) 0/1 planes; hlf/hrt (R, nyp, 1) word columns
// or null (no x split); (rep0, wrow0, col0) the shard's global replica,
// word row and word column; b4/b8 injected planes or null; obs an (R, 2)
// int64 buffer zeroed by the caller, or null.
int ising2d_shard_phase(const void* x_in, void* x_out, const void* o,
                        const void* hup, const void* hdn, const void* hlf,
                        const void* hrt, const void* b4, const void* b8,
                        void* obs, int nrep, int nyp, int half, int color,
                        unsigned int rep0, unsigned int wrow0,
                        unsigned int col0, unsigned int s0, unsigned int s1,
                        unsigned int q4, unsigned int q8, void* stream) {
  if (nrep < 1 || nrep > 65535 || nyp < 1 || half < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PhaseArgs a{};
  a.x_in = static_cast<const int32_t*>(x_in);
  a.x_out = static_cast<int32_t*>(x_out);
  a.o = static_cast<const int32_t*>(o);
  a.b4 = static_cast<const int32_t*>(b4);
  a.b8 = static_cast<const int32_t*>(b8);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  a.key = make_uint2(s0, s1);
  a.q4 = q4;
  a.q8 = q8;
  a.hup = static_cast<const uint32_t*>(hup);
  a.hdn = static_cast<const uint32_t*>(hdn);
  a.hlf = static_cast<const uint32_t*>(hlf);
  a.hrt = static_cast<const uint32_t*>(hrt);
  a.rep0 = rep0;
  a.wrow0 = wrow0;
  a.col0 = col0;
  const dim3 grid((half + TILE_X - 1) / TILE_X, (nyp + TILE_Y - 1) / TILE_Y,
                  nrep);
  phase_kernel<true><<<grid, dim3(TILE_X, TILE_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the cooperative multisweep grid: as many as can be resident
// at once on the current device (0 if none fits).
int ising2d_multisweep_grid(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, TILE_X * TILE_Y, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// S sweeps: wa_in/wb_in -> wa/wb, per-sweep (m, e) into obs (R, S, 2),
// zeroed by the caller.  One cooperative launch.
int ising2d_multisweep(const void* wa_in, const void* wb_in, void* wa,
                       void* wb, const void* seeds, void* obs, int nrep,
                       int nyp, int half, int sweeps, unsigned int q4,
                       unsigned int q8, void* stream) {
  int resident = 0;
  int err = ising2d_multisweep_grid(&resident);
  if (err != 0) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = nrep * (nyp / TILE_Y) * (half / TILE_X);
  const int blocks = tiles < resident ? tiles : resident;
  MultisweepArgs a;
  a.wa_in = static_cast<const int32_t*>(wa_in);
  a.wb_in = static_cast<const int32_t*>(wb_in);
  a.wa = static_cast<int32_t*>(wa);
  a.wb = static_cast<int32_t*>(wb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.obs = static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nyp = nyp;
  a.half = half;
  a.sweeps = sweeps;
  a.q4 = q4;
  a.q8 = q8;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(TILE_X, TILE_Y), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ising2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
