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
//                     (bernoulli.cuh chain_planes from the launch's
//                     ChainTable of (q4, q8, 0): the third chain draws
//                     nothing), digits LSB->MSB, trailing zero digits
//                     skipped
//   flip              ops/ising2d_multispin._flip_plane
// The TPU tiling (8-row granules, pltpu.roll, SMEM seeds, the 128-lane
// obs row) is not carried over: one thread a word, blocks of 32 x 8
// threads (a warp along x, so loads coalesce), every neighbour word read
// from device memory (L2 hits; the kernels are bound by Philox, not
// bytes).
//
// Random words: the key is the (s0, s1) Philox key of the (sample, t,
// phase); the counter is (replica, word row, column, draw / 4).  So a
// trajectory depends on neither the block shape, the host chunking nor
// the kernel (phase_kernel pairs and multisweep_kernel give the same
// bits, and so does the plain PyTorch version).
//
// Observables: m and e are exact integers.  A measuring block reduces its
// words' contributions and adds them with one 64-bit integer atomic per
// replica and observable into an (R, 2) (or (R, S, 2)) int64 buffer.
// Integer addition is associative, so the order of the atomics cannot
// change the sums, and int64 never wraps at any lattice a card holds: the
// JAX package's tiled_obs mode (its int32 partials above
// OBS_INT32_MAX_SITES) has no counterpart here.
//
// Bound on the H100: integer operations.  At Tc the two chains draw ~39
// Philox words a word and phase (10 calls, ~400 int32 operations with the
// round keys a launch constant) against 12 bytes of traffic.  The design
// (that of csrc/ising3d_multispin.cu) spends little beside them:
// - the chains are bernoulli.cuh's unrolled chain_planes, from the
//   launch's ChainTable and Philox round keys (kernel parameters, or
//   computed once a (sweep, phase) in the multisweep), not bern_word's
//   runtime loop, refill test and buffer pick (~12-16 instructions a draw)
//   and per-call round-key bumps;
// - no runtime division in a phase: neighbours wrap by compare and
//   select; phase_kernel's grid is (column tiles, row groups, replicas),
//   each thread walking word rows Y, Y + 8 gridDim.y, ...; the multisweep
//   decodes its block's first tile once a launch and steps through its
//   tiles with carries; indices are 32-bit (the wrappers refuse planes of
//   2^31 words or more);
// - a measuring block adds its sums once a replica, from shared memory
//   double-buffered across calls: one barrier and two atomics a block and
//   replica, where the first design took two barriers and two atomics a
//   256-word tile, and the halo loads of a shared tile four runtime %
//   wraps;
// - the multisweep's grid is the resident one, each block taking `per`
//   whole tiles (ops/ising2d_multispin.multisweep_grid: the fewest tiles
//   on the busiest SM).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "bernoulli.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_Y = 8;   // word rows per tile (blockDim.y)
constexpr int TILE_X = 32;  // words per tile row (blockDim.x, one warp)
constexpr int MAX_GRID = 65535;  // gridDim.y and gridDim.z
constexpr uint32_t ODD_BITS = 0xAAAAAAAAu;
constexpr uint32_t EVEN_BITS = 0x55555555u;

struct PhaseArgs {
  const uint32_t* x_in;  // (R, nyp, half) colour being updated
  uint32_t* x_out;       // may alias x_in
  const uint32_t* o;     // (R, nyp, half) other colour
  const uint32_t* b4;    // injected Bernoulli planes, or nullptr
  const uint32_t* b8;
  long long* obs;        // (m, e) of replica r at obs[r * obs_stride], or null
  int obs_stride;
  int nrep, nyp, half, color;
  // A shard's halos and global offsets (read only by phase_word<true>):
  const uint32_t* hup;   // (R, 1, half) 0/1: the site above word row 0
  const uint32_t* hdn;   // (R, 1, half) 0/1: the site below the last
  const uint32_t* hlf;   // (R, nyp, 1) word column left of column 0, or null
  const uint32_t* hrt;   // (R, nyp, 1) right of the last, or null
  uint32_t rep0, wrow0, col0;
};

// The launch's chains: the table (bernoulli.cuh) and the Philox round
// keys of the phase key (philox_round_keys)
struct Chains {
  uint2 rk[10];
  ChainTable table;
};

// One word (X, Y) of replica r (X < half, Y < nyp) of one colour phase,
// its (m, e) added to (m, e) where a.obs is set.  HALO: the planes are a
// shard's, whose neighbours past word row 0 and the last (and, when hlf
// is set, past column 0 and the last) are its halos, and whose Philox
// counter is offset by (rep0, wrow0, col0).  Otherwise the planes are
// periodic.  t, rk: the launch's chains (chain_planes).
template <bool HALO>
__device__ __forceinline__ void phase_word(const PhaseArgs& a,
                                           const ChainTable& t,
                                           const uint2 (&rk)[10], int X,
                                           int Y, int r, int& m, int& e) {
  const int nyp = a.nyp, half = a.half;
  const int row = (r * nyp + Y) * half;
  const int idx = row + X;
  const int yu = (Y == 0 ? nyp : Y) - 1;
  const int yd = Y == nyp - 1 ? 0 : Y + 1;
  const int xm = (X == 0 ? half : X) - 1;
  const int xp = X == half - 1 ? 0 : X + 1;
  const int col = r * nyp + Y;  // a halo column's word
  // __ldcg: the multisweep kernel rewrites the planes between grid
  // barriers, so loads bypass the (non-coherent) L1.
  const uint32_t* o = a.o;
  const uint32_t oc = __ldcg(o + idx);
  const uint32_t o_prev = HALO && Y == 0
                              ? __ldcg(a.hup + r * half + X) << 31
                              : __ldcg(o + idx + (yu - Y) * half);
  const uint32_t o_next = HALO && Y == nyp - 1
                              ? __ldcg(a.hdn + r * half + X)
                              : __ldcg(o + idx + (yd - Y) * half);
  const uint32_t minus = HALO && X == 0 && a.hlf != nullptr
                             ? __ldcg(a.hlf + col)
                             : __ldcg(o + row + xm);
  const uint32_t plus = HALO && X == half - 1 && a.hrt != nullptr
                            ? __ldcg(a.hrt + col)
                            : __ldcg(o + row + xp);
  const uint32_t x = __ldcg(a.x_in + idx);

  const uint32_t up = (oc << 1) | (o_prev >> 31);
  const uint32_t dn = (oc >> 1) | (o_next << 31);
  const uint32_t side = a.color == 0 ? (plus & ODD_BITS) | (minus & EVEN_BITS)
                                     : (minus & ODD_BITS) | (plus & EVEN_BITS);
  uint32_t ones, twos, fours;
  count4(up, dn, oc, side, ones, twos, fours);

  uint32_t b4, b8;
  if (a.b4 != nullptr) {
    b4 = __ldcg(a.b4 + idx);
    b8 = __ldcg(a.b8 + idx);
  } else {
    uint32_t unused;  // the third chain of (q4, q8, 0): always zero
    chain_planes(t, rk, static_cast<uint32_t>(r) + (HALO ? a.rep0 : 0u),
                 static_cast<uint32_t>(Y) + (HALO ? a.wrow0 : 0u),
                 static_cast<uint32_t>(X) + (HALO ? a.col0 : 0u), b4, b8,
                 unused);
  }
  const uint32_t nw = x ^ flip4(x, ones, twos, fours, b4, b8);
  a.x_out[idx] = nw;

  if (a.obs != nullptr) {
    // s = 2*bit - 1, neighbour sum = 2c - 4: this word's 32 sites give
    // m = 2(pc(new) + pc(oc)) - 64 and
    // e = -(4 pc(new & c) - 8 pc(new) - 2 pc(c) + 128)  (every bond once)
    const int s_x = __popc(nw);
    const int s_c = __popc(ones) + 2 * __popc(twos) + 4 * __popc(fours);
    const int s_xc = __popc(nw & ones) + 2 * __popc(nw & twos) +
                     4 * __popc(nw & fours);
    m += 2 * (s_x + __popc(oc)) - 64;
    e -= 4 * s_xc - 8 * s_x - 2 * s_c + 128;
  }
}

// The block's (m, e) added to dst[0], dst[1] with one 64-bit atomic each;
// every thread of the block calls it.  red is double-buffered: buf
// alternates between the calls of one launch, so a call needs no barrier
// after thread 0's read (the next call's barrier comes after it, and the
// one after that writes the other buffer).
__device__ __forceinline__ void block_add(int m, int e, long long* dst,
                                          int buf) {
  __shared__ long long red[2][2][TILE_Y];
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    m += __shfl_down_sync(0xFFFFFFFFu, m, off);
    e += __shfl_down_sync(0xFFFFFFFFu, e, off);
  }
  if (tx == 0) {
    red[buf][0][ty] = m;
    red[buf][1][ty] = e;
  }
  __syncthreads();
  if (tx == 0 && ty == 0) {
    long long bm = 0, be = 0;
#pragma unroll
    for (int w = 0; w < TILE_Y; ++w) {
      bm += red[buf][0][w];
      be += red[buf][1][w];
    }
    unsigned long long* d = reinterpret_cast<unsigned long long*>(dst);
    atomicAdd(d, static_cast<unsigned long long>(bm));
    atomicAdd(d + 1, static_cast<unsigned long long>(be));
  }
}

// One colour phase: a grid of (ceil(half / 32), row groups, min(R,
// 65535)) blocks of 32 x 8 threads; block (bx, by, br) takes column tile
// bx of replicas br, br + gridDim.z, ..., thread row ty the word rows
// 8 by + ty, + 8 gridDim.y, ...  HALO: the edge tiles may be partial.
template <bool HALO>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    phase_kernel(PhaseArgs a, Chains c) {
  const int X = blockIdx.x * TILE_X + threadIdx.x;
  const bool active = !HALO || X < a.half;
  const int step = gridDim.y * TILE_Y;
  int buf = 0;
  for (int r = blockIdx.z; r < a.nrep; r += gridDim.z) {
    int m = 0, e = 0;
    for (int Y = blockIdx.y * TILE_Y + threadIdx.y; active && Y < a.nyp;
         Y += step)
      phase_word<HALO>(a, c.table, c.rk, X, Y, r, m, e);
    if (a.obs != nullptr) {  // uniform
      block_add(m, e, a.obs + static_cast<size_t>(r) * a.obs_stride, buf);
      buf ^= 1;
    }
  }
}

struct MultisweepArgs {
  const uint32_t* wa_in;
  const uint32_t* wb_in;
  uint32_t* wa;          // (R, nyp, half) outputs, updated in place
  uint32_t* wb;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, nyp, half, sweeps;
  int per;               // tiles a block: tiles [b per, (b + 1) per)
  ChainTable table;      // the chains of every phase (the digits' table)
};

// S sweeps on the whole ensemble.  A 2048^2 replica is 512 KiB, more
// than one SM's shared memory, so the state stays in device memory (the
// reference's 16-replica ensemble, 16 MiB, sits in the 50 MB L2): a
// cooperative grid walks all tiles (8 word rows x 32 words of a replica,
// x fastest, then y, then the replica) of a phase, block b its `per`
// tiles from tile b per on, then waits at a grid-wide barrier before the
// next phase reads what it wrote.  The block's first tile is decoded with
// division once a launch.
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    multisweep_kernel(MultisweepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.nrep * a.nyp * a.half;
  const int nthreads = gridDim.x * TILE_X * TILE_Y;
  for (int i = blockIdx.x * TILE_X * TILE_Y + threadIdx.y * TILE_X +
               threadIdx.x;
       i < n; i += nthreads) {
    a.wa[i] = a.wa_in[i];
    a.wb[i] = a.wb_in[i];
  }
  grid.sync();

  const int tiles_x = a.half / TILE_X, tiles_y = a.nyp / TILE_Y;
  const int tiles_rep = tiles_x * tiles_y;
  const int first = blockIdx.x * a.per;
  const int count = min(a.per, a.nrep * tiles_rep - first);
  const int r0 = first / tiles_rep;
  const int ty0 = (first - r0 * tiles_rep) / tiles_x;
  const int tx0 = first - r0 * tiles_rep - ty0 * tiles_x;
  int buf = 0;
  for (int s = 0; s < a.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      PhaseArgs p{};
      p.x_in = phase ? a.wb : a.wa;
      p.x_out = phase ? a.wb : a.wa;
      p.o = phase ? a.wa : a.wb;
      p.obs = phase ? a.obs + 2 * s : nullptr;
      p.obs_stride = 2 * a.sweeps;
      p.nrep = a.nrep;
      p.nyp = a.nyp;
      p.half = a.half;
      p.color = phase;
      uint2 rk[10];
      philox_round_keys(
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]), rk);
      int r = r0, ty = ty0, tx = tx0, m = 0, e = 0;
      bool pending = false;  // sums of replica r not yet added (uniform)
      for (int k = 0; k < count; ++k) {
        phase_word<false>(p, a.table, rk, tx * TILE_X + threadIdx.x,
                          ty * TILE_Y + threadIdx.y, r, m, e);
        pending = true;
        if (++tx == tiles_x) {
          tx = 0;
          if (++ty == tiles_y) {
            ty = 0;
            if (phase) {
              block_add(m, e, p.obs + static_cast<size_t>(r) * p.obs_stride,
                        buf);
              buf ^= 1;
              m = e = 0;
            }
            pending = false;
            ++r;
          }
        }
      }
      if (phase && pending) {
        block_add(m, e, p.obs + static_cast<size_t>(r) * p.obs_stride, buf);
        buf ^= 1;
      }
      grid.sync();
    }
  }
}

Chains make_chains(unsigned int s0, unsigned int s1,
                   const unsigned int* chain) {
  Chains c;
  philox_round_keys(s0, s1, c.rk);
  std::memcpy(&c.table, chain, sizeof(ChainTable));
  return c;
}

// Row groups of a phase grid: a thread takes `rows` word rows, the most of
// 1, 2, 4, 8 that still leaves MIN_BLOCKS blocks (a few waves of resident
// blocks), so a measuring block adds its sums for several tiles at once.
constexpr long long MIN_BLOCKS = 4096;

dim3 phase_grid(int nrep, int nyp, int half) {
  const int tiles_x = (half + TILE_X - 1) / TILE_X;
  const int tiles_y = (nyp + TILE_Y - 1) / TILE_Y;
  const int reps = nrep < MAX_GRID ? nrep : MAX_GRID;
  int gy = tiles_y;
  for (int rows = 8; rows > 1; rows >>= 1) {
    const int g = (tiles_y + rows - 1) / rows;
    if (static_cast<long long>(tiles_x) * g * reps >= MIN_BLOCKS) {
      gy = g;
      break;
    }
  }
  return dim3(tiles_x, gy < MAX_GRID ? gy : MAX_GRID, reps);
}

bool shape_ok(int nrep, int nyp, int half) {
  return nrep >= 1 && nyp >= 1 && half >= 1 &&
         static_cast<long long>(nrep) * nyp * half < (1LL << 31);
}

PhaseArgs make_args(const void* x_in, void* x_out, const void* o,
                    const void* b4, const void* b8, void* obs, int nrep,
                    int nyp, int half, int color) {
  PhaseArgs a{};
  a.x_in = static_cast<const uint32_t*>(x_in);
  a.x_out = static_cast<uint32_t*>(x_out);
  a.o = static_cast<const uint32_t*>(o);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nrep = nrep;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  return a;
}

}  // namespace

extern "C" {

// One colour phase (phase_kernel<false>).  b4/b8 are injected planes or
// null (then Philox words under (s0, s1) and the chain table `chain`, the
// 65 words of ChainTable); obs is an (R, 2) int64 buffer zeroed by the
// caller, or null.  nyp % 8 == 0 and half % 32 == 0; fewer than 2^31
// words a plane.
int ising2d_phase(const void* x_in, void* x_out, const void* o,
                  const void* b4, const void* b8, void* obs, int nrep,
                  int nyp, int half, int color, unsigned int s0,
                  unsigned int s1, const unsigned int* chain, void* stream) {
  const Chains c = make_chains(s0, s1, chain);
  if (!shape_ok(nrep, nyp, half) || nyp % TILE_Y != 0 ||
      half % TILE_X != 0 || !chain_table_ok(c.table))
    return static_cast<int>(cudaErrorInvalidValue);
  const PhaseArgs a =
      make_args(x_in, x_out, o, b4, b8, obs, nrep, nyp, half, color);
  phase_kernel<false><<<phase_grid(nrep, nyp, half), dim3(TILE_X, TILE_Y),
                        0, static_cast<cudaStream_t>(stream)>>>(a, c);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a shard (phase_kernel<true>).  hup/hdn are (R, 1,
// half) 0/1 planes; hlf/hrt (R, nyp, 1) word columns or null (no x
// split); (rep0, wrow0, col0) the shard's global replica, word row and
// word column; b4/b8 injected planes or null; chain as for ising2d_phase;
// obs an (R, 2) int64 buffer zeroed by the caller, or null.  Any shape of
// fewer than 2^31 words.
int ising2d_shard_phase(const void* x_in, void* x_out, const void* o,
                        const void* hup, const void* hdn, const void* hlf,
                        const void* hrt, const void* b4, const void* b8,
                        void* obs, int nrep, int nyp, int half, int color,
                        unsigned int rep0, unsigned int wrow0,
                        unsigned int col0, unsigned int s0, unsigned int s1,
                        const unsigned int* chain, void* stream) {
  const Chains c = make_chains(s0, s1, chain);
  if (!shape_ok(nrep, nyp, half) || !chain_table_ok(c.table))
    return static_cast<int>(cudaErrorInvalidValue);
  PhaseArgs a =
      make_args(x_in, x_out, o, b4, b8, obs, nrep, nyp, half, color);
  a.hup = static_cast<const uint32_t*>(hup);
  a.hdn = static_cast<const uint32_t*>(hdn);
  a.hlf = static_cast<const uint32_t*>(hlf);
  a.hrt = static_cast<const uint32_t*>(hrt);
  a.rep0 = rep0;
  a.wrow0 = wrow0;
  a.col0 = col0;
  phase_kernel<true><<<phase_grid(nrep, nyp, half), dim3(TILE_X, TILE_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(a, c);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the cooperative multisweep grid that can be resident at once
// on the current device (0 if none fits), and its SMs.
int ising2d_multisweep_grid(int* blocks, int* sms) {
  int dev = 0, per_sm = 0;
  *sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, TILE_X * TILE_Y, 0);
  *blocks = per_sm * *sms;
  return static_cast<int>(e);
}

// S sweeps: wa_in/wb_in -> wa/wb, per-sweep (m, e) into obs (R, S, 2),
// zeroed by the caller; chain the table of ising2d_phase.  One
// cooperative launch of `blocks` blocks, each taking `per` tiles
// (ops/ising2d_multispin.multisweep_grid); blocks must be resident at
// once and blocks * per cover the R (nyp / 8) (half / 32) tiles.
int ising2d_multisweep(const void* wa_in, const void* wb_in, void* wa,
                       void* wb, const void* seeds, void* obs, int nrep,
                       int nyp, int half, int sweeps, int blocks, int per,
                       const unsigned int* chain, void* stream) {
  int resident = 0, sms = 0;
  int err = ising2d_multisweep_grid(&resident, &sms);
  if (err != 0) return err;
  MultisweepArgs a;
  std::memcpy(&a.table, chain, sizeof(ChainTable));
  const long long tiles =
      static_cast<long long>(nrep) * (nyp / TILE_Y) * (half / TILE_X);
  if (!shape_ok(nrep, nyp, half) || nyp % TILE_Y != 0 ||
      half % TILE_X != 0 || sweeps < 1 || !chain_table_ok(a.table) ||
      blocks < 1 || per < 1 || static_cast<long long>(blocks) * per < tiles ||
      static_cast<long long>(blocks - 1) * per >= tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  a.wa_in = static_cast<const uint32_t*>(wa_in);
  a.wb_in = static_cast<const uint32_t*>(wb_in);
  a.wa = static_cast<uint32_t*>(wa);
  a.wb = static_cast<uint32_t*>(wb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.obs = static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nyp = nyp;
  a.half = half;
  a.sweeps = sweeps;
  a.per = per;
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
