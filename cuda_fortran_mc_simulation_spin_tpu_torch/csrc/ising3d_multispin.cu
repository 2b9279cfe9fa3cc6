// Bit-packed (multispin) checkerboard Metropolis for the 3-D Ising model
// on Hopper (sm_90a): the kernels of the periodic 3-D relaxation and of
// its domain-decomposed (mesh) form.
//
//   phase_kernel<false> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising3d_multispin.py:_phase_kernel (pallas_call at
//                     :227 _metropolis_phase3d and :258
//                     phase3d_packed_with_bits).  One colour phase; a
//                     runtime flag takes injected b4/b8/b12 planes instead
//                     of Philox words, another fuses the exact (m, e).
//   multisweep_kernel replaces ising3d_multispin.py:_ms3_kernel
//                     (pallas_call at :409 _multisweep_packed3d).  S full
//                     sweeps with the (m, e) of every sweep, in one
//                     cooperative launch.
//   phase_kernel<true> replaces ising3d_multispin.py:_sharded_phase3d_kernel
//                     (pallas_call at :638 sharded_phase3d_packed).  The
//                     same phase on a z-shard of a (dp, y) mesh
//                     (parallel/domain.py): the planes before z 0 and
//                     after the last are the exchanged packed halo planes
//                     (whole word planes: z neighbours share bit
//                     positions); the side masks follow the global z
//                     parity, and the Philox counter is (rep0 + r,
//                     (z0 + z) * nyp + Y, X, draw / 4), so a sharded run
//                     equals the unsharded one bit for bit.  The edge
//                     tiles of a shard may be partial: any shard shape
//                     runs.
//
// Layout: (R, nz, nyp, half) int32 volumes, one per colour; bit k of word
// row Y of plane z is lattice row 32Y+k (the JAX package's layout).  Per
// word of the updated colour:
//   z+-1 neighbours   the same word of planes z-1/z+1 (periodic)
//   y+-1 neighbours   1-bit funnel shifts carrying from word rows Y-1/Y+1
//   x+-1 neighbours   the words at columns i-1/i+1 (periodic)
//   side select       (y+z) parity: masks 0xAAAAAAAA/0x55555555, swapped
//                     on odd z
//   count             bit-sliced 6:3 counter -> b1/b2/b4 planes
//                     (bernoulli.cuh count6)
//   B4, B8, B12       20-digit Bernoulli chains over Philox words
//                     (bernoulli.cuh chain_planes): up to 60 words, 15
//                     Philox calls
//   flip              bernoulli.cuh flip6
// The TPU grid of (replica, z-plane) blocks with whole planes in VMEM is
// not carried over: one thread a word, 32x8 threads a block walking the
// word rows of a column tile (a warp along x, so loads coalesce), every
// neighbour word read from device memory (they are L1/L2 hits; the
// kernel is bound by Philox, not bytes).
//
// Random words: the key is the Philox key of the (sample, t, phase); the
// counter is (replica, z * nyp + word row, column, draw / 4), disjoint
// fields for any volume the wrapper admits (z * nyp < 2^32).  So
// phase_kernel pairs, multisweep_kernel and the plain PyTorch version
// give the same bits, whatever the tiling or the host's chunking.
//
// Observables: exact integers.  Each block reduces its words' (m, e) and
// adds them with one 64-bit integer atomic per replica (512^3 = 1.3e8
// sites is past any 32-bit sum).
//
// Bound on the H100: integer operations.  At the 3-D critical point the
// chains draw 56 Philox words per word and phase (14 calls, ~650 int32
// operations with the round keys a launch constant) against 12 bytes of
// traffic.  The design spends little beside them:
// - the chains are bernoulli.cuh's unrolled chain_planes (the helical 3-D
//   phase's too), from the launch's ChainTable and Philox round
//   keys in the kernel's parameters, not bern_word's runtime loop, refill
//   test and buffer pick (~12-16 instructions a draw) and per-call
//   round-key bumps;
// - no runtime division: phase_kernel's grid is (column tiles, z-planes,
//   replicas), each block walking the word rows of its column tile and
//   plane (a loop where a grid dimension passes 65535), and every
//   neighbour wraps by compare and select, where the first design decoded
//   a 1-D tile index with % and / and wrapped with %, twelve ~20-
//   instruction sequences a word; indices are 32-bit (a volume holds
//   < 2^31 words);
// - a measuring block adds its sums once a replica, from shared memory
//   double-buffered across replicas: one barrier and two atomics a block
//   and replica, where the first design took two barriers and two
//   atomics a 256-word tile.
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

struct Phase3Args {
  const uint32_t* x_in;  // (R, nz, nyp, half) colour being updated
  uint32_t* x_out;       // may alias x_in
  const uint32_t* o;     // (R, nz, nyp, half) other colour
  const uint32_t* b4;    // injected Bernoulli planes, or nullptr
  const uint32_t* b8;
  const uint32_t* b12;
  long long* obs;        // (m, e) of replica r at obs[r * obs_stride], or null
  int obs_stride;
  int nrep, nz, nyp, half, color;
  // A z-shard's halos and global offsets (read only by phase_word<true>):
  const uint32_t* hzm;   // (R, 1, nyp, half) the plane before z 0
  const uint32_t* hzp;   // (R, 1, nyp, half) the plane after the last
  uint32_t rep0, z0;
};

// The launch's chains: the table (bernoulli.cuh) and the Philox round
// keys of the phase key (philox_round_keys)
struct Chains3 {
  uint2 rk[10];
  ChainTable table;
};

// One word (X, Y) of plane z of replica r (X < half, Y < nyp) of one
// colour phase, its (m, e) added to (m, e) where a.obs is set.  HALO: the
// volume is a z-shard's, whose planes before z 0 and after the last are
// its halos, whose side masks follow the global z parity and whose
// Philox counter is offset by (rep0, z0).  Otherwise the volume is
// periodic.  t, rk: the launch's chains (chain_planes).
template <bool HALO>
__device__ __forceinline__ void phase_word(const Phase3Args& a,
                                           const ChainTable& t,
                                           const uint2 (&rk)[10], int X,
                                           int Y, int z, int r, int& m,
                                           int& e) {
  const int nz = a.nz, nyp = a.nyp, half = a.half;
  const int plane = nyp * half;
  const int rep = r * nz * plane;
  const int in_plane = Y * half + X;
  const int idx = rep + z * plane + in_plane;
  const int row = idx - X;
  const int yu = (Y == 0 ? nyp : Y) - 1;
  const int yd = Y == nyp - 1 ? 0 : Y + 1;
  const int xm = (X == 0 ? half : X) - 1;
  const int xp = X == half - 1 ? 0 : X + 1;
  // __ldcg: the multisweep kernel rewrites the volumes between grid
  // barriers, so loads bypass the (non-coherent) L1.
  const uint32_t* o = a.o;
  const uint32_t oc = __ldcg(o + idx);
  const uint32_t o_prev = __ldcg(o + idx + (yu - Y) * half);
  const uint32_t o_next = __ldcg(o + idx + (yd - Y) * half);
  const uint32_t minus = __ldcg(o + row + xm);
  const uint32_t plus = __ldcg(o + row + xp);
  const int halo = r * plane + in_plane;
  const uint32_t zm =
      HALO && z == 0
          ? __ldcg(a.hzm + halo)
          : __ldcg(o + rep + (z == 0 ? nz - 1 : z - 1) * plane + in_plane);
  const uint32_t zp =
      HALO && z == nz - 1
          ? __ldcg(a.hzp + halo)
          : __ldcg(o + rep + (z == nz - 1 ? 0 : z + 1) * plane + in_plane);
  const uint32_t x = __ldcg(a.x_in + idx);

  const uint32_t zg = static_cast<uint32_t>(z) + (HALO ? a.z0 : 0u);
  const uint32_t up = (oc << 1) | (o_prev >> 31);
  const uint32_t dn = (oc >> 1) | (o_next << 31);
  const uint32_t modd = (zg & 1u) ? EVEN_BITS : ODD_BITS;
  const uint32_t meven = (zg & 1u) ? ODD_BITS : EVEN_BITS;
  const uint32_t side = a.color == 0 ? (plus & modd) | (minus & meven)
                                     : (minus & modd) | (plus & meven);
  uint32_t b1, b2, b4c;
  count6(zm, zp, up, dn, oc, side, b1, b2, b4c);

  uint32_t p4, p8, p12;
  if (a.b4 != nullptr) {
    p4 = __ldcg(a.b4 + idx);
    p8 = __ldcg(a.b8 + idx);
    p12 = __ldcg(a.b12 + idx);
  } else {
    chain_planes(t, rk, static_cast<uint32_t>(r) + (HALO ? a.rep0 : 0u),
                 zg * static_cast<uint32_t>(nyp) + static_cast<uint32_t>(Y),
                 static_cast<uint32_t>(X), p4, p8, p12);
  }
  const uint32_t nw = x ^ flip6(x, b1, b2, b4c, p4, p8, p12);
  a.x_out[idx] = nw;

  if (a.obs != nullptr) {
    // s = 2*bit - 1, neighbour sum = 2c - 6: this word's 32 sites give
    // m = 2(pc(new) + pc(oc)) - 64 and
    // e = -(4 pc(new & c) - 12 pc(new) - 2 pc(c) + 192)  (every bond once)
    const int s_x = __popc(nw);
    const int s_c = __popc(b1) + 2 * __popc(b2) + 4 * __popc(b4c);
    const int s_xc =
        __popc(nw & b1) + 2 * __popc(nw & b2) + 4 * __popc(nw & b4c);
    m += 2 * (s_x + __popc(oc)) - 64;
    e -= 4 * s_xc - 12 * s_x - 2 * s_c + 192;
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

// One colour phase: a grid of (ceil(half / 32), min(nz, 65535),
// min(R, 65535)) blocks of 32 x 8 threads; block (bx, bz, br) takes
// column tile bx of planes bz, bz + gridDim.y, ... of replicas br,
// br + gridDim.z, ..., every word row (thread row ty: rows ty, ty + 8,
// ...).  HALO: the edge tile may be partial (half % 32 != 0).
template <bool HALO>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    phase_kernel(Phase3Args a, Chains3 c) {
  const int X = blockIdx.x * TILE_X + threadIdx.x;
  const bool active = !HALO || X < a.half;
  int buf = 0;
  for (int r = blockIdx.z; r < a.nrep; r += gridDim.z) {
    int m = 0, e = 0;
    for (int z = blockIdx.y; z < a.nz; z += gridDim.y)
      for (int Y = threadIdx.y; active && Y < a.nyp; Y += TILE_Y)
        phase_word<HALO>(a, c.table, c.rk, X, Y, z, r, m, e);
    if (a.obs != nullptr) {  // uniform
      block_add(m, e, a.obs + static_cast<size_t>(r) * a.obs_stride, buf);
      buf ^= 1;
    }
  }
}

struct Multisweep3Args {
  const uint32_t* wa_in;
  const uint32_t* wb_in;
  uint32_t* wa;          // (R, nz, nyp, half) outputs, updated in place
  uint32_t* wb;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, nz, nyp, half, sweeps;
  ChainTable table;      // the chains of every phase (the digits' table)
};

// S sweeps on the whole ensemble: a cooperative grid walks all units
// (column tile, plane, replica) of a phase, every word row of a unit,
// then waits at a grid-wide barrier before the next phase reads what it
// wrote.  The volumes stay in device memory (256^3 x 4 replicas is 8 MiB
// of volumes, which the 50 MB L2 holds).  A unit's index is decoded with
// division, once a unit.
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    multisweep_kernel(Multisweep3Args a) {
  cg::grid_group grid = cg::this_grid();
  const size_t n = static_cast<size_t>(a.nrep) * a.nz * a.nyp * a.half;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * TILE_X * TILE_Y;
  for (size_t i = blockIdx.x * static_cast<size_t>(TILE_X * TILE_Y) +
                  threadIdx.y * TILE_X + threadIdx.x;
       i < n; i += nthreads) {
    a.wa[i] = a.wa_in[i];
    a.wb[i] = a.wb_in[i];
  }
  grid.sync();

  const int tiles_x = a.half / TILE_X;
  const int units = a.nrep * a.nz * tiles_x;
  int buf = 0;
  for (int s = 0; s < a.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      Phase3Args p{};
      p.x_in = phase ? a.wb : a.wa;
      p.x_out = phase ? a.wb : a.wa;
      p.o = phase ? a.wa : a.wb;
      p.obs = phase ? a.obs + 2 * s : nullptr;
      p.obs_stride = 2 * a.sweeps;
      p.nrep = a.nrep;
      p.nz = a.nz;
      p.nyp = a.nyp;
      p.half = a.half;
      p.color = phase;
      uint2 rk[10];
      philox_round_keys(
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]), rk);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int rest = u / tiles_x;
        const int X = (u - rest * tiles_x) * TILE_X + threadIdx.x;
        const int r = rest / a.nz, z = rest - r * a.nz;
        int m = 0, e = 0;
        for (int Y = threadIdx.y; Y < a.nyp; Y += TILE_Y)
          phase_word<false>(p, a.table, rk, X, Y, z, r, m, e);
        if (phase) {
          block_add(m, e, p.obs + static_cast<size_t>(r) * p.obs_stride,
                    buf);
          buf ^= 1;
        }
      }
      grid.sync();
    }
  }
}

Chains3 make_chains(unsigned int s0, unsigned int s1,
                    const unsigned int* chain) {
  Chains3 c;
  philox_round_keys(s0, s1, c.rk);
  std::memcpy(&c.table, chain, sizeof(ChainTable));
  return c;
}

dim3 phase_grid(int nrep, int nz, int half) {
  return dim3((half + TILE_X - 1) / TILE_X, nz < MAX_GRID ? nz : MAX_GRID,
              nrep < MAX_GRID ? nrep : MAX_GRID);
}

}  // namespace

extern "C" {

// One colour phase: a grid of (half/32, nz, R) blocks of 32x8 threads
// (phase_kernel).  b4/b8/b12 are injected planes or null (then Philox
// words under (s0, s1) and the chain table `chain`, the 65 words of
// ChainTable); obs is an (R, 2) int64 buffer zeroed by the caller, or
// null.
int ising3d_phase(const void* x_in, void* x_out, const void* o,
                  const void* b4, const void* b8, const void* b12, void* obs,
                  int nrep, int nz, int nyp, int half, int color,
                  unsigned int s0, unsigned int s1,
                  const unsigned int* chain, void* stream) {
  const Chains3 c = make_chains(s0, s1, chain);
  if (nrep < 1 || nz < 1 || nyp < 1 || half < 1 || !chain_table_ok(c.table))
    return static_cast<int>(cudaErrorInvalidValue);
  Phase3Args a{};
  a.x_in = static_cast<const uint32_t*>(x_in);
  a.x_out = static_cast<uint32_t*>(x_out);
  a.o = static_cast<const uint32_t*>(o);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.b12 = static_cast<const uint32_t*>(b12);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nrep = nrep;
  a.nz = nz;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  phase_kernel<false><<<phase_grid(nrep, nz, half), dim3(TILE_X, TILE_Y), 0,
                        static_cast<cudaStream_t>(stream)>>>(a, c);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a z-shard: a grid of (ceil(half/32), nz, R) blocks
// of 32x8 threads.  hzm/hzp are the (R, 1, nyp, half) halo planes;
// (rep0, z0) the shard's global replica and plane; b4/b8/b12 injected
// planes or null; chain as for ising3d_phase; obs an (R, 2) int64 buffer
// zeroed by the caller, or null.
int ising3d_shard_phase(const void* x_in, void* x_out, const void* o,
                        const void* hzm, const void* hzp, const void* b4,
                        const void* b8, const void* b12, void* obs,
                        int nrep, int nz, int nyp, int half, int color,
                        unsigned int rep0, unsigned int z0, unsigned int s0,
                        unsigned int s1, const unsigned int* chain,
                        void* stream) {
  const Chains3 c = make_chains(s0, s1, chain);
  if (nrep < 1 || nz < 1 || nyp < 1 || half < 1 ||
      static_cast<long long>(nrep) * nz * nyp * half >= (1LL << 31) ||
      !chain_table_ok(c.table))
    return static_cast<int>(cudaErrorInvalidValue);
  Phase3Args a{};
  a.x_in = static_cast<const uint32_t*>(x_in);
  a.x_out = static_cast<uint32_t*>(x_out);
  a.o = static_cast<const uint32_t*>(o);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.b12 = static_cast<const uint32_t*>(b12);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nrep = nrep;
  a.nz = nz;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  a.hzm = static_cast<const uint32_t*>(hzm);
  a.hzp = static_cast<const uint32_t*>(hzp);
  a.rep0 = rep0;
  a.z0 = z0;
  phase_kernel<true><<<phase_grid(nrep, nz, half), dim3(TILE_X, TILE_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(a, c);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the cooperative multisweep grid: as many as can be resident
// at once on the current device (0 if none fits).
int ising3d_multisweep_grid(int* blocks) {
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
// zeroed by the caller; chain the table of ising3d_phase.  One
// cooperative launch.
int ising3d_multisweep(const void* wa_in, const void* wb_in, void* wa,
                       void* wb, const void* seeds, void* obs, int nrep,
                       int nz, int nyp, int half, int sweeps,
                       const unsigned int* chain, void* stream) {
  int resident = 0;
  int err = ising3d_multisweep_grid(&resident);
  if (err != 0) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Multisweep3Args a;
  std::memcpy(&a.table, chain, sizeof(ChainTable));
  if (!chain_table_ok(a.table)) return static_cast<int>(cudaErrorInvalidValue);
  const int units = nrep * nz * (half / TILE_X);
  const int blocks = units < resident ? units : resident;
  a.wa_in = static_cast<const uint32_t*>(wa_in);
  a.wb_in = static_cast<const uint32_t*>(wb_in);
  a.wa = static_cast<uint32_t*>(wa);
  a.wb = static_cast<uint32_t*>(wb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.obs = static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nz = nz;
  a.nyp = nyp;
  a.half = half;
  a.sweeps = sweeps;
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

const char* ising3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
