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
//                     (bernoulli.cuh): up to 60 words, 15 Philox calls
//   flip              bernoulli.cuh flip6
// The TPU grid of (replica, z-plane) blocks with whole planes in VMEM is
// not carried over: one thread per word, 32x8 threads a block (a warp
// along x, so loads coalesce), every neighbour word read from device
// memory (they are L1/L2 hits; the kernel is bound by Philox, not bytes).
//
// Random words: the key is the Philox key of the (sample, t, phase); the
// counter is (replica, z * nyp + word row, column, draw / 4), disjoint
// fields for any volume the wrapper admits (z * nyp < 2^32).  So
// phase_kernel pairs, multisweep_kernel and the plain PyTorch version
// give the same bits, whatever the tiling or the host's chunking.
//
// Observables: exact integers.  Each block reduces its words' (m, e) and
// adds them with one 64-bit integer atomic per tile (512^3 = 1.3e8 sites
// is past any 32-bit sum).
//
// Bound on the H100: integer operations.  At the 3-D critical point the
// chains draw 56 Philox words per word and phase (14 calls, ~900 int32
// operations) against 12 bytes of traffic.
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

struct Phase3Args {
  const uint32_t* x_in;  // (R, nz, nyp, half) colour being updated
  uint32_t* x_out;       // may alias x_in
  const uint32_t* o;     // (R, nz, nyp, half) other colour
  const uint32_t* b4;    // injected Bernoulli planes, or nullptr
  const uint32_t* b8;
  const uint32_t* b12;
  long long* obs;        // (m, e) of replica r at obs[r * obs_stride], or null
  int obs_stride;
  int nz, nyp, half, color;
  uint2 key;             // Philox key of this (sample, t, phase)
  uint32_t q4, q8, q12;  // chain digits: round(p * 2^20)
  // A z-shard's halos and global offsets (read only by phase_tile<true>):
  const uint32_t* hzm;   // (R, 1, nyp, half) the plane before z 0
  const uint32_t* hzp;   // (R, 1, nyp, half) the plane after the last
  uint32_t rep0, z0;
};

// One tile (8 word rows x 32 words of one z-plane of one replica) of one
// colour phase.  Every thread of the block calls it with the same tile
// index; with obs it ends with a block reduction, so all threads must
// call it.  HALO: the volume is a z-shard's, whose planes before z 0 and
// after the last are its halos, whose side masks follow the global z
// parity and whose Philox counter is offset by (rep0, z0); its edge
// tiles may be partial, so any shard shape runs.  Otherwise the volume
// is periodic and tiles whole.
template <bool HALO>
__device__ __forceinline__ void phase_tile(const Phase3Args& a, int tile) {
  __shared__ long long red_m[TILE_Y];
  __shared__ long long red_e[TILE_Y];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nz = a.nz, nyp = a.nyp, half = a.half;
  const int tiles_x = (half + TILE_X - 1) / TILE_X;
  const int tiles_y = (nyp + TILE_Y - 1) / TILE_Y;
  const int X = (tile % tiles_x) * TILE_X + tx;
  int rest = tile / tiles_x;
  const int Y = (rest % tiles_y) * TILE_Y + ty;
  rest /= tiles_y;
  const int z = rest % nz;
  const int r = rest / nz;

  int m = 0, e = 0;
  if (!HALO || (Y < nyp && X < half)) {
    const size_t plane = static_cast<size_t>(nyp) * half;
    const size_t rep = static_cast<size_t>(r) * nz * plane;
    const size_t pz = rep + z * plane;
    const size_t row = pz + static_cast<size_t>(Y) * half;
    const size_t idx = row + X;
    // __ldcg: the multisweep kernel rewrites the volumes between grid
    // barriers, so loads bypass the (non-coherent) L1.
    const uint32_t* o = a.o;
    const uint32_t oc = __ldcg(o + idx);
    const uint32_t o_prev =
        __ldcg(o + pz + static_cast<size_t>((Y - 1 + nyp) % nyp) * half + X);
    const uint32_t o_next =
        __ldcg(o + pz + static_cast<size_t>((Y + 1) % nyp) * half + X);
    const uint32_t minus = __ldcg(o + row + (X - 1 + half) % half);
    const uint32_t plus = __ldcg(o + row + (X + 1) % half);
    const size_t in_plane = static_cast<size_t>(Y) * half + X;
    const size_t halo = static_cast<size_t>(r) * plane + in_plane;
    const uint32_t zm =
        HALO && z == 0
            ? __ldcg(a.hzm + halo)
            : __ldcg(o + rep + static_cast<size_t>((z - 1 + nz) % nz) * plane +
                     in_plane);
    const uint32_t zp =
        HALO && z == nz - 1
            ? __ldcg(a.hzp + halo)
            : __ldcg(o + rep + static_cast<size_t>((z + 1) % nz) * plane +
                     in_plane);
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
      WordStream s(static_cast<uint32_t>(r) + (HALO ? a.rep0 : 0u),
                   zg * static_cast<uint32_t>(nyp) + static_cast<uint32_t>(Y),
                   static_cast<uint32_t>(X), a.key);
      p4 = bern_word(s, a.q4);
      p8 = bern_word(s, a.q8);
      p12 = bern_word(s, a.q12);
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
      m = 2 * (s_x + __popc(oc)) - 64;
      e = -(4 * s_xc - 12 * s_x - 2 * s_c + 192);
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
      unsigned long long* dst = reinterpret_cast<unsigned long long*>(
          a.obs + static_cast<size_t>(r) * a.obs_stride);
      atomicAdd(dst, static_cast<unsigned long long>(bm));
      atomicAdd(dst + 1, static_cast<unsigned long long>(be));
    }
    __syncthreads();
  }
}

template <bool HALO>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    phase_kernel(Phase3Args a) {
  phase_tile<HALO>(a, blockIdx.x);
}

struct Multisweep3Args {
  const uint32_t* wa_in;
  const uint32_t* wb_in;
  uint32_t* wa;          // (R, nz, nyp, half) outputs, updated in place
  uint32_t* wb;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, nz, nyp, half, sweeps;
  uint32_t q4, q8, q12;
};

// S sweeps on the whole ensemble: a cooperative grid walks all tiles of a
// phase, then waits at a grid-wide barrier before the next phase reads
// what it wrote.  The volumes stay in device memory (256^3 x 4 replicas
// is 8 MiB of volumes, which the 50 MB L2 holds).
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

  const int tiles =
      a.nrep * a.nz * (a.nyp / TILE_Y) * (a.half / TILE_X);
  for (int s = 0; s < a.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      Phase3Args p{};
      p.x_in = phase ? a.wb : a.wa;
      p.x_out = phase ? a.wb : a.wa;
      p.o = phase ? a.wa : a.wb;
      p.b4 = nullptr;
      p.b8 = nullptr;
      p.b12 = nullptr;
      p.obs = phase ? a.obs + 2 * s : nullptr;
      p.obs_stride = 2 * a.sweeps;
      p.nz = a.nz;
      p.nyp = a.nyp;
      p.half = a.half;
      p.color = phase;
      p.key = make_uint2(static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
                         static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]));
      p.q4 = a.q4;
      p.q8 = a.q8;
      p.q12 = a.q12;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) phase_tile<false>(p, t);
      grid.sync();
    }
  }
}

}  // namespace

extern "C" {

// One colour phase: a 1-D grid of R*nz*(nyp/8)*(half/32) blocks of 32x8
// threads.  b4/b8/b12 are injected planes or null (then Philox words
// under (s0, s1)); obs is an (R, 2) int64 buffer zeroed by the caller, or
// null.
int ising3d_phase(const void* x_in, void* x_out, const void* o,
                  const void* b4, const void* b8, const void* b12, void* obs,
                  int nrep, int nz, int nyp, int half, int color,
                  unsigned int s0, unsigned int s1, unsigned int q4,
                  unsigned int q8, unsigned int q12, void* stream) {
  Phase3Args a{};
  a.x_in = static_cast<const uint32_t*>(x_in);
  a.x_out = static_cast<uint32_t*>(x_out);
  a.o = static_cast<const uint32_t*>(o);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.b12 = static_cast<const uint32_t*>(b12);
  a.obs = static_cast<long long*>(obs);
  a.obs_stride = 2;
  a.nz = nz;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  a.key = make_uint2(s0, s1);
  a.q4 = q4;
  a.q8 = q8;
  a.q12 = q12;
  const int tiles = nrep * nz * (nyp / TILE_Y) * (half / TILE_X);
  phase_kernel<false><<<tiles, dim3(TILE_X, TILE_Y), 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a z-shard: a 1-D grid of
// R*nz*ceil(nyp/8)*ceil(half/32) blocks of 32x8 threads.  hzm/hzp are the
// (R, 1, nyp, half) halo planes; (rep0, z0) the shard's global replica
// and plane; b4/b8/b12 injected planes or null; obs an (R, 2) int64
// buffer zeroed by the caller, or null.
int ising3d_shard_phase(const void* x_in, void* x_out, const void* o,
                        const void* hzm, const void* hzp, const void* b4,
                        const void* b8, const void* b12, void* obs,
                        int nrep, int nz, int nyp, int half, int color,
                        unsigned int rep0, unsigned int z0, unsigned int s0,
                        unsigned int s1, unsigned int q4, unsigned int q8,
                        unsigned int q12, void* stream) {
  const long long tiles = static_cast<long long>(nrep) * nz *
                          ((nyp + TILE_Y - 1) / TILE_Y) *
                          ((half + TILE_X - 1) / TILE_X);
  if (nrep < 1 || nz < 1 || nyp < 1 || half < 1 || tiles >= (1LL << 31))
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
  a.nz = nz;
  a.nyp = nyp;
  a.half = half;
  a.color = color;
  a.key = make_uint2(s0, s1);
  a.q4 = q4;
  a.q8 = q8;
  a.q12 = q12;
  a.hzm = static_cast<const uint32_t*>(hzm);
  a.hzp = static_cast<const uint32_t*>(hzp);
  a.rep0 = rep0;
  a.z0 = z0;
  phase_kernel<true><<<static_cast<unsigned>(tiles), dim3(TILE_X, TILE_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
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
// zeroed by the caller.  One cooperative launch.
int ising3d_multisweep(const void* wa_in, const void* wb_in, void* wa,
                       void* wb, const void* seeds, void* obs, int nrep,
                       int nz, int nyp, int half, int sweeps,
                       unsigned int q4, unsigned int q8, unsigned int q12,
                       void* stream) {
  int resident = 0;
  int err = ising3d_multisweep_grid(&resident);
  if (err != 0) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = nrep * nz * (nyp / TILE_Y) * (half / TILE_X);
  const int blocks = tiles < resident ? tiles : resident;
  Multisweep3Args a;
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
  a.q4 = q4;
  a.q8 = q8;
  a.q12 = q12;
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
