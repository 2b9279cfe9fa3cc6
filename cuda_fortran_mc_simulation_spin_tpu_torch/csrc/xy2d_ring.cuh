// The ring of the periodic XY multisweeps, shared by csrc/xy2d_resident.cu
// (float32 components) and csrc/xy2d_multisweep.cu (int16 angles), each
// in its shared-memory and its device-memory mode: each
// replica a ring of blocks, one block of 1024 threads an SM, block j
// owning the 256-site chunks bounds[j] .. bounds[j+1] - 1 of both colours
// (ops/xy2d_resident.ring_bounds); each phase reads the other colour's
// `half` sites before its first chunk and after its last (its halos) from
// its two ring neighbours.  A shared-memory mode holds a block's sites in
// shared memory for the launch's S sweeps and publishes its edges to a
// global edge buffer a colour (a neighbour may still read the other
// colour's); the device-memory mode leaves the planes in device memory
// and the neighbours read the edges from them.  Either way the edges are
// flagged with a release store at device scope, polled with relaxed loads
// and a fence (an acquire) by the neighbours before their next phase,
// which read them through L2 (__ldcg).  The waits take the place of a
// grid barrier; the launch is cooperative, so every block is resident and
// no wait can deadlock.  The flags count the phases published, cleared on
// the stream before the launch.  A block owns at least `half` sites, so
// its halos lie in its neighbours' ranges.
//
// Here: the phase keys, the flag loads and stores, the walk of a block's
// chunks (the ones holding its first and last `half` sites first, so the
// edges are published mid-phase and a neighbour's wait is short), a
// site's row, column and side slot without a division, the sums of a
// chunk in block_sums' order (xy2d_site.cuh) and the host side of a
// launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "xy2d_site.cuh"

namespace ring {

using xy::NSUMS;
using xy::THREADS;
using xy::WARPS;

// 256-thread groups a block: 1024 threads, one block an SM (two of 512
// read slower); the groups take the block's chunks in turn
constexpr int GROUPS = 4;
constexpr int BLOCK = THREADS * GROUPS;
// shared memory a chunk takes beside its sites: its warps' sums and its
// first site's (row, column)
constexpr int CHUNK_BYTES = NSUMS * WARPS * 8 + 8;

// A launch's ring (E: the type of an edge site)
template <class E>
struct Ring {
  const int32_t* bounds;   // (nb + 1,) first chunk of each block of a ring
  E* edges;                // (R nb, 2 colours, 2 half): first, last half
  unsigned* flags;         // (R nb,) phases published
  int nb;                  // blocks a ring (a replica)
  int span;                // sites a colour's shared plane: cap + 2 half
  int chunks;              // chunks a block at most: cap / 256
};

// The Philox key of phase k (2 s + colour) from the (S, 2, 2) int32 keys
__device__ __forceinline__ uint2 phase_key(const int32_t* seeds, int k) {
  return make_uint2(static_cast<uint32_t>(seeds[2 * k]),
                    static_cast<uint32_t>(seeds[2 * k + 1]));
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Thread 0 waits until both ring neighbours have published k phases
// (both flags' loads in flight at once, then the fence: the acquire); the
// block waits for it
__device__ __forceinline__ void wait(const unsigned* flags, int prev,
                                     int next, unsigned k, int tid) {
  if (tid == 0) {
    unsigned fp, fn;
    do {
      fp = load_relaxed(flags + prev);
      fn = load_relaxed(flags + next);
    } while (fp < k || fn < k);
    __threadfence();
  }
  __syncthreads();
}

// Thread 0 publishes this block's k-th phase (its edges written, the block
// past a barrier): the fence, then the release store
__device__ __forceinline__ void publish(unsigned* flags, unsigned k,
                                        int tid) {
  if (tid == 0) {
    __threadfence();
    store_release(flags + blockIdx.x, k);
  }
}

// The walk of a block's nch chunks (m owned sites, h = half): position p
// of the walk is chunk chunk(p); the chunks holding the first and the
// last h owned sites (the edges the neighbours read) come first, positions
// [0, edges)
struct Walk {
  int head, tail, edges;
  __device__ __forceinline__ Walk(int h, int m, int nch)
      : head(min((h + THREADS - 1) / THREADS, nch)),
        tail(min(nch - (m - h) / THREADS, nch - head)),
        edges(head + tail) {}
  __device__ __forceinline__ int chunk(int p, int nch) const {
    return p < head ? p : (p < edges ? nch - tail + (p - head) : p - tail);
  }
};

// Each of the block's chunks' first site as (row, column): with a
// thread's offset in a chunk as (rows, columns), (y, i) of a site takes no
// division (T: the block's threads)
template <int T = BLOCK>
__device__ __forceinline__ void chunk_rows(int2* rows, int c0, int nch,
                                           int h, int tid) {
  for (int q = tid; q < nch; q += T) {
    const int w = (c0 + q) * THREADS, y = w / h;
    rows[q] = make_int2(y, w - y * h);
  }
}

// Site (y, i) of a chunk whose first site is yi, at the thread's offset
// (dy, di) in a chunk, and its shared slot l's side neighbour ls (column
// i + 1 for colour 0 on an odd row and colour 1 on an even row, else i - 1,
// wrapping at h): slot l holds site lo - h + l of a colour's plane
struct Slot {
  int y, i, ls;
  __device__ __forceinline__ Slot(int2 yi, int dy, int di, int h, int c,
                                  int l) {
    y = yi.x + dy;
    i = yi.y + di;
    if (i >= h) {
      i -= h;
      ++y;
    }
    const bool plus = (c == 0) == ((y & 1) == 1);
    ls = plus ? (i == h - 1 ? l - i : l + 1)
              : (i == 0 ? l - i + h - 1 : l - 1);
  }
};

// block_sums' shuffle tree of a warp's four sums, transposed: the same
// pairs added in the same tree (at each level lane l's sum plus lane
// l + off's, a + b being b + a in IEEE arithmetic), but each lane keeps
// only the sums its part of the warp still needs, so a level moves one or
// two doubles instead of four (12 shuffles, not 40).  Lanes 0, 8, 16 and
// 24 end with the warp's Σ S_x, Σ S_y, S·h and S·S0, each bitwise
// block_sums' warp sum.
__device__ __forceinline__ double warp_sums(const xy::Sums& t, int lane) {
  constexpr unsigned ALL = 0xFFFFFFFFu;
  const bool hi16 = (lane & 16) != 0, hi8 = (lane & 8) != 0;
  // level 16: lanes 0-15 keep (S_x, S_y), lanes 16-31 (S·h, S·S0)
  double p = hi16 ? t.e : t.mx, q = hi16 ? t.a : t.my;
  p += __shfl_xor_sync(ALL, hi16 ? t.mx : t.e, 16);
  q += __shfl_xor_sync(ALL, hi16 ? t.my : t.a, 16);
  // level 8: of each 16, lanes 0-7 keep the first, lanes 8-15 the second
  double r = hi8 ? q : p;
  r += __shfl_xor_sync(ALL, hi8 ? p : q, 8);
  // levels 4, 2, 1 within each 8 lanes, as block_sums
  r += __shfl_down_sync(ALL, r, 4);
  r += __shfl_down_sync(ALL, r, 2);
  r += __shfl_down_sync(ALL, r, 1);
  return r;
}

// A measuring site's sums t into its warp's slot of chunk q in red (tg
// the thread's index in its 256-thread group), reduced after the phase in
// block_sums' order
__device__ __forceinline__ void store_sums(double* red, int q, int tg,
                                           const xy::Sums& t) {
  const double v = warp_sums(t, tg & 31);
  if ((tg & 7) == 0)
    red[(q * NSUMS + ((tg & 31) >> 3)) * WARPS + (tg >> 5)] = v;
}

// Each chunk's 8 warp sums in order: block_sums' partials of the block's
// nch chunks into part (T: the block's threads)
template <int T = BLOCK>
__device__ __forceinline__ void chunk_partials(double* part,
                                               const double* red, int nch,
                                               int tid) {
  for (int x = tid; x < nch * NSUMS; x += T) {
    double v = 0.0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += red[x * WARPS + wi];
    part[x] = v;
  }
}

// What a fit rule (ops/xy2d_resident.smem_limits) needs of the current
// device for kernel fn of `block` threads: its SMs, the blocks of fn an
// SM holds at once by its threads, registers and barriers (shared memory
// aside), the shared memory one block may take (opt-in), an SM's shared
// memory and what the runtime reserves a block.
inline int smem_limits(const void* fn, int* sms, int* per_sm,
                       int* smem_block, int* smem_sm, int* reserved,
                       int block = BLOCK) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, block, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_block,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return static_cast<int>(e);
}

// Before a ring launch of `blocks` blocks of fn (of `block` threads) with
// smem bytes of dynamic shared memory: the attribute set, a grid that
// cannot be resident at once refused (cudaErrorCooperativeLaunchTooLarge),
// the flags cleared on the stream
inline int prepare(const void* fn, int smem, long long blocks,
                   unsigned* flags, cudaStream_t st, int block = BLOCK) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, block,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(per_sm) * sms < blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(
      cudaMemsetAsync(flags, 0, sizeof(unsigned) * blocks, st));
}

}  // namespace ring
