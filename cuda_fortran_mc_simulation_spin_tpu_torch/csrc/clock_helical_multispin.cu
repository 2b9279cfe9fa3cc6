// Bit-sliced packed q = 6 clock Metropolis for the helical geometry on
// Hopper (sm_90a): the kernel of the helical clock relaxation main path.
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     clock_helical_multispin.py:_ms_kernel (pallas_call
//                     at :310 _multisweep) and, as its injected mode,
//                     _phase_bits_kernel (pallas_call at :196
//                     phase_packed_with_bits).  S full sweeps on one
//                     replica's resident (s, t0, t1) triplets of both
//                     colours with the exact per-sweep (2m, 2e, my2); or
//                     one phase of colour a with 8 planes read from a
//                     buffer.
//
// Layout: per colour three (R, W) uint32 vectors, bit k of word g = colour
// index 32g+k, M = nall/2 valid bits (ops/clock_helical_multispin.py).
// Colour a reads b at the four offsets da, b reads a at db: each of the
// three neighbour planes is the 32 bits from (32g + d) mod M on, read
// across the wrap by read_circ (helical_read.cuh), 12 modular reads a
// phase.  The decision and the thermometer and chains are
// clock_algebra.cuh's (the JAX module reuses clock_multispin._decide the
// same way).  Pad bits [M, 32W) hold garbage after a flip; read_circ never
// reads them for a valid site, and every sum masks them.
//
// Design: one block of 1024 threads owns one replica, so a phase
// boundary is a __syncthreads().  When both triplets fit the block's
// shared memory (501x500: 6 x 3,915 words, 94 KB) the kernel stages them
// there for all S sweeps and writes back once; above that (up to the JAX
// gate of 65,536 words a colour, 1.5 MiB) the same code works in place on
// the output vectors in device memory.  A phase updates its colour in
// place: a word depends only on itself and on the other colour.  At the
// class's 100 replicas 100 of the 132 SMs work; 1024 threads (32 warps,
// under a 64-register cap) beat 512 (16 warps, 112 registers) by ~12%,
// and splitting a replica over a cluster of blocks would leave the busiest
// SMs a replica's work all the same (PERF.md §6).
//
// Random words: the key is the Philox key of the (sample, t, phase); the
// counter is (replica, word, 0, draw / 4), so S one-sweep launches give
// one S-sweep launch's trajectory bitwise, and so does the plain version.
// The draw is clock_algebra.cuh's unrolled draw_unrolled<6>, the periodic
// packed clock's (csrc/clock_planes.cu): it follows the launch's
// DrawTable (ops/multispin_rng.clock_draw_table, checked by draw_table_ok
// before the launch) in one line, the Philox call index and the word
// within it compile-time constants, a draw folded into its chain in one
// three-input op; the round keys of each (sweep, phase) key are taken
// once a block (philox_round_keys) into shared memory, and draw_unrolled
// holds them in registers a word (no slower than every thread keeping its
// own copy across the phase, PERF.md §6).  The first
// design drew through a WordStream and bern_word's loops: a refill test, a
// runtime pick of the buffer word and a digit's shift a draw, and the round
// keys recomputed each Philox call (PERF.md §6 has the A/B).
//
// Bound on the H100: integer operations, ~24 Philox calls a word and
// phase at kbt 0.80.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "clock_algebra.cuh"
#include "helical_read.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

struct HelicalClockArgs {
  const uint32_t* a_in[3];  // (R, W) colour a triplet
  const uint32_t* b_in[3];
  uint32_t* a[3];           // outputs (the working vectors if not staged)
  uint32_t* b[3];
  const int32_t* seeds;     // (S, 2, 2) Philox keys per (sweep, phase)
  const uint32_t* inj;      // (8, R, W) injected planes: bits mode, or null
  long long* obs;           // (R, S, 3) (2m, 2e, my2), or null
  int nrep, nw, m, sweeps;
  int staged;               // 1: work in shared memory
  int da[4], db[4];         // offsets mod M of a's and b's neighbours
  clockq::DrawTable table;  // the launch's draw (unused in the bits mode)
};

// S sweeps (BITS false) or one phase of colour a with the 8 injected
// planes (BITS true), one block a replica.
template <bool BITS>
__global__ void __launch_bounds__(THREADS, 1)
    multisweep_kernel(HelicalClockArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ long long red[3][WARPS];
  __shared__ uint2 rk[10];  // the round keys of the (sweep, phase)
  const int r = blockIdx.x, tid = threadIdx.x;
  const int nw = a.nw, m = a.m;
  const size_t base = static_cast<size_t>(r) * nw;
  uint32_t* A[3];
  uint32_t* B[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    A[k] = a.staged ? smem + k * nw : a.a[k] + base;
    B[k] = a.staged ? smem + (3 + k) * nw : a.b[k] + base;
  }
  for (int g = tid; g < nw; g += THREADS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      A[k][g] = a.a_in[k][base + g];
      B[k][g] = a.b_in[k][base + g];
    }
  }
  __syncthreads();

  constexpr int PHASES = BITS ? 1 : 2;
  const int sweeps = BITS ? 1 : a.sweeps;
  for (int s = 0; s < sweeps; ++s) {
    for (int phase = 0; phase < PHASES; ++phase) {
      // the planes picked one by one, so that they stay in registers
      uint32_t* x[3];
      const uint32_t* o[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = phase ? B[k] : A[k];
        o[k] = phase ? A[k] : B[k];
      }
      int d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = phase ? a.db[k] : a.da[k];
      const bool measure = !BITS && a.obs != nullptr && phase == 1;
      // one copy a block, read after the barrier (the last phase's
      // readers passed its boundary)
      if constexpr (!BITS) {
        if (tid == 0)
          philox_round_keys(
              static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
              static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]), rk);
        __syncthreads();
      }
      long long pm = 0, pe = 0, py = 0;
      for (int g = tid; g < nw; g += THREADS) {
        const int f0 = g * 32;  // < M, so f0 + d < 2M
        uint32_t n[3][4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int st = f0 + d[b];
          if (st >= m) st -= m;
#pragma unroll
          for (int k = 0; k < 3; ++k) n[k][b] = read_circ(o[k], nw, m, st);
        }
        uint32_t rnd[8];
        if constexpr (BITS) {
          const size_t plane = static_cast<size_t>(a.nrep) * nw;
#pragma unroll
          for (int i = 0; i < 8; ++i) rnd[i] = a.inj[i * plane + base + g];
        } else {
          clockq::draw_unrolled<6>(a.table, rk, static_cast<uint32_t>(r),
                                   static_cast<uint32_t>(g), 0u, rnd);
        }
        uint32_t xv[3] = {x[0][g], x[1][g], x[2][g]};
        uint32_t xf[4], wf[4];
        clockq::decide6(xv, n, rnd, xf, wf);
#pragma unroll
        for (int k = 0; k < 3; ++k) x[k][g] = xv[k];
        if (measure) {
          const int nb = min(32, m - f0);
          const uint32_t vm = nb == 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
          const uint32_t oa0 = o[0][g], oa1 = o[1][g], oa2 = o[2][g];
          int sx = 0, sw = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            sx += __popc(xf[b] & vm);
            sw += __popc(wf[b] & vm);
          }
          pm += clockq::m2_word6(xv[0], xv[1], xv[2], vm) +
                clockq::m2_word6(oa0, oa1, oa2, vm);
          py += clockq::my2_word6(xv[0], xv[1], xv[2], vm) +
                clockq::my2_word6(oa0, oa1, oa2, vm);
          pe += 4 * nb + sx - 3 * sw;
        }
      }
      __syncthreads();  // phase boundary
      if (measure) {
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          pm += __shfl_down_sync(0xFFFFFFFFu, pm, off);
          pe += __shfl_down_sync(0xFFFFFFFFu, pe, off);
          py += __shfl_down_sync(0xFFFFFFFFu, py, off);
        }
        if ((tid & 31) == 0) {
          red[0][tid >> 5] = pm;
          red[1][tid >> 5] = pe;
          red[2][tid >> 5] = py;
        }
        __syncthreads();
        if (tid == 0) {
          long long bm = 0, be = 0, by = 0;
          for (int w = 0; w < WARPS; ++w) {
            bm += red[0][w];
            be += red[1][w];
            by += red[2][w];
          }
          long long* dst = a.obs + (static_cast<size_t>(r) * a.sweeps + s) * 3;
          dst[0] = bm;
          dst[1] = be;
          dst[2] = by;
        }
        __syncthreads();  // red is reused by the next sweep
      }
    }
  }
  if (a.staged) {
    for (int g = tid; g < nw; g += THREADS) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.a[k][base + g] = A[k][g];
        a.b[k][base + g] = B[k][g];
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory a block may stage triplets in: the opt-in maximum of the
// current device less the kernel's static reduction buffer.
int clock_helical_smem_optin(int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, multisweep_kernel<false>);
  *bytes = e == cudaSuccess ? optin - static_cast<int>(attr.sharedSizeBytes)
                            : 0;
  return static_cast<int>(e);
}

// S sweeps (or, with bits, one phase of colour a with the 8 injected
// planes inj): grid of R blocks of 1024 threads.  a*_in/b*_in -> a*/b*;
// obs (R, S, 3) is written whole when given.  staged: 1 to work in
// shared memory (6 * W * 4 bytes, which must fit clock_helical_smem_optin).
// table: the 167 words of the DrawTable (ops/multispin_rng.
// clock_draw_table), null in the bits mode.
int clock_helical_multisweep(
    const void* a0_in, const void* a1_in, const void* a2_in,
    const void* b0_in, const void* b1_in, const void* b2_in, void* a0,
    void* a1, void* a2, void* b0, void* b1, void* b2, const void* seeds,
    const void* inj, void* obs, int nrep, int nw, int m, int sweeps,
    int bits, int staged, int da0, int da1, int da2, int da3, int db0,
    int db1, int db2, int db3, const unsigned int* table, void* stream) {
  HelicalClockArgs a;
  const void* ins[6] = {a0_in, a1_in, a2_in, b0_in, b1_in, b2_in};
  void* outs[6] = {a0, a1, a2, b0, b1, b2};
  for (int k = 0; k < 3; ++k) {
    a.a_in[k] = static_cast<const uint32_t*>(ins[k]);
    a.b_in[k] = static_cast<const uint32_t*>(ins[3 + k]);
    a.a[k] = static_cast<uint32_t*>(outs[k]);
    a.b[k] = static_cast<uint32_t*>(outs[3 + k]);
  }
  a.seeds = static_cast<const int32_t*>(seeds);
  a.inj = bits ? static_cast<const uint32_t*>(inj) : nullptr;
  a.obs = bits ? nullptr : static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nw = nw;
  a.m = m;
  a.sweeps = sweeps;
  a.staged = staged;
  const int da[4] = {da0, da1, da2, da3}, db[4] = {db0, db1, db2, db3};
  for (int k = 0; k < 4; ++k) {
    a.da[k] = da[k];
    a.db[k] = db[k];
  }
  if (bits) {
    std::memset(&a.table, 0, sizeof(clockq::DrawTable));
  } else {
    if (table == nullptr || seeds == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(&a.table, table, sizeof(clockq::DrawTable));
    if (!clockq::draw_table_ok(a.table, 12))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = staged ? 6 * nw * static_cast<int>(sizeof(uint32_t)) : 0;
  const auto kernel = bits ? multisweep_kernel<true> : multisweep_kernel<false>;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<nrep, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_helical_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
