// Bit-packed (multispin) Metropolis for the helical 2-D Ising model on
// Hopper (sm_90a): the kernel of the helical relaxation main path.
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     helical_multispin.py:_ms_kernel (pallas_call at :305
//                     _multisweep) and, as its injected-bits mode
//                     (multisweep_kernel<true>), _phase_bits_kernel
//                     (pallas_call at :220 phase_packed_with_bits).  S full
//                     sweeps with the exact (m, e) of every sweep; or one
//                     phase of colour a with b4/b8 planes read from buffers.
//
// Layout: one (R, W) uint32 colour vector per colour, bit k of word g =
// colour index 32g+k, M = nall/2 valid bits (ops/helical_multispin.py).
// Colour a reads b at the four offsets da, b reads a at db:
//   neighbour plane   out bit f = in bit (f + d) mod M: the 32 bits from
//                     (32g + d) mod M on, one __funnelshift_r of two
//                     adjacent words; where they run past bit M-1 (the
//                     wrap point) the rest comes from the head of word 0
//                     (read_circ, helical_read.cuh)
//   count             bit-sliced 4:3 counter (bernoulli.cuh count4)
//   B4, B8            20-digit Bernoulli chains over Philox words, in one
//                     unrolled line (bernoulli.cuh chain_planes) that
//                     follows the launch's ChainTable of (q4, q8, 0)
//                     (ops/multispin_rng.chain_table; the third chain
//                     draws nothing)
//   flip              bernoulli.cuh flip4
//   (m, e)            after phase b, with the pad bits [M, 32W) masked:
//                     they hold garbage after a flip and are never read
//                     as a neighbour
// The TPU's capacity-domain shifts and static blends (_shift_mod_impl)
// are not carried over; the modular read above is their direct form.
//
// Design: one block of 1024 threads owns one replica, so a phase
// boundary is a __syncthreads(): no grid barrier, no cooperative launch.
// When both vectors fit the block's shared memory (1001x1000: 2 x 61.1
// KiB) the kernel stages them there for all S sweeps and writes back once;
// above that (up to 2 x 512 KiB) the same code works on the output
// vectors in device memory.  A phase updates its colour in place: a word
// depends only on itself and on the other colour.  The chains are those
// of the periodic 2-D and the helical 3-D multisweeps (csrc/
// ising2d_multispin.cu, csrc/helical3d_multispin.cu): every thread takes
// the round keys of each (sweep, phase) key once (philox_round_keys) and
// holds them in registers; the Philox call index and the word within it
// are compile-time constants, a draw folds into its chain in one
// three-input op, and the chain boundaries are uniform.  The first design
// drew each chain by bern_word: a runtime loop from __ffs(q) with a
// WordStream refill test, a runtime pick of the buffer word and a digit's
// shift, mask and select a draw, and the round keys recomputed each
// Philox call (PERF.md §6 has the A/B).
//
// Random words: the key is the Philox key of the (sample, t, phase); the
// counter is (replica, word, 0, draw / 4), and the chains draw bern_word's
// words in its order.  S = 1 launches therefore give one S-sweep launch's
// trajectory bitwise, and so does the plain PyTorch version.
//
// Bound on the H100: integer operations.  A word costs about 10 Philox
// calls per phase at Tc (38 chain words), some 460 int32 operations
// against 8 bytes of traffic per sweep; one block per replica leaves the
// card's 132 SMs as busy as the batch has replicas (128 in the reference's
// production runs).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "bernoulli.cuh"
#include "helical_read.cuh"
#include "philox.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

struct HelicalArgs {
  const uint32_t* wa_in;  // (R, W) colour a
  const uint32_t* wb_in;  // (R, W) colour b
  uint32_t* wa;           // (R, W) outputs (the working vectors if not staged)
  uint32_t* wb;
  const int32_t* seeds;   // (S, 2, 2) Philox keys per (sweep, phase), or null
  const uint32_t* b4;     // injected planes (R, W): bits mode, or null
  const uint32_t* b8;
  long long* obs;         // (R, S, 2) (m, e), or null
  int nw, m, sweeps;
  int staged;             // 1: work in shared memory
  int da[4], db[4];       // offsets mod M of colour a's and b's neighbours
  ChainTable chain;       // the launch's chains (bernoulli.cuh)
};

// S sweeps (BITS false) or one phase of colour a with the injected planes
// (BITS true), one block a replica.
template <bool BITS>
__global__ void __launch_bounds__(THREADS, 1)
    multisweep_kernel(HelicalArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ long long red[2][WARPS];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int nw = a.nw, m = a.m;
  const size_t base = static_cast<size_t>(r) * nw;
  uint32_t* A = a.staged ? smem : a.wa + base;
  uint32_t* B = a.staged ? smem + nw : a.wb + base;
  for (int g = tid; g < nw; g += THREADS) {
    A[g] = a.wa_in[base + g];
    B[g] = a.wb_in[base + g];
  }
  __syncthreads();

  constexpr int PHASES = BITS ? 1 : 2;
  const int sweeps = BITS ? 1 : a.sweeps;
  for (int s = 0; s < sweeps; ++s) {
    for (int phase = 0; phase < PHASES; ++phase) {
      uint32_t* x = phase ? B : A;
      const uint32_t* o = phase ? A : B;
      int d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = phase ? a.db[k] : a.da[k];
      const bool measure = a.obs != nullptr && phase == 1;
      uint2 rk[10];
      if constexpr (!BITS)
        philox_round_keys(
            static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
            static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]), rk);
      long long pm = 0, pe = 0;
      for (int g = tid; g < nw; g += THREADS) {
        const int f0 = g * 32;  // < M, so f0 + d < 2M
        uint32_t n[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int st = f0 + d[k];
          if (st >= m) st -= m;
          n[k] = read_circ(o, nw, m, st);
        }
        uint32_t ones, twos, fours;
        count4(n[0], n[1], n[2], n[3], ones, twos, fours);
        uint32_t b4, b8;
        if constexpr (BITS) {
          b4 = a.b4[base + g];
          b8 = a.b8[base + g];
        } else {
          uint32_t unused;
          chain_planes(a.chain, rk, static_cast<uint32_t>(r),
                       static_cast<uint32_t>(g), 0u, b4, b8, unused);
        }
        const uint32_t xv = x[g];
        const uint32_t nv = xv ^ flip4(xv, ones, twos, fours, b4, b8);
        x[g] = nv;
        if (measure) {
          // s = 2*bit - 1, neighbour sum = 2c - 4, over the nb valid
          // sites of this word: m = 2(pc(b) + pc(a)) - 2nb and
          // e = -(4 pc(b & c) - 8 pc(b) - 2 pc(c) + 4nb)
          const int nb = min(32, m - f0);
          const uint32_t vm = nb == 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
          const uint32_t bv = nv & vm;
          const int s_x = __popc(bv);
          const int s_c = __popc(ones & vm) + 2 * __popc(twos & vm) +
                          4 * __popc(fours & vm);
          const int s_xc = __popc(bv & ones) + 2 * __popc(bv & twos) +
                           4 * __popc(bv & fours);
          pm += 2 * (s_x + __popc(o[g] & vm)) - 2 * nb;
          pe -= 4 * s_xc - 8 * s_x - 2 * s_c + 4 * nb;
        }
      }
      __syncthreads();  // phase boundary
      if (measure) {
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          pm += __shfl_down_sync(0xFFFFFFFFu, pm, off);
          pe += __shfl_down_sync(0xFFFFFFFFu, pe, off);
        }
        if ((tid & 31) == 0) {
          red[0][tid >> 5] = pm;
          red[1][tid >> 5] = pe;
        }
        __syncthreads();
        if (tid == 0) {
          long long bm = 0, be = 0;
          for (int w = 0; w < WARPS; ++w) {
            bm += red[0][w];
            be += red[1][w];
          }
          long long* dst = a.obs + (static_cast<size_t>(r) * a.sweeps + s) * 2;
          dst[0] = bm;
          dst[1] = be;
        }
      }
    }
  }
  if (a.staged) {
    for (int g = tid; g < nw; g += THREADS) {
      a.wa[base + g] = A[g];
      a.wb[base + g] = B[g];
    }
  }
}

// One launch of multisweep_kernel<BITS>: R blocks, smem bytes of staging
template <bool BITS>
int launch(const HelicalArgs& a, int nrep, int smem, cudaStream_t st) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        multisweep_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  multisweep_kernel<BITS><<<nrep, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory a block may stage vectors in: the opt-in maximum of the
// current device less the kernel's static reduction buffer.
int helical_smem_optin(int* bytes) {
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

// S sweeps (or, with bits, one phase of colour a with injected b4/b8):
// grid of R blocks of 1024 threads.  wa_in/wb_in -> wa/wb; obs (R, S, 2)
// is written whole when given.  staged: 1 to work in shared memory
// (2 * W * 4 bytes, which must fit helical_smem_optin).  chain: the 65
// words of ChainTable (refused unless chain_table_ok; not read in the
// bits mode).
int helical_multisweep(const void* wa_in, const void* wb_in, void* wa,
                       void* wb, const void* seeds, const void* b4,
                       const void* b8, void* obs, int nrep, int nw, int m,
                       int sweeps, int bits, int staged, int da0, int da1,
                       int da2, int da3, int db0, int db1, int db2, int db3,
                       const unsigned int* chain, void* stream) {
  HelicalArgs a;
  a.wa_in = static_cast<const uint32_t*>(wa_in);
  a.wb_in = static_cast<const uint32_t*>(wb_in);
  a.wa = static_cast<uint32_t*>(wa);
  a.wb = static_cast<uint32_t*>(wb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.obs = static_cast<long long*>(obs);
  a.nw = nw;
  a.m = m;
  a.sweeps = sweeps;
  a.staged = staged;
  a.da[0] = da0;
  a.da[1] = da1;
  a.da[2] = da2;
  a.da[3] = da3;
  a.db[0] = db0;
  a.db[1] = db1;
  a.db[2] = db2;
  a.db[3] = db3;
  std::memcpy(&a.chain, chain, sizeof(ChainTable));
  if (!chain_table_ok(a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = staged ? 2 * nw * static_cast<int>(sizeof(uint32_t)) : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits ? launch<true>(a, nrep, smem, st)
              : launch<false>(a, nrep, smem, st);
}

const char* helical_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
