// Bit-sliced packed clock Metropolis (q = 6, 4, 3) on Hopper (sm_90a): the
// kernel of the periodic clock relaxation main path.
//
//   phase_kernel<Q> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                   clock_planes.py:_phase_kernel (pallas_call at :313,
//                   phase_packed) for every PlaneSpec: one colour phase on
//                   (R, nyw, half) plane tuples, 3 planes a colour for
//                   q = 6 and 2 for q = 4 and q = 3; random planes from
//                   Philox words or injected (8, 6, 4 planes); the
//                   measuring phase b adds exact per-replica (2m, 2e)
//                   ((m, e) for q = 4) over the real sites.
//
// Layout (ops/clock_planes.py): bit k of word row Y is lattice row 32Y+k;
// the top word holds nb = ny % 32 real rows (nb = 0: all 32), its pad bits
// are written 0.  The periodic wrap is built per word from the real
// words, where the JAX padded engine rewrites pad words and lanes before
// each phase (_refresh_plane):
//   centre of the top word  (o[top] & low) | (o[0] << nb): rows 0.. in the
//                           pad bits, so its shift reads row ny-1's wrap
//   word above row 0        o[top] << (32 - nb): bit 31 is row ny-1
//   x neighbours            columns X-1, X+1 modulo half (no lane pad)
// The TPU's 8-row granules, up8/dn8 halo blocks and pltpu.roll are not
// carried over: one thread updates one word, reading its neighbour words
// from device memory (L1/L2 serve the reuse).
//
// Random words: the key is the Philox key of the (sample, t, phase); the
// counter is (replica, word row, column, draw / 4) (csrc/philox.cuh), so
// the plain PyTorch version (ops/clock_planes.phase_plain) gives the same
// bits.  The bond algebra is csrc/clock_algebra.cuh.
//
// Observables: each block belongs to one replica (grid.y); it reduces its
// words' exact integer sums and adds them with one 64-bit atomic a value.
//
// Bound on the H100: integer operations.  At kbt 0.91 (q = 6) a word
// draws 12 thermometer words and 81 chain words, ~24 Philox calls, about
// 1,600 instructions against 36-60 bytes of traffic.
#include <cuda_runtime.h>

#include <cstdint>

#include "clock_algebra.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t ODD_BITS = 0xAAAAAAAAu;
constexpr uint32_t EVEN_BITS = 0x55555555u;

struct ClockArgs {
  const uint32_t* x[3];   // (R, nyw, half) planes of the colour updated
  uint32_t* out[3];       // its new planes (never aliasing x or o)
  const uint32_t* o[3];   // the other colour's planes
  const uint32_t* inj;    // (NR, R, nyw, half) injected planes, or null
  long long* obs;         // (R, 2) sums, zeroed by the caller, or null
  int nrep, nyw, half, nb, color;
  uint2 key;              // Philox key of this (sample, t, phase)
  clockq::Chains chains;
};

template <int Q>
__global__ void __launch_bounds__(THREADS) phase_kernel(ClockArgs a) {
  using T = clockq::Traits<Q>;
  constexpr int NS = T::NS, NR = T::NR;
  __shared__ int red[2][WARPS];
  const int r = blockIdx.y;
  const int nyw = a.nyw, half = a.half, nb = a.nb, top = a.nyw - 1;
  const int per_rep = nyw * half;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const bool live = w < per_rep;
  int m_sum = 0, e_sum = 0;
  if (live) {
    const int Y = w / half, X = w - Y * half;
    const size_t base = static_cast<size_t>(r) * per_rep;
    const int xm = X == 0 ? half - 1 : X - 1;
    const int xp = X == half - 1 ? 0 : X + 1;
    const uint32_t low = nb ? (1u << nb) - 1u : 0xFFFFFFFFu;
    const uint32_t vm = (nb && Y == top) ? low : 0xFFFFFFFFu;

    uint32_t n[NS][4], oc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const uint32_t* o = a.o[k] + base;
      uint32_t c = __ldg(o + w);
      const uint32_t prev =
          Y > 0 ? __ldg(o + w - half)
                : (nb ? __ldg(o + top * half + X) << (32 - nb)
                      : __ldg(o + top * half + X));
      const uint32_t next = Y < top ? __ldg(o + w + half) : __ldg(o + X);
      if (nb && Y == top) c = (c & low) | (__ldg(o + X) << nb);
      const uint32_t minus = __ldg(o + Y * half + xm);
      const uint32_t plus = __ldg(o + Y * half + xp);
      n[k][0] = (c << 1) | (prev >> 31);
      n[k][1] = (c >> 1) | (next << 31);
      n[k][2] = c;
      n[k][3] = a.color == 0 ? (plus & ODD_BITS) | (minus & EVEN_BITS)
                             : (minus & ODD_BITS) | (plus & EVEN_BITS);
      oc[k] = c;
    }
    uint32_t rnd[NR];
    if (a.inj != nullptr) {
      const size_t plane = static_cast<size_t>(a.nrep) * per_rep;
#pragma unroll
      for (int i = 0; i < NR; ++i) rnd[i] = __ldg(a.inj + i * plane + base + w);
    } else {
      WordStream s(static_cast<uint32_t>(r), static_cast<uint32_t>(Y),
                   static_cast<uint32_t>(X), a.key);
      clockq::draw<Q>(s, a.chains, rnd);
    }
    uint32_t x[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) x[k] = __ldg(a.x[k] + base + w);
    uint32_t f1[4], f2[4];
    if constexpr (Q == 6) {
      clockq::decide6(x, n, rnd, f1, f2);
    } else if constexpr (Q == 4) {
      clockq::decide4(x, n, rnd, f1, f2);
    } else {
      clockq::decide3(x, n, rnd, f1);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      x[k] &= vm;
      a.out[k][base + w] = x[k];
    }
    if (a.obs != nullptr) {
      const int nsite = __popc(vm);
      if constexpr (Q == 6) {
        m_sum = clockq::m2_word6(x[0], x[1], x[2], vm) +
                clockq::m2_word6(oc[0], oc[1], oc[2], vm);
        int sx = 0, sw = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sx += __popc(f1[b] & vm);
          sw += __popc(f2[b] & vm);
        }
        e_sum = 4 * nsite + sx - 3 * sw;
      } else if constexpr (Q == 4) {
        const uint32_t na = ~x[0] & vm, nao = ~oc[0] & vm;
        m_sum = __popc(na & ~x[1]) - __popc(na & x[1]) +
                __popc(nao & ~oc[1]) - __popc(nao & oc[1]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t nab = ~f1[b] & vm;
          e_sum += __popc(nab & f2[b]) - __popc(nab & ~f2[b]);
        }
      } else {
        m_sum = 3 * __popc(~(x[0] | x[1]) & vm) +
                3 * __popc(~(oc[0] | oc[1]) & vm) - 2 * nsite;
        int se = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) se += __popc(f1[b] & vm);
        e_sum = 4 * nsite - 3 * se;
      }
    }
  }
  if (a.obs == nullptr) return;  // uniform across the block
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    m_sum += __shfl_down_sync(0xFFFFFFFFu, m_sum, off);
    e_sum += __shfl_down_sync(0xFFFFFFFFu, e_sum, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = m_sum;
    red[1][threadIdx.x >> 5] = e_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long bm = 0, be = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      bm += red[0][i];
      be += red[1][i];
    }
    unsigned long long* dst =
        reinterpret_cast<unsigned long long*>(a.obs) + 2 * static_cast<size_t>(r);
    atomicAdd(dst, static_cast<unsigned long long>(bm));
    atomicAdd(dst + 1, static_cast<unsigned long long>(be));
  }
}

}  // namespace

extern "C" {

// One colour phase of the q-state packed engine: grid (ceil(nyw*half/256),
// R) of 256 threads.  x*/out*/o* are the state planes (the third null for
// q = 4 and q = 3); inj the stacked injected planes when use_inj, else
// Philox words under (s0, s1) with the chains (cq, ck); obs an (R, 2)
// int64 buffer zeroed by the caller, or null.
int clock_phase(int q, const void* x0, const void* x1, const void* x2,
                void* out0, void* out1, void* out2, const void* o0,
                const void* o1, const void* o2, const void* inj, void* obs,
                int nrep, int nyw, int half, int nb, int color, int use_inj,
                unsigned int s0, unsigned int s1, unsigned int cq0,
                unsigned int cq1, unsigned int cq2, unsigned int cq3,
                unsigned int cq4, int ck0, int ck1, int ck2, int ck3, int ck4,
                void* stream) {
  ClockArgs a;
  a.x[0] = static_cast<const uint32_t*>(x0);
  a.x[1] = static_cast<const uint32_t*>(x1);
  a.x[2] = static_cast<const uint32_t*>(x2);
  a.out[0] = static_cast<uint32_t*>(out0);
  a.out[1] = static_cast<uint32_t*>(out1);
  a.out[2] = static_cast<uint32_t*>(out2);
  a.o[0] = static_cast<const uint32_t*>(o0);
  a.o[1] = static_cast<const uint32_t*>(o1);
  a.o[2] = static_cast<const uint32_t*>(o2);
  a.inj = use_inj ? static_cast<const uint32_t*>(inj) : nullptr;
  a.obs = static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nyw = nyw;
  a.half = half;
  a.nb = nb;
  a.color = color;
  a.key = make_uint2(s0, s1);
  const unsigned int cq[5] = {cq0, cq1, cq2, cq3, cq4};
  const int ck[5] = {ck0, ck1, ck2, ck3, ck4};
  for (int i = 0; i < clockq::MAX_CHAINS; ++i) {
    a.chains.q[i] = cq[i];
    a.chains.k[i] = ck[i];
  }
  if (nyw < 2 || half < 2 || nb < 0 || nb > 31 || nrep > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nyw * half + THREADS - 1) / THREADS, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 6:
      phase_kernel<6><<<grid, THREADS, 0, st>>>(a);
      break;
    case 4:
      phase_kernel<4><<<grid, THREADS, 0, st>>>(a);
      break;
    case 3:
      phase_kernel<3><<<grid, THREADS, 0, st>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* clock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
