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
//   phase_kernel<Q, true> replaces clock_planes.py:_sharded_phase_kernel
//                   (pallas_call at :875, sharded_phase_packed; reached as
//                   clock_multispin.sharded_phase_packed6, clock4_
//                   multispin.sharded_phase_packed4 and clock3_multispin.
//                   sharded_phase_packed3).  The same phase on a shard of a
//                   (y[, x]) mesh (parallel/domain.py): the bit rows past
//                   the shard's first and last word rows come from the
//                   exchanged 0/1 halo planes (one a state plane, spliced
//                   in at bit 31 above and read at bit 0 below), with an x
//                   split the word columns past its edges from the
//                   exchanged word columns; the Philox counter is offset by
//                   the shard's global (rep0, wrow0, col0), so a shard
//                   draws what the whole lattice draws and a sharded run
//                   equals the unsharded one bit for bit.  Shards hold
//                   whole words (ny % (32 y) == 0), so nb = 0 there.
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

// A shard's halos and global offsets (read only by phase_kernel<Q, true>)
struct ClockShard {
  const uint32_t* up[3];  // (R, 1, half) 0/1: the row above word row 0
  const uint32_t* dn[3];  // (R, 1, half) 0/1: the row below the last
  const uint32_t* lf[3];  // (R, nyw, 1) word column left of column 0, or null
  const uint32_t* rt[3];  // (R, nyw, 1) right of the last, or null
  uint32_t rep0, wrow0, col0;
};

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

// HALO: a is a shard's (nb = 0), its edges read s's halos; otherwise the
// planes are periodic and s is not read.
template <int Q, bool HALO>
__global__ void __launch_bounds__(THREADS)
    phase_kernel(ClockArgs a, ClockShard s) {
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
      const size_t hrow = static_cast<size_t>(r) * half + X;
      const size_t hcol = static_cast<size_t>(r) * nyw + Y;
      const uint32_t prev =
          Y > 0 ? __ldg(o + w - half)
                : (HALO ? __ldg(s.up[k] + hrow) << 31
                        : (nb ? __ldg(o + top * half + X) << (32 - nb)
                              : __ldg(o + top * half + X)));
      const uint32_t next =
          Y < top ? __ldg(o + w + half)
                  : (HALO ? __ldg(s.dn[k] + hrow) : __ldg(o + X));
      if (!HALO && nb && Y == top) c = (c & low) | (__ldg(o + X) << nb);
      const uint32_t minus = HALO && X == 0 && s.lf[k] != nullptr
                                 ? __ldg(s.lf[k] + hcol)
                                 : __ldg(o + Y * half + xm);
      const uint32_t plus = HALO && X == half - 1 && s.rt[k] != nullptr
                                ? __ldg(s.rt[k] + hcol)
                                : __ldg(o + Y * half + xp);
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
      WordStream ws(static_cast<uint32_t>(r) + (HALO ? s.rep0 : 0u),
                    static_cast<uint32_t>(Y) + (HALO ? s.wrow0 : 0u),
                    static_cast<uint32_t>(X) + (HALO ? s.col0 : 0u), a.key);
      clockq::draw<Q>(ws, a.chains, rnd);
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

ClockArgs make_args(const void* const* planes, const void* inj, void* obs,
                    int nrep, int nyw, int half, int nb, int color,
                    int use_inj, unsigned int s0, unsigned int s1,
                    const unsigned int* cq, const int* ck) {
  ClockArgs a;
  for (int k = 0; k < 3; ++k) {
    a.x[k] = static_cast<const uint32_t*>(planes[k]);
    a.out[k] = static_cast<uint32_t*>(const_cast<void*>(planes[3 + k]));
    a.o[k] = static_cast<const uint32_t*>(planes[6 + k]);
  }
  a.inj = use_inj ? static_cast<const uint32_t*>(inj) : nullptr;
  a.obs = static_cast<long long*>(obs);
  a.nrep = nrep;
  a.nyw = nyw;
  a.half = half;
  a.nb = nb;
  a.color = color;
  a.key = make_uint2(s0, s1);
  for (int i = 0; i < clockq::MAX_CHAINS; ++i) {
    a.chains.q[i] = cq[i];
    a.chains.k[i] = ck[i];
  }
  return a;
}

template <bool HALO>
int launch(int q, const ClockArgs& a, const ClockShard& s, cudaStream_t st) {
  const dim3 grid((a.nyw * a.half + THREADS - 1) / THREADS, a.nrep);
  switch (q) {
    case 6:
      phase_kernel<6, HALO><<<grid, THREADS, 0, st>>>(a, s);
      break;
    case 4:
      phase_kernel<4, HALO><<<grid, THREADS, 0, st>>>(a, s);
      break;
    case 3:
      phase_kernel<3, HALO><<<grid, THREADS, 0, st>>>(a, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  const void* planes[9] = {x0, x1, x2, out0, out1, out2, o0, o1, o2};
  const unsigned int cq[5] = {cq0, cq1, cq2, cq3, cq4};
  const int ck[5] = {ck0, ck1, ck2, ck3, ck4};
  const ClockArgs a = make_args(planes, inj, obs, nrep, nyw, half, nb, color,
                                use_inj, s0, s1, cq, ck);
  if (nyw < 2 || half < 2 || nb < 0 || nb > 31 || nrep > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(q, a, ClockShard{},
                       static_cast<cudaStream_t>(stream));
}

// One colour phase of a shard: planes[0..20] are x[3], out[3], o[3] (as
// for clock_phase), then the halos up[3], dn[3] ((R, 1, half) 0/1) and
// lf[3], rt[3] ((R, nyw, 1) word columns, all null without an x split);
// (rep0, wrow0, col0) the shard's global replica, word row and column.
int clock_halo_phase(int q, const void* const* planes, const void* inj,
                     void* obs, int nrep, int nyw, int half, int color,
                     int use_inj, int rep0, int wrow0, int col0,
                     unsigned int s0, unsigned int s1, const unsigned int* cq,
                     const int* ck, void* stream) {
  ClockArgs a = make_args(planes, inj, obs, nrep, nyw, half, 0, color,
                          use_inj, s0, s1, cq, ck);
  ClockShard s;
  for (int k = 0; k < 3; ++k) {
    s.up[k] = static_cast<const uint32_t*>(planes[9 + k]);
    s.dn[k] = static_cast<const uint32_t*>(planes[12 + k]);
    s.lf[k] = static_cast<const uint32_t*>(planes[15 + k]);
    s.rt[k] = static_cast<const uint32_t*>(planes[18 + k]);
  }
  s.rep0 = static_cast<uint32_t>(rep0);
  s.wrow0 = static_cast<uint32_t>(wrow0);
  s.col0 = static_cast<uint32_t>(col0);
  if (nyw < 1 || half < 1 || nrep > 65535 || rep0 < 0 || wrow0 < 0 ||
      col0 < 0 || (s.lf[0] == nullptr) != (s.rt[0] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, a, s, static_cast<cudaStream_t>(stream));
}

const char* clock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
