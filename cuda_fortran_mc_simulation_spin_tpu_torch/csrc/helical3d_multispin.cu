// Bit-packed (multispin) Metropolis for the helical 3-D Ising model on
// Hopper (sm_90a): the three kernels of the helical 3-D relaxation.
//
//   phase_kernel      replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     helical3d_multispin.py:_phase_bits_kernel (pallas_call
//                     at :197 phase_packed_with_bits), _stream_kernel (:452
//                     _stream_phase) and _halo_kernel (:838 _halo_phase):
//                     one (sub-)phase of a colour vector, with Philox words
//                     or injected b4/b8/b12 planes, the z-parity mask of the
//                     even-nx*ny sub-phases, and fused (m, e) sums.
//   energy_kernel     replaces _halo_energy_kernel (:938 _halo_energy) and
//                     its XLA sibling _energy_all_packed: the exact (m, e)
//                     of the final vectors from forward-bond disagreements.
//   multisweep_kernel replaces _ms_kernel (:290 _multisweep): S sweeps on
//                     resident vectors with the (m, e) of every sweep, odd
//                     nx*ny only; its chains are phase_kernel's, under the
//                     round keys of each (sweep, phase) key.
//
// Layout: one (R, W) uint32 colour vector per colour, bit k of word g =
// colour index 32g+k, M = nall/2 valid bits (ops/helical_multispin.py).
// Colour a reads six neighbour planes at constant offsets mod M
// (ops/helical3d_multispin.helical3d_offsets): all six in colour b when
// nx*ny is odd; four in b and the two z-neighbours at +-nx*ny/2 in a itself
// when nx*ny is even.  A neighbour plane is read_circ (helical_read.cuh):
// the 32 bits from (32g + d) mod M on, reading across the wrap directly,
// so the TPU's ring-pad layout (ring_fill, pack_flat_halo) and its
// pre-shifted planes have no counterpart.  Per word:
//   count             bernoulli.cuh count6
//   B4, B8, B12       20-digit Bernoulli chains over Philox words
//   flip              bernoulli.cuh flip6, and with even nx*ny only on the
//                     sites of one z-plane parity (zsub): bit k flips only
//                     if ((32g + k) / (nx*ny/2)) % 2 == zsub, computed from
//                     the index (no mask plane).  A flipping site's
//                     z-neighbours then lie in the other parity, which that
//                     sub-phase never writes.
// phase_kernel writes out of place (x_in -> x_out), so no read of the
// updated colour's own z-window can see a write of the same launch.
//
// Random words: the key is the Philox key of the (sample, t, sub-phase);
// the counter is (replica, word, 0, draw / 4).  The word index stays below
// 2^32 for any vector the wrappers admit (M < 2^30), so phase_kernel
// launches, multisweep_kernel and the plain PyTorch versions give the same
// bits, whatever the grid or the host's chunking.
//
// Observables: exact integers in 64 bits from the block partials up (3N is
// 3.0e9 at 1001x1000x1000).  Odd nx*ny: phase b's counts are against the
// final colour a and each bond has exactly one b end, so e = -sum_b
// s_b (2c - 6) covers every bond once.  Even nx*ny: that identity mixes in
// the self reads, so the phase kernel gives m only, and energy_kernel the
// energy: 6 forward-bond planes, e = sum (2 popc(src ^ nbr) - valid bits).
//
// energy_kernel (bound on the H100: bytes, both colours read once) takes
// runs of K = 8 consecutive words a thread (faster than runs of 4 on an
// H100, PERF.md §6; the constants from
// ops/helical3d_multispin.energy_runs, the entry point takes them as
// passed).  The six planes are six word streams: a's and b's own words
// (the d = 0 plane and the d = 1 plane, one bit on), and the streams of
// planes 1, 3, 4, 5 at word offsets q = d >> 5.  A run loads each stream
// once as aligned 16-B vectors, the one vector past them from the next
// lane by shuffles, and funnel-shifts by the plane's d & 31: ~6 vector
// loads a run of 8 words, against the first design's 14 scalar loads and
// 6 wrap tests a word (read_circ).  A run where a plane wraps past M or a
// window would pass word W - 1 (the last ~dmax / 32 words of a replica,
// and its first words before the 16-B grid) takes read_circ a word.  A
// grid of a few blocks an SM strides over the runs, one pair of int64
// atomics a block and replica (the first design: a block of 256 words,
// 61,000 same-address pairs a replica at 1001x1000x1000).  Integer sums
// are exact in any order: the plain version's bits.
//
// Bound on the H100: integer operations.  At the 3-D critical point the
// chains draw 56 Philox words a word and phase (14 calls, ~650 int32
// operations with the round keys a per-launch constant) against 8-12
// bytes of traffic.  A word whose sites all lie in the sub-phase's other
// z-parity flips nothing: the kernel copies it and skips the chains, so the
// four even-nx*ny sub-phases cost about two phases.  multisweep_kernel runs
// one block per replica in device memory (both colours of a 151x151x150
// replica, 417.5 KiB, exceed the 227 KB of shared memory), with a
// __syncthreads() between phases; 1024 threads at the cap of 64
// registers ran faster than 512 (78 registers) and 256 (PERF.md §6).
//
// Both Philox kernels draw their chains in a fully unrolled loop
// (bernoulli.cuh chain_planes, from the launch's ChainTable):
// phase_kernel with the round keys in its parameters, multisweep_kernel
// with those of each (sweep, phase) key, derived by every thread at the
// phase's start (philox_round_keys, as csrc/ising3d_multispin.cu's
// multisweep does).  The first design called bern_word per chain, ~12-16
// instructions a draw on top of Philox; each neighbour plane's colour is
// a compile-time choice (phase_kernel<NCROSS>).  PERF.md §6 has the A/Bs.
// The draws and their order are bern_word's, so the planes are the plain
// chains' bits.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "bernoulli.cuh"
#include "helical_read.cuh"
#include "philox.cuh"

namespace {

constexpr int PHASE_THREADS = 256;
constexpr int MS_THREADS = 1024;

// One colour phase's geometry: offsets d[k] mod M of the six neighbour
// planes; planes k < ncross read the other colour, the rest (the even
// nx*ny z-neighbours) the updated colour itself.
struct Stencil {
  int nw, m, ncross;
  int d[6];
};

struct PhaseArgs {
  const uint32_t* x_in;  // (R, W) colour being updated
  uint32_t* x_out;       // (R, W) result, never aliasing x_in
  const uint32_t* o;     // (R, W) other colour
  const uint32_t* b4;    // injected Bernoulli planes (R, W), or null
  const uint32_t* b8;
  const uint32_t* b12;
  long long* obs;        // (R, 2) (m, e) sums, zeroed by the caller, or null
  Stencil st;
  uint2 rk[10];          // Philox round keys of the phase key
  ChainTable chain;      // the launch's chains (bernoulli.cuh)
  int zsub;              // -1: every site; 0/1: z-plane parity zsub only
  int zh;                // colour sites per z-plane, nx*ny/2 (zsub >= 0)
};

// Bits of the word at colour index f0 whose site lies in an even z-plane:
// bit k is set iff ((f0 + k) / zh) % 2 == 0 (ops/helical3d_multispin.
// zmask_words).
__device__ __forceinline__ uint32_t zeven_word(int f0, int zh) {
  int q = f0 / zh;
  int rem = f0 - q * zh;
  uint32_t mask = 0u;
  for (int k = 0; k < 32; ++q, rem = 0) {
    const int len = min(32 - k, zh - rem);
    if (!(q & 1))
      mask |= (len == 32 ? 0xFFFFFFFFu : ((1u << len) - 1u)) << k;
    k += len;
  }
  return mask;
}

// Bits of word g that hold a site (the pad bits [M, 32W) are garbage).
__device__ __forceinline__ uint32_t valid_bits(int m, int f0) {
  const int nb = min(32, m - f0);
  return nb == 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
}

// The 6-neighbour count planes of word g of colour x (replica base
// pointers x and o): planes k < NCROSS read o, the others x (NCROSS < 0:
// s.ncross at run time).
template <int NCROSS = -1>
__device__ __forceinline__ void counts(const Stencil& s, const uint32_t* x,
                                       const uint32_t* o, int f0,
                                       uint32_t& b1, uint32_t& b2,
                                       uint32_t& b4) {
  uint32_t n[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int start = f0 + s.d[k];  // f0 < M and d < M, so start < 2M
    if (start >= s.m) start -= s.m;
    n[k] = read_circ(k < (NCROSS < 0 ? s.ncross : NCROSS) ? o : x, s.nw,
                     s.m, start);
  }
  count6(n[0], n[1], n[2], n[3], n[4], n[5], b1, b2, b4);
}

// Fused sums of one word of phase b with vm its valid bits: s = 2 bit - 1
// and neighbour sum 2c - 6 give m = 2(pc(b) + pc(a)) - 2nb and
// e = -(4 pc(b & c) - 12 pc(b) - 2 pc(c) + 6nb).
__device__ __forceinline__ void word_sums(uint32_t nv, uint32_t ov,
                                          uint32_t b1, uint32_t b2,
                                          uint32_t b4, uint32_t vm,
                                          bool energy, long long& pm,
                                          long long& pe) {
  const int nb = __popc(vm);
  const uint32_t bv = nv & vm;
  const int s_x = __popc(bv);
  pm += 2 * (s_x + __popc(ov & vm)) - 2 * nb;
  if (energy) {
    const int s_c = __popc(b1 & vm) + 2 * __popc(b2 & vm) +
                    4 * __popc(b4 & vm);
    const int s_xc =
        __popc(bv & b1) + 2 * __popc(bv & b2) + 4 * __popc(bv & b4);
    pe -= 4 * s_xc - 12 * s_x - 2 * s_c + 6 * nb;
  }
}

// Block sum of (pm, pe) added to dst[0], dst[1] with one 64-bit atomic
// each; every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ void block_add(long long pm, long long pe,
                                          long long* dst) {
  __shared__ long long red[2][THREADS / 32];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    pm += __shfl_down_sync(0xFFFFFFFFu, pm, off);
    pe += __shfl_down_sync(0xFFFFFFFFu, pe, off);
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = pm;
    red[1][tid >> 5] = pe;
  }
  __syncthreads();
  if (tid == 0) {
    long long bm = 0, be = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      bm += red[0][w];
      be += red[1][w];
    }
    unsigned long long* d = reinterpret_cast<unsigned long long*>(dst);
    atomicAdd(d, static_cast<unsigned long long>(bm));
    atomicAdd(d + 1, static_cast<unsigned long long>(be));
  }
  __syncthreads();
}

// One (sub-)phase: a grid of (ceil(W / 256), R) blocks, one thread a word;
// NCROSS = a.st.ncross, the planes read from the other colour (6 at odd
// nx*ny, 4 at even), a compile-time choice of each read's colour.
template <int NCROSS>
__global__ void __launch_bounds__(PHASE_THREADS)
    phase_kernel(PhaseArgs a) {
  const int g = blockIdx.x * PHASE_THREADS + threadIdx.x;
  const int r = blockIdx.y;
  const int nw = a.st.nw;
  long long pm = 0, pe = 0;
  if (g < nw) {
    const size_t base = static_cast<size_t>(r) * nw;
    const uint32_t* x = a.x_in + base;
    const uint32_t* o = a.o + base;
    const int f0 = g * 32;
    const uint32_t xv = x[g];
    uint32_t allow = 0xFFFFFFFFu;
    if (a.zsub >= 0) {
      allow = zeven_word(f0, a.zh);
      if (a.zsub) allow = ~allow;
    }
    uint32_t nv = xv, b1 = 0u, b2 = 0u, b4c = 0u;
    if (allow != 0u) {
      counts<NCROSS>(a.st, x, o, f0, b1, b2, b4c);
      uint32_t p4, p8, p12;
      if (a.b4 != nullptr) {
        p4 = a.b4[base + g];
        p8 = a.b8[base + g];
        p12 = a.b12[base + g];
      } else {
        chain_planes(a.chain, a.rk, static_cast<uint32_t>(r),
                     static_cast<uint32_t>(g), 0u, p4, p8, p12);
      }
      nv = xv ^ (flip6(xv, b1, b2, b4c, p4, p8, p12) & allow);
    }
    a.x_out[base + g] = nv;
    if (a.obs != nullptr)
      word_sums(nv, o[g], b1, b2, b4c, valid_bits(a.st.m, f0), NCROSS == 6,
                pm, pe);
  }
  if (a.obs != nullptr)
    block_add<PHASE_THREADS>(pm, pe, a.obs + 2 * static_cast<size_t>(r));
}

struct EnergyArgs {
  const uint32_t* wa;  // (R, W) final colour vectors
  const uint32_t* wb;
  long long* obs;      // (R, 2) (m, e) sums, zeroed by the caller
  int nw, m;
  int d[6];            // forward-bond offsets mod M: pairs a->b (d0, d1),
                       // b->a (d2, d3), then a->? (d4) and b->? (d5)
  int self_z;          // 1 (even nx*ny): pairs 4, 5 read the own colour
};

// The launch constants of ops/helical3d_multispin.energy_runs, in its
// order (the entry point takes them as passed, after energy_runs_ok).
// Run t of a replica holds its words K t - c .. K t - c + K - 1, c the
// replica's first word of colour a mod 4 (16-B vectors), so a's words of
// a run are one aligned vector each four.
struct EnergyRuns {
  int nruns;   // runs a replica, ceil((W + 3) / K): every c covered
  int bulk;    // runs t < bulk with K t - c >= 0 read every plane
               // without a wrap and inside the replica's W words
  int blocks;  // blocks a replica (the grid's x), striding over the runs
  int q[6];    // each plane's word offset d >> 5
  int sh[6];   // and its bit shift d & 31
};
constexpr int ENERGY_RUN_INTS = 15;
static_assert(sizeof(EnergyRuns) == ENERGY_RUN_INTS * 4,
              "ops/helical3d_multispin.py passes the runs as 15 ints");

// K, words a thread a step (ops/helical3d_multispin.ENERGY_RUN), threads
// a block, and blocks an SM: the grid is four an SM (ENERGY_BLOCKS), so
// the kernel must fit 64 registers (at 71 it ran 3 an SM, the grid in 1.33
// waves, 47% slower on an H100: PERF.md §6)
constexpr int ENERGY_RUN = 8;
constexpr int ENERGY_THREADS = 256;
constexpr int ENERGY_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

// One word g by the modular reads (the runs off the bulk: a replica's
// first partial run and its last runs, where a plane wraps past M or a
// window would pass word W - 1).
__device__ __forceinline__ void energy_word(const EnergyArgs& a,
                                            const uint32_t* A,
                                            const uint32_t* B, int g,
                                            long long& pm, long long& pe) {
  const int f0 = g * 32;
  const uint32_t vm = valid_bits(a.m, f0);
  const int nb = __popc(vm);
  const uint32_t av = A[g], bv = B[g];
  pm += 2 * (__popc(av & vm) + __popc(bv & vm)) - 2 * nb;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const bool from_a = (k < 2) || (k == 4);  // bonds of a's sites
    const bool into_b = (k < 2) || (k == 4 && !a.self_z) ||
                        (k == 5 && a.self_z);
    int start = f0 + a.d[k];
    if (start >= a.m) start -= a.m;
    const uint32_t nbr = read_circ(into_b ? B : A, a.nw, a.m, start);
    pe += 2 * __popc(((from_a ? av : bv) ^ nbr) & vm) - nb;
  }
}

template <int K, int R>
__device__ __forceinline__ void take(const uint32_t (&v)[K + 4],
                                     uint32_t (&w)[K + 1]) {
#pragma unroll
  for (int j = 0; j <= K; ++j) w[j] = v[R + j];
}

// Words r .. r + K of the K + 4 words from the 16-B aligned p: the
// thread's K / 4 vectors, then the next lane's first vector (its run is
// the next, K words on) by shuffles, or loaded where the next lane holds
// none (lane 31, the last bulk run).  Every lane calls it; a lane off the
// bulk loads nothing.
template <int K>
__device__ __forceinline__ void window(const uint32_t* p, bool mine,
                                       bool self_next, int r,
                                       uint32_t (&w)[K + 1]) {
  uint32_t v[K + 4];
  const uint4* pv = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (mine) x = __ldg(pv + i);
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[K + i] = __shfl_down_sync(FULL, v[i], 1);
  if (mine && self_next) {
    const uint4 x = __ldg(pv + K / 4);
    v[K] = x.x;
    v[K + 1] = x.y;
    v[K + 2] = x.z;
    v[K + 3] = x.w;
  }
  switch (r) {  // uniform: a launch constant of the block
    case 0: take<K, 0>(v, w); break;
    case 1: take<K, 1>(v, w); break;
    case 2: take<K, 2>(v, w); break;
    default: take<K, 3>(v, w); break;
  }
}

// Σ popc(src ^ the plane's words) over a run: word j of the plane is the
// funnel shift of window words j, j + 1 by sh
template <int K>
__device__ __forceinline__ int plane_pop(const uint32_t (&src)[K + 1],
                                         const uint32_t (&w)[K + 1],
                                         int sh) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < K; ++j)
    s += __popc(src[j] ^ __funnelshift_r(w[j], w[j + 1], sh));
  return s;
}

// Word offset mod 4 of p, in words (int32 tensors: p is 4-B aligned)
__device__ __forceinline__ int word_mod4(const uint32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// (m, e) of the final vectors: a grid of (t.blocks, R) blocks, each
// striding over its replica's runs a warp at a time (the lanes of a warp
// hold consecutive runs).  A bulk run loads six windows: a's and b's own
// words (planes 0 and 2, d = 0 and 1, read them) and planes 1, 3, 4, 5's
// words, each as aligned vectors plus the next lane's first; every other
// run takes energy_word a word.  One pair of 64-bit atomics a block.
__global__ void __launch_bounds__(ENERGY_THREADS, ENERGY_MIN_BLOCKS)
    energy_kernel(EnergyArgs a, EnergyRuns t) {
  constexpr int K = ENERGY_RUN;
  const int rep = blockIdx.y;
  const size_t base = static_cast<size_t>(rep) * a.nw;
  const uint32_t* A = a.wa + base;
  const uint32_t* B = a.wb + base;
  const uint32_t* N[6] = {B, B, A, A, a.self_z ? A : B, a.self_z ? B : A};
  const int c = word_mod4(A);
  // each window's word offset in its vector: the same for every run
  int r[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = (word_mod4(N[k]) + t.q[k] - c) & 3;
  const int lane = threadIdx.x & 31;
  long long pm = 0, pe = 0;
  const int stride = gridDim.x * ENERGY_THREADS;
  for (int t0 = blockIdx.x * ENERGY_THREADS + (threadIdx.x & ~31);
       t0 < t.nruns; t0 += stride) {  // uniform over the warp
    const int tr = t0 + lane;
    const int g0 = tr * K - c;
    const bool bulk = tr < t.bulk && g0 >= 0;
    if (t0 < t.bulk) {
      const bool self_next = lane == 31 || tr + 1 >= t.bulk;
      const int g = bulk ? g0 : 0;
      uint32_t av[K + 1], bv[K + 1], w[K + 1];
      window<K>(A + g, bulk, self_next, 0, av);
      window<K>(B + g - r[0], bulk, self_next, r[0], bv);
      int sm = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) sm += __popc(av[j]) + __popc(bv[j]);
      int se = plane_pop<K>(av, bv, 0) + plane_pop<K>(bv, av, 1);
      window<K>(N[1] + g + t.q[1] - r[1], bulk, self_next, r[1], w);
      se += plane_pop<K>(av, w, t.sh[1]);
      window<K>(N[3] + g + t.q[3] - r[3], bulk, self_next, r[3], w);
      se += plane_pop<K>(bv, w, t.sh[3]);
      window<K>(N[4] + g + t.q[4] - r[4], bulk, self_next, r[4], w);
      se += plane_pop<K>(av, w, t.sh[4]);
      window<K>(N[5] + g + t.q[5] - r[5], bulk, self_next, r[5], w);
      se += plane_pop<K>(bv, w, t.sh[5]);
      if (bulk) {
        pm += 2 * sm - 64 * K;
        pe += 2 * se - 6 * 32 * K;
      }
    }
    if (!bulk && tr < t.nruns) {
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
        const int g = g0 + j;
        if (g >= 0 && g < a.nw) energy_word(a, A, B, g, pm, pe);
      }
    }
  }
  block_add<ENERGY_THREADS>(pm, pe, a.obs + 2 * static_cast<size_t>(rep));
}

// The runs as energy_runs builds them, or any that read no word outside
// a replica on the bulk: refuses others
bool energy_runs_ok(const EnergyRuns& t, const EnergyArgs& a, int nrep) {
  constexpr int K = ENERGY_RUN;
  if (t.nruns != (a.nw + 3 + K - 1) / K || t.blocks < 1 ||
      t.blocks > 65535 || nrep < 1 || nrep > 65535 || t.bulk < 0 ||
      t.bulk > t.nruns)
    return false;
  int qmax = 0, dmax = 0;
  for (int k = 0; k < 6; ++k) {
    if (a.d[k] < 0 || a.d[k] >= a.m || t.q[k] != (a.d[k] >> 5) ||
        t.sh[k] != (a.d[k] & 31))
      return false;
    qmax = std::max(qmax, t.q[k]);
    dmax = std::max(dmax, a.d[k]);
  }
  if (t.bulk == 0) return true;
  // planes 0 and 2 read the own windows; the last bulk run's windows end
  // at word W - 1 at the latest and no plane wraps in it
  const long long last = static_cast<long long>(t.bulk - 1) * K;
  return a.d[0] == 0 && a.d[2] == 1 && last + K + 3 + qmax <= a.nw - 1 &&
         32 * (last + K) + dmax <= a.m;
}

struct MultisweepArgs {
  const uint32_t* wa_in;  // (R, W) colour a
  const uint32_t* wb_in;
  uint32_t* wa;           // (R, W) outputs, updated in place
  uint32_t* wb;
  const int32_t* seeds;   // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;         // (R, S, 2) (m, e), zeroed by the caller
  int sweeps;
  Stencil sa, sb;         // colour a's and b's stencils (6 cross planes)
  ChainTable chain;       // the chains of every phase (bernoulli.cuh)
};

// S sweeps, one block a replica.  A phase updates its colour in place: a
// word depends only on itself and on the other colour (odd nx*ny).
__global__ void __launch_bounds__(MS_THREADS, 1)
    multisweep_kernel(MultisweepArgs a) {
  const int r = blockIdx.x, tid = threadIdx.x;
  const int nw = a.sa.nw, m = a.sa.m;
  const size_t base = static_cast<size_t>(r) * nw;
  uint32_t* A = a.wa + base;
  uint32_t* B = a.wb + base;
  for (int g = tid; g < nw; g += MS_THREADS) {
    A[g] = a.wa_in[base + g];
    B[g] = a.wb_in[base + g];
  }
  __syncthreads();
  for (int s = 0; s < a.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      uint32_t* x = phase ? B : A;
      const uint32_t* o = phase ? A : B;
      const Stencil st = phase ? a.sb : a.sa;
      uint2 rk[10];
      philox_round_keys(
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(a.seeds[(2 * s + phase) * 2 + 1]), rk);
      long long pm = 0, pe = 0;
      for (int g = tid; g < nw; g += MS_THREADS) {
        const int f0 = g * 32;
        uint32_t b1, b2, b4c, p4, p8, p12;
        counts(st, x, o, f0, b1, b2, b4c);
        chain_planes(a.chain, rk, static_cast<uint32_t>(r),
                     static_cast<uint32_t>(g), 0u, p4, p8, p12);
        const uint32_t xv = x[g];
        const uint32_t nv = xv ^ flip6(xv, b1, b2, b4c, p4, p8, p12);
        x[g] = nv;
        if (phase)
          word_sums(nv, o[g], b1, b2, b4c, valid_bits(m, f0), true, pm, pe);
      }
      __syncthreads();  // phase boundary
      if (phase)
        block_add<MS_THREADS>(
            pm, pe, a.obs + (static_cast<size_t>(r) * a.sweeps + s) * 2);
    }
  }
}

void set_stencil(Stencil& s, int nw, int m, int ncross, const int* d) {
  s.nw = nw;
  s.m = m;
  s.ncross = ncross;
  for (int k = 0; k < 6; ++k) s.d[k] = d[k];
}

}  // namespace

extern "C" {

// One (sub-)phase of x_in given o -> x_out: ncross cross planes at d[0..]
// and 6 - ncross self planes after them; zsub -1 for every site, 0/1 for
// one z-plane parity (zh colour sites a plane); b4/b8/b12 injected planes
// or null (Philox words under (s0, s1) and the chain table `chain`, the
// 65 words of ChainTable); obs an (R, 2) int64 buffer zeroed by the
// caller, or null.
int helical3d_phase(const void* x_in, void* x_out, const void* o,
                    const void* b4, const void* b8, const void* b12,
                    void* obs, int nrep, int nw, int m, int ncross,
                    const int* d, int zsub, int zh, unsigned int s0,
                    unsigned int s1, const unsigned int* chain,
                    void* stream) {
  PhaseArgs a;
  a.x_in = static_cast<const uint32_t*>(x_in);
  a.x_out = static_cast<uint32_t*>(x_out);
  a.o = static_cast<const uint32_t*>(o);
  a.b4 = static_cast<const uint32_t*>(b4);
  a.b8 = static_cast<const uint32_t*>(b8);
  a.b12 = static_cast<const uint32_t*>(b12);
  a.obs = static_cast<long long*>(obs);
  set_stencil(a.st, nw, m, ncross, d);
  philox_round_keys(s0, s1, a.rk);
  std::memcpy(&a.chain, chain, sizeof(ChainTable));
  if (!chain_table_ok(a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  a.zsub = zsub;
  a.zh = zh;
  const dim3 grid((nw + PHASE_THREADS - 1) / PHASE_THREADS, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncross == 6)
    phase_kernel<6><<<grid, PHASE_THREADS, 0, st>>>(a);
  else if (ncross == 4)
    phase_kernel<4><<<grid, PHASE_THREADS, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// (m, e) of the final vectors into obs (R, 2), zeroed by the caller; d the
// six forward-bond offsets mod M (see EnergyArgs); runs the 15 ints of
// ops/helical3d_multispin.energy_runs (EnergyRuns).
int helical3d_energy(const void* wa, const void* wb, void* obs, int nrep,
                     int nw, int m, const int* d, int self_z,
                     const int* runs, void* stream) {
  EnergyArgs a;
  a.wa = static_cast<const uint32_t*>(wa);
  a.wb = static_cast<const uint32_t*>(wb);
  a.obs = static_cast<long long*>(obs);
  a.nw = nw;
  a.m = m;
  for (int k = 0; k < 6; ++k) a.d[k] = d[k];
  a.self_z = self_z;
  EnergyRuns t;
  std::memcpy(&t, runs, sizeof(EnergyRuns));
  if (!energy_runs_ok(t, a, nrep))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(t.blocks, nrep);
  energy_kernel<<<grid, ENERGY_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

// S sweeps: wa_in/wb_in -> wa/wb, per-sweep (m, e) into obs (R, S, 2),
// zeroed by the caller; da/db the six cross offsets mod M of each colour;
// chain the 65 words of ChainTable (refused unless chain_table_ok).  A
// grid of R blocks of 1024 threads.
int helical3d_multisweep(const void* wa_in, const void* wb_in, void* wa,
                         void* wb, const void* seeds, void* obs, int nrep,
                         int nw, int m, int sweeps, const int* da,
                         const int* db, const unsigned int* chain,
                         void* stream) {
  MultisweepArgs a;
  a.wa_in = static_cast<const uint32_t*>(wa_in);
  a.wb_in = static_cast<const uint32_t*>(wb_in);
  a.wa = static_cast<uint32_t*>(wa);
  a.wb = static_cast<uint32_t*>(wb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.obs = static_cast<long long*>(obs);
  a.sweeps = sweeps;
  set_stencil(a.sa, nw, m, 6, da);
  set_stencil(a.sb, nw, m, 6, db);
  std::memcpy(&a.chain, chain, sizeof(ChainTable));
  if (!chain_table_ok(a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  multisweep_kernel<<<nrep, MS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* helical3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
