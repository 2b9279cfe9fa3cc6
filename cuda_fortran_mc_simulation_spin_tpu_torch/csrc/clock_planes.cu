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
// Observables: each block belongs to one replica (grid.z); it reduces its
// words' exact integer sums and adds them with one 64-bit atomic a value.
//
// Bound on the H100: integer operations.  At kbt 0.91 (q = 6) a word
// draws 12 thermometer words and 78 chain words (81 digits, trailing zero
// digits drawing none), 23 Philox calls (~920 instructions with the round
// keys a launch constant) against 36-60 bytes of traffic.  The design
// spends little beside them:
// - the draw is clock_algebra.cuh's unrolled draw_unrolled<Q>, from the
//   launch's DrawTable and Philox round keys in the kernel's parameters
//   (ops/multispin_rng.clock_draw_table), not the first design's
//   per-chain loops, refill tests, buffer picks and per-call round-key
//   bumps; only the draws the table marks as chain ends pick a chain's
//   output register;
// - no runtime division: the grid is (column tiles of 32 words, word-row
//   tiles, replicas) of 32 x 8 threads, a warp along x so loads coalesce,
//   and every neighbour wraps by compare and select.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "clock_algebra.cuh"

namespace {

constexpr int TILE_X = 32;  // words a tile row (blockDim.x, one warp)
constexpr int TILE_Y = 8;   // word rows a tile (blockDim.y)
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
  uint2 rk[10];           // Philox round keys of this (sample, t, phase)
  clockq::DrawTable table;
};

// Word (X, Y) of replica r (X < half, Y < nyw): its new planes, and with
// a.obs its (2m, 2e) ((m, e) for q = 4) added to (m_sum, e_sum).  HALO: a
// is a shard's (nb = 0), its edges read s's halos; otherwise the planes
// are periodic and s is not read.
template <int Q, bool HALO>
__device__ __forceinline__ void phase_word(const ClockArgs& a,
                                           const ClockShard& s, int r, int X,
                                           int Y, int& m_sum, int& e_sum) {
  using T = clockq::Traits<Q>;
  constexpr int NS = T::NS, NR = T::NR;
  const int nyw = a.nyw, half = a.half, nb = a.nb, top = nyw - 1;
  const size_t base = static_cast<size_t>(r) * nyw * half;
  const int w = Y * half + X;
  const int xm = (X == 0 ? half : X) - 1;
  const int xp = X == half - 1 ? 0 : X + 1;
  const uint32_t low = nb ? (1u << nb) - 1u : 0xFFFFFFFFu;
  const uint32_t vm = (nb && Y == top) ? low : 0xFFFFFFFFu;
  const size_t hrow = static_cast<size_t>(r) * half + X;
  const size_t hcol = static_cast<size_t>(r) * nyw + Y;

  uint32_t n[NS][4];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const uint32_t* o = a.o[k] + base;
    uint32_t c = __ldg(o + w);
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
                               : __ldg(o + w - X + xm);
    const uint32_t plus = HALO && X == half - 1 && s.rt[k] != nullptr
                              ? __ldg(s.rt[k] + hcol)
                              : __ldg(o + w - X + xp);
    n[k][0] = (c << 1) | (prev >> 31);
    n[k][1] = (c >> 1) | (next << 31);
    n[k][2] = c;
    n[k][3] = a.color == 0 ? (plus & ODD_BITS) | (minus & EVEN_BITS)
                           : (minus & ODD_BITS) | (plus & EVEN_BITS);
  }
  uint32_t rnd[NR];
  if (a.inj != nullptr) {
    const size_t plane = static_cast<size_t>(a.nrep) * nyw * half;
#pragma unroll
    for (int i = 0; i < NR; ++i) rnd[i] = __ldg(a.inj + i * plane + base + w);
  } else {
    clockq::draw_unrolled<Q>(
        a.table, a.rk, static_cast<uint32_t>(r) + (HALO ? s.rep0 : 0u),
        static_cast<uint32_t>(Y) + (HALO ? s.wrow0 : 0u),
        static_cast<uint32_t>(X) + (HALO ? s.col0 : 0u), rnd);
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
  if (a.obs == nullptr) return;
  const int nsite = __popc(vm);
  if constexpr (Q == 6) {
    m_sum += clockq::m2_word6(x[0], x[1], x[2], vm) +
             clockq::m2_word6(n[0][2], n[1][2], n[2][2], vm);
    int sx = 0, sw = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      sx += __popc(f1[b] & vm);
      sw += __popc(f2[b] & vm);
    }
    e_sum += 4 * nsite + sx - 3 * sw;
  } else if constexpr (Q == 4) {
    const uint32_t na = ~x[0] & vm, nao = ~n[0][2] & vm;
    m_sum += __popc(na & ~x[1]) - __popc(na & x[1]) +
             __popc(nao & ~n[1][2]) - __popc(nao & n[1][2]);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t nab = ~f1[b] & vm;
      e_sum += __popc(nab & f2[b]) - __popc(nab & ~f2[b]);
    }
  } else {
    m_sum += 3 * __popc(~(x[0] | x[1]) & vm) +
             3 * __popc(~(n[0][2] | n[1][2]) & vm) - 2 * nsite;
    int se = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) se += __popc(f1[b] & vm);
    e_sum += 4 * nsite - 3 * se;
  }
}

// One colour phase: a grid of (ceil(half / 32), ceil(nyw / 8), R) blocks
// of 32 x 8 threads, one word a thread; the partial edge tiles' threads
// past half or nyw only join the sums.
template <int Q, bool HALO>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
    phase_kernel(ClockArgs a, ClockShard s) {
  __shared__ int red[2][TILE_Y];
  const int r = blockIdx.z;
  const int X = blockIdx.x * TILE_X + threadIdx.x;
  const int Y = blockIdx.y * TILE_Y + threadIdx.y;
  int m_sum = 0, e_sum = 0;
  if (X < a.half && Y < a.nyw)
    phase_word<Q, HALO>(a, s, r, X, Y, m_sum, e_sum);
  if (a.obs == nullptr) return;  // uniform across the block
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    m_sum += __shfl_down_sync(0xFFFFFFFFu, m_sum, off);
    e_sum += __shfl_down_sync(0xFFFFFFFFu, e_sum, off);
  }
  if (threadIdx.x == 0) {
    red[0][threadIdx.y] = m_sum;
    red[1][threadIdx.y] = e_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    long long bm = 0, be = 0;
#pragma unroll
    for (int i = 0; i < TILE_Y; ++i) {
      bm += red[0][i];
      be += red[1][i];
    }
    unsigned long long* dst =
        reinterpret_cast<unsigned long long*>(a.obs) + 2 * static_cast<size_t>(r);
    atomicAdd(dst, static_cast<unsigned long long>(bm));
    atomicAdd(dst + 1, static_cast<unsigned long long>(be));
  }
}

// The launch's arguments; table null in the injected mode (use_inj),
// else the 167 words of the DrawTable (ops/multispin_rng.clock_draw_table)
ClockArgs make_args(const void* const* planes, const void* inj, void* obs,
                    int nrep, int nyw, int half, int nb, int color,
                    int use_inj, unsigned int s0, unsigned int s1,
                    const unsigned int* table) {
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
  philox_round_keys(s0, s1, a.rk);
  if (table != nullptr)
    std::memcpy(&a.table, table, sizeof(clockq::DrawTable));
  else
    std::memset(&a.table, 0, sizeof(clockq::DrawTable));
  return a;
}

template <bool HALO>
int launch(int q, const ClockArgs& a, const ClockShard& s, cudaStream_t st) {
  if (a.inj == nullptr &&
      !clockq::draw_table_ok(a.table, q == 3 ? 1 : 12))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.half + TILE_X - 1) / TILE_X,
                  (a.nyw + TILE_Y - 1) / TILE_Y, a.nrep);
  const dim3 block(TILE_X, TILE_Y);
  switch (q) {
    case 6:
      phase_kernel<6, HALO><<<grid, block, 0, st>>>(a, s);
      break;
    case 4:
      phase_kernel<4, HALO><<<grid, block, 0, st>>>(a, s);
      break;
    case 3:
      phase_kernel<3, HALO><<<grid, block, 0, st>>>(a, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One colour phase of the q-state packed engine: a grid of
// (ceil(half/32), ceil(nyw/8), R) blocks of 32 x 8 threads.  x*/out*/o*
// are the state planes (the third null for q = 4 and q = 3); inj the
// stacked injected planes when use_inj, else Philox words under (s0, s1)
// and the draw table `table` (167 words); obs an (R, 2) int64 buffer
// zeroed by the caller, or null.
int clock_phase(int q, const void* x0, const void* x1, const void* x2,
                void* out0, void* out1, void* out2, const void* o0,
                const void* o1, const void* o2, const void* inj, void* obs,
                int nrep, int nyw, int half, int nb, int color, int use_inj,
                unsigned int s0, unsigned int s1, const unsigned int* table,
                void* stream) {
  const void* planes[9] = {x0, x1, x2, out0, out1, out2, o0, o1, o2};
  if (nyw < 2 || half < 2 || nb < 0 || nb > 31 || nrep < 1 ||
      nrep > 65535 || (!use_inj && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClockArgs a = make_args(planes, inj, obs, nrep, nyw, half, nb, color,
                                use_inj, s0, s1, use_inj ? nullptr : table);
  return launch<false>(q, a, ClockShard{},
                       static_cast<cudaStream_t>(stream));
}

// One colour phase of a shard: planes[0..20] are x[3], out[3], o[3] (as
// for clock_phase), then the halos up[3], dn[3] ((R, 1, half) 0/1) and
// lf[3], rt[3] ((R, nyw, 1) word columns, all null without an x split);
// (rep0, wrow0, col0) the shard's global replica, word row and column;
// table as for clock_phase.
int clock_halo_phase(int q, const void* const* planes, const void* inj,
                     void* obs, int nrep, int nyw, int half, int color,
                     int use_inj, int rep0, int wrow0, int col0,
                     unsigned int s0, unsigned int s1,
                     const unsigned int* table, void* stream) {
  if (nyw < 1 || half < 1 || nrep < 1 || nrep > 65535 || rep0 < 0 ||
      wrow0 < 0 || col0 < 0 || (!use_inj && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClockArgs a = make_args(planes, inj, obs, nrep, nyw, half, 0, color,
                                use_inj, s0, s1, use_inj ? nullptr : table);
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
  if ((s.lf[0] == nullptr) != (s.rt[0] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, a, s, static_cast<cudaStream_t>(stream));
}

const char* clock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
