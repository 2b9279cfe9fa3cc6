// The masked helical kernels on Hopper (sm_90a): every helical 2-D shape
// (odd nx, any ny >= 2) of the Ising, clock and XY models on flat states.
//
//   ising_multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/
//                     ops/helical_pallas.py:_ising_kernel (pallas_call at
//                     :216, _ising_multisweep): S sweeps (colour 0, then
//                     colour 1) of (R, N) int8 ±1 states, in place, with
//                     the exact int64 (m, e) of every sweep;
//   clock_multisweep_kernel replaces _clock_kernel (:373,
//                     _clock_multisweep): the same for the q-state clock,
//                     2 <= q <= 127, float64 (Σ cos, Σ sin, E);
//   xy_phase_kernel   replaces _xy_phase_kernel (:555, _xy_phase): one
//                     Metropolis phase of (R, N) float32 component planes,
//                     out of place; mode FUSED adds the float64 sums of the
//                     new state (even N), mode MEASURE takes the sums of a
//                     state and updates nothing; mode OVER replaces
//                     _xy_or_kernel (:579, _xy_or_phase): one
//                     over-relaxation phase, out of place, on the same
//                     tiles and loader.
//
// Layout (ops/helical_pallas.py): site idx of a replica neighbours idx ± 1
// and idx ± nx mod N; colour c holds idx = 2k + c.  Fields are summed
// ((up + dn) + left) + right, up = idx - nx, the TPU kernels' order.  The
// TPU kernels' (ny, 128-lane) view, row tiles and x-seam fixups are TPU
// layout: the flat index is the same site.
//
// Odd N: same-colour neighbours meet across the wrap (rows 0 and ny-1, and
// idx 0 with N-1).  A phase reads their pre-phase values: the XY kernels
// write out of place; the multisweep kernels copy rows 0 and ny-1 into a
// snapshot before each phase (a grid barrier between) and read those rows
// from it.  At even N the colouring is proper and each sweep's energy is
// fused into the colour-1 phase (-Σ_1 s·Σnbr, each bond once); at odd N it
// is taken in a pass over the final state after the last barrier.
//
// Random words: the unit's one Philox4x32-10 call at counter
// (replica, unit, 0, 0) under the phase key; an Ising unit is four colour
// sites (site k takes output k & 3), a clock or XY unit two (site k takes
// outputs 2(k & 1) and 2(k & 1) + 1, uniforms from their top 24 bits).
//
// Tiles of the two multisweeps and the XY kernel's four modes
// (ops/helical_pallas.py ising_tiles, xy_tiles): a thread takes 16-B
// aligned vectors of a replica (16 bytes, 4 floats) and reads its own
// vector, the aligned vectors under its up window (sites - nx) and its
// down window (+ nx) and their successors, and its ±1 neighbours, all
// before it stores its vector: the multisweeps from a tile staged in
// shared memory, the XY modes from registers and the neighbour lanes.
// Only the vectors that reach past a replica (a wrap mod N, a replica
// base that is not 16-B aligned, at odd N the seam rows' snapshot) take
// the per-element path.
//
// Bounds on the H100.  The multisweep kernels: operations (a launch reads
// and writes the states once, then runs 2 S phases of ~30 (Ising) or ~80
// (clock) instructions a site, Philox included; the states of the main
// paths, 4-128 MB, stay in the 50 MB L2 or stream through it: a phase of
// the 128 MB class reads and writes it from device memory).  The XY
// kernels: bytes (each site's 8 B read and written, 16 B a site a phase
// out of place; the Metropolis phase adds half a Philox call, the trig and
// expf a site of the colour, ~70 instructions; the over-relaxation two
// rsqrtf and ~25 instructions).
//
// Every float32 operation of an update is spelled __fadd_rn / __fmul_rn /
// __fsub_rn in the plain version's order (no FMA contraction); expf and
// rsqrtf are the functions torch.exp and torch.rsqrt call on CUDA tensors,
// so kernel and plain version agree bitwise on the card.  Sums: int64
// atomics (Ising, exact in any order), else float64 per tile or block in a
// fixed order and per (replica, sweep) by xy::reduce_kernel: no float
// atomics.
#include <cooperative_groups.h>

#include "byte_tiles.cuh"
#include "clock_int8.cuh"
#include "ising_int8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Flat {
  int n;    // sites a replica
  int nx;   // odd
  int m0;   // colour-0 sites, ceil(n / 2); colour 1 has n / 2
};

__device__ __forceinline__ int colour_sites(const Flat& f, int c) {
  return c ? f.n / 2 : f.m0;
}

// Copies rows 0 and ny-1 of every replica into seam (R, 2 nx); the caller
// waits at a grid barrier before reading it.
template <typename T>
__device__ __forceinline__ void copy_seam(const T* x, T* seam, const Flat& f,
                                          int nrep) {
  const long long per = 2LL * f.nx;
  const long long total = per * nrep;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = i / per;
    const int p = static_cast<int>(i - r * per);
    const int src = p < f.nx ? p : f.n - 2 * f.nx + p;
    seam[i] = __ldcg(x + r * f.n + src);
  }
}

// u mod n for any u (the per-element path: a replica's ends, small N)
__device__ __forceinline__ int wrap_any(int u, int n) {
  if (u >= 0 && u < n) return u;
  u %= n;
  return u < 0 ? u + n : u;
}

// ---------------------------------------------------------------------------
// Ising
// ---------------------------------------------------------------------------
//
// A phase streams the (R, N) bytes in tiles of THREADS 16-B vectors (4 KB).
// The vectors of replica r are the aligned ones its bytes touch, from
// v = rb >> 4 on, rb = off0 + r N its first byte past the aligned address
// below x; tile ts takes vectors THREADS ts .. THREADS ts + 255, thread t
// vector t: sites a .. a + 15 of the replica, a = 16 v - rb (a < 0 or
// a + 16 > N at a replica's ends, where the bytes past it belong to the
// next replica or the last).  The up sites a - nx .. a - nx + 15 are bytes
// ou .. ou + 15 (ou = -nx mod 16) of the aligned vector at a - nx - ou and
// the next one; the down sites bytes od .. od + 15 (od = nx mod 16) of the
// pair at a + nx - od.  A block stages a tile's vectors in shared memory
// (IsingStage) by asynchronous 16-B copies, the next tile's while it
// computes one, then each lane reads its own vector, its neighbours' edge
// bytes and its window pairs there.  A lane's new vector is stored whole,
// the other colour's bytes as staged: no other block writes them in the
// phase.  The blocks walk the tiles replica-major, gridDim.x apart.

struct IsingMs {
  int8_t* x;              // (R, N), updated in place
  int8_t* seam;           // (R, 2 nx) snapshot at odd N, else null
  const int32_t* seeds;   // (S, 2, 2) Philox keys per (sweep, colour)
  const uint32_t* bits;   // (S, 2, R, m0) injected words, or null
  long long* obs;         // (R, S, 2), zeroed by the caller
  int nrep, sweeps;
  uint32_t t4, t8;
};

struct IsingTiles {
  int off0;            // bytes of x past the 16-B aligned address below it
  int tpr;             // tiles a replica (its vectors, at most, / THREADS)
  int ou, od;          // -nx mod 16, nx mod 16
  int step_r, step_s;  // the grid's blocks = step_r tpr + step_s
};

// Where byte j (in [0, N)) of a replica's state is read as of the
// phase's start: the state, or at odd N (seam set) for a wrapped read
// (`wrapped`) of row 0 or ny-1 the snapshot.
template <bool ODD>
__device__ __forceinline__ const int8_t* byte_src(const int8_t* xr,
                                                  const int8_t* seam,
                                                  const Flat& f, int j,
                                                  bool wrapped) {
  if (ODD && seam != nullptr && wrapped) {
    if (j < f.nx) return seam + j;
    if (j >= f.n - f.nx) return seam + (j - (f.n - 2 * f.nx));
  }
  return xr + j;
}

// Bytes u .. u + 15 of a replica (any u) by 16 independent byte loads,
// each wrapped mod N: the per-element path, out of line (inlined at its
// seven call sites it cost the main path registers).  Loads bypass L1.
template <bool ODD>
__device__ __noinline__ uint4 bytes16(const int8_t* xr, const int8_t* seam,
                                         const Flat& f, int u) {
  const int j0 = wrap_any(u, f.n);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int j = j0 + i;
    while (j >= f.n) j -= f.n;  // once at most, but at N < 16
    const bool wrapped = u + i < 0 || u + i >= f.n;
    w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                     __ldcg(byte_src<ODD>(xr, seam, f, j, wrapped))))
                 << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages bytes u .. u + 15 of a replica (u + rb a multiple of 16) into
// dst: an asynchronous 16-B copy (L2 to shared memory) where they lie in
// the replica, else the byte path; either is seen after the caller's wait
// and barrier.
template <bool ODD>
__device__ __forceinline__ void stage16(uint4* dst, const int8_t* xr,
                                        const int8_t* seam, const Flat& f,
                                        int u) {
  if (u >= 0 && u <= f.n - 16)
    tiles8::cp_async16(dst, xr + u);
  else
    *dst = bytes16<ODD>(xr, seam, f, u);
}

__device__ __forceinline__ uint4 shfl_down4(const uint4& v) {
  return make_uint4(__shfl_down_sync(FULL, v.x, 1),
                    __shfl_down_sync(FULL, v.y, 1),
                    __shfl_down_sync(FULL, v.z, 1),
                    __shfl_down_sync(FULL, v.w, 1));
}

// Bytes sh .. sh + 15 of the 32 bytes lo, hi as four words (0 <= sh < 16,
// the same in every lane)
__device__ __forceinline__ void window16(const uint4& lo, const uint4& hi,
                                         int sh, uint32_t (&out)[4]) {
  const uint32_t p[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t t[6], u[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) t[k] = (sh & 8) ? p[k + 2] : p[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) u[k] = (sh & 4) ? t[k + 1] : t[k];
  const uint32_t b = 8u * static_cast<uint32_t>(sh & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __funnelshift_r(u[k], u[k + 1], b);
}

// The bytes of word j (sites a + 4j .. a + 4j + 3) that lie in the replica
__device__ __forceinline__ uint32_t in_replica(int a, int j, int n) {
  uint32_t mask = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = a + 4 * j + q;
    if (idx >= 0 && idx < n) mask |= 0xFFu << (8 * q);
  }
  return mask;
}

// Adds the block's (m, e) to dst[0], dst[1] with one 64-bit atomic each
// (exact in any order): ising8::block_add without its closing barrier,
// since the caller's next one (ising_pass's after each tile) comes before
// it is called again.  Every thread calls it.
__device__ __forceinline__ void tile_add(int m, int e, long long* dst) {
  __shared__ int red[2][THREADS / 32];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    m += __shfl_down_sync(FULL, m, off);
    e += __shfl_down_sync(FULL, e, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = m;
    red[1][threadIdx.x >> 5] = e;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long bm = 0, be = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
      bm += red[0][k];
      be += red[1][k];
    }
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(bm));
    atomicAdd(reinterpret_cast<unsigned long long*>(dst) + 1,
              static_cast<unsigned long long>(be));
  }
}

// Tile ts of replica r: its first vector v0 (lane t holds v0 + t), the
// replica's last vector vl and the site a0 of byte 0 of vector v0.
struct TileAt {
  long long v0, vl;
  int a0;
};

__device__ __forceinline__ TileAt tile_at(const Flat& f, const IsingTiles& g,
                                          int r, int ts) {
  const long long rb = g.off0 + static_cast<long long>(r) * f.n;
  TileAt t;
  t.v0 = (rb >> 4) + static_cast<long long>(ts) * THREADS;
  t.vl = (rb + f.n - 1) >> 4;
  t.a0 = static_cast<int>(16 * t.v0 - rb);
  return t;
}

// One tile's windows in shared memory: own[k] holds the tile's vector
// k - 1, so lane t's left byte is the top byte of own[t] and its right
// byte the low byte of own[t + 2]; up[k] and dn[k] the aligned vectors
// under lane k's up and down windows (lane t's pairs are up[t], up[t + 1]
// and dn[t], dn[t + 1]).
struct IsingStage {
  uint4 own[THREADS + 2];
  uint4 up[THREADS + 1];
  uint4 dn[THREADS + 1];
};

// Starts staging tile ts of replica r into st (UP: with the up window;
// the odd-N sums need only the own and down ones): every lane up to one
// past the replica's last vector stages its three vectors, and threads
// 0-3 the vector before the tile and, where the tile's last lane holds
// a vector of the replica, the three after it.  Then one commit.
template <bool ODD, bool UP>
__device__ __forceinline__ void stage_tile(IsingStage& st, int8_t* x,
                                           int8_t* seam_all, const Flat& f,
                                           const IsingTiles& g, int r,
                                           int ts) {
  const TileAt ta = tile_at(f, g, r, ts);
  const int8_t* xr = x + static_cast<size_t>(r) * f.n;
  const int8_t* seam =
      ODD && seam_all != nullptr ? seam_all + static_cast<size_t>(r) * 2 * f.nx
                                 : nullptr;
  const int t = threadIdx.x;
  const long long last = ta.vl - ta.v0;  // the tile's last lane of the replica
  const int a = ta.a0 + 16 * t;
  if (t <= last + 1) {
    stage16<ODD>(&st.own[t + 1], xr, seam, f, a);
    if (UP) stage16<ODD>(&st.up[t], xr, seam, f, a - f.nx - g.ou);
    stage16<ODD>(&st.dn[t], xr, seam, f, a + f.nx - g.od);
  }
  const int end = ta.a0 + 16 * THREADS;
  if (t == 0 && last >= 0) stage16<ODD>(&st.own[0], xr, seam, f, ta.a0 - 16);
  if (last >= THREADS - 1) {
    if (t == 1) stage16<ODD>(&st.own[THREADS + 1], xr, seam, f, end);
    if (UP && t == 2)
      stage16<ODD>(&st.up[THREADS], xr, seam, f, end - f.nx - g.ou);
    if (t == 3) stage16<ODD>(&st.dn[THREADS], xr, seam, f, end + f.nx - g.od);
  }
  cp_async_commit();
}

// Colour c's phase on tile ts of replica r from its staged windows.
// bits: the phase's injected words (R, m0), or null for Philox words
// under the round keys rk.  With MEASURE (colour 1 at even N) it adds Σ of
// the new bytes (every site once over the tiles) and -Σ_1 new·nsum into
// dst (the colour-0 sites are final: each bond once).  Every thread calls
// it.
template <bool MEASURE>
__device__ __forceinline__ void ising_tile(const IsingStage& st,
                                           const IsingMs& ms, const Flat& f,
                                           const IsingTiles& g, int c, int r,
                                           int ts, const uint2 (&rk)[10],
                                           const uint32_t* bits,
                                           long long* dst) {
  const TileAt ta = tile_at(f, g, r, ts);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long v = ta.v0 + t;
  int m = 0, e = 0;
  if (v - lane <= ta.vl) {  // the warp holds a vector of the replica
    const int a = ta.a0 + 16 * t;
    // colour c's sites of the vector: bytes p0 + 2i, colour sites k0 + i
    const int p0 = (c - a) & 1;
    const int k0 = (a + p0 - c) >> 1;
    const int om = k0 & 3;  // the same in every lane of the tile
    uint32_t wd[8];
    if (bits == nullptr) {
      // units k0 >> 2 and the next from this lane; where the sites start
      // inside a unit (om > 0), the one after (the next lane's first) by
      // a shuffle
      const int u0 = k0 >> 2;
      const uint4 w0 = philox_rk(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(u0), 0u,
                     0u), rk);
      const uint4 w1 = philox_rk(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(u0 + 1),
                     0u, 0u), rk);
      if (om == 0) {
        wd[0] = w0.x, wd[1] = w0.y, wd[2] = w0.z, wd[3] = w0.w;
        wd[4] = w1.x, wd[5] = w1.y, wd[6] = w1.z, wd[7] = w1.w;
      } else {
        uint4 w2 = shfl_down4(w0);
        if (lane == 31)
          w2 = philox_rk(make_uint4(static_cast<uint32_t>(r),
                                    static_cast<uint32_t>(u0 + 2), 0u, 0u),
                         rk);
        const uint32_t w[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                                w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
        uint32_t tw[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) tw[k] = (om & 2) ? w[k + 2] : w[k];
#pragma unroll
        for (int i = 0; i < 8; ++i) wd[i] = (om & 1) ? tw[i + 1] : tw[i];
      }
    } else {
      const uint32_t* row = bits + static_cast<size_t>(r) * f.m0;
      const int mc = colour_sites(f, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + i;
        wd[i] = (k >= 0 && k < mc) ? __ldg(row + k) : 0u;
      }
    }
    if (v <= ta.vl) {
      const uint4 own = st.own[t + 1];
      const uint32_t lb = st.own[t].w >> 24;
      const uint32_t rt = st.own[t + 2].x & 0xFFu;
      uint32_t up[4], dn[4];
      window16(st.up[t], st.up[t + 1], g.ou, up);
      window16(st.dn[t], st.dn[t + 1], g.od, dn);
      const uint32_t o[4] = {own.x, own.y, own.z, own.w};
      uint32_t ns[4];  // the bytes' neighbour sums (in [-4, 4]: no carries)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t left =
            __funnelshift_r(j > 0 ? o[j > 0 ? j - 1 : 0] : lb << 24, o[j], 24);
        const uint32_t right =
            __funnelshift_r(o[j], j < 3 ? o[j < 3 ? j + 1 : 3] : rt, 8);
        ns[j] = __vadd4(__vadd4(up[j], dn[j]), __vadd4(left, right));
      }
      const bool whole = a >= 0 && a <= f.n - 16;
      uint32_t nw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k = s·nsum a byte (s = ±1: nsum, or its negation where s < 0),
        // and the bytes where k <= 0 (always flipped) and where k = 2
        const uint32_t neg = __vcmplts4(o[j], 0u);
        const uint32_t kk = __vsub4(ns[j] ^ neg, neg);
        const uint32_t le0 = __vcmples4(kk, 0u);
        const uint32_t eq2 = __vcmpeq4(kk, 0x02020202u);
        uint32_t flip = 0u;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 2 * j + q;
          const int b = 8 * (p0 + 2 * q);
          bool acc = ((le0 >> b) & 1u) != 0u ||
                     wd[i] < (((eq2 >> b) & 1u) != 0u ? ms.t4 : ms.t8);
          if (!whole) {
            const int idx = a + p0 + 2 * i;
            acc = acc && idx >= 0 && idx < f.n;
          }
          if (acc) flip |= 0xFEu << b;  // -s of s = ±1
        }
        nw[j] = o[j] ^ flip;
      }
      int8_t* xr = ms.x + static_cast<size_t>(r) * f.n;
      if (whole) {
        __stcg(reinterpret_cast<uint4*>(xr + a),
               make_uint4(nw[0], nw[1], nw[2], nw[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = a + p0 + 2 * i;
          if (idx >= 0 && idx < f.n)
            xr[idx] = static_cast<int8_t>(nw[i >> 1] >>
                                          (8 * (p0 + 2 * (i & 1))));
        }
      }
      if (MEASURE) {
        const uint32_t cm = (0xFFu << (8 * p0)) | (0xFFu << (8 * (p0 + 2)));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t vm = whole ? FULL : in_replica(a, j, f.n);
          m = __dp4a(static_cast<int>(nw[j] & vm), 0x01010101, m);
          e -= __dp4a(static_cast<int>(nw[j] & vm & cm),
                      static_cast<int>(ns[j]), 0);
        }
      }
    }
  }
  if (MEASURE) tile_add(m, e, dst);
}

// (m, e) of tile ts of replica r over the final state from its staged own
// and down windows: every site once, e over its bonds to idx + 1 and
// idx + nx (each bond once).  Every thread calls it.
__device__ __forceinline__ void ising_measure_tile(const IsingStage& st,
                                                   const Flat& f,
                                                   const IsingTiles& g,
                                                   int r, int ts,
                                                   long long* dst) {
  const TileAt ta = tile_at(f, g, r, ts);
  const int t = threadIdx.x;
  int m = 0, e = 0;
  if (ta.v0 + t <= ta.vl) {
    const int a = ta.a0 + 16 * t;
    const uint4 own = st.own[t + 1];
    const uint32_t rt = st.own[t + 2].x & 0xFFu;
    uint32_t dn[4];
    window16(st.dn[t], st.dn[t + 1], g.od, dn);
    const uint32_t o[4] = {own.x, own.y, own.z, own.w};
    const bool whole = a >= 0 && a <= f.n - 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t right =
          __funnelshift_r(o[j], j < 3 ? o[j < 3 ? j + 1 : 3] : rt, 8);
      const int s = static_cast<int>(o[j] & (whole ? FULL
                                                   : in_replica(a, j, f.n)));
      m = __dp4a(s, 0x01010101, m);
      e -= __dp4a(s, static_cast<int>(__vadd4(right, dn[j])), 0);
    }
  }
  tile_add(m, e, dst);
}

// The next tile of a block: gridDim.x tiles on, stepped without a division
__device__ __forceinline__ void next_tile(const IsingTiles& g, int& r,
                                          int& ts) {
  ts += g.step_s;
  r += g.step_r;
  if (ts >= g.tpr) {
    ts -= g.tpr;
    ++r;
  }
}

// Tiles a block stages ahead of the one it computes, plus that one
constexpr int STAGES = 2;

// One pass of a block over its tiles from (r0, ts0) of the states ms.x
// (ms.seam the snapshot, ms.nrep replicas; IsingMs or ClockMs): tiles
// i + 1 .. i + STAGES - 1 are in flight while tile i is computed by
// `body(stage, r, ts)`; a group is committed every step, empty past the
// last tile, so the wait is always for the oldest.
template <bool ODD, bool UP, typename Ms, typename Body>
__device__ __forceinline__ void ising_pass(IsingStage (&st)[STAGES],
                                           const Ms& ms, const Flat& f,
                                           const IsingTiles& g, int r0,
                                           int ts0, Body body) {
  int rp = r0, tp = ts0;  // the next tile to stage
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (rp < ms.nrep)
      stage_tile<ODD, UP>(st[k], ms.x, ms.seam, f, g, rp, tp);
    else
      cp_async_commit();
    next_tile(g, rp, tp);
  }
  int r = r0, ts = ts0, cur = 0;
  while (r < ms.nrep) {
    const int ahead = cur == 0 ? STAGES - 1 : cur - 1;
    if (rp < ms.nrep)
      stage_tile<ODD, UP>(st[ahead], ms.x, ms.seam, f, g, rp, tp);
    else
      cp_async_commit();
    next_tile(g, rp, tp);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    body(st[cur], r, ts);
    __syncthreads();  // the stage is read before it is staged again
    next_tile(g, r, ts);
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }
}

template <bool ODD>
__global__ void __launch_bounds__(THREADS)
    ising_multisweep_kernel(IsingMs ms, Flat f, IsingTiles g) {
  __shared__ IsingStage st[STAGES];
  cg::grid_group grid = cg::this_grid();
  // the block's first tile (one division a launch)
  const int r0 = blockIdx.x / g.tpr;
  const int ts0 = blockIdx.x - r0 * g.tpr;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      if (ODD) {
        copy_seam(ms.x, ms.seam, f, ms.nrep);
        grid.sync();
      }
      uint2 rk[10];
      philox_round_keys(static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2]),
                        static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2 + 1]),
                        rk);
      const uint32_t* bits =
          ms.bits == nullptr
              ? nullptr
              : ms.bits + static_cast<size_t>(2 * s + c) * ms.nrep * f.m0;
      ising_pass<ODD, true>(
          st, ms, f, g, r0, ts0,
          [&](const IsingStage& stage, int r, int ts) {
            long long* dst =
                ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2;
            if (!ODD && c == 1)
              ising_tile<true>(stage, ms, f, g, c, r, ts, rk, bits, dst);
            else
              ising_tile<false>(stage, ms, f, g, c, r, ts, rk, bits, dst);
          });
      grid.sync();
    }
    if (ODD) {
      // the exact sums of the final state (staged without the snapshot);
      // the next sweep's snapshot only reads the state too, so no barrier
      // is needed before it
      IsingMs plain = ms;
      plain.seam = nullptr;
      ising_pass<ODD, false>(
          st, plain, f, g, r0, ts0,
          [&](const IsingStage& stage, int r, int ts) {
            ising_measure_tile(
                stage, f, g, r, ts,
                ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2);
          });
    }
  }
}

// ---------------------------------------------------------------------------
// clock
// ---------------------------------------------------------------------------
//
// The clock multisweep runs on the Ising multisweep's tiles (IsingStage,
// stage_tile, ising_pass): lane t of a tile holds the aligned vector of
// sites a .. a + 15, eight of colour c (bytes p0 + 2i, colour sites
// k0 + i), and reads their neighbours from its own, up and down windows
// and its neighbour lanes' edge bytes.  A clock unit is two colour sites,
// so a lane's sites are four units: units k0 / 2 .. + 3 where k0 is even,
// else the second half of unit k0 >> 1, three whole units and the first
// half of the next lane's first unit (k0 & 1 is the same in every lane of
// a tile), whose words a shuffle brings and lane 31 draws itself.  A
// state indexes the staged tables, (cos, sin) as float2 for the update
// and as double2 for the sums.  The first design, one thread a unit with
// five byte loads from L2 a site at indices wrapped one by one, a
// division a tile and the round keys recomputed in every Philox call, ran
// at 23% of its bound; this one at 36% (PERF.md §6).

struct ClockMs {
  int8_t* x;              // (R, N) states in [0, q), updated in place
  int8_t* seam;           // (R, 2 nx) snapshot at odd N, else null
  const int32_t* seeds;   // (S, 2, 2)
  const float* ucand;     // (S, 2, R, m0) injected uniforms, or null
  const float* uacc;
  const float* tab;       // (2, 128) float32 (cos, sin)
  const double* tab64;    // (2, 128) float64 (cos, sin)
  double* partials;       // (R, S, tpr, 3): a partial a tile
  int nrep, sweeps, q;
  float neg_beta;
};

// Byte b (0 .. 3) of w as a table index (the mask keeps a corrupt byte
// inside the table; it is the identity on [0, q))
__device__ __forceinline__ int state_at(uint32_t w, int b) {
  return static_cast<int>((w >> (8 * b)) & (clock8::TABLE - 1));
}

// The new state of a site in state xs given its neighbours' states (up,
// down, left, right) and its uniforms: the field ((up + dn) + left) +
// right, candidate xs + trunc(uc (q - 1)) + 1 mod q, accepted iff
// ua < expf(-β max(ΔE, 0)), every float32 operation in the plain
// version's order.
__device__ __forceinline__ int clock_site(const float2* tab, int xs, int ou,
                                          int od, int ol, int orr, float uc,
                                          float ua, int q, float neg_beta) {
  const float2 fu = tab[ou], fd = tab[od], fl = tab[ol], fr = tab[orr];
  const float hx = __fadd_rn(__fadd_rn(__fadd_rn(fu.x, fd.x), fl.x), fr.x);
  const float hy = __fadd_rn(__fadd_rn(__fadd_rn(fu.y, fd.y), fl.y), fr.y);
  int nw = xs + static_cast<int>(__fmul_rn(uc, static_cast<float>(q - 1))) +
           1;
  if (nw >= q) nw -= q;
  const float2 fn = tab[nw], fo = tab[xs];
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(fn.x, fo.x), hx),
                              __fmul_rn(__fsub_rn(fn.y, fo.y), hy));
  const float prob = expf(__fmul_rn(neg_beta, fmaxf(de, 0.0f)));
  return ua < prob ? nw : xs;
}

// Colour c's clock phase on tile ts of replica r from its staged
// windows.  uc, ua: the replica's injected uniforms (m0 a row), or null
// for Philox words under the round keys rk.  With MEASURE (colour 1 at
// even N) it adds the float64 Σ cos, Σ sin of the new state and of the
// colour-0 site before each (its left neighbour), and S_new·h over the
// site's bonds (the colour-0 sites are final: each bond once), into the
// tile's partial of row `part` (xy::reduce_kernel negates E).  Every
// thread calls it.
template <bool MEASURE>
__device__ __forceinline__ void clock_tile(const IsingStage& st,
                                           const ClockMs& ms, const Flat& f,
                                           const IsingTiles& g,
                                           const float2* tab,
                                           const double2* tab64, int c,
                                           int r, int ts,
                                           const uint2 (&rk)[10],
                                           const float* uc, const float* ua,
                                           size_t part) {
  const TileAt ta = tile_at(f, g, r, ts);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long v = ta.v0 + t;
  xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
  if (v - lane <= ta.vl) {  // the warp holds a vector of the replica
    const int a = ta.a0 + 16 * t;
    // colour c's sites of the vector: bytes p0 + 2i, colour sites k0 + i
    const int p0 = (c - a) & 1;
    const int k0 = (a + p0 - c) >> 1;
    const bool odd_k = (k0 & 1) != 0;
    const int u0 = k0 >> 1;
    // unit u0's words, and the first half of the next lane's unit
    // u0 + 4 (lane 31: its own call), which feeds this lane's last site
    // where k0 is odd
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    uint32_t nx0 = 0u, nx1 = 0u;
    if (uc == nullptr) {
      w = philox_rk(make_uint4(static_cast<uint32_t>(r),
                               static_cast<uint32_t>(u0), 0u, 0u), rk);
      nx0 = __shfl_down_sync(FULL, w.x, 1);
      nx1 = __shfl_down_sync(FULL, w.y, 1);
      if (odd_k && lane == 31) {
        const uint4 wn = philox_rk(
            make_uint4(static_cast<uint32_t>(r),
                       static_cast<uint32_t>(u0 + 4), 0u, 0u), rk);
        nx0 = wn.x;
        nx1 = wn.y;
      }
    }
    if (v <= ta.vl) {
      const uint4 own = st.own[t + 1];
      const uint32_t lb = st.own[t].w >> 24;
      const uint32_t rt = st.own[t + 2].x & 0xFFu;
      uint32_t up[4], dn[4];
      window16(st.up[t], st.up[t + 1], g.ou, up);
      window16(st.dn[t], st.dn[t + 1], g.od, dn);
      const uint32_t o[4] = {own.x, own.y, own.z, own.w};
      const bool whole = a >= 0 && a <= f.n - 16;
      uint32_t nw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t left =
            __funnelshift_r(j > 0 ? o[j > 0 ? j - 1 : 0] : lb << 24, o[j], 24);
        const uint32_t right =
            __funnelshift_r(o[j], j < 3 ? o[j < 3 ? j + 1 : 3] : rt, 8);
        // the words of the word's two sites (colour sites k0 + 2j, + 1):
        // unit u0 + j (w), or the halves of units u0 + j and u0 + j + 1
        // (next: drawn here, or for j = 3 the next lane's first)
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        if (uc == nullptr) {
          const uint4 next =
              j < 3 ? philox_rk(make_uint4(static_cast<uint32_t>(r),
                                           static_cast<uint32_t>(u0 + j + 1),
                                           0u, 0u), rk)
                    : make_uint4(nx0, nx1, 0u, 0u);
          ws[0] = odd_k ? w.z : w.x;
          ws[1] = odd_k ? w.w : w.y;
          ws[2] = odd_k ? next.x : w.z;
          ws[3] = odd_k ? next.y : w.w;
          w = next;
        }
        nw[j] = o[j];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = p0 + 2 * q;
          const int idx = a + 4 * j + b;
          const bool in = whole || (idx >= 0 && idx < f.n);
          float ucv, uav;
          if (uc != nullptr) {
            const int k = k0 + 2 * j + q;
            ucv = in ? __ldg(uc + k) : 0.0f;
            uav = in ? __ldg(ua + k) : 0.0f;
          } else {
            ucv = xy::u24(ws[2 * q]);
            uav = xy::u24(ws[2 * q + 1]);
          }
          const int ou = state_at(up[j], b), od = state_at(dn[j], b);
          const int ol = state_at(left, b), orr = state_at(right, b);
          const int out = clock_site(tab, state_at(o[j], b), ou, od, ol, orr,
                                     ucv, uav, ms.q, ms.neg_beta);
          nw[j] = tiles8::put_byte(nw[j], b, static_cast<uint32_t>(out));
          if (MEASURE && in) {
            const double2 go = tab64[out], gu = tab64[ou], gd = tab64[od];
            const double2 gl = tab64[ol], gr = tab64[orr];
            sums.mx += go.x + gl.x;
            sums.my += go.y + gl.y;
            sums.e += go.x * ((gu.x + gd.x) + (gl.x + gr.x)) +
                      go.y * ((gu.y + gd.y) + (gl.y + gr.y));
          }
        }
      }
      int8_t* xr = ms.x + static_cast<size_t>(r) * f.n;
      if (whole) {
        __stcg(reinterpret_cast<uint4*>(xr + a),
               make_uint4(nw[0], nw[1], nw[2], nw[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = a + p0 + 2 * i;
          if (idx >= 0 && idx < f.n)
            xr[idx] = static_cast<int8_t>(nw[i >> 1] >>
                                          (8 * (p0 + 2 * (i & 1))));
        }
      }
    }
  }
  if (MEASURE) xy::block_sums<3>(ms.partials, part, g.tpr, ts, sums);
}

// Σ cos, Σ sin and the bonds to idx + 1 and idx + nx of tile ts of
// replica r over the final state, from its staged own and down windows:
// every site once (xy::reduce_kernel negates E), into the tile's partial
// of row `part`.  Every thread calls it.
__device__ __forceinline__ void clock_measure_tile(const IsingStage& st,
                                                   const ClockMs& ms,
                                                   const Flat& f,
                                                   const IsingTiles& g,
                                                   const double2* tab64,
                                                   int r, int ts,
                                                   size_t part) {
  const TileAt ta = tile_at(f, g, r, ts);
  const int t = threadIdx.x;
  xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
  if (ta.v0 + t <= ta.vl) {
    const int a = ta.a0 + 16 * t;
    const uint4 own = st.own[t + 1];
    const uint32_t rt = st.own[t + 2].x & 0xFFu;
    uint32_t dn[4];
    window16(st.dn[t], st.dn[t + 1], g.od, dn);
    const uint32_t o[4] = {own.x, own.y, own.z, own.w};
    const bool whole = a >= 0 && a <= f.n - 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t right =
          __funnelshift_r(o[j], j < 3 ? o[j < 3 ? j + 1 : 3] : rt, 8);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int idx = a + 4 * j + b;
        if (!whole && (idx < 0 || idx >= f.n)) continue;
        const double2 gs = tab64[state_at(o[j], b)];
        const double2 gr = tab64[state_at(right, b)];
        const double2 gd = tab64[state_at(dn[j], b)];
        sums.mx += gs.x;
        sums.my += gs.y;
        sums.e += gs.x * (gr.x + gd.x) + gs.y * (gr.y + gd.y);
      }
    }
  }
  xy::block_sums<3>(ms.partials, part, g.tpr, ts, sums);
}

template <bool ODD>
__global__ void __launch_bounds__(THREADS)
    clock_multisweep_kernel(ClockMs ms, Flat f, IsingTiles g) {
  __shared__ IsingStage st[STAGES];
  __shared__ float2 tab[clock8::TABLE];
  __shared__ double2 tab64[clock8::TABLE];
  for (int k = threadIdx.x; k < clock8::TABLE; k += THREADS) {
    tab[k] = make_float2(ms.tab[k], ms.tab[clock8::TABLE + k]);
    tab64[k] = make_double2(ms.tab64[k], ms.tab64[clock8::TABLE + k]);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  // the block's first tile (one division a launch)
  const int r0 = blockIdx.x / g.tpr;
  const int ts0 = blockIdx.x - r0 * g.tpr;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      if (ODD) {
        copy_seam(ms.x, ms.seam, f, ms.nrep);
        grid.sync();
      }
      // the phase's round keys in shared memory (ising_pass's barrier
      // comes before they are read, the last grid barrier after the last
      // read of the phase before)
      __shared__ uint2 rk[10];
      if (threadIdx.x == 0)
        philox_round_keys(static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2]),
                          static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2 + 1]),
                          rk);
      const size_t rows = static_cast<size_t>(2 * s + c) * ms.nrep;
      ising_pass<ODD, true>(
          st, ms, f, g, r0, ts0,
          [&](const IsingStage& stage, int r, int ts) {
            const float* uc = nullptr;
            const float* ua = nullptr;
            if (ms.ucand != nullptr) {
              uc = ms.ucand + (rows + r) * f.m0;
              ua = ms.uacc + (rows + r) * f.m0;
            }
            const size_t part = static_cast<size_t>(r) * ms.sweeps + s;
            if (!ODD && c == 1)
              clock_tile<true>(stage, ms, f, g, tab, tab64, c, r, ts, rk, uc,
                               ua, part);
            else
              clock_tile<false>(stage, ms, f, g, tab, tab64, c, r, ts, rk,
                                uc, ua, part);
          });
      grid.sync();
    }
    if (ODD) {
      // the sums of the final state (staged without the snapshot); the
      // next sweep's snapshot only reads the state too, so no barrier is
      // needed before it
      ClockMs plain = ms;
      plain.seam = nullptr;
      ising_pass<ODD, false>(
          st, plain, f, g, r0, ts0,
          [&](const IsingStage& stage, int r, int ts) {
            clock_measure_tile(stage, ms, f, g, tab64, r, ts,
                               static_cast<size_t>(r) * ms.sweeps + s);
          });
    }
  }
}

// ---------------------------------------------------------------------------
// XY
// ---------------------------------------------------------------------------

constexpr int UPDATE = 0, FUSED = 1, MEASURE = 2, OVER = 3;

struct XYArgs {
  const float* sx;   // (R, N) input planes
  const float* sy;
  float* ox;         // (R, N) output planes (null in MEASURE mode)
  float* oy;
};

// Tiles of the XY kernel (ops/helical_pallas.py xy_tiles): block (bx, r)
// takes vpt THREADS aligned float4 vectors of replica r from bx vpt
// THREADS on, thread t vectors t, t + THREADS, ..., each sites a .. a + 3
// (a = 4 v - rb, rb = off0 + r N), and adds its sums over them in that
// order, then block_sums: vpt vectors a thread keep the partials few
// enough for reduce_kernel's one block a replica.
struct XYTiles {
  int off0;    // floats of the planes past the 16-B aligned address below
  int su, sd;  // -nx mod 4, nx mod 4
  int vec;     // 1: the planes share off0 (vector loads and stores); 0:
               // every float alone
  int vpt;     // vectors a thread
};

struct PhiloxKeys {
  uint2 rk[10];  // the phase key's round keys (philox_round_keys)
};

// Float u of a replica's plane (any u), wrapped mod N: the per-element
// path (a replica's ends, small N, planes not sharing an alignment).  The
// planes are read-only in a launch, so loads may use L1.
__device__ __forceinline__ float float_at(const float* p, const Flat& f,
                                          int u) {
  return __ldg(p + wrap_any(u, f.n));
}

__device__ __forceinline__ float4 vec4(const float* p, int u) {
  return __ldg(reinterpret_cast<const float4*>(p + u));
}

__device__ __forceinline__ float4 gather4(const float* p, const Flat& f,
                                          int u) {
  return make_float4(float_at(p, f, u), float_at(p, f, u + 1),
                     float_at(p, f, u + 2), float_at(p, f, u + 3));
}

// Floats sh .. sh + 3 of the pair lo, hi (0 <= sh < 4, the same in every
// lane)
__device__ __forceinline__ void window4(const float4& lo, const float4& hi,
                                        int sh, float (&out)[4]) {
  const float p[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float t[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) t[k] = (sh & 2) ? p[k + 2] : p[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = (sh & 1) ? t[k + 1] : t[k];
}

// A thread's sites a .. a + 3 of one replica in both planes and their
// neighbours: the right site a + 4 (and with FIELD the left one a - 1)
// from the neighbour lane, lanes 31 and 0 from the next and the last
// vector; the down window a + i + nx (and with FIELD the up window
// a + i - nx) from two aligned vectors.  FIELD: all four neighbours, as
// an update reads them; without, those of the sums over i + 1, i + nx.  A lane whose vectors all lie in the replica loads
// them as 16-B vectors, the others float by float.  The loader of the XY
// phase's modes; every lane of the warp calls it.
struct XYNbhd {
  float x[4], y[4];
  float lx, ly, rx, ry;
  float ux[4], uy[4], dx[4], dy[4];
};

template <bool FIELD>
__device__ __forceinline__ void load_nbhd(const float* px, const float* py,
                                          const Flat& f, const XYTiles& g,
                                          int a, XYNbhd& h) {
  const int lane = threadIdx.x & 31;
  const int du = a - f.nx - g.su, dd = a + f.nx - g.sd;
  const bool fast = g.vec != 0 && a >= 4 && a <= f.n - 8 &&
                    (!FIELD || du >= 0) && dd <= f.n - 8;
  float4 ox, oy, d0x, d1x, d0y, d1y, u0x, u1x, u0y, u1y;
  float ex = 0.0f, ey = 0.0f, fx = 0.0f, fy = 0.0f;
  if (fast) {
    ox = vec4(px, a);
    oy = vec4(py, a);
    d0x = vec4(px, dd);
    d1x = vec4(px, dd + 4);
    d0y = vec4(py, dd);
    d1y = vec4(py, dd + 4);
    if (FIELD) {
      u0x = vec4(px, du);
      u1x = vec4(px, du + 4);
      u0y = vec4(py, du);
      u1y = vec4(py, du + 4);
    }
    if (lane == 31) {
      ex = vec4(px, a + 4).x;
      ey = vec4(py, a + 4).x;
    }
    if (FIELD && lane == 0) {
      fx = vec4(px, a - 4).w;
      fy = vec4(py, a - 4).w;
    }
  } else {
    ox = gather4(px, f, a);
    oy = gather4(py, f, a);
    d0x = gather4(px, f, dd);
    d1x = gather4(px, f, dd + 4);
    d0y = gather4(py, f, dd);
    d1y = gather4(py, f, dd + 4);
    if (FIELD) {
      u0x = gather4(px, f, du);
      u1x = gather4(px, f, du + 4);
      u0y = gather4(py, f, du);
      u1y = gather4(py, f, du + 4);
    }
    if (lane == 31) {
      ex = float_at(px, f, a + 4);
      ey = float_at(py, f, a + 4);
    }
    if (FIELD && lane == 0) {
      fx = float_at(px, f, a - 1);
      fy = float_at(py, f, a - 1);
    }
  }
  window4(d0x, d1x, g.sd, h.dx);
  window4(d0y, d1y, g.sd, h.dy);
  if (FIELD) {
    window4(u0x, u1x, g.su, h.ux);
    window4(u0y, u1y, g.su, h.uy);
  }
  h.x[0] = ox.x, h.x[1] = ox.y, h.x[2] = ox.z, h.x[3] = ox.w;
  h.y[0] = oy.x, h.y[1] = oy.y, h.y[2] = oy.z, h.y[3] = oy.w;
  const float rx = __shfl_down_sync(FULL, ox.x, 1);
  const float ry = __shfl_down_sync(FULL, oy.x, 1);
  h.rx = lane == 31 ? ex : rx;
  h.ry = lane == 31 ? ey : ry;
  if (FIELD) {
    const float lx = __shfl_up_sync(FULL, ox.w, 1);
    const float ly = __shfl_up_sync(FULL, oy.w, 1);
    h.lx = lane == 0 ? fx : lx;
    h.ly = lane == 0 ? fy : ly;
  }
}

// Vector v of replica r (sites a .. a + 3): the sites of colour `color`
// are updated from the input planes (OVER: reflected about their field),
// the others copied.  FUSED adds Σ S of the new values and S_new·h (h in
// float64 from the float32 neighbours) of the updated ones; MEASURE adds
// Σ S and S·(S_{i+1} + S_{i+nx}) of the sites, in float64, each in site
// order.  Every lane of the warp calls it.
template <int MODE>
__device__ __forceinline__ void xy_vector(const XYArgs& io, const Flat& f,
                                          const XYTiles& g, int color,
                                          const float* ucand,
                                          const float* uacc, float neg_beta,
                                          const PhiloxKeys& keys, int r,
                                          int a, bool valid, xy::Sums& t) {
  const size_t base = static_cast<size_t>(r) * f.n;
  XYNbhd h;
  load_nbhd<MODE != MEASURE>(io.sx + base, io.sy + base, f, g, a, h);
  if (!valid) return;
  const bool whole = g.vec != 0 && a >= 0 && a <= f.n - 4;
  if (MODE == MEASURE) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!whole && (a + i < 0 || a + i >= f.n)) continue;
      const int ir = i < 3 ? i + 1 : 3;
      const double vx = h.x[i], vy = h.y[i];
      const float rx = i < 3 ? h.x[ir] : h.rx;
      const float ry = i < 3 ? h.y[ir] : h.ry;
      t.mx += vx;
      t.my += vy;
      t.e += vx * (static_cast<double>(rx) + static_cast<double>(h.dx[i])) +
             vy * (static_cast<double>(ry) + static_cast<double>(h.dy[i]));
    }
    return;
  }
  float fx[4], fy[4];
  if (MODE == OVER) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fx[i] = h.x[i];
      fy[i] = h.y[i];
      if (((a + i) & 1) != color) continue;
      if (!whole && (a + i < 0 || a + i >= f.n)) continue;
      const float lx = i > 0 ? h.x[i - 1] : h.lx;
      const float rx = i < 3 ? h.x[i + 1] : h.rx;
      const float ly = i > 0 ? h.y[i - 1] : h.ly;
      const float ry = i < 3 ? h.y[i + 1] : h.ry;
      const float hx = __fadd_rn(__fadd_rn(__fadd_rn(h.ux[i], h.dx[i]), lx),
                                 rx);
      const float hy = __fadd_rn(__fadd_rn(__fadd_rn(h.uy[i], h.dy[i]), ly),
                                 ry);
      const float inv = rsqrtf(fmaxf(
          __fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), xy::TINY));
      const float nxh = __fmul_rn(hx, inv), nyh = __fmul_rn(hy, inv);
      const float d = __fmul_rn(
          2.0f, __fadd_rn(__fmul_rn(fx[i], nxh), __fmul_rn(fy[i], nyh)));
      const float sx = __fsub_rn(__fmul_rn(d, nxh), fx[i]);
      const float sy = __fsub_rn(__fmul_rn(d, nyh), fy[i]);
      const float rinv = rsqrtf(
          fmaxf(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)), xy::TINY));
      fx[i] = __fmul_rn(sx, rinv);
      fy[i] = __fmul_rn(sy, rinv);
    }
  } else {
    // the vector's colour sites: a + i0 and a + i0 + 2, colour sites ka and
    // ka + 1 (ka >> 1 the unit of the first)
    const int i0 = (color - a) & 1;
    const int ka = (a + i0 - color) >> 1;
    float uc[2], ua[2];
    if (ucand != nullptr) {
      const size_t row = static_cast<size_t>(r) * f.m0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = a + i0 + 2 * q;
        const bool in = idx >= 0 && idx < f.n;
        uc[q] = in ? __ldg(ucand + row + ka + q) : 0.0f;
        ua[q] = in ? __ldg(uacc + row + ka + q) : 0.0f;
      }
    } else {
      const int u0 = ka >> 1;
      const uint4 w0 = philox_rk(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(u0), 0u,
                     0u), keys.rk);
      if ((ka & 1) == 0) {
        uc[0] = xy::u24(w0.x);
        ua[0] = xy::u24(w0.y);
        uc[1] = xy::u24(w0.z);
        ua[1] = xy::u24(w0.w);
      } else {
        const uint4 w1 = philox_rk(
            make_uint4(static_cast<uint32_t>(r),
                       static_cast<uint32_t>(u0 + 1), 0u, 0u), keys.rk);
        uc[0] = xy::u24(w0.z);
        ua[0] = xy::u24(w0.w);
        uc[1] = xy::u24(w1.x);
        ua[1] = xy::u24(w1.y);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fx[i] = h.x[i];
      fy[i] = h.y[i];
      if (((a + i) & 1) != color) continue;
      if (!whole && (a + i < 0 || a + i >= f.n)) continue;
      const int il = i > 0 ? i - 1 : 0, ir = i < 3 ? i + 1 : 3;
      const float ux = h.ux[i], dx = h.dx[i];
      const float lx = i > 0 ? h.x[il] : h.lx, rx = i < 3 ? h.x[ir] : h.rx;
      const float uy = h.uy[i], dy = h.dy[i];
      const float ly = i > 0 ? h.y[il] : h.ly, ry = i < 3 ? h.y[ir] : h.ry;
      const float hx = __fadd_rn(__fadd_rn(__fadd_rn(ux, dx), lx), rx);
      const float hy = __fadd_rn(__fadd_rn(__fadd_rn(uy, dy), ly), ry);
      float cx, cy;
      xy::cos_sin_2pi(uc[i >> 1], cx, cy);
      const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx[i]), hx),
                                  __fmul_rn(__fsub_rn(cy, fy[i]), hy));
      const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
      if (ua[i >> 1] < prob) {
        fx[i] = cx;
        fy[i] = cy;
      }
      if (MODE == FUSED)
        t.e += static_cast<double>(fx[i]) *
                   ((static_cast<double>(ux) + static_cast<double>(dx)) +
                    (static_cast<double>(lx) + static_cast<double>(rx))) +
               static_cast<double>(fy[i]) *
                   ((static_cast<double>(uy) + static_cast<double>(dy)) +
                    (static_cast<double>(ly) + static_cast<double>(ry)));
    }
  }
  float* oxr = io.ox + base;
  float* oyr = io.oy + base;
  if (whole) {
    *reinterpret_cast<float4*>(oxr + a) =
        make_float4(fx[0], fx[1], fx[2], fx[3]);
    *reinterpret_cast<float4*>(oyr + a) =
        make_float4(fy[0], fy[1], fy[2], fy[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!whole && (a + i < 0 || a + i >= f.n)) continue;
    if (!whole) {
      oxr[a + i] = fx[i];
      oyr[a + i] = fy[i];
    }
    if (MODE == FUSED) {
      t.mx += fx[i];
      t.my += fy[i];
    }
  }
}

template <int MODE>
// Blocks an SM: 4 (64 registers) in the phase, measure and
// over-relaxation modes, 3 in the fused mode (its float64 sums; 4 spilled)
__global__ void __launch_bounds__(THREADS, MODE == FUSED ? 3 : 4)
    xy_phase_kernel(XYArgs io, Flat f, XYTiles g, int color,
                    const float* ucand, const float* uacc, float neg_beta,
                    PhiloxKeys keys, double* partials) {
  const int r = blockIdx.y;
  const long long rb = g.off0 + static_cast<long long>(r) * f.n;
  const long long vl = (rb + f.n - 1) >> 2;
  const long long v0 = (rb >> 2) +
                       static_cast<long long>(blockIdx.x) * g.vpt * THREADS +
                       threadIdx.x;
  const int lane = threadIdx.x & 31;
  xy::Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int j = 0; j < g.vpt; ++j) {
    const long long v = v0 + static_cast<long long>(j) * THREADS;
    if (v - lane > vl) break;  // the warp is past the replica
    xy_vector<MODE>(io, f, g, color, ucand, uacc, neg_beta, keys, r,
                    static_cast<int>(4 * v - rb), v <= vl, t);
  }
  if (MODE == FUSED || MODE == MEASURE)
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The kernels' own refusal (the wrappers raise first): odd nx >= 3,
// ny >= 2, 1 .. 65535 replicas, no site index of a replica past 2^31 (a
// tile's last lane reaches N + 4 KB + nx).
bool make_flat(int nrep, int n, int nx, Flat* f) {
  if (nrep < 1 || nrep > 65535 || nx < 3 || (nx & 1) == 0 || n % nx != 0 ||
      n / nx < 2 ||
      static_cast<long long>(n) + 2LL * nx + 32LL * THREADS >= (1LL << 31))
    return false;
  f->n = n;
  f->nx = nx;
  f->m0 = (n + 1) / 2;
  return true;
}

const void* multisweep_fn(int kind, bool odd) {
  if (kind == 0)
    return odd ? reinterpret_cast<const void*>(ising_multisweep_kernel<true>)
               : reinterpret_cast<const void*>(ising_multisweep_kernel<false>);
  return odd ? reinterpret_cast<const void*>(clock_multisweep_kernel<true>)
             : reinterpret_cast<const void*>(clock_multisweep_kernel<false>);
}

int resident_blocks(const void* fn, int* blocks);
int launch_tiles(const void* fn, int nrep, IsingTiles* g, void** args,
                 cudaStream_t st);

// The tiles of x (R, N) int8 (ops/helical_pallas.ising_tiles): off0 its
// bytes past the 16-B aligned address below it, tpr tiles a replica
IsingTiles tiles_of(int nx, int off0, int tpr) {
  IsingTiles g;
  g.off0 = off0;
  g.tpr = tpr;
  g.ou = (-nx) & 15;
  g.od = nx & 15;
  g.step_r = g.step_s = 0;  // set by launch_tiles
  return g;
}

}  // namespace

extern "C" {

// Blocks of a multisweep kernel's cooperative grid (kind 0 Ising, 1
// clock; odd: the odd-N instantiation) resident at once on the current
// device (0 if none fits).
int hp_grid_blocks(int kind, int odd, int* blocks) {
  return resident_blocks(multisweep_fn(kind, odd != 0), blocks);
}

// S Ising sweeps of x (R, N) int8 in place under seeds (S, 2, 2), or the
// injected words bits (S, 2, R, ceil(N/2)); seam (R, 2 nx) int8 scratch
// at odd N (else null); per-sweep (m, e) into obs (R, S, 2) int64, zeroed
// by the caller.  off0, tpr: x's tiles, as the wrapper's ising_tiles
// (ops/helical_pallas.py) alone computes them.
int hp_ising_multisweep(void* x, void* seam, const void* seeds,
                        const void* bits, void* obs, int nrep, int n, int nx,
                        int sweeps, unsigned int t4, unsigned int t8,
                        int off0, int tpr, void* stream) {
  Flat f;
  const bool odd = (n & 1) != 0;
  if (!make_flat(nrep, n, nx, &f) || sweeps < 1 || (odd && seam == nullptr) ||
      off0 < 0 || off0 > 15 || tpr < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  IsingMs ms;
  ms.x = static_cast<int8_t*>(x);
  ms.seam = static_cast<int8_t*>(seam);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.bits = static_cast<const uint32_t*>(bits);
  ms.obs = static_cast<long long*>(obs);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.t4 = t4;
  ms.t8 = t8;
  IsingTiles g = tiles_of(nx, off0, tpr);
  void* args[] = {&ms, &f, &g};
  return launch_tiles(multisweep_fn(0, odd), nrep, &g, args,
                      static_cast<cudaStream_t>(stream));
}

// S clock sweeps of x (R, N) int8 in place under seeds (S, 2, 2), or the
// injected uniforms ucand, uacc (S, 2, R, ceil(N/2)) float32; tab, tab64
// the (2, 128) float32 and float64 tables; partials (R, S, tpr, 3)
// float64 scratch; per-sweep (Σ cos, Σ sin, E) into obs (R, S, 3)
// float64.  off0, tpr: x's tiles, as the wrapper's ising_tiles alone
// computes them.
int hp_clock_multisweep(void* x, void* seam, const void* seeds,
                        const void* ucand, const void* uacc, const void* tab,
                        const void* tab64, void* partials, void* obs,
                        int nrep, int n, int nx, int q, int sweeps,
                        float neg_beta, int off0, int tpr, void* stream) {
  Flat f;
  const bool odd = (n & 1) != 0;
  if (!make_flat(nrep, n, nx, &f) || sweeps < 1 || q < 2 ||
      q >= clock8::TABLE || (odd && seam == nullptr) ||
      (ucand == nullptr) != (uacc == nullptr) || off0 < 0 || off0 > 15 ||
      tpr < 1 || static_cast<long long>(nrep) * sweeps >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ClockMs ms;
  ms.x = static_cast<int8_t*>(x);
  ms.seam = static_cast<int8_t*>(seam);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.ucand = static_cast<const float*>(ucand);
  ms.uacc = static_cast<const float*>(uacc);
  ms.tab = static_cast<const float*>(tab);
  ms.tab64 = static_cast<const double*>(tab64);
  ms.partials = static_cast<double*>(partials);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.q = q;
  ms.neg_beta = neg_beta;
  IsingTiles g = tiles_of(nx, off0, tpr);
  void* args[] = {&ms, &f, &g};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = launch_tiles(multisweep_fn(1, odd), nrep, &g, args, st);
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), tpr);
  return static_cast<int>(cudaGetLastError());
}

// One XY launch over (R, N) float32 planes sx, sy: mode 0 updates colour
// `color` into ox, oy (distinct planes); mode 1 does so and measures the
// new state (even N); mode 2 measures sx, sy and writes nothing.  ucand,
// uacc: injected uniforms (R, ceil(N/2)) float32, or both null for Philox
// words under (s0, s1).  off0, vpt, nblk, vec: the planes' tiles, as the
// wrapper's xy_tiles (ops/helical_pallas.py) alone computes them.
// Measuring modes: partials
// (R, nblk, 3) float64 scratch and the sums into obs (R, 3).
int hp_xy_phase(const void* sx, const void* sy, void* ox, void* oy,
                const void* ucand, const void* uacc, void* partials,
                void* obs, int nrep, int n, int nx, int color, int mode,
                float neg_beta, unsigned int s0, unsigned int s1, int off0,
                int vpt, int nblk, int vec, void* stream) {
  Flat f;
  if (!make_flat(nrep, n, nx, &f) || mode < UPDATE || mode > MEASURE ||
      (color & ~1) != 0 || (ucand == nullptr) != (uacc == nullptr) ||
      (mode != MEASURE && (ox == nullptr || oy == nullptr)) ||
      (mode == FUSED && (n & 1) != 0) ||
      (mode != UPDATE) != (partials != nullptr && obs != nullptr) ||
      (vec & ~1) != 0 || off0 < 0 || off0 > 3 || vpt < 1 || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  XYArgs a;
  a.sx = static_cast<const float*>(sx);
  a.sy = static_cast<const float*>(sy);
  a.ox = static_cast<float*>(ox);
  a.oy = static_cast<float*>(oy);
  XYTiles g;
  g.off0 = off0;
  g.su = (-nx) & 3;
  g.sd = nx & 3;
  g.vec = vec;
  g.vpt = vpt;
  PhiloxKeys keys;
  philox_round_keys(s0, s1, keys.rk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  double* part = static_cast<double*>(partials);
  const dim3 grid(nblk, nrep);
  if (mode == UPDATE)
    xy_phase_kernel<UPDATE><<<grid, THREADS, 0, st>>>(a, f, g, color, uc, ua,
                                                      neg_beta, keys, part);
  else if (mode == FUSED)
    xy_phase_kernel<FUSED><<<grid, THREADS, 0, st>>>(a, f, g, color, uc, ua,
                                                     neg_beta, keys, part);
  else
    xy_phase_kernel<MEASURE><<<grid, THREADS, 0, st>>>(a, f, g, color, uc, ua,
                                                       neg_beta, keys, part);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || mode == UPDATE) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, st>>>(
      part, static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

// One over-relaxation phase of colour `color` from sx, sy into ox, oy
// (xy_phase_kernel's mode OVER); off0, vpt, nblk, vec: the planes' tiles,
// as the wrapper's xy_tiles computes them.
int hp_xy_or(const void* sx, const void* sy, void* ox, void* oy, int nrep,
             int n, int nx, int color, int off0, int vpt, int nblk, int vec,
             void* stream) {
  Flat f;
  if (!make_flat(nrep, n, nx, &f) || (color & ~1) != 0 || ox == nullptr ||
      oy == nullptr || (vec & ~1) != 0 || off0 < 0 || off0 > 3 || vpt < 1 ||
      nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  XYArgs a;
  a.sx = static_cast<const float*>(sx);
  a.sy = static_cast<const float*>(sy);
  a.ox = static_cast<float*>(ox);
  a.oy = static_cast<float*>(oy);
  XYTiles g;
  g.off0 = off0;
  g.su = (-nx) & 3;
  g.sd = nx & 3;
  g.vec = vec;
  g.vpt = vpt;
  const PhiloxKeys keys = {};
  xy_phase_kernel<OVER><<<dim3(nblk, nrep), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, f, g, color, nullptr, nullptr, 0.0f, keys, nullptr);
  return static_cast<int>(cudaGetLastError());
}

const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

// Blocks of `fn` resident at once on the current device (THREADS threads,
// no dynamic shared memory)
int resident_blocks(const void* fn, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// A cooperative launch of multisweep kernel `fn` over nrep tpr tiles (g):
// one block a tile up to the blocks that can be resident at once, which
// then walk the rest, gridDim.x tiles apart (g's steps, set here before
// the launch reads args).
int launch_tiles(const void* fn, int nrep, IsingTiles* g, void** args,
                 cudaStream_t st) {
  const long long tiles = static_cast<long long>(nrep) * g->tpr;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int code = resident_blocks(fn, &blocks);
  if (code != 0) return code;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (tiles < blocks) blocks = static_cast<int>(tiles);
  g->step_r = blocks / g->tpr;
  g->step_s = blocks % g->tpr;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
