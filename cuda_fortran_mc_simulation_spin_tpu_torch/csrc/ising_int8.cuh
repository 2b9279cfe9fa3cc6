// The int8 checkerboard Ising update of the int8 2-D phase kernel
// (csrc/ising2d_pallas.cu; its halo mode runs a mesh's shards).  The 2-D
// multisweep (csrc/ising2d_multisweep.cu) and the 3-D phase
// (csrc/ising3d_pallas.cu) apply the same rule to the same words four
// sites a 32-bit word, and the measure kernel (csrc/
// ising2d_measure_pallas.cu) sums four sites a word on the same tiles;
// they take only block_add and the launch checks from here.
//
// Layout (core/lattice.py): ±1 int8 colour planes (R, nz, ny, half),
// nz = 1 in 2-D; colour 0 holds the sites x = 2i + ((y + z) & 1) of row
// (z, y).  The other colour's site i is the same-column neighbour; the
// side neighbour is column i + 1 when (y + z) & 1 differs from the colour
// and i - 1 when it equals it (periodic in i), the up/down ones rows
// y -+ 1 (periodic).
//
// Unit: four adjacent sites 4j .. 4j + 3 of one row; the tail unit of a
// row whose half is not a multiple of 4 is masked.  Random words
// (ops/ising2d_pallas.py): the unit's one Philox4x32-10 call at counter
// (replica, y, j, 0) under the phase key; site 4j + k takes output k.
//
// Acceptance (JAX ops/ising2d_pallas._phase_kernel): with k = s * nsum
// (dE / 2), flip iff k <= 0 or word < t_k, t_2 = t4, t_4 = t8 (= t12)
// = round(exp(-2 beta k) * 2^32) (uint32 compare).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace ising8 {

constexpr int THREADS = 256;

struct Geometry {
  int nz, ny, half;  // nz = 1 in 2-D
  int units;         // (half + 3) / 4 units a row
};

__device__ __forceinline__ int load(const int8_t* p, size_t i) {
  return static_cast<int>(__ldg(p + i));
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Offsets of the rows a unit of row y of replica r reads (2-D).
struct Rows {
  size_t row, up, down;
  int parity;
};

__device__ __forceinline__ Rows rows_of(const Geometry& g, int r, int y) {
  const size_t zo = static_cast<size_t>(r) * g.ny * g.half;
  Rows w;
  w.row = zo + static_cast<size_t>(y) * g.half;
  w.up = zo + static_cast<size_t>(wrap(y - 1, g.ny)) * g.half;
  w.down = zo + static_cast<size_t>(wrap(y + 1, g.ny)) * g.half;
  w.parity = y & 1;
  return w;
}

struct Phase {
  int8_t* x;             // colour being updated, in place
  const int8_t* o;       // the other colour
  const uint32_t* bits;  // injected words (R, nz, ny, half), or null
  uint2 key;             // Philox key of this (sample, t, phase)
  uint32_t t4, t8, t12;  // t12 = t8: the 2-D kernels' k is 2 or 4
  int color;
};

// A shard of a domain-decomposed 2-D lattice (parallel/domain.py): the
// halos exchanged from its neighbours (parallel/halo.py) and its global
// offsets.  The shard holds rows row0 .. row0 + ny - 1 and columns col0 ..
// col0 + half - 1 of the colour planes.  A periodic lattice is the shard
// with no halos and no offsets.
struct Shard {
  const int8_t* up;  // (R, 1, half): the row above row 0
  const int8_t* dn;  // (R, 1, half): the row below the last
  const int8_t* lf;  // (R, ny, 1): the column left of column 0, or null
  const int8_t* rt;  // (periodic in x: the shard spans every column)
  long long* obs;    // (R, 2) int64 (m, e) partials of a measuring phase
  int rep0, row0, col0;
};

// Units of a row of the shard: the global units (column >> 2) its columns
// touch, so that one Philox call still feeds the four global columns of a
// unit and a shard draws what the whole lattice draws, at any col0.
__host__ __device__ inline int shard_units(int col0, int half) {
  return ((col0 + half - 1) >> 2) - (col0 >> 2) + 1;
}

// Updates the sites of global unit jl + (col0 >> 2) of local row y of
// replica r.  HALO: the neighbours past the shard's first and last rows
// and, when lf is set, past its columns come from the halos of s, and
// parity and the Philox counter (rep0 + r, global row, global unit) from
// global coordinates (JAX ising2d_pallas._halo_phase_kernel); otherwise
// every neighbour wraps and s is not read.  With MEASURE it adds the
// fused sums of a measuring phase b (JAX ising2d_multisweep.py:84-90):
// m += new + o, e -= new * nsum (the other colour is final, so every bond
// is counted once).
template <bool MEASURE, bool HALO = false>
__device__ __forceinline__ void update_unit(const Phase& p, const Shard& s,
                                            const Geometry& g, int r, int y,
                                            int jl, int& m, int& e) {
  const int row0 = HALO ? s.row0 : 0;
  const int col0 = HALO ? s.col0 : 0;
  const Rows w = rows_of(g, r, y);
  // the rows before and after: wrapped, or a halo
  const int8_t* prev = p.o;
  const int8_t* next = p.o;
  size_t prev_at = w.up;
  size_t next_at = w.down;
  if (HALO) {
    const size_t halo = static_cast<size_t>(r) * g.half;
    if (y == 0) {
      prev = s.up;
      prev_at = halo;
    }
    if (y == g.ny - 1) {
      next = s.dn;
      next_at = halo;
    }
  }
  const int d = (((row0 + w.parity) & 1) ^ p.color) ? 1 : -1;
  const int jg = (col0 >> 2) + jl;
  const uint32_t grow = static_cast<uint32_t>(row0 + y);
  uint4 words = make_uint4(0u, 0u, 0u, 0u);
  if (p.bits == nullptr)
    words = philox4x32_10(
        make_uint4(static_cast<uint32_t>((HALO ? s.rep0 : 0) + r), grow,
                   static_cast<uint32_t>(jg), 0u),
        p.key);
  const uint32_t ws[4] = {words.x, words.y, words.z, words.w};
  const size_t col_halo = static_cast<size_t>(r) * g.ny + y;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // c rises with k, so the row's end breaks the loop: a continue there
    // cost the first S-sweep kernel 8 registers and a sixth of its
    // resident blocks (chip_time_ising.py)
    const int c = 4 * jg + k - col0;
    if (HALO && c < 0) continue;
    if (c >= g.half) break;
    const int sc = c + d;
    int side;
    if (HALO && sc < 0 && s.lf != nullptr)
      side = load(s.lf, col_halo);
    else if (HALO && sc >= g.half && s.rt != nullptr)
      side = load(s.rt, col_halo);
    else
      side = load(p.o, w.row + wrap(sc, g.half));
    int nsum = load(p.o, w.row + c) + side;
    nsum += load(prev, prev_at + c) + load(next, next_at + c);
    const int sv = static_cast<int>(p.x[w.row + c]);
    const int kk = sv * nsum;
    const uint32_t word = p.bits != nullptr ? __ldg(p.bits + w.row + c) : ws[k];
    const uint32_t t = kk == 2 ? p.t4 : (kk == 4 ? p.t8 : p.t12);
    const int out = (kk <= 0 || word < t) ? -sv : sv;
    p.x[w.row + c] = static_cast<int8_t>(out);
    if (MEASURE) {
      m += out + load(p.o, w.row + c);
      e -= out * nsum;
    }
  }
}

// Adds the block's (m, e) to dst[0], dst[1] with one 64-bit atomic each.
// Every thread of the block calls it; it ends with a barrier, so the
// caller may call it again at once.
__device__ __forceinline__ void block_add(int m, int e, long long* dst) {
  __shared__ int red_m[THREADS / 32];
  __shared__ int red_e[THREADS / 32];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    m += __shfl_down_sync(0xFFFFFFFFu, m, off);
    e += __shfl_down_sync(0xFFFFFFFFu, e, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_e[warp] = e;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long bm = 0, be = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
      bm += red_m[k];
      be += red_e[k];
    }
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(bm));
    atomicAdd(reinterpret_cast<unsigned long long*>(dst) + 1,
              static_cast<unsigned long long>(be));
  }
  __syncthreads();
}

// Units a replica holds, and the refusal of a launch whose unit index
// within a replica could pass 2^31 or whose replicas exceed the grid's
// y extent (the wrappers raise first; this is the kernels' own guard).
__host__ __device__ inline long long units_per_rep(const Geometry& g) {
  return static_cast<long long>(g.nz) * g.ny * g.units;
}

__host__ inline bool launchable(const Geometry& g, int nrep) {
  return nrep >= 1 && nrep <= 65535 && g.nz >= 1 && g.ny >= 2 &&
         g.half >= 1 && units_per_rep(g) + THREADS < (1LL << 31);
}

__host__ inline Geometry geometry(int nz, int ny, int half) {
  Geometry g;
  g.nz = nz;
  g.ny = ny;
  g.half = half;
  g.units = (half + 3) / 4;
  return g;
}

}  // namespace ising8
