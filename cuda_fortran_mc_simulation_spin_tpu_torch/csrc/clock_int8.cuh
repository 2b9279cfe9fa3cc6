// The int8 q-state clock checkerboard update and its float64 sums, shared
// by the phase kernel (csrc/clock_pallas.cu) and the measure kernel
// (csrc/clock_measure_pallas.cu), so that both apply the same function to
// the same random words; the cooperative multisweep
// (csrc/clock_multisweep.cu) takes the layout and tables from here and
// spells the same site rule on its staged tiles.
//
// Layout (core/lattice.py): int8 states s in [0, q), q <= 127, on colour
// planes (R, ny, half); colour 0 holds the sites x = 2i + (y & 1) of row
// y.  A site's neighbours are the other colour's (y -+ 1, i), (y, i) and
// (y, i + 1) or (y, i - 1) by colour and row parity, rows wrapping at ny
// and columns at half.
//
// Tables: the float32 (cos, sin) of each state, the values the JAX
// package's select chain (q <= 16) or its trig.cos_sin_2pi (q > 16)
// gives (core/tables.clock_cos_sin_table), and for the sums a float64
// table (ops/clock_measure_pallas.sums_table); TABLE cos entries then
// TABLE sin entries each, staged in shared memory once a block.  The
// select chain is a TPU artefact (Mosaic has no fast gather); the gather
// reads the same float32 values, so the decisions are the chain's.
//
// Unit: two adjacent sites 2j, 2j + 1 of one row, one thread; the tail
// unit of a row whose half is odd is masked, so every even nx and ny runs.
// Random words (ops/clock_pallas.draw_words): the unit's one
// Philox4x32-10 call at counter (replica, row, j, 0) under the phase key;
// site 2j + k takes output 2k for its candidate and 2k + 1 for its
// acceptance, each a uniform from its top 24 bits (xy::u24, as JAX
// stencil.bits_to_uniform).
//
// Arithmetic (models/clock.metropolis_update, JAX models/clock.py:104-134):
// h = (up + dn) + (centre + side) in float32; candidate
// n = s + trunc(u_c * (q - 1)) + 1 mod q; ΔE = -((c_n - c_s) h_x +
// (s_n - s_s) h_y); accept iff u_a < expf(-β max(ΔE, 0)).  Every float32
// operation is spelled __fadd_rn / __fmul_rn / __fsub_rn (no FMA
// contraction) in that order, and expf is the function torch.exp calls on
// CUDA tensors, so kernel and plain version agree bitwise on the card.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "xy2d_site.cuh"

namespace clock8 {

constexpr int THREADS = xy::THREADS;
constexpr int TABLE = 128;  // entries a table holds: every q <= 127

struct Geometry {
  int ny, half;
  int units;  // (half + 1) / 2 units a row
};

__host__ __device__ inline long long units_per_rep(const Geometry& g) {
  return static_cast<long long>(g.ny) * g.units;
}

__host__ inline Geometry geometry(int ny, int half) {
  Geometry g;
  g.ny = ny;
  g.half = half;
  g.units = (half + 1) / 2;
  return g;
}

// The kernels' own refusal of a launch whose unit index within a replica
// could pass 2^31, whose replicas exceed the grid's y extent or whose q
// the tables do not hold (the wrappers raise first).
__host__ inline bool launchable(const Geometry& g, int nrep, int q) {
  return nrep >= 1 && nrep <= 65535 && g.ny >= 2 && g.half >= 1 &&
         q >= 2 && q < TABLE && units_per_rep(g) + THREADS < (1LL << 31);
}

// Copies a (2, TABLE) table from device memory into the block's shared
// arrays c, s; ends with a barrier.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void stage(const T* tab, T* c, T* s) {
  for (int k = threadIdx.x; k < TABLE; k += blockDim.x) {
    c[k] = tab[k];
    s[k] = tab[TABLE + k];
  }
  __syncthreads();
}

// A state as a table index (the mask keeps a corrupt byte inside the
// table; it is the identity on [0, q)).  A coherent load bypasses L1: the
// multisweep reads, after a grid barrier, what other SMs wrote.
template <bool COHERENT>
__device__ __forceinline__ int load(const int8_t* p, size_t i) {
  const int v = COHERENT ? static_cast<int>(__ldcg(p + i))
                         : static_cast<int>(__ldg(p + i));
  return v & (TABLE - 1);
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

struct Phase {
  int8_t* x;            // colour being updated, in place
  const int8_t* o;      // the other colour
  const float* ucand;   // injected uniforms (R, ny, half), or null
  const float* uacc;
  uint2 key;            // Philox key of this (sample, t, phase)
  float neg_beta;
  int q, color;
};

// A shard of a domain-decomposed lattice (parallel/domain.py): the halos
// exchanged from its neighbours (parallel/halo.py) and its global offsets.
// The shard holds rows row0 .. row0 + ny - 1 and columns col0 .. col0 +
// half - 1 of the colour planes.  A periodic lattice is the shard with no
// halos and no offsets.
struct Shard {
  const int8_t* up;  // (R, 1, half): the row above row 0
  const int8_t* dn;  // (R, 1, half): the row below the last
  const int8_t* lf;  // (R, ny, 1): the column left of column 0, or null
  const int8_t* rt;  // (periodic in x: the shard spans every column)
  int rep0, row0, col0;
};

// Units of a row of the shard: the global units (column >> 1) its columns
// touch, so that one Philox call still feeds the two global columns of a
// unit and a shard draws what the whole lattice draws, at any col0.
__host__ __device__ inline int shard_units(int col0, int half) {
  return ((col0 + half - 1) >> 1) - (col0 >> 1) + 1;
}

// The staged tables: float32 for the update, float64 for the sums
struct Tables {
  const float* c;
  const float* s;
  const double* c64;
  const double* s64;
};

// Updates the sites of global unit j + (col0 >> 1) of local row y of
// replica r.  HALO: the rows past the shard's first and last and, when lf
// is set, the columns past its edges come from the halos of s, and parity
// and the Philox counter (rep0 + r, row0 + y, global unit) from global
// coordinates (JAX clock_pallas._halo_phase_kernel); a shard at an odd
// col0 cuts a unit, whose other site its neighbour updates.  Otherwise
// every neighbour wraps and s is not read.  With MEASURE it adds the fused
// float64 sums of a measuring phase b (JAX clock_multisweep.py:87-95):
// Σ cos and Σ sin of the new state and of the other colour's site (y, i),
// and S_new·h over the site's four bonds (the other colour is final, so
// every bond is counted once; reduce_kernel negates it into e).
template <bool COHERENT, bool MEASURE, bool HALO = false>
__device__ __forceinline__ void update_unit(const Phase& p, const Shard& s,
                                            const Geometry& g,
                                            const Tables& tb, int r, int y,
                                            int j, xy::Sums& t) {
  const int row0 = HALO ? s.row0 : 0;
  const int col0 = HALO ? s.col0 : 0;
  const size_t base = static_cast<size_t>(r) * g.ny * g.half;
  const size_t row = base + static_cast<size_t>(y) * g.half;
  // the rows before and after: wrapped, or a halo
  const int8_t* prev = p.o;
  const int8_t* next = p.o;
  size_t up = base + static_cast<size_t>(wrap(y - 1, g.ny)) * g.half;
  size_t dn = base + static_cast<size_t>(wrap(y + 1, g.ny)) * g.half;
  if (HALO) {
    const size_t halo = static_cast<size_t>(r) * g.half;
    if (y == 0) {
      prev = s.up;
      up = halo;
    }
    if (y == g.ny - 1) {
      next = s.dn;
      dn = halo;
    }
  }
  // colour 0 on an odd row and colour 1 on an even row read column i + 1
  const int d = (p.color == 0) == (((row0 + y) & 1) == 1) ? 1 : -1;
  const int jg = (col0 >> 1) + j;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (p.ucand == nullptr)
    w = philox4x32_10(
        make_uint4(static_cast<uint32_t>((HALO ? s.rep0 : 0) + r),
                   static_cast<uint32_t>(row0 + y),
                   static_cast<uint32_t>(jg), 0u),
        p.key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  const size_t col_halo = static_cast<size_t>(r) * g.ny + y;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    // i rises with k, so the row's end breaks the loop (a continue there
    // costs registers, csrc/ising_int8.cuh)
    const int i = 2 * jg + k - col0;
    if (HALO && i < 0) continue;
    if (i >= g.half) break;
    const int ou = load<COHERENT>(prev, up + i);
    const int od = load<COHERENT>(next, dn + i);
    const int oc = load<COHERENT>(p.o, row + i);
    const int sc = i + d;
    int os;
    if (HALO && sc < 0 && s.lf != nullptr)
      os = load<COHERENT>(s.lf, col_halo);
    else if (HALO && sc >= g.half && s.rt != nullptr)
      os = load<COHERENT>(s.rt, col_halo);
    else
      os = load<COHERENT>(p.o, row + wrap(sc, g.half));
    const float hx = __fadd_rn(__fadd_rn(tb.c[ou], tb.c[od]),
                               __fadd_rn(tb.c[oc], tb.c[os]));
    const float hy = __fadd_rn(__fadd_rn(tb.s[ou], tb.s[od]),
                               __fadd_rn(tb.s[oc], tb.s[os]));
    const int xs = COHERENT ? load<true>(p.x, row + i)
                            : static_cast<int>(p.x[row + i]) & (TABLE - 1);
    float uc, ua;
    if (p.ucand != nullptr) {
      uc = __ldg(p.ucand + row + i);
      ua = __ldg(p.uacc + row + i);
    } else {
      uc = xy::u24(ws[2 * k]);
      ua = xy::u24(ws[2 * k + 1]);
    }
    int nw = xs + static_cast<int>(
                      __fmul_rn(uc, static_cast<float>(p.q - 1))) + 1;
    if (nw >= p.q) nw -= p.q;
    const float de = -__fadd_rn(
        __fmul_rn(__fsub_rn(tb.c[nw], tb.c[xs]), hx),
        __fmul_rn(__fsub_rn(tb.s[nw], tb.s[xs]), hy));
    const float prob = expf(__fmul_rn(p.neg_beta, fmaxf(de, 0.0f)));
    const int out = ua < prob ? nw : xs;
    p.x[row + i] = static_cast<int8_t>(out);
    if (MEASURE) {
      const double fc = tb.c64[out], fs = tb.s64[out];
      t.mx += fc + tb.c64[oc];
      t.my += fs + tb.s64[oc];
      t.e += fc * ((tb.c64[ou] + tb.c64[od]) + (tb.c64[oc] + tb.c64[os])) +
             fs * ((tb.s64[ou] + tb.s64[od]) + (tb.s64[oc] + tb.s64[os]));
    }
  }
}

// Σ cos, Σ sin and the right and down bonds' Σ cos(θ - θ') of unit j of
// row y, both colours (core/lattice.right_down_neighbors), each bond once,
// in float64 from the float64 table.
__device__ __forceinline__ void measure_unit(const int8_t* a,
                                             const int8_t* b,
                                             const Geometry& g,
                                             const Tables& tb, int r, int y,
                                             int j, xy::Sums& t) {
  const size_t base = static_cast<size_t>(r) * g.ny * g.half;
  const size_t row = base + static_cast<size_t>(y) * g.half;
  const size_t dn = base + static_cast<size_t>(wrap(y + 1, g.ny)) * g.half;
  const bool odd = (y & 1) == 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = 2 * j + k;
    if (i >= g.half) break;
    const int ip = wrap(i + 1, g.half);
    const int sa = load<false>(a, row + i), sb = load<false>(b, row + i);
    const int ra = load<false>(b, row + (odd ? ip : i));
    const int da = load<false>(b, dn + i);
    const int rb = load<false>(a, row + (odd ? i : ip));
    const int db = load<false>(a, dn + i);
    t.mx += tb.c64[sa] + tb.c64[sb];
    t.my += tb.s64[sa] + tb.s64[sb];
    t.e += (tb.c64[sa] * (tb.c64[ra] + tb.c64[da]) +
            tb.s64[sa] * (tb.s64[ra] + tb.s64[da])) +
           (tb.c64[sb] * (tb.c64[rb] + tb.c64[db]) +
            tb.s64[sb] * (tb.s64[rb] + tb.s64[db]));
  }
}

}  // namespace clock8
