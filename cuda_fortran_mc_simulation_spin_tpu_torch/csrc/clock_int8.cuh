// The int8 q-state clock checkerboard site rule and its float64 sums:
// update_word, four sites of a row at a time, shared by the phase kernel
// (csrc/clock_pallas.cu) and the cooperative multisweep
// (csrc/clock_multisweep.cu), so that both apply the same function to the
// same random words; the measure kernel (csrc/clock_measure_pallas.cu)
// takes its geometry and launch checks.
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
// Unit: two adjacent sites 2j, 2j + 1 of one row; the tail unit of a row
// whose half is odd is masked, so every even nx and ny runs.  Random words
// (ops/clock_pallas.draw_words): the unit's one Philox4x32-10 call at
// counter (replica, row, j, 0) under the phase key; site 2j + k takes
// output 2k for its candidate and 2k + 1 for its acceptance, each a
// uniform from its top 24 bits (xy::u24, as JAX stencil.bits_to_uniform).
// A word of four sites from an even column is two units, two calls.
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

#include "byte_tiles.cuh"
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

// The sites k0 <= k < nv of a word of four colour sites (byte k of each
// window is column col + k of its row): xv the sites' own window, uv and
// dv the other colour's rows above and below, cv the centre (the same
// column) and sv the side neighbour's window (col + k + d, the row's wrap
// patched in by the caller).  uniforms(k, uc, ua) gives site k's
// candidate and acceptance uniforms.  Returns xv with the new states in
// bytes k0 .. nv - 1; with MEASURE it adds each updated site's fused
// float64 sums of a measuring phase b (JAX clock_multisweep.py:87-95): Σ
// cos and Σ sin of the new state and of the centre, and S_new·h over the
// site's four bonds (the other colour is final, so every bond is counted
// once; reduce_kernel negates it into e).  tab and tab64 are the staged
// (cos, sin) tables, qm1 = q - 1 as a float.
template <bool MEASURE, typename Uniforms>
__device__ __forceinline__ uint32_t update_word(
    uint32_t xv, uint32_t uv, uint32_t dv, uint32_t cv, uint32_t sv, int k0,
    int nv, int q, float qm1, float neg_beta, const float2* tab,
    const double2* tab64, Uniforms uniforms, xy::Sums& sums) {
  // the states as table indices, byte by byte (the mask keeps a corrupt
  // byte inside the table; it is the identity on [0, q))
  constexpr uint32_t IDX = 0x7F7F7F7Fu;
  const uint32_t um = uv & IDX, dm = dv & IDX, cm = cv & IDX;
  const uint32_t sm = sv & IDX, xm = xv & IDX;
  uint32_t nxv = xv;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // k rises, so the word's last site breaks the loop
    if (k >= nv) break;
    if (k < k0) continue;
    const uint32_t sel = 0x4440u | k;  // byte k, zero-extended
    const int ou = __byte_perm(um, 0u, sel);
    const int od = __byte_perm(dm, 0u, sel);
    const int oc = __byte_perm(cm, 0u, sel);
    const int os = __byte_perm(sm, 0u, sel);
    const int xk = __byte_perm(xm, 0u, sel);
    const float2 fu = tab[ou], fd = tab[od], fc = tab[oc], fs = tab[os];
    const float hx = __fadd_rn(__fadd_rn(fu.x, fd.x), __fadd_rn(fc.x, fs.x));
    const float hy = __fadd_rn(__fadd_rn(fu.y, fd.y), __fadd_rn(fc.y, fs.y));
    float uc, ua;
    uniforms(k, uc, ua);
    int nw = xk + static_cast<int>(__fmul_rn(uc, qm1)) + 1;
    if (nw >= q) nw -= q;
    const float2 fn = tab[nw], fo = tab[xk];
    const float de = -__fadd_rn(__fmul_rn(__fsub_rn(fn.x, fo.x), hx),
                                __fmul_rn(__fsub_rn(fn.y, fo.y), hy));
    const float prob = expf(__fmul_rn(neg_beta, fmaxf(de, 0.0f)));
    const int out = ua < prob ? nw : xk;
    nxv = tiles8::put_byte(nxv, k, static_cast<uint32_t>(out));
    if (MEASURE) {
      const double2 go = tab64[out], gu = tab64[ou], gd = tab64[od];
      const double2 gc = tab64[oc], gs = tab64[os];
      sums.mx += go.x + gc.x;
      sums.my += go.y + gc.y;
      sums.e += go.x * ((gu.x + gd.x) + (gc.x + gs.x)) +
                go.y * ((gu.y + gd.y) + (gc.y + gs.y));
    }
  }
  return nxv;
}

}  // namespace clock8
