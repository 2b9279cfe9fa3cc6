// Bond algebras of the bit-sliced packed clock engines (q = 6, 4, 3),
// shared by csrc/clock_planes.cu (periodic) and
// csrc/clock_helical_multispin.cu (helical q = 6).  Each word holds 32
// sites of one colour; the plain versions are ops/clock_multispin.py
// (_decide, draw_planes, _obs_partial), ops/clock4_multispin.py (_decide4,
// draw_planes4, _obs_partial4) and ops/clock3_multispin.py (_decide3,
// draw_planes3, _obs_partial3).
//
//   q = 6: Z6 = Z2 x Z3, planes (s, t0, t1); 2cos(2pi(c-n)/6) =
//          ~x + 3(x^eq) - 2, so 2dE in [-16, 16] from four 4:3 counters;
//          12-bit proposal thermometer (819, 819, 820, 819, 819)/4096;
//          chains p1, p2, p4, p8, p8 gated by the digits of 2dE.
//   q = 4: digit planes (b0, b1); dE in [-8, 8] from two side sums;
//          thermometer (1365, 1366, 1365)/4096; chains p1, p2, p4, p8.
//   q = 3: planes (t0, t1); 2dE = 3k, k in [-4, 4]; one proposal bit;
//          chains p1, p2, p4.
//
// Random words are drawn in the plain versions' order: the thermometer
// (or proposal) words first, then each chain's words, chain after chain,
// by the unrolled draw_unrolled<Q> from a per-launch DrawTable (both
// kernels).
#pragma once
#include <cstdint>

#include "bernoulli.cuh"
#include "philox.cuh"

namespace clockq {

constexpr int MAX_CHAINS = 5;

__device__ __forceinline__ void ha(uint32_t a, uint32_t b, uint32_t& s,
                                   uint32_t& c) {
  s = a ^ b;
  c = a & b;
}

__device__ __forceinline__ void fa(uint32_t a, uint32_t b, uint32_t cin,
                                   uint32_t& s, uint32_t& c) {
  const uint32_t t = a ^ b;
  s = t ^ cin;
  c = (a & b) | (cin & t);
}

// [u < T] for the 12-bit uniform whose digits, MSB first, are p[0..11].
__device__ __forceinline__ uint32_t lt12(const uint32_t (&p)[12],
                                         uint32_t t) {
  uint32_t lt = 0u;
#pragma unroll
  for (int j = 11; j >= 0; --j) {
    const uint32_t nr = ~p[j];
    lt = ((t >> (11 - j)) & 1u) ? (nr | lt) : (nr & lt);
  }
  return lt;
}

// Traits of each q: state planes NS, random planes NR, chains NC.
template <int Q>
struct Traits;
template <>
struct Traits<6> {
  static constexpr int NS = 3, NR = 8, NC = 5;
};
template <>
struct Traits<4> {
  static constexpr int NS = 2, NR = 6, NC = 4;
};
template <>
struct Traits<3> {
  static constexpr int NS = 2, NR = 4, NC = 3;
};

// The q = 6 and q = 4 proposal planes from the 12 thermometer words
template <int Q>
__device__ __forceinline__ void thermometer(const uint32_t (&p)[12],
                                            uint32_t* r) {
  if constexpr (Q == 6) {
    const uint32_t c1 = lt12(p, 819u), c2 = lt12(p, 1638u);
    const uint32_t c3 = lt12(p, 2458u), c4 = lt12(p, 3277u);
    r[0] = ~(c1 ^ c2 ^ c3 ^ c4);    // rho = r mod 2
    r[1] = c1 | (c4 & ~c3);         // r mod 3 == 1
    r[2] = (c2 & ~c1) | ~c4;        // r mod 3 == 2
  } else {
    const uint32_t c1 = lt12(p, 1365u), c2 = lt12(p, 2731u);
    r[0] = c1 | ~c2;                // r odd
    r[1] = ~c1;                     // r >= 2
  }
}

// The draw of one launch as a table (ops/multispin_rng.clock_draw_table):
// the NP proposal words (12, or 1 for q = 3) are draws [0, NP), chain i
// folds draws [end[i-1], end[i]) (end[-1] = NP), draw n being word n % 4
// of Philox call n / 4; digit[n] is all ones on a one digit, else zero;
// bit c of live[c / 32]: call c has a draw below n; of fast[c / 32]: draws
// 4c .. 4c + 3 are all chain draws below n with no chain end among them;
// bit d of ends[d / 32]: some chain ends at draw d < n.  Sized for the
// longest draw: 12 thermometer words and five chains of 28 digits
// (ops/clock_planes._chain_len), 152 draws.
constexpr int DRAW_CALLS = 38;
struct DrawTable {
  uint32_t digit[4 * DRAW_CALLS];
  uint32_t live[2], fast[2];
  uint32_t ends[(4 * DRAW_CALLS + 31) / 32];
  int end[MAX_CHAINS];
  int n;
};
static_assert(sizeof(DrawTable) == 167 * 4, "ops/multispin_rng.py passes "
              "the table as 167 32-bit words");

// A table the draw can follow, for proposal words np (host check before a
// launch)
inline bool draw_table_ok(const DrawTable& t, int np) {
  int prev = np;
  for (int i = 0; i < MAX_CHAINS; ++i) {
    if (t.end[i] < prev) return false;
    prev = t.end[i];
  }
  return t.n == prev && t.n <= 4 * DRAW_CALLS;
}

template <int N>
__device__ __forceinline__ bool table_bit(const uint32_t (&m)[N], int c) {
  return ((m[c >> 5] >> (c & 31)) & 1u) != 0u;
}

// Chain draw d (< t.n) of a call that is not fast: where chains end at d
// (a uniform test of one table bit), they take the running chain b (an
// empty chain takes 0); then d folds in
template <int NC>
__device__ __forceinline__ void chain_draw(const DrawTable& t, int d,
                                           uint32_t w, uint32_t& b,
                                           uint32_t (&out)[NC]) {
  if (table_bit(t.ends, d)) {  // uniform
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (d == t.end[i]) {
        out[i] = b;
        b = 0u;
      }
    }
  }
  b = fold(w, b, t.digit[d]);
}

// The NR random planes of the word at Philox counter (c0, c1, c2, .) under
// the round keys rk_in (philox_round_keys of the phase key): the plain
// draw's words in its order (the proposal words, then chain after chain
// from its lowest one digit, trailing zero digits drawing none,
// ops/clock_planes.draw_planes_plain), in a fully unrolled line.  The Philox call
// index and the word within it are compile-time constants; a chain draw
// folds into the running chain in one three-input op, B <- maj(r, B, D),
// with D the draw's digit from the table, a launch constant; the chain
// ends are uniform, so a fast call folds its four draws straight; the
// round keys are held in registers; the chain calls go in pairs, two
// independent chains of rounds (a pair's second call past the last draw
// is drawn and dropped).
template <int Q>
__device__ __forceinline__ void draw_unrolled(const DrawTable& t,
                                              const uint2 (&rk_in)[10],
                                              uint32_t c0, uint32_t c1,
                                              uint32_t c2,
                                              uint32_t (&r)[Traits<Q>::NR]) {
  constexpr int NC = Traits<Q>::NC;
  constexpr int NPL = Traits<Q>::NR - NC;  // proposal planes
  constexpr int NP = Q == 3 ? 1 : 12;      // proposal words
  constexpr int TC = (NP + 3) / 4;         // the calls that hold them
  uint2 rk[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    rk[k] = rk_in[k];
    asm volatile("" : "+r"(rk[k].x), "+r"(rk[k].y));
  }
  uint32_t w[4 * TC];
#pragma unroll
  for (int k = 0; k < TC; ++k) {
    const uint4 v = philox_rk(make_uint4(c0, c1, c2, k), rk);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  if constexpr (Q == 3) {
    r[0] = w[0];
  } else {
    thermometer<Q>(w, r);
  }
  uint32_t b = 0u, out[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) out[i] = 0u;
  // the chain draws in the last proposal call (q = 3: draws 1 .. 3)
#pragma unroll
  for (int d = NP; d < 4 * TC; ++d)
    if (d < t.n) chain_draw(t, d, w[d], b, out);
#pragma unroll
  for (int n0 = TC; n0 < DRAW_CALLS; n0 += CALL_PAIR) {
    if (!table_bit(t.live, n0)) break;  // uniform
    uint4 v[CALL_PAIR];
#pragma unroll
    for (int k = 0; k < CALL_PAIR; ++k)
      if (n0 + k < DRAW_CALLS)
        v[k] = philox_rk(make_uint4(c0, c1, c2, n0 + k), rk);
#pragma unroll
    for (int k = 0; k < CALL_PAIR; ++k) {
      const int c = n0 + k;
      if (c >= DRAW_CALLS || !table_bit(t.live, c)) continue;
      const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      if (table_bit(t.fast, c)) {  // uniform
#pragma unroll
        for (int j = 0; j < 4; ++j) b = fold(u[j], b, t.digit[4 * c + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * c + j < t.n) chain_draw(t, 4 * c + j, u[j], b, out);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (t.end[i] == t.n) {
      out[i] = b;
      b = 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) r[NPL + i] = out[i];
}

// q = 6 decision: x = (s, t0, t1) of the centre word, n[plane][bond] the
// neighbour planes (up, dn, ctr, side), r = (rho, rt1, rt2, B1, B2, B4,
// B8a, B8b).  Writes the new planes into x and the final-value bond
// planes (xf, wf) for the fused observables.
__device__ __forceinline__ void decide6(uint32_t (&x)[3],
                                        const uint32_t (&n)[3][4],
                                        const uint32_t (&r)[8],
                                        uint32_t (&xf)[4],
                                        uint32_t (&wf)[4]) {
  const uint32_t rho = r[0], rt1 = r[1], rt2 = r[2];
  const uint32_t z = ~(x[1] | x[2]), rz = ~(rt1 | rt2);
  const uint32_t t0p = (z & rt1) | (x[1] & rz) | (x[2] & rt2);
  const uint32_t t1p = (z & rt2) | (x[1] & rt1) | (x[2] & rz);
  uint32_t xb[4], xpb[4], wb[4], wpb[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    xb[b] = x[0] ^ n[0][b];
    const uint32_t eq = ~((x[1] ^ n[1][b]) | (x[2] ^ n[2][b]));
    const uint32_t eqp = ~((t0p ^ n[1][b]) | (t1p ^ n[2][b]));
    xpb[b] = xb[b] ^ rho;
    wb[b] = xb[b] ^ eq;
    wpb[b] = xpb[b] ^ eqp;
  }
  uint32_t nx[3], nxp[3], nw[3], nwp[3];
  count4(xb[0], xb[1], xb[2], xb[3], nx[0], nx[1], nx[2]);
  count4(xpb[0], xpb[1], xpb[2], xpb[3], nxp[0], nxp[1], nxp[2]);
  count4(wb[0], wb[1], wb[2], wb[3], nw[0], nw[1], nw[2]);
  count4(wpb[0], wpb[1], wpb[2], wpb[3], nwp[0], nwp[1], nwp[2]);
  // na + 3 nw = (na + nw) + 2 nw, 5 bits
  auto scaled = [](const uint32_t (&na)[3], const uint32_t (&w)[3],
                   uint32_t (&o)[5]) {
    uint32_t c, b1, b2, b3;
    ha(na[0], w[0], o[0], c);
    fa(na[1], w[1], c, b1, c);
    fa(na[2], w[2], c, b2, c);
    b3 = c;
    ha(b1, w[0], o[1], c);
    fa(b2, w[1], c, o[2], c);
    fa(b3, w[2], c, o[3], o[4]);
  };
  uint32_t p[5], m[5];
  scaled(nxp, nw, p);
  scaled(nx, nwp, m);
  // D = P - N as P + ~N + 1, 5 bits
  uint32_t d[5], c = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 5; ++i) fa(p[i], ~m[i], c, d[i], c);
  const uint32_t pos = c & (d[0] | d[1] | d[2] | d[3] | d[4]);
  const uint32_t passes = (~d[0] | r[3]) & (~d[1] | r[4]) & (~d[2] | r[5]) &
                          (~(d[3] | d[4]) | r[6]) & (~d[4] | r[7]);
  const uint32_t acc = ~pos | passes;
  const uint32_t flip = rho & acc;
  x[0] ^= flip;
  x[1] = (t0p & acc) | (x[1] & ~acc);
  x[2] = (t1p & acc) | (x[2] & ~acc);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    xf[b] = xb[b] ^ flip;
    wf[b] = (wpb[b] & acc) | (wb[b] & ~acc);
  }
}

// q = 4 decision: x = (b0, b1), r = (r0, r1, B1, B2, B4, B8); final
// bond planes (af, zf).
__device__ __forceinline__ void decide4(uint32_t (&x)[2],
                                        const uint32_t (&n)[2][4],
                                        const uint32_t (&r)[6],
                                        uint32_t (&af)[4],
                                        uint32_t (&zf)[4]) {
  const uint32_t r0 = r[0];
  const uint32_t rz = r[1] ^ (x[0] & r0);
  uint32_t pos_[4], neg[4], posp[4], negp[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t a = x[0] ^ n[0][b], z = x[1] ^ n[1][b];
    const uint32_t na = ~a, nap = ~(a ^ r0), zp = z ^ rz;
    af[b] = a;
    zf[b] = z;
    pos_[b] = na & ~z;
    neg[b] = na & z;
    posp[b] = nap & ~zp;
    negp[b] = nap & zp;
  }
  auto side = [](const uint32_t (&u)[4], const uint32_t (&v)[4],
                 uint32_t (&o)[4]) {
    uint32_t o1, t1, f1, o2, t2, f2, c;
    count4(u[0], u[1], u[2], u[3], o1, t1, f1);
    count4(v[0], v[1], v[2], v[3], o2, t2, f2);
    ha(o1, o2, o[0], c);
    fa(t1, t2, c, o[1], c);
    fa(f1, f2, c, o[2], o[3]);
  };
  uint32_t p[4], m[4];
  side(pos_, negp, p);
  side(neg, posp, m);
  uint32_t d[4], c = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 4; ++i) fa(p[i], ~m[i], c, d[i], c);
  const uint32_t pos = c & (d[0] | d[1] | d[2] | d[3]);
  const uint32_t passes = (~d[0] | r[2]) & (~d[1] | r[3]) & (~d[2] | r[4]) &
                          (~d[3] | r[5]);
  const uint32_t acc = ~pos | passes;
  const uint32_t f0 = r0 & acc, f1 = rz & acc;
  x[0] ^= f0;
  x[1] ^= f1;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    af[b] ^= f0;
    zf[b] ^= f1;
  }
}

// q = 3 decision: x = (t0, t1), r = (rb, B1, B2, B4); final equality
// planes ef.
__device__ __forceinline__ void decide3(uint32_t (&x)[2],
                                        const uint32_t (&n)[2][4],
                                        const uint32_t (&r)[4],
                                        uint32_t (&ef)[4]) {
  const uint32_t rb = r[0];
  const uint32_t z = ~(x[0] | x[1]);
  const uint32_t t0p = (z & ~rb) | (x[1] & rb);
  const uint32_t t1p = (z & rb) | (x[0] & ~rb);
  uint32_t eq[4], eqp[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    eq[b] = ~((x[0] ^ n[0][b]) | (x[1] ^ n[1][b]));
    eqp[b] = ~((t0p ^ n[0][b]) | (t1p ^ n[1][b]));
  }
  uint32_t p[3], m[3];
  count4(eq[0], eq[1], eq[2], eq[3], p[0], p[1], p[2]);
  count4(eqp[0], eqp[1], eqp[2], eqp[3], m[0], m[1], m[2]);
  uint32_t d[3], c = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 3; ++i) fa(p[i], ~m[i], c, d[i], c);
  const uint32_t pos = c & (d[0] | d[1] | d[2]);
  const uint32_t passes = (~d[0] | r[1]) & (~d[1] | r[2]) & (~d[2] | r[3]);
  const uint32_t acc = ~pos | passes;
  x[0] = (t0p & acc) | (x[0] & ~acc);
  x[1] = (t1p & acc) | (x[1] & ~acc);
#pragma unroll
  for (int b = 0; b < 4; ++b) ef[b] = (eqp[b] & acc) | (eq[b] & ~acc);
}

// 2 sum cos of the real sites vm of one q = 6 word: (-1)^s (3[tau=0] - 1).
__device__ __forceinline__ int m2_word6(uint32_t s, uint32_t t0, uint32_t t1,
                                        uint32_t vm) {
  const uint32_t zz = ~(t0 | t1) & vm;
  return 3 * __popc(zz) - 6 * __popc(s & zz) + 2 * __popc(s & vm) -
         __popc(vm);
}

// sum sin / (sqrt(3)/2) of the real sites vm of one q = 6 word.
__device__ __forceinline__ int my2_word6(uint32_t s, uint32_t t0, uint32_t t1,
                                         uint32_t vm) {
  return __popc(((s & t0) | (~s & t1)) & vm) -
         __popc(((~s & t0) | (s & t1)) & vm);
}

}  // namespace clockq
