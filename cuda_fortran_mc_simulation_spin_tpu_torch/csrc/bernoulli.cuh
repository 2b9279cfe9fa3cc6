// Bernoulli word planes of the bit-packed engines: each bit of the
// returned word is 1 with probability q / 2^k, from Philox words
// (philox.cuh), drawn for every bit-packed Ising kernel's chains by the
// unrolled chain_planes (the clock kernels' draw_unrolled,
// clock_algebra.cuh, folds the same way); and the bit-sliced counters and
// flip masks of the 4- and 6-neighbour stencils.  Shared by the Ising and
// clock kernels.
#pragma once
#include <cstdint>

#include "philox.cuh"

constexpr int CHAIN_BITS = 20;  // the Ising chains' digits

// Digits d_1..d_k of p are bits k-1..0 of q = round(p * 2^k) (k <= 32);
// a chain folds B <- r | B on a one digit, r & B on a zero digit, one
// Philox word r a digit, from the last one digit up to d_1
// (ops/ising2d_multispin._bern_plane).  Trailing zero digits draw no word.
// The Ising chains take k = CHAIN_BITS; the clock chains k =
// _chain_len(p), 6..28 (ops/clock_planes.py).

// The B4, B8, B12 chains of one launch as a table
// (ops/multispin_rng.chain_table): draws [0, e4) fold into B4, [e4, e8)
// into B8, [e8, n) into B12, draw n being word n % 4 of Philox call n / 4.
// fast bit c: draws 4c .. 4c + 3 all lie below n with no chain boundary
// among them; live bit c: call c has a draw below n.
constexpr int CHAIN_CALLS = 15;  // 60 draws: three chains of 20 digits
struct ChainTable {
  uint32_t digit[4 * CHAIN_CALLS];  // all ones on a one digit, else zero
  uint32_t live, fast;
  int e4, e8, n;
};
static_assert(sizeof(ChainTable) == 65 * 4, "ops/multispin_rng.py passes "
              "the table as 65 32-bit words");

// A table the chains can follow (host check before a launch)
inline bool chain_table_ok(const ChainTable& t) {
  return 0 <= t.e4 && t.e4 <= t.e8 && t.e8 <= t.n &&
         t.n <= 4 * CHAIN_CALLS;
}

// r | B on a one digit (d all ones), r & B on a zero digit (d zero)
__device__ __forceinline__ uint32_t fold(uint32_t r, uint32_t b, uint32_t d) {
  return (r & b) | (r & d) | (b & d);
}

// Philox calls computed together: two independent chains of rounds
constexpr int CALL_PAIR = 2;

// The four draws of call c folded into the running chain b; a call with a
// chain boundary or the last draw inside it (not fast) draw by draw
__device__ __forceinline__ void fold_call(const ChainTable& t, int c, uint4 v,
                                          uint32_t& b, uint32_t& p4,
                                          uint32_t& p8) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if ((t.fast >> c) & 1u) {  // uniform
#pragma unroll
    for (int j = 0; j < 4; ++j) b = fold(w[j], b, t.digit[4 * c + j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * c + j;
      if (n < t.n) {  // a boundary at t.n is taken after the loop
        if (n == t.e4) {
          p4 = b;
          b = 0u;
        }
        if (n == t.e8) {
          p8 = b;
          b = 0u;
        }
        b = fold(w[j], b, t.digit[n]);
      }
    }
  }
}

// The B4, B8, B12 planes of the word at Philox counter (c0, c1, c2, .)
// under the round keys rk_in (philox_round_keys of the phase key): the
// chains of q4, q8, q12 drawn in turn from the word's draws n (word n % 4
// of Philox call n / 4), in a fully unrolled loop.  The Philox call index and the
// word within it are compile-time constants; a draw folds into the
// running chain in one three-input op, B <- maj(r, B, D), with D the
// draw's digit (all ones or zero) from the table, a launch constant; the
// chain boundaries are uniform, so a call that holds none folds its four
// draws straight; the round keys are held in registers; the calls go in
// pairs, two independent chains of rounds (a pair's second call past the
// last draw is drawn and dropped).  A chain starts at B = 0 with a one
// digit, so its first draw gives B = r.
__device__ __forceinline__ void chain_planes(const ChainTable& t,
                                             const uint2 (&rk_in)[10],
                                             uint32_t c0, uint32_t c1,
                                             uint32_t c2, uint32_t& p4,
                                             uint32_t& p8, uint32_t& p12) {
  uint32_t b = 0u;
  p4 = p8 = 0u;
  // the round keys in registers: taken from the constant bank they cost a
  // uniform load a round and call
  uint2 rk[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    rk[k] = rk_in[k];
    asm volatile("" : "+r"(rk[k].x), "+r"(rk[k].y));
  }
#pragma unroll
  for (int n0 = 0; n0 < CHAIN_CALLS; n0 += CALL_PAIR) {
    if (((t.live >> n0) & 1u) == 0u) break;  // uniform
    uint4 v[CALL_PAIR];
#pragma unroll
    for (int k = 0; k < CALL_PAIR; ++k)
      if (n0 + k < CHAIN_CALLS)
        v[k] = philox_rk(make_uint4(c0, c1, c2, n0 + k), rk);
#pragma unroll
    for (int k = 0; k < CALL_PAIR; ++k)
      if (n0 + k < CHAIN_CALLS && ((t.live >> (n0 + k)) & 1u))
        fold_call(t, n0 + k, v[k], b, p4, p8);
  }
  if (t.e4 == t.n) {
    p4 = b;
    b = 0u;
  }
  if (t.e8 == t.n) {
    p8 = b;
    b = 0u;
  }
  p12 = b;
}

// Bit-sliced count of four one-bit planes: (ones, twos, fours).
__device__ __forceinline__ void count4(uint32_t n1, uint32_t n2, uint32_t n3,
                                       uint32_t n4, uint32_t& ones,
                                       uint32_t& twos, uint32_t& fours) {
  const uint32_t s1 = n1 ^ n2, c1 = n1 & n2;
  const uint32_t s2 = n3 ^ n4, c2 = n3 & n4;
  const uint32_t c3 = s1 & s2;
  ones = s1 ^ s2;
  twos = c1 ^ c2 ^ c3;
  fours = (c1 & c2) | (c3 & (c1 ^ c2));
}

// 2-D Metropolis flip mask of spin word x from its neighbour count and
// the B4/B8 planes: only (up, count 3|4) and (down, count 1|0) reject,
// with dE = 4 and 8 (ops/ising2d_multispin._flip_plane).
__device__ __forceinline__ uint32_t flip4(uint32_t x, uint32_t ones,
                                          uint32_t twos, uint32_t fours,
                                          uint32_t b4, uint32_t b8) {
  const uint32_t nx = ~x, nf = ~fours;
  const uint32_t c3p = twos & ones & nf;
  const uint32_t c1p = ones & ~twos & nf;
  const uint32_t c0p = ~(ones | twos | fours);
  const uint32_t need4 = (x & c3p) | (nx & c1p);
  const uint32_t need8 = (x & fours) | (nx & c0p);
  return ~(need4 | need8) | (need4 & b4) | (need8 & b8);
}

// Bit-sliced count of six one-bit planes, c = b1 + 2 b2 + 4 b4 in [0, 6]:
// three half adders, a full adder for the ones, a 4:3 counter (sum <= 3)
// for the carries (ops/ising3d_multispin._count6).
__device__ __forceinline__ void count6(uint32_t n1, uint32_t n2, uint32_t n3,
                                       uint32_t n4, uint32_t n5, uint32_t n6,
                                       uint32_t& b1, uint32_t& b2,
                                       uint32_t& b4) {
  const uint32_t s1 = n1 ^ n2, c1 = n1 & n2;
  const uint32_t s2 = n3 ^ n4, c2 = n3 & n4;
  const uint32_t s3 = n5 ^ n6, c3 = n5 & n6;
  b1 = s1 ^ s2 ^ s3;
  const uint32_t t2 = (s1 & s2) | (s3 & (s1 ^ s2));
  uint32_t unused;
  count4(c1, c2, c3, t2, b2, b4, unused);
}

// 3-D Metropolis flip mask of spin word x from its 6-neighbour count and
// the B4/B8/B12 planes: only c = 4|5|6 (up) and c = 2|1|0 (down) reject,
// with dE = 4, 8, 12 (ops/ising3d_multispin._flip_plane3d).
__device__ __forceinline__ uint32_t flip6(uint32_t x, uint32_t b1,
                                          uint32_t b2, uint32_t b4,
                                          uint32_t p4, uint32_t p8,
                                          uint32_t p12) {
  const uint32_t nx = ~x, nb1 = ~b1, nb2 = ~b2, nb4 = ~b4;
  const uint32_t need4 = (x & b4 & nb1 & nb2) | (nx & b2 & nb1 & nb4);
  const uint32_t need8 = (x & b4 & b1) | (nx & b1 & nb2 & nb4);
  const uint32_t need12 = (x & b4 & b2) | (nx & nb1 & nb2 & nb4);
  return ~(need4 | need8 | need12) | (need4 & p4) | (need8 & p8) |
         (need12 & p12);
}
