// Bernoulli word planes of the bit-packed engines: each bit of the
// returned word is 1 with probability q / 2^k, from Philox words
// (philox.cuh); and the bit-sliced counters and flip masks of the 4- and
// 6-neighbour stencils.  Shared by the Ising and clock kernels.
#pragma once
#include <cstdint>

#include "philox.cuh"

constexpr int CHAIN_BITS = 20;  // the Ising chains' digits

// Digits d_1..d_k of p are bits k-1..0 of q = round(p * 2^k) (k <= 32);
// fold B <- r | B on a one digit, r & B on a zero digit, from the last one
// digit up to d_1 (ops/ising2d_multispin._bern_plane).  Trailing zero
// digits draw no word.  The Ising chains take k = CHAIN_BITS; the clock
// chains k = _chain_len(p), 6..28 (ops/clock_planes.py).
__device__ __forceinline__ uint32_t bern_word(WordStream& s, uint32_t q,
                                              int nbits = CHAIN_BITS) {
  if (q == 0u) return 0u;
  int k = __ffs(q) - 1;
  uint32_t b = s.next();
  for (++k; k < nbits; ++k) {
    const uint32_t r = s.next();
    b = ((q >> k) & 1u) ? (r | b) : (r & b);
  }
  return b;
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
