// Philox4x32-10 counter-based generator (Salmon et al., SC'11), the
// in-kernel generator of the bit-packed engines.  Bitwise the same
// function as core/rng.philox4x32 (which the CPU tests hold against
// Random123's known-answer vectors).
#pragma once
#include <cstdint>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The ten round keys of philox4x32_10 under key (s0, s1): round r uses
// (s0 + r W0, s1 + r W1).  A launch computes them once on the host.
__host__ __device__ inline void philox_round_keys(uint32_t s0, uint32_t s1,
                                                  uint2 (&rk)[10]) {
  for (int r = 0; r < 10; ++r)
    rk[r] = make_uint2(s0 + r * 0x9E3779B9u, s1 + r * 0xBB67AE85u);
}

// philox4x32_10 with its round keys given (philox_round_keys)
__device__ __forceinline__ uint4 philox_rk(uint4 c, const uint2 (&rk)[10]) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ rk[r].x, lo1, hi0 ^ c.w ^ rk[r].y, lo0);
  }
  return c;
}
