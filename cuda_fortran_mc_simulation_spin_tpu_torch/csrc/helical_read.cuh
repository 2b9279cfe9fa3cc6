// Modular bit reads of the flat helical colour vectors, shared by the
// helical 2-D and 3-D kernels.  A colour vector is nw uint32 words holding
// m valid bits (bit k of word g = colour index 32g + k); the plain version
// of read_circ is ops/helical_multispin.shift_mod.
#pragma once
#include <cstdint>

// 32 bits of the word sequence v from bit pos on; past word nw-1 reads 0.
__device__ __forceinline__ uint32_t read_lin(const uint32_t* v, int nw,
                                             int pos) {
  const int i = pos >> 5;
  const uint32_t hi = (i + 1 < nw) ? v[i + 1] : 0u;
  return __funnelshift_r(v[i], hi, pos & 31);
}

// 32 bits of the circular m-bit sequence v from bit start < m on.
__device__ __forceinline__ uint32_t read_circ(const uint32_t* v, int nw,
                                              int m, int start) {
  uint32_t out = read_lin(v, nw, start);
  int got = m - start;  // bits before the wrap point
  if (got >= 32) return out;
  out &= (1u << got) - 1u;
  const uint32_t head = read_lin(v, nw, 0);
  while (got < 32) {  // once unless m < 32
    const int take = min(32 - got, m);
    out |= (head & ((1u << take) - 1u)) << got;
    got += take;
  }
  return out;
}
