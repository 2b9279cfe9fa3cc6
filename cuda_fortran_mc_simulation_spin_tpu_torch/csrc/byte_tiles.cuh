// Contiguous int8 byte ranges staged in shared memory by the tile kernels
// (csrc/ising3d_pallas.cu tile_kernel, csrc/clock_multisweep.cu
// multisweep_kernel), the four-byte windows they read there and the
// write-back of a staged range.
//
// A range of len bytes at any address src is copied as the aligned 16-B
// vectors that cover it (cp.async, bypassing L1, so a read after a grid
// barrier sees what other SMs wrote), src's byte landing at buf + (src mod
// 16).  A window of four bytes at byte p of shared memory is one funnel
// shift of the aligned words p >> 2 and (p >> 2) + 1, by 8 (p & 3) bits.
// A range is written back in whole aligned vectors, and byte by byte at
// its two ragged ends: no byte outside it is stored.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tiles8 {

// the blocks' threads: every thread of the block calls stage and
// write_back
constexpr int STAGE_THREADS = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Starts the copy of bytes [src, src + len) into buf: the aligned 16-B
// vectors that cover them, src's byte landing at buf + (src mod 16), which
// it returns.  The caller commits, waits and meets a barrier.
__device__ __forceinline__ int stage(uint8_t* buf, const int8_t* src,
                                     int len) {
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int8_t* base = src - sh;
  const int nv = (sh + len + 15) >> 4;
  for (int v = threadIdx.x; v < nv; v += STAGE_THREADS)
    cp_async16(buf + 16 * v, base + 16 * v);
  return sh;
}

// Writes bytes [0, len) of the range staged at buf + sh back to dst (sh =
// dst mod 16): whole aligned vectors, bytes at the ragged ends.
__device__ __forceinline__ void write_back(int8_t* dst, const uint8_t* buf,
                                           int sh, int len) {
  int8_t* base = dst - sh;
  const int nv = (sh + len + 15) >> 4;
  for (int v = threadIdx.x; v < nv; v += STAGE_THREADS) {
    const int lo = 16 * v - sh;
    if (lo >= 0 && lo + 16 <= len) {
      *reinterpret_cast<uint4*>(base + 16 * v) =
          *reinterpret_cast<const uint4*>(buf + 16 * v);
    } else {
      for (int b = 0; b < 16; ++b)
        if (lo + b >= 0 && lo + b < len)
          dst[lo + b] = static_cast<int8_t>(buf[16 * v + b]);
    }
  }
}

// Byte k of w replaced by the low byte of b
__device__ __forceinline__ uint32_t put_byte(uint32_t w, int k, uint32_t b) {
  return __byte_perm(w, b, 0x3210u ^ ((static_cast<uint32_t>(k) ^ 4u)
                                      << (4 * k)));
}

// A window of four bytes: the words at w[0], w[1] shifted by sh bits
__device__ __forceinline__ uint32_t win(const uint32_t* w, int sh) {
  return __funnelshift_r(w[0], w[1], sh);
}

// Bytes a range of len bytes takes in shared memory: its covering
// vectors (sh + len < len + 16) and 32 bytes after them, where a window's
// second word may fall
__host__ inline int span_bytes(long long len) {
  return static_cast<int>(16 * ((len + 15) / 16 + 2));
}

}  // namespace tiles8
