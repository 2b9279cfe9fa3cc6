// Contiguous int8 byte ranges staged in shared memory by the tile kernels
// (csrc/ising3d_pallas.cu tile_kernel, csrc/clock_multisweep.cu and
// csrc/ising2d_multisweep.cu multisweep_kernel), the four-byte windows
// they read there and the write-back of a staged range; and the tiles of
// whole rows the two 2-D multisweeps walk (RowTiles).
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

#include <algorithm>
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

// The launch constants of the 2-D multisweeps' tiles
// (ops/ising2d_multisweep.ms_tiles computes them, in this order; the
// entry points take them as passed).  A tile is `rows` whole rows of one
// replica, or past MAX_COLUMNS columns one row's chunk of cw columns.
struct RowTiles {
  int rows;    // rows of a tile (1 in a chunk)
  int lux;     // log2 of the threads along a row: ux = 1 << lux
  int cw;      // columns of a tile: half, or a chunk's (a multiple of 4)
  int nch;     // chunks a row (1 with whole rows)
  int nty;     // row tiles a replica
  int buf[4];  // byte offsets of the own, centre, y0 - 1 and y0 + rows
               // copies in shared memory (16-B aligned, each with 16
               // bytes before it and 32 after its vectors)
  int smem;    // bytes of dynamic shared memory
};
constexpr int ROW_TILE_INTS = 10;
static_assert(sizeof(RowTiles) == ROW_TILE_INTS * 4,
              "ops/ising2d_multisweep.py passes the tiles as 10 ints");
// the widest chunk (ops/ising2d_multisweep.CHUNK_COLS)
constexpr int MAX_COLUMNS = 4096;

// n staged ranges of need[k] bytes at the byte offsets buf[k] of shared
// memory, in order: each 16-B aligned after a 16-byte guard, all inside
// smem bytes, at most 48 KB
__host__ inline bool spans_ok(const int* buf, const int* need, int n,
                              int smem) {
  int end = 0;
  for (int k = 0; k < n; ++k) {
    if (buf[k] % 16 != 0 || buf[k] < end + 16) return false;
    end = buf[k] + need[k];
  }
  return smem >= end && smem <= 48 * 1024;
}

// Tiles that cover (ny, half) planes, each tile non-empty: nty tiles of
// `rows` whole rows (cw = half, nch 1), or past a row of MAX_COLUMNS one
// row's nch chunks of cw columns (a multiple of 4)
__host__ inline bool row_cover_ok(int rows, int cw, int nch, int nty,
                                  int ny, int half) {
  if (rows < 1 || cw < 1 || nch < 1 ||
      static_cast<long long>(nch) * cw < half ||
      static_cast<long long>(nch - 1) * cw >= half ||
      (nch > 1 && (cw % 4 != 0 || rows != 1 || cw > MAX_COLUMNS)) ||
      (nch == 1 && cw != half))
    return false;
  return nty >= 1 && static_cast<long long>(nty) * rows >= ny &&
         static_cast<long long>(nty - 1) * rows < ny &&
         static_cast<long long>(nty) * nch < (1LL << 31);
}

// The constants as ms_tiles builds them; refuses others
__host__ inline bool row_tiles_ok(const RowTiles& t, int ny, int half) {
  if (t.lux < 2 || t.lux > 8 || t.rows % (STAGE_THREADS >> t.lux) != 0 ||
      !row_cover_ok(t.rows, t.cw, t.nch, t.nty, ny, half))
    return false;
  // own, centre (two columns wider in a chunk), then the rows
  const long long lx =
      static_cast<long long>(t.rows - 1) * half + std::min(t.cw, half);
  const int need[4] = {span_bytes(lx), span_bytes(lx + 2),
                       span_bytes(std::min(t.cw, half)),
                       span_bytes(std::min(t.cw, half))};
  return spans_ok(t.buf, need, 4, t.smem);
}

// The walk's steps: a grid of `blocks` blocks as (replicas, row tiles,
// chunks) of the walk, blocks = (step[0] nty + step[1]) nch + step[2]
__host__ inline void row_tile_steps(const RowTiles& t, int blocks,
                                    int (&step)[3]) {
  const int per_rep = t.nty * t.nch;
  step[0] = blocks / per_rep;
  step[1] = (blocks - step[0] * per_rep) / t.nch;
  step[2] = blocks - step[0] * per_rep - step[1] * t.nch;
}

// A block's next tile (r, yt, cx), gridDim.x tiles on: the steps added
// with carries, no division
__device__ __forceinline__ void next_row_tile(const RowTiles& t,
                                              const int (&step)[3], int& r,
                                              int& yt, int& cx) {
  cx += step[2];
  if (cx >= t.nch) {
    cx -= t.nch;
    ++yt;
  }
  yt += step[1];
  if (yt >= t.nty) {
    yt -= t.nty;
    ++r;
  }
  r += step[0];
}

}  // namespace tiles8
