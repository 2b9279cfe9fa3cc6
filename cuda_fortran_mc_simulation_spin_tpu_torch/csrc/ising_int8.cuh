// The int8 2-D checkerboard Ising phase of the three int8 2-D Ising
// launches: the phase kernel and its halo mode (csrc/ising2d_pallas.cu
// phase_kernel, one tile a block) and the cooperative multisweep
// (csrc/ising2d_multisweep.cu multisweep_kernel, which walks every tile of
// each phase) run tile() on the same staged row tiles (csrc/byte_tiles.cuh
// RowTiles).  The 3-D phase (csrc/ising3d_pallas.cu) applies the same
// rule four sites a word on its own tiles, and the measure kernel (csrc/
// ising2d_measure_pallas.cu) sums four sites a word; they, and the masked
// helical kernels (csrc/helical_pallas.cu), take only block_add and the
// launch checks from here.
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
// (dE / 2), flip iff k <= 0 or word < t_k, t_2 = t4, t_4 = t8
// = round(exp(-2 beta k) * 2^32) (uint32 compare).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "byte_tiles.cuh"
#include "philox.cuh"

namespace ising8 {

constexpr int THREADS = 256;

struct Geometry {
  int nz, ny, half;  // nz = 1 in 2-D
  int units;         // (half + 3) / 4 units a row
};

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

// The tile body (tile below).  A tile is `rows` whole rows y0 .. of one
// replica (past MAX_COLUMNS columns one row's chunk of cw columns).  Its
// four byte ranges are contiguous: its own sites, the other colour's rows
// y0 .. (a chunk widened by a column each side), and the other colour's
// rows y0 - 1 and y0 + rows, wrapped in y, or in the halo mode the
// exchanged halo rows at a shard's first and last rows.  The block stages
// them in shared memory (cp.async from the aligned 16-B vectors that
// cover them, any base address), then thread t takes rows t >> lux, +
// 256 >> lux, ... of the tile and words (t mod 2^lux), + 2^lux, ... of
// each.  Each neighbour window of a word is one funnel shift of two
// aligned shared-memory words, the same shift for every word of a row;
// the centre and side neighbours are the windows of one word pair one
// byte apart (which is which follows the row's parity), the row's wrap
// (or the column halo) patched into the side window's end byte.  A
// shard at col0 % 4 != 0 starts its rows' words col0 % 4 columns early,
// so that a word is still one global unit and one Philox call: the bytes
// before the shard's first column (and past its last) are read and
// masked, never stored or summed.  New bytes go to the tile's own copy,
// and the block writes its range back in aligned vectors, bytes at the
// ragged ends; or (DIRECT) each thread stores its word's new bytes to
// the plane itself, a 32-bit store where the word is whole and aligned.
// Every site lies in one tile, so a phase stores each site once and no
// byte outside the tiles; the own range is staged before any store, and
// no other tile reads it.
//
// The rule, four sites a 32-bit word (csrc/ising3d_pallas.cu's in 2-D).
// With K the neighbours whose spin differs from the site's, k = s * nsum
// = 4 - 2K: flip iff K >= 2, or K = 1 and word < t4, or K = 0 and word <
// t8.  As t8 <= t4, that is K + L >= 2 with L the thresholds the word
// lies below.  The bit 1 of a ±1 byte is its sign, so Σ_n ((x ^ n) &
// 0x02020202) holds 2K a byte and ((2K + 2L + 12) & 16) is the flip
// (no byte carries into the next: 2K + 2L + 12 <= 24).  The fused sums of
// a measuring phase: m = Σ new + Σ o from the sign bits, e = -Σ new *
// nsum = Σ (2K' - 4), K' the neighbours differing from the new spin; per
// thread, then per tile by block_add (int64 atomics, exact in any order).

constexpr uint32_t SIGN = 0x02020202u;

// Byte k of the result: the thresholds word k lies below, 0 .. 2 (t8 <=
// t4)
__device__ __forceinline__ uint32_t below2(uint4 w, uint32_t t4,
                                           uint32_t t8) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t lv = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ws[k] < t4) lv += 1u << (8 * k);
    if (ws[k] < t8) lv += 1u << (8 * k);
  }
  return lv;
}

// One tile (replica r, row tile yt, chunk cx) of a colour phase of (R,
// p.ny, p.half) planes: x the colour updated in place, o the other, rk
// the phase key's round keys.  p holds the launch's ny, half, t4 >= t8
// and t (tiles8::RowTiles, the constants of ops/ising2d_multisweep.
// ms_tiles); HALO also the shard's halo rows up, dn ((R, 1, half)), its
// halo columns lf, rt ((R, ny, 1), or null: periodic in x) and global
// offsets rep0, row0, col0; INJECT the injected (R, ny, half) uint32
// words bits in place of Philox's.  MEASURE adds the tile's fused (m, e)
// to dst()[0], dst()[1].  DIRECT stores each new word to x itself, in
// place of the tile's copy and its write-back (the phase kernel's mode;
// the multisweep keeps the write-back).  Every thread of the block calls
// it; it ends with a barrier, after which the block may stage the next
// tile.
template <bool MEASURE, bool HALO, bool INJECT, bool DIRECT = false, class P,
          class Dst>
__device__ __forceinline__ void tile(const P& p, uint8_t* sm,
                                     const uint2 (&rk)[10], int8_t* x,
                                     const int8_t* o, int color, int r,
                                     int yt, int cx, Dst dst) {
  using tiles8::put_byte;
  using tiles8::stage;
  using tiles8::win;
  const tiles8::RowTiles& t = p.t;
  const int half = p.half, ny = p.ny;
  const int ux = 1 << t.lux, tr = THREADS >> t.lux;
  const int tx = threadIdx.x & (ux - 1), ty = threadIdx.x >> t.lux;
  const int c0 = cx * t.cw;
  const int ncw = min(t.cw, half - c0);
  // the centre range's columns: a chunk's widened by one each side
  const int clo = c0 > 0 ? c0 - 1 : 0;
  const int chi = min(c0 + ncw + 1, half);
  const int y0 = yt * t.rows;
  const int nr = min(t.rows, ny - y0);
  const int lx = (nr - 1) * half + ncw;
  const int lc = (nr - 1) * half + (chi - clo);
  // the shard's offsets (0 on a periodic lattice); lo: the columns a
  // row's words start early
  int rep0 = 0, row0 = 0, col0 = 0;
  if constexpr (HALO) {
    rep0 = p.rep0;
    row0 = p.row0;
    col0 = p.col0;
  }
  const int lo = col0 & 3;
  const size_t base = static_cast<size_t>(r) * ny * half;
  int8_t* xs = x + base + static_cast<size_t>(y0) * half + c0;
  const int8_t* ob = o + base;
  const int8_t* up =
      ob + static_cast<size_t>(y0 == 0 ? ny - 1 : y0 - 1) * half;
  const int8_t* dn =
      ob + static_cast<size_t>(y0 + nr == ny ? 0 : y0 + nr) * half;
  if constexpr (HALO) {
    if (y0 == 0) up = p.up + static_cast<size_t>(r) * half;
    if (y0 + nr == ny) dn = p.dn + static_cast<size_t>(r) * half;
  }
  const int shx = stage(sm + t.buf[0], xs, lx);
  const int shc =
      stage(sm + t.buf[1], ob + static_cast<size_t>(y0) * half + clo, lc);
  const int shu = stage(sm + t.buf[2], up + c0, ncw);
  const int shd = stage(sm + t.buf[3], dn + c0, ncw);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  int m = 0, e = 0;
  for (int ry = ty; ry < nr; ry += tr) {
    const int y = y0 + ry;
    // colour 0 on an odd row and colour 1 on an even row read column
    // i + 1, the others column i - 1
    const int d = (color == 0) == (((row0 + y) & 1) == 1) ? 1 : -1;
    // byte positions in shared memory of the row's first word's windows:
    // own, centre (its lower window), up, down
    const int row = ry * half;
    const int px = t.buf[0] + shx + row - lo;
    const int pc =
        t.buf[1] + shc + row + (c0 - clo) - lo - (d < 0 ? 1 : 0);
    const int pu = (ry == 0 ? t.buf[2] + shu
                            : t.buf[1] + shc + row - half + (c0 - clo)) -
                   lo;
    const int pd = (ry == nr - 1
                        ? t.buf[3] + shd
                        : t.buf[1] + shc + row + half + (c0 - clo)) -
                   lo;
    const uint32_t* wx = sw + (px >> 2);
    const uint32_t* wc = sw + (pc >> 2);
    const uint32_t* wu = sw + (pu >> 2);
    const uint32_t* wd = sw + (pd >> 2);
    const int sx = 8 * (px & 3), sc = 8 * (pc & 3), su = 8 * (pu & 3);
    const int sd = 8 * (pd & 3);
    const int8_t* orow = ob + static_cast<size_t>(y) * half;
    for (int j = tx; 4 * j - lo < ncw; j += ux) {
      const int col = c0 + 4 * j - lo;  // the word's first column
      // its bytes k0 .. nv - 1 are the shard's (k0 > 0 only at an early
      // first word)
      const int k0 = HALO && col < c0 ? c0 - col : 0;
      const int nv = min(4, c0 + ncw - col);
      const uint32_t xv = win(wx + j, sx);
      uint32_t lower = __funnelshift_r(wc[j], wc[j + 1], sc);
      uint32_t upper = __funnelshift_rc(wc[j], wc[j + 1], sc + 8);
      // the row's ends: column 0's left neighbour is half - 1 (or the
      // left halo), half - 1's right neighbour is 0 (or the right halo)
      if (d > 0) {
        if (col + 3 >= half - 1) {
          const int8_t* v = orow;
          if constexpr (HALO)
            if (p.rt != nullptr)
              v = p.rt + static_cast<size_t>(r) * ny + y;
          upper = put_byte(upper, half - 1 - col,
                           static_cast<uint8_t>(__ldcg(v)));
        }
      } else if (HALO ? col <= 0 : col == 0) {
        const int8_t* v = orow + half - 1;
        if constexpr (HALO)
          if (p.lf != nullptr) v = p.lf + static_cast<size_t>(r) * ny + y;
        lower = put_byte(lower, HALO ? -col : 0,
                         static_cast<uint8_t>(__ldcg(v)));
      }
      const uint32_t k2 = ((xv ^ lower) & SIGN) + ((xv ^ upper) & SIGN) +
                          ((xv ^ win(wu + j, su)) & SIGN) +
                          ((xv ^ win(wd + j, sd)) & SIGN);
      uint4 w;
      if constexpr (INJECT) {
        const uint32_t* bw = p.bits + base + static_cast<size_t>(y) * half;
        uint32_t ws[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ws[k] = k >= k0 && k < nv ? __ldg(bw + (col + k)) : 0u;
        w = make_uint4(ws[0], ws[1], ws[2], ws[3]);
      } else {
        w = philox_rk(make_uint4(static_cast<uint32_t>(rep0 + r),
                                 static_cast<uint32_t>(row0 + y),
                                 static_cast<uint32_t>((col0 + col) >> 2),
                                 0u),
                      rk);
      }
      const uint32_t f =
          ((k2 + 2u * below2(w, p.t4, p.t8) + 0x0C0C0C0Cu) >> 4) &
          0x01010101u;
      const uint32_t nxv = xv ^ (f * 0xFEu);
      uint8_t* at = sm + px + 4 * j;
      if constexpr (DIRECT) {
        int8_t* g = x + base + static_cast<size_t>(y) * half;
        if (k0 == 0 && nv == 4 &&
            (reinterpret_cast<uintptr_t>(g + col) & 3) == 0) {
          *reinterpret_cast<uint32_t*>(g + col) = nxv;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k >= k0 && k < nv)
              g[col + k] = static_cast<int8_t>(nxv >> (8 * k));
        }
      } else if (k0 == 0 && nv == 4 && (px & 3) == 0) {
        *reinterpret_cast<uint32_t*>(at) = nxv;
      } else if (k0 == 0 && nv == 4 && (px & 1) == 0) {
        reinterpret_cast<uint16_t*>(at)[0] = static_cast<uint16_t>(nxv);
        reinterpret_cast<uint16_t*>(at)[1] =
            static_cast<uint16_t>(nxv >> 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k >= k0 && k < nv) at[k] = static_cast<uint8_t>(nxv >> (8 * k));
      }
      if (MEASURE) {
        // m += new + o, e -= new * nsum = -(4 - 2K'), K' the neighbours
        // differing from the new spin; over the word's bytes k0 .. nv - 1
        const uint32_t vm = (nv == 4 ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u) &
                            (0xFFFFFFFFu << (8 * k0));
        const int n = nv - k0;
        const uint32_t centre = d > 0 ? lower : upper;
        m += 2 * n -
             2 * (__popc(nxv & SIGN & vm) + __popc(centre & SIGN & vm));
        const uint32_t kp2 = k2 ^ ((k2 ^ (0x08080808u - k2)) & (f * 0xFFu));
        e += static_cast<int>(((kp2 & vm) * 0x01010101u) >> 24) - 4 * n;
      }
    }
  }
  if constexpr (!DIRECT) {
    __syncthreads();
    tiles8::write_back(xs, sm + t.buf[0], shx, lx);
  }
  if (MEASURE)
    block_add(m, e, dst());
  else
    __syncthreads();
}

}  // namespace ising8
