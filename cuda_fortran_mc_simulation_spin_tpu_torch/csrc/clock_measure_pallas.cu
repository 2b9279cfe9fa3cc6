// The int8 clock observables of a state in one pass on Hopper (sm_90a).
//
//   measure_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                  clock_measure_pallas.py:_kernel (pallas_call at :85,
//                  _measure -> measure): per replica (Σ cos θ, Σ sin θ, E)
//                  of (R, ny, half) int8 states, E = -Σ cos(θ - θ_right) +
//                  cos(θ - θ_down), each bond once.
//
// Layout (core/lattice.py): colour a holds the sites x = 2i + (y & 1) of
// row y, colour b the others.  Site i of a's row has its right neighbour
// in b at column i + (y & 1) (wrapped), site i of b in a at column
// i + 1 - (y & 1); the down neighbours are the other colour's site i of
// row y + 1 (wrapped).
//
// Tiles (the constants from ops/clock_measure_pallas.measure_tiles, the
// entry point takes them as passed).  A tile is `rows` whole rows of a
// replica, or past 4096 columns one row's chunk of cw columns; a block
// takes the tiles blockIdx.x, + nblk, ... of each replica in turn.  It
// stages, by cp.async from the 16-B aligned vectors that cover them
// (csrc/byte_tiles.cuh), both colours' tile rows and their row after the
// tile (wrapped), into two tile slots in turns: it starts the next
// tile's copies before it sums the one staged before.  Thread t takes a
// segment of rpt consecutive rows, (t >> lux) rpt .., and the groups of
// four columns (t mod 2^lux), + 2^lux, ... of each (a group's four sites
// of a colour: one funnel shift of two aligned shared words).  It walks
// down its segment: the (cos, sin) of a row's eight sites, gathered once from
// a double2 table in shared memory, are the own values of this step and
// the down values of the step before (two quads in turns, nothing
// copied); a row's right neighbours are the same row's values of the
// other colour, one column on where the row's parity says so, and the
// one column past the group (its byte beside the group's words, or the
// row's wrap) is the step's one more gather.  So a site's (cos, sin) are
// gathered (rpt + 1) / rpt + 1/8 times, against the first design's six
// per site (its own, its right and down neighbours', each twice: cos and
// sin), which alone cost ~24 M shared wavefronts at 2000^2 x 16.
// A masked site (past a row's ragged end) reads state 127, whose table
// entry is (0, 0) for every q <= 127.
//
// Sums: each site's float64 terms are the first design's, c (c_r + c_d)
// + s (s_r + s_d) and its c and s, added per thread, then per block and
// replica in a fixed order (xy::block_sums) into partials (R, nblk, 3).
// The last block to finish (a ticket in device memory after
// __threadfence) adds each replica's partials in block order, a warp a
// replica, negates the bond sum into E, writes obs and resets the ticket
// for the next launch: one launch a call, no float atomics, the same bits
// every run.  The JAX kernel sums float32 across row blocks.
//
// Bound on the H100: bytes.  It reads both colours once, 1 B a site,
// against ~15 instructions a site (chip_smoke.py's OPS_CLOCK8_MEASURE; ~7
// of them float64); it stages 1 + 1 / rows of them.
#include <algorithm>
#include <cstring>

#include "byte_tiles.cuh"
#include "clock_int8.cuh"

namespace {

using clock8::TABLE;
using clock8::THREADS;
using tiles8::span_bytes;
using tiles8::stage;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");
constexpr int WARPS = THREADS / 32;

// The launch constants of ops/clock_measure_pallas.measure_tiles, in its
// order: the cover of tiles8::RowTiles (rows, lux, cw, nch, nty, checked
// by tiles8::row_cover_ok), then the walk's and the grid's.
struct Tiles {
  int rows;    // rows of a tile: (THREADS >> lux) rpt (1 in a chunk)
  int lux;     // log2 of the threads along a row: ux = 1 << lux
  int cw;      // columns of a tile: half, or a chunk's (a multiple of 4)
  int nch;     // chunks a row (1 with whole rows)
  int nty;     // row tiles a replica
  int rpt;     // rows a thread walks down (1 in a chunk)
  int nblk;    // blocks of the grid, at most nty * nch
  int buf[8];  // byte offsets in shared memory of each of the two slots'
               // a and b tile rows and a and b rows after the tile; each
               // 16-B aligned with 16 bytes before it and 32 after its
               // vectors
  int smem;    // bytes of dynamic shared memory
};
constexpr int TILE_INTS = 16;
static_assert(sizeof(Tiles) == TILE_INTS * 4, "ops/clock_measure_pallas.py "
              "passes the tiles as 16 ints");

// A block's tile: replica r, its tile f of the replica's nty * nch, as
// (row tile yt, chunk cx)
struct Step {
  int r, f, yt, cx;
};

// A tile's first column and columns, first row and rows, and the offsets
// in a colour plane of its first byte and of its row after the tile's
struct TileGeom {
  int c0, ncw, y0, nr;
  size_t at, dn;
};

__device__ __forceinline__ TileGeom tile_geom(const Step& st, const Tiles& t,
                                              int ny, int half) {
  TileGeom g;
  g.c0 = st.cx * t.cw;
  g.ncw = min(t.cw, half - g.c0);
  g.y0 = st.yt * t.rows;
  g.nr = min(t.rows, ny - g.y0);
  const int yd = g.y0 + g.nr == ny ? 0 : g.y0 + g.nr;
  const size_t rep = static_cast<size_t>(st.r) * ny * half;
  g.at = rep + static_cast<size_t>(g.y0) * half + g.c0;
  g.dn = rep + static_cast<size_t>(yd) * half + g.c0;
  return g;
}

// Starts the copies of a tile's four ranges into slot k and commits them
__device__ __forceinline__ void stage_tile(uint8_t* sm, const Tiles& t,
                                           int k, const int8_t* a,
                                           const int8_t* b,
                                           const TileGeom& g, int half) {
  const int lx = (g.nr - 1) * half + g.ncw;
  stage(sm + t.buf[4 * k], a + g.at, lx);
  stage(sm + t.buf[4 * k + 1], b + g.at, lx);
  stage(sm + t.buf[4 * k + 2], a + g.dn, g.ncw);
  stage(sm + t.buf[4 * k + 3], b + g.dn, g.ncw);
  asm volatile("cp.async.commit_group;\n" ::);
}

// A byte's offset in its 16-B vector: where stage puts it in its buffer
__device__ __forceinline__ int mod16(const int8_t* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// A row's gathered (cos, sin) of a group's four sites of each colour, and
// each colour's byte of the column after the group
struct Quad {
  double2 a[4], b[4];
  uint32_t xa, xb;
};

// The group's four sites of the row staged at byte p of shared memory
// (masked sites as state 127), and in `next` the byte after them
__device__ __forceinline__ uint32_t group_word(const uint32_t* sw, int p,
                                               int j, uint32_t keep,
                                               uint32_t pad,
                                               uint32_t& next) {
  const int i = (p >> 2) + j;
  const int s8 = 8 * (p & 3);
  const uint32_t w0 = sw[i], w1 = sw[i + 1];
  next = (w1 >> s8) & 0x7Fu;
  return (__funnelshift_r(w0, w1, s8) & keep) | pad;
}

__device__ __forceinline__ void gather(const double2* tab, uint32_t w,
                                       double2 (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = tab[(w >> (8 * k)) & 0xFFu];
}

__device__ __forceinline__ void row_quad(const double2* tab,
                                         const uint32_t* sw, int pa, int pb,
                                         int j, uint32_t keep, uint32_t pad,
                                         Quad& out) {
  gather(tab, group_word(sw, pa, j, keep, pad, out.xa), out.a);
  gather(tab, group_word(sw, pb, j, keep, pad, out.xb), out.b);
}

// The terms of a group's sites of one row: cur the row, nxt the row below,
// x4 the (cos, sin) of the right-neighbour colour's column after the
// group's nv sites (FULL: nv = 4).  ODD: a's right neighbours are b's
// sites one column on, b's are a's of the same column; else the reverse.
template <bool ODD, bool FULL>
__device__ __forceinline__ void bonds(const Quad& cur, const Quad& nxt,
                                      double2 x4, int nv, xy::Sums& t) {
  const double2(&sh)[4] = ODD ? cur.b : cur.a;
  double mx = 0.0, my = 0.0, e = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // the shifted colour's column k + 1: the wrap follows site nv - 1
    double2 ext = x4;
    if (k < 3 && (FULL || k + 1 < nv)) ext = sh[k < 3 ? k + 1 : 3];
    const double2 ga = cur.a[k], gb = cur.b[k];
    const double2 ra = ODD ? ext : cur.b[k];
    const double2 rb = ODD ? cur.a[k] : ext;
    const double2 da = nxt.b[k], db = nxt.a[k];
    mx += ga.x + gb.x;
    my += ga.y + gb.y;
    e += (ga.x * (ra.x + da.x) + ga.y * (ra.y + da.y)) +
         (gb.x * (rb.x + db.x) + gb.y * (rb.y + db.y));
  }
  t.mx += mx;
  t.my += my;
  t.e += e;
}

// Where a walk finds its rows in shared memory: the first bytes of a's
// and b's tile rows and of their rows after the tile; the tile's rows,
// first row and columns; in a chunk the columns after it, a row of each
// colour in device memory (wa, wb at row 0 of the replica, cnext on)
struct Rows {
  int pa0, pb0, pa_dn, pb_dn, nr, y0, half, ncw;
  bool chunk;
  const int8_t* wa;
  const int8_t* wb;
};

// Row ry's terms of group j from its quad cur, gathering the row below
// into nxt
template <bool FULL>
__device__ __forceinline__ void row_step(const double2* tab,
                                         const uint32_t* sw,
                                         const uint8_t* sm, const Rows& w,
                                         int ry, int j, uint32_t keep,
                                         uint32_t pad, int nv, bool last,
                                         const Quad& cur, Quad& nxt,
                                         xy::Sums& s) {
  const bool below = ry + 1 < w.nr;  // else the row after the tile
  row_quad(tab, sw, below ? w.pa0 + (ry + 1) * w.half : w.pa_dn,
           below ? w.pb0 + (ry + 1) * w.half : w.pb_dn, j, keep, pad, nxt);
  const int y = w.y0 + ry;
  const bool odd = (y & 1) != 0;
  uint32_t x = odd ? cur.xb : cur.xa;
  if (last) {
    if (!w.chunk)
      x = sm[(odd ? w.pb0 : w.pa0) + ry * w.half] & 0x7Fu;
    else
      x = static_cast<uint32_t>(__ldg((odd ? w.wb : w.wa) +
                                      static_cast<size_t>(y) * w.half)) &
          0x7Fu;
  }
  if (odd)
    bonds<true, FULL>(cur, nxt, tab[x], nv, s);
  else
    bonds<false, FULL>(cur, nxt, tab[x], nv, s);
}

// A thread's walk down rows s0 .. s1 - 1 of group j, nv sites a colour
// (FULL: 4): two quads in turns, each row's values gathered once
template <bool FULL>
__device__ __forceinline__ void walk(const double2* tab, const uint32_t* sw,
                                     const uint8_t* sm, const Rows& w,
                                     int s0, int s1, int j, int nv,
                                     xy::Sums& s) {
  const uint32_t vm = FULL ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u;
  const uint32_t keep = vm & 0x7F7F7F7Fu, pad = ~vm & 0x7F7F7F7Fu;
  const bool last = 4 * j + 4 >= w.ncw;
  Quad q0, q1;
  row_quad(tab, sw, w.pa0 + s0 * w.half, w.pb0 + s0 * w.half, j, keep, pad,
           q0);
  for (int ry = s0; ry < s1; ry += 2) {
    row_step<FULL>(tab, sw, sm, w, ry, j, keep, pad, nv, last, q0, q1, s);
    if (ry + 1 < s1)
      row_step<FULL>(tab, sw, sm, w, ry + 1, j, keep, pad, nv, last, q1, q0,
                     s);
  }
}

// (Σ cos, Σ sin, E) of every replica into obs (R, 3): a grid of t.nblk
// blocks of THREADS, two an SM, t.smem bytes of dynamic shared memory;
// partials (R, nblk, 3) float64 scratch, ticket a zero uint32 that the
// last block leaves zero.  A block walks its tiles of replica 0, then of
// replica 1, ...; the next tile's copies run while it sums the one
// before.
__global__ void __launch_bounds__(THREADS, 2)
    measure_kernel(const int8_t* a, const int8_t* b, const double* tab64,
                   double* partials, unsigned* ticket, double* obs, int nrep,
                   int ny, int half, Tiles t) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ double2 tab[TABLE];
  __shared__ bool last_block;
  for (int k = threadIdx.x; k < TABLE; k += THREADS)
    tab[k] = make_double2(tab64[k], tab64[TABLE + k]);
  const int ux = 1 << t.lux;
  const int tx = threadIdx.x & (ux - 1), ty = threadIdx.x >> t.lux;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  const int tiles = t.nty * t.nch;
  // the block's first tile and the step to its next, as (row tile,
  // chunk): the walk adds them with a carry
  const int ys = t.nblk / t.nch, cs = t.nblk - ys * t.nch;
  const int yfirst = blockIdx.x / t.nch;
  const int cfirst = blockIdx.x - yfirst * t.nch;
  Step cur = {0, static_cast<int>(blockIdx.x), yfirst, cfirst};
  xy::Sums s = {0.0, 0.0, 0.0, 0.0};
  stage_tile(sm, t, 0, a, b, tile_geom(cur, t, ny, half), half);
  for (int i = 0; cur.r < nrep; ++i) {
    const int k = i & 1;
    Step nxt = cur;
    nxt.f += t.nblk;
    if (nxt.f >= tiles) {
      nxt = {cur.r + 1, static_cast<int>(blockIdx.x), yfirst, cfirst};
    } else {
      nxt.cx += cs;
      if (nxt.cx >= t.nch) {
        nxt.cx -= t.nch;
        ++nxt.yt;
      }
      nxt.yt += ys;
    }
    const TileGeom g = tile_geom(cur, t, ny, half);
    if (nxt.r < nrep) {
      stage_tile(sm, t, k ^ 1, a, b, tile_geom(nxt, t, ny, half), half);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const size_t rep = static_cast<size_t>(cur.r) * ny * half;
    // the column after the tile's last: the wrap, or the next chunk's
    const int cnext = g.c0 + g.ncw == half ? 0 : g.c0 + g.ncw;
    const Rows w = {t.buf[4 * k] + mod16(a + g.at),
                    t.buf[4 * k + 1] + mod16(b + g.at),
                    t.buf[4 * k + 2] + mod16(a + g.dn),
                    t.buf[4 * k + 3] + mod16(b + g.dn),
                    g.nr, g.y0, half, g.ncw, t.nch > 1,
                    a + rep + cnext, b + rep + cnext};
    const int s0 = ty * t.rpt;
    const int s1 = min(s0 + t.rpt, g.nr);
    for (int j = tx; s0 < g.nr && 4 * j < g.ncw; j += ux) {
      const int nv = min(4, g.ncw - 4 * j);
      if (nv == 4)
        walk<true>(tab, sw, sm, w, s0, s1, j, 4, s);
      else  // a row's ragged last group
        walk<false>(tab, sw, sm, w, s0, s1, j, nv, s);
    }
    __syncthreads();  // this slot restages two tiles on
    if (nxt.r != cur.r) {
      xy::block_sums<3, true>(partials, cur.r, t.nblk, blockIdx.x, s);
      s = {0.0, 0.0, 0.0, 0.0};
    }
    cur = nxt;
  }
  // the last block to finish adds every replica's partials in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(ticket, 1u) == static_cast<unsigned>(t.nblk - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrep; r += WARPS) {
    const double* part = partials + static_cast<size_t>(r) * t.nblk * 3;
    double v[3] = {0.0, 0.0, 0.0};
    for (int k = lane; k < t.nblk; k += 32) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] += __ldcg(part + 3 * k + c);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] += __shfl_down_sync(0xFFFFFFFFu, v[c], off);
    }
    if (lane == 0) {
      obs[3 * static_cast<size_t>(r)] = v[0];
      obs[3 * static_cast<size_t>(r) + 1] = v[1];
      obs[3 * static_cast<size_t>(r) + 2] = -v[2];
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// The constants as measure_tiles builds them; refuses others
bool tiles_ok(const Tiles& t, int ny, int half) {
  if (t.lux < 0 || t.lux > 8 || t.rpt < 1 ||
      t.rows != (t.nch > 1 ? 1 : (THREADS >> t.lux) * t.rpt) ||
      (t.nch > 1 && (t.lux != 8 || t.rpt != 1)) ||
      !tiles8::row_cover_ok(t.rows, t.cw, t.nch, t.nty, ny, half) ||
      t.nblk < 1 || t.nblk > t.nty * t.nch)
    return false;
  // each slot's a and b tile rows, then their rows after the tile
  const long long lx = static_cast<long long>(std::min(t.rows, ny) - 1) *
                           half + std::min(t.cw, half);
  const int row = span_bytes(std::min(t.cw, half));
  const int need[8] = {span_bytes(lx), span_bytes(lx), row, row,
                       span_bytes(lx), span_bytes(lx), row, row};
  return tiles8::spans_ok(t.buf, need, 8, t.smem);
}

}  // namespace

extern "C" {

// (Σ cos, Σ sin, E) of each replica of the colour planes a, b into obs
// (R, 3) float64; tab the (2, 128) float64 table; partials (R, nblk, 3)
// float64 scratch and ticket a zero uint32, both kept by the caller
// between launches on one stream (the kernel leaves the ticket zero);
// tiles the 16 ints of ops/clock_measure_pallas.measure_tiles (Tiles).
int clock_int8_measure(const void* a, const void* b, const void* tab,
                       void* partials, void* ticket, void* obs, int nrep,
                       int ny, int half, int q, const int* tiles,
                       void* stream) {
  Tiles t;
  std::memcpy(&t, tiles, sizeof(Tiles));
  const clock8::Geometry g = clock8::geometry(ny, half);
  if (!clock8::launchable(g, nrep, q) || !tiles_ok(t, ny, half))
    return static_cast<int>(cudaErrorInvalidValue);
  measure_kernel<<<t.nblk, THREADS, t.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const double*>(tab), static_cast<double*>(partials),
      static_cast<unsigned*>(ticket), static_cast<double*>(obs), nrep, ny,
      half, t);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_measure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
