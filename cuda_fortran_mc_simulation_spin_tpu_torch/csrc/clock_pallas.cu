// The int8 q-state clock checkerboard Metropolis phase on Hopper (sm_90a).
//
//   phase_kernel<false, .> replaces cuda_fortran_mc_simulation_spin_tpu/
//                ops/clock_pallas.py:_phase_kernel (pallas_call at :106,
//                _metropolis_phase).  One colour phase of (R, ny, half)
//                int8 states, in place; its uniforms from Philox, or
//                injected (R, ny, half) float32 (u_cand, u_acc) planes
//                (the mode the checks use, as JAX's sharded_phase takes
//                u_cand=, u_acc=).
//   phase_kernel<true, .> replaces clock_pallas.py:_halo_phase_kernel
//                (pallas_call at :294, sharded_phase).  The same phase on a
//                shard of a (y[, x]) mesh (parallel/domain.py): rows, and
//                with an x split columns, past the shard's edges come from
//                the exchanged halos; parity and the Philox counter from
//                global coordinates, so a shard draws what the whole
//                lattice draws and a sharded run equals the unsharded one
//                bit for bit.  MEASURE adds the shard's float64 (Σ cos,
//                Σ sin, e) partials of a measuring phase b, per tile in a
//                fixed order and then per replica by xy::reduce_kernel.
//
// The site rule, the tables and the word layout are csrc/clock_int8.cuh's
// (update_word, shared with the cooperative multisweep,
// csrc/clock_multisweep.cu).  Every even nx and ny runs (JAX's nx/2 % 128
// and ny % 32 tiling gates are TPU artefacts).  In place: a phase reads
// only the other colour and its own site, so the updated colour is
// written where it is read, as the TPU kernel aliases it.
//
// Tiles (csrc/byte_tiles.cuh RowTiles; ops/clock_pallas.phase_tiles
// computes the constants, the two int8 multisweeps' ms_tiles at half their
// tile size; the entry points take them as passed).  A block takes one
// tile (at most 8 KB of sites; four blocks an SM under the launch bound,
// 64 registers): `rows` whole rows
// y0 .. of one replica, or past its CHUNK_COLS columns one row's chunk of
// cw columns; a grid (chunks, row tiles, replicas), the row tiles past the
// grid's y extent walked gridDim.y apart: no division.  The four byte
// ranges of a tile are contiguous: its own sites, the other colour's rows
// y0 .. (a chunk widened by a column each side) and the other colour's
// rows y0 - 1 and y0 + rows (wrapped, or the halo rows at a shard's
// edge).  The block stages them in shared memory (cp.async from the
// aligned 16-B vectors that cover them, any base address), then thread t
// takes rows t >> lux, + 256 >> lux, ... of the tile and words (t mod
// 2^lux), + 2^lux, ... of each: four sites, two units, two Philox calls
// under round keys taken once a launch on the host.  Each neighbour window
// of a word is one funnel shift of two aligned shared-memory words, the
// same shift for every word of a row; the centre and side neighbours are
// the windows of one word pair one byte apart (which is which follows the
// row's parity), the row's wrap (or the column halo) patched into the side
// window's end byte.  A shard at an odd col0 cuts a unit: its words start
// a column early (a word is still two global units; the byte before the
// shard's first column, in its neighbour's shard, is read and not
// stored).  A site's state indexes the staged tables: (cos, sin) as float2
// for the update, as double2 for the sums.  New bytes go to the tile's own
// copy, and the block writes its range back in aligned vectors, bytes at
// the ragged ends; every site lies in one tile, so a phase stores each
// site once and no byte outside the tiles.
//
// Bound on the H100: operations.  A site of the colour updated moves 3 B
// (its own byte read and written, the other colour's read once) against
// about 70 instructions (half its unit's Philox4x32-10 call, the field,
// ΔE and expf; chip_smoke.py's clock8_phase_ops).  The first design, one
// thread a unit over device memory with 64-bit division, five byte loads
// a site and the round keys recomputed in every Philox call, ran at 30%
// of it (PERF.md §6).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "byte_tiles.cuh"
#include "clock_int8.cuh"
#include "philox.cuh"

namespace {

using clock8::TABLE;
using clock8::THREADS;
using tiles8::put_byte;
using tiles8::stage;
using tiles8::win;
using tiles8::write_back;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

using Tiles = tiles8::RowTiles;

constexpr int MAX_GRID = 65535;

struct Args {
  int8_t* x;            // colour being updated, in place
  const int8_t* o;      // the other colour
  const float* ucand;   // INJECT: uniforms (R, ny, half)
  const float* uacc;
  const float* tab;     // (2, 128) float32 (cos, sin)
  const double* tab64;  // MEASURE: (2, 128) float64 (cos, sin)
  double* partials;     // MEASURE: (R, nty nch, 3)
  const int8_t* up;     // HALO: (R, 1, half), the row above row 0
  const int8_t* dn;     // HALO: (R, 1, half), the row below the last
  const int8_t* lf;     // HALO: (R, ny, 1), the column left of column 0,
  const int8_t* rt;     // and right of the last; null: periodic in x
  uint2 rk[10];         // Philox round keys of the phase key
  float neg_beta;
  int q, color, ny, half;
  int rep0, row0, col0;  // HALO: the shard's global offsets
  Tiles t;
};

// One colour phase: a grid of (chunks, min(row tiles, 65535), replicas)
// blocks of THREADS, a.t.smem bytes of dynamic shared memory.  INJECT:
// the uniforms from a.ucand, a.uacc.
template <bool HALO, bool MEASURE, bool INJECT>
__global__ void __launch_bounds__(THREADS, 4) phase_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float2 tab[TABLE];
  __shared__ double2 tab64[MEASURE ? TABLE : 1];
  // (the barrier after the first tile's staging publishes the tables)
  for (int k = threadIdx.x; k < TABLE; k += THREADS) {
    tab[k] = make_float2(a.tab[k], a.tab[TABLE + k]);
    if constexpr (MEASURE)
      tab64[k] = make_double2(a.tab64[k], a.tab64[TABLE + k]);
  }
  const Tiles& t = a.t;
  const int half = a.half, ny = a.ny, q = a.q;
  const float qm1 = static_cast<float>(q - 1), neg_beta = a.neg_beta;
  const int ux = 1 << t.lux, tr = THREADS >> t.lux;
  const int tx = threadIdx.x & (ux - 1), ty = threadIdx.x >> t.lux;
  const int r = blockIdx.z;
  const int c0 = blockIdx.x * t.cw;
  const int ncw = min(t.cw, half - c0);
  // the centre range's columns: a chunk's widened by one each side
  const int clo = c0 > 0 ? c0 - 1 : 0;
  const int chi = min(c0 + ncw + 1, half);
  // a shard at an odd col0 starts its words a column early
  const int lo = HALO ? (a.col0 & 1) : 0;
  const int row0 = HALO ? a.row0 : 0;
  const uint32_t rep = static_cast<uint32_t>((HALO ? a.rep0 : 0) + r);
  // the global unit of a row's first word in the chunk
  const uint32_t j0 =
      static_cast<uint32_t>(((HALO ? a.col0 : 0) + c0 - lo) >> 1);
  const size_t base = static_cast<size_t>(r) * ny * half;
  const int8_t* ob = a.o + base;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  for (int yt = blockIdx.y; yt < t.nty; yt += gridDim.y) {
    const int y0 = yt * t.rows;
    const int nr = min(t.rows, ny - y0);
    const int lx = (nr - 1) * half + ncw;
    const int lc = (nr - 1) * half + (chi - clo);
    const int8_t* up =
        HALO && y0 == 0
            ? a.up + static_cast<size_t>(r) * half
            : ob + static_cast<size_t>(y0 == 0 ? ny - 1 : y0 - 1) * half;
    const int8_t* dn =
        HALO && y0 + nr == ny
            ? a.dn + static_cast<size_t>(r) * half
            : ob + static_cast<size_t>(y0 + nr == ny ? 0 : y0 + nr) * half;
    int8_t* xs = a.x + base + static_cast<size_t>(y0) * half + c0;
    const int shx = stage(sm + t.buf[0], xs, lx);
    const int shc =
        stage(sm + t.buf[1], ob + static_cast<size_t>(y0) * half + clo, lc);
    const int shu = stage(sm + t.buf[2], up + c0, ncw);
    const int shd = stage(sm + t.buf[3], dn + c0, ncw);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
    for (int ry = ty; ry < nr; ry += tr) {
      const int y = y0 + ry;
      // colour 0 on an odd row and colour 1 on an even row read column
      // i + 1, the others column i - 1
      const int d = (a.color == 0) == (((row0 + y) & 1) == 1) ? 1 : -1;
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
      const size_t orow = base + static_cast<size_t>(y) * half;
      const size_t hcol = static_cast<size_t>(r) * ny + y;
      const uint32_t yg = static_cast<uint32_t>(row0 + y);
      for (int j = tx; 4 * j - lo < ncw; j += ux) {
        const int col = c0 + 4 * j - lo;  // the word's first column
        const int k0 = col < c0 ? c0 - col : 0;
        const int nv = min(4, c0 + ncw - col);
        const uint32_t xv = win(wx + j, sx);
        const uint32_t uv = win(wu + j, su);
        const uint32_t dv = win(wd + j, sd);
        uint32_t lower = __funnelshift_r(wc[j], wc[j + 1], sc);
        uint32_t upper = __funnelshift_rc(wc[j], wc[j + 1], sc + 8);
        // the row's ends: column 0's left neighbour is half - 1 (or the
        // left halo), half - 1's right neighbour is 0 (or the right halo)
        if (d > 0) {
          if (col + 3 >= half - 1)
            upper = put_byte(
                upper, half - 1 - col,
                static_cast<uint8_t>(HALO && a.rt != nullptr
                                         ? __ldg(a.rt + hcol)
                                         : __ldg(a.o + orow)));
        } else if (col <= 0) {
          lower = put_byte(
              lower, -col,
              static_cast<uint8_t>(HALO && a.lf != nullptr
                                       ? __ldg(a.lf + hcol)
                                       : __ldg(a.o + orow + half - 1)));
        }
        uint32_t ws[8];
        if constexpr (!INJECT) {
          const uint32_t jg = j0 + 2u * static_cast<uint32_t>(j);
          const uint4 w0 = philox_rk(make_uint4(rep, yg, jg, 0u), a.rk);
          const uint4 w1 = philox_rk(make_uint4(rep, yg, jg + 1u, 0u), a.rk);
          ws[0] = w0.x;
          ws[1] = w0.y;
          ws[2] = w0.z;
          ws[3] = w0.w;
          ws[4] = w1.x;
          ws[5] = w1.y;
          ws[6] = w1.z;
          ws[7] = w1.w;
        }
        const size_t at = orow + col;  // >= orow where k >= k0
        const uint32_t nxv = clock8::update_word<MEASURE>(
            xv, uv, dv, d > 0 ? lower : upper, d > 0 ? upper : lower, k0,
            nv, q, qm1, neg_beta, tab, tab64,
            [&](int k, float& uc, float& ua) {
              if constexpr (INJECT) {
                uc = __ldg(a.ucand + at + k);
                ua = __ldg(a.uacc + at + k);
              } else {
                uc = xy::u24(ws[2 * k]);
                ua = xy::u24(ws[2 * k + 1]);
              }
            },
            sums);
        uint8_t* dst = sm + px + 4 * j;
        if (k0 == 0 && nv == 4 && (px & 3) == 0) {
          *reinterpret_cast<uint32_t*>(dst) = nxv;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k >= k0 && k < nv)
              dst[k] = static_cast<uint8_t>(nxv >> (8 * k));
        }
      }
    }
    __syncthreads();
    write_back(xs, sm + t.buf[0], shx, lx);
    if (MEASURE)
      xy::block_sums<3, true>(
          a.partials, static_cast<size_t>(r),
          static_cast<unsigned>(t.nty * t.nch),
          static_cast<unsigned>(yt * t.nch + blockIdx.x), sums);
    else
      __syncthreads();
  }
}

// The launch's arguments; false if the geometry, the tiles or the
// uniforms cannot run
bool make_args(Args& a, void* x, const void* o, const void* tab,
               const void* ucand, const void* uacc, int nrep, int ny,
               int half, int q, int color, float neg_beta, unsigned s0,
               unsigned s1, const int* tiles) {
  a = Args{};
  std::memcpy(&a.t, tiles, sizeof(Tiles));
  if (!clock8::launchable(clock8::geometry(ny, half), nrep, q) ||
      !tiles8::row_tiles_ok(a.t, ny, half) ||
      (ucand == nullptr) != (uacc == nullptr))
    return false;
  a.x = static_cast<int8_t*>(x);
  a.o = static_cast<const int8_t*>(o);
  a.ucand = static_cast<const float*>(ucand);
  a.uacc = static_cast<const float*>(uacc);
  a.tab = static_cast<const float*>(tab);
  philox_round_keys(s0, s1, a.rk);
  a.neg_beta = neg_beta;
  a.q = q;
  a.color = color;
  a.ny = ny;
  a.half = half;
  return true;
}

dim3 grid_of(const Args& a, int nrep) {
  return dim3(a.t.nch, std::min(a.t.nty, MAX_GRID), nrep);
}

template <bool HALO, bool MEASURE>
int launch(const Args& a, int nrep, cudaStream_t st) {
  const dim3 grid = grid_of(a, nrep);
  if (a.ucand != nullptr)
    phase_kernel<HALO, MEASURE, true><<<grid, THREADS, a.t.smem, st>>>(a);
  else
    phase_kernel<HALO, MEASURE, false><<<grid, THREADS, a.t.smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One colour phase of x (R, ny, half) int8 in place given o; tab is the
// (2, 128) float32 (cos, sin) table of the q states; ucand, uacc are
// (R, ny, half) float32 or both null (then Philox words under (s0, s1));
// tiles the 10 ints of ops/ising2d_multisweep.ms_tiles.
int clock_int8_phase(void* x, const void* o, const void* tab,
                     const void* ucand, const void* uacc, int nrep, int ny,
                     int half, int q, int color, float neg_beta,
                     unsigned int s0, unsigned int s1, const int* tiles,
                     void* stream) {
  Args a;
  if (!make_args(a, x, o, tab, ucand, uacc, nrep, ny, half, q, color,
                 neg_beta, s0, s1, tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, false>(a, nrep, static_cast<cudaStream_t>(stream));
}

// One colour phase of a shard x (R, ny, half) int8 in place given o and
// the halos up, dn (R, 1, half) and lf, rt (R, ny, 1) or null; (rep0,
// row0, col0) the shard's global offsets.  With partials ((R, nty nch, 3)
// float64, a tile's partial each) and obs ((R, 3) float64) the launch
// measures (Σ cos, Σ sin, e) into obs; tab64 is the (2, 128) float64
// table of the sums.
int clock_int8_halo_phase(void* x, const void* o, const void* tab,
                          const void* tab64, const void* ucand,
                          const void* uacc, const void* up, const void* dn,
                          const void* lf, const void* rt, void* partials,
                          void* obs, int nrep, int ny, int half, int q,
                          int color, int rep0, int row0, int col0,
                          float neg_beta, unsigned int s0, unsigned int s1,
                          const int* tiles, void* stream) {
  Args a;
  if (!make_args(a, x, o, tab, ucand, uacc, nrep, ny, half, q, color,
                 neg_beta, s0, s1, tiles) ||
      rep0 < 0 || row0 < 0 || col0 < 0 ||
      (partials == nullptr) != (obs == nullptr) ||
      (partials != nullptr && tab64 == nullptr) ||
      (lf == nullptr) != (rt == nullptr) || up == nullptr || dn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tab64 = static_cast<const double*>(tab64);
  a.partials = static_cast<double*>(partials);
  a.up = static_cast<const int8_t*>(up);
  a.dn = static_cast<const int8_t*>(dn);
  a.lf = static_cast<const int8_t*>(lf);
  a.rt = static_cast<const int8_t*>(rt);
  a.rep0 = rep0;
  a.row0 = row0;
  a.col0 = col0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (partials == nullptr) return launch<true, false>(a, nrep, st);
  const int code = launch<true, true>(a, nrep, st);
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, st>>>(
      a.partials, static_cast<double*>(obs), a.t.nty * a.t.nch);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
