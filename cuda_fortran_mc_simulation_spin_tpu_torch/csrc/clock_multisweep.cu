// S int8 q-state clock sweeps in one cooperative launch on Hopper (sm_90a).
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     clock_multisweep.py:_kernel (pallas_call at :127,
//                     _multisweep -> multisweep): S full sweeps (phase a,
//                     then phase b) of (R, ny, half) int8 states, in place,
//                     with each sweep's (Σ cos, Σ sin, E) fused into phase b
//                     as JAX's :87-95 fuses them (each a-b bond once, from
//                     the b site's field), into (R, S, 3) float64.
//
// The TPU kernel keeps one replica in VMEM a grid step.  Here the planes
// stay in device memory (a 1000x1000 ensemble of 16 replicas is 16 MB, in
// the 50 MB L2): a cooperative grid walks every tile of a phase and waits
// at a grid barrier before the next phase reads what it wrote.  Sweep s,
// phase p draws under the key seeds[s][p] (ops/multispin_rng.
// sweep_phase_keys), its round keys taken once a phase, and the counter
// of phase_kernel (csrc/clock_pallas.cu): unit j of row y, sites 2j and
// 2j + 1, one Philox4x32-10 call at (replica, y, j, 0), site 2j + k taking
// outputs 2k and 2k + 1.  The site rule is csrc/clock_int8.cuh's
// update_word, phase_kernel's: the same float32 operations in the same
// order on the same table values, so S sweeps here equal S pairs of
// phase_kernel launches, bitwise in the state.
//
// Tiles (csrc/byte_tiles.cuh RowTiles; ops/ising2d_multisweep.ms_tiles
// computes the constants, shared with the int8 Ising multisweep; the entry
// point takes them as passed).  A tile is `rows` whole rows y0 .. of one
// replica (past its CHUNK_COLS columns one row's chunk of cw columns).  Its
// four byte ranges are contiguous: its own sites, the other colour's rows
// y0 .. (a chunk widened by a column each side), and the other colour's
// rows y0 - 1 and y0 + rows, wrapped in y.  The block stages them in
// shared memory (csrc/byte_tiles.cuh: cp.async from the aligned 16-B
// vectors that cover them, any base address), then thread t takes rows
// t >> lux, + 256 >> lux, ... of the tile and words (t mod 2^lux), +
// 2^lux, ... of each: four sites, two units.  Each neighbour window of a
// word is one funnel shift of two aligned shared-memory words, the same
// shift for every word of a row; the centre and side neighbours are the
// windows of one word pair one byte apart (which is which follows the
// row's parity), the row's wrap patched into the side window's end byte.
// A site's state indexes the staged tables: (cos, sin) as float2 for the
// update, as double2 for the sums.  New bytes go to the tile's own copy,
// and the block writes its range back in aligned vectors, bytes at the
// ragged ends; every site lies in one tile, so a phase stores each site
// once and no byte outside the tiles.  Blocks walk the tiles replica
// major, gridDim.x apart, by carries: no division in the walk.
//
// The fused sums are float64 terms from the float64 table, added per
// thread in its order, per tile by xy::block_sums, then over a (replica,
// sweep)'s tiles in tile order by xy::reduce_kernel: no float atomics, the
// same order every run.  They equal measure_kernel's right-and-down sums to
// float64 rounding.
//
// Bound on the H100: operations.  A launch reads and writes the planes
// once (4 B a site) but runs 2 S phases of ~60 instructions a site and S
// fused sums (chip_smoke.py's count); it saves the host 3 S launches.  The
// first design, one thread a unit with a 64-bit division, five byte loads
// from L2 and the round keys recomputed in every Philox call, ran at 21%
// of it (PERF.md §6).
#include <cooperative_groups.h>

#include <cstring>

#include "byte_tiles.cuh"
#include "clock_int8.cuh"

namespace cg = cooperative_groups;

namespace {

using clock8::TABLE;
using clock8::THREADS;
using tiles8::put_byte;
using tiles8::stage;
using tiles8::win;
using tiles8::write_back;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

using Tiles = tiles8::RowTiles;

struct Multisweep {
  int8_t* a;             // (R, ny, half), updated in place
  int8_t* b;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  const float* tab;      // (2, 128) float32 (cos, sin)
  const double* tab64;   // (2, 128) float64 (cos, sin)
  double* partials;      // (R, S, nty nch, 3)
  int nrep, ny, half, q, sweeps;
  float neg_beta;
  int step[3];  // the walk's steps (tiles8::row_tile_steps)
  Tiles t;
};

// One tile (replica r, row tile yt, chunk cx) of a colour phase: x the
// colour updated in place, o the other.  MEASURE (phase b) adds the fused
// sums into the tile's partial.  Every thread of the block calls it; it
// ends with a barrier, after which the block may stage the next tile.
template <bool MEASURE>
__device__ __forceinline__ void tile(const Multisweep& ms, uint8_t* sm,
                                     const float2* tab, const double2* tab64,
                                     const uint2 (&rk)[10], int8_t* x,
                                     const int8_t* o, int color, int r,
                                     int yt, int cx, int s) {
  const Tiles& t = ms.t;
  const int half = ms.half, ny = ms.ny;
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
  const int yu = y0 == 0 ? ny - 1 : y0 - 1;
  const int yd = y0 + nr == ny ? 0 : y0 + nr;
  const size_t base = static_cast<size_t>(r) * ny * half;
  int8_t* xs = x + base + static_cast<size_t>(y0) * half + c0;
  const int8_t* ob = o + base;
  const int shx = stage(sm + t.buf[0], xs, lx);
  const int shc =
      stage(sm + t.buf[1], ob + static_cast<size_t>(y0) * half + clo, lc);
  const int shu =
      stage(sm + t.buf[2], ob + static_cast<size_t>(yu) * half + c0, ncw);
  const int shd =
      stage(sm + t.buf[3], ob + static_cast<size_t>(yd) * half + c0, ncw);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  const int q = ms.q;
  const float qm1 = static_cast<float>(q - 1);
  const float neg_beta = ms.neg_beta;
  xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
  for (int ry = ty; ry < nr; ry += tr) {
    const int y = y0 + ry;
    // colour 0 on an odd row and colour 1 on an even row read column
    // i + 1, the others column i - 1
    const int d = (color == 0) == ((y & 1) == 1) ? 1 : -1;
    // byte positions in shared memory of the row's first word's windows:
    // own, centre (its lower window), up, down
    const int row = ry * half;
    const int px = t.buf[0] + shx + row;
    const int pc = t.buf[1] + shc + row + (c0 - clo) - (d < 0 ? 1 : 0);
    const int pu = ry == 0 ? t.buf[2] + shu
                           : t.buf[1] + shc + row - half + (c0 - clo);
    const int pd = ry == nr - 1 ? t.buf[3] + shd
                                : t.buf[1] + shc + row + half + (c0 - clo);
    const uint32_t* wx = sw + (px >> 2);
    const uint32_t* wc = sw + (pc >> 2);
    const uint32_t* wu = sw + (pu >> 2);
    const uint32_t* wd = sw + (pd >> 2);
    const int sx = 8 * (px & 3), sc = 8 * (pc & 3), su = 8 * (pu & 3);
    const int sd = 8 * (pd & 3);
    const int8_t* orow = ob + static_cast<size_t>(y) * half;
    for (int j = tx; 4 * j < ncw; j += ux) {
      const int col = c0 + 4 * j;
      const int nv = min(4, c0 + ncw - col);
      const uint32_t xv = win(wx + j, sx);
      const uint32_t uv = win(wu + j, su);
      const uint32_t dv = win(wd + j, sd);
      uint32_t lower = __funnelshift_r(wc[j], wc[j + 1], sc);
      uint32_t upper = __funnelshift_rc(wc[j], wc[j + 1], sc + 8);
      // the row's wrap: column 0's left neighbour is half - 1, and
      // half - 1's right neighbour is 0
      if (d > 0) {
        if (col + 3 >= half - 1)
          upper = put_byte(upper, half - 1 - col,
                           static_cast<uint8_t>(__ldcg(orow)));
      } else if (col == 0) {
        lower = put_byte(lower, 0,
                         static_cast<uint8_t>(__ldcg(orow + half - 1)));
      }
      const uint32_t jg = static_cast<uint32_t>(col >> 1);
      const uint4 w0 = philox_rk(make_uint4(static_cast<uint32_t>(r),
                                            static_cast<uint32_t>(y), jg, 0u),
                                 rk);
      const uint4 w1 = philox_rk(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                     jg + 1u, 0u),
          rk);
      const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w,
                              w1.x, w1.y, w1.z, w1.w};
      const uint32_t nxv = clock8::update_word<MEASURE>(
          xv, uv, dv, d > 0 ? lower : upper, d > 0 ? upper : lower, 0, nv,
          q, qm1, neg_beta, tab, tab64,
          [&](int k, float& uc, float& ua) {
            uc = xy::u24(ws[2 * k]);
            ua = xy::u24(ws[2 * k + 1]);
          },
          sums);
      uint8_t* dst = sm + px + 4 * j;
      if (nv == 4 && (px & 3) == 0) {
        *reinterpret_cast<uint32_t*>(dst) = nxv;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nv) dst[k] = static_cast<uint8_t>(nxv >> (8 * k));
      }
    }
  }
  __syncthreads();
  write_back(xs, sm + t.buf[0], shx, lx);
  if (MEASURE)
    xy::block_sums<3, true>(
        ms.partials, static_cast<size_t>(r) * ms.sweeps + s,
        static_cast<unsigned>(t.nty * t.nch),
        static_cast<unsigned>(yt * t.nch + cx), sums);
  else
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) multisweep_kernel(Multisweep ms) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float2 tab[TABLE];
  __shared__ double2 tab64[TABLE];
  for (int k = threadIdx.x; k < TABLE; k += THREADS) {
    tab[k] = make_float2(ms.tab[k], ms.tab[TABLE + k]);
    tab64[k] = make_double2(ms.tab64[k], ms.tab64[TABLE + k]);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const Tiles& t = ms.t;
  // the block's first tile (r, yt, cx): block b of the walk
  const int per_rep = t.nty * t.nch;
  const int r0 = blockIdx.x / per_rep;
  const int rest = blockIdx.x - r0 * per_rep;
  const int yt0 = rest / t.nch;
  const int cx0 = rest - yt0 * t.nch;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int phase = 0; phase < 2; ++phase) {
      int8_t* x = phase ? ms.b : ms.a;
      const int8_t* o = phase ? ms.a : ms.b;
      uint2 rk[10];
      philox_round_keys(
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2]),
          static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2 + 1]), rk);
      int r = r0, yt = yt0, cx = cx0;
      while (r < ms.nrep) {
        if (phase)
          tile<true>(ms, sm, tab, tab64, rk, x, o, 1, r, yt, cx, s);
        else
          tile<false>(ms, sm, tab, tab64, rk, x, o, 0, r, yt, cx, s);
        tiles8::next_row_tile(t, ms.step, r, yt, cx);
      }
      grid.sync();
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid for the tiles (the 10 ints of
// ops/ising2d_multisweep.ms_tiles): as many as can be resident at once on
// the current device with the tile's shared memory (0 if none fits).
int clock_int8_multisweep_grid(const int* tiles, int* blocks) {
  Tiles t;
  std::memcpy(&t, tiles, sizeof(Tiles));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, THREADS, t.smem);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// S sweeps of a, b (R, ny, half) int8 in place under seeds (S, 2, 2);
// tab, tab64 the (2, 128) float32 and float64 tables; partials
// (R, S, nty nch, 3) float64 scratch; per-sweep (Σ cos, Σ sin, E) into
// obs (R, S, 3) float64; tiles the 10 ints of ops/ising2d_multisweep.
// ms_tiles.
int clock_int8_multisweep(void* a, void* b, const void* seeds,
                          const void* tab, const void* tab64, void* partials,
                          void* obs, int nrep, int ny, int half, int q,
                          int sweeps, float neg_beta, const int* tiles,
                          void* stream) {
  const clock8::Geometry g = clock8::geometry(ny, half);
  Multisweep ms{};
  std::memcpy(&ms.t, tiles, sizeof(Tiles));
  if (!clock8::launchable(g, nrep, q) || sweeps < 1 ||
      !tiles8::row_tiles_ok(ms.t, ny, half))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_rep = ms.t.nty * ms.t.nch;
  const long long total = static_cast<long long>(nrep) * per_rep;
  if (total >= (1LL << 31) ||
      static_cast<long long>(nrep) * sweeps >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = clock_int8_multisweep_grid(tiles, &resident);
  if (err != 0) return err;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = total < resident ? static_cast<int>(total) : resident;
  ms.a = static_cast<int8_t*>(a);
  ms.b = static_cast<int8_t*>(b);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.tab = static_cast<const float*>(tab);
  ms.tab64 = static_cast<const double*>(tab64);
  ms.partials = static_cast<double*>(partials);
  ms.nrep = nrep;
  ms.ny = ny;
  ms.half = half;
  ms.q = q;
  ms.sweeps = sweeps;
  ms.neg_beta = neg_beta;
  tiles8::row_tile_steps(ms.t, blocks, ms.step);
  void* args[] = {&ms};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, static_cast<size_t>(ms.t.smem), st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs),
      per_rep);
  return static_cast<int>(cudaGetLastError());
}

const char* clock_int8_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
