// S int8 2-D Ising sweeps in one cooperative launch on Hopper (sm_90a).
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising2d_multisweep.py:_kernel (pallas_call at :128,
//                     _multisweep -> multisweep): S full sweeps (phase a,
//                     then phase b) of (R, ny, half) int8 planes, in place,
//                     with each sweep's exact (m, e) fused into phase b as
//                     JAX's :84-90 fuses them (m = Σ new + Σ o,
//                     e = -Σ new * nsum), into an (R, S, 2) int64 buffer.
//
// The TPU kernel keeps one replica in VMEM a grid step.  A 1000x1000
// replica is 1 MB and the ensemble 16 MB, which sits in the 50 MB L2, so
// here the planes stay in device memory: a cooperative grid walks every
// tile of a phase and waits at a grid barrier before the next phase reads
// what it wrote.  Sweep s, phase p draws under the key seeds[s][p]
// (ops/multispin_rng.sweep_phase_keys), its round keys taken once a
// phase, and the counter of phase_kernel (csrc/ising2d_pallas.cu,
// csrc/ising_int8.cuh): unit j of row y, sites 4j .. 4j + 3, one
// Philox4x32-10 call at (replica, y, j, 0), site 4j + k taking output k.
// So S sweeps here equal S pairs of phase_kernel launches and
// measure_kernel (csrc/ising2d_measure_pallas.cu), bitwise.
//
// Tiles (csrc/byte_tiles.cuh RowTiles; ops/ising2d_multisweep.ms_tiles
// computes the constants, the entry point takes them as passed), the
// int8 clock multisweep's (csrc/clock_multisweep.cu).  A tile is `rows`
// whole rows y0 .. of one replica (past MAX_COLUMNS columns one row's
// chunk of cw columns).  Its four byte ranges are contiguous: its own
// sites, the other colour's rows y0 .. (a chunk widened by a column each
// side), and the other colour's rows y0 - 1 and y0 + rows, wrapped in y.
// The block stages them in shared memory (cp.async from the aligned 16-B
// vectors that cover them, any base address), then thread t takes rows
// t >> lux, + 256 >> lux, ... of the tile and units (t mod 2^lux), +
// 2^lux, ... of each.  Each neighbour window of a unit is one funnel shift
// of two aligned shared-memory words, the same shift for every unit of a
// row; the centre and side neighbours are the windows of one word pair one
// byte apart (which is which follows the row's parity), the row's wrap
// patched into the side window's end byte.  New bytes go to the tile's
// own copy, and the block writes its range back in aligned vectors, bytes
// at the ragged ends; every site lies in one tile, so a phase stores each
// site once and no byte outside the tiles.  Blocks walk the tiles replica
// major, gridDim.x apart, by carries: no division in the walk.
//
// The rule, four sites a 32-bit word (csrc/ising3d_pallas.cu's in 2-D).
// With K the neighbours whose spin differs from the site's, k = s * nsum
// = 4 - 2K: flip iff K >= 2, or K = 1 and word < t4, or K = 0 and word <
// t8.  As t8 <= t4, that is K + L >= 2 with L the thresholds the word
// lies below.  The bit 1 of a ±1 byte is its sign, so Σ_n ((x ^ n) &
// 0x02020202) holds 2K a byte and ((2K + 2L + 12) & 16) is the flip.  The
// fused sums of phase b: m = Σ new + Σ o from the sign bits, e = -Σ new *
// nsum = Σ (2K' - 4), K' the neighbours differing from the new spin; per
// thread, then per tile by ising8::block_add (int64 atomics, exact in any
// order).
//
// Bound on the H100: operations.  A launch reads and writes the planes
// once (4 B a site) but runs 2 S phases of 26.5 instructions a site and S
// fused sums of 4 (chip_smoke.py's count); it saves the host's launches
// of 3 S kernels and keeps the planes in L2.  The first design, one thread
// a unit with 64-bit divisions, five byte loads from L2 a site and the
// round keys recomputed in every Philox call, ran at 14% of it; this one
// at 27%, with 64 registers and 4 blocks an SM, one a tile of the class's
// 512 (with the round keys in registers 80 and 3, and 44% slower; PERF.md
// §6).
#include <cooperative_groups.h>

#include <cstring>

#include "byte_tiles.cuh"
#include "ising_int8.cuh"

namespace cg = cooperative_groups;

namespace {

using ising8::THREADS;
using tiles8::RowTiles;
using tiles8::stage;
using tiles8::win;
using tiles8::write_back;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

constexpr uint32_t SIGN = 0x02020202u;

struct Multisweep {
  int8_t* a;             // (R, ny, half), updated in place
  int8_t* b;
  const int32_t* seeds;  // (S, 2, 2) Philox keys per (sweep, phase)
  long long* obs;        // (R, S, 2), zeroed by the caller
  int nrep, ny, half, sweeps;
  uint32_t t4, t8;
  int step[3];           // the walk's steps (tiles8::row_tile_steps)
  RowTiles t;
};

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

// One tile (replica r, row tile yt, chunk cx) of a colour phase: x the
// colour updated in place, o the other.  MEASURE (phase b) adds the fused
// (m, e) of sweep s.  Every thread of the block calls it; it ends with a
// barrier, after which the block may stage the next tile.
template <bool MEASURE>
__device__ __forceinline__ void tile(const Multisweep& ms, uint8_t* sm,
                                     const uint2 (&rk)[10], int8_t* x,
                                     const int8_t* o, int color, int r,
                                     int yt, int cx, int s) {
  const RowTiles& t = ms.t;
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
  int m = 0, e = 0;
  for (int ry = ty; ry < nr; ry += tr) {
    const int y = y0 + ry;
    // colour 0 on an odd row and colour 1 on an even row read column
    // i + 1, the others column i - 1
    const int d = (color == 0) == ((y & 1) == 1) ? 1 : -1;
    // byte positions in shared memory of the row's first unit's windows:
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
      uint32_t lower = __funnelshift_r(wc[j], wc[j + 1], sc);
      uint32_t upper = __funnelshift_rc(wc[j], wc[j + 1], sc + 8);
      // the row's wrap: column 0's left neighbour is half - 1, and
      // half - 1's right neighbour is 0
      if (d > 0) {
        if (col + 3 >= half - 1)
          upper = tiles8::put_byte(upper, half - 1 - col,
                                   static_cast<uint8_t>(__ldcg(orow)));
      } else if (col == 0) {
        lower = tiles8::put_byte(
            lower, 0, static_cast<uint8_t>(__ldcg(orow + half - 1)));
      }
      const uint32_t k2 = ((xv ^ lower) & SIGN) + ((xv ^ upper) & SIGN) +
                          ((xv ^ win(wu + j, su)) & SIGN) +
                          ((xv ^ win(wd + j, sd)) & SIGN);
      const uint4 w = philox_rk(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                     static_cast<uint32_t>(col >> 2), 0u),
          rk);
      const uint32_t f =
          ((k2 + 2u * below2(w, ms.t4, ms.t8) + 0x0C0C0C0Cu) >> 4) &
          0x01010101u;
      const uint32_t nxv = xv ^ (f * 0xFEu);
      uint8_t* dst = sm + px + 4 * j;
      if (nv == 4 && (px & 3) == 0) {
        *reinterpret_cast<uint32_t*>(dst) = nxv;
      } else if (nv == 4 && (px & 1) == 0) {
        reinterpret_cast<uint16_t*>(dst)[0] = static_cast<uint16_t>(nxv);
        reinterpret_cast<uint16_t*>(dst)[1] =
            static_cast<uint16_t>(nxv >> 16);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nv) dst[k] = static_cast<uint8_t>(nxv >> (8 * k));
      }
      if (MEASURE) {
        // m += new + o, e -= new * nsum = -(4 - 2K'), K' the neighbours
        // differing from the new spin
        const uint32_t vm = nv == 4 ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u;
        const uint32_t centre = d > 0 ? lower : upper;
        m += 2 * nv -
             2 * (__popc(nxv & SIGN & vm) + __popc(centre & SIGN & vm));
        const uint32_t kp2 = k2 ^ ((k2 ^ (0x08080808u - k2)) & (f * 0xFFu));
        e += static_cast<int>(((kp2 & vm) * 0x01010101u) >> 24) - 4 * nv;
      }
    }
  }
  __syncthreads();
  write_back(xs, sm + t.buf[0], shx, lx);
  if (MEASURE)
    ising8::block_add(
        m, e, ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2);
  else
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) multisweep_kernel(Multisweep ms) {
  extern __shared__ __align__(16) uint8_t sm[];
  cg::grid_group grid = cg::this_grid();
  const RowTiles& t = ms.t;
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
      // the phase's round keys in shared memory (in registers they took
      // 16 more and a block an SM, PERF.md §6); the tile's first barrier
      // comes before they are read, the last grid barrier after the last
      // read of the phase before
      __shared__ uint2 rk[10];
      if (threadIdx.x == 0)
        philox_round_keys(
            static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2]),
            static_cast<uint32_t>(ms.seeds[(2 * s + phase) * 2 + 1]), rk);
      int r = r0, yt = yt0, cx = cx0;
      while (r < ms.nrep) {
        if (phase)
          tile<true>(ms, sm, rk, x, o, 1, r, yt, cx, s);
        else
          tile<false>(ms, sm, rk, x, o, 0, r, yt, cx, s);
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
int ising2d_int8_multisweep_grid(const int* tiles, int* blocks) {
  RowTiles t;
  std::memcpy(&t, tiles, sizeof(RowTiles));
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
// per-sweep (m, e) into obs (R, S, 2) int64, zeroed by the caller; t4 >=
// t8 the thresholds; tiles the 10 ints of ops/ising2d_multisweep.ms_tiles.
int ising2d_int8_multisweep(void* a, void* b, const void* seeds, void* obs,
                            int nrep, int ny, int half, int sweeps,
                            unsigned int t4, unsigned int t8,
                            const int* tiles, void* stream) {
  const ising8::Geometry g = ising8::geometry(1, ny, half);
  Multisweep ms{};
  std::memcpy(&ms.t, tiles, sizeof(RowTiles));
  if (!ising8::launchable(g, nrep) || sweeps < 1 || t8 > t4 ||
      !tiles8::row_tiles_ok(ms.t, ny, half))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(nrep) * ms.t.nty * ms.t.nch;
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = ising2d_int8_multisweep_grid(tiles, &resident);
  if (err != 0) return err;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = total < resident ? static_cast<int>(total) : resident;
  ms.a = static_cast<int8_t*>(a);
  ms.b = static_cast<int8_t*>(b);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.obs = static_cast<long long*>(obs);
  ms.nrep = nrep;
  ms.ny = ny;
  ms.half = half;
  ms.sweeps = sweeps;
  ms.t4 = t4;
  ms.t8 = t8;
  tiles8::row_tile_steps(ms.t, blocks, ms.step);
  void* args[] = {&ms};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, static_cast<size_t>(ms.t.smem),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ising2d_int8_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
