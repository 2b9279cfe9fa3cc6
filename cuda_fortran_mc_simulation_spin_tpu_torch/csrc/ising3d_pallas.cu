// The int8 3-D Ising checkerboard Metropolis phase on Hopper (sm_90a).
//
//   tile_kernel<false, .> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                ising3d_pallas.py:_phase_kernel (pallas_call at :85,
//                _metropolis_phase).  One colour phase of (R, nz, ny,
//                half) int8 volumes, in place; six neighbours (z -+ 1 and
//                y -+ 1 periodic, the side one by (y + z) parity and
//                colour), three thresholds t4, t8, t12; Philox words or
//                injected (R, nz, ny, half) uint32 words (JAX's
//                sharded_phase takes bits= at :237).
//   tile_kernel<true, .> replaces ising3d_pallas.py:_halo_phase_kernel
//                (pallas_call at :237, sharded_phase).  The same phase on a
//                z-shard of a (dp, y) mesh (parallel/domain.py): the planes
//                before its first and after its last come from the
//                exchanged halo planes; parity (z0 + z + y) & 1 and the
//                Philox row (z0 + z) * ny + y are global, so a sharded
//                run equals the unsharded one bit for bit.  MEASURE adds
//                the shard's exact int64 (m, e) partials (phase b).
//
// The site rule, the unit of four sites and the word layout are those of
// csrc/ising_int8.cuh (the 2-D kernels' tile, in 3-D): unit j of row
// (z, y) is sites 4j .. 4j + 3, its one
// Philox4x32-10 call at counter (replica, z * ny + y, j, 0), site 4j + k
// taking output k.  With K the neighbours whose spin differs from the
// site's, k = s * nsum = 6 - 2K: flip iff K >= 3, or K = 2 and word < t4,
// K = 1 and word < t8, K = 0 and word < t12.  As t12 <= t8 <= t4
// (core/tables caps them at 2^32 - 1), that is K + L >= 3 with L the
// thresholds the word lies below.
//
// Tiles (ops/ising3d_pallas.phase_tiles computes the constants; the entry
// points take them as passed).  A block takes `rows` whole rows y0 .. of
// one plane z (up to ~8 KB of sites), or past 4096 columns one row's
// chunk of cw columns, of every replica in turn: a grid (chunks, row
// tiles, planes), no division.  Each of the tile's six byte ranges is
// contiguous in memory: its own sites (x), the other colour's sites at z
// (rows y0 .., widened by a column each side in a chunk), at z - 1 and
// z + 1 (or the halo planes), and its rows y0 - 1 and y0 + rows (wrapped
// in y).  The block copies the 16-B aligned vectors that cover each range
// into shared memory (cp.async; any base address, the range's first byte
// landing at its address mod 16).  Thread t takes rows t >> lux, + 256 >>
// lux, ... of the tile and units (t mod 2^lux), + 2^lux, ... of each (8
// units a row at half 250): each window of four sites is one funnel
// shift of two aligned shared-memory words, the same shift for every unit
// of a row; the centre and side neighbours are the two windows of one
// word pair at byte offsets 0 and 1 apart (which is which follows the
// row's parity), the row's wrap patched into the side window's end byte.
// The sums are byte-SIMD: the bit 1 of a ±1 byte is its sign, so
// sum_n ((x ^ n) & 0x02020202) holds 2K a byte, and ((2K + 2L + 10) & 16)
// is the flip.  New bytes go to the tile's x copy, and the block writes
// its range back in 16-B vectors, bytes only at its two ragged ends: it
// writes no byte outside its range, and every site lies in one range.
//
// Bound on the H100: bytes.  3 B a site against ~28.5 instructions
// (chip_smoke.py's count, a quarter Philox call at 40 with it): at 500^3
// x 2, 0.1119 ms by bytes against 0.1065 ms by operations.  The first
// design, one thread a unit over device memory with 64-bit division and
// seven byte loads a site, ran at 21% of it.  This one runs ~155
// instructions a unit (a Philox call ~60, the windows ~35, the acceptance
// ~35); built without its site updates it takes about half its time,
// without its staging ~92% (PERF.md §6), so the integer pipe holds it,
// not memory.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "byte_tiles.cuh"
#include "ising_int8.cuh"
#include "philox.cuh"

namespace {

using ising8::THREADS;
using tiles8::put_byte;
using tiles8::span_bytes;
using tiles8::stage;
using tiles8::win;
using tiles8::write_back;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

// The launch constants of ops/ising3d_pallas.phase_tiles, in its order.
struct Tiles {
  int rows;    // rows of a tile (1 in a chunk)
  int lux;     // log2 of the threads along a row: ux = 1 << lux
  int cw;      // columns of a tile: half, or a chunk's (a multiple of 4)
  int nch;     // chunks a row (1 with whole rows)
  int nty;     // row tiles a plane
  int buf[6];  // byte offsets of the x, z, z - 1, z + 1, y0 - 1 and
               // y0 + rows copies in shared memory (16-B aligned, each
               // with 16 bytes before it and 32 after its vectors)
  int smem;    // bytes of dynamic shared memory
};
constexpr int TILE_WORDS = 12;
static_assert(sizeof(Tiles) == TILE_WORDS * 4, "ops/ising3d_pallas.py "
              "passes the tiles as 12 ints");

struct Args {
  int8_t* x;             // colour being updated, in place
  const int8_t* o;       // the other colour
  const uint32_t* bits;  // injected words (R, nz, ny, half), or null
  const int8_t* hzm;     // HALO: the planes before and after the shard
  const int8_t* hzp;     // (R, 1, ny, half)
  long long* obs;        // MEASURE: (R, 2) int64 (m, e), zeroed
  uint2 rk[10];          // Philox round keys of the phase key
  uint32_t t4, t8, t12;
  int nrep, nz, ny, half, color;
  int rep0, z0;          // HALO: the shard's first replica and plane
  Tiles t;
};

// Byte k of the result: the thresholds word k lies below, 0 .. 3 (t12 <=
// t8 <= t4)
__device__ __forceinline__ uint32_t below4(uint4 w, const Args& a) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t lv = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ws[k] < a.t4) lv += 1u << (8 * k);
    if (ws[k] < a.t8) lv += 1u << (8 * k);
    if (ws[k] < a.t12) lv += 1u << (8 * k);
  }
  return lv;
}

// One colour phase: a grid of (chunks, min(row tiles, 65535), min(nz,
// 65535)) blocks of THREADS, a.t.smem bytes of dynamic shared memory.
// BITS: the injected words.
template <bool HALO, bool MEASURE, bool BITS>
__global__ void __launch_bounds__(THREADS) tile_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const Tiles& t = a.t;
  const int half = a.half, ny = a.ny, nz = a.nz;
  const int ux = 1 << t.lux, tr = THREADS >> t.lux;
  const int tx = threadIdx.x & (ux - 1), ty = threadIdx.x >> t.lux;
  const size_t plane = static_cast<size_t>(ny) * half;
  const int c0 = blockIdx.x * t.cw;
  const int ncw = min(t.cw, half - c0);
  // the centre range's columns: a chunk's widened by one each side
  const int clo = c0 > 0 ? c0 - 1 : 0;
  const int chi = min(c0 + ncw + 1, half);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const int zm = z == 0 ? nz - 1 : z - 1;
    const int zp = z == nz - 1 ? 0 : z + 1;
    const int zg = (HALO ? a.z0 : 0) + z;
    for (int yt = blockIdx.y; yt < t.nty; yt += gridDim.y) {
      const int y0 = yt * t.rows;
      const int nr = min(t.rows, ny - y0);
      const int lx = (nr - 1) * half + ncw;
      const int lc = (nr - 1) * half + (chi - clo);
      const int yu = y0 == 0 ? ny - 1 : y0 - 1;
      const int yd = y0 + nr == ny ? 0 : y0 + nr;
      for (int r = 0; r < a.nrep; ++r) {
        const size_t zo = static_cast<size_t>(r) * nz * plane +
                          static_cast<size_t>(z) * plane;
        int8_t* xs = a.x + zo + static_cast<size_t>(y0) * half + c0;
        const int8_t* oz = a.o + zo;
        const int8_t* om =
            HALO && z == 0
                ? a.hzm + static_cast<size_t>(r) * plane
                : a.o + static_cast<size_t>(r) * nz * plane +
                      static_cast<size_t>(zm) * plane;
        const int8_t* op =
            HALO && z == nz - 1
                ? a.hzp + static_cast<size_t>(r) * plane
                : a.o + static_cast<size_t>(r) * nz * plane +
                      static_cast<size_t>(zp) * plane;
        const size_t at = static_cast<size_t>(y0) * half + c0;
        const int shx = stage(sm + t.buf[0], xs, lx);
        const int shc = stage(sm + t.buf[1],
                              oz + static_cast<size_t>(y0) * half + clo, lc);
        const int shm = stage(sm + t.buf[2], om + at, lx);
        const int shp = stage(sm + t.buf[3], op + at, lx);
        const int shu = stage(
            sm + t.buf[4], oz + static_cast<size_t>(yu) * half + c0, ncw);
        const int shd = stage(
            sm + t.buf[5], oz + static_cast<size_t>(yd) * half + c0, ncw);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        int m = 0, e = 0;
        const uint32_t rep = static_cast<uint32_t>((HALO ? a.rep0 : 0) + r);
        for (int ry = ty; ry < nr; ry += tr) {
          const int y = y0 + ry;
          // the row's side neighbour: column c + d
          const int d = (((zg + y) & 1) ^ a.color) ? 1 : -1;
          // byte positions in shared memory of the row's first unit's
          // windows: own, centre (its lower window), up, down, z -+ 1
          const int row = ry * half;
          const int px = t.buf[0] + shx + row;
          const int pc = t.buf[1] + shc + row + (c0 - clo) + (d < 0 ? -1 : 0);
          const int pu = ry == 0 ? t.buf[4] + shu
                                 : t.buf[1] + shc + row - half + (c0 - clo);
          const int pd = ry == nr - 1
                             ? t.buf[5] + shd
                             : t.buf[1] + shc + row + half + (c0 - clo);
          const int pm = t.buf[2] + shm + row;
          const int pp = t.buf[3] + shp + row;
          const uint32_t* wx = sw + (px >> 2);
          const uint32_t* wc = sw + (pc >> 2);
          const uint32_t* wu = sw + (pu >> 2);
          const uint32_t* wd = sw + (pd >> 2);
          const uint32_t* wm = sw + (pm >> 2);
          const uint32_t* wp = sw + (pp >> 2);
          const int sx = 8 * (px & 3), sc = 8 * (pc & 3), su = 8 * (pu & 3);
          const int sd = 8 * (pd & 3), smz = 8 * (pm & 3), spz = 8 * (pp & 3);
          const int8_t* orow = oz + static_cast<size_t>(y) * half;
          const uint32_t grow = static_cast<uint32_t>(zg) *
                                    static_cast<uint32_t>(ny) +
                                static_cast<uint32_t>(y);
          for (int j = tx; 4 * j < ncw; j += ux) {
            const int cg = c0 + 4 * j;
            const int nv = min(4, c0 + ncw - cg);
            const uint32_t xv = win(wx + j, sx);
            uint32_t lower = __funnelshift_r(wc[j], wc[j + 1], sc);
            uint32_t upper = __funnelshift_rc(wc[j], wc[j + 1], sc + 8);
            // the row's wrap: column 0's left neighbour is half - 1, and
            // half - 1's right neighbour is 0
            if (d > 0) {
              if (cg + 3 >= half - 1 && cg <= half - 1)
                upper = put_byte(upper, half - 1 - cg,
                                 static_cast<uint8_t>(__ldg(orow)));
            } else if (cg == 0) {
              lower = put_byte(lower, 0,
                               static_cast<uint8_t>(__ldg(orow + half - 1)));
            }
            constexpr uint32_t SIGN = 0x02020202u;
            const uint32_t k2 =
                ((xv ^ lower) & SIGN) + ((xv ^ upper) & SIGN) +
                ((xv ^ win(wu + j, su)) & SIGN) +
                ((xv ^ win(wd + j, sd)) & SIGN) +
                ((xv ^ win(wm + j, smz)) & SIGN) +
                ((xv ^ win(wp + j, spz)) & SIGN);
            uint4 w;
            if (BITS) {
              const uint32_t* bw =
                  a.bits + (static_cast<size_t>(r) * nz + z) * plane +
                  static_cast<size_t>(y) * half + cg;
              w = make_uint4(__ldg(bw), nv > 1 ? __ldg(bw + 1) : 0u,
                             nv > 2 ? __ldg(bw + 2) : 0u,
                             nv > 3 ? __ldg(bw + 3) : 0u);
            } else {
              w = philox_rk(
                  make_uint4(rep, grow, static_cast<uint32_t>(cg >> 2), 0u),
                  a.rk);
            }
            const uint32_t f =
                ((k2 + 2u * below4(w, a) + 0x0A0A0A0Au) >> 4) & 0x01010101u;
            const uint32_t nxv = xv ^ (f * 0xFEu);
            uint8_t* dst = sm + px + 4 * j;
            if (nv == 4 && (px & 3) == 0) {
              *reinterpret_cast<uint32_t*>(dst) = nxv;
            } else if (nv == 4 && (px & 1) == 0) {
              reinterpret_cast<uint16_t*>(dst)[0] =
                  static_cast<uint16_t>(nxv);
              reinterpret_cast<uint16_t*>(dst)[1] =
                  static_cast<uint16_t>(nxv >> 16);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (k < nv) dst[k] = static_cast<uint8_t>(nxv >> (8 * k));
            }
            if (MEASURE) {
              // m += new + o, e -= new * nsum = -(6 - 2K'), K' the
              // neighbours differing from the new spin
              const uint32_t vm =
                  nv == 4 ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u;
              const uint32_t centre = d > 0 ? lower : upper;
              m += 2 * nv - 2 * (__popc(nxv & SIGN & vm) +
                                 __popc(centre & SIGN & vm));
              const uint32_t kp2 =
                  k2 ^ ((k2 ^ (0x0C0C0C0Cu - k2)) & (f * 0xFFu));
              e += static_cast<int>(((kp2 & vm) * 0x01010101u) >> 24) -
                   6 * nv;
            }
          }
        }
        __syncthreads();
        write_back(xs, sm + t.buf[0], shx, lx);
        if (MEASURE)
          ising8::block_add(m, e, a.obs + 2 * r);
        else
          __syncthreads();
      }
    }
  }
}

constexpr int MAX_GRID = 65535;

// The constants as phase_tiles builds them; refuses others
bool tiles_ok(const Tiles& t, int ny, int half) {
  if (t.lux < 2 || t.lux > 8 || t.rows < 1 ||
      t.rows % (THREADS >> t.lux) != 0)
    return false;
  if (t.cw < 1 || t.nch < 1 || static_cast<long long>(t.nch) * t.cw < half ||
      (t.nch > 1 && (t.cw % 4 != 0 || t.rows != 1)) ||
      (t.nch == 1 && t.cw != half))
    return false;
  if (t.nty < 1 || static_cast<long long>(t.nty) * t.rows < ny) return false;
  // x, centre (two columns wider in a chunk), z - 1, z + 1, then the rows
  const long long lx =
      static_cast<long long>(t.rows - 1) * half + std::min(t.cw, half);
  const int need[6] = {span_bytes(lx),     span_bytes(lx + 2),
                       span_bytes(lx),     span_bytes(lx),
                       span_bytes(std::min(t.cw, half)),
                       span_bytes(std::min(t.cw, half))};
  return tiles8::spans_ok(t.buf, need, 6, t.smem);
}

Args make_args(void* x, const void* o, const void* bits, int nrep, int nz,
               int ny, int half, int color, unsigned s0, unsigned s1,
               unsigned t4, unsigned t8, unsigned t12, const int* tiles) {
  Args a{};
  a.x = static_cast<int8_t*>(x);
  a.o = static_cast<const int8_t*>(o);
  a.bits = static_cast<const uint32_t*>(bits);
  philox_round_keys(s0, s1, a.rk);
  a.t4 = t4;
  a.t8 = t8;
  a.t12 = t12;
  a.nrep = nrep;
  a.nz = nz;
  a.ny = ny;
  a.half = half;
  a.color = color;
  std::memcpy(&a.t, tiles, sizeof(Tiles));
  return a;
}

bool args_ok(const Args& a) {
  const ising8::Geometry g = ising8::geometry(a.nz, a.ny, a.half);
  return ising8::launchable(g, a.nrep) && tiles_ok(a.t, a.ny, a.half) &&
         a.t12 <= a.t8 && a.t8 <= a.t4;
}

dim3 grid_of(const Args& a) {
  return dim3(a.t.nch, std::min(a.t.nty, MAX_GRID), std::min(a.nz, MAX_GRID));
}

}  // namespace

extern "C" {

// One colour phase of x (R, nz, ny, half) int8 in place given o; bits is
// (R, nz, ny, half) uint32 or null (then Philox words under (s0, s1));
// tiles the 12 ints of ops/ising3d_pallas.phase_tiles.
int ising3d_int8_phase(void* x, const void* o, const void* bits, int nrep,
                       int nz, int ny, int half, int color, unsigned int s0,
                       unsigned int s1, unsigned int t4, unsigned int t8,
                       unsigned int t12, const int* tiles, void* stream) {
  const Args a = make_args(x, o, bits, nrep, nz, ny, half, color, s0, s1, t4,
                           t8, t12, tiles);
  if (!args_ok(a) || nz < 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != nullptr)
    tile_kernel<false, false, true><<<grid_of(a), THREADS, a.t.smem, st>>>(a);
  else
    tile_kernel<false, false, false><<<grid_of(a), THREADS, a.t.smem, st>>>(
        a);
  return static_cast<int>(cudaGetLastError());
}

// One colour phase of a z-shard x (R, nz, ny, half) int8 in place given o
// and the halo planes zm, zp (R, 1, ny, half); (rep0, z0) the shard's
// global offsets; obs an (R, 2) int64 buffer zeroed by the caller, or null.
int ising3d_int8_halo_phase(void* x, const void* o, const void* bits,
                            const void* zm, const void* zp, void* obs,
                            int nrep, int nz, int ny, int half, int color,
                            int rep0, int z0, unsigned int s0,
                            unsigned int s1, unsigned int t4,
                            unsigned int t8, unsigned int t12,
                            const int* tiles, void* stream) {
  Args a = make_args(x, o, bits, nrep, nz, ny, half, color, s0, s1, t4, t8,
                     t12, tiles);
  if (!args_ok(a) || z0 < 0 || rep0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.hzm = static_cast<const int8_t*>(zm);
  a.hzp = static_cast<const int8_t*>(zp);
  a.obs = static_cast<long long*>(obs);
  a.rep0 = rep0;
  a.z0 = z0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a);
  const int sm = a.t.smem;
  if (obs != nullptr && bits != nullptr)
    tile_kernel<true, true, true><<<grid, THREADS, sm, st>>>(a);
  else if (obs != nullptr)
    tile_kernel<true, true, false><<<grid, THREADS, sm, st>>>(a);
  else if (bits != nullptr)
    tile_kernel<true, false, true><<<grid, THREADS, sm, st>>>(a);
  else
    tile_kernel<true, false, false><<<grid, THREADS, sm, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ising3d_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
