// The int8 Ising observables of a state in one pass on Hopper (sm_90a).
//
//   measure_kernel<2> replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     ising2d_measure_pallas.py:_kernel (pallas_call at
//                     :74, _measure -> measure): per replica the exact
//                     (Σ s, E) of (R, ny, half) int8 planes,
//                     E = -Σ s (s_right + s_down), each bond once.
//   measure_kernel<3> the same for (R, nz, ny, half) volumes with the back
//                     (z + 1) bond.  The JAX package sums the 3-D
//                     observables in jnp outside any kernel (models/
//                     ising3d.py:144-171); in PyTorch their int64
//                     temporaries at 500^3 x 2 would cost gigabytes.
//
// Layout (core/lattice.py): colour a holds the sites x = 2i + ((y + z) &
// 1) of row (z, y), colour b the others.  Site i of a row's a has its
// right neighbour in b at column i + ((y + z) & 1) (wrapped), site i of b
// in a at column i + 1 - ((y + z) & 1); the down and back neighbours are
// the other colour's site i of row y + 1 and plane z + 1 (wrapped).
//
// Tiles (the tile walk of csrc/ising3d_pallas.cu tile_kernel; the
// constants from ops/ising2d_measure_pallas.measure_tiles, the entry
// point takes them as passed).  A block takes `rows` whole rows y0 .. of
// a run of zrun planes (one plane in 2-D), or past 4096 columns one row's
// chunk of cw columns, of every replica in turn: a grid (chunks, row
// tiles, plane runs), no division.  For each plane z of its run it
// stages, by cp.async from the 16-B aligned vectors that cover them
// (csrc/byte_tiles.cuh), the byte ranges it reads: both colours' rows
// y0 .., their row after the tile (y0 + rows, wrapped) and, in 3-D, the
// same rows of plane z + 1 (wrapped), which are the next plane's own rows:
// two slots swap roles, so each plane's rows are staged once a run (the
// run's first twice).  Thread t takes rows t >> lux, + 256 >> lux, ... of
// the tile and units (t mod 2^lux), + 2^lux, ... of four columns of each
// (a warp within one row where a row has 32 units, so its shared loads
// are 32 consecutive words).  A unit's windows of four sites are funnel
// shifts of two aligned shared words (rows start anywhere mod 4: 2-B
// aligned at half 250); the right window is the same word pair one byte
// on, the row's wrap patched into its end byte (from shared memory with
// whole rows, from device memory once a row in a chunk); a row's ragged
// tail is masked out of the own-site bytes.  The sums are four sites a
// 32-bit word: the bytes are ±1, so __dp4a(s, n, acc) adds Σ s·n exactly,
// one neighbour window at a time, and __dp4a(s, 0x01010101, acc) adds Σ s.
// They go in int32 a thread, then one pair of int64 atomics a block and
// replica (ising_int8.cuh block_add).  Integer sums are exact in any
// order, so the result is the plain version's bitwise; JAX accumulates
// f32 across row blocks.
//
// Bound on the H100: bytes.  It reads both colours once, 1 B a site,
// against ~3.5 instructions a site; it stages 1 + 1 / rows of them (the
// row after a tile) and in 3-D 1 + 1 / zrun more.  It runs at ~46% of
// that bound at 500^3 x 2 and ~53% at 4000^2 x 8, a tile step (stage,
// wait, sum) taking ~6 us whatever its bytes: runs of 1 to 8 planes moved
// it by 7%, 6 or 8 blocks an SM (register caps) and a ring that issues
// the next step's copies before it sums made it slower (PERF.md §6).  The
// first design, one thread a unit over device memory with a 64-bit % and
// / a thread and eight byte loads a column, ran at 17% of the bound at
// 500^3 x 2; a first tiled cut with warps across four rows (2-way bank
// conflicts) at 30%.
#include <algorithm>
#include <cstring>

#include "byte_tiles.cuh"
#include "ising_int8.cuh"

namespace {

using ising8::THREADS;
using tiles8::put_byte;
using tiles8::span_bytes;
using tiles8::stage;
using tiles8::win;
static_assert(THREADS == tiles8::STAGE_THREADS, "a block stages its tiles");

// The launch constants of ops/ising2d_measure_pallas.measure_tiles, in its
// order.
struct Tiles {
  int rows;    // rows of a tile (1 in a chunk)
  int lux;     // log2 of the threads along a row: ux = 1 << lux
  int cw;      // columns of a tile: half, or a chunk's (a multiple of 4)
  int nch;     // chunks a row (1 with whole rows)
  int nty;     // row tiles a plane
  int zrun;    // planes a block walks (1 in 2-D)
  int nzg;     // runs of planes: ceil(nz / zrun)
  int buf[6];  // byte offsets in shared memory of the a and b tiles of two
               // planes' slots (buf[0], buf[1] and buf[4], buf[5]) and of
               // the a and b rows after the tile (buf[2], buf[3]); each
               // 16-B aligned with 16 bytes before it and 32 after its
               // vectors; 2-D: the second slot 0
  int smem;    // bytes of dynamic shared memory
};
constexpr int TILE_WORDS = 14;
static_assert(sizeof(Tiles) == TILE_WORDS * 4, "ops/ising2d_measure_pallas.py "
              "passes the tiles as 14 ints");

constexpr uint32_t ONES = 0x01010101u;

// The (m, e) of every replica: a grid of (chunks, min(row tiles, 65535),
// min(plane runs, 65535)) blocks of THREADS, t.smem bytes of dynamic
// shared memory.  In 3-D a block walks the planes z0 .. z0 + zrun - 1 of
// its run: plane z + 1's tiles, staged as z's back neighbours, are the
// next step's own, so a plane's tiles are staged once a run, not twice.
template <int D>
__global__ void __launch_bounds__(THREADS)
    measure_kernel(const int8_t* a, const int8_t* b, long long* obs,
                   int nrep, int nz, int ny, int half, Tiles t) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int ux = 1 << t.lux, tr = THREADS >> t.lux;
  const int tx = threadIdx.x & (ux - 1), ty = threadIdx.x >> t.lux;
  const size_t plane = static_cast<size_t>(ny) * half;
  const int c0 = blockIdx.x * t.cw;
  const int ncw = min(t.cw, half - c0);
  // the column after the tile's last: the wrap, or the next chunk's first
  const int cnext = c0 + ncw == half ? 0 : c0 + ncw;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm);
  for (int g = blockIdx.z; g < t.nzg; g += gridDim.z) {
    const int z0 = g * t.zrun;
    const int z1 = min(z0 + t.zrun, nz);
    for (int yt = blockIdx.y; yt < t.nty; yt += gridDim.y) {
      const int y0 = yt * t.rows;
      const int nr = min(t.rows, ny - y0);
      const int lx = (nr - 1) * half + ncw;
      const int yd = y0 + nr == ny ? 0 : y0 + nr;
      const size_t at = static_cast<size_t>(y0) * half + c0;
      const size_t dn = static_cast<size_t>(yd) * half + c0;
      for (int r = 0; r < nrep; ++r) {
        const size_t rep = static_cast<size_t>(r) * nz * plane;
        // the slots of plane z's tiles (ba, bb) and of plane z + 1's (na,
        // nb), with the tiles' first bytes' offsets mod 16
        int ba = t.buf[0], bb = t.buf[1], na = t.buf[4], nb = t.buf[5];
        int sha = stage(sm + ba, a + rep + z0 * plane + at, lx);
        int shb = stage(sm + bb, b + rep + z0 * plane + at, lx);
        int sna = 0, snb = 0;
        int m = 0, bonds = 0;
        for (int z = z0; z < z1; ++z) {
          const size_t zo = rep + z * plane;
          const int shad = stage(sm + t.buf[2], a + zo + dn, ncw);
          const int shbd = stage(sm + t.buf[3], b + zo + dn, ncw);
          if (D == 3) {
            const size_t zn = rep + (z == nz - 1 ? 0 : z + 1) * plane + at;
            sna = stage(sm + na, a + zn, lx);
            snb = stage(sm + nb, b + zn, lx);
          }
          asm volatile("cp.async.commit_group;\n" ::);
          asm volatile("cp.async.wait_group 0;\n" ::);
          __syncthreads();
          for (int ry = ty; ry < nr; ry += tr) {
            const int y = y0 + ry;
            const bool odd = ((y + z) & 1) != 0;
            // byte positions in shared memory of the row's first unit:
            // a, b, their down rows and (3-D) back rows
            const int row = ry * half;
            const int pa = ba + sha + row;
            const int pb = bb + shb + row;
            const int pad = ry == nr - 1 ? t.buf[2] + shad : pa + half;
            const int pbd = ry == nr - 1 ? t.buf[3] + shbd : pb + half;
            const int paz = na + sna + row;
            const int pbz = nb + snb + row;
            // the byte after the tile's last column of the right
            // neighbours' colour: b's sites on an odd row, a's on an even
            uint32_t wrap_byte;
            if (t.nch == 1)
              wrap_byte = sm[odd ? pb : pa];
            else
              wrap_byte = static_cast<uint8_t>(__ldg(
                  (odd ? b : a) + zo + static_cast<size_t>(y) * half + cnext));
            // word indices in shared memory and byte shifts of the windows
            const int ia = pa >> 2, ib = pb >> 2, iad = pad >> 2;
            const int ibd = pbd >> 2, iaz = paz >> 2, ibz = pbz >> 2;
            const int sa8 = 8 * (pa & 3), sb8 = 8 * (pb & 3);
            const int ss8 = (odd ? sb8 : sa8) + 8;
            const int sad8 = 8 * (pad & 3), sbd8 = 8 * (pbd & 3);
            const int saz8 = 8 * (paz & 3), sbz8 = 8 * (pbz & 3);
            for (int j = tx; 4 * j < ncw; j += ux) {
              const int nv = min(4, ncw - 4 * j);
              const uint32_t vm =
                  nv == 4 ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u;
              const uint32_t a0 = sw[ia + j], a1 = sw[ia + j + 1];
              const uint32_t b0 = sw[ib + j], b1 = sw[ib + j + 1];
              const int sam = static_cast<int>(__funnelshift_r(a0, a1, sa8) &
                                               vm);
              const uint32_t sb = __funnelshift_r(b0, b1, sb8);
              const int sbm = static_cast<int>(sb & vm);
              // bytes 1 .. 4 on of the same words: the right neighbours (a
              // shift of 32 is the second word whole)
              uint32_t rt = __funnelshift_rc(odd ? b0 : a0, odd ? b1 : a1, ss8);
              if (4 * j + nv == ncw) rt = put_byte(rt, nv - 1, wrap_byte);
              m = __dp4a(sam, static_cast<int>(ONES), m);
              m = __dp4a(sbm, static_cast<int>(ONES), m);
              bonds = __dp4a(sam, static_cast<int>(sb), bonds);
              bonds = __dp4a(odd ? sam : sbm, static_cast<int>(rt), bonds);
              bonds = __dp4a(sam, static_cast<int>(win(sw + ibd + j, sbd8)),
                             bonds);
              bonds = __dp4a(sbm, static_cast<int>(win(sw + iad + j, sad8)),
                             bonds);
              if (D == 3) {
                bonds = __dp4a(
                    sam, static_cast<int>(win(sw + ibz + j, sbz8)), bonds);
                bonds = __dp4a(
                    sbm, static_cast<int>(win(sw + iaz + j, saz8)), bonds);
              }
            }
          }
          if (z + 1 < z1) {
            // the next step restages the down rows and this plane's slot
            __syncthreads();
            int k = ba;
            ba = na;
            na = k;
            k = bb;
            bb = nb;
            nb = k;
            sha = sna;
            shb = snb;
          }
        }
        // ends with a barrier: the next replica may restage at once
        ising8::block_add(m, -bonds, obs + 2 * static_cast<size_t>(r));
      }
    }
  }
}

constexpr int MAX_GRID = 65535;

// The constants as measure_tiles builds them; refuses others
bool tiles_ok(const Tiles& t, int dims, int nz, int ny, int half) {
  if (t.lux < 2 || t.lux > 8 || t.rows < 1 ||
      t.rows % (THREADS >> t.lux) != 0)
    return false;
  if (t.cw < 1 || t.nch < 1 || static_cast<long long>(t.nch) * t.cw < half ||
      (t.nch > 1 && (t.cw % 4 != 0 || t.rows != 1)) ||
      (t.nch == 1 && t.cw != half))
    return false;
  if (t.nty < 1 || static_cast<long long>(t.nty) * t.rows < ny) return false;
  if (t.zrun < 1 || t.nzg < 1 || static_cast<long long>(t.nzg) * t.zrun < nz ||
      static_cast<long long>(t.nzg - 1) * t.zrun >= nz ||
      (dims == 2 && t.zrun != 1))
    return false;
  const long long lx =
      static_cast<long long>(t.rows - 1) * half + std::min(t.cw, half);
  const int need[6] = {span_bytes(lx), span_bytes(lx),
                       span_bytes(std::min(t.cw, half)),
                       span_bytes(std::min(t.cw, half)), span_bytes(lx),
                       span_bytes(lx)};
  return tiles8::spans_ok(t.buf, need, dims == 3 ? 6 : 4, t.smem);
}

}  // namespace

extern "C" {

// (m, e) of each replica of the colour planes a, b into obs (R, 2) int64,
// zeroed by the caller; dims = 2 ((R, ny, half), nz = 1) or 3; tiles the
// 14 ints of ops/ising2d_measure_pallas.measure_tiles.
int ising_int8_measure(const void* a, const void* b, void* obs, int nrep,
                       int dims, int nz, int ny, int half, const int* tiles,
                       void* stream) {
  Tiles t;
  std::memcpy(&t, tiles, sizeof(Tiles));
  const ising8::Geometry g = ising8::geometry(nz, ny, half);
  if (!ising8::launchable(g, nrep) || (dims == 3 && nz < 2) ||
      (dims == 2 && nz != 1) || (dims != 2 && dims != 3) ||
      !tiles_ok(t, dims, nz, ny, half))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(t.nch, std::min(t.nty, MAX_GRID),
                  std::min(t.nzg, MAX_GRID));
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* po = static_cast<long long*>(obs);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dims == 2)
    measure_kernel<2><<<grid, THREADS, t.smem, s>>>(pa, pb, po, nrep, nz, ny,
                                                    half, t);
  else
    measure_kernel<3><<<grid, THREADS, t.smem, s>>>(pa, pb, po, nrep, nz, ny,
                                                    half, t);
  return static_cast<int>(cudaGetLastError());
}

const char* ising_int8_measure_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
