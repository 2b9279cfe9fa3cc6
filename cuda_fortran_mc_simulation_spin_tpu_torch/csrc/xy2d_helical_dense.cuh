// The ragged dual-colour layout of helical XY (odd nx), shared by
// xy2d_helical_dense.cu (component planes) and xy2d_helical_dense_angle.cu
// (angle planes).
//
// Layout (ops/xy2d_helical_dense.py): (R, ny, nc) float32 planes, nc =
// (nx + 1) / 2, colour 0 at (y, x = 2i + (y & 1)) and colour 1 at
// (y, x = 2i + 1 - (y & 1)).  A colour's long rows (colour 0 even, colour 1
// odd) hold nc sites and its short rows nc - 1: column nc - 1 of a short
// row is the ragged slot, never updated nor counted.  The four neighbours
// of a site are other-colour slots: up and down the same column in rows
// y -+ 1 (wrapping at ny); on a long row left is column i - 1 and right
// column i, except at the helical x-seam, where x = 0's left is the
// up-row's column nc - 1 and x = nx - 1's right the down-row's column 0; on
// a short row left is column i and right column i + 1.  This is JAX's
// _nbrs_dense (xy2d_helical_dense.py:128-150) written per slot.
//
// A block of THREADS threads walks slots w = block * THREADS + thread,
// stepping by the grid's width.  The caller gives the grid's width nblk
// (ops/xy2d_helical_dense.blocks, the one place it is chosen), since it also
// sizes the measuring launch's nblk x 3 float64 partials a replica for
// reduce_kernel (one block a replica).  Measured at 10001x10000 x 1
// (chip_time_xy.py --helical, PERF.md): uncapped, one slot a thread, the
// 4.7 MB of partials cost a measuring phase ~0.3 ms; 1024 blocks are 1.3
// waves of ~790 resident blocks and idle a third of the card in the
// second; 32768 (~41 waves) was fastest in 7 of 8 modes.  The state does
// not depend on the grid; the sums are added in a fixed order.
// Offsets are 64-bit (R replicas of 1e8 sites pass 2^31 at R >= 22).
#pragma once

#include "xy2d_site.cuh"

namespace xyh {

using xy::THREADS;

// Slot (r, y, i) of the colour updated, the offsets of its four
// neighbours in the other colour's planes, whether it holds a site of its
// colour (valid) and whether the other colour's slot (y, i) holds one of
// that colour's (ovalid).  The neighbours are meaningful where valid.
struct Slot {
  size_t idx, up, dn, left, right;
  int y, i;
  bool valid, ovalid;
};

__device__ __forceinline__ Slot dense_slot(int r, int w, int ny, int nc,
                                           int color) {
  Slot s;
  s.y = w / nc;
  s.i = w - s.y * nc;
  const int y = s.y, i = s.i;
  const bool long_row = (color == 0) == ((y & 1) == 0);
  const int yu = y == 0 ? ny - 1 : y - 1;
  const int yd = y == ny - 1 ? 0 : y + 1;
  const size_t base = static_cast<size_t>(r) * ny * nc;
  const size_t row = base + static_cast<size_t>(y) * nc;
  const size_t rowu = base + static_cast<size_t>(yu) * nc;
  const size_t rowd = base + static_cast<size_t>(yd) * nc;
  s.idx = row + i;
  s.valid = i < (long_row ? nc : nc - 1);
  s.ovalid = i < (long_row ? nc - 1 : nc);
  s.up = rowu + i;
  s.dn = rowd + i;
  if (long_row) {
    s.left = i == 0 ? rowu + (nc - 1) : row + (i - 1);
    s.right = i == nc - 1 ? rowd : row + i;
  } else {
    s.left = row + i;
    s.right = row + (i + 1 < nc ? i + 1 : i);
  }
  return s;
}

// ((up + dn) + left) + right of one component plane, read-only in the
// launch
__device__ __forceinline__ float field(const float* o, const Slot& s) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__ldg(o + s.up), __ldg(o + s.dn)),
                __ldg(o + s.left)),
      __ldg(o + s.right));
}

// The slot's uniforms: injected (ucand non-null) or words 0 and 1 of
// Philox at counter (r, y, i, 0) under the phase key, top 24 bits
__device__ __forceinline__ void uniforms(const Slot& s, int r,
                                         const float* ucand,
                                         const float* uacc, uint2 key,
                                         float& uc, float& ua) {
  if (ucand != nullptr) {
    uc = __ldg(ucand + s.idx);
    ua = __ldg(uacc + s.idx);
  } else {
    const uint4 b = philox4x32_10(
        make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(s.y),
                   static_cast<uint32_t>(s.i), 0u),
        key);
    uc = xy::u24(b.x);
    ua = xy::u24(b.y);
  }
}

// The float64 S·h term of a valid slot whose new spin is (fx, fy)
__device__ __forceinline__ double bond_sum(float fx, float fy, float hx,
                                           float hy) {
  return static_cast<double>(
      __fadd_rn(__fmul_rn(fx, hx), __fmul_rn(fy, hy)));
}

// The shape and grid of a launch: the grid-stride index w stays below
// ny * nc + nblk * THREADS, which must fit an int
inline int check_shape(int nrep, int ny, int nc, int nblk) {
  if (int bad = xy::check_shape(nrep, ny, nc)) return bad;
  if (ny % 2 != 0 || nc < 2 || nblk < 1 ||
      static_cast<long long>(ny) * nc +
              static_cast<long long>(nblk) * THREADS >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// One launch's reduce_kernel where it measures
inline int finish(void* partials, void* obs, int nrep, int nblk,
                  cudaStream_t st) {
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || partials == nullptr) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xyh
