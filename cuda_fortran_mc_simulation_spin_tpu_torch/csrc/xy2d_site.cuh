// Per-site float32 arithmetic of the periodic XY phases, shared by
// xy2d_pallas.cu (one phase a launch) and xy2d_resident.cu (S sweeps a
// launch): the layout, the field, the Metropolis update, the fused sums
// and their per-block float64 reduction.
//
// Layout (ops/xy2d_pallas.py): (R, ny, half) float32 planes, colour 0 at
// (y, 2i + (y & 1)); a site's neighbours are the other colour's (y±1, i),
// (y, i) and (y, i-1) or (y, i+1) by colour and row parity, rows wrapping
// at ny and columns at half.  One thread updates one site in place: a
// phase reads only its own site of the colour it writes, so there is no
// race.
//
// Bitwise equal to the plain PyTorch versions: every float32 operation is
// written out with __fmul_rn / __fadd_rn / __fsub_rn (no FMA contraction)
// in the order of models/xy2d.py metropolis_update and of ops/trig.py
// cos_sin_2pi; expf is the CUDA math function torch.exp calls; constants
// are Python floats rounded once to float32, as the plain versions round
// them.
//
// Random words: key = the Philox key of the (sample, t, phase); counter =
// (replica, row, column, 0); word 0 gives u_cand, word 1 u_acc, each from
// its top 24 bits (ops/xy2d_pallas.draw_uniforms is the plain version).
//
// Sums of a measuring site, widened to float64: S_x and S_y of both
// colours (the updated site and the other colour's site at (y, i)), S·h
// (each bond once, from the updated colour's field) and, against the t=0
// snapshot (a Snap of its own, read only where A is taken), the float32
// terms S·S0 of both colours.  block_sums reduces them per block in a
// fixed order, the first three, or all four where there is a snapshot:
// no float atomics, so runs repeat bitwise.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace xy {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// (Σ S_x, Σ S_y, Σ S·h, Σ S·S0) a block
constexpr int NSUMS = 4;

// ops/trig.py constants, rounded once from the Python floats
constexpr float C0 = static_cast<float>(9.9999998075e-01);
constexpr float C1 = static_cast<float>(-1.2336977754e+00);
constexpr float C2 = static_cast<float>(2.5360837309e-01);
constexpr float C3 = static_cast<float>(-2.0438343895e-02);
constexpr float S0 = static_cast<float>(1.5707963234e+00);
constexpr float S1 = static_cast<float>(-6.4596361199e-01);
constexpr float S2 = static_cast<float>(7.9681932446e-02);
constexpr float S3 = static_cast<float>(-4.6074307448e-03);
constexpr float TINY = static_cast<float>(1e-30);

struct Phase {
  float* sx;               // (R, ny, half) colour updated, in place
  float* sy;
  const float* ox;         // the other colour
  const float* oy;
  int ny, half, color;
};

// The t=0 snapshot of the colour updated and of the other colour, read
// only by the launches that take A
struct Snap {
  const float* sx;
  const float* sy;
  const float* ox;
  const float* oy;
};

struct Sums {
  double mx, my, e, a;
};

// A shard of a domain-decomposed lattice (parallel/domain.py): the other
// colour's halos exchanged from its neighbours (parallel/halo.py), a
// component each, and its global offsets.  The shard holds rows row0 ..
// row0 + ny - 1 and columns col0 .. col0 + half - 1 of the colour planes;
// the halo kernels read it, the periodic ones never do.
struct Shard {
  const float* upx;  // (R, 1, half): the row above row 0
  const float* upy;
  const float* dnx;  // (R, 1, half): the row below the last
  const float* dny;
  const float* lfx;  // (R, ny, 1): the column left of column 0, or null
  const float* lfy;  // (periodic in x: the shard spans every column)
  const float* rtx;  // (R, ny, 1): the column right of the last, or null
  const float* rty;
  int rep0, row0, col0;
};

// (cos 2πu, sin 2πu): the quarter-period fold and polynomials of
// ops/trig.cos_sin_2pi, one rounding per operation in its order
__device__ __forceinline__ void cos_sin_2pi(float u, float& c, float& s) {
  const float a = __fmul_rn(u, 4.0f);
  const float n = floorf(__fadd_rn(a, 0.5f));
  const float r = __fsub_rn(a, n);
  const int m = static_cast<int>(n) & 3;
  const float w = __fmul_rn(r, r);
  const float cq = __fadd_rn(
      C0, __fmul_rn(w, __fadd_rn(C1, __fmul_rn(w, __fadd_rn(
                                          C2, __fmul_rn(w, C3))))));
  const float sq = __fmul_rn(
      r, __fadd_rn(S0, __fmul_rn(w, __fadd_rn(S1, __fmul_rn(w, __fadd_rn(
                                                      S2, __fmul_rn(w, S3)))))));
  const bool swap = (m & 1) == 1;
  c = swap ? -sq : cq;
  s = swap ? cq : sq;
  if (m >= 2) {
    c = -c;
    s = -s;
  }
}

// atan(t)/(2π) on |t| <= tan(π/8), ops/trig.py's _AT and _TAN_PI_8
constexpr float AT0 = static_cast<float>(1.5915465081e-01);
constexpr float AT1 = static_cast<float>(-5.3026171236e-02);
constexpr float AT2 = static_cast<float>(3.1232619285e-02);
constexpr float AT3 = static_cast<float>(-1.7416252601e-02);
constexpr float TAN_PI_8 = static_cast<float>(0.41421356237309503);
constexpr float ATAN_FLOOR = static_cast<float>(1e-37);

// atan2(y, x) in turns ∈ [-0.5, 0.5]: the half-octant reduction of
// ops/trig.atan2_2pi (one divide, rounded as torch's float32 division
// rounds), its degree-7 polynomial and octant fixups, one rounding per
// operation in its order; atan2_2pi(0, 0) = 0
__device__ __forceinline__ float atan2_2pi(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float num = fminf(ax, ay), den = fmaxf(ax, ay);
  const bool fold = num > __fmul_rn(TAN_PI_8, den);
  const float s1 = fold ? __fsub_rn(num, den) : num;
  const float s2 = fold ? __fadd_rn(num, den) : den;
  const float t = __fdiv_rn(s1, fmaxf(s2, ATAN_FLOOR));
  const float w = __fmul_rn(t, t);
  float r = __fmul_rn(
      t, __fadd_rn(AT0, __fmul_rn(w, __fadd_rn(AT1, __fmul_rn(w, __fadd_rn(
                                                      AT2, __fmul_rn(w, AT3)))))));
  if (fold) r = __fadd_rn(r, 0.125f);
  if (ay > ax) r = __fsub_rn(0.25f, r);
  if (x < 0.0f) r = __fsub_rn(0.5f, r);
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float u24(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f);
}

// A load of the other colour's planes: through the read-only data cache
// (NC) where nothing writes them during the launch (a one-phase launch),
// a plain load where a later phase of the same launch writes them.
template <bool NC>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (NC) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// The plane offsets of site w (< ny * half) of replica r of colour
// `color` and of its four other-colour neighbours: (y±1, i), the centre
// (y, i) = idx and the side column, rows wrapping at ny, columns at half.
struct Nbrs {
  size_t idx, up, dn, side;
};

__device__ __forceinline__ Nbrs neighbours(int ny, int half, int color,
                                           int r, int w) {
  const int y = w / half, i = w - y * half;
  const size_t base = static_cast<size_t>(r) * ny * half;
  const int yu = y == 0 ? ny - 1 : y - 1;
  const int yd = y == ny - 1 ? 0 : y + 1;
  // colour 0 on an odd row and colour 1 on an even row read column i + 1
  const bool plus = (color == 0) == ((y & 1) == 1);
  const int is = plus ? (i == half - 1 ? 0 : i + 1)
                      : (i == 0 ? half - 1 : i - 1);
  const size_t row = base + static_cast<size_t>(y) * half;
  Nbrs n;
  n.idx = row + i;
  n.up = base + static_cast<size_t>(yu) * half + i;
  n.dn = base + static_cast<size_t>(yd) * half + i;
  n.side = row + is;
  return n;
}

// Site (r, y, i) of this thread and its local field (hx, hy), built as
// (up + dn) + (centre + side); also the other colour's centre value.
struct Site {
  size_t idx;
  float hx, hy, cx, cy;
};

// The field of site w of a shard: the rows past its first and last and,
// with column halos, the columns past its edges from sh's halos; the side
// column by the global row's parity.
template <bool NC>
__device__ __forceinline__ Site load_site_halo(const Phase& p, int r, int w,
                                               const Shard& sh) {
  const int y = w / p.half, i = w - y * p.half;
  const size_t base = static_cast<size_t>(r) * p.ny * p.half;
  const size_t row = base + static_cast<size_t>(y) * p.half;
  const size_t hrow = static_cast<size_t>(r) * p.half + i;
  const size_t hcol = static_cast<size_t>(r) * p.ny + y;
  const bool plus = (p.color == 0) == (((sh.row0 + y) & 1) == 1);
  const int is = plus ? i + 1 : i - 1;
  const bool past = is < 0 || is >= p.half;
  const float* hx = plus ? sh.rtx : sh.lfx;
  const float* hy = plus ? sh.rty : sh.lfy;
  const size_t side = row + (is < 0 ? p.half - 1 : (is >= p.half ? 0 : is));
  Site s;
  s.idx = row + i;
  s.cx = ld<NC>(p.ox + s.idx);
  s.cy = ld<NC>(p.oy + s.idx);
  const float ux =
      y == 0 ? __ldg(sh.upx + hrow) : ld<NC>(p.ox + row - p.half + i);
  const float uy =
      y == 0 ? __ldg(sh.upy + hrow) : ld<NC>(p.oy + row - p.half + i);
  const float dx = y == p.ny - 1 ? __ldg(sh.dnx + hrow)
                                 : ld<NC>(p.ox + row + p.half + i);
  const float dy = y == p.ny - 1 ? __ldg(sh.dny + hrow)
                                 : ld<NC>(p.oy + row + p.half + i);
  const float sx =
      past && hx != nullptr ? __ldg(hx + hcol) : ld<NC>(p.ox + side);
  const float sy =
      past && hy != nullptr ? __ldg(hy + hcol) : ld<NC>(p.oy + side);
  s.hx = __fadd_rn(__fadd_rn(ux, dx), __fadd_rn(s.cx, sx));
  s.hy = __fadd_rn(__fadd_rn(uy, dy), __fadd_rn(s.cy, sy));
  return s;
}

template <bool NC, bool HALO = false>
__device__ __forceinline__ Site load_site(const Phase& p, int r, int w,
                                          const Shard& sh = Shard{}) {
  if constexpr (HALO) return load_site_halo<NC>(p, r, w, sh);
  const Nbrs n = neighbours(p.ny, p.half, p.color, r, w);
  Site s;
  s.idx = n.idx;
  s.cx = ld<NC>(p.ox + s.idx);
  s.cy = ld<NC>(p.oy + s.idx);
  s.hx = __fadd_rn(__fadd_rn(ld<NC>(p.ox + n.up), ld<NC>(p.ox + n.dn)),
                   __fadd_rn(s.cx, ld<NC>(p.ox + n.side)));
  s.hy = __fadd_rn(__fadd_rn(ld<NC>(p.oy + n.up), ld<NC>(p.oy + n.dn)),
                   __fadd_rn(s.cy, ld<NC>(p.oy + n.side)));
  return s;
}

// The float64 (Σ S_x, Σ S_y, S·h) of a site whose new spin is (fx, fy),
// A = 0.
__device__ __forceinline__ Sums site_sums(const Site& s, float fx, float fy) {
  Sums t;
  t.mx = static_cast<double>(fx) + static_cast<double>(s.cx);
  t.my = static_cast<double>(fy) + static_cast<double>(s.cy);
  t.e = static_cast<double>(
      __fadd_rn(__fmul_rn(fx, s.hx), __fmul_rn(fy, s.hy)));
  t.a = 0.0;
  return t;
}

// That site's A term against the snapshot: the float32 S·S0 of both
// colours, widened.  The snapshot is read-only in every launch.
__device__ __forceinline__ double snap_sum(const Snap& sn, const Site& s,
                                           float fx, float fy) {
  const float as = __fadd_rn(__fmul_rn(fx, __ldg(sn.sx + s.idx)),
                             __fmul_rn(fy, __ldg(sn.sy + s.idx)));
  const float ao = __fadd_rn(__fmul_rn(s.cx, __ldg(sn.ox + s.idx)),
                             __fmul_rn(s.cy, __ldg(sn.oy + s.idx)));
  return static_cast<double>(as) + static_cast<double>(ao);
}

// The two Philox words of site w of replica r: counter (replica, row,
// column, 0) under the phase key; word 0 and word 1
__device__ __forceinline__ uint4 site_words(int r, int w, int half,
                                            uint2 key) {
  const int y = w / half;
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                 static_cast<uint32_t>(w - y * half), 0u),
      key);
}

// (u_cand, u_acc) of site w (plane offset idx): injected (ucand/uacc
// non-null) or the top 24 bits of the site's Philox words 0 and 1
__device__ __forceinline__ void uniforms(int r, int w, int half, size_t idx,
                                         const float* ucand,
                                         const float* uacc, uint2 key,
                                         float& uc, float& ua) {
  if (ucand != nullptr) {
    uc = __ldg(ucand + idx);
    ua = __ldg(uacc + idx);
  } else {
    const uint4 b = site_words(r, w, half, key);
    uc = u24(b.x);
    ua = u24(b.y);
  }
}

// A site after its update: where it is, its field and its new spin
struct Update {
  Site s;
  float fx, fy;
};

// One Metropolis update of site w of replica r (w < ny * half): the
// candidate (cos 2πu, sin 2πu) replaces S iff u_acc < exp(-β max(ΔE, 0)).
// Uniforms injected (ucand/uacc non-null) or Philox words under ``key``.
// HALO: site w of a shard (load_site_halo), its Philox counter (rep0 + r,
// row0 + y, col0 + i, 0) the global site's, so a shard draws what the
// whole lattice draws.
template <bool NC, bool HALO = false>
__device__ __forceinline__ Update metropolis_site(const Phase& p, int r,
                                                  int w, const float* ucand,
                                                  const float* uacc,
                                                  float neg_beta, uint2 key,
                                                  const Shard& sh = Shard{}) {
  Update u;
  u.s = load_site<NC, HALO>(p, r, w, sh);
  const size_t idx = u.s.idx;
  float uc, ua;
  if constexpr (HALO) {
    if (ucand != nullptr) {
      uc = __ldg(ucand + idx);
      ua = __ldg(uacc + idx);
    } else {
      const int y = w / p.half;
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(sh.rep0 + r),
                     static_cast<uint32_t>(sh.row0 + y),
                     static_cast<uint32_t>(sh.col0 + w - y * p.half), 0u),
          key);
      uc = u24(b.x);
      ua = u24(b.y);
    }
  } else {
    uniforms(r, w, p.half, idx, ucand, uacc, key, uc, ua);
  }
  float cx, cy;
  cos_sin_2pi(uc, cx, cy);
  u.fx = p.sx[idx];
  u.fy = p.sy[idx];
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, u.fx), u.s.hx),
                              __fmul_rn(__fsub_rn(cy, u.fy), u.s.hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
  if (ua < prob) {
    u.fx = cx;
    u.fy = cy;
    p.sx[idx] = cx;
    p.sy[idx] = cy;
  }
  return u;
}

// The block's first N float64 sums (3 without A, NSUMS with it) into
// partials[(row * nblk + blk) * N ..]: warp shuffles, then warp 0's lanes
// in order; the same order every run.  Every thread of the block calls
// it; the address is formed inside the branch of the N storing threads
// (the relaxation's code, where it costs the other threads nothing).
// AGAIN: the block calls it again in the same launch, so it ends with a
// barrier before the next call rewrites `red` (a one-phase launch skips
// that barrier).
template <int N, bool AGAIN = false>
__device__ __forceinline__ void block_sums(double* partials, size_t row,
                                           unsigned nblk, unsigned blk,
                                           const Sums& t) {
  __shared__ double red[N][WARPS];
  const double all[NSUMS] = {t.mx, t.my, t.e, t.a};
  double v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = all[k];
  // the N sums' shuffles interleaved at each offset, not one sum after
  // the other: N independent chains instead of one N times as long
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] += __shfl_down_sync(0xFFFFFFFFu, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[threadIdx.x][k];
    partials[(row * nblk + blk) * N + threadIdx.x] = s;
  }
  if (AGAIN) __syncthreads();
}

// obs[row] = (Σ S_x, Σ S_y, -Σ S·h[, Σ S·S0]) from the row's nblk block
// partials (rows of nblk x N float64): one block a row, thread t adds
// blocks t, t + THREADS, ... in order, then a fixed tree over the threads.
template <int N>
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const double* partials, double* obs, int nblk) {
  __shared__ double red[N][THREADS];
  const int row = blockIdx.x;
  const double* part = partials + static_cast<size_t>(row) * nblk * N;
  double t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = 0.0;
  for (int b = threadIdx.x; b < nblk; b += THREADS) {
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] += part[b * N + k];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) red[k][threadIdx.x] = t[k];
  __syncthreads();
  for (int half = THREADS / 2; half; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      obs[row * N + k] = k == 2 ? -red[k][0] : red[k][0];
  }
}

inline int check_shape(int nrep, int ny, int half) {
  if (nrep < 1 || nrep > 65535 || ny < 2 || half < 1 ||
      static_cast<long long>(ny) * half >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace xy
