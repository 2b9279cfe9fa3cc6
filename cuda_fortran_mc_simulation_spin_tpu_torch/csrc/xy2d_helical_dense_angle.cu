// Helical XY (odd nx) phases on Hopper (sm_90a), float32 angle planes in
// turns: the kernels of the helical XY relaxation on the default (angle)
// engine, Metropolis only and with over-relaxation.
//
//   angle_tile_kernel<false, .>  replaces cuda_fortran_mc_simulation_spin_
//                      tpu/ops/xy2d_helical_dense_angle.py:
//                      _angle_phase_kernel (pallas_call at :269,
//                      _angle_phase): one colour phase of the angle plane
//                      s from the other colour's o, decoded with
//                      cos_sin_2pi; the candidate angle u - 0.5 accepted
//                      iff u' < exp(-β max(ΔE, 0)); uniforms from Philox
//                      or injected; optionally the fused (Σ S_x, Σ S_y, e);
//   angle_tile_kernel<true, .>   replaces _angle_or_kernel (:308,
//                      _angle_or_phase): θ' = 2 atan2_2pi(h_y, h_x) - θ,
//                      wrapped by tp - rint(tp), the same sums optional;
//   atan2_kernel       the device atan2_2pi over a vector, for holding it
//                      against ops/trig.atan2_2pi (no path launches it).
//
// Layout and neighbours: xy2d_helical_dense.cuh; per-site arithmetic in the
// order of the plain versions of ops/xy2d_helical_dense_angle.py, one
// rounding per operation (rintf rounds half to even, as torch.round and
// jnp.round do).
//
// Bound on the H100: operations (Metropolis) or bytes (over-relaxation).
// Per site of the colour updated a phase reads 4 B of its own angle and
// 4 B of the other colour and writes 4 B: 12 B, 0.6 GB at 10001x10000 x 1
// (0.179 ms at 3.35 TB/s).  The function needs ~154 32-bit operations a
// Metropolis site (one Philox4x32-10 call; three cos_sin_2pi decodes: the
// site, the candidate and each other-colour angle once; expf: 0.230 ms at
// 33.4 T/s) and ~62 an over-relaxation site (one decode and atan2_2pi:
// 0.093 ms).
//
// Both phases decode the other colour once a tile, as the TPU kernels
// decode a tile and roll it.  A block owns TX slots x TY rows and walks
// its column of tiles (grid (column tiles, row blocks, replicas)): it
// loads the other colour's rows y0 - 1 .. y0 + TY (wrapping at ny) and
// columns x0 - 1 .. x0 + TX, decodes each angle once into shared memory
// as (cos, sin), then each thread takes its four neighbours from there
// and adds them in the plain version's order, ((up + dn) + left) + right,
// so the field is the one-thread-a-site field bit for bit.  The helical
// seams (a long row's x = 0 reads the up-row's column nc - 1, its
// x = nx - 1 the down-row's column 0) are read and decoded by the one
// thread that needs them; a short row's ragged slot is neither updated
// nor counted, as in dense_slot.  That is (TY + 2)(TX + 2) / (TY TX)
// decodes of other angles a site: 1.13 at the 32 x 32 tile, where one
// thread a site decoded four (and a measuring OR site a fifth), and no
// runtime division: 32-bit offsets inside a replica.  32 x 32 halos the
// fewest angles a site and read 0.8% ahead of 64 x 16 and 7% ahead of
// 128 x 8 (PERF.md §6).  A Metropolis site decodes its own angle and the
// candidate; an OR site decodes nothing of its own but, measuring, its
// new angle.  The measuring launch takes the other colour's (S_x, S_y)
// from the decoded tile.  Sums in float64, per block in a fixed order,
// then per replica by reduce_kernel.
#include "xy2d_helical_dense.cuh"

namespace {

using xy::Sums;
using xyh::THREADS;

// a tile: TX slots x TY rows, four sites a thread
constexpr int TX = 32, TY = 32;

struct AnglePlanes {
  float* s;         // (R, ny, nc) colour updated, turns, in place
  const float* o;   // the other colour
  int ny, nc, color;
};

// The field of a valid slot (y, i) of a tile, c pointing at the decoded
// other colour's (y, i), whose rows are sw apart: ((up + dn) + left) +
// right per component; the helical seams decoded from o
__device__ __forceinline__ void tile_field(const float* o, const float2* c,
                                           int sw, int ny, int nc, int y,
                                           int i, bool long_row, float& hx,
                                           float& hy) {
  const float2 up = c[-sw], dn = c[sw];
  float2 lf = long_row ? c[-1] : c[0];
  float2 rt = long_row ? c[0] : c[1];
  if (long_row && i == 0) {
    const int yu = y == 0 ? ny - 1 : y - 1;
    xy::cos_sin_2pi(__ldg(o + yu * nc + (nc - 1)), lf.x, lf.y);
  }
  if (long_row && i == nc - 1) {
    const int yd = y == ny - 1 ? 0 : y + 1;
    xy::cos_sin_2pi(__ldg(o + yd * nc), rt.x, rt.y);
  }
  hx = __fadd_rn(__fadd_rn(__fadd_rn(up.x, dn.x), lf.x), rt.x);
  hy = __fadd_rn(__fadd_rn(__fadd_rn(up.y, dn.y), lf.y), rt.y);
}

// One Metropolis site (y, i) of a tile: c points at the decoded other
// colour's (y, i) in the tile, whose rows are SW apart.
template <bool MEASURE>
__device__ __forceinline__ void tile_site(const AnglePlanes& p, float* s,
                                          const float* o, const float2* c,
                                          int sw, int r, int y, int i,
                                          float own, const float* ucand,
                                          const float* uacc, float neg_beta,
                                          uint2 key, Sums& t) {
  const int ny = p.ny, nc = p.nc;
  const bool long_row = (p.color == 0) == ((y & 1) == 0);
  if (MEASURE && i < (long_row ? nc - 1 : nc)) {
    t.mx += static_cast<double>(c->x);
    t.my += static_cast<double>(c->y);
  }
  if (i >= (long_row ? nc : nc - 1)) return;
  float hx, hy;
  tile_field(o, c, sw, ny, nc, y, i, long_row, hx, hy);
  const int idx = y * nc + i;
  float uc, ua;
  if (ucand != nullptr) {
    uc = __ldg(ucand + idx);
    ua = __ldg(uacc + idx);
  } else {
    const uint4 b = philox4x32_10(
        make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                   static_cast<uint32_t>(i), 0u),
        key);
    uc = xy::u24(b.x);
    ua = xy::u24(b.y);
  }
  float fx, fy, cx, cy;
  xy::cos_sin_2pi(own, fx, fy);
  const float cand = __fsub_rn(uc, 0.5f);
  xy::cos_sin_2pi(cand, cx, cy);
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), hx),
                              __fmul_rn(__fsub_rn(cy, fy), hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
  if (ua < prob) {
    fx = cx;
    fy = cy;
    s[idx] = cand;
  }
  if (MEASURE) {
    t.mx += static_cast<double>(fx);
    t.my += static_cast<double>(fy);
    t.e += xyh::bond_sum(fx, fy, hx, hy);
  }
}

// One over-relaxation site (y, i) of a tile, as tile_site: the reflection
// θ' = 2 atan2_2pi(h_y, h_x) - θ of its own angle `own`, wrapped
template <bool MEASURE>
__device__ __forceinline__ void tile_or_site(const AnglePlanes& p, float* s,
                                             const float* o, const float2* c,
                                             int sw, int y, int i, float own,
                                             Sums& t) {
  const int ny = p.ny, nc = p.nc;
  const bool long_row = (p.color == 0) == ((y & 1) == 0);
  if (MEASURE && i < (long_row ? nc - 1 : nc)) {
    t.mx += static_cast<double>(c->x);
    t.my += static_cast<double>(c->y);
  }
  if (i >= (long_row ? nc : nc - 1)) return;
  float hx, hy;
  tile_field(o, c, sw, ny, nc, y, i, long_row, hx, hy);
  const float phi = xy::atan2_2pi(hy, hx);
  float tp = __fsub_rn(__fmul_rn(2.0f, phi), own);
  tp = __fsub_rn(tp, rintf(tp));
  s[y * nc + i] = tp;
  if (MEASURE) {
    float fx, fy;
    xy::cos_sin_2pi(tp, fx, fy);
    t.mx += static_cast<double>(fx);
    t.my += static_cast<double>(fy);
    t.e += xyh::bond_sum(fx, fy, hx, hy);
  }
}

// The raw other-colour angles of the tile at row y0 that thread t decodes:
// elements k = t + j THREADS of its (rows y0 - 1 .. y0 + min(TY, ny - y0),
// wrapping at ny) x (columns x0 - 1 .. x0 + TX) grid, 0 outside [0, nc).
// No load waits on another: all are in flight before the first decode.
template <int LOADS>
__device__ __forceinline__ void fetch_tile(const float* o, int ny, int nc,
                                           int x0, int y0,
                                           float (&v)[LOADS]) {
  constexpr int SW = TX + 2;
  const int nload = (min(TY, ny - y0) + 2) * SW;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int k = threadIdx.x + j * THREADS;
    const int ry = k / SW, xx = x0 - 1 + (k - ry * SW);
    int yy = y0 - 1 + ry;
    yy = yy < 0 ? yy + ny : (yy >= ny ? yy - ny : yy);
    v[j] = k < nload && xx >= 0 && xx < nc ? __ldg(o + yy * nc + xx) : 0.0f;
  }
}

// One Metropolis (OR false) or over-relaxation (OR true) phase, a tile
// TX slots x TY rows: grid (ceil(nc / TX), row blocks, R); block (bx, by)
// takes tile rows by, by + gridDim.y, ... of column tile bx.  A tile's raw
// angles are all loaded, then decoded into shared memory, and each
// thread's own angles loaded before the barrier: a load that waits for the
// decode of the one before stalls each warp once per load (PERF.md §6).
// The over-relaxation takes no uniforms (ucand, uacc null).
template <bool OR, bool MEASURE>
__global__ void __launch_bounds__(THREADS)
    angle_tile_kernel(AnglePlanes p, double* partials, const float* ucand,
                      const float* uacc, float neg_beta, uint2 key) {
  constexpr int SW = TX + 2, SH = TY + 2, ROWS = THREADS / TX;
  constexpr int LOADS = (SH * SW + THREADS - 1) / THREADS;
  constexpr int SITES = TY / ROWS;
  static_assert(THREADS % TX == 0 && TY % ROWS == 0, "tile shape");
  __shared__ float2 tile[SH * SW];
  const int ny = p.ny, nc = p.nc, r = blockIdx.z;
  const size_t base = static_cast<size_t>(r) * ny * nc;
  float* s = p.s + base;
  const float* o = p.o + base;
  if (ucand != nullptr) {
    ucand += base;
    uacc += base;
  }
  const int x0 = blockIdx.x * TX;
  const int tx = threadIdx.x % TX, ty0 = threadIdx.x / TX, i = x0 + tx;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int y0 = blockIdx.y * TY; y0 < ny; y0 += gridDim.y * TY) {
    float raw[LOADS];
    fetch_tile(o, ny, nc, x0, y0, raw);
    const int nload = (min(TY, ny - y0) + 2) * SW;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < nload) {
        float2 v;
        xy::cos_sin_2pi(raw[j], v.x, v.y);
        tile[k] = v;
      }
    }
    float own[SITES];
#pragma unroll
    for (int j = 0; j < SITES; ++j) {
      const int y = y0 + ty0 + j * ROWS;
      own[j] = y < ny && i < nc ? s[y * nc + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SITES; ++j) {
      const int ty = ty0 + j * ROWS;
      const int y = y0 + ty;
      if (y < ny && i < nc) {
        const float2* c = tile + (ty + 1) * SW + (tx + 1);
        if constexpr (OR)
          tile_or_site<MEASURE>(p, s, o, c, SW, y, i, own[j], t);
        else
          tile_site<MEASURE>(p, s, o, c, SW, r, y, i, own[j], ucand, uacc,
                             neg_beta, key, t);
      }
    }
    __syncthreads();
  }
  if (MEASURE)
    xy::block_sums<3>(partials, r, gridDim.x * gridDim.y,
                      blockIdx.y * gridDim.x + blockIdx.x, t);
}

__global__ void __launch_bounds__(THREADS)
    atan2_kernel(const float* y, const float* x, float* out, long long n) {
  for (long long k = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       k < n; k += static_cast<long long>(gridDim.x) * THREADS)
    out[k] = xy::atan2_2pi(y[k], x[k]);
}

AnglePlanes make_planes(void* s, const void* o, int ny, int nc, int color) {
  AnglePlanes p;
  p.s = static_cast<float*>(s);
  p.o = static_cast<const float*>(o);
  p.ny = ny;
  p.nc = nc;
  p.color = color;
  return p;
}

// The shape and grid of a tile launch: the grid's blocks a replica must
// fit an int (the partials' rows)
int tile_args(int nrep, int ny, int nc, int row_blocks, const void* partials,
              const void* obs) {
  if (int bad = xy::check_shape(nrep, ny, nc)) return bad;
  const long long gx = (static_cast<long long>(nc) + TX - 1) / TX;
  if (ny % 2 != 0 || nc < 2 || row_blocks < 1 || row_blocks > 65535 ||
      (partials == nullptr) != (obs == nullptr) ||
      gx * row_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, nc) angle planes,
// s in place: 32 x 32 tiles, grid (ceil(nc / 32), row_blocks, nrep) of
// 256 threads.  ucand/uacc are injected uniforms, or both null for Philox
// words under (s0, s1).  With
// partials ((nrep, ceil(nc / 32) * row_blocks, 3) float64) and obs
// ((nrep, 3) float64) non-null the launch measures (Σ S_x, Σ S_y, e) and
// reduce_kernel fills obs.
int xya_phase(void* s, const void* o, const void* ucand, const void* uacc,
              void* partials, void* obs, int nrep, int ny, int nc,
              int row_blocks, int color,
              float neg_beta, unsigned int s0, unsigned int s1,
              void* stream) {
  if (int bad = tile_args(nrep, ny, nc, row_blocks, partials, obs))
    return bad;
  if ((ucand == nullptr) != (uacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (static_cast<long long>(nc) + TX - 1) / TX;
  const dim3 grid(static_cast<unsigned>(gx), row_blocks, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AnglePlanes p = make_planes(s, o, ny, nc, color);
  double* part = static_cast<double*>(partials);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  const uint2 key = make_uint2(s0, s1);
  if (partials != nullptr)
    angle_tile_kernel<false, true><<<grid, THREADS, 0, st>>>(
        p, part, uc, ua, neg_beta, key);
  else
    angle_tile_kernel<false, false><<<grid, THREADS, 0, st>>>(
        p, part, uc, ua, neg_beta, key);
  return xyh::finish(partials, obs, nrep, static_cast<int>(gx * row_blocks),
                     st);
}

// One over-relaxation phase of colour `color` on (nrep, ny, nc) angle
// planes, s in place, on the tiles and grid of xya_phase; partials/obs as
// for xya_phase.
int xya_over_relax(void* s, const void* o, void* partials, void* obs,
                   int nrep, int ny, int nc, int row_blocks, int color,
                   void* stream) {
  if (int bad = tile_args(nrep, ny, nc, row_blocks, partials, obs))
    return bad;
  const dim3 grid((nc + TX - 1) / TX, row_blocks, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AnglePlanes p = make_planes(s, o, ny, nc, color);
  double* part = static_cast<double*>(partials);
  const uint2 key = make_uint2(0u, 0u);
  if (partials != nullptr)
    angle_tile_kernel<true, true><<<grid, THREADS, 0, st>>>(
        p, part, nullptr, nullptr, 0.0f, key);
  else
    angle_tile_kernel<true, false><<<grid, THREADS, 0, st>>>(
        p, part, nullptr, nullptr, 0.0f, key);
  return xyh::finish(partials, obs, nrep, static_cast<int>(grid.x) *
                                              row_blocks, st);
}

// out[k] = atan2_2pi(y[k], x[k]) for k < n (float32 vectors).
int xya_atan2(const void* y, const void* x, void* out, long long n,
              void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  atan2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* xyh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
