// Periodic XY phases on float32 angle planes (turns, θ/2π in [-0.5, 0.5))
// on Hopper (sm_90a): the kernels of the periodic XY angle engine, on the
// relaxation (Metropolis only or with over-relaxation) and on the streamed
// disorder protocols.
//
//   angle_metro_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                      xy2d_pallas_angle.py:_angle_metro_kernel
//                      (pallas_call at :267, _angle_metro_phase): one
//                      colour phase of the angle plane s from the other
//                      colour's o, decoded with cos_sin_2pi; the candidate
//                      angle u - 0.5 accepted iff u' < exp(-β max(ΔE, 0));
//                      uniforms from Philox or injected; optionally the
//                      fused (Σ S_x, Σ S_y, e); a decode-once tile a block
//                      (below).  Its snapshot mode, angle_metro_snap_kernel
//                      (the same tiles, angle_tiles<4>), replaces
//                      _angle_metro_snap_kernel (:405,
//                      _angle_metro_snap_phase -> sweep_measure_snap_angle):
//                      the same phase with A = Σ cos 2π(θ - θ0) of both
//                      colours against the t=0 angle snapshots fused beside
//                      the sums;
//   angle_or_kernel    replaces _angle_or_kernel (:300, _angle_or_phase):
//                      θ' = 2 atan2_2pi(h_y, h_x) - θ, wrapped by
//                      tp - rint(tp), the same sums optional; the same
//                      decode-once tiles (angle_tiles<3, true, .>);
//   reduce_kernel      (xy2d_site.cuh) adds the per-block float64 sums of a
//                      measuring launch per replica in a fixed order.
//
// Layout, neighbours, random words and the sums' reduction: xy2d_site.cuh,
// on (R, ny, nx/2) angle planes (the JAX engine's 128-lane pad and seam
// substitution are TPU layout).  A phase updates its colour in place.
// Per-site arithmetic in the order of the plain versions of
// ops/xy2d_pallas_angle.py, one rounding per operation (rintf rounds half
// to even, as torch.round and jnp.round do).
//
// Both kernels decode the other colour once a tile, the design of the
// helical angle phase (xy2d_helical_dense_angle.cu angle_tile_kernel) on
// the periodic layout.  A block owns TX columns of the colour's
// half-plane x TY rows and walks its column of tiles (grid (column tiles,
// row blocks, replicas), at most ops/xy2d_pallas_angle.MAX_TILE_BLOCKS
// blocks a replica, so a measuring launch leaves few partials for
// reduce_kernel): it loads the other colour's rows y0 - 1 .. y0 + TY
// (wrapping at ny) and columns x0 - 1 .. x0 + TX (wrapping at half, with
// no seam), all before the first decode, decodes each angle once into
// shared memory as (cos, sin), loads its own angles, and after the
// barrier each thread takes its four neighbours from there, the side
// column by the row's parity, and adds them in the plain version's order,
// (up + dn) + (centre + side): the one-thread-a-site field bit for bit.
// That is (TY + 2)(TX + 2) / (TY TX) = 1.13 decodes of other angles a site
// where one thread a site decoded four, and no runtime division: the tile
// gives the site's (y, i), its Philox counter (r, y, i, 0) and 32-bit
// offsets inside a replica.  Ragged tiles (half or ny not a multiple of
// 32, half < 32, ny = 2) run: a slot past the plane is neither updated
// nor counted.  The first angle_or_kernel ran one thread a site, each
// decoding its four neighbours itself (xy::neighbours' runtime division
// included), and left ny * half / 256 partials a replica (PERF.md §6).
//
// Bound on the H100.  Per site of the colour updated a phase reads 4 B of
// its own angle and 4 B of the other colour and writes 4 B: 12 B (0.48 GB,
// 0.143 ms at 3.35 TB/s, at 2000x2000 x 32); the snapshot mode reads 8 B
// more.  The function needs ~154 32-bit operations a Metropolis site (one
// Philox4x32-10 call; three decodes: the site, the candidate and each
// other-colour angle once; expf): operations bind Metropolis, bytes the
// over-relaxation (one decode and atan2_2pi, ~62 a site).
#include "xy2d_site.cuh"

namespace {

using xy::Sums;
using xy::THREADS;

// angle_metro_kernel's tile: TX columns x TY rows, four sites a thread
constexpr int TX = 32, TY = 32;

struct AnglePhase {
  float* s;         // (R, ny, half) colour updated, turns, in place
  const float* o;   // the other colour
  int ny, half, color;
};

// The raw other-colour angles of the tile at (x0, y0) that thread t
// decodes: elements k = t + j THREADS of its (rows y0 - 1 .. y0 +
// min(TY, ny - y0), wrapping at ny) x (columns x0 - 1 .. x0 + TX, wrapping
// at half) grid.  A column past half after one wrap (half < TX + 1) is
// read by no site and loads 0.  No load waits on another: all are in
// flight before the first decode.
template <int LOADS>
__device__ __forceinline__ void fetch_tile(const float* o, int ny, int half,
                                           int x0, int y0,
                                           float (&v)[LOADS]) {
  constexpr int SW = TX + 2;
  const int nload = (min(TY, ny - y0) + 2) * SW;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int k = threadIdx.x + j * THREADS;
    const int ry = k / SW;
    int xx = x0 - 1 + (k - ry * SW);
    xx = xx < 0 ? xx + half : (xx >= half ? xx - half : xx);
    int yy = y0 - 1 + ry;
    yy = yy < 0 ? yy + ny : (yy >= ny ? yy - ny : yy);
    v[j] = k < nload && xx < half ? __ldg(o + yy * half + xx) : 0.0f;
  }
}

// One Metropolis phase (OR false) or over-relaxation phase (OR true), N
// sums a block where it measures: 3, or 4 in the Metropolis snapshot mode
// (A against sns, the snapshot of the colour updated, and sno, the
// other's; the 3-sum instantiations never read them).  Tiles of TX x TY
// sites: grid (ceil(half / TX), row blocks, R); block (bx, by) takes tile
// rows by, by + gridDim.y, ... of column tile bx.  A tile's raw angles
// are all loaded, then decoded into shared memory, and each thread's own
// angles loaded before the barrier.  The over-relaxation takes no
// uniforms (ucand, uacc null).  SUMS: -1 measures where partials is
// given (the Metropolis kernels); 0 or 1 fixes it at compile time (the
// over-relaxation's two kernels), so its plain phase carries no sums.
template <int N, bool OR = false, int SUMS = -1>
__device__ __forceinline__ void angle_tiles(const AnglePhase& p,
                                            double* partials,
                                            const float* ucand,
                                            const float* uacc,
                                            float neg_beta, uint2 key,
                                            const float* sns,
                                            const float* sno) {
  constexpr int SW = TX + 2, SH = TY + 2, ROWS = THREADS / TX;
  constexpr int LOADS = (SH * SW + THREADS - 1) / THREADS;
  constexpr int SITES = TY / ROWS;
  static_assert(THREADS % TX == 0 && TY % ROWS == 0, "tile shape");
  static_assert(!OR || N == 3, "the over-relaxation sums three");
  __shared__ float2 tile[SH * SW];
  const bool measuring = SUMS < 0 ? partials != nullptr : SUMS == 1;
  const int ny = p.ny, half = p.half, r = blockIdx.z;
  const size_t base = static_cast<size_t>(r) * ny * half;
  float* s = p.s + base;
  const float* o = p.o + base;
  if (ucand != nullptr) {
    ucand += base;
    uacc += base;
  }
  if constexpr (N > 3) {
    sns += base;
    sno += base;
  }
  const int x0 = blockIdx.x * TX;
  const int tx = threadIdx.x % TX, ty0 = threadIdx.x / TX, i = x0 + tx;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int y0 = blockIdx.y * TY; y0 < ny; y0 += gridDim.y * TY) {
    float raw[LOADS];
    fetch_tile(o, ny, half, x0, y0, raw);
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
      own[j] = y < ny && i < half ? s[y * half + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SITES; ++j) {
      const int ty = ty0 + j * ROWS;
      const int y = y0 + ty;
      if (y < ny && i < half) {
        // the other colour's centre (y, i) and its four neighbours of
        // site (y, i): (y -+ 1, i) and the side column, i + 1 for colour
        // 0 on an odd row and colour 1 on an even row, else i - 1
        const float2* c = tile + (ty + 1) * SW + (tx + 1);
        const bool plus = (p.color == 0) == ((y & 1) == 1);
        const float2 up = c[-SW], dn = c[SW], ce = c[0];
        const float2 sd = plus ? c[1] : c[-1];
        const float hx =
            __fadd_rn(__fadd_rn(up.x, dn.x), __fadd_rn(ce.x, sd.x));
        const float hy =
            __fadd_rn(__fadd_rn(up.y, dn.y), __fadd_rn(ce.y, sd.y));
        const int idx = y * half + i;
        float th, fx = 0.0f, fy = 0.0f;
        if constexpr (OR) {
          const float phi = xy::atan2_2pi(hy, hx);
          th = __fsub_rn(__fmul_rn(2.0f, phi), own[j]);
          th = __fsub_rn(th, rintf(th));
          s[idx] = th;
          if (measuring) xy::cos_sin_2pi(th, fx, fy);
        } else {
          float uc, ua;
          if (ucand != nullptr) {
            uc = __ldg(ucand + idx);
            ua = __ldg(uacc + idx);
          } else {
            const uint4 b = philox4x32_10(
                make_uint4(static_cast<uint32_t>(r),
                           static_cast<uint32_t>(y),
                           static_cast<uint32_t>(i), 0u),
                key);
            uc = xy::u24(b.x);
            ua = xy::u24(b.y);
          }
          th = own[j];
          float cx, cy;
          xy::cos_sin_2pi(th, fx, fy);
          const float cand = __fsub_rn(uc, 0.5f);
          xy::cos_sin_2pi(cand, cx, cy);
          const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), hx),
                                      __fmul_rn(__fsub_rn(cy, fy), hy));
          const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
          if (ua < prob) {
            fx = cx;
            fy = cy;
            th = cand;
            s[idx] = cand;
          }
        }
        if (measuring) {  // uniform
          t.mx += static_cast<double>(fx) + static_cast<double>(ce.x);
          t.my += static_cast<double>(fy) + static_cast<double>(ce.y);
          t.e += static_cast<double>(
              __fadd_rn(__fmul_rn(fx, hx), __fmul_rn(fy, hy)));
          if constexpr (N > 3) {
            float ca, cb, unused;
            xy::cos_sin_2pi(__fsub_rn(th, __ldg(sns + idx)), ca, unused);
            xy::cos_sin_2pi(__fsub_rn(__ldg(o + idx), __ldg(sno + idx)), cb,
                            unused);
            t.a += static_cast<double>(ca) + static_cast<double>(cb);
          }
        }
      }
    }
    __syncthreads();
  }
  if (measuring)  // uniform
    xy::block_sums<N>(partials, r, gridDim.x * gridDim.y,
                      blockIdx.y * gridDim.x + blockIdx.x, t);
}

// The Metropolis phase (angle_tiles<3>): fastest unbounded (58
// registers, four blocks an SM).
__global__ void __launch_bounds__(THREADS)
    angle_metro_kernel(AnglePhase p, double* partials, const float* ucand,
                       const float* uacc, float neg_beta, uint2 key) {
  angle_tiles<3>(p, partials, ucand, uacc, neg_beta, key, nullptr, nullptr);
}

// Its snapshot mode (angle_tiles<4>), held to five blocks an SM (48
// registers; unbounded it took 71, three blocks, and read slower at
// 1000^2 x 20).
__global__ void __launch_bounds__(THREADS, 5)
    angle_metro_snap_kernel(AnglePhase p, double* partials,
                            const float* ucand, const float* uacc,
                            float neg_beta, uint2 key, const float* sns,
                            const float* sno) {
  angle_tiles<xy::NSUMS>(p, partials, ucand, uacc, neg_beta, key, sns,
                         sno);
}

// The over-relaxation phase (angle_tiles<3, true, MEASURE>), its sums a
// compile-time choice
template <bool MEASURE>
__global__ void __launch_bounds__(THREADS)
    angle_or_kernel(AnglePhase p, double* partials) {
  angle_tiles<3, true, MEASURE>(p, partials, nullptr, nullptr, 0.0f,
                                make_uint2(0u, 0u), nullptr, nullptr);
}

AnglePhase make_phase(void* s, const void* o, int ny, int half, int color) {
  AnglePhase p;
  p.s = static_cast<float*>(s);
  p.o = static_cast<const float*>(o);
  p.ny = ny;
  p.half = half;
  p.color = color;
  return p;
}

template <int N>
int finish(void* partials, void* obs, int nrep, int nblk, cudaStream_t st) {
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || partials == nullptr) return code;
  xy::reduce_kernel<N><<<nrep, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, half) angle planes,
// s in place: 32 x 32 tiles, grid (ceil(half / 32), row_blocks, nrep) of
// 256 threads.  ucand/uacc are injected uniforms, or both null for Philox
// words under (s0, s1).  With partials ((nrep, blocks, 3) float64, blocks
// = ceil(half / 32) * row_blocks) and obs ((nrep, 3) float64) non-null the
// launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills obs; with
// sns/sno, the t=0 angle snapshots of the colour updated and of the
// other, partials (nrep, blocks, 4) and obs (nrep, 4) take A too.
int xya_metro(void* s, const void* o, const void* ucand, const void* uacc,
              const void* sns, const void* sno, void* partials, void* obs,
              int nrep, int ny, int half, int row_blocks, int color,
              float neg_beta, unsigned int s0, unsigned int s1,
              void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  const long long gx = (static_cast<long long>(half) + TX - 1) / TX;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr) ||
      (sns == nullptr) != (sno == nullptr) ||
      (sns != nullptr && partials == nullptr) || row_blocks < 1 ||
      row_blocks > 65535 || gx * row_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const AnglePhase p = make_phase(s, o, ny, half, color);
  const int nblk = static_cast<int>(gx * row_blocks);
  const dim3 grid(static_cast<unsigned>(gx), row_blocks, nrep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  double* part = static_cast<double*>(partials);
  const float* ss = static_cast<const float*>(sns);
  const float* so = static_cast<const float*>(sno);
  if (sns != nullptr) {
    angle_metro_snap_kernel<<<grid, THREADS, 0, st>>>(
        p, part, uc, ua, neg_beta, make_uint2(s0, s1), ss, so);
    return finish<xy::NSUMS>(partials, obs, nrep, nblk, st);
  }
  angle_metro_kernel<<<grid, THREADS, 0, st>>>(p, part, uc, ua, neg_beta,
                                               make_uint2(s0, s1));
  return finish<3>(partials, obs, nrep, nblk, st);
}

// One over-relaxation phase of colour `color` on angle planes, s in place:
// the tiles and grid of xya_metro; partials/obs as there without a
// snapshot.
int xya_or(void* s, const void* o, void* partials, void* obs, int nrep,
           int ny, int half, int row_blocks, int color, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  const long long gx = (static_cast<long long>(half) + TX - 1) / TX;
  if ((partials == nullptr) != (obs == nullptr) || row_blocks < 1 ||
      row_blocks > 65535 || gx * row_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = static_cast<int>(gx * row_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(gx), row_blocks, nrep);
  const AnglePhase p = make_phase(s, o, ny, half, color);
  if (partials != nullptr)
    angle_or_kernel<true><<<grid, THREADS, 0, st>>>(
        p, static_cast<double*>(partials));
  else
    angle_or_kernel<false><<<grid, THREADS, 0, st>>>(p, nullptr);
  return finish<3>(partials, obs, nrep, nblk, st);
}

const char* xya_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
