// Periodic XY (planar rotor) phases on Hopper (sm_90a): the kernels of the
// periodic XY relaxation main path, with and without over-relaxation.
//
//   metropolis_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     xy2d_pallas.py:_metropolis_kernel (pallas_call at
//                     :226, _metropolis_phase): one colour phase of the
//                     float32 component planes, the candidate
//                     (cos 2πu, sin 2πu) accepted iff u' < exp(-β max(ΔE, 0));
//                     uniforms from Philox or injected;
//   over_relax_kernel replaces _over_relax_kernel (:265, _over_relax_phase):
//                     S' = 2(S·n̂)n̂ - S about the normalised local field,
//                     then S' / |S'|;
//   reduce_kernel     adds the per-block float64 sums of a measuring launch
//                     per replica in a fixed order.
//
// Layout (ops/xy2d_pallas.py): (R, ny, half) float32 planes, colour 0 at
// (y, 2i + (y & 1)); a site's neighbours are the other colour's (y±1, i),
// (y, i) and (y, i-1) or (y, i+1) by colour and row parity, rows wrapping
// at ny and columns at half (the JAX engine's 128-lane pad and seam
// substitution are TPU layout).  One thread updates one site in place: a
// phase reads only its own site of the colour it writes, so there is no
// race.  Neighbour reuse comes from L1/L2.
//
// Bitwise equal to the plain PyTorch version: every float32 operation is
// written out with __fmul_rn / __fadd_rn / __fsub_rn (no FMA contraction)
// in the order of models/xy2d.py metropolis_update / reflect and of
// ops/trig.py cos_sin_2pi; expf and rsqrtf are the CUDA math functions
// that torch.exp and torch.rsqrt call; constants are Python floats
// rounded once to float32, as the plain version rounds them.
//
// Random words: key = the Philox key of the (sample, t, phase); counter =
// (replica, row, column, 0); word 0 gives u_cand, word 1 u_acc, each from
// its top 24 bits (ops/xy2d_pallas.draw_uniforms is the plain version).
//
// Sums: a measuring launch widens each site's float32 S_x, S_y (of both
// colours: the updated site and the other colour's site at (y, i)) and
// S·h to float64, reduces them per block in a fixed order and writes the
// block's three partials; reduce_kernel adds those per replica in a fixed
// order.  No float atomics, so runs repeat bitwise.
//
// Bound on the H100: bytes.  Per site of the colour updated a phase reads
// 8 B of its own, 8 B of the other colour (each other-colour site is a
// neighbour of four) and writes 8 B: 24 B, 1.536 GB at the main path's
// 4000x4000 x 8 (0.459 ms at 3.35 TB/s), against ~80 float32 and integer
// operations a site (one Philox4x32-10 call, the trig polynomial, expf).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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
  double* partials;        // (R, gridDim.x, 3) block sums, or null
  int ny, half, color;
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

__device__ __forceinline__ float u24(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f);
}

// Site (r, y, i) of this thread and its local field (hx, hy), built as
// (up + dn) + (centre + side); also the other colour's centre value.
struct Site {
  size_t idx;
  float hx, hy, cx, cy;
};

__device__ __forceinline__ Site load_site(const Phase& p, int r, int w) {
  const int y = w / p.half, i = w - y * p.half;
  const size_t base = static_cast<size_t>(r) * p.ny * p.half;
  const int yu = y == 0 ? p.ny - 1 : y - 1;
  const int yd = y == p.ny - 1 ? 0 : y + 1;
  // colour 0 on an odd row and colour 1 on an even row read column i + 1
  const bool plus = (p.color == 0) == ((y & 1) == 1);
  const int is = plus ? (i == p.half - 1 ? 0 : i + 1)
                      : (i == 0 ? p.half - 1 : i - 1);
  const size_t row = base + static_cast<size_t>(y) * p.half;
  const size_t up = base + static_cast<size_t>(yu) * p.half + i;
  const size_t dn = base + static_cast<size_t>(yd) * p.half + i;
  Site s;
  s.idx = row + i;
  s.cx = __ldg(p.ox + s.idx);
  s.cy = __ldg(p.oy + s.idx);
  s.hx = __fadd_rn(__fadd_rn(__ldg(p.ox + up), __ldg(p.ox + dn)),
                   __fadd_rn(s.cx, __ldg(p.ox + row + is)));
  s.hy = __fadd_rn(__fadd_rn(__ldg(p.oy + up), __ldg(p.oy + dn)),
                   __fadd_rn(s.cy, __ldg(p.oy + row + is)));
  return s;
}

// The block's float64 (Σ S_x, Σ S_y, Σ S·h) into partials[r][block]: warp
// shuffles, then warp 0's lanes in order; the same order every run.
__device__ __forceinline__ void block_sums(const Phase& p, int r, double mx,
                                           double my, double e) {
  __shared__ double red[3][WARPS];
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mx += __shfl_down_sync(0xFFFFFFFFu, mx, off);
    my += __shfl_down_sync(0xFFFFFFFFu, my, off);
    e += __shfl_down_sync(0xFFFFFFFFu, e, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = mx;
    red[1][threadIdx.x >> 5] = my;
    red[2][threadIdx.x >> 5] = e;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) t += red[threadIdx.x][k];
    p.partials[(static_cast<size_t>(r) * gridDim.x + blockIdx.x) * 3 +
               threadIdx.x] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
    metropolis_kernel(Phase p, const float* ucand, const float* uacc,
                      float neg_beta, uint2 key) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  double mx = 0.0, my = 0.0, e = 0.0;
  if (w < p.ny * p.half) {
    const Site s = load_site(p, r, w);
    float uc, ua;
    if (ucand != nullptr) {
      uc = __ldg(ucand + s.idx);
      ua = __ldg(uacc + s.idx);
    } else {
      const int y = w / p.half;
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                     static_cast<uint32_t>(w - y * p.half), 0u),
          key);
      uc = u24(b.x);
      ua = u24(b.y);
    }
    float cx, cy;
    cos_sin_2pi(uc, cx, cy);
    float fx = p.sx[s.idx], fy = p.sy[s.idx];
    const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), s.hx),
                                __fmul_rn(__fsub_rn(cy, fy), s.hy));
    const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
    if (ua < prob) {
      fx = cx;
      fy = cy;
      p.sx[s.idx] = fx;
      p.sy[s.idx] = fy;
    }
    mx = static_cast<double>(fx) + static_cast<double>(s.cx);
    my = static_cast<double>(fy) + static_cast<double>(s.cy);
    e = static_cast<double>(
        __fadd_rn(__fmul_rn(fx, s.hx), __fmul_rn(fy, s.hy)));
  }
  if (p.partials != nullptr) block_sums(p, r, mx, my, e);  // uniform
}

__global__ void __launch_bounds__(THREADS) over_relax_kernel(Phase p) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  double mx = 0.0, my = 0.0, e = 0.0;
  if (w < p.ny * p.half) {
    const Site s = load_site(p, r, w);
    const float sx = p.sx[s.idx], sy = p.sy[s.idx];
    const float inv = rsqrtf(
        fmaxf(__fadd_rn(__fmul_rn(s.hx, s.hx), __fmul_rn(s.hy, s.hy)), TINY));
    const float nxh = __fmul_rn(s.hx, inv), nyh = __fmul_rn(s.hy, inv);
    const float d =
        __fmul_rn(2.0f, __fadd_rn(__fmul_rn(sx, nxh), __fmul_rn(sy, nyh)));
    const float rx = __fsub_rn(__fmul_rn(d, nxh), sx);
    const float ry = __fsub_rn(__fmul_rn(d, nyh), sy);
    const float rinv = rsqrtf(
        fmaxf(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), TINY));
    const float fx = __fmul_rn(rx, rinv), fy = __fmul_rn(ry, rinv);
    p.sx[s.idx] = fx;
    p.sy[s.idx] = fy;
    mx = static_cast<double>(fx) + static_cast<double>(s.cx);
    my = static_cast<double>(fy) + static_cast<double>(s.cy);
    e = static_cast<double>(
        __fadd_rn(__fmul_rn(fx, s.hx), __fmul_rn(fy, s.hy)));
  }
  if (p.partials != nullptr) block_sums(p, r, mx, my, e);  // uniform
}

// obs[r] = (Σ S_x, Σ S_y, -Σ S·h) from the replica's nblk block partials:
// one block a replica, thread t adds blocks t, t + THREADS, ... in order,
// then a fixed tree over the threads.
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const double* partials, double* obs, int nblk) {
  __shared__ double red[3][THREADS];
  const int r = blockIdx.x;
  const double* part = partials + static_cast<size_t>(r) * nblk * 3;
  double t[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < nblk; b += THREADS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] += part[b * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) red[k][threadIdx.x] = t[k];
  __syncthreads();
  for (int half = THREADS / 2; half; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    obs[r * 3 + 0] = red[0][0];
    obs[r * 3 + 1] = red[1][0];
    obs[r * 3 + 2] = -red[2][0];
  }
}

int check_shape(int nrep, int ny, int half) {
  if (nrep < 1 || nrep > 65535 || ny < 2 || half < 1 ||
      static_cast<long long>(ny) * half >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Phase make_phase(void* sx, void* sy, const void* ox, const void* oy,
                 void* partials, int ny, int half, int color) {
  Phase p;
  p.sx = static_cast<float*>(sx);
  p.sy = static_cast<float*>(sy);
  p.ox = static_cast<const float*>(ox);
  p.oy = static_cast<const float*>(oy);
  p.partials = static_cast<double*>(partials);
  p.ny = ny;
  p.half = half;
  p.color = color;
  return p;
}

int finish(void* partials, void* obs, int nrep, int nblk, cudaStream_t st) {
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || partials == nullptr) return code;
  reduce_kernel<<<nrep, THREADS, 0, st>>>(static_cast<const double*>(partials),
                                          static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, half) planes, in
// place: grid (ceil(ny*half/256), nrep) of 256 threads.  ucand/uacc are
// injected uniforms, or both null for Philox words under (s0, s1).  With
// partials ((nrep, blocks, 3) float64) and obs ((nrep, 3) float64) non-null
// the launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills obs.
int xy_metropolis(void* sx, void* sy, const void* ox, const void* oy,
                  const void* ucand, const void* uacc, void* partials,
                  void* obs, int nrep, int ny, int half, int color,
                  float neg_beta, unsigned int s0, unsigned int s1,
                  void* stream) {
  if (int bad = check_shape(nrep, ny, half)) return bad;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Phase p = make_phase(sx, sy, ox, oy, partials, ny, half, color);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  metropolis_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      p, static_cast<const float*>(ucand), static_cast<const float*>(uacc),
      neg_beta, make_uint2(s0, s1));
  return finish(partials, obs, nrep, nblk, st);
}

// One over-relaxation phase of colour `color`, in place; partials/obs as
// for xy_metropolis.
int xy_over_relax(void* sx, void* sy, const void* ox, const void* oy,
                  void* partials, void* obs, int nrep, int ny, int half,
                  int color, void* stream) {
  if (int bad = check_shape(nrep, ny, half)) return bad;
  if ((partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Phase p = make_phase(sx, sy, ox, oy, partials, ny, half, color);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  over_relax_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(p);
  return finish(partials, obs, nrep, nblk, st);
}

const char* xy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
