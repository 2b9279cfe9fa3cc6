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
//                      fused (Σ S_x, Σ S_y, e).  Its snapshot mode replaces
//                      _angle_metro_snap_kernel (:405,
//                      _angle_metro_snap_phase -> sweep_measure_snap_angle):
//                      the same phase with A = Σ cos 2π(θ - θ0) of both
//                      colours against the t=0 angle snapshots fused beside
//                      the sums;
//   angle_or_kernel    replaces _angle_or_kernel (:300, _angle_or_phase):
//                      θ' = 2 atan2_2pi(h_y, h_x) - θ, wrapped by
//                      tp - rint(tp), the same sums optional;
//   reduce_kernel      (xy2d_site.cuh) adds the per-block float64 sums of a
//                      measuring launch per replica in a fixed order.
//
// Layout, neighbours, random words and the sums' reduction: xy2d_site.cuh,
// on (R, ny, nx/2) angle planes (the JAX engine's 128-lane pad and seam
// substitution are TPU layout).  A phase updates its colour in place.
// Per-site arithmetic in the order of the plain versions of
// ops/xy2d_pallas_angle.py, one rounding per operation (rintf rounds half
// to even, as torch.round and jnp.round do).  One thread a site; each
// thread decodes its four neighbours itself.
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

struct AnglePhase {
  float* s;         // (R, ny, half) colour updated, turns, in place
  const float* o;   // the other colour
  int ny, half, color;
};

// The site's field (hx, hy) from the other colour's four decoded angles,
// (up + dn) + (centre + side) a component, and the decoded centre (ox, oy)
struct AngleSite {
  xy::Nbrs n;
  float hx, hy, ox, oy;
};

__device__ __forceinline__ AngleSite angle_site(const AnglePhase& p, int r,
                                                int w) {
  AngleSite a;
  a.n = xy::neighbours(p.ny, p.half, p.color, r, w);
  float ux, uy, dx, dy, sx, sy;
  xy::cos_sin_2pi(__ldg(p.o + a.n.up), ux, uy);
  xy::cos_sin_2pi(__ldg(p.o + a.n.dn), dx, dy);
  xy::cos_sin_2pi(__ldg(p.o + a.n.idx), a.ox, a.oy);
  xy::cos_sin_2pi(__ldg(p.o + a.n.side), sx, sy);
  a.hx = __fadd_rn(__fadd_rn(ux, dx), __fadd_rn(a.ox, sx));
  a.hy = __fadd_rn(__fadd_rn(uy, dy), __fadd_rn(a.oy, sy));
  return a;
}

// (Σ S_x, Σ S_y, S·h) of a site whose new spin is (fx, fy), A = 0
__device__ __forceinline__ Sums angle_sums(const AngleSite& a, float fx,
                                           float fy) {
  Sums t;
  t.mx = static_cast<double>(fx) + static_cast<double>(a.ox);
  t.my = static_cast<double>(fy) + static_cast<double>(a.oy);
  t.e = static_cast<double>(
      __fadd_rn(__fmul_rn(fx, a.hx), __fmul_rn(fy, a.hy)));
  t.a = 0.0;
  return t;
}

// N sums a block: 3, or 4 in the snapshot mode (A against sns, the
// snapshot of the colour updated, and sno, the other's; the 3-sum
// instantiation never reads them)
template <int N>
__global__ void __launch_bounds__(THREADS)
    angle_metro_kernel(AnglePhase p, double* partials, const float* ucand,
                       const float* uacc, float neg_beta, uint2 key,
                       const float* sns, const float* sno) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (w < p.ny * p.half) {
    const AngleSite a = angle_site(p, r, w);
    const size_t idx = a.n.idx;
    float uc, ua;
    xy::uniforms(r, w, p.half, idx, ucand, uacc, key, uc, ua);
    float th = p.s[idx];
    float fx, fy, cx, cy;
    xy::cos_sin_2pi(th, fx, fy);
    const float cand = __fsub_rn(uc, 0.5f);
    xy::cos_sin_2pi(cand, cx, cy);
    const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), a.hx),
                                __fmul_rn(__fsub_rn(cy, fy), a.hy));
    const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
    if (ua < prob) {
      fx = cx;
      fy = cy;
      th = cand;
      p.s[idx] = cand;
    }
    t = angle_sums(a, fx, fy);
    if constexpr (N > 3) {
      float ca, cb, unused;
      xy::cos_sin_2pi(__fsub_rn(th, __ldg(sns + idx)), ca, unused);
      xy::cos_sin_2pi(__fsub_rn(__ldg(p.o + idx), __ldg(sno + idx)), cb,
                      unused);
      t.a = static_cast<double>(ca) + static_cast<double>(cb);
    }
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<N>(partials, r, gridDim.x, blockIdx.x, t);
}

__global__ void __launch_bounds__(THREADS)
    angle_or_kernel(AnglePhase p, double* partials) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (w < p.ny * p.half) {
    const AngleSite a = angle_site(p, r, w);
    const float phi = xy::atan2_2pi(a.hy, a.hx);
    float tp = __fsub_rn(__fmul_rn(2.0f, phi), p.s[a.n.idx]);
    tp = __fsub_rn(tp, rintf(tp));
    p.s[a.n.idx] = tp;
    if (partials != nullptr) {
      float fx, fy;
      xy::cos_sin_2pi(tp, fx, fy);
      t = angle_sums(a, fx, fy);
    }
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
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
// s in place: grid (ceil(ny*half/256), nrep) of 256 threads.  ucand/uacc
// are injected uniforms, or both null for Philox words under (s0, s1).
// With partials ((nrep, blocks, 3) float64) and obs ((nrep, 3) float64)
// non-null the launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills
// obs; with sns/sno, the t=0 angle snapshots of the colour updated and of
// the other, partials (nrep, blocks, 4) and obs (nrep, 4) take A too.
int xya_metro(void* s, const void* o, const void* ucand, const void* uacc,
              const void* sns, const void* sno, void* partials, void* obs,
              int nrep, int ny, int half, int color, float neg_beta,
              unsigned int s0, unsigned int s1, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr) ||
      (sns == nullptr) != (sno == nullptr) ||
      (sns != nullptr && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const AnglePhase p = make_phase(s, o, ny, half, color);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  double* part = static_cast<double*>(partials);
  const float* ss = static_cast<const float*>(sns);
  const float* so = static_cast<const float*>(sno);
  if (sns != nullptr) {
    angle_metro_kernel<xy::NSUMS><<<dim3(nblk, nrep), THREADS, 0, st>>>(
        p, part, uc, ua, neg_beta, make_uint2(s0, s1), ss, so);
    return finish<xy::NSUMS>(partials, obs, nrep, nblk, st);
  }
  angle_metro_kernel<3><<<dim3(nblk, nrep), THREADS, 0, st>>>(
      p, part, uc, ua, neg_beta, make_uint2(s0, s1), ss, so);
  return finish<3>(partials, obs, nrep, nblk, st);
}

// One over-relaxation phase of colour `color` on angle planes, s in place;
// partials/obs as for xya_metro without a snapshot.
int xya_or(void* s, const void* o, void* partials, void* obs, int nrep,
           int ny, int half, int color, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if ((partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  angle_or_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      make_phase(s, o, ny, half, color), static_cast<double*>(partials));
  return finish<3>(partials, obs, nrep, nblk, st);
}

const char* xya_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
