// Helical XY (odd nx) phases on Hopper (sm_90a), float32 angle planes in
// turns: the kernels of the helical XY relaxation on the default (angle)
// engine, Metropolis only and with over-relaxation.
//
//   angle_phase_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                      xy2d_helical_dense_angle.py:_angle_phase_kernel
//                      (pallas_call at :269, _angle_phase): one colour
//                      phase of the angle plane s from the other colour's
//                      o, decoded with cos_sin_2pi; the candidate angle
//                      u - 0.5 accepted iff u' < exp(-β max(ΔE, 0));
//                      uniforms from Philox or injected; optionally the
//                      fused (Σ S_x, Σ S_y, e);
//   angle_or_kernel    replaces _angle_or_kernel (:308, _angle_or_phase):
//                      θ' = 2 atan2_2pi(h_y, h_x) - θ, wrapped by
//                      tp - rint(tp), the same sums optional;
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
// 0.093 ms).  Each thread decodes its four neighbours itself, where the
// TPU kernel decodes a tile once and rolls it: six decodes a Metropolis
// site and four an OR site where the function needs three and one, bought
// with no shared memory and no barrier.
#include "xy2d_helical_dense.cuh"

namespace {

using xy::Sums;
using xyh::Slot;
using xyh::THREADS;

struct AnglePlanes {
  float* s;         // (R, ny, nc) colour updated, turns, in place
  const float* o;   // the other colour
  int ny, nc, color;
};

// The decoded field of a valid slot: each neighbour angle to
// (cos, sin), then ((up + dn) + left) + right per component
__device__ __forceinline__ void angle_field(const float* o, const Slot& s,
                                            float& hx, float& hy) {
  float ux, uy, dx, dy, lx, ly, rx, ry;
  xy::cos_sin_2pi(__ldg(o + s.up), ux, uy);
  xy::cos_sin_2pi(__ldg(o + s.dn), dx, dy);
  xy::cos_sin_2pi(__ldg(o + s.left), lx, ly);
  xy::cos_sin_2pi(__ldg(o + s.right), rx, ry);
  hx = __fadd_rn(__fadd_rn(__fadd_rn(ux, dx), lx), rx);
  hy = __fadd_rn(__fadd_rn(__fadd_rn(uy, dy), ly), ry);
}

// The other colour's decoded slot (y, i), counted where it is valid
__device__ __forceinline__ void other_sums(const AnglePlanes& p,
                                           const Slot& s, Sums& t) {
  float ox, oy;
  xy::cos_sin_2pi(__ldg(p.o + s.idx), ox, oy);
  t.mx += static_cast<double>(ox);
  t.my += static_cast<double>(oy);
}

__global__ void __launch_bounds__(THREADS)
    angle_phase_kernel(AnglePlanes p, double* partials, const float* ucand,
                       const float* uacc, float neg_beta, uint2 key) {
  const int r = blockIdx.y;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int w = blockIdx.x * THREADS + threadIdx.x; w < p.ny * p.nc;
       w += gridDim.x * THREADS) {
    const Slot s = xyh::dense_slot(r, w, p.ny, p.nc, p.color);
    if (partials != nullptr && s.ovalid) other_sums(p, s, t);
    if (s.valid) {
      float hx, hy;
      angle_field(p.o, s, hx, hy);
      float uc, ua;
      xyh::uniforms(s, r, ucand, uacc, key, uc, ua);
      float fx, fy, cx, cy;
      xy::cos_sin_2pi(p.s[s.idx], fx, fy);
      const float cand = __fsub_rn(uc, 0.5f);
      xy::cos_sin_2pi(cand, cx, cy);
      const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), hx),
                                  __fmul_rn(__fsub_rn(cy, fy), hy));
      const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
      if (ua < prob) {
        fx = cx;
        fy = cy;
        p.s[s.idx] = cand;
      }
      t.mx += static_cast<double>(fx);
      t.my += static_cast<double>(fy);
      t.e += xyh::bond_sum(fx, fy, hx, hy);
    }
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

__global__ void __launch_bounds__(THREADS)
    angle_or_kernel(AnglePlanes p, double* partials) {
  const int r = blockIdx.y;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int w = blockIdx.x * THREADS + threadIdx.x; w < p.ny * p.nc;
       w += gridDim.x * THREADS) {
    const Slot s = xyh::dense_slot(r, w, p.ny, p.nc, p.color);
    if (partials != nullptr && s.ovalid) other_sums(p, s, t);
    if (s.valid) {
      float hx, hy;
      angle_field(p.o, s, hx, hy);
      const float phi = xy::atan2_2pi(hy, hx);
      float tp = __fsub_rn(__fmul_rn(2.0f, phi), p.s[s.idx]);
      tp = __fsub_rn(tp, rintf(tp));
      p.s[s.idx] = tp;
      if (partials != nullptr) {
        float fx, fy;
        xy::cos_sin_2pi(tp, fx, fy);
        t.mx += static_cast<double>(fx);
        t.my += static_cast<double>(fy);
        t.e += xyh::bond_sum(fx, fy, hx, hy);
      }
    }
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
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

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, nc) angle planes,
// s in place: grid (nblk, nrep) of 256 threads.  ucand/uacc are
// injected uniforms, or both null for Philox words under (s0, s1).
// With partials ((nrep, nblk, 3) float64) and obs ((nrep, 3) float64)
// non-null the launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills
// obs.
int xya_phase(void* s, const void* o, const void* ucand, const void* uacc,
              void* partials, void* obs, int nrep, int ny, int nc, int nblk,
              int color, float neg_beta, unsigned int s0, unsigned int s1,
              void* stream) {
  if (int bad = xyh::check_shape(nrep, ny, nc, nblk)) return bad;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  angle_phase_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      make_planes(s, o, ny, nc, color), static_cast<double*>(partials),
      static_cast<const float*>(ucand), static_cast<const float*>(uacc),
      neg_beta, make_uint2(s0, s1));
  return xyh::finish(partials, obs, nrep, nblk, st);
}

// One over-relaxation phase of colour `color`, s in place; partials/obs
// as for xya_phase.
int xya_over_relax(void* s, const void* o, void* partials, void* obs,
                   int nrep, int ny, int nc, int nblk, int color,
                   void* stream) {
  if (int bad = xyh::check_shape(nrep, ny, nc, nblk)) return bad;
  if ((partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  angle_or_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      make_planes(s, o, ny, nc, color), static_cast<double*>(partials));
  return xyh::finish(partials, obs, nrep, nblk, st);
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
