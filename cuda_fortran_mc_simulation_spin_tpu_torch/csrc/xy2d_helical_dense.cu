// Helical XY (odd nx) phases on Hopper (sm_90a), component planes: the
// kernels of the helical XY relaxation on the component engine, Metropolis
// only and with over-relaxation.
//
//   phase_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                xy2d_helical_dense.py:_phase_kernel (pallas_call at :454,
//                _dense_phase): one colour phase of the float32 (sx, sy)
//                planes from the other colour's (ox, oy), the candidate
//                (cos 2πu, sin 2πu) accepted iff u' < exp(-β max(ΔE, 0));
//                uniforms from Philox or injected; optionally the fused
//                (Σ S_x, Σ S_y, e) over both colours' valid slots;
//   or_kernel    replaces _or_kernel (:499, _dense_or_phase): S' =
//                2(S·n̂)n̂ - S about the normalised local field, then
//                S' / |S'|, the same sums optional.
//
// Layout and neighbours: xy2d_helical_dense.cuh (the JAX engine's 128-lane
// pad, 8-row tiles, splice_updown and pltpu.roll are TPU layout: here each
// thread takes one slot at a time in a grid-stride loop, neighbour reuse
// from L1/L2).  Per-site arithmetic, random
// words and the float64 block sums: xy2d_site.cuh, bitwise equal to the
// plain versions of ops/xy2d_helical_dense.py.
//
// Bound on the H100: bytes.  Per site of the colour updated a phase reads
// 8 B of its own, 8 B of the other colour (each other-colour site is a
// neighbour of four) and writes 8 B: 24 B, 1.2 GB at the main path's
// 10001x10000 x 1 (0.358 ms at 3.35 TB/s), against ~110 32-bit operations
// a site (Metropolis: one Philox4x32-10 call, the trig polynomial, expf)
// or ~30 (over-relaxation).
#include "xy2d_helical_dense.cuh"

namespace {

using xy::Sums;
using xyh::Slot;
using xyh::THREADS;

struct Planes {
  float* sx;         // (R, ny, nc) colour updated, in place
  float* sy;
  const float* ox;   // the other colour
  const float* oy;
  int ny, nc, color;
};

__global__ void __launch_bounds__(THREADS)
    phase_kernel(Planes p, double* partials, const float* ucand,
                 const float* uacc, float neg_beta, uint2 key) {
  const int r = blockIdx.y;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int w = blockIdx.x * THREADS + threadIdx.x; w < p.ny * p.nc;
       w += gridDim.x * THREADS) {
    const Slot s = xyh::dense_slot(r, w, p.ny, p.nc, p.color);
    if (partials != nullptr && s.ovalid) {
      t.mx += static_cast<double>(__ldg(p.ox + s.idx));
      t.my += static_cast<double>(__ldg(p.oy + s.idx));
    }
    if (s.valid) {
      const float hx = xyh::field(p.ox, s), hy = xyh::field(p.oy, s);
      float uc, ua;
      xyh::uniforms(s, r, ucand, uacc, key, uc, ua);
      float cx, cy;
      xy::cos_sin_2pi(uc, cx, cy);
      float fx = p.sx[s.idx], fy = p.sy[s.idx];
      const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), hx),
                                  __fmul_rn(__fsub_rn(cy, fy), hy));
      const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
      if (ua < prob) {
        fx = cx;
        fy = cy;
        p.sx[s.idx] = cx;
        p.sy[s.idx] = cy;
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
    or_kernel(Planes p, double* partials) {
  const int r = blockIdx.y;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  for (int w = blockIdx.x * THREADS + threadIdx.x; w < p.ny * p.nc;
       w += gridDim.x * THREADS) {
    const Slot s = xyh::dense_slot(r, w, p.ny, p.nc, p.color);
    if (partials != nullptr && s.ovalid) {
      t.mx += static_cast<double>(__ldg(p.ox + s.idx));
      t.my += static_cast<double>(__ldg(p.oy + s.idx));
    }
    if (s.valid) {
      const float hx = xyh::field(p.ox, s), hy = xyh::field(p.oy, s);
      const float sx = p.sx[s.idx], sy = p.sy[s.idx];
      const float inv = rsqrtf(fmaxf(
          __fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), xy::TINY));
      const float nxh = __fmul_rn(hx, inv), nyh = __fmul_rn(hy, inv);
      const float d =
          __fmul_rn(2.0f, __fadd_rn(__fmul_rn(sx, nxh), __fmul_rn(sy, nyh)));
      const float rx = __fsub_rn(__fmul_rn(d, nxh), sx);
      const float ry = __fsub_rn(__fmul_rn(d, nyh), sy);
      const float rinv = rsqrtf(
          fmaxf(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), xy::TINY));
      const float fx = __fmul_rn(rx, rinv), fy = __fmul_rn(ry, rinv);
      p.sx[s.idx] = fx;
      p.sy[s.idx] = fy;
      t.mx += static_cast<double>(fx);
      t.my += static_cast<double>(fy);
      t.e += xyh::bond_sum(fx, fy, hx, hy);
    }
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

Planes make_planes(void* sx, void* sy, const void* ox, const void* oy,
                   int ny, int nc, int color) {
  Planes p;
  p.sx = static_cast<float*>(sx);
  p.sy = static_cast<float*>(sy);
  p.ox = static_cast<const float*>(ox);
  p.oy = static_cast<const float*>(oy);
  p.ny = ny;
  p.nc = nc;
  p.color = color;
  return p;
}

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, nc) planes, in
// place: grid (nblk, nrep) of 256 threads.  ucand/uacc are injected
// uniforms, or both null for Philox words under (s0, s1).  With partials
// ((nrep, nblk, 3) float64) and obs ((nrep, 3) float64) non-null the
// launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills obs.
int xyh_phase(void* sx, void* sy, const void* ox, const void* oy,
              const void* ucand, const void* uacc, void* partials, void* obs,
              int nrep, int ny, int nc, int nblk, int color, float neg_beta,
              unsigned int s0, unsigned int s1, void* stream) {
  if (int bad = xyh::check_shape(nrep, ny, nc, nblk)) return bad;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  phase_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      make_planes(sx, sy, ox, oy, ny, nc, color),
      static_cast<double*>(partials), static_cast<const float*>(ucand),
      static_cast<const float*>(uacc), neg_beta, make_uint2(s0, s1));
  return xyh::finish(partials, obs, nrep, nblk, st);
}

// One over-relaxation phase of colour `color`, in place; partials/obs as
// for xyh_phase.
int xyh_over_relax(void* sx, void* sy, const void* ox, const void* oy,
                   void* partials, void* obs, int nrep, int ny, int nc,
                   int nblk, int color, void* stream) {
  if (int bad = xyh::check_shape(nrep, ny, nc, nblk)) return bad;
  if ((partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  or_kernel<<<dim3(nblk, nrep), THREADS, 0, st>>>(
      make_planes(sx, sy, ox, oy, ny, nc, color),
      static_cast<double*>(partials));
  return xyh::finish(partials, obs, nrep, nblk, st);
}

const char* xyh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
