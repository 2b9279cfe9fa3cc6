// Periodic XY (planar rotor) phases on Hopper (sm_90a): the kernels of the
// periodic XY relaxation main path, with and without over-relaxation, and
// the snapshot-measuring phase b of the disorder protocols.
//
//   metropolis_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     xy2d_pallas.py:_metropolis_kernel (pallas_call at
//                     :226, _metropolis_phase): one colour phase of the
//                     float32 component planes, the candidate
//                     (cos 2πu, sin 2πu) accepted iff u' < exp(-β max(ΔE, 0));
//                     uniforms from Philox or injected.  Its snapshot mode
//                     replaces _metropolis_measure_kernel (:457,
//                     _metropolis_phase_b_measure -> sweep_measure): the
//                     same phase with (Σ S_x, Σ S_y, e, A) fused, A against
//                     the four t=0 snapshot planes; the thread that updates
//                     site (y, i) already holds the other colour's (y, i)
//                     for its field, so Σ S and A's other-colour term cost
//                     no extra read of the state;
//   over_relax_kernel replaces _over_relax_kernel (:265, _over_relax_phase):
//                     S' = 2(S·n̂)n̂ - S about the normalised local field,
//                     then S' / |S'|;
//   metropolis_kernel<N, true> replaces _halo_metropolis_kernel (pallas_call
//                     at :726, sharded_phase; its field _halo_field :499):
//                     the same phase, snapshot mode included, on a shard of
//                     a (y[, x]) mesh (parallel/domain.py), the rows and
//                     with an x split the columns past the shard's edges
//                     from the exchanged halos, parity and the Philox
//                     counter from global coordinates, so a shard draws
//                     what the whole lattice draws;
//   over_relax_kernel<true> replaces _halo_or_kernel (:770,
//                     sharded_or_phase): the reflection on a shard, with
//                     the fused sums of its measuring phase b;
//   reduce_kernel     adds the per-block float64 sums of a measuring launch
//                     per replica in a fixed order.
//
// Layout, arithmetic, random words and sums: xy2d_site.cuh (the JAX
// engine's 128-lane pad and seam substitution are TPU layout).  Neighbour
// reuse comes from L1/L2.
//
// Bound on the H100: bytes.  Per site of the colour updated a phase reads
// 8 B of its own, 8 B of the other colour (each other-colour site is a
// neighbour of four) and writes 8 B: 24 B, 1.536 GB at the main path's
// 4000x4000 x 8 (0.459 ms at 3.35 TB/s), against ~80 float32 and integer
// operations a site (one Philox4x32-10 call, the trig polynomial, expf).
// The snapshot mode reads 16 B more a site (both colours' snapshot).
#include "xy2d_site.cuh"

namespace {

using xy::Phase;
using xy::Snap;
using xy::Sums;
using xy::THREADS;

// N sums a block: 3, or 4 in the snapshot mode (A against ``sn``, which
// the 3-sum instantiation never reads).  HALO: p is a shard's, its edges
// read sh's halos; otherwise sh is not read.
template <int N, bool HALO>
__global__ void __launch_bounds__(THREADS)
    metropolis_kernel(Phase p, double* partials, const float* ucand,
                      const float* uacc, float neg_beta, uint2 key, Snap sn,
                      xy::Shard sh) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (w < p.ny * p.half) {
    const xy::Update u = xy::metropolis_site<true, HALO>(
        p, r, w, ucand, uacc, neg_beta, key, sh);
    t = xy::site_sums(u.s, u.fx, u.fy);
    if constexpr (N > 3) t.a = xy::snap_sum(sn, u.s, u.fx, u.fy);
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<N>(partials, r, gridDim.x, blockIdx.x, t);
}

template <bool HALO>
__global__ void __launch_bounds__(THREADS)
    over_relax_kernel(Phase p, double* partials, xy::Shard sh) {
  const int r = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (w < p.ny * p.half) {
    const xy::Site s = xy::load_site<true, HALO>(p, r, w, sh);
    const float sx = p.sx[s.idx], sy = p.sy[s.idx];
    const float inv = rsqrtf(fmaxf(
        __fadd_rn(__fmul_rn(s.hx, s.hx), __fmul_rn(s.hy, s.hy)), xy::TINY));
    const float nxh = __fmul_rn(s.hx, inv), nyh = __fmul_rn(s.hy, inv);
    const float d =
        __fmul_rn(2.0f, __fadd_rn(__fmul_rn(sx, nxh), __fmul_rn(sy, nyh)));
    const float rx = __fsub_rn(__fmul_rn(d, nxh), sx);
    const float ry = __fsub_rn(__fmul_rn(d, nyh), sy);
    const float rinv = rsqrtf(
        fmaxf(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), xy::TINY));
    const float fx = __fmul_rn(rx, rinv), fy = __fmul_rn(ry, rinv);
    p.sx[s.idx] = fx;
    p.sy[s.idx] = fy;
    t = xy::site_sums(s, fx, fy);
  }
  if (partials != nullptr)  // uniform
    xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

Phase make_phase(void* sx, void* sy, const void* ox, const void* oy, int ny,
                 int half, int color) {
  Phase p;
  p.sx = static_cast<float*>(sx);
  p.sy = static_cast<float*>(sy);
  p.ox = static_cast<const float*>(ox);
  p.oy = static_cast<const float*>(oy);
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

// The launches of both kernels: grid (ceil(ny*half/256), nrep) of 256
// threads, then reduce_kernel when measuring.
template <bool HALO>
int metropolis(void* sx, void* sy, const void* ox, const void* oy,
               const void* ucand, const void* uacc, const void* const* snap,
               void* partials, void* obs, int nrep, int ny, int half,
               int color, float neg_beta, unsigned int s0, unsigned int s1,
               const xy::Shard& sh, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if ((ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr) ||
      (snap != nullptr && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Phase p = make_phase(sx, sy, ox, oy, ny, half, color);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  double* part = static_cast<double*>(partials);
  Snap sn = {nullptr, nullptr, nullptr, nullptr};
  if (snap != nullptr) {
    sn.sx = static_cast<const float*>(snap[0]);
    sn.sy = static_cast<const float*>(snap[1]);
    sn.ox = static_cast<const float*>(snap[2]);
    sn.oy = static_cast<const float*>(snap[3]);
    metropolis_kernel<xy::NSUMS, HALO><<<dim3(nblk, nrep), THREADS, 0, st>>>(
        p, part, uc, ua, neg_beta, make_uint2(s0, s1), sn, sh);
    return finish<xy::NSUMS>(partials, obs, nrep, nblk, st);
  }
  metropolis_kernel<3, HALO><<<dim3(nblk, nrep), THREADS, 0, st>>>(
      p, part, uc, ua, neg_beta, make_uint2(s0, s1), sn, sh);
  return finish<3>(partials, obs, nrep, nblk, st);
}

template <bool HALO>
int over_relax(void* sx, void* sy, const void* ox, const void* oy,
               void* partials, void* obs, int nrep, int ny, int half,
               int color, const xy::Shard& sh, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if ((partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Phase p = make_phase(sx, sy, ox, oy, ny, half, color);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  over_relax_kernel<HALO><<<dim3(nblk, nrep), THREADS, 0, st>>>(
      p, static_cast<double*>(partials), sh);
  return finish<3>(partials, obs, nrep, nblk, st);
}

// A shard's halos from the wrappers' (upx, upy, dnx, dny, lfx, lfy, rtx,
// rty) array; false for missing rows or a partial set of columns.
bool make_shard(const void* const* h, int rep0, int row0, int col0,
                xy::Shard& sh) {
  const float* f[8];
  for (int k = 0; k < 8; ++k) f[k] = static_cast<const float*>(h[k]);
  sh = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], rep0, row0, col0};
  const bool cols = f[4] != nullptr;
  for (int k = 0; k < 4; ++k)
    if (f[k] == nullptr || (f[4 + k] != nullptr) != cols) return false;
  return rep0 >= 0 && row0 >= 0 && col0 >= 0;
}

}  // namespace

extern "C" {

// One Metropolis phase of colour `color` on (nrep, ny, half) planes, in
// place: grid (ceil(ny*half/256), nrep) of 256 threads.  ucand/uacc are
// injected uniforms, or both null for Philox words under (s0, s1).  With
// partials ((nrep, blocks, 3) float64) and obs ((nrep, 3) float64)
// non-null the launch measures (Σ S_x, Σ S_y, e) and reduce_kernel fills
// obs; with snap, the four t=0 snapshot planes (sx, sy, ox, oy order),
// partials (nrep, blocks, 4) and obs (nrep, 4) take A too.
int xy_metropolis(void* sx, void* sy, const void* ox, const void* oy,
                  const void* ucand, const void* uacc, const void* const* snap,
                  void* partials, void* obs, int nrep, int ny, int half,
                  int color, float neg_beta, unsigned int s0, unsigned int s1,
                  void* stream) {
  return metropolis<false>(sx, sy, ox, oy, ucand, uacc, snap, partials, obs,
                           nrep, ny, half, color, neg_beta, s0, s1,
                           xy::Shard{}, stream);
}

// One over-relaxation phase of colour `color`, in place; partials/obs as
// for xy_metropolis without a snapshot.
int xy_over_relax(void* sx, void* sy, const void* ox, const void* oy,
                  void* partials, void* obs, int nrep, int ny, int half,
                  int color, void* stream) {
  return over_relax<false>(sx, sy, ox, oy, partials, obs, nrep, ny, half,
                           color, xy::Shard{}, stream);
}

// The phases of a shard of a (y[, x]) mesh: as xy_metropolis and
// xy_over_relax, with halos[0..7] the other colour's exchanged rows (upx,
// upy, dnx, dny: (R, 1, half)) and columns (lfx, lfy, rtx, rty: (R, ny,
// 1), all four null without an x split), and (rep0, row0, col0) the
// shard's global offsets.
int xy_halo_metropolis(void* sx, void* sy, const void* ox, const void* oy,
                       const void* ucand, const void* uacc,
                       const void* const* snap, const void* const* halos,
                       void* partials, void* obs, int nrep, int ny, int half,
                       int color, int rep0, int row0, int col0,
                       float neg_beta, unsigned int s0, unsigned int s1,
                       void* stream) {
  xy::Shard sh;
  if (!make_shard(halos, rep0, row0, col0, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  return metropolis<true>(sx, sy, ox, oy, ucand, uacc, snap, partials, obs,
                          nrep, ny, half, color, neg_beta, s0, s1, sh,
                          stream);
}

int xy_halo_over_relax(void* sx, void* sy, const void* ox, const void* oy,
                       const void* const* halos, void* partials, void* obs,
                       int nrep, int ny, int half, int color, int rep0,
                       int row0, int col0, void* stream) {
  xy::Shard sh;
  if (!make_shard(halos, rep0, row0, col0, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  return over_relax<true>(sx, sy, ox, oy, partials, obs, nrep, ny, half,
                          color, sh, stream);
}

const char* xy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
