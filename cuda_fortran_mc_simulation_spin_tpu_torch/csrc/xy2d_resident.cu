// S Metropolis sweeps of the periodic XY model in one launch on Hopper
// (sm_90a), per-sweep sums fused.
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     xy2d_resident.py:_ms_kernel (pallas_call at :257,
//                     multisweep): S sweeps of (R, ny, half) float32
//                     component planes, each sweep's (Σ S_x, Σ S_y, e, A)
//                     fused into its phase b, A against the t=0 snapshot;
//                     and, in its injected mode, _phase_bits_kernel (:163,
//                     phase_with_bits): one phase with injected uniforms.
//
// The TPU kernel keeps the state and the snapshot in VMEM for S sweeps.
// On the card the reason to keep them in one launch is the host: a
// streamed sweep costs the host ~0.2 ms of launches (PERF.md §5), far
// more than the card's work at one 1500x1500 replica (27 MB a phase at
// 3.35 TB/s is 8 us), and the 36 MB of state and snapshot fit the 50 MB
// L2.  A cooperative grid of as many blocks as fit at once walks the
// phase's 256-site items (replica, block) and waits at a grid barrier
// before the next phase reads what it wrote.  No 128-lane pad and no seam
// substitution: the planes are unpadded, every even nx is served (the
// literal 750 columns too).
//
// The per-site arithmetic and the random words are those of
// metropolis_kernel (xy2d_site.cuh): the same Philox key of the (sweep,
// phase) and counter (replica, row, column, 0), so S sweeps here equal S
// streamed sweep_measure calls bitwise in the state; an item's 256 sites
// are one block of the streamed launch, so the per-item partials, and the
// fixed-order reduce of (R, S) rows of them, equal the streamed sums
// bitwise too.  The other colour is read with plain loads: later phases
// of the same launch write it, so the read-only cache would be unsound.
//
// Bound on the H100: bytes.  A sweep reads and writes 24 B a site of each
// colour and reads the 16 B of both colours' snapshot once, 32 B a site
// (72 MB at 1500x1500 x 1, 22 us at 3.35 TB/s from device memory; less
// where the set stays in L2), against ~110 instructions a site.
#include <cooperative_groups.h>

#include "xy2d_site.cuh"

namespace cg = cooperative_groups;

namespace {

using xy::Phase;
using xy::Snap;
using xy::Sums;
using xy::THREADS;

struct Multisweep {
  float* ax;               // (R, ny, half) state, updated in place
  float* ay;
  float* bx;
  float* by;
  const float* sax;        // t=0 snapshot, or all null (A = 0)
  const float* say;
  const float* sbx;
  const float* sby;
  const int32_t* seeds;    // (S, 2, 2) Philox keys per (sweep, phase)
  const float* ucand;      // injected mode: one phase of `color` with
  const float* uacc;       // these uniforms; else null
  double* partials;        // (R, S, nblk, 4), or null
  int nrep, ny, half, sweeps, color;
  float neg_beta;
};

__global__ void __launch_bounds__(THREADS, 4)
    multisweep_kernel(Multisweep a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.ny * a.half;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int items = a.nrep * nblk;
  const bool injected = a.ucand != nullptr;
  const int k0 = injected ? a.color : 0;
  const int k1 = injected ? a.color + 1 : 2 * a.sweeps;
  for (int k = k0; k < k1; ++k) {
    const int s = k >> 1, c = k & 1;
    const bool measuring = !injected && c == 1 && a.partials != nullptr;
    Phase p;
    p.sx = c ? a.bx : a.ax;
    p.sy = c ? a.by : a.ay;
    p.ox = c ? a.ax : a.bx;
    p.oy = c ? a.ay : a.by;
    const bool snap = measuring && a.sax != nullptr;  // uniform
    const Snap sn = {a.sbx, a.sby, a.sax, a.say};     // colour b updated
    p.ny = a.ny;
    p.half = a.half;
    p.color = c;
    uint2 key = make_uint2(0u, 0u);
    if (!injected)
      key = make_uint2(static_cast<uint32_t>(a.seeds[(2 * s + c) * 2]),
                       static_cast<uint32_t>(a.seeds[(2 * s + c) * 2 + 1]));
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int r = item / nblk, blk = item - r * nblk;
      const int w = blk * THREADS + threadIdx.x;
      Sums t = {0.0, 0.0, 0.0, 0.0};
      if (w < n) {
        const xy::Update u = xy::metropolis_site<false>(
            p, r, w, a.ucand, a.uacc, a.neg_beta, key);
        t = xy::site_sums(u.s, u.fx, u.fy);
        if (snap) t.a = xy::snap_sum(sn, u.s, u.fx, u.fy);
      }
      if (measuring)  // uniform
        xy::block_sums<xy::NSUMS, true>(
            a.partials, static_cast<size_t>(r) * a.sweeps + s, nblk, blk, t);
    }
    if (k + 1 < k1) grid.sync();
  }
}

int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_kernel, THREADS, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid: as many as can be resident at once on
// the current device (0 if none fits).
int xy_multisweep_grid(int* blocks) { return grid_blocks(blocks); }

// S = sweeps Metropolis sweeps of (nrep, ny, half) planes in place, one
// cooperative launch; seeds (S, 2, 2) int32 on the device.  With partials
// ((nrep, S, blocks, 4) float64) and obs ((nrep, S, 4) float64) non-null
// each sweep's (Σ S_x, Σ S_y, e, A) lands in obs (reduce_kernel after the
// launch); snap null (A = 0) or the four t=0 snapshot planes (ax, ay, bx,
// by).  ucand/uacc non-null: the injected mode, one phase of `color` with
// those uniforms (seeds, snap, partials and obs unused, sweeps = 1).
int xy_multisweep(void* ax, void* ay, void* bx, void* by,
                  const void* const* snap, const void* seeds,
                  const void* ucand, const void* uacc, void* partials,
                  void* obs, int nrep, int ny, int half, int sweeps,
                  int color, float neg_beta, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if (sweeps < 1 || (ucand == nullptr) != (uacc == nullptr) ||
      (partials == nullptr) != (obs == nullptr) ||
      (ucand == nullptr && seeds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  if (int err = grid_blocks(&resident)) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const long long items = static_cast<long long>(nrep) * nblk;
  const int blocks = items < resident ? static_cast<int>(items) : resident;
  Multisweep a;
  a.ax = static_cast<float*>(ax);
  a.ay = static_cast<float*>(ay);
  a.bx = static_cast<float*>(bx);
  a.by = static_cast<float*>(by);
  const float* sn[4] = {nullptr, nullptr, nullptr, nullptr};
  if (snap != nullptr)
    for (int k = 0; k < 4; ++k) sn[k] = static_cast<const float*>(snap[k]);
  a.sax = sn[0];
  a.say = sn[1];
  a.sbx = sn[2];
  a.sby = sn[3];
  a.seeds = static_cast<const int32_t*>(seeds);
  a.ucand = static_cast<const float*>(ucand);
  a.uacc = static_cast<const float*>(uacc);
  a.partials = ucand == nullptr ? static_cast<double*>(partials) : nullptr;
  a.nrep = nrep;
  a.ny = ny;
  a.half = half;
  a.sweeps = ucand == nullptr ? sweeps : 1;
  a.color = color;
  a.neg_beta = neg_beta;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || a.partials == nullptr) return code;
  xy::reduce_kernel<xy::NSUMS><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

const char* xy_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
