// S Metropolis sweeps of the periodic XY model in one launch on Hopper
// (sm_90a), per-sweep sums fused.  Two modes of one function, both
// replacing cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_resident.py:
// _ms_kernel (pallas_call at :257, multisweep): S sweeps of (R, ny, half)
// float32 component planes, each sweep's (Σ S_x, Σ S_y, e, A) fused into
// its phase b, A against the t=0 snapshot.
//
//   smem_multisweep_kernel  the lattice in the SMs' shared memory, ring
//                           flags between phases: every batch whose
//                           state fits the grid's shared memory
//                           (ops/xy2d_resident.smem_layout);
//   multisweep_kernel       the state in device memory (L2), a grid
//                           barrier between phases: the larger batches
//                           under the route bound.
//
// The TPU kernel keeps the state and the snapshot in VMEM for S sweeps.
// The card's counterpart of VMEM is its shared memory: 132 SMs x 227 KB.
// smem_multisweep_kernel gives each replica a ring of blocks
// (xy2d_ring.cuh); block j of a ring owns the chunks bounds[j] ..
// bounds[j+1] - 1 of 256 sites (w in [256 q, 256 q + 256), one block of
// the streamed metropolis_kernel) of both colours, loads them into shared
// memory once, updates them there for S sweeps and writes them back once.
// A site's other-colour neighbours lie within `half` sites of its own w
// (rows wrapping at ny are w -+ half modulo the replica), so a block
// needs, each phase, the other colour's `half` sites before its first
// chunk and after its last: its ring neighbours' edges.  A phase updates
// the chunks that hold its first and last `half` sites first, publishes
// those sites and sets its flag, and only then updates its other chunks;
// before the next phase it waits on its two neighbours' flags (set
// mid-phase, so the wait is short) and reads their edges.  smem_layout
// shrinks the ring until a block owns at least `half` sites.  1024
// threads a block, one block an SM: four groups of 256 threads take the
// block's chunks in turn, a group a chunk at a time; (y, i) of a site is
// its chunk's first site's, kept in shared memory, plus the thread's
// offset: no runtime division a site.  The snapshot's loads are issued a
// site ahead, the first before the flag wait.
//
// The per-site arithmetic is that of metropolis_kernel (xy2d_site.cuh):
// cos_sin_2pi, the field's order (up + dn) + (centre + side), expf and
// the acceptance, under the Philox key of the (sweep, phase) and counter
// (replica, row, column, 0), so S sweeps here equal S streamed
// sweep_measure calls bitwise in the state.  A chunk's sums are reduced
// in block_sums' order (thread t on site 256 q + t, the shuffle tree a
// warp, transposed to move fewer doubles; its 8 warps' sums kept in shared
// memory and added in order once the phase is done, no barrier a chunk),
// into the same (R, S, chunks, 4)
// partials for reduce_kernel: the sums equal the streamed ones bitwise
// too.  The t=0 snapshot stays in device memory, read-only.
//
// multisweep_kernel walks the phase's 256-site items (replica, chunk) with
// a cooperative grid of as many blocks as fit at once and waits at a grid
// barrier before the next phase reads what it wrote; the other colour is
// read with plain loads, since later phases of the launch write it.
//
// Bound on the H100: operations.  A site update needs ~100 32-bit
// operations (a Philox call, cos_sin_2pi, expf, the field; the sums a
// measuring site more) against 32 B a site a sweep of state and
// snapshot (72 MB at 1500x1500 x 1, 22 us, less from L2).
// XY_RESIDENT_NO_SITES (a measurement build, chip_time_xy.py --resident)
// compiles the site updates out of both kernels: what is left is the
// barriers or ring waits, the loads and stores and the sums.  It serves
// the profiler pass of ROADMAP's order of work (item 5), which deletes it.
#include <cooperative_groups.h>

#include "xy2d_ring.cuh"
#include "xy2d_site.cuh"

namespace cg = cooperative_groups;

namespace {

using ring::CHUNK_BYTES;
using ring::GROUPS;
using xy::NSUMS;
using xy::Phase;
using xy::Snap;
using xy::Sums;
using xy::THREADS;
using xy::WARPS;

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
  double* partials;        // (R, S, chunks, 4), or null
  int nrep, ny, half, sweeps;
  float neg_beta;
};

// The ring layout of smem_multisweep_kernel (ops/xy2d_resident.smem_layout)
using Ring = ring::Ring<float2>;

__global__ void __launch_bounds__(THREADS, 4)
    multisweep_kernel(Multisweep a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.ny * a.half;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int items = a.nrep * nblk;
  for (int k = 0; k < 2 * a.sweeps; ++k) {
    const int s = k >> 1, c = k & 1;
    const bool measuring = c == 1 && a.partials != nullptr;
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
    const uint2 key = ring::phase_key(a.seeds, k);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int r = item / nblk, blk = item - r * nblk;
      const int w = blk * THREADS + threadIdx.x;
      Sums t = {0.0, 0.0, 0.0, 0.0};
#ifndef XY_RESIDENT_NO_SITES
      if (w < n) {
        const xy::Update u = xy::metropolis_site<false>(
            p, r, w, nullptr, nullptr, a.neg_beta, key);
        t = xy::site_sums(u.s, u.fx, u.fy);
        if (snap) t.a = xy::snap_sum(sn, u.s, u.fx, u.fy);
      }
#endif
      if (measuring)  // uniform
        xy::block_sums<NSUMS, true>(
            a.partials, static_cast<size_t>(r) * a.sweeps + s, nblk, blk, t);
    }
    if (k + 1 < 2 * a.sweeps) grid.sync();
  }
}

__global__ void __launch_bounds__(THREADS * GROUPS, 1)
    smem_multisweep_kernel(Multisweep a, Ring ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const plane0 = reinterpret_cast<float2*>(smem);
  float2* const plane1 = plane0 + ring.span;
  double* const red = reinterpret_cast<double*>(plane1 + ring.span);
  int2* const rows = reinterpret_cast<int2*>(red + ring.chunks * NSUMS * WARPS);
  const int h = a.half, n = a.ny * h;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int r = blockIdx.x / ring.nb, j = blockIdx.x - r * ring.nb;
  const int c0 = ring.bounds[j], nch = ring.bounds[j + 1] - c0;
  const int lo = c0 * THREADS, m = min(nch * THREADS, n - lo);
  const int prev = r * ring.nb + (j == 0 ? ring.nb - 1 : j - 1);
  const int next = r * ring.nb + (j == ring.nb - 1 ? 0 : j + 1);
  const size_t base = static_cast<size_t>(r) * n;
  constexpr int T = THREADS * GROUPS;
  const int tid = threadIdx.x;
  // a colour's shared plane: slot l holds site lo - h + l (modulo n), the
  // owned sites at h .. h + m - 1 and the other colour's halos around them
  for (int l = tid; l < m; l += T) {
    const size_t o = base + lo + l;
    plane0[h + l] = make_float2(a.ax[o], a.ay[o]);
    plane1[h + l] = make_float2(a.bx[o], a.by[o]);
  }
  // phase 0's halo of colour b from the planes: the neighbours write
  // theirs back only after waiting on this block's later flags
  for (int l = tid; l < 2 * h; l += T) {
    int w = l < h ? lo - h + l : lo + m + (l - h);
    w = w < 0 ? w + n : (w >= n ? w - n : w);
    plane1[l < h ? l : m + l] = make_float2(a.bx[base + w], a.by[base + w]);
  }
  ring::chunk_rows(rows, c0, nch, h, tid);
  __syncthreads();
  const int g = tid / THREADS, tg = tid & (THREADS - 1);
  const int dy = tg / h, di = tg - dy * h;
  const ring::Walk walk(h, m, nch);
  const int edges = walk.edges;
  auto chunk = [&](int p) { return walk.chunk(p, nch); };
  auto site_of = [&](int p) {
    return p < nch ? (c0 + chunk(p)) * THREADS + tg : n;
  };
  for (int k = 0; k < 2 * a.sweeps; ++k) {
    const int s = k >> 1, c = k & 1;
    const bool measuring = c == 1 && a.partials != nullptr;
    const bool snap = measuring && a.sax != nullptr;  // uniform
    float2* const sp = c ? plane1 : plane0;
    float2* const op = c ? plane0 : plane1;
    // the snapshot of site w (colour b updated, then colour a at w),
    // issued a site ahead
    auto snap_at = [&](int w) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (snap && w < n)
        v = make_float4(__ldg(a.sbx + base + w), __ldg(a.sby + base + w),
                        __ldg(a.sax + base + w), __ldg(a.say + base + w));
      return v;
    };
    float4 sv = snap_at(site_of(g));
    if (k > 0) {
      ring::wait(ring.flags, prev, next, static_cast<unsigned>(k), tid);
      // the other colour's halos: prev's last h sites, next's first h
      const float2* ep =
          ring.edges + (static_cast<size_t>(prev) * 2 + 1 - c) * 2 * h;
      const float2* en =
          ring.edges + (static_cast<size_t>(next) * 2 + 1 - c) * 2 * h;
      for (int l = tid; l < h; l += T) {
        op[l] = __ldcg(ep + h + l);
        op[h + m + l] = __ldcg(en + l);
      }
      __syncthreads();
    }
    const uint2 key = ring::phase_key(a.seeds, k);
    // one site of position p; a measuring one leaves its warp's sums in
    // red, reduced after the phase in block_sums' order
    auto update = [&](int p) {
      const int q = chunk(p), w = (c0 + q) * THREADS + tg;
      const float4 sn = sv;
      sv = snap_at(site_of(p + GROUPS));
      Sums t = {0.0, 0.0, 0.0, 0.0};
#ifndef XY_RESIDENT_NO_SITES
      if (w < n) {
        const int l = w - lo + h;
        const ring::Slot sl(rows[q], dy, di, h, c, l);
        const int y = sl.y, i = sl.i;
        const float2 up = op[l - h], dn = op[l + h], ce = op[l],
                     sd = op[sl.ls];
        xy::Site st;
        st.idx = base + w;
        st.cx = ce.x;
        st.cy = ce.y;
        st.hx = __fadd_rn(__fadd_rn(up.x, dn.x), __fadd_rn(ce.x, sd.x));
        st.hy = __fadd_rn(__fadd_rn(up.y, dn.y), __fadd_rn(ce.y, sd.y));
        const uint4 b = philox4x32_10(
            make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                       static_cast<uint32_t>(i), 0u),
            key);
        float cx, cy;
        xy::cos_sin_2pi(xy::u24(b.x), cx, cy);
        float2 f = sp[l];
        const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, f.x), st.hx),
                                    __fmul_rn(__fsub_rn(cy, f.y), st.hy));
        const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), a.neg_beta));
        if (xy::u24(b.y) < prob) {
          f = make_float2(cx, cy);
          sp[l] = f;
        }
        if (measuring) {
          t = xy::site_sums(st, f.x, f.y);
          if (snap) {  // xy::snap_sum on the prefetched snapshot
            const float as = __fadd_rn(__fmul_rn(f.x, sn.x),
                                       __fmul_rn(f.y, sn.y));
            const float ao = __fadd_rn(__fmul_rn(st.cx, sn.z),
                                       __fmul_rn(st.cy, sn.w));
            t.a = static_cast<double>(as) + static_cast<double>(ao);
          }
        }
      }
#endif
      if (measuring) ring::store_sums(red, q, tg, t);  // uniform
    };
    int p = g;
    for (; p < edges; p += GROUPS) update(p);
    __syncthreads();
    if (k + 1 < 2 * a.sweeps) {
      // publish this colour's first and last h updated sites, then the
      // flag, before the other chunks
      float2* e = ring.edges + (static_cast<size_t>(blockIdx.x) * 2 + c) * 2 * h;
      for (int l = tid; l < h; l += T) {
        e[l] = sp[h + l];
        e[h + l] = sp[m + l];
      }
      __syncthreads();
      ring::publish(ring.flags, static_cast<unsigned>(k + 1), tid);
    }
    for (; p < nch; p += GROUPS) update(p);
    __syncthreads();
    if (measuring)
      ring::chunk_partials(
          a.partials +
              ((static_cast<size_t>(r) * a.sweeps + s) * nblk + c0) * NSUMS,
          red, nch, tid);
  }
  for (int l = tid; l < m; l += T) {
    const size_t o = base + lo + l;
    const float2 u = plane0[h + l], v = plane1[h + l];
    a.ax[o] = u.x;
    a.ay[o] = u.y;
    a.bx[o] = v.x;
    a.by[o] = v.y;
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

Multisweep make_args(void* ax, void* ay, void* bx, void* by,
                     const void* const* snap, const void* seeds,
                     void* partials, int nrep, int ny, int half, int sweeps,
                     float neg_beta) {
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
  a.partials = static_cast<double*>(partials);
  a.nrep = nrep;
  a.ny = ny;
  a.half = half;
  a.sweeps = sweeps;
  a.neg_beta = neg_beta;
  return a;
}

// The launch's reduce_kernel where it measures
int finish(void* partials, void* obs, int rows, int nblk, cudaStream_t st) {
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || partials == nullptr) return code;
  xy::reduce_kernel<NSUMS><<<rows, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

int check_args(int nrep, int ny, int half, int sweeps, const void* seeds,
               const void* partials, const void* obs) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if (sweeps < 1 || seeds == nullptr ||
      (partials == nullptr) != (obs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// Blocks of multisweep_kernel's cooperative grid: as many as can be
// resident at once on the current device (0 if none fits).
int xy_multisweep_grid(int* blocks) { return grid_blocks(blocks); }

// What smem_layout needs of the current device: its SMs, the blocks of
// smem_multisweep_kernel an SM holds at once by its threads, registers and
// barriers (shared memory aside), the shared memory one block may take
// (opt-in), an SM's shared memory and what the runtime reserves a block.
int xy_multisweep_smem_limits(int* sms, int* per_sm, int* smem_block,
                              int* smem_sm, int* reserved) {
  return ring::smem_limits(
      reinterpret_cast<const void*>(smem_multisweep_kernel), sms, per_sm,
      smem_block, smem_sm, reserved);
}

// multisweep_kernel: S = sweeps Metropolis sweeps of (nrep, ny, half)
// planes in place, one cooperative launch; seeds (S, 2, 2) int32 on the
// device.  With partials ((nrep, S, chunks, 4) float64) and obs
// ((nrep, S, 4) float64) non-null each sweep's (Σ S_x, Σ S_y, e, A) lands
// in obs (reduce_kernel after the launch); snap null (A = 0) or the four
// t=0 snapshot planes (ax, ay, bx, by).
int xy_multisweep(void* ax, void* ay, void* bx, void* by,
                  const void* const* snap, const void* seeds,
                  void* partials, void* obs, int nrep, int ny, int half,
                  int sweeps, float neg_beta, void* stream) {
  if (int bad = check_args(nrep, ny, half, sweeps, seeds, partials, obs))
    return bad;
  int resident = 0;
  if (int err = grid_blocks(&resident)) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const long long items = static_cast<long long>(nrep) * nblk;
  const int blocks = items < resident ? static_cast<int>(items) : resident;
  Multisweep a = make_args(ax, ay, bx, by, snap, seeds, partials, nrep, ny,
                           half, sweeps, neg_beta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(multisweep_kernel), dim3(blocks),
      dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return finish(partials, obs, nrep * sweeps, nblk, st);
}

// smem_multisweep_kernel: the same sweeps and sums as xy_multisweep on
// the ring layout of ops/xy2d_resident.smem_layout: nb blocks a replica,
// block j owning chunks bounds[j] .. bounds[j+1] - 1 ((nb + 1) int32 on
// the device), at most cap sites, in smem bytes of dynamic shared memory
// (16 (cap + 2 half) + CHUNK_BYTES a chunk of cap); edges (nrep nb x 4 half
// float2) and flags (nrep nb uint32) scratch on the device, the flags
// cleared here on the stream.  A grid that cannot be resident at once
// returns cudaErrorCooperativeLaunchTooLarge.
int xy_multisweep_smem(void* ax, void* ay, void* bx, void* by,
                       const void* const* snap, const void* seeds,
                       void* partials, void* obs, const void* bounds,
                       void* edges, void* flags, int nrep, int ny, int half,
                       int sweeps, int nb, int cap, int smem,
                       float neg_beta, void* stream) {
  if (int bad = check_args(nrep, ny, half, sweeps, seeds, partials, obs))
    return bad;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const long long span = static_cast<long long>(cap) + 2LL * half;
  if (nb < 1 || cap < half || cap % THREADS != 0 || bounds == nullptr ||
      edges == nullptr || flags == nullptr ||
      static_cast<long long>(nrep) * nb > 0x7fffffffLL ||
      smem < 16 * span + static_cast<long long>(cap / THREADS) * CHUNK_BYTES)
    return invalid;
  const void* fn = reinterpret_cast<const void*>(smem_multisweep_kernel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = ring::prepare(fn, smem, static_cast<long long>(nrep) * nb,
                              static_cast<unsigned*>(flags), st))
    return err;
  Multisweep a = make_args(ax, ay, bx, by, snap, seeds, partials, nrep, ny,
                           half, sweeps, neg_beta);
  Ring ring;
  ring.bounds = static_cast<const int32_t*>(bounds);
  ring.edges = static_cast<float2*>(edges);
  ring.flags = static_cast<unsigned*>(flags);
  ring.nb = nb;
  ring.span = static_cast<int>(span);
  ring.chunks = cap / THREADS;
  void* args[] = {&a, &ring};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(nrep * nb), dim3(THREADS * GROUPS), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return finish(partials, obs, nrep * sweeps, (ny * half + THREADS - 1) /
                                                  THREADS, st);
}

const char* xy_multisweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
