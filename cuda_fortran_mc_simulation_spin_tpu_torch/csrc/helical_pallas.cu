// The masked helical kernels on Hopper (sm_90a): every helical 2-D shape
// (odd nx, any ny >= 2) of the Ising, clock and XY models on flat states.
//
//   ising_multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/
//                     ops/helical_pallas.py:_ising_kernel (pallas_call at
//                     :216, _ising_multisweep): S sweeps (colour 0, then
//                     colour 1) of (R, N) int8 ±1 states, in place, with
//                     the exact int64 (m, e) of every sweep;
//   clock_multisweep_kernel replaces _clock_kernel (:373,
//                     _clock_multisweep): the same for the q-state clock,
//                     2 <= q <= 127, float64 (Σ cos, Σ sin, E);
//   xy_phase_kernel   replaces _xy_phase_kernel (:555, _xy_phase): one
//                     Metropolis phase of (R, N) float32 component planes,
//                     out of place; mode FUSED adds the float64 sums of the
//                     new state (even N), mode MEASURE takes the sums of a
//                     state and updates nothing;
//   xy_or_kernel      replaces _xy_or_kernel (:579, _xy_or_phase): one
//                     over-relaxation phase, out of place.
//
// Layout (ops/helical_pallas.py): site idx of a replica neighbours idx ± 1
// and idx ± nx mod N; colour c holds idx = 2k + c.  Fields are summed
// ((up + dn) + left) + right, up = idx - nx, the TPU kernels' order.  The
// TPU kernels' (ny, 128-lane) view, row tiles and x-seam fixups are TPU
// layout: the flat index is the same site.
//
// Odd N: same-colour neighbours meet across the wrap (rows 0 and ny-1, and
// idx 0 with N-1).  A phase reads their pre-phase values: the XY kernels
// write out of place; the multisweep kernels copy rows 0 and ny-1 into a
// snapshot before each phase (a grid barrier between) and read those rows
// from it.  At even N the colouring is proper and each sweep's energy is
// fused into the colour-1 phase (-Σ_1 s·Σnbr, each bond once); at odd N it
// is taken in a pass over the final state after the last barrier.
//
// Random words: the unit's one Philox4x32-10 call at counter
// (replica, unit, 0, 0) under the phase key; an Ising unit is four colour
// sites (site k takes output k & 3), a clock or XY unit two (site k takes
// outputs 2(k & 1) and 2(k & 1) + 1, uniforms from their top 24 bits).
//
// Bounds on the H100.  The multisweep kernels: operations (a launch reads
// and writes the states once, then runs 2 S phases of ~30 (Ising) or ~80
// (clock) instructions a site, Philox included; the states of the main
// paths, 4-128 MB, stay in the 50 MB L2 or stream through it).  The XY
// kernels: bytes (each site's 8 B read and written, 16 B a site a phase
// out of place; the Metropolis phase adds half a Philox call, the trig and
// expf a site of the colour, ~70 instructions).
//
// Every float32 operation of an update is spelled __fadd_rn / __fmul_rn /
// __fsub_rn in the plain version's order (no FMA contraction); expf and
// rsqrtf are the functions torch.exp and torch.rsqrt call on CUDA tensors,
// so kernel and plain version agree bitwise on the card.  Sums: int64
// atomics (Ising, exact in any order), else float64 per block in a fixed
// order and per (replica, sweep) by xy::reduce_kernel: no float atomics.
#include <cooperative_groups.h>

#include "clock_int8.cuh"
#include "ising_int8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

struct Flat {
  int n;    // sites a replica
  int nx;   // odd
  int m0;   // colour-0 sites, ceil(n / 2); colour 1 has n / 2
};

__device__ __forceinline__ int colour_sites(const Flat& f, int c) {
  return c ? f.n / 2 : f.m0;
}

__device__ __forceinline__ int wrapn(int j, int n) {
  return j < 0 ? j + n : (j >= n ? j - n : j);
}

// Site j of a replica's state as of the phase's start: in place the state
// holds it, except at odd N for rows 0 and ny-1, whose snapshot (row 0,
// then row ny-1) is read instead.  The loads bypass L1: other SMs wrote
// the state before the last grid barrier.
template <bool ODD, typename T>
__device__ __forceinline__ T at(const T* x, const T* seam, const Flat& f,
                                int j) {
  if (ODD) {
    if (j < f.nx) return __ldcg(seam + j);
    if (j >= f.n - f.nx) return __ldcg(seam + (j - (f.n - 2 * f.nx)));
  }
  return __ldcg(x + j);
}

// The four neighbour indices of idx: up, dn, left, right
struct Nbrs {
  int up, dn, left, right;
};

__device__ __forceinline__ Nbrs nbrs_of(const Flat& f, int idx) {
  Nbrs b;
  b.up = wrapn(idx - f.nx, f.n);
  b.dn = wrapn(idx + f.nx, f.n);
  b.left = wrapn(idx - 1, f.n);
  b.right = wrapn(idx + 1, f.n);
  return b;
}

// Copies rows 0 and ny-1 of every replica into seam (R, 2 nx); the caller
// waits at a grid barrier before reading it.
template <typename T>
__device__ __forceinline__ void copy_seam(const T* x, T* seam, const Flat& f,
                                          int nrep) {
  const long long per = 2LL * f.nx;
  const long long total = per * nrep;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = i / per;
    const int p = static_cast<int>(i - r * per);
    const int src = p < f.nx ? p : f.n - 2 * f.nx + p;
    seam[i] = __ldcg(x + r * f.n + src);
  }
}

// ---------------------------------------------------------------------------
// Ising
// ---------------------------------------------------------------------------

struct IsingMs {
  int8_t* x;              // (R, N), updated in place
  int8_t* seam;           // (R, 2 nx) snapshot at odd N, else null
  const int32_t* seeds;   // (S, 2, 2) Philox keys per (sweep, colour)
  const uint32_t* bits;   // (S, 2, R, m0) injected words, or null
  long long* obs;         // (R, S, 2), zeroed by the caller
  int nrep, sweeps;
  uint32_t t4, t8;
};

// Unit j (colour sites 4j .. 4j+3) of colour c of one replica.  With
// MEASURE (colour 1 at even N) it adds m += new + the colour-0 site before
// it and e -= new * nsum (the colour-0 sites are final: each bond once).
template <bool ODD, bool MEASURE>
__device__ __forceinline__ void ising_unit(int8_t* x, const int8_t* seam,
                                           const Flat& f, int c, int r,
                                           int j, uint2 key,
                                           const uint32_t* bits,
                                           uint32_t t4, uint32_t t8, int& m,
                                           int& e) {
  const int mc = colour_sites(f, c);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (bits == nullptr)
    w = philox4x32_10(make_uint4(static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(j), 0u, 0u),
                      key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * j + i;
    if (k >= mc) break;
    const int idx = 2 * k + c;
    const Nbrs b = nbrs_of(f, idx);
    const int nsum = ((static_cast<int>(at<ODD>(x, seam, f, b.up)) +
                       static_cast<int>(at<ODD>(x, seam, f, b.dn))) +
                      static_cast<int>(at<ODD>(x, seam, f, b.left))) +
                     static_cast<int>(at<ODD>(x, seam, f, b.right));
    const int s = static_cast<int>(__ldcg(x + idx));
    const int kk = s * nsum;
    const uint32_t word = bits != nullptr ? __ldg(bits + k) : ws[i];
    const int out = (kk <= 0 || word < (kk == 2 ? t4 : t8)) ? -s : s;
    x[idx] = static_cast<int8_t>(out);
    if (MEASURE) {
      m += out + static_cast<int>(__ldcg(x + idx - 1));
      e -= out * nsum;
    }
  }
}

// (m, e) of unit j of both colours over the final state: every site once,
// e over its bonds to idx + 1 and idx + nx (each bond once).
__device__ __forceinline__ void ising_measure_unit(const int8_t* x,
                                                   const Flat& f, int j,
                                                   int& m, int& e) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int mc = colour_sites(f, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;
      if (k >= mc) break;
      const int idx = 2 * k + c;
      const int s = __ldcg(x + idx);
      m += s;
      e -= s * (static_cast<int>(__ldcg(x + wrapn(idx + 1, f.n))) +
                static_cast<int>(__ldcg(x + wrapn(idx + f.nx, f.n))));
    }
  }
}

template <bool ODD>
__global__ void __launch_bounds__(THREADS)
    ising_multisweep_kernel(IsingMs ms, Flat f) {
  cg::grid_group grid = cg::this_grid();
  const int units = (f.m0 + 3) / 4;
  const int chunks = (units + THREADS - 1) / THREADS;
  const int tiles = ms.nrep * chunks;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      if (ODD) {
        copy_seam(ms.x, ms.seam, f, ms.nrep);
        grid.sync();
      }
      const uint2 key =
          make_uint2(static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2]),
                     static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2 + 1]));
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const int j = (t - r * chunks) * THREADS + threadIdx.x;
        int8_t* x = ms.x + static_cast<size_t>(r) * f.n;
        const int8_t* seam =
            ODD ? ms.seam + static_cast<size_t>(r) * 2 * f.nx : nullptr;
        const uint32_t* bits =
            ms.bits == nullptr
                ? nullptr
                : ms.bits + (static_cast<size_t>(2 * s + c) * ms.nrep + r) *
                                f.m0;
        int m = 0, e = 0;
        if (!ODD && c == 1) {
          if (j < units)
            ising_unit<false, true>(x, seam, f, c, r, j, key, bits, ms.t4,
                                    ms.t8, m, e);
          ising8::block_add(
              m, e, ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2);
        } else if (j < units) {
          ising_unit<ODD, false>(x, seam, f, c, r, j, key, bits, ms.t4,
                                 ms.t8, m, e);
        }
      }
      grid.sync();
    }
    if (ODD) {
      // the exact sums of the final state; the next sweep's snapshot only
      // reads the state too, so no barrier is needed before it
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const int j = (t - r * chunks) * THREADS + threadIdx.x;
        int m = 0, e = 0;
        if (j < units)
          ising_measure_unit(ms.x + static_cast<size_t>(r) * f.n, f, j, m,
                             e);
        ising8::block_add(
            m, e, ms.obs + (static_cast<size_t>(r) * ms.sweeps + s) * 2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// clock
// ---------------------------------------------------------------------------

struct ClockMs {
  int8_t* x;              // (R, N) states in [0, q), updated in place
  int8_t* seam;           // (R, 2 nx) snapshot at odd N, else null
  const int32_t* seeds;   // (S, 2, 2)
  const float* ucand;     // (S, 2, R, m0) injected uniforms, or null
  const float* uacc;
  const float* tab;       // (2, 128) float32 (cos, sin)
  const double* tab64;    // (2, 128) float64 (cos, sin)
  double* partials;       // (R, S, chunks, 3)
  int nrep, sweeps, q;
  float neg_beta;
};

__device__ __forceinline__ int state(int8_t v) {
  return static_cast<int>(v) & (clock8::TABLE - 1);
}

// Unit j (colour sites 2j, 2j+1) of colour c of one replica.  With MEASURE
// (colour 1 at even N) it adds the float64 Σ cos, Σ sin of the new state
// and of the colour-0 site before it, and S_new·h over the site's bonds.
template <bool ODD, bool MEASURE>
__device__ __forceinline__ void clock_unit(int8_t* x, const int8_t* seam,
                                           const Flat& f,
                                           const clock8::Tables& tb, int c,
                                           int r, int j, uint2 key,
                                           const float* uc_row,
                                           const float* ua_row, int q,
                                           float neg_beta, xy::Sums& t) {
  const int mc = colour_sites(f, c);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (uc_row == nullptr)
    w = philox4x32_10(make_uint4(static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(j), 0u, 0u),
                      key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = 2 * j + i;
    if (k >= mc) break;
    const int idx = 2 * k + c;
    const Nbrs b = nbrs_of(f, idx);
    const int ou = state(at<ODD>(x, seam, f, b.up));
    const int od = state(at<ODD>(x, seam, f, b.dn));
    const int ol = state(at<ODD>(x, seam, f, b.left));
    const int orr = state(at<ODD>(x, seam, f, b.right));
    const float hx = __fadd_rn(
        __fadd_rn(__fadd_rn(tb.c[ou], tb.c[od]), tb.c[ol]), tb.c[orr]);
    const float hy = __fadd_rn(
        __fadd_rn(__fadd_rn(tb.s[ou], tb.s[od]), tb.s[ol]), tb.s[orr]);
    const int xs = state(__ldcg(x + idx));
    float uc, ua;
    if (uc_row != nullptr) {
      uc = __ldg(uc_row + k);
      ua = __ldg(ua_row + k);
    } else {
      uc = xy::u24(ws[2 * i]);
      ua = xy::u24(ws[2 * i + 1]);
    }
    int nw = xs + static_cast<int>(__fmul_rn(uc, static_cast<float>(q - 1))) +
             1;
    if (nw >= q) nw -= q;
    const float de = -__fadd_rn(
        __fmul_rn(__fsub_rn(tb.c[nw], tb.c[xs]), hx),
        __fmul_rn(__fsub_rn(tb.s[nw], tb.s[xs]), hy));
    const float prob = expf(__fmul_rn(neg_beta, fmaxf(de, 0.0f)));
    const int out = ua < prob ? nw : xs;
    x[idx] = static_cast<int8_t>(out);
    if (MEASURE) {
      const int xp = state(__ldcg(x + idx - 1));
      const double fc = tb.c64[out], fs = tb.s64[out];
      t.mx += fc + tb.c64[xp];
      t.my += fs + tb.s64[xp];
      t.e += fc * ((tb.c64[ou] + tb.c64[od]) + (tb.c64[ol] + tb.c64[orr])) +
             fs * ((tb.s64[ou] + tb.s64[od]) + (tb.s64[ol] + tb.s64[orr]));
    }
  }
}

// Σ cos, Σ sin and the bonds to idx + 1 and idx + nx of unit j of both
// colours over the final state (xy::reduce_kernel negates E)
__device__ __forceinline__ void clock_measure_unit(const int8_t* x,
                                                   const Flat& f,
                                                   const clock8::Tables& tb,
                                                   int j, xy::Sums& t) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int mc = colour_sites(f, c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 2 * j + i;
      if (k >= mc) break;
      const int idx = 2 * k + c;
      const int sv = state(__ldcg(x + idx));
      const int rv = state(__ldcg(x + wrapn(idx + 1, f.n)));
      const int dv = state(__ldcg(x + wrapn(idx + f.nx, f.n)));
      t.mx += tb.c64[sv];
      t.my += tb.s64[sv];
      t.e += tb.c64[sv] * (tb.c64[rv] + tb.c64[dv]) +
             tb.s64[sv] * (tb.s64[rv] + tb.s64[dv]);
    }
  }
}

template <bool ODD>
__global__ void __launch_bounds__(THREADS)
    clock_multisweep_kernel(ClockMs ms, Flat f) {
  __shared__ float tc[clock8::TABLE], ts[clock8::TABLE];
  __shared__ double tc64[clock8::TABLE], ts64[clock8::TABLE];
  clock8::stage(ms.tab, tc, ts);
  clock8::stage(ms.tab64, tc64, ts64);
  const clock8::Tables tb = {tc, ts, tc64, ts64};
  cg::grid_group grid = cg::this_grid();
  const int units = (f.m0 + 1) / 2;
  const int chunks = (units + THREADS - 1) / THREADS;
  const int tiles = ms.nrep * chunks;
  for (int s = 0; s < ms.sweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      if (ODD) {
        copy_seam(ms.x, ms.seam, f, ms.nrep);
        grid.sync();
      }
      const uint2 key =
          make_uint2(static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2]),
                     static_cast<uint32_t>(ms.seeds[(2 * s + c) * 2 + 1]));
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const int chunk = t - r * chunks;
        const int j = chunk * THREADS + threadIdx.x;
        int8_t* x = ms.x + static_cast<size_t>(r) * f.n;
        const int8_t* seam =
            ODD ? ms.seam + static_cast<size_t>(r) * 2 * f.nx : nullptr;
        const size_t row = (static_cast<size_t>(2 * s + c) * ms.nrep + r) *
                           f.m0;
        const float* uc = ms.ucand == nullptr ? nullptr : ms.ucand + row;
        const float* ua = ms.uacc == nullptr ? nullptr : ms.uacc + row;
        xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
        if (!ODD && c == 1) {
          if (j < units)
            clock_unit<false, true>(x, seam, f, tb, c, r, j, key, uc, ua,
                                    ms.q, ms.neg_beta, sums);
          xy::block_sums<3, true>(
              ms.partials, static_cast<size_t>(r) * ms.sweeps + s, chunks,
              chunk, sums);
        } else if (j < units) {
          clock_unit<ODD, false>(x, seam, f, tb, c, r, j, key, uc, ua, ms.q,
                                 ms.neg_beta, sums);
        }
      }
      grid.sync();
    }
    if (ODD) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / chunks;
        const int chunk = t - r * chunks;
        const int j = chunk * THREADS + threadIdx.x;
        xy::Sums sums = {0.0, 0.0, 0.0, 0.0};
        if (j < units)
          clock_measure_unit(ms.x + static_cast<size_t>(r) * f.n, f, tb, j,
                             sums);
        xy::block_sums<3, true>(ms.partials,
                                static_cast<size_t>(r) * ms.sweeps + s,
                                chunks, chunk, sums);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// XY
// ---------------------------------------------------------------------------

constexpr int UPDATE = 0, FUSED = 1, MEASURE = 2;

struct XYArgs {
  const float* sx;   // (R, N) input planes
  const float* sy;
  float* ox;         // (R, N) output planes (null in MEASURE mode)
  float* oy;
};

// One thread a unit of four flat sites 4j .. 4j+3: the two of colour
// `color` (colour sites 2j, 2j+1) are updated from the input planes, the
// other two copied.  FUSED adds Σ S of the four new values and S_new·h
// (h in float64 from the float32 neighbours) of the two updated ones;
// MEASURE adds Σ S and S·(S_{i+1} + S_{i+nx}) of the four, in float64.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    xy_phase_kernel(XYArgs a, Flat f, int color, const float* ucand,
                    const float* uacc, float neg_beta, uint2 key,
                    double* partials) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const size_t base = static_cast<size_t>(r) * f.n;
  const float* sx = a.sx + base;
  const float* sy = a.sy + base;
  xy::Sums t = {0.0, 0.0, 0.0, 0.0};
  if (j < (f.n + 3) / 4) {
    if (MODE == MEASURE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 4 * j + i;
        if (idx >= f.n) break;
        const int rt = wrapn(idx + 1, f.n), dn = wrapn(idx + f.nx, f.n);
        const double vx = __ldg(sx + idx), vy = __ldg(sy + idx);
        t.mx += vx;
        t.my += vy;
        t.e += vx * (static_cast<double>(__ldg(sx + rt)) +
                     static_cast<double>(__ldg(sx + dn))) +
               vy * (static_cast<double>(__ldg(sy + rt)) +
                     static_cast<double>(__ldg(sy + dn)));
      }
    } else {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (ucand == nullptr)
        w = philox4x32_10(make_uint4(static_cast<uint32_t>(r),
                                     static_cast<uint32_t>(j), 0u, 0u),
                          key);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 4 * j + i;
        if (idx >= f.n) break;
        float fx = __ldg(sx + idx), fy = __ldg(sy + idx);
        if ((idx & 1) == color) {
          const int k = idx >> 1;   // colour site 2j + (i >> 1)
          const Nbrs b = nbrs_of(f, idx);
          const float ux = __ldg(sx + b.up), dx = __ldg(sx + b.dn);
          const float lx = __ldg(sx + b.left), rx = __ldg(sx + b.right);
          const float uy = __ldg(sy + b.up), dy = __ldg(sy + b.dn);
          const float ly = __ldg(sy + b.left), ry = __ldg(sy + b.right);
          const float hx = __fadd_rn(__fadd_rn(__fadd_rn(ux, dx), lx), rx);
          const float hy = __fadd_rn(__fadd_rn(__fadd_rn(uy, dy), ly), ry);
          float uc, ua;
          if (ucand != nullptr) {
            uc = __ldg(ucand + static_cast<size_t>(r) * f.m0 + k);
            ua = __ldg(uacc + static_cast<size_t>(r) * f.m0 + k);
          } else {
            uc = xy::u24(ws[2 * (i >> 1)]);
            ua = xy::u24(ws[2 * (i >> 1) + 1]);
          }
          float cx, cy;
          xy::cos_sin_2pi(uc, cx, cy);
          const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, fx), hx),
                                      __fmul_rn(__fsub_rn(cy, fy), hy));
          const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
          if (ua < prob) {
            fx = cx;
            fy = cy;
          }
          if (MODE == FUSED)
            t.e += static_cast<double>(fx) *
                       ((static_cast<double>(ux) + static_cast<double>(dx)) +
                        (static_cast<double>(lx) + static_cast<double>(rx))) +
                   static_cast<double>(fy) *
                       ((static_cast<double>(uy) + static_cast<double>(dy)) +
                        (static_cast<double>(ly) + static_cast<double>(ry)));
        }
        a.ox[base + idx] = fx;
        a.oy[base + idx] = fy;
        if (MODE == FUSED) {
          t.mx += fx;
          t.my += fy;
        }
      }
    }
  }
  if (MODE != UPDATE) xy::block_sums<3>(partials, r, gridDim.x, blockIdx.x, t);
}

__global__ void __launch_bounds__(THREADS)
    xy_or_kernel(XYArgs a, Flat f, int color) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= (f.n + 3) / 4) return;
  const size_t base = static_cast<size_t>(r) * f.n;
  const float* sx = a.sx + base;
  const float* sy = a.sy + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = 4 * j + i;
    if (idx >= f.n) break;
    float fx = __ldg(sx + idx), fy = __ldg(sy + idx);
    if ((idx & 1) == color) {
      const Nbrs b = nbrs_of(f, idx);
      const float hx = __fadd_rn(
          __fadd_rn(__fadd_rn(__ldg(sx + b.up), __ldg(sx + b.dn)),
                    __ldg(sx + b.left)),
          __ldg(sx + b.right));
      const float hy = __fadd_rn(
          __fadd_rn(__fadd_rn(__ldg(sy + b.up), __ldg(sy + b.dn)),
                    __ldg(sy + b.left)),
          __ldg(sy + b.right));
      const float inv = rsqrtf(fmaxf(
          __fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), xy::TINY));
      const float nxh = __fmul_rn(hx, inv), nyh = __fmul_rn(hy, inv);
      const float d =
          __fmul_rn(2.0f, __fadd_rn(__fmul_rn(fx, nxh), __fmul_rn(fy, nyh)));
      const float rx = __fsub_rn(__fmul_rn(d, nxh), fx);
      const float ry = __fsub_rn(__fmul_rn(d, nyh), fy);
      const float rinv = rsqrtf(
          fmaxf(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), xy::TINY));
      fx = __fmul_rn(rx, rinv);
      fy = __fmul_rn(ry, rinv);
    }
    a.ox[base + idx] = fx;
    a.oy[base + idx] = fy;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The kernels' own refusal (the wrappers raise first): odd nx >= 3,
// ny >= 2, 1 .. 65535 replicas, no site index of a replica past 2^31.
bool make_flat(int nrep, int n, int nx, Flat* f) {
  if (nrep < 1 || nrep > 65535 || nx < 3 || (nx & 1) == 0 || n % nx != 0 ||
      n / nx < 2 ||
      static_cast<long long>(n) + 2LL * nx + 8LL * THREADS >= (1LL << 31))
    return false;
  f->n = n;
  f->nx = nx;
  f->m0 = (n + 1) / 2;
  return true;
}

const void* multisweep_fn(int kind, bool odd) {
  if (kind == 0)
    return odd ? reinterpret_cast<const void*>(ising_multisweep_kernel<true>)
               : reinterpret_cast<const void*>(ising_multisweep_kernel<false>);
  return odd ? reinterpret_cast<const void*>(clock_multisweep_kernel<true>)
             : reinterpret_cast<const void*>(clock_multisweep_kernel<false>);
}

int cooperative(const void* fn, long long tiles, void** args,
                cudaStream_t st);

}  // namespace

extern "C" {

// Blocks of a multisweep kernel's cooperative grid (kind 0 Ising, 1
// clock; odd: the odd-N instantiation) resident at once on the current
// device (0 if none fits).
int hp_grid_blocks(int kind, int odd, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multisweep_fn(kind, odd != 0), THREADS, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// S Ising sweeps of x (R, N) int8 in place under seeds (S, 2, 2), or the
// injected words bits (S, 2, R, ceil(N/2)); seam (R, 2 nx) int8 scratch
// at odd N (else null); per-sweep (m, e) into obs (R, S, 2) int64, zeroed
// by the caller.
int hp_ising_multisweep(void* x, void* seam, const void* seeds,
                        const void* bits, void* obs, int nrep, int n, int nx,
                        int sweeps, unsigned int t4, unsigned int t8,
                        void* stream) {
  Flat f;
  const bool odd = (n & 1) != 0;
  if (!make_flat(nrep, n, nx, &f) || sweeps < 1 || (odd && seam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  IsingMs ms;
  ms.x = static_cast<int8_t*>(x);
  ms.seam = static_cast<int8_t*>(seam);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.bits = static_cast<const uint32_t*>(bits);
  ms.obs = static_cast<long long*>(obs);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.t4 = t4;
  ms.t8 = t8;
  const long long units = (f.m0 + 3) / 4;
  void* args[] = {&ms, &f};
  return cooperative(multisweep_fn(0, odd),
                     nrep * ((units + THREADS - 1) / THREADS), args,
                     static_cast<cudaStream_t>(stream));
}

// S clock sweeps of x (R, N) int8 in place under seeds (S, 2, 2), or the
// injected uniforms ucand, uacc (S, 2, R, ceil(N/2)) float32; tab, tab64
// the (2, 128) float32 and float64 tables; partials (R, S, chunks, 3)
// float64 scratch, chunks = ceil(ceil(ceil(N/2) / 2) / 256); per-sweep
// (Σ cos, Σ sin, E) into obs (R, S, 3) float64.
int hp_clock_multisweep(void* x, void* seam, const void* seeds,
                        const void* ucand, const void* uacc, const void* tab,
                        const void* tab64, void* partials, void* obs,
                        int nrep, int n, int nx, int q, int sweeps,
                        float neg_beta, void* stream) {
  Flat f;
  const bool odd = (n & 1) != 0;
  if (!make_flat(nrep, n, nx, &f) || sweeps < 1 || q < 2 ||
      q >= clock8::TABLE || (odd && seam == nullptr) ||
      (ucand == nullptr) != (uacc == nullptr) ||
      static_cast<long long>(nrep) * sweeps >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  ClockMs ms;
  ms.x = static_cast<int8_t*>(x);
  ms.seam = static_cast<int8_t*>(seam);
  ms.seeds = static_cast<const int32_t*>(seeds);
  ms.ucand = static_cast<const float*>(ucand);
  ms.uacc = static_cast<const float*>(uacc);
  ms.tab = static_cast<const float*>(tab);
  ms.tab64 = static_cast<const double*>(tab64);
  ms.partials = static_cast<double*>(partials);
  ms.nrep = nrep;
  ms.sweeps = sweeps;
  ms.q = q;
  ms.neg_beta = neg_beta;
  const long long units = (f.m0 + 1) / 2;
  const int chunks = static_cast<int>((units + THREADS - 1) / THREADS);
  void* args[] = {&ms, &f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = cooperative(multisweep_fn(1, odd),
                               static_cast<long long>(nrep) * chunks, args,
                               st);
  if (code != 0) return code;
  xy::reduce_kernel<3><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs),
      chunks);
  return static_cast<int>(cudaGetLastError());
}

// One XY launch over (R, N) float32 planes sx, sy: mode 0 updates colour
// `color` into ox, oy (distinct planes); mode 1 does so and measures the
// new state (even N); mode 2 measures sx, sy and writes nothing.  ucand,
// uacc: injected uniforms (R, ceil(N/2)) float32, or both null for Philox
// words under (s0, s1).  Measuring modes: partials (R, blocks, 3) float64
// scratch, blocks = ceil(ceil(N/4) / 256), and the sums into obs (R, 3).
int hp_xy_phase(const void* sx, const void* sy, void* ox, void* oy,
                const void* ucand, const void* uacc, void* partials,
                void* obs, int nrep, int n, int nx, int color, int mode,
                float neg_beta, unsigned int s0, unsigned int s1,
                void* stream) {
  Flat f;
  if (!make_flat(nrep, n, nx, &f) || mode < UPDATE || mode > MEASURE ||
      (color & ~1) != 0 || (ucand == nullptr) != (uacc == nullptr) ||
      (mode != MEASURE && (ox == nullptr || oy == nullptr)) ||
      (mode == FUSED && (n & 1) != 0) ||
      (mode != UPDATE) != (partials != nullptr && obs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  XYArgs a;
  a.sx = static_cast<const float*>(sx);
  a.sy = static_cast<const float*>(sy);
  a.ox = static_cast<float*>(ox);
  a.oy = static_cast<float*>(oy);
  const int nblk = ((n + 3) / 4 + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uc = static_cast<const float*>(ucand);
  const float* ua = static_cast<const float*>(uacc);
  double* part = static_cast<double*>(partials);
  const dim3 grid(nblk, nrep);
  const uint2 key = make_uint2(s0, s1);
  if (mode == UPDATE)
    xy_phase_kernel<UPDATE><<<grid, THREADS, 0, st>>>(a, f, color, uc, ua,
                                                      neg_beta, key, part);
  else if (mode == FUSED)
    xy_phase_kernel<FUSED><<<grid, THREADS, 0, st>>>(a, f, color, uc, ua,
                                                     neg_beta, key, part);
  else
    xy_phase_kernel<MEASURE><<<grid, THREADS, 0, st>>>(a, f, color, uc, ua,
                                                       neg_beta, key, part);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || mode == UPDATE) return code;
  xy::reduce_kernel<3><<<nrep, THREADS, 0, st>>>(
      part, static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

// One over-relaxation phase of colour `color` from sx, sy into ox, oy.
int hp_xy_or(const void* sx, const void* sy, void* ox, void* oy, int nrep,
             int n, int nx, int color, void* stream) {
  Flat f;
  if (!make_flat(nrep, n, nx, &f) || (color & ~1) != 0 || ox == nullptr ||
      oy == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  XYArgs a;
  a.sx = static_cast<const float*>(sx);
  a.sy = static_cast<const float*>(sy);
  a.ox = static_cast<float*>(ox);
  a.oy = static_cast<float*>(oy);
  const int nblk = ((n + 3) / 4 + THREADS - 1) / THREADS;
  xy_or_kernel<<<dim3(nblk, nrep), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, f, color);
  return static_cast<int>(cudaGetLastError());
}

const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

namespace {

// A cooperative launch of `fn` over `tiles` tiles: one block a tile up to
// the blocks that can be resident at once, which then walk the rest.
int cooperative(const void* fn, long long tiles, void** args,
                cudaStream_t st) {
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, 0,
                                  st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
