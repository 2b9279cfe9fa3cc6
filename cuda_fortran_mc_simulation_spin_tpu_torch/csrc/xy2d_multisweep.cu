// S sweeps of the periodic XY model on int16 angle planes in one launch on
// Hopper (sm_90a), per-sweep sums fused.
//
//   multisweep_kernel replaces cuda_fortran_mc_simulation_spin_tpu/ops/
//                     xy2d_multisweep.py:_kernel (pallas_call at :325,
//                     _multisweep): S sweeps of (R, ny, half) int16 angle
//                     planes (θ = k·2π/2^16), each a Metropolis phase a
//                     and b with a 16-bit candidate, then with n_or > 0 n_or
//                     over-relaxation sweeps θ' = 2 rint(φ) - θ (φ the A&S
//                     atan2 polynomial in 2^16 units) and a measure pass;
//                     each sweep's (Σ S_x, Σ S_y, e, A) fused into phase b
//                     (or the measure pass), A = Σ cos 2π(θ0 - θ)/2^16
//                     against the t=0 snapshot planes.  or_only: max(n_or,
//                     1) over-relaxation sweeps and the measure pass a
//                     sweep (JAX's microcanonical test mode).
//
// The TPU kernel keeps the four planes in VMEM for S sweeps.  Here they
// stay in device memory (9 MiB at the route's largest shape, inside the
// 50 MB L2) and a cooperative grid of as many blocks as fit at once walks
// a phase's 256-site items (replica, block), waiting at a grid barrier
// before the next phase reads what it wrote: 2 + 2·n_or phases and, under
// over-relaxation, a measure pass a sweep.  Layout and neighbours:
// xy2d_site.cuh, on int16 planes, unpadded (JAX's 16-row granules and
// tiles are TPU layout).
//
// Random words: Philox under the (sweep, phase) key and counter
// (replica, row, column, 0), as metropolis_kernel draws: the candidate is
// word 0 >> 16 (an int in [0, 65535], wrapped to int16 only when stored;
// phase b's sums and A use it unwrapped, so the A argument reaches -1.5
// turns, where cos_sin_2pi's floor and & 3 are a true mod 4) and the
// uniform the top 24 bits of word 1.  Arithmetic: one rounding per
// operation in the order of ops/xy2d_multisweep.py's plain version;
// rintf rounds half to even as torch.round does.  The sums are float64 of
// the float32 site terms, per item in a fixed order (block_sums), then per
// (replica, sweep) by reduce_kernel.
//
// Bound on the H100: operations.  A Metropolis site needs ~150 32-bit
// operations (one Philox4x32-10 call, three decodes: the site, the
// candidate and each other-colour angle once, expf), an over-relaxation
// site ~70 (one decode, the atan2 polynomial with its divide), the fused
// sums a b site one more decode and two cos terms; the bytes (2 B read and
// 2 B written a site and phase, the snapshot's 4 B a sweep) are a few MB.
#include <cooperative_groups.h>

#include "xy2d_site.cuh"

namespace cg = cooperative_groups;

namespace {

using xy::Sums;
using xy::THREADS;

// int16 angle units -> turns (exact), radians -> units, and the A&S
// 4.4.49 coefficients of atan on [0, 1], rounded once from the Python
// floats of ops/xy2d_multisweep.py
constexpr float INV_TURN = 1.0f / 65536.0f;
constexpr float UNITS = static_cast<float>(65536.0 / (2.0 * 3.141592653589793));
constexpr float HALF_PI = static_cast<float>(3.141592653589793 / 2.0);
constexpr float PI = static_cast<float>(3.141592653589793);
constexpr float AT0 = static_cast<float>(0.99997726);
constexpr float AT1 = static_cast<float>(-0.33262347);
constexpr float AT2 = static_cast<float>(0.19354346);
constexpr float AT3 = static_cast<float>(-0.11643287);
constexpr float AT4 = static_cast<float>(0.05265332);
constexpr float AT5 = static_cast<float>(-0.01172120);
constexpr float HI_FLOOR = static_cast<float>(1e-30);

struct Multisweep {
  int16_t* pa;             // (R, ny, half) state, updated in place
  int16_t* pb;
  const int16_t* sa;       // t=0 snapshot
  const int16_t* sb;
  const int32_t* seeds;    // (S, 2, 2) Philox keys per (sweep, phase)
  double* partials;        // (R, S, nblk, 4)
  int nrep, ny, half, sweeps, n_or, or_only;
  float neg_beta;
};

__device__ __forceinline__ void cs16(int k, float& c, float& s) {
  xy::cos_sin_2pi(__fmul_rn(static_cast<float>(k), INV_TURN), c, s);
}

__device__ __forceinline__ float cos16(int dk) {
  float c, s;
  cs16(dk, c, s);
  return c;
}

// atan2(y, x) in 2^16 angle units: JAX's _atan2_units in its order
__device__ __forceinline__ float atan2_units(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float lo = fminf(ax, ay), hi = fmaxf(ax, ay);
  const float z = __fdiv_rn(lo, fmaxf(hi, HI_FLOOR));
  const float z2 = __fmul_rn(z, z);
  float p = __fadd_rn(AT4, __fmul_rn(z2, AT5));
  p = __fadd_rn(AT3, __fmul_rn(z2, p));
  p = __fadd_rn(AT2, __fmul_rn(z2, p));
  p = __fadd_rn(AT1, __fmul_rn(z2, p));
  p = __fadd_rn(AT0, __fmul_rn(z2, p));
  float a = __fmul_rn(z, p);
  if (ay > ax) a = __fsub_rn(HALF_PI, a);
  if (x < 0.0f) a = __fsub_rn(PI, a);
  if (y < 0.0f) a = -a;
  return __fmul_rn(a, UNITS);
}

// The field at site w of `color` from the other colour's plane o:
// (up + dn) + (centre + side) of the decoded components; also the
// decoded centre (ox, oy) and its angle
struct Field {
  xy::Nbrs n;
  float hx, hy, ox, oy;
  int ko;
};

__device__ __forceinline__ Field field(const int16_t* o, int ny, int half,
                                       int color, int r, int w) {
  Field f;
  f.n = xy::neighbours(ny, half, color, r, w);
  float ux, uy, dx, dy, sx, sy;
  cs16(o[f.n.up], ux, uy);
  cs16(o[f.n.dn], dx, dy);
  f.ko = o[f.n.idx];
  cs16(f.ko, f.ox, f.oy);
  cs16(o[f.n.side], sx, sy);
  f.hx = __fadd_rn(__fadd_rn(ux, dx), __fadd_rn(f.ox, sx));
  f.hy = __fadd_rn(__fadd_rn(uy, dy), __fadd_rn(f.oy, sy));
  return f;
}

// The site terms of a b site with components (bx, by) and angle kb, and
// colour a's decoded (f.ox, f.oy) and angle f.ko at the same (y, i)
__device__ __forceinline__ Sums b_sums(const Multisweep& a, const Field& f,
                                       float bx, float by, int kb) {
  Sums t;
  t.mx = static_cast<double>(f.ox) + static_cast<double>(bx);
  t.my = static_cast<double>(f.oy) + static_cast<double>(by);
  t.e = static_cast<double>(
      __fadd_rn(__fmul_rn(bx, f.hx), __fmul_rn(by, f.hy)));
  t.a = static_cast<double>(cos16(static_cast<int>(a.sa[f.n.idx]) - f.ko)) +
        static_cast<double>(cos16(static_cast<int>(a.sb[f.n.idx]) - kb));
  return t;
}

// One Metropolis update of site w of `color` (replica r); with `measure`
// (phase b) returns the site's sums, else zeros
__device__ __forceinline__ Sums metropolis(const Multisweep& a, int color,
                                           int r, int w, uint2 key,
                                           bool measure) {
  int16_t* x = color ? a.pb : a.pa;
  const int16_t* o = color ? a.pa : a.pb;
  const Field f = field(o, a.ny, a.half, color, r, w);
  const int k = x[f.n.idx];
  float cx, sx;
  cs16(k, cx, sx);
  const uint4 b = xy::site_words(r, w, a.half, key);
  const int cand = static_cast<int>(b.x >> 16);
  float cc, cs;
  cs16(cand, cc, cs);
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cc, cx), f.hx),
                              __fmul_rn(__fsub_rn(cs, sx), f.hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), a.neg_beta));
  const bool accept = xy::u24(b.y) < prob;
  if (accept) x[f.n.idx] = static_cast<int16_t>(cand);
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (measure)
    t = b_sums(a, f, accept ? cc : cx, accept ? cs : sx, accept ? cand : k);
  return t;
}

__device__ __forceinline__ void over_relax(const Multisweep& a, int color,
                                           int r, int w) {
  int16_t* x = color ? a.pb : a.pa;
  const int16_t* o = color ? a.pa : a.pb;
  const Field f = field(o, a.ny, a.half, color, r, w);
  const float phi = atan2_units(f.hy, f.hx);
  x[f.n.idx] = static_cast<int16_t>(2 * static_cast<int>(rintf(phi)) -
                                    static_cast<int>(x[f.n.idx]));
}

__device__ __forceinline__ Sums measure_site(const Multisweep& a, int r,
                                             int w) {
  const Field f = field(a.pa, a.ny, a.half, 1, r, w);
  const int kb = a.pb[f.n.idx];
  float bx, by;
  cs16(kb, bx, by);
  return b_sums(a, f, bx, by, kb);
}

// Phase kinds of a sweep
enum Kind { METRO_A, METRO_B, METRO_B_MEASURE, OR_A, OR_B, MEASURE };

__device__ __forceinline__ void run_phase(const Multisweep& a, Kind kind,
                                          int s) {
  const int n = a.ny * a.half;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int items = a.nrep * nblk;
  const bool sums = kind == METRO_B_MEASURE || kind == MEASURE;  // uniform
  uint2 key = make_uint2(0u, 0u);
  if (kind <= METRO_B_MEASURE) {
    const int c = kind == METRO_A ? 0 : 1;
    key = make_uint2(static_cast<uint32_t>(a.seeds[(2 * s + c) * 2]),
                     static_cast<uint32_t>(a.seeds[(2 * s + c) * 2 + 1]));
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r = item / nblk, blk = item - r * nblk;
    const int w = blk * THREADS + threadIdx.x;
    Sums t = {0.0, 0.0, 0.0, 0.0};
    if (w < n) {
      switch (kind) {
        case METRO_A: metropolis(a, 0, r, w, key, false); break;
        case METRO_B: metropolis(a, 1, r, w, key, false); break;
        case METRO_B_MEASURE: t = metropolis(a, 1, r, w, key, true); break;
        case OR_A: over_relax(a, 0, r, w); break;
        case OR_B: over_relax(a, 1, r, w); break;
        case MEASURE: t = measure_site(a, r, w); break;
      }
    }
    if (sums)
      xy::block_sums<xy::NSUMS, true>(
          a.partials, static_cast<size_t>(r) * a.sweeps + s, nblk, blk, t);
  }
}

__global__ void __launch_bounds__(THREADS) multisweep_kernel(Multisweep a) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < a.sweeps; ++s) {
    int n_or = a.n_or;
    if (a.or_only) {
      n_or = n_or > 1 ? n_or : 1;
    } else {
      run_phase(a, METRO_A, s);
      grid.sync();
      run_phase(a, n_or == 0 ? METRO_B_MEASURE : METRO_B, s);
      grid.sync();
    }
    if (a.or_only || n_or > 0) {
      for (int j = 0; j < n_or; ++j) {
        run_phase(a, OR_A, s);
        grid.sync();
        run_phase(a, OR_B, s);
        grid.sync();
      }
      run_phase(a, MEASURE, s);
      grid.sync();
    }
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
int xyi_grid(int* blocks) { return grid_blocks(blocks); }

// S = sweeps sweeps of the (nrep, ny, half) int16 planes pa, pb in place,
// one cooperative launch; sa, sb the t=0 snapshot planes; seeds (S, 2, 2)
// int32 on the device; partials (nrep, S, blocks, 4) float64 scratch; obs
// (nrep, S, 4) float64 the per-sweep (Σ S_x, Σ S_y, e, A) (reduce_kernel
// after the launch).  A batch whose site index could reach 2^31 is
// refused.
int xyi_multisweep(void* pa, void* pb, const void* sa, const void* sb,
                   const void* seeds, void* partials, void* obs, int nrep,
                   int ny, int half, int sweeps, int n_or, int or_only,
                   float neg_beta, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if (sweeps < 1 || n_or < 0 || seeds == nullptr || partials == nullptr ||
      obs == nullptr ||
      static_cast<long long>(nrep) * ny * half >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  if (int err = grid_blocks(&resident)) return err;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int nblk = (ny * half + THREADS - 1) / THREADS;
  const long long items = static_cast<long long>(nrep) * nblk;
  const int blocks = items < resident ? static_cast<int>(items) : resident;
  Multisweep a;
  a.pa = static_cast<int16_t*>(pa);
  a.pb = static_cast<int16_t*>(pb);
  a.sa = static_cast<const int16_t*>(sa);
  a.sb = static_cast<const int16_t*>(sb);
  a.seeds = static_cast<const int32_t*>(seeds);
  a.partials = static_cast<double*>(partials);
  a.nrep = nrep;
  a.ny = ny;
  a.half = half;
  a.sweeps = sweeps;
  a.n_or = n_or;
  a.or_only = or_only;
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
  if (code != 0) return code;
  xy::reduce_kernel<xy::NSUMS><<<nrep * sweeps, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

const char* xyi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
