// S sweeps of the periodic XY model on int16 angle planes in one launch on
// Hopper (sm_90a), per-sweep sums fused.
//
//   smem_multisweep_kernel and multisweep_kernel, two modes of one
//                     function, replace cuda_fortran_mc_simulation_spin_tpu/
//                     ops/xy2d_multisweep.py:_kernel (pallas_call at :325,
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
// The TPU kernel keeps the four planes in VMEM for S sweeps.  Here two
// modes of one function:
//
//   smem_multisweep_kernel  the lattice in the SMs' shared memory, ring
//                           flags between phases: every batch whose state
//                           fits the grid's shared memory
//                           (ops/xy2d_multisweep.smem_layout, e.g. one
//                           1536x1536 replica);
//   multisweep_kernel       the planes in device memory (9 MiB at the
//                           route's largest shape, inside the 50 MB L2), a
//                           grid barrier between phases: the larger
//                           batches.
//
// smem_multisweep_kernel gives each replica a ring of 1024-thread blocks,
// one an SM (xy2d_ring.cuh, as xy2d_resident.cu's): block j owns the
// 256-site chunks bounds[j] .. bounds[j+1] - 1 of both colours' int16
// planes and, where the fit rule allows, of the t=0 snapshot planes, holds
// them in shared memory for the launch's S sweeps and writes the state back
// once.  Each updating phase (Metropolis or over-relaxation) first waits on
// its ring neighbours' flags and decodes every angle of the other colour
// it reads once, into a shared float32 (cos, sin) plane: its own sites and
// its halos, the neighbours' edge sites read through L2 (at the first
// phase from the planes); a site then reads its four neighbours'
// components from there, where multisweep_kernel decodes each other-colour
// angle four times a phase.  The phase updates the chunks holding its
// first and last `half` sites first, publishes those int16 sites to the
// colour's edge buffer and sets its flag, then updates its other chunks.
// The measure pass after the over-relaxation sweeps reads the decoded
// colour a that the last phase b left in shared memory; it writes nothing
// the neighbours read, so it neither waits nor publishes.  No grid barrier
// in the launch.
//
// multisweep_kernel walks a phase's 256-site items (replica, block) with a
// cooperative grid of as many blocks as fit at once, waiting at a grid
// barrier before the next phase reads what it wrote: 2 + 2·n_or phases
// and, under over-relaxation, a measure pass a sweep.  Layout and
// neighbours: xy2d_site.cuh, on int16 planes, unpadded (JAX's 16-row
// granules and tiles are TPU layout).
//
// Random words: Philox under the (sweep, phase) key and counter
// (replica, row, column, 0), as metropolis_kernel draws: the candidate is
// word 0 >> 16 (an int in [0, 65535], wrapped to int16 only when stored;
// phase b's sums and A use it unwrapped, so the A argument reaches -1.5
// turns, where cos_sin_2pi's floor and & 3 are a true mod 4) and the
// uniform the top 24 bits of word 1.  Arithmetic: one rounding per
// operation in the order of ops/xy2d_multisweep.py's plain version;
// rintf rounds half to even as torch.round does.  The sums are float64 of
// the float32 site terms, per 256-site chunk in a fixed order (block_sums;
// the ring's warp sums in the same tree), then per (replica, sweep) by
// reduce_kernel: both modes give the same (R, S, chunks, 4) partials.
//
// Bound on the H100: operations.  A Metropolis site needs ~150 32-bit
// operations (one Philox4x32-10 call, three decodes: the site, the
// candidate and each other-colour angle once, expf), an over-relaxation
// site ~70 (one decode, the atan2 polynomial with its divide), the fused
// sums a b site one more decode and two cos terms; the bytes (2 B read and
// 2 B written a site and phase, the snapshot's 4 B a sweep) are a few MB.
#include <cooperative_groups.h>

#include "xy2d_ring.cuh"
#include "xy2d_site.cuh"

namespace cg = cooperative_groups;

namespace {

using ring::CHUNK_BYTES;
using ring::GROUPS;
using xy::NSUMS;
using xy::Sums;
using xy::THREADS;
using xy::WARPS;

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

// The site terms of a b site with components (bx, by) and angle kb in the
// field (hx, hy), colour a's decoded (ox, oy) and angle ko at the same
// (y, i), and the snapshot angles (s_a, s_b) there
__device__ __forceinline__ Sums b_sums(float ox, float oy, float hx,
                                       float hy, float bx, float by, int kb,
                                       int ko, int s_a, int s_b) {
  Sums t;
  t.mx = static_cast<double>(ox) + static_cast<double>(bx);
  t.my = static_cast<double>(oy) + static_cast<double>(by);
  t.e = static_cast<double>(__fadd_rn(__fmul_rn(bx, hx), __fmul_rn(by, hy)));
  t.a = static_cast<double>(cos16(s_a - ko)) +
        static_cast<double>(cos16(s_b - kb));
  return t;
}

// A Metropolis step of a site of angle kx in the field (hx, hy) with its
// Philox words b: the candidate word 0 >> 16 replaces kx iff the top 24
// bits of word 1 fall below exp(-β max(ΔE, 0)); the angle after the step
// (the candidate unwrapped), its components and whether it moved
struct Step {
  int k;
  float x, y;
  bool accept;
};

__device__ __forceinline__ Step metro_step(float hx, float hy, int kx,
                                           uint4 b, float neg_beta) {
  float cx, sx;
  cs16(kx, cx, sx);
  const int cand = static_cast<int>(b.x >> 16);
  float cc, cs;
  cs16(cand, cc, cs);
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cc, cx), hx),
                              __fmul_rn(__fsub_rn(cs, sx), hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
  const bool accept = xy::u24(b.y) < prob;
  return accept ? Step{cand, cc, cs, true} : Step{kx, cx, sx, false};
}

// The over-relaxed angle of a site of angle kx in the field (hx, hy):
// 2 rint(φ) - kx, φ = atan2_units(hy, hx)
__device__ __forceinline__ int16_t reflect(float hx, float hy, int kx) {
  return static_cast<int16_t>(
      2 * static_cast<int>(rintf(atan2_units(hy, hx))) - kx);
}

// One Metropolis update of site w of `color` (replica r); with `measure`
// (phase b) returns the site's sums, else zeros
__device__ __forceinline__ Sums metropolis(const Multisweep& a, int color,
                                           int r, int w, uint2 key,
                                           bool measure) {
  int16_t* x = color ? a.pb : a.pa;
  const int16_t* o = color ? a.pa : a.pb;
  const Field f = field(o, a.ny, a.half, color, r, w);
  const Step st = metro_step(f.hx, f.hy, x[f.n.idx],
                             xy::site_words(r, w, a.half, key), a.neg_beta);
  if (st.accept) x[f.n.idx] = static_cast<int16_t>(st.k);
  Sums t = {0.0, 0.0, 0.0, 0.0};
  if (measure)
    t = b_sums(f.ox, f.oy, f.hx, f.hy, st.x, st.y, st.k, f.ko,
               a.sa[f.n.idx], a.sb[f.n.idx]);
  return t;
}

__device__ __forceinline__ void over_relax(const Multisweep& a, int color,
                                           int r, int w) {
  int16_t* x = color ? a.pb : a.pa;
  const int16_t* o = color ? a.pa : a.pb;
  const Field f = field(o, a.ny, a.half, color, r, w);
  x[f.n.idx] = reflect(f.hx, f.hy, x[f.n.idx]);
}

__device__ __forceinline__ Sums measure_site(const Multisweep& a, int r,
                                             int w) {
  const Field f = field(a.pa, a.ny, a.half, 1, r, w);
  const int kb = a.pb[f.n.idx];
  float bx, by;
  cs16(kb, bx, by);
  return b_sums(f.ox, f.oy, f.hx, f.hy, bx, by, kb, f.ko, a.sa[f.n.idx],
                a.sb[f.n.idx]);
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

// The ring layout of smem_multisweep_kernel (ops/xy2d_multisweep.smem_layout)
using Ring = ring::Ring<int16_t>;

// Shared memory (ops/xy2d_multisweep.smem_layout): the other colour
// decoded, a float2 a slot of span = cap + 2 half (slot l: site lo - h + l,
// the owned sites at h .. h + m - 1 and the halos around them); the chunks'
// warp sums and first sites; the owned int16 sites of colours a and b
// (cap each, site lo + l at l) and, with snap_smem, of the snapshot's.
__global__ void __launch_bounds__(ring::BLOCK, 1)
    smem_multisweep_kernel(Multisweep a, Ring rg, int snap_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const dec = reinterpret_cast<float2*>(smem);
  double* const red = reinterpret_cast<double*>(dec + rg.span);
  int2* const rows = reinterpret_cast<int2*>(red + rg.chunks * NSUMS * WARPS);
  const int cap = rg.chunks * THREADS;
  int16_t* const own0 = reinterpret_cast<int16_t*>(rows + rg.chunks);
  int16_t* const own1 = own0 + cap;
  int16_t* const sn0 = own1 + cap;
  int16_t* const sn1 = sn0 + cap;
  const int h = a.half, n = a.ny * h;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int r = blockIdx.x / rg.nb, j = blockIdx.x - r * rg.nb;
  const int c0 = rg.bounds[j], nch = rg.bounds[j + 1] - c0;
  const int lo = c0 * THREADS, m = min(nch * THREADS, n - lo);
  const int prev = r * rg.nb + (j == 0 ? rg.nb - 1 : j - 1);
  const int next = r * rg.nb + (j == rg.nb - 1 ? 0 : j + 1);
  const size_t base = static_cast<size_t>(r) * n;
  constexpr int T = ring::BLOCK;
  const int tid = threadIdx.x;
  for (int l = tid; l < m; l += T) {
    const size_t o = base + lo + l;
    own0[l] = a.pa[o];
    own1[l] = a.pb[o];
    if (snap_smem) {
      sn0[l] = a.sa[o];
      sn1[l] = a.sb[o];
    }
  }
  // the snapshot's owned sites, in shared or device memory
  const int16_t* const snap_a = snap_smem ? sn0 : a.sa + base + lo;
  const int16_t* const snap_b = snap_smem ? sn1 : a.sb + base + lo;
  ring::chunk_rows(rows, c0, nch, h, tid);
  __syncthreads();
  const int g = tid / THREADS, tg = tid & (THREADS - 1);
  const int dy = tg / h, di = tg - dy * h;
  const ring::Walk walk(h, m, nch);
  const int n_or = a.or_only ? (a.n_or > 1 ? a.n_or : 1) : a.n_or;
  // updating phases of the launch: each waits on the k its neighbours
  // published and publishes k + 1 (but the last)
  const int phases = a.sweeps * ((a.or_only ? 0 : 2) + 2 * n_or);
  // The other colour's angles decoded into dec: its halos from the ring
  // neighbours' edges (phase 0: from the planes, which the neighbours write
  // back only after waiting on this block's later flags), its owned sites
  // from shared memory
  auto decode = [&](int c, int k) {
    const int16_t* const oo = c ? own0 : own1;
    const int16_t* const og = (c ? a.pa : a.pb) + base;
    const int16_t* const ep =
        rg.edges + (static_cast<size_t>(prev) * 2 + 1 - c) * 2 * h;
    const int16_t* const en =
        rg.edges + (static_cast<size_t>(next) * 2 + 1 - c) * 2 * h;
    for (int l = tid; l < m + 2 * h; l += T) {
      int v;
      if (l >= h && l < h + m) {
        v = oo[l - h];
      } else if (k > 0) {
        v = l < h ? __ldcg(ep + h + l) : __ldcg(en + (l - h - m));
      } else {
        int w = lo - h + l;
        w = w < 0 ? w + n : (w >= n ? w - n : w);
        v = og[w];
      }
      float x, y;
      cs16(v, x, y);
      dec[l] = make_float2(x, y);
    }
    __syncthreads();
  };
  // The field of the site at walk position p of colour c: its chunk q, its
  // index w, slot l, (y, i) and field (hx, hy) and decoded centre ce
  struct At {
    int q, w, l, y, i;
    float hx, hy;
    float2 ce;
  };
  auto at = [&](int p, int c) {
    At s;
    s.q = walk.chunk(p, nch);
    s.w = (c0 + s.q) * THREADS + tg;
    if (s.w < n) {
      s.l = s.w - lo + h;
      const ring::Slot sl(rows[s.q], dy, di, h, c, s.l);
      s.y = sl.y;
      s.i = sl.i;
      const float2 up = dec[s.l - h], dn = dec[s.l + h], sd = dec[sl.ls];
      s.ce = dec[s.l];
      s.hx = __fadd_rn(__fadd_rn(up.x, dn.x), __fadd_rn(s.ce.x, sd.x));
      s.hy = __fadd_rn(__fadd_rn(up.y, dn.y), __fadd_rn(s.ce.y, sd.y));
    }
    return s;
  };
  // The measuring sites' warp sums into the partials of sweep s
  auto partials = [&](int s) {
    ring::chunk_partials(
        a.partials +
            ((static_cast<size_t>(r) * a.sweeps + s) * nblk + c0) * NSUMS,
        red, nch, tid);
  };
  // Updating phase k of colour c: Metropolis under key (measuring: the
  // fused sums of sweep s) or, with reflect_phase, over-relaxation
  auto phase = [&](int c, int k, int s, bool reflect_phase, uint2 key,
                   bool measuring) {
    if (k > 0) ring::wait(rg.flags, prev, next, static_cast<unsigned>(k), tid);
    decode(c, k);
    int16_t* const sp = c ? own1 : own0;
    auto update = [&](int p) {
      const At st = at(p, c);
      Sums t = {0.0, 0.0, 0.0, 0.0};
      if (st.w < n) {
        const int ol = st.l - h, kx = sp[ol];
        if (reflect_phase) {
          sp[ol] = reflect(st.hx, st.hy, kx);
        } else {
          const Step u = metro_step(
              st.hx, st.hy, kx,
              philox4x32_10(make_uint4(static_cast<uint32_t>(r),
                                       static_cast<uint32_t>(st.y),
                                       static_cast<uint32_t>(st.i), 0u),
                            key),
              a.neg_beta);
          if (u.accept) sp[ol] = static_cast<int16_t>(u.k);
          if (measuring)
            t = b_sums(st.ce.x, st.ce.y, st.hx, st.hy, u.x, u.y, u.k,
                       own0[ol], snap_a[ol], snap_b[ol]);
        }
      }
      if (measuring) ring::store_sums(red, st.q, tg, t);  // uniform
    };
    int p = g;
    for (; p < walk.edges; p += GROUPS) update(p);
    __syncthreads();
    if (k + 1 < phases) {
      // publish this colour's first and last h updated sites, then the
      // flag, before the other chunks
      int16_t* const e =
          rg.edges + (static_cast<size_t>(blockIdx.x) * 2 + c) * 2 * h;
      for (int l = tid; l < h; l += T) {
        e[l] = sp[l];
        e[h + l] = sp[m - h + l];
      }
      __syncthreads();
      ring::publish(rg.flags, static_cast<unsigned>(k + 1), tid);
    }
    for (; p < nch; p += GROUPS) update(p);
    __syncthreads();
    if (measuring) partials(s);
  };
  // The measure pass of sweep s: colour b's sites in the field of colour
  // a, which the last phase b left decoded in dec
  auto measure = [&](int s) {
    for (int p = g; p < nch; p += GROUPS) {
      const At st = at(p, 1);
      Sums t = {0.0, 0.0, 0.0, 0.0};
      if (st.w < n) {
        const int ol = st.l - h, kb = own1[ol];
        float bx, by;
        cs16(kb, bx, by);
        t = b_sums(st.ce.x, st.ce.y, st.hx, st.hy, bx, by, kb, own0[ol],
                   snap_a[ol], snap_b[ol]);
      }
      ring::store_sums(red, st.q, tg, t);
    }
    __syncthreads();
    partials(s);
  };
  int k = 0;
  for (int s = 0; s < a.sweeps; ++s) {
    if (!a.or_only) {
      phase(0, k++, s, false, ring::phase_key(a.seeds, 2 * s), false);
      phase(1, k++, s, false, ring::phase_key(a.seeds, 2 * s + 1), n_or == 0);
    }
    for (int i = 0; i < n_or; ++i) {
      phase(0, k++, s, true, uint2{}, false);
      phase(1, k++, s, true, uint2{}, false);
    }
    if (n_or > 0) measure(s);
  }
  for (int l = tid; l < m; l += T) {
    const size_t o = base + lo + l;
    a.pa[o] = own0[l];
    a.pb[o] = own1[l];
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

Multisweep make_args(void* pa, void* pb, const void* sa, const void* sb,
                     const void* seeds, void* partials, int nrep, int ny,
                     int half, int sweeps, int n_or, int or_only,
                     float neg_beta) {
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
  return a;
}

// The launch's reduce_kernel: the (rows, nblk, 4) partials into obs
int finish(void* partials, void* obs, int rows, int nblk, cudaStream_t st) {
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<NSUMS><<<rows, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
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
  Multisweep a = make_args(pa, pb, sa, sb, seeds, partials, nrep, ny, half,
                           sweeps, n_or, or_only, neg_beta);
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

// What ops/xy2d_multisweep.smem_layout needs of the current device for
// smem_multisweep_kernel (xy2d_ring.cuh ring::smem_limits).
int xyi_smem_limits(int* sms, int* per_sm, int* smem_block, int* smem_sm,
                    int* reserved) {
  return ring::smem_limits(
      reinterpret_cast<const void*>(smem_multisweep_kernel), sms, per_sm,
      smem_block, smem_sm, reserved);
}

// smem_multisweep_kernel: the same sweeps and sums as xyi_multisweep on
// the ring layout of ops/xy2d_multisweep.smem_layout: nb blocks a replica,
// block j owning chunks bounds[j] .. bounds[j+1] - 1 ((nb + 1) int32 on
// the device), at most cap sites, in smem bytes of dynamic shared memory
// (8 (cap + 2 half) + CHUNK_BYTES a chunk of cap + 4 cap, + 4 cap with
// snap_smem, the snapshot held there too); edges (nrep nb x 4 half int16)
// and flags (nrep nb uint32) scratch on the device, the flags cleared here
// on the stream.  A grid that cannot be resident at once returns
// cudaErrorCooperativeLaunchTooLarge.
int xyi_multisweep_smem(void* pa, void* pb, const void* sa, const void* sb,
                        const void* seeds, void* partials, void* obs,
                        const void* bounds, void* edges, void* flags,
                        int nrep, int ny, int half, int sweeps, int n_or,
                        int or_only, int nb, int cap, int smem,
                        int snap_smem, float neg_beta, void* stream) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  const long long span = static_cast<long long>(cap) + 2LL * half;
  const long long need = 8 * span +
                         static_cast<long long>(cap / THREADS) * CHUNK_BYTES +
                         4LL * cap * (snap_smem ? 2 : 1);
  if (sweeps < 1 || n_or < 0 || seeds == nullptr || partials == nullptr ||
      obs == nullptr || nb < 1 || cap < half || cap % THREADS != 0 ||
      bounds == nullptr || edges == nullptr || flags == nullptr ||
      static_cast<long long>(nrep) * nb > 0x7fffffffLL || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(smem_multisweep_kernel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = ring::prepare(fn, smem, static_cast<long long>(nrep) * nb,
                              static_cast<unsigned*>(flags), st))
    return err;
  Multisweep a = make_args(pa, pb, sa, sb, seeds, partials, nrep, ny, half,
                           sweeps, n_or, or_only, neg_beta);
  Ring rg;
  rg.bounds = static_cast<const int32_t*>(bounds);
  rg.edges = static_cast<int16_t*>(edges);
  rg.flags = static_cast<unsigned*>(flags);
  rg.nb = nb;
  rg.span = static_cast<int>(span);
  rg.chunks = cap / THREADS;
  void* args[] = {&a, &rg, &snap_smem};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(nrep * nb), dim3(ring::BLOCK), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return finish(partials, obs, nrep * sweeps,
                (ny * half + THREADS - 1) / THREADS, st);
}

const char* xyi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
