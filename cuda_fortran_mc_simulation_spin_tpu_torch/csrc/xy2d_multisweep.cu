// S sweeps of the periodic XY model on int16 angle planes in one launch on
// Hopper (sm_90a), per-sweep sums fused.
//
//   smem_multisweep_kernel and gmem_multisweep_kernel, two modes of one
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
// modes of one function, both a ring of 1024-thread blocks a replica, one
// block an SM, with flags between phases (xy2d_ring.cuh, as
// xy2d_resident.cu's) and no grid barrier:
//
//   smem_multisweep_kernel  the lattice in the SMs' shared memory: every
//                           batch whose state fits the grid's shared
//                           memory (ops/xy2d_multisweep.smem_layout, e.g.
//                           one 1536x1536 replica);
//   gmem_multisweep_kernel  the planes in device memory (9.4 MB at 1536^2
//                           x 2 with the snapshot, inside the 50 MB L2),
//                           updated in place: the larger batches
//                           (ops/xy2d_multisweep.gmem_layout).
//
// Block j of a ring owns the 256-site chunks bounds[j] .. bounds[j+1] - 1
// of both colours.  A site's other-colour neighbours lie within `half`
// sites of its own w, so each phase reads the other colour's `half` sites
// before the block's first chunk and after its last from its two ring
// neighbours.  Each updating phase (Metropolis or over-relaxation) waits
// on its neighbours' flags, updates the chunks holding its first and last
// `half` sites (the edge chunks, ring::Walk), publishes them and sets its
// flag, then updates its other chunks.  Four groups of 256 threads take
// the chunks in turn; (y, i) of a site is its chunk's first site's plus
// the thread's offset: no runtime division a site.
//
// The measure pass after the over-relaxation sweeps is folded into the
// last over-relaxation phase b of the sweep: colour a does not change in
// it, so a b site's field, its decoded centre and colour a's angle there
// are the measure pass's, and its new angle as stored (wrapped to int16)
// is the one the measure pass would read.  In the device-memory mode this
// is needed: a pass after phase b that neither waits nor publishes would
// read the neighbours' colour-a edge sites while they, having waited only
// on this block's flag of phase b, may already rewrite them in the next
// sweep's phase a.
//
// smem_multisweep_kernel holds a block's int16 sites of both colours and,
// where the fit rule allows, of the t=0 snapshot in shared memory for the
// launch's S sweeps and writes the state back once.  Each phase decodes
// every angle of the other colour it reads once, into a shared float32
// (cos, sin) plane: its own sites and its halos, the neighbours' edge
// sites read through L2 from their edge buffer (at the first phase from
// the planes); it publishes its edge sites to the colour's edge buffer.
//
// gmem_multisweep_kernel is the same ring and walk with the planes left
// in device memory, updated in place: no edge buffer, a neighbour reads
// the sites it needs straight from the planes after its acquire.  A block
// holds the chunks no neighbour reads (those between its edge chunks) in
// shared memory as int16 sites of both colours, as many as fit beside its
// sums (all 64 of 70 at 1536x1536 x 2), loaded once a replica and written
// back after its S sweeps; where room is left it decodes the other
// colour's held sites and the `half` sites either side (its own edge
// sites) once a phase into a float2 plane (all 64 at x 2, part of them at
// x 3).  A read inside that plane comes from shared memory; any other read
// of the other colour is decoded per read, from the held sites or from
// the planes through L2 (__ldcg: its L1 may hold an older copy of a
// neighbour's sites).  The decoded plane holds only the block's own
// sites, final since the block's last barrier, so it is decoded before
// the flag wait.  The snapshot stays in device memory, read at its site
// through the read-only cache.  Ring t of the launch's rings takes
// replicas t, t + rings, ... in turn, all S sweeps of one before the next,
// its flags counting on: where one ring a replica would not fit
// (1536x1536 x 23 and more), fewer rings of more blocks (two of 66 at
// 1536x1536, each holding and decoding every chunk no neighbour reads);
// where there are more replicas than block slots, rings of one block (the
// whole replica, held whole where it fits, e.g. 64x64) with no flag,
// their own barrier between phases.  A block's switch of replica needs
// nothing more: no two replicas share a site, and the flags go on
// counting phases across replicas.  Why in place is safe (as
// xy2d_resident.cu's device-memory mode; an over-relaxation phase reads
// and writes exactly as a Metropolis phase does):
//   - a site reads only other-colour sites within `half` of its own w, so
//     the sites of block j that read outside its range are its first and
//     last `half` (its edge chunks), and the sites outside its range that
//     it reads are its neighbours' last and first `half`, never held;
//   - read after write: block j reads in phase k the other colour's sites
//     of its neighbours after their flags say they published phase k - 1,
//     which they do after updating their edge chunks in it;
//   - write after read: block j writes colour c in phase k only after the
//     same wait, and its neighbours read j's colour-c sites in phase k - 1
//     only in their edge chunks, which precede their flags; a neighbour
//     is at most one phase ahead (to start phase k + 1 it waits on j's
//     flag of phase k), and in phase k + 1 it writes the other colour,
//     which j reads in phase k from its own range alone after its edges;
//   - a block's own writes are seen by its own threads after its barrier
//     (a site's own plain load reads its own range, written by no other
//     block); a held site's copy in the planes is stale until the write
//     back, and every read of it goes to shared memory.
// tests/test_torch_xy2d_int16_ring.py replays this schedule on the CPU
// under adversarial interleavings, a separate measure pass's hazard
// included.
//
// Random words: Philox under the (sweep, phase) key and counter
// (replica, row, column, 0), as metropolis_kernel draws: the candidate is
// word 0 >> 16 (an int in [0, 65535], wrapped to int16 only when stored;
// phase b's sums and A use it unwrapped, so the A argument reaches -1.5
// turns, where cos_sin_2pi's floor and & 3 are a true mod 4) and the
// uniform the top 24 bits of word 1.  Arithmetic: one rounding per
// operation in the order of ops/xy2d_multisweep.py's plain version;
// rintf rounds half to even as torch.round does.  The sums are float64 of
// the float32 site terms, per 256-site chunk in block_sums' order (the
// ring's warp sums in the same tree), then per (replica, sweep) by
// reduce_kernel: both modes give the same (R, S, chunks, 4) partials.
// Layout and neighbours: xy2d_site.cuh, on int16 planes, unpadded (JAX's
// 16-row granules and tiles are TPU layout).
//
// Bound on the H100: operations.  A Metropolis site needs ~150 32-bit
// operations (one Philox4x32-10 call, three decodes: the site, the
// candidate and each other-colour angle once, expf), an over-relaxation
// site ~70 (one decode, the atan2 polynomial with its divide), the fused
// sums a b site one more decode and two cos terms; the bytes (2 B read and
// 2 B written a site and phase, the snapshot's 4 B a sweep) are a few MB.
#include <type_traits>

#include "xy2d_ring.cuh"
#include "xy2d_site.cuh"

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

// A site's new angle k (a Metropolis candidate unwrapped, a reflection as
// stored), its components (x, y) where the sums read them, and whether to
// store it
struct Update {
  int k;
  float x, y;
  bool store;
};

// One site's update, both modes': the site of angle kx in the field (hx,
// hy) by a Metropolis step under the Philox words of counter (r, y, i, 0)
// and key (the candidate word 0 >> 16 replaces kx iff the top 24 bits of
// word 1 fall below exp(-β max(ΔE, 0))), or with reflect_phase by the
// over-relaxation 2 rint(φ) - kx, φ = atan2_units(hy, hx); with measuring
// the new angle's components for its sums (a reflection's decoded as the
// measure pass would read it back, wrapped to int16)
__device__ __forceinline__ Update update_site(float hx, float hy, int kx,
                                              int r, int y, int i, uint2 key,
                                              float neg_beta,
                                              bool reflect_phase,
                                              bool measuring) {
  Update u;
  if (reflect_phase) {
    u.k = static_cast<int16_t>(
        2 * static_cast<int>(rintf(atan2_units(hy, hx))) - kx);
    u.store = true;
    u.x = u.y = 0.0f;
    if (measuring) cs16(u.k, u.x, u.y);
    return u;
  }
  const uint4 b = philox4x32_10(
      make_uint4(static_cast<uint32_t>(r), static_cast<uint32_t>(y),
                 static_cast<uint32_t>(i), 0u),
      key);
  float cx, sx;
  cs16(kx, cx, sx);
  const int cand = static_cast<int>(b.x >> 16);
  float cc, cs;
  cs16(cand, cc, cs);
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cc, cx), hx),
                              __fmul_rn(__fsub_rn(cs, sx), hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
  u.store = xy::u24(b.y) < prob;
  u.k = u.store ? cand : kx;
  u.x = u.store ? cc : cx;
  u.y = u.store ? cs : sx;
  return u;
}

// The phases of a sweep: two Metropolis phases (but with or_only) and two
// a sweep of over-relaxation; the last (a colour-b phase) measures
__device__ __forceinline__ int sweep_phases(const Multisweep& a) {
  const int n_or = a.or_only ? (a.n_or > 1 ? a.n_or : 1) : a.n_or;
  return (a.or_only ? 0 : 2) + 2 * n_or;
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
  const int per = sweep_phases(a);
  // updating phases of the launch: each waits on the k its neighbours
  // published and publishes k + 1 (but the last)
  const int phases = a.sweeps * per;
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
  // Phase k of colour c, the i-th of sweep s: Metropolis, or
  // over-relaxation from the sweep's third phase (from its first with
  // or_only); the last of the sweep measures
  auto phase = [&](int c, int k, int s, int i) {
    const bool reflect_phase = a.or_only || i >= 2;
    const bool measuring = i == per - 1;
    const uint2 key = reflect_phase ? make_uint2(0u, 0u)
                                    : ring::phase_key(a.seeds, 2 * s + c);
    if (k > 0) ring::wait(rg.flags, prev, next, static_cast<unsigned>(k), tid);
    decode(c, k);
    int16_t* const sp = c ? own1 : own0;
    auto update = [&](int p) {
      const int q = walk.chunk(p, nch);
      const int w = (c0 + q) * THREADS + tg;
      Sums t = {0.0, 0.0, 0.0, 0.0};
      if (w < n) {
        const int l = w - lo + h, ol = l - h;
        const ring::Slot sl(rows[q], dy, di, h, c, l);
        const float2 up = dec[l - h], dn = dec[l + h], sd = dec[sl.ls];
        const float2 ce = dec[l];
        const float hx =
            __fadd_rn(__fadd_rn(up.x, dn.x), __fadd_rn(ce.x, sd.x));
        const float hy =
            __fadd_rn(__fadd_rn(up.y, dn.y), __fadd_rn(ce.y, sd.y));
        const Update u = update_site(hx, hy, sp[ol], r, sl.y, sl.i, key,
                                     a.neg_beta, reflect_phase, measuring);
        if (u.store) sp[ol] = static_cast<int16_t>(u.k);
        if (measuring)
          t = b_sums(ce.x, ce.y, hx, hy, u.x, u.y, u.k, own0[ol], snap_a[ol],
                     snap_b[ol]);
      }
      if (measuring) ring::store_sums(red, q, tg, t);  // uniform
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
    if (measuring)
      ring::chunk_partials(
          a.partials +
              ((static_cast<size_t>(r) * a.sweeps + s) * nblk + c0) * NSUMS,
          red, nch, tid);
  };
  int k = 0;
  for (int s = 0; s < a.sweeps; ++s)
    for (int i = 0; i < per; ++i, ++k) phase(i & 1, k, s, i);
  for (int l = tid; l < m; l += T) {
    const size_t o = base + lo + l;
    a.pa[o] = own0[l];
    a.pb[o] = own1[l];
  }
}

// The rings of gmem_multisweep_kernel (ops/xy2d_multisweep.gmem_layout)
struct GmemRing {
  const int32_t* bounds;   // (nb + 1,) first chunk of each block of a ring
  unsigned* flags;         // (rings nb,) phases published
  int nb;                  // blocks a ring
  int rings;               // rings at once: ring t takes replicas t,
                           // t + rings, ... in turn
  int chunks;              // chunks a block at most
  int hold;                // chunks a block holds in shared memory at most
  int dec;                 // held chunks decoded once a phase at most
  int span;                // float2 slots of the decoded plane: dec 256 +
                           // 2 half, or 0
};

// shared memory a held chunk takes: its int16 sites of both colours
constexpr int HELD_BYTES = 2 * THREADS * 2;

// The angle of site x of a colour: held[x - sa] where held (x in [sa, sa
// + span)), else from its plane through L2
__device__ __forceinline__ int angle_at(const int16_t* held, int sa,
                                        unsigned span, const int16_t* plane,
                                        int x) {
  const unsigned o = static_cast<unsigned>(x - sa);
  return o < span ? held[o] : __ldcg(plane + x);
}

// Site x of the other colour as (cos, sin): slot x - dlo of the decoded
// plane where it holds x, else decoded from angle_at
__device__ __forceinline__ float2 other_at(const float2* dec, int dlo,
                                           unsigned dspan,
                                           const int16_t* held, int sa,
                                           unsigned span,
                                           const int16_t* plane, int x) {
  const unsigned o = static_cast<unsigned>(x - dlo);
  if (o < dspan) return dec[o];
  float2 f;
  cs16(angle_at(held, sa, span, plane, x), f.x, f.y);
  return f;
}

// Shared memory (ops/xy2d_multisweep.gmem_layout): the decoded plane, a
// float2 a slot of span; the chunks' warp sums and first sites; the held
// int16 sites of colours a and b (hold chunks each, site sa + l at l).
__global__ void __launch_bounds__(ring::BLOCK, 1)
    gmem_multisweep_kernel(Multisweep a, GmemRing rg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const dec = reinterpret_cast<float2*>(smem);
  double* const red = reinterpret_cast<double*>(dec + rg.span);
  int2* const rows = reinterpret_cast<int2*>(red + rg.chunks * NSUMS * WARPS);
  int16_t* const held0 = reinterpret_cast<int16_t*>(rows + rg.chunks);
  int16_t* const held1 = held0 + rg.hold * THREADS;
  constexpr int T = ring::BLOCK;
  const int h = a.half, n = a.ny * h;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int t = blockIdx.x / rg.nb, j = blockIdx.x - t * rg.nb;
  const int c0 = rg.bounds[j], nch = rg.bounds[j + 1] - c0;
  const int m = min(nch * THREADS, n - c0 * THREADS);
  const int prev = t * rg.nb + (j == 0 ? rg.nb - 1 : j - 1);
  const int next = t * rg.nb + (j == rg.nb - 1 ? 0 : j + 1);
  // a ring of one: no neighbour, no flag, no edge first
  const bool alone = rg.nb == 1;
  const int tid = threadIdx.x;
  ring::chunk_rows(rows, c0, nch, h, tid);
  const int g = tid / THREADS, tg = tid & (THREADS - 1);
  const int dy = tg / h, di = tg - dy * h;
  const ring::Walk walk(h, m, nch);
  const int edges = alone ? 0 : walk.edges;
  // the held chunks qa .. qb - 1: the chunks no neighbour reads (all of a
  // ring of one), sites sa .. sb - 1
  const int qa = alone ? 0 : walk.head;
  const int room = alone ? nch : nch - walk.edges;
  const int qb = qa + min(rg.hold, max(room, 0));
  const int sa = (c0 + qa) * THREADS;
  const int sb = qb > qa ? min((c0 + qb) * THREADS, n) : sa;
  const unsigned span = static_cast<unsigned>(sb - sa);
  // the decoded plane: the first dq held chunks, sites sa .. db - 1, and h
  // sites either side; slot l holds site dlo + l (modulo n), so a site w
  // in sa .. db - 1 finds its four reads at slots w - dlo -+ h, w - dlo
  // and its side slot, as in smem_multisweep_kernel
  const int dq = min(rg.dec, qb - qa);
  const int db = dq > 0 ? min((c0 + qa + dq) * THREADS, n) : sa;
  const int dlo = sa - h;
  const unsigned dspan = dq > 0 ? static_cast<unsigned>(db - sa + 2 * h) : 0u;
  // every site of chunk q lies in sa .. db - 1
  auto all_dec = [&](int q) {
    const int w0 = (c0 + q) * THREADS;
    return w0 >= sa && min(w0 + THREADS, n) <= db;
  };
  const int per = sweep_phases(a);
  unsigned done = 0;  // phases this block finished, over its replicas
  for (int r = t; r < a.nrep; r += rg.rings) {
    const size_t base = static_cast<size_t>(r) * n;
    for (int l = tid; l < sb - sa; l += T) {
      held0[l] = a.pa[base + sa + l];
      held1[l] = a.pb[base + sa + l];
    }
    __syncthreads();
    for (int s = 0; s < a.sweeps; ++s) {
      for (int i = 0; i < per; ++i, ++done) {
        const int c = i & 1;
        const bool reflect_phase = a.or_only || i >= 2;
        const bool measuring = i == per - 1;
        int16_t* const xs = (c ? a.pb : a.pa) + base;
        const int16_t* const os = (c ? a.pa : a.pb) + base;
        int16_t* const xh = c ? held1 : held0;
        const int16_t* const oh = c ? held0 : held1;
        // the other colour's own sites decoded, before the wait: no other
        // block writes them
        for (int l = tid; l < static_cast<int>(dspan); l += T) {
          int x = dlo + l;
          x = x < 0 ? x + n : (x >= n ? x - n : x);
          float2 f;
          cs16(angle_at(oh, sa, span, os, x), f.x, f.y);
          dec[l] = f;
        }
        if (!alone && done > 0)
          ring::wait(rg.flags, prev, next, done, tid);
        else
          __syncthreads();
        const uint2 key = reflect_phase ? make_uint2(0u, 0u)
                                        : ring::phase_key(a.seeds, 2 * s + c);
        // one site of position p (D: its chunk in the decoded plane, its
        // reads at slots; else rows wrapping at the replica and each read
        // by other_at); a measuring one leaves its warp's sums in red,
        // reduced after the phase in block_sums' order
        auto update = [&](auto all, int p) {
          constexpr bool D = decltype(all)::value;
          const int q = walk.chunk(p, nch), w = (c0 + q) * THREADS + tg;
          Sums t4 = {0.0, 0.0, 0.0, 0.0};
          if (w < n) {
            const int l = D ? w - dlo : w;
            const ring::Slot sl(rows[q], dy, di, h, c, l);
            float2 up, dn, ce, sd;
            if (D) {
              up = dec[l - h];
              dn = dec[l + h];
              ce = dec[l];
              sd = dec[sl.ls];
            } else {
              const int wu = w < h ? w - h + n : w - h;
              const int wd = w >= n - h ? w + h - n : w + h;
              up = other_at(dec, dlo, dspan, oh, sa, span, os, wu);
              dn = other_at(dec, dlo, dspan, oh, sa, span, os, wd);
              ce = other_at(dec, dlo, dspan, oh, sa, span, os, w);
              sd = other_at(dec, dlo, dspan, oh, sa, span, os, sl.ls);
            }
            const float hx =
                __fadd_rn(__fadd_rn(up.x, dn.x), __fadd_rn(ce.x, sd.x));
            const float hy =
                __fadd_rn(__fadd_rn(up.y, dn.y), __fadd_rn(ce.y, sd.y));
            const bool mine = q >= qa && q < qb;  // uniform: a held site
            const Update u =
                update_site(hx, hy, mine ? xh[w - sa] : xs[w], r, sl.y, sl.i,
                            key, a.neg_beta, reflect_phase, measuring);
            if (u.store) {
              if (mine)
                xh[w - sa] = static_cast<int16_t>(u.k);
              else
                xs[w] = static_cast<int16_t>(u.k);
            }
            // the snapshot through the read-only cache, at the site
            if (measuring)
              t4 = b_sums(ce.x, ce.y, hx, hy, u.x, u.y, u.k,
                          D ? oh[w - sa] : angle_at(oh, sa, span, os, w),
                          __ldg(a.sa + base + w), __ldg(a.sb + base + w));
          }
          if (measuring) ring::store_sums(red, q, tg, t4);  // uniform
        };
        int p = g;
        for (; p < edges; p += GROUPS) update(std::false_type{}, p);
        if (!alone) {
          // the edge chunks' sites stored, then the flag, before the others
          __syncthreads();
          ring::publish(rg.flags, done + 1, tid);
        }
        for (; p < nch; p += GROUPS) {
          if (all_dec(walk.chunk(p, nch)))
            update(std::true_type{}, p);
          else
            update(std::false_type{}, p);
        }
        __syncthreads();
        if (measuring)
          ring::chunk_partials(
              a.partials +
                  ((static_cast<size_t>(r) * a.sweeps + s) * nblk + c0) *
                      NSUMS,
              red, nch, tid);
      }
    }
    for (int l = tid; l < sb - sa; l += T) {
      a.pa[base + sa + l] = held0[l];
      a.pb[base + sa + l] = held1[l];
    }
  }
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

// Both modes' arguments but the ring's
int check_args(int nrep, int ny, int half, int sweeps, int n_or,
               const void* seeds, const void* partials, const void* obs) {
  if (int bad = xy::check_shape(nrep, ny, half)) return bad;
  if (sweeps < 1 || n_or < 0 || seeds == nullptr || partials == nullptr ||
      obs == nullptr ||
      static_cast<long long>(nrep) * ny * half >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The launch of ring kernel fn (args, blocks of ring::BLOCK threads, smem
// bytes) and its reduce_kernel: the (rows, nblk, 4) partials into obs
int launch(const void* fn, void** args, long long blocks, int smem,
           void* partials, void* obs, int rows, int nblk, cudaStream_t st) {
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(blocks)), dim3(ring::BLOCK), args, smem,
      st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  xy::reduce_kernel<NSUMS><<<rows, THREADS, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(obs), nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// What ops/xy2d_multisweep.smem_layout needs of the current device for
// smem_multisweep_kernel (xy2d_ring.cuh ring::smem_limits).
int xyi_smem_limits(int* sms, int* per_sm, int* smem_block, int* smem_sm,
                    int* reserved) {
  return ring::smem_limits(
      reinterpret_cast<const void*>(smem_multisweep_kernel), sms, per_sm,
      smem_block, smem_sm, reserved);
}

// The same of gmem_multisweep_kernel, for gmem_layout.
int xyi_gmem_limits(int* sms, int* per_sm, int* smem_block, int* smem_sm,
                    int* reserved) {
  return ring::smem_limits(
      reinterpret_cast<const void*>(gmem_multisweep_kernel), sms, per_sm,
      smem_block, smem_sm, reserved, ring::BLOCK);
}

// smem_multisweep_kernel: S = sweeps sweeps of the (nrep, ny, half) int16
// planes pa, pb in place, one cooperative launch; sa, sb the t=0 snapshot
// planes; seeds (S, 2, 2) int32 on the device; partials (nrep, S, chunks,
// 4) float64 scratch; obs (nrep, S, 4) float64 the per-sweep (Σ S_x, Σ
// S_y, e, A) (reduce_kernel after the launch).  On the ring layout of
// ops/xy2d_multisweep.smem_layout: nb blocks a replica, block j owning
// chunks bounds[j] .. bounds[j+1] - 1 ((nb + 1) int32 on the device), at
// most cap sites, in smem bytes of dynamic shared memory (8 (cap + 2 half)
// + CHUNK_BYTES a chunk of cap + 4 cap, + 4 cap with snap_smem, the
// snapshot held there too); edges (nrep nb x 4 half int16) and flags (nrep
// nb uint32) scratch on the device, the flags cleared here on the stream.
// A batch whose site index could reach 2^31 is refused; a grid that
// cannot be resident at once returns cudaErrorCooperativeLaunchTooLarge.
int xyi_multisweep_smem(void* pa, void* pb, const void* sa, const void* sb,
                        const void* seeds, void* partials, void* obs,
                        const void* bounds, void* edges, void* flags,
                        int nrep, int ny, int half, int sweeps, int n_or,
                        int or_only, int nb, int cap, int smem,
                        int snap_smem, float neg_beta, void* stream) {
  if (int bad = check_args(nrep, ny, half, sweeps, n_or, seeds, partials,
                           obs))
    return bad;
  const long long span = static_cast<long long>(cap) + 2LL * half;
  const long long need = 8 * span +
                         static_cast<long long>(cap / THREADS) * CHUNK_BYTES +
                         4LL * cap * (snap_smem ? 2 : 1);
  if (nb < 1 || cap < half || cap % THREADS != 0 || bounds == nullptr ||
      edges == nullptr || flags == nullptr ||
      static_cast<long long>(nrep) * nb > 0x7fffffffLL || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(smem_multisweep_kernel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(nrep) * nb;
  if (int err = ring::prepare(fn, smem, blocks,
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
  return launch(fn, args, blocks, smem, partials, obs, nrep * sweeps,
                (ny * half + THREADS - 1) / THREADS, st);
}

// gmem_multisweep_kernel: the same sweeps and sums as xyi_multisweep_smem
// on the rings of ops/xy2d_multisweep.gmem_layout: rings rings of nb
// blocks at once (ring t taking replicas t, t + rings, ...; with nb > 1
// each block owning at least half sites), block j
// of a ring owning chunks bounds[j] .. bounds[j+1] - 1 ((nb + 1) int32 on
// the device), at most cap sites, of which it holds at most hold chunks in
// shared memory and decodes at most dec of those once a phase, in smem
// bytes of dynamic shared memory (8 (256 dec + 2 half) where dec > 0,
// CHUNK_BYTES a chunk of cap, HELD_BYTES a held chunk); flags (rings nb
// uint32) scratch on the device, cleared here on the stream.
int xyi_multisweep_gmem(void* pa, void* pb, const void* sa, const void* sb,
                        const void* seeds, void* partials, void* obs,
                        const void* bounds, void* flags, int nrep, int ny,
                        int half, int sweeps, int n_or, int or_only, int nb,
                        int rings, int cap, int hold, int dec, int smem,
                        float neg_beta, void* stream) {
  if (int bad = check_args(nrep, ny, half, sweeps, n_or, seeds, partials,
                           obs))
    return bad;
  const long long blocks = static_cast<long long>(rings) * nb;
  const long long span = dec > 0 ? 256LL * dec + 2LL * half : 0;
  if (nb < 1 || rings < 1 || rings > nrep || (nb > 1 && cap < half) ||
      cap < THREADS || cap % THREADS != 0 || hold < 0 ||
      hold > cap / THREADS || dec < 0 || dec > hold ||
      bounds == nullptr || flags == nullptr || blocks > 0x7fffffffLL ||
      smem < 8 * span + static_cast<long long>(cap / THREADS) * CHUNK_BYTES +
                 static_cast<long long>(hold) * HELD_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(gmem_multisweep_kernel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = ring::prepare(fn, smem, blocks, static_cast<unsigned*>(flags),
                              st, ring::BLOCK))
    return err;
  Multisweep a = make_args(pa, pb, sa, sb, seeds, partials, nrep, ny, half,
                           sweeps, n_or, or_only, neg_beta);
  GmemRing rg;
  rg.bounds = static_cast<const int32_t*>(bounds);
  rg.flags = static_cast<unsigned*>(flags);
  rg.nb = nb;
  rg.rings = rings;
  rg.chunks = cap / THREADS;
  rg.hold = hold;
  rg.dec = dec;
  rg.span = static_cast<int>(span);
  void* args[] = {&a, &rg};
  return launch(fn, args, blocks, smem, partials, obs, nrep * sweeps,
                (ny * half + THREADS - 1) / THREADS, st);
}

const char* xyi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
