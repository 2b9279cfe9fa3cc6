// S Metropolis sweeps of the periodic XY model in one launch on Hopper
// (sm_90a), per-sweep sums fused.  Two modes of one function, both
// replacing cuda_fortran_mc_simulation_spin_tpu/ops/xy2d_resident.py:
// _ms_kernel (pallas_call at :257, multisweep): S sweeps of (R, ny, half)
// float32 component planes, each sweep's (Σ S_x, Σ S_y, e, A) fused into
// its phase b, A against the t=0 snapshot.
//
//   smem_multisweep_kernel  the lattice in the SMs' shared memory: every
//                           batch whose state fits the grid's shared
//                           memory (ops/xy2d_resident.smem_layout);
//   gmem_multisweep_kernel  the planes in device memory (L2): the larger
//                           batches under the route bound
//                           (ops/xy2d_resident.gmem_layout).
//
// Both give each replica a ring of blocks (xy2d_ring.cuh) with flags
// between phases in place of a grid barrier.
//
// The TPU kernel keeps the state and the snapshot in VMEM for S sweeps.
// The card's counterpart of VMEM is its shared memory: 132 SMs x 227 KB.
// smem_multisweep_kernel gives each replica a ring of blocks; block j of
// a ring owns the chunks bounds[j] .. bounds[j+1] - 1 of 256 sites (w in
// [256 q, 256 q + 256), one block of the streamed metropolis_kernel) of
// both colours, loads them into shared memory once, updates them there
// for S sweeps and writes them back once.  A site's other-colour
// neighbours lie within `half` sites of its own w (rows wrapping at ny
// are w -+ half modulo the replica), so a block needs, each phase, the
// other colour's `half` sites before its first chunk and after its last:
// its ring neighbours' edges.  A phase updates the chunks that hold its
// first and last `half` sites first, publishes those sites and sets its
// flag, and only then updates its other chunks; before the next phase it
// waits on its two neighbours' flags (set mid-phase, so the wait is
// short) and reads their edges.  smem_layout shrinks the ring until a
// block owns at least `half` sites.  1024 threads a block, one block an
// SM: four groups of 256 threads take the block's chunks in turn, a group
// a chunk at a time; (y, i) of a site is its chunk's first site's, kept
// in shared memory, plus the thread's offset: no runtime division a site.
// The snapshot's loads are issued a site ahead, the first before the flag
// wait.
//
// gmem_multisweep_kernel is the same ring and walk with the planes left
// in device memory, updated in place: no edge buffer, a neighbour reads
// the sites it needs straight from the planes after its acquire.  A
// block holds as many of the chunks no neighbour reads (those past its
// edge chunks) in shared memory as fit beside its sums: 52 of 67 at
// 1500x1500 x 2, loaded once a replica and written back after its S
// sweeps; its other reads go to the planes through L2 (__ldcg: its L1 may
// hold an older copy of a neighbour's sites, and beside the held sites L1
// is small).  A chunk whose reads all lie in the held sites reads shared
// memory alone.  Where there are more replicas than block slots, each
// block is a ring of one (the whole replica, held whole where it fits,
// e.g. 64x64) and takes replicas blockIdx.x, blockIdx.x + rings, ... in
// turn, all S sweeps of one before the next, with no flag: its own
// barrier between phases.  Why in place is safe:
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
// tests/test_torch_xy2d_resident_ring.py replays this schedule on the CPU
// under adversarial interleavings.
//
// The per-site arithmetic is that of metropolis_kernel (xy2d_site.cuh):
// cos_sin_2pi, the field's order (up + dn) + (centre + side), expf and
// the acceptance, under the Philox key of the (sweep, phase) and counter
// (replica, row, column, 0), so S sweeps here equal S streamed
// sweep_measure calls bitwise in the state.  A chunk's sums are reduced
// in block_sums' order (thread t on site 256 q + t, the shuffle tree a
// warp, transposed to move fewer doubles; its 8 warps' sums kept in shared
// memory and added in order once the phase is done, no barrier a chunk),
// into the same (R, S, chunks, 4) partials for reduce_kernel: the sums
// equal the streamed ones bitwise too.  The t=0 snapshot stays in device
// memory, read-only.
//
// Bound on the H100: operations.  A site update needs ~100 32-bit
// operations (a Philox call, cos_sin_2pi, expf, the field; the sums a
// measuring site more) against 32 B a site a sweep of state and
// snapshot (72 MB at 1500x1500 x 1, 22 us, less from L2).  Past ~1.5 M
// site pairs state and snapshot pass the 50 MB L2, and the snapshot
// streams from device memory every measuring phase (36 MB at 1500x1500
// x 2, 10.7 us, under the operations' 13.4 us a sweep): the device-memory
// mode reads it evict-first (__ldcs), so the sites not held keep their
// place in L2.
// XY_RESIDENT_NO_SITES (a measurement build, chip_time_xy.py --resident)
// compiles the site updates out of both kernels: what is left is the ring
// waits, the loads and stores and the sums.  It serves the profiler pass
// of ROADMAP's order of work (item 5), which deletes it.
#include <type_traits>

#include "xy2d_ring.cuh"
#include "xy2d_site.cuh"

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

// One site's Metropolis update, both modes': the field of its other-colour
// neighbours (up, dn, centre ce, side sd) in the order (up + dn) + (ce +
// sd), the candidate from the Philox words of counter (r, y, i, 0) under
// key, f the site's spin in and out; true where the candidate is
// accepted.  A measuring site's sums into t, A from the prefetched
// snapshot sn (the colour updated, then the other) where snap.
__device__ __forceinline__ bool update_site(float2 up, float2 dn, float2 ce,
                                            float2 sd, int r, int y, int i,
                                            uint2 key, float neg_beta,
                                            bool measuring, bool snap,
                                            float4 sn, float2& f, Sums& t) {
  xy::Site st;
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
  const float de = -__fadd_rn(__fmul_rn(__fsub_rn(cx, f.x), st.hx),
                              __fmul_rn(__fsub_rn(cy, f.y), st.hy));
  const float prob = expf(__fmul_rn(fmaxf(de, 0.0f), neg_beta));
  const bool accept = xy::u24(b.y) < prob;
  if (accept) f = make_float2(cx, cy);
  if (measuring) {
    t = xy::site_sums(st, f.x, f.y);
    if (snap) {  // xy::snap_sum on the prefetched snapshot
      const float as = __fadd_rn(__fmul_rn(f.x, sn.x), __fmul_rn(f.y, sn.y));
      const float ao = __fadd_rn(__fmul_rn(st.cx, sn.z),
                                 __fmul_rn(st.cy, sn.w));
      t.a = static_cast<double>(as) + static_cast<double>(ao);
    }
  }
  return accept;
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
        float2 f = sp[l];
        if (update_site(op[l - h], op[l + h], op[l], op[sl.ls], r, sl.y, sl.i,
                        key, a.neg_beta, measuring, snap, sn, f, t))
          sp[l] = f;
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

// The rings of gmem_multisweep_kernel (ops/xy2d_resident.gmem_layout)
struct GmemRing {
  const int32_t* bounds;   // (nb + 1,) first chunk of each block of a ring
  unsigned* flags;         // (rings nb,) phases published
  int nb;                  // blocks a ring
  int rings;               // rings at once: ring t takes replicas t,
                           // t + rings, ... in turn
  int chunks;              // chunks a block at most
  int hold;                // chunks a block holds in shared memory at most
};

// 256-thread groups a block of gmem_multisweep_kernel: 1024 threads, one
// block an SM
constexpr int GMEM_GROUPS = GROUPS;
constexpr int GMEM_BLOCK = THREADS * GMEM_GROUPS;
constexpr int GMEM_PER_SM = 4 / GMEM_GROUPS;
// shared memory a held chunk takes: its sites of both colours as float2
constexpr int HELD_BYTES = 2 * THREADS * 8;

// Site x of the other colour: held[x - sa] where held (x in [sa, sa +
// span)), else from the planes through L2 (__ldcg: a block's L1 may hold
// an older copy of a neighbour's sites, and with the held sites' shared
// memory it is small); HELD: every read of the chunk is held
template <bool HELD>
__device__ __forceinline__ float2 other_at(const float2* held, int sa,
                                           unsigned span, const float* ox,
                                           const float* oy, int x) {
  const unsigned o = static_cast<unsigned>(x - sa);
  if (HELD || o < span) return held[o];
  return make_float2(__ldcg(ox + x), __ldcg(oy + x));
}

__global__ void __launch_bounds__(GMEM_BLOCK, GMEM_PER_SM)
    gmem_multisweep_kernel(Multisweep a, GmemRing ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const held0 = reinterpret_cast<float2*>(smem);
  float2* const held1 = held0 + ring.hold * THREADS;
  double* const red = reinterpret_cast<double*>(held1 + ring.hold * THREADS);
  int2* const rows = reinterpret_cast<int2*>(red + ring.chunks * NSUMS * WARPS);
  constexpr int G = GMEM_GROUPS, T = GMEM_BLOCK;
  const int h = a.half, n = a.ny * h;
  const int nblk = (n + THREADS - 1) / THREADS;
  const int t = blockIdx.x / ring.nb, j = blockIdx.x - t * ring.nb;
  const int c0 = ring.bounds[j], nch = ring.bounds[j + 1] - c0;
  const int m = min(nch * THREADS, n - c0 * THREADS);
  const int prev = t * ring.nb + (j == 0 ? ring.nb - 1 : j - 1);
  const int next = t * ring.nb + (j == ring.nb - 1 ? 0 : j + 1);
  // a ring of one: no neighbour, no flag, no edge first
  const bool alone = ring.nb == 1;
  const int tid = threadIdx.x;
  ring::chunk_rows<T>(rows, c0, nch, h, tid);
  __syncthreads();
  const int g = tid / THREADS, tg = tid & (THREADS - 1);
  const int dy = tg / h, di = tg - dy * h;
  const ring::Walk walk(h, m, nch);
  const int edges = alone ? 0 : walk.edges;
  // the held chunks qa .. qb - 1: the first of the chunks no neighbour
  // reads (all of a ring of one), sites sa .. sb - 1
  const int qa = alone ? 0 : walk.head;
  const int room = alone ? nch : nch - walk.edges;
  const int qb = qa + min(ring.hold, max(room, 0));
  const int sa = (c0 + qa) * THREADS;
  const int sb = qb > qa ? min((c0 + qb) * THREADS, n) : sa;
  const unsigned span = static_cast<unsigned>(sb - sa);
  auto site_of = [&](int p) {
    return p < nch ? (c0 + walk.chunk(p, nch)) * THREADS + tg : n;
  };
  // every other-colour read of chunk q lies in the held sites
  auto all_held = [&](int q) {
    const int w0 = (c0 + q) * THREADS;
    return (w0 - h >= sa && w0 + THREADS + h <= sb) || (sa == 0 && sb == n);
  };
  unsigned done = 0;  // phases this block finished, over its replicas
  for (int r = t; r < a.nrep; r += ring.rings) {
    const size_t base = static_cast<size_t>(r) * n;
    for (int l = tid; l < sb - sa; l += T) {
      const size_t o = base + sa + l;
      held0[l] = make_float2(a.ax[o], a.ay[o]);
      held1[l] = make_float2(a.bx[o], a.by[o]);
    }
    __syncthreads();
    for (int k = 0; k < 2 * a.sweeps; ++k, ++done) {
      const int s = k >> 1, c = k & 1;
      const bool measuring = c == 1 && a.partials != nullptr;
      const bool snap = measuring && a.sax != nullptr;  // uniform
      float* const sx = (c ? a.bx : a.ax) + base;
      float* const sy = (c ? a.by : a.ay) + base;
      const float* const ox = (c ? a.ax : a.bx) + base;
      const float* const oy = (c ? a.ay : a.by) + base;
      float2* const sh = c ? held1 : held0;
      const float2* const oh = c ? held0 : held1;
      // the snapshot of site w (colour b updated, then colour a at w),
      // issued a site ahead, evict-first: it streams once a sweep, and
      // the sites not held keep their place in L2
      auto snap_at = [&](int w) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (snap && w < n)
          v = make_float4(__ldcs(a.sbx + base + w), __ldcs(a.sby + base + w),
                          __ldcs(a.sax + base + w), __ldcs(a.say + base + w));
        return v;
      };
      float4 sv = snap_at(site_of(g));
      if (!alone && done > 0)
        ring::wait(ring.flags, prev, next, done, tid);
      const uint2 key = ring::phase_key(a.seeds, k);
      // one site of position p (held: every read of its chunk held); a
      // measuring one leaves its warp's sums in red, reduced after the
      // phase in block_sums' order
      auto update = [&](auto held, int p) {
        constexpr bool S = decltype(held)::value;
        const int q = walk.chunk(p, nch), w = (c0 + q) * THREADS + tg;
        const float4 sn = sv;
        sv = snap_at(site_of(p + G));
        Sums t4 = {0.0, 0.0, 0.0, 0.0};
#ifndef XY_RESIDENT_NO_SITES
        if (w < n) {
          // (y, i) and the side column's w, rows wrapping at the replica
          const ring::Slot sl(rows[q], dy, di, h, c, w);
          const int wu = w < h ? w - h + n : w - h;
          const int wd = w >= n - h ? w + h - n : w + h;
          const bool mine = q >= qa && q < qb;  // uniform: a held site
          float2 f = mine ? sh[w - sa] : make_float2(sx[w], sy[w]);
          if (update_site(other_at<S>(oh, sa, span, ox, oy, wu),
                          other_at<S>(oh, sa, span, ox, oy, wd),
                          other_at<S>(oh, sa, span, ox, oy, w),
                          other_at<S>(oh, sa, span, ox, oy, sl.ls), r, sl.y,
                          sl.i, key, a.neg_beta, measuring, snap, sn, f, t4)) {
            if (mine) {
              sh[w - sa] = f;
            } else {
              sx[w] = f.x;
              sy[w] = f.y;
            }
          }
        }
#endif
        if (measuring) ring::store_sums(red, q, tg, t4);  // uniform
      };
      int p = g;
      for (; p < edges; p += G) update(std::false_type{}, p);
      if (!alone) {
        // the edge chunks' sites stored, then the flag, before the others
        __syncthreads();
        ring::publish(ring.flags, done + 1, tid);
      }
      for (; p < nch; p += G) {
        if (all_held(walk.chunk(p, nch)))
          update(std::true_type{}, p);
        else
          update(std::false_type{}, p);
      }
      __syncthreads();
      if (measuring)
        ring::chunk_partials<T>(
            a.partials +
                ((static_cast<size_t>(r) * a.sweeps + s) * nblk + c0) * NSUMS,
            red, nch, tid);
    }
    for (int l = tid; l < sb - sa; l += T) {
      const size_t o = base + sa + l;
      const float2 u = held0[l], v = held1[l];
      a.ax[o] = u.x;
      a.ay[o] = u.y;
      a.bx[o] = v.x;
      a.by[o] = v.y;
    }
  }
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

// The same of gmem_multisweep_kernel, for gmem_layout.
int xy_multisweep_gmem_limits(int* sms, int* per_sm, int* smem_block,
                              int* smem_sm, int* reserved) {
  return ring::smem_limits(
      reinterpret_cast<const void*>(gmem_multisweep_kernel), sms, per_sm,
      smem_block, smem_sm, reserved, GMEM_BLOCK);
}

// gmem_multisweep_kernel: S = sweeps Metropolis sweeps of (nrep, ny, half)
// planes in place, one cooperative launch, on the rings of
// ops/xy2d_resident.gmem_layout: rings rings of nb blocks at once (ring t
// taking replicas t, t + rings, ...; nb > 1 only with rings = nrep, each
// block then owning at least half sites), block j of a ring owning chunks
// bounds[j] .. bounds[j+1] - 1 ((nb + 1) int32 on the device), at most cap
// sites, of which it holds at most hold chunks in shared memory, in smem
// bytes of dynamic shared memory (CHUNK_BYTES a chunk of cap, HELD_BYTES a
// held chunk); flags (rings nb uint32) scratch on the device, cleared here on
// the stream; seeds (S, 2, 2) int32 on the device.  With partials
// ((nrep, S, chunks, 4) float64) and obs ((nrep, S, 4) float64) non-null
// each sweep's (Σ S_x, Σ S_y, e, A) lands in obs (reduce_kernel after the
// launch); snap null (A = 0) or the four t=0 snapshot planes (ax, ay, bx,
// by).  A grid that cannot be resident at once returns
// cudaErrorCooperativeLaunchTooLarge.
int xy_multisweep_gmem(void* ax, void* ay, void* bx, void* by,
                       const void* const* snap, const void* seeds,
                       void* partials, void* obs, const void* bounds,
                       void* flags, int nrep, int ny, int half, int sweeps,
                       int nb, int rings, int cap, int hold, int smem,
                       float neg_beta, void* stream) {
  if (int bad = check_args(nrep, ny, half, sweeps, seeds, partials, obs))
    return bad;
  const long long blocks = static_cast<long long>(rings) * nb;
  if (nb < 1 || rings < 1 || rings > nrep || (nb > 1 && rings != nrep) ||
      (nb > 1 && cap < half) || cap < THREADS || cap % THREADS != 0 ||
      hold < 0 || hold > cap / THREADS || bounds == nullptr ||
      flags == nullptr || blocks > 0x7fffffffLL ||
      smem < static_cast<long long>(cap / THREADS) * CHUNK_BYTES +
                 static_cast<long long>(hold) * HELD_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(gmem_multisweep_kernel);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = ring::prepare(fn, smem, blocks, static_cast<unsigned*>(flags),
                              st, GMEM_BLOCK))
    return err;
  Multisweep a = make_args(ax, ay, bx, by, snap, seeds, partials, nrep, ny,
                           half, sweeps, neg_beta);
  GmemRing ring;
  ring.bounds = static_cast<const int32_t*>(bounds);
  ring.flags = static_cast<unsigned*>(flags);
  ring.nb = nb;
  ring.rings = rings;
  ring.chunks = cap / THREADS;
  ring.hold = hold;
  void* args[] = {&a, &ring};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(blocks)), dim3(GMEM_BLOCK), args, smem,
      st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return finish(partials, obs, nrep * sweeps, (ny * half + THREADS - 1) /
                                                  THREADS, st);
}

// smem_multisweep_kernel: the same sweeps and sums as xy_multisweep_gmem
// on the ring layout of ops/xy2d_resident.smem_layout: nb blocks a replica,
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
