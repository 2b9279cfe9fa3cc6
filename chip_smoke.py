"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's relaxation paths through the CLI on the card: the
periodic 2-D Ising NER relaxation at Tc, the helical 2-D one at the
reference's 1001x1000 geometry, the periodic 3-D one at 512^3, the
helical 3-D one at the reference's 151x151x150, 501x501x500 and
1001x1000x1000, the q=6 clock one at the reference's 2000x2000
(padded), at 2048x2048 (aligned) and helical at 501x500, and the
periodic XY one with over-relaxation at the reference's 4000x4000 and
Metropolis only at 2000x2000, the XY disorder protocols (from
disorder at the reference's 1500x1500, with and without fix1mcs, and
finite-magne and its samples at 1000x1000), and helical XY at the
reference's 10001x10000, with over-relaxation and Metropolis only, on the
default f32-angle engine and (over-relaxation) the component one, and
periodic Ising at shapes the bit-packed engines refuse (1000x1000 on the
int8 multisweep, 4000x4000 on the streamed int8 phases, --protocol
samples at 1000x1000, 500^3), and the clock at q and shapes the packed
clock engines refuse, on the int8 clock kernels (q = 2 at 1000x1000 on
the int8 clock multisweep, q = 5 at 2000x2000 on the streamed phases,
--protocol samples at q = 6, 1000x1000), and every helical 2-D shape on
the masked helical kernels (Ising at 1001x1000 under
SPINLAT_HELICAL_PACKED=0, past the packed bound at 4001x4000 and at odd
ny, 1001x1001; the clock at q = 6 on 501x500 under
SPINLAT_CLOCK_HELICAL_PACKED=0, q = 2 at 1001x1000 and q = 5 at 501x500;
XY with over-relaxation at 10001x10000 under SPINLAT_XY_DENSE=0 and at
odd ny, 4001x4001; --protocol samples on helical Ising and the helical
clock), and the periodic XY angle engines under the JAX package's
switches (SPINLAT_XY_PERIODIC_ANGLE=1: the literal 10000x10000 Metropolis
relaxation, 2000x2000 x 32, over-relaxation at 4000x4000 and
finite-magne at 1000x1000 on the f32-angle kernels; SPINLAT_XY_ANGLE_MS=1:
from-disorder at 1536x1536 on the int16-angle multisweep), and periodic
Ising 2-D and 3-D, the clock (packed and int8), XY with over-relaxation
and the fix1mcs disorder protocol domain-sharded over a mesh of the card
repeated (through protocols, as `--mesh` runs them); and holds
every kernel of those paths against its plain PyTorch version.
Phases (each prints a progress line on stderr):

1. build the CUDA sources (csrc/*.cu) from scratch with nvcc, all at once;
2. kernel = plain version, bitwise:
   - 2-D, at 1024^2 x 4 and the main path's shapes: the phase kernel with
     injected bits, Philox bits and the fused exact (m, e); the multisweep
     kernel over 64 sweeps against 64 phase-kernel pairs and its plain
     version; both again at 1024^2 x 4 (8 sweeps) at kbt 1e9 and 0.5, the
     chain table's edges (every chain draws 20 words; B8 draws none);
   - helical, at 131x62 (a partial last word) and 1001x1000 x 4: the
     injected-bits mode on the valid bits; 64 sweeps against 64 one-sweep
     launches and the plain version; the fused (m, e) against the exact
     sums of the unpacked state, staged in shared memory (1001x1000) and
     in device memory (2001x2000, over the shared memory);
   - 3-D, at 256x256x8 x 2 and 512^3 x 8: the phase kernel with injected
     bits, Philox bits and the fused (m, e) (also against the exact sums);
     the multisweep kernel over 64 sweeps (the runner's chunk) at 256^3 x
     4 against 64 phase-kernel pairs (against its plain version at that
     launch in phase 5);
   - helical 3-D, at 151x151x150 x 8 (27 bits in the last word), 501x501x500
     x 1, 1001x1000x1000 x 1 and 151x151x150 x 1 (--protocol samples):
     the phase kernel with injected bits, Philox bits, each z-parity
     sub-phase (even nx*ny) and the fused (m, e); the energy kernel (also
     against the exact sums at 151^3); the multisweep kernel over 64 sweeps
     at 151^3 x 8 and 8 at 151^3 x 1 against as many streamed phase pairs
     and its plain version;
   - clock, q = 6, 4, 3, at 2048^2 x 16 (aligned) and 2000^2 x 4 (padded,
     16 real rows in the top word): the phase kernel with injected planes
     and Philox words, measuring and not; the helical clock multisweep
     kernel at 501x500 x 4 (shared memory: injected mode, 16 sweeps against
     16 one-sweep launches and the plain version, the fused sums against
     the state's) and 1001x1000 x 2 (device memory); the 64-sweep launch
     is held against its plain version in phase 5;
   - XY, at 256x200 x 2 (half = 100), 4000x4000 x 8 and 2000x2000 x 32
     (both classes' launches, each at its kbt), random states:
     the Metropolis kernel with injected and Philox uniforms and the
     over-relaxation kernel, both colours, measuring and not; the state
     bitwise, the float64 sums within 1e-9 relative;
   - XY disorder, at 256x200 x 2, 1500x1500 x 1 and 1000x1000 x 20: the
     Metropolis kernel's snapshot mode (injected and Philox, both
     colours), measure_kernel with and without a snapshot and
     phase_with_bits (the Metropolis kernel's injected mode); 64
     multisweep sweeps at 1500x1500 x 1 in both modes (the shared-memory
     mode the fit rule takes, the device-memory mode forced) against 64
     streamed snapshot-measuring sweeps (state and sums bitwise) and
     against its plain version;
   - helical XY, at 10001x10000 x 1 (the classes' launch) and 65x64 x 4
     (the seam, the ragged slot and both row wraps in one block): the
     component phase and OR kernels and the angle phase and OR kernels,
     injected and Philox uniforms, both colours, measuring and not; the
     state bitwise, the float64 sums within 1e-12 relative; the device
     atan2_2pi bitwise against ops/trig.atan2_2pi on 1e7 points of every
     octant, the axes and (0, 0);
   - int8 Ising, at 130x126 x 3 (half 63, a masked last unit), 10x12x14 x 2
     and each class's launch (1000x1000 x 16, 4000x4000 x 8, 1000x1000 x
     1, 500^3 x 2): the 2-D and 3-D phase kernels with injected and Philox
     words, both colours, and the measure kernel (2-D and 3-D, exact
     sums; also at 4102 and 4100 columns, its chunks, and at 250, on
     aligned tensors and on views 3 and 7 bytes off the 16-B grid); 64
     multisweep sweeps at 1000x1000 x 16 against 64 phase-kernel
     pairs with the measure kernel (state and sums) and against its plain
     version, and 4 at 130x126 x 3 and 8204x4 x 2 (chunked rows) on
     aligned planes and on views 3 and 7 bytes off the 16-B grid;
   - int8 clock, at 130x126 x 3 for q = 2, 3, 4, 5, 6, 8, 20 and at each
     class's launch with its q (1000x1000 x 16, q = 2; 2000x2000 x 16,
     q = 5; 1000x1000 x 1, q = 6): the phase kernel with injected and
     Philox uniforms, both colours, bitwise (at q = 5 and 6 also at
     6x4102 x 2, rows chunked past 4096 columns, and on views 3, 7 and 11
     bytes off the 16-B grid); the measure kernel within
     1e-12 of the sums' scale (exactly at q = 2 and 4); 64 multisweep
     sweeps at 1000x1000 x 16, q = 2 and 6, against 64 phase-kernel pairs
     with the measure kernel and against its plain version (states
     bitwise, sums within 1e-12);
   - masked helical, at 33x32 x 3 (even N), 33x31 x 3 (odd N: the seam
     rows' same-colour pairs), 35x30 x 3 and 35x31 x 5 (replica bases off
     the 16-B grid), 3x2 x 2 (N below one vector; the Ising and XY at
     these three; and at each small shape the Ising and clock
     multisweeps and the XY phase on views off the 16-B grid) and every
     main-path launch (Ising 1001x1000 x 128, 4001x4000 x 4, 1001x1001 x
     16, 1001x1000 x 1 of --protocol samples; clock q = 6 and 5 at 501x500
     x 100, q = 2 at 1001x1000 x 64, q = 6 at 501x500 x 1, q = 2, 5, 8 at
     501x500 and 1001x1001 x 2, every q of HP_CLOCK_QS at the small
     shapes; XY
     10001x10000 x 1, 4001x4001 x 2 and x 1): the Ising and clock
     multisweeps with injected and Philox randomness against their plain
     versions and against one-sweep launches (states bitwise, Ising sums
     exactly, clock sums within 1e-12 of their scale, the last sweep's sums
     the exact sums of the final state); the XY phase kernel, both colours,
     injected and Philox uniforms, measuring (fused at even N, the measure
     launch at odd N) and not, the OR kernel and the measure mode (states
     bitwise, sums within 1e-12 of their scale);
   - periodic XY angles, at 256x200 x 2 and every angle class's launch
     (10000x10000 x 1, 2000x2000 x 32, 4000x4000 x 8, 1000x1000 x 20):
     angle_metro_kernel plain, measuring and in its snapshot mode (Philox;
     injected uniforms at the small shape) and angle_or_kernel plain and
     measuring, both colours; the int16 multisweep in both modes (the
     shared-memory mode where its fit rule takes the batch, the
     device-memory mode past it and where forced) at 32x48 x 2 (S = 4, n_or
     0, 1 and or_only), at the int16 classes' launches (1536x1536 x 1, S =
     64 and 40, and with one OR sweep; 1536x1536 x 2, S = 8), past the fit
     at 1536x1536 x 2 with one OR sweep and OR only, 1536x1536 x 3,
     1536x1536 x 32 (two rings of 66 blocks, 16 replicas each in turn)
     and 64x64 x 1600 (rings of one), and forced at 1536x1536 x 1;
     states bitwise, sums within 1e-12 of their scale;
2b. <m>, <e> after one sweep from all-up against their closed forms for
   the chains' quantized acceptances, over >= 1e10 sites per path (helical
   3-D at 151^3 and 501^3, where every neighbour lies in the other
   colour); at even nx*ny (101x100x100, four z-parity sub-phases) a
   two-sample test of the kernels against the int8 model on the card over
   >= 1e9 site-samples each;
   the clock's first sweep (q = 6 at kbt 0.91 and 0.80, q = 4 and 3 at
   0.91, with the engine's rounded thermometer and chain probabilities)
   over >= 1e10 sites each, periodic and helical (501x500);
   XY phase a from all-up at 4000x4000 x 8 over >= 1e10 sites: <S_x> =
   1 - e^(-4β)[I0(4β) - I1(4β)], <S_y> = 0 and the acceptance e^(-4β)
   I0(4β); one over-relaxation sweep of a random 4000x4000 x 8 state
   keeps the energy and |S| to float32 rounding; the rotation onto +x
   leaves |Σ S_y| / N below 1e-6 and |m| unchanged (1500x1500 x 4), and
   prep_finite_magne puts every replica of 1000x1000 x 20 within 1% of
   |m| = 0.02;
   helical XY phase a from all-up at 10001x10000 on both engines over
   >= 1e10 sites each (the same closed forms); one over-relaxation sweep
   of a random 10001x10000 state on each engine keeps the energy within
   the bound check_xy_helical_over_relax derives;
   the int8 phases' first sweep from all-up, with the measure kernel, at
   4000x4000 x 8 and 500^3 x 2 over >= 1e10 sites each, against the closed
   forms for the uint32-quantized thresholds; the int8 clock's at q = 5
   and 6, 2000x2000 x 16, over >= 1e10 sites each, against the closed form
   for its exact float32 arithmetic (the b site's four neighbours
   enumerated);
3. 2-D resident class: 2048^2, 16 replicas, 64 samples, 1000 MCS through
   the multisweep kernel;
4. 2-D streaming class: 8192^2, 4 replicas, 4 samples, 200 MCS through
   the measuring phase kernel; both against
   data/production/ising2d_1001x1000_mcs1000_s1440000.dat within 5
   standard errors of the port's mean;
3c. helical: 1001x1000, 128 replicas, 256 samples, 1000 MCS through the
   helical multisweep kernel, against the same curve (the same geometry);
4b. 3-D streaming class: 512^3, 8 replicas, 8 samples, 1000 MCS through
   the measuring 3-D phase kernel; 3-D resident class: 256^3, 4 replicas,
   16 samples, 200 MCS through the 3-D multisweep kernel; both against
   data/production/ising3d_512_mcs1000_s1024.dat within 5 combined
   standard errors (the reference has only 1024 samples);
4c. helical 3-D classes, from all-up, within 5 combined standard errors
   of the reference's curves where those are sound (ROADMAP C2, C3):
   resident 151x151x150 x 128 replicas, 128 samples, 1000 MCS through the
   multisweep kernel (t >= 100); streamed 501x501x500 x 2, 2 samples at
   the 16-sample curve's times up to 1000 through the measuring phase
   kernel (t >= 100); streamed 1001x1000x1000 x 2, 2 samples, 1000 MCS
   through four sub-phase launches and an energy launch a sweep, against
   the 90-sample curve with the 16 racy samples taken out (t >= 150);
4d. clock classes, from all-up, at every t <= 1000 within 5 combined
   standard errors of the reference's curves: periodic padded 2000x2000,
   q = 6, kbt 0.91, 40 replicas, 80 samples; aligned 2048x2048, kbt 0.8,
   16 replicas, 32 samples; helical 501x500, kbt 0.8, 100 replicas, 200
   samples (the clock phase kernel, streamed; the helical multisweep);
4e. XY classes, from all-up, at every t within 5 combined standard
   errors of the reference's curves: over-relaxation 4000x4000, kbt 0.89,
   8 replicas, 16 samples, 1000 MCS, n_over_relax 1 (t <= 1000 of
   xy2d_periodic_or_4000x4000_mcs10000_s3125.dat); Metropolis 2000x2000,
   kbt 0.895, 32 replicas, 64 samples, 100 MCS
   (xy2d_samples32_2000x2000_mcs100.dat);
4f. XY disorder classes, kbt 0.89, <|m|> (or <m>), <e> and <A> at every t
   within 5 combined standard errors of the reference's curves:
   from-disorder 1500x1500 x 1 replica, 64 samples, 1000 MCS (the
   2222-sample curve; the multisweep's shared-memory mode); from-disorder
   1500x1500 x 2, 4 samples, 200 MCS (the same curve; past the fit, the
   device-memory mode); fix1mcs 1500x1500 x 8, 32 samples, 200 MCS (the
   2000-sample curve); finite-magne 1000x1000 x 20, 40 samples, 100 MCS,
   m0 = 0.02 (the 500-sample curve); finite-magne samples, 20 histories
   of 100 MCS at 1000x1000, the row format and the per-t means of m_x, e
   and A against the file's 500 histories;
4g. helical XY classes at 10001x10000, one replica a sample, from all-up,
   at every t within 5 combined standard errors: over-relaxation, kbt
   0.89, 4 samples, 1000 MCS, n_over_relax 1, on the angle engine and
   again on the component engine (t <= 1000 of
   xy2d_or_10001x10000_mcs10000_s500.dat, its rows' Nsample); Metropolis,
   kbt 0.895, 4 samples, 100 MCS, on the angle engine, against
   xy2d_samples32_2000x2000_mcs100.dat and the one-sample
   xy2d_10001x10000_mcs10000_s1.dat (sigma from the 32-sample curve's
   N·Var);
4h. int8 Ising classes from all-up, at every t: 1000x1000 x 16, 64
   samples, 1000 MCS through the int8 multisweep and 4000x4000 x 8, 8
   samples, 200 MCS through the streamed phase and measure launches
   (against the 2-D curve within 5 standard errors of the port's mean);
   --protocol samples at 1000x1000, 16 histories of 200 MCS one at a time
   (the per-t means against the same curve, combined sigma); 500^3 x 2, 2
   samples, 1000 MCS through the 3-D phase and measure launches (against
   data/production/ising3d_512_mcs1000_s1024.dat, combined sigma);
4i. int8 clock classes from all-up: q = 2 (the Ising model) at 1000x1000
   x 16, 64 samples, 1000 MCS through the int8 clock multisweep, every t
   against the 2-D Ising curve; q = 5 at 2000x2000 x 16, 32 samples, 200
   MCS through the streamed phase and measure launches, m(1) and e(1)
   against the first-sweep closed form (sigma from the run's N·Var) and
   every row finite; --protocol samples at q = 6, 1000x1000, 16
   histories of 1000 MCS, the per-t means against
   data/production/clock_1000x1000_kbt0.91_mcs10000_s100.dat (combined
   sigma);
4j. masked helical classes from all-up: Ising 1001x1000 x 128, 128
   samples, 1000 MCS (SPINLAT_HELICAL_PACKED=0) and 4001x4000 x 4, 4
   samples, 200 MCS, every t against the 1001x1000 curve (combined sigma);
   1001x1001 x 16, 16 samples, 200 MCS, its |z| against that curve printed
   (the seam's Jacobi pairs); the clock q = 6 at 501x500 x 100, 100
   samples, 1000 MCS (SPINLAT_CLOCK_HELICAL_PACKED=0), every t against
   the 100-sample curve (the masked kernel's own curve is the same file),
   q = 2 at 1001x1000 x 64, 64 samples, 200 MCS against the Ising curve,
   q = 5 at 501x500 x 100, 100 samples, 200 MCS, t = 1 against the
   first-sweep closed form for the masked kernel's table and field order;
   XY with over-relaxation at 10001x10000 x 1, 2 samples, 200 MCS
   (SPINLAT_XY_DENSE=0) against xy2d_or_10001x10000_mcs10000_s500.dat,
   and Metropolis at 4001x4001 x 2, 2 samples, 100 MCS, kbt 0.895, its
   |z| against the 2000x2000 curve printed; --protocol samples, 16
   histories of 200 MCS, on helical Ising 1001x1000 and the helical clock
   q = 6 at 501x500, per-t means against their curves;
4k. short CLI runs (5 MCS, 2 samples) to a .dat of finite rows: the
   helical clock at q = 2, 5, 8 on 501x500 and 1001x1001, --protocol
   samples on helical XY at 4001x4001 and on helical 3-D at 151x151x150;
4l. periodic XY angle classes, each on the engine its switch selects
   (the .dat's engine line and the launches say so; no component kernel
   launched): under SPINLAT_XY_PERIODIC_ANGLE=1 the literal 10000x10000 x
   1, 4 samples, 200 MCS, kbt 0.895 (against the 2000x2000 curve at
   t <= 100, combined sigma, and the one-sample 10000x10000 curve at
   t <= 200, sigma from the 2000x2000 curve's N·Var, carried past its
   t = 100 by a power law fitted on t in [50, 100]); 2000x2000 x 32, 64
   samples, 100 MCS (the 32-sample curve, every t); over-relaxation at
   4000x4000 x 8, 16 samples, 200 MCS, n_or 1 (the OR curve, every t);
   finite-magne 1000x1000 x 20, 40 samples, 100 MCS, m0 0.02 (its curve,
   every t); under SPINLAT_XY_ANGLE_MS=1 the route readings (1500^2
   streamed, JAX's gate refusing ny % 16; 1536^2 on the int16 kernel) and
   from-disorder at 1536x1536 x 1, 32 samples, 1000 MCS (the int16
   multisweep's shared-memory mode) and at 1536x1536 x 2, 4 samples, 200
   MCS (past its fit: the device-memory mode), against the 1500x1500
   curve's size-free <e>, <A> and N·<m^2> at every t (combined sigma;
   Var(m^2) of a Gaussian m from the curve's second moments); and
   every earlier XY class, run with neither switch set, launched no angle
   kernel;
4m. periodic Ising on a mesh (parallel/domain.py) of the one card repeated,
   through protocols.run_relaxation to .dat from all-up, each class's
   table equal bit for bit to its unsharded class's (phases 4, 4b, 4h;
   their first 200 rows where those ran 1000 MCS) and within 5 sigma of
   the same reference curve at every t: packed 2-D 8192^2 x 4 on (1,4)
   and on (2,2,2) (bit-row and word-column halos), 4 samples, 200 MCS;
   packed 3-D 512^3 x 8 on (2,4), 8 samples, 200 MCS; int8 2-D 4000^2 x 8
   on (1,2,2), 8 samples, 200 MCS; int8 3-D 500^3 x 2 on (2,2), 2 samples,
   200 MCS; each class's rate beside its unsharded class's and the halo
   kernels' launches.  Then the clock and XY, 200 MCS each, against their
   unsharded classes' first 200 rows (phases 4d, 4e, 4f, 4i): the packed
   clock 2048^2 x 16, q = 6, 32 samples on (2,2,2), bit for bit and
   against the 2048x2048 curve; the int8 clock 2000^2 x 16, q = 5, 32
   samples on (1,2,2), within 1e-12 on the means (float64 sums in another
   order) and against the first-sweep closed form; XY 4000^2 x 8 with
   --n-over-relax 1, 16 samples on (2,2,2), and fix1mcs 1500^2 x 8, 32
   samples on (1,2,2), within 1e-12 and against their curves;
5. times with CUDA events, beside each kernel's bound and its plain
   version's time, at the main paths' launch shapes (the helical kernel
   at 128 x 1001x1000, S = 64; the clock phase kernel at 2000x2000 x 40,
   measuring and not; the helical clock kernel at 501x500 x 100, S = 64;
   both XY kernels at 4000x4000 x 8, measuring and not, and the
   Metropolis kernel at 2000x2000 x 32, measuring and not, each held
   against its plain version; each XY class's kernel share of its wall);
   the kernel's output there is held against
   the plain version's, bitwise, too; then each runner's two routes (one
   multisweep launch per S sweeps, or S streamed phase pairs) at and
   between the paths' shapes, and the helical 3-D routes at 151^3 x 128;
   the XY disorder kernels at every launch shape their classes run, each
   held against its plain version (state bitwise, sums within 1e-9
   relative): the snapshot mode at 1500x1500 x 8 (fix1mcs) and 1000x1000
   x 20 (finite-magne), measure_kernel at 1500x1500 x 8, the multisweep's
   shared-memory mode at 1500x1500 x 1 with S = 64 and 40 (from-disorder)
   and at 1000x1000 x 1 with S = 64 and 36 (samples), its device-memory
   mode at 1500x1500 x 2 and x 3 with S = 64 and 8 (past the fit: the
   from-disorder x2 class's launches and the route bound's batch), each
   row with its registers; and the disorder runner's two
   routes at XY_ROUTE_SHAPES, where the route bound is read; the four
   helical XY phase kernels at 10001x10000 x 1, plain and measuring, in
   three readings (the engines' A/B, angle over component), each held
   against its plain version, and each helical class's kernel share of
   its wall; the int8 kernels at their classes' launch shapes (the 2-D
   phase and the measure kernel at 4000x4000 x 8 and 1000x1000 x 1, the
   3-D ones at 500^3 x 2, the multisweep at 1000x1000 x 16 with S = 64
   and 40), each held against its plain version, each int8 class's kernel
   share of its wall, and the int8 route reading (one multisweep launch of
   64 sweeps against 64 streamed sweeps at 1000^2 and 2000^2 for several
   batches), where ops/ising2d_multisweep.MULTISWEEP_MAX_BYTES is read;
   the int8 clock kernels at their classes' launches (the phase and the
   measure kernel at 2000x2000 x 16 and 1000x1000 x 1, the multisweep at
   1000x1000 x 16 with S = 64 and 40), each held against its plain
   version, each clock class's kernel share of its wall, and the clock
   route reading at q = 6 (1000^2 x 1 and 16, 2000^2 x 8 and 16), where
   ops/clock_multisweep.MULTISWEEP_MAX_BYTES is read; the masked helical
   kernels at their classes' launches (the Ising multisweep at 1001x1000 x
   128 and the clock one at 501x500 x 100, S = 16; the XY phase, fused
   and not, the OR phase and the measure mode at 10001x10000 x 1), each
   held against its plain version, and each masked class's kernel share
   of its wall; the periodic XY angle kernels at their classes' launches
   (angle_metro_kernel plain and measuring at 10000x10000 x 1 and
   2000x2000 x 32, plain at 4000x4000 x 8 and 1000x1000 x 20, its
   snapshot mode at 1000x1000 x 20, angle_or_kernel plain and measuring
   at 4000x4000 x 8, the int16 multisweep's shared-memory mode at
   1536x1536 x 1 with S = 64 and 40, its device-memory mode at 1536x1536
   x 2 with S = 64 and 8 and x 3 with S = 8), each held against its plain
   version,
   each angle class's
   kernel share of its wall, and the A/B of the two periodic engines
   (2000x2000 x 32 end to end and a sweep's kernels; the OR class).  The
   helical 3-D multisweep is timed alone at its class's S = 64 and held
   against its plain version at S = 8 on the same lattice.  The four
   halo kernels at each mesh class's shard shape, plain and measuring
   phases, Philox and injected words, each held against its plain
   version, and each mesh class's kernel share of its wall; the clock and
   XY halo modes likewise (graph-timed at their classes' shards: the
   packed and int8 clock phase a and measuring, XY Metropolis phase a,
   OR phase a and measuring, the snapshot mode at the fix1mcs shard), and
   every mode against its plain version at small shards (Philox and
   injected, both colours, plain and measuring, with and without columns,
   an int8 clock shard at an odd col0, a packed one of one word row).

It prints the kernels' JSON line, the card's `nvidia-smi` name and power
limit, and last the device line.  It exits non-zero, printing no result,
without a card, and when any phase fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PRODUCTION = ROOT / "data" / "production"
REFERENCE_DAT = PRODUCTION / "ising2d_1001x1000_mcs1000_s1440000.dat"
REFERENCE_3D_DAT = PRODUCTION / "ising3d_512_mcs1000_s1024.dat"
REFERENCE_H3_151 = PRODUCTION / "ising3d_151x151x150_mcs1000_s10000.dat"
REFERENCE_H3_501 = (PRODUCTION
                    / "ising3d_501x501x500_specific_times_mcs10000_s16.dat")
REFERENCE_H3_1001 = PRODUCTION / "ising3d_1001x1000x1000_mcs1000_s500.dat"
RACY_H3_1001 = PRODUCTION / "ising3d_1001x1000x1000_mcs1000_s16.dat"
CLOCK_2000 = PRODUCTION / "clock_2000x2000_kbt0.91_mcs100000_s5000.dat"
CLOCK_2048 = PRODUCTION / "clock_2048x2048_mcs100000_s1088.dat"
CLOCK_501 = PRODUCTION / "clock_501x500_kbt0.80_mcs100000_s100.dat"
XY_OR_4000 = PRODUCTION / "xy2d_periodic_or_4000x4000_mcs10000_s3125.dat"
XY_2000 = PRODUCTION / "xy2d_samples32_2000x2000_mcs100.dat"
XY_FD_1500 = PRODUCTION / "xy2d_from_disorder_1500x1500_mcs100000_s2222.dat"
XY_FIX1_1500 = (PRODUCTION
                / "xy2d_from_disorder_fix1mcs_1500x1500_mcs100000_s2000.dat")
XY_FM_1000 = PRODUCTION / "xy2d_finite_magne_1000x1000_mcs100_s500.dat"
XY_FMS_1000 = (PRODUCTION
               / "xy2d_finite_magne_samples_1000x1000_mcs100_s500.dat")
XY_OR_10001 = PRODUCTION / "xy2d_or_10001x10000_mcs10000_s500.dat"
XY_10001 = PRODUCTION / "xy2d_10001x10000_mcs10000_s1.dat"
XY_10000 = PRODUCTION / "xy2d_periodic_10000x10000_mcs10000_s1.dat"
KBT_XY = 0.89                       # the 4000x4000 over-relaxation curve
KBT_XY_2000 = 0.895                 # the 2000x2000 Metropolis curve
KBT_CLOCK = 0.91                    # the 2000x2000 curve
KBT_CLOCK_08 = 0.8                  # the 2048x2048 and 501x500 curves
KBT = 2.26918531421
KBT_3D = 4.51152
KBT_H3 = 4.511454583186711          # 151^3 and 1001x1000x1000 curves
KBT_H3_501 = 4.51152174982078       # the 501^3 curve
SIGMAS = 5.0
# H100 SXM peaks at 700 W.  HBM3 bytes/s: NVIDIA data sheet.  32-bit
# integer instructions/s: an assumption, the SMs' issue limit of 132 SMs
# x 4 schedulers x 32 lanes at 1.98 GHz (the clock implied by the data
# sheet's 67 TFLOP/s of FP32 = 132 x 128 lanes x 2 x 1.98 GHz).  The
# CUDA C++ Programming Guide's throughput table gives compute capability
# 9.0 only 64 integer add/logic/shift results per clock and SM, so the
# limit holds only if IMAD (on the FMA pipe) issues alongside LOP3 and
# IADD3 (on the ALU pipe); at 64 per clock every bound would double
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 128 * 1.98e9
# minimum 32-bit instructions per word and phase: a Philox4x32-10 call
# is 10 rounds of 2 wide multiplies (hi and lo at once) and 2 three-input
# xors (its 9 round keys are the same for every call of a launch: the
# function needs them once a launch, not once a call); the Bernoulli
# chains fold two words per three-input logic op; the 2-D stencil, count
# and flip are 24 logic ops, the helical one 8 more (4 funnel shifts, 4
# wrap selects), the 3-D one 40 (6:3 count, 3 chains' flip); the fused
# (m, e) adds 7 popcounts and 9 integer adds (6 more masks for the
# helical pad bits)
OPS_PER_PHILOX = 10 * 4
OPS_STENCIL_FLIP = 24
OPS_HELICAL_SHIFTS = 8
OPS_STENCIL_FLIP_3D = 40
OPS_MEASURE = 16
OPS_HELICAL_MASKS = 6
# helical 3-D: 6 funnel shifts and 6 wrap selects; the z-parity word of a
# sub-phase; the energy pass per word: 6 modular reads (8 each) and 6
# xor-and-popcount-add, and the magnetisation's 2 popcounts and 3 adds
OPS_HELICAL3D_SHIFTS = 12
OPS_ZMASK = 8
OPS_ENERGY = 6 * 8 + 6 * 4 + 5
# clock, per word and phase (three-input logic ops): the proposal
# thermometer's 4 (q=6) or 2 (q=4) twelve-step comparisons and the CRT
# recode; the stencil of each state plane (2 funnel shifts, the side
# select, the top word's wrap); the decision (q=6: per bond 8 for x, eq,
# eq', w, w'; four 4:3 counters; two scaled sums; a 5-bit subtract; the
# gated acceptance; the updates); the fused (2m, 2e): 12-16 popcounts and
# their adds; helical: 12 modular reads of 3 each instead of the stencil,
# and my2's 4 popcounts
OPS_CLOCK_THERMO = {6: 4 * 12 + 6, 4: 2 * 12 + 2, 3: 0}
OPS_CLOCK_STENCIL = {6: 3 * 6, 4: 2 * 6, 3: 2 * 6}
OPS_CLOCK_DECIDE = {6: 32 + 6 + 4 * 6 + 2 * 8 + 10 + 10 + 6, 4: 80, 3: 50}
OPS_CLOCK_MEASURE = {6: 40, 4: 30, 3: 20}
OPS_CLOCK_HELICAL_READS = 12 * 3
OPS_CLOCK_MY = 10
# XY, per site of a phase (32-bit instructions): one Philox4x32-10 call
# for both uniforms and their conversion (4); the trig fold and
# polynomials (22); the field (6); dE, its clamp and scale (6); expf
# (~10); the test and the selects (4).  Over-relaxation: the field (6),
# two rsqrtf with their squares and clamps (14), the reflection (8), the
# scaling (2).  The fused sums: 3 widenings and 3 float64 adds a site.
# Bytes a site of the colour updated: its S read and written (16) and the
# other colour's S read once (8); the injected mode reads 8 more
OPS_XY_METROPOLIS = OPS_PER_PHILOX + 4 + 22 + 6 + 6 + 10 + 4
OPS_XY_OVER_RELAX = 6 + 14 + 8 + 2
OPS_XY_MEASURE = 6
XY_BYTES_PER_SITE = 24
# the snapshot mode's A: 4 multiplies, 2 adds, 2 widenings and a float64
# add a site; its bytes: both colours' snapshot read once, 16 B a site of
# the colour updated.  measure_kernel, per (y, i) (two sites): 4 state and
# 4 snapshot planes read once (32 B), ~24 float64 operations
OPS_XY_SNAP = 9
XY_SNAP_BYTES_PER_SITE = 16
OPS_XY_MEASURE_PAIR = 24
XY_MEASURE_BYTES_PAIR = 32
# (R, ny, nx, kbt): a small shape whose half (100) fills no whole warp,
# then both classes' launches; 2000x1000 sites a replica leave the
# Metropolis class's last block of 256 threads half idle
XY_CHECK_SHAPES = ((2, 256, 200, KBT_XY), (8, 4000, 4000, KBT_XY),
                   (32, 2000, 2000, KBT_XY_2000))
# the disorder classes' launches (R, ny, nx): a small shape, the literal
# 1500x1500 x 1 (750 columns a colour) and the finite-magne 1000x1000 x 20
XY_DISORDER_SHAPES = ((2, 256, 200), (1, 1500, 1500), (20, 1000, 1000))
# helical XY: the reference's geometry (nx, ny); the kernel checks at its
# launch (R, ny, nx) and at a small shape whose one block holds the seam,
# the ragged slot and both row wraps
HX, HY = 10001, 10000
XYH_CHECK_SHAPES = ((1, HY, HX), (4, 64, 65))
# per valid site of a helical phase (32-bit instructions), counting what
# the function needs: the component engine as the periodic one (OPS_XY_*);
# the angle engine decodes three angles a Metropolis site (the site, the
# candidate, and the other colour's angles once each, one a site: 22 each)
# and one an OR site, plus atan2_2pi (abs, min, max, the fold and its
# selects, the divide ~10, the polynomial 8, the fixups 6: ~30) and the
# reflection's 4; its fused sums are OPS_XY_MEASURE, plus one decode of
# the new angle after OR.  The tile kernel decodes ~1.13 other angles a
# site (a tile's halo) in both modes: that excess is the kernel's cost,
# not the bound's.  Bytes a site: 24 (components) or 12 (angles)
OPS_XYA_METROPOLIS = OPS_PER_PHILOX + 4 + 3 * 22 + 6 + 6 + 10 + 4
OPS_XYA_OVER_RELAX = 22 + 6 + 30 + 4
XYA_BYTES_PER_SITE = 12
# the route readings: ms a sweep of both routes, fused sums included
XY_ROUTE_SHAPES = ((1500, 1), (1500, 2), (1500, 3), (1500, 4), (1500, 5),
                   (1500, 6), (1500, 16),
                   (1000, 1), (1000, 4), (1000, 20))

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def chain_ops(msb, qs) -> int:
    """Minimum instructions of the Bernoulli chains of digits ``qs``."""
    draws = sum(msb.chain_draws(q) for q in qs)
    return math.ceil(draws / 4) * OPS_PER_PHILOX + math.ceil(draws / 2)


def phase_ops_per_word(msb, beta: float, measuring: bool) -> int:
    return (chain_ops(msb, msb.chain_words(beta)) + OPS_STENCIL_FLIP
            + (OPS_MEASURE if measuring else 0))


def helical_phase_ops_per_word(msb, beta: float, measuring: bool) -> int:
    return (phase_ops_per_word(msb, beta, measuring) + OPS_HELICAL_SHIFTS
            + (OPS_HELICAL_MASKS if measuring else 0))


def phase3d_ops_per_word(msb, ms3, beta: float, measuring: bool) -> int:
    return (chain_ops(msb, ms3.chain_words3d(beta)) + OPS_STENCIL_FLIP_3D
            + (OPS_MEASURE if measuring else 0))


def helical3d_phase_ops_per_word(msb, ms3, beta: float,
                                 measuring: bool) -> int:
    return (phase3d_ops_per_word(msb, ms3, beta, measuring)
            + OPS_HELICAL3D_SHIFTS + (OPS_HELICAL_MASKS if measuring else 0))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, launches: int, windows: int
                  ) -> tuple[float, float, float]:
    """Device time of one call of ``fn`` without the host's share:
    ``launches`` calls captured in one CUDA graph, the graph replayed in
    ``windows`` event-timed windows; (median, least, largest) ms a call
    over the windows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    del graph
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def time_kernel(label: str, flips: int, fn, plain, nbytes: float,
                ops: float, reps: int, plain_reps: int,
                view=lambda out: out, graphed: bool = False
                ) -> tuple[dict, int]:
    """CUDA-event time of a kernel's wrapper and of its plain version on
    the same inputs, beside the kernel's bound; ``flips`` is the flip
    attempts of one call.  Also the largest absolute difference between
    the two calls' outputs (the tensors ``view`` picks from each).  With
    ``graphed`` the kernel's time is :func:`graph_time_ms`'s median over
    nine windows of ``reps`` captured launches, and its spread is logged
    (a launch short enough for the wrapper's host work to show)."""
    last = {}
    spread = ""
    if graphed:
        last["kernel"] = fn()
        ms, lo, hi = graph_time_ms(fn, reps, 9)
        spread = f" (graph, {reps} launches x 9 windows: {lo:.4f}-{hi:.4f})"
    else:
        ms = cuda_time_ms(lambda: last.__setitem__("kernel", fn()),
                          reps=reps)
    plain_ms = cuda_time_ms(lambda: last.__setitem__("plain", plain()),
                            reps=plain_reps, warmup=plain_reps - 1)
    err = max_abs_err(zip(view(last["kernel"]), view(last["plain"])))
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch{spread} ({flips / ms * 1e3:.4g} "
        f"flip attempts/s), plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
        f"({by}); vs plain {err}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def host_ms_per_sweep(cp, spec, model, wa, wb, seeds) -> float:
    """Host time of one streamed clock sweep as the runner issues it (two
    phase launches and the fused densities) on the host's clock, the card
    left to run behind: the host's own cost a sweep."""
    wa, wb, _ = cp.sweep_measure_seeded(spec, model, wa, wb, seeds[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(seeds.shape[0]):
        wa, wb, _ = cp.sweep_measure_seeded(spec, model, wa, wb, seeds[j])
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / seeds.shape[0] * 1e3


def random_words(shape, seed: int, dev, n: int = 4) -> list[torch.Tensor]:
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                        dtype=np.int64).astype(np.int32)
                             ).to(dev) for _ in range(n)]


def max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if got.shape != want.shape:
            fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def check_kernels(msb, rng, dev, shapes) -> dict[str, int]:
    """2-D kernel vs plain version on the same CUDA tensors, bitwise, at
    each (R, ny, nx, S[, kbt]) (kbt Tc unless given); returns the largest
    absolute difference seen per kernel (0 when equal)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D

    errs = {"phase": 0, "multisweep": 0}
    for nrep, ny, nx, sweeps, *kbt in shapes:
        beta = 1.0 / (kbt[0] if kbt else KBT)
        shape = (nrep, ny // 32, nx // 2)
        x, o, b4, b8 = random_words(shape, ny + nrep, dev)
        key = rng.sample_key(rng.base_key(7), ny)
        seeds = msb.sweep_seed_pairs(key, sweeps)
        for color in (0, 1):
            e = max_abs_err([(
                msb.phase_packed_with_bits(x, o, b4, b8, color=color),
                msb.packed_phase_reference(x, o, color, b4, b8))])
            e_r = max_abs_err([(
                msb.phase_packed(x, o, seeds[0, color], color=color,
                                 beta=beta),
                msb.phase_packed_plain(x, o, seeds[0, color], color=color,
                                       beta=beta))])
            got, got_obs = msb.phase_packed(x, o, seeds[0, color],
                                            color=color, beta=beta,
                                            measuring=True)
            want, want_obs = msb.phase_packed_plain(
                x, o, seeds[0, color], color=color, beta=beta,
                measuring=True)
            e_m = max_abs_err([(got, want), (got_obs, want_obs)])
            # the fused sums against the model's exact sums of the state
            model_state = msb.unpack_state(*((o, got) if color else
                                             (got, o)), True)
            model = Ising2D(nx=nx, ny=ny, kbt=KBT)
            exact = torch.stack([model.magne_sum(model_state),
                                 model.energy_sum(model_state)], dim=-1)
            e_x = max_abs_err([(got_obs, exact)])
            errs["phase"] = max(errs["phase"], e, e_r, e_m, e_x)
            log(f"  phase kernel {nrep}x{ny}x{nx} kbt {1 / beta:.6g} colour "
                f"{color}: bits {e}, philox {e_r}, measuring {e_m}, "
                f"(m, e) vs exact sums {e_x}")
        wa, wb = x, o
        ka, kb, k_obs = msb.multisweep_planes(wa, wb, seeds, beta=beta)
        obs = []
        pa, pb = wa, wb
        for s in range(sweeps):
            pa = msb.phase_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
            pb, ob = msb.phase_packed(pb, pa, seeds[s, 1], color=1,
                                      beta=beta, measuring=True)
            obs.append(ob)
        e_pairs = max_abs_err([(ka, pa), (kb, pb),
                               (k_obs, torch.stack(obs, dim=1))])
        qa, qb, q_obs = msb.multisweep_planes_plain(wa, wb, seeds, beta=beta)
        e_plain = max_abs_err([(ka, qa), (kb, qb), (k_obs, q_obs)])
        errs["multisweep"] = max(errs["multisweep"], e_pairs, e_plain)
        log(f"  multisweep kernel {nrep}x{ny}x{nx} kbt {1 / beta:.6g} "
            f"S={sweeps}: vs {sweeps} phase pairs {e_pairs}, vs plain "
            f"{e_plain}")
    torch.cuda.synchronize()
    for name, e in errs.items():
        if e != 0:
            fail(f"{name} kernel differs from its plain version "
                 f"(max abs err {e})")
    return errs


def helical_exact(model, hms, wa, wb) -> torch.Tensor:
    """(R, 2) exact (m, e) sums of the unpacked helical (2-D or 3-D)
    state."""
    m = model.nsites // 2
    flat = hms.merge_flat(hms.unpack_flat(wa, m), hms.unpack_flat(wb, m))
    return torch.stack([model.magne_sum(flat), model.energy_sum(flat)], -1)


def check_helical(hms, rng, dev) -> int:
    """Helical multisweep kernel vs its plain version, bitwise on the
    valid bits; returns the largest absolute difference seen."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising2DHelical,
    )

    beta = 1.0 / KBT
    err = 0

    def valid(w, m):
        return hms._u32(w) & hms.valid_mask(m, dev)

    for nrep, nx, ny in ((2, 131, 62), (4, 1001, 1000)):
        m = nx * ny // 2
        x, o, b4, b8 = random_words((nrep, hms.words(m)), nx, dev)
        for color, offs in enumerate(hms.helical_offsets(nx)):
            e = max_abs_err([(
                valid(hms.phase_packed_with_bits(x, o, b4, b8, offs=offs,
                                                 m=m), m),
                valid(hms.packed_helical_phase_reference(x, o, offs, b4, b8,
                                                         m), m))])
            err = max(err, e)
            log(f"  helical bits mode {nrep}x{nx}x{ny} (M {m}, "
                f"{m % 32 or 32} bits in the last word) colour {color}: {e}")
    # 64 sweeps: one launch, 64 one-sweep launches, the plain version,
    # and the exact sums of the final state
    nx, ny, nrep, sweeps = 1001, 1000, 4, 64
    model = Ising2DHelical(nx, ny, KBT)
    m = model.nsites // 2
    wa, wb = random_words((nrep, hms.words(m)), 5, dev, n=2)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(9), 1), sweeps)
    kw = dict(beta=beta, nx=nx, m=m)
    ka, kb, kobs = hms.multisweep_planes(wa, wb, seeds, **kw)
    sa, sb, sobs = wa, wb, []
    for s in range(sweeps):
        sa, sb, o = hms.multisweep_planes(sa, sb, seeds[s:s + 1], **kw)
        sobs.append(o)
    e_single = max_abs_err([(valid(ka, m), valid(sa, m)),
                            (valid(kb, m), valid(sb, m)),
                            (kobs, torch.cat(sobs, dim=1))])
    pa, pb, pobs = hms.multisweep_plain(wa, wb, seeds, **kw)
    e_plain = max_abs_err([(valid(ka, m), valid(pa, m)),
                           (valid(kb, m), valid(pb, m)), (kobs, pobs)])
    e_exact = max_abs_err([(kobs[:, -1], helical_exact(model, hms, ka, kb))])
    log(f"  helical multisweep {nrep}x{nx}x{ny} S={sweeps} (staged "
        f"{hms.staged_fits(hms.words(m), dev)}): vs {sweeps} one-sweep "
        f"launches {e_single}, vs plain {e_plain}, (m, e) vs exact sums "
        f"{e_exact}")
    err = max(err, e_single, e_plain, e_exact)
    # the unrolled chains' edges: kbt 1e9 (both chains draw twenty
    # words), 0.5 (B8 draws none) and 0.2 (neither draws)
    nx, ny, nrep, sweeps = 131, 62, 3, 8
    for kbt in (1e9, 0.5, 0.2):
        model = Ising2DHelical(nx, ny, kbt)
        m = model.nsites // 2
        wa, wb = random_words((nrep, hms.words(m)), 7, dev, n=2)
        seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(9), 3),
                                     sweeps)
        kw = dict(beta=1.0 / kbt, nx=nx, m=m)
        ka, kb, kobs = hms.multisweep_planes(wa, wb, seeds, **kw)
        pa, pb, pobs = hms.multisweep_plain(wa, wb, seeds, **kw)
        e_plain = max_abs_err([(valid(ka, m), valid(pa, m)),
                               (valid(kb, m), valid(pb, m)), (kobs, pobs)])
        e_exact = max_abs_err([(kobs[:, -1],
                                helical_exact(model, hms, ka, kb))])
        log(f"  helical multisweep {nrep}x{nx}x{ny} kbt {kbt:g} S={sweeps}: "
            f"vs plain {e_plain}, (m, e) vs exact sums {e_exact}")
        err = max(err, e_plain, e_exact)
    # above the shared memory: the device-memory variant
    nx, ny, nrep, sweeps = 2001, 2000, 2, 4
    model = Ising2DHelical(nx, ny, KBT)
    m = model.nsites // 2
    if hms.staged_fits(hms.words(m), dev):
        fail(f"{nx}x{ny} fits the shared memory: the device-memory "
             "variant goes unchecked")
    wa, wb = random_words((nrep, hms.words(m)), 6, dev, n=2)
    seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(9), 2), sweeps)
    kw = dict(beta=beta, nx=nx, m=m)
    ka, kb, kobs = hms.multisweep_planes(wa, wb, seeds, **kw)
    pa, pb, pobs = hms.multisweep_plain(wa, wb, seeds, **kw)
    e_plain = max_abs_err([(valid(ka, m), valid(pa, m)),
                           (valid(kb, m), valid(pb, m)), (kobs, pobs)])
    e_exact = max_abs_err([(kobs[:, -1], helical_exact(model, hms, ka, kb))])
    log(f"  helical multisweep {nrep}x{nx}x{ny} S={sweeps} (staged "
        f"{hms.staged_fits(hms.words(m), dev)}): vs plain {e_plain}, "
        f"(m, e) vs exact sums {e_exact}")
    err = max(err, e_plain, e_exact)
    torch.cuda.synchronize()
    if err != 0:
        fail(f"helical multisweep kernel differs from its plain version "
             f"(max abs err {err})")
    return err


def ising3d_exact(model, msb, wa, wb) -> torch.Tensor:
    """(R, 2) exact (m, e) sums of the unpacked 3-D state, one replica at
    a time (a 512^3 replica unpacks to 128 MiB of int8 per colour)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )

    rows = []
    for r in range(wa.shape[0]):
        st = CheckerboardState(msb.unpack_color(wa[r]),
                               msb.unpack_color(wb[r]))
        rows.append(torch.stack([model.magne_sum(st), model.energy_sum(st)]))
    return torch.stack(rows)


def check_ising3d(msb, ms3, rng, dev) -> dict[str, int]:
    """3-D kernels vs their plain versions on the same CUDA tensors,
    bitwise; returns the largest absolute difference seen per kernel."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising3D

    beta = 1.0 / KBT_3D
    errs = {"phase": 0, "multisweep": 0}
    for nrep, nz, ny, nx in ((2, 8, 256, 256), (8, 512, 512, 512)):
        model = Ising3D(nx=nx, ny=ny, nz=nz, kbt=KBT_3D)
        shape = (nrep, nz, ny // 32, nx // 2)
        x, o, b4, b8 = random_words(shape, nz + nrep, dev)
        b12 = random_words(shape, nz + nrep + 1, dev, n=1)[0]
        seeds = ms3.sweep_seed_pairs(rng.sample_key(rng.base_key(8), nz), 1)
        for color in (0, 1):
            e = max_abs_err([(
                ms3.phase3d_packed_with_bits(x, o, b4, b8, b12, color=color),
                ms3.packed_phase3d_reference(x, o, color, b4, b8, b12))])
            e_r = max_abs_err([(
                ms3.phase3d_packed(x, o, seeds[0, color], color=color,
                                   beta=beta),
                ms3.phase3d_plain(x, o, seeds[0, color], color=color,
                                  beta=beta))])
            got, got_obs = ms3.phase3d_packed(x, o, seeds[0, color],
                                              color=color, beta=beta,
                                              measuring=True)
            want, want_obs = ms3.phase3d_plain(x, o, seeds[0, color],
                                               color=color, beta=beta,
                                               measuring=True)
            e_m = max_abs_err([(got, want), (got_obs, want_obs)])
            exact = ising3d_exact(model, msb, *((o, got) if color
                                               else (got, o)))
            e_x = max_abs_err([(got_obs, exact)])
            errs["phase"] = max(errs["phase"], e, e_r, e_m, e_x)
            log(f"  3-D phase kernel {nrep}x{nz}x{ny}x{nx} colour {color}: "
                f"bits {e}, philox {e_r}, measuring {e_m}, (m, e) vs exact "
                f"sums {e_x}")
        del x, o, b4, b8, b12, got, want
    nrep, n, sweeps = 4, 256, 64
    wa, wb = random_words((nrep, n, n // 32, n // 2), 3, dev, n=2)
    seeds = ms3.sweep_seed_pairs(rng.sample_key(rng.base_key(8), 3), sweeps)
    ka, kb, k_obs = ms3.multisweep3d_planes(wa, wb, seeds, beta=beta)
    pa, pb, obs = wa, wb, []
    for s in range(sweeps):
        pa = ms3.phase3d_packed(pa, pb, seeds[s, 0], color=0, beta=beta)
        pb, ob = ms3.phase3d_packed(pb, pa, seeds[s, 1], color=1, beta=beta,
                                    measuring=True)
        obs.append(ob)
    # against its plain version at this shape and S in phase 5 (6.7 s a
    # plain call)
    errs["multisweep"] = max_abs_err([(ka, pa), (kb, pb),
                                      (k_obs, torch.stack(obs, dim=1))])
    log(f"  3-D multisweep kernel {nrep}x{n}^3 S={sweeps}: vs {sweeps} "
        f"phase pairs {errs['multisweep']}")
    torch.cuda.synchronize()
    for name, e in errs.items():
        if e != 0:
            fail(f"3-D {name} kernel differs from its plain version "
                 f"(max abs err {e})")
    return errs


# the classes' launches, and phase 4k's --protocol samples (151^3 x 1)
H3_CHECK_SHAPES = ((8, 151, 151, 150), (1, 501, 501, 500),
                   (1, 1001, 1000, 1000), (1, 151, 151, 150))
# the energy kernel's edges (R, nx, ny, nz): even nx·ny with M % 32 = 23,
# whose runs cross the seam where the far planes wrap, odd nx·ny with M %
# 32 = 27, M % 32 = 9, and a replica shorter than one run (M = 30); each
# also on views H3_ENERGY_VIEWS words off the 16-B grid (the two colours
# apart)
H3_ENERGY_EDGES = ((3, 129, 62, 9), (2, 65, 63, 10), (1, 7, 5, 6),
                   (3, 5, 3, 4))
H3_ENERGY_VIEWS = ((1, 3), (2, 0))


def word_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous int32 copy of ``t`` on its device whose first word
    lies ``off`` words past a 16-B aligned address."""
    buf = torch.empty(t.numel() + 8, dtype=torch.int32, device=t.device)
    base = (-buf.data_ptr()) % 16 // 4
    v = buf[base + off:base + off + t.numel()].view(t.shape)
    assert v.data_ptr() % 16 == 4 * off and v.is_contiguous()
    return v.copy_(t)


def check_helical3d(h3, hms, rng, dev) -> dict[str, int]:
    """Helical 3-D kernels vs their plain versions on the same CUDA
    tensors, bitwise on the valid bits; returns the largest absolute
    difference seen per kernel."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )

    beta = 1.0 / KBT_H3
    errs = {"phase": 0, "energy": 0, "multisweep": 0}

    def valid(w, m):
        return hms._u32(w) & hms.valid_mask(m, dev)

    for nrep, nx, ny, nz in H3_CHECK_SHAPES:
        model = Ising3DHelical(nx, ny, nz, KBT_H3)
        nxy, m = model.nxy, model.nsites // 2
        geom = dict(nx=nx, nxy=nxy, m=m)
        x, o, b4, b8 = random_words((nrep, hms.words(m)), nz + nrep, dev)
        b12 = random_words((nrep, hms.words(m)), nz + 1, dev, n=1)[0]
        seeds = h3.sweep_keys(model, rng.sample_key(rng.base_key(10), nx), 1)
        for i, (color, zsub) in enumerate(h3.sub_phases(model)):
            offs_cross, offs_self = h3._stencil(nx, nxy, color)
            zmask = None if zsub is None else h3.zmask_words(nxy, m, dev)
            e = max_abs_err([(
                valid(h3.phase_packed_with_bits(x, o, b4, b8, b12,
                                                color=color, zsub=zsub,
                                                **geom), m),
                valid(h3.packed_phase_reference(
                    x, o, offs_cross, offs_self, b4, b8, b12, m,
                    zmask=zmask, zsub=zsub or 0), m))])
            key = seeds[0, i]
            kw = dict(color=color, zsub=zsub, beta=beta, **geom)
            e_r = max_abs_err([(
                valid(h3.phase_packed(x, o, key, **kw), m),
                valid(h3.phase_plain(x, o, key, **kw), m))])
            got, got_obs = h3.phase_packed(x, o, key, measuring=True,
                                           **kw)
            want, want_obs = h3.phase_plain(x, o, key, measuring=True,
                                            **kw)
            e_m = max_abs_err([(valid(got, m), valid(want, m)),
                               (got_obs, want_obs)])
            errs["phase"] = max(errs["phase"], e, e_r, e_m)
            log(f"  helical3d phase kernel {nrep}x{nx}x{ny}x{nz} (M {m}, "
                f"{m % 32 or 32} bits in the last word) colour {color} "
                f"zsub {zsub}: bits {e}, philox {e_r}, measuring {e_m}")
        got = h3.energy_sums(x, o, **geom)
        e_e = max_abs_err([(got, h3.energy_sums_plain(x, o, **geom))])
        exact = model.nsites * nrep < 10 ** 8   # unpacks to int64 sums
        e_x = (max_abs_err([(got, helical_exact(model, hms, x, o))])
               if exact else 0)
        errs["energy"] = max(errs["energy"], e_e, e_x)
        log(f"  helical3d energy kernel {nrep}x{nx}x{ny}x{nz}: vs plain "
            f"{e_e}" + (f", vs exact sums {e_x}" if exact else ""))
        del x, o, b4, b8, b12, got, want
    for nrep, nx, ny, nz in H3_ENERGY_EDGES:
        geom = dict(nx=nx, nxy=nx * ny, m=nx * ny * nz // 2)
        wa, wb = random_words((nrep, hms.words(geom["m"])), nx + nz, dev,
                              n=2)
        want = h3.energy_sums_plain(wa, wb, **geom)
        e_e = max_abs_err(
            [(h3.energy_sums(wa, wb, **geom), want)]
            + [(h3.energy_sums(word_view(wa, oa), word_view(wb, ob), **geom),
                want) for oa, ob in H3_ENERGY_VIEWS])
        errs["energy"] = max(errs["energy"], e_e)
        runs = h3.energy_runs(nrep, **geom)
        log(f"  helical3d energy kernel {nrep}x{nx}x{ny}x{nz} (M "
            f"{geom['m']}, {runs['bulk']} of {runs['nruns']} runs bulk), "
            f"views {H3_ENERGY_VIEWS} words off the 16-B grid: vs plain "
            f"{e_e}")
    # the C entry point refuses runs whose last bulk run would read past
    # word W - 1 (the wrapper builds none)
    geom = dict(nx=129, nxy=129 * 62, m=129 * 62 * 9 // 2)
    runs = h3._energy_runs_arg(3, **geom)
    bad = type(runs)(*runs)
    bad[1] += 1  # bulk
    code = h3._lib().helical3d_energy(
        None, None, None, 3, hms.words(geom["m"]), geom["m"],
        h3._offsets([d for _, _, d in h3._energy_pairs(129, 129 * 62)],
                    geom["m"]), 1, bad, None)
    log(f"  helical3d energy entry point, one bulk run too many: code {code}")
    if code != 1:
        fail(f"helical3d energy took runs past a replica (code {code})")
    # 64 sweeps at 151^3 x 8 and 8 at 151^3 x 1 (--protocol samples'
    # launch): one launch, as many streamed phase pairs, plain
    model = Ising3DHelical(151, 151, 150, KBT_H3)
    geom = dict(nx=151, nxy=model.nxy, m=model.nsites // 2)
    m = geom["m"]
    for nrep, sweeps, seed in ((8, 64, 16), (1, 8, 17)):
        wa, wb = random_words((nrep, hms.words(m)), seed, dev, n=2)
        seeds = h3.sweep_keys(model, rng.sample_key(rng.base_key(10),
                                                    seed - 15), sweeps)
        ka, kb, kobs = h3.multisweep_planes(wa, wb, seeds, beta=beta, **geom)
        sa, sb, sobs = wa, wb, []
        for s in range(sweeps):
            sa = h3.phase_packed(sa, sb, seeds[s, 0], color=0, beta=beta,
                                 **geom)
            sb, ob = h3.phase_packed(sb, sa, seeds[s, 1], color=1,
                                     beta=beta, measuring=True, **geom)
            sobs.append(ob)
        e_pairs = max_abs_err([(valid(ka, m), valid(sa, m)),
                               (valid(kb, m), valid(sb, m)),
                               (kobs, torch.stack(sobs, dim=1))])
        pa, pb, pobs = h3.multisweep_plain(wa, wb, seeds, beta=beta, **geom)
        e_plain = max_abs_err([(valid(ka, m), valid(pa, m)),
                               (valid(kb, m), valid(pb, m)), (kobs, pobs)])
        e_exact = max_abs_err([(kobs[:, -1], helical_exact(model, hms, ka,
                                                             kb))])
        errs["multisweep"] = max(errs["multisweep"], e_pairs, e_plain,
                                 e_exact)
        log(f"  helical3d multisweep kernel {nrep}x151x151x150 S={sweeps}: "
            f"vs {sweeps} phase pairs {e_pairs}, vs plain {e_plain}, (m, e) "
            f"vs exact sums {e_exact}")
    # the C entry point refuses a chain table the kernel cannot follow
    # (the wrapper's check raises first)
    offs_a, offs_b, table = h3.multisweep_args(beta=beta, **geom)
    bad = (type(table))(*table)
    bad[len(bad) - 1] = 4 * h3.CHAIN_CALLS + 1
    code = h3._lib().helical3d_multisweep(
        None, None, None, None, None, None, 1, hms.words(m), m, 1, offs_a,
        offs_b, bad, None)
    log(f"  helical3d multisweep entry point, a table of 61 draws: code "
        f"{code}")
    if code != 1:
        fail(f"helical3d multisweep took a bad chain table (code {code})")
    torch.cuda.synchronize()
    for name, e in errs.items():
        if e != 0:
            fail(f"helical3d {name} kernel differs from its plain version "
                 f"(max abs err {e})")
    return errs


def first_sweep_exact(msb, beta: float) -> tuple[float, float]:
    """Exact E[m], E[e] per site after one sweep from all-up, for the
    chains' quantized acceptances p4, p8, on any lattice whose sites have
    four distinct neighbours of the other colour (periodic and helical
    2-D).  Phase a flips each site with p8 (all four neighbours up); a
    phase-b site with c up neighbours flips surely for c <= 2, with p4 for
    c = 3 and p8 for c = 4."""
    q4, q8 = msb.chain_words(beta)
    return first_sweep_exact_p(q4 / 2 ** 20, q8 / 2 ** 20)


def first_sweep_exact_p(p4: float, p8: float) -> tuple[float, float]:
    """:func:`first_sweep_exact` for the acceptances p4, p8 (the int8
    kernels' uint32 thresholds over 2^32)."""
    all4, three = (1 - p8) ** 4, 4 * p8 * (1 - p8) ** 3
    flip_b = (1 - all4 - three) + three * p4 + all4 * p8
    m1 = 0.5 * (1 - 2 * p8) + 0.5 * (1 - 2 * flip_b)
    # a bond (a0, b0): b0's other three neighbours are up with 1 - p8
    up3, two3 = (1 - p8) ** 3, 3 * p8 * (1 - p8) ** 2
    flip_if_a0_up = (1 - up3 - two3) + two3 * p4 + up3 * p8
    flip_if_a0_down = (1 - up3) + up3 * p4
    bond = ((1 - p8) * (1 - 2 * flip_if_a0_up)
            - p8 * (1 - 2 * flip_if_a0_down))
    return m1, -2 * bond


def first_sweep_exact3d(ms3, beta: float) -> tuple[float, float]:
    """Exact E[m], E[e] per site after one 3-D sweep from all-up, for the
    quantized p4, p8, p12.  Phase a flips each site with p12 (six up
    neighbours, dE = 12).  A phase-b site then has c ~ 6 - Binomial(6,
    p12) up neighbours; it flips with p12, p8, p4 for c = 6, 5, 4 and
    surely for c <= 3.  A bond (a0, b0): b0's other five neighbours are
    independent of a0, so E[s_a s_b] follows from a0's two cases, and
    e = -3 E[s_a s_b] (three bonds a site)."""
    return first_sweep_exact3d_p(*(q / 2 ** 20
                                   for q in ms3.chain_words3d(beta)))


def first_sweep_exact3d_p(p4: float, p8: float, p12: float
                          ) -> tuple[float, float]:
    """:func:`first_sweep_exact3d` for the acceptances p4, p8, p12."""
    acc = {4: p4, 5: p8, 6: p12}

    def flip_prob(extra_up: int, others: int) -> float:
        """P(flip) of an up b-site with ``extra_up`` known up neighbours
        and ``others`` independent ones, each up with 1 - p12."""
        total = 0.0
        for k in range(others + 1):
            pk = math.comb(others, k) * (1 - p12) ** k * p12 ** (others - k)
            total += pk * acc.get(extra_up + k, 1.0)
        return total

    flip_b = flip_prob(0, 6)
    m1 = 0.5 * (1 - 2 * p12) + 0.5 * (1 - 2 * flip_b)
    bond = ((1 - p12) * (1 - 2 * flip_prob(1, 5))
            - p12 * (1 - 2 * flip_prob(0, 5)))
    return m1, -3 * bond


def check_z(name: str, total, nsites: int, want: tuple[float, float],
            nvar: tuple[float, float]) -> float:
    """<m>, <e> summed over ``nsites`` sites against their exact values,
    within SIGMAS standard errors (variance from the reference's N·Var at
    t = 1).  Returns the larger |z|."""
    worst = 0.0
    for obs, got, exact, nv in (("m", int(total[0]) / nsites, want[0],
                                 nvar[0]),
                                ("e", int(total[1]) / nsites, want[1],
                                 nvar[1])):
        z = (got - exact) / math.sqrt(nv / nsites)
        log(f"  {name} first sweep <{obs}> {got:.9f} exact {exact:.9f} "
            f"over {nsites:.3g} sites, z {z:+.2f}")
        if abs(z) > SIGMAS:
            fail(f"{name} first-sweep <{obs}> is {z:+.2f} sigma from exact")
        worst = max(worst, abs(z))
    return worst


def check_first_sweep(msb, rng, dev, ref_row, iters: int) -> None:
    """2-D <m>(1), <e>(1) of the phase kernel over iters x 4 x 8192^2
    sites against their exact values: a test of the in-kernel Bernoulli
    chains far sharper than the reference curve."""
    beta = 1.0 / KBT
    up = torch.full((4, 8192 // 32, 4096), -1, dtype=torch.int32,
                    device=dev)
    total = torch.zeros(2, dtype=torch.int64, device=dev)
    base = rng.base_key(2024)
    for it in range(iters):
        seeds = msb.sweep_seed_pairs(rng.sample_key(base, it), 1)[0]
        wa = msb.phase_packed(up, up, seeds[0], color=0, beta=beta)
        _, obs = msb.phase_packed(up, wa, seeds[1], color=1, beta=beta,
                                  measuring=True)
        total += obs.sum(dim=0)
    check_z("2-D", total, iters * up.numel() * 64,
            first_sweep_exact(msb, beta), (ref_row[7], ref_row[8]))


def check_first_sweep_helical(msb, hms, rng, dev, ref_row, iters: int
                              ) -> None:
    """Helical <m>(1), <e>(1) of the multisweep kernel over iters x 128 x
    1001x1000 sites: the same closed form as the periodic lattice (four
    distinct neighbours of the other colour)."""
    beta = 1.0 / KBT
    nx, ny, nrep = 1001, 1000, 128
    m = nx * ny // 2
    up = torch.full((nrep, hms.words(m)), -1, dtype=torch.int32, device=dev)
    total = torch.zeros(2, dtype=torch.int64, device=dev)
    base = rng.base_key(2025)
    for it in range(iters):
        seeds = hms.sweep_seed_pairs(rng.sample_key(base, it), 1)
        _, _, obs = hms.multisweep_planes(up, up, seeds, beta=beta, nx=nx,
                                          m=m)
        total += obs[:, 0].sum(dim=0)
    check_z("helical", total, iters * nrep * nx * ny,
            first_sweep_exact(msb, beta), (ref_row[7], ref_row[8]))


def check_first_sweep_3d(ms3, rng, dev, ref_row, iters: int) -> None:
    """3-D <m>(1), <e>(1) of the phase kernel over iters x 8 x 512^3
    sites: the sharp test of the three chains and the 3-D counter."""
    beta = 1.0 / KBT_3D
    up = torch.full((8, 512, 512 // 32, 256), -1, dtype=torch.int32,
                    device=dev)
    total = torch.zeros(2, dtype=torch.int64, device=dev)
    base = rng.base_key(2026)
    for it in range(iters):
        seeds = ms3.sweep_seed_pairs(rng.sample_key(base, it), 1)[0]
        wa = ms3.phase3d_packed(up, up, seeds[0], color=0, beta=beta)
        _, obs = ms3.phase3d_packed(up, wa, seeds[1], color=1, beta=beta,
                                    measuring=True)
        total += obs.sum(dim=0)
    check_z("3-D", total, iters * up.numel() * 64,
            first_sweep_exact3d(ms3, beta), (ref_row[7], ref_row[8]))


def check_first_sweep_helical3d(h3, ms3, hms, rng, dev, ref_row, dims,
                                kbt: float, nrep: int, iters: int) -> None:
    """Helical 3-D <m>(1), <e>(1) over iters x nrep replicas at odd nx·ny,
    on the route the runner takes: every neighbour lies in the other
    colour, so the periodic closed form is exact.  The variance is the
    periodic 512^3 curve's N·Var at t = 1 (the helical curves' t = 1 rows
    are unsound, ROADMAP C2)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )

    model = Ising3DHelical(*dims, kbt)
    m = model.nsites // 2
    geom = dict(nx=model.nx, nxy=model.nxy, m=m, beta=model.beta)
    up = torch.full((nrep, hms.words(m)), -1, dtype=torch.int32, device=dev)
    total = torch.zeros(2, dtype=torch.int64, device=dev)
    base = rng.base_key(2027 + model.nx)
    for it in range(iters):
        seeds = h3.sweep_keys(model, rng.sample_key(base, it), 1)
        if h3.fits(model):
            _, _, obs = h3.multisweep_planes(up, up, seeds, **geom)
            total += obs[:, 0].sum(dim=0)
        else:
            wa = h3.phase_packed(up, up, seeds[0, 0], color=0, **geom)
            _, obs = h3.phase_packed(up, wa, seeds[0, 1], color=1,
                                     measuring=True, **geom)
            total += obs.sum(dim=0)
    check_z("helical 3-D {}x{}x{}".format(*dims), total,
            iters * nrep * model.nsites,
            first_sweep_exact3d(ms3, model.beta), (ref_row[7], ref_row[8]))


def check_first_sweep_even(h3, hms, rng, dev, nrep: int, calls: int,
                           batch: int, batches: int) -> float:
    """Even nx·ny (101x100x100): <m>(1), <e>(1) of the kernels (four
    z-parity sub-phase launches and the energy launch, calls x nrep
    replicas) against the int8 model's sweep on the card (batches x batch
    replicas), a two-sample z-test on the per-replica values.  No closed
    form is at hand: the local structure changes near the helix's plane
    crossings.  Returns the largest |z|."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )

    model = Ising3DHelical(101, 100, 100, KBT_H3)
    m = model.nsites // 2
    kern = {"m": [], "e": []}
    base = rng.base_key(2030)
    for c in range(calls):
        up = torch.full((nrep, hms.words(m)), -1, dtype=torch.int32,
                        device=dev)
        seeds = h3.sweep_keys(model, rng.sample_key(base, c), 1)[0]
        _, _, obs = h3.sweep_measure_seeded(model, up, up, seeds)
        for k in kern:
            kern[k].append(obs[k])
    oracle = {"m": [], "e": []}
    base = rng.base_key(2031)
    for c in range(batches):
        flat = model.init_state("allup", device=dev, batch=(batch,))
        flat = model.sweep(flat, rng.sweep_key(rng.sample_key(base, c), 1))
        oracle["m"].append(model.magne_sum(flat).double() / model.nsites)
        oracle["e"].append(model.energy_sum(flat).double() / model.nsites)
        del flat
    worst = 0.0
    for k in ("m", "e"):
        a, b = torch.cat(kern[k]), torch.cat(oracle[k])
        z = float((a.mean() - b.mean())
                  / torch.sqrt(a.var() / a.numel() + b.var() / b.numel()))
        log(f"  even nx*ny 101x100x100 first sweep <{k}>: kernels "
            f"{float(a.mean()):.7f} over {a.numel() * model.nsites:.3g} "
            f"sites, int8 model {float(b.mean()):.7f} over "
            f"{b.numel() * model.nsites:.3g} sites, z {z:+.2f}")
        worst = max(worst, abs(z))
        if abs(z) > SIGMAS:
            fail(f"even nx*ny first-sweep <{k}> is {z:+.2f} sigma from the "
                 "int8 model")
    return worst


def cleaned_1001_curve(raw: np.ndarray, racy: np.ndarray) -> np.ndarray:
    """ROADMAP C3: the 1001x1000x1000 rows (90 samples) with the 16 racy
    samples of the _s16 run taken out, (90·row - 16·row_s16)/74 on the mean
    and second-moment columns, the N·Var columns recomputed from them
    (unbiased, as the port's statistics are) and the covariance dropped."""
    n_raw, n_racy = raw[0, 1], racy[0, 1]
    n = n_raw - n_racy
    out = raw.copy()
    out[:, 1] = n
    out[:, 3:7] = (n_raw * raw[:, 3:7] - n_racy * racy[:, 3:7]) / n
    out[:, 7] = raw[:, 0] * (out[:, 5] - out[:, 3] ** 2) * n / (n - 1)
    out[:, 8] = raw[:, 0] * (out[:, 6] - out[:, 4] ** 2) * n / (n - 1)
    out[:, 9] = np.nan
    return out


def clock_specs():
    """The runner's q -> PlaneSpec table."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine.sweep import (
        CLOCK_SPECS,
    )
    return CLOCK_SPECS


def clock_phase_ops_per_word(msb, cp, spec, beta: float,
                             measuring: bool) -> int:
    """Minimum instructions of one clock word-phase: the Philox calls of
    the proposal and chain words, the chains' folds, the thermometer, the
    stencil and the decision (and the fused sums)."""
    qs, ks = cp.chain_words(spec.accept_digits(beta))
    draws = {6: 12, 4: 12, 3: 1}[spec.q] + sum(
        msb.chain_draws(q, k) for q, k in zip(qs, ks))
    return (math.ceil(draws / 4) * OPS_PER_PHILOX + math.ceil(draws / 2)
            + OPS_CLOCK_THERMO[spec.q] + OPS_CLOCK_STENCIL[spec.q]
            + OPS_CLOCK_DECIDE[spec.q]
            + (OPS_CLOCK_MEASURE[spec.q] if measuring else 0))


def clock_words(dev, nrep, nyw, half, n, seed, ny, cp):
    """n random int32 planes (nrep, nyw, half) with the pad bits of the
    top word clear (the port's clock layout)."""
    mask = cp.real_mask(nyw, half, ny % 32, dev)
    return [cp._i32(cp._u32(w) & mask)
            for w in random_words((nrep, nyw, half), seed, dev, n)]


def valid_rand(spec, rand):
    """Injected q = 6 planes as the engine draws them: a valid (rt1, rt2)
    Z3 encoding and no null proposal."""
    rand = list(rand)
    if spec.q == 6:
        rand[2] = rand[2] & ~rand[1]
        rand[0] = rand[0] | ~(rand[1] | rand[2])
    return rand


# (R, ny, nx, kbts of the Philox checks): the aligned and the padded
# main-path geometries at their classes' kbt (and 0.91), and a ragged shape
# (7 word rows, 8 real rows in the top one; 70 words a row, partial tiles
# both ways) at temperatures whose chains take 12 digits, all ones (1e9),
# and up to 28, some empty (0.05)
CLOCK_CHECK_SHAPES = ((16, 2048, 2048, (KBT_CLOCK, KBT_CLOCK_08)),
                      (4, 2000, 2000, (KBT_CLOCK,)),
                      (3, 200, 140, (KBT_CLOCK, 1e9, 0.05)))


def check_clock(cp, rng, dev) -> int:
    """Clock phase kernel vs its plain version, bitwise, for q = 6, 4, 3
    at CLOCK_CHECK_SHAPES, both colours, injected and Philox planes (the
    unrolled draw at each of the shape's kbts), measuring and not.
    Returns the largest absolute difference seen."""
    err = 0
    for q, spec in clock_specs().items():
        for nrep, ny, nx, kbts in CLOCK_CHECK_SHAPES:
            half, nyw = nx // 2, -(-ny // 32)
            planes = clock_words(dev, nrep, nyw, half,
                                 2 * spec.n_state + spec.n_rand, q + ny, ny,
                                 cp)
            x = tuple(planes[:spec.n_state])
            o = tuple(planes[spec.n_state:2 * spec.n_state])
            rand = valid_rand(spec, planes[2 * spec.n_state:])
            seeds = cp.multispin_rng.sweep_phase_keys(
                rng.sample_key(rng.base_key(12), q), 1)[0]
            for color in (0, 1):
                errs = []
                for measuring in (False, True):
                    got = cp.phase_packed_inject(spec, x, o, rand,
                                                 color=color, ny=ny,
                                                 measuring=measuring)
                    want = cp.phase_reference(spec, x, o, color, rand, ny,
                                              measuring)
                    if measuring:
                        errs.append(max_abs_err(
                            list(zip(got[0], want[0])) + [(got[1],
                                                           want[1])]))
                    else:
                        errs.append(max_abs_err(zip(got, want)))
                    for kbt in kbts:
                        kw = dict(color=color, beta=1.0 / kbt, ny=ny,
                                  measuring=measuring)
                        got = cp.phase_packed(spec, x, o, seeds[color], **kw)
                        want = cp.phase_plain(spec, x, o, seeds[color], **kw)
                        if measuring:
                            errs.append(max_abs_err(
                                list(zip(got[0], want[0])) + [(got[1],
                                                               want[1])]))
                        else:
                            errs.append(max_abs_err(zip(got, want)))
                err = max(err, *errs)
                log(f"  clock q={q} phase kernel {nrep}x{ny}x{nx} colour "
                    f"{color}, kbt {kbts}: injected, philox at each kbt, "
                    f"then measuring: {errs}")
            del planes, x, o, rand
    torch.cuda.synchronize()
    if err != 0:
        fail(f"clock phase kernel differs from its plain version (max abs "
             f"err {err})")
    return err


def check_clock_helical(chm, hms, rng, dev) -> int:
    """Helical clock multisweep kernel vs its plain version, bitwise on
    the valid bits: the injected mode, S sweeps against S one-sweep
    launches and the plain version, and the fused sums against the final
    state's, staged in shared memory (501x500) and in device memory
    (1001x1000); at 501x500 also 4 sweeps at kbt 0.91 and 1e9 (other
    launch tables of the draw).  Returns the largest absolute difference
    seen."""
    err = 0
    beta = 1.0 / KBT_CLOCK_08

    def valid(w, m):
        return hms._u32(w) & hms.valid_mask(m, dev)

    for nrep, nx, ny, sweeps in ((4, 501, 500, 16), (2, 1001, 1000, 4)):
        m = nx * ny // 2
        staged = chm.staged_fits(hms.words(m), dev)
        if staged != (nx == 501):
            fail(f"helical clock {nx}x{ny}: staged {staged}, so a variant "
                 "goes unchecked")
        vecs = random_words((nrep, hms.words(m)), nx, dev, n=14)
        a3, b3 = tuple(vecs[:3]), tuple(vecs[3:6])
        p8 = valid_rand(clock_specs()[6], vecs[6:])
        for color, offs in enumerate(hms.helical_offsets(nx)):
            e = max_abs_err(
                (valid(g, m), valid(w, m)) for g, w in zip(
                    chm.phase_packed_with_bits(a3, b3, p8, offs=offs, m=m),
                    chm.packed_helical_phase6_reference(a3, b3, offs, p8,
                                                        m)))
            err = max(err, e)
            log(f"  helical clock injected mode {nrep}x{nx}x{ny} colour "
                f"{color}: {e}")
        seeds = hms.sweep_seed_pairs(rng.sample_key(rng.base_key(13), nx),
                                     sweeps)
        kw = dict(beta=beta, nx=nx, m=m)
        ka, kb, kobs = chm.multisweep_planes(a3, b3, seeds, **kw)
        pa, pb, pobs = chm.multisweep_plain(a3, b3, seeds, **kw)
        e_plain = max_abs_err(
            [(valid(g, m), valid(w, m)) for g, w in zip(ka + kb, pa + pb)]
            + [(kobs, pobs)])
        e_state = max_abs_err([(kobs[:, -1],
                                chm.obs_packed6_reference(ka, kb, nx, m))])
        e_single = 0
        if nx == 501:
            sa, sb, sobs = a3, b3, []
            for s in range(sweeps):
                sa, sb, o = chm.multisweep_planes(sa, sb, seeds[s:s + 1],
                                                  **kw)
                sobs.append(o)
            e_single = max_abs_err(
                [(valid(g, m), valid(w, m)) for g, w in zip(ka + kb,
                                                             sa + sb)]
                + [(kobs, torch.cat(sobs, dim=1))])
        err = max(err, e_plain, e_state, e_single)
        log(f"  helical clock multisweep {nrep}x{nx}x{ny} S={sweeps} "
            f"(staged {staged}): vs plain {e_plain}, vs {sweeps} one-sweep "
            f"launches {e_single}, (2m, 2e, my2) vs the state's {e_state}")
        # the launch's draw table at other temperatures (the chains' digits
        # and ends move with beta)
        for kbt in (0.91, 1e9) if nx == 501 else ():
            kw = dict(beta=1.0 / kbt, nx=nx, m=m)
            got = chm.multisweep_planes(a3, b3, seeds[:4], **kw)
            want = chm.multisweep_plain(a3, b3, seeds[:4], **kw)
            e = max_abs_err(
                [(valid(g, m), valid(w, m))
                 for g, w in zip(got[0] + got[1], want[0] + want[1])]
                + [(got[2], want[2])])
            err = max(err, e)
            log(f"  helical clock multisweep {nrep}x{nx}x{ny} S=4 kbt {kbt}: "
                f"vs plain {e}")
    torch.cuda.synchronize()
    if err != 0:
        fail(f"helical clock multisweep kernel differs from its plain "
             f"version (max abs err {err})")
    return err


def clock_first_sweep_exact(cp, spec, beta: float) -> tuple[float, float]:
    """E[m], E[e] per site after one sweep from all-up (every state 0) for
    the engine's rounded proposal categories and chain probabilities, on
    any lattice whose sites have four distinct neighbours of the other
    colour.  Phase a: every site sees four 0 neighbours.  Phase b: each
    b-site sees four independent a-sites; a bond (a0, b0) conditions on
    a0 and enumerates b0's other three neighbours."""
    q = spec.q
    nch = len(spec.accept_digits(beta))
    qs, ks = cp.chain_words(spec.accept_digits(beta))
    p = [qq / 2 ** k for qq, k in zip(qs, ks)][:nch]
    if q == 6:
        prop = {r: c / 4096 for r, c in zip(range(1, 6),
                                            (819, 819, 820, 819, 819))}
    elif q == 4:
        prop = {1: 1365 / 4096, 2: 1366 / 4096, 3: 1365 / 4096}
    else:
        prop = {1: 0.5, 2: 0.5}
    cos = [math.cos(2 * math.pi * c / q) for c in range(q)]
    # the integer the chains gate on: 2dE (q=6), dE (q=4), 2dE/3 (q=3)
    unit = {6: 0.5, 4: 1.0, 3: 1.5}[q]

    def accept(c, nbrs, r) -> float:
        new = (c + r) % q
        de = sum(cos[(c - n) % q] - cos[(new - n) % q] for n in nbrs)
        mm = round(de / unit)
        if mm <= 0:
            return 1.0
        gates = ([mm & 1, mm >> 1 & 1, mm >> 2 & 1, (mm >> 3 | mm >> 4) & 1,
                  mm >> 4 & 1] if q == 6 else
                 [mm >> i & 1 for i in range(nch)])
        out = 1.0
        for g, pk in zip(gates, p):
            if g:
                out *= pk
        return out

    def after(c, nbrs) -> list[float]:
        """Distribution of a site's state after its phase."""
        dist = [0.0] * q
        for r, pr in prop.items():
            a = accept(c, nbrs, r)
            dist[(c + r) % q] += pr * a
            dist[c] += pr * (1 - a)
        return dist

    pa = after(0, (0, 0, 0, 0))
    m_a = sum(pa[c] * cos[c] for c in range(q))
    m_b = 0.0
    bond = 0.0
    for s0 in range(q):
        for rest in np.ndindex(q, q, q):
            w = pa[s0] * pa[rest[0]] * pa[rest[1]] * pa[rest[2]]
            if w == 0.0:
                continue
            pb = after(0, (s0,) + rest)
            m_b += w * sum(pb[c] * cos[c] for c in range(q))
            bond += w * sum(pb[c] * cos[(c - s0) % q] for c in range(q))
    return 0.5 * (m_a + m_b), -2.0 * bond


def z_sampled(name: str, values, exact: float, nsites: float) -> float:
    """The mean of per-replica values against a closed form within SIGMAS
    standard errors of their sampled variance; returns |z|."""
    v = torch.cat(values).double()
    mean = float(v.mean())
    z = (mean - exact) / math.sqrt(float(v.var()) / v.numel())
    log(f"  {name} {mean:.9f} closed form {exact:.9f} over "
        f"{v.numel() * nsites:.3g} sites, z {z:+.2f}")
    if abs(z) > SIGMAS:
        fail(f"{name} is {z:+.2f} sigma from the closed form")
    return abs(z)


def check_z_sampled(name: str, per_rep: dict, nsites: int,
                    want: tuple[float, float]) -> float:
    """<m>, <e> over the per-replica densities against their exact values
    (:func:`z_sampled`).  Returns the largest |z|."""
    return max(z_sampled(f"{name} first sweep <{k}>", per_rep[k], exact,
                         nsites) for k, exact in zip(("m", "e"), want))


def check_first_sweep_clock(cp, rng, dev, q: int, kbt: float,
                            iters: int) -> float:
    """Periodic clock <m>(1), <e>(1) of the phase kernel over iters x 40 x
    2000^2 sites (the padded main path's launch) against the closed
    form."""
    spec = clock_specs()[q]
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
    model = Clock2D(nx=2000, ny=2000, kbt=kbt, q=q)
    zero = tuple(torch.zeros((40, 63, 1000), dtype=torch.int32, device=dev)
                 for _ in range(spec.n_state))
    per_rep = {"m": [], "e": []}
    base = rng.base_key(2040 + q)
    for it in range(iters):
        seeds = cp.multispin_rng.sweep_phase_keys(rng.sample_key(base, it),
                                                  1)[0]
        _, _, obs = cp.sweep_measure_seeded(spec, model, zero, zero, seeds)
        for k in per_rep:
            per_rep[k].append(obs[k])
    return check_z_sampled(f"clock q={q} kbt {kbt} 2000^2", per_rep,
                           model.nsites,
                           clock_first_sweep_exact(cp, spec, model.beta))


def check_first_sweep_clock_helical(cp, chm, hms, rng, dev,
                                    iters: int) -> float:
    """Helical clock <m>(1), <e>(1) of the multisweep kernel over iters x
    500 x 501x500 sites at kbt 0.8: the periodic closed form (four
    distinct neighbours of the other colour)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Clock2DHelical,
    )
    model = Clock2DHelical(501, 500, KBT_CLOCK_08)
    m = model.nsites // 2
    zero = tuple(torch.zeros((500, hms.words(m)), dtype=torch.int32,
                             device=dev) for _ in range(3))
    per_rep = {"m": [], "e": []}
    base = rng.base_key(2050)
    for it in range(iters):
        _, _, obs = chm.multisweep(model, zero, zero,
                                   rng.sample_key(base, it), 1)
        for k in per_rep:
            per_rep[k].append(obs[k][:, 0])
    return check_z_sampled("helical clock 501x500 kbt 0.8", per_rep,
                           model.nsites,
                           clock_first_sweep_exact(cp, clock_specs()[6],
                                                   model.beta))


def run_clock(main_fn, modules, out_dir, nx, ny, kbt, replicas, samples,
              mcs, ref, engine):
    """One clock class through the CLI, from all-up, against the reference
    curve at every t <= mcs with the combined sigma.  Returns (launches,
    wall, rate, largest |z|)."""
    argv = ["--model", "clock", "--nx", str(nx), "--ny", str(ny), "--q",
            "6", "--kbt", repr(kbt), "--mcs", str(mcs), "--samples",
            str(samples), "--replicas", str(replicas)]
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, f"clock_{nx}x{ny}", argv, nx * ny,
        samples, mcs)
    for line in (f"# nx, ny: {nx} {ny}", f"# engine: {engine}"):
        if line not in head:
            fail(f"clock .dat header lacks {line!r}: {head}")
    worst = check_against_reference(
        table, ref, nx * ny, samples, mcs, range(1, mcs + 1),
        ref_nsites=int(ref[0, 0]), ref_samples=int(ref[0, 1]))
    return launches, wall, rate, worst


def xy_state(dev, nrep: int, ny: int, nx: int, seed: int) -> list:
    """A random XY state (ax, ay, bx, by): float32 unit vectors at angles
    2πu, u from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    th = torch.rand((2, nrep, ny, nx // 2), generator=gen, device=dev,
                    dtype=torch.float64) * (2 * math.pi)
    return [f(th[c]).float().contiguous() for c in (0, 1)
            for f in (torch.cos, torch.sin)]


def xy_by_color(planes, color: int) -> list:
    """(sx, sy, ox, oy) of the colour updated."""
    return list(planes) if color == 0 else [planes[2], planes[3], planes[0],
                                            planes[1]]


def float_err(pairs) -> float:
    """Largest absolute difference of float tensors (0 when equal)."""
    err = 0.0
    for got, want in pairs:
        if got.shape != want.shape:
            fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = max(err, float((got.double() - want.double()).abs().max()))
    return err


def sums_rel_err(got, want) -> float:
    """Largest |got - want| / max(|want|, 1) of float64 sums."""
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def xy_pair(xyp, kind: str, planes, color, measuring, rand=None,
            beta=1.0 / KBT_XY):
    """One phase of ``kind`` (metropolis or over_relax) through the kernel
    and through its plain version, each on its own copy of ``planes``.
    Returns (state error, sums' relative error or 0)."""
    a = [p.clone() for p in xy_by_color(planes, color)]
    b = [p.clone() for p in xy_by_color(planes, color)]
    if kind == "metropolis":
        kw = dict(color=color, beta=beta, measuring=measuring)
        got = xyp.metropolis_phase(*a, rand, **kw)
        want = xyp.metropolis_phase_plain(*b, rand, **kw)
    else:
        got = xyp.over_relax_phase(*a, color=color, measuring=measuring)
        want = xyp.over_relax_phase_plain(*b, color=color,
                                          measuring=measuring)
    return (float_err(zip(a[:2], b[:2])),
            sums_rel_err(got[2], want[2]) if measuring else 0.0)


def check_xy(xyp, rng, dev) -> tuple[dict[str, float], float]:
    """Both XY kernels against their plain versions on the same CUDA
    tensors: random states, both colours, measuring and not, injected and
    Philox uniforms, at 256x200 x 2 (half = 100) and the main paths'
    4000x4000 x 8 and 2000x2000 x 32, each at its class's kbt.  The state
    must be equal bitwise, the sums within 1e-9 relative.  Returns
    ({kernel: state error}, sums' relative error)."""
    errs = {"metropolis": 0.0, "over_relax": 0.0}
    rel = 0.0
    for nrep, ny, nx, kbt in XY_CHECK_SHAPES:
        planes = xy_state(dev, nrep, ny, nx, ny + nrep)
        gen = torch.Generator(device=dev).manual_seed(nx)
        u = tuple(torch.rand((nrep, ny, nx // 2), generator=gen, device=dev)
                  for _ in range(2))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(30), ny),
                                       color)
            for measuring in (False, True):
                for kind, rand in (("metropolis", u), ("metropolis", seeds),
                                   ("over_relax", None)):
                    e, r = xy_pair(xyp, kind, planes, color, measuring, rand,
                                   beta=1.0 / kbt)
                    errs[kind] = max(errs[kind], e)
                    rel = max(rel, r)
        log(f"  xy kernels {nrep}x{ny}x{nx}: state vs plain "
            f"{errs['metropolis']:.3g} (metropolis), "
            f"{errs['over_relax']:.3g} (over-relaxation); sums' relative "
            f"error {rel:.3g}")
        del planes, u
    if max(errs.values()) != 0.0 or rel > 1e-9:
        fail(f"an XY kernel differs from its plain version: {errs}, sums' "
             f"relative error {rel:.3g}")
    return errs, rel


def check_xy_phase_a(xyp, rng, dev, iters: int) -> float:
    """Phase a from all-up, iters x 8 x 4000x4000 (the main path's launch):
    every site sees the field (4, 0) and accepts (cos 2πu, sin 2πu) with
    p = exp(-4β(1 - cos 2πu)), so <S_x> = 1 - e^(-4β)[I0(4β) - I1(4β)],
    <S_y> = 0 and the acceptance is e^(-4β) I0(4β).  <S_x>, <S_y> come
    from the measuring kernel's sums (colour b adds exactly N/2 to Σ S_x);
    a site counts as accepted where S moved off (1, 0).  Returns the
    largest |z|."""
    from scipy.special import ive
    x4 = 4.0 / KBT_XY
    nrep, ny, half = 8, 4000, 2000
    n_a = ny * half
    ax, bx = (torch.ones((nrep, ny, half), device=dev) for _ in range(2))
    ay, by = (torch.zeros((nrep, ny, half), device=dev) for _ in range(2))
    keys = rng.seeds_from_key(rng.sample_key(rng.base_key(2060),
                                             torch.arange(iters)), 0)
    per = {"sx": [], "sy": [], "acc": []}
    for it in range(iters):
        ax.fill_(1.0)
        ay.zero_()
        _, _, obs = xyp.metropolis_phase(ax, ay, bx, by, keys[it], color=0,
                                         beta=1.0 / KBT_XY, measuring=True)
        per["sx"].append((obs[:, 0] - n_a) / n_a)
        per["sy"].append(obs[:, 1] / n_a)
        per["acc"].append(((ax != 1.0) | (ay != 0.0)).sum(dim=(1, 2))
                          .double() / n_a)
    return max(
        z_sampled("xy phase a <S_x>", per["sx"],
                  1.0 - (ive(0, x4) - ive(1, x4)), n_a),
        z_sampled("xy phase a <S_y>", per["sy"], 0.0, n_a),
        z_sampled("xy phase a acceptance", per["acc"], ive(0, x4), n_a))


def check_xy_over_relax(xyp, dev) -> tuple[float, float]:
    """One over-relaxation sweep of a random 4000x4000 x 8 state: the
    energy (float64 of the float32 state) kept within float32 rounding,
    at most N · 2 ulp of the largest |S·h| = 4 (N · 8 · 2^-24), the fused e
    (float32 site terms) within the same of it, and |S| within 1e-6 of 1.
    Returns (largest |dE| / N, largest ||S| - 1|)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    model = XY2D(nx=4000, ny=4000, kbt=KBT_XY)
    st = XYState(*xy_state(dev, 8, 4000, 4000, 77))
    e0 = model.energy_sum(st)
    st, obs = xyp.or_sweep_measured(model, st)
    e1 = model.energy_sum(st)
    de = float((e1 - e0).abs().max())
    fused = float((obs["e"] * model.nsites - e1).abs().max())
    norm = max(float((torch.hypot(x.double(), y.double()) - 1.0).abs().max())
               for x, y in ((st.ax, st.ay), (st.bx, st.by)))
    log(f"  xy over-relaxation sweep 4000x4000 x 8: |dE| <= {de:.4g} "
        f"({de / model.nsites:.3g} a site), fused e vs the state's "
        f"{fused / model.nsites:.3g} a site, ||S| - 1| <= {norm:.3g}")
    bound = model.nsites * 8 * 2.0 ** -24
    if de > bound or fused > bound or norm > 1e-6:
        fail("the over-relaxation sweep does not conserve the energy or "
             "|S| to float32 rounding")
    return de / model.nsites, norm


def run_xy(main_fn, modules, out_dir, nx, kbt, replicas, samples, mcs,
           n_over_relax, ref, engine):
    """One XY class through the CLI, from all-up, against the reference
    curve at every t <= mcs with the combined sigma.  Returns (launches,
    wall, rate, largest |z|)."""
    argv = ["--model", "xy2d", "--nx", str(nx), "--ny", str(nx), "--kbt",
            repr(kbt), "--mcs", str(mcs), "--samples", str(samples),
            "--replicas", str(replicas)]
    lines = [f"# nx, ny: {nx} {nx}", f"# engine: {engine}"]
    if n_over_relax:
        argv += ["--n-over-relax", str(n_over_relax)]
        lines += [f"# n_over_relax: {n_over_relax}",
                  f"# mcs_over_relax: {mcs}"]
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, f"xy2d_{nx}", argv, nx * nx, samples,
        mcs)
    for line in lines:
        if line not in head:
            fail(f"xy .dat header lacks {line!r}: {head}")
    worst = check_against_reference(
        table, ref, nx * nx, samples, mcs, range(1, mcs + 1),
        ref_nsites=int(ref[0, 0]), ref_samples=int(ref[0, 1]))
    return launches, wall, rate, worst


def time_xy(label: str, kernel, plain, planes, nbytes: float, ops: float,
            reps: int, plain_reps: int) -> tuple[dict, float]:
    """CUDA-event time of one XY phase wrapper and of its plain version
    (each on its own copy of ``planes``, updated in place launch after
    launch), beside the bound; then one call of each on fresh copies of
    ``planes``, whose states must agree.  Returns (times, state error)."""
    k = [p.clone() for p in planes]
    q = [p.clone() for p in planes]
    ms = cuda_time_ms(lambda: kernel(*k), reps=reps)
    plain_ms = cuda_time_ms(lambda: plain(*q), reps=plain_reps, warmup=1)
    del k, q
    a = [p.clone() for p in planes]
    b = [p.clone() for p in planes]
    kernel(*a)
    plain(*b)
    err = float_err(zip(a[:2], b[:2]))
    bound, by = bound_ms(nbytes, ops)
    sites = planes[0].numel()
    log(f"  {label}: {ms:.4f} ms/launch ({sites / ms * 1e3:.4g} site "
        f"updates/s), plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); "
        f"vs plain {err}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def xy_disorder_state(dev, nrep: int, ny: int, nx: int, seed: int):
    """(state, snapshot) XYStates of random float32 unit vectors."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    return (XYState(*xy_state(dev, nrep, ny, nx, seed)),
            XYState(*xy_state(dev, nrep, ny, nx, seed + 1)))


def check_xy_disorder(xyp, xym, xyr, rng, dev) -> tuple[dict, float]:
    """The disorder slice's kernels against their plain versions on the
    same CUDA tensors, at XY_DISORDER_SHAPES: metropolis_kernel's snapshot
    mode (injected and Philox uniforms, both colours), measure_kernel with
    and without a snapshot, phase_with_bits (metropolis_kernel's injected
    mode, both colours); then, at 1500x1500 x 1, 64 multisweep sweeps in
    each mode (smem_multisweep_kernel, the fit rule's;
    gmem_multisweep_kernel, forced) against 64 streamed snapshot-measuring
    sweeps (state and sums bitwise) and against its plain version.  State
    bitwise, sums within 1e-9 relative.  Returns ({kernel: state error},
    sums' relative error): "phase_bits" for phase_with_bits, "smem" and
    "gmem" for the multisweep's two modes."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng

    errs = {"snapshot": 0.0, "measure": 0.0, "phase_bits": 0.0, "smem": 0.0,
            "gmem": 0.0}
    rel = 0.0
    for nrep, ny, nx in XY_DISORDER_SHAPES:
        st, snap = xy_disorder_state(dev, nrep, ny, nx, 5 * ny + nrep)
        gen = torch.Generator(device=dev).manual_seed(nx + 1)
        u = tuple(torch.rand((nrep, ny, nx // 2), generator=gen, device=dev)
                  for _ in range(2))
        for color in (0, 1):
            sn = xy_by_color(list(snap), color)
            seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(31), ny),
                                       color)
            for rand in (u, seeds):
                a = [p.clone() for p in xy_by_color(list(st), color)]
                b = [p.clone() for p in xy_by_color(list(st), color)]
                kw = dict(color=color, beta=1.0 / KBT_XY, snap=sn)
                got = xyp.metropolis_phase(*a, rand, **kw)
                want = xyp.metropolis_phase_plain(*b, rand, **kw)
                errs["snapshot"] = max(errs["snapshot"],
                                       float_err(zip(a[:2], b[:2])))
                rel = max(rel, sums_rel_err(got[2], want[2]))
            a = [p.clone() for p in xy_by_color(list(st), color)]
            b = [p.clone() for p in xy_by_color(list(st), color)]
            xyr.phase_with_bits(*a, *u, color=color, beta=1.0 / KBT_XY)
            xyr.phase_with_bits_plain(*b, *u, color=color, beta=1.0 / KBT_XY)
            errs["phase_bits"] = max(errs["phase_bits"],
                                     float_err(zip(a[:2], b[:2])))
        for sn in (None, snap):
            got = xym.measure_sums(st, sn)
            rel = max(rel, sums_rel_err(got, xym.measure_sums_plain(st, sn)))
            if sn is None:  # no snapshot: A is exactly 0
                errs["measure"] = max(errs["measure"],
                                      float(got[:, 3].abs().max()))
        log(f"  xy disorder kernels {nrep}x{ny}x{nx}: state vs plain "
            f"{errs['snapshot']:.3g} (snapshot mode), {errs['phase_bits']:.3g}"
            f" (phase_with_bits, metropolis_kernel's injected mode); sums' "
            f"relative error {rel:.3g}")
        del st, snap, u
    nrep, ny, nx = XY_DISORDER_SHAPES[1]
    model = XY2D(nx=nx, ny=ny, kbt=KBT_XY)
    st, snap = xy_disorder_state(dev, nrep, ny, nx, 41)
    seeds = multispin_rng.sweep_phase_keys(rng.sample_key(rng.base_key(32),
                                                          0), 64)
    streamed = XYState(*(p.clone() for p in st))
    sobs = []
    for s in range(64):
        streamed, obs = xyp.sweep_measure(model, streamed, snap, seeds[s])
        sobs.append(torch.stack([obs[k] for k in ("mx", "my", "e", "A")], 1))
    sobs = torch.stack(sobs, dim=1)
    plain = XYState(*(p.clone() for p in st))
    pobs = xyr.multisweep_planes_plain(plain, snap, seeds, beta=model.beta)
    s_str = 0.0
    for grid in (False, True):
        ms = XYState(*(p.clone() for p in st))
        kobs = xyr.multisweep_planes(ms, snap, seeds, beta=model.beta,
                                     grid=grid)
        e_str = float_err(zip(ms, streamed))
        e_plain = float_err(zip(ms, plain))
        s_mode = float((xyp.per_site(kobs, model.nsites) - sobs).abs().max())
        s_str = max(s_str, s_mode)
        rel = max(rel, sums_rel_err(kobs, pobs))
        mode = "gmem" if grid or xyr.device_layout(ms) is None else "smem"
        errs[mode] = max(errs[mode], e_str, e_plain)
        name = f"{mode}_multisweep_kernel" + (" (forced)" if grid else "")
        log(f"  xy {name} 64 sweeps {ny}x{nx} x {nrep}: state vs 64 "
            f"streamed sweep_measure {e_str:.3g}, sums vs streamed "
            f"{s_mode:.3g}; state vs plain {e_plain:.3g}, sums' relative "
            f"error {rel:.3g}")
    if max(errs.values()) != 0.0 or s_str != 0.0 or rel > 1e-9:
        fail(f"an XY disorder kernel differs from its plain version: {errs}, "
             f"sums vs streamed {s_str}, sums' relative error {rel:.3g}")
    return errs, rel


def check_xy_preparations(dev) -> tuple[float, float]:
    """On the card: rotate_magne_toward_xaxis of a random 1500x1500 x 4
    state leaves |Σ S_y| / N below 1e-6 and |m| within 1e-9; and
    prep_finite_magne at 1000x1000 x 20 gives |m| within 1% of 0.02 in
    every replica, along +x.  Returns (largest |m_y| after the rotation,
    largest relative |m| error of the preparation)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XYState

    model = XY2D(nx=1500, ny=1500, kbt=KBT_XY)
    st = XYState(*xy_state(dev, 4, 1500, 1500, 51))
    mx0, my0 = model.magne_sums(st)
    rot = model.rotate_magne_toward_xaxis(st)
    mx1, my1 = model.magne_sums(rot)
    n = model.nsites
    my_after = float(my1.abs().max()) / n
    dm = float((torch.hypot(mx1, my1) - torch.hypot(mx0, my0)).abs().max()) / n
    log(f"  rotate_magne_toward_xaxis 1500x1500 x 4: |m_y| <= {my_after:.3g}, "
        f"|m| moved {dm:.3g} (|m| ~ {float(torch.hypot(mx0, my0)[0]) / n:.3g})")
    if my_after > 1e-6 or dm > 1e-9 or float(mx1.min()) < 0.0:
        fail("the rotation does not put m on +x or does not keep |m|")
    model = XY2D(nx=1000, ny=1000, kbt=KBT_XY)
    keys = rng.fold_in(rng.init_key(rng.sample_key(rng.base_key(52), 0)),
                       torch.arange(20))
    t0 = time.perf_counter()
    prep = model.prep_finite_magne(keys, 0.02, device=dev)
    torch.cuda.synchronize()
    mx, my = (v / model.nsites for v in model.magne_sums(prep))
    mabs = torch.hypot(mx, my)
    err = float(((mabs - 0.02).abs() / 0.02).max())
    log(f"  prep_finite_magne 1000x1000 x 20, m0 0.02: |m| in "
        f"[{float(mabs.min()):.6f}, {float(mabs.max()):.6f}], largest "
        f"relative error {err:.4f}, largest |m_y| {float(my.abs().max()):.3g}"
        f" ({time.perf_counter() - t0:.2f} s)")
    if err > 0.01 or float(my.abs().max()) > 1e-6:
        fail("prep_finite_magne missed |m| = 0.02 within 1% along +x")
    return my_after, err


def check_disorder_curve(table: np.ndarray, ref: np.ndarray, samples: int,
                         mcs: int, moments, label: str) -> float:
    """The port's disorder table against a reference curve of the same
    geometry at every t <= mcs: for each (name, mean column, variance of
    a reference row) in ``moments``, |mean - mean_ref| within SIGMAS of
    the combined sigma^2 = var_ref (1/n + 1/n_ref), the variance from the
    reference's own second-moment or N·Var columns.  Returns the largest
    |z|."""
    ts = np.arange(1, mcs + 1)
    if (table.shape[0] != mcs or table.shape[1] != ref.shape[1]
            or not np.all(np.isfinite(table))):
        fail(f"{label}: table shape {table.shape} or non-finite")
    if not np.all(table[:, 1] == samples) or not np.all(table[:, 2] == ts):
        fail(f"{label}: Nsample or t column is wrong")
    n_ref = ref[0, 1]
    worst = 0.0
    for t in ts:
        row, rrow = row_at(table, t), row_at(ref, t)
        for name, col, var in moments:
            sigma = math.sqrt(var(rrow) * (1.0 / samples + 1.0 / n_ref))
            z = (row[col] - rrow[col]) / sigma
            if t in (1, 2, 10, 100, 1000):
                log(f"  {label} t={t:5d} <{name}> port {row[col]:.9g} "
                    f"reference {rrow[col]:.9g} sigma {sigma:.3e} z {z:+.2f}")
            worst = max(worst, abs(z))
            if abs(z) > SIGMAS:
                fail(f"{label}: <{name}>({t}) is {z:+.2f} sigma from the "
                     "reference")
    log(f"  {label}: largest |z| {worst:.2f} over {mcs} times")
    return worst


# (name, mean column, variance of a reference row) of the two tables
ABS_MOMENTS = (("|m|", 3, lambda r: r[5] - r[3] ** 2),
               ("e", 4, lambda r: r[6] - r[4] ** 2),
               ("A", 9, lambda r: r[10] - r[9] ** 2))
PARAM_MOMENTS = (("m", 3, lambda r: r[7] / r[0]),
                 ("e", 4, lambda r: r[8] / r[0]),
                 ("A", 10, lambda r: r[12] / r[0]))


def run_xy_disorder(main_fn, modules, out_dir, label, argv, nx, samples,
                    mcs, ref, moments, engine):
    """One XY disorder class through the CLI against its curve.  Returns
    (launches, wall, rate, largest |z|)."""
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, label, argv, nx * nx, samples, mcs)
    for line in (f"# nx, ny: {nx} {nx}", f"# engine: {engine}",
                 "# initial state: disorder"):
        if line not in head:
            fail(f"{label} .dat header lacks {line!r}: {head}")
    worst = check_disorder_curve(table, ref, samples, mcs, moments, label)
    return launches, wall, rate, worst


def check_samples_table(table: np.ndarray, head, ref: np.ndarray,
                        histories: int, mcs: int, nsites: int) -> float:
    """The finite-magne samples class: rows N, sample, t, m_x, e, m_y, A
    for every history and t under the reference's literal header; the
    per-t means of m_x, e and A over the histories against the reference
    file's (its 500 histories), within SIGMAS of sigma^2 = var_ref
    (1/n + 1/n_ref) from the reference's per-t sample variance.  Returns
    the largest |z|."""
    if "# N, smaple, time, m_x, e, m_y, A" not in head:
        fail(f"samples header lacks the reference's column line: {head}")
    want = np.stack([np.full(histories * mcs, nsites),
                     np.repeat(np.arange(1, histories + 1), mcs),
                     np.tile(np.arange(1, mcs + 1), histories)], axis=1)
    if table.shape != (histories * mcs, 7) or not np.array_equal(
            table[:, :3], want) or not np.all(np.isfinite(table)):
        fail(f"samples rows: shape {table.shape} or the N, sample, t "
             "columns are wrong")
    n_ref = int(ref[:, 1].max())
    port = table[:, 3:].reshape(histories, mcs, 4)
    other = ref[:, 3:].reshape(n_ref, mcs, 4)
    worst = 0.0
    for name, k in (("m_x", 0), ("e", 1), ("A", 3)):
        mean, mref = port[..., k].mean(0), other[..., k].mean(0)
        var = other[..., k].var(0, ddof=1)
        z = (mean - mref) / np.sqrt(var * (1.0 / histories + 1.0 / n_ref))
        for t in (1, 2, 10, 100):
            log(f"  samples t={t:4d} <{name}> port {mean[t - 1]:.9g} "
                f"reference {mref[t - 1]:.9g} z {z[t - 1]:+.2f}")
        worst = max(worst, float(np.abs(z).max()))
        if np.abs(z).max() > SIGMAS:
            fail(f"samples <{name}> is {np.abs(z).max():.2f} sigma from the "
                 "reference at some t")
    log(f"  finite-magne samples: largest |z| {worst:.2f} over {mcs} times")
    return worst


def time_sums(label: str, fn, plain, nbytes: float, ops: float, reps: int,
              plain_reps: int) -> tuple[dict, float]:
    """CUDA-event time of a sums-only kernel wrapper and of its plain
    version on the same inputs, beside the bound; returns (times, sums'
    relative and absolute error between the two)."""
    ms = cuda_time_ms(fn, reps=reps)
    plain_ms = cuda_time_ms(plain, reps=plain_reps, warmup=1)
    got, want = fn(), plain()
    rel = sums_rel_err(got, want)
    err = float((got - want).abs().max())
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch, plain {plain_ms:.2f} ms, bound "
        f"{bound:.4f} ms ({by}); sums vs plain {err:.3g} ({rel:.3g} "
        "relative)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, rel, err


def ptxas_registers(lib: str, kernel: str, args: str = "") -> int | None:
    """Registers of the first function of ``.build/lib<lib>.so`` named
    ``kernel`` (its mangled name, length first, followed by ``args``),
    from the build's ptxas report."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    log_path = _build.library_path(lib).with_suffix(".log")
    name = f"{len(kernel)}{kernel}{args}"
    entry = None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif entry and name in entry and "registers" in line:
            return int(line.split("Used", 1)[1].split()[0])
    return None


def time_multisweep(xyr, dev, n: int, seeds, beta: float, seed: int,
                    nrep: int = 1) -> tuple[dict, float, float]:
    """CUDA-event time of one multisweep launch of S = len(seeds) sweeps
    at n^2 x nrep, in the fit rule's mode (state and snapshot fresh,
    updated launch after launch), and of its plain version, beside the
    bound; then one launch of each from the same state.  Returns (times
    and the mode, "smem" or "gmem"; state error, sums' relative error)."""
    sweeps = int(seeds.shape[0])
    st, snap = xy_disorder_state(dev, nrep, n, n, seed)
    pairs = nrep * n * n // 2
    mode = "smem" if xyr.device_layout(st) else "gmem"
    name = f"{mode}_multisweep_kernel"

    def fresh():
        return type(st)(*(p.clone() for p in st))

    k_st, p_st = fresh(), fresh()
    ms = cuda_time_ms(
        lambda: xyr.multisweep_planes(k_st, snap, seeds, beta=beta), reps=5)
    plain_ms = cuda_time_ms(
        lambda: xyr.multisweep_planes_plain(p_st, snap, seeds, beta=beta),
        reps=1, warmup=0)
    k_st, p_st = fresh(), fresh()
    k_obs = xyr.multisweep_planes(k_st, snap, seeds, beta=beta)
    p_obs = xyr.multisweep_planes_plain(p_st, snap, seeds, beta=beta)
    err = float_err(zip(k_st, p_st))
    rel = sums_rel_err(k_obs, p_obs)
    bound, by = bound_ms(
        12 * 4 * pairs + nrep * sweeps * 4 * 8,
        sweeps * pairs * (2 * OPS_XY_METROPOLIS + OPS_XY_MEASURE
                          + OPS_XY_SNAP))
    log(f"  xy {name} {n}^2 x {nrep}, S={sweeps}: {ms:.4f} ms/launch "
        f"({ms / sweeps * 1e3:.2f} us a sweep), plain {plain_ms:.2f} ms, "
        f"bound {bound:.4f} ms ({by}); {ptxas_registers('xy2d_resident', name)}"
        f" registers; vs plain {err}, sums {rel:.3g} relative")
    return ({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "mode": mode}, err, rel)


def compare_xy_routes(xyp, xyr, dev, seeds) -> list[tuple]:
    """ms a sweep of the disorder runner's two routes, CUDA events, fused
    (mx, my, e, A) included: one multisweep launch of S sweeps (resident)
    against S streamed snapshot-measuring sweeps, host loop included
    (streamed), at XY_ROUTE_SHAPES.  Returns [(nx, replicas, resident ms,
    streamed ms)]."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D

    sweeps = seeds.shape[0]
    out = []
    for nx, nrep in XY_ROUTE_SHAPES:
        model = XY2D(nx=nx, ny=nx, kbt=KBT_XY)
        st, snap = xy_disorder_state(dev, nrep, nx, nx, nx + nrep)

        def resident():
            xyr.multisweep_planes(st, snap, seeds, beta=model.beta)

        def streamed():
            s = st
            for j in range(sweeps):
                s, _ = xyp.sweep_measure(model, s, snap, seeds[j])

        res_ms, str_ms = _route_times(resident, streamed, sweeps)
        log(f"  xy disorder route {nx}^2 x {nrep} ({nrep * nx * nx / 1e6:.2f}"
            f" M sites, fits {xyr.fits(model, nrep)}): resident "
            f"{res_ms:.5f} ms/sweep, streamed {str_ms:.5f} ms/sweep, "
            f"streamed/resident {str_ms / res_ms:.3f}")
        out.append((nx, nrep, res_ms, str_ms))
        del st, snap
    return out


ROUTE_SHAPES = ((2048, 16), (4096, 4), (8192, 1), (8192, 4))
ROUTE_SHAPES_3D = ((256, 4), (256, 8), (512, 1), (512, 2), (512, 8))


def _route_times(resident, streaming, sweeps: int) -> tuple[float, float]:
    return (cuda_time_ms(resident, reps=3, warmup=1) / sweeps,
            cuda_time_ms(streaming, reps=3, warmup=1) / sweeps)


def compare_routes(msb, dev, beta: float, seeds) -> None:
    """2-D ms per sweep of the runner's two chunk routes, CUDA events, at
    the main path's shapes and between them: one multisweep launch of S
    sweeps (resident) against S streamed phase pairs, host loop included
    (streaming).  Both give the same trajectory; this says which is
    faster where."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D

    sweeps = seeds.shape[0]
    for nx, nrep in ROUTE_SHAPES:
        model = Ising2D(nx=nx, ny=nx, kbt=KBT)
        wa, wb = random_words((nrep, nx // 32, nx // 2), nx + nrep, dev)[:2]

        def resident():
            msb.multisweep_planes(wa, wb, seeds, beta=beta)

        def streaming():
            a, b = wa, wb
            for j in range(sweeps):
                a, b, _ = msb.sweep_measure_seeded(model, a, b, seeds[j])

        res_ms, str_ms = _route_times(resident, streaming, sweeps)
        ens_mib = 2 * wa.numel() * 4 / 2 ** 20
        log(f"  route {nx}^2 x {nrep} ({ens_mib:.0f} MiB of planes, "
            f"multisweep_fits {msb.multisweep_fits(nrep, nx, nx // 2)}): "
            f"resident {res_ms:.5f} ms/sweep, streaming {str_ms:.5f} "
            f"ms/sweep, streaming/resident {str_ms / res_ms:.3f}")


def compare_routes_3d(ms3, dev, seeds) -> None:
    """The same for the 3-D runner's routes, at its two classes' shapes
    and between them."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising3D

    beta = 1.0 / KBT_3D
    sweeps = seeds.shape[0]
    for n, nrep in ROUTE_SHAPES_3D:
        model = Ising3D(nx=n, ny=n, nz=n, kbt=KBT_3D)
        wa, wb = random_words((nrep, n, n // 32, n // 2), n + nrep, dev, 2)

        def resident():
            ms3.multisweep3d_planes(wa, wb, seeds, beta=beta)

        def streaming():
            a, b = wa, wb
            for j in range(sweeps):
                a, b, _ = ms3.sweep_measure_seeded3d(model, a, b, seeds[j])

        res_ms, str_ms = _route_times(resident, streaming, sweeps)
        log(f"  3-D route {n}^3 x {nrep} ({wa.numel() / 2 ** 20:.0f} Mi "
            f"words a colour, multisweep3d_fits "
            f"{ms3.multisweep3d_fits(nrep, n, n, n // 2)}): resident "
            f"{res_ms:.5f} ms/sweep, streaming {str_ms:.5f} ms/sweep, "
            f"streaming/resident {str_ms / res_ms:.3f}")


def compare_routes_helical3d(h3, hms, dev, seeds) -> float:
    """ms per sweep of the helical 3-D runner's two routes at the resident
    class's shape, 151x151x150 x 128: one multisweep launch of S sweeps
    against S streamed phase pairs.  Returns streamed / resident."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising3DHelical,
    )

    model = Ising3DHelical(151, 151, 150, KBT_H3)
    m = model.nsites // 2
    sweeps = seeds.shape[0]
    wa, wb = random_words((128, hms.words(m)), 17, dev, n=2)

    def resident():
        h3.multisweep_planes(wa, wb, seeds, beta=model.beta, nx=151,
                             nxy=model.nxy, m=m)

    def streaming():
        a, b = wa, wb
        for j in range(sweeps):
            a, b, _ = h3.sweep_measure_seeded(model, a, b, seeds[j])

    res_ms, str_ms = _route_times(resident, streaming, sweeps)
    log(f"  helical 3-D route 151x151x150 x 128 ({hms.words(m)} words a "
        f"colour, fits {h3.fits(model)}): resident {res_ms:.5f} ms/sweep, "
        f"streamed {str_ms:.5f} ms/sweep, streamed/resident "
        f"{str_ms / res_ms:.3f}")
    return str_ms / res_ms


def helical_state(dev, nrep: int, ny: int, nx: int, seed: int):
    """One random helical XY state as the dense engines keep it: the angle
    planes (a, b) in turns and the component planes (ax, ay, bx, by) of
    their decode, drawn on the card from a seeded generator."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense as xhd,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    turns = torch.rand((nrep, nx * ny), generator=gen, device=dev) - 0.5
    ang = list(xhd.dense_pack(turns, ny, nx))
    del turns
    comp = [c.contiguous() for p in ang for c in trig.cos_sin_2pi(p)]
    return ang, comp


def helical_pairs(xhd, xha, comp, ang, u, seeds, color, beta):
    """Every kernel of both helical engines against its plain version on
    its own copies of the state, colour ``color``, measuring and not,
    Metropolis with injected uniforms ``u`` and with the Philox key
    ``seeds``.  Yields (kernel name, state error, sums' relative error)."""
    corder = (0, 1, 2, 3) if color == 0 else (2, 3, 0, 1)
    aorder = (0, 1) if color == 0 else (1, 0)
    runs = (("phase", xhd.phase, xhd.phase_plain, comp, corder, (u,), True),
            ("phase", xhd.phase, xhd.phase_plain, comp, corder, (seeds,),
             True),
            ("or", xhd.or_phase, xhd.or_phase_plain, comp, corder, (), False),
            ("angle_phase", xha.angle_phase, xha.angle_phase_plain, ang,
             aorder, (u,), True),
            ("angle_phase", xha.angle_phase, xha.angle_phase_plain, ang,
             aorder, (seeds,), True),
            ("angle_or", xha.angle_or_phase, xha.angle_or_phase_plain, ang,
             aorder, (), False))
    for name, kernel, plain, planes, order, extra, metro in runs:
        kw = dict(color=color, beta=beta) if metro else dict(color=color)
        for measuring in (False, True):
            a = [planes[i].clone() for i in order]
            b = [planes[i].clone() for i in order]
            got = kernel(*a, *extra, measuring=measuring, **kw)
            want = plain(*b, *extra, measuring=measuring, **kw)
            err = float_err(zip(a, b))
            rel = sums_rel_err(got[-1], want[-1]) if measuring else 0.0
            del a, b
            yield name, err, rel


def check_xy_helical(xhd, xha, rng, dev) -> tuple[dict[str, float], float]:
    """The four helical XY kernels against their plain versions on the
    same CUDA tensors at XYH_CHECK_SHAPES: both colours, measuring and
    not, injected and Philox uniforms.  The state must be equal bitwise,
    the float64 sums within 1e-12 relative.  Returns ({kernel: state
    error}, sums' relative error)."""
    errs = {"phase": 0.0, "or": 0.0, "angle_phase": 0.0, "angle_or": 0.0}
    rel = 0.0
    for nrep, ny, nx in XYH_CHECK_SHAPES:
        ang, comp = helical_state(dev, nrep, ny, nx, ny + nrep)
        gen = torch.Generator(device=dev).manual_seed(nx)
        u = tuple(torch.rand(tuple(ang[0].shape), generator=gen, device=dev)
                  for _ in range(2))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.sample_key(rng.base_key(31), ny),
                                       color)
            for name, e, r in helical_pairs(xhd, xha, comp, ang, u, seeds,
                                            color, 1.0 / KBT_XY):
                errs[name] = max(errs[name], e)
                rel = max(rel, r)
        log(f"  xy helical kernels {nx}x{ny} x {nrep}: state vs plain "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; sums' relative error {rel:.3g}")
        del ang, comp, u
    if max(errs.values()) != 0.0 or rel > 1e-12:
        fail(f"a helical XY kernel differs from its plain version: {errs}, "
             f"sums' relative error {rel:.3g}")
    return errs, rel


def check_atan2(xha, dev, n: int = 10_000_000) -> float:
    """The device atan2_2pi (``atan2_kernel``) against the plain
    ops/trig.atan2_2pi on the card, bitwise, on n points: every octant at
    radii from 1e-6 to 1e3, the octant borders, the axes with signed zeros,
    and (0, 0).  Returns the largest difference (0 when equal)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
    gen = torch.Generator(device=dev).manual_seed(5)
    ang = (torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
           * 2.0 - 1.0) * math.pi
    rad = 10.0 ** (torch.rand(n, generator=gen, device=dev,
                              dtype=torch.float64) * 9.0 - 6.0)
    border = torch.arange(-8, 9, device=dev, dtype=torch.float64) * (
        math.pi / 8)
    y = torch.cat([rad * torch.sin(ang), torch.sin(border),
                   torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -1.0],
                                device=dev, dtype=torch.float64)]).float()
    x = torch.cat([rad * torch.cos(ang), torch.cos(border),
                   torch.tensor([0.0, 0.0, -1.0, -1.0, 0.0, 0.0],
                                device=dev, dtype=torch.float64)]).float()
    got = xha.atan2_2pi(y.contiguous(), x.contiguous())
    want = trig.atan2_2pi(y, x)
    err = float_err([(got, want)])
    ref = torch.atan2(y.double(), x.double()) / (2 * math.pi)
    d = (got.double() - ref).abs()
    acc = float(torch.minimum(d, 1.0 - d).max())   # -0.5 and 0.5: one angle
    log(f"  atan2_2pi on {y.numel()} points: device vs plain {err:.3g}, "
        f"largest |error| vs float64 {acc:.3g} turns, atan2_2pi(0, 0) = "
        f"{float(got[-6]):.3g}")
    if err != 0.0 or float(got[-6]) != 0.0:
        fail("the device atan2_2pi differs from its plain version")
    return err


def check_xy_helical_phase_a(xhd, xha, rng, dev, iters: int) -> float:
    """Phase a from all-up on both engines, iters x 10001x10000 (the main
    path's launch; 5.0005e7 sites a colour): every site sees the field
    (4, 0) and accepts (cos 2πu, sin 2πu) with p = exp(-4β(1 - cos 2πu)),
    so <S_x> = 1 - e^(-4β)[I0(4β) - I1(4β)], <S_y> = 0 and the acceptance
    is e^(-4β) I0(4β), as for the periodic lattice.  <S_x>, <S_y> come
    from the measuring kernel's sums (colour b adds N/2 times its decoded
    +x, exactly); a site counts as accepted where it left +x.  On the
    angle engine all-up is the angle 0, decoded (C0, 0) with C0 =
    0.99999998: its field is 4 C0, which moves the closed forms by ~1e-8,
    far inside the 5e-6 sigma.  Returns the largest |z|."""
    from scipy.special import ive
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import trig
    x4 = 4.0 / KBT_XY
    nrep, ny, nc = 1, HY, (HX + 1) // 2
    n_a = HX * HY // 2
    keys = rng.seeds_from_key(rng.sample_key(rng.base_key(2061),
                                             torch.arange(iters)), 0)
    c0 = float(trig.cos_sin_2pi(torch.zeros(1))[0][0])
    worst = 0.0
    for engine in ("component", "angle"):
        per = {"sx": [], "sy": [], "acc": []}
        if engine == "component":
            ax, bx = (torch.ones((nrep, ny, nc), device=dev) for _ in range(2))
            ay, by = (torch.zeros((nrep, ny, nc), device=dev)
                      for _ in range(2))
        else:
            a, b = (torch.zeros((nrep, ny, nc), device=dev) for _ in range(2))
        for it in range(iters):
            if engine == "component":
                ax.fill_(1.0)
                ay.zero_()
                obs = xhd.phase(ax, ay, bx, by, keys[it], color=0,
                                beta=1.0 / KBT_XY, measuring=True)[2]
                moved = (ax != 1.0) | (ay != 0.0)
                other = n_a
            else:
                a.zero_()
                obs = xha.angle_phase(a, b, keys[it], color=0,
                                      beta=1.0 / KBT_XY, measuring=True)[1]
                moved = a != 0.0
                other = n_a * c0
            per["sx"].append((obs[:, 0] - other) / n_a)
            per["sy"].append(obs[:, 1] / n_a)
            per["acc"].append(moved.sum(dim=(1, 2)).double() / n_a)
        worst = max(
            worst,
            z_sampled(f"xy helical {engine} phase a <S_x>", per["sx"],
                      1.0 - (ive(0, x4) - ive(1, x4)), n_a),
            z_sampled(f"xy helical {engine} phase a <S_y>", per["sy"], 0.0,
                      n_a),
            z_sampled(f"xy helical {engine} phase a acceptance", per["acc"],
                      ive(0, x4), n_a))
    return worst


def check_xy_helical_over_relax(xhd, xha, dev) -> dict[str, float]:
    """One over-relaxation sweep of one random 10001x10000 state on each
    engine, the energy of the flat state (float64 of its float32
    components) before and after.  Bounds, worst case over the N sites
    (each bond changes once a phase, N site reflections a sweep):
    component, N · 8 · 2^-24 (2 ulp of the largest |S·h| = 4, as for the
    periodic lattice); angle, N · 2e-5: φ = atan2_2pi(h) carries the
    polynomial's 4.6e-8 turns and ~6 roundings below 0.5 (1.8e-7), θ' =
    2φ - θ doubles that and rounds twice more (6e-8 each): |δθ'| <= 5.8e-7
    turns = 3.6e-6 rad, which moves a site's -S·h by at most |h| 3.6e-6 <=
    1.5e-5, and the decode of θ and θ' (1.1e-7 a component each) by
    |h| 4.4e-7 <= 1.8e-6.  Also the fused e against the state's and |S|.
    Returns {engine: |dE| / N}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2DHelical
    model = XY2DHelical(nx=HX, ny=HY, kbt=KBT_XY)
    ang, comp = helical_state(dev, 1, HY, HX, 78)
    out = {}
    for engine, mod, planes, per_site in (
            ("component", xhd, comp, 8 * 2.0 ** -24),
            ("angle", xha, ang, 2e-5)):
        e0 = model.energy_sum(mod.unpack_state(planes, HY, HX))
        planes, obs = mod.over_relax_sweep_measure(model, planes)
        st = mod.unpack_state(planes, HY, HX)
        e1 = model.energy_sum(st)
        de = float((e1 - e0).abs().max())
        fused = float((obs["e"] * model.nsites - e1).abs().max())
        norm = float((torch.hypot(st.sx.double(), st.sy.double())
                      - 1.0).abs().max())
        del st
        out[engine] = de / model.nsites
        log(f"  xy helical {engine} over-relaxation sweep 10001x10000: "
            f"|dE| {de:.4g} ({de / model.nsites:.3g} a site, bound "
            f"{per_site:.3g}), fused e vs the state's "
            f"{fused / model.nsites:.3g} a site, ||S| - 1| <= {norm:.3g}")
        if (de > model.nsites * per_site
                or fused > model.nsites * 8 * 2.0 ** -24 or norm > 1e-6):
            fail(f"the {engine} over-relaxation sweep does not keep the "
                 "energy within its bound or |S| to float32 rounding")
    del ang, comp
    return out


def check_one_sample_curve(table: np.ndarray, ref1: np.ndarray,
                           var_ref: np.ndarray, nsites: int, samples: int,
                           mcs: int) -> float:
    """<m>(t), <e>(t) against a one-sample curve of the same geometry (its
    own variance columns are 0): a two-sample z with sigma^2 = N·Var
    (1/(N n) + 1/N_1) at every t <= mcs, N·Var from ``var_ref`` (the
    32-sample 2000x2000 curve at the same kbt; the port's own 4-sample
    N·Var would make z Student-t with 3 degrees of freedom, P(|t| > 5) =
    1.5% a point).  The port's own-variance z is printed beside it.
    Returns the largest |z|."""
    worst = 0.0
    for t in range(1, mcs + 1):
        row, r1, rv = row_at(table, t), row_at(ref1, t), row_at(var_ref, t)
        for name, col, var_col in (("m", 3, 7), ("e", 4, 8)):
            term = 1.0 / (nsites * samples) + 1.0 / int(r1[0])
            z = (row[col] - r1[col]) / math.sqrt(rv[var_col] * term)
            z_own = (row[col] - r1[col]) / math.sqrt(
                max(row[var_col], 1e-300) * term)
            if t in (1, 10, 100):
                log(f"  t={t:5d} <{name}> port {row[col]:.9f} one-sample "
                    f"curve {r1[col]:.9f} z {z:+.2f} (own N·Var: "
                    f"{z_own:+.2f})")
            worst = max(worst, abs(z))
            if abs(z) > SIGMAS:
                fail(f"<{name}>({t}) is {z:+.2f} sigma from the one-sample "
                     "curve")
    log(f"  largest |z| against the one-sample curve {worst:.2f}")
    return worst


def run_xy_helical(main_fn, modules, out_dir, label, kbt, samples, mcs,
                   n_over_relax, engine):
    """One helical XY class through the CLI at 10001x10000, one replica a
    sample, from all-up; the header's geometry, schedule and engine.
    Returns (launches, wall, rate, table)."""
    argv = ["--model", "xy2d", "--nx", str(HX), "--ny", str(HY), "--kbt",
            repr(kbt), "--mcs", str(mcs), "--samples", str(samples),
            "--replicas", "1"]
    lines = [f"# nx, ny: {HX} {HY}", f"# engine: {engine}"]
    if n_over_relax:
        argv += ["--n-over-relax", str(n_over_relax), "--mcs-over-relax",
                 str(mcs)]
        lines += [f"# n_over_relax: {n_over_relax}",
                  f"# mcs_over_relax: {mcs}"]
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, label, argv, HX * HY, samples, mcs)
    for line in lines:
        if line not in head:
            fail(f"helical xy .dat header lacks {line!r}: {head}")
    return launches, wall, rate, table


def time_xy_helical(xhd, xha, dev, seeds, readings: int = 3):
    """Every phase kernel of both helical engines at the main path's launch,
    10001x10000 x 1, colour a plain and colour b measuring, with CUDA
    events (200-launch runs), over ``readings`` readings in turns, beside
    its bound; the first reading also times the plain version and holds the
    state against it.  Returns ({case: [times of each reading]}, largest
    state error)."""
    ang, comp = helical_state(dev, 1, HY, HX, 25)
    n = HX * HY // 2
    beta = 1.0 / KBT_XY
    obs = 3 * 8
    a_kw, b_kw = dict(color=0, beta=beta), dict(color=1, beta=beta,
                                                 measuring=True)
    cases = (
        ("component phase",
         lambda *p: xhd.phase(*p, seeds[0, 0], **a_kw),
         lambda *p: xhd.phase_plain(*p, seeds[0, 0], **a_kw), comp,
         24 * n, n * OPS_XY_METROPOLIS),
        ("component phase, measuring",
         lambda *p: xhd.phase(*p, seeds[0, 1], **b_kw),
         lambda *p: xhd.phase_plain(*p, seeds[0, 1], **b_kw),
         xy_by_color(comp, 1), 24 * n + obs,
         n * (OPS_XY_METROPOLIS + OPS_XY_MEASURE)),
        ("component or", lambda *p: xhd.or_phase(*p, color=0),
         lambda *p: xhd.or_phase_plain(*p, color=0), comp, 24 * n,
         n * OPS_XY_OVER_RELAX),
        ("component or, measuring",
         lambda *p: xhd.or_phase(*p, color=1, measuring=True),
         lambda *p: xhd.or_phase_plain(*p, color=1, measuring=True),
         xy_by_color(comp, 1), 24 * n + obs,
         n * (OPS_XY_OVER_RELAX + OPS_XY_MEASURE)),
        ("angle phase",
         lambda *p: xha.angle_phase(*p, seeds[0, 0], **a_kw),
         lambda *p: xha.angle_phase_plain(*p, seeds[0, 0], **a_kw), ang,
         XYA_BYTES_PER_SITE * n, n * OPS_XYA_METROPOLIS),
        ("angle phase, measuring",
         lambda *p: xha.angle_phase(*p, seeds[0, 1], **b_kw),
         lambda *p: xha.angle_phase_plain(*p, seeds[0, 1], **b_kw),
         ang[::-1], XYA_BYTES_PER_SITE * n + obs,
         n * (OPS_XYA_METROPOLIS + OPS_XY_MEASURE)),
        ("angle or", lambda *p: xha.angle_or_phase(*p, color=0),
         lambda *p: xha.angle_or_phase_plain(*p, color=0), ang,
         XYA_BYTES_PER_SITE * n, n * OPS_XYA_OVER_RELAX),
        ("angle or, measuring",
         lambda *p: xha.angle_or_phase(*p, color=1, measuring=True),
         lambda *p: xha.angle_or_phase_plain(*p, color=1, measuring=True),
         ang[::-1], XYA_BYTES_PER_SITE * n + obs,
         n * (OPS_XYA_OVER_RELAX + 22 + OPS_XY_MEASURE)))
    times = {label: [] for label, *_ in cases}
    err = 0.0
    for reading in range(readings):
        for label, kernel, plain, planes, nbytes, ops in cases:
            if reading == 0:
                t, e = time_xy(f"xy helical {label} 10001x10000 x 1",
                               kernel, plain, planes, nbytes, ops, reps=200,
                               plain_reps=2)
                err = max(err, e)
            else:
                k = [p.clone() for p in planes]
                ms = cuda_time_ms(lambda: kernel(*k), reps=200)
                del k
                t = dict(times[label][0], ms=ms)
            times[label].append(t)
    for label in times:
        log(f"  xy helical {label}: ms a launch over {readings} readings "
            + ", ".join(f"{t['ms']:.4f}" for t in times[label])
            + f"; bound {times[label][0]['bound_ms']:.4f} "
            f"({times[label][0]['bound_by']})")
    regs = {f"{mode} {kind}": ptxas_registers(
        "xy2d_helical_dense_angle", "angle_tile_kernel", f"ILb{o}ELb{m}E")
        for o, mode in ((0, "Metropolis"), (1, "OR"))
        for m, kind in ((0, "plain"), (1, "measuring"))}
    log("  xy helical angle_tile_kernel registers: " + ", ".join(
        f"{k} {v}" for k, v in regs.items()))
    for kind in ("phase", "phase, measuring", "or", "or, measuring"):
        ratios = [a["ms"] / c["ms"] for a, c in zip(
            times[f"angle {kind}"], times[f"component {kind}"])]
        log(f"  xy helical A/B {kind}: angle / component "
            + ", ".join(f"{r:.3f}" for r in ratios))
    del ang, comp
    return times, err


# ---------------------------------------------------------------------------
# the int8 periodic Ising kernels: every even shape the bit-packed engines
# refuse (ops/ising2d_pallas.py, ising3d_pallas.py, ising2d_measure_pallas.py,
# ising2d_multisweep.py)
# ---------------------------------------------------------------------------

# (R, ny, half) / (R, nz, ny, half) of the checks: a ragged small shape
# (half 63, a masked last unit), then each class's launch shape, and in
# 2-D rows chunked past ops/ising2d_multisweep.CHUNK_COLS columns
INT8_SHAPES_2D = ((3, 130, 63), (16, 1000, 500), (8, 4000, 2000),
                  (1, 1000, 500), (1, 4, 4102))
INT8_SHAPES_3D = ((2, 14, 12, 5), (2, 500, 500, 250))
# the multisweep's check (the resident class's launch), the first sweeps'
# (shape, sweeps) for >= 1e10 sites each, and the launch shapes timed
INT8_MS_CHECK = (16, 1000, 500)
# the multisweep's tile edges, INT8_MS_EDGE_SWEEPS sweeps against its plain
# version on aligned planes and on views off the 16-B grid: a masked last
# unit and rows off the 4-byte grid (half 63), rows chunked past
# ops/ising2d_multisweep.CHUNK_COLS columns with a masked last unit
INT8_MS_EDGES = ((3, 130, 63), (2, 4, 4102))
INT8_MS_EDGE_SWEEPS = 4
INT8_FIRST_SWEEP = (((8, 4000, 2000), 79), ((2, 500, 500, 250), 40))
INT8_TIMED = ((8, 4000, 2000), (1, 1000, 500), (2, 500, 500, 250))
# minimum 32-bit instructions a site of an int8 phase beside a quarter of
# its unit's Philox call: the neighbour sum (3 adds, 5 in 3-D), the side
# column's select and wrap (2), k = s * nsum and its test (2), the
# threshold's two selects and the compare (3), the flip's negate and select
# (2); a site of the measure pass: its two bonds' (three in 3-D) adds, the
# product and the two sums (5, 6); the fused sums of a measuring phase b
# (4).  Bytes a site of the colour updated: its byte read and written and
# the other colour's read once (3); the measure pass reads every site once
# (1 B a site)
OPS_INT8_SITE = {2: 12, 3: 14}
OPS_INT8_MEASURE = {2: 5, 3: 6}
OPS_INT8_FUSED = 4
INT8_PHASE_BYTES = 3
# the int8 route readings (nx, R): ms a sweep of the multisweep against the
# streamed phase-measure launches, about the bound's batch·nx·ny bytes
INT8_ROUTE_SHAPES = ((1000, 1), (1000, 4), (1000, 16), (1000, 32),
                     (1000, 64), (2000, 1), (2000, 4), (2000, 8),
                     (2000, 16))


def int8_phase_build(i2p) -> dict:
    """The int8 2-D phase kernel's ptxas registers a mode (the halo modes
    are row 25's) and the tile constants of its main-path launches
    (ops/ising2d_pallas.phase_tiles): the streamed class's, the samples
    class's and the mesh class's shard."""
    modes = {"phase": "ILb0ELb0ELb0E", "injected": "ILb0ELb0ELb1E",
             "halo": "ILb1ELb0ELb0E", "halo measuring": "ILb1ELb1ELb0E"}
    return {"registers": {k: ptxas_registers("ising2d_pallas",
                                             "phase_kernel", v)
                          for k, v in modes.items()},
            "tiles": {"x".join(map(str, shape)): i2p.phase_tiles(*shape)
                      for shape in ((8, 4000, 2000), (1, 1000, 500),
                                    (8, 2000, 1000))}}


def int8_phase_ops(dims: int) -> float:
    """Instructions a site of an int8 phase (a quarter Philox call)."""
    return OPS_PER_PHILOX / 4 + OPS_INT8_SITE[dims]


def int8_state(dev, shape, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy((g.integers(0, 2, size=shape,
                                              dtype=np.int8) * 2 - 1)
                                  .astype(np.int8)).to(dev)
                 for _ in range(2))


def check_int8(i2p, i3p, i8m, i8ms, rng, dev) -> dict[str, int]:
    """The int8 kernels against their plain versions on the same CUDA
    tensors, bitwise: both phase kernels with injected and Philox words,
    both colours, and the measure kernel, at a ragged small shape and at
    each class's launch shape; 64 multisweep sweeps at 1000x1000 x 16
    against 64 phase-kernel pairs with measure_kernel (state and sums)
    and against the plain multisweep, and INT8_MS_EDGE_SWEEPS at
    INT8_MS_EDGES against the plain multisweep, on aligned planes and on
    views off the 16-B grid.  Returns the largest absolute difference a
    kernel."""
    errs = {"phase2d": 0, "phase3d": 0, "measure": 0, "multisweep": 0}
    for shape in INT8_SHAPES_2D + INT8_SHAPES_3D:
        dims = len(shape) - 1
        mod, beta = (i2p, 1.0 / KBT) if dims == 2 else (i3p, 1.0 / KBT_3D)
        a, b = int8_state(dev, shape, sum(shape))
        bits = random_words(shape, len(shape) + shape[0], dev, n=1)[0]
        e_bits = e_rand = 0
        for color in (0, 1):
            x, o = (a, b) if color == 0 else (b, a)
            seeds = rng.seeds_from_key(rng.base_key(17), color)
            e_bits = max(e_bits, max_abs_err([(
                mod.metropolis_phase(x.clone(), o, color=color, beta=beta,
                                     bits=bits),
                mod.phase_plain(x, o, color=color, beta=beta, bits=bits))]))
            e_rand = max(e_rand, max_abs_err([(
                mod.metropolis_phase(x.clone(), o, seeds, color=color,
                                     beta=beta),
                mod.phase_plain(x, o, seeds, color=color, beta=beta))]))
        e_m = max_abs_err([(i8m.measure_sums(a, b),
                            i8m.measure_sums_plain(a, b))])
        errs[f"phase{dims}d"] = max(errs[f"phase{dims}d"], e_bits, e_rand)
        errs["measure"] = max(errs["measure"], e_m)
        log(f"  int8 {dims}-D {'x'.join(map(str, shape))}: phase bits "
            f"{e_bits}, philox {e_rand}; measure {e_m}")
        del a, b, bits
    errs["phase3d"] = max(errs["phase3d"], check_int8_3d_off_grid(i3p, rng,
                                                                  dev))
    errs["measure"] = max(errs["measure"], check_int8_measure_edges(i8m,
                                                                    dev))
    a, b = int8_state(dev, INT8_MS_CHECK, 31)
    seeds = multispin_keys(rng, 64)
    ka, kb, kobs = i8ms.multisweep_planes(a.clone(), b.clone(), seeds,
                                          beta=1.0 / KBT)
    pa, pb, obs = a.clone(), b.clone(), []
    for s in range(64):
        i2p.metropolis_phase(pa, pb, seeds[s, 0], color=0, beta=1.0 / KBT)
        i2p.metropolis_phase(pb, pa, seeds[s, 1], color=1, beta=1.0 / KBT)
        obs.append(i8m.measure_sums(pa, pb))
    e_pairs = max_abs_err([(ka, pa), (kb, pb),
                           (kobs, torch.stack(obs, dim=1))])
    qa, qb, qobs = i8ms.multisweep_plain(a, b, seeds, beta=1.0 / KBT)
    e_plain = max_abs_err([(ka, qa), (kb, qb), (kobs, qobs)])
    log(f"  int8 multisweep {'x'.join(map(str, INT8_MS_CHECK))}, S=64: vs "
        "64 phase pairs and "
        f"measure_kernel {e_pairs}, vs plain {e_plain}")
    e_edges = 0
    s_edge = seeds[:INT8_MS_EDGE_SWEEPS]
    for shape in INT8_MS_EDGES:
        a, b = int8_state(dev, shape, 7 + sum(shape))
        qa, qb, qobs = i8ms.multisweep_plain(a, b, s_edge, beta=1.0 / KBT)
        for off in ((0, 0), OFF_GRID[:2]):
            ka, kb, kobs = i8ms.multisweep_planes(
                off_grid_view(a, off[0]), off_grid_view(b, off[1]), s_edge,
                beta=1.0 / KBT)
            e_edges = max(e_edges, max_abs_err([(ka, qa), (kb, qb),
                                                (kobs, qobs)]))
    log(f"  int8 multisweep at {INT8_MS_EDGES}, S={INT8_MS_EDGE_SWEEPS}, "
        f"aligned and {OFF_GRID[:2]} bytes off the 16-B grid: vs plain "
        f"{e_edges}")
    errs["multisweep"] = max(e_pairs, e_plain, e_edges)
    torch.cuda.synchronize()
    for name, e in errs.items():
        if e != 0:
            fail(f"int8 {name} kernel differs from its plain version (max "
                 f"abs err {e})")
    return errs


# a small int8 3-D shape on views off the 16-B grid (each tensor's first
# byte OFF_GRID bytes past an aligned address): tile_kernel in its plain,
# injected-words and halo measuring modes, the halo mode at global
# offsets (1, 5)
INT8_OFF_GRID_3D = (2, 6, 10, 250)
OFF_GRID = (3, 7, 11)


def check_int8_3d_off_grid(i3p, rng, dev) -> int:
    """tile_kernel on views whose first byte lies off the 16-B grid,
    against its plain version on aligned copies, bitwise: both colours
    with Philox and injected words, and the halo mode measuring and
    plain.  Returns the largest absolute difference."""
    g = np.random.default_rng(97)
    shape = INT8_OFF_GRID_3D
    beta = 1.0 / KBT_3D

    def spins(shp):
        return torch.from_numpy((g.integers(0, 2, size=shp) * 2 - 1).astype(
            np.int8)).to(dev)

    off_grid = off_grid_view
    a, b = spins(shape), spins(shape)
    hs = (shape[0], 1) + shape[2:]
    zm, zp = spins(hs), spins(hs)
    bits = random_words(shape, 101, dev, n=1)[0]
    err = 0
    for color in (0, 1):
        x, o = (a, b) if color == 0 else (b, a)
        seeds = rng.seeds_from_key(rng.base_key(23), color)
        for kw in (dict(seeds=seeds), dict(bits=bits)):
            got = i3p.metropolis_phase(off_grid(x, OFF_GRID[0]),
                                       off_grid(o, OFF_GRID[1]),
                                       color=color, beta=beta, **kw)
            err = max(err, max_abs_err([(got, i3p.phase_plain(
                x, o, color=color, beta=beta, **kw))]))
        for measuring in (False, True):
            got = i3p.sharded_phase(
                off_grid(x, OFF_GRID[0]), off_grid(o, OFF_GRID[1]),
                off_grid(zm, OFF_GRID[2]), off_grid(zp, OFF_GRID[0]), seeds,
                (1, 5), color=color, beta=beta, measuring=measuring)
            want = i3p.sharded_phase_plain(x, o, zm, zp, seeds, (1, 5),
                                           color=color, beta=beta,
                                           measuring=measuring)
            err = max(err, max_abs_err(
                zip(got, want) if measuring else [(got, want)]))
    log(f"  int8 3-D {'x'.join(map(str, shape))} on views {OFF_GRID} bytes "
        f"off the 16-B grid: phase, injected, halo (measuring): {err}")
    return err


def off_grid_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous int8 copy of ``t`` on its device whose first byte lies
    ``off`` bytes past a 16-B aligned address."""
    buf = torch.empty(t.numel() + 32, dtype=torch.int8, device=t.device)
    base = (-buf.data_ptr()) % 16
    v = buf[base + off:base + off + t.numel()].view(t.shape)
    assert v.data_ptr() % 16 == off % 16 and v.is_contiguous()
    return v.copy_(t)


# the measure kernel's edges: rows past its chunk width (two chunks, a
# masked last unit), 2-D and 3-D, the least ny and nz, rows 2-B aligned
INT8_MEASURE_EDGES = ((2, 2, 4102), (1, 2, 2, 4100), (2, 4, 6, 250))


def check_int8_measure_edges(i8m, dev) -> int:
    """measure_kernel against its plain version at INT8_MEASURE_EDGES, on
    aligned tensors and on views OFF_GRID[:2] bytes off the 16-B grid,
    exactly.  Returns the largest absolute difference."""
    err = 0
    for shape in INT8_MEASURE_EDGES:
        a, b = int8_state(dev, shape, 7 * sum(shape))
        want = i8m.measure_sums_plain(a, b)
        err = max(err, max_abs_err([
            (i8m.measure_sums(a, b), want),
            (i8m.measure_sums(off_grid_view(a, OFF_GRID[0]),
                              off_grid_view(b, OFF_GRID[1])), want)]))
    log(f"  int8 measure at {INT8_MEASURE_EDGES}, aligned and {OFF_GRID[:2]} "
        f"bytes off the 16-B grid: {err}")
    return err


def multispin_keys(rng, sweeps: int, seed: int = 29):
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    return multispin_rng.sweep_phase_keys(
        rng.sample_key(rng.base_key(seed), 0), sweeps)


def check_first_sweep_int8(i2p, i3p, i8m, rng, dev, ref_row, ref3_row
                           ) -> float:
    """<m>(1), <e>(1) of the int8 kernels from all-up against the closed
    forms for the uint32-quantized thresholds, over >= 1e10 sites each:
    2-D at 4000x4000 x 8 (79 sweeps), 3-D at 500^3 x 2 (40 sweeps), each
    sweep two phase launches and the measure kernel.  Returns the largest
    |z|."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import tables
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import (
        Ising2D,
        Ising3D,
    )

    worst = 0.0
    for shape, iters in INT8_FIRST_SWEEP:
        if len(shape) == 3:
            name, mod, ref_r = "int8 2-D", i2p, ref_row
            model = Ising2D(nx=2 * shape[2], ny=shape[1], kbt=KBT)
        else:
            name, mod, ref_r = "int8 3-D", i3p, ref3_row
            model = Ising3D(nx=2 * shape[3], ny=shape[2], nz=shape[1],
                            kbt=KBT_3D)
        total = torch.zeros(2, dtype=torch.int64, device=dev)
        base = rng.base_key(2027)
        for it in range(iters):
            a = torch.ones(shape, dtype=torch.int8, device=dev)
            b = torch.ones(shape, dtype=torch.int8, device=dev)
            seeds = i2p.phase_seeds(rng.sweep_key(rng.sample_key(base, it),
                                                  1))
            mod.metropolis_phase(a, b, seeds[0], color=0, beta=model.beta)
            mod.metropolis_phase(b, a, seeds[1], color=1, beta=model.beta)
            total += i8m.measure_sums(a, b).sum(dim=0)
        if len(shape) == 3:
            t4, t8 = i2p.accept_thresholds_u32(model.beta)
            want = first_sweep_exact_p(t4 / 2 ** 32, t8 / 2 ** 32)
        else:
            want = first_sweep_exact3d_p(
                *(t / 2 ** 32
                  for t in tables.ising3d_accept_thresholds_u32(model.beta)))
        nsites = iters * shape[0] * model.nsites
        worst = max(worst, check_z(name, total, nsites, want,
                                   (ref_r[7], ref_r[8])))
    return worst


def run_samples_class(main_fn, modules, out_dir, label: str, argv, ref,
                      histories: int, mcs: int, ncols: int,
                      shape: tuple[int, int] = (1000, 1000)
                      ) -> tuple[dict, float, float, float]:
    """--protocol samples at ``shape`` (nx, ny; ``argv`` names the model), one
    history at a time through the per-history runner; the rows N, sample,
    t, m, e (and m_y: ``ncols`` 6) and the per-t means of m and e over the
    histories against the reference curve within SIGMAS combined standard
    errors, sigma^2 = N·Var_ref (1/(N n) + 1/(N_ref n_ref)).  Returns
    (launches, wall, rate, largest |z|)."""
    nx, ny = shape
    nsites = nx * ny
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, label,
        list(argv) + ["--protocol", "samples", "--nx", str(nx), "--ny",
                      str(ny), "--mcs", str(mcs), "--samples",
                      str(histories)], nsites, histories, mcs)
    if "# engine: phase engine (single history)" not in head:
        fail(f"samples run took another route: {head}")
    want = np.stack([np.full(histories * mcs, nsites),
                     np.repeat(np.arange(1, histories + 1), mcs),
                     np.tile(np.arange(1, mcs + 1), histories)], axis=1)
    if table.shape != (histories * mcs, ncols) or not np.array_equal(
            table[:, :3], want) or not np.all(np.isfinite(table)):
        fail(f"samples rows: shape {table.shape} or the N, sample, t "
             "columns are wrong")
    port = table[:, 3:5].reshape(histories, mcs, 2).mean(axis=0)
    worst = 0.0
    n_ref, ns_ref = ref[0, 0], ref[0, 1]
    for t in range(1, mcs + 1):
        rrow = row_at(ref, t)
        for k, (name, col, var_col) in enumerate((("m", 3, 7),
                                                  ("e", 4, 8))):
            sigma = math.sqrt(rrow[var_col] * (1.0 / (nsites * histories)
                                               + 1.0 / (n_ref * ns_ref)))
            z = (port[t - 1, k] - rrow[col]) / sigma
            if t in (1, 10, 100, mcs):
                log(f"  samples t={t:4d} <{name}> port {port[t - 1, k]:.9f} "
                    f"reference {rrow[col]:.9f} z {z:+.2f}")
            worst = max(worst, abs(z))
            if abs(z) > SIGMAS:
                fail(f"samples <{name}>({t}) is {z:+.2f} sigma from the "
                     "reference")
    log(f"  samples: largest |z| {worst:.2f} over {mcs} times")
    return launches, wall, rate, worst


def time_int8(label: str, sites: int, kernel, plain, inputs, nbytes: float,
              ops: float, reps: int, plain_reps: int) -> tuple[dict, int]:
    """CUDA-event time of an int8 wrapper on clones of ``inputs`` (the
    phases update their planes in place) and of its plain version, beside
    the bound; then one call of each on the same inputs, compared."""
    work = [t.clone() for t in inputs]
    ms = cuda_time_ms(lambda: kernel(*work), reps=reps)
    plain_ms = cuda_time_ms(lambda: plain(*inputs), reps=plain_reps,
                            warmup=1)
    got = kernel(*(t.clone() for t in inputs))
    want = plain(*inputs)
    pairs = (list(zip(got, want)) if isinstance(got, tuple)
             else [(got, want)])
    err = max_abs_err(pairs)
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch ({sites / ms * 1e3:.4g} sites/s), "
        f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); vs plain "
        f"{err}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def time_int8_kernels(i2p, i3p, i8m, i8ms, rng, dev) -> dict:
    """Each int8 kernel at its classes' launch shapes: the 2-D phase at
    4000^2 x 8 (streamed) and 1000^2 x 1 (samples), the 3-D phase at 500^3
    x 2, the measure kernel at each of those, the multisweep at 1000^2 x 16
    with S = 64 and 40 (a call's 15 launches of 64 sweeps and one of 40);
    each held against its plain version; and the multisweep's wrapper and
    launch alone in turns at S = 64, logged.  Returns {label: (times,
    err)}."""
    seeds = multispin_keys(rng, 64, 37)
    out = {}
    for shape in INT8_TIMED:
        dims = len(shape) - 1
        mod, beta = (i2p, 1.0 / KBT) if dims == 2 else (i3p, 1.0 / KBT_3D)
        a, b = int8_state(dev, shape, 41 + len(shape))
        sites = a.numel()
        tag = "x".join(map(str, shape))
        out[f"phase{dims}d {tag}"] = time_int8(
            f"int8 {dims}-D phase kernel {tag}", sites,
            lambda x, o: mod.metropolis_phase(x, o, seeds[0, 0], color=0,
                                              beta=beta),
            lambda x, o: mod.phase_plain(x, o, seeds[0, 0], color=0,
                                         beta=beta),
            (a, b), INT8_PHASE_BYTES * sites, sites * int8_phase_ops(dims),
            reps=20, plain_reps=1)
        out[f"measure{dims}d {tag}"] = time_int8(
            f"int8 {dims}-D measure kernel {tag}", 2 * sites,
            i8m.measure_sums, i8m.measure_sums_plain, (a, b),
            2 * sites + 16 * shape[0], 2 * sites * OPS_INT8_MEASURE[dims],
            reps=20, plain_reps=1)
        del a, b
    a, b = int8_state(dev, INT8_MS_CHECK, 53)
    sites = a.numel()
    for sweeps in (64, 40):
        out[f"multisweep S={sweeps}"] = time_int8(
            f"int8 multisweep kernel {'x'.join(map(str, INT8_MS_CHECK))}, "
            f"S={sweeps}",
            2 * sites * sweeps,
            lambda x, o: i8ms.multisweep_planes(x, o, seeds[:sweeps],
                                                beta=1.0 / KBT),
            lambda x, o: i8ms.multisweep_plain(x, o, seeds[:sweeps],
                                               beta=1.0 / KBT),
            (a, b), 2 * 2 * sites + 16 * a.shape[0] * sweeps,
            2 * sites * sweeps * int8_phase_ops(2)
            + sites * sweeps * OPS_INT8_FUSED, reps=5, plain_reps=1)
    # the launch alone: the C entry on keys already on the card (the
    # wrapper adds its checks, tiles and the keys' pinned copy)
    nrep, ny, half = INT8_MS_CHECK
    lib, keys = i8ms._lib(), multispin_keys_on(seeds, dev)
    t4, t8 = i8ms.accept_thresholds_u32(1.0 / KBT)
    tiles = i8ms._tiles_arg(nrep, ny, half)
    obs = torch.zeros((nrep, 64, 2), dtype=torch.int64, device=dev)

    def alone():
        code = lib.ising2d_int8_multisweep(
            a.data_ptr(), b.data_ptr(), keys.data_ptr(), obs.data_ptr(), nrep,
            ny, half, 64, t4, t8, tiles,
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"int8 multisweep launch alone: code {code}")
    wrap, just = wrapper_and_alone(
        lambda: i8ms.multisweep_planes(a, b, seeds, beta=1.0 / KBT), alone)
    log(f"  int8 multisweep kernel {'x'.join(map(str, INT8_MS_CHECK))}, "
        f"S=64, in turns: the wrapper {wrap}, the launch alone {just} ms")
    return out


def wrapper_and_alone(wrapper, alone) -> tuple[str, str]:
    """The ranges of a wrapper's and its launch alone's CUDA-event times a
    launch in a run of launches, in turns (wrapper, alone, alone,
    wrapper), 5 launches each: the start event is recorded behind two
    launches still on the card, as a runner's next launch finds it, so
    the first timed call's host work overlaps them (after a synchronise
    it would add its host time over 5 to the wrapper's reading)."""
    times = {wrapper: [], alone: []}
    for fn in (wrapper, alone, alone, wrapper):
        fn()
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        stop.record()
        stop.synchronize()
        times[fn].append(start.elapsed_time(stop) / 5)
    return tuple(f"{min(t):.4f}-{max(t):.4f}" for t in times.values())


def multispin_keys_on(seeds, dev) -> torch.Tensor:
    """(S, 2, 2) phase keys as the kernels read them, on the card."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import multispin_rng
    keys = multispin_rng.keys_to(seeds, dev)
    torch.cuda.synchronize()
    return keys


def compare_int8_routes(i2p, i8m, i8ms, rng, dev) -> list[tuple]:
    """ms a sweep of the int8 runner's two 2-D routes, CUDA events, host
    loop included: one multisweep launch of 64 sweeps against 64 streamed
    sweeps (two phase launches and the measure kernel each), at
    INT8_ROUTE_SHAPES.  Returns [(nx, R, bytes, multisweep ms, streamed
    ms)]."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Ising2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )

    seeds = multispin_keys(rng, 64, 43)
    rows = []
    for nx, nrep in INT8_ROUTE_SHAPES:
        model = Ising2D(nx=nx, ny=nx, kbt=KBT)
        a, b = int8_state(dev, (nrep, nx, nx // 2), nx + nrep)

        def resident():
            i8ms.multisweep_planes(a, b, seeds, beta=model.beta)

        def streamed():
            for j in range(64):
                i2p.sweep_seeded(model, CheckerboardState(a, b), seeds[j])
                i8m.measure_sums(a, b)

        res_ms, str_ms = _route_times(resident, streamed, 64)
        nbytes = nrep * nx * nx
        rows.append((nx, nrep, nbytes, res_ms, str_ms))
        log(f"  int8 route {nx}^2 x {nrep} ({nbytes / 2 ** 20:.1f} MiB, "
            f"fits {i8ms.fits(nrep, nx, nx // 2)}): multisweep "
            f"{res_ms:.5f} ms/sweep, streamed {str_ms:.5f} ms/sweep, "
            f"streamed/multisweep {str_ms / res_ms:.3f}")
        del a, b
    return rows


def expect_launches(label: str, launches: dict, want: dict) -> None:
    """Fail unless each named kernel count of a class equals ``want``."""
    got = {mod: {k: launches[mod][k] for k in ks} for mod, ks in want.items()}
    if got != want:
        fail(f"int8 {label} path launched {got}, want {want}")


def run_int8_classes(main_fn, modules, out_dir, ref, ref3) -> dict:
    """The int8 classes through the CLI from all-up, each against its
    reference curve at every t: 1000x1000 x 16, 64 samples, 1000 MCS on the
    multisweep; 4000x4000 x 8 (128 MB of planes, over the multisweep's
    bound), 8 samples, 200 MCS on the streamed phase and measure launches
    (both against the 2-D curve within 5 standard errors of the port's
    mean); --protocol samples at 1000x1000, 16 histories of 200 MCS one at
    a time; 500^3 x 2, 2 samples, 1000 MCS on the 3-D phase and measure
    launches (against the 512^3 curve within 5 combined standard errors).
    Returns {label: (launches, wall, rate, largest |z|)}."""
    out = {}
    ms = "ising2d_int8_multisweep"
    for label, n, nrep, samples, mcs, engine in (
            ("2-D resident 1000^2 x 16", 1000, 16, 64, 1000,
             "int8 multisweep (cooperative)"),
            ("2-D streamed 4000^2 x 8", 4000, 8, 8, 200,
             "phase engine (batched)")):
        log(f"phase 4h: int8 2-D path, {label}, {samples} samples, {mcs} "
            "MCS")
        launches, wall, rate, table, head = run_main_path(
            main_fn, modules, out_dir, f"ising2d_int8_{n}",
            ["--model", "ising2d", "--nx", str(n), "--ny", str(n), "--kbt",
             repr(KBT), "--mcs", str(mcs), "--samples", str(samples),
             "--replicas", str(nrep)], n * n, samples, mcs)
        if f"# engine: {engine}" not in head:
            fail(f"int8 {label} took another route: {head}")
        z = check_against_reference(table, ref, n * n, samples, mcs,
                                    range(1, mcs + 1))
        calls = samples // nrep
        resident = engine.startswith("int8 multisweep")
        expect_launches(label, launches, {
            ms: {"multisweep": calls * -(-mcs // 64) if resident else 0},
            "ising2d_int8": {"phase": 0 if resident else 2 * calls * mcs},
            "ising_int8_measure": {"measure2d": 0 if resident
                                   else calls * mcs, "measure3d": 0}})
        out[label] = (launches, wall, rate, z)
    label = "2-D samples 1000^2 x 1"
    log(f"phase 4h: int8 2-D path, {label}: --protocol samples, 16 "
        "histories, 200 MCS")
    launches, wall, rate, z = run_samples_class(
        main_fn, modules, out_dir, "ising2d_int8_samples",
        ["--model", "ising2d", "--kbt", repr(KBT)], ref, 16, 200, 5)
    expect_launches(label, launches, {
        ms: {"multisweep": 0}, "ising2d_int8": {"phase": 2 * 16 * 200},
        "ising_int8_measure": {"measure2d": 16 * 200, "measure3d": 0}})
    out[label] = (launches, wall, rate, z)
    label = "3-D 500^3 x 2"
    log(f"phase 4h: int8 3-D path, {label}, 2 samples, 1000 MCS")
    launches, wall, rate, z = run_3d(
        main_fn, modules, out_dir, (500, 500, 500), KBT_3D, 2, 2, 1000, ref3,
        range(1, 1001), "phase engine (batched)", ref_nsites=512 ** 3)
    expect_launches(label, launches, {
        "ising3d_int8": {"phase": 2000}, "ising2d_int8": {"phase": 0},
        "ising_int8_measure": {"measure2d": 0, "measure3d": 1000}})
    out[label] = (launches, wall, rate, z)
    return out


def int8_shares(classes: dict, t8: dict) -> dict[str, float]:
    """Each int8 class's kernel time (its launches times the launch times
    measured at its shape) over its wall."""
    def ms(key):
        return t8[key][0]["ms"]

    shares = {}
    for label, (n, wall, _, _) in classes.items():
        ph2, ph3 = n["ising2d_int8"]["phase"], n["ising3d_int8"]["phase"]
        m2 = n["ising_int8_measure"]["measure2d"]
        m3 = n["ising_int8_measure"]["measure3d"]
        launches = n["ising2d_int8_multisweep"]["multisweep"]
        if label.startswith("2-D resident"):
            kern = launches // 16 * (15 * ms("multisweep S=64")
                                     + ms("multisweep S=40"))
        elif label.startswith("2-D streamed"):
            kern = (ph2 * ms("phase2d 8x4000x2000")
                    + m2 * ms("measure2d 8x4000x2000"))
        elif label.startswith("2-D samples"):
            kern = (ph2 * ms("phase2d 1x1000x500")
                    + m2 * ms("measure2d 1x1000x500"))
        else:
            kern = (ph3 * ms("phase3d 2x500x500x250")
                    + m3 * ms("measure3d 2x500x500x250"))
        shares[label] = kern / (wall * 1e3)
        log(f"  int8 {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share {shares[label]:.3f}")
    return shares


# ---------------------------------------------------------------------------
# the int8 q-state clock kernels: every q and every even shape the packed
# clock engines refuse (ops/clock_pallas.py, clock_measure_pallas.py,
# clock_multisweep.py)
# ---------------------------------------------------------------------------

CLOCK_1000 = PRODUCTION / "clock_1000x1000_kbt0.91_mcs10000_s100.dat"
# the q of the phase checks (the Ising case, the packed engines' three,
# others below and above the select chains' 16)
CLOCK8_QS = (2, 3, 5, 6, 8, 20)
# (q, kbt, (R, ny, half)) of the classes' launches: resident q = 2 at
# 1000^2 x 16, streamed q = 5 at 2000^2 x 16, samples q = 6 at 1000^2 x 1
CLOCK8_CLASSES = ((2, KBT, (16, 1000, 500)), (5, KBT_CLOCK, (16, 2000, 1000)),
                  (6, KBT_CLOCK, (1, 1000, 500)))
# a ragged small shape (half 63: a masked tail unit)
CLOCK8_SMALL = (3, 130, 63)
# the phase's tile edges, at q = 5 and 6, on aligned planes and on views
# (x, o) bytes off the 16-B grid: rows chunked past
# ops/ising2d_multisweep.CHUNK_COLS columns with a masked last word, the
# ragged small shape
CLOCK8_EDGES = (((2, 6, 4102), (0, 0)), (CLOCK8_SMALL, (3, 7)),
                ((2, 6, 4102), (7, 11)))
# the multisweep's checks (the resident class's launch) at these q
CLOCK8_MS_QS = (2, 6)
# first sweeps from all-up: (q, launch, sweeps) for >= 1e10 sites each
CLOCK8_FIRST_SWEEP = ((5, (16, 2000, 1000), 157), (6, (16, 2000, 1000), 157))
# minimum 32-bit instructions a site of an int8 clock phase beside half its
# unit's Philox call: two uniforms (shift, convert, scale: 6), the
# candidate (scale, truncate, two adds, the wrap: 5), twelve table reads
# (cos and sin of four neighbours, the site and the candidate), the field
# (6 adds), ΔE (2 subtracts, 2 multiplies, an add, the sign: 6), its clamp
# and scale (2), expf (~10), the test, select and store (3): 50.  The
# measure pass a site: two table reads a component for it and its two
# bond partners (6), the bond products and adds (6), the three float64
# sums (3): 15.  The fused sums of a measuring phase b a site of the
# colour updated: two table reads, the float64 field (6) and the three
# sums and products (6): 14.  Bytes a site of the colour updated: its
# byte read and written and the other colour's read once (3); the measure
# pass reads every site once (1 B a site)
OPS_CLOCK8_SITE = 50
OPS_CLOCK8_MEASURE = 15
OPS_CLOCK8_FUSED = 14
CLOCK8_PHASE_BYTES = 3
# the route readings (nx, R) at q = 6: ms a sweep of the multisweep
# against the streamed phase-measure launches
CLOCK8_ROUTE_SHAPES = ((1000, 1), (1000, 16), (2000, 8), (2000, 16))


def scaled_err(got, want, nsites: int) -> float:
    """Largest |got - want| / max(|want|, nsites) of float64 sums of a
    replica's nsites terms of magnitude <= 1 (two, for E, a site): the
    error against the sum's scale, which a sum that cancels (Σ sin θ near
    0) does not shrink."""
    return float(((got - want).abs()
                  / want.abs().clamp(min=float(nsites))).max())


def clock8_phase_ops() -> float:
    """Instructions a site of an int8 clock phase (half a Philox call)."""
    return OPS_PER_PHILOX / 2 + OPS_CLOCK8_SITE


def clock8_state(dev, shape, q: int, seed: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy(g.integers(0, q, size=shape,
                                             dtype=np.int8)).to(dev)
                 for _ in range(2))


def clock8_uniforms(dev, shape, seed: int) -> list[torch.Tensor]:
    """Injected (u_cand, u_acc): multiples of 2^-24 in [0, 1), float32."""
    g = np.random.default_rng(seed)
    return [torch.from_numpy((g.integers(0, 2 ** 24, size=shape)
                              * 2.0 ** -24).astype(np.float32)).to(dev)
            for _ in range(2)]


def check_clock8(c8p, c8m, c8ms, rng, dev) -> dict[str, float]:
    """The int8 clock kernels against their plain versions on the same CUDA
    tensors: phase_kernel bitwise at every q of CLOCK8_QS on a ragged small
    shape and at each class's launch with its q, both colours, injected
    and Philox uniforms; measure_kernel within 1e-12 relative to the sums'
    scale (:func:`scaled_err`; exactly at q = 2 and 4), the same bits in
    two calls, and on views off the 16-B grid at the tile edges; 64
    multisweep sweeps at 1000x1000 x 16, q = 2 and 6, against 64
    phase-kernel pairs with measure_kernel and against the plain
    multisweep, states bitwise and sums within 1e-12 relative.
    Returns the largest error a kernel: of the states and the sums
    absolute ("phase", "measure", "multisweep"), of the sums relative
    ("measure_rel", "multisweep_rel")."""
    errs = {"phase": 0.0, "measure": 0.0, "multisweep": 0.0,
            "measure_rel": 0.0, "multisweep_rel": 0.0}
    cases = [(q, 0.91, CLOCK8_SMALL) for q in CLOCK8_QS + (4,)]
    cases += list(CLOCK8_CLASSES)
    for q, kbt, shape in cases:
        beta = 1.0 / kbt
        a, b = clock8_state(dev, shape, q, sum(shape) + q)
        uc, ua = clock8_uniforms(dev, shape, q + shape[0])
        e_inj = e_rand = 0
        for color in (0, 1):
            x, o = (a, b) if color == 0 else (b, a)
            seeds = rng.seeds_from_key(rng.base_key(17 + q), color)
            kw = dict(color=color, q=q, beta=beta)
            e_inj = max(e_inj, max_abs_err([(
                c8p.metropolis_phase(x.clone(), o, u_cand=uc, u_acc=ua,
                                     **kw),
                c8p.phase_plain(x, o, u_cand=uc, u_acc=ua, **kw))]))
            e_rand = max(e_rand, max_abs_err([(
                c8p.metropolis_phase(x.clone(), o, seeds, **kw),
                c8p.phase_plain(x, o, seeds, **kw))]))
        got, want = c8m.measure_sums(a, b, q), c8m.measure_sums_plain(a, b, q)
        if not torch.equal(got, c8m.measure_sums(a, b, q)):
            fail(f"clock measure_kernel at {shape}, q={q}: two calls differ")
        e_m = scaled_err(got, want, 2 * shape[1] * shape[2])
        if q in (2, 4) and not torch.equal(got, want):
            fail(f"clock measure_kernel at q={q} differs from its plain "
                 f"version ({e_m:.3g}); its integer terms sum exactly")
        errs["phase"] = max(errs["phase"], e_inj, e_rand)
        errs["measure"] = max(errs["measure"], float_err([(got, want)]))
        errs["measure_rel"] = max(errs["measure_rel"], e_m)
        log(f"  clock8 q={q} {'x'.join(map(str, shape))}: phase injected "
            f"{e_inj}, philox {e_rand}; measure rel {e_m:.3g}")
        del a, b, uc, ua
    for shape, (ox, oo) in CLOCK8_EDGES:
        for q in (5, 6):
            a, b = clock8_state(dev, shape, q, 7 * q + shape[2] + ox)
            uc, ua = clock8_uniforms(dev, shape, q + ox)
            e = 0
            for color in (0, 1):
                x, o = (a, b) if color == 0 else (b, a)
                seeds = rng.seeds_from_key(rng.base_key(19 + q), color)
                kw = dict(color=color, q=q, beta=1.0 / KBT_CLOCK)
                for inj in ({}, dict(u_cand=uc, u_acc=ua)):
                    e = max(e, max_abs_err([(
                        c8p.metropolis_phase(
                            off_grid_view(x, ox), off_grid_view(o, oo),
                            None if inj else seeds, **kw, **inj),
                        c8p.phase_plain(x, o, None if inj else seeds, **kw,
                                        **inj))]))
            errs["phase"] = max(errs["phase"], e)
            log(f"  clock8 q={q} {'x'.join(map(str, shape))} at "
                f"({ox}, {oo}) bytes off the 16-B grid: phase {e}")
    # the measure on views off the 16-B grid and at the tile edges, q = 2
    # and 4 exactly
    for shape, (ox, oo) in CLOCK8_EDGES + ((CLOCK8_SMALL, (11, 5)),):
        for q in (2, 4, 5, 127):
            a, b = clock8_state(dev, shape, q, 3 * q + shape[2] + ox)
            got = c8m.measure_sums(off_grid_view(a, ox), off_grid_view(b, oo),
                                   q)
            want = c8m.measure_sums_plain(a, b, q)
            e_m = scaled_err(got, want, 2 * shape[1] * shape[2])
            if q in (2, 4) and not torch.equal(got, want):
                fail(f"clock measure_kernel at q={q} off the 16-B grid "
                     f"differs from its plain version ({e_m:.3g})")
            errs["measure"] = max(errs["measure"], float_err([(got, want)]))
            errs["measure_rel"] = max(errs["measure_rel"], e_m)
        log(f"  clock8 measure {'x'.join(map(str, shape))} at ({ox}, {oo}) "
            f"bytes off the 16-B grid, q = 2, 4, 5, 127: rel "
            f"{errs['measure_rel']:.3g} (largest so far)")
    seeds = multispin_keys(rng, 64)
    e_states = 0
    for q in CLOCK8_MS_QS:
        beta = 1.0 / (KBT if q == 2 else KBT_CLOCK)
        a, b = clock8_state(dev, CLOCK8_CLASSES[0][2], q, 31 + q)
        ka, kb, kobs = c8ms.multisweep_planes(a.clone(), b.clone(), seeds,
                                              q=q, beta=beta)
        pa, pb, obs = a.clone(), b.clone(), []
        for s in range(64):
            c8p.metropolis_phase(pa, pb, seeds[s, 0], color=0, q=q,
                                 beta=beta)
            c8p.metropolis_phase(pb, pa, seeds[s, 1], color=1, q=q,
                                 beta=beta)
            obs.append(c8m.measure_sums(pa, pb, q))
        nsites = 2 * a.shape[1] * a.shape[2]
        e_pairs = max_abs_err([(ka, pa), (kb, pb)])
        r_pairs = scaled_err(kobs, torch.stack(obs, dim=1), nsites)
        qa, qb, qobs = c8ms.multisweep_plain(a, b, seeds, q=q, beta=beta)
        e_plain = max_abs_err([(ka, qa), (kb, qb)])
        e_states = max(e_states, e_pairs, e_plain)
        r_plain = scaled_err(kobs, qobs, nsites)
        errs["multisweep"] = max(
            errs["multisweep"], e_pairs, e_plain,
            float_err([(kobs, torch.stack(obs, dim=1)), (kobs, qobs)]))
        errs["multisweep_rel"] = max(errs["multisweep_rel"], r_pairs,
                                     r_plain)
        log(f"  clock8 multisweep q={q} "
            f"{'x'.join(map(str, CLOCK8_CLASSES[0][2]))}, S=64: states vs "
            f"64 phase pairs {e_pairs}, vs plain {e_plain}; sums rel vs "
            f"measure_kernel {r_pairs:.3g}, vs plain {r_plain:.3g}")
        del a, b, ka, kb, pa, pb, qa, qb
    torch.cuda.synchronize()
    if errs["phase"] != 0 or e_states != 0:
        fail(f"an int8 clock kernel's state differs from its plain version "
             f"({errs}, multisweep states {e_states})")
    if max(errs["measure_rel"], errs["multisweep_rel"]) > 1e-12:
        fail(f"an int8 clock kernel's sums differ from the plain version's "
             f"by more than 1e-12 relative ({errs})")
    return errs


def clock8_first_sweep_exact(q: int, beta: float, dev, masked: bool = False
                             ) -> tuple[float, float]:
    """E[m], E[e] per site after one sweep from all-up (every state 0) on
    the int8 clock engine, for its exact float32 arithmetic: the candidate
    offset's distribution over the 2^24 uniforms, ΔE in float32 from the
    float32 table with the field summed in the kernel's order, the
    acceptance #{k : k 2^-24 < expf(-β max(ΔE, 0))} / 2^24 with expf the
    card's (torch.exp on a CUDA tensor, the kernel's function).  Phase a:
    every site sees four 0 neighbours.  Phase b: each b site sees four
    independent a sites (up, down, centre, side), enumerated in order.
    With ``masked`` the masked helical clock kernel's: its float32 table
    (ops/helical_pallas.clock_table) and field order ((up + dn) + left) +
    right, the four a sites independent as well (a b site's neighbours
    idx ± 1, idx ± nx are four distinct a sites at even N)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import tables
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import helical_pallas

    c32, s32 = (helical_pallas.clock_table(q) if masked
                else tables.clock_cos_sin_table(q)).numpy()

    def fsum(v, nb):
        """The float32 field of (T, 4) neighbour states in the kernel's
        order."""
        a, b, c, d = (v[nb[:, k]] for k in range(4))
        return ((a + b) + c) + d if masked else (a + b) + (c + d)
    c64, s64 = tables.clock_sums_table(q).numpy()
    u = np.arange(2 ** 24, dtype=np.float32) * np.float32(2.0 ** -24)
    off = (u * np.float32(q - 1)).astype(np.int32) + 1
    prop = np.bincount(off, minlength=q).astype(np.float64) / 2 ** 24
    neg_beta = np.float32(-beta)

    def accept(hx, hy):
        """(T, q) acceptance of a state-0 site's candidates n = 1 .. q-1
        (column n; column 0 unused) under the float32 fields (T,)."""
        cn, sn = c32[None, 1:], s32[None, 1:]
        de = -((cn - c32[0]) * hx[:, None] + (sn - s32[0]) * hy[:, None])
        arg = neg_beta * np.maximum(de, np.float32(0.0))
        p = torch.exp(torch.from_numpy(arg).to(dev)).double().cpu().numpy()
        acc = np.minimum(np.ceil(p * 2 ** 24), 2 ** 24) / 2 ** 24
        return np.concatenate([np.zeros((len(hx), 1)), acc], axis=1)

    def after(hx, hy):
        """(T, q) distribution of a state-0 site after its phase."""
        move = prop[None, :] * accept(hx, hy)
        move[:, 0] = 1.0 - move[:, 1:].sum(axis=1)
        return move

    zero = np.zeros((1, 4), dtype=np.int64)
    pa = after(fsum(c32, zero), fsum(s32, zero))[0]
    nb = np.array(list(np.ndindex(q, q, q, q)))         # (up, dn, o, side)
    w = np.prod(pa[nb], axis=1)
    hx, hy = fsum(c32, nb), fsum(s32, nb)
    pb = after(hx.astype(np.float32), hy.astype(np.float32))    # (T, q)
    m_a = float(pa @ c64)
    m_b = float(w @ (pb @ c64))
    # Σ over the four bonds of cos(θ_b - θ_n) = c_b c_n + s_b s_n
    bonds = (pb[:, :, None] * (c64[None, :, None] * c64[nb][:, None, :]
                               + s64[None, :, None] * s64[nb][:, None, :])
             ).sum(axis=(1, 2))
    return 0.5 * (m_a + m_b), -0.5 * float(w @ bonds)


def check_first_sweep_clock8(c8p, c8m, rng, dev) -> float:
    """<m>(1), <e>(1) of the int8 clock kernels from all-up against
    :func:`clock8_first_sweep_exact`, over >= 1e10 sites a q (two phase
    launches and measure_kernel a sweep).  Returns the largest |z|."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D

    worst = 0.0
    for q, shape, iters in CLOCK8_FIRST_SWEEP:
        model = Clock2D(nx=2 * shape[2], ny=shape[1], kbt=KBT_CLOCK, q=q)
        per_rep = {"m": [], "e": []}
        base = rng.base_key(2060 + q)
        for it in range(iters):
            a = torch.zeros(shape, dtype=torch.int8, device=dev)
            b = torch.zeros(shape, dtype=torch.int8, device=dev)
            seeds = c8p.phase_seeds(rng.sweep_key(rng.sample_key(base, it),
                                                  1))
            c8p.metropolis_phase(a, b, seeds[0], color=0, q=q,
                                 beta=model.beta)
            c8p.metropolis_phase(b, a, seeds[1], color=1, q=q,
                                 beta=model.beta)
            obs = c8m.measure(model, (a, b))
            per_rep["m"].append(obs["m"])
            per_rep["e"].append(obs["e"])
        worst = max(worst, check_z_sampled(
            f"int8 clock q={q} kbt {KBT_CLOCK} {model.nx}^2", per_rep,
            model.nsites, clock8_first_sweep_exact(q, model.beta, dev)))
    return worst


def run_clock8_classes(main_fn, modules, out_dir, ref, ref_c1000,
                       dev) -> dict:
    """The int8 clock classes through the CLI from all-up: q = 2 at
    1000x1000 x 16, 64 samples, 1000 MCS on the multisweep, against the
    Ising curve at every t within 5 standard errors of the port's mean;
    q = 5 at 2000x2000 x 16 (64 MB of planes, over the multisweep's bound),
    32 samples, 200 MCS on the streamed phase and measure launches, m(1)
    and e(1) against the closed form (sigma from the run's own N·Var) and
    every row finite; --protocol samples at q = 6, 1000x1000, 16 histories
    of 1000 MCS one at a time, the per-t means against the 100-sample
    clock curve (combined sigma).  Returns {label: (launches, wall, rate,
    largest |z|)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_multisweep,
    )

    out = {}
    ms = "clock8_multisweep"
    label = "resident q=2 1000^2 x 16"
    if not clock_multisweep.fits(16, 1000, 500):
        fail("the q=2 class's batch is over the clock multisweep's bound")
    log(f"phase 4i: int8 clock path, {label}, 64 samples, 1000 MCS")
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, "clock8_q2_1000",
        ["--model", "clock", "--q", "2", "--nx", "1000", "--ny", "1000",
         "--kbt", repr(KBT), "--mcs", "1000", "--samples", "64",
         "--replicas", "16"], 1000 * 1000, 64, 1000)
    if "# engine: int8 multisweep (cooperative)" not in head:
        fail(f"int8 clock {label} took another route: {head}")
    z = check_against_reference(table, ref, 1000 * 1000, 64, 1000,
                                range(1, 1001))
    expect_launches(label, launches, {
        ms: {"multisweep": 4 * 16}, "clock8": {"phase": 0},
        "clock8_measure": {"measure": 0}})
    out[label] = (launches, wall, rate, z)
    label = "streamed q=5 2000^2 x 16"
    nrep = 16
    while clock_multisweep.fits(nrep, 2000, 1000):
        nrep *= 2
    samples = 2 * nrep
    log(f"phase 4i: int8 clock path, streamed q=5 2000^2 x {nrep}, "
        f"{samples} samples, 200 MCS")
    nsites = 2000 * 2000
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, "clock8_q5_2000",
        ["--model", "clock", "--q", "5", "--nx", "2000", "--ny", "2000",
         "--kbt", repr(KBT_CLOCK), "--mcs", "200", "--samples",
         str(samples), "--replicas", str(nrep)], nsites, samples, 200)
    if "# engine: phase engine (batched)" not in head:
        fail(f"int8 clock {label} took another route: {head}")
    if (table.shape != (200, 10) or not np.all(np.isfinite(table))
            or not np.all(table[:, 1] == samples)
            or not np.all(table[:, 2] == np.arange(1, 201))):
        fail(f"int8 clock {label}: table {table.shape} is not 200 finite "
             f"rows of Nsample {samples}")
    want = clock8_first_sweep_exact(5, 1.0 / KBT_CLOCK, dev)
    row = table[0]
    z = 0.0
    for name, col, var_col, exact in (("m", 3, 7, want[0]),
                                      ("e", 4, 8, want[1])):
        zk = (row[col] - exact) / math.sqrt(row[var_col]
                                            / (nsites * samples))
        log(f"  t=1 <{name}> port {row[col]:.9f} closed form {exact:.9f} "
            f"z {zk:+.2f}")
        if abs(zk) > SIGMAS:
            fail(f"int8 clock {label} <{name}>(1) is {zk:+.2f} sigma from "
                 "its closed form")
        z = max(z, abs(zk))
    calls = samples // nrep
    expect_launches(label, launches, {
        ms: {"multisweep": 0}, "clock8": {"phase": 2 * calls * 200},
        "clock8_measure": {"measure": calls * 200}})
    out[label] = (launches, wall, rate, z)
    label = "samples q=6 1000^2 x 1"
    log(f"phase 4i: int8 clock path, {label}: --protocol samples, 16 "
        "histories, 1000 MCS")
    launches, wall, rate, z = run_samples_class(
        main_fn, modules, out_dir, "clock8_samples",
        ["--model", "clock", "--q", "6", "--kbt", repr(KBT_CLOCK)],
        ref_c1000, 16, 1000, 6)
    expect_launches(label, launches, {
        ms: {"multisweep": 0}, "clock8": {"phase": 2 * 16 * 1000},
        "clock8_measure": {"measure": 16 * 1000}})
    out[label] = (launches, wall, rate, z)
    return out


def time_clock8(label: str, sites: int, kernel, plain, inputs,
                nbytes: float, ops: float, reps: int,
                plain_reps: int) -> tuple[dict, float]:
    """CUDA-event time of an int8 clock wrapper on clones of ``inputs``
    (the phases update their planes in place) and of its plain version,
    beside the bound; then one call of each on the same inputs: the int8
    outputs' largest absolute difference, the float64 sums' relative one
    (:func:`scaled_err`)."""
    work = [t.clone() for t in inputs]
    ms = cuda_time_ms(lambda: kernel(*work), reps=reps)
    plain_ms = cuda_time_ms(lambda: plain(*inputs), reps=plain_reps,
                            warmup=1)
    got = kernel(*(t.clone() for t in inputs))
    want = plain(*inputs)
    pairs = (list(zip(got, want)) if isinstance(got, tuple)
             else [(got, want)])
    err = 0.0
    for g, w in pairs:
        err = max(err, float(max_abs_err([(g, w)])) if g.dtype == torch.int8
                  else scaled_err(g, w, inputs[0][0].numel() * 2))
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch ({sites / ms * 1e3:.4g} sites/s), "
        f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); vs plain "
        f"{err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def time_clock8_kernels(c8p, c8m, c8ms, rng, dev) -> dict:
    """Each int8 clock kernel at its classes' launches: the phase and the
    measure kernel at 2000^2 x 16, q = 5 (streamed) and 1000^2 x 1, q = 6
    (samples), the multisweep at 1000^2 x 16, q = 2, with S = 64 and 40 (a
    call's 15 launches of 64 sweeps and one of 40); each held against its
    plain version.  Returns {label: (times, err)}."""
    seeds = multispin_keys(rng, 64, 37)
    out = {}
    for q, kbt, shape in CLOCK8_CLASSES[1:]:
        a, b = clock8_state(dev, shape, q, 41 + q)
        sites = a.numel()
        tag = "x".join(map(str, shape))
        kw = dict(color=0, q=q, beta=1.0 / kbt)
        out[f"phase {tag}"] = time_clock8(
            f"clock8 phase kernel {tag}, q={q}", sites,
            lambda x, o: c8p.metropolis_phase(x, o, seeds[0, 0], **kw),
            lambda x, o: c8p.phase_plain(x, o, seeds[0, 0], **kw),
            (a, b), CLOCK8_PHASE_BYTES * sites, sites * clock8_phase_ops(),
            reps=20, plain_reps=1)
        out[f"measure {tag}"] = time_clock8(
            f"clock8 measure kernel {tag}, q={q}", 2 * sites,
            lambda x, o: c8m.measure_sums(x, o, q),
            lambda x, o: c8m.measure_sums_plain(x, o, q), (a, b),
            2 * sites + 24 * shape[0], 2 * sites * OPS_CLOCK8_MEASURE,
            reps=20, plain_reps=1)
        del a, b
    q, kbt, shape = CLOCK8_CLASSES[0]
    a, b = clock8_state(dev, shape, q, 53)
    sites = a.numel()
    for sweeps in (64, 40):
        out[f"multisweep S={sweeps}"] = time_clock8(
            f"clock8 multisweep kernel {'x'.join(map(str, shape))}, q={q}, "
            f"S={sweeps}", 2 * sites * sweeps,
            lambda x, o: c8ms.multisweep_planes(x, o, seeds[:sweeps], q=q,
                                                beta=1.0 / kbt),
            lambda x, o: c8ms.multisweep_plain(x, o, seeds[:sweeps], q=q,
                                               beta=1.0 / kbt),
            (a, b), 2 * 2 * sites + 24 * shape[0] * sweeps,
            2 * sites * sweeps * clock8_phase_ops()
            + sites * sweeps * OPS_CLOCK8_FUSED, reps=5, plain_reps=1)
    return out


def compare_clock8_routes(c8p, c8m, c8ms, rng, dev) -> list[tuple]:
    """ms a sweep of the int8 clock runner's two routes at q = 6, kbt
    0.91, CUDA events, host loop included: one multisweep launch of 64
    sweeps against 64 streamed sweeps (two phase launches and the measure
    kernel each), at CLOCK8_ROUTE_SHAPES.  Returns [(nx, R, bytes,
    multisweep ms, streamed ms)]."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.models.base import (
        CheckerboardState,
    )

    seeds = multispin_keys(rng, 64, 47)
    rows = []
    for nx, nrep in CLOCK8_ROUTE_SHAPES:
        model = Clock2D(nx=nx, ny=nx, kbt=KBT_CLOCK, q=6)
        a, b = clock8_state(dev, (nrep, nx, nx // 2), 6, nx + nrep)

        def resident():
            c8ms.multisweep_planes(a, b, seeds, q=6, beta=model.beta)

        def streamed():
            for j in range(64):
                c8p.sweep_seeded(model, CheckerboardState(a, b), seeds[j])
                c8m.measure_sums(a, b, 6)

        res_ms, str_ms = _route_times(resident, streamed, 64)
        nbytes = nrep * nx * nx
        rows.append((nx, nrep, nbytes, res_ms, str_ms))
        log(f"  clock8 route {nx}^2 x {nrep} ({nbytes / 2 ** 20:.1f} MiB, "
            f"fits {c8ms.fits(nrep, nx, nx // 2)}): multisweep "
            f"{res_ms:.5f} ms/sweep, streamed {str_ms:.5f} ms/sweep, "
            f"streamed/multisweep {str_ms / res_ms:.3f}")
        del a, b
    return rows


def clock8_shares(classes: dict, t8: dict) -> dict[str, float]:
    """Each int8 clock class's kernel time (its launches times the launch
    times measured at its shape) over its wall."""
    def ms(key):
        return t8[key][0]["ms"]

    shares = {}
    for label, (n, wall, _, _) in classes.items():
        ph = n["clock8"]["phase"]
        me = n["clock8_measure"]["measure"]
        launches = n["clock8_multisweep"]["multisweep"]
        if label.startswith("resident"):
            kern = launches // 16 * (15 * ms("multisweep S=64")
                                     + ms("multisweep S=40"))
        elif label.startswith("streamed"):
            kern = ph * ms("phase 16x2000x1000") + me * ms(
                "measure 16x2000x1000")
        else:
            kern = ph * ms("phase 1x1000x500") + me * ms("measure 1x1000x500")
        shares[label] = kern / (wall * 1e3)
        log(f"  clock8 {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share {shares[label]:.3f}")
    return shares


# ---------------------------------------------------------------------------
# the masked helical kernels: every helical 2-D shape the packed and dense
# engines refuse, and all of them under the JAX package's switches
# (ops/helical_pallas.py)
# ---------------------------------------------------------------------------

CLOCK_501_MASKED = (PRODUCTION
                    / "clock_501x500_kbt0.80_mcs100000_s100_masked.dat")
# the checks' shapes (R, ny, nx): a small even N and a small odd N (both
# seam rows, idx 0 with N-1), replica bases that are not 16-B aligned
# (even and odd N) and N below one vector (the Ising and XY tiles' edge
# paths), then every launch of the main path: each class's, and the
# one-replica launch of --protocol samples (a cooperative grid of fewer
# tiles than resident blocks walks them otherwise)
HP_SMALL = ((3, 32, 33), (3, 31, 33), (3, 30, 35), (5, 31, 35), (2, 2, 3))
HP_ISING_SHAPES = HP_SMALL + ((128, 1000, 1001), (4, 4000, 4001),
                              (16, 1001, 1001), (1, 1000, 1001))
# (q, kbt, (R, ny, nx)): every q at a small shape, then the clock classes'
# launches (q = 6 and 5 at 501x500 x 100, q = 2 at 1001x1000 x 64), the
# samples class's (q = 6 at 501x500 x 1) and phase 4k's (q = 2, 5, 8 at
# 501x500 and 1001x1001 x 2)
HP_CLOCK_QS = (2, 3, 5, 6, 8, 20, 127)
HP_CLOCK_LAUNCHES = ((6, KBT_CLOCK_08, (100, 500, 501)),
                     (2, KBT, (64, 1000, 1001)),
                     (5, KBT_CLOCK_08, (100, 500, 501)),
                     (6, KBT_CLOCK_08, (1, 500, 501)),
                     *((q, KBT_CLOCK_08, (2, ny, nx)) for q in (2, 5, 8)
                       for ny, nx in ((500, 501), (1001, 1001))))
# the XY classes' launches, and phase 4k's --protocol samples at 4001x4001
HP_XY_SHAPES = HP_SMALL + ((1, 10000, 10001), (2, 4001, 4001),
                           (1, 4001, 4001))
# sweeps of a multisweep check (state and sums against the plain version)
# at the small shapes; at a class's launch 1 (the plain version there takes
# ~0.1 s a phase)
HP_CHECK_SWEEPS = 4


def hp_check_sweeps(shape) -> tuple[int, int]:
    """(Philox sweeps, injected sweeps) of a multisweep check."""
    return (HP_CHECK_SWEEPS, HP_CHECK_SWEEPS) if shape in HP_SMALL else (1, 1)
# the timed multisweep launches' sweeps (the plain version of 64 sweeps
# at 1001x1000 x 128 would take seconds; a launch's time is linear in S)
HP_TIMED_SWEEPS = 16
# minimum 32-bit instructions a site of a masked phase beside its share of
# a Philox call (a quarter for Ising, a half for the clock and XY): the
# four neighbour indices (an add, a compare and a select each: 12); Ising
# the sum (3), k = s * nsum and its test (2), the threshold's select and
# compare (2), the flip (2); the clock that of the int8 clock phase
# (OPS_CLOCK8_SITE: 50); XY the uniforms (4), the trig (22), the field's
# adds (6), ΔE, its clamp and scale (8), expf (~10), the test and selects
# (4); XY over-relaxation the field (6), two rsqrtf with their squares
# and clamps (14), the reflection (8), the scaling (2).  The exact sums a
# site: Ising 5, clock 15 (OPS_CLOCK8_MEASURE), XY 6 float64 operations;
# the fused ones a site of colour 1: Ising 4, clock 14, XY 8
OPS_HP_INDEX = 12
OPS_HP_ISING = OPS_HP_INDEX + 9
OPS_HP_XY = OPS_HP_INDEX + 54
OPS_HP_XY_OR = OPS_HP_INDEX + 30


def hp_ising_state(dev, shape, seed: int) -> torch.Tensor:
    nrep, ny, nx = shape
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.integers(0, 2, size=(nrep, ny * nx)) * 2
                             - 1).astype(np.int8)).to(dev)


def hp_clock_state(dev, shape, q: int, seed: int) -> torch.Tensor:
    nrep, ny, nx = shape
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, q, size=(nrep, ny * nx),
                                       dtype=np.int8)).to(dev)


def hp_xy_state(dev, shape, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    nrep, ny, nx = shape
    g = np.random.default_rng(seed)
    th = torch.from_numpy(g.uniform(0, 2 * np.pi, size=(nrep, ny * nx))
                          .astype(np.float32)).to(dev)
    return torch.cos(th).contiguous(), torch.sin(th).contiguous()


def hp_uniforms(dev, shape, seed: int) -> list[torch.Tensor]:
    """Injected uniforms: multiples of 2^-24 in [0, 1), float32."""
    g = np.random.default_rng(seed)
    return [torch.from_numpy((g.integers(0, 2 ** 24, size=shape)
                              * 2.0 ** -24).astype(np.float32)).to(dev)
            for _ in range(2)]


def hp_offset(t: torch.Tensor, elems: int) -> torch.Tensor:
    """t's values in a view starting ``elems`` elements past the 16-B
    aligned start of a larger buffer."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    return buf[elems:].view(t.shape).copy_(t)


def hp_or_off_grid(hp, sx, sy, nx: int) -> float:
    """The over-relaxation phase, colour 1, on planes one float (4 B)
    past the 16-B grid into planes also one float past it (vectors from
    off0 = 1), against the plain version: the largest difference."""
    want = hp.xy_or_phase_plain(sx, sy, color=1, nx=nx)
    got = hp.xy_or_phase(hp_offset(sx, 1), hp_offset(sy, 1), color=1, nx=nx,
                         out=(hp_offset(sx, 1), hp_offset(sy, 1)))
    return float_err(list(zip(got, want)))


def check_helical_pallas(hp, rng, dev) -> dict[str, float]:
    """The masked helical kernels against their plain versions on the same
    CUDA tensors, at even and odd N and at the classes' launches: the
    multisweeps over HP_CHECK_SWEEPS sweeps with injected and Philox
    randomness (states bitwise, Ising sums exactly, clock sums within
    1e-12 of their scale) and against as many one-sweep launches (the
    chunking); the last sweep's sums against the exact sums of the final
    state; the XY phase with injected and Philox uniforms, both colours,
    measuring and not (fused at even N, the measure launch at odd N), the
    OR phase and the measure mode (states bitwise, sums within 1e-12 of
    their scale); then the two multisweeps, the XY phase and the OR
    phase on views that start off the 16-B grid (the OR also at the OR
    class's 10001x10000 x 1).  Returns the largest error a kernel."""
    errs = {"ising": 0.0, "clock": 0.0, "xy_phase": 0.0, "xy_or": 0.0,
            "sums_rel": 0.0}
    seeds = multispin_keys(rng, HP_CHECK_SWEEPS, 91)
    for shape in HP_ISING_SHAPES:
        nrep, ny, nx = shape
        n = ny * nx
        beta = 1.0 / KBT
        S, SI = hp_check_sweeps(shape)
        x = hp_ising_state(dev, shape, n + nrep)
        g = np.random.default_rng(nrep + ny)
        bits = torch.from_numpy(g.integers(
            -2 ** 31, 2 ** 31, size=(SI, 2, nrep, hp.colour_sites(n, 0)),
            dtype=np.int64).astype(np.int32)).to(dev)
        ki, oi = hp.ising_multisweep(x.clone(), beta=beta, nx=nx, bits=bits)
        pi, opi = hp.ising_multisweep_plain(x, beta=beta, nx=nx, bits=bits)
        kr, orr = hp.ising_multisweep(x.clone(), seeds[:S], beta=beta,
                                      nx=nx)
        pr, opr = hp.ising_multisweep_plain(x, seeds[:S], beta=beta, nx=nx)
        one = x.clone()
        for s in range(S):
            hp.ising_multisweep(one, seeds[s:s + 1], beta=beta, nx=nx)
        e_state = max_abs_err([(ki, pi), (kr, pr), (one, kr)])
        e_sums = max_abs_err([(oi, opi), (orr, opr),
                              (orr[:, -1], hp.ising_sums(kr, nx))])
        errs["ising"] = max(errs["ising"], e_state, e_sums)
        log(f"  helical_pallas ising {nrep}x{ny}x{nx} "
            f"({'odd' if n % 2 else 'even'} N), S={S}: states {e_state}, "
            f"sums {e_sums}")
        del x, bits, ki, pi, kr, pr, one
    for q, kbt, shape in ([(q, 0.8, HP_SMALL[k]) for q in HP_CLOCK_QS
                           for k in (0, 1)] + list(HP_CLOCK_LAUNCHES)):
        nrep, ny, nx = shape
        n = ny * nx
        beta = 1.0 / kbt
        S, SI = hp_check_sweeps(shape)
        x = hp_clock_state(dev, shape, q, n + q)
        u = hp_uniforms(dev, (SI, 2, nrep, hp.colour_sites(n, 0)), q + nrep)
        kw = dict(beta=beta, nx=nx, q=q)
        ki, oi = hp.clock_multisweep(x.clone(), u=u, **kw)
        pi, opi = hp.clock_multisweep_plain(x, u=u, **kw)
        kr, orr = hp.clock_multisweep(x.clone(), seeds[:S], **kw)
        pr, opr = hp.clock_multisweep_plain(x, seeds[:S], **kw)
        one = x.clone()
        for s in range(S):
            hp.clock_multisweep(one, seeds[s:s + 1], **kw)
        e_state = max_abs_err([(ki, pi), (kr, pr), (one, kr)])
        rel = max(scaled_err(oi, opi, n), scaled_err(orr, opr, n),
                  scaled_err(orr[:, -1], hp.clock_sums(kr, nx, q), n))
        errs["clock"] = max(errs["clock"], e_state)
        errs["sums_rel"] = max(errs["sums_rel"], rel)
        if shape in HP_SMALL and q != 6:
            continue
        log(f"  helical_pallas clock q={q} {nrep}x{ny}x{nx}, S={S}: states "
            f"{e_state}, sums rel {rel:.3g}")
        del x, u, ki, pi, kr, pr, one
    for shape in HP_XY_SHAPES:
        nrep, ny, nx = shape
        n = ny * nx
        beta = 1.0 / KBT_XY
        sx, sy = hp_xy_state(dev, shape, n + nrep)
        u = hp_uniforms(dev, (nrep, hp.colour_sites(n, 0)), nrep + 5)
        e_ph = e_or = rel = 0.0
        for color in (0, 1):
            key = rng.seeds_from_key(rng.base_key(83 + nrep), color)
            for rand in (tuple(u), key):
                for measuring in (False, True):
                    kw = dict(color=color, nx=nx, beta=beta,
                              measuring=measuring)
                    got = hp.xy_phase(sx, sy, rand, **kw)
                    want = hp.xy_phase_plain(sx, sy, rand, **kw)
                    e_ph = max(e_ph, float_err(list(zip(got[:2],
                                                        want[:2]))))
                    if measuring:
                        rel = max(rel, scaled_err(got[2], want[2], 2 * n))
            got = hp.xy_or_phase(sx, sy, color=color, nx=nx)
            want = hp.xy_or_phase_plain(sx, sy, color=color, nx=nx)
            e_or = max(e_or, float_err(list(zip(got, want))))
        rel = max(rel, scaled_err(hp.xy_measure(sx, sy, nx=nx),
                                  hp.xy_sums(sx, sy, nx), 2 * n))
        errs["xy_phase"] = max(errs["xy_phase"], e_ph)
        errs["xy_or"] = max(errs["xy_or"], e_or)
        errs["sums_rel"] = max(errs["sums_rel"], rel)
        log(f"  helical_pallas xy {nrep}x{ny}x{nx}: phase {e_ph}, or {e_or}, "
            f"sums rel {rel:.3g}")
        del sx, sy, u
    # views that start off the 16-B grid: Ising and the clock at 3 bytes;
    # XY at 1 float, its out planes at 1 (vectors from off0 = 1) and at 0
    # (float by float)
    for shape in HP_SMALL:
        nrep, ny, nx = shape
        n = ny * nx
        x = hp_ising_state(dev, shape, n + 7)
        ki, oi = hp.ising_multisweep(hp_offset(x, 3), seeds[:2],
                                     beta=1.0 / KBT, nx=nx)
        pi, opi = hp.ising_multisweep_plain(x, seeds[:2], beta=1.0 / KBT,
                                            nx=nx)
        e_i = max_abs_err([(ki, pi), (oi, opi)])
        xc = hp_clock_state(dev, shape, 6, n + 11)
        kw = dict(beta=1.0 / KBT_CLOCK_08, nx=nx, q=6)
        kc, oc = hp.clock_multisweep(hp_offset(xc, 3), seeds[:2], **kw)
        pc, opc = hp.clock_multisweep_plain(xc, seeds[:2], **kw)
        e_c = max_abs_err([(kc, pc)])
        rel_c = scaled_err(oc, opc, n)
        sx, sy = hp_xy_state(dev, shape, n + 9)
        key = rng.seeds_from_key(rng.base_key(87), 1)
        kw = dict(color=1, nx=nx, beta=1.0 / KBT_XY, measuring=True)
        want = hp.xy_phase_plain(sx, sy, key, **kw)
        e_x = rel = 0.0
        for off in (1, 0):
            got = hp.xy_phase(hp_offset(sx, 1), hp_offset(sy, 1), key,
                              out=(hp_offset(sx, off), hp_offset(sy, off)),
                              **kw)
            e_x = max(e_x, float_err(list(zip(got[:2], want[:2]))))
            rel = max(rel, scaled_err(got[2], want[2], 2 * n))
        e_o = hp_or_off_grid(hp, sx, sy, nx)
        errs["ising"] = max(errs["ising"], e_i)
        errs["clock"] = max(errs["clock"], e_c)
        errs["xy_phase"] = max(errs["xy_phase"], e_x)
        errs["xy_or"] = max(errs["xy_or"], e_o)
        errs["sums_rel"] = max(errs["sums_rel"], rel, rel_c)
        log(f"  helical_pallas {nrep}x{ny}x{nx} off the 16-B grid: ising "
            f"{e_i}, clock {e_c} (sums rel {rel_c:.3g}), xy phase {e_x}, "
            f"or {e_o}, sums rel {rel:.3g}")
    # the over-relaxation at the OR class's launch, every plane 4 B past
    # the 16-B grid
    sx, sy = hp_xy_state(dev, (1, HY, HX), 95)
    e_o = hp_or_off_grid(hp, sx, sy, HX)
    errs["xy_or"] = max(errs["xy_or"], e_o)
    log(f"  helical_pallas xy or 1x{HY}x{HX} off the 16-B grid: {e_o}")
    del sx, sy
    torch.cuda.synchronize()
    if max(errs["ising"], errs["clock"], errs["xy_phase"], errs["xy_or"]):
        fail(f"a masked helical kernel differs from its plain version "
             f"({errs})")
    if errs["sums_rel"] > 1e-12:
        fail(f"a masked helical kernel's float64 sums differ from the plain "
             f"version's by more than 1e-12 of their scale ({errs})")
    return errs


@contextlib.contextmanager
def hp_env(name: str | None, value: str = "0"):
    """One JAX switch set to ``value`` for the block (None: none)."""
    if name:
        os.environ[name] = value
    try:
        yield
    finally:
        if name:
            os.environ.pop(name, None)


def hp_class(main_fn, modules, out_dir, label, argv, switch, nsites,
             samples, mcs, engine, want):
    """One masked helical class through the CLI (``switch`` set to 0 where
    the packed or dense engine would take the shape); its engine and its
    masked kernels' launches.  Returns (launches, wall, rate, table)."""
    with hp_env(switch):
        launches, wall, rate, table, head = run_main_path(
            main_fn, modules, out_dir, label, argv, nsites, samples, mcs)
    if f"# engine: {engine}" not in head:
        fail(f"masked helical {label} took another route: {head}")
    got = {k: launches["helical_pallas"][k] for k in want}
    if got != want:
        fail(f"masked helical {label} launched {got}, want {want}")
    for other in ("helical", "clock_helical", "xy_helical",
                  "xy_helical_angle"):
        if any(launches[other].values()):
            fail(f"masked helical {label} launched {other}: "
                 f"{launches[other]}")
    return launches, wall, rate, table


def run_hp_classes(main_fn, modules, out_dir, ref, ref_c501, ref_c501m,
                   ref_xyh_or, ref_xy, dev) -> dict:
    """The masked helical classes through the CLI from all-up: Ising at
    the reference's 1001x1000 (SPINLAT_HELICAL_PACKED=0), past the packed
    bound (4001x4000) and at odd ny (1001x1001, printed: the seam's
    Jacobi pairs); the clock at q = 6 on 501x500 (SPINLAT_CLOCK_HELICAL_
    PACKED=0) against both 100-sample curves, q = 2 at 1001x1000 against
    the Ising curve, q = 5 at 501x500 against the first-sweep closed form;
    XY with over-relaxation at 10001x10000 (SPINLAT_XY_DENSE=0) and at odd
    ny, 4001x4001 (printed); --protocol samples on helical Ising 1001x1000
    and the helical clock q = 6 at 501x500.  Returns {label: (launches,
    wall, rate, largest |z|)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep

    out = {}
    ising = ["--model", "ising2d", "--kbt", repr(KBT)]
    for label, nx, ny, nrep, samples, mcs, switch, gate in (
            ("ising 1001x1000 x 128", 1001, 1000, 128, 128, 1000,
             "SPINLAT_HELICAL_PACKED", True),
            ("ising 4001x4000 x 4", 4001, 4000, 4, 4, 200, None, True),
            ("ising 1001x1001 x 16", 1001, 1001, 16, 16, 200, None, False)):
        log(f"phase 4j: masked helical path, {label}, {samples} samples, "
            f"{mcs} MCS")
        n, wall, rate, table = hp_class(
            main_fn, modules, out_dir, label.replace(" ", "_"),
            ising + ["--nx", str(nx), "--ny", str(ny), "--mcs", str(mcs),
                     "--samples", str(samples), "--replicas", str(nrep)],
            switch, nx * ny, samples, mcs, sweep.MASKED_ISING,
            {"ising_multisweep": samples // nrep * -(-mcs // 64)})
        if gate:
            z = check_against_reference(
                table, ref, nx * ny, samples, mcs, range(1, mcs + 1),
                ref_nsites=int(ref[0, 0]), ref_samples=int(ref[0, 1]))
        else:
            z = hp_printed_z(table, ref, nx * ny, samples, mcs)
        out[label] = (n, wall, rate, z)
    clock = ["--model", "clock", "--kbt"]
    label = "clock q=6 501x500 x 100"
    log(f"phase 4j: masked helical path, {label}, 100 samples, 1000 MCS")
    n, wall, rate, table = hp_class(
        main_fn, modules, out_dir, "clock_q6_501",
        clock + [repr(KBT_CLOCK_08), "--q", "6", "--nx", "501", "--ny",
                 "500", "--mcs", "1000", "--samples", "100", "--replicas",
                 "100"], "SPINLAT_CLOCK_HELICAL_PACKED", 501 * 500, 100,
        1000, sweep.MASKED_CLOCK, {"clock_multisweep": 16})
    # the committed 100-sample curve and the masked kernel's own are one
    # file byte for byte (both runs.log entries: seed 42, 100 replicas)
    if not np.array_equal(ref_c501, ref_c501m):
        fail("the two 100-sample 501x500 clock curves differ")
    log("  the 100-sample curve and the masked kernel's are equal, row for "
        "row: one check holds both")
    z = check_against_reference(table, ref_c501, 501 * 500, 100, 1000,
                                range(1, 1001),
                                ref_nsites=int(ref_c501[0, 0]),
                                ref_samples=int(ref_c501[0, 1]))
    out[label] = (n, wall, rate, z)
    label = "clock q=2 1001x1000 x 64"
    log(f"phase 4j: masked helical path, {label}, 64 samples, 200 MCS")
    n, wall, rate, table = hp_class(
        main_fn, modules, out_dir, "clock_q2_1001",
        clock + [repr(KBT), "--q", "2", "--nx", "1001", "--ny", "1000",
                 "--mcs", "200", "--samples", "64", "--replicas", "64"],
        None, 1001 * 1000, 64, 200, sweep.MASKED_CLOCK,
        {"clock_multisweep": 4})
    z = check_against_reference(table, ref, 1001 * 1000, 64, 200,
                                range(1, 201), ref_nsites=int(ref[0, 0]),
                                ref_samples=int(ref[0, 1]))
    out[label] = (n, wall, rate, z)
    label = "clock q=5 501x500 x 100"
    log(f"phase 4j: masked helical path, {label}, 100 samples, 200 MCS")
    n, wall, rate, table = hp_class(
        main_fn, modules, out_dir, "clock_q5_501",
        clock + [repr(KBT_CLOCK_08), "--q", "5", "--nx", "501", "--ny",
                 "500", "--mcs", "200", "--samples", "100", "--replicas",
                 "100"], None, 501 * 500, 100, 200, sweep.MASKED_CLOCK,
        {"clock_multisweep": 4})
    if table.shape != (200, 10) or not np.all(np.isfinite(table)):
        fail(f"masked clock {label}: table {table.shape} not 200 finite "
             "rows")
    want = clock8_first_sweep_exact(5, 1.0 / KBT_CLOCK_08, dev,
                                    masked=True)
    z = 0.0
    for name, col, var_col, exact in (("m", 3, 7, want[0]),
                                      ("e", 4, 8, want[1])):
        zk = (table[0, col] - exact) / math.sqrt(table[0, var_col]
                                                 / (501 * 500 * 100))
        log(f"  t=1 <{name}> port {table[0, col]:.9f} closed form "
            f"{exact:.9f} z {zk:+.2f}")
        if abs(zk) > SIGMAS:
            fail(f"masked clock {label} <{name}>(1) is {zk:+.2f} sigma from "
                 "its closed form")
        z = max(z, abs(zk))
    out[label] = (n, wall, rate, z)
    for label, nx, ny, nrep, samples, mcs, kbt, n_or, switch, ref_t, want in (
            ("xy or 10001x10000 x 1", HX, HY, 1, 2, 200, KBT_XY, 1,
             "SPINLAT_XY_DENSE", ref_xyh_or,
             {"xy_phase": 800, "xy_or": 800, "xy_measure": 400,
              "xy_phase_measuring": 0}),
            ("xy 4001x4001 x 2", 4001, 4001, 2, 2, 100, KBT_XY_2000, 0,
             None, ref_xy,
             {"xy_phase": 200, "xy_or": 0, "xy_measure": 100,
              "xy_phase_measuring": 0})):
        log(f"phase 4j: masked helical path, {label}, {samples} samples, "
            f"{mcs} MCS")
        argv = ["--model", "xy2d", "--nx", str(nx), "--ny", str(ny),
                "--kbt", repr(kbt), "--mcs", str(mcs), "--samples",
                str(samples), "--replicas", str(nrep)]
        if n_or:
            argv += ["--n-over-relax", str(n_or)]
        n, wall, rate, table = hp_class(
            main_fn, modules, out_dir, label.replace(" ", "_"), argv, switch,
            nx * ny, samples, mcs, sweep.MASKED_XY, want)
        if n_or:
            z = check_against_reference(
                table, ref_t, nx * ny, samples, mcs, range(1, mcs + 1),
                ref_nsites=int(ref_t[0, 0]), ref_samples=int(ref_t[0, 1]))
        else:
            z = hp_printed_z(table, ref_t, nx * ny, samples, mcs)
        out[label] = (n, wall, rate, z)
    for label, argv, shape, ref_t, ncols in (
            ("samples ising 1001x1000", ["--model", "ising2d", "--kbt",
                                         repr(KBT)], (1001, 1000), ref, 5),
            ("samples clock q=6 501x500", ["--model", "clock", "--q", "6",
                                           "--kbt", repr(KBT_CLOCK_08)],
             (501, 500), ref_c501, 6)):
        log(f"phase 4j: masked helical path, {label}: --protocol samples, "
            "16 histories, 200 MCS")
        n, wall, rate, z = run_samples_class(
            main_fn, modules, out_dir, label.replace(" ", "_"), argv, ref_t,
            16, 200, ncols, shape)
        key = "clock_multisweep" if "clock" in label else "ising_multisweep"
        if n["helical_pallas"][key] != 16 * 4:
            fail(f"masked helical {label} launched {n['helical_pallas']}")
        out[label] = (n, wall, rate, z)
    run_hp_routes(main_fn, modules, out_dir)
    return out


# (argv, nsites, rows, masked kernel counter or None) of the short CLI runs
# of phase 4k: every helical shape the masked kernels took over runs to a
# .dat (each launch count is checked above, on its class)
HP_ROUTES = tuple(
    [(["--model", "clock", "--q", str(q), "--nx", str(nx), "--ny",
       str(ny), "--kbt", repr(KBT_CLOCK_08), "--mcs", "5", "--samples",
       "2", "--replicas", "2"], nx * ny, 5, "clock_multisweep")
     for q in (2, 5, 8) for nx, ny in ((501, 500), (1001, 1001))]
    + [(["--protocol", "samples", "--model", "xy2d", "--nx", "4001",
         "--ny", "4001", "--kbt", repr(KBT_XY_2000), "--mcs", "5",
         "--samples", "2"], 4001 * 4001, 10, "xy_measure"),
       (["--protocol", "samples", "--model", "ising3d", "--nx", "151",
         "--ny", "151", "--nz", "150", "--kbt", repr(KBT_H3), "--mcs", "5",
         "--samples", "2"], 151 * 151 * 150, 10, None)])


def run_hp_routes(main_fn, modules, out_dir) -> None:
    """Phase 4k: the helical clock at q = 2, 5, 8 on 501x500 and 1001x1001,
    --protocol samples on helical XY at 4001x4001 and on helical 3-D at
    151x151x150, each a short CLI run from all-up: a .dat of finite rows,
    the masked kernel launched (2-D)."""
    for k, (argv, nsites, nrows, counter) in enumerate(HP_ROUTES):
        log(f"phase 4k: {' '.join(argv)}")
        n, _, _, table, _ = run_main_path(main_fn, modules, out_dir,
                                          f"hp_route_{k}", argv, nsites,
                                          2, 5)
        if table.shape[0] != nrows or not np.all(np.isfinite(table)):
            fail(f"phase 4k: {argv} wrote {table.shape} or non-finite rows")
        if counter is not None and n["helical_pallas"][counter] == 0:
            fail(f"phase 4k: {argv} launched no masked kernel")


def hp_printed_z(table, ref, nsites: int, samples: int, mcs: int) -> float:
    """The largest |z| of <m>(t), <e>(t) at every t <= mcs against a curve
    of another geometry, combined sigma, printed and not gated (an odd-ny
    lattice's seam rows take Jacobi pairs)."""
    if table.shape != (mcs, 10) or not np.all(np.isfinite(table)):
        fail(f"table shape {table.shape} or non-finite")
    worst = 0.0
    ref_term = 1.0 / (ref[0, 0] * ref[0, 1])
    for t in range(1, mcs + 1):
        row, rrow = row_at(table, t), row_at(ref, t)
        for col, var_col in ((3, 7), (4, 8)):
            sigma = math.sqrt(rrow[var_col]
                              * (1.0 / (nsites * samples) + ref_term))
            worst = max(worst, abs(row[col] - rrow[col]) / sigma)
    log(f"  largest |z| {worst:.2f} over {mcs} times (printed, not gated)")
    return worst


def time_hp_kernels(hp, rng, dev) -> dict:
    """Each masked kernel at its classes' launch, held against its plain
    version: the Ising multisweep at 1001x1000 x 128 and the clock one at
    501x500 x 100, q = 6, both with S = HP_TIMED_SWEEPS; the XY phase at
    10001x10000 x 1, colour 0 and colour 1 fused, the OR phase and the
    measure mode; the clock multisweep's wrapper and launch alone in
    turns, logged.  Returns {label: (times, err)}."""
    S = HP_TIMED_SWEEPS
    seeds = multispin_keys(rng, S, 93)
    out = {}
    nrep, ny, nx = 128, 1000, 1001
    n = ny * nx
    x = hp_ising_state(dev, (nrep, ny, nx), 7)
    sites = nrep * n
    out["ising"] = time_hp_ms(
        f"helical_pallas ising multisweep 1001x1000 x 128, S={S}",
        sites * S,
        lambda v: hp.ising_multisweep(v, seeds, beta=1.0 / KBT, nx=nx),
        lambda v: hp.ising_multisweep_plain(v, seeds, beta=1.0 / KBT,
                                            nx=nx), (x,),
        2 * sites + 16 * nrep * S,
        sites * S * (OPS_PER_PHILOX / 4 + OPS_HP_ISING) + sites * S * 2,
        reps=5, plain_reps=1)
    del x
    nrep, ny, nx = 100, 500, 501
    n = ny * nx
    x = hp_clock_state(dev, (nrep, ny, nx), 6, 8)
    sites = nrep * n
    kw = dict(beta=1.0 / KBT_CLOCK_08, nx=nx, q=6)
    out["clock"] = time_hp_ms(
        f"helical_pallas clock multisweep 501x500 x 100, q=6, S={S}",
        sites * S, lambda v: hp.clock_multisweep(v, seeds, **kw),
        lambda v: hp.clock_multisweep_plain(v, seeds, **kw), (x,),
        2 * sites + 24 * nrep * S,
        sites * S * (OPS_PER_PHILOX / 2 + OPS_HP_INDEX + OPS_CLOCK8_SITE)
        + sites * S * OPS_CLOCK8_FUSED // 2, reps=5, plain_reps=1)
    # the launch alone: the C entry on keys, tables and scratch already on
    # the card
    lib, keys = hp._lib(), multispin_keys_on(seeds, dev)
    tab = hp._device_table(6, str(dev), torch.float32)
    tab64 = hp._device_table(6, str(dev), torch.float64)
    g = hp.ising_tiles(nrep, n, nx, x.data_ptr())
    part = torch.empty((nrep, S, g["tpr"], 3), dtype=torch.float64,
                       device=dev)
    obs = torch.empty((nrep, S, 3), dtype=torch.float64, device=dev)

    def alone():
        code = lib.hp_clock_multisweep(
            x.data_ptr(), None, keys.data_ptr(), None, None, tab.data_ptr(),
            tab64.data_ptr(), part.data_ptr(), obs.data_ptr(), nrep, n, nx, 6,
            S, -1.0 / KBT_CLOCK_08, g["off0"], g["tpr"],
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"masked clock multisweep launch alone: code {code}")
    wrap, just = wrapper_and_alone(
        lambda: hp.clock_multisweep(x, seeds, **kw), alone)
    log(f"  helical_pallas clock multisweep 501x500 x 100, q=6, S={S}, in "
        f"turns: the wrapper {wrap}, the launch alone {just} ms")
    del x
    n = HX * HY
    sx, sy = hp_xy_state(dev, (1, HY, HX), 9)
    out_planes = (torch.empty_like(sx), torch.empty_like(sy))
    half = n // 2
    ph_ops = half * (OPS_PER_PHILOX / 2 + OPS_HP_XY)
    for label, color, measuring in (("phase", 0, False),
                                    ("phase, measuring", 1, True)):
        kw = dict(color=color, nx=HX, beta=1.0 / KBT_XY, measuring=measuring)
        out[f"xy {label}"] = time_xy_out(
            f"helical_pallas xy phase 10001x10000 x 1, colour {color}"
            + (", fused sums" if measuring else ""),
            lambda: hp.xy_phase(sx, sy, seeds[0, color], out=out_planes,
                                **kw),
            lambda: hp.xy_phase_plain(sx, sy, seeds[0, color], **kw),
            16 * n + (24 if measuring else 0),
            ph_ops + (n * 4 if measuring else 0), n)
    out["xy or"] = time_xy_out(
        "helical_pallas xy or 10001x10000 x 1, colour 0",
        lambda: hp.xy_or_phase(sx, sy, color=0, nx=HX, out=out_planes),
        lambda: hp.xy_or_phase_plain(sx, sy, color=0, nx=HX), 16 * n,
        half * OPS_HP_XY_OR, n)
    out["xy measure"] = time_xy_out(
        "helical_pallas xy phase kernel, measure mode, 10001x10000 x 1",
        lambda: (hp.xy_measure(sx, sy, nx=HX),),
        lambda: (hp.xy_sums(sx, sy, HX),), 8 * n + 24, n * 6 + n * 4, n)
    return out


def time_hp_ms(label: str, flips: int, kernel, plain, inputs,
               nbytes: float, ops: float, reps: int,
               plain_reps: int) -> tuple[dict, float]:
    """CUDA-event time of a masked multisweep wrapper on a clone of the
    state (it updates it in place) and of its plain version, beside the
    bound; then one call of each on the same state: the largest difference
    of the states and of the int64 sums, or the float64 sums' relative to
    their scale (:func:`scaled_err`)."""
    last = {}
    work = [t.clone() for t in inputs]
    ms = cuda_time_ms(lambda: kernel(*work), reps=reps)
    plain_ms = cuda_time_ms(lambda: last.__setitem__("plain", plain(*inputs)),
                            reps=plain_reps, warmup=plain_reps - 1)
    got, want = kernel(*(t.clone() for t in inputs)), last["plain"]
    err = float(max_abs_err([(got[0], want[0])]))
    err = max(err, float(max_abs_err([(got[1], want[1])]))
              if got[1].dtype == torch.int64
              else scaled_err(got[1], want[1], inputs[0][0].numel()))
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch ({flips / ms * 1e3:.4g} flip "
        f"attempts/s), plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); "
        f"vs plain {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def time_xy_out(label: str, kernel, plain, nbytes: float, ops: float,
                n: int) -> tuple[dict, float]:
    """CUDA-event time of an out-of-place XY wrapper (its inputs are not
    changed) and of its plain version, beside the bound; then the largest
    difference of their outputs: float32 planes absolute, float64 sums
    relative to their scale."""
    last = {}
    ms = cuda_time_ms(lambda: last.__setitem__("kernel", kernel()), reps=20)
    plain_ms = cuda_time_ms(lambda: last.__setitem__("plain", plain()),
                            reps=1, warmup=0)
    got, want = last["kernel"], last["plain"]
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, scaled_err(g, w, 2 * n) if g.dtype == torch.float64
                  else float_err([(g, w)]))
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch ({n / 2 / ms * 1e3:.4g} site "
        f"updates/s), plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); "
        f"vs plain {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def hp_shares(classes: dict, th: dict) -> dict[str, float]:
    """Each masked class's kernel time (its launches times the launch times
    measured at the timed shapes, scaled by sites and sweeps) over its
    wall."""
    shares = {}
    ms_ising = th["ising"][0]["ms"] / (HP_TIMED_SWEEPS * 128 * 1001 * 1000)
    ms_clock = th["clock"][0]["ms"] / (HP_TIMED_SWEEPS * 100 * 501 * 500)
    xy = {k: th[f"xy {k}"][0]["ms"] / (HX * HY)
          for k in ("phase", "phase, measuring", "or", "measure")}
    for label, (n, wall, rate, _) in classes.items():
        k = n["helical_pallas"]
        site_sweeps = rate * wall
        if "xy" in label:
            nsites = site_sweeps / (k["xy_measure"]
                                    + k["xy_phase_measuring"])
            kern = nsites * ((k["xy_phase"]) * xy["phase"]
                             + k["xy_phase_measuring"]
                             * xy["phase, measuring"]
                             + k["xy_or"] * xy["or"]
                             + k["xy_measure"] * xy["measure"])
        elif "clock" in label:
            kern = site_sweeps * ms_clock
        else:
            kern = site_sweeps * ms_ising
        shares[label] = kern / (wall * 1e3)
        log(f"  masked {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share {shares[label]:.3f}")
    return shares


# ---------------------------------------------------------------------------
# the periodic XY angle engines: f32 angles (ops/xy2d_pallas_angle.py, the
# JAX switch SPINLAT_XY_PERIODIC_ANGLE=1) and int16 angles
# (ops/xy2d_multisweep.py, SPINLAT_XY_ANGLE_MS=1)
# ---------------------------------------------------------------------------

# (R, ny, nx, kbt) of the angle kernels' checks: a small shape whose half
# (100) fills no whole warp, then every class's launch: the literal
# 10000^2 x 1, the A/B 2000^2 x 32, the OR 4000^2 x 8, the finite-magne
# 1000^2 x 20
XYA_SHAPES = ((2, 256, 200, KBT_XY), (1, 10000, 10000, KBT_XY_2000),
              (32, 2000, 2000, KBT_XY_2000), (8, 4000, 4000, KBT_XY),
              (20, 1000, 1000, KBT_XY))
# (R, ny, nx) of angle_or_kernel's ragged checks: half 65 and 31 (not a
# multiple of the tile's 32 columns), rows past a tile, ny = 2, half 1
XYA_OR_RAGGED = ((3, 70, 130), (2, 34, 62), (2, 2, 2))
# ((R, ny, nx), S, n_or, or_only, grid) of the int16 multisweep's checks: a
# small shape in every mode, also forced to the device-memory mode; the
# from-disorder class's launches (1000 MCS: 15 launches of 64 and one of
# 40; the shared-memory mode), with an OR sweep and forced to the
# device-memory mode; past the shared-memory fit, the x2 class's last
# launch, x 2 with an OR sweep and OR only (the measure folded into the
# last OR phase b), x 3 (part of the held chunks decoded), x 32 (one ring
# a replica would not fit: two rings of 66 blocks, 16 replicas each in
# turn) and 64x64 x 1600 (more replicas than block slots: rings of one)
XYI_CHECKS = (((2, 32, 48), 4, 0, False, False),
              ((2, 32, 48), 4, 1, False, False),
              ((2, 32, 48), 4, 2, True, False),
              ((2, 32, 48), 4, 1, False, True),
              ((1, 1536, 1536), 64, 0, False, False),
              ((1, 1536, 1536), 40, 0, False, False),
              ((1, 1536, 1536), 16, 1, False, False),
              ((1, 1536, 1536), 8, 0, False, True),
              ((2, 1536, 1536), 8, 0, False, False),
              ((2, 1536, 1536), 4, 1, False, False),
              ((2, 1536, 1536), 4, 2, True, False),
              ((3, 1536, 1536), 8, 0, False, False),
              ((32, 1536, 1536), 2, 0, False, False),
              ((1600, 64, 64), 4, 1, False, False))
XYI_N = 1536
# per site of the colour updated: the snapshot mode's A, two decodes of
# the differences (22 each), their subtracts, widenings and adds (5); its
# bytes, both colours' snapshot angles (8 B).  The int16 multisweep, per
# site of a colour and sweep: two Metropolis phases (OPS_XYA_METROPOLIS
# each, the 16-bit candidate as cheap as the angle's subtract), phase b's
# fused sums (the A terms' two decodes and the sums: 54); an OR phase
# (one decode, the field, the A&S atan2 with its divide ~33, the rounding
# and the reflection 3: 64) and the measure pass (a decode, the field and
# the sums: 82)
OPS_XYA_SNAP = 2 * 22 + 5
XYA_SNAP_BYTES_PER_SITE = 8
OPS_XYI_FUSED = 2 * 22 + 10
OPS_XYI_OR = 22 + 6 + 33 + 3
OPS_XYI_MEASURE = 22 + 6 + OPS_XYI_FUSED


def angle_planes(dev, nrep: int, ny: int, nx: int, seed: int) -> list:
    """Four random (R, ny, nx/2) float32 angle planes in turns."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.rand((nrep, ny, nx // 2), generator=gen, device=dev) - 0.5
            for _ in range(4)]


def xya_pair(xya, planes, color, kind, rand, beta, snap_mode, measuring):
    """One angle phase through the kernel and its plain version, each on
    its own copy of the colour updated.  Returns (state error, sums'
    error against their scale or 0)."""
    a, b, sa, sb = planes
    s, o = (a, b) if color == 0 else (b, a)
    snap = ((sa, sb) if color == 0 else (sb, sa)) if snap_mode else None
    ks, ps = s.clone(), s.clone()
    if kind == "metro":
        kw = dict(color=color, beta=beta, measuring=measuring, snap=snap)
        got = xya.metro_phase(ks, o, rand, **kw)
        want = xya.metro_phase_plain(ps, o, rand, **kw)
    else:
        got = xya.or_phase(ks, o, color=color, measuring=measuring)
        want = xya.or_phase_plain(ps, o, color=color, measuring=measuring)
    err = float_err([(ks, ps)])
    if not isinstance(want, tuple):
        return err, 0.0
    return err, scaled_err(got[1], want[1], 2 * s[0].numel())


def check_xy_angle(xya, rng, dev) -> tuple[float, float]:
    """angle_metro_kernel (Philox: plain, measuring and the snapshot mode;
    injected uniforms at the small shape) and angle_or_kernel (plain and
    measuring) against their plain versions on the same CUDA tensors, both
    colours, at XYA_SHAPES: the state bitwise, the float64 sums within
    1e-12 of their scale.  Returns (state error, sums' error)."""
    t0 = time.perf_counter()
    err = rel = 0.0
    for nrep, ny, nx, kbt in XYA_SHAPES:
        planes = angle_planes(dev, nrep, ny, nx, nx + ny + nrep)
        g = np.random.default_rng(ny)
        u = tuple(torch.from_numpy(g.random((nrep, ny, nx // 2),
                                            dtype=np.float32)).to(dev)
                  for _ in range(2))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.base_key(40 + ny), color)
            runs = [("metro", seeds, False, False),
                    ("metro", seeds, False, True),
                    ("metro", seeds, True, False),
                    ("or", None, False, False), ("or", None, False, True)]
            if nrep * ny * nx < 1e6:
                runs += [("metro", u, False, True), ("metro", u, True, False)]
            for kind, rand, snap_mode, measuring in runs:
                e, r = xya_pair(xya, planes, color, kind, rand, 1.0 / kbt,
                                snap_mode, measuring)
                err, rel = max(err, e), max(rel, r)
        del planes, u
    for nrep, ny, nx in XYA_OR_RAGGED:
        planes = angle_planes(dev, nrep, ny, nx, nx + ny + nrep)
        for color in (0, 1):
            for measuring in (False, True):
                e, r = xya_pair(xya, planes, color, "or", None, 0.0, False,
                                measuring)
                err, rel = max(err, e), max(rel, r)
    log(f"  xy angle kernels at {[s[:3] for s in XYA_SHAPES]}, the OR "
        f"also at {XYA_OR_RAGGED}: state vs plain {err}, sums {rel:.3g} "
        f"of their scale ({time.perf_counter() - t0:.1f} s)")
    if err != 0.0 or rel > 1e-12:
        fail(f"an XY angle kernel differs from its plain version: state "
             f"{err}, sums {rel:.3g}")
    return err, rel


def int16_planes(dev, shape, seed: int) -> list:
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(-2 ** 15, 2 ** 15, size=shape)
                             .astype(np.int16)).to(dev) for _ in range(4)]


def check_xy_int16(xyi, rng, dev) -> tuple[float, float]:
    """The int16 multisweep against its plain version on the same CUDA
    tensors at XYI_CHECKS (Philox words), in the mode its fit rule picks
    (or the device-memory mode, forced): the int16 state bitwise, the sums
    within 1e-12 of their scale.  Returns (state error, sums' error)."""
    t0 = time.perf_counter()
    err = rel = 0.0
    for shape, sweeps, n_or, or_only, grid in XYI_CHECKS:
        nrep, ny, nx = shape
        pa, pb, sa, sb = int16_planes(dev, (nrep, ny, nx // 2), ny + n_or)
        seeds = multispin_keys(rng, sweeps, 50 + sweeps)
        kw = dict(beta=1.0 / KBT_XY, n_or=n_or, or_only=or_only)
        ka, kb, qa, qb = pa.clone(), pb.clone(), pa.clone(), pb.clone()
        smem = not grid and xyi.device_layout(pa) is not None
        xyi.reset_launches()
        got = xyi.multisweep_planes(ka, kb, sa, sb, seeds, grid=grid, **kw)
        if xyi.LAUNCHES != {"multisweep": int(not smem),
                            "multisweep_smem": int(smem)}:
            fail(f"int16 multisweep at {shape} launched {xyi.LAUNCHES}")
        want = xyi.multisweep_plain(qa, qb, sa, sb, seeds, **kw)
        err = max(err, max_abs_err([(ka, qa), (kb, qb)]))
        rel = max(rel, scaled_err(got, want, ny * nx))
    log(f"  xy int16 multisweep at {XYI_CHECKS}: state vs plain {err}, "
        f"sums {rel:.3g} of their scale ({time.perf_counter() - t0:.1f} s)")
    if err != 0 or rel > 1e-12:
        fail(f"the int16 XY multisweep differs from its plain version: "
             f"state {err}, sums {rel:.3g}")
    return float(err), rel


def extended_var(ref: np.ndarray, mcs: int) -> np.ndarray:
    """The 2000x2000 curve's rows with their N·Var(m), N·Var(e) columns
    (7, 8) carried past its last t (100) to ``mcs`` by a power law in t
    fitted on t in [50, 100] of the same columns (N·Var grows with the
    correlation length); only those columns and t are used."""
    last = int(ref[-1, 2])
    ts = np.arange(last + 1, mcs + 1, dtype=np.float64)
    fit = ref[ref[:, 2] >= 50]
    extra = np.repeat(ref[-1:], len(ts), axis=0)
    extra[:, 2] = ts
    for col in (7, 8):
        slope, icpt = np.polyfit(np.log(fit[:, 2]), np.log(fit[:, col]), 1)
        extra[:, col] = np.exp(icpt + slope * np.log(ts))
        log(f"  N·Var column {col} carried past t = {last} as t^{slope:.3f}: "
            f"{extra[-1, col]:.4g} at t = {mcs} ({ref[-1, col]:.4g} at "
            f"t = {last})")
    return np.concatenate([ref, extra])


# (name, mean column, variance column or function) of the from-disorder
# table (N, Nsample, t, <|m|>, <e>, <m^2>, <e^2>, <|m|e>, ..., <A>, <A^2>,
# <mx>, <my>, <mx^2>, <my^2>, <mx*my>)
def m2_var(r: np.ndarray) -> float:
    """Var(m^2) of one sample, m = (mx, my) taken Gaussian (a sum of many
    independent blocks while xi << L) with the row's means and second
    moments: Var(mx^2) + Var(my^2) + 2 Cov(mx^2, my^2)."""
    mx, my = r[11], r[12]
    vx, vy = r[13] - mx ** 2, r[14] - my ** 2
    c = r[15] - mx * my
    return (2 * vx ** 2 + 4 * mx ** 2 * vx + 2 * vy ** 2 + 4 * my ** 2 * vy
            + 2 * (2 * c ** 2 + 4 * mx * my * c))


def check_size_free(table: np.ndarray, ref: np.ndarray, nsites: int,
                    samples: int, mcs: int, label: str) -> float:
    """A from-disorder table of one geometry against the reference curve
    of another at every t <= mcs on the size-free moments while xi << L:
    <e>, <A> and N·<m^2>, within SIGMAS of the combined sigma^2 = var_ref
    (N_ref / N / n + 1 / n_ref) (N_ref^2 for N·<m^2>), the variance a
    sample from the reference's own columns (Var(m^2) by m2_var).
    Returns the largest |z|."""
    ts = np.arange(1, mcs + 1)
    if (table.shape[0] != mcs or table.shape[1] != ref.shape[1]
            or not np.all(np.isfinite(table))):
        fail(f"{label}: table shape {table.shape} or non-finite")
    if not np.all(table[:, 1] == samples) or not np.all(table[:, 2] == ts):
        fail(f"{label}: Nsample or t column is wrong")
    n_ref, nsites_ref = ref[0, 1], ref[0, 0]
    worst = 0.0
    for t in ts:
        row, r = row_at(table, t), row_at(ref, t)
        for name, got, want, var in (
                ("e", row[4], r[4], (r[6] - r[4] ** 2)
                 * (nsites_ref / nsites / samples + 1 / n_ref)),
                ("A", row[9], r[9], (r[10] - r[9] ** 2)
                 * (nsites_ref / nsites / samples + 1 / n_ref)),
                ("N m^2", nsites * row[5], nsites_ref * r[5],
                 nsites_ref ** 2 * m2_var(r)
                 * (1 / samples + 1 / n_ref))):
            z = (got - want) / math.sqrt(var)
            if t in (1, 2, 10, 100, 1000):
                log(f"  {label} t={t:5d} <{name}> port {got:.9g} reference "
                    f"{want:.9g} sigma {math.sqrt(var):.3e} z {z:+.2f}")
            worst = max(worst, abs(z))
            if abs(z) > SIGMAS:
                fail(f"{label}: <{name}>({t}) is {z:+.2f} sigma from the "
                     "reference")
    log(f"  {label}: largest |z| {worst:.2f} over {mcs} times")
    return worst


def xy_angle_launches(label, launches, want_angle,
                      want_int16=(0, 0)) -> None:
    """A class of the angle engines: its angle and int16 launches as
    counted (the int16 multisweep's (device-memory, shared-memory) modes),
    and none of the component engines'."""
    got = launches["xy_angle"]
    if {k: got[k] for k in want_angle} != want_angle:
        fail(f"xy {label} launched {got}, want {want_angle}")
    want = dict(zip(("multisweep", "multisweep_smem"), want_int16))
    if launches["xy_int16"] != want:
        fail(f"xy {label} launched {launches['xy_int16']}, want {want} "
             "int16 launches")
    for other in ("xy", "xy_resident", "xy_measure"):
        if any(launches[other].values()):
            fail(f"xy {label} launched {other}: {launches[other]}")


def run_xya_classes(main_fn, modules, out_dir, ref_xy, ref_xy10k, ref_xy_or,
                    ref_fm, ref_fd) -> dict:
    """The angle engines' classes through the CLI: under
    SPINLAT_XY_PERIODIC_ANGLE=1 the literal 10000x10000 x 1 Metropolis
    relaxation (4 samples, 200 MCS, kbt 0.895; against the 2000x2000
    curve at t <= 100 and the one-sample 10000x10000 curve at t <= 200),
    the A/B 2000x2000 x 32 (64 samples, 100 MCS), over-relaxation at
    4000x4000 x 8 (16 samples, 200 MCS, n_or 1) and finite-magne at
    1000x1000 x 20 (40 samples, 100 MCS, m0 0.02); under
    SPINLAT_XY_ANGLE_MS=1 from-disorder at 1536x1536 x 1 (32 samples,
    1000 MCS; the int16 multisweep's shared-memory mode) and x 2 (4
    samples, 200 MCS; past its fit, the device-memory mode) on the
    size-free moments of the 1500x1500 curve.  Returns {label: (launches,
    wall, rate, largest |z|)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import sweep
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D

    out = {}
    with hp_env("SPINLAT_XY_PERIODIC_ANGLE", "1"):
        n = 10000
        log(f"phase 4l: XY angle path, literal {n}x{n} x 1, 4 samples, "
            "200 MCS")
        argv = ["--model", "xy2d", "--nx", str(n), "--ny", str(n), "--kbt",
                repr(KBT_XY_2000), "--mcs", "200", "--samples", "4",
                "--replicas", "1"]
        launches, wall, rate, table, head = run_main_path(
            main_fn, modules, out_dir, "xy2d_angle_10000", argv, n * n, 4,
            200)
        if f"# engine: {sweep.XY_ANGLE_ENGINE}" not in head:
            fail(f"literal angle class took another route: {head}")
        z = max(check_against_reference(
            table[:100], ref_xy, n * n, 4, 100, range(1, 101),
            ref_nsites=int(ref_xy[0, 0]), ref_samples=int(ref_xy[0, 1])),
            check_one_sample_curve(table, ref_xy10k,
                                   extended_var(ref_xy, 200), n * n, 4,
                                   200))
        xy_angle_launches("literal", launches,
                          {"metro": 1600, "metro_measuring": 800,
                           "metro_snapshot": 0, "or": 0})
        out["literal 10000^2 x 1"] = (launches, wall, rate, z)
        log("phase 4l: XY angle path, A/B 2000x2000 x 32, 64 samples, "
            "100 MCS")
        res = run_xy(main_fn, modules, out_dir, 2000, KBT_XY_2000, 32, 64,
                     100, 0, ref_xy, sweep.XY_ANGLE_ENGINE)
        xy_angle_launches("A/B", res[0], {"metro": 400,
                                          "metro_measuring": 200, "or": 0})
        out["Metropolis 2000^2 x 32"] = res
        log("phase 4l: XY angle path, OR 4000x4000 x 8, 16 samples, 200 "
            "MCS, n_over_relax 1")
        res = run_xy(main_fn, modules, out_dir, 4000, KBT_XY, 8, 16, 200, 1,
                     ref_xy_or, sweep.XY_ANGLE_ENGINE)
        xy_angle_launches("OR", res[0], {"metro": 800, "metro_measuring": 0,
                                         "or": 800, "or_measuring": 400})
        out["OR 4000^2 x 8"] = res
        log("phase 4l: XY angle path, finite-magne 1000x1000 x 20, 40 "
            "samples, 100 MCS")
        argv = ["--model", "xy2d", "--protocol", "finite_magne", "--nx",
                "1000", "--ny", "1000", "--kbt", repr(KBT_XY), "--mcs",
                "100", "--samples", "40", "--replicas", "20",
                "--init-magne", "0.02"]
        res = run_xy_disorder(main_fn, modules, out_dir,
                              "xy2d_angle_finite-magne", argv, 1000, 40, 100,
                              ref_fm, PARAM_MOMENTS, sweep.XY_DISORDER_ANGLE)
        xy_angle_launches("finite-magne", res[0],
                          {"metro": 400, "metro_snapshot": 200,
                           "metro_measuring": 0, "or": 0})
        out["finite-magne 1000^2 x 20"] = res
    with hp_env("SPINLAT_XY_ANGLE_MS", "1"):
        for nx, want in ((1500, sweep.XY_DISORDER_STREAMED),
                         (XYI_N, sweep.XY_DISORDER_INT16)):
            got = sweep.xy_disorder_route(XY2D(nx=nx, ny=nx, kbt=KBT_XY), 1,
                                          "rotate_first", 1000)
            if got != want:
                fail(f"SPINLAT_XY_ANGLE_MS=1 routes {nx}^2 x 1 to {got}, "
                     f"want {want} (JAX's gate)")
        n = XYI_N
        log(f"phase 4l: XY int16 path, from-disorder {n}x{n} x 1, 32 "
            "samples, 1000 MCS")
        argv = ["--model", "xy2d", "--protocol", "from_disorder", "--nx",
                str(n), "--ny", str(n), "--kbt", repr(KBT_XY), "--mcs",
                "1000", "--samples", "32", "--replicas", "1"]
        launches, wall, rate, table, head = run_main_path(
            main_fn, modules, out_dir, "xy2d_int16_from-disorder", argv,
            n * n, 32, 1000)
        if f"# engine: {sweep.XY_DISORDER_INT16}" not in head:
            fail(f"int16 class took another route: {head}")
        z = check_size_free(table, ref_fd, n * n, 32, 1000, "int16 1536^2")
        xy_angle_launches("int16", launches, {"metro": 0}, (0, 32 * 16))
        out["int16 from-disorder 1536^2 x 1"] = (launches, wall, rate, z)
        # two replicas a call: past the shared-memory fit, the int16
        # multisweep's device-memory mode (2 calls of 64, 64, 64, 8 sweeps)
        log(f"phase 4l: XY int16 path, from-disorder {n}x{n} x 2, 4 "
            "samples, 200 MCS")
        argv = ["--model", "xy2d", "--protocol", "from_disorder", "--nx",
                str(n), "--ny", str(n), "--kbt", repr(KBT_XY), "--mcs",
                "200", "--samples", "4", "--replicas", "2"]
        launches, wall, rate, table, head = run_main_path(
            main_fn, modules, out_dir, "xy2d_int16_from-disorder_x2", argv,
            n * n, 4, 200)
        if f"# engine: {sweep.XY_DISORDER_INT16}" not in head:
            fail(f"int16 x2 class took another route: {head}")
        z = check_size_free(table, ref_fd, n * n, 4, 200, "int16 1536^2 x 2")
        xy_angle_launches("int16 x2", launches, {"metro": 0}, (8, 0))
        out["int16 from-disorder 1536^2 x 2"] = (launches, wall, rate, z)
    return out


def time_xy_angle(label: str, kernel, plain, planes, nbytes: float,
                  ops: float, reps: int = 20) -> tuple[dict, float]:
    """CUDA-event time of an angle phase wrapper (on a copy of its
    ``planes[0]``, updated launch after launch) and of its plain version,
    beside the bound; then one call of each on fresh copies.  Returns
    (times, (state error, sums' error against their scale or 0))."""
    s, rest = planes[0], planes[1:]
    k, q = s.clone(), s.clone()
    ms = cuda_time_ms(lambda: kernel(k, *rest), reps=reps)
    plain_ms = cuda_time_ms(lambda: plain(q, *rest), reps=1, warmup=1)
    k, q = s.clone(), s.clone()
    got, want = kernel(k, *rest), plain(q, *rest)
    err = (float_err([(k, q)]),
           scaled_err(got[1], want[1], 2 * s[0].numel())
           if isinstance(want, tuple) else 0.0)
    bound, by = bound_ms(nbytes, ops)
    log(f"  {label}: {ms:.4f} ms/launch ({s.numel() / ms * 1e3:.4g} site "
        f"updates/s), plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); "
        f"vs plain {err[0]}, sums {err[1]:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}, err


def time_xya_kernels(xya, xyi, rng, dev) -> dict:
    """The angle kernels at their classes' launches, each held against its
    plain version (Philox): angle_metro_kernel plain and measuring at
    10000^2 x 1 and 2000^2 x 32, plain at 4000^2 x 8 and 1000^2 x 20, the
    snapshot mode at 1000^2 x 20; angle_or_kernel plain and measuring at
    4000^2 x 8 and 10000^2 x 1; the int16 multisweep at 1536^2 x 1 with
    S = 64 and 40 (its shared-memory mode) and at 1536^2 x 2 with S = 64
    and 8 and x 3 with S = 8 (its device-memory mode, past the fit;
    chip_time_xy.py --int16 times x 3 at S = 64).
    Returns {label: (times, err)}."""
    out = {}
    keys = multispin_keys(rng, 64, 61)
    for nrep, ny, nx, kbt in XYA_SHAPES[1:]:
        a, b, sa, sb = angle_planes(dev, nrep, ny, nx, 70 + nrep)
        sites = nrep * ny * nx // 2
        tag = f"{ny}^2 x {nrep}"
        beta = 1.0 / kbt
        plain_kw = dict(color=0, beta=beta)
        out[f"metro {tag}"] = time_xy_angle(
            f"xy angle_metro_kernel {tag}",
            lambda s, o: xya.metro_phase(s, o, keys[0, 0], **plain_kw),
            lambda s, o: xya.metro_phase_plain(s, o, keys[0, 0], **plain_kw),
            (a, b), XYA_BYTES_PER_SITE * sites, sites * OPS_XYA_METROPOLIS)
        if ny in (10000, 2000):
            kw = dict(color=1, beta=beta, measuring=True)
            out[f"metro measuring {tag}"] = time_xy_angle(
                f"xy angle_metro_kernel {tag}, measuring",
                lambda s, o: xya.metro_phase(s, o, keys[0, 1], **kw),
                lambda s, o: xya.metro_phase_plain(s, o, keys[0, 1], **kw),
                (b, a), XYA_BYTES_PER_SITE * sites + nrep * 24,
                sites * (OPS_XYA_METROPOLIS + OPS_XY_MEASURE))
        if ny in (4000, 10000):
            for label, measuring, color in (("or", False, 0),
                                            ("or measuring", True, 1)):
                kw = dict(color=color, measuring=measuring)
                pl = (a, b) if color == 0 else (b, a)
                out[f"{label} {tag}"] = time_xy_angle(
                    f"xy angle_or_kernel {tag}"
                    + (", measuring" if measuring else ""),
                    lambda s, o, kw=kw: xya.or_phase(s, o, **kw),
                    lambda s, o, kw=kw: xya.or_phase_plain(s, o, **kw), pl,
                    XYA_BYTES_PER_SITE * sites + nrep * 24 * measuring,
                    sites * (OPS_XYA_OVER_RELAX
                             + OPS_XY_MEASURE * measuring))
        if ny == 1000:
            kw = dict(color=1, beta=beta, snap=(sb, sa))
            out[f"snapshot {tag}"] = time_xy_angle(
                f"xy angle_metro_kernel {tag}, snapshot mode",
                lambda s, o: xya.metro_phase(s, o, keys[0, 1], **kw),
                lambda s, o: xya.metro_phase_plain(s, o, keys[0, 1], **kw),
                (b, a), (XYA_BYTES_PER_SITE + XYA_SNAP_BYTES_PER_SITE)
                * sites + nrep * 32,
                sites * (OPS_XYA_METROPOLIS + OPS_XY_MEASURE + OPS_XYA_SNAP))
        del a, b, sa, sb
    n = XYI_N
    for nrep, sweeps, label in ((1, 64, "S=64"), (1, 40, "S=40"),
                                (2, 64, "x2 S=64"), (2, 8, "x2 S=8"),
                                (3, 8, "x3 S=8")):
        sites = nrep * n * n // 2
        pa, pb, sa, sb = int16_planes(dev, (nrep, n, n // 2), sweeps)
        seeds = keys[:sweeps]
        kw = dict(beta=1.0 / KBT_XY)
        k = [pa.clone(), pb.clone()]
        ms = cuda_time_ms(lambda: xyi.multisweep_planes(*k, sa, sb, seeds,
                                                        **kw), reps=5)
        q = [pa.clone(), pb.clone()]
        plain_ms = cuda_time_ms(lambda: xyi.multisweep_plain(
            *q, sa, sb, seeds, **kw), reps=1, warmup=0)
        k, q = [pa.clone(), pb.clone()], [pa.clone(), pb.clone()]
        got = xyi.multisweep_planes(*k, sa, sb, seeds, **kw)
        want = xyi.multisweep_plain(*q, sa, sb, seeds, **kw)
        err = (float(max_abs_err(zip(k, q))),
               scaled_err(got, want, nrep * n * n))
        bound, by = bound_ms(8 * 2 * sites + nrep * sweeps * 4 * 8,
                             sweeps * sites * (2 * OPS_XYA_METROPOLIS
                                               + OPS_XYI_FUSED))
        mode = ("smem_multisweep_kernel" if xyi.device_layout(pa)
                is not None else "gmem_multisweep_kernel")
        log(f"  xy int16 {mode} {n}^2 x {nrep}, S={sweeps}: "
            f"{ms:.4f} ms/launch ({ms / sweeps * 1e3:.2f} us a sweep), "
            f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); vs "
            f"plain {err[0]}, sums {err[1]:.3g}")
        out[f"int16 {label}"] = ({"ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound, "bound_by": by}, err)
        del pa, pb, sa, sb
    return out


def xya_shares(classes: dict, ta: dict) -> dict[str, float]:
    """Each angle class's kernel time (its launches times the launch times
    at its shape) over its wall."""
    def ms(key):
        return ta[key][0]["ms"]
    kern = {
        "literal 10000^2 x 1": 800 * (ms("metro 10000^2 x 1")
                                      + ms("metro measuring 10000^2 x 1")),
        "Metropolis 2000^2 x 32": 200 * (ms("metro 2000^2 x 32")
                                         + ms("metro measuring 2000^2 x 32")),
        "OR 4000^2 x 8": 400 * (2 * ms("metro 4000^2 x 8")
                                + ms("or 4000^2 x 8")
                                + ms("or measuring 4000^2 x 8")),
        "finite-magne 1000^2 x 20": 200 * (ms("metro 1000^2 x 20")
                                           + ms("snapshot 1000^2 x 20")),
        "int16 from-disorder 1536^2 x 1": 32 * (15 * ms("int16 S=64")
                                                 + ms("int16 S=40")),
        "int16 from-disorder 1536^2 x 2": 2 * (3 * ms("int16 x2 S=64")
                                               + ms("int16 x2 S=8")),
    }
    shares = {}
    for label, (_, wall, _, _) in classes.items():
        shares[label] = kern[label] / (wall * 1e3)
        log(f"  xy angle {label}: kernel {kern[label] / 1e3:.3f} s of a "
            f"{wall:.3f} s wall; kernel share {shares[label]:.3f}")
    return shares


# ---------------------------------------------------------------------------
# periodic Ising on a mesh of the one card repeated (parallel/domain.py):
# the four halo kernels (ising2d_multispin.py:783, ising3d_multispin.py:638,
# ising2d_pallas.py:397, ising3d_pallas.py:237)
# ---------------------------------------------------------------------------

# (label, model, (nx, ny, nz), kbt, replicas, samples, MCS, mesh, the
# module and counter of its halo kernel, the unsharded class's .dat and
# label in its phase, the shard shape (R, lead, ..., w))
MESH_CLASSES = (
    ("packed 2-D 8192^2 x 4 (1,4)", "ising2d", (8192, 8192, 1), KBT, 4, 4,
     200, (1, 4, 1), "ising2d", "ising2d_8192.dat",
     "2-D streaming 8192^2 x 4", (4, 64, 4096)),
    ("packed 2-D 8192^2 x 4 (2,2,2)", "ising2d", (8192, 8192, 1), KBT, 4, 4,
     200, (2, 2, 2), "ising2d", "ising2d_8192.dat",
     "2-D streaming 8192^2 x 4", (2, 128, 2048)),
    ("packed 3-D 512^3 x 8 (2,4)", "ising3d", (512, 512, 512), KBT_3D, 8, 8,
     200, (2, 4, 1), "ising3d", "ising3d_512.dat",
     "3-D streaming 512^3 x 8", (4, 128, 16, 256)),
    ("int8 2-D 4000^2 x 8 (1,2,2)", "ising2d", (4000, 4000, 1), KBT, 8, 8,
     200, (1, 2, 2), "ising2d_int8", "ising2d_int8_4000.dat",
     "2-D streamed 4000^2 x 8", (8, 2000, 1000)),
    ("int8 3-D 500^3 x 2 (2,2)", "ising3d", (500, 500, 500), KBT_3D, 2, 2,
     200, (2, 2, 1), "ising3d_int8", "ising3d_500.dat", "3-D 500^3 x 2",
     (1, 250, 500, 250)),
)
# the halo kernel of each mesh module: (counter, JSON name, source, site)
MESH_KERNELS = {
    "ising2d": ("shard_phase", "ising2d_multispin.phase_kernel<true>",
                "ising2d_multispin.cu", "ising2d_multispin.py:783"),
    "ising3d": ("shard_phase", "ising3d_multispin.phase_kernel<true>",
                "ising3d_multispin.cu", "ising3d_multispin.py:638"),
    "ising2d_int8": ("halo_phase", "ising2d_pallas.phase_kernel<true, .>",
                     "ising2d_pallas.cu", "ising2d_pallas.py:397"),
    "ising3d_int8": ("halo_phase", "ising3d_pallas.tile_kernel<true, .>",
                     "ising3d_pallas.cu", "ising3d_pallas.py:237"),
}


def run_mesh_classes(modules, out_dir, ref, ref3, dev, unsharded) -> dict:
    """Phase 4m: each MESH_CLASSES class through protocols.run_relaxation
    on its mesh of ``dev`` repeated, from all-up, launch counts set to 0
    just before and read just after; its table equal bit for bit to the
    unsharded class's (its first MCS rows), within 5 sigma of the curve at
    every t, and the halo kernel launched 2·shards a sweep and no other
    phase kernel.  ``unsharded`` maps the unsharded labels to their
    rates.  Returns {label: (launches, wall, rate, largest |z|)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols

    out = {}
    for (label, model, (nx, ny, nz), kbt, nrep, samples, mcs, (dp, y, x),
         mod, dat, base, _) in MESH_CLASSES:
        log(f"phase 4m: mesh path, {label}, {samples} samples, {mcs} MCS")
        cfg = RunConfig(model=model, nx=nx, ny=ny, nz=nz, kbt=kbt, mcs=mcs,
                        tot_sample=samples, replicas=nrep, mesh_dp=dp,
                        mesh_y=y, mesh_x=x)
        nsites = nx * ny * nz
        path = out_dir / f"mesh_{model}_{nx}_{dp}{y}{x}.dat"
        for m in modules.values():
            m.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with path.open("w") as f, open(os.devnull, "w") as err:
            protocols.run_relaxation(cfg, out=f, err=err, device=dev,
                                     mesh_devices=[dev] * (dp * y * x))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: dict(m.LAUNCHES) for name, m in modules.items()}
        rate = nsites * mcs * samples / wall
        head = [line for line in path.read_text().splitlines()
                if line.startswith("#")]
        engine = f"# engine: domain-sharded mesh ({dp},{y},{x})"
        if engine not in head:
            fail(f"mesh {label} took another route: {head}")
        table = read_dat(path)
        want = read_dat(out_dir / dat, max_t=mcs)
        if table.shape != want.shape or not np.array_equal(table, want):
            diff = (np.abs(table - want).max() if table.shape == want.shape
                    else table.shape)
            fail(f"mesh {label} differs from its unsharded class: {diff}")
        if model == "ising2d":
            z = check_against_reference(table, ref, nsites, samples, mcs,
                                        range(1, mcs + 1))
        else:
            z = check_against_reference(
                table, ref3, nsites, samples, mcs, range(1, mcs + 1),
                ref_nsites=512 ** 3, ref_samples=int(ref3[0, 1]))
        counter = MESH_KERNELS[mod][0]
        want_n = 2 * dp * y * x * (samples // nrep) * mcs
        phase_keys = ("phase", "shard_phase", "halo_phase")
        got = {name: {k: v for k, v in n.items() if k in phase_keys and v}
               for name, n in launches.items()}
        if got != {**{name: {} for name in launches},
                   mod: {counter: want_n}}:
            fail(f"mesh {label} launched {got}, want {mod}.{counter} = "
                 f"{want_n} and no other phase kernel")
        ratio = rate / unsharded[base]
        log(f"  {label}: {wall:.2f} s, {rate:.4g} flip attempts/s, "
            f"{ratio:.3f} of the unsharded class's {unsharded[base]:.4g}; "
            f"launches {mod}.{counter} {want_n}; bitwise equal to "
            f"{dat}; largest |z| {z:.2f}")
        out[label] = (launches, wall, rate, z, ratio)
    return out


# global column offsets of the int8 2-D halo check at the mesh class's
# shard: col0 % 4 = 0 .. 3 (the class's own x split is at 1000), a shard
# at col0 % 4 != 0 starting its rows' words col0 % 4 columns early
INT8_HALO_COL0 = (1000, 1001, 1002, 1003)


def check_int8_halo_col0(i2p, a, b, halos, cols, seeds, beta, g, dev
                         ) -> int:
    """ising2d_pallas.phase_kernel<true, ., .> against sharded_phase_plain
    at the shard (a, b) with its halo rows and columns, at global offsets
    (0, L, col0) for each INT8_HALO_COL0: both colours, Philox and
    injected words, plain and measuring (the sums exactly).  Returns the
    largest absolute difference."""
    nrep, L, half = a.shape
    bits = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=a.shape,
                                       dtype=np.int64).astype(np.int32)
                            ).to(dev)
    err = 0
    for col0 in INT8_HALO_COL0:
        for color in (0, 1):
            x, o = (a, b) if color == 0 else (b, a)
            for words in (dict(seeds=seeds[color]), dict(bits=bits)):
                for measuring in (False, True):
                    args = (o, *halos, words.get("seeds"), (0, L, col0))
                    kw = dict(color=color, beta=beta, halo_lf=cols[0],
                              halo_rt=cols[1], bits=words.get("bits"),
                              measuring=measuring)
                    got = i2p.sharded_phase(x.clone(), *args, **kw)
                    want = i2p.sharded_phase_plain(x, *args, **kw)
                    err = max(err, max_abs_err(
                        zip(got, want) if measuring else [(got, want)]))
    log(f"  int8 2-D halo mode {tuple(a.shape)} at col0 {INT8_HALO_COL0} "
        "with column halos, both colours, Philox and injected, plain and "
        f"measuring: vs plain {err}")
    return err


def time_mesh_kernels(msb, ms3, i2p, i3p, rng, dev) -> dict:
    """Each halo kernel at each mesh class's shard shape: phase a (Philox)
    and the measuring phase b, CUDA events, the bound from the unsharded
    kernel's per-word or per-site counts plus the halo bytes; each held
    against its plain version there, and in injected mode at a small
    shape.  Returns {label: (phase a times, phase b times, err)}."""
    seeds = multispin_keys(rng, 1, 61)[0]
    g = np.random.default_rng(67)

    def words(shape):
        return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                           dtype=np.int64).astype(np.int32)
                                ).to(dev)

    def bits01(shape):
        return torch.from_numpy(g.integers(0, 2, size=shape).astype(
            np.int32)).to(dev)

    out = {}
    for (label, model, _, kbt, _, _, _, (_, _, x), mod, _, _,
         shape) in MESH_CLASSES:
        beta = 1.0 / kbt
        nrep = shape[0]
        cols = x > 1
        if mod in ("ising2d", "ising3d"):
            xw, ow = words(shape), words(shape)
            if mod == "ising2d":
                _, nyp, half = shape
                halos = (bits01((nrep, 1, half)), bits01((nrep, 1, half)))
                kw = (dict(halo_lf=words((nrep, nyp, 1)),
                           halo_rt=words((nrep, nyp, 1))) if cols else {})
                offs = (0, nyp, half) if cols else (0, nyp)
                fn = msb.sharded_phase_packed
                plain = msb.sharded_phase_packed_plain
                per_word = functools.partial(phase_ops_per_word, msb, beta)
                halo_bytes = 4 * nrep * (2 * half + (2 * nyp if cols else 0))
                inject = {"b4": words(shape), "b8": words(shape)}
            else:
                halos = (words((nrep, 1) + shape[2:]),
                         words((nrep, 1) + shape[2:]))
                kw, offs = {}, (0, shape[1])
                fn = ms3.sharded_phase3d_packed
                plain = ms3.sharded_phase3d_packed_plain
                per_word = functools.partial(phase3d_ops_per_word, msb, ms3,
                                             beta)
                halo_bytes = 4 * 2 * halos[0].numel()
                inject = {k: words(shape) for k in ("b4", "b8", "b12")}
            n = xw.numel()
            flips = 32 * n

            def call(f, color, measuring, extra=None, xw=xw, ow=ow,
                     halos=halos, kw=kw, offs=offs, beta=beta):
                return f(xw, ow, *halos, seeds[color], offs, color=color,
                         beta=beta, measuring=measuring, **kw,
                         **(extra or {}))

            times = []
            for color, measuring in ((0, False), (1, True)):
                t, err = time_kernel(
                    f"{label.split(' (')[0]} halo kernel {shape}, "
                    f"{'measuring' if measuring else 'phase a'}", flips,
                    functools.partial(call, fn, color, measuring),
                    functools.partial(call, plain, color, measuring),
                    12 * n + halo_bytes + (16 * nrep if measuring else 0),
                    n * per_word(measuring), reps=50, plain_reps=1,
                    view=lambda r: r if isinstance(r, tuple) else (r,),
                    graphed=True)
                times.append((t, err))
            ierr = max_abs_err([(call(fn, 0, False, inject),
                                 call(plain, 0, False, inject))])
        else:
            a, b = int8_state(dev, shape, 71)
            dims = len(shape) - 1
            if dims == 2:
                _, L, half = shape
                halos = tuple(int8_state(dev, (nrep, 1, half), 73))
                cl = int8_state(dev, (nrep, L, 1), 79)
                kw = dict(halo_lf=cl[0], halo_rt=cl[1]) if cols else {}
                offs = (0, L, half) if cols else (0, L)
                fn, plain = i2p.sharded_phase, i2p.sharded_phase_plain
                halo_bytes = nrep * (2 * half + (2 * L if cols else 0))
            else:
                halos = tuple(int8_state(dev, (nrep, 1) + shape[2:], 73))
                kw, offs = {}, (0, shape[1])
                fn, plain = i3p.sharded_phase, i3p.sharded_phase_plain
                halo_bytes = 2 * halos[0].numel()
            sites = a.numel()

            def call(f, color, measuring, x_, extra=None, b=b, halos=halos,
                     kw=kw, offs=offs, beta=beta):
                return f(x_, b, *halos, seeds[color], offs, color=color,
                         beta=beta, measuring=measuring, **kw,
                         **(extra or {}))

            times = []
            for color, measuring in ((0, False), (1, True)):
                work = a.clone()
                t, _ = time_kernel(
                    f"{label.split(' (')[0]} halo kernel {shape}, "
                    f"{'measuring' if measuring else 'phase a'}", sites,
                    functools.partial(call, fn, color, measuring, work),
                    functools.partial(call, plain, color, measuring, a),
                    INT8_PHASE_BYTES * sites + halo_bytes
                    + (16 * nrep if measuring else 0),
                    sites * (int8_phase_ops(dims)
                             + (OPS_INT8_FUSED if measuring else 0)),
                    reps=50, plain_reps=1, view=lambda r: (),
                    graphed=True)
                got = call(fn, color, measuring, a.clone())
                want = call(plain, color, measuring, a)
                err = max_abs_err(zip(got if measuring else (got,),
                                      want if measuring else (want,)))
                times.append((t, err))
            small = tuple(min(v, 64) for v in shape)
            bits = torch.from_numpy(g.integers(
                -2 ** 31, 2 ** 31, size=small, dtype=np.int64).astype(
                    np.int32)).to(dev)
            sa, sb = int8_state(dev, small, 83)
            sh = (sb[:, :1].contiguous(), sb[:, -1:].contiguous())
            skw = {k: v[:small[0], :small[1]].contiguous()
                   for k, v in kw.items()}
            ierr = max_abs_err([(
                fn(sa.clone(), sb, *sh, seeds[0], offs, color=0, beta=beta,
                   bits=bits, **skw),
                plain(sa, sb, *sh, seeds[0], offs, color=0, beta=beta,
                      bits=bits, **skw))])
            if dims == 2 and cols:
                ierr = max(ierr, check_int8_halo_col0(
                    i2p, a, b, halos, cl, seeds, beta, g, dev))
        err = max(times[0][1], times[1][1], ierr)
        log(f"  {label}: injected mode vs plain {ierr}")
        out[label] = (times[0][0], times[1][0], err)
    return out


def mesh_shares(classes: dict, tm: dict) -> dict[str, float]:
    """Each mesh class's kernel time (its sweeps' phase a and b launches
    at the times measured at its shard shape) over its wall."""
    shares = {}
    for (label, *_, mcs, (dp, y, x), mod, _, _, _) in MESH_CLASSES:
        launches, wall = classes[label][:2]
        n = launches[mod][MESH_KERNELS[mod][0]]
        ta, tb, _ = tm[label]
        kern = n / 2 * (ta["ms"] + tb["ms"])
        shares[label] = kern / (wall * 1e3)
        log(f"  mesh {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share {shares[label]:.3f}")
    return shares


# ---------------------------------------------------------------------------
# the clock and XY on a mesh of the one card repeated: the four halo modes
# (clock_planes.py:875, clock_pallas.py:294, xy2d_pallas.py:726, :770)
# ---------------------------------------------------------------------------

# (label, RunConfig fields, mesh, kind, the unsharded class's .dat and its
# label, the shard shape (R, L, w): word rows for the packed clock)
MESH_CX_MCS = 200
MESH_CX_CLASSES = (
    ("packed clock 2048^2 x 16 (2,2,2)",
     dict(model="clock", q=6, nx=2048, ny=2048, kbt=KBT_CLOCK_08,
          replicas=16, tot_sample=32), (2, 2, 2), "clock6",
     "clock_2048x2048.dat", "clock aligned 2048^2 x 16", (8, 32, 512)),
    ("int8 clock 2000^2 x 16 (1,2,2)",
     dict(model="clock", q=5, nx=2000, ny=2000, kbt=KBT_CLOCK, replicas=16,
          tot_sample=32), (1, 2, 2), "clock8", "clock8_q5_2000.dat",
     "streamed q=5 2000^2 x 16", (16, 1000, 500)),
    ("XY OR 4000^2 x 8 (2,2,2)",
     dict(model="xy2d", nx=4000, ny=4000, kbt=KBT_XY, replicas=8,
          tot_sample=16, n_over_relax=1), (2, 2, 2), "xy_or",
     "xy2d_4000_component.dat", "XY OR 4000^2 x 8", (4, 2000, 1000)),
    ("XY fix1mcs 1500^2 x 8 (1,2,2)",
     dict(model="xy2d", nx=1500, ny=1500, kbt=KBT_XY, replicas=8,
          tot_sample=32, rotate_after_first_mcs=True), (1, 2, 2), "xy_fix1",
     "xy2d_fix1mcs.dat", "fix1mcs", (8, 750, 375)),
)
# the densities of the float64-summed classes (the int8 clock, XY) are held
# within this of the unsharded run's at every t: one changed site would
# move a density by >= 1/N (>= 6e-8 here, 4e-9 over 16 samples)
MESH_CX_BOUND = 1e-12


def mesh_table_err(table: np.ndarray, want: np.ndarray, nsites: int,
                   relaxation: bool) -> float:
    """Largest error of a mesh table against the unsharded class's in
    units of its bound: N, Nsample and t exact; the mean columns (means of
    densities and of their products, magnitude <= 4) within
    MESH_CX_BOUND x 4; the relaxation table's N·Var columns (7-9, N times
    differences of those means) within MESH_CX_BOUND x 8N."""
    if table.shape != want.shape or not np.array_equal(table[:, :3],
                                                       want[:, :3]):
        fail(f"mesh table {table.shape} against {want.shape}: the N, "
             "Nsample or t columns differ")
    tol = np.full(table.shape[1], MESH_CX_BOUND * 4)
    if relaxation:
        tol[7:10] = MESH_CX_BOUND * 8 * nsites
    return float((np.abs(table[:, 3:] - want[:, 3:]) / tol[3:]).max())


def run_mesh_cx_classes(modules, out_dir, refs: dict, dev,
                        unsharded: dict) -> dict:
    """Phase 4m, the clock and XY: each MESH_CX_CLASSES class through
    protocols on its mesh of ``dev`` repeated, launch counts set to 0 just
    before and read just after; its table against the unsharded class's
    first MESH_CX_MCS rows (the packed clock's bit for bit, the others
    within MESH_CX_BOUND, :func:`mesh_table_err`), the unsharded class's
    own physics check, and the halo modes launched as the schedule says,
    no unsharded phase kernel.  ``unsharded`` maps the unsharded labels to
    their rates.  Returns {label: (launches, wall, rate, largest |z|,
    ratio)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine import protocols

    out = {}
    mcs = MESH_CX_MCS
    for label, fields, (dp, y, x), kind, dat, base, _ in MESH_CX_CLASSES:
        samples, nrep = fields["tot_sample"], fields["replicas"]
        log(f"phase 4m: mesh path, {label}, {samples} samples, {mcs} MCS")
        cfg = RunConfig(mcs=mcs, mesh_dp=dp, mesh_y=y, mesh_x=x, **fields)
        nsites = cfg.nx * cfg.ny
        fix1 = kind == "xy_fix1"
        path = out_dir / f"mesh_{kind}_{cfg.nx}_{dp}{y}{x}.dat"
        for m in modules.values():
            m.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = protocols.run_from_disorder if fix1 else \
            protocols.run_relaxation
        with path.open("w") as f, open(os.devnull, "w") as err:
            run(cfg, out=f, err=err, device=dev,
                mesh_devices=[dev] * (dp * y * x))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: dict(m.LAUNCHES) for name, m in modules.items()}
        rate = nsites * mcs * samples / wall
        head = [line for line in path.read_text().splitlines()
                if line.startswith("#")]
        engine = (f"# engine: {'XY disorder ' if fix1 else ''}"
                  f"domain-sharded mesh ({dp},{y},{x})")
        if engine not in head:
            fail(f"mesh {label} took another route: {head}")
        table = read_dat(path)
        want = read_dat(out_dir / dat, max_t=mcs)
        if kind == "clock6":
            if table.shape != want.shape or not np.array_equal(table, want):
                fail(f"mesh {label} differs from its unsharded class")
            err = 0.0
        else:
            err = mesh_table_err(table, want, nsites, not fix1)
            if err > 1.0:
                fail(f"mesh {label} is {err:.3g} bounds from its unsharded "
                     "class")
        if kind == "clock6":
            ref = refs["clock6"]
            z = check_against_reference(
                table, ref, nsites, samples, mcs, range(1, mcs + 1),
                ref_nsites=int(ref[0, 0]), ref_samples=int(ref[0, 1]))
        elif kind == "clock8":
            exact = clock8_first_sweep_exact(5, 1.0 / KBT_CLOCK, dev)
            row = table[0]
            z = max(abs((row[col] - exact[k])
                        / math.sqrt(row[var] / (nsites * samples)))
                    for k, col, var in ((0, 3, 7), (1, 4, 8)))
            if z > SIGMAS or not np.all(np.isfinite(table)):
                fail(f"mesh {label}: t = 1 is {z:.2f} sigma from the "
                     "closed form, or a row is not finite")
        elif kind == "xy_or":
            ref = refs["xy_or"]
            z = check_against_reference(
                table, ref, nsites, samples, mcs, range(1, mcs + 1),
                ref_nsites=int(ref[0, 0]), ref_samples=int(ref[0, 1]))
        else:
            z = check_disorder_curve(table, refs["fix1"], samples, mcs,
                                     ABS_MOMENTS, f"mesh {label}")
        shards = dp * y * x
        sweeps = samples // nrep * mcs
        want_n = {
            "clock6": {"clock": {"shard_phase": 2 * shards * sweeps,
                                 "phase": 0}},
            "clock8": {"clock8": {"halo_phase": 2 * shards * sweeps,
                                  "halo_phase_measuring": shards * sweeps,
                                  "phase": 0},
                       "clock8_measure": {"measure": 0}},
            "xy_or": {"xy": {"halo_metropolis": 2 * shards * sweeps,
                             "halo_metropolis_measuring": 0,
                             "halo_over_relax": 2 * shards * sweeps,
                             "halo_over_relax_measuring": shards * sweeps,
                             "metropolis": 0, "over_relax": 0}},
            "xy_fix1": {"xy": {"halo_metropolis": 2 * shards * sweeps,
                               "halo_metropolis_snapshot": shards * sweeps,
                               "metropolis": 0},
                        "xy_measure": {"measure": 0},
                        "xy_resident": {"multisweep": 0,
                                        "multisweep_smem": 0}},
        }[kind]
        got = {mod: {k: launches[mod][k] for k in ks}
               for mod, ks in want_n.items()}
        if got != want_n:
            fail(f"mesh {label} launched {got}, want {want_n}")
        ratio = rate / unsharded[base]
        log(f"  {label}: {wall:.2f} s, {rate:.4g} flip attempts/s, "
            f"{ratio:.3f} of the unsharded class's {unsharded[base]:.4g}; "
            f"launches {got}; against {dat}: "
            + ("bitwise" if kind == "clock6"
               else f"{err:.3g} of the bound {MESH_CX_BOUND}")
            + f"; largest |z| {z:.2f}")
        out[label] = (launches, wall, rate, z, ratio)
    return out


def check_mesh_cx_small(cp, c8p, xyp, rng, dev) -> float:
    """The four halo modes against their plain versions at small shards:
    Philox and injected, both colours, plain and measuring (the snapshot
    mode too), with and without columns, int8 clock shards at an odd
    col0 (one chunked past 4096 columns, on a view off the 16-B grid) and
    a packed clock shard of one word row.  Returns the largest
    error (int8 and words exact; float64 sums against their scale)."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock3_multispin,
        clock4_multispin,
        clock_multispin,
    )
    g = np.random.default_rng(89)
    worst = 0.0

    def words(shape):
        return torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=shape,
                                           dtype=np.int64).astype(np.int32)
                                ).to(dev)

    def cmp(got, want, sites):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            if isinstance(a, tuple):
                err = max(err, cmp(a, b, sites))
            elif a.dtype == torch.float64:
                err = max(err, float((a - b).abs().max()) / sites)
            else:
                err = max(err, float_err([(a, b)]))
        return err

    for mod in (clock_multispin, clock4_multispin, clock3_multispin):
        spec = mod.SPEC
        for nyw, half, cols in ((1, 33, True), (3, 70, False)):
            st = [torch.from_numpy(g.integers(0, spec.q, (2, 32 * nyw, half))
                                   .astype(np.int8)).to(dev)
                  for _ in range(2)]
            x, o = spec.pack_color(st[0]), spec.pack_color(st[1])
            bits = [words((2, 1, half)) & 1 for _ in range(6)]
            kw = {}
            offs = (2, 6)
            if cols:
                offs = (2, 6, 40)
                kw = dict(halo_lf=tuple(words((2, nyw, 1)) for _ in x),
                          halo_rt=tuple(words((2, nyw, 1)) for _ in x))
            inj = tuple(words((2, nyw, half)) for _ in range(spec.n_rand))
            for color in (0, 1):
                seeds = rng.seeds_from_key(rng.base_key(91), color)
                for extra in ({}, {"inject": valid_rand(spec, inj)},
                              {"measuring": True}):
                    args = (spec, x, o, tuple(bits[:len(x)]),
                            tuple(bits[3:3 + len(x)]), seeds, offs)
                    worst = max(worst, cmp(
                        cp.sharded_phase_packed(*args, color=color,
                                                beta=1 / KBT_CLOCK_08, **kw,
                                                **extra),
                        cp.sharded_phase_packed_plain(
                            *args, color=color, beta=1 / KBT_CLOCK_08, **kw,
                            **extra), 1))
    # the int8 clock halo mode: odd and even col0 with the column halos,
    # none without; a shard chunked past CHUNK_COLS columns at an odd col0
    # on a view off the 16-B grid
    for q, col0, (R, L, H) in ((5, 11, (3, 9, 23)), (2, 0, (3, 9, 23)),
                               (20, None, (3, 9, 23)),
                               (7, 5, (1, 3, 4102))):

        def states(shape):
            return torch.from_numpy(g.integers(0, q, shape).astype(np.int8)
                                    ).to(dev)

        x, o, up, dn = (states(s) for s in ((R, L, H), (R, L, H), (R, 1, H),
                                             (R, 1, H)))
        off = OFF_GRID[0] if H > 4096 else 0
        kw = dict(q=q, beta=1 / KBT_CLOCK)
        offs = (1, 5) if col0 is None else (1, 5, col0)
        if col0 is not None:
            kw.update(halo_lf=states((R, L, 1)), halo_rt=states((R, L, 1)))
        uc, ua = (torch.rand((R, L, H), device=dev) for _ in range(2))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.base_key(93), color)
            for extra in ({}, {"u_cand": uc, "u_acc": ua},
                          {"measuring": True}):
                worst = max(worst, cmp(
                    c8p.sharded_phase(off_grid_view(x, off), o, up, dn,
                                      seeds, offs,
                                      color=color, **kw, **extra),
                    c8p.sharded_phase_plain(x, o, up, dn, seeds, offs,
                                            color=color, **kw, **extra),
                    2 * L * H))
    for col0 in (None, 11):
        R, L, H = 2, 9, 23

        def unit(shape):
            th = torch.from_numpy(g.uniform(0, 2 * np.pi, shape)).to(dev)
            return torch.cos(th).float(), torch.sin(th).float()

        (sx, sy), (ox, oy) = unit((R, L, H)), unit((R, L, H))
        (ux, uy), (dx, dy) = unit((R, 1, H)), unit((R, 1, H))
        kw = dict(halos_x=(ux, dx), halos_y=(uy, dy))
        offs = (2, 7) if col0 is None else (2, 7, col0)
        if col0 is not None:
            (lx, ly), (rx, ry) = unit((R, L, 1)), unit((R, L, 1))
            kw.update(cols_x=(lx, rx), cols_y=(ly, ry))
        snap = [p for pair in (unit((R, L, H)), unit((R, L, H)))
                for p in pair]
        uc, ua = (torch.rand((R, L, H), device=dev) for _ in range(2))
        for color in (0, 1):
            seeds = rng.seeds_from_key(rng.base_key(95), color)
            for extra in ({}, {"u_cand": uc, "u_acc": ua},
                          {"measuring": True}, {"snap": snap}):
                worst = max(worst, cmp(
                    xyp.sharded_phase(sx.clone(), sy.clone(), ox, oy,
                                      seeds=seeds, offs=offs, color=color,
                                      beta=1 / KBT_XY, **kw, **extra),
                    xyp.sharded_phase_plain(sx.clone(), sy.clone(), ox, oy,
                                            seeds=seeds, offs=offs,
                                            color=color, beta=1 / KBT_XY,
                                            **kw, **extra), 2 * L * H))
            for measuring in (False, True):
                worst = max(worst, cmp(
                    xyp.sharded_or_phase(sx.clone(), sy.clone(), ox, oy,
                                         offs=offs, color=color,
                                         measuring=measuring, **kw),
                    xyp.sharded_or_phase_plain(sx.clone(), sy.clone(), ox,
                                               oy, offs=offs, color=color,
                                               measuring=measuring, **kw),
                    2 * L * H))
    log(f"  clock and XY halo modes at small shards, every mode: largest "
        f"error {worst:.3g}")
    return worst


def time_mesh_cx_kernels(msb, cp, c8p, xyp, rng, dev) -> dict:
    """Each clock and XY halo mode at its mesh class's shard shape, graph
    timed (50 launches, 9 windows) beside its bound and its plain version:
    phase a (Philox) and the measuring phase b (the packed and int8 clock,
    the XY OR measuring phase and the snapshot mode at the fix1mcs shard);
    each held against its plain version there (states exact, float64 sums
    against their scale).  Returns {label: (times, err)}."""
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import clock_multispin

    seeds = multispin_keys(rng, 1, 97)[0]
    g = np.random.default_rng(99)
    out = {}

    def timed(label, sites, fn, plain, nbytes, ops, sums_scale):
        """Graph time of ``fn`` (which updates its own inputs), the plain
        version's single call, one call of each on equal inputs."""
        ms, lo, hi = graph_time_ms(fn, 50, 9)
        plain_ms = cuda_time_ms(plain, reps=1, warmup=0)
        got, want = fn(fresh=True), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            for u, v in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                err = max(err, float((u.double() - v.double()).abs().max())
                          / (sums_scale if u.dtype == torch.float64 else 1))
        bound, by = bound_ms(nbytes, ops)
        log(f"  {label}: {ms:.4f} ms/launch (graph, 50 launches x 9 "
            f"windows: {lo:.4f}-{hi:.4f}; {sites / ms * 1e3:.4g} sites/s), "
            f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({by}); vs "
            f"plain {err:.3g}")
        out[label] = ({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by}, err)

    for label, fields, (_, _, x), kind, _, _, shape in MESH_CX_CLASSES:
        cols = x > 1
        nrep, L, w = shape
        if kind == "clock6":
            spec = clock_multispin.SPEC
            beta = 1.0 / fields["kbt"]
            st = [torch.randint(0, 6, (nrep, 32 * L, w), device=dev,
                                dtype=torch.int8) for _ in range(2)]
            xp, op = spec.pack_color(st[0]), spec.pack_color(st[1])
            hup = tuple(((p[:, -1:] >> 31) & 1).contiguous() for p in op)
            hdn = tuple((p[:, :1] & 1).contiguous() for p in op)
            kw = (dict(halo_lf=tuple(p[:, :, -1:].contiguous() for p in op),
                       halo_rt=tuple(p[:, :, :1].contiguous() for p in op))
                  if cols else {})
            offs = (0, L, w) if cols else (0, L)
            n = L * w * nrep
            halo = 4 * nrep * 3 * (2 * w + (2 * L if cols else 0))
            for color, measuring in ((0, False), (1, True)):
                def call(f, fresh=False, color=color, measuring=measuring,
                         xp=xp, op=op, hup=hup, hdn=hdn, kw=kw, offs=offs):
                    return f(spec, xp, op, hup, hdn, seeds[color], offs,
                             color=color, beta=beta, measuring=measuring,
                             **kw)
                timed(f"packed clock halo mode {shape}, "
                      f"{'measuring' if measuring else 'phase a'}", 32 * n,
                      functools.partial(call, cp.sharded_phase_packed),
                      functools.partial(call, cp.sharded_phase_packed_plain),
                      3 * 3 * 4 * n + halo + (16 * nrep if measuring else 0),
                      n * clock_phase_ops_per_word(msb, cp, spec, beta,
                                                   measuring), 1)
        elif kind == "clock8":
            q, beta = fields["q"], 1.0 / fields["kbt"]
            a, b = (torch.randint(0, q, shape, device=dev, dtype=torch.int8)
                    for _ in range(2))
            up, dn = b[:, -1:].contiguous(), b[:, :1].contiguous()
            kw = (dict(halo_lf=b[:, :, -1:].contiguous(),
                       halo_rt=b[:, :, :1].contiguous()) if cols else {})
            offs = (0, L, w) if cols else (0, L)
            n = a.numel()
            halo = nrep * (2 * w + (2 * L if cols else 0))
            work = a.clone()
            for color, measuring in ((0, False), (1, True)):
                def call(f, fresh=False, color=color, measuring=measuring,
                         kw=kw, offs=offs):
                    x_ = a.clone() if fresh or f is c8p.sharded_phase_plain \
                        else work
                    return f(x_, b, up, dn, seeds[color], offs, color=color,
                             q=q, beta=beta, measuring=measuring, **kw)
                timed(f"int8 clock halo mode {shape} q={q}, "
                      f"{'measuring' if measuring else 'phase a'}", n,
                      functools.partial(call, c8p.sharded_phase),
                      functools.partial(call, c8p.sharded_phase_plain),
                      CLOCK8_PHASE_BYTES * n + halo
                      + (24 * nrep if measuring else 0),
                      n * (clock8_phase_ops()
                           + (OPS_CLOCK8_FUSED if measuring else 0)),
                      2 * L * w)
        else:
            beta = 1.0 / fields["kbt"]
            th = torch.rand((6,) + shape, device=dev) * 6.2832
            sx, sy, ox, oy = (torch.cos(th[0]), torch.sin(th[0]),
                              torch.cos(th[1]), torch.sin(th[1]))
            snap = [torch.cos(th[2]), torch.sin(th[2]), torch.cos(th[3]),
                    torch.sin(th[3])]
            kw = dict(halos_x=(ox[:, -1:].contiguous(),
                               ox[:, :1].contiguous()),
                      halos_y=(oy[:, -1:].contiguous(),
                               oy[:, :1].contiguous()))
            if cols:
                kw.update(cols_x=(ox[:, :, -1:].contiguous(),
                                  ox[:, :, :1].contiguous()),
                          cols_y=(oy[:, :, -1:].contiguous(),
                                  oy[:, :, :1].contiguous()))
            offs = (0, L, w) if cols else (0, L)
            n = sx.numel()
            halo = 8 * nrep * (2 * w + (2 * L if cols else 0))
            wx, wy = sx.clone(), sy.clone()
            modes = ([("Metropolis phase a", xyp.sharded_phase,
                       xyp.sharded_phase_plain, dict(seeds=seeds[0],
                                                     color=0, beta=beta),
                       OPS_XY_METROPOLIS, 0),
                      ("OR phase a", xyp.sharded_or_phase,
                       xyp.sharded_or_phase_plain, dict(color=0),
                       OPS_XY_OVER_RELAX, 0),
                      ("OR measuring", xyp.sharded_or_phase,
                       xyp.sharded_or_phase_plain,
                       dict(color=1, measuring=True),
                       OPS_XY_OVER_RELAX + OPS_XY_MEASURE, 0)]
                     if kind == "xy_or" else
                     [("snapshot mode", xyp.sharded_phase,
                       xyp.sharded_phase_plain,
                       dict(seeds=seeds[1], color=1, beta=beta, snap=snap),
                       OPS_XY_METROPOLIS + OPS_XY_MEASURE + OPS_XY_SNAP,
                       XY_SNAP_BYTES_PER_SITE)])
            for name, fn, plain, extra, ops, snap_bytes in modes:
                def call(f, fresh=False, extra=extra, kw=kw, offs=offs):
                    if fresh or f is not fn:
                        u, v = sx.clone(), sy.clone()
                    else:
                        u, v = wx, wy
                    return f(u, v, ox, oy, offs=offs, **kw, **extra)
                timed(f"XY halo mode {shape}, {name}", n,
                      functools.partial(call, fn),
                      functools.partial(call, plain),
                      (XY_BYTES_PER_SITE + snap_bytes) * n + halo
                      + (32 * nrep if "measuring" in name
                         or "snapshot" in name else 0),
                      n * ops, 2 * L * w)
    return out


def mesh_cx_shares(classes: dict, tcx: dict) -> dict[str, float]:
    """Each clock and XY mesh class's kernel time (its launches at the
    times measured at its shard shape) over its wall."""
    shares = {}
    for label, fields, _, kind, *_ in MESH_CX_CLASSES:
        launches, wall = classes[label][:2]
        t = {k: v[0]["ms"] for k, v in tcx.items()}
        if kind == "clock6":
            n = launches["clock"]["shard_phase"]
            pa, pb = (t[k] for k in t if k.startswith("packed clock"))
            kern = n / 2 * (pa + pb)
        elif kind == "clock8":
            n = launches["clock8"]["halo_phase"]
            pa, pb = (t[k] for k in t if k.startswith("int8 clock"))
            kern = n / 2 * (pa + pb)
        elif kind == "xy_or":
            n = launches["xy"]
            ta = t[next(k for k in t if k.endswith("Metropolis phase a"))]
            to = t[next(k for k in t if k.endswith("OR phase a"))]
            tm = t[next(k for k in t if k.endswith("OR measuring"))]
            kern = (n["halo_metropolis"] * ta
                    + (n["halo_over_relax"] - n["halo_over_relax_measuring"])
                    * to + n["halo_over_relax_measuring"] * tm)
        else:
            n = launches["xy"]["halo_metropolis"]
            ts = t[next(k for k in t if k.endswith("snapshot mode"))]
            kern = n * ts
        shares[label] = kern / (wall * 1e3)
        log(f"  mesh {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share {shares[label]:.3f}")
    return shares


def read_dat(path: Path, max_t: int | None = None) -> np.ndarray:
    """A .dat table's rows; with ``max_t`` only those up to t = max_t
    (the clock curves run to 10^5 sweeps)."""
    rows = []
    with path.open() as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            row = line.split()
            if max_t is not None and float(row[2]) > max_t:
                break
            rows.append(row)
    return np.array(rows, dtype=np.float64)


def row_at(table: np.ndarray, t: int) -> np.ndarray:
    """The row of a .dat table at sweep t."""
    rows = table[table[:, 2] == t]
    if len(rows) != 1:
        fail(f"no single row at t = {t}")
    return rows[0]


def check_against_reference(table: np.ndarray, ref: np.ndarray, nsites: int,
                            samples: int, mcs: int, times,
                            ref_nsites: int | None = None,
                            ref_samples: int | None = None,
                            table_times=None) -> float:
    """<m>(t), <e>(t) within SIGMAS standard errors, with the variance
    taken from the reference's own N·Var columns: of the port's mean
    alone, or, given the reference's sites and samples, of the difference
    of the two means (sigma^2 = N·Var (1/(N n) + 1/(N_ref n_ref))).  The
    table holds every sweep 1..mcs, or the sweeps ``table_times``.
    Returns the largest |z|."""
    ts = np.arange(1, mcs + 1) if table_times is None else np.asarray(
        table_times)
    if table.shape != (len(ts), 10) or not np.all(np.isfinite(table)):
        fail(f"table shape {table.shape} (want ({len(ts)}, 10)) or "
             "non-finite")
    if not np.all(table[:, 1] == samples) or not np.all(table[:, 2] == ts):
        fail("Nsample or t column is wrong")
    ref_term = (0.0 if ref_samples is None
                else 1.0 / (ref_nsites * ref_samples))
    worst = 0.0
    for t in times:
        row, rrow = row_at(table, t), row_at(ref, t)
        for name, col, var_col in (("m", 3, 7), ("e", 4, 8)):
            sigma = math.sqrt(rrow[var_col]
                              * (1.0 / (nsites * samples) + ref_term))
            z = (row[col] - rrow[col]) / sigma
            if len(times) <= 20 or t in (1, 10, 100, 1000):
                log(f"  t={t:5d} <{name}> port {row[col]:.9f} reference "
                    f"{rrow[col]:.9f} sigma {sigma:.3e} z {z:+.2f}")
            worst = max(worst, abs(z))
            if abs(z) > SIGMAS:
                fail(f"<{name}>({t}) is {z:+.2f} sigma from the reference")
    log(f"  largest |z| {worst:.2f} over {len(times)} times")
    return worst


def run_main_path(main_fn, modules, out_dir: Path, label: str, argv,
                  nsites: int, samples: int, mcs: int):
    """The CLI once, with every kernel's launch count set to 0 just before
    and read just after.  Returns ({module: launches}, wall, rate, table,
    header lines)."""
    path = out_dir / f"{label}.dat"
    for mod in modules.values():
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main_fn(list(argv) + ["--init-state", "allup", "--device", "cuda",
                               "--output", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: dict(mod.LAUNCHES) for name, mod in modules.items()}
    if rc != 0:
        fail(f"CLI exited {rc}")
    rate = nsites * mcs * samples / wall
    log(f"  {label}: {samples} samples x {mcs} MCS: {wall:.2f} s, "
        f"{rate:.4g} flip attempts/s end to end, launches {launches}")
    head = [line for line in path.read_text().splitlines()
            if line.startswith("#")]
    return launches, wall, rate, read_dat(path), head


def run_2d(main_fn, modules, out_dir, nx, replicas, samples, mcs, ref,
           times):
    argv = ["--model", "ising2d", "--nx", str(nx), "--ny", str(nx),
            "--kbt", repr(KBT), "--mcs", str(mcs), "--samples",
            str(samples), "--replicas", str(replicas)]
    launches, wall, rate, table, _ = run_main_path(
        main_fn, modules, out_dir, f"ising2d_{nx}", argv, nx * nx, samples,
        mcs)
    check_against_reference(table, ref, nx * nx, samples, mcs, times)
    return launches, wall, rate


def run_3d(main_fn, modules, out_dir, dims, kbt, replicas, samples, mcs,
           ref, times, engine, ref_nsites=None, measure_times=None):
    """One 3-D class (periodic or helical) through the CLI, from all-up,
    against the reference curve ``ref`` at ``times`` with the combined
    sigma (the reference's samples are its rows' Nsample, its sites
    ``ref_nsites``, by default this geometry's).  Returns (launches, wall,
    rate, largest |z|)."""
    nx, ny, nz = dims
    nsites = nx * ny * nz
    argv = ["--model", "ising3d", "--nx", str(nx), "--ny", str(ny), "--nz",
            str(nz), "--kbt", repr(kbt), "--mcs", str(mcs), "--samples",
            str(samples), "--replicas", str(replicas)]
    if measure_times is not None:
        argv += ["--measure-times", *map(str, measure_times)]
    launches, wall, rate, table, head = run_main_path(
        main_fn, modules, out_dir, f"ising3d_{nx}", argv, nsites, samples,
        mcs)
    for line in (f"# nx, ny: {nx} {ny} {nz}", f"# engine: {engine}"):
        if line not in head:
            fail(f"3-D .dat header lacks {line!r}: {head}")
    worst = check_against_reference(
        table, ref, nsites, samples, mcs, times,
        ref_nsites=ref_nsites or nsites, ref_samples=int(ref[0, 1]),
        table_times=measure_times)
    return launches, wall, rate, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cuda_fortran_mc_simulation_spin_tpu_torch.core import rng
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine.sweep import (
        XY_ENGINE,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import Clock2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import _build
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_helical_multispin as chm,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_planes as cp,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_measure_pallas as c8m,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_multisweep as c8ms,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        clock_pallas as c8p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical3d_multispin as h3,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_multispin as hms,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        helical_pallas as hp,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multispin as msb,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_multispin as ms3,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_measure_pallas as i8m,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_multisweep as i8ms,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising2d_pallas as i2p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        ising3d_pallas as i3p,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine.sweep import (
        XY_DISORDER_RESIDENT,
        XY_DISORDER_STREAMED,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.models import XY2D
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_measure_pallas as xym,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_pallas as xyp,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_resident as xyr,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_pallas_angle as xya,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_multisweep as xyi,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.engine.sweep import (
        XY_HELICAL_ANGLE,
        XY_HELICAL_COMPONENT,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense as xhd,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.ops import (
        xy2d_helical_dense_angle as xha,
    )
    from cuda_fortran_mc_simulation_spin_tpu_torch.runs.__main__ import (
        main as cli_main,
    )

    modules = {"ising2d": msb, "helical": hms, "ising3d": ms3,
               "helical3d": h3, "clock": cp, "clock_helical": chm,
               "xy": xyp, "xy_measure": xym, "xy_resident": xyr,
               "xy_helical": xhd, "xy_helical_angle": xha,
               "ising2d_int8": i2p, "ising3d_int8": i3p,
               "ising_int8_measure": i8m, "ising2d_int8_multisweep": i8ms,
               "clock8": c8p, "clock8_measure": c8m,
               "clock8_multisweep": c8ms, "helical_pallas": hp,
               "xy_angle": xya, "xy_int16": xyi}
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"device {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    for path in (REFERENCE_DAT, REFERENCE_3D_DAT, REFERENCE_H3_151,
                 REFERENCE_H3_501, REFERENCE_H3_1001, RACY_H3_1001,
                 CLOCK_2000, CLOCK_2048, CLOCK_501, XY_OR_4000, XY_2000,
                 XY_FD_1500, XY_FIX1_1500, XY_FM_1000, XY_FMS_1000,
                 XY_OR_10001, XY_10001, CLOCK_1000, CLOCK_501_MASKED,
                 XY_10000):
        if not path.exists():
            fail(f"reference curve {path} is missing")
    ref = read_dat(REFERENCE_DAT)
    ref3 = read_dat(REFERENCE_3D_DAT)
    ref_h151 = read_dat(REFERENCE_H3_151)
    ref_h501 = read_dat(REFERENCE_H3_501)
    ref_h1001 = cleaned_1001_curve(read_dat(REFERENCE_H3_1001),
                                   read_dat(RACY_H3_1001))
    ref_c2000 = read_dat(CLOCK_2000, max_t=1000)
    ref_c2048 = read_dat(CLOCK_2048, max_t=1000)
    ref_c501 = read_dat(CLOCK_501, max_t=1000)
    ref_c1000 = read_dat(CLOCK_1000, max_t=1000)
    ref_c501m = read_dat(CLOCK_501_MASKED, max_t=1000)
    ref_xy_or = read_dat(XY_OR_4000, max_t=1000)
    ref_xy = read_dat(XY_2000)
    ref_fd = read_dat(XY_FD_1500, max_t=1000)
    ref_fix1 = read_dat(XY_FIX1_1500, max_t=200)
    ref_fm = read_dat(XY_FM_1000)
    ref_fms = read_dat(XY_FMS_1000)
    ref_xyh_or = read_dat(XY_OR_10001, max_t=1000)
    ref_xyh_1 = read_dat(XY_10001, max_t=100)
    ref_xy10k = read_dat(XY_10000, max_t=200)

    # 1. build from scratch
    log("phase 1: build csrc/*.cu with nvcc")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in sources:
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    secs = _build.build(sources, force=True)
    build_s = time.perf_counter() - t0
    log(f"  built {sources} in {build_s:.1f} s ({secs})")
    for name in sources:
        for line in _build.library_path(name).with_suffix(
                ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"  cooperative grids: 2-D {msb.multisweep_grid_blocks()}, 3-D "
        f"{ms3.multisweep_grid_blocks()}, XY (device-memory ring slots) "
        f"{xyr.gmem_limits(dev)[0]}, int8 2-D "
        f"{i8ms.grid_blocks(16, 1000, 500)}, int8 clock "
        f"{c8ms.grid_blocks(16, 1000, 500)} (both 1000^2 x 16), masked "
        f"helical Ising {hp.grid_blocks(0, False)} (odd N "
        f"{hp.grid_blocks(0, True)}), clock {hp.grid_blocks(1, False)} (odd N "
        f"{hp.grid_blocks(1, True)}), XY int16 (device-memory ring slots) "
        f"{xyi.gmem_limits(dev)[0]} blocks resident")

    # 2. kernels against their plain versions
    log("phase 2: kernels vs plain versions (bitwise)")
    errs = check_kernels(msb, rng, dev, [
        (4, 1024, 1024, 64),     # the bring-up size
        (16, 2048, 2048, 64),    # resident main-path shape
        (4, 8192, 8192, 1),      # streaming main-path shape
        # the chain table's edges: every chain draws 20 words; B8 none
        (4, 1024, 1024, 8, 1e9),
        (4, 1024, 1024, 8, 0.5),
    ])
    err_helical = check_helical(hms, rng, dev)
    errs3 = check_ising3d(msb, ms3, rng, dev)
    errs_h3 = check_helical3d(h3, hms, rng, dev)
    err_clock = check_clock(cp, rng, dev)
    err_clock_h = check_clock_helical(chm, hms, rng, dev)
    err_xy, rel_xy = check_xy(xyp, rng, dev)
    err_xyd, rel_xyd = check_xy_disorder(xyp, xym, xyr, rng, dev)
    err_xyh, rel_xyh = check_xy_helical(xhd, xha, rng, dev)
    check_atan2(xha, dev)
    errs8 = check_int8(i2p, i3p, i8m, i8ms, rng, dev)
    errs_c8 = check_clock8(c8p, c8m, c8ms, rng, dev)
    errs_hp = check_helical_pallas(hp, rng, dev)
    err_xya, rel_xya = check_xy_angle(xya, rng, dev)
    err_xyi, rel_xyi = check_xy_int16(xyi, rng, dev)

    log("phase 2b: first sweep from all-up against its exact expectation")
    check_first_sweep(msb, rng, dev, ref[0], iters=100)
    check_first_sweep_helical(msb, hms, rng, dev, ref[0], iters=80)
    check_first_sweep_3d(ms3, rng, dev, ref3[0], iters=10)
    check_first_sweep_helical3d(h3, ms3, hms, rng, dev, ref3[0],
                                (151, 151, 150), KBT_H3, nrep=128, iters=23)
    check_first_sweep_helical3d(h3, ms3, hms, rng, dev, ref3[0],
                                (501, 501, 500), KBT_H3_501, nrep=8, iters=10)
    z_even = check_first_sweep_even(h3, hms, rng, dev, nrep=250, calls=4,
                                    batch=125, batches=8)
    z_clock = max(
        check_first_sweep_clock(cp, rng, dev, 6, KBT_CLOCK, iters=63),
        check_first_sweep_clock(cp, rng, dev, 6, KBT_CLOCK_08, iters=63),
        check_first_sweep_clock(cp, rng, dev, 4, KBT_CLOCK, iters=63),
        check_first_sweep_clock(cp, rng, dev, 3, KBT_CLOCK, iters=63),
        check_first_sweep_clock_helical(cp, chm, hms, rng, dev, iters=80))
    z_xy = check_xy_phase_a(xyp, rng, dev, iters=160)
    de_or, norm_or = check_xy_over_relax(xyp, dev)
    my_rot, prep_err = check_xy_preparations(dev)
    z_xyh = check_xy_helical_phase_a(xhd, xha, rng, dev, iters=200)
    de_xyh = check_xy_helical_over_relax(xhd, xha, dev)
    z_int8 = check_first_sweep_int8(i2p, i3p, i8m, rng, dev, ref[0], ref3[0])
    z_clock8 = check_first_sweep_clock8(c8p, c8m, rng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        # 3. 2-D resident class through the multisweep kernel
        log("phase 3: 2-D main path, resident class (2048^2 x 16 replicas)")
        res_launch, res_wall, res_rate = run_2d(
            cli_main, modules, out, 2048, 16, 64, 1000, ref,
            (1, 10, 100, 1000))
        if res_launch["ising2d"]["multisweep"] == 0:
            fail("resident main path launched no multisweep kernel")
        # 4. 2-D streaming class through the measuring phase kernel
        log("phase 4: 2-D main path, streaming class (8192^2 x 4 replicas)")
        str_launch, str_wall, str_rate = run_2d(
            cli_main, modules, out, 8192, 4, 4, 200, ref, (1, 10, 100, 200))
        if str_launch["ising2d"]["phase_measuring"] == 0:
            fail("streaming main path launched no measuring phase kernel")
        # 3c. helical 1001x1000 through the helical multisweep kernel
        log("phase 3c: helical path, 1001x1000 x 128 replicas")
        hel_launch, hel_wall, hel_rate, table, head = run_main_path(
            cli_main, modules, out, "helical_1001x1000",
            ["--model", "ising2d", "--nx", "1001", "--ny", "1000", "--kbt",
             repr(KBT), "--mcs", "1000", "--samples", "256", "--replicas",
             "128"], 1001 * 1000, 256, 1000)
        if "# engine: helical_multispin (flat even/odd bit-packed)" \
                not in head:
            fail(f"helical run took another route: {head}")
        check_against_reference(table, ref, 1001 * 1000, 256, 1000,
                                (1, 10, 100, 1000))
        if hel_launch["helical"]["multisweep"] == 0:
            fail("helical path launched no helical multisweep kernel")
        # 4b. 3-D streaming and resident classes
        log("phase 4b: 3-D path, streaming class (512^3 x 8 replicas)")
        s3_launch, s3_wall, s3_rate, _ = run_3d(
            cli_main, modules, out, (512, 512, 512), KBT_3D, 8, 8, 1000,
            ref3, (1, 10, 100, 1000),
            "ising3d_multispin bit-packed (streaming z-plane phases)",
            ref_nsites=512 ** 3)
        if s3_launch["ising3d"]["phase_measuring"] == 0:
            fail("3-D streaming path launched no measuring phase kernel")
        log("phase 4b: 3-D path, resident class (256^3 x 4 replicas)")
        r3_launch, r3_wall, r3_rate, _ = run_3d(
            cli_main, modules, out, (256, 256, 256), KBT_3D, 4, 16, 200,
            ref3, (1, 10, 100),
            "ising3d_multispin bit-packed (resident multisweep)",
            ref_nsites=512 ** 3)
        if r3_launch["ising3d"]["multisweep"] == 0:
            fail("3-D resident path launched no multisweep kernel")
        # 4c. helical 3-D classes
        log("phase 4c: helical 3-D path, resident class (151x151x150 x 128)")
        h1_launch, h1_wall, h1_rate, h1_z = run_3d(
            cli_main, modules, out, (151, 151, 150), KBT_H3, 128, 128, 1000,
            ref_h151, (100, 150, 200, 300, 500, 700, 1000),
            "helical3d_multispin (resident multisweep)")
        if (h1_launch["helical3d"]["multisweep"] == 0
                or h1_launch["helical3d"]["phase"] != 0):
            fail("helical 3-D resident path did not run the multisweep "
                 f"kernel alone: {h1_launch['helical3d']}")
        log("phase 4c: helical 3-D path, streamed odd class (501x501x500 x 2)")
        times_501 = [int(t) for t in ref_h501[:, 2] if t <= 1000]
        h5_launch, h5_wall, h5_rate, h5_z = run_3d(
            cli_main, modules, out, (501, 501, 500), KBT_H3_501, 2, 2, 1000,
            ref_h501, [t for t in times_501 if t >= 100],
            "helical3d_multispin (streamed phases)", measure_times=times_501)
        if h5_launch["helical3d"]["phase_measuring"] == 0:
            fail("helical 3-D streamed odd path launched no measuring phase "
                 "kernel")
        log("phase 4c: helical 3-D path, streamed even class "
            "(1001x1000x1000 x 2)")
        ha_launch, ha_wall, ha_rate, ha_z = run_3d(
            cli_main, modules, out, (1001, 1000, 1000), KBT_H3, 2, 2, 1000,
            ref_h1001, (150, 200, 300, 500, 700, 1000),
            "helical3d_multispin (streamed phases)")
        la = ha_launch["helical3d"]
        if la["energy"] == 0 or la["phase"] != 4 * la["energy"]:
            fail(f"helical 3-D even path did not run 4 phase launches and an "
                 f"energy launch a sweep: {la}")
        # 4d. clock classes
        log("phase 4d: clock path, periodic padded 2000x2000 x 40 replicas")
        cp_launch, cp_wall, cp_rate, cp_z = run_clock(
            cli_main, modules, out, 2000, 2000, KBT_CLOCK, 40, 80, 1000,
            ref_c2000, "clock q=6 bit-sliced packed (padded)")
        if cp_launch["clock"]["phase_measuring"] != 80 // 40 * 1000:
            fail(f"padded clock path: {cp_launch['clock']}")
        log("phase 4d: clock path, periodic aligned 2048x2048 x 16 replicas")
        ca_launch, ca_wall, ca_rate, ca_z = run_clock(
            cli_main, modules, out, 2048, 2048, KBT_CLOCK_08, 16, 32, 1000,
            ref_c2048, "clock q=6 bit-sliced packed")
        if ca_launch["clock"]["phase_measuring"] != 32 // 16 * 1000:
            fail(f"aligned clock path: {ca_launch['clock']}")
        log("phase 4d: clock path, helical 501x500 x 100 replicas")
        ch_launch, ch_wall, ch_rate, ch_z = run_clock(
            cli_main, modules, out, 501, 500, KBT_CLOCK_08, 100, 200, 1000,
            ref_c501, "clock_helical_multispin (bit-sliced packed)")
        if (ch_launch["clock_helical"]["multisweep"] == 0
                or ch_launch["clock"]["phase"] != 0):
            fail(f"helical clock path: {ch_launch}")
        # 4e. XY classes
        log("phase 4e: XY path, over-relaxation class (4000x4000 x 8, "
            "n_over_relax 1)")
        xo_launch, xo_wall, xo_rate, xo_z = run_xy(
            cli_main, modules, out, 4000, KBT_XY, 8, 16, 1000, 1,
            ref_xy_or, XY_ENGINE)
        no_halo = {k: 0 for k in xyp.LAUNCHES if k.startswith("halo_")}
        want = {"metropolis": 4000, "metropolis_measuring": 0,
                "metropolis_snapshot": 0, "over_relax": 4000,
                "over_relax_measuring": 2000, **no_halo}
        if xo_launch["xy"] != want:
            fail(f"XY over-relaxation path: {xo_launch['xy']} != {want}")
        # phase 4l's angle class writes xy2d_4000.dat again: keep this one
        # for phase 4m's mesh class
        (out / "xy2d_4000_component.dat").write_bytes(
            (out / "xy2d_4000.dat").read_bytes())
        log("phase 4e: XY path, Metropolis class (2000x2000 x 32)")
        xm_launch, xm_wall, xm_rate, xm_z = run_xy(
            cli_main, modules, out, 2000, KBT_XY_2000, 32, 64, 100, 0,
            ref_xy, XY_ENGINE)
        want = {"metropolis": 400, "metropolis_measuring": 200,
                "metropolis_snapshot": 0, "over_relax": 0,
                "over_relax_measuring": 0, **no_halo}
        if xm_launch["xy"] != want:
            fail(f"XY Metropolis path: {xm_launch['xy']} != {want}")
        # 4f. XY disorder classes
        disorder = {}
        for label, nx, nrep, samples, mcs, extra, ref_t, moments in (
                ("from-disorder", 1500, 1, 64, 1000, [], ref_fd,
                 ABS_MOMENTS),
                ("from-disorder x2", 1500, 2, 4, 200, [], ref_fd,
                 ABS_MOMENTS),
                ("fix1mcs", 1500, 8, 32, 200, ["--fix1mcs"], ref_fix1,
                 ABS_MOMENTS),
                ("finite-magne", 1000, 20, 40, 100,
                 ["--protocol", "finite_magne", "--init-magne", "0.02"],
                 ref_fm, PARAM_MOMENTS)):
            model = XY2D(nx=nx, ny=nx, kbt=KBT_XY)
            resident = xyr.fits(model, nrep)
            # the resident route's mode: the fit rule of the wrapper
            mode = ("multisweep_smem" if xyr.smem_layout(
                nrep, nx, nx // 2, *xyr.smem_limits(dev)) else "multisweep")
            log(f"phase 4f: XY disorder path, {label} class ({nx}x{nx} x "
                f"{nrep}, {mode if resident else 'streamed'})")
            argv = ["--model", "xy2d", "--protocol", "from_disorder",
                    "--nx", str(nx), "--ny", str(nx), "--kbt", repr(KBT_XY),
                    "--mcs", str(mcs), "--samples", str(samples),
                    "--replicas", str(nrep)] + extra
            disorder[label] = run_xy_disorder(
                cli_main, modules, out, f"xy2d_{label.replace(' ', '_')}",
                argv, nx, samples, mcs, ref_t, moments,
                XY_DISORDER_RESIDENT if resident else XY_DISORDER_STREAMED)
            n = disorder[label][0]
            calls = samples // nrep
            chunks = -(-mcs // 64)
            fix1 = label == "fix1mcs"
            want = {"multisweep": 0, "multisweep_smem": 0,
                    "metropolis_snapshot": calls * mcs}
            if resident:
                want.update({mode: calls * chunks,
                             "metropolis_snapshot": calls if fix1 else 0})
            got = {**n["xy_resident"],
                   "metropolis_snapshot": n["xy"]["metropolis_snapshot"]}
            if (got != want or n["xy_measure"]["measure_snapshot"]
                    != (calls if fix1 else 0)
                    or n["xy"]["metropolis_measuring"] != 0):
                fail(f"XY {label} path: {n} (want {want})")
        log("phase 4f: XY disorder path, finite-magne samples class "
            "(1000x1000, 20 histories)")
        model = XY2D(nx=1000, ny=1000, kbt=KBT_XY)
        fs_res = xyr.fits(model, 1)
        fs_mode = ("multisweep_smem" if xyr.smem_layout(
            1, 1000, 500, *xyr.smem_limits(dev)) else "multisweep")
        fs_launch, fs_wall, fs_rate, table, head = run_main_path(
            cli_main, modules, out, "xy2d_finite_magne_samples",
            ["--model", "xy2d", "--protocol", "finite_magne_samples", "--nx",
             "1000", "--ny", "1000", "--kbt", repr(KBT_XY), "--mcs", "100",
             "--samples", "20", "--init-magne", "0.02"], 1000 * 1000, 20, 100)
        engine = XY_DISORDER_RESIDENT if fs_res else XY_DISORDER_STREAMED
        if f"# engine: {engine}" not in head:
            fail(f"samples run took another route: {head}")
        fs_z = check_samples_table(table, head, ref_fms, 20, 100, 1000 * 1000)
        if (fs_launch["xy_resident"][fs_mode] if fs_res
                else fs_launch["xy"]["metropolis_snapshot"]) == 0:
            fail(f"samples path: {fs_launch}")
        disorder["samples"] = (fs_launch, fs_wall, fs_rate, fs_z)
        # 4g. helical XY classes at the reference's 10001x10000, one
        # replica a sample: the default (angle) engine, then the OR class
        # again on the component engine (the engines' A/B end to end)
        helical = {}
        for label, kbt, samples, mcs, n_or, engine in (
                ("or_angle", KBT_XY, 4, 1000, 1, XY_HELICAL_ANGLE),
                ("metropolis_angle", KBT_XY_2000, 4, 100, 0,
                 XY_HELICAL_ANGLE),
                ("or_component", KBT_XY, 4, 1000, 1, XY_HELICAL_COMPONENT)):
            log(f"phase 4g: helical XY path, {label} class (10001x10000 x 1,"
                f" {samples} samples, {mcs} MCS)")
            angle = engine == XY_HELICAL_ANGLE
            os.environ["SPINLAT_XY_DENSE_ANGLE"] = "1" if angle else "0"
            try:
                n, wall, rate, table = run_xy_helical(
                    cli_main, modules, out, f"xy2d_helical_{label}", kbt,
                    samples, mcs, n_or, engine)
            finally:
                os.environ.pop("SPINLAT_XY_DENSE_ANGLE", None)
            if n_or:
                z = check_against_reference(
                    table, ref_xyh_or, HX * HY, samples, mcs,
                    range(1, mcs + 1), ref_nsites=int(ref_xyh_or[0, 0]),
                    ref_samples=int(ref_xyh_or[0, 1]))
            else:
                z = max(check_against_reference(
                    table, ref_xy, HX * HY, samples, mcs, range(1, mcs + 1),
                    ref_nsites=int(ref_xy[0, 0]),
                    ref_samples=int(ref_xy[0, 1])),
                    check_one_sample_curve(table, ref_xyh_1, ref_xy,
                                           HX * HY, samples, mcs))
            mod, other = (("xy_helical_angle", "xy_helical") if angle
                          else ("xy_helical", "xy_helical_angle"))
            sweeps = samples * mcs
            want = {"phase": 2 * sweeps,
                    "phase_measuring": 0 if n_or else sweeps,
                    "or": 2 * sweeps if n_or else 0,
                    "or_measuring": sweeps if n_or else 0}
            got = {k: n[mod][k] for k in want}
            if got != want or any(n[other].values()) or n["xy"]["metropolis"]:
                fail(f"helical XY {label} path: {n} (want {mod}: {want})")
            helical[label] = (n, wall, rate, z)
        # 4h. periodic Ising at shapes the bit-packed engines refuse, on the
        # int8 kernels: the multisweep, the streamed phase and measure
        # launches, one history at a time, and 3-D
        int8 = run_int8_classes(cli_main, modules, out, ref, ref3)
        # 4i. the clock at every q and shape the packed engines refuse, on
        # the int8 clock kernels
        clock8 = run_clock8_classes(cli_main, modules, out, ref, ref_c1000,
                                    dev)
        # 4j. every helical 2-D shape on the masked helical kernels
        hpc = run_hp_classes(cli_main, modules, out, ref, ref_c501, ref_c501m,
                             ref_xyh_or, ref_xy, dev)
        # 4l. the periodic XY angle engines under the JAX switches
        xya_cls = run_xya_classes(cli_main, modules, out, ref_xy, ref_xy10k,
                                  ref_xy_or, ref_fm, ref_fd)
        # 4m. periodic Ising on a mesh of the card repeated, bitwise against
        # the unsharded classes' tables
        t_mesh = time.perf_counter()
        mesh_cls = run_mesh_classes(
            modules, out, ref, ref3, dev,
            {"2-D streaming 8192^2 x 4": str_rate,
             "3-D streaming 512^3 x 8": s3_rate,
             **{k: int8[k][2] for k in ("2-D streamed 4000^2 x 8",
                                        "3-D 500^3 x 2")}})
        mesh_cx = run_mesh_cx_classes(
            modules, out, {"clock6": ref_c2048, "xy_or": ref_xy_or,
                           "fix1": ref_fix1}, dev,
            {"clock aligned 2048^2 x 16": ca_rate,
             "streamed q=5 2000^2 x 16":
                 clock8["streamed q=5 2000^2 x 16"][2],
             "XY OR 4000^2 x 8": xo_rate,
             "fix1mcs": disorder["fix1mcs"][2]})
        mesh_wall = time.perf_counter() - t_mesh
    # with neither switch set the XY classes kept their engines
    for p in (xo_launch, xm_launch, *(d[0] for d in disorder.values()),
              *(h[0] for h in helical.values())):
        if any(p["xy_angle"].values()) or any(p["xy_int16"].values()):
            fail(f"an XY class without a switch launched an angle kernel: "
                 f"{p['xy_angle']}, {p['xy_int16']}")
    paths = (res_launch, str_launch, hel_launch, s3_launch, r3_launch,
             h1_launch, h5_launch, ha_launch, cp_launch, ca_launch,
             ch_launch, xo_launch, xm_launch,
             *(d[0] for d in disorder.values()),
             *(h[0] for h in helical.values()),
             *(c[0] for c in int8.values()),
             *(c[0] for c in clock8.values()),
             *(c[0] for c in hpc.values()),
             *(c[0] for c in xya_cls.values()),
             *(c[0] for c in mesh_cls.values()),
             *(c[0] for c in mesh_cx.values()))

    def launched(module: str, kernel: str) -> int:
        return sum(p[module][kernel] for p in paths)

    # 5. times at the main paths' shapes
    log("phase 5: kernel times (CUDA events)")
    beta, beta3 = 1.0 / KBT, 1.0 / KBT_3D
    seeds = msb.sweep_seed_pairs(rng.sample_key(rng.base_key(11), 0), 64)
    sweeps = seeds.shape[0]

    def sweep_ops(per_word, words: int) -> float:
        """Instructions of S sweeps: phase a plain, phase b measuring."""
        return words * sweeps * (per_word(False) + per_word(True))

    x, o = random_words((4, 8192 // 32, 4096), 3, dev, n=2)
    t1, e1 = time_kernel(
        "phase kernel 8192^2 x 4, measuring", x.numel() * 32,
        lambda: msb.phase_packed(x, o, seeds[0, 1], color=1, beta=beta,
                                 measuring=True),
        lambda: msb.phase_packed_plain(x, o, seeds[0, 1], color=1,
                                       beta=beta, measuring=True),
        3 * 4 * x.numel() + 2 * 8 * x.shape[0],
        x.numel() * phase_ops_per_word(msb, beta, True), reps=20,
        plain_reps=2)
    wa, wb = random_words((16, 2048 // 32, 1024), 5, dev, n=2)
    t2, e2 = time_kernel(
        f"multisweep kernel 2048^2 x 16, S={sweeps}",
        wa.numel() * 64 * sweeps,
        lambda: msb.multisweep_planes(wa, wb, seeds, beta=beta),
        lambda: msb.multisweep_planes_plain(wa, wb, seeds, beta=beta),
        4 * 4 * wa.numel() + 2 * 8 * wa.shape[0] * sweeps,
        sweep_ops(lambda m: phase_ops_per_word(msb, beta, m), wa.numel()),
        reps=5, plain_reps=1)
    # the helical path's launch: 128 x 1001x1000, S=64
    hm = 1001 * 1000 // 2
    ha, hb = random_words((128, hms.words(hm)), 12, dev, n=2)
    hkw = dict(beta=beta, nx=1001, m=hm)
    hvm = hms.valid_mask(hm, dev)
    t3, e3 = time_kernel(
        f"helical multisweep kernel 1001x1000 x 128, S={sweeps}",
        128 * 1001 * 1000 * sweeps,
        lambda: hms.multisweep_planes(ha, hb, seeds, **hkw),
        lambda: hms.multisweep_plain(ha, hb, seeds, **hkw),
        4 * 4 * ha.numel() + 2 * 8 * ha.shape[0] * sweeps,
        sweep_ops(lambda m: helical_phase_ops_per_word(msb, beta, m),
                  ha.numel()), reps=5, plain_reps=1,
        view=lambda out: (hms._u32(out[0]) & hvm, hms._u32(out[1]) & hvm,
                          out[2]))
    # the 3-D streaming class: 8 x 512^3, measuring
    x3, o3 = random_words((8, 512, 16, 256), 13, dev, n=2)
    t4, e4 = time_kernel(
        "3-D phase kernel 512^3 x 8, measuring", x3.numel() * 32,
        lambda: ms3.phase3d_packed(x3, o3, seeds[0, 1], color=1,
                                   beta=beta3, measuring=True),
        lambda: ms3.phase3d_plain(x3, o3, seeds[0, 1], color=1,
                                  beta=beta3, measuring=True),
        3 * 4 * x3.numel() + 2 * 8 * x3.shape[0],
        x3.numel() * phase3d_ops_per_word(msb, ms3, beta3, True), reps=10,
        plain_reps=1)
    del x3, o3
    # the 3-D resident class: 4 x 256^3, S=64
    ra, rb = random_words((4, 256, 8, 128), 14, dev, n=2)
    t5, e5 = time_kernel(
        f"3-D multisweep kernel 256^3 x 4, S={sweeps}",
        ra.numel() * 64 * sweeps,
        lambda: ms3.multisweep3d_planes(ra, rb, seeds, beta=beta3),
        lambda: ms3.multisweep3d_plain(ra, rb, seeds, beta=beta3),
        4 * 4 * ra.numel() + 2 * 8 * ra.shape[0] * sweeps,
        sweep_ops(lambda m: phase3d_ops_per_word(msb, ms3, beta3, m),
                  ra.numel()), reps=3, plain_reps=1)
    del ra, rb
    # helical 3-D: the even class's sub-phase, 1001x1000x1000 x 2, zsub 0
    # (4000 of the phase kernel's 6000 main-path launches); chains only
    # on the words holding a site of that z-parity
    beta_h = 1.0 / KBT_H3
    hg = dict(nx=1001, nxy=1001 * 1000, m=1001 * 1000 * 1000 // 2)
    hw = hms.words(hg["m"])
    za, zb = random_words((2, hw), 15, dev, n=2)
    zsel = h3.zmask_words(hg["nxy"], hg["m"], dev) & hms.valid_mask(hg["m"],
                                                                   dev)
    sub_sites = 2 * int(msb._pc_plane(zsel).sum())
    sub_words = 2 * int((zsel != 0).sum())
    hvm3 = hms.valid_mask(hg["m"], dev)
    t6, e6 = time_kernel(
        "helical3d phase kernel 1001x1000x1000 x 2, z-parity sub-phase",
        sub_sites,
        lambda: h3.phase_packed(za, zb, seeds[0, 0], color=0, zsub=0,
                                beta=beta_h, **hg),
        lambda: h3.phase_plain(za, zb, seeds[0, 0], color=0, zsub=0,
                               beta=beta_h, **hg),
        12 * 2 * hw,
        sub_words * helical3d_phase_ops_per_word(msb, ms3, beta_h, False)
        + 2 * hw * OPS_ZMASK, reps=10, plain_reps=1,
        view=lambda out: (hms._u32(out) & hvm3,))
    t7, e7 = time_kernel(
        "helical3d energy kernel 1001x1000x1000 x 2", 2 * 2 * hg["m"],
        lambda: h3.energy_sums(za, zb, **hg),
        lambda: h3.energy_sums_plain(za, zb, **hg),
        4 * 2 * 2 * hw + 2 * 16, 2 * hw * OPS_ENERGY, reps=20, plain_reps=2)
    del za, zb, zsel
    # the odd streamed class's measuring phase, 501x501x500 x 2
    g5 = dict(nx=501, nxy=501 * 501, m=501 * 501 * 500 // 2)
    w5 = hms.words(g5["m"])
    fa, fb = random_words((2, w5), 18, dev, n=2)
    vm5 = hms.valid_mask(g5["m"], dev)
    beta5 = 1.0 / KBT_H3_501
    t6b, e6b = time_kernel(
        "helical3d phase kernel 501x501x500 x 2, measuring", 2 * g5["m"],
        lambda: h3.phase_packed(fb, fa, seeds[0, 1], color=1, beta=beta5,
                                measuring=True, **g5),
        lambda: h3.phase_plain(fb, fa, seeds[0, 1], color=1, beta=beta5,
                               measuring=True, **g5),
        12 * 2 * w5 + 2 * 16,
        2 * w5 * helical3d_phase_ops_per_word(msb, ms3, beta5, True),
        reps=20, plain_reps=1, graphed=True,
        view=lambda out: (hms._u32(out[0]) & vm5, out[1]))
    del fa, fb
    # the resident class's launch shape, 128 x 151x151x150: the kernel
    # alone at its S = 64, then kernel and plain version at S = 8 (the
    # plain version takes ~0.4 s a sweep there; the row's times are S = 8)
    g1 = dict(nx=151, nxy=151 * 151, m=151 * 151 * 150 // 2)
    w1 = hms.words(g1["m"])
    ma, mb = random_words((128, w1), 19, dev, n=2)
    vm1 = hms.valid_mask(g1["m"], dev)
    ms_h3_64 = cuda_time_ms(
        lambda: h3.multisweep_planes(ma, mb, seeds, beta=beta_h, **g1),
        reps=3)
    log(f"  helical3d multisweep kernel 151x151x150 x 128, S={sweeps}: "
        f"{ms_h3_64:.4f} ms/launch")
    s8 = 8
    t8, e8 = time_kernel(
        f"helical3d multisweep kernel 151x151x150 x 128, S={s8}",
        128 * 2 * g1["m"] * s8,
        lambda: h3.multisweep_planes(ma, mb, seeds[:s8], beta=beta_h, **g1),
        lambda: h3.multisweep_plain(ma, mb, seeds[:s8], beta=beta_h, **g1),
        4 * 4 * 128 * w1 + 2 * 8 * 128 * s8,
        sweep_ops(lambda meas: helical3d_phase_ops_per_word(
            msb, ms3, beta_h, meas), 128 * w1) * s8 / sweeps, reps=5,
        plain_reps=1,
        view=lambda out: (hms._u32(out[0]) & vm1, hms._u32(out[1]) & vm1,
                          out[2]))
    del ma, mb
    # the clock paths' launches: the padded class's phase at 2000^2 x 40,
    # q = 6, kbt 0.91, plain and measuring; the helical class's 64 sweeps
    # at 501x500 x 100, kbt 0.8
    spec6 = clock_specs()[6]
    beta_c = 1.0 / KBT_CLOCK
    cw = clock_words(dev, 40, 63, 1000, 6, 20, 2000, cp)
    cx, co = tuple(cw[:3]), tuple(cw[3:])
    nw_c = 40 * 63 * 1000
    c_kw = dict(color=0, beta=beta_c, ny=2000)
    t9, e9 = time_kernel(
        "clock phase kernel 2000^2 x 40, q=6", 40 * 2000 * 1000,
        lambda: cp.phase_packed(spec6, cx, co, seeds[0, 0], **c_kw),
        lambda: cp.phase_plain(spec6, cx, co, seeds[0, 0], **c_kw),
        3 * 3 * 4 * nw_c,
        nw_c * clock_phase_ops_per_word(msb, cp, spec6, beta_c, False),
        reps=20, plain_reps=1)
    c_kw = dict(color=1, beta=beta_c, ny=2000, measuring=True)
    t9m, e9m = time_kernel(
        "clock phase kernel 2000^2 x 40, q=6, measuring", 40 * 2000 * 1000,
        lambda: cp.phase_packed(spec6, co, cx, seeds[0, 1], **c_kw),
        lambda: cp.phase_plain(spec6, co, cx, seeds[0, 1], **c_kw),
        3 * 3 * 4 * nw_c + 2 * 8 * 40,
        nw_c * clock_phase_ops_per_word(msb, cp, spec6, beta_c, True),
        reps=20, plain_reps=1,
        view=lambda out: (*out[0], out[1]))
    host_p = host_ms_per_sweep(cp, spec6, Clock2D(nx=2000, ny=2000,
                                                  kbt=KBT_CLOCK, q=6),
                               cx, co, seeds)
    del cw, cx, co
    # the aligned class's phase at 2048^2 x 16, q = 6, kbt 0.8
    beta_a = 1.0 / KBT_CLOCK_08
    aw = clock_words(dev, 16, 64, 1024, 6, 22, 2048, cp)
    ax, ao = tuple(aw[:3]), tuple(aw[3:])
    nw_a = 16 * 64 * 1024
    a_kw = dict(color=0, beta=beta_a, ny=2048)
    t11, e11 = time_kernel(
        "clock phase kernel 2048^2 x 16, q=6", 16 * 2048 * 1024,
        lambda: cp.phase_packed(spec6, ax, ao, seeds[0, 0], **a_kw),
        lambda: cp.phase_plain(spec6, ax, ao, seeds[0, 0], **a_kw),
        3 * 3 * 4 * nw_a,
        nw_a * clock_phase_ops_per_word(msb, cp, spec6, beta_a, False),
        reps=20, plain_reps=1)
    a_kw = dict(color=1, beta=beta_a, ny=2048, measuring=True)
    t11m, e11m = time_kernel(
        "clock phase kernel 2048^2 x 16, q=6, measuring", 16 * 2048 * 1024,
        lambda: cp.phase_packed(spec6, ao, ax, seeds[0, 1], **a_kw),
        lambda: cp.phase_plain(spec6, ao, ax, seeds[0, 1], **a_kw),
        3 * 3 * 4 * nw_a + 2 * 8 * 16,
        nw_a * clock_phase_ops_per_word(msb, cp, spec6, beta_a, True),
        reps=20, plain_reps=1,
        view=lambda out: (*out[0], out[1]))
    host_a = host_ms_per_sweep(cp, spec6, Clock2D(nx=2048, ny=2048,
                                                  kbt=KBT_CLOCK_08, q=6),
                               ax, ao, seeds)
    del aw, ax, ao
    cm_ = 501 * 500 // 2
    cnw = hms.words(cm_)
    hv = random_words((100, cnw), 21, dev, n=6)
    ha3, hb3 = tuple(hv[:3]), tuple(hv[3:])
    beta_h8 = 1.0 / KBT_CLOCK_08
    cvm = hms.valid_mask(cm_, dev)
    t10, e10 = time_kernel(
        f"helical clock multisweep kernel 501x500 x 100, S={sweeps}",
        100 * 501 * 500 * sweeps,
        lambda: chm.multisweep_planes(ha3, hb3, seeds, beta=beta_h8, nx=501,
                                      m=cm_),
        lambda: chm.multisweep_plain(ha3, hb3, seeds, beta=beta_h8, nx=501,
                                     m=cm_),
        6 * 2 * 4 * 100 * cnw + 3 * 8 * 100 * sweeps,
        100 * cnw * sweeps * (
            2 * (clock_phase_ops_per_word(msb, cp, spec6, beta_h8, False)
                 - OPS_CLOCK_STENCIL[6] + OPS_CLOCK_HELICAL_READS)
            + OPS_CLOCK_MEASURE[6] + OPS_CLOCK_MY + OPS_HELICAL_MASKS),
        reps=3, plain_reps=1,
        view=lambda out: tuple(hms._u32(w) & cvm for w in out[0] + out[1])
        + (out[2],))
    # the wrapper against its launch alone: the C entry on keys and a draw
    # table already set up (the wrapper adds its checks, the table's
    # lookup and the keys' pinned copy)
    hlib, hkeys = chm._lib(), multispin_keys_on(seeds, dev)
    htable = chm._table_arg(chm.SPEC, beta_h8)
    hda, hdb = ([d % cm_ for d in offs] for offs in hms.helical_offsets(501))
    hstaged = int(chm.staged_fits(cnw, dev))
    houts = [torch.empty_like(ha3[0]) for _ in range(6)]
    hobs = torch.empty((100, len(seeds), 3), dtype=torch.int64, device=dev)

    def h_alone():
        code = hlib.clock_helical_multisweep(
            *[w.data_ptr() for w in (*ha3, *hb3, *houts)], hkeys.data_ptr(),
            None, hobs.data_ptr(), 100, cnw, cm_, len(seeds), 0, hstaged,
            *hda, *hdb, htable, torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"helical clock multisweep launch alone: code {code}")
    h_wrap = chm.multisweep_planes(ha3, hb3, seeds, beta=beta_h8, nx=501,
                                   m=cm_)
    h_alone()
    if max_abs_err([(hms._u32(g) & cvm, hms._u32(w) & cvm)
                    for g, w in zip(houts, h_wrap[0] + h_wrap[1])]
                   + [(hobs, h_wrap[2])]) != 0:
        fail("helical clock multisweep: the launch alone differs from the "
             "wrapper")
    wrap, just = wrapper_and_alone(
        lambda: chm.multisweep_planes(ha3, hb3, seeds, beta=beta_h8, nx=501,
                                      m=cm_), h_alone)
    log(f"  helical clock multisweep kernel 501x500 x 100, S={len(seeds)}, "
        f"in turns: the wrapper {wrap}, the launch alone {just} ms")
    del hv, ha3, hb3, houts, h_wrap
    if max(e1, e2, e3, e4, e5, e6, e6b, e7, e8, e9, e9m, e10, e11,
           e11m) != 0:
        fail(f"a kernel differs from its plain version at its main-path "
             f"launch shape (max abs errs {e1}, {e2}, {e3}, {e4}, {e5}, "
             f"{e6}, {e6b}, {e7}, {e8}, {e9}, {e9m}, {e10}, {e11}, "
             f"{e11m})")
    # each clock class's kernel time a sweep against its wall a sweep (the
    # phase times on random states: the draws do not depend on the data)
    for label, t, tm, host, launch, wall in (
            ("padded 2000^2 x 40", t9, t9m, host_p, cp_launch, cp_wall),
            ("aligned 2048^2 x 16", t11, t11m, host_a, ca_launch, ca_wall)):
        n, nm = (launch["clock"][k] for k in ("phase", "phase_measuring"))
        kern = (n - nm) * t["ms"] + nm * tm["ms"]
        log(f"  clock {label}: kernel {(t['ms'] + tm['ms']):.4f} ms a "
            f"sweep, host {host:.4f} ms a sweep, wall "
            f"{wall * 1e3 / nm:.4f} ms a sweep; kernel share of the wall "
            f"{kern / (wall * 1e3):.3f}")
    kern = 200 // 100 * 1000 / sweeps * t10["ms"]
    log(f"  clock helical 501x500 x 100: kernel share of the wall "
        f"{kern / (ch_wall * 1e3):.3f}")

    # the XY paths' launches: phases at 4000x4000 x 8 (both classes move
    # 6.4e7 sites a phase), Philox, kbt 0.89, plain and measuring; then
    # the Metropolis class's own launch at 2000x2000 x 32, kbt 0.895
    xs = xy_state(dev, 8, 4000, 4000, 23)
    x_sites = 8 * 4000 * 2000
    x_bytes = XY_BYTES_PER_SITE * x_sites
    beta_x = 1.0 / KBT_XY
    metro_a = dict(color=0, beta=beta_x)
    metro_b = dict(color=1, beta=beta_x, measuring=True)
    obs_bytes = 8 * 3 * 8
    t12, e12 = time_xy(
        "xy metropolis kernel 4000^2 x 8",
        lambda *p: xyp.metropolis_phase(*p, seeds[0, 0], **metro_a),
        lambda *p: xyp.metropolis_phase_plain(*p, seeds[0, 0], **metro_a),
        xs, x_bytes, x_sites * OPS_XY_METROPOLIS, reps=50, plain_reps=2)
    t12m, e12m = time_xy(
        "xy metropolis kernel 4000^2 x 8, measuring",
        lambda *p: xyp.metropolis_phase(*p, seeds[0, 1], **metro_b),
        lambda *p: xyp.metropolis_phase_plain(*p, seeds[0, 1], **metro_b),
        xy_by_color(xs, 1), x_bytes + obs_bytes,
        x_sites * (OPS_XY_METROPOLIS + OPS_XY_MEASURE), reps=50,
        plain_reps=2)
    t13, e13 = time_xy(
        "xy over-relaxation kernel 4000^2 x 8",
        lambda *p: xyp.over_relax_phase(*p, color=0),
        lambda *p: xyp.over_relax_phase_plain(*p, color=0),
        xs, x_bytes, x_sites * OPS_XY_OVER_RELAX, reps=50, plain_reps=2)
    t13m, e13m = time_xy(
        "xy over-relaxation kernel 4000^2 x 8, measuring",
        lambda *p: xyp.over_relax_phase(*p, color=1, measuring=True),
        lambda *p: xyp.over_relax_phase_plain(*p, color=1, measuring=True),
        xy_by_color(xs, 1), x_bytes + obs_bytes,
        x_sites * (OPS_XY_OVER_RELAX + OPS_XY_MEASURE), reps=50,
        plain_reps=2)
    del xs
    x2 = xy_state(dev, 32, 2000, 2000, 24)
    x2_sites = 32 * 2000 * 1000
    x2_obs_bytes = 32 * 3 * 8
    metro_2a = dict(color=0, beta=1.0 / KBT_XY_2000)
    metro_2b = dict(color=1, beta=1.0 / KBT_XY_2000, measuring=True)
    t_x2, e_x2 = time_xy(
        "xy metropolis kernel 2000^2 x 32",
        lambda *p: xyp.metropolis_phase(*p, seeds[0, 0], **metro_2a),
        lambda *p: xyp.metropolis_phase_plain(*p, seeds[0, 0], **metro_2a),
        x2, XY_BYTES_PER_SITE * x2_sites, x2_sites * OPS_XY_METROPOLIS,
        reps=50, plain_reps=2)
    t_x2m, e_x2m = time_xy(
        "xy metropolis kernel 2000^2 x 32, measuring",
        lambda *p: xyp.metropolis_phase(*p, seeds[0, 1], **metro_2b),
        lambda *p: xyp.metropolis_phase_plain(*p, seeds[0, 1], **metro_2b),
        xy_by_color(x2, 1), XY_BYTES_PER_SITE * x2_sites + x2_obs_bytes,
        x2_sites * (OPS_XY_METROPOLIS + OPS_XY_MEASURE), reps=50,
        plain_reps=2)
    del x2
    if max(e12, e12m, e13, e13m, e_x2, e_x2m) != 0.0:
        fail(f"an XY kernel differs from its plain version at its main-path "
             f"launch shape ({e12}, {e12m}, {e13}, {e13m}, {e_x2}, "
             f"{e_x2m})")
    # each XY class's kernel time against its wall
    xy_kern = {}
    for label, launch, wall, tm, tmm in (
            ("over-relaxation 4000^2 x 8", xo_launch, xo_wall, t12["ms"],
             t12m["ms"]),
            ("Metropolis 2000^2 x 32", xm_launch, xm_wall, t_x2["ms"],
             t_x2m["ms"])):
        n = launch["xy"]
        kern = ((n["metropolis"] - n["metropolis_measuring"]) * tm
                + n["metropolis_measuring"] * tmm
                + (n["over_relax"] - n["over_relax_measuring"]) * t13["ms"]
                + n["over_relax_measuring"] * t13m["ms"])
        xy_kern[label] = kern / (wall * 1e3)
        log(f"  xy {label}: kernel {kern / 1e3:.3f} s of a {wall:.3f} s "
            f"wall; kernel share of the wall {xy_kern[label]:.3f}")

    # the XY disorder classes' launches: the snapshot mode at 1500^2 x 8
    # (fix1mcs, 800 of its 1000 main-path launches) and 1000^2 x 20
    # (finite-magne, the other 200), state and sums against the plain
    # version; measure_kernel with the snapshot at 1500^2 x 8 (fix1mcs,
    # t = 1); the multisweep at every (shape, S) the resident classes
    # launch: 1500^2 x 1 with S = 64 and 40 (from-disorder's 15 + 1
    # chunks of 1000 sweeps), 1000^2 x 1 with S = 64 and 36 (samples)
    snap_t, snap_err, snap_rel = {}, 0.0, 0.0
    for nrep, n in ((8, 1500), (20, 1000)):
        st, snap = xy_disorder_state(dev, nrep, n, n, 60 + nrep)
        sites = nrep * n * n // 2
        planes = xy_by_color(list(st), 1)
        snap_kw = dict(color=1, beta=beta_x, snap=xy_by_color(list(snap), 1))
        snap_t[n], err = time_xy(
            f"xy metropolis kernel, snapshot mode, {n}^2 x {nrep}",
            lambda *p: xyp.metropolis_phase(*p, seeds[0, 1], **snap_kw),
            lambda *p: xyp.metropolis_phase_plain(*p, seeds[0, 1],
                                                  **snap_kw),
            planes,
            (XY_BYTES_PER_SITE + XY_SNAP_BYTES_PER_SITE) * sites
            + nrep * 4 * 8,
            sites * (OPS_XY_METROPOLIS + OPS_XY_MEASURE + OPS_XY_SNAP),
            reps=50, plain_reps=2)
        got = xyp.metropolis_phase(*(p.clone() for p in planes), seeds[0, 1],
                                   **snap_kw)[2]
        want = xyp.metropolis_phase_plain(*(p.clone() for p in planes),
                                          seeds[0, 1], **snap_kw)[2]
        snap_err = max(snap_err, err)
        snap_rel = max(snap_rel, sums_rel_err(got, want))
        del st, snap, planes
    st, snap = xy_disorder_state(dev, 8, 1500, 1500, 70)
    pairs = 8 * 1500 * 750
    t_meas, rel_meas, err_meas = time_sums(
        "xy measure kernel 1500^2 x 8, snapshot",
        lambda: xym.measure_sums(st, snap),
        lambda: xym.measure_sums_plain(st, snap),
        XY_MEASURE_BYTES_PAIR * pairs + 8 * 4 * 8,
        OPS_XY_MEASURE_PAIR * pairs, reps=50, plain_reps=3)
    del st, snap
    # the two modes of the multisweep: smem_multisweep_kernel at every
    # (shape, S) the resident classes launch, gmem_multisweep_kernel past
    # the shared-memory fit at 1500^2 x 2 (the from-disorder x2 class's
    # batch: 6 launches of 64 and 2 of 8) and x 3 (the route bound's
    # batch), S = 64 and 8
    ms_t, ms_err, ms_rel = {}, {"smem": 0.0, "gmem": 0.0}, 0.0
    for n, nrep, sw in ((1500, 1, 64), (1500, 1, 40), (1000, 1, 64),
                        (1000, 1, 36), (1500, 2, 64), (1500, 2, 8),
                        (1500, 3, 64), (1500, 3, 8)):
        ms_t[n, nrep, sw], err, rel = time_multisweep(
            xyr, dev, n, seeds[:sw], beta_x, 71 + sw, nrep)
        mode = ms_t[n, nrep, sw].pop("mode")
        ms_err[mode], ms_rel = max(ms_err[mode], err), max(ms_rel, rel)
    t_ms, t_gmem = ms_t[1500, 1, 64], ms_t[1500, 2, 64]
    if max(snap_err, *ms_err.values()) != 0.0 or max(
            snap_rel, rel_meas, ms_rel) > 1e-9:
        fail(f"an XY disorder kernel differs from its plain version at its "
             f"main-path launch shape (state {snap_err}, {ms_err}; sums "
             f"{snap_rel:.3g}, {rel_meas:.3g}, {ms_rel:.3g})")
    xy_routes = compare_xy_routes(xyp, xyr, dev, seeds)
    # the from-disorder class's kernel time against its wall: each call
    # (one replica) runs 1000 sweeps as 15 launches of 64 and one of 40
    fd_launch, fd_wall = disorder["from-disorder"][:2]
    fd_calls, fd_left = divmod(fd_launch["xy_resident"]["multisweep_smem"],
                               16)
    if (fd_left or fd_launch["xy"]["metropolis_snapshot"]
            or fd_launch["xy_resident"]["multisweep"]):
        fail(f"from-disorder launches: {fd_launch}")
    fd_kern = fd_calls * (15 * t_ms["ms"] + ms_t[1500, 1, 40]["ms"])
    log(f"  xy from-disorder 1500^2 x 1: kernel {fd_kern / 1e3:.3f} s of a "
        f"{fd_wall:.3f} s wall; kernel share {fd_kern / (fd_wall * 1e3):.3f}")
    # the x2 class: each call (two replicas) runs 200 sweeps as 3 launches
    # of 64 and one of 8 in the device-memory mode
    x2_launch, x2_wall = disorder["from-disorder x2"][:2]
    x2_calls = x2_launch["xy_resident"]["multisweep"] // 4
    x2_kern = x2_calls * (3 * t_gmem["ms"] + ms_t[1500, 2, 8]["ms"])
    log(f"  xy from-disorder 1500^2 x 2: kernel {x2_kern / 1e3:.4f} s of a "
        f"{x2_wall:.3f} s wall; kernel share {x2_kern / (x2_wall * 1e3):.3f}")

    # the helical XY phases at the classes' launch, both engines, A/B
    xyh_t, xyh_err = time_xy_helical(xhd, xha, dev, seeds)
    if xyh_err != 0.0:
        fail(f"a helical XY kernel differs from its plain version at its "
             f"main-path launch shape ({xyh_err})")

    def helical_ms(label: str, engine: str) -> tuple[float, float]:
        """(kernel ms a sweep from the median reading, kernel share of the
        class's wall)."""
        def med(case):
            return sorted(t["ms"] for t in xyh_t[f"{engine} {case}"])[1]
        n, wall = helical[label][:2]
        mod = "xy_helical_angle" if engine == "angle" else "xy_helical"
        k = n[mod]
        kern = ((k["phase"] - k["phase_measuring"]) * med("phase")
                + k["phase_measuring"] * med("phase, measuring")
                + (k["or"] - k["or_measuring"]) * med("or")
                + k["or_measuring"] * med("or, measuring"))
        sweeps = (k["phase"] // 2)
        return kern / sweeps, kern / (wall * 1e3)

    xyh_share = {}
    for label, engine in (("or_angle", "angle"),
                          ("metropolis_angle", "angle"),
                          ("or_component", "component")):
        per_sweep, share = helical_ms(label, engine)
        n, wall = helical[label][:2]
        xyh_share[label] = share
        log(f"  xy helical {label}: kernel {per_sweep:.4f} ms a sweep, wall "
            f"{wall * 1e3 / (n['xy_helical_angle' if engine == 'angle' else 'xy_helical']['phase'] // 2):.4f} ms a sweep; kernel "
            f"share of the wall {share:.3f}")
    log("  xy helical A/B end to end, OR class: angle "
        f"{helical['or_angle'][1]:.2f} s, component "
        f"{helical['or_component'][1]:.2f} s, angle / component "
        f"{helical['or_angle'][1] / helical['or_component'][1]:.3f}")

    compare_routes(msb, dev, beta, seeds)
    compare_routes_3d(ms3, dev, seeds[:32])
    route_h3 = compare_routes_helical3d(h3, hms, dev, seeds)

    # the int8 kernels at their classes' launch shapes, each class's kernel
    # share of its wall, and the int8 route reading
    ti8 = time_int8_kernels(i2p, i3p, i8m, i8ms, rng, dev)
    ei8 = max(err for _, err in ti8.values())
    if ei8 != 0:
        fail(f"an int8 kernel differs from its plain version at its "
             f"main-path launch shape ({ {k: v[1] for k, v in ti8.items()} })")
    int8_share = int8_shares(int8, ti8)
    int8_routes = compare_int8_routes(i2p, i8m, i8ms, rng, dev)

    # the int8 clock kernels at their classes' launches, each class's
    # kernel share of its wall, and the clock route reading
    tc8 = time_clock8_kernels(c8p, c8m, c8ms, rng, dev)
    ec8 = {k: v[1] for k, v in tc8.items()}
    if (max(v for k, v in ec8.items() if not k.startswith("measure")) != 0
            or max(v for k, v in ec8.items()
                   if k.startswith("measure")) > 1e-12):
        fail(f"an int8 clock kernel differs from its plain version at its "
             f"main-path launch shape ({ec8})")
    clock8_share = clock8_shares(clock8, tc8)
    clock8_routes = compare_clock8_routes(c8p, c8m, c8ms, rng, dev)

    # the masked helical kernels at their classes' launches and each masked
    # class's kernel share of its wall
    th = time_hp_kernels(hp, rng, dev)
    eh = {k: v[1] for k, v in th.items()}
    if (max(eh["ising"], eh["xy phase"], eh["xy or"]) != 0
            or max(eh["clock"], eh["xy phase, measuring"],
                   eh["xy measure"]) > 1e-12):
        fail(f"a masked helical kernel differs from its plain version at its "
             f"main-path launch shape ({eh})")
    hp_share = hp_shares(hpc, th)

    # the periodic XY angle engines' kernels at their classes' launches,
    # each class's kernel share of its wall, and the A/B of the two engines
    ta = time_xya_kernels(xya, xyi, rng, dev)
    ea = {k: max(v[1]) for k, v in ta.items()}
    if (max(v[1][0] for v in ta.values()) != 0.0
            or max(v[1][1] for v in ta.values()) > 1e-12):
        fail(f"an XY angle kernel differs from its plain version at its "
             f"main-path launch shape ({ {k: v[1] for k, v in ta.items()} })")
    xya_share = xya_shares(xya_cls, ta)
    ab_rate = xya_cls["Metropolis 2000^2 x 32"][2]
    log(f"  xy periodic A/B, Metropolis 2000^2 x 32: angle {ab_rate:.4g}, "
        f"component {xm_rate:.4g} flip attempts/s end to end, angle / "
        f"component {ab_rate / xm_rate:.3f}; kernels a sweep angle "
        f"{ta['metro 2000^2 x 32'][0]['ms'] + ta['metro measuring 2000^2 x 32'][0]['ms']:.4f} ms, "
        f"component {t_x2['ms'] + t_x2m['ms']:.4f} ms; OR 4000^2 x 8: angle "
        f"{xya_cls['OR 4000^2 x 8'][2]:.4g}, component {xo_rate:.4g}")

    # the halo kernels at the mesh classes' shard shapes, each mesh class's
    # kernel share of its wall
    t_mesh5 = time.perf_counter()
    tm = time_mesh_kernels(msb, ms3, i2p, i3p, rng, dev)
    if max(v[2] for v in tm.values()) != 0:
        fail(f"a halo kernel differs from its plain version at its shard "
             f"shape ({ {k: v[2] for k, v in tm.items()} })")
    mesh_share = mesh_shares(mesh_cls, tm)
    err_cx = check_mesh_cx_small(cp, c8p, xyp, rng, dev)
    tcx = time_mesh_cx_kernels(msb, cp, c8p, xyp, rng, dev)
    err_cx = max(err_cx, *(v[1] for v in tcx.values()))
    if err_cx > 1e-12:
        fail(f"a clock or XY halo mode differs from its plain version "
             f"({err_cx:.3g})")
    mesh_share.update(mesh_cx_shares(mesh_cx, tcx))
    mesh_wall += time.perf_counter() - t_mesh5
    log(f"  phase 4m and its phase-5 rows took {mesh_wall:.1f} s")

    def mesh_row(mod: str, first: str):
        """The JSON row of a halo kernel: its launches over the mesh
        classes, its largest error over them, and its times at its first
        class's shard shape (the measuring phase)."""
        counter, name, cu, site = MESH_KERNELS[mod]
        errs = [tm[c[0]][2] for c in MESH_CLASSES if c[8] == mod]
        return (name, cu, site, launched(mod, counter), max(errs),
                tm[first][1])

    src = "cuda_fortran_mc_simulation_spin_tpu_torch/csrc/"
    ref_py = "cuda_fortran_mc_simulation_spin_tpu/ops/"
    rows = [
        ("ising2d_multispin.phase_kernel", "ising2d_multispin.cu",
         "ising2d_multispin.py:355", launched("ising2d", "phase"),
         max(errs["phase"], e1), t1),
        ("ising2d_multispin.multisweep_kernel", "ising2d_multispin.cu",
         "ising2d_multispin.py:495", launched("ising2d", "multisweep"),
         max(errs["multisweep"], e2), t2),
        ("helical_multispin.multisweep_kernel (unrolled chains from a "
         "launch table)", "helical_multispin.cu",
         "helical_multispin.py:305", launched("helical", "multisweep"),
         max(err_helical, e3), t3),
        ("ising3d_multispin.phase_kernel", "ising3d_multispin.cu",
         "ising3d_multispin.py:227", launched("ising3d", "phase"),
         max(errs3["phase"], e4), t4),
        ("ising3d_multispin.multisweep_kernel", "ising3d_multispin.cu",
         "ising3d_multispin.py:409", launched("ising3d", "multisweep"),
         max(errs3["multisweep"], e5), t5),
        ("helical3d_multispin.phase_kernel", "helical3d_multispin.cu",
         "helical3d_multispin.py:838", launched("helical3d", "phase"),
         max(errs_h3["phase"], e6, e6b), t6),
        ("helical3d_multispin.energy_kernel", "helical3d_multispin.cu",
         "helical3d_multispin.py:938", launched("helical3d", "energy"),
         max(errs_h3["energy"], e7), t7),
        ("helical3d_multispin.multisweep_kernel", "helical3d_multispin.cu",
         "helical3d_multispin.py:290", launched("helical3d", "multisweep"),
         max(errs_h3["multisweep"], e8), t8),
        ("clock_planes.phase_kernel", "clock_planes.cu",
         "clock_planes.py:313", launched("clock", "phase"),
         max(err_clock, e9, e9m, e11, e11m), t9m),
        ("clock_helical_multispin.multisweep_kernel",
         "clock_helical_multispin.cu", "clock_helical_multispin.py:310",
         launched("clock_helical", "multisweep"), max(err_clock_h, e10),
         t10),
        ("xy2d_pallas.metropolis_kernel", "xy2d_pallas.cu",
         "xy2d_pallas.py:226", launched("xy", "metropolis"),
         max(err_xy["metropolis"], err_xyd["phase_bits"], e12, e12m, e_x2,
             e_x2m), t12),
        ("xy2d_pallas.over_relax_kernel", "xy2d_pallas.cu",
         "xy2d_pallas.py:265", launched("xy", "over_relax"),
         max(err_xy["over_relax"], e13, e13m), t13),
        ("xy2d_pallas.metropolis_kernel (snapshot mode)", "xy2d_pallas.cu",
         "xy2d_pallas.py:457", launched("xy", "metropolis_snapshot"),
         max(err_xyd["snapshot"], snap_err), snap_t[1500]),
        ("xy2d_measure_pallas.measure_kernel", "xy2d_measure_pallas.cu",
         "xy2d_measure_pallas.py:121", launched("xy_measure", "measure"),
         max(err_xyd["measure"], err_meas), t_meas),
        ("xy2d_resident.smem_multisweep_kernel", "xy2d_resident.cu",
         "xy2d_resident.py:257", launched("xy_resident", "multisweep_smem"),
         max(err_xyd["smem"], ms_err["smem"]), t_ms),
        ("xy2d_resident.gmem_multisweep_kernel", "xy2d_resident.cu",
         "xy2d_resident.py:257", launched("xy_resident", "multisweep"),
         max(err_xyd["gmem"], ms_err["gmem"]), t_gmem),
        ("xy2d_helical_dense.phase_kernel", "xy2d_helical_dense.cu",
         "xy2d_helical_dense.py:454", launched("xy_helical", "phase"),
         max(err_xyh["phase"], xyh_err), xyh_t["component phase"][0]),
        ("xy2d_helical_dense.or_kernel", "xy2d_helical_dense.cu",
         "xy2d_helical_dense.py:499", launched("xy_helical", "or"),
         max(err_xyh["or"], xyh_err), xyh_t["component or"][0]),
        ("xy2d_helical_dense_angle.angle_tile_kernel<false, .>",
         "xy2d_helical_dense_angle.cu", "xy2d_helical_dense_angle.py:269",
         launched("xy_helical_angle", "phase"),
         max(err_xyh["angle_phase"], xyh_err), xyh_t["angle phase"][0]),
        ("xy2d_helical_dense_angle.angle_tile_kernel<true, .>",
         "xy2d_helical_dense_angle.cu", "xy2d_helical_dense_angle.py:308",
         launched("xy_helical_angle", "or"),
         max(err_xyh["angle_or"], xyh_err), xyh_t["angle or"][0]),
        ("ising2d_pallas.phase_kernel", "ising2d_pallas.cu",
         "ising2d_pallas.py:126", launched("ising2d_int8", "phase"),
         max(errs8["phase2d"], ei8), ti8["phase2d 8x4000x2000"][0],
         int8_phase_build(i2p)),
        ("ising3d_pallas.tile_kernel", "ising3d_pallas.cu",
         "ising3d_pallas.py:85", launched("ising3d_int8", "phase"),
         max(errs8["phase3d"], ei8), ti8["phase3d 2x500x500x250"][0]),
        ("ising2d_measure_pallas.measure_kernel",
         "ising2d_measure_pallas.cu", "ising2d_measure_pallas.py:74",
         launched("ising_int8_measure", "measure2d")
         + launched("ising_int8_measure", "measure3d"),
         max(errs8["measure"], ei8), ti8["measure2d 8x4000x2000"][0]),
        ("ising2d_multisweep.multisweep_kernel", "ising2d_multisweep.cu",
         "ising2d_multisweep.py:128",
         launched("ising2d_int8_multisweep", "multisweep"),
         max(errs8["multisweep"], ei8), ti8["multisweep S=64"][0]),
        ("clock_pallas.phase_kernel", "clock_pallas.cu", "clock_pallas.py:106",
         launched("clock8", "phase"), errs_c8["phase"],
         tc8["phase 16x2000x1000"][0]),
        ("clock_measure_pallas.measure_kernel", "clock_measure_pallas.cu",
         "clock_measure_pallas.py:85", launched("clock8_measure", "measure"),
         errs_c8["measure"], tc8["measure 16x2000x1000"][0]),
        ("clock_multisweep.multisweep_kernel", "clock_multisweep.cu",
         "clock_multisweep.py:127",
         launched("clock8_multisweep", "multisweep"),
         errs_c8["multisweep"], tc8["multisweep S=64"][0]),
        ("helical_pallas.ising_multisweep_kernel", "helical_pallas.cu",
         "helical_pallas.py:216",
         launched("helical_pallas", "ising_multisweep"),
         max(errs_hp["ising"], eh["ising"]), th["ising"][0]),
        ("helical_pallas.clock_multisweep_kernel", "helical_pallas.cu",
         "helical_pallas.py:373",
         launched("helical_pallas", "clock_multisweep"),
         max(errs_hp["clock"], errs_hp["sums_rel"], eh["clock"]),
         th["clock"][0]),
        ("helical_pallas.xy_phase_kernel", "helical_pallas.cu",
         "helical_pallas.py:555",
         launched("helical_pallas", "xy_phase")
         + launched("helical_pallas", "xy_phase_measuring")
         + launched("helical_pallas", "xy_measure"),
         max(errs_hp["xy_phase"], eh["xy phase"],
             eh["xy phase, measuring"], eh["xy measure"]),
         th["xy phase"][0]),
        ("helical_pallas.xy_phase_kernel<OVER> (over-relaxation mode)",
         "helical_pallas.cu",
         "helical_pallas.py:579", launched("helical_pallas", "xy_or"),
         max(errs_hp["xy_or"], eh["xy or"]), th["xy or"][0]),
        ("xy2d_pallas_angle.angle_metro_kernel", "xy2d_pallas_angle.cu",
         "xy2d_pallas_angle.py:267", launched("xy_angle", "metro"),
         max(err_xya, ea["metro 10000^2 x 1"], ea["metro 2000^2 x 32"]),
         ta["metro 10000^2 x 1"][0]),
        ("xy2d_pallas_angle.angle_metro_snap_kernel (snapshot mode)",
         "xy2d_pallas_angle.cu", "xy2d_pallas_angle.py:405",
         launched("xy_angle", "metro_snapshot"),
         max(err_xya, rel_xya, ea["snapshot 1000^2 x 20"]),
         ta["snapshot 1000^2 x 20"][0]),
        ("xy2d_pallas_angle.angle_or_kernel<MEASURE> (decode-once tiles, "
         "angle_tiles<3, true, .>)", "xy2d_pallas_angle.cu",
         "xy2d_pallas_angle.py:300", launched("xy_angle", "or"),
         max(err_xya, ea["or 4000^2 x 8"], ea["or measuring 4000^2 x 8"],
             ea["or 10000^2 x 1"], ea["or measuring 10000^2 x 1"]),
         ta["or 4000^2 x 8"][0]),
        ("xy2d_multisweep.smem_multisweep_kernel", "xy2d_multisweep.cu",
         "xy2d_multisweep.py:325", launched("xy_int16", "multisweep_smem"),
         max(err_xyi, rel_xyi, ea["int16 S=64"], ea["int16 S=40"]),
         ta["int16 S=64"][0]),
        ("xy2d_multisweep.gmem_multisweep_kernel", "xy2d_multisweep.cu",
         "xy2d_multisweep.py:325", launched("xy_int16", "multisweep"),
         max(err_xyi, rel_xyi, ea["int16 x2 S=64"], ea["int16 x2 S=8"],
             ea["int16 x3 S=8"]),
         ta["int16 x2 S=64"][0]),
        mesh_row("ising2d", "packed 2-D 8192^2 x 4 (1,4)"),
        mesh_row("ising3d", "packed 3-D 512^3 x 8 (2,4)"),
        mesh_row("ising2d_int8", "int8 2-D 4000^2 x 8 (1,2,2)"),
        mesh_row("ising3d_int8", "int8 3-D 500^3 x 2 (2,2)"),
        ("clock_planes.phase_kernel<Q, true>", "clock_planes.cu",
         "clock_planes.py:875", launched("clock", "shard_phase"), err_cx,
         tcx["packed clock halo mode (8, 32, 512), measuring"][0]),
        ("clock_pallas.phase_kernel<true, .>", "clock_pallas.cu",
         "clock_pallas.py:294", launched("clock8", "halo_phase"), err_cx,
         tcx["int8 clock halo mode (16, 1000, 500) q=5, measuring"][0]),
        ("xy2d_pallas.metropolis_kernel<N, true>", "xy2d_pallas.cu",
         "xy2d_pallas.py:726", launched("xy", "halo_metropolis"), err_cx,
         tcx["XY halo mode (4, 2000, 1000), Metropolis phase a"][0]),
        ("xy2d_pallas.over_relax_kernel<true>", "xy2d_pallas.cu",
         "xy2d_pallas.py:770", launched("xy", "halo_over_relax"), err_cx,
         tcx["XY halo mode (4, 2000, 1000), OR measuring"][0]),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": src + cu,
         "replaces": ref_py + site, "launches": n, "max_abs_err": err,
         **times, "library_ms": None, **(extra[0] if extra else {})}
        for name, cu, site, n, err, times, *extra in rows]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was not launched on a main path")
    log(f"main path 2-D: resident {res_rate:.4g} flip attempts/s "
        f"({res_wall:.2f} s), streaming {str_rate:.4g} flip attempts/s "
        f"({str_wall:.2f} s)")
    log(f"main path helical 1001x1000 x 128: {hel_rate:.4g} flip "
        f"attempts/s ({hel_wall:.2f} s)")
    log(f"main path 3-D: streaming 512^3 x 8 {s3_rate:.4g} flip attempts/s "
        f"({s3_wall:.2f} s), resident 256^3 x 4 {r3_rate:.4g} flip "
        f"attempts/s ({r3_wall:.2f} s); build {build_s:.1f} s")
    log(f"main path helical 3-D: resident 151x151x150 x 128 {h1_rate:.4g} "
        f"flip attempts/s ({h1_wall:.2f} s, largest |z| {h1_z:.2f}), "
        f"streamed 501x501x500 x 2 {h5_rate:.4g} ({h5_wall:.2f} s, |z| "
        f"{h5_z:.2f}), streamed 1001x1000x1000 x 2 {ha_rate:.4g} "
        f"({ha_wall:.2f} s, |z| {ha_z:.2f}); even first sweep |z| "
        f"{z_even:.2f}; 151^3 routes streamed/resident {route_h3:.3f}")
    log(f"main path clock: padded 2000x2000 x 40 {cp_rate:.4g} flip "
        f"attempts/s ({cp_wall:.2f} s, largest |z| {cp_z:.2f}), aligned "
        f"2048x2048 x 16 {ca_rate:.4g} ({ca_wall:.2f} s, |z| {ca_z:.2f}), "
        f"helical 501x500 x 100 {ch_rate:.4g} ({ch_wall:.2f} s, |z| "
        f"{ch_z:.2f}); first sweeps largest |z| {z_clock:.2f}; clock phase "
        f"kernel {t9['ms']:.4f} ms plain, {t9m['ms']:.4f} ms measuring")
    share_or, share_m = xy_kern.values()
    log(f"main path XY: over-relaxation 4000x4000 x 8 {xo_rate:.4g} flip "
        f"attempts/s, {2 * xo_rate:.4g} site updates/s with the OR sweeps "
        f"({xo_wall:.2f} s, largest |z| {xo_z:.2f}, kernel share "
        f"{share_or:.3f}); Metropolis 2000x2000 x 32 {xm_rate:.4g} flip "
        f"attempts/s ({xm_wall:.2f} s, |z| {xm_z:.2f}, kernel share "
        f"{share_m:.3f}); phase a largest |z| {z_xy:.2f}; OR |dE|/N "
        f"{de_or:.3g}, ||S| - 1| {norm_or:.3g}; sums' relative error "
        f"{rel_xy:.3g}; kernels {t12['ms']:.4f} / {t12m['ms']:.4f} ms "
        f"(metropolis), {t13['ms']:.4f} / {t13m['ms']:.4f} ms "
        f"(over-relaxation)")
    log("main path XY disorder: " + "; ".join(
        f"{label} {rate:.4g} site updates/s ({wall:.2f} s, largest |z| "
        f"{z:.2f})" for label, (_, wall, rate, z) in disorder.items())
        + f"; rotation |m_y| {my_rot:.3g}, finite-magne preparation "
        f"relative error {prep_err:.4f}; sums' relative error {rel_xyd:.3g}; "
        "routes (nx, R, resident, streamed ms a sweep) "
        + ", ".join(f"({nx}, {r}, {a:.5f}, {b:.5f})"
                    for nx, r, a, b in xy_routes))
    log("main path helical XY 10001x10000 x 1: " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s"
        + (f", {2 * rate:.4g} site updates/s with the OR sweeps"
           if label.startswith("or") else "")
        + f" ({wall:.2f} s, largest |z| {z:.2f}, kernel share "
        f"{xyh_share[label]:.3f})"
        for label, (_, wall, rate, z) in helical.items())
        + f"; phase a largest |z| {z_xyh:.2f}; OR |dE|/N "
        + ", ".join(f"{k} {v:.3g}" for k, v in de_xyh.items())
        + f"; sums' relative error {rel_xyh:.3g}")
    log("main path int8 Ising: " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s ({wall:.2f} s, largest |z| "
        f"{z:.2f}, kernel share {int8_share[label]:.3f})"
        for label, (_, wall, rate, z) in int8.items())
        + f"; first sweeps largest |z| {z_int8:.2f}; routes (nx, R, MiB, "
        "multisweep, streamed ms a sweep) "
        + ", ".join(f"({nx}, {r}, {b / 2 ** 20:.1f}, {a:.5f}, {c:.5f})"
                    for nx, r, b, a, c in int8_routes))
    log("main path int8 clock: " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s ({wall:.2f} s, largest |z| "
        f"{z:.2f}, kernel share {clock8_share[label]:.3f})"
        for label, (_, wall, rate, z) in clock8.items())
        + f"; first sweeps largest |z| {z_clock8:.2f}; measure and "
        f"multisweep sums' relative error {errs_c8['measure_rel']:.3g}, "
        f"{errs_c8['multisweep_rel']:.3g}; routes (nx, R, MiB, multisweep, "
        "streamed ms a sweep) "
        + ", ".join(f"({nx}, {r}, {b / 2 ** 20:.1f}, {a:.5f}, {c:.5f})"
                    for nx, r, b, a, c in clock8_routes))
    log("main path masked helical: " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s ({wall:.2f} s, largest |z| "
        f"{z:.2f}, kernel share {hp_share[label]:.3f})"
        for label, (_, wall, rate, z) in hpc.items())
        + f"; sums' relative error {errs_hp['sums_rel']:.3g}")
    log("main path XY angle engines: " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s"
        + (f", {2 * rate:.4g} site updates/s with the OR sweeps"
           if label.startswith("OR") else "")
        + f" ({wall:.2f} s, largest |z| {z:.2f}, kernel share "
        f"{xya_share[label]:.3f})"
        for label, (_, wall, rate, z) in xya_cls.items())
        + f"; sums' relative error {max(rel_xya, rel_xyi):.3g}")
    log("main path mesh (one card repeated): " + "; ".join(
        f"{label} {rate:.4g} flip attempts/s ({wall:.2f} s, largest |z| "
        f"{z:.2f}, {ratio:.3f} of the unsharded rate, kernel share "
        f"{mesh_share[label]:.3f})"
        for label, (_, wall, rate, z, ratio) in {**mesh_cls,
                                                   **mesh_cx}.items()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
