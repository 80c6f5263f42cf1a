#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc`` (it
builds ``tclb_tpu_torch/csrc/d2q9.cu`` for d2q9 and once for each of the
five d2q9-family models (``-DD2Q9_MODEL``), ``d3q27.cu`` for
d3q27_cumulant and once for each of d3q27_BGK, d3q27_BGK_galcor, d3q19 and
d3q19_les (``-DD3Q_MODEL``), ``generic2d.cu``
once for each of d2q9 (``csrc/models/d2q9.cuh``), d2q9_kuper,
d2q9_heat_adj (with the backward kernel of ``generic2d_adjoint.cuh``),
the six one-stage models (d2q9_heat, d2q9_heat_conjugate, d2q9_hb, sw,
d2q9_solid, d2q9_npe_guo), the four multi-stage models
(d2q9_pf_pressureEvolution, d2q9_pp_MCMP, d2q9_lee,
d2q9_poison_boltzmann) and the three adjoint models (d2q9_adj,
d2q9_optimalMixing, d2q9_plate, each with the backward kernel), and
``generic3d.cu`` for
d3q19_adj with the backward kernel of ``generic3d_adjoint.cuh`` and for
d3q19_heat, d3q27, d3q27_viscoplastic, d3q27_cumulant_qibb_small and
d3q19_kuper, for
sm_90a into ``build/``, one ``nvcc`` each, started together), and exits
nonzero without printing a result when either the card or the package is
missing.  Phases, each of which fails the run on its own:

1. build the d2q9 library and the five family libraries, the five d3q27
   libraries, the sixteen generic 2D and the six generic 3D libraries and
   print what ``ptxas`` reports;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it (the Karman state for ``d2q9_resident8`` and
   ``d2q9_step``, the 1024x1024 channel state for ``d2q9_step2`` and
   ``d2q9_step``, the warmed ``example/3d_channel.xml`` state and a
   12x8x64 state that paints every d3q27 node type for ``d3q27_step`` and
   ``d3q27_step2``, the warmed ``example/drop.xml`` state, bench.py's
   1024x1024 drop and a walled 16x128 kuper state that paints every
   d2q9_kuper node type and two Density zones for ``generic2d_step``, its
   globals flavour and an 8-step ``generic2d_resident``, and after phases
   6 and 9 the developed 3d_channel and drop flows), d2q9_heat_adj's
   ``generic2d_step``, its globals flavour and an 8-step
   ``generic2d_resident`` on a 64x32 state that paints every node type
   the model reads and on bench.py's 512x1024 heat_adj channel, at rtol
   2e-5 / atol 2e-6, and the globals flavour's globals at rtol 1e-4 /
   atol 1e-6; ``generic2d_step_b`` against ``step_b_plain`` on the same two
   d2q9_heat_adj states (and after phase 12 the developed channel),
   lam_in at rtol 1e-4 / atol 1e-6 and the settings cotangent at rtol
   1e-4; d3q19_adj's ``generic3d_step`` (both flavours) and
   ``generic3d_step_b`` at the same tolerances on an 8x16x32 state that
   paints every node type the model reads, two zones and ``w`` in (0, 1),
   on the 32x64x256 case state of phase 13, and after phase 13 on its
   developed state after the Solve; each d2q9-family model's branch of
   ``d2q9_step``, ``d2q9_step2`` and ``d2q9_resident8`` on a 32x64 state
   that paints every node type the model reads (two zones, gravity,
   d2q9_new's Smagorinsky and Stab nodes), on its paths' starting states
   and, after phases 15-19, on their developed states; each z-slab family
   model's branch of ``d3q27_step`` and ``d3q27_step2`` on a 12x8x64 state
   that paints every node type the model reads (two zones, gravity), on
   its 48x48x256 channel's starting state and, after phase 21, on its
   developed state, and the cumulant's two kernels on the
   3dcum_turbulence state with SynthT planes that are not zero (and after
   phase 20);
3. hold the card's f32 run of the d2q9 golden cases
   (``tests/goldens/karman.json``, ``poiseuille.json``), of the
   d3q27_cumulant channel (``channel3d.json``), of the d2q9_kuper drop
   (``drop.json``) and of d2q9_heat_adj (``heat_adj.json``, with its
   gradient columns on ``cuda_adjoint``) against the goldens at rtol 1e-4
   / atol 1e-6 (f32 against an f64 recording);
4. the d2q9 main path: ``example/karman.xml`` unchanged through
   ``run_config`` (10000 iterations, Log every 1000, VTK every 5000) on
   ``cuda_d2q9_resident[d2q9,fuse=8]``, with the launch counts set to 0
   just before and read just after;
5. the d2q9 band engine: the 1024x1024 d2q9 channel of ``bench.py``,
   ``iterate(2002)`` on ``cuda_d2q9_band[d2q9,fuse=2]``, counted the same
   way;
6. the 3D main path: ``example/3d_channel.xml`` unchanged through
   ``run_config`` (48x48x256, 20000 iterations, Log every 2000, VTK every
   10000) on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]``, counted the same
   way, with its MLUPS and the eager globals step's time;
7. kernel times (CUDA events over many launches), the plain versions'
   times, each kernel's bound on this card, and the host time one call of
   each wrapper takes;
8. torch.profiler traces of a karman, a 3d_channel and a drop ``iterate``
   window: the card's busy and idle share and its time by kernel; the
   split of karman.xml's and drop.xml's windows (an ``iterate`` of one Log
   interval: the resident kernel's device time and its wrapper's host
   time a launch, the eager globals step, the idle share); then,
   a trace each, the launch of each three-stage ``generic2d_step`` (the
   staged form) at 1024x1024 against the step's bound;
9. the generic main path: ``example/drop.xml`` unchanged through
   ``run_config`` (128x128, 6000 iterations, Log every 500, VTK every
   2000) on ``cuda_generic_resident[d2q9_kuper,fuse=N]``, launching both
   generic kernels and no eager step, with its mass conserved to 1e-4 and
   the vapour bubble still at the centre;
10. the generic band engine: bench.py's drop physics at 1024x1024,
   ``iterate(2000)`` on ``cuda_generic_band[d2q9_kuper,fuse=1]``, both
   flavours of ``generic2d_step`` launched;
11. the adjoint main path: ``example/heat_adj.xml`` unchanged through
   ``run_config`` (64x32, Solve 4000 on
   ``cuda_generic_resident[d2q9_heat_adj,fuse=N]``, FDTest 8/3 and a
   10-evaluation MMA Optimize of 100 iterations on
   ``cuda_adjoint[d2q9_heat_adj,k=1]``, ThresholdNow, VTK): the launch
   counts, the FDTest records (logged), each objective (finite), the
   material constraint, a binary design; then the first evaluation's f32
   kernel gradient against an f64 eager gradient on the card (relative L2
   at most 1e-3);
12. bench.py's heat_adj channel at 512x1024: ``iterate(2000)`` on
   ``cuda_generic_band[d2q9_heat_adj,fuse=1]``, an 8-step kernel gradient
   against f32 eager autograd at rtol 1e-4 / atol 1e-7, and a 1000-step
   gradient with automatic checkpoint levels (2): its wall time, rate,
   peak memory and launches;
13. the 3D adjoint path: the d3q19_adj case XML
   (``tests/torch_cases.py:adj3d_case_xml`` at 32x64x256) through
   ``run_config``: Solve 2000 on ``cuda_generic3d_band[d3q19_adj,fuse=1]``,
   FDTest 8/3 and an MMA Optimize of 5 evaluations of 200 iterations on
   ``cuda_adjoint3d[d3q19_adj,k=1]``, ThresholdNow, VTK; the launch
   counts, each objective (finite), the material constraint, a binary
   design block; then the first evaluation's f32 kernel gradient against
   an f64 eager gradient on the card (relative L2 at most 1e-3) and an
   8-step f64 central-difference check at three components inside the
   design block;
14. bench.py's 3D adjoint case (``bench_adjoint3d``, 32x64x256):
   ``iterate(2000)`` on the band engine, an 8-step kernel gradient
   against f32 eager autograd at rtol 1e-4 / atol 1e-7, the 200-step
   gradient's wall time and rate, and a 1000-step gradient at 64x128x256
   with automatic checkpoint levels (2), run three times: each run's wall
   time and their median, its rate, ratio to 1000 primal steps, peak
   memory and launches (phase 8 traces a fourth run: its device-busy
   time).

15. ``example/cumulant2d.xml`` unchanged through ``run_config``
   (d2q9_cumulant, 1024x128, 8000 iterations, Log every 1000) on
   ``cuda_d2q9_resident[d2q9_cumulant,fuse=8]``, counted from 0, its Log
   columns finite, one eager (globals) step per iterate call;
16. bench.py's d2q9_cumulant channel (bench.py:194-207, 1024x1024):
   ``iterate(2002)`` on ``cuda_d2q9_band[d2q9_cumulant,fuse=2]``;
17. ``example/les_channel.xml`` unchanged (d2q9_les, 512x96, 8000
   iterations) on the resident engine;
18. BASELINE config 2: ``example/poiseuille.xml`` on d2q9_SRT
   (``tests/torch_cases.py:srt_poiseuille_xml``) on the resident engine,
   its final ux profile against the same case on the eager engine on the
   card, in f32 at rtol 2e-5 / atol 2e-6 and in f64 within a relative L2
   error of 1e-3;
19. bench.py's channel at 1024x1024 for d2q9_SRT, d2q9_les, d2q9_inc and
   d2q9_new (``iterate(2002)`` on the band engine), and at 128x1024 for
   d2q9_inc and d2q9_new (the resident engine), so that every family
   branch of every kernel runs on a path;
20. path A: ``example/3dcum_turbulence.xml`` unchanged through
   ``run_config`` (d3q27_cumulant, 128x32x32, a ``WVelocityTurbulent``
   inlet fed by ``<SyntheticTurbulence>``, 1000 iterations, Log every 200)
   on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]``, counted from 0: finite
   fields, SynthT planes that change between the Solve's segments, an
   inlet whose ux fluctuates, the MLUPS over the whole case;
21. path B: bench.py's 3D channel (bench.py:619-662, 48x48x256, walls at
   y = 0 and y = ny - 1, a body force along x) for d3q27_BGK,
   d3q27_BGK_galcor, d3q19 and d3q19_les, ``iterate(2002)`` on
   ``cuda_d3q27_band[<model>,fuse=2]``: the launches by kernel and the
   MLUPS;
22. tests/test_models.py's 3D Poiseuille for d3q19 and d3q27_BGK on the
   kernels in f32: the ux profile against the f32 eager engine at rtol
   2e-5 / atol 2e-6, against the f64 eager engine (relative L2, see
   ``check_d3q_poiseuille``) and the analytic profile (3%);
23. path A of the <Control> slice: ``example/karman_control.xml``
   unchanged through ``run_config`` (d2q9, 512x96, a ``<Control>`` of
   4000 iterations reading ``example/inlet_ramp.csv`` into the inlet
   zone's Velocity, Log every 500, Solve 4000) on
   ``cuda_generic_band[d2q9,fuse=1]``, counted from 0: no eager step,
   ``generic2d_step_series`` on every step but the last of each iterate
   call, which is ``generic2d_step_series_globals``, no plain launch;
   every Log column and the final fields against the same XML on the
   eager f32 engine at rtol 1e-4 / atol 1e-6; the inlet's ux at each Log
   equal to the series' entry of the step before and changing as the
   ramp does; the MLUPS of the whole case and of an ``iterate(500)``
   window;
24. path B: the 3D Control channel (``tests/torch_cases.py:
   adj3d_control_xml`` at 32x64x256: the 3D adjoint case's geometry and
   settings, a forward Solve of 2000 under a ``<Control>`` ramp of the
   inlet zone's Velocity, Log every 500) on
   ``cuda_generic3d_band[d3q19_adj,fuse=1]``, held the same way;
25. path C: ``<Sample what="U,Rho">`` of three points on
   karman_control.xml's lattice (500 iterations), every step eager by
   selection (no kernel launched), its CSV against the same case stepped
   one iteration at a time on the kernel engine at rtol 1e-4 / atol 1e-6.

26. the storage ladder's bf16 kernels against their plain versions on the
   card, in both representations (raw, shifted): ``generic2d_step_bf16``
   (both flavours) for d2q9 and d2q9_kuper at 1024x1024 and 96x512,
   ``generic2d_resident_bf16`` for the two harness cases at 64x64, and
   ``d3q27_step_bf16``/``d3q27_step2_bf16`` for d3q27_cumulant (a rich
   48x48x256 state with nonzero SynthT planes, the developed 3d_channel
   and 3dcum_turbulence states) and for the four other z-slab models (the
   developed 48x48x256 channels).  A kernel that narrows once a launch is
   held to the f32 tolerance (rtol 2e-5 / atol 2e-6 on the raw values)
   carried through its narrowing (``core/shift.py:narrowed_bounds``); the
   resident kernel equals as many chained ``generic2d_step_bf16`` launches
   bit for bit, each launch of that chain held so against its plain
   version from the same input, and, for d2q9_kuper, the resident kernel
   also equals its plain version from the start at the f32 tolerance;
27. the precision harness (``tclb_tpu_torch.precision``) on the kernels:
   both cases, both representations, 64x64, 500 steps, within
   ``ERROR_BOUNDS``, the shifted cavity's u_linf at least 10x below raw's;
28. bench.py's bf16 flagship (bench.py:818-870: d2q9 1024x1024, walls top
   and bottom): f32 on K1/K2, f32 on K4, bf16 shifted and bf16 raw on K4,
   MLUPS over ``iterate(2000)`` windows and their ratios (no floor held);
29. example/3d_channel.xml's lattice in bf16 shifted on K3 against the f32
   run of the same 20000 steps (MLUPS, U's relative L2, reported), and
   (29b) bench.py's 48x48x256 channel for each other z-slab model in bf16
   shifted;
30. bf16 shifted checkpoints on the card: bit-exact at rest, through raw
   f32 and back.

31. the one-stage models' examples unchanged through ``run_config``:
   ``example/heat_channel.xml`` (d2q9_heat, 512x64, 6000 iterations),
   ``sw_wave.xml`` (256x64, 3000), ``solidification.xml`` (d2q9_solid,
   128x128, 2000, VTK Solid,C,T) and ``npe_guo.xml`` (d2q9_npe_guo, 64x32,
   2000), each on ``cuda_generic_resident[<model>,fuse=N]``, counted from
   0: no eager step, both generic kernels, one globals launch per Log;
   heat_channel's T finite and hottest on the Heater,
   solidification's fi_s in [0, 1] with its sum growing from Log to Log;
   then each example cut to 1000 iterations on the kernels and on the
   eager f32 engine: every Log column, the fields and the VTK quantities
   at rtol 1e-4 / atol 1e-6; sw_wave's total height (f64 sum) conserved
   within 1e-10 by the f64 eager engine over the cut and carried by the
   kernels as by the eager f32 engine (within 1e-7 at every Log; f32
   drifts alike on every engine, ``SW_MASS_F32``); the MLUPS of the case
   and of an
   ``iterate(2000)`` window; (31b) tests/test_electrokinetics.py's
   electro-osmotic channel (30x64, 8000 iterations) on the kernels, its
   normalised ux within 0.08 of (psi - zeta);
32. each one-stage model's 1024x1024 lattice (``torch_cases.
   paint_generic``: tests/test_pallas_generic.py's ``_paint``) on K4:
   ``generic2d_step`` (both flavours) against its plain version after 4
   eager steps, the bf16 shifted flavours within the f32 tolerance carried
   through the narrowing, and ``iterate(2000)`` in f32 and in bf16
   (MLUPS, the band engine's tag);
33. K5 on each model's resident path (the example's state after its run;
   a 128x128 lattice iterated 500 steps for d2q9_heat_conjugate and
   d2q9_hb) against its plain version and bit for bit against eight
   chained K4 launches, its bf16 rung bit for bit against eight chained
   ``generic2d_step_bf16`` launches each within its bound, and an
   ``iterate(2000)`` of the same state in bf16 on the resident engine;
34. d2q9_heat under a ``<Control>`` series of HeaterTemperature on
   heat_channel's Heater zone (horizon 5): both series flavours against
   their plain versions, then an ``iterate(2000)`` on them.

35. the multi-stage models' examples unchanged through ``run_config``:
   ``example/bubble_rise.xml`` (d2q9_pf_pressureEvolution, 128x64, 3000
   iterations; its plan of two stages in one launch a step),
   ``mcmp_contact.xml`` (d2q9_pp_MCMP, 64x128, 2000) and ``drop_lee.xml``
   (d2q9_lee, 128x128, 3000; three stages, one launch each on K4, a grid
   barrier each in K5), each on ``cuda_generic_resident[<model>,fuse=N]``,
   counted from 0: no eager step, both generic kernels, one globals launch
   per Log; then each cut to 1000 iterations on the kernels and on the
   eager f32 engine: every Log column, the fields and every quantity at
   rtol 1e-4 / atol 1e-6; the physics of the reference's tests:
   bubble_rise's PhaseF sum (an f64 eager cut within 1e-12, the kernels'
   f32 drift as the eager f32 engine's within 1e-6) and its TotalDensity
   against the sum of Rho over the MRT nodes at every Log (rtol 1e-4);
   mcmp_contact's two masses alike (f64 within 1e-10) and TotalDensity1/2
   against their sums over the collision nodes; drop_lee's mass within
   5e-3 with rho above 0.8 and below 0.2 somewhere at the end; the MLUPS;
   (35b) tests/test_pp.py's immiscible blob (48x48, 1000 iterations) on
   the kernels: the components apart, their masses drifting as eager f32
   does, the globals equal to the sums;
36. each multi-stage model's 1024x1024 lattice (``torch_cases.
   paint_generic`` with ``MULTISTAGE_SETTINGS``) on K4: ``generic2d_step``
   (both flavours) against its plain version after 4 eager steps, the
   bf16 shifted flavours within the f32 tolerance carried through the
   narrowing, and ``iterate(2000)`` in f32 and in bf16;
37. K5 on each resident path (the example's state after its run;
   d2q9_poison_boltzmann's 128x128 lattice iterated 500 steps) against its
   plain version and bit for bit against eight chained K4 calls, its bf16
   rung bit for bit against eight chained ``generic2d_step_bf16`` calls
   each within its bound, and an ``iterate(2000)`` in bf16 on the
   resident engine;
38. d2q9_lee's 1024x1024 lattice under a ``<Control>`` series of
   InletVelocity on its inlet's zone (horizon 5): both series flavours of
   the three-stage step against their plain versions, then an
   ``iterate(2000)`` on them.

39. the last shipped example, ``example/adj_drag.xml`` (d2q9_adj, 64x32)
   unchanged through ``run_config``: FDTest 8/3 and an 8-evaluation MMA
   Optimize of 20 iterations on ``cuda_adjoint[d2q9_adj,k=1]`` (K4 and K7,
   whose reverse reads the zonal Velocity and Pressure from the zone
   table), ThresholdNow, Solve 100 on
   ``cuda_generic_resident[d2q9_adj,fuse=N]``: the launch counts from 0,
   the FDTest records, each objective (finite), the material constraint,
   a binary design; then the first evaluation's f32 kernel gradient
   against an f64 eager gradient on the card (relative L2 at most 1e-3);
40. bench.py's d2q9_adj gradient case (``bench_adjoint``, 512x1024, the
   design block [128:384, 300:700]): ``iterate(2000)`` on
   ``cuda_generic_band[d2q9_adj,fuse=1]``, an 8-step kernel gradient
   against f32 eager autograd at rtol 1e-4 / atol 1e-7, and a 1000-step
   gradient with automatic checkpoint levels (2): its wall time, rate,
   ratio to 1000 primal steps, peak memory and launches;
41. each adjoint model's 1024x1024 lattice (``torch_cases.paint_generic``
   with ``ADJ_SETTINGS``, zone 1's own zonal values) on K4:
   ``generic2d_step`` (both flavours) against its plain version after 4
   eager steps, the bf16 shifted flavours within the f32 tolerance
   carried through the narrowing, ``iterate(2000)`` in f32 and in bf16;
   (41b) d2q9_optimalMixing's and d2q9_plate's objective sensitivity to
   the initial populations and the settings on ``cuda_adjoint``
   (``make_objective_run`` with ``make_diff_step``): 8 steps against
   eager autograd on the card (rtol 1e-4, an absolute 1e-6 of the
   largest |g|), then 200 steps, counted;
42. K5 on each resident path (adj_drag's state after its run; a 128x128
   lattice iterated 200 steps for the other two) against its plain
   version and bit for bit against eight chained K4 calls, its bf16 rung
   bit for bit against eight chained ``generic2d_step_bf16`` calls each
   within its bound, and an ``iterate(200)`` in bf16 on the resident
   engine;
43. ``generic2d_step_b`` for each adjoint model against ``step_b_plain``
   on rich states (``generic2d_parity.paint``: every node type, zone 1
   with other zonal values than zone 0, 1% noise; 37x53 and 256x256),
   lam_in at rtol 1e-4 / atol 1e-6 and the settings cotangent at rtol
   1e-4, and both series flavours on the same states under a series of a
   zonal setting; then d2q9_adj's 1024x1024 lattice under a Velocity
   series: both flavours, then an ``iterate(500)`` on them.

44. bench.py's d3q19_heat case (bench.py:664-677, ``bench_d3q27``'s third
   lattice: 48x48x256, MRT, Wall rows at y = 0 and ny - 1; nu 0.05,
   Velocity 0.02, FluidAlfa 0.05) on ``cuda_generic3d_band[d3q19_heat,
   fuse=1]`` (K6): both flavours of ``generic3d_step`` against their plain
   versions, its first 200 steps against eager f32 on the card (rtol 1e-4
   / atol 1e-6), then ``iterate(4000)`` from Init counted from 0: MLUPS
   and GB/s by bench.py's count (2 n_storage 4 + 2 B a node) beside the
   48x48x256 d3q27_cumulant (3d_channel.xml) and d3q19 (channel48)
   figures of the same run;
45. each 3D model of the generic engine (d3q19_heat, d3q27,
   d3q27_viscoplastic, d3q27_cumulant_qibb_small, d3q19_kuper) at
   48x48x256, painted as tests/test_pallas_generic.py's ``_parity_3d``
   (the collision type with Wall rows, its ``_3D_SETTINGS``) with an inlet
   and outlet face where the model has them (qibb also a sphere with its
   cut distances): both flavours against their plain versions after 4
   eager steps and after the run, ``iterate(2000)`` (MLUPS) and the card's
   idle share over an ``iterate(200)``;
46. each of them on rich states (every node type its header reads, zone 1
   with its own zonal values, noise, qibb's cuts from a sphere, kuper's phi
   not constant; 8x16x32 and 24x48x128): both flavours and both series
   flavours against their plain versions, and whether each is bit for bit
   its plain version;
47. the reference's physics on K6 in f32: tests/test_viscoplastic.py's
   Newtonian limit, Bingham plug and Zou/He duct, tests/test_qibb.py's
   off-grid walls at delta 0.25 and 0.75 and plain bounce-back, each at its
   size and steps with the reference's fits, its first ``PHYS_F64_CUT``
   steps against f64 eager on the card (``f64_against``);
48. a d3q19_kuper drop at 64^3 (a liquid sphere in its vapour, periodic,
   two zones): its first 100 steps against eager f32, 2000 steps with the
   mass within 1e-4, both passes of each step counted.

Phase 2 also holds both series flavours of ``generic2d_step`` and
``generic3d_step`` on rich states with series on two zones (horizon 5, at
iterations inside, at the end of and past it) and on the paths' states,
and d2q9's plain ``generic2d_step`` (both flavours) and
``generic2d_resident``, which no path runs (d2q9 without a series takes
``d2q9_step``/``d2q9_resident8``): their times and errors go into the
summary line, not the kernels line.

Phase 7 also times d2q9_heat_adj's kernels, ``generic2d_step_b``, the
two 3D kernels, each d2q9-family branch at its path's shape and each
z-slab family branch at 48x48x256; phase 8 also profiles the two
1000-step gradients, a cumulant2d, a 1024x1024 d2q9_cumulant, a
3dcum_turbulence and a 48x48x256 window of each z-slab family model.
Phase 7 also times the series flavours (K4's at 1024x1024 and at
512x96, K6's at 32x64x256) and d2q9's plain generic kernels; phase 8 also
profiles a karman_control ``iterate(500)`` and a 3D Control channel
``iterate(200)``.  Phase 7 also times every one-stage kernel at its paths'
shapes, phase 8 profiles a heat_channel and a 1024x1024 d2q9_npe_guo
window; likewise for the multi-stage kernels, and a drop_lee and a
1024x1024 d2q9_lee window; likewise for the adjoint models' kernels
(``generic2d_step_b`` at its gradient path's shape), and the 1000-step
d2q9_adj gradient.  Phases run in the order 1, 2, 3, 4, 5, 6, 9, 10, 11,
12, 13, 14, 15-19, 20-22, 23-25, 26-30, 31-34, 35-38, 39-43, 44-48, 7,
8; phase 7 also times both flavours of each 3D model's ``generic3d_step``
at 48x48x256, phase 8 each pass of d3q19_kuper's and the heat case's
``iterate(200)``.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# K5's launches are timed at no more than this many steps (and their plain
# versions, the eager engine over as many steps, with them): at a path's
# own launch (up to 3998 steps) the plain versions alone took some 170 s
# of phase 7
K5_TIMING_STEPS = 98
# runs of phase 14's 1000-step 3D gradient (its median is kept)
GRAD3D_RUNS = 3
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 2e-5, 2e-6        # kernel vs plain (tests/test_fastpath.py:69)
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-6
# generic2d_step_b against its plain version (lam_in, settings cotangent)
STEP_B_RTOL, STEP_B_ATOL, STEP_B_SETT_RTOL = 1e-4, 1e-6, 1e-4
# a kernel gradient against eager autograd, both f32
# (tests/test_pallas_adjoint.py:155)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
GRAD_F64_REL_L2 = 1e-3     # the f32 kernel gradient against f64 eager
# a sensitivity of a large objective (d2q9_optimalMixing's TotalTempSqr
# sums temp^2 over 1M nodes: |g| up to ~16) against eager autograd, both
# f32: GRAD_RTOL, and for the f32 rounding that eight reverse steps carry
# at the gradient's own scale, an absolute part relative to its largest
SENS_ATOL_REL = 1e-6
# central differences (eps 1e-4, f64) against the f64 adjoint: the
# truncation (eps^2 times the third derivative) stays below the relative
# limit, the objective's f64 rounding over eps (|J| 1e-16 / 1e-4, about
# 1e-10 for |J| ~ 100) below the absolute one
FD_REL, FD_ATOL = 1e-4, 1e-9
# the d2q9_SRT Poiseuille's f32 ux profile after 10000 steps against f64:
# its body force enters as feq(u + g) - feq(u), two values near 0.1 that
# differ by about 1e-6 at g ~ 1e-5, so f32 on any engine carries a
# systematic error of several 1e-4 of the profile; the limit is the one
# this script holds its f32 gradients to against f64
POISEUILLE_F64_REL_L2 = GRAD_F64_REL_L2
KARMAN_XML = ROOT / "example" / "karman.xml"
CHANNEL3D_XML = ROOT / "example" / "3d_channel.xml"
DROP_XML = ROOT / "example" / "drop.xml"
HEAT_ADJ_XML = ROOT / "example" / "heat_adj.xml"
CUMULANT2D_XML = ROOT / "example" / "cumulant2d.xml"
LES_XML = ROOT / "example" / "les_channel.xml"
TURB_XML = ROOT / "example" / "3dcum_turbulence.xml"
KARMAN_CONTROL_XML = ROOT / "example" / "karman_control.xml"
DEVICE = "cuda"
TPU_KERNELS = {   # the Pallas call each CUDA kernel replaces
    "d2q9_step": "tclb_tpu/ops/pallas_d2q9.py:775",
    "d2q9_step2": "tclb_tpu/ops/pallas_d2q9.py:756",
    "d2q9_resident8": "tclb_tpu/ops/pallas_d2q9.py:302",
    "d3q27_step": "tclb_tpu/ops/pallas_d3q.py:655",
    "d3q27_step2": "tclb_tpu/ops/pallas_d3q.py:843",
    "generic2d_step": "tclb_tpu/ops/pallas_generic.py:796",
    "generic2d_resident": "tclb_tpu/ops/pallas_generic.py:1105",
    "generic2d_step_b": "tclb_tpu/ops/pallas_adjoint.py:905",
    "generic3d_step": "tclb_tpu/ops/pallas_generic.py:1528",
    "generic3d_step_b": "tclb_tpu/ops/pallas_adjoint.py:634",
    # the <Control> series flavours: call_s and call_sg of the same functions
    "generic2d_step_series": "tclb_tpu/ops/pallas_generic.py:838",
    "generic2d_step_series_globals": "tclb_tpu/ops/pallas_generic.py:839",
    "generic3d_step_series": "tclb_tpu/ops/pallas_generic.py:1558",
    "generic3d_step_series_globals": "tclb_tpu/ops/pallas_generic.py:1559",
}
# the d2q9 family's branches of the three d2q9 kernels replace the family
# branches of the same Pallas calls (pallas_d2q9.py:136, :535-584)
FAMILY_2D = ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_cumulant",
             "d2q9_new")
TPU_KERNELS.update({f"{name}[{m}]": TPU_KERNELS[name] for m in FAMILY_2D
                    for name in ("d2q9_step", "d2q9_step2",
                                 "d2q9_resident8")})
SOURCES = {"d2q9": "d2q9.cu", "d3q27": "d3q27.cu", "generic": "generic2d.cu",
           "adjoint": "generic2d_adjoint.cuh", "generic3d": "generic3d.cu",
           "adjoint3d": "generic3d_adjoint.cuh"}
GENERIC_MODELS = ("d2q9", "d2q9_kuper", "d2q9_heat_adj", "d3q19_adj",
                  "d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb", "sw",
                  "d2q9_solid", "d2q9_npe_guo", "d2q9_pf_pressureEvolution",
                  "d2q9_pp_MCMP", "d2q9_lee", "d2q9_poison_boltzmann",
                  "d2q9_adj", "d2q9_optimalMixing", "d2q9_plate",
                  "d3q19_heat", "d3q27", "d3q27_viscoplastic",
                  "d3q27_cumulant_qibb_small", "d3q19_kuper")
# the rest of the z-slab family on the d3q27 kernels (phases 20-22)
D3Q_FAMILY = ("d3q27_BGK", "d3q27_BGK_galcor", "d3q19", "d3q19_les")
CHANNEL48 = (48, 48, 256)      # bench.py:619-662's 3D channel
# the 3D adjoint case's handlers (phase 13)
ADJ3D_HANDLERS = ("Solve", "FDTest", "Optimize", "ThresholdNow", "VTK")
GOLDEN_MODELS = {"karman": "d2q9", "poiseuille": "d2q9",
                 "channel3d": "d3q27_cumulant", "drop": "d2q9_kuper",
                 "heat_adj": "d2q9_heat_adj"}


T0 = time.perf_counter()     # the script's start, for each phase's clock


def say(msg: str) -> None:
    """Print ``msg``; a phase's first line also gets the seconds since the
    script started."""
    if msg.startswith("phase"):
        msg = f"{msg} [{time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# states at the path's shapes
# --------------------------------------------------------------------------- #


def case_lattice(xml, dtype, device, drop=("Solve", "Log", "VTK")):
    """An example case's lattice after running it without the elements
    ``drop`` names (by default: painted and initialised)."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    root = ET.parse(xml).getroot()
    for tag in drop:
        for el in root.findall(tag):
            root.remove(el)
    cwd = os.getcwd()
    with case_dir() as out:
        os.chdir(out)    # the XML's own output= prefix is relative
        try:
            solver = _run_root(root, get_model(root.get("model")), None,
                               dtype, out + "/", "case_state", device=device)
        finally:
            os.chdir(cwd)
    return solver.lattice


def case_dir() -> tempfile.TemporaryDirectory:
    """A temporary working directory for a case: an XML's output= prefix
    is relative, and so is karman_control.xml's CSV
    (example/inlet_ramp.csv), so ``example`` there links to the
    checkout's."""
    tmp = tempfile.TemporaryDirectory()
    os.symlink(ROOT / "example", os.path.join(tmp.name, "example"))
    return tmp


def rich3d_lattice(device):
    """A 12x8x64 d3q27_cumulant state that paints every node type, with
    nonzero SynthT planes and a Buffer layer (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import RICH3D_SETTINGS, SHAPE3D, paint_rich_3d
    lat = Lattice(get_model("d3q27_cumulant"), SHAPE3D, dtype=torch.float32,
                  device=device, settings=RICH3D_SETTINGS)
    return paint_rich_3d(lat, seed=5)


def channel_lattice(device, n=1024):
    """bench.py's d2q9 channel (bench.py:154-167)."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=device,
                  settings={"nu": 0.02, "Velocity": 0.01})
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = m.flag_for("Wall")
    flags[-1, :] = m.flag_for("Wall")
    flags[n // 3:2 * n // 3, n // 10:n // 5] = m.flag_for("Wall")
    flags[1:-1, 2] = m.flag_for("MRT", "Inlet")
    flags[1:-1, -3] = m.flag_for("MRT", "Outlet")
    lat.set_flags(flags)
    lat.init()
    return lat


def drop_lattice(device, n=1024):
    """bench.py's drop physics (bench.py:290-306): a vapour disc of radius
    n/5 (zone 1) in the liquid, periodic."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9_kuper")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=device,
                  settings={"omega": 1.0, "Temperature": 0.56, "FAcc": 1.0,
                            "Magic": 0.01, "MagicA": -0.152,
                            "MagicF": -2.0 / 3.0,
                            "Density": 3.2600529440452366})
    lat.set_setting("Density", 0.014500641645077492, zone=1)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    yy, xx = np.mgrid[0:n, 0:n]
    drop = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (n / 5) ** 2
    flags[drop] = m.flag_for("MRT", zone=1)
    lat.set_flags(flags)
    lat.init()
    return lat


def rich_kuper_lattice(device):
    """A 16x128 d2q9_kuper state that paints every node type the model
    dispatches and two Density zones (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import KUPER_SETTINGS, KUPER_SHAPE, paint_rich_kuper
    lat = Lattice(get_model("d2q9_kuper"), KUPER_SHAPE, dtype=torch.float32,
                  device=device, settings=KUPER_SETTINGS)
    return paint_rich_kuper(lat, seed=5)


def rich_heat_lattice(device):
    """heat_adj.xml's 64x32 with every node type d2q9_heat_adj reads (W
    velocity, E pressure, walls, a solid block, an Outlet column, a
    DesignSpace block), a non-uniform design field and a ux == 0 node
    (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import HEAT_SETTINGS, HEAT_SHAPE, paint_rich_heat
    lat = Lattice(get_model("d2q9_heat_adj"), HEAT_SHAPE,
                  dtype=torch.float32, device=device, settings=HEAT_SETTINGS)
    return paint_rich_heat(lat, seed=5)


def heat1024_lattice(device, ny=512, nx=1024):
    """bench.py's heat_adj channel (bench.py:314-331) with a W velocity
    inlet, an E pressure outlet and bench.py:357-361's DesignSpace block;
    Drag is the objective (phase 12 sets w = 0.8 on the block)."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9_heat_adj")
    lat = Lattice(m, (ny, nx), dtype=torch.float32, device=device,
                  settings={"nu": 0.05, "InletVelocity": 0.02,
                            "FluidAlfa": 0.05, "DragInObj": 1.0})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    flags[128:384, 300:700] |= np.uint16(m.flag_for("DesignSpace"))
    lat.set_flags(flags)
    lat.init()
    return lat


def eager_warm(lat, steps: int) -> None:
    """Advance on the eager engine so the state carries flow, not just
    the initial equilibrium."""
    lat.state = lat._iterate(lat.state, lat.params, steps)
    lat.synchronize()


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def compare(got, want, what: str, rtol: float = RTOL,
            atol: float = ATOL) -> dict:
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    finite = bool(torch.isfinite(got).all())
    say(f"  {what}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
        f"(rtol {rtol} atol {atol}) {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        fail(f"{what} disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def check_kernels(cases, errs: dict, what: str) -> dict:
    """Each kernel against its plain version on the same inputs;
    ``cases`` lists (kernel module, lattice, kernel name).  ``errs`` keeps
    each kernel's largest error over every call."""
    say(f"{what}: kernels against their plain versions on the card")
    for dk, lat, name in cases:
        fn, n = dk.WRAPPERS[name]
        *inputs, a = dk.kernel_inputs(lat.model, lat.state, lat.params)
        got = fn(*inputs, a)
        want = dk.plain_steps(*inputs, a, n)
        f = inputs[0]
        torch.cuda.synchronize()
        key = kernel_key(dk, name, lat)
        e = compare(got, want, f"{key} at {tuple(f.shape)}")
        keep_worst(errs, key, e)
    return errs


def kernel_key(dk, name: str, lat) -> str:
    """A kernel's name in the record: the generic kernels, and the d2q9
    and d3q27 kernels' family branches, are built once per model, so
    theirs carries the model."""
    if hasattr(dk, "launch_key"):
        return dk.launch_key(name, lat.model.name)
    return f"{name}[{lat.model.name}]" \
        if "generic" in dk.__name__ else name


def keep_worst(errs: dict, name: str, e: dict) -> None:
    prev = errs.get(name)
    if prev is None or e["max_abs_err"] > prev["max_abs_err"]:
        errs[name] = e


def check_globals_flavour(gk, lats, errs: dict, what: str) -> dict:
    """``generic2d_step``'s (``generic3d_step``'s, with that module)
    globals flavour against its plain version: the fields at rtol 2e-5 /
    atol 2e-6 (counted with the kernel's errors) and the SUM globals at
    rtol 1e-4 / atol 1e-6."""
    name = gk.KERNELS[0]
    say(f"{what}: {name}'s globals flavour on the card")
    for lat in lats:
        *inputs, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
        got, g = gk.step_globals(*inputs, a)
        want, wg = gk.plain_steps(*inputs, a, 1, with_globals=True)
        torch.cuda.synchronize()
        shape = tuple(inputs[0].shape)
        key = kernel_key(gk, name, lat)
        keep_worst(errs, key,
                   compare(got, want, f"{key} (globals) at {shape}"))
        gerr = (g - wg).abs()
        ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
            and bool(torch.isfinite(g).all())
        say(f"  globals at {shape}: {g.tolist()} vs {wg.tolist()} (rtol "
            f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}'s globals at {shape} disagree")
        keep_worst(errs, f"{key} globals", globals_err(gerr, wg))
    return errs


def globals_err(gerr, wg) -> dict:
    """The largest absolute and relative error of a globals vector (0 for
    a model without globals)."""
    if not gerr.numel():
        return {"max_abs_err": 0.0, "max_rel_err": 0.0}
    return {"max_abs_err": float(gerr.max()),
            "max_rel_err": float((gerr / wg.abs().clamp_min(1e-30)).max())}


def check_step_b(ak, gk, lats, errs: dict, what: str) -> dict:
    """``generic2d_step_b`` (``generic3d_step_b`` for a 3D model) against
    ``step_b_plain`` (torch.func.vjp of the plain step) on the same
    inputs: lam_out and lam_g of order one from a seeded generator; lam_in
    at rtol 1e-4 / atol 1e-6, the settings cotangent at rtol 1e-4."""
    say(f"{what}: the backward kernel against its plain version on the "
        "card")
    for lat in lats:
        f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state,
                                             lat.params)
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        lam = torch.randn(f.shape, generator=gen, device=DEVICE)
        lam_g = torch.randn((lat.model.n_globals,), generator=gen,
                            device=DEVICE)
        got, gs = ak.step_b(f, flags, ztab, a, lam, lam_g)
        want, ws = ak.step_b_plain(f, flags, ztab, a, lam, lam_g)
        torch.cuda.synchronize()
        shape = tuple(f.shape)
        key = f"generic{lat.model.ndim}d_step_b[{lat.model.name}]"
        keep_worst(errs, key, compare(got, want, f"{key} lam_in at {shape}",
                                      STEP_B_RTOL, STEP_B_ATOL))
        serr = (gs - ws).abs()
        ok = bool((serr <= STEP_B_SETT_RTOL * ws.abs()).all()) \
            and bool(torch.isfinite(gs).all())
        say(f"  settings cotangent at {shape}: {gs.tolist()} vs "
            f"{ws.tolist()} (rtol {STEP_B_SETT_RTOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{key}'s settings cotangent at {shape} disagrees")
        keep_worst(errs, f"{key} settings",
                   {"max_abs_err": float(serr.max()),
                    "max_rel_err": float((serr / ws.abs().clamp_min(1e-30))
                                         .max())})
    return errs


def check_goldens() -> None:
    """The d2q9 and channel3d goldens, run on the card in f32 through the
    kernels."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    say("phase 3: goldens on the card (f32 kernels vs f64 recording)")
    src = (ROOT / "tests" / "test_golden.py").read_text()
    for name, model in GOLDEN_MODELS.items():
        tag = f'{name.upper()} = """'
        start = src.index(tag) + len(tag)
        xml = src[start:src.index('"""', start)]
        golden = json.loads(
            (ROOT / "tests" / "goldens" / f"{name}.json").read_text())
        with tempfile.TemporaryDirectory() as out:
            solver = _run_root(ET.fromstring(xml.format(out=out)),
                               get_model(model), None, torch.float32,
                               out + "/", name, device=DEVICE)
            row = solver.log_row()
            fields = solver.lattice.state.fields.double().cpu().numpy()
        row["FieldsL1"] = float(np.abs(fields).sum())
        row["FieldsSum"] = float(fields.sum())
        if name == "heat_adj":
            # tests/test_golden.py's gradient columns, on the card
            from torch_cases import heat_adj_golden_columns
            cols, adj_engine = heat_adj_golden_columns(solver)
            if adj_engine != "cuda_adjoint[d2q9_heat_adj,k=1]":
                fail(f"golden heat_adj's gradient ran on {adj_engine}")
            row.update(cols)
        engine = solver.lattice.engine_name
        if not engine.startswith("cuda_"):
            fail(f"golden {name} ran on {engine}, not a kernel engine")
        worst, worst_key = 0.0, None
        for key, want in golden.items():
            if key == "Walltime":
                continue
            got = row[key]
            if not abs(got - want) <= GOLDEN_ATOL + GOLDEN_RTOL * abs(want):
                fail(f"golden {name}:{key}: {got!r} vs {want!r}")
            rel = abs(got - want) / max(abs(want), 1e-30)
            if rel >= worst:
                worst, worst_key = rel, key
        say(f"  {name}: {len(golden) - 1} columns within rtol "
            f"{GOLDEN_RTOL} (worst rel {worst:.2e}, {worst_key}) on "
            f"{engine}")


def run_case(dk, xml, phase: str, engine: str, kernels, check) -> dict:
    """A main path: an example case end to end on the card, on ``engine``,
    launching each of ``kernels``; ``check(lat)`` adds the case's own
    plausibility checks.  An engine that sums the globals itself
    (``full_globals``) must run no eager step.  The case writes into its
    own ``output/`` (the XML's ``output`` attribute), so it runs from a
    temporary working directory."""
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    say(f"phase {phase}: {xml.name} end to end")
    root = ET.parse(xml).getroot()
    case = xml.stem
    niter = int(root.find("Solve").get("Iterations"))
    log_every = int(root.find("Log").get("Iterations"))
    vtk = root.find("VTK")
    vtk_every = None if vtk is None else int(vtk.get("Iterations"))
    # the Solve iterates between the Log and VTK callbacks: one iterate
    # call, hence one trailing eager step, per stop
    stops = {niter} | {i for every in (log_every, vtk_every) if every
                       for i in range(every, niter + 1, every)}
    model = get_model(root.get("model"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            dk.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(dk.LAUNCHES)
            flavours = getattr(dk, "flavours", dict)()
        finally:
            os.chdir(cwd)
        out = os.path.join(tmp, root.get("output"))
        files = sorted(os.listdir(out))
        with open(os.path.join(out, f"{case}_Log.csv")) as f:
            rows = f.read().strip().splitlines()[1:]
    log = np.array([[float(v) for v in r.split(",")] for r in rows])
    if not np.isfinite(log).all():
        fail(f"{case}: non-finite Log columns")
    lat = solver.lattice
    full_globals = bool(getattr(lat._fast, "full_globals", False))
    eager_steps = lat.eager_steps
    say(f"  engine {lat.engine_name}, {solver.iter} iterations, "
        f"{wall:.3f} s wall, launches "
        f"{ {k: v for k, v in launches.items() if v} }, eager steps "
        f"{eager_steps}")
    if lat.engine_name != engine:
        fail(f"{case} ran on {lat.engine_name}")
    if eager_steps != (0 if full_globals else len(stops)):
        fail(f"{case} ran {eager_steps} eager steps on {engine} in "
             f"{len(stops)} iterate calls")
    if solver.iter != niter or len(rows) != niter // log_every:
        fail(f"{case}: {solver.iter} iterations, {len(rows)} log rows")
    for it in range(vtk_every or niter + 1, niter + 1, vtk_every or 1):
        for ext in ("vti", "pvti"):
            if f"{case}_VTK_{it:08d}.{ext}" not in files:
                fail(f"{case}: no VTK output {it} .{ext} in {files}")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{case}: non-finite fields")
    g = lat.get_globals()
    if not all(math.isfinite(v) for v in g.values()):
        fail(f"{case}: non-finite globals {g}")
    check(lat)
    for name in kernels:
        if launches[name] < 1:
            fail(f"{case} did not launch {name}")
    # a pure iterate window on the run's own lattice, fenced by synchronize
    nodes = float(np.prod(lat.shape))
    window = 2000
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(window)
    host = time.perf_counter() - t0    # until iterate returns to the host
    lat.synchronize()
    dt = time.perf_counter() - t0
    # the window's trailing eager step (the globals) on its own, where the
    # engine has one
    eager = None
    if not full_globals:
        t0 = time.perf_counter()
        lat.state = lat._iterate(lat.state, lat.params, 1)
        lat.synchronize()
        eager = time.perf_counter() - t0
    out = {"launches": launches, "flavours": flavours, "wall_s": wall,
           "eager_steps": eager_steps,
           "mlups_end_to_end": nodes * niter / wall / 1e6,
           "mlups_iterate": nodes * window / dt / 1e6,
           "iterate_ms": dt * 1e3, "iterate_host_ms": host * 1e3,
           "eager_step_ms": None if eager is None else eager * 1e3,
           "globals": g, "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end (XML, painting, "
        f"Log and VTK included), {out['mlups_iterate']:.1f} in an "
        f"iterate({window}) window ({dt * 1e3:.2f} ms, of which "
        f"{host * 1e3:.2f} ms until iterate returned; "
        + ("no eager step)" if eager is None
           else f"one eager globals step alone {eager * 1e3:.2f} ms)"))
    return out


def check_karman(lat) -> None:
    g = lat.get_globals()
    if g["InletFlux"] <= 0:
        fail(f"karman: implausible globals {g}")


def check_channel3d(lat) -> None:
    """The forced channel flows along +x: positive Flux, a mean x velocity
    of the fluid between the walls that is positive and below 0.5, and
    running averages that are finite and positive in x."""
    g = lat.get_globals()
    u = lat.get_quantity("U")
    avg_u = lat.get_quantity("avgU")
    ux = float(u[0, :, 1:-1, :].mean())
    if not (g["Flux"] > 0 and 0 < ux < 0.5):
        fail(f"3d_channel: implausible flow, Flux {g['Flux']}, mean ux {ux}")
    if not bool(torch.isfinite(avg_u).all()) \
            or float(avg_u[0, :, 1:-1, :].mean()) <= 0:
        fail("3d_channel: implausible running averages")
    say(f"  Flux {g['Flux']:.6g}, mean ux {ux:.6g}, mean avgU.x "
        f"{float(avg_u[0, :, 1:-1, :].mean()):.6g}")


def check_drop(lat) -> None:
    """The periodic drop: total mass within 1e-4 of the initial mass (the
    zonal Density summed over the nodes), and the vapour bubble still at
    the centre (Rho < 0.1 there, > 3 at a corner)."""
    m = lat.model
    zones = (lat.state.flags >> m.zone_shift).long()
    mass0 = float(lat.params.zone_table[m.setting_index["Density"]][zones]
                  .double().sum())
    rho = lat.get_quantity("Rho")
    mass = float(rho.double().sum())
    ny, nx = lat.shape
    centre, corner = float(rho[ny // 2, nx // 2]), float(rho[0, 0])
    say(f"  mass {mass:.9g} (initial {mass0:.9g}, rel change "
        f"{abs(mass - mass0) / mass0:.2e}), Rho centre {centre:.6g}, "
        f"corner {corner:.6g}")
    if abs(mass - mass0) > 1e-4 * mass0:
        fail(f"drop: mass {mass} drifted from {mass0}")
    if not (centre < 0.1 and corner > 3.0):
        fail(f"drop: no vapour bubble (Rho centre {centre}, corner "
             f"{corner})")


def run_drop_band(gk, lat) -> dict:
    """The generic band engine on bench.py's 1024x1024 drop."""
    say("phase 10: 1024x1024 drop on the generic band engine")
    niter = 2000
    lat.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    flavours = gk.flavours()
    say(f"  engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), eager steps {lat.eager_steps}, "
        f"{np.prod(lat.shape) * niter / dt / 1e6:.1f} MLUPS")
    if lat.engine_name != "cuda_generic_band[d2q9_kuper,fuse=1]":
        fail(f"1024^2 drop ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps:
        fail(f"1024^2 drop: generic2d_step flavours {flavours}, eager "
             f"steps {lat.eager_steps}")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail("1024^2 drop: non-finite fields")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": float(np.prod(lat.shape)) * niter / dt / 1e6}


def heat_adj_solve_state(xml):
    """heat_adj.xml's lattice after its <Solve>: the state the Optimize's
    first evaluation starts from (FDTest leaves the state as it was)."""
    return case_lattice(xml, torch.float32, DEVICE,
                        drop=("FDTest", "Optimize", "ThresholdNow", "VTK"))


def run_heat_adj(gk, ak) -> dict:
    """The adjoint main path: example/heat_adj.xml unchanged (phase 11)."""
    return run_design_xml(gk, ak, HEAT_ADJ_XML, "11",
                          heat_adj_solve_state(HEAT_ADJ_XML))


def run_design_xml(gk, ak, xml, phase: str, start) -> dict:
    """A design case unchanged through ``run_config`` — its Solve on the
    resident engine, FDTest and the MMA Optimize on ``cuda_adjoint``,
    ThresholdNow, VTK — counted from 0, then the first Optimize
    evaluation's f32 kernel gradient against an f64 eager gradient on the
    card, from ``start``: the lattice the Optimize begins from."""
    from tclb_tpu_torch.adjoint import (InternalTopology,
                                        make_unsteady_gradient)
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.core.lattice import LatticeState, SimParams
    from tclb_tpu_torch.models import get_model
    root = ET.parse(xml).getroot()
    model = get_model(root.get("model"))
    case = xml.name
    say(f"phase {phase}: {case} end to end ("
        + ", ".join(el.tag for el in root
                    if el.tag not in ("Geometry", "Model")) + ")")
    opt_el = root.find("Optimize")
    niter = int(opt_el.get("Iterations"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            gk.reset_launches()
            ak.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**gk.LAUNCHES, **ak.LAUNCHES}
            flavours = gk.flavours()
        finally:
            os.chdir(cwd)
        out = os.path.join(tmp, root.get("output"))
        files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    lat = solver.lattice
    say(f"  primal engine {lat.engine_name}, adjoint engine "
        f"{solver.adjoint_engine}, {wall:.3f} s wall, launches {launches} "
        f"(generic2d_step flavours {flavours}), eager steps "
        f"{lat.eager_steps}")
    for r in solver.fd_records:
        say(f"  FDTest component {r['index']}: adjoint {r['adjoint']:.8g} "
            f"fd {r['fd']:.8g} rel_err {r['rel_err']:.3e} (f32: logged, "
            "not judged)")
    for k, obj in enumerate(solver.opt_history):
        say(f"  Optimize[MMA] evaluation {k}: objective {obj:.9g}")
    mat = solver.opt_material
    say(f"  material: start {mat['start']:.9g}, end {mat['end']:.9g} "
        f"({mat['direction']})")
    if lat.engine_name != f"cuda_generic_resident[{model.name},fuse=N]":
        fail(f"{case}'s Solve ran on {lat.engine_name}")
    if solver.adjoint_engine != f"cuda_adjoint[{model.name},k=1]":
        fail(f"{case}'s gradients ran on {solver.adjoint_engine}")
    if launches["generic2d_step_b"] < 1 or flavours["globals"] < 1 \
            or launches["generic2d_resident"] < 1:
        fail(f"{case} launches {launches}, flavours {flavours}")
    if len(solver.opt_history) != int(opt_el.get("MaxEvaluations")) \
            or not all(math.isfinite(o) for o in solver.opt_history):
        fail(f"{case} objectives {solver.opt_history}")
    if mat["end"] > mat["start"] * (1 + 1e-6):
        fail(f"{case} broke its material constraint: {mat}")
    # the design: binary on the DesignSpace nodes after ThresholdNow, w
    # elsewhere as the Optimize found it
    design_nodes = (lat.state.flags & model.group_masks["DESIGNSPACE"]) != 0
    w = lat.get_quantity("W")
    values = sorted(set(torch.unique(w[design_nodes]).tolist()))
    if not set(values) <= {0.0, 1.0}:
        fail(f"{case}'s design is not binary after ThresholdNow: "
             f"{values[:8]}")
    if not torch.equal(w[~design_nodes],
                       start.get_quantity("W")[~design_nodes]):
        fail(f"{case} changed w outside its DesignSpace")
    wants_vtk = root.find("VTK") is not None
    if (wants_vtk and not any(f.endswith(".vti") for f in files)) \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{case}: output {files} or non-finite fields")
    solid = int((w == 0).sum())
    say(f"  design values after ThresholdNow {values}, {solid} solid nodes")

    # the first Optimize evaluation: the same state, theta and horizon
    design = InternalTopology(model)
    theta = design.get(start.state, start.params)
    g32_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    device=DEVICE)
    obj32, g32, _ = g32_fn(theta, start.state, start.params)
    state64 = LatticeState(fields=start.state.fields.double(),
                           flags=start.state.flags,
                           globals_=start.state.globals_.double(),
                           iteration=start.state.iteration)
    params64 = SimParams(settings=start.params.settings.double(),
                         zone_table=start.params.zone_table.double())
    g64_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    dtype=torch.float64, device=DEVICE)
    obj64, g64, _ = g64_fn(theta.double(), state64, params64)
    rel_l2 = float((g32.double() - g64).norm() / g64.norm())
    say(f"  first evaluation: {g32_fn.engine_name} objective "
        f"{float(obj32):.9g} (Optimize logged "
        f"{solver.opt_history[0]:.9g}), {g64_fn.engine_name} f64 "
        f"{float(obj64):.9g}; gradient rel L2 {rel_l2:.3e} (limit "
        f"{GRAD_F64_REL_L2})")
    if g64_fn.engine_name != "eager" or not rel_l2 <= GRAD_F64_REL_L2:
        fail(f"{case}'s f32 kernel gradient is {rel_l2} from f64")
    if abs(float(obj32) - solver.opt_history[0]) \
            > 1e-6 * abs(solver.opt_history[0]):
        fail("the re-run first evaluation differs from the Optimize's")
    return {"launches": launches, "flavours": flavours, "wall_s": wall,
            "objectives": solver.opt_history, "material": mat,
            "fd_records": solver.fd_records, "grad_rel_l2_f64": rel_l2,
            "solid_nodes": solid, "lattice": lat}


def run_heat1024(gk, ak, lat) -> dict:
    """bench.py's heat_adj channel at 512x1024 (phase 12), with w = 0.8 on
    the design block: Drag = (1 - w)|ux| then depends on the flow, so the
    gradient runs through every step's field cotangents."""
    return run_gradient_channel(gk, ak, lat, "12", 0.8)


def run_gradient_channel(gk, ak, lat, phase: str, fill=None,
                         from_start: bool = False) -> dict:
    """A bench.py gradient channel: (a) ``iterate(2000)`` on the band
    engine; (b) an 8-step gradient on cuda_adjoint against eager autograd
    on the card, f32; (c) a 1000-step unsteady gradient with automatic
    checkpoint levels, counted from 0.  The gradients start from the
    developed state, or with ``from_start`` from the state before (a), as
    bench.py's ``bench_adjoint`` does; the design theta is the state's own
    (``fill`` None) or ``fill`` on the whole block."""
    import dataclasses
    from tclb_tpu_torch.adjoint import (InternalTopology, auto_levels,
                                        make_unsteady_gradient)
    name = lat.model.name
    what = f"{lat.shape[0]}x{lat.shape[1]} {name} channel"
    say(f"phase {phase}: {what}: primal band engine and gradients")
    nodes = float(np.prod(lat.shape))
    start = dataclasses.replace(lat.state, fields=lat.state.fields.clone())
    niter = 2000
    lat.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    flavours = gk.flavours()
    mlups = nodes * niter / dt / 1e6
    say(f"  (a) engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), {mlups:.1f} MLUPS")
    if lat.engine_name != f"cuda_generic_band[{name},fuse=1]":
        fail(f"the {what} ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"the {what}: flavours {flavours}, eager steps "
             f"{lat.eager_steps}")
    m = lat.model
    state = start if from_start else lat.state
    design = InternalTopology(m)
    theta = design.get(state, lat.params)
    if fill is not None:
        theta = torch.full_like(theta, fill)
    got = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device=DEVICE)
        got[engine] = fn(theta, state, lat.params)
    (oc, gc, _), (oe, ge, _) = got["cuda"], got["eager"]
    err = (gc - ge).abs()
    ok = bool((err <= GRAD_ATOL + GRAD_RTOL * ge.abs()).all()) \
        and float(ge.abs().max()) > 0
    say(f"  (b) 8-step gradient: cuda_adjoint objective {float(oc):.9g}, "
        f"eager {float(oe):.9g}; max abs err {float(err.max()):.3e}, "
        f"max |g| {float(ge.abs().max()):.3e} (rtol {GRAD_RTOL} atol "
        f"{GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {what}'s 8-step kernel gradient disagrees with eager")
    horizon = 1000
    levels = auto_levels(m, lat.shape, horizon)
    if levels != 2:
        fail(f"auto_levels chose {levels} for the 1000-step gradient")
    grad_fn = make_unsteady_gradient(m, design, horizon, shape=lat.shape,
                                     device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    obj, g, _ = grad_fn(theta, state, lat.params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grad_launches = {**gk.LAUNCHES, **ak.LAUNCHES}
    grad_flavours = gk.flavours()
    peak = torch.cuda.max_memory_allocated()
    rate = nodes * horizon / wall / 1e6
    primal_s = horizon * nodes / (mlups * 1e6)
    say(f"  (c) 1000-step gradient, levels {levels}: {wall:.3f} s wall, "
        f"{rate:.1f} primal-equivalent MLUPS, {wall / primal_s:.2f}x the "
        f"wall of 1000 primal steps, peak memory {peak / 2**30:.2f} GiB, "
        f"launches {grad_launches}, objective {float(obj):.9g}")
    if not (math.isfinite(float(obj)) and bool(torch.isfinite(g).all())):
        fail(f"the {what}'s 1000-step gradient is not finite")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": mlups, "grad_launches": grad_launches,
            "grad_flavours": grad_flavours,
            "grad8_max_abs_err": float(err.max()),
            "grad1000": {"levels": levels, "wall_s": wall,
                         "mlups_primal_equivalent": rate,
                         "wall_over_primal": wall / primal_s,
                         "max_memory_allocated": peak},
            "grad_fn": lambda: grad_fn(theta, state, lat.params)}


def adj3d_case_file(directory) -> pathlib.Path:
    """The 3D adjoint case XML (tests/torch_cases.py:adj3d_case_xml) at
    bench.py's 32x64x256, written into ``directory``."""
    from torch_cases import adj3d_case_xml
    path = pathlib.Path(directory) / "adj3d_case.xml"
    path.write_text(adj3d_case_xml("chip"))
    return path


def rich_adj3d_lattice(device):
    """An 8x16x32 d3q19_adj state that paints every node type the model
    reads, two zones and a design field in (0.1, 0.9)
    (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import ADJ3D_SETTINGS, ADJ3D_SHAPE, paint_rich_adj3d
    lat = Lattice(get_model("d3q19_adj"), ADJ3D_SHAPE, dtype=torch.float32,
                  device=device, settings=ADJ3D_SETTINGS)
    return paint_rich_adj3d(lat, seed=5)


def bench3d_lattice(device, shape=(32, 64, 256)):
    """bench.py:bench_adjoint3d's d3q19_adj case (bench.py:418-428)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import bench_adjoint3d_lattice
    return bench_adjoint3d_lattice(Lattice, get_model("d3q19_adj"),
                                   torch.float32, shape, device=device)


def f64_copy(lat):
    """``(state, params)`` of a lattice in f64."""
    from tclb_tpu_torch.core.lattice import LatticeState, SimParams
    st, pa = lat.state, lat.params
    return (LatticeState(fields=st.fields.double(), flags=st.flags,
                         globals_=st.globals_.double(),
                         iteration=st.iteration),
            SimParams(settings=pa.settings.double(),
                      zone_table=pa.zone_table.double()))


def run_adj3d_case(g3, ak, xml) -> dict:
    """The 3D adjoint path: the case XML through ``run_config`` -- the
    Solve on the band engine, FDTest and the MMA Optimize on
    ``cuda_adjoint3d``, ThresholdNow, VTK -- counted from 0; then the first
    Optimize evaluation's f32 kernel gradient against an f64 eager
    gradient on the card, and an 8-step f64 central-difference check at
    three components inside the design block."""
    from tclb_tpu_torch.adjoint import (InternalTopology, fd_test,
                                        make_objective_run,
                                        make_unsteady_gradient)
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    from torch_cases import adj3d_design_block
    say("phase 13: the 3D adjoint case at 32x64x256 end to end (Solve, "
        "FDTest, MMA Optimize, ThresholdNow, VTK)")
    root = ET.parse(xml).getroot()
    model = get_model(root.get("model"))
    opt_el = root.find("Optimize")
    niter = int(opt_el.get("Iterations"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            g3.reset_launches()
            ak.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**g3.LAUNCHES, **ak.LAUNCHES}
            flavours = dict(g3.FLAVOUR_LAUNCHES)
        finally:
            os.chdir(cwd)
        files = sorted(os.listdir(os.path.join(tmp, root.get("output"))))
    lat = solver.lattice
    say(f"  primal engine {lat.engine_name}, adjoint engine "
        f"{solver.adjoint_engine}, {wall:.3f} s wall, launches {launches} "
        f"(generic3d_step flavours {flavours}), eager steps "
        f"{lat.eager_steps}")
    for r in solver.fd_records:
        say(f"  FDTest component {r['index']}: adjoint {r['adjoint']:.8g} "
            f"fd {r['fd']:.8g} rel_err {r['rel_err']:.3e} (f32: logged, "
            "not judged)")
    for k, obj in enumerate(solver.opt_history):
        say(f"  Optimize[MMA] evaluation {k}: objective {obj:.9g}")
    mat = solver.opt_material
    say(f"  material: start {mat['start']:.9g}, end {mat['end']:.9g} "
        f"({mat['direction']})")
    if lat.engine_name != "cuda_generic3d_band[d3q19_adj,fuse=1]":
        fail(f"the 3D case's Solve ran on {lat.engine_name}")
    if solver.adjoint_engine != "cuda_adjoint3d[d3q19_adj,k=1]":
        fail(f"the 3D case's gradients ran on {solver.adjoint_engine}")
    if launches["generic3d_step_b"] < 1 or launches["generic2d_step_b"] \
            or flavours["globals"] < 1 or flavours["plain"] < 1 \
            or lat.eager_steps:
        fail(f"the 3D case: launches {launches}, flavours {flavours}, "
             f"eager steps {lat.eager_steps}")
    if len(solver.opt_history) != int(opt_el.get("MaxEvaluations")) \
            or not all(math.isfinite(o) for o in solver.opt_history):
        fail(f"the 3D case's objectives {solver.opt_history}")
    if mat["end"] > mat["start"] * (1 + 1e-6):
        fail(f"the 3D case broke its material constraint: {mat}")
    w = lat.get_quantity("W")
    block = adj3d_design_block(lat.shape)
    values = sorted(set(torch.unique(w[block]).tolist()))
    if not set(values) <= {0.0, 1.0}:
        fail(f"the 3D design block is not binary after ThresholdNow: "
             f"{values[:8]}")
    if not any(f.endswith(".vti") for f in files) \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"the 3D case: output {files} or non-finite fields")
    solid = int((w[block] == 0).sum())
    say(f"  design block values after ThresholdNow {values}, {solid} "
        "solid nodes")

    # the first Optimize evaluation: the same state, theta and horizon
    start = case_lattice(xml, torch.float32, DEVICE,
                         drop=("FDTest", "Optimize", "ThresholdNow", "VTK"))
    design = InternalTopology(model)
    theta = design.get(start.state, start.params)
    g32_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    device=DEVICE)
    obj32, g32, _ = g32_fn(theta, start.state, start.params)
    state64, params64 = f64_copy(start)
    g64_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    dtype=torch.float64, device=DEVICE)
    obj64, g64, _ = g64_fn(theta.double(), state64, params64)
    rel_l2 = float((g32.double() - g64).norm() / g64.norm())
    say(f"  first evaluation: {g32_fn.engine_name} objective "
        f"{float(obj32):.9g} (Optimize logged "
        f"{solver.opt_history[0]:.9g}), {g64_fn.engine_name} f64 "
        f"{float(obj64):.9g}; gradient rel L2 {rel_l2:.3e} (limit "
        f"{GRAD_F64_REL_L2})")
    if g32_fn.engine_name != "cuda_adjoint3d[d3q19_adj,k=1]" \
            or g64_fn.engine_name != "eager" \
            or not rel_l2 <= GRAD_F64_REL_L2:
        fail(f"the 3D case's f32 kernel gradient is {rel_l2} from f64")
    if abs(float(obj32) - solver.opt_history[0]) \
            > 1e-6 * abs(solver.opt_history[0]):
        fail("the re-run first evaluation differs from the Optimize's")

    # central differences inside the design block, f64 eager, against the
    # f64 adjoint (judged) and the f32 kernel adjoint (logged)
    fd_el = root.find("FDTest")
    fd_iter, checks = int(fd_el.get("Iterations")), int(fd_el.get("Checks"))
    quarters = ((2, 2, 2), (1, 3, 1), (3, 1, 3))
    nodes = [tuple(sl.start + (sl.stop - sl.start) * q // 4
                   for sl, q in zip(block, f)) for f in quarters]
    idx = [int(np.ravel_multi_index((0,) + n, tuple(theta.shape)))
           for n in nodes[:checks]]
    fd64_fn = make_unsteady_gradient(model, design, fd_iter,
                                     dtype=torch.float64, device=DEVICE)
    _, gfd64, _ = fd64_fn(theta.double(), state64, params64)
    fd32_fn = make_unsteady_gradient(model, design, fd_iter,
                                     shape=start.shape, device=DEVICE)
    _, gfd32, _ = fd32_fn(theta, start.state, start.params)
    run = make_objective_run(model, fd_iter)

    def loss(th):
        return run(*design.put(th, state64, params64))[0]

    records = fd_test(loss, gfd64, theta.double(), indices=idx, eps=1e-4)
    flat32 = gfd32.reshape(-1)
    for r in records:
        r["kernel_f32"] = float(flat32[r["index"]])
        say(f"  FD component {r['index']} (in the design block): f64 "
            f"adjoint {r['adjoint']:.10g}, fd {r['fd']:.10g}, rel_err "
            f"{r['rel_err']:.3e} (rtol {FD_REL} atol {FD_ATOL}); f32 kernel "
            f"adjoint {r['kernel_f32']:.8g}")
        if not (r["adjoint"] != 0 and abs(r["fd"] - r["adjoint"])
                <= FD_ATOL + FD_REL * abs(r["adjoint"])):
            fail(f"the 3D case's FD check at {r['index']}: {r}")
    return {"launches": launches, "flavours": flavours, "wall_s": wall,
            "objectives": solver.opt_history, "material": mat,
            "fd_records": solver.fd_records, "fd_in_block": records,
            "grad_rel_l2_f64": rel_l2, "solid_nodes": solid,
            "start": start}


def run_bench_adjoint3d(g3, ak, lat) -> dict:
    """bench.py's 3D adjoint case (bench_adjoint3d) at 32x64x256: (a)
    ``iterate(2000)`` on the band engine; (b) an 8-step gradient on
    cuda_adjoint3d against eager autograd on the card, f32; (c) the
    200-step gradient (bench.py:436-446), best of two timed runs; (d) a
    1000-step gradient at 64x128x256 with automatic checkpoint levels,
    counted from 0, run ``GRAD3D_RUNS`` times: each run's wall and the
    median (phase 8 adds a trace's device-busy time)."""
    from tclb_tpu_torch.adjoint import (InternalTopology, auto_levels,
                                        make_unsteady_gradient)
    say("phase 14: bench.py's 3D adjoint case: the band primal and "
        "gradients")
    nodes = float(np.prod(lat.shape))
    niter = 2000
    # the gradients start from the initialised state, as bench.py's do:
    # with Porocity 0.5 everywhere and no inlet the flow dies out
    state0, params0 = lat.state, lat.params
    lat.synchronize()
    g3.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(g3.LAUNCHES)
    flavours = dict(g3.FLAVOUR_LAUNCHES)
    mlups = nodes * niter / dt / 1e6
    say(f"  (a) engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), {mlups:.1f} MLUPS")
    if lat.engine_name != "cuda_generic3d_band[d3q19_adj,fuse=1]":
        fail(f"bench_adjoint3d ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"bench_adjoint3d: flavours {flavours}, eager steps "
             f"{lat.eager_steps}")
    m = lat.model
    design = InternalTopology(m)
    theta = design.get(state0, params0)
    got = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device=DEVICE)
        got[engine] = fn(theta, state0, params0)
    (oc, gc, _), (oe, ge, _) = got["cuda"], got["eager"]
    err = (gc - ge).abs()
    ok = bool((err <= GRAD_ATOL + GRAD_RTOL * ge.abs()).all()) \
        and float(ge.abs().max()) > 0 and float(oc) != 0
    say(f"  (b) 8-step gradient: cuda_adjoint3d objective {float(oc):.9g}, "
        f"eager {float(oe):.9g}; max abs err {float(err.max()):.3e}, "
        f"max |g| {float(ge.abs().max()):.3e} (rtol {GRAD_RTOL} atol "
        f"{GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the 8-step 3D kernel gradient disagrees with eager")
    grad200 = make_unsteady_gradient(m, design, 200, shape=lat.shape,
                                     device=DEVICE)
    grad200(theta, state0, params0)
    best = math.inf
    for _ in range(2):
        torch.cuda.synchronize()
        g3.reset_launches()
        ak.reset_launches()
        t0 = time.perf_counter()
        obj, g, _ = grad200(theta, state0, params0)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if not (math.isfinite(float(obj)) and bool(torch.isfinite(g).all())):
            fail("the 200-step 3D gradient is not finite")
    g200_launches = {**g3.LAUNCHES, **ak.LAUNCHES}
    g200_flavours = dict(g3.FLAVOUR_LAUNCHES)
    levels200 = auto_levels(m, lat.shape, 200)
    say(f"  (c) 200-step gradient, levels {levels200}: {best:.4f} s wall "
        f"(best of 2), {nodes * 200 / best / 1e6:.1f} primal-equivalent "
        f"MLUPS, launches {g200_launches}")

    big = bench3d_lattice(DEVICE, (64, 128, 256))
    big0 = big.state
    nodes_big = float(np.prod(big.shape))
    horizon = 1000
    big.iterate(2)
    big.synchronize()
    t0 = time.perf_counter()
    big.iterate(horizon)
    big.synchronize()
    primal_s = time.perf_counter() - t0
    mlups_big = nodes_big * horizon / primal_s / 1e6
    levels = auto_levels(m, big.shape, horizon)
    if levels != 2:
        fail(f"auto_levels chose {levels} for the 1000-step 3D gradient")
    theta_big = design.get(big0, big.params)
    grad_fn = make_unsteady_gradient(m, design, horizon, shape=big.shape,
                                     device=DEVICE)
    runs = []
    for i in range(GRAD3D_RUNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g3.reset_launches()
        ak.reset_launches()
        t0 = time.perf_counter()
        obj, g, _ = grad_fn(theta_big, big0, big.params)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if i == 0:
            grad_launches = {**g3.LAUNCHES, **ak.LAUNCHES}
            grad_flavours = dict(g3.FLAVOUR_LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(runs)
    rate = nodes_big * horizon / wall / 1e6
    say(f"  (d) 64x128x256: 1000 primal steps {primal_s:.4f} s "
        f"({mlups_big:.1f} MLUPS); 1000-step gradient, levels {levels}: "
        f"runs {', '.join(f'{r:.4f}' for r in runs)} s, median "
        f"{wall:.3f} s wall, {rate:.1f} primal-equivalent MLUPS, "
        f"{wall / primal_s:.2f}x the wall of 1000 primal steps, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {grad_launches}, objective "
        f"{float(obj):.9g}")
    if not (math.isfinite(float(obj)) and float(obj) != 0
            and bool(torch.isfinite(g).all())):
        fail("the 1000-step 3D gradient is zero or not finite")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": mlups,
            "grad8_max_abs_err": float(err.max()),
            "grad200": {"levels": levels200, "wall_s": best,
                        "mlups_primal_equivalent": nodes * 200 / best / 1e6,
                        "launches": g200_launches,
                        "flavours": g200_flavours},
            "grad1000": {"shape": list(big.shape), "levels": levels,
                         "wall_s": wall, "runs_s": runs,
                         "primal_1000_s": primal_s,
                         "primal_mlups": mlups_big,
                         "mlups_primal_equivalent": rate,
                         "wall_over_primal": wall / primal_s,
                         "max_memory_allocated": peak,
                         "launches": grad_launches,
                         "flavours": grad_flavours},
            "grad_fn": lambda: grad_fn(theta_big, big0, big.params)}


def time_generic3d(g3, ak, lat) -> dict:
    """d3q19_adj's ``generic3d_step`` (both flavours) and
    ``generic3d_step_b`` at the 3D paths' launch (32x64x256)."""
    out = {}
    *inputs, a = g3.kernel_inputs(lat.model, lat.state, lat.params)
    for g in (False, True):
        key = f"generic3d_step[{lat.model.name}]" + (" globals" if g else "")
        fn = g3.step_globals if g else g3.step
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: g3.plain_steps(*inputs, a, 1, with_globals=g),
            g3.launch_bytes(lat.model, lat.shape),
            g3.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            200 if g else 400, plain_reps=3)
    out.update(time_step_b(ak, g3, lat, plain_reps=3))
    return out


def run_iterate(dk, lat, phase: str, what: str, engine: str, kernels,
                niter: int = 2002) -> dict:
    """``lat.iterate(niter)`` on ``engine``, counted from 0: each of
    ``kernels`` launched, one trailing eager step (the globals), finite
    fields, and the window's MLUPS."""
    say(f"phase {phase}: {what}")
    lat.synchronize()
    dk.reset_launches()
    eager0 = lat.eager_steps
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dk.LAUNCHES)
    mlups = float(np.prod(lat.shape)) * niter / dt / 1e6
    say(f"  engine {lat.engine_name}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, {mlups:.1f} MLUPS")
    if lat.engine_name != engine:
        fail(f"{what} ran on {lat.engine_name}")
    for name in kernels:
        if launches[name] < 1:
            fail(f"{what} did not launch {name}")
    if lat.eager_steps - eager0 != 1:
        fail(f"{what}: {lat.eager_steps - eager0} eager steps")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{what}: non-finite fields")
    return {"launches": launches, "mlups_iterate": mlups, "lattice": lat}


def rich_family_lattice(model: str, device):
    """A 32x64 state of a d2q9-family model that paints every node type
    the model reads, two zones and gravity (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import FAMILY_SHAPE, family_settings, paint_rich_family
    m = get_model(model)
    lat = Lattice(m, FAMILY_SHAPE, dtype=torch.float32, device=device,
                  settings=family_settings(m))
    return paint_rich_family(lat, seed=5)


def family_channel_lattice(model: str, device, shape):
    """bench.py's channels for a family model: its d2q9_cumulant channel
    (bench.py:194-207: BGK nodes, W velocity inlet, E pressure outlet, two
    walls, nu 0.02, Velocity 0.01, omega_bulk 1) for d2q9_cumulant, and
    its d2q9 channel's flags (bench.py:154-167) with the same settings for
    the other models."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import channel_flags, cumulant_channel_flags
    m = get_model(model)
    settings = {"nu": 0.02, "Velocity": 0.01}
    if model == "d2q9_cumulant":
        settings["omega_bulk"] = 1.0
        flags = cumulant_channel_flags(m, *shape)
    else:
        flags = channel_flags(m, *shape)
    lat = Lattice(m, shape, dtype=torch.float32, device=device,
                  settings=settings)
    lat.set_flags(flags)
    lat.init()
    return lat


def run_xml(xml, dtype):
    """A case XML through ``run_config`` on the card's eager engine
    (``TCLB_FASTPATH=0``) from a temporary working directory (its output=
    prefix is relative)."""
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    model = get_model(ET.parse(xml).getroot().get("model"))
    cwd, fastpath = os.getcwd(), os.environ.get("TCLB_FASTPATH")
    with case_dir() as tmp:
        os.chdir(tmp)
        os.environ["TCLB_FASTPATH"] = "0"
        try:
            solver = run_config(str(xml), model, dtype=dtype, device=DEVICE)
            solver.lattice.synchronize()
        finally:
            os.chdir(cwd)
            if fastpath is None:
                del os.environ["TCLB_FASTPATH"]
            else:
                os.environ["TCLB_FASTPATH"] = fastpath
    return solver


def mean_ux_between_walls(lat) -> float:
    return float(lat.get_quantity("U")[0, 1:-1, :].double().mean())


def check_cumulant2d(lat) -> None:
    """The inlet-driven cumulant channel flows along +x: a mean ux between
    the walls in (0, 0.1) (the case paints no objective nodes, so its
    flux globals stay 0)."""
    ux = mean_ux_between_walls(lat)
    say(f"  mean ux {ux:.6g}, globals {lat.get_globals()}")
    if not 0 < ux < 0.1:
        fail(f"cumulant2d: implausible mean ux {ux}")


def check_les(lat) -> None:
    """The gravity-driven LES channel accelerates along +x."""
    ux = mean_ux_between_walls(lat)
    say(f"  mean ux {ux:.6g}")
    if not 0 < ux < 0.2:
        fail(f"les_channel: implausible mean ux {ux}")


def check_poiseuille(xml, out: dict):
    """BASELINE config 2 on d2q9_SRT: the f32 kernel run's final ux
    profile (the mean over x of each fluid row) against the same XML run on
    the eager engine on the card, in f32 at the kernels' own tolerance
    (rtol 2e-5, atol 2e-6) and in f64 within a relative L2 error of
    POISEUILLE_F64_REL_L2; the f32 eager run's own distance from f64 is
    reported beside it."""
    def profile(lat):
        return lat.get_quantity("U")[0, 1:-1].double().mean(dim=1)

    def check(lat) -> None:
        got = profile(lat)
        refs = {}
        for dtype in (torch.float32, torch.float64):
            ref = run_xml(xml, dtype)
            if ref.lattice.engine_name != "eager" \
                    or ref.iter != lat.state.iteration:
                fail(f"SRT Poiseuille {dtype} reference: "
                     f"{ref.lattice.engine_name}, {ref.iter} iterations")
            refs[dtype] = profile(ref.lattice)
        want = refs[torch.float64]
        out["vs_f32_eager"] = compare(got, refs[torch.float32],
                                      "SRT Poiseuille ux profile, f32 "
                                      "kernels vs f32 eager")
        for what, u in (("kernels", got), ("eager", refs[torch.float32])):
            rel = float((u - want).norm() / want.norm())
            out[f"f32_{what}_vs_f64_rel_l2"] = rel
            out[f"f32_{what}_vs_f64_max_abs"] = float((u - want).abs().max())
            say(f"  SRT Poiseuille ux profile, f32 {what} vs f64 eager: "
                f"relative L2 {rel:.3e}, max_abs "
                f"{out[f'f32_{what}_vs_f64_max_abs']:.3e} (limit "
                f"{POISEUILLE_F64_REL_L2} for the kernels)")
        out["ux_max"] = float(want.max())
        if not out["f32_kernels_vs_f64_rel_l2"] <= POISEUILLE_F64_REL_L2:
            fail("SRT Poiseuille: the f32 kernel profile is too far from "
                 "f64")
        if not float(want.max()) > 0:
            fail("SRT Poiseuille: no flow")
    return check


def run_family(dk, band_lats: dict, res_lats: dict, errs: dict) -> dict:
    """The d2q9 family's paths, each counted from 0 (phases 15-19), then
    every family kernel against its plain version on each path's developed
    state (phase 19b).  Returns the launches by kernel and path, each
    model's resident-path lattice and the paths' figures."""
    from torch_cases import srt_poiseuille_xml
    keys = ("wall_s", "mlups_end_to_end", "mlups_iterate", "iterate_ms",
            "iterate_host_ms", "eager_step_ms", "eager_steps")
    launches = {dk.launch_key(name, m): {} for m in dk.FAMILY
                for name in dk.KERNELS}
    resident, summary, developed = {}, {}, []

    def engine(kind: str, m: str) -> str:
        return (f"cuda_d2q9_resident[{m},fuse={dk.RESIDENT_FUSE}]"
                if kind == "resident" else f"cuda_d2q9_band[{m},fuse=2]")

    def kernels(kind: str, m: str) -> tuple:
        first = "d2q9_resident8" if kind == "resident" else "d2q9_step2"
        return (dk.launch_key(first, m), dk.launch_key("d2q9_step", m))

    def record(path: str, m: str, run: dict) -> None:
        for name in dk.KERNELS:
            n = run["launches"][dk.launch_key(name, m)]
            if n:
                launches[dk.launch_key(name, m)][path] = n
        developed.append(run["lattice"])

    m = "d2q9_cumulant"
    run = run_case(dk, CUMULANT2D_XML, "15", engine("resident", m),
                   kernels("resident", m), check_cumulant2d)
    record("cumulant2d", m, run)
    resident[m] = run["lattice"]
    summary["cumulant2d"] = {k: run[k] for k in keys}
    run = run_iterate(dk, band_lats[m], "16", "bench.py's 1024x1024 "
                      "d2q9_cumulant channel on the band engine",
                      engine("band", m), kernels("band", m))
    record("cumulant1024", m, run)
    summary["d2q9_cumulant1024_mlups_iterate"] = run["mlups_iterate"]
    m = "d2q9_les"
    run = run_case(dk, LES_XML, "17", engine("resident", m),
                   kernels("resident", m), check_les)
    record("les_channel", m, run)
    resident[m] = run["lattice"]
    summary["les_channel"] = {k: run[k] for k in keys}
    m = "d2q9_SRT"
    with tempfile.TemporaryDirectory() as tmp:
        xml = pathlib.Path(tmp) / "poiseuille_srt.xml"
        xml.write_text(srt_poiseuille_xml())
        profile = {}
        run = run_case(dk, xml, "18", engine("resident", m),
                       kernels("resident", m), check_poiseuille(xml, profile))
    record("srt_poiseuille", m, run)
    resident[m] = run["lattice"]
    summary["srt_poiseuille"] = {**{k: run[k] for k in keys},
                                 "ux_profile": profile}
    summary["family1024_mlups_iterate"] = {}
    for m in ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_new"):
        run = run_iterate(dk, band_lats[m], "19", f"bench.py's 1024x1024 "
                          f"channel, {m}, on the band engine",
                          engine("band", m), kernels("band", m))
        record("channel1024", m, run)
        summary["family1024_mlups_iterate"][m] = run["mlups_iterate"]
    summary["family128x1024_mlups_iterate"] = {}
    for m, lat in res_lats.items():
        run = run_iterate(dk, lat, "19", f"bench.py's channel at 128x1024, "
                          f"{m}, on the resident engine",
                          engine("resident", m), kernels("resident", m))
        record("channel128x1024", m, run)
        resident[m] = lat
        summary["family128x1024_mlups_iterate"][m] = run["mlups_iterate"]
    check_kernels([(dk, lat, name) for lat in developed
                   for name in dk.KERNELS], errs,
                  "phase 19b, the family's paths after their runs")
    return {"launches": launches, "resident_lattice": resident,
            "summary": summary}


def rich_d3q_lattice(model: str, device):
    """A 12x8x64 state of a z-slab family model that paints every node
    type the model reads, two zones and gravity (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import SHAPE3D, d3q_family_settings, paint_rich_d3q
    m = get_model(model)
    lat = Lattice(m, SHAPE3D, dtype=torch.float32, device=device,
                  settings=d3q_family_settings(m))
    return paint_rich_d3q(lat, seed=5)


def channel48_lattice(model: str, device):
    """bench.py's 3D channel (bench.py:619-662) at 48x48x256: MRT nodes,
    walls at y = 0 and y = ny - 1, nu 0.01 and a body force along x."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import channel3d_flags
    m = get_model(model)
    lat = Lattice(m, CHANNEL48, dtype=torch.float32, device=device,
                  settings={"nu": 0.01, "GravitationX": 1e-5})
    lat.set_flags(channel3d_flags(m, *CHANNEL48))
    lat.init()
    return lat


def turbulence_lattice(device):
    """example/3dcum_turbulence.xml painted and initialised, its SynthT
    planes drawn once for a 200-step segment (nonzero) and the flow
    warmed 20 eager steps."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    root = ET.parse(TURB_XML).getroot()
    for tag in ("Solve", "Log"):
        for el in root.findall(tag):
            root.remove(el)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as out:
        os.chdir(out)
        try:
            solver = _run_root(root, get_model(root.get("model")), None,
                               torch.float32, out + "/", "case_state",
                               device=device)
        finally:
            os.chdir(cwd)
    solver.update_synthetic_turbulence(200)
    lat = solver.lattice
    eager_warm(lat, 20)
    if not float(lat.get_density("SynthTX").abs().max()) > 0:
        fail("3dcum_turbulence: SynthT planes are zero")
    return lat


def run_turbulence(dk3) -> dict:
    """Path A: example/3dcum_turbulence.xml unchanged through
    ``run_config`` on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]`` (phase
    20, counted from 0).  The Solve draws new SynthT planes before each of
    its five iterate calls: their digests are recorded and must all
    differ; the inlet's ux must fluctuate and the flow near the inlet carry
    a transverse velocity (after tests/test_turbulence.py:56-93)."""
    from tclb_tpu_torch.control.solver import Solver
    synth_sums = []
    update = Solver.update_synthetic_turbulence

    def recording(self, steps):
        update(self, steps)
        planes = [self.lattice.get_density(n)
                  for n in ("SynthTX", "SynthTY", "SynthTZ")]
        synth_sums.append(float(sum(p.double().abs().sum()
                                    for p in planes)))

    def check(lat) -> None:
        u = lat.get_quantity("U")
        ux_in = u[0, 1:-1, 1:-1, 0].double()
        uy_near = float(u[1, :, :, 1].abs().max())
        sx = float(lat.get_density("SynthTX").abs().max())
        say(f"  SynthT digests per segment {synth_sums}; inlet ux mean "
            f"{float(ux_in.mean()):.6g} std {float(ux_in.std()):.3e}, "
            f"max |uy| at x = 1 {uy_near:.3e}, max |SynthTX| {sx:.3g}")
        if len(synth_sums) != 5 or len(set(synth_sums)) != len(synth_sums):
            fail(f"3dcum_turbulence: SynthT planes did not change between "
                 f"segments: {synth_sums}")
        if not (float(ux_in.std()) > 1e-4 and uy_near > 1e-5 and sx > 1e-3
                and 0 < float(ux_in.mean()) < 0.1):
            fail("3dcum_turbulence: the inlet does not fluctuate")

    Solver.update_synthetic_turbulence = recording
    try:
        out = run_case(dk3, TURB_XML, "20",
                       "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
                       ("d3q27_step2", "d3q27_step"), check)
    finally:
        Solver.update_synthetic_turbulence = update
    out["synth_digests"] = synth_sums
    return out


def run_d3q_channels(dk3, lats: dict) -> dict:
    """Path B (phase 21): bench.py's 48x48x256 channel for each z-slab
    family model, ``iterate(2002)`` on ``cuda_d3q27_band[<model>,fuse=2]``,
    counted from 0, its launches by kernel and its MLUPS."""
    out = {}
    for m, lat in lats.items():
        run = run_iterate(dk3, lat, "21", f"bench.py's 48x48x256 channel, "
                          f"{m}, on the band engine",
                          f"cuda_d3q27_band[{m},fuse=2]",
                          tuple(dk3.launch_key(k, m) for k in dk3.KERNELS))
        out[m] = run
    return out


def check_d3q_poiseuille() -> dict:
    """Phase 22: tests/test_models.py's 3D Poiseuille (14x3x4, walls on the
    first axis, BGK nodes, nu 0.1, GravitationX 1e-5, 2000 steps) for
    d3q19 and d3q27_BGK on the kernels in f32, its mean ux profile against
    the f32 eager engine on the card at rtol 2e-5 / atol 2e-6, within 3%
    of the analytic profile (tests/test_models.py's limit), and against
    the f64 eager engine within a relative L2 error of
    POISEUILLE_F64_REL_L2 or, where f32 itself is farther, within twice
    the f32 eager engine's own distance: d3q27_BGK's f32 profile is
    1.27e-3 (the CPU) to 1.35e-3 (the card) from f64 on the eager engine
    and 1.55e-3 on the kernels, because its body force is the difference
    of two ~0.07 equilibria ~1e-6 apart, which f32 resolves to about a
    percent a step; which f32 engine lands nearer f64 is chance."""
    from tclb_tpu_torch import Lattice, get_model
    say("phase 22: the 3D Poiseuille profile on the kernels")
    shape, g, nu, steps = (14, 3, 4), 1e-5, 0.1, 2000
    out = {}
    h = shape[0] - 2
    y = torch.arange(1, shape[0] - 1, dtype=torch.float64)
    ana = g / (2 * nu) * (y - 0.5) * (h + 0.5 - y)
    for name in ("d3q19", "d3q27_BGK"):
        m = get_model(name)
        flags = np.full(shape, m.flag_for("BGK"), dtype=np.uint16)
        flags[0] = flags[-1] = m.flag_for("Wall")
        prof = {}
        for tag, dtype, fast in (("kernels", torch.float32, "1"),
                                 ("eager32", torch.float32, "0"),
                                 ("eager64", torch.float64, "0")):
            before = os.environ.get("TCLB_FASTPATH")
            os.environ["TCLB_FASTPATH"] = fast
            try:
                lat = Lattice(m, shape, dtype=dtype, device=DEVICE,
                              settings={"nu": nu, "GravitationX": g})
                lat.set_flags(flags)
                lat.init()
                lat.iterate(steps)
                lat.synchronize()
            finally:
                if before is None:
                    del os.environ["TCLB_FASTPATH"]
                else:
                    os.environ["TCLB_FASTPATH"] = before
            want_engine = (f"cuda_d3q27_band[{name},fuse=2]"
                           if tag == "kernels" else "eager")
            if lat.engine_name != want_engine:
                fail(f"{name} Poiseuille {tag} ran on {lat.engine_name}")
            prof[tag] = lat.get_quantity("U")[0].double().reshape(
                shape[0], -1).mean(dim=1)[1:-1].cpu()
        e = compare(prof["kernels"], prof["eager32"],
                    f"{name} Poiseuille ux profile, f32 kernels vs f32 eager")
        rel = float((prof["kernels"] - prof["eager64"]).norm()
                    / prof["eager64"].norm())
        rel32 = float((prof["eager32"] - prof["eager64"]).norm()
                      / prof["eager64"].norm())
        ana_err = float(((prof["kernels"] - ana).abs() / ana).max())
        say(f"  {name}: f32 kernels vs f64 eager relative L2 {rel:.3e} "
            f"(f32 eager {rel32:.3e}; limit {POISEUILLE_F64_REL_L2} or twice "
            f"the f32 eager one), vs "
            f"the analytic profile max rel {ana_err:.3e} (limit 0.03)")
        limit = max(POISEUILLE_F64_REL_L2, 2 * rel32)
        if not (rel <= limit and ana_err <= 0.03):
            fail(f"{name} Poiseuille: the f32 kernel profile is off")
        out[name] = {"vs_f32_eager": e, "f32_kernels_vs_f64_rel_l2": rel,
                     "f32_eager_vs_f64_rel_l2": rel32,
                     "vs_analytic_max_rel": ana_err,
                     "ux_max": float(prof["eager64"].max())}
    return out


# --------------------------------------------------------------------------- #
# <Control> time series and <Sample> (phases 23-25)
# --------------------------------------------------------------------------- #


def series_lattice(lat, T: int = 16):
    """``lat`` with a <Control> inlet series on zone 0's Velocity (a
    ramp over ``T`` iterations, so a long run wraps)."""
    lat.set_setting_series("Velocity", np.linspace(0.008, 0.012, T), zone=0)
    return lat


def rich_series_lattice(model: str, device):
    """A rich state that paints every node type ``model`` reads, with
    series on two zones and a horizon of 5 (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import (ADJ3D_SETTINGS, ADJ3D_SHAPE, RICH_SETTINGS,
                             add_rich_series, paint_rich, paint_rich_adj3d)
    shape, settings, paint = {
        "d2q9": ((32, 64), RICH_SETTINGS, paint_rich),
        "d3q19_adj": (ADJ3D_SHAPE, ADJ3D_SETTINGS, paint_rich_adj3d)}[model]
    lat = Lattice(get_model(model), shape, dtype=torch.float32,
                  device=device, settings=settings)
    return add_rich_series(paint(lat, seed=5))


def adj3d_control_file(directory) -> pathlib.Path:
    """The 3D Control channel (tests/torch_cases.py:adj3d_control_xml at
    32x64x256, Solve 2000, Log every 500) and its inlet ramp CSV, written
    into ``directory``."""
    from torch_cases import adj3d_control_xml, ramp_csv
    csv = ramp_csv(pathlib.Path(directory) / "ramp.csv")
    path = pathlib.Path(directory) / "adj3d_control.xml"
    path.write_text(adj3d_control_xml(str(csv), "chip"))
    return path


def compare_globals(g, wg, what: str) -> dict:
    """A kernel's SUM globals against its plain version's at rtol 1e-4 /
    atol 1e-6."""
    gerr = (g - wg).abs()
    ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
        and bool(torch.isfinite(g).all())
    say(f"  globals {what}: {g.tolist()} vs {wg.tolist()} (rtol "
        f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"globals {what} disagree with the plain version's")
    return globals_err(gerr, wg)


def check_series_flavours(mod, lats, errs: dict, what: str) -> dict:
    """Both <Control> series flavours of ``mod``'s step kernel
    (``generic2d_step_series``, ``generic3d_step_series``) against their
    plain versions on lattices with a series, at an iteration inside, at
    the end of and past the horizon: fields at rtol 2e-5 / atol 2e-6, the
    series + globals flavour's globals at rtol 1e-4 / atol 1e-6."""
    from tclb_tpu_torch.ops import generic_kernels as gk
    say(f"{what}: the series flavours against their plain versions")
    for lat in lats:
        f, flags, ztab, a = mod.kernel_inputs(lat.model, lat.state,
                                              lat.params)
        series = gk.series_inputs(lat.model, lat.params)
        T = series.horizon
        key, keyg = (f"{k}[{lat.model.name}]" for k in mod.SERIES_KERNELS)
        for it in (0, T - 1, 3 * T + 2):
            got = mod.step_series(f, flags, ztab, a, series, it)
            gotg, g = mod.step_series_globals(f, flags, ztab, a, series, it)
            want, wg = mod.plain_steps(f, flags, ztab, a, 1,
                                       with_globals=True, series=series,
                                       it=it)
            torch.cuda.synchronize()
            at = f"{tuple(f.shape)}, it {it} of T {T}"
            keep_worst(errs, key, compare(got, want, f"{key} at {at}"))
            keep_worst(errs, keyg, compare(gotg, want, f"{keyg} at {at}"))
            keep_worst(errs, f"{keyg} globals",
                       compare_globals(g, wg, f"of {keyg} at {at}"))
    return errs


def _read_log(path) -> tuple:
    lines = pathlib.Path(path).read_text().strip().splitlines()
    return (lines[0].split(","),
            np.array([[float(v) for v in r.split(",")] for r in lines[1:]]))


def run_series_xml(xml, fast: bool, probe=None, csvs=("Log",),
                   dtype=torch.float32) -> dict:
    """``xml`` through ``run_config`` at ``dtype`` (f32) from a case
    directory, on the kernel engines (``fast``, launches counted from 0)
    or the eager engine (``TCLB_FASTPATH=0``); ``probe(solver)`` is
    recorded at each Log, and the case's ``<stem>_<name>.csv`` read for
    each of ``csvs``."""
    from tclb_tpu_torch.control.solver import Solver, run_config
    from tclb_tpu_torch.models import get_model
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    from tclb_tpu_torch.ops import generic_kernels as gk
    root = ET.parse(xml).getroot()
    probes = []
    write_log = Solver.write_log

    def recording(self):
        if probe is not None:
            probes.append((self.iter, probe(self)))
        write_log(self)

    cwd, fastpath = os.getcwd(), os.environ.get("TCLB_FASTPATH")
    with case_dir() as tmp:
        os.chdir(tmp)
        if not fast:
            os.environ["TCLB_FASTPATH"] = "0"
        Solver.write_log = recording
        try:
            torch.cuda.synchronize()
            for mod in (gk, g3):
                mod.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), get_model(root.get("model")),
                                dtype=dtype, device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**gk.LAUNCHES, **gk.SERIES_LAUNCHES, **g3.LAUNCHES,
                        **g3.SERIES_LAUNCHES}
            read = {name: _read_log(os.path.join(
                tmp, root.get("output"), f"{xml.stem}_{name}.csv"))
                for name in csvs}
        finally:
            Solver.write_log = write_log
            os.chdir(cwd)
            if fastpath is None:
                os.environ.pop("TCLB_FASTPATH", None)
            else:
                os.environ["TCLB_FASTPATH"] = fastpath
    return {"solver": solver, "wall_s": wall, "launches": launches,
            "probes": probes, **read}


def run_series_case(mod, xml, phase: str, engine: str, probe,
                    window: int) -> dict:
    """A case under a <Control> series end to end on the card (paths A
    and B): on ``engine`` with no eager step, the series flavour on every
    step but the last of each iterate call (one per Log stop), which is
    the series + globals flavour, and no plain launch; every Log column
    and the final fields against the same XML on the eager f32 engine at
    rtol 1e-4 / atol 1e-6; ``probe(solver)`` (the inlet's mean ux) at each
    Log in a fixed proportion to the series' entry of the iteration before
    it and changing between Logs as the series does.  Then the MLUPS of
    the whole case and of an ``iterate(window)`` window."""
    say(f"phase {phase}: {xml.name} end to end under its <Control> series")
    root = ET.parse(xml).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    stops = niter // int(root.find("Log").get("Iterations"))
    run = run_series_xml(xml, True, probe)
    solver = run["solver"]
    lat = solver.lattice
    launches = {k: v for k, v in run["launches"].items() if v}
    say(f"  engine {lat.engine_name}, {solver.iter} iterations, "
        f"{run['wall_s']:.3f} s wall, launches {launches}, eager steps "
        f"{lat.eager_steps}")
    one, last = mod.SERIES_KERNELS
    if lat.engine_name != engine or lat.eager_steps:
        fail(f"{xml.name} ran on {lat.engine_name} with {lat.eager_steps} "
             "eager steps")
    if launches != {one: niter - stops, last: stops}:
        fail(f"{xml.name}: launches {launches}, not {niter - stops} of "
             f"{one} and {stops} of {last}")
    eager = run_series_xml(xml, False)
    if eager["solver"].lattice.engine_name != "eager":
        fail(f"{xml.name}'s eager run ran on "
             f"{eager['solver'].lattice.engine_name}")
    (head, rows), (ehead, erows) = run["Log"], eager["Log"]
    if head != ehead or rows.shape != erows.shape or len(rows) != stops:
        fail(f"{xml.name}: Log {rows.shape} {head} vs eager {erows.shape}")
    keep = [i for i, h in enumerate(head) if "Walltime" not in h]
    got, want = rows[:, keep], erows[:, keep]
    if not (np.isfinite(got).all() and np.allclose(
            got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)):
        fail(f"{xml.name}: Log columns differ from the eager run's")
    log_err = float(np.abs(got - want).max())
    field = compare(lat.state.fields, eager["solver"].lattice.state.fields,
                    f"{xml.name}'s fields against the eager run's",
                    GOLDEN_RTOL, GOLDEN_ATOL)
    ts = lat.params.time_series[0].double().cpu().numpy()
    its = np.array([it for it, _ in run["probes"]])
    seen = np.array([v for _, v in run["probes"]])
    expect = ts[(its - 1) % len(ts)]
    ratio = seen / expect
    say(f"  inlet mean ux at the Logs {seen.tolist()} against the series "
        f"{expect.tolist()} (ratio {ratio.tolist()}); Log columns within "
        f"{log_err:.3e} of the eager run's")
    if not (np.allclose(ratio, ratio[0], rtol=1e-4)
            and (np.sign(np.diff(seen)) == np.sign(np.diff(expect))).all()
            and (np.diff(expect) != 0).all()):
        fail(f"{xml.name}: the inlet does not follow the series")
    nodes = float(np.prod(lat.shape))
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(window)
    host = time.perf_counter() - t0
    lat.synchronize()
    dt = time.perf_counter() - t0
    out = {"launches": run["launches"], "wall_s": run["wall_s"],
           "eager_steps": lat.eager_steps, "engine": lat.engine_name,
           "mlups_end_to_end": nodes * niter / run["wall_s"] / 1e6,
           "mlups_iterate": nodes * window / dt / 1e6,
           "iterate_ms": dt * 1e3, "iterate_host_ms": host * 1e3,
           "window": window, "eager_wall_s": eager["wall_s"],
           "log_max_abs_err_vs_eager": log_err,
           "fields_vs_eager": field, "inlet_ux": seen.tolist(),
           "inlet_series": expect.tolist(), "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end, "
        f"{out['mlups_iterate']:.1f} in an iterate({window}) window "
        f"({dt * 1e3:.2f} ms, of which {host * 1e3:.2f} ms until iterate "
        f"returned); the eager f32 run took {eager['wall_s']:.2f} s")
    return out


def inlet_ux_2d(solver) -> float:
    """karman_control's inlet: the mean ux of the W velocity column."""
    return float(solver.lattice.get_quantity("U")[0, 1:-1, 0].double()
                 .mean())


def inlet_ux_3d(solver) -> float:
    return float(solver.lattice.get_quantity("U")[0, 1:-1, 1:-1, 0]
                 .double().mean())


SAMPLE_POINTS = ((5, 48), (100, 30), (300, 70))    # (dx, dy)


def run_sample(gk) -> dict:
    """Path C (phase 25): karman_control.xml cut to 500 iterations (Log
    every 250) with a <Sample what="U,Rho"> of three points every 100
    iterations, through ``run_config``: every step on the eager engine by
    selection (no kernel launched, 500 eager steps); its CSV (one row per
    iteration) against the same case stepped one iteration at a time on
    the kernel engine, U and Rho read at the points after each step, at
    rtol 1e-4 / atol 1e-6 (the CSV keeps six significant digits)."""
    say("phase 25: <Sample> on karman_control.xml's lattice")
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    niter = 500
    root = ET.parse(KARMAN_CONTROL_XML).getroot()
    root.find("Solve").set("Iterations", str(niter))
    root.find("Log").set("Iterations", str(niter // 2))
    sample = ET.Element("Sample", {"what": "U,Rho", "Iterations": "100"})
    for dx, dy in SAMPLE_POINTS:
        ET.SubElement(sample, "Point", {"dx": str(dx), "dy": str(dy)})
    root.insert(list(root).index(root.find("Solve")), sample)
    with tempfile.TemporaryDirectory() as tmp:
        xml = pathlib.Path(tmp) / "karman_sampled.xml"
        ET.ElementTree(root).write(xml)
        run = run_series_xml(xml, True, csvs=("Sample",))
    head, rows = run["Sample"]
    lat = run["solver"].lattice
    launched = {k: v for k, v in run["launches"].items() if v}
    say(f"  {len(rows)} sample rows, columns {head}; eager steps "
        f"{lat.eager_steps}, kernel launches {launched}")
    want_head = ["Iteration"] + [
        c for i in range(len(SAMPLE_POINTS))
        for c in (f"U_{i}_x", f"U_{i}_y", f"U_{i}_z", f"Rho_{i}")]
    if head != want_head or rows.shape != (niter, len(want_head)):
        fail(f"<Sample>: CSV {rows.shape} {head}")
    if launched or lat.eager_steps != niter or lat.sampler is not None:
        fail(f"<Sample>: launches {launched}, eager steps "
             f"{lat.eager_steps}")
    ref = case_lattice(KARMAN_CONTROL_XML, torch.float32, DEVICE)
    ys = [dy for _, dy in SAMPLE_POINTS]
    xs = [dx for dx, _ in SAMPLE_POINTS]
    gk.reset_launches()
    got = []
    for _ in range(niter):
        ref.iterate(1)
        u, rho = ref.get_quantity("U"), ref.get_quantity("Rho")
        # the CSV's order: per point U's three components, then Rho
        got.append(torch.cat([torch.cat([u[:, y, x], rho[y, x][None]])
                              for y, x in zip(ys, xs)]))
    kern = torch.stack(got).double().cpu().numpy()
    if ref.engine_name != "cuda_generic_band[d2q9,fuse=1]" \
            or gk.SERIES_LAUNCHES["generic2d_step_series_globals"] != niter:
        fail(f"<Sample>'s kernel run ran on {ref.engine_name}")
    err = np.abs(rows[:, 1:] - kern)
    ok = bool((err <= GOLDEN_ATOL + GOLDEN_RTOL * np.abs(kern)).all())
    say(f"  the CSV against the kernel run's fields: max abs "
        f"{float(err.max()):.3e} (rtol {GOLDEN_RTOL} atol {GOLDEN_ATOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or not np.array_equal(rows[:, 0], np.arange(1, niter + 1)):
        fail("<Sample>: the CSV disagrees with the kernel run")
    return {"rows": len(rows), "columns": head,
            "max_abs_err_vs_kernels": float(err.max()),
            "eager_steps": lat.eager_steps, "wall_s": run["wall_s"],
            "kernel_launches_during_sampling": launched}


def time_series_flavours(mod, lat, reps: int, it: int = 7) -> dict:
    """Both series flavours at ``lat``'s shape (CUDA events), their plain
    versions, their bound (``launch_bytes`` with the series' row map and
    entries) and their wrappers' host time."""
    from tclb_tpu_torch.ops import generic_kernels as gk
    f, flags, ztab, a = mod.kernel_inputs(lat.model, lat.state, lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    n_series = int(series.ts.shape[0])
    out = {}
    for name, fn, g in ((mod.SERIES_KERNELS[0], mod.step_series, False),
                        (mod.SERIES_KERNELS[1], mod.step_series_globals,
                         True)):
        key = f"{name}[{lat.model.name}]"
        out[key] = time_one(
            key, lambda fn=fn: fn(f, flags, ztab, a, series, it),
            lambda g=g: mod.plain_steps(f, flags, ztab, a, 1,
                                        with_globals=g, series=series,
                                        it=it),
            gk.launch_bytes(lat.model, lat.shape, n_series),
            mod.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            reps)
    return out


def event_ms(fn, reps: int, warm: int = 5) -> float:
    """Device ms per call of ``fn`` between two CUDA events.  A spin kernel
    queued first keeps the card busy while the host enqueues the window,
    so the launches run back to back and host launch cost is not timed."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(min(reps, 1000) * 50_000)   # ~25 us of cycles a call
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_one(name: str, launch, plain, nbytes: int, flops: int, shape,
             reps: int, plain_reps: int = 10, plain_warm=None) -> dict:
    """One kernel's time (CUDA events), its plain version's (after
    ``plain_warm`` calls, by default as many as its repeats up to 2), its
    bound on this card from ``nbytes`` and ``flops``, and its wrapper's
    host time."""
    ms = event_ms(launch, reps)
    plain_ms = event_ms(plain, plain_reps, warm=min(2, plain_reps)
                        if plain_warm is None else plain_warm)
    host_ms = wrapper_host_ms(launch)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops, "wrapper_host_ms": host_ms,
           "shape": list(shape)}
    say(f"  {name} at {tuple(shape)}: {ms:.4f} ms/launch, plain "
        f"{plain_ms:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}: {nbytes} B, {flops} flop), "
        f"wrapper {host_ms:.4f} ms of host time a call")
    return out


def time_kernels(cases) -> dict:
    """``cases`` lists (kernel module, kernel name, lattice, repeats)."""
    say("phase 7: times (CUDA events) and bounds")
    out = {}
    for dk, name, lat, reps in cases:
        fn, steps = dk.WRAPPERS[name]
        *inputs, a = dk.kernel_inputs(lat.model, lat.state, lat.params)
        key = kernel_key(dk, name, lat)
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: dk.plain_steps(*inputs, a, steps),
            dk.launch_bytes(lat.model, lat.shape),
            steps * dk.node_step_flops(lat.model, lat.flags_numpy()),
            lat.shape, reps)
    return out


def time_generic(gk, band_lat, res_lat, resident_steps: int,
                 plain_reps: int = 2) -> dict:
    """One model's generic kernels at their paths' launches (K5 at no more
    than ``K5_TIMING_STEPS`` steps):
    ``generic2d_step`` in both flavours on ``band_lat`` (the band engine's
    path), ``generic2d_resident`` on ``res_lat`` at the step count its
    path gives one launch."""
    out = {}
    model = band_lat.model.name
    for name, lat, reps in (("generic2d_step", band_lat, 400),
                            ("generic2d_step globals", band_lat, 200)):
        *inputs, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
        g = name.endswith("globals")
        fn = gk.step_globals if g else gk.step
        key = name.replace("generic2d_step", f"generic2d_step[{model}]")
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: gk.plain_steps(*inputs, a, 1, with_globals=g),
            gk.launch_bytes(lat.model, lat.shape),
            gk.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            reps)
    *inputs, a = gk.kernel_inputs(res_lat.model, res_lat.state,
                                  res_lat.params)
    resident_steps = min(resident_steps, K5_TIMING_STEPS)
    key = f"generic2d_resident[{model}]"
    out[key] = time_one(
        f"{key} ({resident_steps} steps)",
        lambda: gk.resident(*inputs, a, resident_steps),
        lambda: gk.plain_steps(*inputs, a, resident_steps),
        gk.launch_bytes(res_lat.model, res_lat.shape),
        resident_steps * gk.node_step_flops(res_lat.model,
                                            res_lat.flags_numpy()),
        res_lat.shape, 50, plain_reps=plain_reps)
    out[key]["steps"] = resident_steps
    return out


def time_step_b(ak, gk, lat, plain_reps: int = 10) -> dict:
    """The backward kernel at a gradient's launch (``generic2d_step_b`` at
    512x1024, ``generic3d_step_b`` at 32x64x256), against ``step_b_plain``
    on the same inputs."""
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    lam = torch.randn(f.shape, generator=gen, device=DEVICE)
    lam_g = torch.randn((lat.model.n_globals,), generator=gen, device=DEVICE)
    key = f"generic{lat.model.ndim}d_step_b[{lat.model.name}]"
    return {key: time_one(
        key, lambda: ak.step_b(f, flags, ztab, a, lam, lam_g),
        lambda: ak.step_b_plain(f, flags, ztab, a, lam, lam_g),
        ak.launch_bytes_b(lat.model, lat.shape),
        ak.node_step_b_flops(lat.model, lat.flags_numpy()), lat.shape, 200,
        plain_reps=plain_reps)}


def wrapper_host_ms(launch, calls: int = 200) -> float:
    """Host ms one call of a kernel's wrapper takes to enqueue its launch
    (checks, output allocation, the ctypes call), timed with a host clock
    and no synchronize inside the window."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        launch()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def device_events(prof) -> list:
    """The device activity of a torch.profiler trace: (name, start us,
    duration us) of each kernel, copy and fill."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def device_busy(run, what: str) -> dict:
    """Where a window's time goes on the card: a torch.profiler trace of
    ``run()`` (an iterate or a gradient, run once before to warm), the
    union of the kernels' intervals against the host window, and device
    time by kernel name.  Where the trace shows no device activity the
    share is not measured."""
    from torch.profiler import ProfilerActivity, profile
    say(f"phase 8: device busy share over {what}")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for name, ts, dur in device_events(prof):
        spans.append((ts, ts + dur))
        by_name[name] = by_name.get(name, 0.0) + dur
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    out = {"window": what, "wall_us": wall_us,
           "device_busy_us": busy if spans else None,
           "idle_share": 1.0 - busy / wall_us if spans else None,
           "device_us_by_kernel": dict(sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8])}
    share = ("not measured (no device events in the trace)"
             if out["idle_share"] is None
             else f"{out['idle_share']:.3f}")
    say(f"  {what} under the profiler: {wall_us:.0f} us wall, "
        f"device busy {busy:.0f} us, idle share {share}")
    for k, v in out["device_us_by_kernel"].items():
        say(f"    {v:10.1f} us  {k[:90]}")
    return out


def window_split(lat, niter: int, what: str, kernel: str, count,
                 launch) -> dict:
    """Phase 8's split of an ``iterate(niter)`` window on a resident
    engine: a torch.profiler trace of the window (``device_busy``) gives
    the resident kernel's device time a launch (``kernel``: a part of its
    name in the trace; ``count()`` its launch count) and the idle share;
    ``launch()`` (one call of its wrapper) its host time a launch
    (``wrapper_host_ms``); the eager globals step that ``Lattice.iterate``
    runs after the engine is timed alone (host clock, synchronized; the
    median of 5), where the engine leaves one."""
    n0, e0 = count(), lat.eager_steps
    busy = device_busy(lambda: lat.iterate(niter), what)
    launches = (count() - n0) // 2            # the warm run and the trace
    eager = (lat.eager_steps - e0) // 2
    dev_us = sum(us for name, us in busy["device_us_by_kernel"].items()
                 if kernel in name)
    eager_ms = None
    if eager:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat.state = lat._iterate(lat.state, lat.params, eager)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        eager_ms = sorted(times)[2]
    out = {"window": what, "launches": launches,
           "kernel_us_per_launch": dev_us / launches if launches else None,
           "kernel_us_per_call": dev_us,
           "wrapper_host_ms_per_launch": wrapper_host_ms(launch, 50),
           "eager_steps_per_call": eager, "eager_step_ms": eager_ms,
           "wall_us": busy["wall_us"],
           "device_busy_us": busy["device_busy_us"],
           "idle_share": busy["idle_share"]}
    say(f"  split of {what}: {kernel} {launches} launches, "
        f"{out['kernel_us_per_launch']} us of device time each "
        f"({dev_us:.1f} us a call), wrapper "
        f"{out['wrapper_host_ms_per_launch']:.4f} ms of host time a launch, "
        f"eager globals step {eager_ms} ms ({eager} a call), idle share "
        f"{busy['idle_share']}")
    return out


# --------------------------------------------------------------------------- #
# The storage ladder: the bf16 flavours of K4, K5 and K3 (phases 26-30)
# --------------------------------------------------------------------------- #

BF16 = torch.bfloat16
HARNESS_N, HARNESS_NITER = 64, 500     # tests/test_precision.py's size
FLAGSHIP_N, FLAGSHIP_WINDOW = 1024, 2000
# the bf16 flagship windows on the previous pass-form kernel, whose pulls
# wrapped by integer modulo (MLUPS, PERF.md section 6: generic2d_parity's
# flagship_windows, that library beside this one's in one call on NVIDIA
# H100 80GB HBM3, 700.00 W), printed beside this run's
FLAGSHIP_BEFORE_MLUPS = {"bf16_shifted": 30928.6, "bf16_raw": 32318.7}


def bf16_key(mod, name: str, model: str) -> str:
    """A bf16 kernel's name in the record: ``generic2d_step_bf16[d2q9]``,
    ``d3q27_step2_bf16[d3q19]`` (the cumulant's ``d3q27_step2_bf16``)."""
    if hasattr(mod, "launch_key"):
        return mod.launch_key(f"{name}_bf16", model)
    return f"{name}_bf16[{model}]"


def bf16_copy(lat, storage_repr: str = "shifted"):
    """The same case on a bf16 lattice on the card: flags, params and the
    fields narrowed into ``storage_repr``."""
    import dataclasses
    from tclb_tpu_torch import Lattice
    from tclb_tpu_torch.core import shift as ddf
    b = Lattice(lat.model, lat.shape, dtype=torch.float32, device=DEVICE,
                storage_dtype=BF16, storage_repr=storage_repr)
    b.set_flags(lat.flags_numpy())
    b.params = dataclasses.replace(lat.params)
    b.state = dataclasses.replace(
        lat.state, fields=ddf.narrow_stack(lat.state.fields, BF16,
                                           b._shift_block),
        globals_=lat.state.globals_.clone())
    b.avg_start = lat.avg_start
    return b


def bf16_inputs(mod, lat) -> tuple:
    """``mod.kernel_inputs`` of a bf16 lattice, with its shifts."""
    from tclb_tpu_torch.core import shift as ddf
    return mod.kernel_inputs(lat.model, lat.state, lat.params,
                             ddf.kernel_shift(lat.model, lat.storage_repr))


def wide_plain(mod, lat, n: int, with_globals: bool = False, fields=None):
    """The plain version's f32 values before its one narrowing: ``n``
    plain f32 steps on the widened stack (a bf16 kernel's cadence), from
    ``lat``'s stack or from ``fields``, a bf16 stack of ``lat``'s shape."""
    import dataclasses
    from tclb_tpu_torch.core import shift as ddf
    f, flags, ztab, a = bf16_inputs(mod, lat)
    wide = ddf.widen_stack(f if fields is None else fields, torch.float32,
                           lat._shift_block)
    a32 = dataclasses.replace(a, shift=None)
    if with_globals:
        return mod.plain_steps(wide, flags, ztab, a32, n, with_globals=True)
    return mod.plain_steps(wide, flags, ztab, a32, n)


def compare_narrowed(got, wide, lat, what: str, quiet: bool = False
                     ) -> dict:
    """A bf16 kernel's output against its plain version's compute values
    before their one narrowing: the f32 tolerance (rtol 2e-5 / atol 2e-6
    on the raw values) carried through the narrowing
    (``core/shift.py:narrowed_bounds``).  Where the kernel's f32 values
    equal the plain version's the stored bits are equal; where they sit
    an ulp apart a value that straddles a bf16 rounding boundary may take
    the other neighbour.  The error printed is that of the widened raw
    fields against the narrowed plain output; ``flips`` counts the values
    whose bits differ.  ``quiet``: print only a failure."""
    from tclb_tpu_torch.core import shift as ddf
    sb = lat._shift_block
    lo, hi = ddf.narrowed_bounds(wide, BF16, sb, RTOL, ATOL)
    s = got.double()
    ok = bool(((s >= lo.double()) & (s <= hi.double())).all())
    want = ddf.narrow_stack(wide, BF16, sb)
    g_raw = ddf.widen_stack(got, torch.float32, sb)
    w_raw = ddf.widen_stack(want, torch.float32, sb)
    err = (g_raw - w_raw).abs()
    flips = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    out = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / w_raw.abs().clamp_min(1e-30)).max()),
           "flips": flips, "values": int(got.numel())}
    finite = bool(torch.isfinite(g_raw).all())
    if quiet and ok and finite:
        return out
    say(f"  {what}: max_abs {out['max_abs_err']:.3e} max_rel "
        f"{out['max_rel_err']:.3e}, {flips} of {got.numel()} values a bf16 "
        f"step from the narrowed plain output, all within the f32 tolerance "
        f"(rtol {RTOL} atol {ATOL}) carried through the narrowing: "
        f"{'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        fail(f"{what} disagrees with its plain version")
    return out


def check_bf16_kernels(cases, errs: dict, what: str) -> dict:
    """Phase 26: each one-narrowing bf16 kernel against its plain version
    on the same bf16 inputs.  ``cases`` lists (module, bf16 lattice,
    kernel name); ``generic2d_step`` is checked in both flavours (the
    globals at rtol 1e-4 / atol 1e-6)."""
    say(f"{what}: bf16 kernels against their plain versions on the card")
    for mod, lat, name in cases:
        fn, n = mod.WRAPPERS[name]
        *inputs, a = bf16_inputs(mod, lat)
        key = bf16_key(mod, name, lat.model.name)
        tag = f"{key} ({lat.storage_repr}) at {tuple(inputs[0].shape)}"
        got = fn(*inputs, a)
        torch.cuda.synchronize()
        keep_worst(errs, key, compare_narrowed(
            got, wide_plain(mod, lat, n), lat, tag))
        if name == "generic2d_step":
            got, g = mod.step_globals(*inputs, a)
            wide, wg = wide_plain(mod, lat, 1, with_globals=True)
            torch.cuda.synchronize()
            keep_worst(errs, key, compare_narrowed(
                got, wide, lat, f"{tag}, globals flavour"))
            gerr = (g - wg).abs()
            ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
                and bool(torch.isfinite(g).all())
            say(f"  its globals: {g.tolist()} vs {wg.tolist()} (rtol "
                f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{tag}: globals disagree")
            keep_worst(errs, f"{key} globals", globals_err(gerr, wg))
    return errs


def check_bf16_resident(gk, lat, nsteps: int, errs: dict, what: str) -> dict:
    """Phase 26, K5: ``generic2d_resident_bf16`` narrows once a step, and
    its step is ``generic2d_step_bf16``'s device code.  Each of ``nsteps``
    chained ``generic2d_step_bf16`` launches is held against its plain
    version from the same input (the f32 tolerance carried through the
    narrowing, ``compare_narrowed``), and the resident launch equals that
    chain bit for bit: so each of its steps is held too.  Against
    ``nsteps`` narrowed eager steps from the start: at the f32 tolerance
    on the widened raw fields where the model's f32 kernels equal their
    plain versions bit for bit (d2q9_kuper); for d2q9, whose header sums
    rho in plane order, a value one bf16 step off moves the next steps'
    inputs, so that error is reported, not held."""
    from tclb_tpu_torch.core import shift as ddf
    f, flags, ztab, a = bf16_inputs(gk, lat)
    key = bf16_key(gk, "generic2d_resident", lat.model.name)
    tag = f"{key} ({lat.storage_repr}, {nsteps} steps) at {tuple(f.shape)}"
    got = gk.resident(f, flags, ztab, a, nsteps)
    chain = f
    e = {"max_abs_err": 0.0, "max_rel_err": 0.0, "flips": 0}
    for i in range(nsteps):
        nxt = gk.step(chain, flags, ztab, a)
        one = compare_narrowed(
            nxt, wide_plain(gk, lat, 1, fields=chain), lat,
            f"{tag}: generic2d_step_bf16 launch {i + 1} of the chain",
            quiet=True)
        e = {k: max(e[k], one[k]) for k in e}
        chain = nxt
    torch.cuda.synchronize()
    say(f"{what}: {tag}: each of {nsteps} chained generic2d_step_bf16 "
        f"launches against its plain version from the same input: max_abs "
        f"{e['max_abs_err']:.3e} max_rel {e['max_rel_err']:.3e}, at most "
        f"{e['flips']} values a bf16 step off, all within the f32 "
        f"tolerance carried through the narrowing: ok")
    same = torch.equal(got.view(torch.int16), chain.view(torch.int16))
    say(f"  {tag} against the {nsteps} chained launches: "
        f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        fail(f"{tag} differs from {nsteps} generic2d_step_bf16 launches")
    want = gk.plain_steps(f, flags, ztab, a, nsteps)
    sb = lat._shift_block
    g_raw = ddf.widen_stack(got, torch.float32, sb)
    w_raw = ddf.widen_stack(want, torch.float32, sb)
    err = (g_raw - w_raw).abs()
    eager = {"max_abs_err": float(err.max()),
             "flips": int((got.view(torch.int16)
                           != want.view(torch.int16)).sum())}
    if lat.model.name == "d2q9":
        say(f"  {tag} against {nsteps} narrowed eager steps from the start: "
            f"max_abs {eager['max_abs_err']:.3e}, {eager['flips']} values "
            "differ (reported)")
    else:
        compare(g_raw, w_raw, f"{tag} against {nsteps} narrowed eager "
                "steps from the start (widened raw fields)")
    e["chain_bit_identical"] = same
    e["eager_max_abs_err"] = eager["max_abs_err"]
    keep_worst(errs, key, e)
    return errs


def harness_phase(gk) -> dict:
    """Phase 27: the precision harness (``tclb_tpu_torch.precision``) on
    the card: both cases, both representations, 64x64, 500 steps, each
    run on the engines ``Lattice`` selects (the bf16 runs on
    ``cuda_generic_resident[...,bfloat16/<repr>]``), within
    ``ERROR_BOUNDS``; the shifted cavity's u_linf at least 10x below raw's
    at every checkpoint.  Counted from 0."""
    from tclb_tpu_torch import precision
    say(f"phase 27: the precision harness on the kernels ({HARNESS_N}x"
        f"{HARNESS_N}, {HARNESS_NITER} steps)")
    t0 = time.perf_counter()
    reports, launches = [], {}
    for case in precision.CASE_NAMES:
        gk.reset_launches()
        reports += precision.compare_reprs(case, niter=HARNESS_NITER,
                                           n=HARNESS_N, device=DEVICE)
        launches[case] = {
            **{k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS},
            "globals": gk.flavours("generic2d_step_bf16")["globals"]}
    wall = time.perf_counter() - t0
    precision._print_text(reports)
    models = {"cavity": "d2q9", "kuper_drop": "d2q9_kuper"}
    for rep in reports:
        want = (f"cuda_generic_resident[{models[rep['case']]},fuse=N,"
                f"bfloat16/{rep['storage_repr']}]")
        if rep["engine"] != want:
            fail(f"harness {rep['case']} ran on {rep['engine']}")
        v = precision.check_bounds(rep)
        if v or not all(r["l2"] > 0 for r in rep["checkpoints"]):
            fail(f"harness: {v or 'no error measured'}")
    cav = {r["storage_repr"]: r for r in reports if r["case"] == "cavity"}
    ratios = [rr["u_linf"] / rs["u_linf"] for rr, rs in zip(
        cav["raw"]["checkpoints"], cav["shifted"]["checkpoints"])]
    say(f"  within ERROR_BOUNDS; cavity u_linf raw / shifted "
        f"{[round(r, 2) for r in ratios]} (at least 10); bf16 launches "
        f"{launches}; {wall:.2f} s")
    if min(ratios) < 10:
        fail(f"shifted cavity u_linf only {min(ratios):.2f}x below raw")
    return {"reports": reports, "u_linf_raw_over_shifted": ratios,
            "launches": launches, "wall_s": wall}


def flagship_lattice(storage_dtype=None, storage_repr=None):
    """bench.py's ``bench_precision_ladder`` case (bench.py:818-870): d2q9
    at 1024x1024, MRT everywhere, walls top and bottom, nu 0.02, Velocity
    0.01."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    n = FLAGSHIP_N
    lat = Lattice(m, (n, n), dtype=torch.float32, device=DEVICE,
                  settings={"nu": 0.02, "Velocity": 0.01},
                  storage_dtype=storage_dtype, storage_repr=storage_repr)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def flagship_phase(gk) -> dict:
    """Phase 28: the flagship through the port: f32 (K1/K2 by selection),
    f32 on the generic engine (the same engine as bf16), bf16 shifted and
    bf16 raw (K4): each engine's tag and MLUPS over an
    ``iterate(FLAGSHIP_WINDOW)`` fenced by synchronize, and the ratios.
    No floor is asserted."""
    say(f"phase 28: bench.py's bf16 flagship, d2q9 {FLAGSHIP_N}x"
        f"{FLAGSHIP_N}, iterate({FLAGSHIP_WINDOW}) windows")
    runs = {}
    for label, sdt, repr_, generic in (
            ("f32", None, None, False), ("f32_generic", None, None, True),
            ("bf16_shifted", BF16, "shifted", False),
            ("bf16_raw", BF16, "raw", False)):
        lat = flagship_lattice(sdt, repr_)
        if generic:
            lat._fast, lat._fast_name = gk.select_engine(
                lat.model, lat.shape, lat.dtype)
            lat._fast_tried = True
        lat.iterate(10)
        lat.synchronize()
        gk.reset_launches()
        t0 = time.perf_counter()
        lat.iterate(FLAGSHIP_WINDOW)
        lat.synchronize()
        dt = time.perf_counter() - t0
        mlups = FLAGSHIP_N * FLAGSHIP_N * FLAGSHIP_WINDOW / dt / 1e6
        if not bool(torch.isfinite(lat.state.fields.float()).all()):
            fail(f"flagship {label}: non-finite fields")
        runs[label] = {"engine": lat.engine_name, "mlups_iterate": mlups,
                       "iterate_ms": dt * 1e3,
                       "bf16_launches": {
                           **{k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS},
                           "globals": gk.flavours(
                               "generic2d_step_bf16")["globals"]},
                       "lattice": lat}
        before = (f" (the previous kernel: "
                  f"{FLAGSHIP_BEFORE_MLUPS[label]:.1f} MLUPS, PERF.md)"
                  if label in FLAGSHIP_BEFORE_MLUPS else "")
        say(f"  {label}: engine {lat.engine_name}, {mlups:.1f} MLUPS "
            f"({dt * 1e3:.2f} ms){before}, bf16 launches "
            f"{ {k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS} }")
    want = {"f32": "cuda_d2q9_band[d2q9,fuse=2]",
            "f32_generic": "cuda_generic_band[d2q9,fuse=1]",
            "bf16_shifted": "cuda_generic_band[d2q9,fuse=1,bfloat16/shifted]",
            "bf16_raw": "cuda_generic_band[d2q9,fuse=1,bfloat16/raw]"}
    for label, engine in want.items():
        if runs[label]["engine"] != engine:
            fail(f"flagship {label} ran on {runs[label]['engine']}")
    for label in ("bf16_shifted", "bf16_raw"):
        if runs[label]["bf16_launches"]["generic2d_step_bf16"] \
                != FLAGSHIP_WINDOW:
            fail(f"flagship {label}: {runs[label]['bf16_launches']}")
    m = {k: v["mlups_iterate"] for k, v in runs.items()}
    out = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "lattice"}
                    for k, v in runs.items()},
           "bf16_over_f32": m["bf16_shifted"] / m["f32"],
           "bf16_raw_over_f32": m["bf16_raw"] / m["f32"],
           "bf16_over_f32_same_engine": m["bf16_shifted"] / m["f32_generic"],
           "bf16_raw_over_f32_same_engine": m["bf16_raw"] / m["f32_generic"],
           "lattice": runs["bf16_shifted"]["lattice"]}
    say(f"  bf16 (shifted) / f32: {out['bf16_over_f32']:.3f} across engines "
        f"(K4 over K1/K2, as the JAX package reports it), "
        f"{out['bf16_over_f32_same_engine']:.3f} on the same engine (K4); "
        f"raw {out['bf16_raw_over_f32']:.3f} / "
        f"{out['bf16_raw_over_f32_same_engine']:.3f}; card "
        f"{card_line()}")
    return out


def channel3d_bf16_phase(dk3) -> dict:
    """Phase 29: example/3d_channel.xml's lattice (48x48x256,
    d3q27_cumulant) in bf16 shifted on K3 and in f32, the Solve's 20000
    steps as its Log interval cuts them (iterate(2000) ten times), each
    fenced by synchronize: MLUPS, the launches and the relative L2 of U
    against the f32 run (reported: the JAX package pins no 3D bound)."""
    say("phase 29: 3d_channel.xml's lattice in bf16 shifted on K3")
    root = ET.parse(CHANNEL3D_XML).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    chunk = int(root.find("Log").get("Iterations"))
    base = case_lattice(CHANNEL3D_XML, torch.float32, DEVICE)
    out = {}
    for label, lat in (("f32", base), ("bf16_shifted", bf16_copy(base))):
        lat.synchronize()
        dk3.reset_launches()
        t0 = time.perf_counter()
        for _ in range(niter // chunk):
            lat.iterate(chunk)
        lat.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in dk3.LAUNCHES.items() if v}
        out[label] = {"engine": lat.engine_name, "wall_s": dt,
                      "mlups": float(np.prod(lat.shape)) * niter / dt / 1e6,
                      "launches": launches, "lattice": lat}
        say(f"  {label}: engine {lat.engine_name}, {niter} steps in "
            f"{dt:.3f} s, {out[label]['mlups']:.1f} MLUPS, launches "
            f"{launches}")
    if out["bf16_shifted"]["engine"] != \
            "cuda_d3q27_band[d3q27_cumulant,fuse=2,bfloat16/shifted]":
        fail(f"3d_channel bf16 ran on {out['bf16_shifted']['engine']}")
    u32 = out["f32"]["lattice"].get_quantity("U").double()
    u16 = out["bf16_shifted"]["lattice"].get_quantity("U").double()
    if not bool(torch.isfinite(u16).all()):
        fail("3d_channel bf16: non-finite U")
    rel = float((u16 - u32).norm() / u32.norm())
    out["u_rel_l2_vs_f32"] = rel
    out["mean_ux"] = {"f32": float(u32[0].mean()),
                      "bf16_shifted": float(u16[0].mean())}
    say(f"  U of the bf16 run against the f32 run: relative L2 {rel:.3e}; "
        f"mean ux {out['mean_ux']['bf16_shifted']:.4e} against "
        f"{out['mean_ux']['f32']:.4e} (reported, not held)")
    return out


def channel48_bf16_phase(dk3, models) -> dict:
    """Phase 29b: bench.py's 48x48x256 channel for each other z-slab
    model in bf16 shifted, ``iterate(2002)`` on
    ``cuda_d3q27_band[<model>,fuse=2,bfloat16/shifted]``: the launches and
    the MLUPS."""
    out = {}
    for m in models:
        lat = bf16_copy(channel48_lattice(m, DEVICE))
        say(f"phase 29b: the 48x48x256 {m} channel in bf16 shifted")
        lat.synchronize()
        dk3.reset_launches()
        t0 = time.perf_counter()
        lat.iterate(2002)
        lat.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in dk3.LAUNCHES.items() if "bf16" in k}
        mlups = float(np.prod(lat.shape)) * 2002 / dt / 1e6
        say(f"  engine {lat.engine_name}, launches "
            f"{ {k: v for k, v in launches.items() if v} }, {mlups:.1f} "
            "MLUPS")
        if lat.engine_name != f"cuda_d3q27_band[{m},fuse=2,bfloat16/shifted]":
            fail(f"{m} bf16 ran on {lat.engine_name}")
        if not bool(torch.isfinite(lat.state.fields.float()).all()):
            fail(f"{m} bf16: non-finite fields")
        out[m] = {"launches": launches, "mlups_iterate": mlups,
                  "lattice": lat}
    return out


def walled_cavity(storage_dtype=None, n: int = 16):
    """tests/test_shift.py's cavity: d2q9, walls top and bottom, nu 0.05,
    Velocity 0.02, initialised."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=DEVICE,
                  settings={"nu": 0.05, "Velocity": 0.02},
                  storage_dtype=storage_dtype)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[0] = flags[-1] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def checkpoint_phase() -> dict:
    """Phase 30: a save/load round trip of bf16 shifted lattices on the
    card: bit-exact at rest in the same representation; through a raw f32
    lattice within 1e-6; and back to shifted bf16, every value to within
    the f32 rounding of its raw value f + w (the values that differ are
    counted; on the JAX package's own test state none do).
    The states: tests/test_shift.py:177-222's (its walled 16x16 cavity
    after 12 steps) and the developed 64x64 harness cavity (500 steps)."""
    from tclb_tpu_torch import precision
    from tclb_tpu_torch.core import shift as ddf
    say("phase 30: bf16 shifted checkpoints on the card")
    out = {}
    makers = {
        "test_shift_state": (lambda sdt=None: walled_cavity(sdt), 12),
        "harness_cavity": (lambda sdt=None: precision.case_lattice(
            "cavity", HARNESS_N, sdt, None, DEVICE), HARNESS_NITER)}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (make, steps) in makers.items():
            sh = make(BF16)
            sh.iterate(steps)
            p = os.path.join(tmp, f"{label}.npz")
            sh.save(p)
            same = make(BF16)
            same.load(p)
            exact = torch.equal(same.state.fields.view(torch.int16),
                                sh.state.fields.view(torch.int16))
            wide = make()
            wide.load(p)
            to_f32 = float(abs(wide.fields_raw() - sh.fields_raw()).max())
            q = os.path.join(tmp, f"{label}_f32.npz")
            wide.save(q)
            back = make(BF16)
            back.load(q)
            differ = (back.state.fields.view(torch.int16)
                      != sh.state.fields.view(torch.int16)).cpu().numpy()
            # a value comes back to within the f32 rounding of f + w: the
            # raw f32 lattice holds f32(dev + w)
            dev = sh.state.fields.double().cpu().numpy()
            w = ddf._bshape(ddf.storage_shift(sh.model), dev.ndim)
            e = np.abs(dev + w) * 2.0 ** -24 * (1 + 2.0 ** -20)
            lo = torch.from_numpy(dev - e).to(BF16).double().numpy()
            hi = torch.from_numpy(dev + e).to(BF16).double().numpy()
            got = back.state.fields.double().cpu().numpy()
            explained = bool(np.all((got >= lo) & (got <= hi)))
            out[label] = {"same_repr_bit_exact": exact,
                          "to_f32_max_abs": to_f32,
                          "round_trip_differ": int(differ.sum()),
                          "values": int(differ.size)}
            say(f"  {label} ({tuple(sh.shape)}, {steps} steps on "
                f"{sh.engine_name}): same-repr load "
                f"{'bit-exact' if exact else 'DIFFERS'}; to raw f32 max "
                f"{to_f32:.2e}; back to shifted bf16: {int(differ.sum())} "
                f"of {differ.size} values differ, every value within the "
                f"f32 rounding of f + w")
            if not exact or to_f32 > 1e-6 or not explained:
                fail(f"checkpoint round trip {label}: {out[label]}")
    return out


HARNESS_RES_STEPS = 98     # one resident launch of the harness's iterate(100)


def run_ladder(gk, dk3, errs: dict, channel, drop1024, control, channel3d,
               turb, channel48) -> dict:
    """Phases 26-30 (the storage ladder) on the card, and the bf16
    kernels' launches by path, their lattices for phase 7 and the summary
    line's record."""
    from tclb_tpu_torch import Lattice, get_model, precision
    from torch_cases import (KUPER_SETTINGS, RICH3D_SETTINGS,
                             paint_rich_3d, paint_rich_kuper)
    kuper96 = paint_rich_kuper(Lattice(
        get_model("d2q9_kuper"), (96, 512), dtype=torch.float32,
        device=DEVICE, settings=KUPER_SETTINGS), seed=5)
    rich48 = paint_rich_3d(Lattice(
        get_model("d3q27_cumulant"), CHANNEL48, dtype=torch.float32,
        device=DEVICE, settings=RICH3D_SETTINGS), seed=5)
    k4 = [channel, control, drop1024, kuper96]
    k3 = [rich48, channel3d, turb] + list(channel48.values())
    harness = {}
    for case in precision.CASE_NAMES:
        for repr_ in ("raw", "shifted"):
            lat = precision.case_lattice(case, HARNESS_N, BF16, repr_,
                                         DEVICE)
            lat.iterate(100)
            harness[(case, repr_)] = lat
    for repr_ in ("raw", "shifted"):
        check_bf16_kernels(
            [(gk, bf16_copy(lat, repr_), "generic2d_step") for lat in k4]
            + [(dk3, bf16_copy(lat, repr_), name) for lat in k3
               for name in dk3.KERNELS], errs,
            f"phase 26 ({repr_})")
        for case in precision.CASE_NAMES:
            check_bf16_resident(gk, harness[(case, repr_)],
                                HARNESS_RES_STEPS, errs,
                                f"phase 26 ({repr_}, {case})")
    harness_out = harness_phase(gk)
    flagship = flagship_phase(gk)
    ch3d = channel3d_bf16_phase(dk3)
    ch48 = channel48_bf16_phase(dk3, channel48)
    ckpt = checkpoint_phase()
    # the developed bf16 states of the paths (after their counts were read)
    check_bf16_kernels(
        [(gk, flagship["lattice"], "generic2d_step"),
         (dk3, ch3d["bf16_shifted"]["lattice"], "d3q27_step"),
         (dk3, ch3d["bf16_shifted"]["lattice"], "d3q27_step2")]
        + [(dk3, v["lattice"], name) for v in ch48.values()
           for name in dk3.KERNELS], errs,
        "phase 26b, the paths' developed bf16 states")
    h = harness_out["launches"]
    fl = flagship["runs"]
    launches = {
        "generic2d_step_bf16[d2q9]": {
            "flagship": sum(fl[k]["bf16_launches"]["generic2d_step_bf16"]
                            for k in ("bf16_shifted", "bf16_raw")),
            "harness_cavity": h["cavity"]["generic2d_step_bf16"]},
        "generic2d_resident_bf16[d2q9]": {
            "harness_cavity": h["cavity"]["generic2d_resident_bf16"]},
        "generic2d_step_bf16[d2q9_kuper]": {
            "harness_kuper_drop": h["kuper_drop"]["generic2d_step_bf16"]},
        "generic2d_resident_bf16[d2q9_kuper]": {
            "harness_kuper_drop":
                h["kuper_drop"]["generic2d_resident_bf16"]}}
    launches.update({k: {"3d_channel_bf16": v} for k, v in
                     ch3d["bf16_shifted"]["launches"].items()
                     if "bf16" in k})
    launches.update({k: {"channel48_bf16": n} for v in ch48.values()
                     for k, n in v["launches"].items() if n})
    # the globals flavour's share of generic2d_step_bf16's launches
    globals_launches = {
        "generic2d_step_bf16[d2q9]": {
            "flagship": sum(fl[k]["bf16_launches"]["globals"]
                            for k in ("bf16_shifted", "bf16_raw")),
            "harness_cavity": h["cavity"]["globals"]},
        "generic2d_step_bf16[d2q9_kuper]": {
            "harness_kuper_drop": h["kuper_drop"]["globals"]}}
    summary = {
        "harness": {"u_linf_raw_over_shifted":
                    harness_out["u_linf_raw_over_shifted"],
                    "wall_s": harness_out["wall_s"],
                    "reports": harness_out["reports"]},
        "flagship": {k: v for k, v in flagship.items() if k != "lattice"},
        "3d_channel_bf16": {
            "u_rel_l2_vs_f32": ch3d["u_rel_l2_vs_f32"],
            "mean_ux": ch3d["mean_ux"],
            **{label: {k: v for k, v in ch3d[label].items()
                       if k != "lattice"} for label in ("f32",
                                                        "bf16_shifted")}},
        "channel48_bf16_mlups_iterate": {m: v["mlups_iterate"]
                                         for m, v in ch48.items()},
        "checkpoints": ckpt}
    return {"launches": launches, "globals_launches": globals_launches,
            "summary": summary,
            "band": {"d2q9": flagship["lattice"],
                     "d2q9_kuper": bf16_copy(drop1024)},
            "resident": {"d2q9": harness[("cavity", "shifted")],
                         "d2q9_kuper": harness[("kuper_drop", "shifted")]},
            "d3": {"d3q27_cumulant": ch3d["bf16_shifted"]["lattice"],
                   **{m: v["lattice"] for m, v in ch48.items()}}}


def time_bf16(gk, dk3, band: dict, res: dict, d3: dict,
              res_steps: int) -> dict:
    """Phase 7 for the bf16 kernels at their paths' shapes: K4 (both
    flavours) on ``band`` lattices, K5 for ``res_steps`` on ``res``
    lattices, K3 on ``d3`` lattices; the bound at 2 B a value at rest."""
    out = {}
    for lat in band.values():
        f, flags, ztab, a = bf16_inputs(gk, lat)
        key = bf16_key(gk, "generic2d_step", lat.model.name)
        for k, fn, g, reps in ((key, gk.step, False, 400),
                               (f"{key} globals", gk.step_globals, True,
                                200)):
            out[k] = time_one(
                k, lambda fn=fn: fn(f, flags, ztab, a),
                lambda g=g: gk.plain_steps(f, flags, ztab, a, 1,
                                           with_globals=g),
                gk.launch_bytes(lat.model, lat.shape, itemsize=2),
                gk.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
                reps)
    for lat in res.values():
        f, flags, ztab, a = bf16_inputs(gk, lat)
        key = bf16_key(gk, "generic2d_resident", lat.model.name)
        out[key] = time_one(
            f"{key} ({res_steps} steps)",
            lambda: gk.resident(f, flags, ztab, a, res_steps),
            lambda: gk.plain_steps(f, flags, ztab, a, res_steps),
            gk.launch_bytes(lat.model, lat.shape, itemsize=2),
            res_steps * gk.node_step_flops(lat.model, lat.flags_numpy()),
            lat.shape, 50, plain_reps=2)
        out[key]["steps"] = res_steps
    for lat in d3.values():
        *inputs, a = bf16_inputs(dk3, lat)
        for name, reps in (("d3q27_step", 400), ("d3q27_step2", 200)):
            fn, steps = dk3.WRAPPERS[name]
            key = bf16_key(dk3, name, lat.model.name)
            out[key] = time_one(
                key, lambda fn=fn: fn(*inputs, a),
                lambda steps=steps: dk3.plain_steps(*inputs, a, steps),
                dk3.launch_bytes(lat.model, lat.shape, itemsize=2),
                steps * dk3.node_step_flops(lat.model, lat.flags_numpy()),
                lat.shape, reps)
    return out


# --------------------------------------------------------------------------- #
# The one-stage 2D models on K4/K5 (phases 31-34)
# --------------------------------------------------------------------------- #

ONESTAGE_MODELS = ("d2q9_heat", "d2q9_heat_conjugate", "d2q9_hb", "sw",
                   "d2q9_solid", "d2q9_npe_guo")
# model -> its shipped example (the two built on d2q9_heat ship none)
ONESTAGE_EXAMPLES = {"d2q9_heat": "heat_channel.xml", "sw": "sw_wave.xml",
                     "d2q9_solid": "solidification.xml",
                     "d2q9_npe_guo": "npe_guo.xml"}
ONESTAGE_CUT = 1000          # iterations of the eager comparison
ONESTAGE_N = 1024            # the full-width lattices
ONESTAGE_WINDOW = 2000       # iterate() window of the MLUPS
ONESTAGE_SMALL = (128, 128)  # K5's path for the models without an example
ONESTAGE_SMALL_WINDOW = 500  # its iterate window
# sw_wave's total height (an f64 sum): the f64 eager run conserves it to
# SW_MASS_F64 over the cut; in f32 it grows on every engine, the JAX
# package's XLA engine too (the inverse basis' float coefficients;
# tests/test_torch_sw.py), so the kernel run's mass is held to the eager
# f32 run's at every Log of the cut within SW_MASS_F32
SW_MASS_F64, SW_MASS_F32 = 1e-10, 1e-7
EOF_ATOL = 0.08              # tests/test_electrokinetics.py:122


def onestage_lattice(model: str, shape, storage_dtype=None, settings=None,
                     zone1=None):
    """tests/test_pallas_generic.py's ``_paint`` on the card
    (``torch_cases.paint_generic``: the collision type inside, walls top
    and bottom, W and E faces, a settings zone 1 stripe; hb's Destroy and
    solid's Seed) with ``settings`` (by default that file's ``_SETTINGS``
    where it has the model and the example's otherwise,
    ``GENERIC_SETTINGS``) and zone 1's values of the zonal settings from
    ``zone1`` (by default ``RICH_ONESTAGE_ZONE1``), initialised; bf16
    shifted storage with ``storage_dtype``."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import (GENERIC_SETTINGS, RICH_ONESTAGE_ZONE1,
                             paint_generic)
    m = get_model(model)
    kw = {} if storage_dtype is None else {
        "storage_dtype": storage_dtype, "storage_repr": "shifted"}
    lat = Lattice(m, shape, dtype=torch.float32, device=DEVICE,
                  settings=settings or GENERIC_SETTINGS[model], **kw)
    lat.set_flags(paint_generic(m, *shape))
    for name in m.zonal_settings:
        lat.set_setting(name, (zone1 or RICH_ONESTAGE_ZONE1)[name], zone=1)
    lat.init()
    return lat


def cut_xml(xml, niter: int, directory) -> pathlib.Path:
    """``xml`` with its Solve cut to ``niter`` iterations (the Log
    interval kept, no VTK), written into ``directory`` under its name."""
    root = ET.parse(xml).getroot()
    root.find("Solve").set("Iterations", str(niter))
    for el in root.findall("VTK"):
        root.remove(el)
    path = pathlib.Path(directory) / xml.name
    ET.ElementTree(root).write(path)
    return path


def heat_check(run, lat) -> dict:
    """heat_channel.xml: T finite, hottest on the Heater."""
    m = lat.model
    T = lat.get_quantity("T").double()
    heater = torch.as_tensor(
        (lat.flags_numpy() & m.node_types["Heater"].mask)
        == m.node_types["Heater"].value, device=T.device)
    t_max, t_heater = float(T.max()), float(T[heater].max())
    say(f"  T in [{float(T.min()):.4f}, {t_max:.4f}], on the Heater up to "
        f"{t_heater:.4f}")
    if not (bool(torch.isfinite(T).all()) and t_heater == t_max):
        fail("heat_channel.xml: T is not hottest on the Heater")
    return {"T_max": t_max, "T_heater_max": t_heater}


def sw_check(run, kern, eager, f64) -> dict:
    """sw_wave.xml's total height (summed in f64): the f64 eager run of
    the cut conserves it within SW_MASS_F64 at every Log; the kernel run
    of the cut carries it as the eager f32 run does, within SW_MASS_F32
    at every Log; the whole run's drift (f32) is reported."""
    mass0 = run["mass0"]
    drift = {tag: [abs(v - r["mass0"]) / r["mass0"] for _, v in r["probes"]]
             for tag, r in (("run", run), ("f64", f64))}
    gap = max(abs(a - b) / mass0 for (_, a), (_, b)
              in zip(kern["probes"], eager["probes"]))
    say(f"  total height {mass0!r} at the start; relative drift at the "
        f"Logs {drift['run']} on the kernels (f32), {drift['f64']} on the "
        f"f64 eager engine over the first {ONESTAGE_CUT} (limit "
        f"{SW_MASS_F64}); kernels against eager f32 over the cut: "
        f"{gap:.3e} (limit {SW_MASS_F32})")
    if not (max(drift["f64"]) <= SW_MASS_F64 and gap <= SW_MASS_F32
            and len(kern["probes"]) == len(eager["probes"]) > 0):
        fail("sw_wave.xml does not conserve its mass")
    return {"mass0": mass0, "drift_f32_run": drift["run"],
            "drift_f64_cut": drift["f64"], "kernel_vs_eager_f32": gap}


def solid_check(run, lat) -> dict:
    """solidification.xml: fi_s in [0, 1] at every Log, its sum growing
    from Log to Log (tests/test_physics_constitutive.py:158-200)."""
    sums = [v[0] for _, v in run["probes"]]
    lo = min(v[1] for _, v in run["probes"])
    hi = max(v[2] for _, v in run["probes"])
    say(f"  solid sum at the Logs {sums}; fi_s in [{lo!r}, {hi!r}]")
    if not (lo >= 0.0 and hi <= 1.0
            and all(b > a for a, b in zip(sums, sums[1:]))):
        fail("solidification.xml: the solid does not grow within [0, 1]")
    return {"solid_sums": sums, "fi_min": lo, "fi_max": hi}


def onestage_probe(model: str):
    """What the physics check of ``model``'s example records at each Log."""
    if model == "sw":
        return lambda s: float(s.lattice.get_quantity("Rho").double().sum())
    if model == "d2q9_solid":
        def solid(s):
            fi = s.lattice.get_quantity("Solid").double()
            return (float(fi.sum()), float(fi.min()), float(fi.max()))
        return solid
    return None


def run_onestage_example(gk, model: str) -> dict:
    """Phase 31: ``model``'s example unchanged through ``run_config`` on
    the card, counted from 0: the resident engine, no eager step, both
    generic kernels; the physics check; then the example cut to
    ONESTAGE_CUT iterations on the kernels and on the eager f32 engine:
    every Log column and the final fields and VTK quantities at rtol 1e-4
    / atol 1e-6; the MLUPS of the whole case and of an iterate window."""
    xml = ROOT / "example" / ONESTAGE_EXAMPLES[model]
    say(f"phase 31: {xml.name} end to end")
    root = ET.parse(xml).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    # one iterate call, hence one globals launch, per Log or VTK stop
    stops = len({niter} | {i for el in root.findall("Log")
                           + root.findall("VTK")
                           for i in range(int(el.get("Iterations")),
                                          niter + 1,
                                          int(el.get("Iterations")))})
    run = run_onestage_xml(gk, xml, True, onestage_probe(model))
    lat = run["solver"].lattice
    engine = f"cuda_generic_resident[{model},fuse=N]"
    launches = {k: v for k, v in run["launches"].items() if v}
    say(f"  engine {lat.engine_name}, {run['solver'].iter} iterations, "
        f"{run['wall_s']:.3f} s wall, launches {launches}, eager steps "
        f"{lat.eager_steps}")
    if lat.engine_name != engine or lat.eager_steps:
        fail(f"{xml.name} ran on {lat.engine_name} with {lat.eager_steps} "
             "eager steps")
    globals_ = run["flavours"]["generic2d_step"]["globals"]
    if set(launches) != set(gk.KERNELS) or globals_ != stops:
        fail(f"{xml.name}: launches {launches}, globals flavour "
             f"{globals_} in {stops} iterate calls")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{xml.name}: non-finite fields")
    if model == "d2q9_heat":
        physics = heat_check(run, lat)
    elif model == "d2q9_solid":
        physics = solid_check(run, lat)
    probe = onestage_probe(model)
    with tempfile.TemporaryDirectory() as tmp:
        cut = cut_xml(xml, ONESTAGE_CUT, tmp)
        kern = run_onestage_xml(gk, cut, True, probe)
        eager = run_onestage_xml(gk, cut, False, probe)
        if model == "sw":
            f64 = run_onestage_xml(gk, cut, False, probe, torch.float64)
            run["mass0"], f64["mass0"] = (
                float(case_lattice(xml, dt, DEVICE).get_quantity("Rho")
                      .double().sum())
                for dt in (torch.float32, torch.float64))
            physics = sw_check(run, kern, eager, f64)
        elif model == "d2q9_npe_guo":
            physics = {}
    if eager["solver"].lattice.engine_name != "eager" \
            or kern["solver"].lattice.engine_name != engine:
        fail(f"{xml.name} cut: engines {kern['solver'].lattice.engine_name}"
             f", {eager['solver'].lattice.engine_name}")
    (head, rows), (ehead, erows) = kern["Log"], eager["Log"]
    keep = [i for i, h in enumerate(head) if "Walltime" not in h]
    if head != ehead or rows.shape != erows.shape or not (
            np.isfinite(rows[:, keep]).all() and np.allclose(
                rows[:, keep], erows[:, keep], rtol=GOLDEN_RTOL,
                atol=GOLDEN_ATOL)):
        fail(f"{xml.name}: the Log columns of the first {ONESTAGE_CUT} "
             "iterations differ from the eager run's")
    log_err = float(np.abs(rows[:, keep] - erows[:, keep]).max())
    klat, elat = kern["solver"].lattice, eager["solver"].lattice
    say(f"  the first {ONESTAGE_CUT} iterations on the kernels against the "
        f"eager f32 engine ({eager['wall_s']:.2f} s): Log columns within "
        f"{log_err:.3e}")
    fields = compare(klat.state.fields, elat.state.fields,
                     f"{xml.name}'s fields after {ONESTAGE_CUT} against the "
                     "eager run's", GOLDEN_RTOL, GOLDEN_ATOL)
    vtk = root.find("VTK")
    quantities = {}
    for q in ([] if vtk is None else vtk.get("what").split(",")):
        quantities[q] = compare(klat.get_quantity(q), elat.get_quantity(q),
                                f"{xml.name}'s {q} after {ONESTAGE_CUT}",
                                GOLDEN_RTOL, GOLDEN_ATOL)
    nodes = float(np.prod(lat.shape))
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(ONESTAGE_WINDOW)
    lat.synchronize()
    dt = time.perf_counter() - t0
    out = {"engine": lat.engine_name, "wall_s": run["wall_s"],
           "launches": run["launches"], "flavours": run["flavours"],
           "mlups_end_to_end": nodes * niter / run["wall_s"] / 1e6,
           "mlups_iterate": nodes * ONESTAGE_WINDOW / dt / 1e6,
           "log_max_abs_err_vs_eager": log_err, "fields_vs_eager": fields,
           "vtk_vs_eager": quantities, "eager_wall_s": eager["wall_s"],
           "physics": physics, "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end, "
        f"{out['mlups_iterate']:.1f} in an iterate({ONESTAGE_WINDOW}) "
        "window")
    return out


def run_onestage_xml(gk, xml, fast: bool, probe=None,
                     dtype=torch.float32) -> dict:
    """``run_series_xml`` with the step kernels' launches by flavour."""
    run = run_series_xml(xml, fast, probe, dtype=dtype)
    run["flavours"] = {k: gk.flavours(k) for k in ("generic2d_step",
                                                   "generic2d_step_bf16")}
    return run


def run_eof(gk) -> dict:
    """Phase 31b: tests/test_electrokinetics.py's electro-osmotic channel
    (30x64, charged walls, a potential drop through phi_bc zones at the W
    and E pressure faces, 8000 iterations) on the kernels in f32: a plug
    profile whose shape follows (psi - zeta) within EOF_ATOL."""
    from tclb_tpu_torch import Lattice, get_model
    say("phase 31b: d2q9_npe_guo's electro-osmotic profile on the kernels")
    ny, nx, zeta, n_inf = 30, 64, 0.05, 0.01
    m = get_model("d2q9_npe_guo")
    lat = Lattice(m, (ny, nx), dtype=torch.float32, device=DEVICE,
                  settings={"n_inf_0": n_inf, "n_inf_1": n_inf,
                            "psi_bc": zeta, "psi0": 0.0, "phi0": 0.0,
                            "phi_bc": 0.0, "el_kbT": 1.0, "epsilon": 1.0,
                            "nu": 1 / 6, "D": 1 / 6, "rho_bc": 1.0})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    flags[1:-1, 0] = m.flag_for("WPressure", "MRT", zone=1)
    flags[1:-1, -1] = m.flag_for("EPressure", "MRT")
    lat.set_flags(flags)
    lat.set_setting("phi_bc", 0.5, zone=1)
    lat.init()
    gk.reset_launches()
    lat.iterate(8000)
    lat.synchronize()
    launches = dict(gk.LAUNCHES)
    flavours = {k: gk.flavours(k) for k in ("generic2d_step",
                                            "generic2d_step_bf16")}
    ux = lat.get_quantity("U")[0][:, nx // 2].double().cpu().numpy()
    psi = lat.get_quantity("Psi")[:, nx // 2].double().cpu().numpy()
    c = ny // 2
    shape_u = ux / ux[c]
    shape_p = (psi - zeta) / (psi[c] - zeta)
    err = float(np.abs(shape_u[3:-3] - shape_p[3:-3]).max())
    plug = abs(ux[c]) > 5 * abs(ux[1] - ux[c] * (psi[1] - zeta)
                                / (psi[c] - zeta))
    say(f"  engine {lat.engine_name}, launches "
        f"{ {k: v for k, v in launches.items() if v} }; centre ux "
        f"{ux[c]:.4e}, normalised u against (psi - zeta): max |diff| "
        f"{err:.4f} (limit {EOF_ATOL}), plug {plug}")
    if not (np.isfinite(ux).all() and plug and err <= EOF_ATOL):
        fail("npe_guo: the electro-osmotic profile does not follow "
             "(psi - zeta)")
    return {"engine": lat.engine_name, "launches": launches,
            "flavours": flavours, "ux_centre": float(ux[c]),
            "shape_max_abs_diff": err}


def bf16_chain(gk, lat, nsteps: int, errs: dict, what: str) -> dict:
    """K5's bf16 rung on ``lat`` (bf16 shifted): each of ``nsteps``
    chained ``generic2d_step_bf16`` launches against its plain version
    from the same input (``compare_narrowed``), and the resident launch
    bit for bit against the chain."""
    f, flags, ztab, a = bf16_inputs(gk, lat)
    key = bf16_key(gk, "generic2d_resident", lat.model.name)
    tag = f"{key} ({nsteps} steps) at {tuple(f.shape)}"
    got = gk.resident(f, flags, ztab, a, nsteps)
    chain = f
    e = {"max_abs_err": 0.0, "max_rel_err": 0.0, "flips": 0}
    for i in range(nsteps):
        nxt = gk.step(chain, flags, ztab, a)
        one = compare_narrowed(nxt, wide_plain(gk, lat, 1, fields=chain),
                               lat, f"{tag}: chained launch {i + 1}",
                               quiet=True)
        e = {k: max(e[k], one[k]) for k in e}
        chain = nxt
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int16), chain.view(torch.int16))
    say(f"{what}: {tag}: {nsteps} chained generic2d_step_bf16 launches "
        f"each within the f32 tolerance carried through the narrowing "
        f"(max_abs {e['max_abs_err']:.3e}, at most {e['flips']} values a "
        f"bf16 step off); the resident launch "
        f"{'bit-identical to' if same else 'DIFFERS from'} the chain")
    if not same:
        fail(f"{tag} differs from {nsteps} generic2d_step_bf16 launches")
    e["chain_bit_identical"] = same
    keep_worst(errs, key, e)
    return errs


def resident_chain(gk, lat, nsteps: int, errs: dict, what: str) -> dict:
    """K5 in f32 on ``lat``: against its plain version (``check_kernels``)
    and bit for bit against ``nsteps`` chained ``generic2d_step``
    launches."""
    check_kernels([(gk, lat, "generic2d_resident")], errs, what)
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    got = gk.resident(f, flags, ztab, a, nsteps)
    chain = f
    for _ in range(nsteps):
        chain = gk.step(chain, flags, ztab, a)
    torch.cuda.synchronize()
    same = torch.equal(got, chain)
    say(f"  generic2d_resident[{lat.model.name}] ({nsteps} steps) at "
        f"{tuple(f.shape)}: {'bit-identical to' if same else 'DIFFERS from'}"
        f" {nsteps} chained generic2d_step launches")
    if not same:
        fail(f"generic2d_resident[{lat.model.name}] differs from its chain")
    errs[f"generic2d_resident[{lat.model.name}]"]["chain_bit_identical"] = \
        same
    return errs


def iterate_window(gk, lat, what: str, engine: str,
                   n: int = ONESTAGE_WINDOW) -> dict:
    """An ``iterate(n)`` on the card from counts set to 0, fenced by
    synchronize: its engine, launches by kernel and flavour and MLUPS."""
    lat.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(n)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = {**gk.LAUNCHES, **gk.SERIES_LAUNCHES}
    flav = {k: gk.flavours(k) for k in ("generic2d_step",
                                        "generic2d_step_bf16")}
    mlups = float(np.prod(lat.shape)) * n / dt / 1e6
    say(f"  {what}: engine {lat.engine_name}, "
        f"{ {k: v for k, v in launches.items() if v} }, {mlups:.1f} MLUPS "
        f"({dt * 1e3:.2f} ms)")
    if lat.engine_name != engine or lat.eager_steps:
        fail(f"{what} ran on {lat.engine_name}")
    if not bool(torch.isfinite(lat.state.fields.float()).all()):
        fail(f"{what}: non-finite fields")
    return {"engine": lat.engine_name, "launches": launches,
            "flavours": flav, "mlups_iterate": mlups, "iterate_ms": dt * 1e3,
            "window": n}


def run_onestage(gk, errs: dict) -> dict:
    """Phases 31-34 for the six one-stage models: the examples (31), the
    EOF profile (31b), K5 and its bf16 rung on each resident path (33: the
    example's, or a 128x128 lattice for the two models without one), each
    model's 1024x1024 lattice on K4 in f32 and in bf16 shifted (32),
    d2q9_heat under a <Control> series of HeaterTemperature (34).
    Returns the launches by kernel and path (and of the step kernels'
    globals flavour), the lattices phase 7 times and the summary."""
    launches, glaunches, summary = {}, {}, {}
    band, res, res_steps = {}, {}, {}

    def count(into, key, path, n):
        if n:
            into.setdefault(key, {})[path] = into.get(key, {}).get(path,
                                                                    0) + n

    def record(path, run, kernels):
        for k in kernels:
            count(launches, f"{k}[{model}]", path, run["launches"][k])
        for k in ("generic2d_step", "generic2d_step_bf16"):
            count(glaunches, f"{k}[{model}]", path,
                  run["flavours"][k]["globals"])
        summary[path] = {k: v for k, v in run.items()
                         if k not in ("launches", "flavours")}

    for model in ONESTAGE_MODELS:
        if model in ONESTAGE_EXAMPLES:
            xml = ROOT / "example" / ONESTAGE_EXAMPLES[model]
            run = run_onestage_example(gk, model)
            res[model] = run.pop("lattice")
            log = int(ET.parse(xml).getroot().find("Log").get("Iterations"))
            record(xml.stem, run, gk.KERNELS)
        else:
            say(f"phase 33: {model} at {ONESTAGE_SMALL} (K5's path)")
            res[model] = onestage_lattice(model, ONESTAGE_SMALL)
            log = ONESTAGE_SMALL_WINDOW
            run = iterate_window(gk, res[model], f"{model}128",
                                 f"cuda_generic_resident[{model},fuse=N]",
                                 log)
            record(f"{model}128", run, gk.KERNELS)
        # one resident launch of the path: the even part of niter - 1
        res_steps[model] = (log - 1) // 2 * 2
    model = "d2q9_npe_guo"
    eof = run_eof(gk)
    record("npe_eof", eof, gk.KERNELS)
    # K5 and its bf16 rung on each resident path's developed state
    for model in ONESTAGE_MODELS:
        lat = res[model]
        resident_chain(gk, lat, 8, errs, f"phase 33, {model}'s resident "
                       "path")
        bf = bf16_copy(lat)
        bf16_chain(gk, bf, 8, errs, f"phase 33, {model} in bf16 shifted")
        res[f"{model} bf16"] = bf16_copy(lat)
        path = f"{model}_bf16_resident"
        record(path, iterate_window(
            gk, bf, f"{path} at {lat.shape}",
            f"cuda_generic_resident[{model},fuse=N,bfloat16/shifted]"),
            gk.BF16_KERNELS)
    # the full-width lattices on K4, f32 and bf16 shifted
    for model in ONESTAGE_MODELS:
        say(f"phase 32: {model} at {ONESTAGE_N}x{ONESTAGE_N} on K4")
        what = f"phase 32, {model} {ONESTAGE_N}x{ONESTAGE_N}"
        lat = onestage_lattice(model, (ONESTAGE_N, ONESTAGE_N))
        eager_warm(lat, 4)
        check_kernels([(gk, lat, "generic2d_step")], errs, what)
        check_globals_flavour(gk, (lat,), errs, what)
        bf = bf16_copy(lat)
        check_bf16_kernels([(gk, bf, "generic2d_step")], errs, what)
        band[model], band[f"{model} bf16"] = lat, bf16_copy(lat)
        for tag, L, eng in (
                ("", lat, f"cuda_generic_band[{model},fuse=1]"),
                ("_bf16", bf,
                 f"cuda_generic_band[{model},fuse=1,bfloat16/shifted]")):
            path = f"{model}{ONESTAGE_N}{tag}"
            record(path, iterate_window(gk, L, path, eng),
                   [f"generic2d_step{tag}"])
        summary[f"{model}{ONESTAGE_N}"]["bf16_over_f32"] = (
            summary[f"{model}{ONESTAGE_N}_bf16"]["mlups_iterate"]
            / summary[f"{model}{ONESTAGE_N}"]["mlups_iterate"])
    # a <Control> series on a new model: heat_channel's Heater zone
    say("phase 34: d2q9_heat under a <Control> series of HeaterTemperature")
    model = "d2q9_heat"
    heat = case_lattice(ROOT / "example" / ONESTAGE_EXAMPLES[model],
                        torch.float32, DEVICE)
    eager_warm(heat, 50)
    heat.set_setting_series("HeaterTemperature",
                            [10.0, 12.0, 15.0, 11.0, 9.0], zone=0)
    check_series_flavours(gk, (heat,), errs, "phase 34")
    record("heat_channel_series", iterate_window(
        gk, heat, "heat_channel under the series",
        "cuda_generic_band[d2q9_heat,fuse=1]"), gk.SERIES_KERNELS)
    res["heat series"] = heat
    return {"launches": launches, "globals_launches": glaunches,
            "summary": summary, "band": band, "resident": res,
            "res_steps": res_steps}


def time_onestage(gk, one: dict) -> dict:
    """Phase 7 for the one-stage models: K4 (both flavours) at 1024x1024
    in f32 and bf16, K5 on each resident path's state for the steps one of
    its launches takes there (at most
    K5_TIMING_STEPS), in f32 and bf16 (its plain version, seconds
    of eager steps, timed once with no warm-up call: the checks before
    ran the same eager operations), the series flavours on heat_channel; the
    bound from ``launch_bytes`` (bf16 at 2 B a value) and
    ``node_step_flops``."""
    out = {}
    for model in ONESTAGE_MODELS:
        for tag, lat in (("", one["band"][model]),
                         ("_bf16", one["band"][f"{model} bf16"])):
            inputs = (bf16_inputs(gk, lat) if tag
                      else gk.kernel_inputs(lat.model, lat.state,
                                            lat.params))
            f, flags, ztab, a = inputs
            key = f"generic2d_step{tag}[{model}]"
            for k, fn, g, reps in ((key, gk.step, False, 200),
                                   (f"{key} globals", gk.step_globals,
                                    True, 100)):
                out[k] = time_one(
                    k, lambda fn=fn: fn(f, flags, ztab, a),
                    lambda g=g: gk.plain_steps(f, flags, ztab, a, 1,
                                               with_globals=g),
                    gk.launch_bytes(lat.model, lat.shape,
                                    itemsize=2 if tag else 4),
                    gk.node_step_flops(lat.model, lat.flags_numpy()),
                    lat.shape, reps, plain_reps=3)
        steps = min(one["res_steps"][model], K5_TIMING_STEPS)
        for tag, lat in (("", one["resident"][model]),
                         ("_bf16", one["resident"][f"{model} bf16"])):
            f, flags, ztab, a = (bf16_inputs(gk, lat) if tag else
                                 gk.kernel_inputs(lat.model, lat.state,
                                                  lat.params))
            key = f"generic2d_resident{tag}[{model}]"
            out[key] = time_one(
                f"{key} ({steps} steps)",
                lambda: gk.resident(f, flags, ztab, a, steps),
                lambda: gk.plain_steps(f, flags, ztab, a, steps),
                gk.launch_bytes(lat.model, lat.shape,
                                itemsize=2 if tag else 4),
                steps * gk.node_step_flops(lat.model, lat.flags_numpy()),
                lat.shape, 20, plain_reps=1, plain_warm=0)
            out[key]["steps"] = steps
    out.update(time_series_flavours(gk, one["resident"]["heat series"],
                                    1000))
    return out


# --------------------------------------------------------------------------- #
# The multi-stage 2D models on K4/K5 (phases 35-38)
# --------------------------------------------------------------------------- #

MULTISTAGE_MODELS = ("d2q9_pf_pressureEvolution", "d2q9_pp_MCMP",
                     "d2q9_lee", "d2q9_poison_boltzmann")
MULTISTAGE_CUT = 1000        # iterations of the eager comparison
MULTISTAGE_N = 1024          # the full-width lattices
MULTISTAGE_WINDOW = 2000     # iterate() window of the MLUPS
PB_SMALL = (128, 128)        # poison_boltzmann's resident path (no example)
PB_WINDOW = 500
# a conserved sum's relative drift: the f64 eager run of a cut holds
# tests/test_pf.py:146's and tests/test_pp.py:106's limits; in f32 the
# sums drift by their rounding bias on every engine (1e-5 a few thousand
# steps), so the kernel run's drift is held to the eager f32 run's at
# every Log of the cut within CONSERVED_F32
PF_SUM_F64, MCMP_MASS_F64, CONSERVED_F32 = 1e-12, 1e-10, 1e-6
LEE_MASS_RTOL = 5e-3         # tests/test_lee.py:80
LEE_RL, LEE_RV = 1.0, 0.1    # drop_lee.xml's Liquid/VaporDensity


def mask_of(lat, *names):
    """The nodes of ``lat`` whose group field equals one of ``names`` (or,
    for a group name, with any of its bits set), on the card."""
    m = lat.model
    flags = lat.flags_numpy().astype(np.int64)
    out = np.zeros(flags.shape, dtype=bool)
    for n in names:
        if n in m.group_masks:
            out |= (flags & m.group_masks[n]) != 0
        else:
            nt = m.node_types[n]
            out |= (flags & nt.mask) == nt.value
    return torch.as_tensor(out, device=DEVICE)


def multistage_probe(model: str):
    """What the physics check of ``model``'s example records at each Log:
    its conserved sums (f64 sums of the stored values), the globals and
    the sums they must equal."""
    def pf(s):
        lat = s.lattice
        rho = lat.get_quantity("Rho").double()
        return (float(lat.get_quantity("PhaseField").double().sum()),
                lat.get_globals()["TotalDensity"],
                float(rho[mask_of(lat, "MRT")].sum()))

    def mcmp(s):
        lat = s.lattice
        rf = lat.get_quantity("Rhof").double()
        rg = lat.get_quantity("Rhog").double()
        coll = mask_of(lat, "COLLISION")
        g = lat.get_globals()
        return (float(rf.sum()), float(rg.sum()), g["TotalDensity1"],
                g["TotalDensity2"], float(rf[coll].sum()),
                float(rg[coll].sum()))

    def lee(s):
        rho = s.lattice.get_quantity("Rho").double()
        return (float(rho.sum()), float(rho.max()), float(rho.min()))
    return {"d2q9_pf_pressureEvolution": pf, "d2q9_pp_MCMP": mcmp,
            "d2q9_lee": lee}[model]


def drifts(run, n: int = 1) -> list:
    """Relative drift of the first ``n`` probe columns at each Log from
    the run's start (``run["start"]``)."""
    return [[abs(v[i] - run["start"][i]) / abs(run["start"][i])
             for i in range(n)] for _, v in run["probes"]]


def sums_match_globals(run, pairs, what: str) -> float:
    """Each global equals the sum it counts at every Log of ``run``
    (``pairs`` of probe columns) within GOLDEN_RTOL; the largest
    relative gap."""
    gap = max(abs(v[g] - v[s]) / max(abs(v[s]), 1e-30)
              for _, v in run["probes"] for g, s in pairs)
    say(f"  {what}: the globals against the sums they count, largest "
        f"relative gap {gap:.3e} (rtol {GOLDEN_RTOL})")
    if gap > GOLDEN_RTOL:
        fail(f"{what}: a global differs from the sum it counts")
    return gap


def conserved_like_eager(kern, eager, f64, n: int, limit_f64: float,
                         what: str) -> dict:
    """The cut's conserved sums (the first ``n`` probe columns): the f64
    eager run holds them within ``limit_f64``, the kernel run drifts as
    the eager f32 run does within CONSERVED_F32 at every Log."""
    d64 = max(max(row) for row in drifts(f64, n))
    gap = max(abs(a - b) for rk, re in zip(drifts(kern, n),
                                           drifts(eager, n))
              for a, b in zip(rk, re))
    say(f"  {what}: the f64 eager cut drifts by at most {d64:.3e} (limit "
        f"{limit_f64}); the kernels' f32 drift against the eager f32 "
        f"run's: {gap:.3e} (limit {CONSERVED_F32}); the kernels' own "
        f"drift at the Logs {drifts(kern, n)}")
    if not (d64 <= limit_f64 and gap <= CONSERVED_F32
            and len(kern["probes"]) == len(eager["probes"]) > 0):
        fail(f"{what}: a conserved sum is not conserved")
    return {"f64_drift": d64, "kernel_vs_eager_f32": gap,
            "kernel_drift": drifts(kern, n)}


def start_probe(xml, model, dtype=torch.float32):
    """The probe on the case's initialised lattice (before its Solve)."""
    import types
    return multistage_probe(model)(types.SimpleNamespace(
        lattice=case_lattice(xml, dtype, DEVICE)))


def run_multistage_example(gk, model: str) -> dict:
    """Phase 35: ``model``'s example unchanged through ``run_config`` on
    the card, counted from 0: the resident engine, no eager step, both
    generic kernels, one globals call per Log (one launch a call); its
    physics (see ``multistage_physics``); then the example cut to
    MULTISTAGE_CUT iterations on the kernels and on the eager f32 engine:
    every Log column and the final fields at rtol 1e-4 / atol 1e-6; the
    MLUPS of the case and of an iterate window."""
    from torch_cases import MULTISTAGE_EXAMPLES
    xml = ROOT / "example" / MULTISTAGE_EXAMPLES[model]
    say(f"phase 35: {xml.name} end to end")
    root = ET.parse(xml).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    stops = len({niter} | {i for el in root.findall("Log")
                           + root.findall("VTK")
                           for i in range(int(el.get("Iterations")),
                                          niter + 1,
                                          int(el.get("Iterations")))})
    probe = multistage_probe(model)
    run = run_onestage_xml(gk, xml, True, probe)
    run["start"] = start_probe(xml, model)
    lat = run["solver"].lattice
    engine = f"cuda_generic_resident[{model},fuse=N]"
    launches = {k: v for k, v in run["launches"].items() if v}
    say(f"  engine {lat.engine_name}, {run['solver'].iter} iterations, "
        f"{run['wall_s']:.3f} s wall, launches {launches}, eager steps "
        f"{lat.eager_steps}")
    if lat.engine_name != engine or lat.eager_steps:
        fail(f"{xml.name} ran on {lat.engine_name} with {lat.eager_steps} "
             "eager steps")
    globals_ = run["flavours"]["generic2d_step"]["globals"]
    if set(launches) != set(gk.KERNELS) or globals_ != stops:
        fail(f"{xml.name}: launches {launches}, globals flavour "
             f"{globals_} in {stops} iterate calls")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{xml.name}: non-finite fields")
    with tempfile.TemporaryDirectory() as tmp:
        cut = cut_xml(xml, MULTISTAGE_CUT, tmp)
        kern = run_onestage_xml(gk, cut, True, probe)
        eager = run_onestage_xml(gk, cut, False, probe)
        f64 = (run_onestage_xml(gk, cut, False, probe, torch.float64)
               if model != "d2q9_lee" else None)
    for r in (kern, eager):
        r["start"] = run["start"]
    if f64 is not None:
        f64["start"] = start_probe(xml, model, torch.float64)
    physics = multistage_physics(model, run, kern, eager, f64, lat)
    if eager["solver"].lattice.engine_name != "eager" \
            or kern["solver"].lattice.engine_name != engine:
        fail(f"{xml.name} cut: engines {kern['solver'].lattice.engine_name}"
             f", {eager['solver'].lattice.engine_name}")
    (head, rows), (ehead, erows) = kern["Log"], eager["Log"]
    keep = [i for i, h in enumerate(head) if "Walltime" not in h]
    if head != ehead or rows.shape != erows.shape or not (
            np.isfinite(rows[:, keep]).all() and np.allclose(
                rows[:, keep], erows[:, keep], rtol=GOLDEN_RTOL,
                atol=GOLDEN_ATOL)):
        fail(f"{xml.name}: the Log columns of the first {MULTISTAGE_CUT} "
             "iterations differ from the eager run's")
    log_err = float(np.abs(rows[:, keep] - erows[:, keep]).max())
    klat, elat = kern["solver"].lattice, eager["solver"].lattice
    say(f"  the first {MULTISTAGE_CUT} iterations on the kernels against "
        f"the eager f32 engine ({eager['wall_s']:.2f} s): Log columns "
        f"within {log_err:.3e}")
    fields = compare(klat.state.fields, elat.state.fields,
                     f"{xml.name}'s fields after {MULTISTAGE_CUT} against "
                     "the eager run's", GOLDEN_RTOL, GOLDEN_ATOL)
    same = torch.equal(klat.state.fields, elat.state.fields)
    say(f"  the kernels' fields after {MULTISTAGE_CUT} iterations are "
        f"{'bit for bit' if same else 'not bit for bit'} the eager f32 "
        "engine's")
    quantities = {q.name: compare(
        klat.get_quantity(q.name), elat.get_quantity(q.name),
        f"{xml.name}'s {q.name} after {MULTISTAGE_CUT}", GOLDEN_RTOL,
        GOLDEN_ATOL) for q in lat.model.quantities}
    nodes = float(np.prod(lat.shape))
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(ONESTAGE_WINDOW)
    lat.synchronize()
    dt = time.perf_counter() - t0
    out = {"engine": lat.engine_name, "wall_s": run["wall_s"],
           "launches": run["launches"], "flavours": run["flavours"],
           "mlups_end_to_end": nodes * niter / run["wall_s"] / 1e6,
           "mlups_iterate": nodes * ONESTAGE_WINDOW / dt / 1e6,
           "log_max_abs_err_vs_eager": log_err, "fields_vs_eager": fields,
           "fields_bit_identical_to_eager": same,
           "quantities_vs_eager": quantities,
           "eager_wall_s": eager["wall_s"], "physics": physics,
           "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end, "
        f"{out['mlups_iterate']:.1f} in an iterate({ONESTAGE_WINDOW}) "
        "window")
    return out


def multistage_physics(model, run, kern, eager, f64, lat) -> dict:
    """The reference's physics tests on the example: bubble_rise conserves
    its PhaseF sum (tests/test_pf.py:146) and its TotalDensity equals the
    sum of Rho over the MRT nodes (:148-150); mcmp_contact keeps both
    components' masses (tests/test_pp.py:106-107) and its TotalDensity1
    and TotalDensity2 equal their sums over the collision nodes
    (:111-113); drop_lee keeps its mass within 5e-3 with both phases
    present (tests/test_lee.py:80, :91)."""
    name = lat.model.name
    if name == "d2q9_pf_pressureEvolution":
        out = conserved_like_eager(kern, eager, f64, 1, PF_SUM_F64,
                                   "bubble_rise's PhaseF sum")
        out["totaldensity_gap"] = sums_match_globals(
            run, [(1, 2)], "bubble_rise's TotalDensity")
        out["run_drift"] = drifts(run)
        return out
    if name == "d2q9_pp_MCMP":
        out = conserved_like_eager(kern, eager, f64, 2, MCMP_MASS_F64,
                                   "mcmp_contact's component masses")
        out["totaldensity_gap"] = sums_match_globals(
            run, [(2, 4), (3, 5)], "mcmp_contact's TotalDensity1/2")
        out["run_drift"] = drifts(run, 2)
        return out
    mass = drifts(run)
    hi = max(v[1] for _, v in run["probes"][-1:])
    lo = min(v[2] for _, v in run["probes"][-1:])
    say(f"  drop_lee's mass drift at the Logs {mass} (limit "
        f"{LEE_MASS_RTOL}); rho in [{lo!r}, {hi!r}] at the end (the "
        f"liquid above {0.8 * LEE_RL}, the vapour below {2 * LEE_RV})")
    if not (max(r[0] for r in mass) <= LEE_MASS_RTOL and hi > 0.8 * LEE_RL
            and lo < 2 * LEE_RV):
        fail("drop_lee.xml: its mass or its two phases are not kept")
    return {"mass_drift": mass, "rho_max": hi, "rho_min": lo}


def mcmp_blob(gk) -> dict:
    """Phase 35b: tests/test_pp.py's immiscibility case (48x48, f dense in
    a disk, g outside, 1000 iterations) on the kernels in f32: the two
    components stay apart (each dominates its region threefold), the
    kernels' masses drift as the eager f32 engine's within CONSERVED_F32,
    and TotalDensity1/2 equal the sums over the collision nodes."""
    from tclb_tpu_torch import Lattice, get_model
    say("phase 35b: d2q9_pp_MCMP's immiscible blob on the kernels")
    m = get_model("d2q9_pp_MCMP")
    n = 48
    lats = []
    for _ in range(2):
        lat = Lattice(m, (n, n), dtype=torch.float32, device=DEVICE,
                      settings={"nu": 1 / 6, "nu_g": 1 / 6, "Gc": 1.8,
                                "Gad1": 0.0, "Gad2": 0.0, "Density": 1.0,
                                "Density_dry": 1.0})
        lat.set_flags(np.full((n, n), m.flag_for("BGK"), dtype=np.uint16))
        lat.init()
        y, x = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        disk = ((x - n / 2) ** 2 + (y - n / 2) ** 2) < (n / 4) ** 2
        f = lat.state.fields.cpu().numpy()
        lat.set_density_planes({
            **{f"f[{i}]": f[i] * np.where(disk, 1.0, 0.06)
               for i in range(9)},
            **{f"g[{i}]": f[9 + i] * np.where(disk, 0.06, 1.0)
               for i in range(9)}})
        lats.append(lat)
    kern, eager = lats
    mass0 = [float(kern.get_quantity(q).double().sum())
             for q in ("Rhof", "Rhog")]
    gk.reset_launches()
    kern.iterate(1000)
    kern.synchronize()
    launches = {k: v for k, v in gk.LAUNCHES.items() if v}
    eager.state = eager._iterate(eager.state, eager.params, 1000)
    rf, rg = (kern.get_quantity(q).double() for q in ("Rhof", "Rhog"))
    erf, erg = (eager.get_quantity(q).double() for q in ("Rhof", "Rhog"))
    d = torch.as_tensor(disk, device=DEVICE)
    apart = (float(rf[d].mean()) > 3 * float(rg[d].mean())
             and float(rg[~d].mean()) > 3 * float(rf[~d].mean()))
    drift = [abs(float(a.sum()) - m0) / m0 for a, m0 in zip((rf, rg), mass0)]
    edrift = [abs(float(a.sum()) - m0) / m0
              for a, m0 in zip((erf, erg), mass0)]
    gap = max(abs(a - b) for a, b in zip(drift, edrift))
    g = kern.get_globals()
    run = {"probes": [(1000, (g["TotalDensity1"], g["TotalDensity2"],
                              float(rf.sum()), float(rg.sum())))]}
    say(f"  engine {kern.engine_name}, launches {launches}; inside the "
        f"disk f {float(rf[d].mean()):.4f} g {float(rg[d].mean()):.4f}, "
        f"outside f {float(rf[~d].mean()):.4f} g {float(rg[~d].mean()):.4f}"
        f" (apart: {apart}); mass drift {drift}, eager f32 {edrift} (gap "
        f"{gap:.3e}, limit {CONSERVED_F32})")
    if not (apart and gap <= CONSERVED_F32 and launches
            and not kern.eager_steps):
        fail("mcmp blob: the components mix or their masses drift")
    tg = sums_match_globals(run, [(0, 2), (1, 3)], "the blob's "
                            "TotalDensity1/2")
    return {"engine": kern.engine_name, "launches": gk.LAUNCHES.copy(),
            "flavours": {k: gk.flavours(k) for k in ("generic2d_step",
                                                     "generic2d_step_bf16")},
            "apart": apart, "mass_drift": drift, "eager_mass_drift": edrift,
            "totaldensity_gap": tg}


def multistage_lattice(model: str, shape):
    """tests/test_pallas_generic.py's ``_paint`` on the card
    (``torch_cases.paint_generic``) with that file's ``_SETTINGS`` where it
    has the model, bubble_rise.xml's for d2q9_pf_pressureEvolution (its
    zone stripe a bubble: PhaseField-zbub) and the JAX package's physics
    test's for d2q9_poison_boltzmann (``MULTISTAGE_SETTINGS``),
    initialised.  The other zonal settings are the same in both zones, as
    the reference's ``_parity`` has them: MCMP's rich zone-1 velocities
    (``RICH_MULTISTAGE_ZONE1``) blow its painted lattice up within 100
    steps on every engine, eager f32 included.  MCMP's lattice keeps the
    W velocity face and not the E pressure face (mcmp_contact.xml has
    neither): with both, the two columns meet across the periodic edge
    and a 2000-step run goes non-finite on every engine."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import MULTISTAGE_SETTINGS, paint_generic
    m = get_model(model)
    lat = Lattice(m, shape, dtype=torch.float32, device=DEVICE,
                  settings=MULTISTAGE_SETTINGS[model])
    flags = paint_generic(m, *shape)
    if model == "d2q9_pp_MCMP":
        flags[1:-1, -1] = m.flag_for("BGK")
    lat.set_flags(flags)
    if model == "d2q9_pf_pressureEvolution":
        lat.set_setting("PhaseField", 0.5, zone=1)
    lat.init()
    return lat


def run_multistage(gk, errs: dict) -> dict:
    """Phases 35-38 for the multi-stage models: the three examples (35)
    and the MCMP blob (35b), each model's 1024x1024 lattice on K4 in f32
    and in bf16 shifted (36), K5 and its bf16 rung on each resident path
    (37: the example's, or poison_boltzmann's 128x128), d2q9_lee under a
    <Control> series of InletVelocity (38).  Returns the launches by
    kernel and path (and of the step kernels' globals flavour), the
    lattices phase 7 times and the summary."""
    from torch_cases import MULTISTAGE_EXAMPLES
    launches, glaunches, summary = {}, {}, {}
    band, res, res_steps = {}, {}, {}

    def count(into, key, path, n):
        if n:
            into.setdefault(key, {})[path] = into.get(key, {}).get(path,
                                                                    0) + n

    def record(model, path, run, kernels):
        for k in kernels:
            count(launches, f"{k}[{model}]", path, run["launches"][k])
        for k in ("generic2d_step", "generic2d_step_bf16"):
            count(glaunches, f"{k}[{model}]", path,
                  run["flavours"][k]["globals"])
        summary[path] = {k: v for k, v in run.items()
                         if k not in ("launches", "flavours")}

    for model in MULTISTAGE_MODELS:
        if model in MULTISTAGE_EXAMPLES:
            xml = ROOT / "example" / MULTISTAGE_EXAMPLES[model]
            run = run_multistage_example(gk, model)
            res[model] = run.pop("lattice")
            log = int(ET.parse(xml).getroot().find("Log").get("Iterations"))
            record(model, xml.stem, run, gk.KERNELS)
        else:
            say(f"phase 37: {model} at {PB_SMALL} (K5's path)")
            res[model] = multistage_lattice(model, PB_SMALL)
            log = PB_WINDOW
            run = iterate_window(gk, res[model], f"{model}128",
                                 f"cuda_generic_resident[{model},fuse=N]",
                                 log)
            record(model, f"{model}128", run, gk.KERNELS)
        res_steps[model] = (log - 1) // 2 * 2
    record("d2q9_pp_MCMP", "mcmp_blob", mcmp_blob(gk), gk.KERNELS)
    # K5 and its bf16 rung on each resident path's developed state
    for model in MULTISTAGE_MODELS:
        lat = res[model]
        resident_chain(gk, lat, 8, errs, f"phase 37, {model}'s resident "
                       "path")
        bf = bf16_copy(lat)
        bf16_chain(gk, bf, 8, errs, f"phase 37, {model} in bf16 shifted")
        res[f"{model} bf16"] = bf16_copy(lat)
        path = f"{model}_bf16_resident"
        record(model, path, iterate_window(
            gk, bf, f"{path} at {lat.shape}",
            f"cuda_generic_resident[{model},fuse=N,bfloat16/shifted]"),
            gk.BF16_KERNELS)
    # the full-width lattices on K4, f32 and bf16 shifted
    for model in MULTISTAGE_MODELS:
        say(f"phase 36: {model} at {MULTISTAGE_N}x{MULTISTAGE_N} on K4")
        what = f"phase 36, {model} {MULTISTAGE_N}x{MULTISTAGE_N}"
        lat = multistage_lattice(model, (MULTISTAGE_N, MULTISTAGE_N))
        eager_warm(lat, 4)
        check_kernels([(gk, lat, "generic2d_step")], errs, what)
        check_globals_flavour(gk, (lat,), errs, what)
        bf = bf16_copy(lat)
        check_bf16_kernels([(gk, bf, "generic2d_step")], errs, what)
        band[model], band[f"{model} bf16"] = lat, bf16_copy(lat)
        for tag, L, eng in (
                ("", lat, f"cuda_generic_band[{model},fuse=1]"),
                ("_bf16", bf,
                 f"cuda_generic_band[{model},fuse=1,bfloat16/shifted]")):
            path = f"{model}{MULTISTAGE_N}{tag}"
            record(model, path, iterate_window(gk, L, path, eng,
                                               MULTISTAGE_WINDOW),
                   [f"generic2d_step{tag}"])
        summary[f"{model}{MULTISTAGE_N}"]["bf16_over_f32"] = (
            summary[f"{model}{MULTISTAGE_N}_bf16"]["mlups_iterate"]
            / summary[f"{model}{MULTISTAGE_N}"]["mlups_iterate"])
    # a <Control> series on a three-stage model: the inlet of lee's 1024^2
    say("phase 38: d2q9_lee under a <Control> series of InletVelocity")
    model = "d2q9_lee"
    lee = multistage_lattice(model, (MULTISTAGE_N, MULTISTAGE_N))
    eager_warm(lee, 4)
    lee.set_setting_series("InletVelocity",
                           [0.01, 0.015, 0.02, 0.012, 0.008], zone=0)
    check_series_flavours(gk, (lee,), errs, "phase 38")
    record(model, "lee1024_series", iterate_window(
        gk, lee, "lee1024 under the series",
        f"cuda_generic_band[{model},fuse=1]"), gk.SERIES_KERNELS)
    res["lee series"] = lee
    return {"launches": launches, "globals_launches": glaunches,
            "summary": summary, "band": band, "resident": res,
            "res_steps": res_steps}


def time_passes(gk, lat, key: str, inputs, itemsize: int,
                reps: int = 100) -> list:
    """Each kernel a ``generic2d_step`` call (``key``) launches, on its
    own: its device time a call from a torch.profiler trace of ``reps``
    calls, against the step's bound (``launch_bytes``, at ``itemsize``
    bytes a value, and ``node_step_flops``: what the step must move and
    compute, whatever it recomputes).  A three-stage plan runs in one
    launch, the staged form (``generic2d_staged_kernel``).  ``ms`` is
    None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    say(f"phase 8: each launch of {key} at {lat.shape} (a torch.profiler "
        f"trace of {reps} calls)")
    m = lat.model
    fn = lambda: gk.step(*inputs)      # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {}
    for name, _, dur in device_events(prof):
        hit = re.search(r"(generic2d_\w+_kernel)", name)
        if hit:
            us[hit.group(1)] = us.get(hit.group(1), 0.0) + dur
    nbytes = gk.launch_bytes(m, lat.shape, itemsize=itemsize)
    flops = gk.node_step_flops(m, lat.flags_numpy())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    out = []
    for kernel, t in sorted(us.items()):
        ms = t / reps / 1e3 if t else None
        out.append({"kernel": kernel, "ms": ms, "bound_ms": bound,
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", "bytes": nbytes, "flops": flops,
                    "share_of_bound": bound / ms if ms else None})
        say(f"  {key} {kernel}: "
            + (f"{ms:.4f} ms a call" if ms else "not measured (no device "
               "time in the trace)")
            + f", the step's bound {bound:.4f} ms ({out[-1]['bound_by']}:"
            f" {nbytes} B, {flops} flop)")
    if not out:
        say(f"  {key}: not measured (no generic2d kernel in the trace)")
    return out


def time_multistage(gk, multi: dict) -> dict:
    """Phase 7 for the multi-stage models: K4 (both flavours) at
    1024x1024 in f32 and bf16, K5 on each resident path's state for the
    steps one of its launches takes there (at most
    K5_TIMING_STEPS), in f32 and bf16 (its plain
    version timed once, no warm-up call: the checks ran the same eager
    operations), the series flavours on lee's 1024x1024 lattice; the bound
    from ``launch_bytes`` (bf16 at 2 B a value) and ``node_step_flops``:
    what the step must move and compute, whatever the launches."""
    out = {}
    for model in MULTISTAGE_MODELS:
        for tag, lat in (("", multi["band"][model]),
                         ("_bf16", multi["band"][f"{model} bf16"])):
            f, flags, ztab, a = (bf16_inputs(gk, lat) if tag else
                                 gk.kernel_inputs(lat.model, lat.state,
                                                  lat.params))
            key = f"generic2d_step{tag}[{model}]"
            for k, fn, g, reps in ((key, gk.step, False, 200),
                                   (f"{key} globals", gk.step_globals,
                                    True, 100)):
                out[k] = time_one(
                    k, lambda fn=fn: fn(f, flags, ztab, a),
                    lambda g=g: gk.plain_steps(f, flags, ztab, a, 1,
                                               with_globals=g),
                    gk.launch_bytes(lat.model, lat.shape,
                                    itemsize=2 if tag else 4),
                    gk.node_step_flops(lat.model, lat.flags_numpy()),
                    lat.shape, reps, plain_reps=3)
            out[key]["launches_per_call"] = 1
        steps = min(multi["res_steps"][model], K5_TIMING_STEPS)
        for tag, lat in (("", multi["resident"][model]),
                         ("_bf16", multi["resident"][f"{model} bf16"])):
            f, flags, ztab, a = (bf16_inputs(gk, lat) if tag else
                                 gk.kernel_inputs(lat.model, lat.state,
                                                  lat.params))
            key = f"generic2d_resident{tag}[{model}]"
            out[key] = time_one(
                f"{key} ({steps} steps)",
                lambda: gk.resident(f, flags, ztab, a, steps),
                lambda: gk.plain_steps(f, flags, ztab, a, steps),
                gk.launch_bytes(lat.model, lat.shape,
                                itemsize=2 if tag else 4),
                steps * gk.node_step_flops(lat.model, lat.flags_numpy()),
                lat.shape, 20, plain_reps=1, plain_warm=0)
            out[key]["steps"] = steps
    series = time_series_flavours(gk, multi["resident"]["lee series"], 200)
    for t in series.values():
        t["launches_per_call"] = 1
    out.update(series)
    return out


# --------------------------------------------------------------------------- #
# The 2D adjoint models on K4/K5 and K7 (phases 39-43)
# --------------------------------------------------------------------------- #

ADJ_MODELS = ("d2q9_adj", "d2q9_optimalMixing", "d2q9_plate")
ADJ_DRAG_XML = ROOT / "example" / "adj_drag.xml"
ADJ_N = 1024                 # the full-width lattices
ADJ_SMALL = (128, 128)       # K5's path for the models without an example
ADJ_SMALL_WINDOW = 200       # its iterate window
ADJ_SENSITIVITY = 200        # the sensitivity path's horizon


def adj_lattice(model: str, shape):
    """``onestage_lattice``'s painting with the model's flow settings
    (``ADJ_SETTINGS``) and zone 1's own zonal values."""
    from torch_cases import ADJ_SETTINGS, RICH_ADJ_ZONE1
    return onestage_lattice(model, shape, settings=ADJ_SETTINGS[model],
                            zone1=RICH_ADJ_ZONE1)


def adj_bench_lattice():
    """bench.py's ``bench_adjoint`` case (bench.py:335-397): d2q9_adj at
    512x1024, a W velocity inlet, an E pressure outlet, walls top and
    bottom and the design block [128:384, 300:700], with its settings."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import adj_channel
    return adj_channel(Lattice, get_model("d2q9_adj"), torch.float32,
                       shape=(512, 1024),
                       design=(slice(128, 384), slice(300, 700)),
                       device=DEVICE)


def rich_adj_lattice(model: str, shape, seed: int = 5):
    """``generic2d_parity.paint``'s rich state: every node type the
    header reads, zone 1 with other zonal values than zone 0, 1% noise."""
    from tclb_tpu_torch import get_model
    from tclb_tpu_torch.ops import generic2d_parity
    from torch_cases import RICH_ADJ_SETTINGS, RICH_ADJ_ZONE1
    m = get_model(model)
    return generic2d_parity.paint(
        m, shape, seed=seed, device=DEVICE,
        settings=RICH_ADJ_SETTINGS[model],
        zone1={n: RICH_ADJ_ZONE1[n] for n in m.zonal_settings})


def sensitivity_fn(lat, niter: int, step, levels: int):
    """``fn() -> (objective, d obj / d fields, d obj / d settings)`` of
    ``niter`` steps from ``lat``'s state (``make_objective_run``): on the
    kernel step ``step`` (``adjoint_kernels.make_diff_step``), or eager for
    None."""
    import dataclasses
    from tclb_tpu_torch.adjoint import make_objective_run
    run = make_objective_run(lat.model, niter, levels=levels, step=step)

    def fn():
        f0 = lat.state.fields.detach().clone().requires_grad_()
        sett = lat.params.settings.detach().clone().requires_grad_()
        with torch.enable_grad():
            obj, _ = run(dataclasses.replace(lat.state, fields=f0),
                         dataclasses.replace(lat.params, settings=sett))
            gf, gs = torch.autograd.grad(obj, (f0, sett))
        return obj.detach(), gf, gs
    return fn


def run_sensitivity(gk, ak, lat, path: str) -> dict:
    """Phase 41b: the sensitivity of a model's objective to the initial
    populations and the settings on the kernel step, (a) over 8 steps
    against eager autograd on the card (the fields at rtol 1e-4 and an
    absolute 1e-6 of the largest, the settings within 1e-4 of the
    largest), (b) over ``ADJ_SENSITIVITY`` steps with automatic checkpoint
    levels, counted from 0."""
    from tclb_tpu_torch.adjoint import auto_levels
    m = lat.model
    say(f"phase 41b: {path}: the objective's sensitivity on cuda_adjoint")
    step = ak.make_diff_step(m, lat.shape)
    (oc, gc, sc), (oe, ge, se) = (sensitivity_fn(lat, 8, st, 1)()
                                  for st in (step, None))
    torch.cuda.synchronize()
    err = (gc - ge).abs()
    serr = float((sc - se).abs().max())
    gmax = float(ge.abs().max())
    ok = bool((err <= SENS_ATOL_REL * gmax + GRAD_RTOL * ge.abs()).all()) \
        and gmax > 0 and serr <= GRAD_RTOL * float(se.abs().max())
    say(f"  (a) 8 steps: {step.engine_name} objective {float(oc):.9g}, eager "
        f"{float(oe):.9g}; fields max abs err {float(err.max()):.3e} "
        f"(max |g| {gmax:.3e}), settings max abs err "
        f"{serr:.3e} (max {float(se.abs().max()):.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{path}: the 8-step kernel sensitivity disagrees with eager")
    levels = auto_levels(m, lat.shape, ADJ_SENSITIVITY)
    fn = sensitivity_fn(lat, ADJ_SENSITIVITY, step, levels)
    torch.cuda.synchronize()
    gk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    obj, g, gs = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**gk.LAUNCHES, **ak.LAUNCHES}
    flavours = {k: gk.flavours(k) for k in ("generic2d_step",
                                            "generic2d_step_bf16")}
    say(f"  (b) {ADJ_SENSITIVITY} steps, levels {levels}: {wall:.3f} s wall, "
        f"launches { {k: v for k, v in launches.items() if v} }, objective "
        f"{float(obj):.9g}")
    if not (math.isfinite(float(obj)) and bool(torch.isfinite(g).all())
            and bool(torch.isfinite(gs).all())):
        fail(f"{path}: the {ADJ_SENSITIVITY}-step sensitivity is not finite")
    return {"launches": launches, "flavours": flavours,
            "grad8_max_abs_err": float(err.max()),
            "settings8_max_abs_err": serr, "levels": levels, "wall_s": wall}


def run_adj_models(gk, ak, errs: dict) -> dict:
    """Phases 39-43 for the three adjoint models: example/adj_drag.xml
    whole (39), bench.py's d2q9_adj gradient at 512x1024 (40), each
    model's 1024x1024 lattice on K4 in f32 and bf16 shifted (41) and the
    sensitivity of d2q9_optimalMixing's and d2q9_plate's objectives on
    cuda_adjoint (41b), K5 and its bf16 rung (42: adj_drag's state, or a
    128x128 lattice), generic2d_step_b and the series flavours on rich
    states, and d2q9_adj's 1024x1024 lattice under a Velocity series
    (43).  Returns the launches by kernel and path (and of the step
    kernels' globals flavour), the lattices phase 7 times and the
    summary."""
    launches, glaunches, summary = {}, {}, {}
    band, res, res_steps, lats_b = {}, {}, {}, {}

    def count(into, key, path, n):
        if n:
            into.setdefault(key, {})[path] = into.get(key, {}).get(path,
                                                                    0) + n

    def record(model, path, run, kernels):
        for k in kernels:
            count(launches, f"{k}[{model}]", path, run["launches"][k])
        # generic2d_step's flavours, or each step kernel's
        fl = run["flavours"]
        if "globals" in fl:
            fl = {"generic2d_step": fl}
        for k in ("generic2d_step", "generic2d_step_bf16"):
            count(glaunches, f"{k}[{model}]", path,
                  fl.get(k, {}).get("globals", 0))
        summary[path] = {k: v for k, v in run.items()
                         if k not in ("launches", "flavours", "lattice",
                                      "grad_fn", "grad_launches",
                                      "grad_flavours")}

    adjoint = gk.KERNELS + ("generic2d_step_b",)
    # phase 39: adj_drag.xml unchanged; its Optimize starts from Init
    start = case_lattice(ADJ_DRAG_XML, torch.float32, DEVICE,
                         drop=("FDTest", "Optimize", "ThresholdNow",
                               "Solve"))
    run = run_design_xml(gk, ak, ADJ_DRAG_XML, "39", start)
    res["d2q9_adj"] = run["lattice"]
    solve = int(ET.parse(ADJ_DRAG_XML).getroot().find("Solve")
                .get("Iterations"))
    res_steps["d2q9_adj"] = (solve - 1) // 2 * 2
    record("d2q9_adj", "adj_drag", run, adjoint)
    # phase 40: bench.py's gradient case
    bench = adj_bench_lattice()
    run = run_gradient_channel(gk, ak, bench, "40", from_start=True)
    lats_b["d2q9_adj"] = bench
    record("d2q9_adj", "adj_bench", run, gk.KERNELS)
    record("d2q9_adj", "adj_bench_gradient",
           {"launches": run["grad_launches"],
            "flavours": run["grad_flavours"]}, adjoint)
    grad_fn = run["grad_fn"]
    # phase 41: the full-width lattices on K4, f32 and bf16 shifted
    for model in ADJ_MODELS:
        say(f"phase 41: {model} at {ADJ_N}x{ADJ_N} on K4")
        what = f"phase 41, {model} {ADJ_N}x{ADJ_N}"
        lat = adj_lattice(model, (ADJ_N, ADJ_N))
        eager_warm(lat, 4)
        check_kernels([(gk, lat, "generic2d_step")], errs, what)
        check_globals_flavour(gk, (lat,), errs, what)
        bf = bf16_copy(lat)
        check_bf16_kernels([(gk, bf, "generic2d_step")], errs, what)
        band[model], band[f"{model} bf16"] = lat, bf16_copy(lat)
        for tag, L, eng in (
                ("", lat, f"cuda_generic_band[{model},fuse=1]"),
                ("_bf16", bf,
                 f"cuda_generic_band[{model},fuse=1,bfloat16/shifted]")):
            path = f"{model}{ADJ_N}{tag}"
            record(model, path, iterate_window(gk, L, path, eng),
                   [f"generic2d_step{tag}"])
        summary[f"{model}{ADJ_N}"]["bf16_over_f32"] = (
            summary[f"{model}{ADJ_N}_bf16"]["mlups_iterate"]
            / summary[f"{model}{ADJ_N}"]["mlups_iterate"])
        if model != "d2q9_adj":
            lats_b[model] = band[model]
            path = f"{model}{ADJ_N}_sensitivity"
            record(model, path, run_sensitivity(gk, ak, band[model], path),
                   adjoint)
    # phase 42: K5 and its bf16 rung on each resident path
    for model in ADJ_MODELS:
        if model not in res:
            say(f"phase 42: {model} at {ADJ_SMALL} (K5's path)")
            res[model] = adj_lattice(model, ADJ_SMALL)
            res_steps[model] = (ADJ_SMALL_WINDOW - 1) // 2 * 2
            record(model, f"{model}128", iterate_window(
                gk, res[model], f"{model}128",
                f"cuda_generic_resident[{model},fuse=N]", ADJ_SMALL_WINDOW),
                gk.KERNELS)
        lat = res[model]
        resident_chain(gk, lat, 8, errs, f"phase 42, {model}'s resident "
                       "path")
        bf = bf16_copy(lat)
        bf16_chain(gk, bf, 8, errs, f"phase 42, {model} in bf16 shifted")
        res[f"{model} bf16"] = bf16_copy(lat)
        path = f"{model}_bf16_resident"
        record(model, path, iterate_window(
            gk, bf, f"{path} at {lat.shape}",
            f"cuda_generic_resident[{model},fuse=N,bfloat16/shifted]",
            ADJ_SMALL_WINDOW), gk.BF16_KERNELS)
    # phase 43: K7 and the series flavours on rich states (every node type,
    # two zones with other zonal values), then d2q9_adj under a series
    from torch_cases import ADJ_SERIES
    for model in ADJ_MODELS:
        rich = [rich_adj_lattice(model, shape) for shape in ((37, 53),
                                                             (256, 256))]
        check_step_b(ak, gk, rich, errs, f"phase 43, {model}")
        setting, values = ADJ_SERIES[model]
        for lat in rich:
            lat.set_setting_series(setting, values, zone=0)
        check_series_flavours(gk, rich, errs, f"phase 43, {model}")
    say("phase 43: d2q9_adj at 1024x1024 under a <Control> series of "
        "Velocity")
    ser = adj_lattice("d2q9_adj", (ADJ_N, ADJ_N))
    eager_warm(ser, 4)
    ser.set_setting_series(*ADJ_SERIES["d2q9_adj"], zone=0)
    check_series_flavours(gk, (ser,), errs, "phase 43, adj1024_series")
    record("d2q9_adj", "adj1024_series", iterate_window(
        gk, ser, "adj1024_series", "cuda_generic_band[d2q9_adj,fuse=1]",
        500), gk.SERIES_KERNELS)
    res["adj series"] = ser
    return {"launches": launches, "globals_launches": glaunches,
            "summary": summary, "band": band, "resident": res,
            "res_steps": res_steps, "step_b": lats_b, "grad_fn": grad_fn}


def time_adj(gk, ak, adj: dict) -> dict:
    """Phase 7 for the adjoint models: K4 (both flavours) at 1024x1024 in
    f32 and bf16, K5 on each resident path's state for the steps one of
    its launches takes there (at most
    K5_TIMING_STEPS), in f32 and bf16 (the plain version timed
    once), generic2d_step_b at its gradient path's shape (d2q9_adj's
    512x1024, the others' 1024x1024) and d2q9_adj's series flavours at
    1024x1024."""
    out = {}
    for model in ADJ_MODELS:
        for tag, lat in (("", adj["band"][model]),
                         ("_bf16", adj["band"][f"{model} bf16"])):
            f, flags, ztab, a = (bf16_inputs(gk, lat) if tag else
                                 gk.kernel_inputs(lat.model, lat.state,
                                                  lat.params))
            key = f"generic2d_step{tag}[{model}]"
            for k, fn, g, reps in ((key, gk.step, False, 200),
                                   (f"{key} globals", gk.step_globals,
                                    True, 100)):
                out[k] = time_one(
                    k, lambda fn=fn: fn(f, flags, ztab, a),
                    lambda g=g: gk.plain_steps(f, flags, ztab, a, 1,
                                               with_globals=g),
                    gk.launch_bytes(lat.model, lat.shape,
                                    itemsize=2 if tag else 4),
                    gk.node_step_flops(lat.model, lat.flags_numpy()),
                    lat.shape, reps, plain_reps=3)
        steps = min(adj["res_steps"][model], K5_TIMING_STEPS)
        for tag, lat in (("", adj["resident"][model]),
                         ("_bf16", adj["resident"][f"{model} bf16"])):
            f, flags, ztab, a = (bf16_inputs(gk, lat) if tag else
                                 gk.kernel_inputs(lat.model, lat.state,
                                                  lat.params))
            key = f"generic2d_resident{tag}[{model}]"
            out[key] = time_one(
                f"{key} ({steps} steps)",
                lambda: gk.resident(f, flags, ztab, a, steps),
                lambda: gk.plain_steps(f, flags, ztab, a, steps),
                gk.launch_bytes(lat.model, lat.shape,
                                itemsize=2 if tag else 4),
                steps * gk.node_step_flops(lat.model, lat.flags_numpy()),
                lat.shape, 20, plain_reps=1, plain_warm=0)
            out[key]["steps"] = steps
        out.update(time_step_b(ak, gk, adj["step_b"][model], plain_reps=3))
    out.update(time_series_flavours(gk, adj["resident"]["adj series"], 400))
    return out


# --------------------------------------------------------------------------- #
# The 3D models of the generic engine on K6 (phases 44-48)
# --------------------------------------------------------------------------- #

GENERIC3D = ("d3q19_heat", "d3q27", "d3q27_viscoplastic",
             "d3q27_cumulant_qibb_small", "d3q19_kuper")
HEAT_BENCH_STEPS = 4000      # bench.py:631's iterations of bench_d3q27
HEAT_EAGER_CUT = 200         # the heat case's first steps held to eager f32
G3_WINDOW = 2000             # each model's iterate window at 48x48x256
G3_RICH = ((8, 16, 32), (24, 48, 128))
# the inlet and outlet faces each model's 48x48x256 lattice gets, and the
# inlet velocity where its settings name none
G3_FACES = {"d3q19_heat": ("WVelocity", "EPressure"),
            "d3q27": ("WVelocity", "EPressure"),
            "d3q27_viscoplastic": ("WVelocity_ZouHe", "EPressure_ZouHe"),
            "d3q27_cumulant_qibb_small": ("WVelocity", "EPressure")}
G3_INFLOW = 0.02
# the f32 kernels against f64 eager on a forced channel: the margin the port
# holds d3q27_BGK's f32 Poiseuille to (ROADMAP queue 3)
F32_FORCED_REL = 2.7e-3
# the physics cases' f64 (and f32) eager horizon on the card: the eager
# engine is launch-bound on these 192- and 864-node lattices (some 10-17 ms
# a step), so both references over the cases' 32,000 steps would take
# about 15 minutes; they cover each case's first PHYS_F64_CUT steps, the
# kernels run each case in full
PHYS_F64_CUT = 500
# the reference's steps: tests/test_viscoplastic.py's Newtonian channel,
# Bingham plug and Zou/He duct, tests/test_qibb.py's channels
VP_STEPS = {"newtonian": 4000, "bingham": 8000, "duct": 2000}
QIBB_STEPS = 6000
KUPER_DROP_N, KUPER_DROP_STEPS, KUPER_DROP_CUT = 64, 2000, 100
KUPER_MASS_RTOL = 1e-4       # drop.xml's limit (check_drop)
KUPER_LIQUID, KUPER_VAPOUR = 3.2600529440452366, 0.014500641645077492
# drop.xml's MagicF (-2/3) halved: d3q19's shell weights 18 w_i give each
# axis twice d2q9's sum of g_i e_i^2 (6 against 3), so the same force
# needs half the factor; at -2/3 the 3D drop's interface drives |u| to 0.9
# in one step and the run goes non-finite within six (eager f32, the CPU)
KUPER_DROP_MAGICF = -1 / 3


def g3_key(model: str) -> str:
    return f"generic3d_step[{model}]"


def g3_engine(model: str) -> str:
    return f"cuda_generic3d_band[{model},fuse=1]"


def heat_bench_lattice():
    """bench.py's d3q19_heat case (bench.py:664-677): 48x48x256, MRT
    everywhere, Wall rows at y = 0 and y = ny - 1, periodic in x and z."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d3q19_heat")
    lat = Lattice(m, CHANNEL48, dtype=torch.float32, device=DEVICE,
                  settings={"nu": 0.05, "Velocity": 0.02,
                            "FluidAlfa": 0.05})
    flags = np.full(CHANNEL48, m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def sphere_cuts(m, shape, center, radius):
    """A solid sphere for d3q27_cumulant_qibb_small: its cut distances
    (``utils.geometry.cuts_from_sdf``) and the flags' masks of the nodes
    inside (Solid) and of the fluid nodes with a cut link (QIBB)."""
    from tclb_tpu_torch.models.d3q27_cumulant_qibb import E
    from tclb_tpu_torch.utils.geometry import cuts_from_sdf, sphere_sdf
    sdf = sphere_sdf(center, radius)
    cuts = cuts_from_sdf(sdf, shape, E)
    grids = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64)
                                   for s in shape], indexing="ij"))
    return cuts, sdf(grids) <= 0.0, (cuts >= 0).any(axis=0)


def generic3d_lattice(model: str, shape=None):
    """tests/test_pallas_generic.py's ``_parity_3d`` at ``shape``: the
    collision type with Wall rows at y = 0 and y = ny - 1, its
    ``_3D_SETTINGS`` where it names the model; an inlet (velocity
    ``G3_INFLOW``) and an outlet face where the model has them
    (``G3_FACES``); for d3q27_cumulant_qibb_small a sphere of radius nz/4
    at (nz/2, ny/2, nx/4) with its cut distances (QIBB nodes around it,
    Solid inside).  Initialised."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import GENERIC3D_SETTINGS, parity3d_flags
    m = get_model(model)
    shape = shape or CHANNEL48
    settings = dict(GENERIC3D_SETTINGS[model])
    if model in G3_FACES:
        settings.setdefault("Velocity", G3_INFLOW)
    lat = Lattice(m, shape, dtype=torch.float32, device=DEVICE,
                  settings=settings)
    flags = parity3d_flags(m, shape)
    coll = "MRT" if "MRT" in m.node_types else "BGK"
    if model in G3_FACES:
        w, e = G3_FACES[model]
        flags[:, 1:-1, 0] = m.flag_for(w, coll)
        flags[:, 1:-1, -1] = m.flag_for(e, coll)
    cuts = None
    if "q" in m.groups:
        nz, ny, nx = shape
        cuts, solid, qibb = sphere_cuts(m, shape, (nz / 2, ny / 2, nx / 4),
                                        nz / 4)
        flags[qibb] = m.flag_for("QIBB", coll)
        flags[solid] = m.flag_for("Solid")
    lat.set_flags(flags)
    lat.init()
    if cuts is not None:
        lat.set_density_planes({f"q[{i + 1}]": cuts[i] for i in range(26)})
    return lat


def iterate_window3(g3, lat, what: str, engine: str, n: int) -> dict:
    """An ``iterate(n)`` on the card from K6's counts set to 0, fenced by
    synchronize: its engine, launches and flavours, no eager step, finite
    fields, MLUPS."""
    lat.synchronize()
    g3.reset_launches()
    eager0 = lat.eager_steps
    t0 = time.perf_counter()
    lat.iterate(n)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches, flav = dict(g3.LAUNCHES), g3.flavours()
    mlups = float(np.prod(lat.shape)) * n / dt / 1e6
    say(f"  {what}: engine {lat.engine_name}, launches {launches} "
        f"{flav}, {mlups:.1f} MLUPS ({dt * 1e3:.2f} ms)")
    if lat.engine_name != engine or lat.eager_steps != eager0:
        fail(f"{what} ran on {lat.engine_name} "
             f"({lat.eager_steps - eager0} eager steps)")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{what}: non-finite fields")
    return {"launches": launches, "flavours": flav, "mlups_iterate": mlups,
            "iterate_ms": dt * 1e3, "window": n}


def bit_identical(g3, lat) -> dict:
    """Whether both flavours of ``generic3d_step`` are bit for bit their
    plain versions on the lattice's state."""
    f, flags, ztab, a = g3.kernel_inputs(lat.model, lat.state, lat.params)
    got = g3.step(f, flags, ztab, a)
    gotg, g = g3.step_globals(f, flags, ztab, a)
    want, wg = g3.plain_steps(f, flags, ztab, a, 1, with_globals=True)
    torch.cuda.synchronize()
    return {"step": bool(torch.equal(got, want)),
            "globals_flavour_fields": bool(torch.equal(gotg, want)),
            "globals": bool(torch.equal(g, wg))}


def run_heat_bench(g3, errs: dict, beside: dict) -> dict:
    """Phase 44: bench.py's d3q19_heat case (``bench_d3q27``'s third
    lattice) on ``cuda_generic3d_band[d3q19_heat,fuse=1]``: both
    flavours of ``generic3d_step`` against their plain versions on its
    state, its first ``HEAT_EAGER_CUT`` steps on the kernels against eager
    f32 on the card (fields and globals at rtol 1e-4 / atol 1e-6), then
    ``iterate(HEAT_BENCH_STEPS)`` from Init, counted from 0: the MLUPS and
    the GB/s by bench.py's own count (``2 n_storage 4 + 2`` B a node),
    beside ``beside``'s figures of this run (the 48x48x256 d3q27_cumulant
    and d3q19 channels)."""
    say("phase 44: bench.py's d3q19_heat case, 48x48x256 on K6")
    lat = heat_bench_lattice()
    eager_warm(lat, 4)
    check_kernels([(g3, lat, "generic3d_step")], errs,
                  "phase 44, the d3q19_heat case")
    check_globals_flavour(g3, (lat,), errs, "phase 44")
    kern, ref = heat_bench_lattice(), heat_bench_lattice()
    kern.iterate(HEAT_EAGER_CUT)
    eager_warm(ref, HEAT_EAGER_CUT)
    if kern.engine_name != g3_engine("d3q19_heat"):
        fail(f"the d3q19_heat case ran on {kern.engine_name}")
    cut = compare(kern.state.fields, ref.state.fields,
                  f"the d3q19_heat case after {HEAT_EAGER_CUT} steps, "
                  "kernels vs eager f32", GOLDEN_RTOL, GOLDEN_ATOL)
    gcut = compare_globals(kern.state.globals_, ref.state.globals_,
                           f"of the d3q19_heat case after {HEAT_EAGER_CUT} "
                           "steps, kernels vs eager f32")
    bench = heat_bench_lattice()
    run = iterate_window3(g3, bench, f"iterate({HEAT_BENCH_STEPS}) of the "
                          "d3q19_heat case", g3_engine("d3q19_heat"),
                          HEAT_BENCH_STEPS)
    per_node = 2 * bench.model.n_storage * 4 + 2
    run["gbps_bench_count"] = run["mlups_iterate"] * per_node / 1e3
    run["bench_bytes_per_node"] = per_node
    run["beside_mlups"] = beside
    say(f"  d3q19_heat {run['mlups_iterate']:.1f} MLUPS, "
        f"{run['gbps_bench_count']:.1f} GB/s by bench.py's count "
        f"({per_node} B a node); beside it in this run: "
        + ", ".join(f"{k} {v:.1f} MLUPS" for k, v in beside.items()))
    run.update({"vs_eager_f32": cut, "globals_vs_eager_f32": gcut,
                "lattice": bench})
    return run


def run_generic3d_models(g3, errs: dict) -> dict:
    """Phases 45-46: each model's 48x48x256 lattice (``generic3d_lattice``)
    on K6: both flavours against their plain versions after 4 eager steps,
    ``iterate(G3_WINDOW)`` counted from 0 (MLUPS), the card's idle share
    over an ``iterate(200)`` (a torch.profiler trace), and the kernel on
    the developed state (45); on rich states (``torch_cases.
    paint_rich_generic3d``: every node type the header reads, zone 1 with
    its own zonal values, noise, qibb's cuts from a sphere, kuper's phi not
    constant; at ``G3_RICH``) both flavours and both series flavours (a
    series of the model's first zonal setting on zone 1) against their
    plain versions, and whether each is bit for bit its plain version
    (46)."""
    from tclb_tpu_torch import Lattice, get_model
    from tclb_tpu_torch.ops import generic_kernels as gk
    from torch_cases import RICH_GENERIC3D_SETTINGS, paint_rich_generic3d
    launches, glaunches, summary, lats = {}, {}, {}, {}
    for model in GENERIC3D:
        say(f"phase 45: {model} at 48x48x256 on K6")
        what = f"phase 45, {model} 48x48x256"
        lat = generic3d_lattice(model)
        eager_warm(lat, 4)
        check_kernels([(g3, lat, "generic3d_step")], errs, what)
        check_globals_flavour(g3, (lat,), errs, what)
        run = iterate_window3(g3, lat, f"{model}48 iterate({G3_WINDOW})",
                              g3_engine(model), G3_WINDOW)
        busy = device_busy(lambda lat=lat: lat.iterate(200),
                           f"a 48x48x256 {model} iterate(200)")
        check_kernels([(g3, lat, "generic3d_step")], errs,
                      f"{what} after {G3_WINDOW} iterations")
        key = g3_key(model)
        launches.setdefault(key, {})[f"{model}48"] = \
            run["launches"]["generic3d_step"]
        glaunches.setdefault(key, {})[f"{model}48"] = \
            run["flavours"]["globals"]
        run.pop("launches")
        summary[f"{model}48"] = {**run, "idle_share": busy["idle_share"],
                                 "iterate_profile": busy}
        lats[model] = lat
    for model in GENERIC3D:
        m = get_model(model)
        bits = {}
        for shape in G3_RICH:
            what = f"phase 46, {model} rich {shape}"
            lat = paint_rich_generic3d(
                Lattice(m, shape, dtype=torch.float32, device=DEVICE,
                        settings=RICH_GENERIC3D_SETTINGS[model]),
                gk.DEVICE_MODELS[model].node_types, 5)
            check_kernels([(g3, lat, "generic3d_step")], errs, what)
            check_globals_flavour(g3, (lat,), errs, what)
            bits[str(shape)] = bit_identical(g3, lat)
            name = m.zonal_settings[0]
            v = float(lat.params.zone_table[m.setting_index[name], 1])
            lat.set_setting_series(name, [v * (1 + 0.05 * k)
                                          for k in range(5)], zone=1)
            check_series_flavours(g3, (lat,), errs, what)
        summary[f"{model}_bit_identical"] = bits
        say(f"  {model}: bit for bit its plain version: {bits}")
    return {"launches": launches, "globals_launches": glaunches,
            "summary": summary, "lattices": lats}


def channel_profile(lat) -> torch.Tensor:
    """The x velocity across the channel (y) at z = nz // 2, x = nx // 2,
    in f64 on the host."""
    nz, _, nx = lat.shape
    return lat.get_quantity("U")[0][nz // 2, :, nx // 2].double().cpu()


def eager_case(make, dtype, steps: int):
    """The case ``make(dtype)`` run ``steps`` steps on the eager engine on
    the card (``TCLB_FASTPATH=0`` while it is built and run)."""
    before = os.environ.get("TCLB_FASTPATH")
    os.environ["TCLB_FASTPATH"] = "0"
    try:
        lat = make(dtype)
        lat.iterate(steps)
        lat.synchronize()
    finally:
        if before is None:
            del os.environ["TCLB_FASTPATH"]
        else:
            os.environ["TCLB_FASTPATH"] = before
    if lat.engine_name != "eager":
        fail(f"an eager reference ran on {lat.engine_name}")
    return lat


def f64_against(lat32, make, cut: int, profile, what: str) -> dict:
    """The case ``make(dtype)`` for ``cut`` steps on the eager engine on the
    card in f64 and in f32 against ``lat32`` (the f32 kernels at the same
    step): ``profile``'s relative L2 distance from f64, within the port's
    f32 margin for a forced channel: ``F32_FORCED_REL``, or twice the f32
    eager engine's own distance where that is farther (phase 22's rule;
    2.7e-3 is twice d3q27_BGK's f32 eager Poiseuille distance there)."""
    want = profile(eager_case(make, torch.float64, cut))
    got = profile(lat32)
    rel = float((got - want).norm() / want.norm())
    rel32 = float((profile(eager_case(make, torch.float32, cut)) - want)
                  .norm() / want.norm())
    limit = max(F32_FORCED_REL, 2 * rel32)
    say(f"  {what}: f32 kernels vs f64 eager after {cut} steps, relative "
        f"L2 {rel:.3e} (f32 eager {rel32:.3e}; limit {limit:.3e})")
    if not rel <= limit:
        fail(f"{what}: the f32 kernels are {rel} from f64")
    return {"steps": cut, "rel_l2": rel, "f32_eager_rel_l2": rel32,
            "limit": limit}


def run_case3(g3, make, niter: int, cut: int, profile, what: str,
              model: str) -> tuple:
    """One physics case on K6 in f32: ``cut`` steps, the f64 eager
    comparison there, then the rest to ``niter``; returns the lattice, the
    comparison and the case's launches and globals launches (counted
    from 0)."""
    lat = make(torch.float32)
    lat.synchronize()
    g3.reset_launches()
    lat.iterate(cut)
    vs64 = f64_against(lat, make, cut, profile, what)
    lat.iterate(niter - cut)
    lat.synchronize()
    launches = (g3.LAUNCHES["generic3d_step"], g3.flavours()["globals"])
    if lat.engine_name != g3_engine(model):
        fail(f"{what} ran on {lat.engine_name}")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{what}: non-finite fields")
    return lat, vs64, launches


def vp_channel(yield_stress: float, ny: int = 19, g: float = 1e-5):
    """tests/test_viscoplastic.py:_channel: a 3xNYx4 force-driven channel,
    walls on y, nu 1/6, ForceX ``g``, the yield stress."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d3q27_viscoplastic")

    def make(dtype):
        lat = Lattice(m, (3, ny, 4), dtype=dtype, device=DEVICE,
                      settings={"nu": 1 / 6, "ForceX": g,
                                "YieldStress": yield_stress})
        flags = np.full((3, ny, 4), m.flag_for("MRT"), dtype=np.uint16)
        flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Wall")
        lat.set_flags(flags)
        lat.init()
        return lat
    return make


def vp_duct(dtype):
    """tests/test_viscoplastic.py:test_zou_he_inlet_outlet's 3x12x24 duct:
    a WVelocity_ZouHe inlet at 0.02, an EPressure_ZouHe outlet, walls."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d3q27_viscoplastic")
    shape = (3, 12, 24)
    lat = Lattice(m, shape, dtype=dtype, device=DEVICE,
                  settings={"nu": 1 / 6, "Velocity": 0.02})
    flags = np.full(shape, m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Wall")
    flags[:, 1:-1, 0] = m.flag_for("WVelocity_ZouHe", "MRT")
    flags[:, 1:-1, -1] = m.flag_for("EPressure_ZouHe", "MRT")
    lat.set_flags(flags)
    lat.init()
    return lat


def qibb_channel(delta, ny: int = 16, g: float = 1e-6):
    """tests/test_qibb.py:_qibb_channel: a 3xNYx4 force-driven channel
    whose walls sit at y = 1 - delta and y = ny - 2 + delta (Solid rows 0
    and ny - 1, QIBB rows 1 and ny - 2 with their cut distances); with
    ``delta`` None the same channel with plain bounce-back on the Solid
    rows (test_qibb_beats_plain_bounceback)."""
    from tclb_tpu_torch import Lattice, get_model
    from tclb_tpu_torch.models.d3q27_cumulant_qibb import E
    from tclb_tpu_torch.utils.geometry import cuts_from_sdf
    m = get_model("d3q27_cumulant_qibb_small")
    shape = (3, ny, 4)

    def make(dtype):
        lat = Lattice(m, shape, dtype=dtype, device=DEVICE,
                      settings={"nu": 1 / 6, "ForceY": 0.0, "ForceX": g})
        flags = np.full(shape, m.flag_for("MRT"), dtype=np.uint16)
        flags[:, 0, :] = flags[:, -1, :] = m.flag_for("Solid")
        if delta is not None:
            flags[:, 1, :] = flags[:, -2, :] = m.flag_for("QIBB", "MRT")
        lat.set_flags(flags)
        lat.init()
        if delta is not None:
            y_w0, y_w1 = 1.0 - delta, ny - 2.0 + delta
            cuts = cuts_from_sdf(
                lambda c: np.minimum(c[1] - y_w0, y_w1 - c[1]), shape, E)
            lat.set_density_planes({f"q[{i}]": cuts[i - 1]
                                    for i in range(1, 27)})
        return lat
    return make


def run_generic3d_physics(g3) -> dict:
    """Phase 47: the reference's physics checks on K6 in f32, each at its
    size and steps, its first ``PHYS_F64_CUT`` steps held against the same
    case on the f64 eager engine on the card (relative L2 of the profile,
    or of U for the duct, within the port's f32 margin: ``f64_against``)
    and each fit the
    reference's test asserts (tests/test_viscoplastic.py: the Newtonian
    limit within 3% of Poiseuille, the Bingham plug slower than the
    Newtonian profile, unyielded and flat at the centre, yielded at the
    walls, the Zou/He duct finite with its centre above 0.01;
    tests/test_qibb.py: at delta 0.25 and 0.75 within 4% of the parabola
    anchored at the off-grid walls, its roots within 0.15 of them, and at
    0.75 less than half plain bounce-back's error)."""
    say("phase 47: the reference's viscoplastic and qibb physics on K6")
    out, launches = {}, {}
    ny, g = 19, 1e-5
    y = np.arange(ny, dtype=float)
    newton = vp_channel(0.0)
    lat, vs64, n = run_case3(g3, newton, VP_STEPS["newtonian"], PHYS_F64_CUT,
                             channel_profile, "Newtonian channel",
                             "d3q27_viscoplastic")
    launches["vp_newtonian"] = n
    ux_n = channel_profile(lat).numpy()
    h, c, nu = (ny - 2) / 2.0, (ny - 1) / 2.0, 1 / 6
    ref = g / (2 * nu) * (h ** 2 - (y - c) ** 2)
    err = float(np.abs(ux_n[1:-1] - ref[1:-1]).max() / ref.max())
    say(f"  Newtonian limit: max error {err:.4e} of the Poiseuille peak "
        "(limit 0.03)")
    if not (np.isfinite(ux_n).all() and err < 0.03):
        fail(f"viscoplastic Newtonian limit: error {err}")
    out["vp_newtonian"] = {"vs_f64": vs64, "poiseuille_err": err,
                           "ux_max": float(ux_n.max())}
    y0_frac = 0.4
    hb = (ny - 1) / 2.0
    lat, vs64, n = run_case3(g3, vp_channel(y0_frac * hb * g),
                             VP_STEPS["bingham"], PHYS_F64_CUT,
                             channel_profile, "Bingham plug",
                             "d3q27_viscoplastic")
    launches["vp_bingham"] = n
    ux_b = channel_profile(lat).numpy()
    ystat = lat.get_quantity("yield_stat")[1, :, 2].double().cpu().numpy()
    cc = ny // 2
    plug = np.abs(np.arange(ny) - cc) <= y0_frac * hb * 0.5
    spread = float(ux_b[plug].max() - ux_b[plug].min())
    ok = (np.isfinite(ux_b).all() and ux_b.max() < ux_n.max()
          and ux_b.max() > 0 and ystat[cc] == 1.0
          and spread < 0.02 * ux_b.max() and ystat[1] == 0.0
          and ystat[-2] == 0.0)
    say(f"  Bingham plug: ux max {ux_b.max():.6e} (Newtonian "
        f"{ux_n.max():.6e}), plug spread {spread:.3e} (limit "
        f"{0.02 * ux_b.max():.3e}), yield_stat centre {ystat[cc]}, walls "
        f"{ystat[1]} {ystat[-2]}")
    if not ok:
        fail("viscoplastic Bingham plug: the reference's fit fails")
    out["vp_bingham"] = {"vs_f64": vs64, "ux_max": float(ux_b.max()),
                         "plug_spread": spread,
                         "yield_stat_centre": float(ystat[cc])}

    def duct_u(lat):
        return lat.get_quantity("U").double().cpu().flatten()
    lat, vs64, n = run_case3(g3, vp_duct, VP_STEPS["duct"], PHYS_F64_CUT,
                             duct_u,
                             "Zou/He duct", "d3q27_viscoplastic")
    launches["vp_duct"] = n
    u = lat.get_quantity("U").double().cpu().numpy()
    centre = float(u[0][1, 6, 12])
    say(f"  Zou/He duct: centre ux {centre:.6e} (limit > 0.01)")
    if not (np.isfinite(u).all() and centre > 0.01):
        fail(f"viscoplastic Zou/He duct: centre ux {centre}")
    out["vp_duct"] = {"vs_f64": vs64, "centre_ux": centre}
    # the qibb channels
    nyq, gq = 16, 1e-6
    yq = np.arange(nyq, dtype=float)
    sl = slice(2, nyq - 2)
    errs_q = {}
    for delta in (0.25, 0.75):
        lat, vs64, n = run_case3(g3, qibb_channel(delta), QIBB_STEPS,
                                 PHYS_F64_CUT, channel_profile,
                                 f"qibb channel, delta {delta}",
                                 "d3q27_cumulant_qibb_small")
        launches[f"qibb_{delta}"] = n
        ux = lat.get_quantity("U")[0][1, :, 2].double().cpu().numpy()
        y_w0, y_w1 = 1.0 - delta, nyq - 2.0 + delta
        cq, hq = 0.5 * (y_w0 + y_w1), 0.5 * (y_w1 - y_w0)
        refq = gq / (2 * (1 / 6)) * (hq ** 2 - (yq - cq) ** 2)
        err = float(np.abs(ux[sl] - refq[sl]).max() / refq.max())
        roots = np.sort(np.roots(np.polyfit(yq[sl], ux[sl], 2)).real)
        say(f"  qibb delta {delta}: error {err:.4e} of the parabola "
            f"(limit 0.04), roots {roots.tolist()} (walls {y_w0}, {y_w1}, "
            "within 0.15)")
        if not (np.isfinite(ux).all() and err < 0.04
                and np.allclose(roots, [y_w0, y_w1], atol=0.15)):
            fail(f"qibb channel at delta {delta}: the reference's fit fails")
        errs_q[delta] = (err, refq)
        out[f"qibb_{delta}"] = {"vs_f64": vs64, "parabola_err": err,
                                "roots": roots.tolist()}
    lat, vs64, n = run_case3(g3, qibb_channel(None), QIBB_STEPS,
                             PHYS_F64_CUT,
                             channel_profile, "plain bounce-back channel",
                             "d3q27_cumulant_qibb_small")
    launches["qibb_plain_bb"] = n
    ux_bb = lat.get_quantity("U")[0][1, :, 2].double().cpu().numpy()
    err_q, refq = errs_q[0.75]
    err_bb = float(np.abs(ux_bb[sl] - refq[sl]).max() / refq.max())
    say(f"  delta 0.75: qibb error {err_q:.4e} against plain bounce-back's "
        f"{err_bb:.4e} (qibb below half of it)")
    if not err_q < 0.5 * err_bb:
        fail("qibb does not beat plain bounce-back at delta 0.75")
    out["qibb_plain_bb"] = {"vs_f64": vs64, "err_bb": err_bb}
    return {"summary": out, "launches": launches}


def kuper_drop(dtype):
    """A liquid drop in its vapour at 64^3 for d3q19_kuper, painted as
    example/drop.xml paints d2q9_kuper's drop but in 3D: a sphere of
    diameter 3/8 of the box at its centre in zone 1 (drop.xml's
    Temperature, FAcc, Magic and MagicA, ``KUPER_DROP_MAGICF``; the liquid
    Density in the drop, the vapour's outside), periodic."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d3q19_kuper")
    n = KUPER_DROP_N
    lat = Lattice(m, (n, n, n), dtype=dtype, device=DEVICE,
                  settings={"omega": 1.0, "Temperature": 0.56, "FAcc": 1.0,
                            "Magic": 0.01, "MagicA": -0.152,
                            "MagicF": KUPER_DROP_MAGICF, "Density":
                            KUPER_VAPOUR})
    lat.set_setting("Density", KUPER_LIQUID, zone=1)
    flags = np.full((n, n, n), m.flag_for("MRT"), dtype=np.uint16)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    r = 3 * n / 16
    drop = (zz - n / 2) ** 2 + (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < r * r
    flags[drop] = m.flag_for("MRT", zone=1)
    lat.set_flags(flags)
    lat.init()
    return lat


def run_kuper_drop(g3, errs: dict) -> dict:
    """Phase 48: the 3D kuper drop on K6: its first ``KUPER_DROP_CUT`` steps
    against eager f32 on the card (rtol 1e-4 / atol 1e-6), then
    ``KUPER_DROP_STEPS`` steps from Init counted from 0 (both passes of
    each step): the mass within ``KUPER_MASS_RTOL`` of the initial (the
    zonal Density summed over the nodes), the drop still liquid at its
    centre and vapour at a corner; both flavours against their plain
    versions on the developed drop."""
    say(f"phase 48: a d3q19_kuper drop at {KUPER_DROP_N}^3 on K6")
    kern, ref = kuper_drop(torch.float32), kuper_drop(torch.float32)
    kern.iterate(KUPER_DROP_CUT)
    eager_warm(ref, KUPER_DROP_CUT)
    cut = compare(kern.state.fields, ref.state.fields,
                  f"the kuper drop after {KUPER_DROP_CUT} steps, kernels vs "
                  "eager f32", GOLDEN_RTOL, GOLDEN_ATOL)
    lat = kuper_drop(torch.float32)
    m = lat.model
    zones = (lat.state.flags >> m.zone_shift).long()
    mass0 = float(lat.params.zone_table[m.setting_index["Density"]][zones]
                  .double().sum())
    run = iterate_window3(g3, lat, f"the kuper drop, iterate("
                          f"{KUPER_DROP_STEPS})", g3_engine("d3q19_kuper"),
                          KUPER_DROP_STEPS)
    rho = lat.get_quantity("Rho")
    mass = float(rho.double().sum())
    n = KUPER_DROP_N
    centre, corner = float(rho[n // 2, n // 2, n // 2]), float(rho[0, 0, 0])
    drift = abs(mass - mass0) / mass0
    say(f"  mass {mass:.9g} (initial {mass0:.9g}, rel change {drift:.3e}, "
        f"limit {KUPER_MASS_RTOL}), Rho centre {centre:.6g}, corner "
        f"{corner:.6g}")
    if drift > KUPER_MASS_RTOL:
        fail(f"the kuper drop's mass drifted by {drift}")
    if not (centre > 3.0 and corner < 0.1):
        fail(f"the kuper drop: no liquid drop (Rho centre {centre}, corner "
             f"{corner})")
    check_kernels([(g3, lat, "generic3d_step")], errs,
                  f"phase 48b, the kuper drop after {KUPER_DROP_STEPS} "
                  "steps")
    check_globals_flavour(g3, (lat,), errs, "phase 48b")
    run.update({"vs_eager_f32": cut, "mass_rel_drift": drift,
                "rho_centre": centre, "rho_corner": corner,
                "lattice": lat})
    return run


def time_passes3(g3, lat, key: str, reps: int = 100) -> list:
    """Each launch of a multi-pass ``generic3d_step`` on its own: its device
    time a call from a torch.profiler trace of ``reps`` calls, against its
    share of the step's bound (pass 0 reads the step's input once, the
    last pass writes its output once, each does its stage's operations);
    ``ms`` is None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    say(f"phase 8: each launch of {key} at {lat.shape} (a torch.profiler "
        f"trace of {reps} calls)")
    m = lat.model
    plan = g3.DEVICE_MODELS[m.name].plan
    inputs = g3.kernel_inputs(m, lat.state, lat.params)
    flops = g3.stage_flops(m, lat.flags_numpy(), inputs[0])
    n = int(np.prod(lat.shape))
    table = len(m.zonal_settings) * m.zone_max * 4
    fn = lambda: g3.step(*inputs)      # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [0.0] * len(plan)
    for name, _, dur in device_events(prof):
        hit = re.search(r"generic3d_pass_kernel<(\d+)", name)
        if hit:
            us[int(hit.group(1))] += dur
    out = []
    for s, ((stage, _), f) in enumerate(zip(plan, flops)):
        nbytes = (m.n_storage * 4 + 4) * n + table if s == 0 else 0
        if s == len(plan) - 1:
            nbytes += m.n_storage * 4 * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = f / FP32_FLOPS_PER_S * 1e3
        ms = us[s] / reps / 1e3 if us[s] else None
        bound = max(bytes_ms, ops_ms)
        out.append({"stage": stage, "ms": ms, "bound_ms": bound,
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", "bytes": nbytes, "flops": f,
                    "share_of_bound": bound / ms if ms else None})
        say(f"  {key} pass {s} ({stage}): "
            + (f"{ms:.4f} ms a call" if ms else "not measured (no device "
               "time in the trace)")
            + f", its share of the bound {bound:.4f} ms "
            f"({out[-1]['bound_by']}: {nbytes} B, {f} flop)")
    return out


def time_generic3d_models(g3, lats: dict) -> dict:
    """Phase 7 for the 3D models of the generic engine: both flavours of
    ``generic3d_step`` on each model's 48x48x256 lattice (its developed
    state) against their plain versions, the bound from ``launch_bytes``
    and ``node_step_flops`` (qibb's cut links counted from its cut
    distances), a multi-pass step's launches a call and each pass's time."""
    out = {}
    for model, lat in lats.items():
        f, flags, ztab, a = g3.kernel_inputs(lat.model, lat.state,
                                             lat.params)
        key = g3_key(model)
        for k, fn, g, reps in ((key, g3.step, False, 200),
                               (f"{key} globals", g3.step_globals, True,
                                100)):
            out[k] = time_one(
                k, lambda fn=fn: fn(f, flags, ztab, a),
                lambda g=g: g3.plain_steps(f, flags, ztab, a, 1,
                                           with_globals=g),
                g3.launch_bytes(lat.model, lat.shape),
                g3.node_step_flops(lat.model, lat.flags_numpy(), f),
                lat.shape, reps, plain_reps=3)
        out[key]["launches_per_call"] = len(g3.DEVICE_MODELS[model].plan)
    return out


def ptxas_of(gk, builds, models) -> dict:
    """Registers, stack, spills and shared memory of each generic3d_pass_
    kernel instance in the model libraries' compiler reports: by model,
    then by instance (``<stage,flavour,zonal source>``)."""
    out = {}
    for path, report in builds:
        model = next((m for m in models if re.fullmatch(
            r"libtclb_generic3d_%s_[0-9a-f]{12}\.so"
            % pathlib.Path(gk.DEVICE_MODELS[m].header).stem, path.name)),
            None)
        if model is None:
            continue
        cur, rows = None, {}
        for line in report.splitlines():
            hit = re.search(r"generic3d_pass_kernelILi(\d+)ELb(\d)ELb(\d)",
                            line)
            if hit:
                cur = "<{},{},{}>".format(
                    hit.group(1), "globals" if hit.group(2) == "1"
                    else "plain", "series" if hit.group(3) == "1"
                    else "table")
                rows[cur] = {}
                continue
            if cur is None:
                continue
            hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line)
            if hit:
                rows[cur].update(stack=int(hit.group(1)),
                                 spill_stores=int(hit.group(2)),
                                 spill_loads=int(hit.group(3)))
            hit = re.search(r"Used (\d+) registers", line)
            if hit:
                smem = re.search(r"(\d+) bytes smem", line)
                rows[cur].update(registers=int(hit.group(1)),
                                 smem=int(smem.group(1)) if smem else 0)
                cur = None
        out[model] = rows
    return out


def main() -> int:
    if not all((ROOT / "tclb_tpu_torch" / "csrc" / src).is_file()
               for src in SOURCES.values()):
        print("chip_smoke: run from a checkout of the repository (no "
              "tclb_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from tclb_tpu_torch.ops import adjoint_kernels as ak
    from tclb_tpu_torch.ops import d2q9_kernels as dk
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    from tclb_tpu_torch.ops import generic_kernels as gk

    say(card_line())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("phase 1: build (one nvcc per library, started together)")
    t0 = time.perf_counter()
    jobs = [dk.build, dk3.build] + [
        (lambda m=m: gk.build(m)) for m in GENERIC_MODELS] + [
        (lambda m=m: dk.build(m)) for m in dk.FAMILY] + [
        (lambda m=m: dk3.build(m)) for m in D3Q_FAMILY]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda job: job(), jobs))
    say(f"  built {', '.join(p.name for p, _ in builds)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for path, report in builds:
        for line in report.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling" in line:
                say(f"  ptxas ({path.name}): {line.strip()}")

    karman = case_lattice(KARMAN_XML, torch.float32, DEVICE)
    eager_warm(karman, 200)
    channel = channel_lattice(DEVICE)
    eager_warm(channel, 20)
    channel3d = case_lattice(CHANNEL3D_XML, torch.float32, DEVICE)
    eager_warm(channel3d, 4)
    rich3d = rich3d_lattice(DEVICE)
    drop = case_lattice(DROP_XML, torch.float32, DEVICE)
    eager_warm(drop, 100)
    drop1024 = drop_lattice(DEVICE)
    eager_warm(drop1024, 4)
    rich_kuper = rich_kuper_lattice(DEVICE)
    rich_heat = rich_heat_lattice(DEVICE)
    heat1024 = heat1024_lattice(DEVICE)
    eager_warm(heat1024, 20)
    case_tmp = tempfile.TemporaryDirectory()
    adj3d_xml = adj3d_case_file(case_tmp.name)
    rich_adj3d = rich_adj3d_lattice(DEVICE)
    adj3d_init = case_lattice(adj3d_xml, torch.float32, DEVICE,
                              drop=ADJ3D_HANDLERS)
    eager_warm(adj3d_init, 4)
    bench3d = bench3d_lattice(DEVICE)
    # the d2q9 family: a rich state each, the paths' starting states
    # (bench.py's channels at 1024x1024, for d2q9_inc and d2q9_new also at
    # 128x1024) warmed a few steps
    rich_family = [rich_family_lattice(m, DEVICE) for m in dk.FAMILY]
    family_band = {m: family_channel_lattice(m, DEVICE, (1024, 1024))
                   for m in dk.FAMILY}
    family_res = {m: family_channel_lattice(m, DEVICE, (128, 1024))
                  for m in ("d2q9_inc", "d2q9_new")}
    for lat in list(family_band.values()) + list(family_res.values()):
        eager_warm(lat, 20)
    # the rest of the z-slab family: a rich state each and path B's
    # starting states; path A's state with SynthT planes drawn
    rich_d3q = [rich_d3q_lattice(m, DEVICE) for m in D3Q_FAMILY]
    channel48 = {m: channel48_lattice(m, DEVICE) for m in D3Q_FAMILY}
    for lat in channel48.values():
        eager_warm(lat, 4)
    turb = turbulence_lattice(DEVICE)
    # the Control series: rich states with series on two zones (horizon 5),
    # the starting states of paths A and B (their series from their
    # <Control>), bench.py's 1024x1024 d2q9 channel under an inlet series,
    # and a rich d2q9 state without one (d2q9's plain generic kernels)
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import RICH_SETTINGS, paint_rich
    rich_series = {m: rich_series_lattice(m, DEVICE)
                   for m in ("d2q9", "d3q19_adj")}
    control_init = case_lattice(KARMAN_CONTROL_XML, torch.float32, DEVICE)
    eager_warm(control_init, 200)
    adj3d_control_xml = adj3d_control_file(case_tmp.name)
    control3d_init = case_lattice(adj3d_control_xml, torch.float32, DEVICE)
    eager_warm(control3d_init, 4)
    channel_series = series_lattice(channel_lattice(DEVICE))
    eager_warm(channel_series, 20)
    rich_d2q9 = paint_rich(Lattice(get_model("d2q9"), (32, 64),
                                   dtype=torch.float32, device=DEVICE,
                                   settings=RICH_SETTINGS), seed=5)
    errs = check_kernels([
        (dk, karman, "d2q9_resident8"), (dk, karman, "d2q9_step"),
        (dk, channel, "d2q9_step2"), (dk, channel, "d2q9_step"),
        (dk3, channel3d, "d3q27_step"), (dk3, channel3d, "d3q27_step2"),
        (dk3, rich3d, "d3q27_step"), (dk3, rich3d, "d3q27_step2"),
        (gk, drop, "generic2d_step"), (gk, drop, "generic2d_resident"),
        (gk, drop1024, "generic2d_step"),
        (gk, drop1024, "generic2d_resident"),
        (gk, rich_kuper, "generic2d_step"),
        (gk, rich_kuper, "generic2d_resident"),
        (gk, rich_heat, "generic2d_step"),
        (gk, rich_heat, "generic2d_resident"),
        (gk, heat1024, "generic2d_step"),
        (gk, heat1024, "generic2d_resident"),
        (g3, rich_adj3d, "generic3d_step"),
        (g3, adj3d_init, "generic3d_step")] + [
        (dk, lat, name) for lat in rich_family
        + list(family_band.values()) + list(family_res.values())
        for name in dk.KERNELS] + [
        (dk3, lat, name) for lat in rich_d3q + list(channel48.values())
        + [turb] for name in dk3.KERNELS], {}, "phase 2")
    check_globals_flavour(gk, (drop, drop1024, rich_kuper, rich_heat,
                               heat1024), errs, "phase 2")
    check_globals_flavour(g3, (rich_adj3d, adj3d_init), errs, "phase 2")
    # d2q9's generic kernels without a series (no path runs them: d2q9
    # takes K1/K2 there) on the rich state, bench.py's 1024x1024 channel
    # and karman.xml's state (the resident kernel where it fits the L2)
    check_kernels([(gk, rich_d2q9, "generic2d_step"),
                   (gk, rich_d2q9, "generic2d_resident"),
                   (gk, channel, "generic2d_step"),
                   (gk, karman, "generic2d_step"),
                   (gk, karman, "generic2d_resident")], errs,
                  "phase 2, d2q9 on the generic kernels")
    check_globals_flavour(gk, (rich_d2q9, channel), errs, "phase 2")
    check_series_flavours(gk, (rich_series["d2q9"], control_init,
                               channel_series), errs, "phase 2")
    check_series_flavours(g3, (rich_series["d3q19_adj"], control3d_init),
                          errs, "phase 2")
    check_step_b(ak, gk, (rich_heat, heat1024, rich_adj3d, adj3d_init), errs,
                 "phase 2")
    check_goldens()
    main_path = run_case(dk, KARMAN_XML, "4",
                         "cuda_d2q9_resident[d2q9,fuse=8]",
                         ("d2q9_resident8", "d2q9_step"), check_karman)
    band = run_iterate(dk, channel, "5", "1024x1024 channel on the band "
                       "engine", "cuda_d2q9_band[d2q9,fuse=2]",
                       ("d2q9_step2", "d2q9_step"))
    path3d = run_case(dk3, CHANNEL3D_XML, "6",
                      "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
                      ("d3q27_step2", "d3q27_step"), check_channel3d)
    # the developed flow the 3D path ends with (these launches come after
    # the path's counts were read)
    check_kernels([(dk3, path3d["lattice"], "d3q27_step"),
                   (dk3, path3d["lattice"], "d3q27_step2")], errs,
                  "phase 6b, 3d_channel after 20000 iterations")
    path_drop = run_case(gk, DROP_XML, "9",
                         "cuda_generic_resident[d2q9_kuper,fuse=N]",
                         gk.KERNELS, check_drop)
    drop_dev = path_drop["lattice"]
    check_kernels([(gk, drop_dev, "generic2d_step"),
                   (gk, drop_dev, "generic2d_resident")], errs,
                  "phase 9b, drop.xml after 6000 iterations")
    check_globals_flavour(gk, (drop_dev,), errs, "phase 9b")
    band_drop = run_drop_band(gk, drop1024)
    path_heat = run_heat_adj(gk, ak)
    heat_band = run_heat1024(gk, ak, heat1024)
    # the developed 512x1024 flow (after the gradients' counts were read)
    check_kernels([(gk, heat1024, "generic2d_step")], errs,
                  "phase 12b, the 512x1024 heat_adj channel after 2000 "
                  "iterations")
    check_step_b(ak, gk, (heat1024,), errs, "phase 12b")
    path3d_adj = run_adj3d_case(g3, ak, adj3d_xml)
    # the developed state after the 3D case's Solve (its launches come after
    # the path's counts were read)
    adj3d_dev = path3d_adj.pop("start")
    check_kernels([(g3, adj3d_dev, "generic3d_step")], errs,
                  "phase 13b, the 3D case after its Solve of 2000")
    check_globals_flavour(g3, (adj3d_dev,), errs, "phase 13b")
    check_step_b(ak, g3, (adj3d_dev,), errs, "phase 13b")
    bench_adj3d = run_bench_adjoint3d(g3, ak, bench3d)
    family = run_family(dk, family_band, family_res, errs)
    path_turb = run_turbulence(dk3)
    check_kernels([(dk3, path_turb["lattice"], name)
                   for name in dk3.KERNELS], errs,
                  "phase 20b, 3dcum_turbulence.xml after 1000 iterations")
    path_b = run_d3q_channels(dk3, channel48)
    check_kernels([(dk3, lat, name) for lat in channel48.values()
                   for name in dk3.KERNELS], errs,
                  "phase 21b, the 48x48x256 channels after 2002 iterations")
    poiseuille3d = check_d3q_poiseuille()
    path_control = run_series_case(
        gk, KARMAN_CONTROL_XML, "23", "cuda_generic_band[d2q9,fuse=1]",
        inlet_ux_2d, window=500)
    control_dev = path_control.pop("lattice")
    path_control3d = run_series_case(
        g3, adj3d_control_xml, "24",
        "cuda_generic3d_band[d3q19_adj,fuse=1]", inlet_ux_3d, window=200)
    control3d_dev = path_control3d.pop("lattice")
    # the developed states (after the paths' counts were read)
    check_series_flavours(gk, (control_dev,), errs,
                          "phase 23b, karman_control.xml after 4000 "
                          "iterations")
    check_series_flavours(g3, (control3d_dev,), errs,
                          "phase 24b, the 3D Control channel after 2000 "
                          "iterations")
    path_sample = run_sample(gk)
    ladder = run_ladder(gk, dk3, errs, channel=channel, drop1024=drop1024,
                        control=control_dev, channel3d=path3d["lattice"],
                        turb=path_turb["lattice"], channel48=channel48)
    one = run_onestage(gk, errs)
    multi = run_multistage(gk, errs)
    adj = run_adj_models(gk, ak, errs)
    heat3d = run_heat_bench(g3, errs, {
        "d3q27_cumulant (3d_channel.xml, 48x48x256)":
            path3d["mlups_iterate"],
        "d3q19 (channel48)": path_b["d3q19"]["mlups_iterate"]})
    g3models = run_generic3d_models(g3, errs)
    physics3d = run_generic3d_physics(g3)
    drop3d = run_kuper_drop(g3, errs)
    # one generic2d_resident launch of each path: the even part of
    # niter - 1 for drop.xml's Log interval of 500 iterations and for
    # heat_adj.xml's one Solve of 4000
    log_every = int(ET.parse(DROP_XML).getroot().find("Log")
                    .get("Iterations"))
    solve = int(ET.parse(HEAT_ADJ_XML).getroot().find("Solve")
                .get("Iterations"))
    times = time_kernels([
        (dk, "d2q9_resident8", karman, 400), (dk, "d2q9_step", karman, 1000),
        (dk, "d2q9_step2", channel, 200),
        (dk3, "d3q27_step", channel3d, 400),
        (dk3, "d3q27_step2", channel3d, 200)])
    times.update(time_generic(gk, drop1024, drop_dev,
                              (log_every - 1) // 2 * 2))
    times.update(time_generic(gk, heat1024, heat_adj_solve_state(
        HEAT_ADJ_XML), (solve - 1) // 2 * 2, plain_reps=1))
    times.update(time_step_b(ak, gk, heat1024))
    # the series flavours: K4's at 1024x1024 (the record) and at
    # karman_control's 512x96, K6's at the 3D Control channel's 32x64x256;
    # d2q9's plain K4 at 1024x1024 and K5 at karman.xml's 1024x100 for the
    # 498 steps one launch would take per Log interval of 500
    times.update(time_series_flavours(gk, channel_series, 400))
    times_512 = time_series_flavours(gk, control_dev, 1000)
    times.update(time_series_flavours(g3, control3d_dev, 400))
    times_d2q9 = time_generic(gk, channel, karman, 498, plain_reps=1)
    times.update(time_generic3d(g3, ak, adj3d_dev))
    times.update(time_bf16(gk, dk3, ladder["band"], ladder["resident"],
                           ladder["d3"], HARNESS_RES_STEPS))
    times.update(time_onestage(gk, one))
    times.update(time_multistage(gk, multi))
    times.update(time_adj(gk, ak, adj))
    times.update(time_generic3d_models(g3, g3models["lattices"]))
    # the family: d2q9_resident8 on each model's resident path, the
    # single and fused steps on its 1024x1024 band path
    times.update(time_kernels(
        [(dk, "d2q9_resident8", family["resident_lattice"][m], 400)
         for m in dk.FAMILY]
        + [(dk, name, family_band[m], reps) for m in dk.FAMILY
           for name, reps in (("d2q9_step", 400), ("d2q9_step2", 200))]
        + [(dk3, name, channel48[m], reps) for m in D3Q_FAMILY
           for name, reps in (("d3q27_step", 400), ("d3q27_step2", 200))]))
    busy = device_busy(lambda: karman.iterate(400), "a karman iterate(400)")
    # karman.xml's and drop.xml's windows, split: the resident kernel's
    # device time and its wrapper's host time a launch, the eager globals
    # step, the idle share (an iterate of one Log interval each)
    k_inputs = dk.kernel_inputs(karman.model, karman.state, karman.params)
    d_inputs = gk.kernel_inputs(drop_dev.model, drop_dev.state,
                                drop_dev.params)
    splits = {
        "karman": window_split(
            karman, 1000, "a karman iterate(1000)", "d2q9_resident8",
            lambda: dk.LAUNCHES["d2q9_resident8"],
            lambda: dk.resident8(*k_inputs)),
        "drop": window_split(
            drop_dev, log_every, f"a drop iterate({log_every})",
            "generic2d_resident", lambda: gk.LAUNCHES["generic2d_resident"],
            lambda: gk.resident(*d_inputs, (log_every - 1) // 2 * 2))}
    busy3d = device_busy(lambda: channel3d.iterate(200),
                         "a 3d_channel iterate(200)")
    busy_drop = device_busy(lambda: drop_dev.iterate(2000),
                            "a drop iterate(2000)")
    busy_grad = device_busy(heat_band.pop("grad_fn"),
                            "the 1000-step 512x1024 heat_adj gradient")
    busy_grad3d = device_busy(bench_adj3d.pop("grad_fn"),
                              "the 1000-step 64x128x256 d3q19_adj gradient")
    grad3d = bench_adj3d["grad1000"]
    grad3d["device_busy_us"] = busy_grad3d["device_busy_us"]
    say(f"  the 1000-step 64x128x256 d3q19_adj gradient: median of "
        f"{GRAD3D_RUNS} runs {grad3d['wall_s']:.4f} s (phase 14d), device "
        f"busy {busy_grad3d['device_busy_us']} us in a traced run")
    busy_adj_grad = device_busy(adj.pop("grad_fn"),
                                "the 1000-step 512x1024 d2q9_adj gradient")
    cum2d = family["resident_lattice"]["d2q9_cumulant"]
    busy_cum2d = device_busy(lambda: cum2d.iterate(400),
                             "a cumulant2d iterate(400)")
    cum1024 = family_band["d2q9_cumulant"]
    busy_cum1024 = device_busy(lambda: cum1024.iterate(200),
                               "a 1024x1024 d2q9_cumulant iterate(200)")
    turb_dev = path_turb["lattice"]
    busy_turb = device_busy(lambda: turb_dev.iterate(200),
                            "a 3dcum_turbulence iterate(200)")
    busy48 = {m: device_busy(lambda lat=lat: lat.iterate(200),
                             f"a 48x48x256 {m} channel iterate(200)")
              for m, lat in channel48.items()}
    busy_control = device_busy(lambda: control_dev.iterate(500),
                               "a karman_control iterate(500)")
    busy_control3d = device_busy(lambda: control3d_dev.iterate(200),
                                 "a 3D Control channel iterate(200)")
    busy_one = {
        "heat_channel": device_busy(
            lambda: one["resident"]["d2q9_heat"].iterate(500),
            "a heat_channel iterate(500)"),
        "d2q9_npe_guo1024": device_busy(
            lambda: one["band"]["d2q9_npe_guo"].iterate(100),
            "a 1024x1024 d2q9_npe_guo iterate(100)")}
    busy_multi = {
        "drop_lee": device_busy(
            lambda: multi["resident"]["d2q9_lee"].iterate(500),
            "a drop_lee iterate(500)"),
        "d2q9_lee1024": device_busy(
            lambda: multi["band"]["d2q9_lee"].iterate(100),
            "a 1024x1024 d2q9_lee iterate(100)")}
    # the launch of each three-stage step at 1024x1024 (the staged form),
    # after the windows above (a trace of its own each)
    for model in MULTISTAGE_MODELS:
        if gk.step_form(multi["band"][model].model) == "staged":
            for tag in ("", "_bf16"):
                lat = multi["band"][f"{model}{' bf16' if tag else ''}"]
                key = f"generic2d_step{tag}[{model}]"
                times[key]["passes"] = time_passes(
                    gk, lat, key, bf16_inputs(gk, lat) if tag else
                    gk.kernel_inputs(lat.model, lat.state, lat.params),
                    2 if tag else 4)

    # K6's passes of d3q19_kuper at 48x48x256, after the windows above
    kuper3d = g3_key("d3q19_kuper")
    times[kuper3d]["passes"] = time_passes3(
        g3, g3models["lattices"]["d3q19_kuper"], kuper3d)
    busy_heat3d = device_busy(lambda: heat3d["lattice"].iterate(200),
                              "a d3q19_heat case iterate(200)")

    launches = {name: {"karman": main_path["launches"][name],
                       "channel": band["launches"][name]}
                for name in dk.KERNELS}
    launches.update(family["launches"])
    launches.update({name: {"3d_channel": path3d["launches"][name],
                            "3dcum_turbulence": path_turb["launches"][name]}
                     for name in dk3.KERNELS})
    launches.update({dk3.launch_key(name, m): {
        "channel48": path_b[m]["launches"][dk3.launch_key(name, m)]}
        for m in D3Q_FAMILY for name in dk3.KERNELS})
    launches.update({f"{name}[d2q9_kuper]": {
        "drop": path_drop["launches"][name],
        "drop1024": band_drop["launches"][name]} for name in gk.KERNELS})
    launches.update({f"{name}[d2q9_heat_adj]": {
        "heat_adj": path_heat["launches"][name],
        "heat_adj1024": heat_band["launches"].get(name, 0),
        "heat_adj1024_gradient": heat_band["grad_launches"][name]}
        for name in gk.KERNELS + ("generic2d_step_b",)})
    launches.update({f"{name}[d3q19_adj]": {
        "adj3d_case": path3d_adj["launches"][name],
        "bench_adjoint3d": bench_adj3d["launches"].get(name, 0),
        "bench_adjoint3d_gradient200":
            bench_adj3d["grad200"]["launches"][name],
        "bench_adjoint3d_gradient1000":
            bench_adj3d["grad1000"]["launches"][name]}
        for name in g3.KERNELS + ("generic3d_step_b",)})
    launches.update({f"{name}[d2q9]": {
        "karman_control": path_control["launches"][name]}
        for name in gk.SERIES_KERNELS})
    launches.update({f"{name}[d3q19_adj]": {
        "adj3d_control": path_control3d["launches"][name]}
        for name in g3.SERIES_KERNELS})
    launches.update(one["launches"])
    launches.update(multi["launches"])
    launches.update(adj["launches"])
    # the 3D models of the generic engine: their paths' launches and the
    # globals flavour's
    g3_launches = dict(g3models["launches"])
    g3_glaunches = dict(g3models["globals_launches"])

    def add3(model, path, n, n_globals):
        g3_launches.setdefault(g3_key(model), {})[path] = n
        g3_glaunches.setdefault(g3_key(model), {})[path] = n_globals
    add3("d3q19_heat", "heat_bench", heat3d["launches"]["generic3d_step"],
         heat3d["flavours"]["globals"])
    for path, (n, n_globals) in physics3d["launches"].items():
        add3("d3q27_viscoplastic" if path.startswith("vp")
             else "d3q27_cumulant_qibb_small", path, n, n_globals)
    add3("d3q19_kuper", "kuper_drop", drop3d["launches"]["generic3d_step"],
         drop3d["flavours"]["globals"])
    launches.update(g3_launches)
    for name in gk.BF16_KERNELS:
        TPU_KERNELS.setdefault(name, TPU_KERNELS[name[:-len("_bf16")]])
    bf16_sources = {name: SOURCES["generic"] for name in gk.BF16_KERNELS}
    for key, by_path in ladder["launches"].items():
        launches[key] = by_path
        name = key.split("[")[0]
        bf16_sources[name] = SOURCES["d3q27" if name.startswith("d3q27")
                                     else "generic"]
        TPU_KERNELS.setdefault(name, TPU_KERNELS[name[:-len("_bf16")]])
    sources = {**{n: SOURCES["d2q9"] for n in dk.KERNELS},
               **{n: SOURCES["d3q27"] for n in dk3.KERNELS},
               **{n: SOURCES["generic"] for n in gk.KERNELS
                  + gk.SERIES_KERNELS},
               **{n: SOURCES["generic3d"] for n in g3.SERIES_KERNELS},
               "generic2d_step_b": SOURCES["adjoint"],
               **{n: SOURCES["generic3d"] for n in g3.KERNELS},
               "generic3d_step_b": SOURCES["adjoint3d"], **bf16_sources}
    kernels = []
    for key, by_path in launches.items():
        name = key.split("[")[0]
        if sum(by_path.values()) < 1:
            fail(f"{key} was launched no time on the path")
        kernels.append({
            "name": key, "route": "cuda",
            "source": "tclb_tpu_torch/csrc/" + sources[name],
            "replaces": TPU_KERNELS.get(key, TPU_KERNELS[name]),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[key]["max_abs_err"],
            "max_rel_err": errs[key]["max_rel_err"],
            "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"],
            "bound_ms": times[key]["bound_ms"],
            "bound_by": times[key]["bound_by"],
            "library_ms": None,
            "wrapper_host_ms": times[key]["wrapper_host_ms"],
            "shape": times[key]["shape"],
        })
    by_name = {k["name"]: k for k in kernels}
    # the form each generic 2D step row runs (generic_kernels.step_form)
    # and its __global__: the one-node-a-thread pass (in 32x16 blocks, or
    # 32x8 at three an SM: the narrow pass), the tiled form, the ring form
    # or the staged form
    for key, k in by_name.items():
        hit = re.match(r"generic2d_step(?:_bf16|_series\w*)?\[(\w+)\]$",
                       key)
        if hit:
            form = gk.step_form(gk._get_model(hit.group(1)))
            k["form"] = form
            k["global"] = {"pass": "generic2d_pass_kernel",
                           "narrow": "generic2d_narrow_kernel",
                           "tiled": "generic2d_tiled_kernel",
                           "ring": "generic2d_step_kernel",
                           "staged": "generic2d_staged_kernel"}[form]
    for key, flavour_launches in (
            ("generic2d_step[d2q9_kuper]",
             {"drop": path_drop["flavours"]["globals"],
              "drop1024": band_drop["flavours"]["globals"]}),
            ("generic2d_step[d2q9_heat_adj]",
             {"heat_adj": path_heat["flavours"]["globals"],
              "heat_adj1024": heat_band["flavours"]["globals"],
              "heat_adj1024_gradient":
                  heat_band["grad_flavours"]["globals"]}),
            ("generic3d_step[d3q19_adj]",
             {"adj3d_case": path3d_adj["flavours"]["globals"],
              "bench_adjoint3d": bench_adj3d["flavours"]["globals"],
              "bench_adjoint3d_gradient200":
                  bench_adj3d["grad200"]["flavours"]["globals"],
              "bench_adjoint3d_gradient1000":
                  bench_adj3d["grad1000"]["flavours"]["globals"]})):
        by_name[key]["globals_flavour"] = {
            **{k: times[f"{key} globals"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "wrapper_host_ms", "shape")},
            "launches_by_path": flavour_launches,
            "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
        res = key.replace("step", "resident")
        if res in by_name:
            by_name[res]["steps"] = times[res]["steps"]
    for step_b in ["generic2d_step_b[d2q9_heat_adj]",
                   "generic3d_step_b[d3q19_adj]"] + [
            f"generic2d_step_b[{m}]" for m in ADJ_MODELS]:
        by_name[step_b]["settings_max_rel_err"] = \
            errs[f"{step_b} settings"]["max_rel_err"]
    for key in (f"{k}[{m}]" for mod, m in ((gk, "d2q9"), (g3, "d3q19_adj"),
                                           (gk, "d2q9_heat"),
                                           (gk, "d2q9_lee"),
                                           (gk, "d2q9_adj"))
                for k in mod.SERIES_KERNELS[1:]):
        by_name[key]["globals_max_abs_err"] = \
            errs[f"{key} globals"]["max_abs_err"]
    for key in ladder["launches"]:
        e = errs[key]
        by_name[key]["flips"] = e.get("flips")
        if key.startswith("generic2d_step_bf16"):
            by_name[key]["globals_flavour"] = {
                **{k: times[f"{key} globals"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "wrapper_host_ms", "shape")},
                "launches_by_path": ladder["globals_launches"][key],
                "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
        if key.startswith("generic2d_resident_bf16"):
            by_name[key]["steps"] = times[key]["steps"]
            by_name[key]["chain_bit_identical"] = e["chain_bit_identical"]
            # against as many narrowed eager steps from the start
            by_name[key]["eager_max_abs_err"] = e["eager_max_abs_err"]
    # the one-stage and multi-stage models: each kernel's header, the step
    # kernels' globals flavour, K5's steps and its chain, the bf16 values a
    # step off
    for key in list(one["launches"]) + list(multi["launches"]) + list(
            adj["launches"]):
        model = key.split("[")[1].rstrip("]")
        by_name[key]["header"] = ("tclb_tpu_torch/csrc/"
                                  + gk.DEVICE_MODELS[model].header)
        if key.startswith("generic2d_resident"):
            by_name[key]["steps"] = times[key]["steps"]
            by_name[key]["chain_bit_identical"] = \
                errs[key]["chain_bit_identical"]
        if "bf16" in key:
            by_name[key]["flips"] = errs[key].get("flips")
    # a three-stage step's launches a call, and each launch's time against
    # the step's bound
    for key in multi["launches"]:
        for k in ("launches_per_call", "passes"):
            if k in times[key]:
                by_name[key][k] = times[key][k]
    for key, by_path in list(one["globals_launches"].items()) + list(
            multi["globals_launches"].items()) + list(
            adj["globals_launches"].items()):
        by_name[key]["globals_flavour"] = {
            **{k: times[f"{key} globals"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "wrapper_host_ms", "shape")},
            "launches_by_path": by_path,
            "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
    # the 3D models of the generic engine: each kernel's header, compiler
    # report, globals flavour, bit parity with its plain version, a
    # multi-pass step's launches a call and each pass's time
    ptxas3 = ptxas_of(gk, builds, GENERIC3D)
    for model in GENERIC3D:
        key = g3_key(model)
        by_name[key]["header"] = ("tclb_tpu_torch/csrc/"
                                  + gk.DEVICE_MODELS[model].header)
        by_name[key]["ptxas"] = ptxas3.get(model)
        by_name[key]["bit_identical"] = \
            g3models["summary"][f"{model}_bit_identical"]
        for k in ("launches_per_call", "passes"):
            if k in times[key]:
                by_name[key][k] = times[key][k]
        by_name[key]["globals_flavour"] = {
            **{k: times[f"{key} globals"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "wrapper_host_ms", "shape")},
            "launches_by_path": g3_glaunches[key],
            "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
    for key, t in times_512.items():
        by_name[key]["at_512x96"] = {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "wrapper_host_ms")}
    # d2q9's plain generic kernels: held and timed, on no path (d2q9
    # without a series takes K1/K2), so not in the kernels line
    d2q9_generic = {key: {**{k: t[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "wrapper_host_ms",
        "shape")}, "max_abs_err": errs[key.replace(" globals", "")
                                       ]["max_abs_err"]}
        for key, t in times_d2q9.items()}
    d2q9_generic["generic2d_step[d2q9] globals"]["globals_max_abs_err"] = \
        errs["generic2d_step[d2q9] globals"]["max_abs_err"]
    keys = ("wall_s", "mlups_end_to_end", "mlups_iterate", "iterate_ms",
            "iterate_host_ms", "eager_step_ms", "eager_steps")
    heat_keys = ("wall_s", "objectives", "material", "fd_records",
                 "grad_rel_l2_f64", "solid_nodes")
    say(json.dumps({
        "karman": {k: main_path[k] for k in keys},
        "channel_mlups_iterate": band["mlups_iterate"],
        "3d_channel": {k: path3d[k] for k in keys},
        "drop": {k: path_drop[k] for k in keys},
        "drop1024_mlups_iterate": band_drop["mlups_iterate"],
        "heat_adj": {k: path_heat[k] for k in heat_keys},
        "heat_adj1024": {k: heat_band[k] for k in (
            "mlups_iterate", "grad8_max_abs_err", "grad1000")},
        "adj3d_case": {k: path3d_adj[k] for k in heat_keys + (
            "fd_in_block",)},
        "bench_adjoint3d": {k: bench_adj3d[k] for k in (
            "mlups_iterate", "grad8_max_abs_err", "grad200", "grad1000")},
        **family["summary"],
        "3dcum_turbulence": {**{k: path_turb[k] for k in keys},
                             "synth_digests": path_turb["synth_digests"]},
        "channel48_mlups_iterate": {m: path_b[m]["mlups_iterate"]
                                    for m in D3Q_FAMILY},
        "poiseuille3d": poiseuille3d,
        "karman_control": path_control,
        "adj3d_control": path_control3d,
        "sample": path_sample,
        "storage_ladder": ladder["summary"],
        "onestage": one["summary"],
        "onestage_iterate_profile": busy_one,
        "multistage": multi["summary"],
        "multistage_iterate_profile": busy_multi,
        "adjoint_models": adj["summary"],
        "generic3d_models": {
            "heat_bench": {k: v for k, v in heat3d.items()
                           if k != "lattice"},
            "models": g3models["summary"],
            "physics": physics3d["summary"],
            "kuper_drop": {k: v for k, v in drop3d.items()
                           if k != "lattice"},
            "ptxas": ptxas3},
        "d3q19_heat_bench_iterate_profile": busy_heat3d,
        "adj_bench_gradient1000_profile": busy_adj_grad,
        "d2q9_generic_kernels_off_path": d2q9_generic,
        "karman_control_iterate_profile": busy_control,
        "adj3d_control_iterate_profile": busy_control3d,
        "3dcum_turbulence_iterate_profile": busy_turb,
        "channel48_iterate_profile": busy48,
        "cumulant2d_iterate_profile": busy_cum2d,
        "d2q9_cumulant1024_iterate_profile": busy_cum1024,
        "karman_iterate_profile": busy,
        "resident_window_split": splits,
        "3d_channel_iterate_profile": busy3d,
        "drop_iterate_profile": busy_drop,
        "heat_adj1024_gradient_profile": busy_grad,
        "bench_adjoint3d_gradient1000_profile": busy_grad3d}))
    case_tmp.cleanup()
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
