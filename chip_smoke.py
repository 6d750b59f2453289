"""Smoke run of the PyTorch/CUDA port (``isochrones_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``--parent-csrc DIR`` (a directory holding another version's ``csrc/``,
e.g. the parent commit's) also builds those
(``scripts.compare_torch_kernels.Baseline``, imported only then) and times
its kernels A', B, B' and C' in turns beside these (phases 25a and 26).

Phases, one or more lines each; any failure raises and exits non-zero:

1. device: require a CUDA card; print its name and ``nvidia-smi``'s name and
   power limit;
2. build: compile the CUDA kernels from ``isochrones_torch/csrc`` with nvcc
   (into ``isochrones_torch/_build/``);
3. kernel: the cluster-marginal kernel against its plain PyTorch version on
   the card, on seeded adversarial inputs at (S, E, B) = (7, 50, 4),
   (50, 700, 3) and (50, 1710, 3) with W = 8 walkers, in float64 and float32;
   at the two wide shapes the kernel's device time (``torch.profiler``)
   beside its bound (special functions at the card's rate);
4. slice: the 50-star cluster model on the MIST-scale synthetic grid in
   float32 (the fit's settings): lnpost at the truth, one 16-walker
   ``lnpost_batch`` through the kernels (the cluster kernel once, kernel B
   three times: the ladder's mass columns, ``interp_mag``'s two lerps)
   against the plain path (every lerp plain too) in float64;
5. fit: ``fit_mcmc`` with 16 walkers, 30 burn-in + 20 steps, moves "mixed";
   every lnprob finite, acceptance above 0, the cluster kernel and kernel B
   launched;
6. star kernel: the fused star-likelihood kernel against its plain PyTorch
   version on the card at the MIST-scale grid, B = 131072 points (the bench
   box plus adversarial rows: exact and top knots, out of bounds, NaN), a
   binary with 4 bands, in float64 and float32, and at the nested fit's
   batch of 1024 points; the kernel's device time (``torch.profiler``) at
   both batches beside its bound;
7. binary slice: ``BinaryStarModel`` at full width (the bench's star,
   observations made with the port's ``interp_mag``): lnpost at the truth,
   a 131072-point ``lnpost_batch`` through the kernel against the plain path
   in float64, and the float32 throughput of both paths;
8. nested fit: ``fit_multinest(n_live_points=1000, n_batch=64,
   n_chains=16)`` in float32, then ``derived_samples`` (through kernel B);
   logz finite, the run not truncated, the kernels launched, and the
   distance posterior's 2.5-97.5% interval holding the true 200 pc;
9. tree kernel: the observation-tree likelihood kernel (``ll`` and the EEP
   prior's two columns per star) against its plain PyTorch version on the
   card at the MIST-scale grid, for two plans (one system of three stars:
   blended J, H, K, an AO camera with two companions in relative J, H, K,
   spectroscopy on the primary, a parallax; and two systems in one parameter
   vector) at B = 131072, 24576, 12288 and the nested fit's 1024 points (one
   lane per point taking the stars in turn, then 2, 4 and 8 lanes per star),
   and for plans of 1, 5 and 16 stars (a count that is no power of two, and
   the cap) at two batches each, so that every group width the launch
   geometry can choose runs; float64 and
   float32, on adversarial rows (exact and top knots, one star off the grid
   while the others are on it, NaN); identical -inf and NaN patterns; the
   kernel's device time beside its bound, and its time at 1, 2, 3, 8 and 16
   stars (rows in proportion) at 1024 and 131072 points;
10. tree slice: a folder whose ``star.ini`` this script writes from a known
    truth, through ``StarModel.from_ini`` in float32: lnpost at the truth, a
    131072-point ``lnpost_batch`` through the fused path (the kernel's
    columns feed the prior) against the composed path (the prior
    interpolates for itself) and the plain path in float64, throughput of
    all three, and one 1024-point call of each under the profiler;
11. tree fit: ``fit(n_live_points=1000, seed=0, checkpoint=True)`` (dynamic
    by default) on that model; logz finite, not truncated, the kernel
    launched, the distance posterior holding the truth; then ``save_hdf`` ->
    ``load_hdf`` with equal samples and evidence;
12. the entry point: ``isochrones_torch.cli.starfit.main`` on a flat
    (``--binary``) and a tree (``--tree``) folder at the default synthetic
    grid; results files loadable, ``starfit.log`` written, kernel B launched
    by the derived samples; then the resume
    check on the card: a fit stopped after two chunks and resumed gives
    bitwise the samples of the fit that never stopped;
13. EEP inversion on the card, at the MIST-scale grid: ``track.get_eep`` fast
    at 1,000,000 points and accurate at 100,000 (mass, age, [Fe/H] spread
    past the grid, exact knots, NaN) in float64 against the same functions on
    the CPU (identical NaN pattern, values to 1e-9); a mass -> EEP -> age
    round trip; ``iso.get_eep(..., accurate=True)`` likewise with its mass
    round trip; wall-clock, device time and kernel launches per call of both
    modes in float32 (the profiler's count beside the wrappers' own), beside
    the bytes bound (every form one launch of kernel F: the fast EEP alone,
    the fast EEP with the Newton step, the Newton step from EEP 300 on the
    isochrone grid);
14. the simulated cluster and the nested cluster fit: ``SimulatedCluster``
    built on the card reproduces the committed 50-star catalogue column by
    column (drawn columns exactly, EEPs and magnitudes to 1e-9); the cluster
    kernel against its plain version at the nested fit's W = 1024 walkers,
    (50, 700, 3), both dtypes, timed; one W = 1024 ``lnpost_batch`` under the
    profiler (launches, device time, idle share; kernel B three launches),
    and the cluster kernel alone on the arguments that call hands it, beside
    the bound on those inputs; ``StarClusterModel.fit`` (nested, dynamic by default) in float32 at a
    reduced number of live points: logz finite, not truncated, the cluster
    kernel and kernel B launched, the distance posterior's 95% interval
    holding 300 pc;
15. the cluster entry point: ``isochrones_torch.cli.clusterfit``'s ``main``
    in a subprocess on a CSV written from phase 14's catalogue (default
    synthetic grid, small ``--nlive``): exit 0, a finite evidence in its
    log, the cluster kernel and kernel B launched (the counts it prints);
16. the catalog kernel, both instantiations (the log-posterior: likelihood,
    default priors, bounds and EEP change of variables; and the likelihood's
    triple) against their plain versions at the MIST-scale grid: a seeded
    catalogue of 256 stars in J, H, K with Teff, logg and a parallax (some
    stars without H, without a parallax, one without Teff, one without any
    band), 256 points a star (half about each truth, half over the grid with
    adversarial rows) and the MCMC fit's 32, and the posterior's unit-cube
    form at 256 (the nested fit's call, the box map in the kernel); float64,
    and float32 against the float64 plain version on the same float32 values
    and constants; identical NaN and +-inf patterns; the kernels' device time
    beside the posterior's bound, its plain version's time and the earlier
    likelihood-only kernel's;
17. the catalog fits on that catalogue in float32: one ``lnpost_batch`` at
    each fit's batch (the nested one on unit-cube points) must be one
    posterior launch and at most ``CAT_CALL_KERNELS`` device kernels under
    the profiler (wall-clock, idle share), beside a single-star call;
    ``fit_catalog(method="mcmc")`` (64 walkers, 300 + 50 steps) with its
    summary, then ``BatchStarFitter.fit_multinest(256 live points, n_batch
    32, n_chains 8)`` and ``summarize_batch``, then the same fit dynamic (an
    ESS target of 2000, two thread rounds at most; the per-star host merges
    timed), each beside the earlier design's wall-clock; finite evidences, every star
    converged in both nested fits, the true distance inside the 95% interval
    for at least 95% of the stars;
18. the catalog entry point: ``python -m isochrones_torch.cli.fit_catalog``
    as a subprocess on a 16-star CSV (default synthetic grid, nested, 64 live
    points): the summary's columns and evidences;
19. independent runs: ``BinaryStarModel.fit_multinest(n_runs=4)`` at 500
    live points (``run_nested``'s lockstep runs through the star kernel):
    four finite run evidences and the distance interval holding the truth;
20. the forward-model kernel (kernel F, ``csrc/generate.cu``) against
    ``generate_plain`` on the card at the MIST-scale grid, all 15 columns and
    11 bands: 1,000,000 seeded points (mass log-uniform 0.1-10, ages 8-10.2,
    [Fe/H] -2.2-0.7, with exact and top knots, NaN rows and ages past every
    track's end) in float64 (EEPs bitwise) and float32 (against the float64
    plain version on the same float32 tables and inputs), every form: the
    inversion with ``all_As`` off and on, EEPs given, the EEP alone, a column
    subset, no columns, and the accurate forms (the fast EEP and the Newton
    step in the kernel: with the forward model, the EEP alone, and the Newton
    step from EEP 300 on the isochrone grid), their EEPs against the plain
    Newton step (``check_newton``); every form's device time beside its bound
    and its plain version's; the fast ``get_eep_batch`` through the kernel at
    phase 13's points (wall-clock, device time, launches) beside the plain
    torch figures it replaced;
21. the forward model and a population in float32 through the
    interpolators, with the plain versions made to raise: ``track.generate``
    of 1,000,000 stars (host round trip) and ``generate_device`` (no
    read-back), ``generate_binary``, ``iso.isochrone(9.0)``, ``model_mag``
    approximate and accurate (one launch each), ``generate(accurate=True)``
    (one launch), and ``StarPopulation`` in ``bench.py``'s configuration:
    ``generate(100_000, exact_N=True)`` gives exactly 100,000 rows with no NaN
    total magnitude, and ``deredden`` equals regeneration at AV = 0; stars per
    second; kernel F launched;
22. the population entry point: ``python -m isochrones_torch.cli.generate_cmd
    1000 --models synthetic --seed 0`` as a subprocess: exit 0 and 1000 rows;
23. the MIST grids from files: a tree of MIST-format files written under a
    temporary ``$ISOCHRONES`` (``isochrones_torch.grids.mist_files``, one
    process a [Fe/H]: the isochrones on MIST's 15 [Fe/H]s x 107 ages x 1710
    EEPs, tracks of 95 masses a [Fe/H] with some cut short, UBVRIplus and
    WISE tables), ``get_ichrone("mist")`` built from the files and again from
    the caches (bitwise the same tables) in float64, then float32; the star
    kernel at 1024 and 131072 points in the bench box, kernel F (fast, EEPs
    given, accurate) and ``get_eep(accurate=True)`` on both grids against
    their plain versions on these grids; ``isochrone`` on the card against
    the CPU; then the default ``starfit`` (no ``--models``) on a flat binary
    and a tree folder whose magnitudes come from this grid: exit 0, both
    kernels launched, the results files reload onto the MIST grid, finite
    evidences, the true distance inside the 95% intervals;
24. the joint isochrone + track model on phase 23's grids
    (``IsoTrackModel(get_ichrone("mist"), get_ichrone("mist",
    tracks=True))``, float64 and float32, a star with Teff, logg, [Fe/H],
    J, H, K, G and a parallax): the star kernel on the track grid against
    its plain version (131072 points, all three outputs); ``lnpost_batch``
    at 1024 and 131072 points (the bounds box, track-consistent ages,
    adversarial rows) against the composed plain path in float64 (1e-9,
    identical NaN and -inf patterns) and against the fused path with the
    plain likelihood on the same float32 values in float32, exactly two
    kernel launches a call and the composed path never called; wall-clock,
    device time, launches and idle share of one call at both batches; then
    ``fit()`` (nested, 500 live points) and ``fit()`` with ``use_emcee``
    on the card (seconds, launches; the nested distance interval holding
    the truth), and a ``SingleStarModel`` fitted on the MIST track grid
    whose results file reloads onto that grid;
25. the other engines: the backward kernels A' (star) and C' (tree) against
    torch autograd of their plain versions with seeded cotangents, at the
    NUTS fits' 4 and the leaf's 8 chains (idle lanes in the launch) and at
    1024 and 131072 points (the adversarial rows of phases 6 and 9), in float64
    and float32 (against the float64 plain version on the same float32
    values), identical NaN and +-inf patterns (``check_grad``); their device
    times at the same four batches beside their bounds and the plain
    versions' (autograd forward and backward), at 4 and 8 points also the
    median and spread of 400 launches after a warm-up and A's forward beside
    A', with ``--parent-csrc`` the parent's A' and C' in turns; one NUTS
    leaf's wall-clock and device kernels (kernels A and
    A' once each); ``BinaryStarModel.fit_nuts`` on the bench binary in
    float32 and float64 and the three-star tree ``StarModel.fit_nuts``, with
    the plain likelihoods made to raise: finite lnprob, the distance median
    within 10 pc of the truth, both kernels launched, the frozen chains
    counted, the posterior's gradient at the chains' last draws equal to the
    plain versions' in float64 and far from the one without the likelihood's
    part, the lnprob quantiles printed beside the nested fits' (phases 8 and
    11); one ``fit_polychord`` (100 live points) and a short
    ``fit_mcmc_convergent`` continued from its checkpoint;
26. kernel B (``interp_nd``, ``csrc/interp_nd.cu``) and its backward B':
    B against its plain version at the cluster ladder's call (W = 1024, E =
    700, 2 columns; from the column-planar copy the ladder reads and from the
    row layout), its 1-column property call, ``interp_mag``'s 4-d BC call,
    every model column at 100,000 adversarial points and a searchsorted-axis
    shim, float64 and float32, identical NaN patterns; B' against autograd of
    the plain version at the seismic terms' call (131072 points); their
    device times beside the bounds (with ``--parent-csrc`` the parent's B on
    every call and B' at 4, 8 and 131072 points in turns), the plain
    versions, ``grid_sample`` and its backward, and the planar copies'
    bytes; then a binary with
    ``nu_max`` and ``delta_nu`` observed: ``lnpost_batch`` at 131072 points
    against the plain path, and ``fit_nuts`` at the cut setting through A,
    A', B and B' with the plain versions made to raise;
27. the rest of starfit's surface on phase 23's grids: a ``star.ini`` with
    the position and 2MASS J, H, K of a single star, an injected Gaia table
    of three sources (the closest the star's G, BP, RP and parallax, one
    failing the quality cuts), ``starfit --gaia --write_ini --models mist``
    without ``--no_plots`` for the single and the binary model: the ini
    gained the parallax and the ``[gaia]`` section, the fits' observables
    hold G, BP, RP and the parallax, kernels A and B launched, the distance
    interval holds the truth; the plots drawn where matplotlib imports, else
    (the card's machine has none) the results files written and both fits
    logged as failures, as the JAX package does; then ``starfit-summarize``
    (a CSV table, and ``--results-txt`` for both) and ``starmodel-select``
    on the folder;
28. the device mesh (``isochrones_torch.parallel``): ``default_mesh()`` over
    the machine's cards, and a mesh of one card more refused; four shards on
    the one card (``Mesh([cuda:0] * 4)``): the binary's 131072-point
    ``lnpost_batch`` through ``sharded_lnpost`` against the plain call
    (bitwise where kernel A takes the same launch geometry at both batches,
    else the float32 star bar), kernel A four launches against one, both
    wall-clocks; the 50-star cluster with its star axis on four shards at
    the nested fit's 1024 walkers: one ``lnpost_batch`` against the
    unsharded model in float64 (1e-12 relative) and float32 (the slice's
    bar), four cluster-kernel and twelve kernel-B launches a call, then the
    nested fit sharded and unsharded at the cut setting ``CLUSTER_MESH_FIT``
    (logz equal, or within 3 combined logzerr); the 256-star catalogue's
    ``BatchStarFitter.fit_mcmc`` with its star axis on four shards against
    the unsharded fit (kernel E four launches a call); a short binary
    ``fit_nuts`` with its chains on two shards against the unsharded fit
    (A and A' launches); then a real two-process fleet of ``python -m
    isochrones_torch.cli.starfit --multihost`` on the card over four
    folders written as phase 12 writes its own: the shards disjoint and
    complete, every folder's results file written, the end barrier passed
    by both processes;
29. the JAX package's HDF5 files, read and written without h5py or pandas
    (``isochrones_torch.hdf5``): phase 27's results files reread, their
    samples bitwise the fits', each model reloaded onto the card in float32
    and one ``lnpost_batch`` of its stored draws (one launch of kernel A)
    within the star's float32 bar of the stored lnprob, ``save_hdf`` and
    ``load_hdf`` of the binary fit timed; ``clusterfit`` from phase 14's
    table written in pandas' ``fixed`` layout against the same table as CSV
    (bitwise samples and logz, equal launches of the cluster kernel and
    kernel B); the fit-catalog CLI from phase 17's table in pandas' ``table``
    layout, deflated, against its CSV (bitwise output, equal launches of
    kernel E); ``fit_mcmc_convergent`` stopped after one chunk and resumed
    from its HDF5 checkpoint, bitwise the uninterrupted run.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_SHAPES = ((7, 50, 4), (50, 700, 3), (50, 1710, 3))
MAIN_SHAPE = (50, 700, 3)  # the slice's (stars, ladder points, bands)
W_KERNEL = 8  # walkers per half-step of the 16-walker ensemble
#: float64 kernel vs float64 plain: same inputs, sums in another order
RTOL_F64 = 1e-10
#: float32 kernel vs float64 plain on the same (float32) inputs: each star's
#: ln-marginal is the log of a weighted sum over ~1e5-1.5e6 cells whose
#: exponents are O(10-1000) nats; float32 rounding of the per-cell exponent
#: (~6e-8 relative) and of the running sums gives errors up to ~1e-5
#: relative. The kernel's ex2.approx exponentials add ~2 ulp (~2.4e-7
#: relative) to each cell's weight and each band's 1 + e^-|d| factor, which
#: moves a ln-marginal by ~1e-6 absolute; the residuals, formed as
#: fma(m, g, -m_obs g), act as an error of <= 0.5 ulp in the observed
#: magnitude (~5e-7 mag, ~1e-5 nats per band at 1-sigma residuals). So 1e-4
#: relative (1e-3 absolute near 0) holds with margin
RTOL_F32, ATOL_F32 = 1e-4, 1e-3
#: float32 slice vs float64 plain slice: the grid itself is rounded to
#: float32, shifting model magnitudes by ~1e-6 mag; with 0.02 mag errors each
#: of 50 stars moves by ~1e-3 nats, so 0.05 nats + 1e-4 relative
RTOL_SLICE_F32, ATOL_SLICE_F32 = 1e-4, 0.05
RTOL_SLICE_F64 = 1e-9

#: float64 star kernel vs float64 plain: same inputs, other rounding of
#: log/pow and of the corner sums
RTOL_STAR_F64 = 1e-10
#: float32 star kernel vs float64 plain on the same (float32) tables and
#: points: magnitudes carry ~1e-6 relative float32 rounding (~1e-5 mag), so
#: a photometry term with residual r and error u moves by ~r/u^2 * 1e-5;
#: relative 1e-4 covers the far points (ll ~ -1e6), 0.05 nats the near ones
RTOL_STAR_F32, ATOL_STAR_F32 = 1e-4, 0.05
STAR_BANDS = ("J", "H", "K", "G")
#: the bench's binary (bench.py:540-543): EEPs 350 and 300, age, feh,
#: distance [pc], AV
STAR_TRUTH = (350.0, 300.0, 9.0, 0.0, 200.0, 0.1)
#: bench_binary_lnpost's batch and parameter box (bench.py:214-225)
STAR_BATCH = 1 << 17
STAR_BOX = ((200, 450), (200, 450), (8.5, 9.5), (-0.5, 0.3), (100, 300), (0.0, 0.5))
NESTED = dict(n_live_points=1000, n_batch=64, n_chains=16, seed=0)

#: float64 tree kernel vs float64 plain: same inputs, other rounding of
#: log/pow and of the corner and flux sums; 1e-9 absolute for a ll near 0
RTOL_TREE_F64, ATOL_TREE_F64 = 1e-10, 1e-9
#: float32 tree kernel vs float64 plain on the same (float32) tables and
#: points: as for the star kernel, magnitudes carry ~1e-5 mag of float32
#: rounding, and a relative row subtracts its reference row's magnitude from
#: its own, so its residual carries twice that; with errors of 0.02-0.05 mag a
#: term with residual r moves by ~r/u^2 * 2e-5. Twice the star kernel's bars
RTOL_TREE_F32, ATOL_TREE_F32 = 2e-4, 0.1
#: the float32 tree kernel's two prior columns (the EEP-prior quantity, of
#: order 0.1-10, and its derivative, 1e-3-1) against the float64 plain
#: version on the same float32 table and points: a lerp of 8 products whose
#: weights carry ~1e-7 relative float32 rounding, so ~1e-6 relative; 1e-4
#: relative and 1e-6 absolute hold with margin
RTOL_TREE_COL_F32, ATOL_TREE_COL_F32 = 1e-4, 1e-6
#: the tree slice's truth: one system of three stars (EEPs), age, feh,
#: distance [pc], AV
TREE_TRUTH = (350.0, 300.0, 250.0, 9.0, 0.0, 200.0, 0.1)
#: the layout of tests/star3/star.ini; the magnitudes come from TREE_TRUTH.
#: ``write_tree_ini`` adds one companion block per further star
TREE_INI = """maxAV = 0.9
RA = 45.0
dec = 5.0
Teff = {Teff:.2f}, 110
feh = {feh:.3f}, 0.12
logg = {logg:.3f}, 0.09
parallax = {parallax:.4f}, 0.05

[twomass]
J = {J:.4f}, 0.021
H = {H:.4f}, 0.019
K = {K:.4f}, 0.013
"""
TREE_INI_COMPANION = """separation_{i} = {sep:.1f}
PA_{i} = {pa}
K_{i} = {dK:.4f}, {uK}
H_{i} = {dH:.4f}, {uH}
J_{i} = {dJ:.4f}, {uJ}
"""
#: the layout and values of tests/star4/star.ini (companions seen in other
#: bands by a second instrument), fitted as two systems: index=[0, 0, 1]
TREE_INI_TWO_SYSTEMS = """maxAV = 0.2
RA = 310.25
dec = -12.5
Teff = 5650, 120
feh = 0.05, 0.12
logg = 4.38, 0.09

[twomass]
J = 9.42, 0.02
H = 9.06, 0.02
K = 8.97, 0.02

[speckle]
resolution = 0.5
separation_1 = 4.2
PA_1 = 75.0
H_1 = 3.1, 0.02
K_1 = 2.9, 0.05
separation_2 = 11.5
PA_2 = 210.0
H_2 = 6.4, 0.03
"""
#: a flat folder for the entry point: the binary of STAR_TRUTH
FLAT_INI = """RA = 123.4
dec = -12.3
Teff = {Teff:.2f}, 100
logg = {logg:.3f}, 0.1
parallax = 5.0, 0.05

[twomass]
J = {J:.4f}, 0.02
H = {H:.4f}, 0.02
K = {K:.4f}, 0.02
"""
TREE_FIT = dict(n_live_points=1000, seed=0, checkpoint=True)
CLI_LIVE = 200
#: truths on the default synthetic grid (EEPs 1-200), which the CLI builds
CLI_STAR_TRUTH = (45.0, 35.0, 9.0, 0.0, 200.0, 0.1)
CLI_TREE_TRUTH = (45.0, 35.0, 28.0, 9.0, 0.0, 200.0, 0.1)

#: H100 SXM peaks the kernels' bounds are taken against: HBM and dense
#: float32/float64 rates from the data sheet; special functions (exp2, log2,
#: rcp, ...) at 16 results per clock per SM on 132 SMs at the 1980 MHz
#: maximum SM clock
HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "float64": 34e12}
SFU_PER_S = 16 * 132 * 1.98e9

TRUTH = (9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3)
P0_SCALE = (0.02, 0.02, 2.0, 0.01, 0.1, 0.03, 0.03)
GRID = dict(n_feh=15, n_mass=196, n_eep=1710, n_age=107)
MODEL = dict(bands=("J", "H", "K"), props=("parallax",), eep_bounds=(1, 1400), eep_step=2.0,
             max_distance=3000, minq=0.2, mass_bounds=(0.6, 2.0))
FIXTURE = os.path.join("isochrones_torch", "data", "cluster50_synthetic.csv")
#: kernel B's launches in one cluster lnpost_batch whose only property is the
#: parallax: the ladder's mass columns, interp_mag's model and BC lerps
INTERP_PER_CLUSTER_CALL = 3


#: EEP inversion (phase 13): batch sizes; port on the card against port on
#: the CPU in float64: the same arithmetic, reductions in another order
EEP_FAST_POINTS, EEP_ACCURATE_POINTS = 1_000_000, 100_000
ATOL_EEP = 1e-9
#: the accurate inversion in float32, kernel against the plain version in
#: float32 on the card: both iterate to the root of the same float32
#: residual, which each rounds in its own order (~1e-6 of a log age or a
#: mass); over the slope (>= ~1e-3 a unit of EEP on these grids) that moves
#: the fixed point by ~1e-3 EEP; a point can cross the resid_tol cut only
#: where its residual lies that close to the cut
ATOL_NEWTON_F32, RESID_EDGE_F32, KNIFE_ROWS_F32 = 1e-2, 1e-5, 1e-5
#: the nested cluster fit (phase 14): the catalogue's settings (those of
#: scripts/make_torch_cluster_fixture.py), the fit's walker batch (n_batch 64
#: x n_chains 16) and the reduced depth
CLUSTER_SIM = dict(age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3, bands=("J", "H", "K"),
                   mass_range=(0.6, 2.0), rng=0, phot_unc=0.02, distance_scatter=0.0)
W_FIT = 1024
CLUSTER_FIT = dict(n_live_points=256, seed=0)
#: columns the simulator draws on the host (equal bit for bit) and columns
#: that go through the interpolators (ATOL_EEP)
SIM_DRAWN = ("is_binary", "distance", "mass_pri", "mass_sec", "parallax", "parallax_unc",
             "J_mag_unc", "H_mag_unc", "K_mag_unc")
SIM_INTERPOLATED = ("J_mag", "H_mag", "K_mag", "eep_pri", "eep_sec")
#: the CLI's fit (phase 15): the default synthetic grid has 200 EEPs where
#: the catalogue's grid has 1710, so the ladder's bounds scale by 200 / 1710
CLUSTER_CLI = ["--models", "synthetic", "--dtype", "float32", "--nlive", "64", "--mineep", "1", "--maxeep", "164",
               "--max_distance", "3000", "--minq", "0.2", "--name", "smoke"]

#: the catalog (phases 16-18): the JAX package's catalog row (its README,
#: 256 stars in J, H, K), with Teff, logg and a parallax; truths' EEPs in the
#: bench box of the MIST-scale grid, and the same box scaled to the default
#: synthetic grid's 200 EEPs for the CLI
CAT_STARS = 256
CAT_BANDS = ("J", "H", "K")
CAT_EEP_BOX = (200.0, 450.0)
CLI_EEP_BOX = (200.0 * 200 / 1710, 450.0 * 200 / 1710)
CAT_POINTS = 256
CAT_MCMC = dict(nwalkers=64, nburn=300, niter=50, seed=0)
#: the earlier likelihood-only catalog kernel at these batches (PERF.md, row
#: E's earlier time), printed beside this run's posterior kernel
CAT_EARLIER_MS = {CAT_POINTS: 0.0414, CAT_MCMC["nwalkers"] // 2: 0.0120}
#: device kernels one catalog lnpost_batch may launch: the posterior kernel,
#: and nothing else on a tensor already of the fitter's dtype and device
CAT_CALL_KERNELS = 1
#: the catalog fits with their summaries when the priors ran in eager torch
#: around that kernel (seconds; 710, 4236 and 6444 launches; PERF.md),
#: printed beside this run's
CAT_EARLIER_FIT_S = {"mcmc": 3.756, "nested": 12.525, "dynamic": 28.163}
CAT_NESTED = dict(n_live_points=256, n_batch=32, n_chains=8, seed=0)
#: the dynamic catalog fit: an ESS target above what the base runs reach
#: (~1100 at these settings), two thread rounds at most
CAT_DYNAMIC = dict(dynamic=True, min_ess=2000.0, max_dynamic_rounds=2)
CAT_CLI = ["--models", "synthetic", "--dtype", "float32", "--method", "nested", "--n-live-points", "64", "--seed",
           "0"]
#: independent runs of the binary fit (phase 19)
MULTI_RUNS = dict(n_live_points=500, n_runs=4, seed=0)

#: phase 23: a tree of MIST-format files (``isochrones_torch.grids.mist_files``)
#: under a temporary ``$ISOCHRONES``. The isochrones on MIST's own axes (its 15
#: [Fe/H]s, 107 ages, log age 5.0-10.3, EEPs 1-1710, initial masses 0.1-300);
#: tracks at the 15 [Fe/H]s of MIST_TRACK_MASSES (a cut: MIST has 196 masses,
#: 0.1-300), each as long as ``max_eep`` makes it but MIST_SHORT's, which the
#: pipeline completes from their neighbours; BC tables of UBVRIplus and WISE
#: on the synthetic BC grid's axes (53 Teff x 15 logg x 11 [Fe/H] x 13 AV)
MIST_AGES = tuple(float(a) for a in np.round(np.linspace(5.0, 10.3, 107), 2))
MIST_ISO_MASSES = (0.1, 300.0)
MIST_TRACK_MASSES = tuple(float(m) for m in np.unique(np.round(np.geomspace(0.1, 10.0, 100), 2)))
#: ([Fe/H], the track mass nearest this value): rows written (max_eep is 1710)
MIST_SHORT = ((0.0, 1.0, 1500), (-1.0, 2.0, 1300), (-2.0, 3.0, 1650), (0.25, 1.5, 1709))
MIST_BC = dict(systems=("UBVRIplus", "WISE"), fehs=tuple(np.linspace(-4.0, 1.0, 11)),
               teffs=tuple(np.concatenate([np.linspace(2000.0, 12000.0, 41), np.linspace(13000.0, 50000.0, 12)])),
               loggs=tuple(np.linspace(-1.0, 6.0, 15)), avs=tuple(np.linspace(0.0, 6.0, 13)))
#: kernel F's points on the MIST-read track grid, and the star kernel's batches
MIST_GEN_POINTS = 200_000
MIST_STAR_BATCHES = (1024, STAR_BATCH)
#: phase 24: the star (eep, age, feh, distance, AV) on phase 23's grids,
#: the lnpost batches (the nested fit's and the bench's), the fits
ISOTRACK_TRUTH = (350.0, 9.0, 0.0, 200.0, 0.1)
ISOTRACK_BATCHES = (1024, STAR_BATCH)
ISOTRACK_NESTED = dict(n_live_points=500, seed=0)
ISOTRACK_MCMC = dict(nwalkers=256, nburn=200, niter=100, seed=0)
TRACK_NESTED = dict(n_live_points=200, seed=0)
#: float64 lnpost_batch through the two launches vs the composed plain path:
#: another order of the same sums
RTOL_ISOTRACK_F64 = 1e-9
#: phase 27: a single star (EEP, log age, [Fe/H], distance [pc], AV) on phase
#: 23's grids, its star.ini (position and 2MASS J, H, K from the truth) and
#: the injected Gaia table: the closest source the truth's G, BP, RP and
#: parallax, a brighter one that fails the quality cuts, a farther one
GAIA_TRUTH = (350.0, 9.0, 0.0, 200.0, 0.1)
GAIA_INI = """RA = 123.4
dec = -12.3

[twomass]
J = {J:.4f}, 0.02
H = {H:.4f}, 0.02
K = {K:.4f}, 0.02
"""


def make_kernel_inputs(S, E, B, W, seed=0):
    """Seeded numpy inputs of the batched cluster marginal, made like
    ``tests/test_cluster_pallas.py``'s fixture, per walker: invalid ladder
    rows, a secondary mask wider than the primary one, a -inf entry, an
    all -inf (no support) star and, in one walker, a NaN star."""
    rng = np.random.default_rng(seed)
    eeps = np.sort(rng.uniform(200, 400, E))
    valid = rng.random((W, E)) > 0.1
    valid_k = valid | (rng.random((W, E)) < 0.05)
    either = valid | valid_k
    lnprop = rng.normal(-2, 1, (W, S, E))
    lnprop[:, 0, min(3, E - 1)] = -np.inf
    if S > 2:
        lnprop[:, 2, :] = -np.inf
        lnprop[min(1, W - 1), 1, :] = np.nan
    return dict(
        lnlike_prop=lnprop,
        model_mags=np.where(either[..., None], rng.normal(10, 2, (W, E, B)), 0.0),
        masses=np.where(either, np.sort(rng.uniform(0.3, 2.0, (W, E)), axis=-1), 1.0),
        ln_dm_deeps=np.where(either, rng.normal(-3, 0.5, (W, E)), 0.0),
        eeps=eeps,
        mag_values=rng.normal(10, 2, (S, B)),
        mag_uncs=rng.uniform(0.05, 0.2, (S, B)),
        alpha=rng.uniform(-3.0, -1.5, W),
        gamma=rng.uniform(0.1, 0.5, W),
        fB=rng.uniform(0.1, 0.6, W),
        mass_lo=0.3, mass_hi=2.0, q_lo=0.2,
        valid=valid, valid_k=valid_k,
    )


def to_torch(inputs, device, dtype):
    """numpy inputs -> positional args and keywords of the batched call."""
    import torch

    def t(k):
        x = inputs[k]
        return torch.as_tensor(x, device=device, dtype=torch.bool if x.dtype == bool else dtype)

    args = [t(k) for k in ("lnlike_prop", "model_mags", "masses", "ln_dm_deeps", "eeps",
                           "mag_values", "mag_uncs", "alpha", "gamma", "fB")]
    args += [inputs["mass_lo"], inputs["mass_hi"], inputs["q_lo"]]
    return args, dict(valid=t("valid"), valid_k=t("valid_k"))


def as_float32(inputs):
    return {k: (v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64 else v)
            for k, v in inputs.items()}


def check_close(name, got, ref, rtol, atol=0.0):
    """``got`` holds no NaN (a star without support is -inf), its finite
    pattern equals ``ref``'s (whose NaN stars, from NaN inputs, count as
    non-finite) and |got - ref| <= atol + rtol |ref|; returns the max
    absolute error over the finite entries."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if np.isnan(got).any():
        raise AssertionError(f"{name}: NaN in the result")
    fin = np.isfinite(ref)
    if not np.array_equal(np.isfinite(got), fin):
        raise AssertionError(f"{name}: finite/-inf pattern differs:\n{np.isfinite(got)}\n{fin}")
    err = np.abs(got[fin] - ref[fin])
    bad = err > atol + rtol * np.abs(ref[fin])
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} entries out of tolerance, max abs err {err.max()}")
    return float(err.max()) if err.size else 0.0


def star_observations(ic, truth=STAR_TRUTH, bands=STAR_BANDS):
    """The bench's binary observations (bench.py:540-553) made with the
    port's ``interp_mag``: Teff and logg of the primary, flux-summed band
    magnitudes of both components, a 5 mas parallax."""
    eep0, eep1, age, feh, dist, av = truth
    Teff, logg, _, mags0 = ic.interp_mag([eep0, age, feh, dist, av], list(bands))
    _, _, _, mags1 = ic.interp_mag([eep1, age, feh, dist, av], list(bands))
    tot = -2.5 * np.log10(10 ** (-0.4 * np.asarray(mags0)) + 10 ** (-0.4 * np.asarray(mags1)))
    obs = dict(Teff=(Teff, 100.0), logg=(logg, 0.1))
    obs.update({b: (float(m), 0.01 if b == "G" else 0.02) for b, m in zip(bands, tot)})
    obs["parallax"] = (5.0, 0.05)
    return obs


def star_points(knots, n_stars, batch, seed=0, box=None):
    """Seeded (batch, N + 4) numpy parameters (N EEPs, age, feh, distance,
    AV) for an isochrone grid with axis ``knots`` (age, feh, eep): uniform in
    ``box`` (default: the grid's box), with adversarial blocks in the first
    half: exact interior knots, top and bottom knots, out-of-bounds
    coordinates, NaN, AV past the BC grid, distance <= 0."""
    rng = np.random.default_rng(seed)
    ages, fehs, eeps = (np.asarray(k.cpu().double() if hasattr(k, "cpu") else k, dtype=float) for k in knots)
    if box is None:
        box = [(eeps[0], eeps[-1])] * n_stars + [(ages[0], ages[-1]), (fehs[0], fehs[-1]), (10.0, 3000.0),
                                                 (0.0, 1.5)]
    p = np.stack([rng.uniform(lo, hi, batch) for lo, hi in box], axis=-1)
    m = max(1, batch // 16)
    blocks = [slice(i * m, (i + 1) * m) for i in range(8)]
    A, F, D, V = n_stars, n_stars + 1, n_stars + 2, n_stars + 3
    p[blocks[0], :n_stars] = rng.choice(eeps, (len(p[blocks[0]]), n_stars))
    p[blocks[1], A] = rng.choice(ages, len(p[blocks[1]]))
    p[blocks[1], F] = rng.choice(fehs, len(p[blocks[1]]))
    p[blocks[2], :n_stars] = eeps[-1]
    p[blocks[2], A] = ages[-1]
    p[blocks[3], F] = np.where(rng.random(len(p[blocks[3]])) < 0.5, fehs[0], fehs[-1])
    p[blocks[3], 0] = eeps[0]
    p[blocks[4], 0] = eeps[0] - 0.5
    p[blocks[4], A] = np.where(rng.random(len(p[blocks[4]])) < 0.5, ages[-1] + 0.01, p[blocks[4], A])
    rows = np.arange(batch)[blocks[5]]
    p[rows, rng.integers(0, n_stars + 4, len(rows))] = np.nan
    p[blocks[6], V] = 7.0
    p[blocks[7], D] = np.where(rng.random(len(p[blocks[7]])) < 0.5, -5.0, 0.0)
    return p


def isotrack_points(model, batch, seed=0):
    """Seeded (batch, 6) numpy parameters (eep, mass, age, feh, distance, AV)
    of an ``IsoTrackModel``: uniform in the model's bounds box, the age of
    the second half the track's age at the row's (mass, eep, feh) within 0.01
    dex (where both grids and the EEP prior can be finite), and adversarial
    blocks in the first quarter: exact knots of both grids, top and bottom
    knots, coordinates past either grid, NaN, AV past the BC grid, distance
    <= 0, EEP, AV and distance past the bounds."""
    rng = np.random.default_rng(seed)
    ages, fehs, eeps = (k.cpu().double().numpy() for k in model.iso.model.knots)
    masses = model.track.model.knots[1].cpu().double().numpy()
    los, his = (np.asarray(x, dtype=float) for x in model._bounds_arrays())
    p = los + (his - los) * rng.random((batch, 6))
    half = np.arange(batch // 2, batch)
    age = model.track.interp_value([p[half, 1], p[half, 0], p[half, 3]], ["age"])[:, 0]
    p[half, 2] = np.where(np.isfinite(age), age + rng.normal(0, 0.01, len(half)), p[half, 2])
    m = max(1, batch // 40)
    blocks = [slice(i * m, (i + 1) * m) for i in range(10)]
    n = [len(p[b]) for b in blocks]
    p[blocks[0], 0], p[blocks[0], 1] = rng.choice(eeps, n[0]), rng.choice(masses, n[0])
    p[blocks[1], 2], p[blocks[1], 3] = rng.choice(ages, n[1]), rng.choice(fehs, n[1])
    p[blocks[2], 0], p[blocks[2], 1], p[blocks[2], 2] = eeps[-1], masses[-1], ages[-1]
    p[blocks[3], 0], p[blocks[3], 1] = eeps[0], masses[0]
    p[blocks[3], 3] = np.where(rng.random(n[3]) < 0.5, fehs[0], fehs[-1])
    p[blocks[4], 0] = eeps[0] - 0.5
    p[blocks[4], 1] = np.where(rng.random(n[4]) < 0.5, masses[-1] * 1.01, p[blocks[4], 1])
    p[blocks[4], 2] = np.where(rng.random(n[4]) < 0.5, ages[-1] + 0.01, p[blocks[4], 2])
    rows = np.arange(batch)[blocks[5]]
    p[rows, rng.integers(0, 6, len(rows))] = np.nan
    p[blocks[6], 5] = 7.0
    p[blocks[7], 4] = np.where(rng.random(n[7]) < 0.5, -5.0, 0.0)
    p[blocks[8], 0] = his[0] + 1.0
    p[blocks[9], 4] = his[4] * 1.1
    p[blocks[9], 5] = np.where(rng.random(n[9]) < 0.5, his[5] + 0.2, p[blocks[9], 5])
    return p


def isotrack_observations(iso, truth, bands=STAR_BANDS):
    """One star's observations at ``truth`` (eep, age, feh, distance, AV) on
    the isochrone grid: Teff, logg, [Fe/H], the band magnitudes and the
    parallax of its distance."""
    eep, age, feh, dist, av = truth
    Teff, logg, _, mags = iso.interp_mag([eep, age, feh, dist, av], list(bands))
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), feh=(float(feh), 0.1))
    obs.update({b: (float(m), 0.02) for b, m in zip(bands, np.asarray(mags))})
    obs["parallax"] = (1000.0 / dist, 0.05)
    return obs


def star_grid_variant(pack6, bc, kind):
    """``(pack6, bc)`` with other axes, so that every kind of the kernel's
    cell location runs: "default" as built (affine age and feh, exact-affine
    EEP; BC: compare Teff, exact-affine logg, feh, AV), "log" (log-uniform
    age knots), "compare" (irregular feh knots), "searchsorted" (no axis
    maps on either grid). Values are kept: only the coordinates move."""
    import torch

    from isochrones_torch.ops.interp import compute_axis_maps

    if kind == "default":
        return pack6, bc
    if kind == "searchsorted":
        return (dataclasses.replace(pack6, axis_maps=(None,) * 3), dataclasses.replace(bc, axis_maps=(None,) * 4))
    knots = [k.cpu().double().numpy() for k in pack6.knots]
    if kind == "log":
        axis = 0
        knots[0] = np.exp(np.linspace(np.log(knots[0][0]), np.log(knots[0][-1]), len(knots[0])))
    elif kind == "compare":
        axis = 1
        k = knots[1]
        d = np.diff(k) * (1.0 + 0.5 * np.sin(np.arange(len(k) - 1)))
        knots[1] = k[0] + (k[-1] - k[0]) * np.concatenate([[0.0], np.cumsum(d)]) / d.sum()
    else:
        raise ValueError(kind)
    maps = compute_axis_maps(knots)
    assert maps[axis][0] == kind, maps
    v = pack6.values
    return (dataclasses.replace(pack6, knots=tuple(torch.as_tensor(k, dtype=v.dtype, device=v.device) for k in knots),
                                axis_maps=maps), bc)


def grid_as(g, dtype):
    """The same grid in another dtype (values and knots cast; axis maps kept)."""
    return dataclasses.replace(g, values=g.values.to(dtype), knots=tuple(k.to(dtype) for k in g.knots),
                               host_values=None)


def check_star(name, got, ref, rtol, atol=0.0):
    """``got`` and ``ref`` (tuples of arrays) have identical NaN and +-inf
    patterns and agree within atol + rtol |ref| where finite; returns the max
    absolute error."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g = np.asarray(g, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        if g.shape != r.shape:
            raise AssertionError(f"{name}[{i}]: shape {g.shape} != {r.shape}")
        if not (np.array_equal(np.isnan(g), np.isnan(r)) and np.array_equal(np.isposinf(g), np.isposinf(r))
                and np.array_equal(np.isneginf(g), np.isneginf(r))):
            raise AssertionError(f"{name}[{i}]: NaN/inf pattern differs ({int(np.isfinite(g).sum())} vs "
                                 f"{int(np.isfinite(r).sum())} finite)")
        fin = np.isfinite(r)
        err = np.abs(g[fin] - r[fin])
        bad = err > atol + rtol * np.abs(r[fin])
        if bad.any():
            raise AssertionError(f"{name}[{i}]: {int(bad.sum())} entries out of tolerance, max abs err {err.max()}")
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst


#: kernel B against the plain version. Float64: the same explicitly rounded
#: products summed in another order (torch's sum over the corners), within
#: 1e-9 of the value; the absolute term, 1e-13 of the column's largest
#: magnitude, only covers values that cancel to near 0. Float32, against the
#: plain float32 version on the card (the same float32 cell location, so the
#: same cells and NaN pattern): 2**ndim float32 products in another order
#: differ by at most ~2**ndim ulps of the largest, 16 x 6e-8 = 1e-6 of the
#: column's scale at 4 axes; 2e-6 of it.
RTOL_INTERP_F64, ATOL_INTERP_F64, ATOL_INTERP_F32 = 1e-9, 1e-13, 2e-6
#: the ladder's call (W, E, 3) with its 2 columns, the all-column
#: interp_value call's points
INTERP_LADDER_W, INTERP_VALUE_POINTS = W_FIT, 100_000


def interp_scale(values, icols=None):
    """Per wanted column, the largest finite magnitude of the table
    ``values`` (numpy ``(n_icols,)``; 1 for a column with none)."""
    v = np.asarray(values.cpu().double() if hasattr(values, "cpu") else values, dtype=np.float64)
    v = v.reshape(-1, v.shape[-1])[:, list(range(v.shape[-1]) if icols is None else icols)]
    m = np.max(np.where(np.isfinite(v), np.abs(v), 0.0), axis=0)
    return np.where(m > 0, m, 1.0)


def check_interp(name, got, ref, scale, rtol, atol):
    """``interp_nd`` outputs ``(..., n_icols)``: identical NaN and +-inf
    patterns, and |got - ref| <= rtol |ref| + atol * scale (per column) where
    finite. Returns the max absolute error."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, dtype=np.float64)
    ref = np.asarray(ref.cpu() if hasattr(ref, "cpu") else ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    for what, f in (("NaN", np.isnan), ("+inf", np.isposinf), ("-inf", np.isneginf)):
        if not np.array_equal(f(got), f(ref)):
            raise AssertionError(f"{name}: {what} pattern differs ({int(f(got).sum())} vs {int(f(ref).sum())})")
    fin = np.isfinite(ref)
    err = np.where(fin, np.abs(got - ref), 0.0)
    bad = err > rtol * np.abs(np.where(fin, ref, 0.0)) + atol * np.asarray(scale)
    if bad.any():
        i = np.unravel_index(np.argmax(np.where(bad, err, -1.0)), err.shape)
        raise AssertionError(f"{name}: {int(bad.sum())} entries out of tolerance; worst at {i}: got {got[i]!r} "
                             f"ref {ref[i]!r}")
    return float(err.max()) if err.size else 0.0


def interp_points(knots, n, seed=0):
    """Seeded ``(n, ndim)`` numpy points for a grid with axis ``knots``:
    uniform over the grid's box, then in blocks of n // 16: exact interior
    knots on every axis, the top knot on one axis, the bottom knot on every
    axis, one axis just below or above its range, a NaN on one axis, and
    exact knots on a random half of the axes."""
    rng = np.random.default_rng(seed)
    ks = [np.asarray(k.cpu().double() if hasattr(k, "cpu") else k, dtype=float) for k in knots]
    nd = len(ks)
    p = np.stack([rng.uniform(k[0], k[-1], n) for k in ks], axis=-1)
    m = max(1, n // 16)
    blocks = [np.arange(n)[i * m:(i + 1) * m] for i in range(6)]
    for d, k in enumerate(ks):
        p[blocks[0], d] = rng.choice(k, len(blocks[0]))
        p[blocks[2], d] = k[0]
        half = rng.random(len(blocks[5])) < 0.5
        p[blocks[5], d] = np.where(half, rng.choice(k, len(blocks[5])), p[blocks[5], d])
    axis = rng.integers(0, nd, n)
    for d, k in enumerate(ks):
        r = blocks[1][axis[blocks[1]] == d]
        p[r, d] = k[-1]
        r = blocks[3][axis[blocks[3]] == d]
        span = k[-1] - k[0] if k[-1] > k[0] else 1.0
        p[r, d] = np.where(rng.random(len(r)) < 0.5, k[0] - 1e-3 * span, k[-1] + 1e-3 * span)
        p[blocks[4][axis[blocks[4]] == d], d] = np.nan
    return p


def write_tree_ini(folder, ic, truth=TREE_TRUTH):
    """A folder with a ``star.ini`` in the layout of tests/star3/star.ini
    whose magnitudes are those of ``truth`` (the stars' EEPs, then age, feh,
    distance, AV) through ``ic.interp_mag``: blended J, H, K of all stars,
    each companion's magnitudes relative to the primary as seen by an AO
    camera, the primary's Teff, logg and feh, the true parallax."""
    *eeps, age, feh, dist, av = truth
    comps = [ic.interp_mag([e, age, feh, dist, av], ["J", "H", "K"]) for e in eeps]
    mags = np.array([np.asarray(c[3], dtype=float) for c in comps])  # (stars, 3 bands)
    tot = -2.5 * np.log10((10 ** (-0.4 * mags)).sum(axis=0))
    text = TREE_INI.format(Teff=comps[0][0], logg=comps[0][1], feh=comps[0][2], parallax=1000.0 / dist,
                           J=tot[0], H=tot[1], K=tot[2])
    if len(eeps) > 1:
        text += "\n[AOcam]\nresolution = 0.1\n"
    for i in range(1, len(eeps)):
        d = mags[i] - mags[0]
        unc = dict(uK=0.05, uH=0.03, uJ=0.05) if i == 1 else dict(uK=0.1, uH=0.1, uJ=0.1)
        text += TREE_INI_COMPANION.format(i=i, sep=0.5 + 0.6 * (i - 1), pa=(100 * i) % 360, dJ=d[0], dH=d[1], dK=d[2],
                                          **unc)
    return write_ini(folder, text)


def write_ini(folder, text):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "star.ini"), "w") as f:
        f.write(text)
    return folder


def tree_points(param_names, knots, batch, seed=0, narrow=False):
    """Seeded (batch, n_params) numpy parameters of a tree model with the
    given parameter names (``eep_<s>_<j>``, ``age_<s>``, ``feh_<s>``,
    ``distance_<s>``, ``AV_<s>``) on an isochrone grid with axis ``knots``
    (age, feh, eep): uniform in the grid's box (``narrow``: a box around
    solar-type dwarfs, where most rows are finite), with adversarial blocks
    in the first half: EEPs on interior knots, ages and fehs on knots, the
    top knots, ONE star's EEP below the grid while the others stay on it,
    a NaN parameter, AV past the BC grid."""
    rng = np.random.default_rng(seed)
    ages, fehs, eeps = (np.asarray(k.cpu().double() if hasattr(k, "cpu") else k, dtype=float) for k in knots)
    wide = dict(eep=(eeps[0], eeps[-1]), age=(ages[0], ages[-1]), feh=(fehs[0], fehs[-1]), distance=(10.0, 3000.0),
                AV=(0.0, 1.5))
    span = eeps[-1] - eeps[0]  # the bench box's EEPs, 200-450 of 1-1710, on any ladder
    tight = dict(eep=(eeps[0] + 0.1165 * span, eeps[0] + 0.2627 * span), age=(8.5, 9.5), feh=(-0.5, 0.3), distance=(100, 300), AV=(0.0, 0.5))
    kinds = [n.split("_")[0] for n in param_names]
    box = [(tight if narrow else wide)[k] for k in kinds]
    p = np.stack([rng.uniform(lo, hi, batch) for lo, hi in box], axis=-1)
    col = {k: [i for i, kk in enumerate(kinds) if kk == k] for k in wide}
    m = max(1, batch // 16)
    blocks = [slice(i * m, (i + 1) * m) for i in range(6)]
    n0 = len(p[blocks[0]])
    p[blocks[0]][:, col["eep"]] = rng.choice(eeps, (n0, len(col["eep"])))
    p[blocks[1]][:, col["age"]] = rng.choice(ages, (n0, len(col["age"])))
    p[blocks[1]][:, col["feh"]] = rng.choice(fehs, (n0, len(col["feh"])))
    p[blocks[2]][:, col["eep"]] = eeps[-1]
    p[blocks[2]][:, col["age"]] = ages[-1]
    rows = np.arange(batch)[blocks[3]]
    p[rows, rng.choice(col["eep"], len(rows))] = eeps[0] - 0.5  # one star off the grid
    rows = np.arange(batch)[blocks[4]]
    p[rows, rng.integers(0, len(kinds), len(rows))] = np.nan
    p[blocks[5]][:, col["AV"][0]] = 7.0
    return p


def tree_likelihood_as(lk, dtype):
    """The same tree likelihood with its grids and value arrays in another
    dtype (index arrays kept)."""
    import torch

    changes = {}
    for f in dataclasses.fields(lk):
        v = getattr(lk, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            changes[f.name] = v.to(dtype)
        elif f.name in ("model", "bc", "full_model") and v is not None:
            changes[f.name] = grid_as(v, dtype)
    return dataclasses.replace(lk, **changes)


def tree_work(pars, lk):
    """``(bytes, flops, special functions)`` of the tree likelihood and the
    EEP prior's two columns on these points: the parameters read and the
    outputs (``ll`` per point, two columns per point and star) written once,
    the plan's arrays once, each distinct table row that the batch's corners
    touch read once (6 pack columns, the density column when a row needs it,
    the band columns of the BC table); per (point, star) ~70 flops of cell
    location, 8 corners x (6 weight flops + 12 lerp flops), 16 corners x (8 +
    2 per band), 3 flops and one pow per band, one log10, 2 flops per
    observation row; per point and observation row a log10 and, with the
    spectroscopy, parallax and AV rows, a log and ~6 flops per Gaussian
    term."""
    import torch

    from isochrones_torch.ops.interp import interp_nd

    B, S, nb, n_obs = pars.shape[0], lk.n_stars, len(lk.band_icols), lk.n_obs
    io = lk.index_order
    sp = pars[:, lk.star_param_idx.long()].reshape(B * S, 5)
    gp = torch.stack([sp[:, io[0]], sp[:, io[1]], sp[:, io[2]]], dim=-1)
    v6 = interp_nd(lk.model.values, lk.model.knots, gp, axis_maps=lk.model.axis_maps)
    bp = torch.stack([v6[:, 0], v6[:, 1], v6[:, 2], sp[:, io[4]]], dim=-1)
    e = pars.element_size()
    model_rows = _touched_rows(lk.model, gp)
    elems = model_rows * (6 + (lk.full_model is not None)) + _touched_rows(lk.bc, bp) * nb
    plan = sum(getattr(lk, f.name).numel() * getattr(lk, f.name).element_size() for f in dataclasses.fields(lk)
               if isinstance(getattr(lk, f.name), torch.Tensor))
    nbytes = (pars.numel() + B * (1 + 2 * S) + elems) * e + plan
    n_terms = n_obs + len(lk.spec_star) + len(lk.plax_idx) + len(lk.av_idx)
    flops = B * S * (70 + 8 * 18 + 16 * (8 + 2 * nb) + 3 * nb + 2 * n_obs) + B * 6 * n_terms
    sfu = B * S * (nb + 1) + B * (n_obs + n_terms)
    return nbytes, flops, sfu


def bound(bytes_, flops, sfu, dtype):
    """``(bound_ms, bound_by, what)``: the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over their
    pipe's peak (flops of ``dtype``, special functions)."""
    times = {"bytes": bytes_ / HBM_BYTES_PER_S, "flops": flops / FLOPS[dtype], "special functions": sfu / SFU_PER_S}
    what = max(times, key=times.get)
    return 1e3 * times[what], ("bytes" if what == "bytes" else "operations"), what


def cluster_work(args, kw):
    """``(bytes, flops, special functions)`` that the batched cluster marginal
    needs on these inputs: each input read and each output written once, and
    per cell that this run's mask keeps (k <= j, valid j and k, q >= q_lo,
    positive trapezoid weight) the least arithmetic the function needs: with
    the band sum in product form, one exp and ~10 flops per (star, band)
    (two residual FMAs, a max, a sum, a difference, a product FMA), one exp
    and ~5 flops per star (the log-sum-exp push), one log10 and ~3 flops per
    band (the binary magnitude); no logarithm per star."""
    import torch

    from isochrones_torch.ops.cluster_cuda import trapezoid_weights

    lnprop, mags, masses, _, eeps = args[:5]
    W, S, E = lnprop.shape
    B = mags.shape[-1]
    tri = torch.ones((E, E), dtype=torch.bool, device=eeps.device).tril()
    cells = 0
    for w in range(W):
        q = masses[w][None, :] / masses[w][:, None]
        mask = tri & kw["valid"][w][:, None] & kw["valid_k"][w][None, :] & (q >= args[12])
        cells += int((trapezoid_weights(eeps, mask) > 0).sum())
    tensors = [a for a in args if isinstance(a, torch.Tensor)] + list(kw.values())
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + W * S * lnprop.element_size()
    return nbytes, cells * (S * B * 10 + S * 5 + B * 3), cells * (S * (B + 1) + B)


def _touched_rows(grid, pts):
    """Distinct table rows that the 2**ndim corners of the in-bounds,
    non-NaN points ``pts`` (P, ndim) read."""
    import torch

    from isochrones_torch.ops.interp import find_cells_1d

    ndim, dims = len(grid.knots), grid.values.shape[:-1]
    bad = torch.isnan(pts).any(dim=-1)
    flat = torch.zeros((pts.shape[0], 2 ** ndim), dtype=torch.int64, device=pts.device)
    corner = torch.arange(2 ** ndim, device=pts.device)
    stride = 1
    for d in reversed(range(ndim)):
        amap = grid.axis_maps[d] if grid.axis_maps is not None else None
        cell, _, oob = find_cells_1d(grid.knots[d], pts[:, d], axis_map=amap)
        bad |= oob
        o = (corner >> (ndim - 1 - d)) & 1
        flat += torch.clamp(cell[:, None] + o, 0, dims[d] - 1) * stride
        stride *= dims[d]
    return int(torch.unique(flat[~bad]).numel())


def ladder_points(model, p):
    """The grid points ``(W, E, 3)`` of a cluster model's EEP ladder at the
    walkers ``p`` (numpy ``(W, 7)``), in the model grid's axis order: the
    points of the ladder's ``interp_nd`` calls."""
    import torch

    ic = model.ic
    n_eep = model._n_ladder
    eeps = float(model.bounds("eep")[0]) + model.eep_step * torch.arange(n_eep, dtype=ic.dtype, device=ic.device)
    pt = torch.as_tensor(p, dtype=ic.dtype, device=ic.device)
    W = pt.shape[0]
    user = [eeps.expand(W, n_eep), pt[:, :1].expand(W, n_eep), pt[:, 1:2].expand(W, n_eep)]  # eep, age, feh
    io = ic._param_index_order
    return torch.stack([user[io[0]], user[io[1]], user[io[2]]], dim=-1)


def interp_work(grid, pts, n_cols, grad=False):
    """``(bytes, flops, special functions)`` of kernel B on these points (of
    B' with ``grad``): the points read and the output written once (B': the
    points and the cotangent read, the gradient written), each distinct row
    that the corners of the in-bounds points touch read once for its wanted
    columns; ~23 flops of cell location an axis and 2**ndim corners x (2 a
    weight factor and 2 a column) a point, twice that for B' (the values
    again, then the vector-Jacobian product)."""
    nd = pts.shape[-1]
    flat = pts.reshape(-1, nd)
    P, e = flat.shape[0], flat.element_size()
    rows = _touched_rows(grid, flat)
    nbytes = (P * nd + P * n_cols + rows * n_cols + (P * nd if grad else 0)) * e
    flops = P * (23 * nd + 2 ** nd * (2 * nd + 2 * n_cols))
    return nbytes, (2 if grad else 1) * flops, 0


def grid_sample_input(grid, pts, icols):
    """``(volume (1, C, n0, n1, n2), sample grid (1, 1, 1, P, 3))``: the wanted
    columns of a 3-d table laid out for ``torch.nn.functional.grid_sample``,
    and the points mapped onto [-1, 1] by each axis' end knots, last axis
    first (grid_sample's x is the innermost axis)."""
    import torch

    vol = grid.values[..., list(icols)].permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    lo = torch.stack([k[0] for k in grid.knots])
    hi = torch.stack([k[-1] for k in grid.knots])
    u = (pts.reshape(-1, 3) - lo) / (hi - lo) * 2.0 - 1.0
    return vol, u.flip(-1).reshape(1, 1, 1, -1, 3).contiguous()


def grid_sample_backward(grid, pts, icols, cot, kernel_grad):
    """``(fn, diff)``: ``fn`` runs ``torch.nn.functional.grid_sample``'s
    backward for the sample grid alone (the volume takes no gradient) on the
    wanted columns of a 3-d table at ``pts`` with the cotangent ``cot``
    ``(P, C)``, the work of kernel B' (the library's yardstick, timed by its
    ``grid_sampler_3d_backward`` kernel); ``diff`` is the largest difference
    from B''s gradient ``kernel_grad`` after the chain rule of the [-1, 1]
    map, in units of the row's scale (``check_grad``'s; None where no row
    qualifies), where both are finite and nonzero and no coordinate lies on a
    knot (grid_sample pads
    with zeros, lets a NaN corner poison its gradient and takes a one-sided
    slope at a knot; B' passes 0 for the first two and keeps autograd's
    convention at a knot)."""
    import torch
    import torch.nn.functional as F

    vol, sg = grid_sample_input(grid, pts, icols)
    sg = sg.detach().requires_grad_(True)
    with torch.enable_grad():
        out = F.grid_sample(vol, sg, mode="bilinear", align_corners=True)
    g_out = cot.T.reshape(out.shape).contiguous()

    def fn():
        return torch.autograd.grad(out, sg, grad_outputs=g_out, retain_graph=True)[0]

    lo = torch.stack([k[0] for k in grid.knots])
    hi = torch.stack([k[-1] for k in grid.knots])
    lib = fn().reshape(-1, 3).flip(-1) * (2.0 / (hi - lo))
    ref = kernel_grad.reshape(-1, 3)
    flat = pts.reshape(-1, 3)
    on_knot = torch.stack([torch.isin(flat[:, d], k) for d, k in enumerate(grid.knots)], dim=-1).any(-1)
    both = (torch.isfinite(lib).all(-1) & torch.isfinite(ref).all(-1) & (lib != 0).any(-1) & (ref != 0).any(-1)
            & ~on_knot)
    if not bool(both.any()):
        return fn, None  # no row to compare (the kernels line is strict JSON: no NaN)
    scale = torch.clamp(ref[both].abs().amax(-1, keepdim=True), min=1.0)
    return fn, float(((lib[both] - ref[both]).abs() / scale).max())


def _interp_check(name, values, knots, pts, icols, maps, planar=False):
    """Kernel B (reading its column-planar copy with ``planar``, else the row layout)
    against the plain version on the same card tensors (``check_interp`` at
    the dtype's tolerances); returns the max abs error."""
    import torch

    from isochrones_torch.ops.interp import interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    got = interp_nd_cuda(values, knots, pts, icols=icols, axis_maps=maps, planar=planar)
    ref = interp_nd_plain(values, knots, pts, icols=icols, axis_maps=maps)
    torch.cuda.synchronize()
    f64 = pts.dtype == torch.float64
    return check_interp(name, got, ref, interp_scale(values, icols), RTOL_INTERP_F64 if f64 else 0.0,
                        ATOL_INTERP_F64 if f64 else ATOL_INTERP_F32)


def plain_interp(values, knots, points, icols=None, axis_maps=None, planar=False):
    """``interp_nd_plain`` under ``interp_nd``'s signature (the plain version
    reads the row layout; a planar copy is kernel B's alone)."""
    from isochrones_torch.ops.interp import interp_nd_plain

    return interp_nd_plain(values, knots, points, icols=icols, axis_maps=axis_maps)


def in_turns(new, parent, name, reps):
    """Device ms of ``new`` and, where given, ``parent`` (kernels whose name
    holds ``name``), timed in turns (parent, new, new, parent): ``{"new":
    [ms, ...], "parent": [ms, ...]}``; the parent's list is empty without
    one. With ``--parent-csrc`` the phases pass the parent's kernels here
    (``scripts.compare_torch_kernels.Baseline``)."""
    order = ["parent", "new", "new", "parent"] if parent is not None else ["new"]
    out = {"new": [], "parent": []}
    for who in order:
        out[who].append(kernel_ms(new if who == "new" else parent, name, reps=reps))
    return out


def cluster_call_ab(dev, ic, data, p):
    """One cluster ``lnpost_batch`` at the walkers ``p`` (the 50-star model
    of phase 4 on ``ic``) with the ladder's lerps through kernel B and
    through the plain version (the earlier design), in turns (B, plain,
    plain, B): wall-clock ms a call (10 calls a turn), and per design under
    the profiler the device kernels a call and the idle share. Returns
    ``{design: {"wall_ms": [two turns], "kernels": n, "idle": share}}``."""
    import torch

    import isochrones_torch.cluster as cluster_mod
    from isochrones_torch import StarClusterModel
    from isochrones_torch.ops.mags import interp_mag_plain

    model = StarClusterModel(ic, data, **MODEL)
    pt = torch.as_tensor(p, device=dev, dtype=ic.dtype)

    def run(design, fn):
        if design == "kernel B":
            return fn()
        saved = cluster_mod.interp_nd, cluster_mod._interp_mag_kernel
        cluster_mod.interp_nd, cluster_mod._interp_mag_kernel = plain_interp, interp_mag_plain
        try:
            return fn()
        finally:
            cluster_mod.interp_nd, cluster_mod._interp_mag_kernel = saved

    out = {d: {"wall_ms": []} for d in ("kernel B", "plain")}
    for design in ("kernel B", "plain", "plain", "kernel B"):
        out[design]["wall_ms"].append(run(design, lambda: 1e3 * _wall(lambda: model.lnpost_batch(pt), reps=10)))
    for design, rec in out.items():
        wall, by_name = run(design, lambda: profile_kernels(lambda: model.lnpost_batch(pt), reps=3))
        busy = sum(ms for ms, _ in by_name.values()) / 3
        rec.update(kernels=sum(n for _, n in by_name.values()) / 3, idle=1 - busy / (1e3 * wall / 3))
    print(f"[interp] one {len(p)}-walker cluster lnpost_batch f32, in turns (B, plain, plain, B): ladder through "
          f"kernel B {np.round(out['kernel B']['wall_ms'], 3).tolist()} ms, {out['kernel B']['kernels']:.1f} device "
          f"kernels, idle share {out['kernel B']['idle']:.3f}; through the plain version "
          f"{np.round(out['plain']['wall_ms'], 3).tolist()} ms, {out['plain']['kernels']:.1f} kernels, idle share "
          f"{out['plain']['idle']:.3f}")
    return out


def phase_interp_kernel(dev, ic32, ic64, parent=None):
    """Phase 26a: kernel B against its plain version on the card, float64 and
    float32: the cluster ladder's call at W = 1024 walkers (W, 700, 3) with
    its two mass columns, from their column-planar copy as the ladder reads
    them and from the row layout, the ladder's 1-column property call (Teff,
    planar), ``interp_mag``'s 4-d BC call (3 bands) at the ladder's points,
    ``interp_value``'s every column at 100,000 seeded points (adversarial
    blocks: ``interp_points``), and a reference-named shim
    (``interp_values_3d``, float64) on a cut of the model grid whose EEP axis
    is irregular past 256 knots (searchsorted); kernel B' against autograd of
    the plain version at the seismic terms' call (131072 points, ``nu_max``
    and ``delta_nu``). Times of every B call beside its bound and, with the
    parent's kernels ``parent`` (``scripts.compare_torch_kernels.Baseline``),
    the parent's kernel B on the same call in turns; at the ladder's call the
    plain version and ``grid_sample``; B' at the seismic call and at the NUTS
    chains' 4 and 8 points and at 1024 (median and spread of 400 launches), in
    turns with the parent's B' where given and beside ``grid_sample``'s
    backward for the sample grid (:func:`grid_sample_backward`); the bytes of
    the ladder's planar copies; the 1024-walker cluster ``lnpost_batch`` with
    B and with the plain lerps in turns (:func:`cluster_call_ab`). Returns
    ``(B record, B' record)``."""
    import torch
    import torch.nn.functional as F

    from isochrones_torch import StarClusterModel
    from isochrones_torch import interp as shims
    from isochrones_torch.catalog import read_csv
    from isochrones_torch.ops.interp import compute_axis_maps, interp_nd, interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda, interp_nd_grad_cuda, planar_columns

    data = read_csv(FIXTURE)
    rng = np.random.default_rng(1)
    pw = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(INTERP_LADDER_W, 7))
    errs, calls, planar_bytes = {}, {}, {}
    for label, ic in (("f64", ic64), ("f32", ic32)):
        g, bc = ic.model, ic.bc
        ci = g.column_index
        gp = ladder_points(StarClusterModel(ic, data, **MODEL), pw)
        mass_icols, prop_icols = (ci["initial_mass"], ci["dm_deep"]), (ci["Teff"],)
        planar_bytes[label] = {what: pc.numel() * pc.element_size() for what, pc in (
            ("mass pair", planar_columns(g.values, mass_icols)),
            ("one property column", planar_columns(g.values, prop_icols)))}
        errs[f"ladder {label}"] = _interp_check(f"ladder {label}", g.values, g.knots, gp, mass_icols, g.axis_maps,
                                                True)
        errs[f"ladder row layout {label}"] = _interp_check(f"ladder row layout {label}", g.values, g.knots, gp,
                                                           mass_icols, g.axis_maps)
        errs[f"property {label}"] = _interp_check(f"property {label}", g.values, g.knots, gp, prop_icols, g.axis_maps,
                                                  True)
        pk = ic.model_packed
        props = interp_nd_plain(pk.values, pk.knots, gp, icols=ic._packed_icols, axis_maps=pk.axis_maps)
        av = torch.as_tensor(pw[:, 3], dtype=ic.dtype, device=dev)[:, None].expand(gp.shape[:2])
        bp = torch.stack([props[..., 0], props[..., 1], props[..., 2], av], dim=-1)
        bands = tuple(bc.column_index[b] for b in MODEL["bands"])
        errs[f"BC {label}"] = _interp_check(f"BC {label}", bc.values, bc.knots, bp, bands, bc.axis_maps)
        vp = torch.as_tensor(interp_points(g.knots, INTERP_VALUE_POINTS, seed=26), device=dev, dtype=ic.dtype)
        errs[f"every column {label}"] = _interp_check(f"every column {label}", g.values, g.knots, vp, None,
                                                      g.axis_maps)
        calls[label] = (g, gp, mass_icols, prop_icols, bc, bp, bands, vp)
    print(f"[interp] kernel B vs plain on the card: the ladder's call ({INTERP_LADDER_W}, "
          f"{calls['f32'][1].shape[1]}, 3) x 2 columns (planar copy and row layout) and its 1-column property call "
          f"(planar), interp_mag's BC call (4-d, 3 bands), every column ({len(calls['f32'][0].columns)}) at "
          f"{INTERP_VALUE_POINTS} points; max_abs_err {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(float64 rtol {RTOL_INTERP_F64} + {ATOL_INTERP_F64} x column scale, float32 against the plain float32 "
          f"version {ATOL_INTERP_F32} x column scale); NaN patterns identical")
    print(f"[interp] the ladder's column-planar copies on the card (MIST-scale synthetic grid, "
          f"{tuple(ic32.model.values.shape)}): {json.dumps(planar_bytes)} bytes")

    # a shim on a cut of the model grid with an irregular EEP axis: no map, searchsorted
    g = ic64.model
    sub = g.values[:, :4].cpu().numpy()
    knots = [k.cpu().numpy() for k in g.knots]
    knots[1] = knots[1][:4]
    e = knots[2]
    knots[2] = e + 0.3 * (e[1] - e[0]) * np.sin(np.arange(len(e))) ** 2
    maps = compute_axis_maps(knots)
    if maps[2] is not None:
        raise AssertionError(f"the shim's EEP axis is not searchsorted: {maps[2]}")
    sp = interp_points(knots, INTERP_VALUE_POINTS, seed=27)
    icols = [g.column_index["Teff"], g.column_index["logg"], g.column_index["initial_mass"]]
    interp_nd_cuda.launches = 0
    got = shims.interp_values_3d(sp[:, 0], sp[:, 1], sp[:, 2], sub, icols, *knots, device=dev)
    if interp_nd_cuda.launches != 1:
        raise AssertionError(f"the shim launched kernel B {interp_nd_cuda.launches} times")
    kt = tuple(torch.as_tensor(k, device=dev) for k in knots)
    shim_call = (torch.as_tensor(sub, device=dev), kt, torch.as_tensor(sp, device=dev), tuple(icols), maps)
    ref = interp_nd_plain(*shim_call[:3], icols=shim_call[3], axis_maps=maps)
    errs["shim f64"] = check_interp("shim f64", got, ref, interp_scale(sub, icols), RTOL_INTERP_F64,
                                    ATOL_INTERP_F64)
    print(f"[interp] interp_values_3d (maps {[m and m[0] for m in maps]}) at {INTERP_VALUE_POINTS} points: one "
          f"launch, max_abs_err {errs['shim f64']:.3e}")

    # times, float32 unless named: every call, in turns with the parent's kernel B where given
    g, gp, mass_icols, prop_icols, bc, bp, bands, vp = calls["f32"]
    g64, gp64 = calls["f64"][:2]
    timed = {
        "ladder": (g, gp, mass_icols, True),
        "ladder f64": (g64, gp64, mass_icols, True),
        "ladder row layout": (g, gp, mass_icols, False),
        "property": (g, gp, prop_icols, True),
        "BC": (bc, bp, bands, False),
        "every column": (g, vp, None, False),
    }
    times = {}
    for what, (tg, tp, ti, tpl) in timed.items():
        times[what] = in_turns(
            lambda tg=tg, tp=tp, ti=ti, tpl=tpl: interp_nd_cuda(tg.values, tg.knots, tp, icols=ti,
                                                                 axis_maps=tg.axis_maps, planar=tpl),
            None if parent is None else (lambda tg=tg, tp=tp, ti=ti, tpl=tpl: parent.interp(
                tg.values, tg.knots, tp, ti, tg.axis_maps, tpl)),
            "interp_nd_kernel", reps=20)
    times["searchsorted shim f64"] = in_turns(
        lambda: interp_nd_cuda(*shim_call[:3], icols=shim_call[3], axis_maps=maps),
        None if parent is None else (lambda: parent.interp(*shim_call)), "interp_nd_kernel", reps=20)
    bounds = {what: bound(*interp_work(tg, tp, len(tg.columns) if ti is None else len(ti)),
                          "float64" if what.endswith("f64") else "float32")[0]
              for what, (tg, tp, ti, _) in timed.items()}
    ms, ms64 = float(np.mean(times["ladder"]["new"])), float(np.mean(times["ladder f64"]["new"]))
    plain = lambda: interp_nd_plain(g.values, g.knots, gp, icols=mass_icols, axis_maps=g.axis_maps)  # noqa: E731
    plain_ms = cuda_ms(plain, reps=5)
    plain_kernels = sum(n for _, n in profile_kernels(plain, reps=3)[1].values()) / 3
    bound_ms, bound_by, what = bound(*interp_work(g, gp, len(mass_icols)), "float32")
    vol, sg = grid_sample_input(g, gp, mass_icols)
    lib = F.grid_sample(vol, sg, mode="bilinear", align_corners=True)[0, :, 0, 0, :].T
    library_turns = []
    for who in ("grid_sample", "kernel B", "kernel B", "grid_sample"):
        if who == "grid_sample":
            # its kernel's device time, as kernel B's (CUDA events over the calls
            # would count the host's launch gaps too)
            library_turns.append(kernel_ms(lambda: F.grid_sample(vol, sg, mode="bilinear", align_corners=True),
                                           "grid_sampler", reps=20))
        else:
            times["ladder"]["new"].append(kernel_ms(lambda: interp_nd_cuda(
                g.values, g.knots, gp, icols=mass_icols, axis_maps=g.axis_maps, planar=True),
                "interp_nd_kernel", reps=20))
    library_ms = float(np.mean(library_turns))
    ms = float(np.mean(times["ladder"]["new"]))
    kgot = interp_nd_cuda(g.values, g.knots, gp, icols=mass_icols, axis_maps=g.axis_maps, planar=True)
    kgot = kgot.reshape(-1, 2)
    both = torch.isfinite(kgot).all(-1) & torch.isfinite(lib).all(-1)
    lib_diff = float((lib[both] - kgot[both]).abs().max()) if bool(both.any()) else float("nan")
    print(f"[interp] time, the ladder's call ({INTERP_LADDER_W}, {gp.shape[1]}, 3) x 2 columns f32 (planar copy): "
          f"kernel B {ms:.4f} ms (turns {np.round(times['ladder']['new'], 4).tolist()}; f64 {ms64:.4f}), plain "
          f"{plain_ms:.4f} ms ({plain_kernels:.1f} device kernels), grid_sample {library_ms:.4f} ms (turns "
          f"{np.round(library_turns, 4).tolist()}; where both are finite it differs from kernel B by "
          f"{lib_diff:.3e}); bound {bound_ms:.6f} ms ({what}), kernel at {bound_ms / ms:.5f} of it")
    for name, t in times.items():
        par = (f", the parent's kernel B {np.round(t['parent'], 4).tolist()} ms (mean {np.mean(t['parent']):.4f}, "
               f"{np.mean(t['parent']) / np.mean(t['new']):.2f}x)" if t["parent"] else "")
        print(f"[interp] time {name}: kernel B {np.round(t['new'], 4).tolist()} ms (mean {np.mean(t['new']):.4f})"
              f"{par}; bound {bounds.get(name, float('nan')):.6f} ms")
    ab = cluster_call_ab(dev, ic32, data, pw)
    rec_b = dict(name="interp_nd", route="cuda", source="isochrones_torch/csrc/interp_nd.cu",
                 replaces="isochrones_tpu/ops/interp.py:483", max_abs_err=errs["ladder f32"], ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                 library="torch.nn.functional.grid_sample(mode='bilinear', align_corners=True)",
                 library_max_diff=lib_diff, plain_device_kernels=plain_kernels, ms_f64=ms64,
                 shape={"W": INTERP_LADDER_W, "E": int(gp.shape[1]), "ndim": 3, "cols": 2, "dtype": "float32",
                        "layout": "column-planar copy"},
                 times_in_turns=times, bounds=bounds, planar_bytes=planar_bytes,
                 ms_bc_call=float(np.mean(times["BC"]["new"])), bound_ms_bc_call=bounds["BC"],
                 ms_every_column=float(np.mean(times["every column"]["new"])),
                 bound_ms_every_column=bounds["every column"], max_abs_err_all=errs, cluster_call_ab=ab)

    # kernel B' at the seismic terms' call: the primary's grid point, nu_max and delta_nu
    grads, times = {}, {}
    for label, ic in (("f64", ic64), ("f32", ic32)):
        g = ic.model
        io = ic._param_index_order
        sp = star_points(g.knots, 1, STAR_BATCH, seed=28)
        sp[STAR_BATCH // 2:] = star_points(g.knots, 1, STAR_BATCH // 2, seed=29, box=STAR_BOX[1:])
        gp = torch.as_tensor(sp[:, [io[0], io[1], io[2]]], device=dev, dtype=ic.dtype)
        icols = (g.column_index["nu_max"], g.column_index["delta_nu"])
        cot = torch.as_tensor(np.random.default_rng(30).normal(size=(STAR_BATCH, 2)), device=dev, dtype=ic.dtype)

        def vjp(fn, g=g, gp=gp, icols=icols, cot=cot):
            with torch.enable_grad():
                x = gp.clone().requires_grad_(True)
                (gx,) = torch.autograd.grad(fn(g.values, g.knots, x, icols=icols, axis_maps=g.axis_maps), x,
                                            grad_outputs=cot)
            return gx

        interp_nd_grad_cuda.launches = 0
        got = vjp(interp_nd).cpu().numpy()
        if interp_nd_grad_cuda.launches != 1:
            raise AssertionError(f"B' launched {interp_nd_grad_cuda.launches} times in one backward")
        grads[label] = check_grad(f"B' {label}", got, vjp(interp_nd_plain).cpu().numpy(),
                                  RTOL_GRAD_F64 if label == "f64" else RTOL_GRAD_F32)[0]
        if label == "f64":
            times[label] = kernel_ms(lambda: interp_nd_grad_cuda(g.values, g.knots, gp, cot, icols, g.axis_maps),
                                     "interp_nd_grad_kernel", reps=20)
            continue
        # float32: B' in turns with the parent's B' and with grid_sample's backward for the sample grid, at
        # the seismic call's 131072 points, the NUTS chains' 4 and 8 and 1024 (medians of SPREAD_LAUNCHES
        # launches below 131072)
        bprime = {}
        for B in (STAR_BATCH,) + GRAD_BATCHES[:3]:
            args = (g.values, g.knots, gp[:B].contiguous(), cot[:B].contiguous(), icols, g.axis_maps)
            new = lambda args=args: interp_nd_grad_cuda(*args)  # noqa: E731
            old = None if parent is None else (lambda args=args: parent.interp_grad(*args))
            lib_bwd, lib_diff = grid_sample_backward(g, args[2], icols, args[3], new())
            if B == STAR_BATCH:  # the library, the parent and B' in turns (L, P, B, B, P, L)
                library = [kernel_ms(lib_bwd, "grid_sampler_3d_backward", reps=20)]
                turns = in_turns(new, old, "interp_nd_grad_kernel", reps=20)
                library.append(kernel_ms(lib_bwd, "grid_sampler_3d_backward", reps=20))
                rec = dict(ms=float(np.mean(turns["new"])), ms_turns=turns["new"], parent_ms=turns["parent"],
                           library_ms=float(np.mean(library)), library_turns=library)
            else:
                spread = kernel_ms_spread(new, "interp_nd_grad_kernel")
                rec = dict(ms=spread[0], ms_spread=spread,
                           parent_ms_spread=None if old is None else kernel_ms_spread(old, "interp_nd_grad_kernel"),
                           library_ms_spread=kernel_ms_spread(lib_bwd, "grid_sampler_3d_backward"))
                rec["library_ms"] = rec["library_ms_spread"][0]
            rec.update(bound_ms=bound(*interp_work(g, args[2], 2, grad=True), "float32")[0], library_max_diff=lib_diff)
            bprime[B] = rec
        times[label] = (bprime, cuda_ms(lambda: vjp(interp_nd_plain), reps=5),
                        bound(*interp_work(g, gp, 2, grad=True), "float32")[:2])
    (bprime, gplain, (gbound, gby)), gms64 = times["f32"], times["f64"]
    top = bprime[STAR_BATCH]
    gms = top["ms"]
    print(f"[interp] kernel B' vs autograd of the plain version at the seismic call ({STAR_BATCH} points, nu_max "
          f"and delta_nu): f64 {grads['f64']:.3e} (rtol {RTOL_GRAD_F64} of the row's scale), f32 against the plain "
          f"float32 version {grads['f32']:.3e} (rtol {RTOL_GRAD_F32}); autograd of the plain version (forward + "
          f"backward) {gplain:.4f} ms; bound {gbound:.6f} ms")
    for B, r in bprime.items():
        if B == STAR_BATCH:
            par = (f", the parent's B' {np.round(r['parent_ms'], 4).tolist()} ms (mean {np.mean(r['parent_ms']):.4f})"
                   if r["parent_ms"] else "")
            what = f"kernel B' {np.round(r['ms_turns'], 4).tolist()} ms (mean {r['ms']:.4f}; f64 {gms64:.4f}){par}"
            lib = f"grid_sample's backward {np.round(r['library_turns'], 4).tolist()} ms"
        else:
            q = r["ms_spread"]
            par = (f", the parent's B' {r['parent_ms_spread'][0]:.5f} [{r['parent_ms_spread'][1]:.5f}, "
                   f"{r['parent_ms_spread'][2]:.5f}]" if r["parent_ms_spread"] else "")
            lq = r["library_ms_spread"]
            what = f"kernel B' {q[0]:.5f} [{q[1]:.5f}, {q[2]:.5f}]{par}"
            lib = f"grid_sample's backward {lq[0]:.5f} [{lq[1]:.5f}, {lq[2]:.5f}] ms"
        diff = ("no row off the knots to compare" if r["library_max_diff"] is None else
                f"where both are finite and nonzero its gradient, through the [-1, 1] map, differs from B''s by "
                f"{r['library_max_diff']:.3e} of the row's scale")
        print(f"[interp] time B' at {B} points f32: {what} ms; {lib} ({diff}); bound {r['bound_ms']:.8f} ms, kernel "
              f"at {r['bound_ms'] / r['ms']:.5f} of it")
    rec_g = dict(name="interp_nd_grad", route="cuda", source="isochrones_torch/csrc/interp_nd.cu",
                 replaces="isochrones_tpu/ops/interp.py:483", max_abs_err=grads["f32"], ms=gms, plain_ms=gplain,
                 bound_ms=gbound, bound_by=gby, library_ms=top["library_ms"],
                 library="torch.nn.functional.grid_sample(mode='bilinear', align_corners=True) backward for the "
                         "sample grid (grid_sampler_3d_backward)",
                 library_max_diff=top["library_max_diff"], ms_f64=gms64, max_err_f64=grads["f64"],
                 shape={"P": STAR_BATCH, "ndim": 3, "cols": 2, "dtype": "float32"},
                 ms_nuts_chains={str(B): bprime[B]["ms"] for B in GRAD_BATCHES[:2]},
                 timing={str(B): r for B, r in bprime.items()},
                 bound_ms_nuts_chains={str(B): bprime[B]["bound_ms"] for B in GRAD_BATCHES[:2]})
    return rec_b, rec_g


def star_work(pars, lk):
    """``(bytes, flops, special functions)`` of the fused star likelihood on
    these points: the parameters read and the outputs written once, each
    distinct row that the batch's corners touch read once (its 6 pack
    columns, its band columns of the BC table); per (point, component) ~70
    flops of cell location, 8 corners x (6 weight flops + 12 lerp flops), 16
    corners x (8 + 2 per band), 3 per band for the magnitudes, one pow per
    band and one log10; per point a log10 per band (N > 1) and a log and ~6
    flops per Gaussian term."""
    import torch

    from isochrones_torch.ops.interp import interp_nd
    from isochrones_torch.ops.likelihood import stack_components

    B, N, nb = pars.shape[0], lk.n_stars, len(lk.band_icols)
    io = lk.index_order
    comp = stack_components(pars, N).reshape(B * N, 5)
    gp = torch.stack([comp[:, io[0]], comp[:, io[1]], comp[:, io[2]]], dim=-1)
    vals6 = interp_nd(lk.pack6.values, lk.pack6.knots, gp, axis_maps=lk.pack6.axis_maps)
    bp = torch.stack([vals6[:, 0], vals6[:, 1], vals6[:, 2], comp[:, io[4]]], dim=-1)
    e = pars.element_size()
    rows = _touched_rows(lk.pack6, gp) * 6 + _touched_rows(lk.bc, bp) * nb
    nbytes = (pars.numel() + B * (1 + 2 * N) + rows) * e
    n_terms = nb + 3 + (lk.parallax is not None)
    flops = B * N * (70 + 8 * 18 + 16 * (8 + 2 * nb) + 3 * nb) + B * 6 * n_terms
    sfu = B * N * (nb + 1) + B * ((nb if N > 1 else 0) + n_terms)
    return nbytes, flops, sfu


def profile_kernels(fn, reps=1, required=True):
    """Run ``fn`` ``reps`` times under ``torch.profiler``; returns ``(wall
    seconds, {kernel name: (device ms, launches)})`` over the window. A
    window in which the profiler reports no device event at all (it drops a
    cycle's events now and then, up to four windows running) is run again,
    eight times at most; then it raises, or with ``required`` False returns
    an empty dict."""
    import torch

    from isochrones_torch.tracing import PREFIX

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(8):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():  # the program's spans have copies on the device's timeline: not kernels
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(PREFIX):
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        if by_name:
            return wall, by_name
    if not required:
        return wall, {}
    raise AssertionError("the profiler reported no device event in 8 windows")


def kernel_ms(fn, name, reps, warmup=2):
    """Mean device milliseconds per call of the kernels whose name holds
    ``name``, over ``reps`` calls: the kernels' own time, without launch gaps
    or the wrapper's torch ops. Each kernel's mean is taken over the events
    the profiler reports (it may drop one of a window) and counted as often
    as a call launches it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = [v for k, v in profile_kernels(fn, reps)[1].items() if name in k]
    if not seen:
        raise AssertionError(f"the profiler saw no {name} kernel")
    return sum(ms / n * max(1, round(n / reps)) for ms, n in seen)


#: launches in one window of kernel_ms_spread, and the calls before it
SPREAD_LAUNCHES, SPREAD_WARMUP = 400, 50


def kernel_ms_spread(fn, name, reps=SPREAD_LAUNCHES, warmup=SPREAD_WARMUP):
    """Device milliseconds of each launch of the kernels whose name holds
    ``name`` over ``reps`` calls of ``fn`` after ``warmup`` calls:
    ``(median, 10th percentile, 90th percentile, launches seen)``. For
    launches of a few microseconds, whose means over short windows spread by
    up to 2x from one window to the next."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(4):  # the profiler drops a window's events now and then
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if ms:
            q = np.percentile(ms, [50, 10, 90])
            return float(q[0]), float(q[1]), float(q[2]), len(ms)
    raise AssertionError(f"the profiler saw no {name} kernel in 4 windows")


def cuda_ms(fn, reps, warmup=2):
    """Mean device milliseconds per call, CUDA events over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tree_check(name, lk64, pts, dev):
    """The tree kernel's ``(ll, orig_val, deriv)`` against the plain version
    on ``pts``: float64, and float32 tables and points against the float64
    plain version on the same float32 values; NaN and +-inf patterns
    identical. Returns ``(err64, err32, finite, n)``, the errors over all
    three outputs."""
    import torch

    from isochrones_torch.ops.tree import tree_lnlike_fused_plain
    from isochrones_torch.ops.tree_cuda import tree_lnlike_cuda

    def host(triple):
        return [x.cpu().numpy() for x in triple]

    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    ref64 = host(tree_lnlike_fused_plain(p64, lk64))
    got64 = host(tree_lnlike_cuda(p64, lk64))
    torch.cuda.synchronize()
    err64 = check_star(f"tree kernel f64 {name}", got64, ref64, RTOL_TREE_F64, ATOL_TREE_F64)
    lk32 = tree_likelihood_as(lk64, torch.float32)
    lk32up = tree_likelihood_as(lk32, torch.float64)
    p32 = p64.float()
    ref32 = host(tree_lnlike_fused_plain(p32.double(), lk32up))
    got32 = host(tree_lnlike_cuda(p32, lk32))
    torch.cuda.synchronize()
    err32 = check_star(f"tree kernel f32 {name}", got32[:1], ref32[:1], RTOL_TREE_F32, ATOL_TREE_F32)
    err32 = max(err32, check_star(f"tree kernel f32 prior columns {name}", got32[1:], ref32[1:], RTOL_TREE_COL_F32,
                                  ATOL_TREE_COL_F32))
    if np.isnan(got64[0]).any() or np.isposinf(got64[0]).any():
        raise AssertionError(f"tree kernel {name}: NaN or +inf in ll")
    return err64, err32, int(np.isfinite(ref64[0]).sum()), len(ref64[0])


#: batches at which a plan of 3 stars takes 4 star groups of 8, 4 and 2 lanes
#: per point, and one lane that takes the stars in turn
TREE_WIDTH_BATCHES = (1024, 12288, 24576, STAR_BATCH)
#: further plans of phase 9: stars and the batches checked (16 lanes per star;
#: a star count that is no power of two; the cap, with 2 lanes and 1)
TREE_EXTRA_PLANS = ((1, (1024, 20000)), (5, (1024, 40000)), (16, (1024, 20000)))
#: star counts of the timing sweep
TREE_SWEEP_STARS = (1, 2, 3, 8, 16)


def _tree_mixed_points(param_names, knots, batch, seed):
    """``tree_points`` over the grid's whole box in the first half and over
    the narrow box in the second, adversarial blocks in both."""
    pts = tree_points(param_names, knots, batch, seed=seed)
    pts[batch // 2:] = tree_points(param_names, knots, batch - batch // 2, seed=seed + 100, narrow=True)
    return pts


def _tree_truth(n_stars):
    """EEPs descending from 350 in steps of 10, then TREE_TRUTH's age, feh,
    distance and AV."""
    return tuple(350.0 - 10.0 * i for i in range(n_stars)) + TREE_TRUTH[3:]


def phase_tree_kernel(dev, ic32, ic64, workdir):
    """Phase 9. Returns the record of the kernels line."""
    import torch

    from isochrones_torch.ops.tree import tree_lnlike_fused_plain
    from isochrones_torch.ops.tree_cuda import launch_geometry, tree_lnlike_cuda
    from isochrones_torch.treemodel import StarModel

    fit_batch = NESTED["n_batch"] * NESTED["n_chains"]
    knots = ic64.model.knots
    three = StarModel.from_ini(ic64, write_tree_ini(os.path.join(workdir, "tree3"), ic64))
    two = StarModel.from_ini(ic64, write_ini(os.path.join(workdir, "tree2sys"), TREE_INI_TWO_SYSTEMS), index=[0, 0, 1])
    record = None
    widths = set()
    for label, mod in (("one system of 3 stars", three), ("two systems (2 + 1 stars)", two)):
        lk64 = mod._get_fn("lnlike").likelihood
        print(f"[tree] plan {label}: labelstring {mod.labelstring}, params {mod.param_names}, "
              f"{lk64.n_obs} observation rows ({int(lk64.obs_active.sum())} active, "
              f"{int((lk64.obs_ref >= 0).sum())} relative), bands {mod.obs.plan(ic64).bands}, "
              f"{len(lk64.spec_star)} spectroscopy rows, {len(lk64.plax_idx)} parallax")
        for B in TREE_WIDTH_BATCHES:
            p = _tree_mixed_points(mod.param_names, knots, B, seed=21 + B % 7)
            groups, G = launch_geometry(B, lk64.n_stars)
            widths.add(G)
            e64, e32, fin, n = _tree_check(f"{label} B={B}", lk64, p, dev)
            print(f"[tree] kernel vs plain (ll, orig_val, deriv), {label}: B={B} ({groups} groups of {G} lanes) f64 max_abs_err "
                  f"{e64:.3e} (rtol {RTOL_TREE_F64}), f32 vs f64 max_abs_err {e32:.3e} (ll: rtol {RTOL_TREE_F32} atol "
                  f"{ATOL_TREE_F32}; columns: rtol {RTOL_TREE_COL_F32} atol {ATOL_TREE_COL_F32}), {fin}/{n} finite")
            if B == STAR_BATCH and (fin < n // 8 or fin > n - n // 8):
                raise AssertionError(f"tree points {label}: {fin}/{n} finite rows do not test both outcomes")
            if B == STAR_BATCH:
                main_err = e32
        if mod is not three:
            continue
        lk32 = tree_likelihood_as(lk64, torch.float32)
        bench32 = torch.as_tensor(tree_points(mod.param_names, knots, STAR_BATCH, seed=24, narrow=True),
                                  device=dev, dtype=torch.float32)
        pf32 = torch.as_tensor(tree_points(mod.param_names, knots, fit_batch, seed=23, narrow=True), device=dev,
                               dtype=torch.float32)
        ms = kernel_ms(lambda: tree_lnlike_cuda(bench32, lk32), "tree_lnlike", reps=20)
        plain_ms = cuda_ms(lambda: tree_lnlike_fused_plain(bench32, lk32), reps=5)
        ms64 = kernel_ms(lambda: tree_lnlike_cuda(bench32.double(), lk64), "tree_lnlike", reps=10)
        bnd = bound(*tree_work(bench32, lk32), "float32")
        fit_ms = kernel_ms(lambda: tree_lnlike_cuda(pf32, lk32), "tree_lnlike", reps=200)
        fit_plain_ms = cuda_ms(lambda: tree_lnlike_fused_plain(pf32, lk32), reps=20)
        fit_bnd = bound(*tree_work(pf32, lk32), "float32")
        print(f"[tree] time B={STAR_BATCH} {label}: kernel f32 {ms:.4f} ms, plain f32 {plain_ms:.4f} ms, kernel f64 "
              f"{ms64:.4f} ms; f32 bound {bnd[0]:.5f} ms ({bnd[2]}), kernel at {bnd[0] / ms:.3f} of it")
        print(f"[tree] time B={fit_batch} (the fit's batch): kernel f32 {fit_ms:.4f} ms, plain f32 "
              f"{fit_plain_ms:.4f} ms; f32 bound {fit_bnd[0]:.5f} ms ({fit_bnd[2]}), kernel at "
              f"{fit_bnd[0] / fit_ms:.3f} of it")
        record = {
            "name": "tree_lnlike", "route": "cuda", "source": "isochrones_torch/csrc/tree_lnlike.cu",
            "replaces": "isochrones_tpu/observation.py:1269",
            "launches": None, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None,
            "shape": {"B": STAR_BATCH, "stars": lk32.n_stars, "obs_rows": lk32.n_obs, "bands": len(lk32.band_icols),
                      "dtype": "float32"},
            "ms_fit_batch": fit_ms, "plain_ms_fit_batch": fit_plain_ms, "bound_ms_fit_batch": fit_bnd[0],
            "fit_batch": fit_batch,
        }

    # other star counts: every group width, a count off the powers of two, the cap
    for n_stars, batches in TREE_EXTRA_PLANS:
        mod = StarModel.from_ini(ic64, write_tree_ini(os.path.join(workdir, f"tree{n_stars}"), ic64,
                                                      _tree_truth(n_stars)))
        lk64 = mod._get_fn("lnlike").likelihood
        if lk64.n_stars != n_stars:
            raise AssertionError(f"the {n_stars}-star folder gave a plan of {lk64.n_stars} stars")
        for B in batches:
            p = _tree_mixed_points(mod.param_names, knots, B, seed=30 + n_stars)
            groups, G = launch_geometry(B, n_stars)
            widths.add(G)
            e64, e32, fin, n = _tree_check(f"{n_stars} stars B={B}", lk64, p, dev)
            print(f"[tree] kernel vs plain, {n_stars} stars, {lk64.n_obs} rows: B={B} ({groups} groups of {G} lanes) f64 "
                  f"max_abs_err {e64:.3e}, f32 vs f64 max_abs_err {e32:.3e}, {fin}/{n} finite")
    if widths != {1, 2, 4, 8, 16}:
        raise AssertionError(f"group widths checked: {sorted(widths)}")

    # the kernel's time against the number of stars, rows in proportion
    for n_stars in TREE_SWEEP_STARS:
        mod = StarModel.from_ini(ic32, write_tree_ini(os.path.join(workdir, f"sweep{n_stars}"), ic32,
                                                      _tree_truth(n_stars)))
        lk32 = mod._get_fn("lnlike").likelihood
        for B, reps in ((fit_batch, 100), (STAR_BATCH, 10)):
            p32 = torch.as_tensor(tree_points(mod.param_names, knots, B, seed=60 + n_stars, narrow=True), device=dev,
                                  dtype=torch.float32)
            ms_n = kernel_ms(lambda: tree_lnlike_cuda(p32, lk32), "tree_lnlike", reps=reps)
            groups, G = launch_geometry(B, n_stars)
            print(f"[tree] sweep: {n_stars} stars, {lk32.n_obs} rows, B={B} ({groups} groups of {G} lanes): kernel f32 {ms_n:.4f} ms, {1e6 * ms_n / (B * n_stars):.3f} ns per (point, star)")
    return record


def phase_tree_slice_and_fit(dev, ic32, ic64, workdir):
    """Phases 10 and 11. Returns the tree kernel's launches in the fit and
    the fit's NUTS_LNPROB_Q quantiles of lnprob."""
    import torch

    import isochrones_torch.ops.tree as tree_ops
    from isochrones_torch.ops.tree_cuda import tree_lnlike_cuda
    from isochrones_torch.treemodel import StarModel

    folder = os.path.join(workdir, "tree3")
    mod32 = StarModel.from_ini(ic32, folder)
    mod64 = StarModel.from_ini(ic64, folder)
    lp = mod32.lnpost(TREE_TRUTH)
    if not np.isfinite(lp) or not np.isfinite(mod64.lnpost(TREE_TRUTH)):
        raise AssertionError(f"tree lnpost at the truth is not finite: {lp}")
    pts = tree_points(mod64.param_names, ic64.model.knots, STAR_BATCH, seed=25, narrow=True)
    pts[:, :3] = -np.sort(-pts[:, :3], axis=1)  # descending EEPs: inside the prior
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    p32 = p64.float()
    before = tree_lnlike_cuda.launches
    lp_k64 = mod64.lnpost_batch(p64).cpu().numpy()
    if tree_lnlike_cuda.launches != before + 1:
        raise AssertionError("the tree model's lnpost_batch did not launch the tree kernel once")
    if mod32._build_lnpost_fused() is None or mod64._build_lnpost_fused() is None:
        raise AssertionError("the tree model did not take the fused posterior")
    lk64 = mod64._get_fn("lnlike").likelihood
    lk32 = mod32._get_fn("lnlike").likelihood

    def composed_lnpost(mod, lnlike):
        """lnprior + lnlike: the prior interpolates for itself."""
        lnprior = mod._get_fn("lnprior")

        def lnpost(p):
            lnpr = lnprior(p)
            ll = lnlike(p)
            return torch.where(torch.isfinite(lnpr), lnpr + ll, float("-inf"))

        return lnpost

    composed64, composed32 = (composed_lnpost(m, m._get_fn("lnlike")) for m in (mod64, mod32))
    # the plain path on the card: the composed posterior over the plain version
    plain64 = composed_lnpost(mod64, lambda p: tree_ops.tree_lnlike_plain(p, lk64))
    plain32 = composed_lnpost(mod32, lambda p: tree_ops.tree_lnlike_plain(p, lk32))
    lp_c64 = composed64(p64).cpu().numpy()
    lp_p64 = plain64(p64).cpu().numpy()
    err_c = check_star("tree lnpost_batch f64 fused vs composed", [lp_k64], [lp_c64], RTOL_TREE_F64, ATOL_TREE_F64)
    err = check_star("tree lnpost_batch f64 kernel vs plain", [lp_k64], [lp_p64], RTOL_TREE_F64, ATOL_TREE_F64)
    fused_rate = STAR_BATCH / _wall(lambda: mod32.lnpost_batch(p32), reps=10)
    composed_rate = STAR_BATCH / _wall(lambda: composed32(p32), reps=10)
    plain_rate = STAR_BATCH / _wall(lambda: plain32(p32), reps=3)
    print(f"[tree slice] lnpost(truth) = {lp:.6f} (f32); {STAR_BATCH}-point lnpost_batch f64: fused vs composed "
          f"max_abs_err {err_c:.3e}, fused vs plain max_abs_err {err:.3e} (rtol {RTOL_TREE_F64}), "
          f"{int(np.isfinite(lp_p64).sum())} finite")
    print(f"[tree slice] lnpost_batch f32 throughput: fused path {fused_rate:.1f} evals/s, composed path "
          f"{composed_rate:.1f} evals/s, plain path {plain_rate:.1f} evals/s")
    # one call at the fit's batch: what a walk step of the nested fit pays
    fit_batch = NESTED["n_batch"] * NESTED["n_chains"]
    pf32 = p32[:fit_batch].contiguous()
    reps = 10
    for label, fn, wall_reps in (("fused", lambda: mod32.lnpost_batch(pf32), 20), ("composed", lambda: composed32(pf32), 20),
                                 ("plain", lambda: plain32(pf32), 10)):
        call_ms = 1e3 * _wall(fn, reps=wall_reps)
        wall, by_name = profile_kernels(fn, reps=reps)
        busy_ms = sum(ms for ms, _ in by_name.values()) / reps
        launches = sum(n for _, n in by_name.values()) / reps
        tree_ms = sum(ms for k, (ms, _) in by_name.items() if "tree_lnlike" in k) / reps
        print(f"[tree slice] one {fit_batch}-point lnpost_batch f32, {label} path: {call_ms:.3f} ms wall-clock; under "
              f"the profiler {1e3 * wall / reps:.3f} ms, {launches:.1f} kernel launches, device busy {busy_ms:.4f} ms "
              f"(idle share {1 - busy_ms / (1e3 * wall / reps):.3f}), the tree kernel {tree_ms:.4f} ms of it "
              f"({tree_ms / busy_ms:.3f})")

    # ---- 11. the tree fit
    tree_lnlike_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mod32.fit(**TREE_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_tree = tree_lnlike_cuda.launches
    if not np.isfinite(res.logz) or res.truncated or n_tree <= 0:
        raise AssertionError(f"tree fit: logz {res.logz}, truncated {res.truncated}, launches {n_tree}")
    if not os.path.exists(f"{mod32.mnest_basename}checkpoint.pkl"):
        raise AssertionError("the tree fit wrote no checkpoint")
    d_lo, d_hi = np.quantile(mod32.samples["distance_0"], [0.025, 0.975])
    if not d_lo <= TREE_TRUTH[5] <= d_hi:
        raise AssertionError(f"distance 95% interval ({d_lo:.2f}, {d_hi:.2f}) misses {TREE_TRUTH[5]}")
    med = {k: round(float(np.median(v)), 4) for k, v in mod32.samples.items() if k != "lnprob"}
    print(f"[tree fit] fit {json.dumps(TREE_FIT)} f32 (dynamic by default): {fit_s:.3f} s, {res.n_iter} dead "
          f"points, dynamic_rounds {res.dynamic_rounds}, logz {res.logz:.4f} +- {res.logzerr:.4f}, ESS "
          f"{res.ess:.1f}, kernel launches {n_tree}")
    print(f"[tree fit] posterior medians {json.dumps(med)}; distance 95% interval ({d_lo:.3f}, {d_hi:.3f})")
    store = os.path.join(folder, "tree_model.h5")
    mod32.save_hdf(store, overwrite=True)
    back = StarModel.load_hdf(store, ic=ic32)
    same = all(np.array_equal(back.samples[c], mod32.samples[c]) for c in mod32.samples)
    derived_same = all(np.array_equal(back.derived_samples[c], v, equal_nan=True)
                       for c, v in mod32.derived_samples.items())
    if not (same and derived_same and back.evidence == mod32.evidence and back.param_names == mod32.param_names):
        raise AssertionError("save_hdf -> load_hdf did not restore the tree model's samples and evidence")
    print(f"[tree fit] save_hdf -> load_hdf: {len(mod32.samples)} sample columns, "
          f"{len(mod32.derived_samples)} derived columns and the evidence restored")
    return n_tree, np.quantile(mod32.samples["lnprob"], NUTS_LNPROB_Q)


def phase_entry_point(dev, workdir):
    """Phase 12. Returns the launches of the star, the tree and the interp
    kernel (B: the derived samples)."""
    import torch

    from isochrones_torch import BinaryStarModel, get_ichrone
    from isochrones_torch.cli.starfit import main as starfit_main
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda
    from isochrones_torch.ops.tree_cuda import tree_lnlike_cuda
    from isochrones_torch.samplers.nested import _chunk_dead
    from isochrones_torch.treemodel import StarModel

    # the CLI builds the default synthetic grid: the folders' magnitudes come from it
    ic = get_ichrone("synthetic", device=dev)
    obs = star_observations(ic, CLI_STAR_TRUTH, bands=("J", "H", "K"))
    flat_text = FLAT_INI.format(Teff=obs["Teff"][0], logg=obs["logg"][0], J=obs["J"][0], H=obs["H"][0], K=obs["K"][0])
    flat = write_ini(os.path.join(workdir, "cli_flat"), flat_text)
    tree = write_tree_ini(os.path.join(workdir, "cli_tree"), ic, CLI_TREE_TRUTH)
    common = ["--models", "synthetic", "--no_plots", "--n_live_points", str(CLI_LIVE), "--seed", "0"]
    star_lnlike_cuda.launches = tree_lnlike_cuda.launches = interp_nd_cuda.launches = 0
    t0 = time.perf_counter()
    rc_flat = starfit_main(common + ["--binary", flat])
    t_flat = time.perf_counter() - t0
    rc_tree = starfit_main(common + ["--tree", tree])
    t_tree = time.perf_counter() - t0 - t_flat
    n_star, n_tree, n_interp = star_lnlike_cuda.launches, tree_lnlike_cuda.launches, interp_nd_cuda.launches
    if rc_flat != 0 or rc_tree != 0:
        raise AssertionError(f"starfit exit codes {rc_flat}, {rc_tree}")
    flat_file = os.path.join(flat, "synthetic_starmodel_binary.h5")
    tree_file = os.path.join(tree, "synthetic_starmodel_single.h5")
    m_flat = BinaryStarModel.load_hdf(flat_file, ic=ic)
    m_tree = StarModel.load_hdf(tree_file, ic=ic)
    for folder, m in ((flat, m_flat), (tree, m_tree)):
        log = os.path.join(folder, "starfit.log")
        if not os.path.exists(log) or "starfit successful" not in open(log).read():
            raise AssertionError(f"{log} does not report a successful fit")
        if not np.isfinite(m.evidence[0]) or len(m.samples["lnprob"]) != 4000:
            raise AssertionError(f"{folder}: evidence {m.evidence}, {len(m.samples['lnprob'])} samples")
    if n_star <= 0 or n_tree <= 0 or n_interp <= 0:
        raise AssertionError(f"entry point launches: star {n_star}, tree {n_tree}, interp (derived samples) {n_interp}")
    print(f"[starfit] cli --binary: exit {rc_flat}, {t_flat:.2f} s, logz {m_flat.evidence[0]:.3f}, star kernel "
          f"launches {n_star}; cli --tree: exit {rc_tree}, {t_tree:.2f} s, logz {m_tree.evidence[0]:.3f}, "
          f"labelstring {m_tree.labelstring}, tree kernel launches {n_tree}; kernel B launches (the derived "
          f"samples) {n_interp}")

    # the resume check: stop after two chunks, lose the results file (a
    # killed fit wrote none), resume; against the fit that never stopped
    n_batch = min(NESTED["n_batch"], CLI_LIVE // 4)
    two_chunks = 2 * max(_chunk_dead(CLI_LIVE) // n_batch, 8) * n_batch
    stopped = write_ini(os.path.join(workdir, "cli_resume"), flat_text)
    part_file = os.path.join(stopped, "synthetic_starmodel_binary.h5")
    rc1 = starfit_main(common + ["--binary", "--resume", "--max_iter", str(two_chunks), stopped])
    part = BinaryStarModel.load_hdf(part_file, ic=ic)
    os.remove(part_file)
    rc2 = starfit_main(common + ["--binary", "--resume", stopped])
    resumed = BinaryStarModel.load_hdf(part_file, ic=ic)
    if rc1 != 0 or rc2 != 0:
        raise AssertionError(f"resume check exit codes {rc1}, {rc2}")
    if np.array_equal(part.samples["lnprob"], m_flat.samples["lnprob"]):
        raise AssertionError("the stopped fit was not stopped")
    for c, v in m_flat.samples.items():
        if not np.array_equal(resumed.samples[c], v):
            raise AssertionError(f"resumed fit differs from the uninterrupted one in column {c}")
    if resumed.evidence != m_flat.evidence:
        raise AssertionError(f"resumed evidence {resumed.evidence} != {m_flat.evidence}")
    print(f"[starfit] resume on the card: stopped at {two_chunks} dead points (2 chunks), resumed; samples "
          f"({len(m_flat.samples)} columns x 4000) and evidence bitwise equal to the uninterrupted fit")
    return n_star, n_tree, n_interp


def eep_points(track, n, seed):
    """Seeded (mass, age, feh) numpy columns spread past the grid on every
    side, with every exact mass and [Fe/H] knot (the top ones together) and a
    NaN in each coordinate."""
    rng = np.random.default_rng(seed)
    masses, fehs = track.masses, track.fehs
    mass = np.exp(rng.uniform(np.log(0.09), np.log(11.0), n))
    age = rng.uniform(5.8, 10.3, n)
    feh = rng.uniform(-2.1, 0.6, n)
    k = len(masses)
    mass[:k] = masses
    feh[k: k + len(fehs)] = fehs
    mass[k + len(fehs)], feh[k + len(fehs)] = masses[-1], fehs[-1]
    mass[-1], age[-2], feh[-3] = np.nan, np.nan, np.nan
    return mass, age, feh


def check_eep(name, got, ref, atol=ATOL_EEP):
    """Identical NaN pattern and |got - ref| <= atol; returns ``(max abs
    error, finite count)``."""
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape or not np.array_equal(np.isnan(got), np.isnan(ref)):
        raise AssertionError(f"{name}: NaN pattern differs ({int(np.isnan(got).sum())} vs {int(np.isnan(ref).sum())} "
                             f"NaN, {int((np.isnan(got) != np.isnan(ref)).sum())} differ)")
    fin = ~np.isnan(ref)
    err = float(np.abs(got[fin] - ref[fin]).max()) if fin.any() else 0.0
    if not err <= atol:
        raise AssertionError(f"{name}: max abs err {err} > {atol}")
    return err, int(fin.sum())


def wrapper_launches(fn, reps):
    """Kernel F's launches per call of ``fn`` by its wrappers' own counters."""
    import torch

    from isochrones_torch.ops import generate_cuda as gc

    wrappers = (gc.generate_cuda, gc.generate_accurate_cuda, gc.get_eep_cuda, gc.get_eep_accurate_cuda,
                gc.eep_newton_cuda)
    for w in wrappers:
        w.launches = 0
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return sum(w.launches for w in wrappers) / reps


def newton_work(grid, icol, seed, target, x0, x1):
    """``(bytes, flops)`` that the Newton step needs on these points beyond
    its seed: the matched column read once (the iterates may touch any of
    its rows); per point ~40 flops a residual (8 corners and the slope), 14
    residuals (the seed's, 12 steps, the final one) and 33 more where the
    seed has no finite residual (the scan, counted on these points)."""
    import torch

    from isochrones_torch.ops.interp import interp_nd

    eep_knots = grid.knots[-1]
    eep = torch.clamp(seed, eep_knots[0], eep_knots[-1])
    pt = torch.stack([x0.expand_as(eep), x1.expand_as(eep), torch.nan_to_num(eep, nan=float(eep_knots[0]))], -1)
    r0 = interp_nd(grid.values, grid.knots, pt, icols=(icol,), axis_maps=grid.axis_maps)[:, 0] - target
    n_scan = int((~(torch.isfinite(eep) & torch.isfinite(r0))).sum())
    col = grid.values[..., icol]
    return col.numel() * col.element_size(), 40 * (14 * seed.numel() + 33 * n_scan)


def check_newton(name, got, ref, ref_resid, dtype, resid_at, resid_tol=0.02):
    """The accurate inversion's EEPs on the card against the plain Newton
    step's: float64 as ``check_eep`` (1e-9, identical NaN patterns); float32
    against the plain version in float32, to ``ATOL_NEWTON_F32``, the NaN
    patterns identical but at two knife edges, together at most
    ``KNIFE_ROWS_F32`` of the rows: the ``resid_tol`` cut (the plain final
    residual within ``RESID_EDGE_F32`` of ``resid_tol``), and a NaN-padded
    neighbour (an iterate exactly on an EEP knot reads the next row, NaN
    past a track's end, one unit in the last place below it does not, so one
    version stops there while the other goes on): the finite one of the two
    EEPs must then be a root by the plain residual ``resid_at`` (numpy EEPs
    of every row -> their residuals), lie within ``ATOL_NEWTON_F32`` of an
    EEP knot (``resid_at.eep_knots``), and the plain residual exactly at that
    knot must be NaN. Returns ``(max abs error, finite count, knife-edge
    rows)``."""
    if dtype == "float64":
        return check_eep(name, got, ref) + (0,)
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    r = np.abs(np.asarray(ref_resid, dtype=np.float64))
    differ = np.isnan(got) != np.isnan(ref)
    edge = np.abs(r - resid_tol) < RESID_EDGE_F32
    if (differ & ~edge).any():
        fin = np.where(np.isnan(got), ref, got)  # the finite one of the two
        knots = np.asarray(resid_at.eep_knots, dtype=np.float64)
        i = np.clip(np.searchsorted(knots, np.nan_to_num(fin)), 1, len(knots) - 1)
        knot = np.where(np.abs(fin - knots[i - 1]) <= np.abs(fin - knots[i]), knots[i - 1], knots[i])
        root = np.abs(resid_at(fin)) < resid_tol
        padded = np.isnan(resid_at(np.where(differ, knot, fin)))
        edge |= differ & root & (np.abs(fin - knot) <= ATOL_NEWTON_F32) & padded
    n_edge = int(differ.sum())
    if got.shape != ref.shape or (differ & ~edge).any() or n_edge > max(1, KNIFE_ROWS_F32 * len(ref)):
        raise AssertionError(f"{name}: NaN pattern differs at {n_edge} rows, {int((differ & ~edge).sum())} of them "
                             f"off the knife edges (plain |resid| {r[differ & ~edge][:5]})")
    both = ~np.isnan(got) & ~np.isnan(ref)
    err = float(np.abs(got[both] - ref[both]).max()) if both.any() else 0.0
    if not err <= ATOL_NEWTON_F32:
        raise AssertionError(f"{name}: max abs err {err} > {ATOL_NEWTON_F32}")
    return err, int(both.sum()), n_edge


def timed_call(fn, reps):
    """``(wall ms, device-busy ms, kernel launches, kernel names)`` per call
    of ``fn``: the wall-clock unprofiled, the rest from ``torch.profiler``.
    Where its windows of ``reps`` calls report no device event it profiles
    one call a window; if those report none either, busy and launches are
    None and the names empty (the launches are then counted by the wrappers
    alone, ``wrapper_launches``)."""
    wall = 1e3 * _wall(fn, reps)
    for r in (reps, 1):
        _, by_name = profile_kernels(fn, r, required=False)
        if by_name:
            return (wall, sum(ms for ms, _ in by_name.values()) / r, sum(n for _, n in by_name.values()) / r,
                    set(by_name))
    return wall, None, None, set()


def only_kernel(timed, kernel, what):
    """The device kernels ``timed_call`` saw in each of ``timed`` ({label:
    its result}) all hold ``kernel`` in their names; at least one call's
    windows saw one. Raises otherwise: a torch kernel beside the wrapper's
    launch, which the wrappers' counters cannot see."""
    seen = {label: names for label, (_, _, _, names) in timed.items() if names}
    if not seen:
        raise AssertionError(f"{what}: the profiler saw no device event in any call's windows")
    stray = {label: sorted(n for n in names if kernel not in n) for label, names in seen.items()}
    if any(stray.values()):
        raise AssertionError(f"{what}: device kernels other than {kernel}: {stray}")
    return sorted(seen)


def _fmt(x, spec):
    """``x`` formatted, or "not measured" for None."""
    return "not measured" if x is None else format(x, spec)


def phase_eep(dev, ic32, ic64):
    """Phase 13. Returns the record of the EEP inversion's times."""
    import torch

    import isochrones_torch
    from isochrones_torch.ops.generate import get_eep_fast

    t0 = time.perf_counter()
    cpu = isochrones_torch.get_ichrone("synthetic", device="cpu", dtype=torch.float64, **GRID)
    print(f"[eep] MIST-scale synthetic grid (f64) on the CPU in {time.perf_counter() - t0:.2f} s")
    tr64, tr32, trc = ic64.track, ic32.track, cpu.track
    if tr64.iso is not ic64 or ic64.track is not tr64 or tr64.eep_replaces != "age":
        raise AssertionError("the isochrone and track interpolators are not cross-linked")

    mass, age, feh = eep_points(trc, EEP_FAST_POINTS, seed=21)
    fast = tr64.get_eep(mass, age, feh)
    err_f, n_f = check_eep("get_eep fast, card vs CPU", fast, trc.get_eep(mass, age, feh))
    ma, aa, fa = mass[:EEP_ACCURATE_POINTS], age[:EEP_ACCURATE_POINTS], feh[:EEP_ACCURATE_POINTS]
    acc = tr64.get_eep(ma, aa, fa, accurate=True)
    err_a, n_a = check_eep("get_eep accurate, card vs CPU", acc, trc.get_eep(ma, aa, fa, accurate=True))
    if not (n_f > EEP_FAST_POINTS // 4 and n_a > EEP_ACCURATE_POINTS // 8):
        raise AssertionError(f"too few finite EEPs: {n_f}, {n_a}")
    print(f"[eep] track.get_eep f64, card vs CPU: fast {EEP_FAST_POINTS} points max_abs_err {err_f:.3e} "
          f"({n_f} finite), accurate {EEP_ACCURATE_POINTS} points max_abs_err {err_a:.3e} ({n_a} finite); "
          f"NaN patterns identical (atol {ATOL_EEP})")
    ok = np.isfinite(acc)
    back = tr64.interp_value([ma[ok], acc[ok], fa[ok]], ["age"])[:, 0]
    trip = np.abs(back - aa[ok])
    if not trip.max() < 0.02:
        raise AssertionError(f"mass -> EEP -> age round trip off by {trip.max()}")
    # the fast estimate is within one EEP of the accurate one nearly everywhere
    both = ok & np.isfinite(fast[:EEP_ACCURATE_POINTS])
    print(f"[eep] round trip mass -> EEP -> age: max |d log age| {trip.max():.3e}, median {np.median(trip):.3e} "
          f"(tolerance 0.02); |fast - accurate| median "
          f"{np.median(np.abs(fast[:EEP_ACCURATE_POINTS][both] - acc[both])):.3f} EEP")
    iso_acc = ic64.get_eep(ma, aa, fa, accurate=True)
    err_i, n_i = check_eep("iso.get_eep accurate, card vs CPU", iso_acc, cpu.get_eep(ma, aa, fa, accurate=True))
    ok = np.isfinite(iso_acc)
    back = ic64.interp_value([iso_acc[ok], aa[ok], fa[ok]], ["initial_mass"])[:, 0]
    if not n_i > EEP_ACCURATE_POINTS // 8 or not np.abs(back - ma[ok]).max() < 0.02:
        raise AssertionError(f"iso.get_eep: {n_i} finite, round trip off by {np.abs(back - ma[ok]).max()}")
    print(f"[eep] iso.get_eep(accurate=True) f64, card vs CPU: max_abs_err {err_i:.3e} ({n_i} finite); round trip "
          f"mass -> EEP -> mass max {np.abs(back - ma[ok]).max():.3e} Msun")

    # times in float32, on tensors already on the card
    m32, a32, f32 = (torch.as_tensor(x, device=dev, dtype=torch.float32) for x in (mass, age, feh))
    n_acc = EEP_ACCURATE_POINTS
    ma32, aa32, fa32 = m32[:n_acc], a32[:n_acc], f32[:n_acc]
    fast_ms = timed_call(lambda: tr32.get_eep_batch(m32, a32, f32), reps=10)
    acc_ms = timed_call(lambda: tr32.get_eep_batch(ma32, aa32, fa32, accurate=True), reps=40)
    iso_ms = timed_call(lambda: ic32.get_eep_batch(ma32, aa32, fa32, accurate=True), reps=40)
    counted = {label: wrapper_launches(fn, reps=10) for label, fn in (
        ("track fast", lambda: tr32.get_eep_batch(m32, a32, f32)),
        ("track accurate", lambda: tr32.get_eep_batch(ma32, aa32, fa32, accurate=True)),
        ("iso accurate", lambda: ic32.get_eep_batch(ma32, aa32, fa32, accurate=True)))}
    table = sum(t.numel() * t.element_size() for t in tr32.eep_support)
    fast_bound = bound(4 * 4 * EEP_FAST_POINTS + table, 4 * 12 * 4 * EEP_FAST_POINTS, 0, "float32")
    fm32 = tr32._forward_model
    acc_work = newton_work(fm32.model, fm32.i_age, get_eep_fast(fm32, ma32, aa32, fa32), aa32, fa32, ma32)
    acc_bound = bound(4 * 4 * n_acc + table + acc_work[0], 4 * 12 * 4 * n_acc + acc_work[1], 0, "float32")
    ng32 = ic32._newton_grid
    iso_work = newton_work(ng32.grid, ng32.icol, torch.full_like(ma32, 300.0), ma32, aa32, fa32)
    iso_bound = bound(4 * 4 * n_acc + iso_work[0], iso_work[1], 0, "float32")
    checked = only_kernel({"track fast": fast_ms, "track accurate": acc_ms, "iso accurate": iso_ms},
                          "generate_kernel", "get_eep_batch")
    for label, n, (wall, busy, launches, _), b in (("track fast", EEP_FAST_POINTS, fast_ms, fast_bound),
                                                 ("track accurate", n_acc, acc_ms, acc_bound),
                                                 ("iso accurate", n_acc, iso_ms, iso_bound)):
        print(f"[eep] time f32 get_eep_batch {label}, {n} points: {wall:.3f} ms per call, device busy "
              f"{_fmt(busy, '.4f')} ms, {_fmt(launches, '.1f')} kernel launches under the profiler, "
              f"{counted[label]:.1f} by the wrappers' counters; bound {b[0]:.5f} ms ({b[2]}), at {b[0] / wall:.5f} "
              f"of it")
    if any(v != 1 for v in counted.values()):
        raise AssertionError(f"an EEP inversion is not one kernel launch: {counted}")
    print(f"[eep] the profiler saw only kernel F in the windows of {checked}")
    return dict(fast_points=EEP_FAST_POINTS, fast_ms=fast_ms[0], fast_busy_ms=fast_ms[1], fast_launches=fast_ms[2],
                fast_bound_ms=fast_bound[0], accurate_points=n_acc, accurate_ms=acc_ms[0],
                accurate_busy_ms=acc_ms[1], accurate_launches=acc_ms[2], accurate_bound_ms=acc_bound[0],
                iso_accurate_ms=iso_ms[0], iso_accurate_busy_ms=iso_ms[1], iso_accurate_launches=iso_ms[2],
                iso_accurate_bound_ms=iso_bound[0], counted_launches=counted)


def fit_call_kernel(model, pw):
    """The cluster kernel on the arguments that one ``lnpost_batch`` of the
    nested fit's walker batch ``pw`` hands it (captured from the call): its
    device time (mean of 5 launches) and the bound counted on the same
    inputs (:func:`cluster_work`). The inputs of :func:`make_kernel_inputs`
    are random ladders, with more cells kept than the fit's."""
    import isochrones_torch.ops.cluster_cuda as cluster_cuda_mod

    kernel = cluster_cuda_mod.cluster_lnmarginal_cuda
    seen = []

    def capture(*args, **kw):
        seen.append((args, kw))
        return kernel(*args, **kw)

    capture.launches = kernel.launches
    cluster_cuda_mod.cluster_lnmarginal_cuda = capture
    try:
        model.lnpost_batch(pw)
    finally:
        cluster_cuda_mod.cluster_lnmarginal_cuda = kernel
        kernel.launches = capture.launches
    if len(seen) != 1:
        raise AssertionError(f"one lnpost_batch called the cluster kernel {len(seen)} times")
    args, kw = seen[0]
    ms = kernel_ms(lambda: kernel(*args, **kw), "cluster_marginal", reps=5)
    masks = {"valid": args[13], "valid_k": args[13] if kw.get("valid_k") is None else kw["valid_k"]}
    bound_ms, bound_by, what = bound(*cluster_work(args[:13], masks), "float32")
    print(f"[kernel] time at the nested fit's call (W={len(pw)}, the arguments of one lnpost_batch): cluster kernel "
          f"{ms:.4f} ms; bound on the same inputs {bound_ms:.4f} ms ({what}), kernel at {bound_ms / ms:.3f} of it")
    return dict(ms_fit_call=ms, bound_ms_fit_call=bound_ms, bound_by_fit_call=bound_by)


def phase_cluster_nested(dev, ic32, ic64):
    """Phase 14. Returns ``(the simulated catalogue, the cluster kernel's
    record at W = 1024, its launches in the nested fit)``."""
    import torch

    import isochrones_torch.samplers.nested as nested_mod
    from isochrones_torch.catalog import read_csv
    from isochrones_torch.cluster import SimulatedCluster, StarClusterModel
    from isochrones_torch.ops.cluster import cluster_lnmarginal_plain
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    # ---- the simulator on the card against the committed catalogue
    sim = SimulatedCluster(50, ic=ic64, **CLUSTER_SIM)
    want = read_csv(FIXTURE)
    errs = {}
    for c in want:
        got, ref = np.asarray(sim.data[c], dtype=np.float64), want[c]
        if c in SIM_DRAWN:
            if not np.array_equal(got, ref):
                raise AssertionError(f"SimulatedCluster: drawn column {c} differs from {FIXTURE}")
        else:
            errs[c] = check_eep(f"SimulatedCluster column {c}", got, ref)[0]
    if set(want) != set(SIM_DRAWN + SIM_INTERPOLATED) or not set(want) <= set(sim.data):
        raise AssertionError(f"catalogue columns {sorted(want)}")
    print(f"[sim] SimulatedCluster(50, rng=0) on the card (f64) reproduces {FIXTURE}: {len(SIM_DRAWN)} drawn columns "
          f"equal, max_abs_err {json.dumps({c: float(f'{e:.3e}') for c, e in errs.items()})} (atol {ATOL_EEP}); "
          f"{int(sim.data['is_binary'].sum())} binaries, no NaN magnitude")

    # ---- the kernel at the nested fit's walker batch
    S, E, B = MAIN_SHAPE
    inputs = make_kernel_inputs(S, E, B, W_FIT, seed=S + E + B + W_FIT)
    a64, kw64 = to_torch(inputs, dev, torch.float64)
    got64 = cluster_lnmarginal_cuda(*a64, **kw64).cpu().numpy()
    ref64 = cluster_lnmarginal_plain(*a64, **kw64).cpu().numpy()
    err64 = check_close(f"f64 kernel W={W_FIT}", got64, ref64, RTOL_F64)
    del a64, kw64
    in32 = as_float32(inputs)
    a32, kw32 = to_torch(in32, dev, torch.float32)
    a32up, kw32up = to_torch(in32, dev, torch.float64)
    got32 = cluster_lnmarginal_cuda(*a32, **kw32).cpu().numpy()
    ms64 = kernel_ms(lambda: cluster_lnmarginal_cuda(*a32up, **kw32up), "cluster_marginal", reps=2, warmup=1)
    ref32 = cluster_lnmarginal_plain(*a32up, **kw32up).cpu().numpy()
    err32 = check_close(f"f32 kernel W={W_FIT}", got32, ref32, RTOL_F32, ATOL_F32)
    del a32up, kw32up
    ms = kernel_ms(lambda: cluster_lnmarginal_cuda(*a32, **kw32), "cluster_marginal", reps=5)
    plain_ms = cuda_ms(lambda: cluster_lnmarginal_plain(*a32, **kw32), reps=1, warmup=0)
    bound_ms, bound_by, what = bound(*cluster_work(a32, kw32), "float32")
    del a32, kw32
    torch.cuda.empty_cache()
    print(f"[kernel] S={S} E={E} B={B} W={W_FIT} (the nested fit's batch): f64 max_abs_err {err64:.3e} (rtol "
          f"{RTOL_F64}), f32 max_abs_err {err32:.3e} (rtol {RTOL_F32} atol {ATOL_F32}), "
          f"{int(np.isfinite(ref64).sum())}/{ref64.size} finite")
    print(f"[kernel] time S={S} E={E} B={B} W={W_FIT}: kernel f32 {ms:.4f} ms, plain f32 {plain_ms:.1f} ms, kernel f64 "
          f"{ms64:.4f} ms; f32 bound {bound_ms:.4f} ms ({what}), kernel at {bound_ms / ms:.3f} of it")
    record = dict(fit_batch=W_FIT, ms_fit_batch=ms, plain_ms_fit_batch=plain_ms, bound_ms_fit_batch=bound_ms,
                  max_abs_err_fit_batch=err32, ms_f64_fit_batch=ms64)

    # ---- the model, one W = 1024 lnpost_batch, the nested fit
    model = StarClusterModel(ic32, sim, **{k: v for k, v in MODEL.items() if k not in ("bands", "props")})
    marg = model.star_lnmarginals(TRUTH)
    if not np.isfinite(marg).all() or not np.isfinite(model.lnlike(TRUTH)):
        raise AssertionError(f"a member has no support at the truth: {marg}")
    rng = np.random.default_rng(1)
    pw = torch.as_tensor(np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(W_FIT, 7)), device=dev,
                         dtype=torch.float32)
    cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
    lp = model.lnpost_batch(pw)
    torch.cuda.synchronize()
    n_interp_call = interp_nd_cuda.launches
    if cluster_lnmarginal_cuda.launches != 1 or n_interp_call != INTERP_PER_CLUSTER_CALL or not torch.isfinite(lp).any():
        raise AssertionError(f"W={W_FIT} lnpost_batch: {cluster_lnmarginal_cuda.launches} cluster kernel launches, "
                             f"{n_interp_call} of kernel B, {int(torch.isfinite(lp).sum())} finite")
    call_ms = 1e3 * _wall(lambda: model.lnpost_batch(pw), reps=5)
    prof_s, by_name = profile_kernels(lambda: model.lnpost_batch(pw), reps=3)
    busy = sum(v[0] for v in by_name.values()) / 3
    k_ms = sum(v[0] for k, v in by_name.items() if "cluster_marginal" in k) / 3
    b_ms = sum(v[0] for k, v in by_name.items() if "interp_nd_kernel" in k) / 3
    n_kernels = sum(v[1] for v in by_name.values()) / 3
    idle = 1 - busy / (1e3 * prof_s / 3)
    print(f"[cluster nested] one W={W_FIT} lnpost_batch f32: {call_ms:.3f} ms ({1e3 * prof_s / 3:.3f} ms under the "
          f"profiler), {n_kernels:.1f} kernel launches, device busy {busy:.3f} ms (idle share {idle:.3f}), cluster "
          f"kernel {k_ms:.3f} ms ({k_ms / busy:.3f} of busy), kernel B {n_interp_call} launches {b_ms:.3f} ms; "
          f"{int(torch.isfinite(lp).sum())}/{W_FIT} finite")
    record.update(lnpost_batch_ms_fit_batch=call_ms, lnpost_batch_kernels_fit_batch=n_kernels,
                  lnpost_batch_idle_fit_batch=idle, interp_launches_fit_batch_call=n_interp_call)
    record.update(fit_call_kernel(model, pw))

    seen = {}
    run_nested = nested_mod.run_nested

    def recording_run_nested(*args, **kwargs):
        seen.update(kwargs)
        return run_nested(*args, **kwargs)

    nested_mod.run_nested = recording_run_nested
    cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = model.fit(**CLUSTER_FIT)
    finally:
        nested_mod.run_nested = run_nested
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_launch, n_interp = cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches
    if seen.get("dynamic") is not True or (seen.get("n_batch"), seen.get("n_chains")) != (64, 16):
        raise AssertionError(f"the cluster fit is not dynamic by default at the card's batch: {seen}")
    if (not np.isfinite(res.logz) or res.truncated or n_launch <= 0 or n_interp < INTERP_PER_CLUSTER_CALL * n_launch
            or model.evidence != (res.logz, res.logzerr)):
        raise AssertionError(f"nested cluster fit: logz {res.logz}, truncated {res.truncated}, launches {n_launch}, "
                             f"kernel B {n_interp}")
    d_lo, d_hi = np.quantile(model.samples["distance"], [0.025, 0.975])
    if not d_lo <= TRUTH[2] <= d_hi:
        raise AssertionError(f"cluster distance 95% interval ({d_lo:.2f}, {d_hi:.2f}) misses {TRUTH[2]}")
    if set(model.derived_samples) != set(model.param_names) | {"lnprob"}:
        raise AssertionError("cluster derived_samples are not the raw chain")
    n_batch = min(64, CLUSTER_FIT["n_live_points"] // 4)
    med = {k: round(float(np.median(v)), 4) for k, v in model.samples.items() if k != "lnprob"}
    print(f"[cluster nested] lnpost at the truth {model.lnpost(TRUTH):.3f}, best sample {model.samples['lnprob'].max():.3f}")
    print(f"[cluster nested] fit {json.dumps(CLUSTER_FIT)} f32, dynamic by default, n_batch {n_batch} x n_chains 16: "
          f"{fit_s:.3f} s, {res.n_iter} dead points, {res.n_iter // n_batch} steps, {res.dynamic_rounds} dynamic "
          f"rounds, logz {res.logz:.4f} +- {res.logzerr:.4f}, ESS {res.ess:.1f}, cluster kernel launches {n_launch}, "
          f"kernel B launches {n_interp}")
    print(f"[cluster nested] posterior medians {json.dumps(med)}; distance 95% interval ({d_lo:.3f}, {d_hi:.3f})")
    record.update(nested_fit_seconds=fit_s, interp_launches_nested_fit=n_interp)
    return sim, record, n_launch


#: phase 15's subprocess: the CLI's main, then the kernel wrappers' counts
CLUSTER_CLI_RUN = (
    "import json, sys\n"
    "from isochrones_torch.cli.clusterfit import main\n"
    "from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda\n"
    "from isochrones_torch.ops.interp_cuda import interp_nd_cuda\n"
    "rc = main(sys.argv[1:])\n"
    "print('launches ' + json.dumps([cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches]))\n"
    "sys.exit(rc)\n"
)


def _write_csv(path, columns):
    """``columns`` as a CSV file of exact float reprs (``DataFrame.to_csv(index=False)``'s values)."""
    import csv

    cols = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(len(columns[cols[0]])):
            w.writerow([repr(float(columns[c][i])) for c in cols])
    return path


def phase_cluster_entry_point(sim, workdir):
    """Phase 15: the CLI's ``main`` in a subprocess on a CSV of phase 14's
    catalogue. Returns the launches of the cluster kernel and of kernel B."""
    import re

    path = _write_csv(os.path.join(workdir, "cluster50.csv"), sim.data)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLUSTER_CLI_RUN, *CLUSTER_CLI, path], capture_output=True, text=True,
                          timeout=900)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    found = re.search(r"clusterfit cluster_smoke: logz = (\S+) \+- (\S+)", log)
    if proc.returncode != 0 or found is None or not np.isfinite(float(found.group(1))):
        raise AssertionError(f"clusterfit CLI: exit {proc.returncode}, log:\n{log[-3000:]}")
    if "no (eep, q) support" in log:
        raise AssertionError(f"clusterfit CLI: a member has no support:\n{log[-3000:]}")
    n_cluster, n_interp = json.loads(re.search(r"^launches (.*)$", proc.stdout, re.M).group(1))
    if n_cluster <= 0 or n_interp < INTERP_PER_CLUSTER_CALL * n_cluster:
        raise AssertionError(f"clusterfit CLI: cluster kernel launches {n_cluster}, kernel B {n_interp}")
    print(f"[clusterfit] isochrones_torch.cli.clusterfit.main {' '.join(CLUSTER_CLI)} <csv of {len(sim)} stars> in a "
          f"subprocess: exit {proc.returncode}, {secs:.2f} s, logz {float(found.group(1)):.4f} +- "
          f"{float(found.group(2)):.4f}, cluster kernel launches {n_cluster}, kernel B launches {n_interp}")
    return n_cluster, n_interp


def catalog_table(ic, n_stars, eep_box, seed=0):
    """A seeded catalogue of ``n_stars`` single stars on ``ic`` in the bands
    ``CAT_BANDS`` with Teff, logg and a parallax: truths spread over the grid
    (EEPs in ``eep_box``, log age 8.5-9.7, [Fe/H] -0.5-0.3, 100-800 pc, AV
    0-0.5; a truth off the grid is drawn again), observations the port's
    ``interp_mag`` at the truths, without noise, so that every posterior is
    centred on its truth and a coverage check does not hang on the noise of
    256 draws (errors 0.02 mag, 100 K, 0.1 dex, 0.05 mas). Holes: every 17th
    star lacks H, every 23rd its parallax, star 7 its Teff, star 11 every
    band. Returns ``(truths (S, 5), columns)``."""
    rng = np.random.default_rng(seed)
    box = (eep_box, (8.5, 9.7), (-0.5, 0.3), (100.0, 800.0), (0.0, 0.5))
    truths = np.stack([rng.uniform(lo, hi, n_stars) for lo, hi in box], axis=-1)
    for _ in range(50):
        Teff, logg, _, mags = ic.interp_mag([truths[:, i] for i in range(5)], list(CAT_BANDS))
        bad = ~(np.isfinite(mags).all(axis=-1) & np.isfinite(Teff))
        if not bad.any():
            break
        truths[bad] = np.stack([rng.uniform(lo, hi, int(bad.sum())) for lo, hi in box], axis=-1)
    else:
        raise AssertionError("catalog truths: no finite magnitudes after 50 draws")
    cols = {}
    for j, b in enumerate(CAT_BANDS):
        cols[f"{b}_mag"] = np.array(mags[:, j], dtype=float)
        cols[f"{b}_mag_unc"] = np.full(n_stars, 0.02)
    cols["Teff"], cols["Teff_unc"] = np.array(Teff, dtype=float), np.full(n_stars, 100.0)
    cols["logg"], cols["logg_unc"] = np.array(logg, dtype=float), np.full(n_stars, 0.1)
    cols["parallax"], cols["parallax_unc"] = 1000.0 / truths[:, 3], np.full(n_stars, 0.05)
    idx = np.arange(n_stars)
    cols["H_mag"][idx % 17 == 3] = np.nan
    cols["parallax"][idx % 23 == 5] = np.nan
    cols["Teff"][7] = np.nan
    for b in CAT_BANDS:
        cols[f"{b}_mag"][11] = np.nan
    return truths, cols


def catalog_points(ic, truths, n_points, seed=0):
    """Seeded (S, n_points, 5) parameters: the first half in a box about each
    star's truth, the second half over the whole grid with adversarial rows
    (a NaN EEP, the top knots, an EEP below the grid, distance 0)."""
    rng = np.random.default_rng(seed)
    ages, fehs, eeps = (k.cpu().double().numpy() for k in ic.model.knots)
    S, h = truths.shape[0], n_points // 2
    near = truths[:, None, :] + rng.uniform(-1.0, 1.0, (S, h, 5)) * np.array([20.0, 0.1, 0.1, 0.0, 0.05])
    near[..., 3] = truths[:, None, 3] * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, (S, h)))
    near[..., 4] = np.abs(near[..., 4])
    box = ((eeps[0], eeps[-1]), (ages[0], ages[-1]), (fehs[0], fehs[-1]), (10.0, 3000.0), (0.0, 1.5))
    far = np.stack([rng.uniform(lo, hi, (S, n_points - h)) for lo, hi in box], axis=-1)
    far[:, 0, 0] = np.nan
    far[:, 1, :3] = (eeps[-1], ages[-1], fehs[-1])
    far[:, 2, 0] = eeps[0] - 0.5
    far[:, 3, 3] = 0.0
    return np.concatenate([near, far], axis=1)


def catalog_likelihood_as(lk, dtype):
    """The same catalog likelihood with its grids and observations in another
    dtype."""
    import torch

    changes = {f.name: getattr(lk, f.name).to(dtype) for f in dataclasses.fields(lk)
               if isinstance(getattr(lk, f.name), torch.Tensor)}
    return dataclasses.replace(lk, pack6=grid_as(lk.pack6, dtype), bc=grid_as(lk.bc, dtype), **changes)


def catalog_priors_as(pri, dtype):
    """The same packed priors for another dtype: the per-star distance rows
    in ``dtype``; from float32 every constant rounded to float32, as the
    float32 kernel rounds it, so that a float64 reference sees the float32
    run's constants."""
    import torch

    consts = pri.consts
    if pri.dist.dtype == torch.float32:
        consts = {k: float(np.float32(v)) for k, v in consts.items()}
    return dataclasses.replace(pri, consts=consts, dist=pri.dist.to(dtype))


def catalog_unit_points(truths, los, his, n_points, seed=0):
    """Seeded (S, n_points, 5) unit-cube points in the nested fit's per-star
    boxes: half about each truth, half uniform, a row at 0 and a row at 1."""
    rng = np.random.default_rng(seed)
    S, h = truths.shape[0], n_points // 2
    u = rng.uniform(0.0, 1.0, (S, n_points, 5))
    u[:, :h] = np.clip((truths[:, None, :] - los) / (his - los)[:, None, :] + rng.normal(0, 0.02, (S, h, 5)), 0, 1)
    u[:, h], u[:, h + 1] = 0.0, 1.0
    return u


def catalog_work(pars, lk, post=False, unit=False):
    """``(bytes, flops, special functions)`` of the catalog posterior
    (``post``) or likelihood on these parameters: the points read (with the
    per-star box tops in the unit-cube form) and the outputs written once (the
    posterior's one column, the likelihood's three), each distinct row that
    the points' corners touch read once (6 pack columns; the wanted band
    columns of the BC table, whatever the kernel's layout pads), each star's
    observation row (and the posterior's distance row) once; per point ~70
    flops of cell location, 8 corners x (6 weight + 12 lerp flops), 16 corners
    x (8 + 2 per band), 3 per band for the magnitudes, ~6 per Gaussian term,
    one log10 (the distance modulus) and a log per term. The posterior's
    epilogue adds ~60 flops (the priors' products, sums, divisions, bounds and
    selects; 15 more for the box map) and 8 special functions: three exp and
    a log for [Fe/H], a log each for the distance, the log-normal, the power
    law and the derivative."""
    import torch

    from isochrones_torch.ops.interp import interp_nd

    S, B = pars.shape[:2]
    nb = len(lk.band_icols)
    io = lk.index_order
    pts = pars.reshape(S * B, 5)
    gp = torch.stack([pts[:, io[0]], pts[:, io[1]], pts[:, io[2]]], dim=-1)
    v6 = interp_nd(lk.pack6.values, lk.pack6.knots, gp, axis_maps=lk.pack6.axis_maps)
    bp = torch.stack([v6[:, 0], v6[:, 1], v6[:, 2], pts[:, 4]], dim=-1)
    rows = _touched_rows(lk.pack6, gp) * 6 + _touched_rows(lk.bc, bp) * nb
    n_terms = nb + 3 + (lk.plax is not None)
    per_star = (8 + 2 * nb) + (2 if post else 0) + (5 if unit else 0)
    nbytes = (pars.numel() + (1 if post else 3) * S * B + rows + S * per_star) * pars.element_size()
    flops = S * B * (70 + 8 * 18 + 16 * (8 + 2 * nb) + 3 * nb + 6 * n_terms + (60 + 15 * unit if post else 0))
    return nbytes, flops, S * B * (1 + n_terms + (8 if post else 0))


def phase_catalog_kernel(dev, ic32, ic64):
    """Phase 16: both instantiations of the catalog kernel (the posterior,
    the fitter's path, and the likelihood's triple) against their plain
    versions at the nested fit's (256, 256) and the MCMC half-update's
    (256, 32), float64 and float32, and the posterior's unit-cube form at
    (256, 256); their device times beside the posterior's bound, its plain
    version's time and the earlier likelihood-only kernel's. Returns
    ``(truths, table, record)``."""
    import torch

    from isochrones_torch.batch import BatchStarFitter
    from isochrones_torch.ops.catalog import catalog_lnlike_plain, catalog_lnpost_plain, unit_box
    from isochrones_torch.ops.catalog_cuda import catalog_lnlike_cuda, catalog_lnpost_cuda, compact_bc

    truths, table = catalog_table(ic64, CAT_STARS, CAT_EEP_BOX)
    fit64, fit32 = BatchStarFitter(ic64, table, bands=CAT_BANDS), BatchStarFitter(ic32, table, bands=CAT_BANDS)
    lk64, pri64 = fit64._catalog_likelihood(), fit64._catalog_priors()
    lk32, pri32 = fit32._catalog_likelihood(), fit32._catalog_priors()
    lk32up, pri32up = catalog_likelihood_as(lk32, torch.float64), catalog_priors_as(pri32, torch.float64)
    p64 = torch.as_tensor(catalog_points(ic64, truths, CAT_POINTS, seed=16), device=dev, dtype=torch.float64)
    p32 = p64.float()
    los, his = fit64._bounds_arrays()
    u64 = torch.as_tensor(catalog_unit_points(truths, los, his, CAT_POINTS, seed=17), device=dev,
                          dtype=torch.float64)
    u32 = u64.float()
    h64 = torch.as_tensor(his, device=dev, dtype=torch.float64)
    h32 = torch.as_tensor(fit32._bounds_arrays()[1], device=dev, dtype=torch.float32)
    B_mc = CAT_MCMC["nwalkers"] // 2
    width = compact_bc(lk32).shape[-1]

    def lnpost_errs(x64, x32, hh64=None, hh32=None, name=""):
        got64 = catalog_lnpost_cuda(x64, lk64, pri64, hh64)[0].cpu().numpy()
        ref64 = catalog_lnpost_plain(x64, lk64, pri64, hh64)[0].cpu().numpy()
        got32 = catalog_lnpost_cuda(x32, lk32, pri32, hh32)[0].cpu().numpy()
        px = x32 if hh32 is None else unit_box(x32, pri32, hh32)  # the float32 box map, as the kernel rounds it
        ref32 = catalog_lnpost_plain(px.double(), lk32up, pri32up)[0].cpu().numpy()
        torch.cuda.synchronize()
        e = (check_star(f"catalog posterior f64 {name}", [got64], [ref64], RTOL_STAR_F64),
             check_star(f"catalog posterior f32 {name}", [got32], [ref32], RTOL_STAR_F32, ATOL_STAR_F32))
        return e, ref64

    errs = {}
    for B in (CAT_POINTS, B_mc):
        x64, x32 = p64[:, :B].contiguous(), p32[:, :B].contiguous()
        (e64, e32), ref = lnpost_errs(x64, x32, name=f"B={B}")
        l64 = check_star(f"catalog likelihood f64 B={B}", [x.cpu().numpy() for x in catalog_lnlike_cuda(x64, lk64)],
                         [x.cpu().numpy() for x in catalog_lnlike_plain(x64, lk64)], RTOL_STAR_F64)
        l32 = check_star(f"catalog likelihood f32 B={B}", [x.cpu().numpy() for x in catalog_lnlike_cuda(x32, lk32)],
                         [x.cpu().numpy() for x in catalog_lnlike_plain(x32.double(), lk32up)], RTOL_STAR_F32,
                         ATOL_STAR_F32)
        errs[B] = (e64, e32)
        print(f"[catalog] kernel vs plain, S={CAT_STARS} B={B} {len(CAT_BANDS)} bands (compact BC table {width} "
              f"columns wide): posterior f64 max_abs_err {e64:.3e} (rtol {RTOL_STAR_F64}), f32 vs f64 {e32:.3e} "
              f"(rtol {RTOL_STAR_F32} atol {ATOL_STAR_F32}), "
              f"{int(np.isfinite(ref).sum())}/{ref.size} finite, {int(np.isneginf(ref).sum())} -inf; likelihood "
              f"(ll, orig_val, deriv) f64 {l64:.3e}, f32 vs f64 {l32:.3e}; NaN and +-inf patterns identical")
    (eu64, eu32), ref = lnpost_errs(u64, u32, h64, h32, name="unit cube")
    print(f"[catalog] posterior, unit-cube form (the box map in the kernel), S={CAT_STARS} B={CAT_POINTS}: f64 "
          f"max_abs_err {eu64:.3e}, f32 vs f64 {eu32:.3e}; {int(np.isfinite(ref).sum())}/{ref.size} finite")

    times = {}
    for B in (CAT_POINTS, B_mc):
        pb = p32[:, :B].contiguous()
        ms = kernel_ms(lambda: catalog_lnpost_cuda(pb, lk32, pri32), "catalog_lnlike", reps=50)
        ms_ll = kernel_ms(lambda: catalog_lnlike_cuda(pb, lk32), "catalog_lnlike", reps=50)
        plain_ms = cuda_ms(lambda: catalog_lnpost_plain(pb, lk32, pri32), reps=10)
        pb64 = pb.double()
        ms64 = kernel_ms(lambda: catalog_lnpost_cuda(pb64, lk64, pri64), "catalog_lnlike", reps=20)
        bound_ms, bound_by, what = bound(*catalog_work(pb, lk32, post=True), "float32")
        times[B] = (ms, plain_ms, ms64, bound_ms, bound_by, ms_ll)
        earlier = CAT_EARLIER_MS[B]
        print(f"[catalog] time S={CAT_STARS} B={B}: posterior kernel f32 {ms:.4f} ms (earlier likelihood-only kernel "
              f"{earlier} ms), likelihood instantiation {ms_ll:.4f} ms, plain posterior f32 {plain_ms:.4f} ms, "
              f"posterior kernel f64 {ms64:.4f} ms; f32 bound {bound_ms:.5f} ms ({what}), kernel at "
              f"{bound_ms / ms:.3f} of it")
    ms_unit = kernel_ms(lambda: catalog_lnpost_cuda(u32, lk32, pri32, h32), "catalog_lnlike", reps=50)
    pu = unit_box(u32, pri32, h32)
    bound_unit = bound(*catalog_work(pu, lk32, post=True, unit=True), "float32")
    print(f"[catalog] time S={CAT_STARS} B={CAT_POINTS}, unit-cube form (the nested fit's call): posterior kernel "
          f"f32 {ms_unit:.4f} ms; bound {bound_unit[0]:.5f} ms ({bound_unit[2]}), kernel at "
          f"{bound_unit[0] / ms_unit:.3f} of it")
    ms, plain_ms, ms64, bound_ms, bound_by, ms_ll = times[CAT_POINTS]
    record = dict(max_abs_err=errs[CAT_POINTS][1], max_abs_err_f64=errs[CAT_POINTS][0], ms=ms, plain_ms=plain_ms,
                  ms_f64=ms64, bound_ms=bound_ms, bound_by=bound_by,
                  function="log-posterior (likelihood, default priors, bounds, EEP change of variables)",
                  shape={"S": CAT_STARS, "B": CAT_POINTS, "bands": len(CAT_BANDS), "dtype": "float32"},
                  ms_likelihood=ms_ll, ms_unit_cube=ms_unit, bound_ms_unit_cube=bound_unit[0],
                  max_abs_err_unit_cube=eu32, ms_mcmc_batch=times[B_mc][0], plain_ms_mcmc_batch=times[B_mc][1],
                  bound_ms_mcmc_batch=times[B_mc][3], ms_likelihood_mcmc_batch=times[B_mc][5],
                  mcmc_batch=B_mc, compact_bc_width=width)
    return truths, table, record


def _coverage(fitter, truths):
    """Share of stars whose true distance lies in the 2.5-97.5% interval."""
    lo, hi = np.nanquantile(fitter.samples[:, :, 3], [0.025, 0.975], axis=1)
    return float(np.mean((lo <= truths[:, 3]) & (truths[:, 3] <= hi)))


def phase_catalog_fits(dev, ic32, truths, table):
    """Phase 17: both catalog fits at full width, then the summary, then the
    dynamic nested fit. Returns the posterior kernel's launches in the three
    fits."""
    import torch

    import isochrones_torch.samplers.nested as nested_mod
    from isochrones_torch import SingleStarModel
    from isochrones_torch.batch import BatchStarFitter, fit_catalog
    from isochrones_torch.ops.catalog_cuda import catalog_lnpost_cuda
    from isochrones_torch.summary import summarize_batch

    S = CAT_STARS
    fitter = BatchStarFitter(ic32, table, bands=CAT_BANDS)
    los, his = fitter._bounds_arrays()
    h32 = torch.as_tensor(his, device=dev, dtype=torch.float32)
    # one call at each fit's batch (the nested fit's in its unit-cube form),
    # and one single-star call beside them
    rng = np.random.default_rng(17)
    for B in (CAT_MCMC["nwalkers"] // 2, CAT_NESTED["n_batch"] * CAT_NESTED["n_chains"]):
        if B == CAT_POINTS:
            pb = torch.as_tensor(catalog_unit_points(truths, los, his, B, seed=int(rng.integers(1000))), device=dev,
                                 dtype=torch.float32)
            call, form = (lambda: fitter._lnpost(pb, his=h32)), "unit-cube points (the nested walk's call)"
        else:
            pb = torch.as_tensor(catalog_points(ic32, truths, 2 * B, seed=int(rng.integers(1000)))[:, :B],
                                 device=dev, dtype=torch.float32)
            call, form = (lambda: fitter.lnpost_batch(pb)), "parameters (the MCMC's call)"
        catalog_lnpost_cuda.launches = 0
        lp = call()
        torch.cuda.synchronize()
        if catalog_lnpost_cuda.launches != 1 or not torch.isfinite(lp).any():
            raise AssertionError(f"catalog lnpost_batch: {catalog_lnpost_cuda.launches} launches")
        call_ms = 1e3 * _wall(call, reps=50)
        prof_s, by_name = profile_kernels(call, reps=5)
        busy = sum(v[0] for v in by_name.values()) / 5
        n_kernels = sum(v[1] for v in by_name.values()) / 5
        k_ms = sum(v[0] for k, v in by_name.items() if "catalog_lnlike" in k) / 5
        if n_kernels > CAT_CALL_KERNELS:
            raise AssertionError(f"catalog lnpost_batch: {n_kernels} device kernels a call ({by_name}), at most "
                                 f"{CAT_CALL_KERNELS} allowed")
        print(f"[catalog fit] one lnpost_batch ({S}, {B}, 5) f32 on {form}: {call_ms:.4f} ms "
              f"({1e3 * call_ms / (S * B):.5f} us a point, {call_ms / S:.5f} ms a star; {1e3 * prof_s / 5:.4f} ms "
              f"under the profiler), 1 posterior launch, {n_kernels:.1f} device kernels a call (at most "
              f"{CAT_CALL_KERNELS}), device busy {busy:.4f} ms (idle share {1 - busy / call_ms:.3f} of the "
              f"unprofiled call, {1 - busy / (1e3 * prof_s / 5):.3f} under the profiler), catalog kernel "
              f"{k_ms:.4f} ms ({k_ms / busy:.3f} of busy); {int(torch.isfinite(lp).sum())}/{lp.numel()} finite")
    obs0 = {b: (table[f"{b}_mag"][0], table[f"{b}_mag_unc"][0]) for b in CAT_BANDS}
    obs0.update({k: (table[k][0], table[f"{k}_unc"][0]) for k in ("Teff", "logg", "parallax")})
    star0 = SingleStarModel(ic32, **obs0)
    p1 = torch.as_tensor(catalog_points(ic32, truths[:1], 2048, seed=18)[0, :1024], device=dev, dtype=torch.float32)
    single_ms = 1e3 * _wall(lambda: star0.lnpost_batch(p1), reps=20)
    print(f"[catalog fit] beside it, one single-star lnpost_batch of 1024 points (the star kernel): {single_ms:.3f} ms "
          f"({1e3 * single_ms / 1024:.4f} us a point)")

    catalog_lnpost_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc, mc_summary = fit_catalog(ic32, table, method="mcmc", bands=CAT_BANDS, **CAT_MCMC)
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    n_mc = catalog_lnpost_cuda.launches
    T = CAT_MCMC["niter"]
    if mc.samples.shape != (S, T * CAT_MCMC["nwalkers"], 5) or not np.isfinite(mc._lnprob).all() or n_mc <= 0:
        raise AssertionError(f"catalog MCMC: samples {mc.samples.shape}, {int(np.isfinite(mc._lnprob).sum())} finite "
                             f"lnprob, {n_mc} launches")
    acc = float(mc.sampler_state.n_accept.sum().item()) / (S * CAT_MCMC["nwalkers"] * T)
    print(f"[catalog fit] fit_catalog(method='mcmc', {json.dumps(CAT_MCMC)}) f32, {S} stars, summary with derived "
          f"columns: {mc_s:.3f} s (earlier {CAT_EARLIER_FIT_S['mcmc']} s), catalog kernel launches {n_mc}, acceptance "
          f"{acc:.3f}, {len(mc_summary)} summary columns; true distance in the 95% interval for "
          f"{_coverage(mc, truths):.3f} of the stars")

    catalog_lnpost_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fitter.fit_multinest(**CAT_NESTED)
    torch.cuda.synchronize()
    ns_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = summarize_batch(fitter)
    sum_s = time.perf_counter() - t0
    n_ns = catalog_lnpost_cuda.launches
    cover = _coverage(fitter, truths)
    logz = out["logz"]
    if not np.isfinite(logz).all() or n_ns <= 0 or cover < 0.95 or not out["converged"].all():
        raise AssertionError(f"catalog nested fit: {int(np.isfinite(logz).sum())}/{S} finite evidences, {n_ns} "
                             f"launches, distance coverage {cover}, {int(out['converged'].sum())}/{S} converged")
    if not np.array_equal(summary["logz"], logz) or summary.index.shape != (S,):
        raise AssertionError("summary evidence columns differ from the fit's")
    print(f"[catalog fit] fit_multinest({json.dumps(CAT_NESTED)}) f32, {S} stars: {ns_s:.3f} s (earlier "
          f"{CAT_EARLIER_FIT_S['nested']} s), {out['n_dead']} dead points a star, {int(out['converged'].sum())}/{S} "
          f"converged, logz {logz.min():.3f} .. {logz.max():.3f}, "
          f"logzerr median {np.median(out['logzerr']):.4f}, ESS min {out['ess'].min():.1f}, catalog kernel launches "
          f"{n_ns}; true distance in the 95% interval for {cover:.3f} of the stars")
    print(f"[catalog fit] summarize_batch: {sum_s:.3f} s, {len(summary)} columns, "
          f"{min(2000, CAT_NESTED.get('n_equal', 2000))} draws a star through one interpolator call")

    # the dynamic fit: thread rounds for the whole catalogue; the per-star
    # host merges timed
    merge_s = []
    merge = nested_mod._merge_segments

    def timed_merge(segments):
        t = time.perf_counter()
        out = merge(segments)
        merge_s.append(time.perf_counter() - t)
        return out

    nested_mod._merge_segments = timed_merge
    catalog_lnpost_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        dyn = fitter.fit_multinest(**CAT_NESTED, **CAT_DYNAMIC)
    finally:
        nested_mod._merge_segments = merge
    torch.cuda.synchronize()
    dyn_s = time.perf_counter() - t0
    n_dyn = catalog_lnpost_cuda.launches
    if not np.isfinite(dyn["logz"]).all() or dyn["dynamic_rounds"] < 1 or n_dyn <= 0 or not dyn["converged"].all():
        raise AssertionError(f"dynamic catalog fit: {int(np.isfinite(dyn['logz']).sum())}/{S} finite evidences, "
                             f"{dyn['dynamic_rounds']} rounds, {n_dyn} launches, {int(dyn['converged'].sum())}/{S} "
                             f"converged")
    print(f"[catalog fit] fit_multinest({json.dumps(dict(CAT_NESTED, **CAT_DYNAMIC))}) f32, {S} stars: {dyn_s:.3f} s "
          f"(earlier {CAT_EARLIER_FIT_S['dynamic']} s), {dyn['n_dead']} dead points a star, "
          f"{dyn['dynamic_rounds']} thread rounds, ESS min {dyn['ess'].min():.1f} "
          f"median {np.median(dyn['ess']):.1f}, {int(dyn['converged'].sum())}/{S} converged, logz {dyn['logz'].min():.3f} "
          f".. {dyn['logz'].max():.3f}, |logz - static logz| max {np.abs(dyn['logz'] - logz).max():.3f}, catalog "
          f"kernel launches {n_dyn}; host merges {len(merge_s)} in {sum(merge_s):.3f} s "
          f"({1e3 * sum(merge_s) / max(len(merge_s), 1):.3f} ms a star); distance coverage {_coverage(fitter, truths):.3f}")
    return n_mc, n_ns, n_dyn


def phase_catalog_entry_point(workdir):
    """Phase 18: ``python -m isochrones_torch.cli.fit_catalog`` as a subprocess
    on a small CSV at the default synthetic grid."""
    import csv

    from isochrones_torch import get_ichrone

    truths, table = catalog_table(get_ichrone("synthetic", device="cuda"), 16, CLI_EEP_BOX, seed=18)
    path, out = _write_csv(os.path.join(workdir, "catalog16.csv"), table), os.path.join(workdir, "catalog16_fit.csv")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "isochrones_torch.cli.fit_catalog", *CAT_CLI, path, "-O", out],
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"fit_catalog CLI: exit {proc.returncode}, log:\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    want = [""] + [f"{p}_{q}" for p in ("eep", "age", "feh", "distance", "AV") for q in ("16", "50", "84")]
    if header[:16] != want or header[-2:] != ["logz", "logzerr"] or "mass_50" not in header or len(rows) != 17:
        raise AssertionError(f"fit_catalog CLI output: header {header}, {len(rows) - 1} rows")
    logz = np.array([float(r[-2]) for r in rows[1:]])
    if not np.isfinite(logz).all() or [r[0] for r in rows[1:]] != [str(i) for i in range(16)]:
        raise AssertionError(f"fit_catalog CLI output: logz {logz}, index {[r[0] for r in rows[1:]]}")
    print(f"[fit-catalog] python -m isochrones_torch.cli.fit_catalog {' '.join(CAT_CLI)} <csv of 16 stars>: exit 0, "
          f"{secs:.2f} s, {len(header) - 1} columns ({', '.join(header[1:4])}, ..., {', '.join(header[-3:])}), "
          f"logz {logz.min():.3f} .. {logz.max():.3f}")


def phase_multi_run(dev, ic32, ic64):
    """Phase 19: ``run_nested(n_runs=4)`` through the binary model's nested
    fit. Returns the star kernel's launches."""
    import torch

    from isochrones_torch import BinaryStarModel
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda

    model = BinaryStarModel(ic32, **star_observations(ic64))
    star_lnlike_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.fit_multinest(**MULTI_RUNS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_star = star_lnlike_cuda.launches
    runs = MULTI_RUNS["n_runs"]
    if res.logz_runs is None or len(res.logz_runs) != runs or not np.isfinite(res.logz_runs).all() or n_star <= 0:
        raise AssertionError(f"run_nested(n_runs={runs}): logz_runs {res.logz_runs}, launches {n_star}")
    d_lo, d_hi = np.quantile(model.samples["distance"], [0.025, 0.975])
    if not d_lo <= STAR_TRUTH[4] <= d_hi:
        raise AssertionError(f"n_runs={runs} distance 95% interval ({d_lo:.2f}, {d_hi:.2f}) misses {STAR_TRUTH[4]}")
    print(f"[multi-run] BinaryStarModel.fit_multinest({json.dumps(MULTI_RUNS)}) f32, n_batch 64 x n_chains 16 a run: "
          f"{secs:.3f} s, {res.n_iter} dead points in all, logz {res.logz:.4f} +- {res.logzerr:.4f}, logz_runs "
          f"{json.dumps([round(float(x), 4) for x in res.logz_runs])}, ESS {res.ess:.1f}, star kernel launches {n_star}")
    return n_star


#: the forward model (phases 20-22): kernel F's points (the EEP inversion's
#: batch of phase 13), the accurate form's, and the population of
#: bench.py:425-450 (Salpeter 0.4-2.5, fB 0.4, gamma 0.3, [Fe/H] N(-0.1,
#: 0.15), distance <= 3000 pc, AV 0-1)
GEN_POINTS, GEN_ACCURATE_POINTS = 1_000_000, 100_000
GEN_BINARIES, GEN_MODEL_MAG, GEN_POPULATION = 100_000, 10_000, 100_000
#: kernel F against its plain version on the card: float64 EEPs bitwise, the
#: columns and magnitudes to rtol 1e-10 + 1e-10 of the column's scale (the
#: same lerps, summed in another order; log10 to within an ulp); float32
#: against the float64 plain version on the same float32 tables and inputs,
#: the EEPs to 2e-3 (the blend's weights rounded to float32, EEPs up to 1711)
#: and the columns and magnitudes, at the kernel's own EEPs, to rtol 2e-5 +
#: 2e-5 of the column's scale (three float32 weight products and 8 or 16
#: corners a lerp)
RTOL_GEN_F64, RTOL_GEN_F32, ATOL_EEP_F32 = 1e-10, 2e-5, 2e-3
#: float32 magnitudes at a BC grid's edge: a star whose interpolated Teff,
#: logg or [Fe/H] (or whose AV) lies within this relative distance of the
#: first or last knot of its BC axis may be inside the grid in float32 and
#: outside in float64 (its magnitudes finite in one, NaN in the other); a
#: float32 lerp of 8 corners carries a few ulp (~1e-7 relative), so 1e-6
BC_EDGE_RTOL_F32 = 1e-6
#: phase 13's fast get_eep at 1,000,000 points in plain torch, before kernel
#: F took it (PERF.md, row D's earlier time): wall ms, launches
EEP_EARLIER = (10.405, 650)
#: kernel F's first version at this phase's shape (PERF.md, row F's earlier time): ms, EEP-only ms
GEN_EARLIER_MS, GEN_EARLIER_EEP_MS = 0.8374, 0.2894
GEN_CLI_STARS = 1000


def generate_points(track, n, seed):
    """Seeded (mass, age, feh, distance, AV) numpy columns: mass log-uniform
    on 0.1-10, ages 8-10.2, [Fe/H] -2.2-0.7 (past the grid's -2.0-0.5), with
    every exact mass and [Fe/H] knot, the top knots together, NaN rows in
    each coordinate, and ages past every track's end."""
    rng = np.random.default_rng(seed)
    masses, fehs = track.masses, track.fehs
    mass = np.exp(rng.uniform(np.log(0.1), np.log(10.0), n))
    age = rng.uniform(8.0, 10.2, n)
    feh = rng.uniform(-2.2, 0.7, n)
    k = len(masses)
    mass[:k] = masses
    feh[k: k + len(fehs)] = fehs
    mass[k + len(fehs)], feh[k + len(fehs)] = masses[-1], fehs[-1]
    age[k + len(fehs) + 1: k + len(fehs) + 200] = 10.6  # past every track's end
    mass[-1], age[-2], feh[-3] = np.nan, np.nan, np.nan
    distance = rng.uniform(10.0, 5000.0, n)
    AV = rng.uniform(0.0, 1.0, n)
    return mass, age, feh, distance, AV


def _resid_at(grid, icol, x0, x1, target):
    """The plain Newton residual at numpy EEPs of every row: the column
    interpolated at (x0, x1, eep) minus the target, as numpy; the grid's EEP
    knots ride along as ``resid_at.eep_knots``."""
    import torch

    from isochrones_torch.ops.interp import interp_nd

    def resid_at(eep):
        e = torch.as_tensor(eep, dtype=target.dtype, device=target.device)
        pt = torch.stack([x0.expand_as(e), x1.expand_as(e), e], dim=-1)
        return (interp_nd(grid.values, grid.knots, pt, icols=(icol,), axis_maps=grid.axis_maps)[:, 0]
                - target).cpu().numpy()

    resid_at.eep_knots = grid.knots[-1].double().cpu().numpy()
    return resid_at


def plain_accurate(fm, mass, age, feh, resid_tol=0.02):
    """The plain accurate inversion on a track grid: ``(EEP after the
    resid_tol cut, final residual, the residual at given EEPs)``."""
    import torch

    from isochrones_torch.ops.eep import get_eep_newton, interp_eep

    eep, r = get_eep_newton(fm.model, interp_eep(age, feh, mass, *fm.eep_support, eep0=fm.eep0), age, feh, mass,
                            fm.i_age)
    return (torch.where(r.abs() < resid_tol, eep, torch.full_like(eep, float("nan"))), r,
            _resid_at(fm.model, fm.i_age, feh, mass, age))


def plain_newton(ng, seed, mass, age, feh, resid_tol=0.02):
    """The plain Newton step on an isochrone grid (``NewtonGrid``): ``(EEP
    after the resid_tol cut, final residual, the residual at given EEPs)``."""
    import torch

    from isochrones_torch.ops.eep import get_eep_newton

    eep, r = get_eep_newton(ng.grid, seed, mass, age, feh, ng.icol)
    return (torch.where(r.abs() < resid_tol, eep, torch.full_like(eep, float("nan"))), r,
            _resid_at(ng.grid, ng.icol, age, feh, mass))


def check_generate(name, got, ref, dtype, bc_edge=None):
    """Kernel F's ``(eeps, props, mags, mags0)`` against the plain version's:
    identical NaN patterns; the EEPs bitwise in float64 (``ATOL_EEP_F32`` in
    float32), every column to ``rtol`` + ``rtol`` of its finite scale.
    Returns the largest error over the columns, relative to their scale.

    ``bc_edge``: in float32, a boolean mask of the rows whose plain Teff,
    logg, [Fe/H] or AV lies on a BC grid's edge (``bc_edge_rows``); a row of
    magnitudes may be NaN in one version and finite in the other there, and
    only there, at most ``KNIFE_ROWS_F32`` of the rows."""
    rtol = RTOL_GEN_F64 if dtype == "float64" else RTOL_GEN_F32
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None and r is None:
            continue
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if i >= 2 and bc_edge is not None and dtype == "float32" and g.shape == r.shape:
            differ = (np.isnan(g) != np.isnan(r)).any(axis=1)
            if (differ & ~bc_edge).any() or differ.sum() > max(1, KNIFE_ROWS_F32 * len(r)):
                raise AssertionError(f"{name} output {i}: NaN pattern differs at {int(differ.sum())} rows, "
                                     f"{int((differ & ~bc_edge).sum())} of them off the BC grid's edges")
            g, r = g.copy(), r.copy()
            g[differ], r[differ] = np.nan, np.nan
        if g.shape != r.shape or not np.array_equal(np.isnan(g), np.isnan(r)):
            raise AssertionError(f"{name} output {i}: shape {g.shape} vs {r.shape} or NaN pattern differs "
                                 f"({int((np.isnan(g) != np.isnan(r)).sum())} values)")
        if i == 0:
            err = float(np.nanmax(np.abs(g - r))) if np.isfinite(r).any() else 0.0
            if not err <= (0.0 if dtype == "float64" else ATOL_EEP_F32):
                raise AssertionError(f"{name}: EEPs differ by {err}")
            continue
        g, r = g.reshape(len(g), -1), r.reshape(len(r), -1)
        for c in range(r.shape[1]):
            fin = np.isfinite(r[:, c])
            if not fin.any():
                continue
            scale = max(1.0, float(np.abs(r[fin, c]).max()))
            d = np.abs(g[fin, c] - r[fin, c])
            if not (d <= rtol * (np.abs(r[fin, c]) + scale)).all():
                raise AssertionError(f"{name} output {i} column {c}: max abs err {d.max()} (scale {scale})")
            worst = max(worst, float(d.max()) / scale)
    return worst


def bc_edge_rows(fm, mass, feh, eeps, AV, rtol=BC_EDGE_RTOL_F32):
    """Rows whose Teff, logg and [Fe/H] interpolated in float64 from the
    forward model's packed table at ``(feh, mass, eeps)``, or whose AV, lie
    within ``rtol`` (relative, at least absolute) of the first or last knot
    of their BC axis: a numpy boolean mask."""
    import torch

    from isochrones_torch.ops.interp import interp_nd

    g = fm.model_packed
    pts = torch.stack([x.double() for x in (feh, mass, eeps)], dim=-1)
    v = interp_nd(g.values.double(), tuple(k.double() for k in g.knots), pts, icols=(0, 1, 2), axis_maps=g.axis_maps)
    coords = [v[:, 0], v[:, 1], v[:, 2], AV.double()]
    edge = torch.zeros_like(coords[0], dtype=torch.bool)
    for x, k in zip(coords, fm.bc.knots):
        for knot in (float(k[0]), float(k[-1])):
            edge |= (x - knot).abs() <= rtol * max(1.0, abs(knot))
    return edge.cpu().numpy()


def _age_entries(fm, mass, age, feh):
    """Distinct entries of the +inf-padded age rows that the fast
    inversion's four bisections read for these points (the reads of
    ``searchsorted_rows``, step by step)."""
    import math

    import torch

    from isochrones_torch.ops.interp import find_cells_1d

    feh_knots, mass_knots, rows, _ = fm.eep_support
    n_feh, n_mass, n_eep = feh_knots.shape[0], mass_knots.shape[0], rows.shape[1]
    c0, _, oob0 = find_cells_1d(feh_knots, feh)
    c1, _, oob1 = find_cells_1d(mass_knots, mass)
    ok = ~(torch.isnan(age) | torch.isnan(feh) | torch.isnan(mass) | oob0 | oob1)
    c0, c1, x = c0[ok].clamp(0, n_feh - 1), c1[ok].clamp(0, n_mass - 1), age[ok]
    c0p, c1p = (c0 + 1).clamp(max=n_feh - 1), (c1 + 1).clamp(max=n_mass - 1)
    flat, last = rows.reshape(-1), rows.numel() - 1
    seen = []
    for ind in (c0 * n_mass + c1, c0 * n_mass + c1p, c0p * n_mass + c1, c0p * n_mass + c1p):
        lo, hi = torch.zeros_like(ind), torch.full_like(ind, n_eep)
        for _ in range(max(1, int(math.ceil(math.log2(max(n_eep, 2))))) + 1):
            mid = (lo + hi) // 2
            idx = ind * n_eep + mid
            seen.append(torch.unique(idx[idx <= last]))
            pred = (flat[idx.clamp(max=last)] < x) & (idx <= last)
            lo, hi = torch.where(pred, mid + 1, lo), torch.where(pred, hi, mid)
    return int(torch.unique(torch.cat(seen)).numel())


def generate_work(fm, mass, age, feh, AV, eeps, n_props, band_icols, all_As, invert=True):
    """``(bytes, flops, special functions)`` that the forward model needs on
    these points: the inputs read and the outputs written once; with the
    inversion each age-row entry its bisections read, once, and each corner
    track's length; each distinct model row the points' corners touch (its 4
    magnitude columns and the P asked for) and each distinct BC row (its
    band columns; the AV = 0 rows too with ``all_As``) once; per point ~50
    flops a bisection step of four rows and ~30 for the blend, ~70 flops of
    cell location, 8 corners x (6 + 2 (4 + P)), 16 corners x (8 + 2 per
    band) and 3 a band for the magnitudes (twice with ``all_As``); one log10
    (the distance modulus) and one log (the log mass axis)."""
    import math

    import torch

    from isochrones_torch.ops.interp import interp_nd

    N, e, nb = mass.numel(), mass.element_size(), len(band_icols)
    io = fm.index_order
    user = torch.stack([mass, eeps, feh], dim=-1)
    gp = torch.stack([user[:, io[0]], user[:, io[1]], user[:, io[2]]], dim=-1)
    v = interp_nd(fm.model.values, fm.model.knots, gp, icols=fm.model_icols, axis_maps=fm.model.axis_maps)
    rows = _touched_rows(fm.model, gp) * (4 + n_props)
    for av in (AV, torch.zeros_like(AV)) if all_As else (AV,):
        rows += _touched_rows(fm.bc, torch.stack([v[:, 0], v[:, 1], v[:, 2], av], dim=-1)) * nb
    n_out = N * (n_props + nb * (2 if all_As else 1))
    steps = max(1, int(math.ceil(math.log2(max(fm.eep_support[2].shape[1], 2))))) + 1
    if invert:
        nbytes = (5 * N + N + n_out + _age_entries(fm, mass, age, feh) + rows) * e + 8 * fm.eep_support[3].numel()
        inv_flops = 50 * steps + 30
    else:
        nbytes = (5 * N + N + n_out + rows) * e
        inv_flops = 0
    per_bc = 16 * (8 + 2 * nb) + 3 * nb
    flops = N * (inv_flops + 70 + 8 * (6 + 2 * (4 + n_props)) + per_bc * (2 if all_As else 1))
    return nbytes, flops, 2 * N


def phase_generate_kernel(dev, ic32, ic64):
    """Phase 20: kernel F (``csrc/generate.cu``) against ``generate_plain`` on
    the card at the MIST-scale grid, every instantiation, both dtypes; its
    device time beside its bound and its plain version's; the fast
    ``get_eep`` through the kernel beside phase 13's earlier figures.
    Returns the kernel's record."""
    import dataclasses as dc

    import torch

    from isochrones_torch.ops.eep import interp_eep
    from isochrones_torch.ops.generate import generate_plain
    from isochrones_torch.ops.generate_cuda import (
        eep_newton_cuda, generate_accurate_cuda, generate_cuda, get_eep_accurate_cuda, get_eep_cuda,
    )

    tr64, tr32 = ic64.track, ic32.track
    fm64, fm32 = tr64._forward_model, tr32._forward_model
    # the float32 tables in float64, for the float32 kernel's reference
    up = [grid_as(g, torch.float64) for g in (fm32.model, fm32.model_packed, fm32.bc)]
    sup = tuple(x.double() if x.is_floating_point() else x for x in fm32.eep_support)
    fm32up = dc.replace(fm32, model=up[0], model_packed=up[1], bc=up[2], eep_support=sup)
    icols = tr64.model.icols("all")
    bcols = tuple(tr64.bc.column_index[b] for b in tr64.bands)
    cols = generate_points(tr64, GEN_POINTS, seed=20)
    x64 = [torch.as_tensor(c, device=dev, dtype=torch.float64) for c in cols]
    x32 = [x.float() for x in x64]
    x32up = [x.double() for x in x32]
    errs = {}
    for all_As in (False, True):
        ref = generate_plain(fm64, *x64, icols, bcols, all_As=all_As)
        got = generate_cuda(fm64, *x64, icols, bcols, all_As=all_As)
        errs[f"f64 invert all_As={all_As}"] = check_generate(f"kernel F f64 all_As={all_As}", got, ref, "float64")
        got32 = generate_cuda(fm32, *x32, icols, bcols, all_As=all_As)
        e_ref = interp_eep(x32up[1], x32up[2], x32up[0], *fm32up.eep_support, eep0=fm32up.eep0)
        ref32 = generate_plain(fm32up, *x32up, icols, bcols, eeps=got32[0].double(), all_As=all_As)
        errs[f"f32 invert all_As={all_As}"] = check_generate(f"kernel F f32 all_As={all_As}", got32,
                                                            (e_ref,) + tuple(ref32[1:]), "float32")
        # the EEP-given form at the kernel's own EEPs is the inverting form, bitwise
        giv32 = generate_cuda(fm32, *x32, icols, bcols, eeps=got32[0], all_As=all_As)
        for a, b in zip(giv32[1:], got32[1:]):
            if a is not None and not torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)):
                raise AssertionError("kernel F: the EEP-given form differs from the inverting form")
    n_fin = int(torch.isfinite(ref[2]).all(dim=1).sum())
    # EEPs given past the grid on both sides, both dtypes; EEP-only; a column subset and few bands
    given = torch.as_tensor(np.random.default_rng(3).uniform(-20.0, 1750.0, GEN_POINTS), device=dev,
                            dtype=torch.float64)
    errs["f64 given"] = check_generate("kernel F f64 eeps given", generate_cuda(fm64, *x64, icols, bcols, eeps=given),
                                       generate_plain(fm64, *x64, icols, bcols, eeps=given), "float64")
    g32 = generate_cuda(fm32, *x32, icols, bcols, eeps=given.float())
    errs["f32 given"] = check_generate("kernel F f32 eeps given", g32, generate_plain(
        fm32up, *x32up, icols, bcols, eeps=given.float().double()), "float32")
    sub, few = tr64.model.icols(["radius", "age", "Teff"]), bcols[:3]
    errs["f64 subset"] = check_generate("kernel F f64 3 columns 3 bands", generate_cuda(fm64, *x64, sub, few),
                                        generate_plain(fm64, *x64, sub, few), "float64")
    errs["f64 P=0"] = check_generate("kernel F f64 no columns", generate_cuda(fm64, *x64, (), few, all_As=True),
                                     generate_plain(fm64, *x64, (), few, all_As=True), "float64")
    eo64 = get_eep_cuda(fm64, x64[0], x64[1], x64[2])
    if not torch.equal(eo64.nan_to_num(-1.0), interp_eep(x64[1], x64[2], x64[0], *fm64.eep_support,
                                                          eep0=fm64.eep0).nan_to_num(-1.0)):
        raise AssertionError("kernel F EEP-only f64 differs from interp_eep")
    if not torch.equal(get_eep_cuda(fm32, *x32[:3]).nan_to_num(-1.0), got32[0].nan_to_num(-1.0)):
        raise AssertionError("kernel F EEP-only f32 differs from the inverting form's EEPs")
    # the accurate forms, one launch each: the forward model, the EEP alone, the isochrone grid's Newton step
    acc = {}
    for dtn, fm, x, xup, fmup in (("float64", fm64, x64, x64, fm64), ("float32", fm32, x32, x32up, fm32up)):
        ref_e, ref_r, resid_at = plain_accurate(fm, *x[:3])
        got = generate_accurate_cuda(fm, *x, icols, bcols, all_As=True)
        acc[f"{dtn} generate"] = check_newton(f"accurate kernel F {dtn}", got[0].cpu(), ref_e.cpu(), ref_r.cpu(), dtn,
                                              resid_at)
        ref = generate_plain(fmup, *xup, icols, bcols, eeps=got[0].to(xup[0].dtype), all_As=True)
        errs[f"{dtn[:1]}{dtn[-2:]} accurate columns"] = check_generate(
            f"accurate kernel F {dtn} columns", got, (got[0],) + tuple(ref[1:]), dtn)
        if not torch.equal(get_eep_accurate_cuda(fm, *x[:3]).nan_to_num(-1.0), got[0].nan_to_num(-1.0)):
            raise AssertionError(f"kernel F accurate EEP-only {dtn} differs from the accurate forward form's EEPs")
        ng = (ic64 if dtn == "float64" else ic32)._newton_grid
        seed = torch.full_like(x[0], 300.0)
        ref_e, ref_r, resid_at = plain_newton(ng, seed, *x[:3])
        acc[f"{dtn} iso"] = check_newton(f"Newton form {dtn} (isochrone grid)", eep_newton_cuda(ng, seed, *x[:3]).cpu(),
                                         ref_e.cpu(), ref_r.cpu(), dtn, resid_at)
    torch.cuda.synchronize()
    print(f"[generate] kernel F vs generate_plain, {GEN_POINTS} points ({n_fin} with every magnitude finite), "
          f"{len(icols)} columns, {len(bcols)} bands: every form within tolerance (f64 EEPs bitwise, columns rtol "
          f"{RTOL_GEN_F64}; f32 EEPs {ATOL_EEP_F32}, columns rtol {RTOL_GEN_F32}); worst error / column scale "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
    print(f"[generate] accurate forms vs the plain Newton step (autograd slope), {GEN_POINTS} points: (max abs err, "
          f"finite, knife-edge rows) {json.dumps(acc)} (f64 atol {ATOL_EEP}, identical NaN patterns; f32 atol "
          f"{ATOL_NEWTON_F32}, NaN patterns identical off the knife edges)")

    # times in float32: the kernel, its plain version, its bound; then the fast get_eep
    ms = kernel_ms(lambda: generate_cuda(fm32, *x32, icols, bcols), "generate_kernel", reps=20)
    ms_as = kernel_ms(lambda: generate_cuda(fm32, *x32, icols, bcols, all_As=True), "generate_kernel", reps=10)
    plain_ms = cuda_ms(lambda: generate_plain(fm32, *x32, icols, bcols), reps=3, warmup=1)
    ms64 = kernel_ms(lambda: generate_cuda(fm64, *x64, icols, bcols), "generate_kernel", reps=5)
    b_work = generate_work(fm32, *x32[:3], x32[4], got32[0], len(icols), bcols, False)
    b = bound(*b_work, "float32")
    eep_ms = kernel_ms(lambda: get_eep_cuda(fm32, *x32[:3]), "generate_kernel", reps=20)
    # the accurate forms: the kernel, its plain version, the bound (the fast form's and the Newton step's work)
    acc_ms = kernel_ms(lambda: generate_accurate_cuda(fm32, *x32, icols, bcols), "generate_kernel", reps=10)
    acc_eep_ms = kernel_ms(lambda: get_eep_accurate_cuda(fm32, *x32[:3]), "generate_kernel", reps=10)
    ng32 = ic32._newton_grid
    seed32 = torch.full_like(x32[0], 300.0)
    iso_ms = kernel_ms(lambda: eep_newton_cuda(ng32, seed32, *x32[:3]), "generate_kernel", reps=10)
    acc_plain_ms = cuda_ms(lambda: generate_plain(fm32, *x32, icols, bcols, accurate=True), reps=1, warmup=1)
    nw = newton_work(fm32.model, fm32.i_age, got32[0], x32[1], x32[2], x32[0])
    b_acc = bound(b_work[0] + nw[0], b_work[1] + nw[1], b_work[2], "float32")
    iw = newton_work(ng32.grid, ng32.icol, seed32, *x32[:3])
    b_iso = bound(4 * 4 * GEN_POINTS + iw[0], iw[1], 0, "float32")
    m13, a13, f13 = (torch.as_tensor(c, device=dev, dtype=torch.float32)
                     for c in eep_points(tr64, EEP_FAST_POINTS, seed=21))
    timed = timed_call(lambda: tr32.get_eep_batch(m13, a13, f13), reps=20)
    only_kernel({"track fast": timed}, "generate_kernel", "get_eep_batch")
    wall, busy, launches, _ = timed
    print(f"[generate] time f32 {GEN_POINTS} points, {len(icols)} columns, {len(bcols)} bands: kernel {ms:.4f} ms "
          f"(all_As {ms_as:.4f} ms, f64 {ms64:.4f} ms), plain {plain_ms:.3f} ms; bound {b[0]:.5f} ms ({b[2]}), kernel "
          f"at {b[0] / ms:.4f} of it; EEP-only kernel {eep_ms:.4f} ms (first version: {GEN_EARLIER_MS} ms, EEP-only "
          f"{GEN_EARLIER_EEP_MS} ms)")
    print(f"[generate] time f32 accurate forms, {GEN_POINTS} points: forward model {acc_ms:.4f} ms (plain "
          f"{acc_plain_ms:.3f} ms; bound {b_acc[0]:.5f} ms ({b_acc[2]}), at {b_acc[0] / acc_ms:.4f} of it), EEP alone "
          f"{acc_eep_ms:.4f} ms, Newton step on the isochrone grid {iso_ms:.4f} ms (bound {b_iso[0]:.5f} ms)")
    print(f"[generate] fast get_eep_batch f32 at phase 13's {EEP_FAST_POINTS} points through the kernel: {wall:.3f} ms "
          f"wall-clock, device busy {_fmt(busy, '.4f')} ms, {_fmt(launches, '.1f')} kernel launches a call (plain "
          f"torch before: {EEP_EARLIER[0]} ms, {EEP_EARLIER[1]} launches)")
    return dict(max_abs_err=errs["f32 invert all_As=False"], ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], ms_all_As=ms_as, ms_f64=ms64, eep_only_ms=eep_ms, get_eep_wall_ms=wall,
                get_eep_launches=launches, accurate_ms=acc_ms, accurate_plain_ms=acc_plain_ms,
                accurate_bound_ms=b_acc[0], accurate_bound_by=b_acc[1], accurate_eep_only_ms=acc_eep_ms,
                newton_iso_ms=iso_ms, newton_iso_bound_ms=b_iso[0], accurate_max_abs_err=acc["float32 generate"][0],
                shape={"N": GEN_POINTS, "P": len(icols), "bands": len(bcols), "dtype": "float32"})


def phase_forward_model(dev, ic32):
    """Phase 21: the forward model and a population in float32 through the
    entry points a user calls, with the plain versions made to raise. Returns
    ``(kernel F's launches, the record of the run)``."""
    import torch

    import isochrones_torch.ops.eep as eep_mod
    import isochrones_torch.ops.generate as gen_mod
    from isochrones_torch.ops import generate_cuda as gc
    from isochrones_torch.populations import StarPopulation, deredden
    from isochrones_torch.priors import AVPrior, DistancePrior, GaussianPrior, SalpeterPrior

    track = ic32.track
    mass, age, feh, distance, AV = generate_points(track, GEN_POINTS, seed=22)
    dm, da, df_, dd, dav = (torch.as_tensor(c, device=dev, dtype=torch.float32)
                            for c in (mass, age, feh, distance, AV))
    pop = StarPopulation(track, imf=SalpeterPrior(bounds=(0.4, 2.5)), fB=0.4, gamma=0.3,
                         feh=GaussianPrior(-0.1, 0.15), distance=DistancePrior(max_distance=3000),
                         AV=AVPrior(bounds=[0, 1]))
    track.generate(mass[:1000], age[:1000], feh[:1000], distance=distance[:1000], AV=AV[:1000])  # warm-up
    pop.generate(1000, rng=1)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    saved = gen_mod.generate_plain, gen_mod.interp_eep, gen_mod.get_eep_newton, eep_mod.get_eep_newton
    gen_mod.generate_plain = gen_mod.interp_eep = gen_mod.get_eep_newton = eep_mod.get_eep_newton = refuse
    wrappers = (gc.generate_cuda, gc.generate_accurate_cuda, gc.get_eep_cuda, gc.get_eep_accurate_cuda,
                gc.eep_newton_cuda)
    for w in wrappers:
        w.launches = 0

    def one_launch(label, fn):
        """``fn()``, which must be one launch of kernel F"""
        before = sum(w.launches for w in wrappers)
        out = fn()
        if sum(w.launches for w in wrappers) - before != 1:
            raise AssertionError(f"{label}: {sum(w.launches for w in wrappers) - before} launches of kernel F, not 1")
        return out

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = track.generate(mass, age, feh, distance=distance, AV=AV)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eeps, values, mags = track.generate_device(dm, da, df_, distance=dd, AV=dav)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        binary = track.generate_binary(mass[:GEN_BINARIES], 0.6 * mass[:GEN_BINARIES], age[:GEN_BINARIES],
                                       feh[:GEN_BINARIES], distance=distance[:GEN_BINARIES],
                                       AV=AV[:GEN_BINARIES], all_As=True)
        bin_s = time.perf_counter() - t0
        iso_df = ic32.isochrone(9.0)
        k = GEN_MODEL_MAG
        t0 = time.perf_counter()
        mm_fast = one_launch("model_mag approx", lambda: ic32.model_mag(
            mass[:k], age[:k], feh[:k], distance=distance[:k], AV=AV[:k], approx=True))
        fast_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm_acc = one_launch("model_mag", lambda: ic32.model_mag(mass[:k], age[:k], feh[:k], distance=distance[:k],
                                                                 AV=AV[:k]))
        acc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gen_acc = one_launch("generate(accurate=True)", lambda: track.generate(
            mass[:GEN_ACCURATE_POINTS], age[:GEN_ACCURATE_POINTS], feh[:GEN_ACCURATE_POINTS],
            distance=distance[:GEN_ACCURATE_POINTS], AV=AV[:GEN_ACCURATE_POINTS], accurate=True))
        gen_acc_s = time.perf_counter() - t0
        one_launch("iso.get_eep(accurate=True)", lambda: ic32.get_eep(mass[:k], age[:k], feh[:k], accurate=True))
        one_launch("track.get_eep", lambda: track.get_eep(mass[:k], age[:k], feh[:k]))
        one_launch("track.get_eep(accurate=True)", lambda: track.get_eep(mass[:k], age[:k], feh[:k], accurate=True))
        t0 = time.perf_counter()
        popdf = pop.generate(GEN_POPULATION, rng=2, exact_N=True)
        pop_s = time.perf_counter() - t0
        # where the time goes: generate's upload, launch, read-back and frame;
        # a population round's host draws and its generate_binary
        t0 = time.perf_counter()
        up = [torch.as_tensor(c, device=dev, dtype=torch.float32) for c in (mass, age, feh, distance, AV)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = track._forward(*up, list(track.model.columns), track.bands)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        [x.cpu().numpy() for x in out[1:3]]
        t3 = time.perf_counter()
        M = int(np.ceil(GEN_POPULATION * 1.25)) + 16
        rng = np.random.default_rng(3)
        t4 = time.perf_counter()
        draws = [*pop.binary_distribution.sample(M, rng=rng), pop.sfh.sample_ages(M, rng=rng),
                 pop.feh.sample(M, rng=rng), pop.distance.sample(M, rng=rng), pop.AV.sample(M, rng=rng)]
        t5 = time.perf_counter()
        track.generate_binary(*draws[:4], distance=draws[4], AV=draws[5], all_As=True)
        t6 = time.perf_counter()
        breakdown = dict(upload_ms=1e3 * (t1 - t0), kernel_call_ms=1e3 * (t2 - t1), read_back_ms=1e3 * (t3 - t2),
                         frame_ms=1e3 * (host_s - (t3 - t0)), population_draws_ms=1e3 * (t5 - t4),
                         population_generate_binary_ms=1e3 * (t6 - t5))
        dered = deredden(popdf)
        old = track.generate_binary(popdf["initial_mass_0"], popdf["initial_mass_1"], popdf["requested_age_0"],
                                    popdf["initial_feh_0"], distance=popdf["distance_0"], AV=0.0, all_As=True)
        torch.cuda.synchronize()
    finally:
        gen_mod.generate_plain, gen_mod.interp_eep, gen_mod.get_eep_newton, eep_mod.get_eep_newton = saved
    counts = {w.__name__: w.launches for w in wrappers}
    if any(n <= 0 for n in counts.values()):
        raise AssertionError(f"the forward model did not launch every form of kernel F: {counts}")
    n_df = len(df["mass"])
    if n_df != GEN_POINTS or values.shape != (GEN_POINTS, len(track.model.columns)) or \
            mags.shape != (GEN_POINTS, len(track.bands)) or eeps.shape != (GEN_POINTS,):
        raise AssertionError(f"generate shapes: {n_df} rows, device {tuple(values.shape)} {tuple(mags.shape)}")
    if not np.array_equal(np.stack([df[f"{b}_mag"] for b in track.bands], axis=-1), mags.cpu().numpy(),
                          equal_nan=True):
        raise AssertionError("generate and generate_device differ")
    n_fin = int(np.isfinite(df["J_mag"]).sum())
    if not GEN_POINTS // 4 < n_fin < GEN_POINTS:
        raise AssertionError(f"generate: {n_fin} finite J magnitudes of {GEN_POINTS}")
    if not np.isfinite(iso_df["J_mag"]).all() or len(iso_df["J_mag"]) < 50:
        raise AssertionError(f"isochrone(9.0): {len(iso_df['J_mag'])} rows")
    if len(binary["J_mag"]) != GEN_BINARIES or not np.isfinite(binary["J_mag"]).sum() > GEN_BINARIES // 4:
        raise AssertionError("generate_binary: too few finite systems")
    both = np.isfinite(mm_fast).all(axis=1) & np.isfinite(mm_acc).all(axis=1)
    if not both.sum() > k // 4 or not np.abs(mm_fast[both] - mm_acc[both]).max() < 0.5:
        raise AssertionError(f"model_mag approx vs accurate: {both.sum()} finite")
    acc_j = np.asarray(gen_acc["J_mag"])
    if not np.array_equal(acc_j[:k], mm_acc[:, track.bands.index("J")], equal_nan=True) or \
            not GEN_ACCURATE_POINTS // 4 < int(np.isfinite(acc_j).sum()):
        raise AssertionError("generate(accurate=True) and model_mag differ, or too few finite rows")
    if len(popdf["mass_0"]) != GEN_POPULATION or any(np.isnan(popdf[f"{b}_mag"]).any() for b in track.bands):
        raise AssertionError(f"population: {len(popdf['mass_0'])} rows, NaN total magnitudes")
    # NaN as 0 (the reference test's fillna(0)), to 1e-5 of each value in
    # float32; the regeneration re-inverts the interpolated float32 initial
    # masses, so a star at its track's last valid EEP may fall off it: at
    # most 0.1% of the rows may differ
    off = np.zeros(GEN_POPULATION, dtype=bool)
    worst = 0.0
    for c in (c for c in dered if c in old):
        a, r = (np.nan_to_num(np.asarray(x, dtype=float)) for x in (dered[c], old[c]))
        d = np.abs(a - r) / np.maximum(1.0, np.abs(r))
        off |= d > 1e-5
        worst = max(worst, float(d[d <= 1e-5].max(initial=0.0)))
    flips = int(off.sum())
    if flips > GEN_POPULATION // 1000:
        raise AssertionError(f"deredden vs regeneration at AV = 0: {flips} rows differ")
    rec = dict(generate_s=host_s, generate_device_s=dev_s, generate_stars_per_s=GEN_POINTS / host_s,
               generate_device_stars_per_s=GEN_POINTS / dev_s, population_s=pop_s,
               population_stars_per_s=GEN_POPULATION / pop_s, generate_accurate_s=gen_acc_s,
               launches_by_wrapper=counts, **breakdown)
    print(f"[forward] f32, {GEN_POINTS} stars, {len(track.model.columns)} columns, {len(track.bands)} bands: "
          f"generate (host round trip) {host_s:.3f} s = {GEN_POINTS / host_s:.1f} stars/s, generate_device "
          f"{1e3 * dev_s:.3f} ms = {GEN_POINTS / dev_s:.1f} stars/s ({n_fin} with finite J); generate_binary "
          f"{GEN_BINARIES} systems {bin_s:.3f} s; isochrone(9.0) {len(iso_df['J_mag'])} rows; model_mag {k} stars "
          f"approx {fast_s:.3f} s, accurate {acc_s:.3f} s (one launch each); generate(accurate=True) "
          f"{GEN_ACCURATE_POINTS} stars {gen_acc_s:.3f} s (one launch)")
    print(f"[forward] StarPopulation (bench.py:425-450) generate({GEN_POPULATION}, exact_N=True): {pop_s:.3f} s = "
          f"{GEN_POPULATION / pop_s:.1f} stars/s, no NaN total magnitude; deredden vs regeneration at AV = 0 max "
          f"relative diff {worst:.2e} on all but {flips} rows; kernel F launches {json.dumps(counts)}, no plain "
          f"version run")
    print(f"[forward] where the time goes (ms): {json.dumps({k: round(v, 3) for k, v in breakdown.items()})}; one "
          f"population round is {M} systems, {2 * M} generated rows")
    return sum(counts.values()), rec


def phase_generate_entry_point(workdir):
    """Phase 22: ``python -m isochrones_torch.cli.generate_cmd`` as a subprocess."""
    import csv

    out = os.path.join(workdir, "cmd.csv")
    args = [str(GEN_CLI_STARS), "--models", "synthetic", "--seed", "0", "-o", out]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "isochrones_torch.cli.generate_cmd", *args],
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"generate_cmd CLI: exit {proc.returncode}, log:\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) != GEN_CLI_STARS + 1 or "J_mag" not in rows[0]:
        raise AssertionError(f"generate_cmd CLI output: {len(rows) - 1} rows, header {rows[0]}")
    j = rows[0].index("J_mag")
    if not all(r[j] and np.isfinite(float(r[j])) for r in rows[1:]):
        raise AssertionError("generate_cmd CLI output: a star without a J magnitude")
    print(f"[generate-cmd] python -m isochrones_torch.cli.generate_cmd {' '.join(args[:-1])} <csv>: exit 0, "
          f"{secs:.2f} s, {len(rows) - 1} rows, {len(rows[0]) - 1} columns")


def _mist_short():
    """MIST_SHORT as ``{([Fe/H], track mass): rows}``."""
    masses = np.asarray(MIST_TRACK_MASSES)
    return {(feh, float(masses[np.argmin(np.abs(masses - m))])): n for feh, m, n in MIST_SHORT}


def _write_mist_feh(root, feh):
    """One [Fe/H]'s isochrone file and track directory of phase 23's tree."""
    from isochrones_torch.grids.mist import MISTModelGrid
    from isochrones_torch.grids.mist_eep import max_eep
    from isochrones_torch.grids.mist_files import make_iso_tree, make_track_tree

    feh = float(feh)
    rows = {(feh, m): max_eep(m, feh) for m in MIST_TRACK_MASSES}
    rows.update({k: v for k, v in _mist_short().items() if k[0] == feh})
    make_track_tree(root, fehs=(feh,), masses=MIST_TRACK_MASSES, short=rows, n_eep=MISTModelGrid.n_eep)
    make_iso_tree(root, fehs=(feh,), ages=MIST_AGES, masses=MIST_ISO_MASSES, n_eep=MISTModelGrid.n_eep)
    return feh


def _write_mist_bc(root, system):
    from isochrones_torch.grids.mist_files import make_bc_tree

    make_bc_tree(root, **dict(MIST_BC, systems=(system,)))
    return system


def write_mist_tree(root):
    """Phase 23's MIST-format tree under ``root``, one [Fe/H] or BC system a
    task in a pool of fresh processes (no CUDA in them); returns the
    seconds."""
    import concurrent.futures
    import multiprocessing

    from isochrones_torch.grids.mist import MISTModelGrid

    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(_write_mist_bc, root, s) for s in MIST_BC["systems"]]
        jobs += [pool.submit(_write_mist_feh, root, f) for f in MISTModelGrid.fehs]
        for j in jobs:
            j.result()
    return time.perf_counter() - t0


def _card_bytes(*ics):
    """Bytes of the distinct tensors the interpolators hold on the card: the
    tables, their packed copies, the knots and the EEP support arrays."""
    import torch

    seen = {}

    def add(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            seen[t.data_ptr()] = max(seen.get(t.data_ptr(), 0), t.numel() * t.element_size())

    for ic in ics:
        for g in (ic.model, ic.bc, ic.model_packed, ic.model_packed6):
            if g is not None:
                add(g.values)
                for k in g.knots:
                    add(k)
        for x in ic.eep_support or ():
            add(x)
    return sum(seen.values())


def _host_tables(iso, track):
    return [iso.model.host_values, iso.bc.host_values, track.model.host_values,
            track.eep_support[2].cpu().numpy(), track.eep_support[3].cpu().numpy()]


def phase_mist(dev, workdir):
    """Phase 23: ``get_ichrone("mist")`` on files in MIST's format, the
    kernels on the grids read from them, and the default ``starfit``.
    Returns ``(star, tree, kernel F launches in the entry point's fits,
    record)``."""
    import torch

    import isochrones_torch.config as tconfig
    import isochrones_torch.isochrone as iso_mod
    from isochrones_torch import BinaryStarModel, get_ichrone
    from isochrones_torch.cli.starfit import main as starfit_main
    from isochrones_torch.ops import generate_cuda as gc
    from isochrones_torch.ops.eep import interp_eep
    from isochrones_torch.ops.generate import generate_plain
    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda
    from isochrones_torch.ops.tree_cuda import tree_lnlike_cuda
    from isochrones_torch.treemodel import StarModel

    root = os.path.join(workdir, "isochrones")
    write_s = write_mist_tree(root)
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"[mist] MIST-format tree (15 [Fe/H]s; isochrones at {len(MIST_AGES)} ages, EEPs to 1710; tracks of "
          f"{len(MIST_TRACK_MASSES)} masses, {len(MIST_SHORT)} cut short; BC {'+'.join(MIST_BC['systems'])}) written "
          f"in {write_s:.2f} s: {nbytes / 1e6:.1f} MB")
    saved_root = tconfig.ISOCHRONES
    tconfig.ISOCHRONES = root
    try:
        # ---- the builds: files (parse, completion, derivatives, densify, upload), then the caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ic64 = get_ichrone("mist", device=dev, dtype=torch.float64)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t0
        first = _host_tables(ic64, ic64.track)
        iso_mod._mist_cache.clear()
        t0 = time.perf_counter()
        ic64 = get_ichrone("mist", device=dev, dtype=torch.float64)
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(first, _host_tables(ic64, ic64.track))):
            if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
                raise AssertionError(f"the build from the caches differs from the build from the files (table {i})")
        t0 = time.perf_counter()
        ic32 = get_ichrone("mist", device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        tr64, tr32 = ic64.track, ic32.track
        b64, b32 = _card_bytes(ic64, tr64), _card_bytes(ic32, tr32)
        n_nan = int(np.isnan(ic64.model.host_values[..., 0]).sum())
        print(f"[mist] get_ichrone('mist') f64: {parse_s:.2f} s from the files, {cache_s:.2f} s from the caches "
              f"(tables bitwise equal); f32 {f32_s:.2f} s from the caches; on the card f64 {b64 / 1e6:.1f} MB, f32 "
              f"{b32 / 1e6:.1f} MB; iso grid {tuple(ic64.model.values.shape)} ({n_nan} NaN-padded rows), track grid "
              f"{tuple(tr64.model.values.shape)} ({len(tr64.model.columns)} columns), BC {tuple(ic64.bc.values.shape)}")

        # ---- the star kernel on the MIST-read isochrone grid
        obs = star_observations(ic64)
        bin32, bin64 = BinaryStarModel(ic32, **obs), BinaryStarModel(ic64, **obs)
        lk64, lk32 = bin64._star_likelihood(), bin32._star_likelihood()
        lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64),
                                     bc=grid_as(lk32.bc, torch.float64))
        star_err = {}
        for B in MIST_STAR_BATCHES:
            p64 = torch.as_tensor(star_points(ic64.model.knots, 2, B, seed=23, box=STAR_BOX), device=dev,
                                  dtype=torch.float64)
            p32 = p64.float()
            e64 = check_star(f"mist star kernel f64 B={B}", [x.cpu().numpy() for x in star_lnlike_cuda(p64, lk64)],
                             [x.cpu().numpy() for x in star_lnlike_fused_plain(p64, lk64)], RTOL_STAR_F64)
            e32 = check_star(f"mist star kernel f32 B={B}", [x.cpu().numpy() for x in star_lnlike_cuda(p32, lk32)],
                             [x.cpu().numpy() for x in star_lnlike_fused_plain(p32.double(), lk32up)],
                             RTOL_STAR_F32, ATOL_STAR_F32)
            star_err[B] = (e64, e32, int(torch.isfinite(star_lnlike_fused_plain(p64, lk64)[0]).sum()))
        star_ms = kernel_ms(lambda: star_lnlike_cuda(p32, lk32), "star_lnlike", reps=20)
        print(f"[mist] star kernel vs plain on the MIST-read isochrone grid (bench box with adversarial rows): "
              f"(f64 max_abs_err, f32 vs f64 max_abs_err, finite) "
              f"{json.dumps({b: [float(f'{e:.3e}') for e in v[:2]] + [v[2]] for b, v in star_err.items()})}; "
              f"f32 time at B={STAR_BATCH} {star_ms:.4f} ms")

        # ---- kernel F on the MIST-read track grid: fast, EEPs given, accurate; get_eep(accurate=True)
        fm64, fm32 = tr64._forward_model, tr32._forward_model
        up = [grid_as(g, torch.float64) for g in (fm32.model, fm32.model_packed, fm32.bc)]
        sup = tuple(x.double() if x.is_floating_point() else x for x in fm32.eep_support)
        fm32up = dataclasses.replace(fm32, model=up[0], model_packed=up[1], bc=up[2], eep_support=sup)
        icols = tr64.model.icols("all")
        bcols = tuple(tr64.bc.column_index[b] for b in tr64.bands)
        cols = generate_points(tr64, MIST_GEN_POINTS, seed=23)
        cols[1][:] = np.random.default_rng(24).uniform(5.5, 10.3, MIST_GEN_POINTS)
        x64 = [torch.as_tensor(c, device=dev, dtype=torch.float64) for c in cols]
        x32 = [x.float() for x in x64]
        x32up = [x.double() for x in x32]
        errs = {}
        ref = generate_plain(fm64, *x64, icols, bcols)
        errs["f64 fast"] = check_generate("mist kernel F f64", gc.generate_cuda(fm64, *x64, icols, bcols), ref,
                                          "float64")
        got32 = gc.generate_cuda(fm32, *x32, icols, bcols)
        e_ref = interp_eep(x32up[1], x32up[2], x32up[0], *fm32up.eep_support, eep0=fm32up.eep0)
        ref32 = generate_plain(fm32up, *x32up, icols, bcols, eeps=got32[0].double())
        errs["f32 fast"] = check_generate("mist kernel F f32", got32, (e_ref,) + tuple(ref32[1:]), "float32",
                                          bc_edge_rows(fm32up, x32up[0], x32up[2], got32[0], x32up[4]))
        given = torch.as_tensor(np.random.default_rng(25).uniform(-20.0, 1750.0, MIST_GEN_POINTS), device=dev,
                                dtype=torch.float64)
        errs["f64 given"] = check_generate("mist kernel F f64 eeps given",
                                           gc.generate_cuda(fm64, *x64, icols, bcols, eeps=given),
                                           generate_plain(fm64, *x64, icols, bcols, eeps=given), "float64")
        errs["f32 given"] = check_generate("mist kernel F f32 eeps given",
                                           gc.generate_cuda(fm32, *x32, icols, bcols, eeps=given.float()),
                                           generate_plain(fm32up, *x32up, icols, bcols, eeps=given.float().double()),
                                           "float32", bc_edge_rows(fm32up, x32up[0], x32up[2], given, x32up[4]))
        acc = {}
        for dtn, tr, fm, x, xup, fmup in (("float64", tr64, fm64, x64, x64, fm64),
                                          ("float32", tr32, fm32, x32, x32up, fm32up)):
            ref_e, ref_r, resid_at = plain_accurate(fm, *x[:3])
            got = gc.generate_accurate_cuda(fm, *x, icols, bcols)
            acc[f"{dtn} generate"] = check_newton(f"mist accurate kernel F {dtn}", got[0].cpu(), ref_e.cpu(),
                                                  ref_r.cpu(), dtn, resid_at)
            ref = generate_plain(fmup, *xup, icols, bcols, eeps=got[0].to(xup[0].dtype))
            errs[f"{dtn[:1]}{dtn[-2:]} accurate columns"] = check_generate(
                f"mist accurate kernel F {dtn} columns", got, (got[0],) + tuple(ref[1:]), dtn,
                bc_edge_rows(fmup, xup[0], xup[2], got[0], xup[4]))
            before = gc.get_eep_accurate_cuda.launches
            eep_acc = tr.get_eep_batch(*x[:3], accurate=True)
            if gc.get_eep_accurate_cuda.launches - before != 1:
                raise AssertionError("track.get_eep_batch(accurate=True) is not one launch of kernel F")
            acc[f"{dtn} get_eep"] = check_newton(f"mist track.get_eep(accurate=True) {dtn}", eep_acc.cpu(),
                                                 ref_e.cpu(), ref_r.cpu(), dtn, resid_at)
            ic = ic64 if dtn == "float64" else ic32
            ref_e, ref_r, resid_at = plain_newton(ic._newton_grid, torch.full_like(x[0], 300.0), *x[:3])
            acc[f"{dtn} iso get_eep"] = check_newton(f"mist iso.get_eep(accurate=True) {dtn}",
                                                     ic.get_eep_batch(*x[:3], accurate=True).cpu(), ref_e.cpu(),
                                                     ref_r.cpu(), dtn, resid_at)
        gen_ms = kernel_ms(lambda: gc.generate_cuda(fm32, *x32, icols, bcols), "generate_kernel", reps=10)
        print(f"[mist] kernel F vs generate_plain on the MIST-read track grid, {MIST_GEN_POINTS} points, "
              f"{len(icols)} columns (interpolated among them), {len(bcols)} bands: worst error / column scale "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; accurate forms and get_eep "
              f"(accurate=True) vs the plain Newton step (max abs err, finite, knife-edge rows) {json.dumps(acc)}; "
              f"f32 fast form {gen_ms:.4f} ms")

        # ---- isochrone on the MIST-read isochrone grid: the card against the CPU, float64
        cpu64 = get_ichrone("mist", device="cpu", dtype=torch.float64)
        iso_rows, iso_err = 0, 0.0
        for age, feh in ((9.0, 0.0), (7.0, -1.5), (10.0, -0.25), (9.6, 0.1)):
            got, want = ic64.isochrone(age, feh=feh), cpu64.isochrone(age, feh=feh)
            if got.columns != want.columns or len(got["eep"]) != len(want["eep"]) or len(got["eep"]) < 100:
                raise AssertionError(f"isochrone({age}, {feh}): {len(got['eep'])} rows on the card, "
                                     f"{len(want['eep'])} on the CPU")
            for c in want.columns:
                iso_err = max(iso_err, check_eep(f"isochrone({age}, {feh}) {c}", got[c], want[c], atol=1e-9 * max(
                    1.0, float(np.abs(want[c]).max())))[0])
            iso_rows += len(got["eep"])
        del cpu64
        print(f"[mist] iso.isochrone at 4 (age, [Fe/H]) on the card vs the CPU, f64: {iso_rows} rows, max abs err "
              f"{iso_err:.3e} (1e-9 of each column's scale)")

        # ---- the default starfit: no --models, flat binary and tree folders from this grid
        flat_obs = star_observations(ic64, STAR_TRUTH, bands=("J", "H", "K"))
        flat_text = FLAT_INI.format(Teff=flat_obs["Teff"][0], logg=flat_obs["logg"][0], J=flat_obs["J"][0],
                                    H=flat_obs["H"][0], K=flat_obs["K"][0])
        flat = write_ini(os.path.join(workdir, "mist_flat"), flat_text)
        tree = write_tree_ini(os.path.join(workdir, "mist_tree"), ic64, TREE_TRUTH)
        common = ["--no_plots", "--n_live_points", str(CLI_LIVE), "--seed", "0"]
        wrappers = (gc.generate_cuda, gc.generate_accurate_cuda, gc.get_eep_cuda, gc.get_eep_accurate_cuda,
                    gc.eep_newton_cuda)
        star_lnlike_cuda.launches = tree_lnlike_cuda.launches = 0
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        rc_flat = starfit_main(common + ["--binary", flat])
        t_flat = time.perf_counter() - t0
        rc_tree = starfit_main(common + ["--tree", tree])
        t_tree = time.perf_counter() - t0 - t_flat
        torch.cuda.synchronize()
        n_star, n_tree = star_lnlike_cuda.launches, tree_lnlike_cuda.launches
        n_gen = sum(w.launches for w in wrappers)
        if rc_flat != 0 or rc_tree != 0:
            raise AssertionError(f"default starfit exit codes {rc_flat}, {rc_tree}")
        if n_star <= 0 or n_tree <= 0:
            raise AssertionError(f"default starfit launches: star {n_star}, tree {n_tree}")
        m_flat = BinaryStarModel.load_hdf(os.path.join(flat, "mist_starmodel_binary.h5"))
        m_tree = StarModel.load_hdf(os.path.join(tree, "mist_starmodel_single.h5"))
        fit_rec = {}
        for label, folder, m, dist in (("flat", flat, m_flat, STAR_TRUTH[4]), ("tree", tree, m_tree, TREE_TRUTH[5])):
            if m.ic.grid_type is None or m.ic.model.values.shape != ic64.model.values.shape:
                raise AssertionError(f"{label}: the results file did not reload onto the MIST grid")
            log = os.path.join(folder, "starfit.log")
            if not os.path.exists(log) or "starfit successful" not in open(log).read():
                raise AssertionError(f"{log} does not report a successful fit")
            d_lo, d_hi = np.quantile(m.samples["distance" if label == "flat" else "distance_0"], [0.025, 0.975])
            if not np.isfinite(m.evidence[0]) or not d_lo <= dist <= d_hi:
                raise AssertionError(f"{label}: evidence {m.evidence}, distance 95% interval ({d_lo}, {d_hi}) "
                                     f"against {dist}")
            fit_rec[label] = dict(logz=float(m.evidence[0]), distance_95=[float(d_lo), float(d_hi)])
        print(f"[mist] default starfit (no --models, {CLI_LIVE} live points, float64): --binary exit {rc_flat}, "
              f"{t_flat:.2f} s, logz {fit_rec['flat']['logz']:.3f}, distance 95% {fit_rec['flat']['distance_95']}, "
              f"star kernel launches {n_star}; --tree exit {rc_tree}, {t_tree:.2f} s, logz "
              f"{fit_rec['tree']['logz']:.3f}, distance 95% {fit_rec['tree']['distance_95']}, tree kernel launches "
              f"{n_tree}; kernel F launches {n_gen}; both results files reloaded onto the MIST grid")
        rec = dict(write_s=write_s, build_files_s=parse_s, build_caches_s=cache_s, build_f32_s=f32_s,
                   card_bytes_f64=b64, card_bytes_f32=b32, star_ms=star_ms, generate_ms=gen_ms,
                   starfit_flat_s=t_flat, starfit_tree_s=t_tree)
        return n_star, n_tree, n_gen, rec
    finally:
        tconfig.ISOCHRONES = saved_root
        iso_mod._mist_cache.clear()



def gaia_provider(G, BP, RP, parallax):
    """An injected ``query.Gaia.table_provider``: three sources near the query
    position (0.4, 1.2 and 2.5 arcsec to the north), the closest at ``G``,
    ``BP``, ``RP`` and ``parallax``, the second brighter and failing the
    quality cuts (RPlx 4), the third fainter and farther out."""
    def provider(ra, dec, radius, name):
        return {"_RAJ2000": np.full(3, ra), "_DEJ2000": dec + np.array([0.4, 1.2, 2.5]) / 3600,
                "Gmag": np.array([G, G - 1.0, G + 1.5]), "e_Gmag": np.array([0.002, 0.002, 0.003]),
                "BPmag": np.array([BP, BP - 1.0, BP + 1.5]), "e_BPmag": np.array([0.003, 0.003, 0.004]),
                "RPmag": np.array([RP, RP - 1.0, RP + 1.5]), "e_RPmag": np.array([0.003, 0.003, 0.004]),
                "Plx": np.array([parallax, 3.0, 1.0]), "e_Plx": np.array([0.05, 0.1, 0.2]),
                "RPlx": np.array([100.0, 4.0, 20.0]), "RFG": np.full(3, 100.0), "RFRP": np.full(3, 50.0),
                "RFBP": np.full(3, 50.0), "Nper": np.full(3, 12), "chi2AL": np.full(3, 100.0),
                "NgAL": np.full(3, 105), "Source": np.array([1, 2, 3])}
    return provider


def phase_results_and_summary(dev, workdir, smi, fitted=None):
    """Phase 27: ``starfit --gaia --write_ini`` without ``--no_plots`` on
    phase 23's MIST-format grids (single, then binary), then the summarize
    and select CLIs on the folder. Returns the phase's record (seconds of
    each step, launches of kernels A and B in the two fits). ``fitted``
    (a dict) receives each results file's samples as the fitted model held
    them when it saved them, by the file's absolute path."""
    import contextlib
    import csv
    import io

    import torch

    import isochrones_torch.config as tconfig
    import isochrones_torch.isochrone as iso_mod
    from isochrones_torch import BasicStarModel, get_ichrone
    from isochrones_torch.cli.select import main as select_main
    from isochrones_torch.cli.starfit import main as starfit_main
    from isochrones_torch.cli.summarize import main as summarize_main
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda
    from isochrones_torch.query import Gaia

    try:
        import matplotlib  # noqa: F401

        have_mpl = True
    except ImportError:
        have_mpl = False
    bands = ["BP", "G", "H", "J", "K", "RP"]  # the sorted bands starfit asks of the grid after the query
    saved_root, saved_provider = tconfig.ISOCHRONES, Gaia.table_provider
    tconfig.ISOCHRONES = os.path.join(workdir, "isochrones")
    secs = {}
    try:
        t0 = time.perf_counter()
        ic = get_ichrone("mist", bands=bands, device=dev, dtype=torch.float64)
        eep, age, feh, dist, av = GAIA_TRUTH
        _, _, _, mags = ic.interp_mag([eep, age, feh, dist, av], bands)
        mag = {b: float(m) for b, m in zip(bands, np.asarray(mags, dtype=float))}
        if not all(np.isfinite(v) for v in mag.values()):
            raise AssertionError(f"the truth's magnitudes are not finite: {mag}")
        folder = write_ini(os.path.join(workdir, "gaia_star"), GAIA_INI.format(**mag))
        Gaia.table_provider = staticmethod(gaia_provider(mag["G"], mag["BP"], mag["RP"], 1000.0 / dist))
        secs["setup"] = time.perf_counter() - t0

        # ---- the Gaia-conditioned fits, plots drawn where matplotlib imports
        common = ["--gaia", "--write_ini", "--models", "mist", "--n_live_points", str(CLI_LIVE), "--seed", "0",
                  "--device", str(dev)]
        star_lnlike_cuda.launches = interp_nd_cuda.launches = 0
        rcs = {}
        save_hdf = BasicStarModel.save_hdf

        def keep(self, filename, *args, **kwargs):
            if fitted is not None:
                fitted[os.path.abspath(filename)] = {c: np.array(v) for c, v in self.samples.items()}
            return save_hdf(self, filename, *args, **kwargs)

        BasicStarModel.save_hdf = keep
        try:
            for mult, flag in (("single", []), ("binary", ["--binary"])):
                t0 = time.perf_counter()
                rcs[mult] = starfit_main(common + flag + [folder])
                torch.cuda.synchronize()
                secs[f"starfit_{mult}"] = time.perf_counter() - t0
        finally:
            BasicStarModel.save_hdf = save_hdf
        n_a, n_b = star_lnlike_cuda.launches, interp_nd_cuda.launches
        if n_a <= 0 or n_b <= 0:
            raise AssertionError(f"the Gaia-conditioned fits launched kernel A {n_a} and kernel B {n_b} times")
        with open(os.path.join(folder, "star.ini")) as f:
            ini = f.read()
        if f"parallax = {1000.0 / dist}, 0.05" not in ini or "[gaia]" not in ini:
            raise AssertionError(f"star.ini did not gain the Gaia parallax and section:\n{ini}")
        with open(os.path.join(folder, "starfit.log")) as f:
            log = f.read()
        fits = {}
        for mult in ("single", "binary"):
            m = BasicStarModel.load_hdf(os.path.join(folder, f"mist_starmodel_{mult}.h5"), device=dev)
            want = {"G": mag["G"], "BP": mag["BP"], "RP": mag["RP"], "parallax": 1000.0 / dist}
            if any(k not in m.kwargs or m.kwargs[k][0] != v for k, v in want.items()):
                raise AssertionError(f"{mult}: the fit's observables {m.kwargs} lack the Gaia values {want}")
            d_lo, d_hi = np.quantile(m.samples["distance"], [0.025, 0.975])
            if not np.isfinite(m.evidence[0]) or not d_lo <= dist <= d_hi:
                raise AssertionError(f"{mult}: evidence {m.evidence}, distance 95% interval ({d_lo}, {d_hi}) "
                                     f"against {dist}")
            pngs = [os.path.join(folder, f"mist_corner_{mult}_{x}.png") for x in ("physical", "observed")]
            if have_mpl:
                ok = rcs[mult] == 0 and all(os.path.exists(p) for p in pngs)
            else:  # the JAX package's behaviour without matplotlib: the fit kept, the folder a failure
                ok = (rcs[mult] == 1 and f"{mult} starfit failed" in log and "matplotlib" in log
                      and not any(os.path.exists(p) for p in pngs))
            if not ok:
                raise AssertionError(f"{mult}: exit {rcs[mult]}, matplotlib {'present' if have_mpl else 'absent'}, "
                                     f"PNGs {[os.path.exists(p) for p in pngs]}; log:\n{log[-3000:]}")
            fits[mult] = dict(logz=float(m.evidence[0]), distance_95=[float(d_lo), float(d_hi)])
        case = ("matplotlib present: both PNGs drawn for each fit" if have_mpl else
                "no matplotlib: results files written, both fits logged as failures, no PNG")
        print(f"[gaia] starfit --gaia --write_ini --models mist ({CLI_LIVE} live points, float64): single exit "
              f"{rcs['single']} {secs['starfit_single']:.2f} s, logz {fits['single']['logz']:.3f}, distance 95% "
              f"{fits['single']['distance_95']}; binary exit {rcs['binary']} {secs['starfit_binary']:.2f} s, logz "
              f"{fits['binary']['logz']:.3f}, distance 95% {fits['binary']['distance_95']}; star.ini gained the "
              f"parallax and [gaia]; the plots: {case}")

        # ---- the summarize and select CLIs on the folder
        out = io.StringIO()
        csv_path = os.path.join(workdir, "gaia_summary.csv")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_sum = summarize_main(["gaia_star", "--rootdir", workdir, "--modelname", "mist_starmodel_single",
                                     "-O", csv_path, "--device", str(dev)])
        secs["summarize_csv"] = time.perf_counter() - t0
        with open(csv_path, newline="") as f:
            header, *rows = list(csv.reader(f))
        values = np.array([[float(x) if x else np.nan for x in r[1:]] for r in rows])
        if rc_sum != 0 or len(rows) != 1 or rows[0][0] != "gaia_star" or values.shape[1] < 5 \
                or not np.isfinite(values).all():
            raise AssertionError(f"summarize: exit {rc_sum}, header {header}, rows {rows}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc_txt = [summarize_main(["gaia_star", "--rootdir", workdir, "--models", "mist", "--results-txt"] + f)
                      for f in ([], ["--binary"])]
        secs["summarize_results_txt"] = time.perf_counter() - t0
        txt = {}
        for mult in ("single", "binary"):
            with open(os.path.join(folder, f"mist_{mult}_results.txt")) as f:
                txt[mult] = f.read().splitlines()[1].split()
        if rc_txt != [0, 0] or any(len(v) != 24 for v in txt.values()):
            raise AssertionError(f"summarize --results-txt: exits {rc_txt}, rows {txt}")
        sel = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sel):
            rc_sel = select_main([folder, "--models", "mist", "--device", str(dev)])
        secs["select"] = time.perf_counter() - t0
        lines = [ln for ln in sel.getvalue().splitlines() if "delta_lnZ" in ln]
        if rc_sel != 0 or sorted(ln.split()[1] for ln in lines) != ["binary", "single"]:
            raise AssertionError(f"select: exit {rc_sel}, output {sel.getvalue()!r}")
        print(f"[gaia] starfit-summarize: {len(header) - 1} quantile columns, all finite "
              f"({secs['summarize_csv']:.2f} s); --results-txt single and binary ({secs['summarize_results_txt']:.2f} "
              f"s): mass {txt['single'][0]} / {txt['binary'][0]}; starmodel-select ({secs['select']:.2f} s): "
              + "; ".join(ln.split(": ", 1)[1] for ln in lines))
        print(f"[gaia] phase 27 on {smi}: seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}, "
              f"kernel A launches {n_a}, kernel B launches {n_b}")
        return dict(seconds=secs, launches_a=n_a, launches_b=n_b, matplotlib=have_mpl, fits=fits)
    finally:
        tconfig.ISOCHRONES = saved_root
        Gaia.table_provider = saved_provider
        iso_mod._mist_cache.clear()


def plain_star_f64(lks, dtype):
    """A stand-in for ``star_lnlike_fused`` on the likelihoods ``lks``: the
    plain version in float64 on each one's tables as they are (float32
    values upcast), its outputs in ``dtype``; the float32 kernel's oracle."""
    import torch

    from isochrones_torch.ops.star import star_lnlike_fused_plain

    def upcast(lk):
        return dataclasses.replace(lk, pack6=grid_as(lk.pack6, torch.float64), bc=grid_as(lk.bc, torch.float64))

    up = {id(lk): (lk, upcast(lk)) for lk in lks}

    def fused(pars, lk):
        if id(lk) not in up:  # a likelihood built after the stand-in: kept alive beside its copy
            up[id(lk)] = (lk, upcast(lk))
        return tuple(x.to(dtype) for x in star_lnlike_fused_plain(pars.double(), up[id(lk)][1]))

    return fused


def isotrack_reference(model, x):
    """The reference of ``IsoTrackModel.lnpost_batch`` at the tensor ``x``:
    in float64 the composed posterior (``lnlike_batch`` and
    ``lnprior_batch``, both plain torch, merged as the JAX model merges
    them); in float32 the model's fused posterior with both likelihoods the
    plain version in float64 on the float32 tables (``plain_star_f64``), so
    that only the kernel differs."""
    import torch

    import isochrones_torch.starmodel as star_mod

    if x.dtype == torch.float64:
        lnp, ll = model.lnprior_batch(x), model.lnlike_batch(x)
        ll = torch.where(torch.isnan(ll), float("-inf"), ll)
        return torch.where(torch.isfinite(lnp), lnp + ll, float("-inf"))
    fused = star_mod.star_lnlike_fused
    star_mod.star_lnlike_fused = plain_star_f64([], x.dtype)
    try:
        return model._build_lnpost_fused()(x)
    finally:
        star_mod.star_lnlike_fused = fused


def phase_isotrack(dev, workdir):
    """Phase 24: ``IsoTrackModel`` on the grids phase 23 wrote. Returns
    ``(launches in the two fits, record)``."""
    import torch

    import isochrones_torch.config as tconfig
    import isochrones_torch.isochrone as iso_mod
    import isochrones_torch.starmodel as star_mod
    from isochrones_torch import IsoTrackModel, SingleStarModel, get_ichrone
    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda

    saved_root = tconfig.ISOCHRONES
    tconfig.ISOCHRONES = os.path.join(workdir, "isochrones")
    try:
        t0 = time.perf_counter()
        grids = {dt: (get_ichrone("mist", device=dev, dtype=dt), get_ichrone("mist", tracks=True, device=dev, dtype=dt))
                 for dt in (torch.float64, torch.float32)}
        torch.cuda.synchronize()
        iso64, track64 = grids[torch.float64]
        iso32, track32 = grids[torch.float32]
        obs = isotrack_observations(iso64, ISOTRACK_TRUTH)
        m64, m32 = IsoTrackModel(iso64, track64, **obs), IsoTrackModel(iso32, track32, **obs)
        print(f"[isotrack] MIST grids f64 + f32 from the caches in {time.perf_counter() - t0:.2f} s: iso "
              f"{tuple(iso64.model.values.shape)}, track {tuple(track64.model.values.shape)}; params "
              f"{m32.param_names}, bounds {json.dumps({p: [float(x) for x in m32.bounds(p)] for p in m32.param_names})}"
              f"; observations {json.dumps({k: [round(float(v), 5), float(u)] for k, (v, u) in obs.items()})}")

        # ---- the star kernel on the track grid against its plain version
        lk64, lk32 = m64._star_likelihoods()[1], m32._star_likelihoods()[1]
        pts = isotrack_points(m64, STAR_BATCH, seed=24)
        track_cols = list(m64._TRACK_COLUMNS)
        t64 = torch.as_tensor(pts[:, track_cols], device=dev, dtype=torch.float64)
        e_t64 = check_star("track-grid star kernel f64", [x.cpu().numpy() for x in star_lnlike_cuda(t64, lk64)],
                           [x.cpu().numpy() for x in star_lnlike_fused_plain(t64, lk64)], RTOL_STAR_F64)
        t32 = t64.float()
        e_t32 = check_star("track-grid star kernel f32", [x.cpu().numpy() for x in star_lnlike_cuda(t32, lk32)],
                           [x.cpu().numpy() for x in plain_star_f64([lk32], torch.float64)(t32, lk32)],
                           RTOL_STAR_F32, ATOL_STAR_F32)
        n_fin = int(torch.isfinite(star_lnlike_fused_plain(t64, lk64)[0]).sum())
        print(f"[isotrack] star kernel on the track grid (index order {lk64.index_order}, axis kinds "
              f"{[None if a is None else a[0] for a in lk64.pack6.axis_maps]}) vs plain, B={STAR_BATCH}: f64 "
              f"max_abs_err {e_t64:.3e} (rtol {RTOL_STAR_F64}), f32 vs f64 {e_t32:.3e} (rtol {RTOL_STAR_F32} atol "
              f"{ATOL_STAR_F32}); {n_fin} ll finite")

        # ---- lnpost_batch: two launches against the composed plain path; a
        # prior of a subclass's own keeps the two launches and adds that prior
        class OwnPrior(IsoTrackModel):
            def _build_lnprior_batch(self):
                return super()._build_lnprior_batch()

        own64 = OwnPrior(iso64, track64, **obs)
        composed_lnlike = star_mod.star_lnlike

        def no_composed(*a, **k):
            raise AssertionError("the fused posterior called the composed likelihood")

        errs, calls = {}, {}
        for B in ISOTRACK_BATCHES:
            p = isotrack_points(m64, B, seed=B)
            p64 = torch.as_tensor(p, device=dev, dtype=torch.float64)
            p32 = p64.float()
            ref64 = isotrack_reference(m64, p64).cpu().numpy()
            ref32 = isotrack_reference(m32, p32).cpu().numpy()
            star_mod.star_lnlike = no_composed
            try:
                got = {}
                for label, m, x in (("f64", m64, p64), ("f32", m32, p32), ("f64 own prior", own64, p64)):
                    before = star_lnlike_cuda.launches
                    got[label] = m.lnpost_batch(x).cpu().numpy()
                    calls[(B, label)] = star_lnlike_cuda.launches - before
            finally:
                star_mod.star_lnlike = composed_lnlike
            e64 = check_star(f"isotrack lnpost_batch f64 B={B}", [got["f64"]], [ref64], RTOL_ISOTRACK_F64)
            e32 = check_star(f"isotrack lnpost_batch f32 B={B}", [got["f32"]], [ref32], RTOL_STAR_F32,
                             ATOL_STAR_F32)
            check_star(f"isotrack lnpost_batch f64, a subclass's prior, B={B}", [got["f64 own prior"]], [ref64],
                       RTOL_ISOTRACK_F64)
            errs[B] = (e64, e32, int(np.isfinite(ref64).sum()), int(np.isnan(p).any(axis=1).sum()))
        if any(n != 2 for n in calls.values()):
            raise AssertionError(f"IsoTrackModel.lnpost_batch is not two star-kernel launches: {calls}")
        print(f"[isotrack] lnpost_batch vs the composed plain path (f64, rtol {RTOL_ISOTRACK_F64}; also with a "
              f"subclass's own prior) and vs the plain likelihood on the same float32 values (f32, rtol "
              f"{RTOL_STAR_F32} atol {ATOL_STAR_F32}): (f64 max_abs_err, f32 max_abs_err, finite, NaN rows) "
              f"{json.dumps({b: [float(f'{e:.3e}') for e in v[:2]] + list(v[2:]) for b, v in errs.items()})}; "
              f"star-kernel launches a call {json.dumps({f'{b} {d}': n for (b, d), n in calls.items()})}")

        # ---- time of one call, float32
        timed, ms = {}, {}
        for B in ISOTRACK_BATCHES:
            x = torch.as_tensor(isotrack_points(m64, B, seed=B + 1), device=dev, dtype=torch.float32)
            timed[B] = timed_call(lambda: m32.lnpost_batch(x), reps=20 if B > 1024 else 50)
            ms[B] = kernel_ms(lambda: m32.lnpost_batch(x), "star_lnlike", reps=20)
        for B, (wall, busy, launches, _) in timed.items():
            idle = None if busy is None else 1.0 - busy / wall
            print(f"[isotrack] time f32 lnpost_batch B={B}: {wall:.3f} ms per call, device busy {_fmt(busy, '.4f')} "
                  f"ms, idle share {_fmt(idle, '.3f')}, {_fmt(launches, '.1f')} device kernels under the profiler; "
                  f"the two star-kernel launches {ms[B]:.4f} ms of device time")

        # ---- each launch alone, float32, at 131072 points: on lnpost_batch's
        # points (the timed call's) and on bench-box stars (phase 6's box for
        # one component; on the tracks the same stars, their mass from the
        # isochrones), each beside its bound
        lk_i32, lk_t32 = m32._star_likelihoods()
        x_lnpost = torch.as_tensor(isotrack_points(m64, STAR_BATCH, seed=STAR_BATCH + 1), device=dev,
                                   dtype=torch.float32)
        box = star_points(iso64.model.knots, 1, STAR_BATCH, seed=2424, box=STAR_BOX[1:])
        mass = iso64.interp_value([box[:, 0], box[:, 1], box[:, 2]], ["initial_mass"])[:, 0]
        x_box = torch.as_tensor(np.stack([box[:, 0], mass, box[:, 1], box[:, 2], box[:, 3], box[:, 4]], axis=-1),
                                device=dev, dtype=torch.float32)
        launch = {}
        for pts_name, x in (("lnpost points", x_lnpost), ("bench box", x_box)):
            for grid, lk, cols in (("iso", lk_i32, m32._ISO_COLUMNS), ("track", lk_t32, m32._TRACK_COLUMNS)):
                xc = x[:, list(cols)].contiguous()
                k_ms = kernel_ms(lambda: star_lnlike_cuda(xc, lk), "star_lnlike", reps=50)
                b_ms, b_by, b_what = bound(*star_work(xc, lk), "float32")
                n_fin = int(torch.isfinite(star_lnlike_cuda(xc, lk)[0]).sum())
                launch[f"{grid}, {pts_name}"] = dict(ms=k_ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / k_ms,
                                                     ll_finite=n_fin)
                print(f"[isotrack] time f32 {grid} launch alone, B={STAR_BATCH}, {pts_name}: {k_ms:.4f} ms, bound "
                      f"{b_ms:.5f} ms ({b_what}), kernel at {b_ms / k_ms:.3f} of it; {n_fin} ll finite")

        # ---- the fits on the card (the slice's main path): nested, then MCMC
        star_lnlike_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m32.fit(**ISOTRACK_NESTED)
        torch.cuda.synchronize()
        nest_s = time.perf_counter() - t0
        n_nested = star_lnlike_cuda.launches
        d_lo, d_hi = np.quantile(m32.samples["distance"], [0.025, 0.975])
        if not np.isfinite(res.logz) or res.truncated or n_nested <= 0 or not d_lo <= ISOTRACK_TRUTH[3] <= d_hi:
            raise AssertionError(f"isotrack nested fit: logz {res.logz}, truncated {res.truncated}, launches "
                                 f"{n_nested}, distance 95% ({d_lo}, {d_hi})")
        med = {k: round(float(np.median(v)), 4) for k, v in m32.samples.items() if k != "lnprob"}
        mc = IsoTrackModel(iso32, track32, use_emcee=True, **obs)
        star_lnlike_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = mc.fit(**ISOTRACK_MCMC)
        torch.cuda.synchronize()
        mcmc_s = time.perf_counter() - t0
        n_mcmc = star_lnlike_cuda.launches
        acc = float(mc.sampler.n_accept.sum().item()) / (ISOTRACK_MCMC["nwalkers"] * ISOTRACK_MCMC["niter"])
        if not np.isfinite(samples["lnprob"]).all() or n_mcmc <= 0 or not acc > 0:
            raise AssertionError(f"isotrack MCMC fit: launches {n_mcmc}, acceptance {acc}")
        try:
            m32.derived_samples
            raise AssertionError("IsoTrackModel.derived_samples did not raise TypeError (the reference does)")
        except TypeError:
            pass
        print(f"[isotrack] fit() nested {json.dumps(ISOTRACK_NESTED)} f32: {nest_s:.3f} s, {res.n_iter} dead points, "
              f"logz {res.logz:.4f} +- {res.logzerr:.4f}, ESS {res.ess:.1f}, star-kernel launches {n_nested}; "
              f"medians {json.dumps(med)}, distance 95% ({d_lo:.3f}, {d_hi:.3f})")
        print(f"[isotrack] fit(use_emcee) {json.dumps(ISOTRACK_MCMC)} f32: {mcmc_s:.3f} s, acceptance {acc:.3f}, "
              f"star-kernel launches {n_mcmc}, distance median {np.median(samples['distance']):.3f}; "
              f"derived_samples raises TypeError, as in the reference")

        # ---- a track-grid model's results file reloads onto the MIST track grid
        single = SingleStarModel(track32, name="track", **obs)
        t0 = time.perf_counter()
        tres = single.fit_multinest(**TRACK_NESTED)
        path = os.path.join(workdir, "track_starmodel.h5")
        single.save_hdf(path)
        back = SingleStarModel.load_hdf(path, device=dev, dtype=torch.float32)
        track_s = time.perf_counter() - t0
        if (type(back.ic).__name__ != "EvolutionTrackInterpolator" or back.ic.grid_type is None
                or back.ic.model.values.shape != track32.model.values.shape or back.evidence != single.evidence
                or not all(np.array_equal(back.samples[c], single.samples[c]) for c in single.samples)):
            raise AssertionError("the track-grid results file did not reload onto the MIST track grid")
        print(f"[isotrack] SingleStarModel on the MIST track grid: fit_multinest {json.dumps(TRACK_NESTED)} logz "
              f"{tres.logz:.4f}, saved and reloaded onto {type(back.ic).__name__} {tuple(back.ic.model.values.shape)} "
              f"with equal samples and evidence ({track_s:.2f} s in all)")
        rec = dict(track_kernel_err_f64=e_t64, track_kernel_err_f32=e_t32,
                   lnpost_err={b: list(v[:2]) for b, v in errs.items()},
                   call={b: dict(wall_ms=timed[b][0], busy_ms=timed[b][1], device_kernels=timed[b][2],
                                 star_launches=calls[(b, "f32")], star_ms=ms[b]) for b in ISOTRACK_BATCHES},
                   launch_alone=launch, nested_s=nest_s, nested_launches=n_nested, logz=float(res.logz), mcmc_s=mcmc_s,
                   mcmc_launches=n_mcmc)
        return n_nested + n_mcmc, rec
    finally:
        tconfig.ISOCHRONES = saved_root
        iso_mod._mist_cache.clear()


#: phase 25: the backward kernels' timed batches, float32 (float64 beside):
#: the NUTS fits' and the leaf's chain counts (the path's shape), then 1024
#: and 131072 points
GRAD_BATCHES = (4, 8, 1024, STAR_BATCH)
#: float64 backward kernel vs autograd of the float64 plain version: the same
#: closed forms in another order (autograd's product chain of the corner
#: weights, its division by each lerp's knot spacing); row by row,
#: |got - ref| <= rtol * max(1, max |ref| of the row)
RTOL_GRAD_F64 = 1e-9
#: float32 backward kernel vs autograd of the float64 plain version on the same
#: float32 tables, points and cotangents, row by row as above. A photometry
#: term's cotangent is (val - mag) / unc^2 with float32 magnitudes good to
#: ~1e-5 mag, so at a near point (residual ~ unc = 0.02) it carries ~1e-3
#: relative error, and each lerp's slope divides a difference of corner
#: values that float32 rounds by ~1e-7 of their size; 1e-2 of the row's
#: largest entry holds both
RTOL_GRAD_F32 = 1e-2


def check_grad(name, got, ref, rtol):
    """Gradients ``(B, P)``: identical NaN and +-inf patterns and, where
    finite, |got - ref| <= rtol * max(1, max |ref| of the row). Returns the
    largest error in those units and the largest absolute error."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    for what, f in (("NaN", np.isnan), ("+inf", np.isposinf), ("-inf", np.isneginf)):
        if not np.array_equal(f(got), f(ref)):
            raise AssertionError(f"{name}: {what} pattern differs ({int(f(got).sum())} vs {int(f(ref).sum())})")
    fin = np.isfinite(ref)
    scale = np.maximum(1.0, np.max(np.where(fin, np.abs(ref), 0.0), axis=1, keepdims=True))
    err = np.where(fin, np.abs(got - ref), 0.0) / scale
    if (err > rtol).any():
        b, j = np.unravel_index(np.argmax(err), err.shape)
        raise AssertionError(f"{name}: {int((err > rtol).sum())} entries out of tolerance (rtol {rtol} of the row's "
                             f"scale); worst row {b} column {j}: got {got[b, j]!r} ref {ref[b, j]!r} "
                             f"(scale {scale[b, 0]!r})")
    if not err.size:
        return 0.0, 0.0
    return float(err.max()), float(np.max(np.where(fin, np.abs(got - ref), 0.0)))


def grad_cotangents(B, n, seed, device, dtype):
    """Seeded cotangents ``(g_ll (B,), g_orig (B, n), g_deriv (B, n))``."""
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=shape), device=device, dtype=dtype)
                 for shape in ((B,), (B, n), (B, n)))


def plain_grad(fn, x, lk, cot):
    """The gradient that torch.autograd takes through the plain version ``fn``
    for the cotangents ``cot`` of its three outputs."""
    import torch

    with torch.enable_grad():
        x = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x, lk), x, grad_outputs=cot)
    return g


def grad_work(fwd_work, pars, n_out):
    """``(bytes, flops, special functions)`` of a backward kernel from its
    forward's: the forward's reads, the cotangents in (the size of the
    forward's outputs, ``n_out`` values a point) and the ``(B, P)`` gradient
    out; the forward's operations twice (recomputed, then its vector-Jacobian
    product, which costs about what the forward does)."""
    nbytes, flops, sfu = fwd_work
    B, P = pars.shape
    return nbytes + B * P * pars.element_size(), 2 * flops, 2 * sfu


def _grad_pair(label, kernel, plain_fn, lk64, lk32, pts, n_out, dev):
    """The backward kernel against autograd of the plain version on ``pts``
    with seeded cotangents, float64 and float32 (against the float64 plain
    version on the same float32 values). Returns ``(err64, err32, finite rows
    of the value)``, the errors in units of the row's scale, and ``(abs64,
    abs32)``, the largest absolute errors."""
    import torch

    B = pts.shape[0]
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    cot64 = grad_cotangents(B, n_out, 7 + B % 11, dev, torch.float64)
    ref64 = plain_grad(plain_fn, p64, lk64, cot64).cpu().numpy()
    got64 = kernel(p64, lk64, *cot64).cpu().numpy()
    torch.cuda.synchronize()
    err64, abs64 = check_grad(f"{label} f64 B={B}", got64, ref64, RTOL_GRAD_F64)
    p32 = p64.float()
    cot32 = tuple(c.float() for c in cot64)
    ref32 = plain_grad(plain_fn, p32.double(), lk32[1], tuple(c.double() for c in cot32)).cpu().numpy()
    got32 = kernel(p32, lk32[0], *cot32).cpu().numpy()
    torch.cuda.synchronize()
    err32, abs32 = check_grad(f"{label} f32 B={B}", got32, ref32, RTOL_GRAD_F32)
    with torch.no_grad():
        fin = int(torch.isfinite(plain_fn(p64, lk64)[0]).sum())
    return err64, err32, fin, (abs64, abs32)


def phase_grad_kernels(dev, ic32, ic64, workdir, parent=None):
    """Phase 25a: kernels A' and C' against autograd of the plain versions at
    the NUTS fits' and leaf's chain counts (4, 8) and at B = 1024 and 131072,
    float64 and float32, on the bench binary and on the
    three-star tree plan (adversarial rows); their device times at the same
    batches (float32, float64 beside; at 4 and 8 points also the median and
    spread of :data:`SPREAD_LAUNCHES` launches, and A's forward beside A')
    beside their bounds and, with the parent's kernels ``parent``
    (``scripts.compare_torch_kernels.Baseline``), the parent's A' and C' in
    turns. Returns the two records of the kernels line (launches filled in by
    the caller)."""
    import torch

    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda, star_lnlike_grad_cuda
    from isochrones_torch.ops.tree import tree_lnlike_fused_plain
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda
    from isochrones_torch.starmodel import BinaryStarModel
    from isochrones_torch.treemodel import StarModel

    obs = star_observations(ic64)
    lk64 = BinaryStarModel(ic64, **obs)._star_likelihood()
    lk32 = BinaryStarModel(ic32, **obs)._star_likelihood()
    lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    tree64 = StarModel.from_ini(ic64, write_tree_ini(os.path.join(workdir, "grad_tree3"), ic64, TREE_TRUTH))
    tlk64 = tree64._get_fn("lnlike").likelihood
    tlk32 = tree_likelihood_as(tlk64, torch.float32)
    tlk32up = tree_likelihood_as(tlk32, torch.float64)
    records = {}
    for name, kernel, plain_fn, l64, l32, n_out, make in (
            ("star_lnlike_grad", star_lnlike_grad_cuda, star_lnlike_fused_plain, lk64, (lk32, lk32up), 2,
             lambda B, seed: _star_grad_points(ic64, B, seed)),
            ("tree_lnlike_grad", tree_lnlike_grad_cuda, tree_lnlike_fused_plain, tlk64, (tlk32, tlk32up),
             tlk64.n_stars, lambda B, seed: _tree_mixed_points(tree64.param_names, ic64.model.knots, B, seed))):
        errs = {}
        for B in GRAD_CHECK_BATCHES:
            e64, e32, fin, (a64, a32) = _grad_pair(name, kernel, plain_fn, l64, l32, make(B, 40 + B % 13), n_out,
                                                   dev)
            errs[B] = (e64, e32, a64, a32)
            print(f"[grad] {name} vs autograd of the plain version, B={B}: f64 max err {e64:.3e} (rtol "
                  f"{RTOL_GRAD_F64} of the row's scale; {a64:.3e} absolute), f32 vs f64 max err {e32:.3e} (rtol "
                  f"{RTOL_GRAD_F32}; {a32:.3e} absolute); {fin}/{B} rows with a finite ll; NaN/inf patterns "
                  f"identical")
        timing = {}
        for B in GRAD_BATCHES:
            box = STAR_BOX if name == "star_lnlike_grad" else None
            if box is not None:
                pts = star_points(ic64.model.knots, 2, B, seed=50, box=box)
            else:
                pts = tree_points(tree64.param_names, ic64.model.knots, B, seed=51, narrow=True)
            p32 = torch.as_tensor(pts, device=dev, dtype=torch.float32)
            cot = grad_cotangents(B, n_out, 52, dev, torch.float32)
            lk = l32[0]
            reps = 50 if B <= 1024 else 10
            new = lambda: kernel(p32, lk, *cot)  # noqa: E731
            old = None
            if parent is not None:
                old = ((lambda: parent.star_grad(p32, lk, *cot)) if name == "star_lnlike_grad"  # noqa: E731
                       else (lambda new=new: parent.run(new)))
            turns = in_turns(new, old, name, reps=reps)
            spread = kernel_ms_spread(new, name) if B <= LEAF_CHAINS else None
            parent_spread = kernel_ms_spread(old, name) if spread and old else None
            # the forward beside its backward at the NUTS chains' batches
            fwd_spread = None
            if spread and name == "star_lnlike_grad":
                fwd_spread = kernel_ms_spread(lambda: star_lnlike_cuda(p32, lk), "star_lnlike_kernel")
            ms = float(np.mean(turns["new"]))
            p64, cot64 = p32.double(), tuple(c.double() for c in cot)
            ms64 = kernel_ms(lambda: kernel(p64, l64, *cot64), name, reps=reps)
            plain = cuda_ms(lambda: plain_grad(plain_fn, p32, lk, cot), reps=max(2, reps // 5))
            fwd = star_work(p32, lk) if name == "star_lnlike_grad" else tree_work(p32, lk)
            bnd = bound(*grad_work(fwd, p32, 1 + 2 * n_out), "float32")
            timing[B] = dict(ms=ms, ms_turns=turns["new"], parent_ms=turns["parent"], ms_f64=ms64, plain_ms=plain,
                             bound_ms=bnd[0], bound_by=bnd[1], ms_spread=spread, parent_ms_spread=parent_spread,
                             forward_ms_spread=fwd_spread)
            par = (f", the parent's {np.round(turns['parent'], 4).tolist()} ms (mean {np.mean(turns['parent']):.4f}, "
                   f"{np.mean(turns['parent']) / ms:.2f}x)" if turns["parent"] else "")
            if spread:
                par += (f"; median [10th, 90th percentile] of {spread[3]} launches {spread[0]:.5f} "
                        f"[{spread[1]:.5f}, {spread[2]:.5f}] ms"
                        + (f", the parent's {parent_spread[0]:.5f} [{parent_spread[1]:.5f}, {parent_spread[2]:.5f}] ms"
                           if parent_spread else "")
                        + (f"; the forward (kernel A) {fwd_spread[0]:.5f} [{fwd_spread[1]:.5f}, {fwd_spread[2]:.5f}] ms"
                           if fwd_spread else ""))
            print(f"[grad] time {name} B={B} f32: kernel {np.round(turns['new'], 4).tolist()} ms (mean {ms:.4f}; f64 "
                  f"{ms64:.4f}){par}, plain (autograd forward + backward) {plain:.4f} ms; bound {bnd[0]:.6f} ms "
                  f"({bnd[2]}), kernel at {bnd[0] / ms:.4f} of it")
        top = GRAD_BATCHES[-1]
        main = timing[top]
        records[name] = {
            "name": name, "route": "cuda",
            "source": "isochrones_torch/csrc/" + ("star_lnlike.cu" if name == "star_lnlike_grad" else "tree_lnlike.cu"),
            "replaces": ("isochrones_tpu/samplers/nuts.py:59" if name == "star_lnlike_grad"
                         else "isochrones_tpu/observation.py:1269"),
            "launches": None, "max_abs_err": errs[top][3], "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "shape": {"B": top, "dtype": "float32"}, "max_err_row_scale": errs[top][1],
            "max_abs_err_f64": errs[top][2], "max_err_row_scale_f64": errs[top][0],
            "ms_fit_batch": timing[1024]["ms"], "plain_ms_fit_batch": timing[1024]["plain_ms"],
            "bound_ms_fit_batch": timing[1024]["bound_ms"],
            "timing": {str(B): t for B, t in timing.items()},
        }
    return records


#: phase 25: NUTS on the bench binary (each dtype) and on the three-star tree.
#: A leaf is ~6 ms of host launches and the chains run in lockstep, so a
#: transition waits for the chain with the smallest step: the depth is held to
#: 5 (32 leaves) and the runs are short (the smoke's budget)
NUTS_BINARY = dict(n_chains=4, n_warmup=80, n_samples=80, max_depth=5, seed=0)
NUTS_TREE = dict(n_chains=4, n_warmup=60, n_samples=60, max_depth=5, seed=0)
#: the distance posterior's median must lie within this of the truth [pc]:
#: the 5 mas +- 0.05 parallax alone gives 200 +- 2 pc, so 10 pc is 5 sigma
NUTS_DIST_TOL = 10.0
#: 4 slice moves a replacement (PolyChord's default is 2 a dimension, 14 here)
POLYCHORD = dict(n_live_points=100, n_batch=25, n_repeat=4, seed=0)
CONVERGENT = dict(nwalkers=64, iter_chunksize=100, maxiter=2, targetn=1, nsamples=2000, seed=0)
#: chains per NUTS leaf in the leaf's timing (fit_nuts' default)
LEAF_CHAINS = 8
#: the backward kernels' checked batches: the NUTS fits' and the leaf's chain
#: counts (a partial warp: idle lanes in every launch), then the timed ones
GRAD_CHECK_BATCHES = tuple(sorted({NUTS_BINARY["n_chains"], NUTS_TREE["n_chains"], LEAF_CHAINS, *GRAD_BATCHES}))
#: NUTS's lnprob quantiles, printed beside the nested fit's of the same model
#: (phase 8 for the binary, phase 11 for the tree). They are no check of the
#: gradient: NUTS picks its draws by the true lnprob, so a fit with the
#: likelihood's gradient lost still lands on the posterior's bulk (a CPU run
#: with the likelihood's outputs detached did, as close as an intact one)
NUTS_LNPROB_Q = (0.16, 0.5, 0.84)
#: the posterior's gradient at each NUTS fit's last draws must differ from
#: the one whose likelihood part is dropped (a wrapper outside the autograd
#: graph) by more than this, in units of the row's scale
LOST_GRAD_MIN = 1e-3


def _refuse_plain(*_args, **_kw):
    raise AssertionError("a plain version ran on the card's path")


def _posterior_grad_check(label, model, z, module, name, plain):
    """The value and gradient that a NUTS leaf takes of ``model``'s posterior
    at ``z`` (float64, on the card) through the wrapper ``module.name``
    (kernels A and A', or C and C') against the same with the wrapper
    replaced by its plain version (autograd), row by row at RTOL_GRAD_F64;
    and against the same with the plain version's outputs detached, the
    fault of a wrapper outside the autograd graph, which must differ from it
    by more than LOST_GRAD_MIN. The wrappers count their launches through
    their module's name, so neither stand-in calls the wrapper. Returns ``(err, lost)`` in units of the row's
    scale."""
    import torch

    from isochrones_torch.samplers.nuts import _safe_value_and_grad

    vg = _safe_value_and_grad(model._get_fn("lnpost"))
    real = getattr(module, name)
    v_k, g_k = vg(z)
    try:
        setattr(module, name, plain)
        v_p, g_p = vg(z)
        setattr(module, name, lambda p, lk: tuple(x.detach() for x in plain(p.detach(), lk)))
        _, g_lost = vg(z)
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    v_k, v_p = v_k.cpu().numpy(), v_p.cpu().numpy()
    if not (np.isfinite(v_p).all() and np.allclose(v_k, v_p, rtol=RTOL_GRAD_F64, atol=RTOL_GRAD_F64)):
        raise AssertionError(f"{label}: lnpost through the kernels {v_k} against the plain version's {v_p}")
    g_p = g_p.cpu().numpy()
    err, _ = check_grad(f"{label} posterior gradient", g_k.cpu().numpy(), g_p, RTOL_GRAD_F64)
    scale = np.maximum(1.0, np.abs(g_p).max(axis=1, keepdims=True))
    lost = float((np.abs(g_lost.cpu().numpy() - g_p) / scale).max(axis=1).min())
    if not lost > LOST_GRAD_MIN:
        raise AssertionError(f"{label}: the gradient without the likelihood's part differs by only {lost:.3e}")
    print(f"[nuts] {label}: the posterior's gradient at the {len(g_p)} chains' last draws through the kernels "
          f"against the plain version's autograd, float64: max err {err:.3e} (rtol {RTOL_GRAD_F64} of the row's "
          f"scale); with the likelihood's outputs detached every row differs by >= {lost:.3e} (bar {LOST_GRAD_MIN})")
    return err, lost


def _nuts_fit(label, model, kw, fwd, bwd, distance, ref_lnprob, check):
    """``model.fit_nuts(**kw)`` with the plain likelihoods made to raise and
    the kernels' counters set to 0 just before: checks finite lnprob, the
    distance median within NUTS_DIST_TOL of the true ``distance``, both
    kernels launched, and through ``check(z)`` (:func:`_posterior_grad_check`
    on a float64 model) the posterior's gradient at the chains' last draws
    ``z``; prints the lnprob quantiles beside ``ref_lnprob`` (the nested
    fit's); returns a record."""
    import torch

    import isochrones_torch.ops.star as star_ops
    import isochrones_torch.ops.tree as tree_ops

    saved = star_ops.star_lnlike_fused_plain, tree_ops.tree_lnlike_fused_plain
    star_ops.star_lnlike_fused_plain = tree_ops.tree_lnlike_fused_plain = _refuse_plain
    try:
        fwd.launches = bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = model.fit_nuts(**kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_fwd, n_bwd = fwd.launches, bwd.launches
    finally:
        star_ops.star_lnlike_fused_plain, tree_ops.tree_lnlike_fused_plain = saved
    res = model._nuts_result
    lnprob = samples["lnprob"]
    dist = [k for k in samples if k.startswith("distance")][0]
    med = float(np.median(samples[dist]))
    frozen = int(np.sum(res.step_size < 100.0 * float(torch.finfo(model.dtype).eps)))
    if not np.isfinite(lnprob).all():
        raise AssertionError(f"{label}: {int((~np.isfinite(lnprob)).sum())} non-finite lnprob")
    q = np.quantile(lnprob, NUTS_LNPROB_Q)
    if abs(med - distance) > NUTS_DIST_TOL:
        raise AssertionError(f"{label}: distance median {med:.3f} pc, truth {distance}")
    if n_fwd <= 0 or n_bwd <= 0:
        raise AssertionError(f"{label}: kernel launches forward {n_fwd}, backward {n_bwd}")
    med_all = {k: round(float(np.median(v)), 4) for k, v in samples.items() if k != "lnprob"}
    print(f"[nuts] {label} fit_nuts {json.dumps(kw)}: {secs:.3f} s, launches forward {n_fwd} backward {n_bwd} (no "
          f"plain version), step sizes {np.round(res.step_size, 5).tolist()}, {frozen} frozen chains, accept "
          f"{np.round(res.accept_rate, 3).tolist()}, divergent {int(res.n_divergent.sum())}, lnprob quantiles "
          f"{NUTS_LNPROB_Q} {np.round(q, 3).tolist()} (the nested fit's {np.round(ref_lnprob, 3).tolist()}); medians "
          f"{json.dumps(med_all)}")
    z = torch.as_tensor(res.samples[-1], device=model.device, dtype=torch.float64)
    grad_err, lost = check(z)
    return dict(seconds=secs, launches_forward=n_fwd, launches_backward=n_bwd, frozen_chains=frozen,
                step_size=res.step_size.tolist(), distance_median=med, divergent=int(res.n_divergent.sum()),
                lnprob_q=q.tolist(), nested_lnprob_q=list(ref_lnprob), grad_err=grad_err, lost_grad=lost)


def phase_engines(dev, ic32, ic64, workdir, nested_lnprob):
    """Phase 25b: the other engines on the card. One NUTS leaf's time and
    launches; ``BinaryStarModel.fit_nuts`` on the bench binary in float32 and
    float64 through kernels A and A'; the three-star tree ``StarModel.fit_nuts``
    through C and C'; each fit's posterior gradient at its chains' last draws
    against the plain versions' (:func:`_posterior_grad_check`), its lnprob
    quantiles printed beside the nested fit's (``nested_lnprob``:
    ``{"binary": q, "tree": q}``); one ``fit_polychord`` and one short
    ``fit_mcmc_convergent``. Returns ``(star record, tree
    record)``: the NUTS fits' launches and times."""
    import torch

    import isochrones_torch.ops.star_cuda as star_cuda
    import isochrones_torch.ops.tree_cuda as tree_cuda
    from isochrones_torch.fit import fit_mcmc_convergent
    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda, star_lnlike_grad_cuda
    from isochrones_torch.ops.tree import tree_lnlike_fused_plain
    from isochrones_torch.ops.tree_cuda import tree_lnlike_cuda, tree_lnlike_grad_cuda
    from isochrones_torch.samplers.nuts import _safe_value_and_grad
    from isochrones_torch.starmodel import BinaryStarModel
    from isochrones_torch.treemodel import StarModel

    obs = star_observations(ic64)
    bin32, bin64 = BinaryStarModel(ic32, **obs), BinaryStarModel(ic64, **obs)

    # one leaf: a value-and-grad call of the posterior over the chains
    z = torch.as_tensor(star_points(ic64.model.knots, 2, LEAF_CHAINS, seed=60, box=STAR_BOX), device=dev,
                        dtype=torch.float32)
    vg = _safe_value_and_grad(bin32._get_fn("lnpost"))
    star_lnlike_cuda.launches = star_lnlike_grad_cuda.launches = 0
    vg(z)
    torch.cuda.synchronize()
    if (star_lnlike_cuda.launches, star_lnlike_grad_cuda.launches) != (1, 1):
        raise AssertionError(f"a NUTS leaf launched A {star_lnlike_cuda.launches} and A' "
                             f"{star_lnlike_grad_cuda.launches} times, not once each")
    leaf_ms = 1e3 * _wall(lambda: vg(z), reps=200)
    _, by_name = profile_kernels(lambda: vg(z), reps=20)
    leaf_kernels = sum(n for _, n in by_name.values()) / 20
    print(f"[nuts] one leaf ({LEAF_CHAINS} chains, float32 binary): {leaf_ms:.4f} ms wall-clock, "
          f"{leaf_kernels:.1f} device kernels (A and A' once each, the rest the posterior's glue in both "
          f"directions), device time {sum(ms for ms, _ in by_name.values()) / 20:.4f} ms")

    star = {"leaf_ms": leaf_ms, "leaf_device_kernels": leaf_kernels}
    for label, model in (("binary f32", bin32), ("binary f64", bin64)):
        star[label] = _nuts_fit(
            label, model, NUTS_BINARY, star_lnlike_cuda, star_lnlike_grad_cuda, STAR_TRUTH[4], nested_lnprob["binary"],
            lambda z, label=label: _posterior_grad_check(label, bin64, z, star_cuda, "star_lnlike_cuda",
                                                         star_lnlike_fused_plain))

    folder = write_tree_ini(os.path.join(workdir, "nuts_tree3"), ic32, TREE_TRUTH)
    tree, tree64 = StarModel.from_ini(ic32, folder), StarModel.from_ini(ic64, folder)
    tree_rec = _nuts_fit(
        "tree (3 stars) f32", tree, NUTS_TREE, tree_lnlike_cuda, tree_lnlike_grad_cuda, TREE_TRUTH[-2],
        nested_lnprob["tree"], lambda z: _posterior_grad_check("tree (3 stars) f32", tree64, z, tree_cuda,
                                                               "tree_lnlike_cuda", tree_lnlike_fused_plain))

    star_lnlike_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bin32.fit_polychord(**POLYCHORD)
    torch.cuda.synchronize()
    pc_s = time.perf_counter() - t0
    d_lo, d_hi = np.quantile(bin32.samples["distance"], [0.025, 0.975])
    if not np.isfinite(res.logz) or star_lnlike_cuda.launches <= 0 or not d_lo <= STAR_TRUTH[4] <= d_hi:
        raise AssertionError(f"fit_polychord: logz {res.logz}, launches {star_lnlike_cuda.launches}, distance 95% "
                             f"({d_lo:.2f}, {d_hi:.2f})")
    print(f"[polychord] fit_polychord {json.dumps(POLYCHORD)} f32: {pc_s:.3f} s, {res.n_iter} dead points, logz "
          f"{res.logz:.4f} +- {res.logzerr:.4f}, ESS {res.ess:.1f}, truncated {res.truncated}, kernel launches "
          f"{star_lnlike_cuda.launches}; distance 95% interval ({d_lo:.3f}, {d_hi:.3f})")
    star["polychord_seconds"] = pc_s
    star["polychord_launches"] = star_lnlike_cuda.launches

    bin32.name = "chip-smoke-binary"
    star_lnlike_cuda.launches = 0
    t0 = time.perf_counter()
    df = fit_mcmc_convergent(bin32, sample_directory=os.path.join(workdir, "chains"),
                             resultsdir=os.path.join(workdir, "results"), **CONVERGENT)
    conv_s = time.perf_counter() - t0
    n_conv = star_lnlike_cuda.launches
    df2 = fit_mcmc_convergent(bin32, sample_directory=os.path.join(workdir, "chains"),
                              resultsdir=os.path.join(workdir, "results"), **dict(CONVERGENT, maxiter=1, targetn=1e9))
    if not (np.isfinite(df["lnprob"]).all() and np.isfinite(df2["lnprob"]).all()) or n_conv <= 0:
        raise AssertionError("fit_mcmc_convergent: non-finite lnprob or no kernel launch")
    print(f"[convergent] fit_mcmc_convergent {json.dumps(CONVERGENT)} f32: {conv_s:.3f} s, {len(df['lnprob'])} "
          f"samples, kernel launches {n_conv}, distance median {np.median(df['distance']):.3f}; resumed for one more "
          f"chunk: {len(df2['lnprob'])} samples")
    star["convergent_seconds"] = conv_s
    return star, tree_rec


def seismic_observations(ic, truth=STAR_TRUTH):
    """The bench binary's observations (:func:`star_observations`) with the
    primary's ``nu_max`` and ``delta_nu`` at ``truth`` (5% and 1 uHz)."""
    obs = star_observations(ic, truth)
    nu_max, delta_nu = (float(x) for x in ic.interp_value([truth[0], *truth[2:4]], ["nu_max", "delta_nu"]))
    obs.update(nu_max=(nu_max, 0.05 * nu_max), delta_nu=(delta_nu, 1.0))
    return obs


def phase_seismic(dev, ic32, ic64):
    """Phase 26b: the bench binary with ``nu_max`` and ``delta_nu`` observed,
    whose posterior is kernel A's launch and kernel B's (the seismic terms):
    ``lnpost_batch`` at 131072 points (adversarial rows and the bench box)
    against the plain path in float64, one launch of each a call, the
    throughput of both paths in float32; then ``fit_nuts`` at the smoke's cut
    setting in float32 through A, A', B and B' with the plain versions made
    to raise (finite lnprob, distance median within NUTS_DIST_TOL, every
    kernel launched), and the posterior's value and gradient at the chains'
    last draws in float64 against the plain path's. Returns a record."""
    import torch

    import isochrones_torch.ops.interp as interp_ops
    import isochrones_torch.ops.star as star_ops
    import isochrones_torch.ops.star_cuda as star_cuda
    import isochrones_torch.starmodel as star_mod
    from isochrones_torch.ops.interp import interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda, interp_nd_grad_cuda
    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.samplers.nuts import _safe_value_and_grad
    from isochrones_torch.starmodel import BinaryStarModel

    obs = seismic_observations(ic64)
    s32, s64 = BinaryStarModel(ic32, **obs), BinaryStarModel(ic64, **obs)
    pts = star_points(ic64.model.knots, 2, STAR_BATCH, seed=31)
    pts[STAR_BATCH // 2:] = star_points(ic64.model.knots, 2, STAR_BATCH // 2, seed=32, box=STAR_BOX)
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    p32 = p64.float()

    def plain_path(fn):
        saved = star_cuda.star_lnlike_cuda, star_mod.interp_nd
        star_cuda.star_lnlike_cuda, star_mod.interp_nd = star_lnlike_fused_plain, interp_nd_plain
        try:
            return fn()
        finally:
            star_cuda.star_lnlike_cuda, star_mod.interp_nd = saved

    star_cuda.star_lnlike_cuda.launches = interp_nd_cuda.launches = 0
    lp_k = s64.lnpost_batch(p64).cpu().numpy()
    if (star_cuda.star_lnlike_cuda.launches, interp_nd_cuda.launches) != (1, 1):
        raise AssertionError(f"seismic lnpost_batch: kernel A {star_cuda.star_lnlike_cuda.launches}, kernel B "
                             f"{interp_nd_cuda.launches} launches")
    lp_p = plain_path(lambda: s64.lnpost_batch(p64).cpu().numpy())
    err = check_star("seismic lnpost_batch f64 kernels vs plain", [lp_k], [lp_p], RTOL_STAR_F64)
    rate = STAR_BATCH / _wall(lambda: s32.lnpost_batch(p32), reps=20)
    plain_rate = plain_path(lambda: STAR_BATCH / _wall(lambda: s32.lnpost_batch(p32), reps=5))
    print(f"[seismic] binary with nu_max {obs['nu_max'][0]:.3f} and delta_nu {obs['delta_nu'][0]:.4f} observed: "
          f"{STAR_BATCH}-point lnpost_batch, one launch each of kernels A and B; f64 kernels vs plain max_abs_err "
          f"{err:.3e} (rtol {RTOL_STAR_F64}), {int(np.isfinite(lp_p).sum())} finite; f32 throughput kernels "
          f"{rate:.1f} evals/s, plain path {plain_rate:.1f} evals/s")

    counters = (star_cuda.star_lnlike_cuda, star_cuda.star_lnlike_grad_cuda, interp_nd_cuda, interp_nd_grad_cuda)
    saved = star_ops.star_lnlike_fused_plain, interp_ops.interp_nd_plain
    star_ops.star_lnlike_fused_plain = interp_ops.interp_nd_plain = _refuse_plain
    try:
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = s32.fit_nuts(**NUTS_BINARY)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_a, n_ag, n_b, n_bg = (c.launches for c in counters)
    finally:
        star_ops.star_lnlike_fused_plain, interp_ops.interp_nd_plain = saved
    med = float(np.median(samples["distance"]))
    if not np.isfinite(samples["lnprob"]).all() or abs(med - STAR_TRUTH[4]) > NUTS_DIST_TOL:
        raise AssertionError(f"seismic fit_nuts: distance median {med:.3f}, {np.isfinite(samples['lnprob']).sum()} "
                             f"finite lnprob")
    if min(n_a, n_ag, n_b, n_bg) <= 0:
        raise AssertionError(f"seismic fit_nuts launches: A {n_a}, A' {n_ag}, B {n_b}, B' {n_bg}")
    res = s32._nuts_result
    q = np.quantile(samples["lnprob"], NUTS_LNPROB_Q)
    print(f"[seismic] fit_nuts {json.dumps(NUTS_BINARY)} f32: {secs:.3f} s, launches A {n_a}, A' {n_ag}, B {n_b}, "
          f"B' {n_bg} (no plain version), step sizes {np.round(res.step_size, 5).tolist()}, distance median "
          f"{med:.3f} pc, lnprob quantiles {NUTS_LNPROB_Q} {np.round(q, 3).tolist()}")

    z = torch.as_tensor(res.samples[-1], device=dev, dtype=torch.float64)
    vg = _safe_value_and_grad(s64._get_fn("lnpost"))
    v_k, g_k = vg(z)
    v_p, g_p = plain_path(lambda: vg(z))
    torch.cuda.synchronize()
    v_k, v_p = v_k.cpu().numpy(), v_p.cpu().numpy()
    if not (np.isfinite(v_p).all() and np.allclose(v_k, v_p, rtol=RTOL_GRAD_F64, atol=RTOL_GRAD_F64)):
        raise AssertionError(f"seismic lnpost at the last draws through the kernels {v_k}, plain {v_p}")
    gerr = check_grad("seismic posterior gradient", g_k.cpu().numpy(), g_p.cpu().numpy(), RTOL_GRAD_F64)[0]
    print(f"[seismic] the posterior's gradient at the {len(v_k)} chains' last draws through A, A', B and B' against "
          f"the plain path's autograd, float64: max err {gerr:.3e} (rtol {RTOL_GRAD_F64} of the row's scale)")
    return dict(lnpost_max_abs_err=err, lnpost_rate=rate, lnpost_plain_rate=plain_rate, nuts_seconds=secs,
                launches_a=n_a, launches_a_grad=n_ag, launches_b=n_b, launches_b_grad=n_bg, distance_median=med,
                grad_err=gerr)


#: phase 28's nested cluster fits (sharded and unsharded): phase 14's fit at
#: 1024 walkers a call with shorter walks, to keep the phase near 90 s
CLUSTER_MESH_FIT = dict(n_live_points=256, n_repeat=6, seed=0)
#: phase 28's NUTS fits (sharded and unsharded)
NUTS_MESH = dict(n_chains=4, n_warmup=20, n_samples=16, max_depth=5, seed=0)
#: phase 28's two-process fleet: processes, folders
FLEET_PROCS, FLEET_FOLDERS = 2, 4
#: phase 28's fleet worker: the kernel library loaded (built by the parent),
#: its seconds printed, then ``python -m isochrones_torch.cli.starfit``
FLEET_RUN = (
    "import json, runpy, sys, time\n"
    "t0 = time.perf_counter()\n"
    "from isochrones_torch.ops import _build\n"
    "path, secs, _ = _build.build()\n"
    "_build.load_library()\n"
    "print('build ' + json.dumps([secs, time.perf_counter() - t0]), flush=True)\n"
    "sys.argv = ['isochrones_torch.cli.starfit'] + sys.argv[1:]\n"
    "runpy.run_module('isochrones_torch.cli.starfit', run_name='__main__')\n"
)


def _same_or_close(name, got, ref, rtol, atol):
    """``("bitwise", 0.0)`` where ``got`` equals ``ref``, else the largest
    difference after :func:`check_close` held it to the bar."""
    if np.array_equal(got, ref, equal_nan=True):
        return "bitwise", 0.0
    return "close", check_close(name, got, ref, rtol, atol)


def _fleet(dev, workdir):
    """Phase 28f: ``FLEET_PROCS`` processes of ``isochrones_torch.cli.starfit
    --multihost`` over ``FLEET_FOLDERS`` binary folders on the one card.
    Returns the fleet's record."""
    import re
    import socket

    from isochrones_torch import get_ichrone

    ic = get_ichrone("synthetic", device=dev)
    obs = star_observations(ic, CLI_STAR_TRUTH, bands=("J", "H", "K"))
    text = FLAT_INI.format(Teff=obs["Teff"][0], logg=obs["logg"][0], J=obs["J"][0], H=obs["H"][0], K=obs["K"][0])
    folders = [write_ini(os.path.join(workdir, f"fleet_{i}"), text) for i in range(FLEET_FOLDERS)]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    args = ["--device", str(dev), "--models", "synthetic", "--no_plots", "--binary", "--n_live_points", str(CLI_LIVE),
            "--seed", "0", "--multihost", *folders]
    procs = []
    t0 = time.perf_counter()
    for pid in range(FLEET_PROCS):
        env = dict(os.environ, ISOCHRONES_TPU_COORDINATOR=f"localhost:{port}",
                   ISOCHRONES_TPU_NUM_PROCESSES=str(FLEET_PROCS), ISOCHRONES_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", FLEET_RUN, *args], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    secs = time.perf_counter() - t0
    shards, loads = [], []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"fleet process {pid}: exit {p.returncode}\n{out[-3000:]}")
        if f"[multihost] process {pid}/{FLEET_PROCS}: every process has finished" not in out:
            raise AssertionError(f"fleet process {pid} did not pass the end barrier:\n{out[-3000:]}")
        shards.append(re.findall(r"^\d+ of \d+: (\S+)$", out, re.M))
        loads.append(json.loads(re.search(r"^build (.*)$", out, re.M).group(1)))
    flat = [f for shard in shards for f in shard]
    if sorted(flat) != sorted(folders) or len(set(flat)) != len(flat):
        raise AssertionError(f"fleet shards {shards} are not a partition of {folders}")
    for f in folders:
        if not os.path.exists(os.path.join(f, "synthetic_starmodel_binary.h5")):
            raise AssertionError(f"fleet: {f} has no results file")
    print(f"[mesh] fleet: {FLEET_PROCS} processes of python -m isochrones_torch.cli.starfit --multihost (gloo, "
          f"localhost:{port}) on {dev} over {FLEET_FOLDERS} binary folders ({CLI_LIVE} live points): {secs:.2f} s; "
          f"shards {[len(x) for x in shards]}, disjoint and complete, every results file written, the end barrier "
          f"passed by both; kernel library build / load seconds per process "
          f"{[[round(a, 3), round(b, 3)] for a, b in loads]}")
    return dict(seconds=secs, shards=[len(x) for x in shards], build_load_s=loads)


def phase_parallel(dev, ic32, ic64, sim, table, workdir, cards=None, fleet=True):
    """Phase 28: the device mesh on the card (see the module's note).
    ``cards`` (default ``[dev] * 4``) are the four shards' devices of parts
    (b)-(d), the first two part (e)'s; ``scripts/check_torch_mesh.py``
    passes four distinct cards, each shard then on its own copy of the
    model's tables. ``fleet=False`` leaves out part (f). Returns the phase's
    record: launches and times of every part."""
    import torch

    import isochrones_torch.ops.star_cuda as star_cuda
    from isochrones_torch import BinaryStarModel
    from isochrones_torch.batch import BatchStarFitter
    from isochrones_torch.cluster import StarClusterModel
    from isochrones_torch.ops.catalog_cuda import catalog_lnpost_cuda
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda, star_lnlike_grad_cuda
    from isochrones_torch.parallel import Mesh, default_mesh, sharded_lnpost

    rec = {}
    # ---- (a) the card's own mesh
    mesh = default_mesh()
    n_cards = torch.cuda.device_count()
    try:
        default_mesh(n_cards + 1)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError(f"default_mesh({n_cards + 1}) on {n_cards} card(s) was not refused")
    print(f"[mesh] default_mesh(): {mesh.size} device(s) {[str(d) for d in mesh.devices]}; default_mesh({n_cards + 1}) "
          f"refused: {refused}")
    rec["default_mesh_devices"] = mesh.size

    # ---- (b) four shards on the card: the binary's lnpost_batch
    cards = [dev] * 4 if cards is None else list(cards)
    where = f"{dev}" if len(set(cards)) == 1 else f"{len(set(cards))} cards"
    four = Mesh(cards, ("walkers",))
    bin32 = BinaryStarModel(ic32, **star_observations(ic64, STAR_TRUTH))
    x = torch.as_tensor(star_points(ic64.model.knots, 2, STAR_BATCH, seed=13, box=STAR_BOX), device=dev,
                        dtype=torch.float32)
    sharded = sharded_lnpost(bin32._mesh_fn("lnpost", four), four)
    star_lnlike_cuda.launches = 0
    ref = bin32.lnpost_batch(x)
    torch.cuda.synchronize()
    n_plain = star_lnlike_cuda.launches
    star_lnlike_cuda.launches = 0
    got = sharded(x)
    torch.cuda.synchronize()
    n_mesh = star_lnlike_cuda.launches
    if (n_plain, n_mesh) != (1, 4):
        raise AssertionError(f"binary lnpost_batch: kernel A launched {n_plain} times plain, {n_mesh} on 4 shards")
    geo = (star_cuda.launch_geometry(STAR_BATCH, 2), star_cuda.launch_geometry(STAR_BATCH // 4, 2))
    kind, err = _same_or_close("binary lnpost_batch, 4 shards vs plain", got.cpu().numpy(), ref.cpu().numpy(),
                               RTOL_STAR_F32, ATOL_STAR_F32)
    if geo[0] == geo[1] and kind != "bitwise":
        raise AssertionError(f"binary lnpost_batch on 4 shards differs ({err:.3e}) at one launch geometry {geo[0]}")
    plain_ms = 1e3 * _wall(lambda: bin32.lnpost_batch(x), reps=20)
    mesh_ms = 1e3 * _wall(lambda: sharded(x), reps=20)
    print(f"[mesh] binary lnpost_batch f32, B={STAR_BATCH}, 4 shards on {where} (sharded_lnpost) vs the plain call: "
          f"{kind} (max_abs_err {err:.3e}; kernel A's (groups, lanes) {geo[0]} at {STAR_BATCH}, {geo[1]} at "
          f"{STAR_BATCH // 4}); kernel A launches {n_mesh} vs {n_plain}; wall-clock {mesh_ms:.3f} ms vs "
          f"{plain_ms:.3f} ms")
    rec["star"] = dict(agreement=kind, max_abs_err=err, launches_mesh=n_mesh, launches_plain=n_plain,
                       ms_mesh=mesh_ms, ms_plain=plain_ms, geometry=[list(g) for g in geo])

    # ---- (c) the cluster's star axis on four shards
    stars4 = Mesh(cards, ("stars",))
    kw = {k: v for k, v in MODEL.items() if k not in ("bands", "props")}
    rng = np.random.default_rng(1)
    pw = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(W_FIT, 7))
    cl = {}
    for dt, ic in (("float64", ic64), ("float32", ic32)):
        plain, shard = StarClusterModel(ic, sim, **kw), StarClusterModel(ic, sim, mesh=stars4, **kw)
        p = torch.as_tensor(pw, device=dev, dtype=ic.dtype)
        ref = plain.lnpost_batch(p).cpu().numpy()
        cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
        got = shard.lnpost_batch(p).cpu().numpy()
        n_c, n_b = cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches
        if (n_c, n_b) != (4, 4 * INTERP_PER_CLUSTER_CALL):
            raise AssertionError(f"cluster lnpost_batch on 4 shards ({dt}): cluster kernel {n_c}, kernel B {n_b}")
        if not np.array_equal(np.isfinite(got), np.isfinite(ref)) or not np.isfinite(ref).any():
            raise AssertionError(f"cluster lnpost_batch on 4 shards ({dt}): finite patterns differ")
        fin = np.isfinite(ref)
        if dt == "float64":
            rel = float(np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin])))
            if rel > 1e-12:
                raise AssertionError(f"cluster lnpost_batch on 4 shards (float64): relative error {rel:.3e} > 1e-12")
            cl[dt] = dict(max_rel_err=rel)
        else:
            cl[dt] = dict(max_abs_err=check_close("cluster lnpost_batch on 4 shards (float32)", got, ref,
                                                  RTOL_SLICE_F32, ATOL_SLICE_F32))
        cl[dt].update(launches_call=n_c, interp_launches_call=n_b)
        if dt == "float32":
            cl[dt]["ms_mesh"] = 1e3 * _wall(lambda: shard.lnpost_batch(p), reps=5)
            cl[dt]["ms_plain"] = 1e3 * _wall(lambda: plain.lnpost_batch(p), reps=5)
            m_ref, m_got = plain.star_lnmarginals(TRUTH), shard.star_lnmarginals(TRUTH)
            cl[dt]["star_lnmarginals_err"] = check_close("star_lnmarginals on 4 shards (float32)", m_got, m_ref,
                                                         RTOL_SLICE_F32, ATOL_SLICE_F32)
            fits = {}
            for label, model in (("plain", plain), ("mesh", shard)):
                cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = model.fit(**CLUSTER_MESH_FIT)
                torch.cuda.synchronize()
                fits[label] = dict(seconds=time.perf_counter() - t0, logz=res.logz, logzerr=res.logzerr,
                                   n_dead=res.n_iter, launches=cluster_lnmarginal_cuda.launches,
                                   interp_launches=interp_nd_cuda.launches)
                if not np.isfinite(res.logz) or res.truncated:
                    raise AssertionError(f"cluster fit ({label}): logz {res.logz}, truncated {res.truncated}")
            a, b = fits["mesh"], fits["plain"]
            bar = 3.0 * float(np.hypot(a["logzerr"], b["logzerr"]))
            if a["logz"] != b["logz"] and abs(a["logz"] - b["logz"]) > bar:
                raise AssertionError(f"sharded cluster fit logz {a['logz']} vs {b['logz']} (bar {bar:.3f})")
            if a["launches"] <= 0 or a["interp_launches"] != INTERP_PER_CLUSTER_CALL * a["launches"]:
                raise AssertionError(f"sharded cluster fit launches: cluster {a['launches']}, B {a['interp_launches']}")
            cl["fits"] = fits
        print(f"[mesh] cluster lnpost_batch {dt}, W={W_FIT}, {len(sim)} stars on 4 shards ({where}) vs unsharded: cluster kernel "
              f"launches {n_c}, kernel B {n_b}; {json.dumps({k: v for k, v in cl[dt].items()})}")
    fits = cl["fits"]
    print(f"[mesh] cluster nested fit {json.dumps(CLUSTER_MESH_FIT)} f32 (1024 walkers a call), sharded vs unsharded: "
          f"logz {fits['mesh']['logz']:.4f} +- {fits['mesh']['logzerr']:.4f} vs {fits['plain']['logz']:.4f} +- "
          f"{fits['plain']['logzerr']:.4f} ({'equal' if fits['mesh']['logz'] == fits['plain']['logz'] else 'within 3 combined logzerr'}); "
          f"{fits['mesh']['seconds']:.2f} s vs {fits['plain']['seconds']:.2f} s; dead points {fits['mesh']['n_dead']} vs "
          f"{fits['plain']['n_dead']}; cluster kernel launches {fits['mesh']['launches']} vs {fits['plain']['launches']}, "
          f"kernel B {fits['mesh']['interp_launches']} vs {fits['plain']['interp_launches']}")
    rec["cluster"] = cl

    # ---- (d) the catalogue's star axis on four shards
    cat = {}
    for label, mesh_arg in (("plain", None), ("mesh", stars4)):
        fitter = BatchStarFitter(ic32, table, bands=CAT_BANDS)
        catalog_lnpost_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = fitter.fit_mcmc(**CAT_MCMC, mesh=mesh_arg)
        torch.cuda.synchronize()
        cat[label] = dict(seconds=time.perf_counter() - t0, launches=catalog_lnpost_cuda.launches, samples=samples)
    # the walkers' start (sample_p0) is drawn unsharded; every sampler call is four launches
    catalog_lnpost_cuda.launches = 0
    BatchStarFitter(ic32, table, bands=CAT_BANDS).sample_p0(CAT_MCMC["nwalkers"], rng=CAT_MCMC["seed"])
    n_p0 = catalog_lnpost_cuda.launches
    n_calls = cat["plain"]["launches"] - n_p0
    if cat["mesh"]["launches"] != n_p0 + 4 * n_calls or n_calls <= 0:
        raise AssertionError(f"catalog fit_mcmc: kernel E {cat['mesh']['launches']} launches on 4 shards, "
                             f"{cat['plain']['launches']} unsharded ({n_p0} of them the start's)")
    kind, err = _same_or_close("catalog fit_mcmc samples, 4 shards vs unsharded", cat["mesh"]["samples"],
                               cat["plain"]["samples"], RTOL_STAR_F32, ATOL_STAR_F32)
    print(f"[mesh] BatchStarFitter.fit_mcmc({json.dumps(CAT_MCMC)}) f32, {CAT_STARS} stars on 4 shards ({where}) vs unsharded: "
          f"samples {kind} (max_abs_err {err:.3e}); kernel E launches {cat['mesh']['launches']} vs "
          f"{cat['plain']['launches']} ({n_p0} of each the unsharded start's); "
          f"{cat['mesh']['seconds']:.3f} s vs {cat['plain']['seconds']:.3f} s")
    rec["catalog"] = dict(agreement=kind, max_abs_err=err, launches_mesh=cat["mesh"]["launches"],
                          launches_plain=cat["plain"]["launches"], launches_start=n_p0, seconds_mesh=cat["mesh"]["seconds"],
                          seconds_plain=cat["plain"]["seconds"])

    # ---- (e) NUTS chains on two shards
    chains2 = Mesh(cards[:2], ("chains",))
    nuts = {}
    for label, mesh_arg in (("plain", None), ("mesh", chains2)):
        star_lnlike_cuda.launches = star_lnlike_grad_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = bin32.fit_nuts(**NUTS_MESH, mesh=mesh_arg)
        torch.cuda.synchronize()
        nuts[label] = dict(seconds=time.perf_counter() - t0, launches=star_lnlike_cuda.launches,
                           launches_backward=star_lnlike_grad_cuda.launches, samples=samples)
        if not np.isfinite(samples["lnprob"]).all() or star_lnlike_grad_cuda.launches <= 0:
            raise AssertionError(f"fit_nuts ({label}): lnprob finite {np.isfinite(samples['lnprob']).all()}, "
                                 f"A' launches {star_lnlike_grad_cuda.launches}")
    same = all(np.array_equal(nuts["mesh"]["samples"][c], nuts["plain"]["samples"][c]) for c in nuts["plain"]["samples"])
    med = float(np.median(nuts["mesh"]["samples"]["distance"]))
    if not same and abs(med - STAR_TRUTH[4]) > NUTS_DIST_TOL:
        raise AssertionError(f"sharded fit_nuts: not the unsharded draws, and the distance median {med:.3f} pc")
    print(f"[mesh] BinaryStarModel.fit_nuts({json.dumps(NUTS_MESH)}) f32, chains on 2 shards vs unsharded: draws "
          f"{'bitwise' if same else 'differ'} (sharded distance median {med:.3f} pc); kernel A launches "
          f"{nuts['mesh']['launches']} vs {nuts['plain']['launches']}, A' {nuts['mesh']['launches_backward']} vs "
          f"{nuts['plain']['launches_backward']}; {nuts['mesh']['seconds']:.3f} s vs {nuts['plain']['seconds']:.3f} s")
    rec["nuts"] = dict(agreement="bitwise" if same else "differ", distance_median=med,
                       **{f"{k}_{lab}": v for lab in ("mesh", "plain") for k, v in nuts[lab].items() if k != "samples"})

    # ---- (f) a two-process fleet on the card
    if fleet:
        rec["fleet"] = _fleet(dev, workdir)
    return rec


def _star_grad_points(ic, B, seed):
    """``star_points`` over the grid's box in the first half (adversarial
    blocks) and the bench box in the second."""
    pts = star_points(ic.model.knots, 2, B, seed=seed)
    pts[B // 2:] = star_points(ic.model.knots, 2, B - B // 2, seed=seed + 1, box=STAR_BOX)
    return pts


#: phase 29: the cluster fits from phase 14's table (in-process, a cut live
#: count), the fit-catalog CLI on phase 17's table, the convergent harness
HDF5_CLUSTER = dict(models="synthetic", dtype=None, nlive=32, mineep=1, maxeep=164, max_distance=3000, minq=0.2,
                    max_iter=160, dynamic=False, name="hdf5", seed=0)
HDF5_CATALOG_CLI = ["--models", "synthetic", "--dtype", "float32", "--method", "mcmc", "--nwalkers", "32", "--nburn",
                    "20", "--niter", "10", "--seed", "0"]
HDF5_CONVERGENT = dict(nwalkers=64, iter_chunksize=50, targetn=1e9, nsamples=1000, seed=5)


def pandas_frame_tree(columns, table_format=False, deflate=None):
    """``DataFrame(columns).to_hdf(path, key="df")`` as an
    :class:`isochrones_torch.hdf5.Tree` in PyTables' layout
    (``pandas/io/pytables.py``), for the card's machine, which has neither
    pandas nor PyTables: ``format="fixed"`` (``FrameFixed``: the column
    labels, the row index and one float64 block, stored transposed) or
    ``format="table"`` (``AppendableFrameTable``: one compound ``table``
    dataset of the row index and a ``values_block_0`` field, deflated at
    ``deflate`` where given, and the columns' names in pickled attributes).
    Attributes as PyTables keeps them: strings fixed-length, lists, tuples,
    dicts and None as protocol-0 pickles."""
    import pickle

    from isochrones_torch import hdf5

    def text(s):
        return np.bytes_(s.encode())

    def pickled(obj):
        return np.bytes_(pickle.dumps(obj, 0))

    def node(cls, version):
        return {"CLASS": text(cls), "VERSION": text(version), "TITLE": text("")}

    names = list(columns)
    values = np.stack([np.asarray(columns[c], dtype=np.float64) for c in names], axis=1)
    n = len(values)
    root = hdf5.Tree(attrs=dict(node("GROUP", "1.0"), PYTABLES_FORMAT_VERSION=text("2.1")))
    g = root.require("df")
    g.attrs.update(node("GROUP", "1.0"), pandas_version=text("0.15.2"), encoding=text("UTF-8"),
                   errors=text("strict"))
    if not table_format:
        g.attrs.update(pandas_type=text("frame"), ndim=2, axis0_variety=text("regular"),
                       axis1_variety=text("regular"), nblocks=1, block0_items_variety=text("regular"))
        labels = np.array([c.encode() for c in names])
        array = dict(node("CARRAY", "1.1") if deflate else node("ARRAY", "2.4"), FLAVOR=text("numpy"))
        for name, arr, kind in (("axis0", labels, "string"), ("axis1", np.arange(n, dtype=np.int64), "integer"),
                                ("block0_items", labels, "string")):
            g[name] = hdf5.Data(arr, dict(array, transposed=False, kind=text(kind), name=pickled(None)),
                                deflate=deflate)
        g["block0_values"] = hdf5.Data(values, dict(array, transposed=True), deflate=deflate)
        return root
    g.attrs.update(pandas_type=text("frame_table"), table_type=text("appendable_frame"),
                   index_cols=pickled([(0, "index")]), values_cols=pickled(["values_block_0"]),
                   non_index_axes=pickled([(1, names)]), data_columns=pickled([]), nan_rep=text("nan"), levels=1,
                   info=pickled({1: {"names": [None], "type": "Index"}, "index": {}}))
    rec = np.zeros(n, dtype=[("index", "<i8"), ("values_block_0", "<f8", (len(names),))])
    rec["index"], rec["values_block_0"] = np.arange(n), values
    g["table"] = hdf5.Data(rec, dict(node("TABLE", "2.7"), FIELD_0_NAME=text("index"),
                                     FIELD_1_NAME=text("values_block_0"), FIELD_0_FILL=np.int64(0),
                                     FIELD_1_FILL=np.float64(0.0), NROWS=np.int64(n), index_kind=text("integer"),
                                     values_block_0_kind=pickled(names), values_block_0_meta=pickled(None),
                                     values_block_0_dtype=text("float64")), deflate=deflate)
    return root


def phase_hdf5(dev, workdir, ic32, ic64, sim, table, fitted, smi):
    """Phase 29: the JAX package's HDF5 files on the card's machine, which has
    neither h5py nor pandas (``isochrones_torch.hdf5``). (a) Phase 27's
    results files reread: their samples bitwise those the fits held
    (``fitted``, kept by phase 27 as it saved them), each model reloaded
    onto the card in float32 and its stored draws' ``lnpost_batch`` (one
    launch of kernel A) within the star's float32 bar of the stored lnprob;
    ``save_hdf`` and ``load_hdf`` of the binary fit timed. (b) ``clusterfit``
    from phase 14's table written in pandas' ``fixed`` layout against the
    same table as CSV: bitwise equal samples and logz, equal launches of
    the cluster kernel and kernel B. (c) The fit-catalog CLI from phase
    17's table in pandas' ``table`` layout, deflated, against its CSV:
    bitwise equal output files and equal launches of kernel E. (d)
    ``fit_mcmc_convergent`` stopped after one chunk and resumed from its
    HDF5 checkpoint: bitwise the uninterrupted run. Returns the phase's
    record."""
    import contextlib
    import filecmp
    import io

    import torch

    import isochrones_torch.config as tconfig
    import isochrones_torch.isochrone as iso_mod
    from isochrones_torch import BasicStarModel, BinaryStarModel, hdf5
    from isochrones_torch.cli.fit_catalog import main as fit_catalog_main
    from isochrones_torch.cluster import clusterfit
    from isochrones_torch.fit import fit_mcmc_convergent
    from isochrones_torch.ops.catalog_cuda import catalog_lnpost_cuda
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda
    from isochrones_torch.utils import stored_table

    secs, rec = {}, {}
    # ---- (a) phase 27's results files
    t0 = time.perf_counter()
    folder = os.path.join(workdir, "gaia_star")
    saved_root = tconfig.ISOCHRONES
    tconfig.ISOCHRONES = os.path.join(workdir, "isochrones")
    try:
        for mult in ("single", "binary"):
            path = os.path.join(folder, f"mist_starmodel_{mult}.h5")
            samples = stored_table(hdf5.read(path), "samples")
            want = fitted[os.path.abspath(path)]
            if list(samples) != list(want) or not all(np.array_equal(samples[c], want[c]) for c in want):
                raise AssertionError(f"{path}: the samples reread are not bitwise the fitted model's")
            m = BasicStarModel.load_hdf(path, device=dev, dtype=torch.float32)
            x = np.stack([samples[c] for c in m.param_names], axis=-1)
            star_lnlike_cuda.launches = 0
            lp = m.lnpost_batch(x).cpu().numpy()
            torch.cuda.synchronize()
            if star_lnlike_cuda.launches != 1:
                raise AssertionError(f"{mult}: lnpost_batch launched kernel A {star_lnlike_cuda.launches} times")
            err = check_star(f"{mult}: reloaded lnpost_batch vs the stored lnprob", [lp], [samples["lnprob"]],
                             RTOL_STAR_F32, ATOL_STAR_F32)
            rec[mult] = dict(draws=len(x), max_abs_err=err, launches_a=star_lnlike_cuda.launches)
            if mult == "binary":
                copy = os.path.join(workdir, "hdf5_binary_copy.h5")
                save_s = _wall(lambda: m.save_hdf(copy, overwrite=True), reps=5)
                load_s = _wall(lambda: BasicStarModel.load_hdf(copy, ic=m.ic), reps=5)
                rec[mult].update(save_hdf_ms=1e3 * save_s, load_hdf_ms=1e3 * load_s, bytes=os.path.getsize(copy))
    finally:
        tconfig.ISOCHRONES = saved_root
        iso_mod._mist_cache.clear()
    secs["results_files"] = time.perf_counter() - t0
    print(f"[hdf5] phase 27's results files reread bitwise; float32 kernel A on the stored draws against the stored "
          f"lnprob: {json.dumps(rec)} (one launch each)")

    # ---- (b) clusterfit from an HDF table in pandas' fixed layout against the CSV
    t0 = time.perf_counter()
    members = {c: np.asarray(sim.data[c], dtype=np.float64) for c in sim.data}
    paths = {"csv": _write_csv(os.path.join(workdir, "hdf5_cluster50.csv"), members),
             "h5": os.path.join(workdir, "hdf5_cluster50.h5")}
    hdf5.write(paths["h5"], pandas_frame_tree(members))
    fits = {}
    for kind, path in paths.items():
        cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
        model = clusterfit(path, device=dev, **dict(HDF5_CLUSTER, dtype=torch.float32))
        torch.cuda.synchronize()
        fits[kind] = (model, cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches)
    (mc, nc, bc), (mh, nh, bh) = fits["csv"], fits["h5"]
    same = (list(mc.samples) == list(mh.samples) and all(np.array_equal(mc.samples[c], mh.samples[c]) for c in
                                                         mc.samples) and mc.evidence == mh.evidence)
    if not same or (nc, bc) != (nh, bh) or nc <= 0 or bc <= 0 or not np.isfinite(mh.evidence[0]):
        raise AssertionError(f"clusterfit: HDF table vs CSV: samples and logz equal {same}, launches cluster {nh} vs "
                             f"{nc}, kernel B {bh} vs {bc}, logz {mh.evidence}")
    secs["clusterfit"] = time.perf_counter() - t0
    rec["clusterfit"] = dict(logz=mh.evidence[0], cluster_launches=nh, interp_launches=bh)
    print(f"[hdf5] clusterfit {json.dumps({k: v for k, v in HDF5_CLUSTER.items() if k != 'dtype'})} float32 from the "
          f"{len(sim)}-star table in pandas' fixed layout: samples and logz ({mh.evidence[0]:.4f}) bitwise those from "
          f"its CSV; cluster kernel launches {nh} = {nc}, kernel B {bh} = {bc} ({secs['clusterfit']:.2f} s)")

    # ---- (c) the fit-catalog CLI from an HDF table in pandas' table layout, deflated, against the CSV
    t0 = time.perf_counter()
    paths = {"csv": _write_csv(os.path.join(workdir, "hdf5_catalog.csv"), table),
             "h5": os.path.join(workdir, "hdf5_catalog.h5")}
    hdf5.write(paths["h5"], pandas_frame_tree(table, table_format=True, deflate=6))
    launches = {}
    for kind, path in paths.items():
        catalog_lnpost_cuda.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = fit_catalog_main(HDF5_CATALOG_CLI + ["--device", str(dev), path, "-O", f"{path}.fit.csv"])
        torch.cuda.synchronize()
        launches[kind] = catalog_lnpost_cuda.launches
        if rc != 0:
            raise AssertionError(f"fit-catalog on the {kind} table: exit {rc}")
    same = filecmp.cmp(f"{paths['csv']}.fit.csv", f"{paths['h5']}.fit.csv", shallow=False)
    if not same or launches["csv"] != launches["h5"] or launches["h5"] <= 0:
        raise AssertionError(f"fit-catalog: HDF table vs CSV: outputs equal {same}, kernel E launches {launches}")
    secs["fit_catalog"] = time.perf_counter() - t0
    rec["fit_catalog"] = dict(stars=len(next(iter(table.values()))), launches=launches["h5"],
                              bytes_h5=os.path.getsize(paths["h5"]), bytes_csv=os.path.getsize(paths["csv"]))
    print(f"[hdf5] fit-catalog {' '.join(HDF5_CATALOG_CLI)} on phase 17's {rec['fit_catalog']['stars']}-star table in "
          f"pandas' table layout, deflated ({rec['fit_catalog']['bytes_h5']} bytes, the CSV "
          f"{rec['fit_catalog']['bytes_csv']}): output bitwise that from the CSV, kernel E launches {launches['h5']} = "
          f"{launches['csv']} ({secs['fit_catalog']:.2f} s)")

    # ---- (d) the convergent harness stopped after one chunk and resumed from its checkpoint
    t0 = time.perf_counter()
    model = BinaryStarModel(ic32, name="hdf5-resume", **star_observations(ic64))
    runs, counts = {}, {}
    for label, steps in (("whole", [2]), ("stopped", [1, 1])):
        star_lnlike_cuda.launches = 0
        chains = os.path.join(workdir, f"hdf5_chains_{label}")
        for maxiter in steps:
            df = fit_mcmc_convergent(model, sample_directory=chains, resultsdir=os.path.join(workdir, "hdf5_results"),
                                     maxiter=maxiter, **HDF5_CONVERGENT)
        torch.cuda.synchronize()
        ckpt = hdf5.File(os.path.join(chains, "hdf5-resume.h5"))
        runs[label], counts[label] = (dict(df), ckpt["chain"], ckpt["ln_prob"]), star_lnlike_cuda.launches
    (dw, cw, lw), (ds, cs, ls) = runs["whole"], runs["stopped"]
    same = (list(dw) == list(ds) and all(np.array_equal(dw[c], ds[c]) for c in dw) and np.array_equal(cw, cs)
            and np.array_equal(lw, ls))
    if not same or counts["whole"] != counts["stopped"] or cw.shape[0] != 2 * HDF5_CONVERGENT["iter_chunksize"]:
        raise AssertionError(f"fit_mcmc_convergent resumed from its HDF5 checkpoint: bitwise {same}, kernel A "
                             f"launches {counts}, chain {cw.shape} vs {cs.shape}")
    secs["convergent_resume"] = time.perf_counter() - t0
    rec["convergent_resume"] = dict(launches=counts["stopped"], chain=list(cw.shape))
    print(f"[hdf5] fit_mcmc_convergent {json.dumps(HDF5_CONVERGENT)} stopped after one chunk and resumed from "
          f"its HDF5 checkpoint: samples, chain {list(cw.shape)} and ln_prob bitwise the uninterrupted run's, kernel "
          f"A launches {counts['stopped']} = {counts['whole']} ({secs['convergent_resume']:.2f} s)")
    rec["seconds"] = secs
    print(f"[hdf5] phase 29 on {smi}: seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}; save_hdf "
          f"{rec['binary']['save_hdf_ms']:.3f} ms, load_hdf {rec['binary']['load_hdf_ms']:.3f} ms for the binary "
          f"fit's {rec['binary']['draws']} draws ({rec['binary']['bytes']} bytes); launches: cluster kernel "
          f"{rec['clusterfit']['cluster_launches']} and kernel B {rec['clusterfit']['interp_launches']} a clusterfit, "
          f"kernel E {rec['fit_catalog']['launches']} a fit-catalog run, kernel A {rec['convergent_resume']['launches']} "
          f"in the resumed harness")
    return rec


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of isochrones_torch on one CUDA card.")
    ap.add_argument("--parent-csrc", default=None, metavar="DIR",
                    help="a directory holding the parent commit's csrc/ (its *.cu and interp_common.cuh): "
                         "phases 25a and 26 time its kernels A', B, B' and C' in turns beside these")
    args = ap.parse_args(argv)

    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    import isochrones_torch
    from isochrones_torch.catalog import read_csv
    from isochrones_torch.ops import _build
    from isochrones_torch.ops.cluster import cluster_lnmarginal_plain
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print("[device] nvidia-smi name, power.limit:")
    print(smi)

    # ---- 2. build
    path, secs, log = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} built in {secs:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    parent = None
    if args.parent_csrc:
        from scripts.compare_torch_kernels import Baseline

        parent = Baseline.build(args.parent_csrc)
        print(f"[build] the parent's kernels from {args.parent_csrc} built in {parent.seconds:.3f} s")
        for line in parent.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] parent {line.strip()}")

    # ---- 3. kernel against the plain version
    times = {}
    main_err = None
    for S, E, B in KERNEL_SHAPES:
        inputs = make_kernel_inputs(S, E, B, W_KERNEL, seed=S + E + B)
        a64, kw64 = to_torch(inputs, dev, torch.float64)
        ref64 = cluster_lnmarginal_plain(*a64, **kw64).cpu().numpy()
        got64 = cluster_lnmarginal_cuda(*a64, **kw64).cpu().numpy()
        err64 = check_close(f"f64 kernel {S, E, B}", got64, ref64, RTOL_F64)
        in32 = as_float32(inputs)
        a32, kw32 = to_torch(in32, dev, torch.float32)
        a32up, kw32up = to_torch(in32, dev, torch.float64)
        ref32 = cluster_lnmarginal_plain(*a32up, **kw32up).cpu().numpy()
        got32 = cluster_lnmarginal_cuda(*a32, **kw32).cpu().numpy()
        err32 = check_close(f"f32 kernel {S, E, B}", got32, ref32, RTOL_F32, ATOL_F32)
        n_fin = int(np.isfinite(ref64).sum())
        print(f"[kernel] S={S} E={E} B={B} W={W_KERNEL}: f64 max_abs_err {err64:.3e} (rtol {RTOL_F64}), "
              f"f32 max_abs_err {err32:.3e} (rtol {RTOL_F32} atol {ATOL_F32}), "
              f"{n_fin}/{ref64.size} finite")
        if (S, E, B) == KERNEL_SHAPES[0]:
            gotj = cluster_lnmarginal_cuda(*a64, q_jacobian=True, **kw64).cpu().numpy()
            refj = cluster_lnmarginal_plain(*a64, q_jacobian=True, **kw64).cpu().numpy()
            errj = check_close("f64 kernel q_jacobian", gotj, refj, RTOL_F64)
            print(f"[kernel] q_jacobian=True S={S} E={E} B={B}: f64 max_abs_err {errj:.3e}")
        if E >= 700:
            ms = kernel_ms(lambda: cluster_lnmarginal_cuda(*a32, **kw32), "cluster_marginal", reps=20)
            plain_ms = cuda_ms(lambda: cluster_lnmarginal_plain(*a32, **kw32), reps=3, warmup=1)
            ms64 = kernel_ms(lambda: cluster_lnmarginal_cuda(*a64, **kw64), "cluster_marginal", reps=5)
            bound_ms, bound_by, what = bound(*cluster_work(a32, kw32), "float32")
            times[(S, E, B)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"[kernel] time S={S} E={E} B={B} W={W_KERNEL}: kernel f32 {ms:.4f} ms, "
                  f"plain f32 {plain_ms:.4f} ms, kernel f64 {ms64:.4f} ms; f32 bound {bound_ms:.4f} ms "
                  f"({what}), kernel at {bound_ms / ms:.3f} of it")
        if (S, E, B) == MAIN_SHAPE:
            main_err = err32

    # ---- 4. the slice at full size
    t0 = time.perf_counter()
    ic32 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    ic64 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float64, **GRID)
    torch.cuda.synchronize()
    print(f"[slice] MIST-scale synthetic grids (f32 + f64) on the card in {time.perf_counter() - t0:.2f} s")
    data = read_csv(FIXTURE)
    model32 = isochrones_torch.StarClusterModel(ic32, data, **MODEL)
    model64 = isochrones_torch.StarClusterModel(ic64, data, **MODEL)
    print(f"[slice] {len(model32.stars)} stars, bands {model32.bands}, ladder {model32._n_ladder} points")
    lp_truth = model32.lnpost(TRUTH)
    if not np.isfinite(lp_truth):
        raise AssertionError(f"lnpost at the truth is not finite: {lp_truth}")
    rng = np.random.default_rng(0)
    p16 = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(16, 7))

    cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
    lp32 = model32.lnpost_batch(p16)
    torch.cuda.synchronize()
    n_slice, n_slice_interp = cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches
    if n_slice <= 0 or n_slice_interp != INTERP_PER_CLUSTER_CALL:
        raise AssertionError(f"lnpost_batch launched the cluster kernel {n_slice} and kernel B {n_slice_interp} times")
    lp64 = model64.lnpost_batch(p16).cpu().numpy()
    import isochrones_torch.cluster as cluster_mod
    from isochrones_torch.ops.mags import interp_mag_plain

    # the plain path, on the card: the cluster marginal and every lerp
    kernels = cluster_mod.cluster_lnmarginal, cluster_mod.interp_nd, cluster_mod._interp_mag_kernel
    cluster_mod.cluster_lnmarginal, cluster_mod.interp_nd, cluster_mod._interp_mag_kernel = (
        cluster_lnmarginal_plain, plain_interp, interp_mag_plain)
    try:
        plain64 = model64.lnpost_batch(p16).cpu().numpy()
        plain32_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16), reps=2)
    finally:
        cluster_mod.cluster_lnmarginal, cluster_mod.interp_nd, cluster_mod._interp_mag_kernel = kernels
    err_s64 = check_close("slice f64 kernel vs plain", lp64, plain64, RTOL_SLICE_F64)
    err_s32 = check_close("slice f32 kernel vs f64 plain", lp32.cpu().numpy(), plain64,
                          RTOL_SLICE_F32, ATOL_SLICE_F32)
    call_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16), reps=10)
    call8_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16[:8]), reps=10)
    print(f"[slice] lnpost(truth) = {lp_truth:.6f} (f32)")
    print(f"[slice] lnpost_batch 16 walkers: cluster kernel launches {n_slice}, kernel B launches {n_slice_interp}; "
          f"f64 kernels vs f64 plain max_abs_err "
          f"{err_s64:.3e} (rtol {RTOL_SLICE_F64}); f32 kernel vs f64 plain max_abs_err {err_s32:.3e} "
          f"(rtol {RTOL_SLICE_F32} atol {ATOL_SLICE_F32})")
    print(f"[slice] lnpost_batch wall-clock f32: 16 walkers {call_ms:.3f} ms, 8 walkers {call8_ms:.3f} ms "
          f"(plain path, 16 walkers: {plain32_ms:.3f} ms)")

    # ---- 5. the fit
    nburn, niter = 30, 20
    p0 = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(16, 7))
    cluster_lnmarginal_cuda.launches = interp_nd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = model32.fit_mcmc(nwalkers=16, nburn=nburn, niter=niter, p0=p0, seed=3, moves="mixed")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_fit, n_fit_interp = cluster_lnmarginal_cuda.launches, interp_nd_cuda.launches
    lnprob = samples["lnprob"]
    if lnprob.shape != (16 * niter,) or not np.isfinite(lnprob).all():
        raise AssertionError(f"fit lnprob not all finite ({np.isfinite(lnprob).sum()}/{lnprob.size})")
    acc = float(model32.sampler_state.n_accept.sum().item()) / (16 * niter)
    if not acc > 0:
        raise AssertionError("fit accepted no proposal")
    if n_fit <= 0 or n_fit_interp < INTERP_PER_CLUSTER_CALL * n_fit:
        raise AssertionError(f"fit launched the cluster kernel {n_fit} and kernel B {n_fit_interp} times")
    med = {k: float(np.median(v)) for k, v in samples.items() if k != "lnprob"}
    print(f"[fit] 16 walkers x ({nburn} + {niter}) steps, moves mixed: {fit_s:.3f} s, "
          f"{1e3 * fit_s / (nburn + niter):.3f} ms per full ensemble step, kernel launches {n_fit} (kernel B "
          f"{n_fit_interp}), "
          f"acceptance {acc:.3f}, lnprob median {np.median(lnprob):.3f}")
    print(f"[fit] posterior medians {json.dumps({k: round(v, 4) for k, v in med.items()})}")

    # ---- 6. the star kernel against the plain version, full-size tables
    import isochrones_torch.starmodel as star_mod
    from isochrones_torch.ops.star import star_lnlike_fused_plain
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda

    obs = star_observations(ic64)
    bin32 = isochrones_torch.BinaryStarModel(ic32, **obs)
    bin64 = isochrones_torch.BinaryStarModel(ic64, **obs)
    print(f"[star] binary model, bands {bin32.bands}, params {bin32.param_names}, observations "
          f"{json.dumps({k: [round(float(v), 5), float(u)] for k, (v, u) in bin32.kwargs.items()})}")
    lk64, lk32 = bin64._star_likelihood(), bin32._star_likelihood()
    lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    pts = star_points(ic64.model.knots, 2, STAR_BATCH, seed=11)
    pts[STAR_BATCH // 2:] = star_points(ic64.model.knots, 2, STAR_BATCH // 2, seed=12, box=STAR_BOX)
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    p32 = p64.float()
    ref64 = [x.cpu().numpy() for x in star_lnlike_fused_plain(p64, lk64)]
    got64 = [x.cpu().numpy() for x in star_lnlike_cuda(p64, lk64)]
    torch.cuda.synchronize()
    err_k64 = check_star("star kernel f64", got64, ref64, RTOL_STAR_F64)
    ref32 = [x.cpu().numpy() for x in star_lnlike_fused_plain(p32.double(), lk32up)]
    got32 = [x.cpu().numpy() for x in star_lnlike_cuda(p32, lk32)]
    torch.cuda.synchronize()
    err_k32 = check_star("star kernel f32", got32, ref32, RTOL_STAR_F32, ATOL_STAR_F32)
    n_fin = int(np.isfinite(ref64[0]).sum())
    print(f"[star] kernel vs plain, B={STAR_BATCH} N=2 {len(STAR_BANDS)} bands: f64 max_abs_err {err_k64:.3e} "
          f"(rtol {RTOL_STAR_F64}), f32 vs f64 max_abs_err {err_k32:.3e} (rtol {RTOL_STAR_F32} atol "
          f"{ATOL_STAR_F32}); {n_fin}/{STAR_BATCH} ll finite, {int(np.isnan(ref64[0]).sum())} NaN")
    # the nested fit's own batch: n_batch * n_chains walk points per call
    fit_batch = NESTED["n_batch"] * NESTED["n_chains"]
    pf = torch.as_tensor(star_points(ic64.model.knots, 2, fit_batch, seed=14, box=STAR_BOX), device=dev,
                         dtype=torch.float32)
    err_fit = check_star("star kernel f32, fit batch", [x.cpu().numpy() for x in star_lnlike_cuda(pf, lk32)],
                         [x.cpu().numpy() for x in star_lnlike_fused_plain(pf.double(), lk32up)],
                         RTOL_STAR_F32, ATOL_STAR_F32)
    err_fit64 = check_star("star kernel f64, fit batch", [x.cpu().numpy() for x in star_lnlike_cuda(pf.double(), lk64)],
                           [x.cpu().numpy() for x in star_lnlike_fused_plain(pf.double(), lk64)], RTOL_STAR_F64)
    print(f"[star] kernel vs plain, B={fit_batch} (the fit's batch): f64 max_abs_err {err_fit64:.3e}, f32 vs f64 "
          f"max_abs_err {err_fit:.3e}")
    bench32 = torch.as_tensor(star_points(ic64.model.knots, 2, STAR_BATCH, seed=13, box=STAR_BOX), device=dev,
                              dtype=torch.float32)
    bench64 = bench32.double()
    star_ms = kernel_ms(lambda: star_lnlike_cuda(bench32, lk32), "star_lnlike", reps=50)
    star_plain_ms = cuda_ms(lambda: star_lnlike_fused_plain(bench32, lk32), reps=10)
    star_ms64 = kernel_ms(lambda: star_lnlike_cuda(bench64, lk64), "star_lnlike", reps=20)
    star_plain_ms64 = cuda_ms(lambda: star_lnlike_fused_plain(bench64, lk64), reps=5)
    star_bound = bound(*star_work(bench32, lk32), "float32")
    print(f"[star] time B={STAR_BATCH} N=2 bench box: kernel f32 {star_ms:.4f} ms, plain f32 {star_plain_ms:.4f} "
          f"ms, kernel f64 {star_ms64:.4f} ms, plain f64 {star_plain_ms64:.4f} ms; f32 bound {star_bound[0]:.5f} ms "
          f"({star_bound[2]}), kernel at {star_bound[0] / star_ms:.3f} of it")
    fit_ms = kernel_ms(lambda: star_lnlike_cuda(pf, lk32), "star_lnlike", reps=200)
    fit_plain_ms = cuda_ms(lambda: star_lnlike_fused_plain(pf, lk32), reps=20)
    fit_bound = bound(*star_work(pf, lk32), "float32")
    print(f"[star] time B={fit_batch} N=2 (the fit's batch): kernel f32 {fit_ms:.4f} ms, plain f32 "
          f"{fit_plain_ms:.4f} ms; f32 bound {fit_bound[0]:.5f} ms ({fit_bound[2]}), kernel at "
          f"{fit_bound[0] / fit_ms:.3f} of it")

    # ---- 7. the binary slice at full width
    lp_star = bin32.lnpost(STAR_TRUTH)
    if not np.isfinite(lp_star) or not np.isfinite(bin64.lnpost(STAR_TRUTH)):
        raise AssertionError(f"binary lnpost at the truth is not finite: {lp_star}")
    lp_k64 = bin64.lnpost_batch(bench64).cpu().numpy()
    fused_dispatch = star_mod.star_lnlike_fused
    star_mod.star_lnlike_fused = star_lnlike_fused_plain  # the plain path, on the card
    try:
        lp_p64 = bin64.lnpost_batch(bench64).cpu().numpy()
        plain_rate = STAR_BATCH / _wall(lambda: bin32.lnpost_batch(bench32), reps=5)
    finally:
        star_mod.star_lnlike_fused = fused_dispatch
    err_b64 = check_star("binary lnpost_batch f64 kernel vs plain", [lp_k64], [lp_p64], RTOL_STAR_F64)
    kernel_rate = STAR_BATCH / _wall(lambda: bin32.lnpost_batch(bench32), reps=20)
    print(f"[binary] lnpost(truth) = {lp_star:.6f} (f32); {STAR_BATCH}-point lnpost_batch f64 kernel vs plain "
          f"max_abs_err {err_b64:.3e} (rtol {RTOL_STAR_F64}), {int(np.isfinite(lp_p64).sum())} finite")
    print(f"[binary] lnpost_batch f32 throughput: kernel path {kernel_rate:.1f} evals/s, plain path "
          f"{plain_rate:.1f} evals/s")

    # ---- 8. the nested fit (the main path of the slice)
    star_lnlike_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bin32.fit_multinest(**NESTED)
    interp_nd_cuda.launches = 0
    derived = bin32.derived_samples
    torch.cuda.synchronize()
    nest_s = time.perf_counter() - t0
    n_star, n_derived_interp = star_lnlike_cuda.launches, interp_nd_cuda.launches
    if not np.isfinite(res.logz) or res.truncated or n_star <= 0 or n_derived_interp <= 0:
        raise AssertionError(f"nested fit: logz {res.logz}, truncated {res.truncated}, launches {n_star}, kernel B in "
                             f"derived_samples {n_derived_interp}")
    d_lo, d_hi = np.quantile(bin32.samples["distance"], [0.025, 0.975])
    if not d_lo <= STAR_TRUTH[4] <= d_hi:
        raise AssertionError(f"distance 95% interval ({d_lo:.2f}, {d_hi:.2f}) misses {STAR_TRUTH[4]}")
    if not all(np.isfinite(derived[f"{b}_mag"]).all() for b in STAR_BANDS):
        raise AssertionError("derived magnitudes not finite")
    med = {k: round(float(np.median(v)), 4) for k, v in bin32.samples.items() if k != "lnprob"}
    print(f"[nested] fit_multinest {json.dumps({k: v for k, v in NESTED.items()})} f32: {nest_s:.3f} s, "
          f"{res.n_iter} dead points, logz {res.logz:.4f} +- {res.logzerr:.4f}, ESS {res.ess:.1f}, "
          f"kernel launches {n_star}, kernel B launches in derived_samples {n_derived_interp}, posterior_predictive "
          f"{bin32.posterior_predictive:.4f}")
    nested_lnprob = {"binary": np.quantile(bin32.samples["lnprob"], NUTS_LNPROB_Q)}
    print(f"[nested] posterior medians {json.dumps(med)}; distance 95% interval ({d_lo:.3f}, {d_hi:.3f}); lnprob "
          f"quantiles {NUTS_LNPROB_Q} {np.round(nested_lnprob['binary'], 3).tolist()}")

    # ---- 9-12. the tree kernel, the tree model, the entry point
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.environ.get("TMPDIR") or None)
    try:
        tree_record = phase_tree_kernel(dev, ic32, ic64, workdir)
        n_tree, nested_lnprob["tree"] = phase_tree_slice_and_fit(dev, ic32, ic64, workdir)
        del model32, model64, bin32, bin64, ic32
        torch.cuda.empty_cache()
        n_star_cli, n_tree_cli, n_interp_cli = phase_entry_point(dev, workdir)
        # ---- 13-15. EEP inversion, the simulated cluster and its nested fit, the cluster entry point
        ic32 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
        eep_record = phase_eep(dev, ic32, ic64)
        sim, cluster_fit_record, n_cluster_nested = phase_cluster_nested(dev, ic32, ic64)
        n_cluster_cli, n_interp_cluster_cli = phase_cluster_entry_point(sim, workdir)
        # ---- 16-19. the catalog kernel, the catalog fits, their entry point, independent runs
        truths, table, catalog_record = phase_catalog_kernel(dev, ic32, ic64)
        n_cat_mcmc, n_cat_nested, n_cat_dynamic = phase_catalog_fits(dev, ic32, truths, table)
        phase_catalog_entry_point(workdir)
        n_multi = phase_multi_run(dev, ic32, ic64)
        # ---- 20-22. kernel F, the forward model and populations, their entry point
        gen_record = phase_generate_kernel(dev, ic32, ic64)
        n_gen, forward_record = phase_forward_model(dev, ic32)
        phase_generate_entry_point(workdir)
        # ---- 23. get_ichrone("mist") on MIST-format files, the kernels on its grids, the default starfit
        n_star_mist, n_tree_mist, n_gen_mist, mist_record = phase_mist(dev, workdir)
        # ---- 24. IsoTrackModel on those grids: lnpost_batch, both fits, a track-grid results file
        n_isotrack, isotrack_record = phase_isotrack(dev, workdir)
        # ---- 25. the other engines: kernels A' and C', NUTS, PolyChord, the convergent harness
        t25 = time.perf_counter()
        grad_records = phase_grad_kernels(dev, ic32, ic64, workdir, parent)
        nuts_star, nuts_tree = phase_engines(dev, ic32, ic64, workdir, nested_lnprob)
        print(f"[engines] phase 25 took {time.perf_counter() - t25:.1f} s")
        # ---- 26. kernels B and B' against their plain versions, their times, the seismic binary
        t26 = time.perf_counter()
        interp_rec, interp_grad_rec = phase_interp_kernel(dev, ic32, ic64, parent)
        seismic_rec = phase_seismic(dev, ic32, ic64)
        print(f"[interp] phase 26 took {time.perf_counter() - t26:.1f} s")
        # ---- 27. the Gaia-conditioned starfit with its plots, the summarize and select CLIs
        t27 = time.perf_counter()
        fitted = {}
        gaia_rec = phase_results_and_summary(dev, workdir, smi, fitted)
        print(f"[gaia] phase 27 took {time.perf_counter() - t27:.1f} s")
        # ---- 28. the device mesh: shards on the card, the star-sharded cluster and catalogue, a fleet
        t28 = time.perf_counter()
        mesh_rec = phase_parallel(dev, ic32, ic64, sim, table, workdir)
        print(f"[mesh] phase 28 took {time.perf_counter() - t28:.1f} s")
        # ---- 29. the JAX package's HDF5 files: results files, HDF member tables, the MCMC checkpoint
        t29 = time.perf_counter()
        hdf5_rec = phase_hdf5(dev, workdir, ic32, ic64, sim, table, fitted, smi)
        print(f"[hdf5] phase 29 took {time.perf_counter() - t29:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tree_record["launches"] = n_tree
    tree_record["launches_entry_point"] = n_tree_cli
    tree_record["launches_mist_entry_point"] = n_tree_mist
    print(json.dumps({"mist": mist_record}))
    print(json.dumps({"isotrack": isotrack_record}))
    print(json.dumps({"eep_inversion": dict(eep_record, route="cuda (kernel F: the fast, accurate and Newton forms)",
                                            source="isochrones_torch/csrc/generate.cu",
                                            replaces="isochrones_tpu/ops/eep.py:35", dtype="float32")}))

    print(json.dumps({"seismic": seismic_rec}))
    print(json.dumps({"results_and_summary": gaia_rec}))
    print(json.dumps({"mesh": mesh_rec}))
    print(json.dumps({"hdf5": hdf5_rec}))
    interp_rec.update(
        launches=cluster_fit_record.pop("interp_launches_nested_fit"),
        launches_lnpost_batch_fit_batch=cluster_fit_record.pop("interp_launches_fit_batch_call"),
        launches_lnpost_batch_16=n_slice_interp, launches_mcmc_fit=n_fit_interp,
        launches_clusterfit_cli=n_interp_cluster_cli, launches_starfit_cli=n_interp_cli,
        launches_derived_samples=n_derived_interp, launches_seismic_nuts=seismic_rec["launches_b"],
        cluster_lnpost_batch_ms_fit_batch=cluster_fit_record["lnpost_batch_ms_fit_batch"],
        cluster_lnpost_batch_kernels_fit_batch=cluster_fit_record["lnpost_batch_kernels_fit_batch"],
        cluster_lnpost_batch_idle_fit_batch=cluster_fit_record["lnpost_batch_idle_fit_batch"],
        cluster_nested_fit_seconds=cluster_fit_record["nested_fit_seconds"],
        launches_gaia_starfit=gaia_rec["launches_b"],
        launches_mesh=mesh_rec["cluster"]["fits"]["mesh"]["interp_launches"],
        launches_mesh_call=mesh_rec["cluster"]["float32"]["interp_launches_call"],
        launches_hdf5_clusterfit=hdf5_rec["clusterfit"]["interp_launches"])
    interp_grad_rec.update(launches=seismic_rec["launches_b_grad"])
    ms, plain_ms, bound_ms, bound_by = times[MAIN_SHAPE]
    kernels_line = [{
        "name": "cluster_marginal", "route": "cuda",
        "source": "isochrones_torch/csrc/cluster_marginal.cu",
        "replaces": "isochrones_tpu/ops/cluster_pallas.py:78",
        "launches": n_fit, "launches_clusterfit_cli": n_cluster_cli, "max_abs_err": main_err, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": {"W": W_KERNEL, "S": MAIN_SHAPE[0], "E": MAIN_SHAPE[1], "B": MAIN_SHAPE[2], "dtype": "float32"},
        "launches_nested_fit": n_cluster_nested, **cluster_fit_record,
        "launches_mesh": mesh_rec["cluster"]["fits"]["mesh"]["launches"],
        "launches_mesh_call": mesh_rec["cluster"]["float32"]["launches_call"],
        "launches_hdf5_clusterfit": hdf5_rec["clusterfit"]["cluster_launches"],
    }, {
        "name": "star_lnlike", "route": "cuda",
        "source": "isochrones_torch/csrc/star_lnlike.cu",
        "replaces": "isochrones_tpu/starmodel.py:430",
        "launches": n_star, "max_abs_err": err_k32, "ms": star_ms, "plain_ms": star_plain_ms,
        "bound_ms": star_bound[0], "bound_by": star_bound[1], "library_ms": None,
        "shape": {"B": STAR_BATCH, "N": 2, "bands": len(STAR_BANDS), "dtype": "float32"},
        "ms_fit_batch": fit_ms, "plain_ms_fit_batch": fit_plain_ms, "bound_ms_fit_batch": fit_bound[0],
        "fit_batch": fit_batch, "launches_entry_point": n_star_cli, "launches_multi_run": n_multi,
        "launches_mist_entry_point": n_star_mist, "ms_mist_grid": mist_record["star_ms"],
        "launches_isotrack": n_isotrack, "ms_isotrack_batch": isotrack_record["call"][1024]["star_ms"],
        "launches_gaia_starfit": gaia_rec["launches_a"],
        "launches_mesh": mesh_rec["star"]["launches_mesh"], "ms_mesh_4_shards": mesh_rec["star"]["ms_mesh"],
        "launches_mesh_nuts": mesh_rec["nuts"]["launches_mesh"],
        "launches_hdf5_reload": hdf5_rec["single"]["launches_a"] + hdf5_rec["binary"]["launches_a"],
        "launches_hdf5_convergent": hdf5_rec["convergent_resume"]["launches"],
    }, tree_record, {
        "name": "catalog_lnlike", "route": "cuda",
        "source": "isochrones_torch/csrc/catalog_lnlike.cu",
        "replaces": "isochrones_tpu/batch.py:145",
        "launches": n_cat_mcmc + n_cat_nested + n_cat_dynamic, "launches_mcmc_fit": n_cat_mcmc,
        "launches_nested_fit": n_cat_nested, "launches_dynamic_fit": n_cat_dynamic,
        "library_ms": None, **catalog_record, "launches_mesh": mesh_rec["catalog"]["launches_mesh"],
        "launches_hdf5_fit_catalog": hdf5_rec["fit_catalog"]["launches"],
    }, {
        "name": "generate", "route": "cuda",
        "source": "isochrones_torch/csrc/generate.cu",
        "replaces": "isochrones_tpu/models/interpolator.py:109",
        "launches": n_gen, "library_ms": None, **gen_record, **forward_record,
        "launches_mist_entry_point": n_gen_mist, "ms_mist_grid": mist_record["generate_ms"],
    }]
    print(json.dumps({"engines": {"nuts_binary": nuts_star, "nuts_tree": nuts_tree}}))
    grad_records["star_lnlike_grad"].update(
        launches=nuts_star["binary f32"]["launches_backward"],
        launches_f64_fit=nuts_star["binary f64"]["launches_backward"],
        launches_mesh=mesh_rec["nuts"]["launches_backward_mesh"])
    grad_records["tree_lnlike_grad"].update(launches=nuts_tree["launches_backward"])
    kernels_line.extend([grad_records["star_lnlike_grad"], grad_records["tree_lnlike_grad"], interp_rec,
                         interp_grad_rec])
    print(json.dumps({"kernels": kernels_line}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def _wall(fn, reps):
    """Mean host seconds per call of work that ends in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


if __name__ == "__main__":
    sys.exit(main())
