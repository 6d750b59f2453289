"""Smoke run of the PyTorch/CUDA port (``isochrones_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

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
   ``lnpost_batch`` through the kernel against the plain path in float64;
5. fit: ``fit_mcmc`` with 16 walkers, 30 burn-in + 20 steps, moves "mixed";
   every lnprob finite, acceptance above 0, the kernel launched;
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
   n_chains=16)`` in float32, then ``derived_samples``; logz finite, the run
   not truncated, the kernel launched, and the distance posterior's 2.5-97.5%
   interval holding the true 200 pc.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
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


def profile_kernels(fn, reps=1):
    """Run ``fn`` ``reps`` times under ``torch.profiler``; returns ``(wall
    seconds, {kernel name: (device ms, launches)})`` over the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall, by_name


def kernel_ms(fn, name, reps, warmup=2):
    """Mean device milliseconds per call of the kernels whose name holds
    ``name``, over ``reps`` calls: the kernels' own time, without launch gaps
    or the wrapper's torch ops."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = sum(t for k, (t, _) in profile_kernels(fn, reps)[1].items() if name in k)
    if not ms > 0:
        raise AssertionError(f"the profiler saw no {name} kernel")
    return ms / reps


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


def main():
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    import isochrones_torch
    from isochrones_torch.catalog import read_csv
    from isochrones_torch.ops import _build
    from isochrones_torch.ops.cluster import cluster_lnmarginal_plain
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda

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

    cluster_lnmarginal_cuda.launches = 0
    lp32 = model32.lnpost_batch(p16)
    torch.cuda.synchronize()
    n_slice = cluster_lnmarginal_cuda.launches
    if n_slice <= 0:
        raise AssertionError("lnpost_batch did not launch the cluster kernel")
    lp64 = model64.lnpost_batch(p16).cpu().numpy()
    import isochrones_torch.cluster as cluster_mod

    kernel_dispatch = cluster_mod.cluster_lnmarginal
    cluster_mod.cluster_lnmarginal = cluster_lnmarginal_plain  # the plain path, on the card
    try:
        plain64 = model64.lnpost_batch(p16).cpu().numpy()
        plain32_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16), reps=2)
    finally:
        cluster_mod.cluster_lnmarginal = kernel_dispatch
    err_s64 = check_close("slice f64 kernel vs plain", lp64, plain64, RTOL_SLICE_F64)
    err_s32 = check_close("slice f32 kernel vs f64 plain", lp32.cpu().numpy(), plain64,
                          RTOL_SLICE_F32, ATOL_SLICE_F32)
    call_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16), reps=10)
    call8_ms = 1e3 * _wall(lambda: model32.lnpost_batch(p16[:8]), reps=10)
    print(f"[slice] lnpost(truth) = {lp_truth:.6f} (f32)")
    print(f"[slice] lnpost_batch 16 walkers: kernel launches {n_slice}; f64 kernel vs f64 plain max_abs_err "
          f"{err_s64:.3e} (rtol {RTOL_SLICE_F64}); f32 kernel vs f64 plain max_abs_err {err_s32:.3e} "
          f"(rtol {RTOL_SLICE_F32} atol {ATOL_SLICE_F32})")
    print(f"[slice] lnpost_batch wall-clock f32: 16 walkers {call_ms:.3f} ms, 8 walkers {call8_ms:.3f} ms "
          f"(plain path, 16 walkers: {plain32_ms:.3f} ms)")

    # ---- 5. the fit
    nburn, niter = 30, 20
    p0 = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(16, 7))
    cluster_lnmarginal_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = model32.fit_mcmc(nwalkers=16, nburn=nburn, niter=niter, p0=p0, seed=3, moves="mixed")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_fit = cluster_lnmarginal_cuda.launches
    lnprob = samples["lnprob"]
    if lnprob.shape != (16 * niter,) or not np.isfinite(lnprob).all():
        raise AssertionError(f"fit lnprob not all finite ({np.isfinite(lnprob).sum()}/{lnprob.size})")
    acc = float(model32.sampler_state.n_accept.sum().item()) / (16 * niter)
    if not acc > 0:
        raise AssertionError("fit accepted no proposal")
    if n_fit <= 0:
        raise AssertionError("fit did not launch the cluster kernel")
    med = {k: float(np.median(v)) for k, v in samples.items() if k != "lnprob"}
    print(f"[fit] 16 walkers x ({nburn} + {niter}) steps, moves mixed: {fit_s:.3f} s, "
          f"{1e3 * fit_s / (nburn + niter):.3f} ms per full ensemble step, kernel launches {n_fit}, "
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
    derived = bin32.derived_samples
    torch.cuda.synchronize()
    nest_s = time.perf_counter() - t0
    n_star = star_lnlike_cuda.launches
    if not np.isfinite(res.logz) or res.truncated or n_star <= 0:
        raise AssertionError(f"nested fit: logz {res.logz}, truncated {res.truncated}, launches {n_star}")
    d_lo, d_hi = np.quantile(bin32.samples["distance"], [0.025, 0.975])
    if not d_lo <= STAR_TRUTH[4] <= d_hi:
        raise AssertionError(f"distance 95% interval ({d_lo:.2f}, {d_hi:.2f}) misses {STAR_TRUTH[4]}")
    if not all(np.isfinite(derived[f"{b}_mag"]).all() for b in STAR_BANDS):
        raise AssertionError("derived magnitudes not finite")
    med = {k: round(float(np.median(v)), 4) for k, v in bin32.samples.items() if k != "lnprob"}
    print(f"[nested] fit_multinest {json.dumps({k: v for k, v in NESTED.items()})} f32: {nest_s:.3f} s, "
          f"{res.n_iter} dead points, logz {res.logz:.4f} +- {res.logzerr:.4f}, ESS {res.ess:.1f}, "
          f"kernel launches {n_star}, posterior_predictive {bin32.posterior_predictive:.4f}")
    print(f"[nested] posterior medians {json.dumps(med)}; distance 95% interval ({d_lo:.3f}, {d_hi:.3f})")

    ms, plain_ms, bound_ms, bound_by = times[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "cluster_marginal", "route": "cuda",
        "source": "isochrones_torch/csrc/cluster_marginal.cu",
        "replaces": "isochrones_tpu/ops/cluster_pallas.py:78",
        "launches": n_fit, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": {"W": W_KERNEL, "S": MAIN_SHAPE[0], "E": MAIN_SHAPE[1], "B": MAIN_SHAPE[2], "dtype": "float32"},
    }, {
        "name": "star_lnlike", "route": "cuda",
        "source": "isochrones_torch/csrc/star_lnlike.cu",
        "replaces": "isochrones_tpu/starmodel.py:430",
        "launches": n_star, "max_abs_err": err_k32, "ms": star_ms, "plain_ms": star_plain_ms,
        "bound_ms": star_bound[0], "bound_by": star_bound[1], "library_ms": None,
        "shape": {"B": STAR_BATCH, "N": 2, "bands": len(STAR_BANDS), "dtype": "float32"},
        "ms_fit_batch": fit_ms, "plain_ms_fit_batch": fit_plain_ms, "bound_ms_fit_batch": fit_bound[0],
        "fit_batch": fit_batch,
    }]}))
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
