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
   (50, 700, 3) and (50, 1710, 3) with W = 8 walkers, in float64 and float32,
   with times;
4. slice: the 50-star cluster model on the MIST-scale synthetic grid in
   float32 (the fit's settings): lnpost at the truth, one 16-walker
   ``lnpost_batch`` through the kernel against the plain path in float64;
5. fit: ``fit_mcmc`` with 16 walkers, 30 burn-in + 20 steps, moves "mixed";
   every lnprob finite, acceptance above 0, the kernel launched.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

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
#: relative, so 1e-4 relative (1e-3 absolute near 0) holds with margin
RTOL_F32, ATOL_F32 = 1e-4, 1e-3
#: float32 slice vs float64 plain slice: the grid itself is rounded to
#: float32, shifting model magnitudes by ~1e-6 mag; with 0.02 mag errors each
#: of 50 stars moves by ~1e-3 nats, so 0.05 nats + 1e-4 relative
RTOL_SLICE_F32, ATOL_SLICE_F32 = 1e-4, 0.05
RTOL_SLICE_F64 = 1e-9

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
            ms = cuda_ms(lambda: cluster_lnmarginal_cuda(*a32, **kw32), reps=20)
            plain_ms = cuda_ms(lambda: cluster_lnmarginal_plain(*a32, **kw32), reps=3, warmup=1)
            ms64 = cuda_ms(lambda: cluster_lnmarginal_cuda(*a64, **kw64), reps=5)
            times[(S, E, B)] = (ms, plain_ms)
            print(f"[kernel] time S={S} E={E} B={B} W={W_KERNEL}: kernel f32 {ms:.4f} ms, "
                  f"plain f32 {plain_ms:.4f} ms, kernel f64 {ms64:.4f} ms")
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

    ms, plain_ms = times[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "cluster_marginal", "route": "cuda",
        "source": "isochrones_torch/csrc/cluster_marginal.cu",
        "replaces": "isochrones_tpu/ops/cluster_pallas.py:78",
        "launches": n_fit, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
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
