// The forward model: (mass, age, feh, distance, AV) -> (EEP, model columns,
// magnitudes), and the EEP inversions, one thread a point.
//
// Replaces the JAX package's fused forward model, _generate_g
// (isochrones_tpu/models/interpolator.py:109-156), which XLA compiles into one
// TPU program, and its accurate EEP inversion, get_eep_newton
// (isochrones_tpu/ops/eep.py:128-180). For each point it
//
//   1. inverts (mass, age, feh) to an EEP on the evolution tracks
//      (isochrones_tpu/ops/eep.py::interp_eep): locates [Fe/H] and mass among
//      the track knots (searchsorted), finds the age in each of the four
//      corner tracks' +inf-padded age rows by searchsorted_rows' fixed-step
//      bisection, substitutes a neighbour for a corner past its track's end
//      in the reference's order, and blends the four integer EEPs
//      bilinearly; NaN for a NaN or out-of-bounds input and for an age past
//      a full-length track;
//   2. in the accurate forms, refines that EEP by get_eep_newton's 12 damped
//      Newton steps on the age column (the seed clamped to the EEP knots, the
//      best of a 33-point scan of the EEP axis where the seed has no finite
//      residual, the step r / g clipped to +-32, the iterate clamped to the
//      knots and kept where the new one is not finite), with the slope g in
//      the closed form autograd takes (interp_common.cuh::lerp_slope), and
//      cuts it to NaN where the final residual is not finite or resid_tol or
//      more; the Newton form alone does the same from given seeds on any 3-d
//      grid whose last axis is the EEP (the isochrone grid's initial mass);
//   3. locates the cell of (feh, mass, eep) on the 3 model-grid axes once and
//      lerps the 8 corner rows of a packed copy of the model table (every
//      column, Teff, logg, feh and Mbol first, rows padded to 16 bytes;
//      ops/generate_cuda.py::packed_model), read as 16-byte vectors up to the
//      last column the call wants (one vector for the magnitudes alone); the
//      columns asked for are picked from the lerped row through shared memory;
//   4. locates the cell of (Teff, logg, feh, AV) on the 4 BC-grid axes and
//      lerps the band columns of the 16 corner rows, from a compact copy of
//      the BC table 4, 8, 12 or 16 columns wide, read as 16-byte vectors;
//   5. forms mag = Mbol + 5 log10(d / 10) - BC; with all_As once more at
//      AV = 0, reusing step 3's lerp (the JAX program recomputes it; the
//      numbers are the same).
//
// Six instantiations of one body (Mode): the fast inversion with the forward
// model (generate), the EEP given (generate(eeps=...)), the fast EEP alone
// (get_eep), the accurate inversion with the forward model
// (generate(accurate=True), model_mag), the accurate EEP alone on a track
// grid, and the Newton step from given seeds (the isochrone grid's get_eep).
//
// Semantics are those of the plain version (isochrones_torch/ops/generate.py,
// ops/eep.py, ops/interp.py, ops/mags.py), through interp_common.cuh: cell
// location step for step, every corner's product in the sum (weight 0
// included, so a NaN-padded neighbour poisons the lerp as IEEE 0 * NaN does in
// torch), _pin_top and the exact_affine fix-up. The EEP blend
// (1 - d1) * e00 + d1 * e01 is written with __f*_rn / __d*_rn: eager torch
// never contracts it into a fused multiply-add, nvcc would, and one unit in
// the last place decides at a track's last valid EEP whether the lerp reads
// the NaN-padded neighbour. The fast EEP equals the plain version's bitwise;
// the Newton step's arithmetic is rounded as torch rounds it (_rn), its sums
// in another order. The track lengths are int64 and compared with the int64
// insertion indices, as torch compares them.
//
// What bounds it: not the bytes (a point reads its 5 inputs and writes 1 +
// P + n_bands values; the rows it gathers are a few hundred bytes) and not
// the chain of dependent reads (a few L2 round trips a point, hidden by the
// warps in flight) but the number of memory transactions: every load of a
// gathered row is a warp-wide instruction whose 32 lanes touch 32 different
// sectors. So the corner rows come as 16-byte vectors from packed tables (4
// loads a float32 model row of 16 columns where there were 19 scalar loads,
// 1 where only the magnitudes are wanted; 3 a BC row of 12 where there were
// 8 pairs of 16), and the
// strided output rows are staged in shared memory and written out as
// contiguous 16-byte vectors, a warp's 32 rows at a time. The Newton step
// reads the matched column from a contiguous copy (a corner's two EEP
// neighbours adjacent; reading them as one pair measured no faster). One
// lane a point, as the catalog kernel measured (PERF.md):
// more lanes a point would repeat the cell location and not cut the
// transactions. No tensor cores: there is no matrix product. Every lane of a
// warp reaches every shuffle and vote of the cell location and every
// __syncwarp of the staging: lanes past the batch take a NaN point and stay;
// only a warp wholly past the batch leaves. 64-bit row offsets; float and
// double.
//
// GEN_PART cuts the body for scripts/tune_torch_generate.py, which builds
// this file (with generate_f64.cu) alone to time the parts apart: 1 the EEP alone (the inversion,
// with the accurate forms the Newton step), 2 also the model lerp and its
// stores, 3 (the library's build) everything.

#include "interp_common.cuh"

#ifndef GEN_PART
#define GEN_PART 3
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxCols = 32;  // the packed model row
constexpr int kScan = 33;     // get_eep_newton's scan of the EEP axis


enum Mode : int { kInvert = 0, kGiven = 1, kEepOnly = 2, kAccurate = 3, kAccurateEep = 4, kNewton = 5 };

struct GenerateArgs {
  const void* in[5];        // mass, age, feh, distance, AV (kNewton: target, x0, x1, seed): N values each,
                            // element strides `stride`
  const void* eeps_in;      // (N,) contiguous EEPs (kGiven)
  const void* model;        // (m0, m1, m2, row_len) packed model table
  const void* bc;           // (b0, b1, b2, b3, bc_ncols) compact BC table, or null without bands
  const void* age_rows;     // (n_tracks, n_eep) track ages, +inf past each track's end
  const void* lengths;      // (n_tracks,) int64 track lengths
  const void* newton_col;   // (n0, n1, n2) the column the Newton step matches, contiguous
  const void* scan;         // (33,) the scan's EEPs: linspace(first, last EEP knot, 33)
  void* eep;                // (N,) out (every form but kGiven)
  void* props;              // (N, P) out
  void* mags;               // (N, n_bands) out
  void* mags0;              // (N, n_bands) out at AV = 0, or null
  long long stride[5];
  long long N;
  long long n_eep;          // the age rows' length
  long long n_tracks;
  double eep0;              // the first EEP knot
  double resid_tol;         // the accurate forms' cut
  int io[3];                // model axis d takes column io[d] of (mass, eep, feh)
  int n_steps;              // bisection steps: ceil(log2(max(n_eep, 2))) + 1
  int row_len;              // the packed model row's width, a multiple of 4; Teff, logg, feh, Mbol first
  int read_len;             // the lerped part of the row: its first read_len columns, a multiple of 4
  int P;                    // columns asked for
  int prop_cols[kMaxCols];  // their places in the packed row, each below read_len
  int n_bands;
  int bc_ncols;             // W: 4, 8, 12 or 16, at least n_bands
  int n_iter;               // Newton steps
  Axis inv_ax[2];           // the tracks' [Fe/H] and mass knots (searchsorted)
  Axis model_ax[3];
  Axis bc_ax[4];
  Axis newton_ax[3];        // the Newton grid's axes, the EEP last
};

template <typename T>
__device__ __forceinline__ T input(const GenerateArgs& a, int k, long long i) {
  return static_cast<const T*>(a.in[k])[i * a.stride[k]];
}

// torch.clamp: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_nan(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ops/eep.py::interp_eep for one point (NaN inputs, out-of-bounds [Fe/H] or
// mass and an age past a full-length track give NaN); every lane of the warp
// calls it (the knot searches vote)
template <typename T>
__device__ T invert(const GenerateArgs& a, T mass, T age, T feh) {
  AxisReads<T> rf, rm;
  locate_reads<T, 1>(a.inv_ax[0], feh, 0, rf);
  locate_reads<T, 1>(a.inv_ax[1], mass, 0, rm);
  const bool bad = isnan(age) || isnan(feh) || isnan(mass) || feh < rf.first || feh > rf.last ||
                   mass < rm.first || mass > rm.last;
  long long c0, c1;
  T d0, d1;
  locate_finish<T, 1>(a.inv_ax[0], feh, bad, 0, rf, c0, d0);
  locate_finish<T, 1>(a.inv_ax[1], mass, bad, 0, rm, c1, d1);
  if (bad) return T(NAN);
  const long long n_feh = a.inv_ax[0].n, n_mass = a.inv_ax[1].n;
  c0 = clampll(c0, 0, n_feh - 1);
  c1 = clampll(c1, 0, n_mass - 1);
  const long long c0p = clampll(c0 + 1, 0, n_feh - 1), c1p = clampll(c1 + 1, 0, n_mass - 1);
  const long long ind[4] = {c0 * n_mass + c1, c0 * n_mass + c1p, c0p * n_mass + c1, c0p * n_mass + c1p};

  // searchsorted_rows: the four lower bounds, one bisection step of each in turn
  const T* rows = static_cast<const T*>(a.age_rows);
  const long long last = a.n_tracks * a.n_eep - 1;
  long long lo[4] = {0, 0, 0, 0}, hi[4] = {a.n_eep, a.n_eep, a.n_eep, a.n_eep};
  for (int s = 0; s < a.n_steps; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long mid = (lo[k] + hi[k]) / 2;
      const long long idx = ind[k] * a.n_eep + mid;
      // once the interval has closed on n_eep the step reads the next row's
      // first entry (past the last row nothing), as the plain version does
      const bool pred = __ldg(rows + (idx < last ? idx : last)) < age && idx <= last;
      lo[k] = pred ? mid + 1 : lo[k];
      hi[k] = pred ? hi[k] : mid;
    }
  }
  bool past = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) past = past || lo[k] >= a.n_eep;  // past a full-length track
  if (past) return T(NAN);

  const long long* len = static_cast<const long long*>(a.lengths);
  T e[4];
  bool inv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = add_rn(T(lo[k]), T(a.eep0));
    inv[k] = lo[k] >= __ldg(len + ind[k]);
  }
  // the end-of-track substitution in sequence: e01 takes the substituted e00
  e[0] = inv[0] ? e[1] : e[0];
  e[1] = inv[1] ? e[0] : e[1];
  e[2] = inv[2] ? e[3] : e[2];
  e[3] = inv[3] ? e[2] : e[3];
  const T lo_m = add_rn(mul_rn(sub_rn(T(1), d1), e[0]), mul_rn(d1, e[1]));
  const T hi_m = add_rn(mul_rn(sub_rn(T(1), d1), e[2]), mul_rn(d1, e[3]));
  return add_rn(mul_rn(sub_rn(T(1), d0), lo_m), mul_rn(d0, hi_m));
}

// The Newton step's fixed part at one point: the cells of (x0, x1) on the
// grid's first two axes, located once, as the 4 (o0, o1) corners' weights
// (1 * f0) * f1 and their offsets in the (n0, n1, n2) column
template <typename T>
struct NewtonPoint {
  T w[4];
  long long base[4];
  bool bad;  // x0 or x1 NaN or out of bounds
  // the corner values of the EEP cell last read (cell -1: none yet): an
  // iterate that stays in its cell reads nothing again
  long long cell;
  T lo[4], hi[4];
};

template <typename T>
__device__ __forceinline__ void newton_setup(const GenerateArgs& a, T x0, T x1, NewtonPoint<T>& p) {
  AxisReads<T> r0, r1;
  locate_reads<T, 1>(a.newton_ax[0], x0, 0, r0);
  locate_reads<T, 1>(a.newton_ax[1], x1, 0, r1);
  p.bad = isnan(x0) || isnan(x1) || x0 < r0.first || x0 > r0.last || x1 < r1.first || x1 > r1.last;
  long long c0, c1;
  T t0, t1;
  locate_finish<T, 1>(a.newton_ax[0], x0, p.bad, 0, r0, c0, t0);
  locate_finish<T, 1>(a.newton_ax[1], x1, p.bad, 0, r1, c1, t1);
  const long long n0 = a.newton_ax[0].n, n1 = a.newton_ax[1].n, n2 = a.newton_ax[2].n;
  p.cell = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p.lo[j] = p.hi[j] = T(0);
    const int o0 = j >> 1, o1 = j & 1;
    p.w[j] = (o0 ? t0 : T(1) - t0) * (o1 ? t1 : T(1) - t1);
    p.base[j] = (clampll(c0 + o0, 0, n0 - 1) * n1 + clampll(c1 + o1, 0, n1 - 1)) * n2;
  }
}

// get_eep_newton's resid(e): the column lerped at (x0, x1, e) minus the
// target, NaN where the point is NaN or out of bounds; with `slope`, also its
// derivative in e (lerp_slope). Lanes with `skip` read nothing; every lane of
// the warp calls it (the EEP axis' search may vote).
template <typename T, bool CACHE>
__device__ __forceinline__ T newton_resid(const GenerateArgs& a, NewtonPoint<T>& p, T e, T target, bool skip, T* slope) {
  const Axis& ax = a.newton_ax[2];
  AxisReads<T> r;
  locate_reads<T, 1>(ax, e, 0, r);
  const bool bad = skip || p.bad || isnan(e) || e < r.first || e > r.last;
  long long c;
  T t, den;
  locate_finish<T, 1>(ax, e, bad, 0, r, c, t, &den);
  if (bad) {
    if (slope) *slope = T(NAN);
    return T(NAN);
  }
  if (!CACHE || c != p.cell) {
    const long long k0 = clampll(c, 0, ax.n - 1), k1 = clampll(c + 1, 0, ax.n - 1);
    const T* col = static_cast<const T*>(a.newton_col);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p.lo[j] = __ldg(col + p.base[j] + k0);
      p.hi[j] = __ldg(col + p.base[j] + k1);
    }
    p.cell = c;
  }
  const T* lo = p.lo;
  const T* hi = p.hi;
  // the 8 corners in interp_nd's order (the EEP axis' bit lowest)
  T val = T(0), diff = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    val += (p.w[j] * (T(1) - t)) * lo[j];
    val += (p.w[j] * t) * hi[j];
    diff += p.w[j] * (hi[j] - lo[j]);
  }
  if (slope) *slope = lerp_slope(diff, den);
  return sub_rn(val, target);
}

// ops/eep.py::get_eep_newton for one point, then the resid_tol cut: the
// refined EEP, or NaN; every lane of the warp calls it
// CACHE: keep a point's corner values while its iterate stays in one cell.
// The EEP-only forms do (on an H100 at 1,000,000 points in float32, 0.726
// against 0.938 ms; scripts/tune_torch_generate.py); the forward form does
// not (its 9 more registers cost it a block an SM: 1.523 against 1.343 ms).
template <typename T, bool CACHE>
__device__ T newton(const GenerateArgs& a, T seed, T target, T x0, T x1) {
  NewtonPoint<T> p;
  newton_setup(a, x0, x1, p);
  const Axis& ax = a.newton_ax[2];
  const T e_min = knot<T>(ax, 0), e_max = knot<T>(ax, ax.n - 1);
  T eep = clamp_nan(seed, e_min, e_max);
  const T r0 = newton_resid<T, CACHE>(a, p, isnan(eep) ? e_min : eep, target, false, static_cast<T*>(nullptr));
  // the scan seed where the seed has no finite residual; a point off the
  // first two axes has none anywhere and ends NaN whatever its seed
  const bool scan = !p.bad && !(isfinite(eep) && isfinite(r0));
  if (__any_sync(kFull, scan)) {
    const T* scan_eeps = static_cast<const T*>(a.scan);
    T best_r = T(INFINITY);
    int best = 0;
    for (int k = 0; k < kScan; ++k) {
      const T r = newton_resid<T, CACHE>(a, p, __ldg(scan_eeps + k), target, !scan, static_cast<T*>(nullptr));
      const T s = isfinite(r) ? fabs(r) : T(INFINITY);
      if (s < best_r) {  // argmin: the first of equal scores
        best_r = s;
        best = k;
      }
    }
    if (scan) eep = __ldg(scan_eeps + best);
  }
  for (int it = 0; it < a.n_iter; ++it) {
    T g;
    const T r = newton_resid<T, CACHE>(a, p, eep, target, false, &g);
    const T step = clamp_nan(div_rn(r, g == T(0) ? T(1) : g), T(-32), T(32));
    const T next = clamp_nan(sub_rn(eep, step), e_min, e_max);
    eep = isfinite(next) ? next : eep;
  }
  const T r = newton_resid<T, CACHE>(a, p, eep, target, false, static_cast<T*>(nullptr));
  return isfinite(r) && fabs(r) < T(a.resid_tol) ? eep : T(NAN);
}

// picked[c] = v[cols[c]] for c < n, without local memory: lane r's row of
// n_v values goes to the warp's stage at an odd stride (no bank conflicts) and
// comes back by the uniform indices cols[c]. Every lane of the warp calls it.
template <typename T, int NC>
__device__ void pick_cols(T* stage, const T* v, int n_v, const int* cols, int n, T* picked, int lane) {
  const int s = n_v | 1;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k == n_v) break;
    stage[lane * s + k] = v[k];
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == n) break;
    picked[c] = stage[lane * s + cols[c]];
  }
  __syncwarp();  // the buffer serves the stores next
}

// The warp's 32 output rows of `width` values (row r from lane r's
// vals[0, width)) into out rows q0.., staged in shared memory and written as
// contiguous 16-byte vectors (out + q0 * width is 16-byte aligned: q0 is a
// multiple of 32 and out comes from the allocator); n_rows of the 32 rows
// are real. Every lane of the warp calls it.
template <typename T, int NV>
__device__ void store_rows(T* stage, const T* vals, int width, T* out, long long q0, int n_rows, int lane) {
  if (width == 0) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (c == width) break;
    stage[lane * width + c] = vals[c];
  }
  __syncwarp();
  constexpr int kVec = 16 / sizeof(T);
  using V = typename Vec<T, kVec>::type;
  const int total = n_rows * width, n_vec = total / kVec;
  T* dst = out + q0 * width;
  for (int i = lane; i < n_vec; i += 32) reinterpret_cast<V*>(dst)[i] = reinterpret_cast<const V*>(stage)[i];
  for (int i = n_vec * kVec + lane; i < total; i += 32) dst[i] = stage[i];
  __syncwarp();  // the buffer serves the next rows
}

// the magnitudes Mbol + 5 log10(d / 10) - BC at (Teff, logg, feh, av), in
// torch's order, staged out; every lane of the warp calls it
template <typename T, int W>
__device__ void bands_out(const GenerateArgs& a, const T* tlf, T mbol, T dist_mod, T av, T* stage, long long q0,
                          int n_rows, int lane, void* out) {
  T bcv[W];
  const T bx[4] = {tlf[0], tlf[1], tlf[2], av};
  interp_group<T, 4, 1, W, 16 / sizeof(T)>(static_cast<const T*>(a.bc), a.bc_ax, bx, W, nullptr, W, 0, bcv);
  T m[W];
#pragma unroll
  for (int k = 0; k < W; ++k) m[k] = sub_rn(add_rn(mbol, dist_mod), bcv[k]);
  store_rows<T, W>(stage, m, a.n_bands, static_cast<T*>(out), q0, n_rows, lane);
}

// a warp's stage holds 32 rows of this many values: the lerped row at its
// odd stride, the columns asked for, the bands
__host__ __device__ __forceinline__ int stage_width(const GenerateArgs& a) {
  int w = a.n_bands;
  if (a.P > 0 && (a.read_len | 1) > w) w = a.read_len | 1;
  if (a.P > w) w = a.P;
  return w;
}

// Blocks an SM the registers of the forward forms leave room for: 5 in
// float (96 registers a thread), 3 in double (168). Unbounded, nvcc hoists
// the BC lerp's 16 unrolled corner rows and takes 106-128 registers in float
// and 254 in double, one block an SM fewer, and those forms ran 8-17% slower
// on an H100 (PERF.md; scripts/tune_torch_generate.py). The EEP-only forms
// need fewer and are left unbounded (bounded at 5, the isochrone grid's
// Newton form ran 9% slower).
template <typename T, int MODE>
constexpr int kMinBlocks = MODE == kInvert || MODE == kGiven || MODE == kAccurate ? (sizeof(T) == 4 ? 5 : 3) : 1;

template <typename T, int W, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, MODE>)
    generate_kernel(const __grid_constant__ GenerateArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps N < 2^31
  const long long q0 = q & ~31u;
  if (q0 >= a.N) return;  // the whole warp lies past the batch
  const bool active = q < a.N;
  const long long qc = active ? q : a.N - 1;
  if constexpr (MODE == kNewton) {
    // an idle lane's point is NaN: no reads
    const T x0 = active ? input<T>(a, 1, qc) : T(NAN);
    const T eep = newton<T, true>(a, input<T>(a, 3, qc), input<T>(a, 0, qc), x0, input<T>(a, 2, qc));
    if (active) static_cast<T*>(a.eep)[q] = eep;
    return;
  } else {
    const T mass = active ? input<T>(a, 0, qc) : T(NAN);  // an idle lane's point is NaN: no reads
    const T feh = input<T>(a, 2, qc);
    T eep;
    if constexpr (MODE == kGiven) {
      eep = active ? static_cast<const T*>(a.eeps_in)[qc] : T(NAN);
    } else {
      const T age = input<T>(a, 1, qc);
      eep = invert<T>(a, mass, age, feh);
      if constexpr (MODE == kAccurate) eep = newton<T, false>(a, eep, age, feh, mass);
      if constexpr (MODE == kAccurateEep) eep = newton<T, true>(a, eep, age, feh, mass);
      if (active) static_cast<T*>(a.eep)[q] = eep;
    }
    if constexpr (MODE == kEepOnly || MODE == kAccurateEep || GEN_PART < 2) return;
    const int lane = threadIdx.x % 32;
    const int n_rows = (int)(a.N - q0 < 32 ? a.N - q0 : 32);
    T* stage = reinterpret_cast<T*>(smem) + (threadIdx.x / 32) * 32 * stage_width(a);
    auto user = [&](int i) { return i == 0 ? mass : i == 1 ? eep : feh; };  // selects: no local memory
    const T gx[3] = {user(a.io[0]), user(a.io[1]), user(a.io[2])};
    T v[kMaxCols];
    interp_group<T, 3, 1, kMaxCols, 16 / sizeof(T)>(static_cast<const T*>(a.model), a.model_ax, gx, a.row_len,
                                                    nullptr, a.read_len, 0, v);
    const T tlf[3] = {v[0], v[1], v[2]};
    const T mbol = v[3];
    if (a.P > 0) {  // uniform: the whole warp or none
      T props[kMaxCols];
      pick_cols<T, kMaxCols>(stage, v, a.read_len, a.prop_cols, a.P, props, lane);
      store_rows<T, kMaxCols>(stage, props, a.P, static_cast<T*>(a.props), q0, n_rows, lane);
    }
    if (GEN_PART < 3 || a.n_bands == 0) return;
    const T dist_mod = mul_rn(T(5), d_log10(div_rn(input<T>(a, 3, qc), T(10))));
    bands_out<T, W>(a, tlf, mbol, dist_mod, input<T>(a, 4, qc), stage, q0, n_rows, lane, a.mags);
    if (a.mags0) bands_out<T, W>(a, tlf, mbol, dist_mod, T(0), stage, q0, n_rows, lane, a.mags0);
  }
}

template <typename T, int W, int MODE>
cudaError_t launch_w(const GenerateArgs& a, cudaStream_t st) {
  const long long blocks = (a.N + kThreads - 1) / kThreads;
  const int width = stage_width(a);
  const size_t smem = (MODE == kEepOnly || MODE == kAccurateEep || MODE == kNewton)
                          ? 0
                          : (size_t)kThreads * (width > 0 ? width : 1) * sizeof(T);
  generate_kernel<T, W, MODE><<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_bands(const GenerateArgs& a, cudaStream_t st) {
  switch (a.bc_ncols) {  // the compact table's instantiated widths only
    case 4: return launch_w<T, 4, MODE>(a, st);
    case 8: return launch_w<T, 8, MODE>(a, st);
    case 12: return launch_w<T, 12, MODE>(a, st);
    case 16: return launch_w<T, 16, MODE>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_axis(const Axis& ax) { return ax.knots != nullptr && ax.n >= 1; }

template <typename T>
int launch(const GenerateArgs* args, int mode, void* stream) {
  const GenerateArgs& a = *args;
  if (mode < kInvert || mode > kNewton || a.N < 0 || a.N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return 0;
  const bool fwd = mode == kInvert || mode == kGiven || mode == kAccurate;
  const bool inverts = mode != kGiven && mode != kNewton;
  const bool newton = mode == kAccurate || mode == kAccurateEep || mode == kNewton;
  if (!a.in[0] || !a.in[1] || !a.in[2] || (mode != kGiven && !a.eep) || (mode == kGiven && !a.eeps_in))
    return (int)cudaErrorInvalidValue;
  if (inverts && (a.n_steps < 1 || a.n_eep < 1 || !a.age_rows || !a.lengths || !valid_axis(a.inv_ax[0]) ||
                  !valid_axis(a.inv_ax[1]) || a.n_tracks != a.inv_ax[0].n * a.inv_ax[1].n))
    return (int)cudaErrorInvalidValue;
  if (newton && (!a.newton_col || !a.scan || a.n_iter < 0 || !valid_axis(a.newton_ax[0]) ||
                 !valid_axis(a.newton_ax[1]) || !valid_axis(a.newton_ax[2]) || (mode == kNewton && !a.in[3])))
    return (int)cudaErrorInvalidValue;
  if (fwd && (a.P < 0 || a.P > kMaxCols || a.row_len < 4 || a.row_len > kMaxCols || a.row_len % 4 != 0 ||
              a.read_len < 4 || a.read_len > a.row_len || a.read_len % 4 != 0 ||
              a.n_bands < 0 || a.n_bands > kMaxBands || a.n_bands > a.bc_ncols || !a.model ||
              (a.P > 0 && !a.props) || (a.n_bands > 0 && (!a.bc || !a.mags || !a.in[3] || !a.in[4])) ||
              (a.mags0 && a.n_bands == 0)))
    return (int)cudaErrorInvalidValue;
  if (fwd) {
    for (int c = 0; c < a.P; ++c)
      if (a.prop_cols[c] < 0 || a.prop_cols[c] >= a.read_len) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kEepOnly: return (int)launch_w<T, 4, kEepOnly>(a, st);
    case kAccurateEep: return (int)launch_w<T, 4, kAccurateEep>(a, st);
    case kNewton: return (int)launch_w<T, 4, kNewton>(a, st);
    case kInvert: return (int)launch_bands<T, kInvert>(a, st);
    case kGiven: return (int)launch_bands<T, kGiven>(a, st);
    default: return (int)launch_bands<T, kAccurate>(a, st);
  }
}

}  // namespace

// `args` points to a GenerateArgs (void*: see star_lnlike.cu); `mode` is a
// Mode. The float64 entry point is compiled from generate_f64.cu, which
// includes this file: the two types' 15 instantiations each build in their
// own nvcc process, in parallel.
extern "C" {

#ifdef GENERATE_F64_UNIT
int generate_f64(const void* args, int mode, void* stream) {
  return launch<double>(static_cast<const GenerateArgs*>(args), mode, stream);
}
#else
int generate_args_size() { return (int)sizeof(GenerateArgs); }

int generate_max_bands() { return kMaxBands; }

int generate_max_cols() { return kMaxCols; }

int generate_f32(const void* args, int mode, void* stream) {
  return launch<float>(static_cast<const GenerateArgs*>(args), mode, stream);
}
#endif

}  // extern "C"
