// Fused single/binary/triple star log-likelihood: one CUDA thread per point.
//
// Replaces the likelihood half of the XLA-fused posterior of the JAX package,
// isochrones_tpu/starmodel.py:430-486 (_build_lnpost_fused), which XLA
// compiles into one TPU fusion. For each point (row of `pars`, N + 4 values:
// N component EEPs, then age, feh, distance, AV) and each component c < N it
//
//   1. locates the cell on the 3 model-grid axes and lerps the 8 corner rows of
//      the 6-column packed table (Teff, logg, feh, Mbol, the EEP-prior
//      quantity and its d/dEEP derivative);
//   2. locates the cell on the 4 BC-grid axes at (Teff, logg, feh, AV) and
//      lerps the wanted band columns of the 16 corner rows;
//   3. forms the component magnitudes Mbol + 5 log10(d / 10) - BC;
//
// then flux-sums the components (N > 1), adds the Gaussian spectroscopy terms
// of component 0 (a missing observation adds exactly 0), the photometry terms
// and the parallax term, and writes ll (B,), orig_val (B, N), deriv (B, N).
// The priors stay in torch around the call (isochrones_torch/starmodel.py).
//
// Semantics are those of the plain version (isochrones_torch/ops/star.py and
// ops/interp.py): cell location copies find_cells_1d step for step (the
// exact_affine fix-up, the two-step fix-up of the affine and log kinds,
// _pin_top), with explicitly rounded products and sums so that nvcc's FMA
// contraction cannot move a point into another cell; every corner enters the
// sum, weight 0 included, so a NaN-padded neighbour poisons the result as
// IEEE 0 * NaN does in torch; a NaN or out-of-bounds coordinate on any axis
// makes the component's row NaN, and a NaN Teff/logg/feh from the model step
// makes the BC step NaN in turn.
//
// What bounds it: gather latency, not arithmetic. Per point and component it
// reads 8 rows of the model pack (66 MB in float32 at the MIST-scale grid,
// more than the 50 MB L2) and 16 short rows of the 5 MB BC table, at
// data-dependent addresses, and does ~300 flops.
//
// Design, against that bound (a first version: simple and right):
// * one thread per point; the components loop inside the thread, so each
//   thread keeps its flux sums and Teff/logg/feh in registers and writes its
//   outputs once;
// * all grid descriptions (axis kinds, constants, knot pointers, strides, the
//   observations) travel in one by-value argument struct, so a launch needs no
//   host allocation; knot arrays are read through the read-only cache;
// * 64-bit row offsets (the full model table has 41 M elements);
// * instantiated for float and double.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxStars = 3;
constexpr int kPackCols = 6;

// axis-map kinds of ops/interp.py::compute_axis_maps (None = searchsorted)
enum AxisKind : int { kSearch = 0, kExactAffine = 1, kAffine = 2, kLog = 3, kCompare = 4 };

struct Axis {
  const void* knots;  // device pointer to n knots of the grid's dtype
  long long n;
  double lo0;
  double step;
  int kind;
  int pad;
};

struct StarArgs {
  const void* pars;   // (B, P) P = N + 4
  const void* model;  // (m0, m1, m2, 6) packed model table
  const void* bc;     // (b0, b1, b2, b3, bc_ncols) BC table
  void* ll;           // (B,)
  void* orig;         // (B, N)
  void* deriv;        // (B, N)
  long long B;
  int N;
  int P;
  int io[5];          // user order -> (grid axis 0, 1, 2, distance, AV)
  int n_bands;
  int bc_ncols;
  int dist_idx;       // column of the distance for the parallax term; -1: none
  int band_cols[kMaxBands];
  int has_spec[3];
  double spec_val[3];
  double spec_unc[3];
  double mag_val[kMaxBands];
  double mag_unc[kMaxBands];
  double plax;
  double plax_unc;
  Axis model_ax[3];
  Axis bc_ax[4];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log10(float x) { return log10f(x); }
__device__ __forceinline__ double d_log10(double x) { return log10(x); }
__device__ __forceinline__ float d_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double d_pow(double a, double b) { return pow(a, b); }

template <typename T>
__device__ __forceinline__ T knot(const Axis& ax, long long i) {
  return __ldg(static_cast<const T*>(ax.knots) + i);
}

// torch: num / where(den == 0, 1, den)
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return div_rn(num, den == T(0) ? T(1) : den);
}

template <typename T>
__device__ __forceinline__ long long floor_to_cell(T raw, long long n) {
  // floor(raw) clamped to [0, n - 2]; raw is finite for in-bounds x
  T f = floor(raw);
  if (!(f >= T(0))) return 0;
  if (f > T(n - 2)) return n - 2;
  return static_cast<long long>(f);
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/interp.py::find_cells_1d for one in-bounds, non-NaN x: the lower cell
// index (may be n - 1 at the top knot) and the in-cell coordinate t.
template <typename T>
__device__ void find_cell(const Axis& ax, T x, long long& cell, T& t) {
  const long long n = ax.n;
  if (ax.kind != kSearch && n > 1) {
    const T top = knot<T>(ax, n - 1);
    if (ax.kind == kExactAffine) {
      const T lo0 = T(ax.lo0), step = T(ax.step);
      long long c = floor_to_cell<T>(div_rn(sub_rn(x, lo0), step), n);
      T lo = add_rn(lo0, mul_rn(T(c), step));
      T tt = div_rn(sub_rn(x, lo), step);
      // division rounding may land one cell off near a knot
      const long long shift = (tt >= T(1) ? 1 : 0) - (tt < T(0) ? 1 : 0);
      c = clampll(c + shift, 0, n - 2);
      lo = add_rn(lo0, mul_rn(T(c), step));
      tt = div_rn(sub_rn(x, lo), step);
      cell = c;
      t = tt;
    } else if (ax.kind == kCompare) {
      long long cnt = 0;
      for (long long i = 0; i < n; ++i) cnt += (x >= knot<T>(ax, i)) ? 1 : 0;
      const long long c = clampll(cnt - 1, 0, n - 2);
      const T lo = knot<T>(ax, c);
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(knot<T>(ax, c + 1), lo));
    } else {  // kAffine, kLog
      const T lo0 = T(ax.lo0), step = T(ax.step);
      const T xs = ax.kind == kLog ? d_log(x > T(0) ? x : T(0)) : x;
      long long c = floor_to_cell<T>(div_rn(sub_rn(xs, lo0), step), n);
      // two-step fix-up against the true knots absorbs rounding in raw
      if (x < knot<T>(ax, c)) c -= 1;
      c = clampll(c, 0, n - 2);
      if (x >= knot<T>(ax, clampll(c + 1, 0, n - 1))) c += 1;
      c = clampll(c, 0, n - 2);
      const T lo = knot<T>(ax, c);
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(knot<T>(ax, c + 1), lo));
    }
    if (x == top) {  // _pin_top
      cell = n - 1;
      t = T(0);
    }
    return;
  }
  // searchsorted(side="left"): the number of knots below x
  long long lo_i = 0, hi_i = n;
  while (lo_i < hi_i) {
    const long long mid = (lo_i + hi_i) / 2;
    if (knot<T>(ax, mid) < x) lo_i = mid + 1; else hi_i = mid;
  }
  const long long i_ins = lo_i;
  const long long i_safe = clampll(i_ins, 0, n - 1);
  const bool eq = knot<T>(ax, i_safe) == x;
  const long long c = eq ? i_safe : i_ins - 1;
  const long long c_safe = n > 1 ? clampll(c, 0, n - 2) : 0;
  const T lo = knot<T>(ax, c_safe);
  const T hi = knot<T>(ax, clampll(c_safe + 1, 0, n - 1));
  cell = eq ? c : c_safe;
  t = eq ? T(0) : safe_div(sub_rn(x, lo), sub_rn(hi, lo));
}

template <typename T>
__device__ __forceinline__ bool out_of_bounds(const Axis& ax, T x) {
  return isnan(x) || x < knot<T>(ax, 0) || x > knot<T>(ax, ax.n - 1);
}

// Multilinear interpolation of `ncols` columns (cols[i], or i when cols is
// null) of a dense (dims..., row_len) table at one point; NaN when the point
// is NaN or out of bounds on any axis. All 2**NDIM corners enter the sum.
template <typename T, int NDIM>
__device__ void interp_point(const T* __restrict__ table, const Axis* axes, const T* x, int row_len,
                             const int* cols, int ncols, T* out) {
  bool bad = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) bad = bad || out_of_bounds<T>(axes[d], x[d]);
  if (bad) {
    for (int c = 0; c < ncols; ++c) out[c] = T(NAN);
    return;
  }
  long long cell[NDIM];
  T t[NDIM];
  long long stride[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) find_cell<T>(axes[d], x[d], cell[d], t[d]);
  stride[NDIM - 1] = 1;
#pragma unroll
  for (int d = NDIM - 2; d >= 0; --d) stride[d] = stride[d + 1] * axes[d + 1].n;
  for (int c = 0; c < ncols; ++c) out[c] = T(0);
#pragma unroll
  for (int i = 0; i < (1 << NDIM); ++i) {
    T w = T(1);
    long long row = 0;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const int o = (i >> (NDIM - 1 - d)) & 1;
      w = w * (o ? t[d] : T(1) - t[d]);
      row += clampll(cell[d] + o, 0, axes[d].n - 1) * stride[d];
    }
    const T* r = table + row * row_len;
    for (int c = 0; c < ncols; ++c) out[c] += w * __ldg(r + (cols ? cols[c] : c));
  }
}

// reference likelihood.py:10-13, with its +log(unc) constant
template <typename T>
__device__ __forceinline__ T gauss_lnprob(T val, T unc, T model_val) {
  const T resid = val - model_val;
  return T(-0.91893853320467274178) + d_log(unc) - T(0.5) * resid * resid / (unc * unc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) star_lnlike_kernel(const StarArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const T* p = static_cast<const T*>(a.pars) + b * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* bc = static_cast<const T*>(a.bc);
  const int N = a.N;
  const T age = p[N], feh = p[N + 1], dist = p[N + 2], av = p[N + 3];

  T flux[kMaxBands];
  T mags[kMaxBands];
  T spec[3];
  for (int k = 0; k < a.n_bands; ++k) flux[k] = T(0);
  for (int c = 0; c < N; ++c) {
    const T comp[5] = {p[c], age, feh, dist, av};  // user order of the component
    const T gx[3] = {comp[a.io[0]], comp[a.io[1]], comp[a.io[2]]};
    T v[kPackCols];
    interp_point<T, 3>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, v);
    static_cast<T*>(a.orig)[b * N + c] = v[4];
    static_cast<T*>(a.deriv)[b * N + c] = v[5];
    if (c == 0) {
      spec[0] = v[0];
      spec[1] = v[1];
      spec[2] = v[2];
    }
    if (a.n_bands == 0) continue;
    const T bx[4] = {v[0], v[1], v[2], comp[a.io[4]]};
    T bcv[kMaxBands];
    interp_point<T, 4>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, a.n_bands, bcv);
    const T dist_mod = T(5) * d_log10(comp[a.io[3]] / T(10));
    for (int k = 0; k < a.n_bands; ++k) {
      const T m = v[3] + dist_mod - bcv[k];
      if (N == 1) mags[k] = m; else flux[k] += d_pow(T(10), T(-0.4) * m);
    }
  }
  if (N > 1) {
    for (int k = 0; k < a.n_bands; ++k) mags[k] = T(-2.5) * d_log10(flux[k]);
  }

  T ll = T(0);
  for (int k = 0; k < 3; ++k) {
    if (a.has_spec[k]) ll += gauss_lnprob<T>(T(a.spec_val[k]), T(a.spec_unc[k]), spec[k]);
  }
  T phot = T(0);
  for (int k = 0; k < a.n_bands; ++k) phot += gauss_lnprob<T>(T(a.mag_val[k]), T(a.mag_unc[k]), mags[k]);
  ll += phot;
  if (a.dist_idx >= 0) ll += gauss_lnprob<T>(T(a.plax), T(a.plax_unc), T(1000) / p[a.dist_idx]);
  static_cast<T*>(a.ll)[b] = ll;
}

template <typename T>
int launch(const StarArgs* args, void* stream) {
  const StarArgs& a = *args;
  if (a.B < 0 || a.N < 1 || a.N > kMaxStars || a.P != a.N + 4 || a.n_bands < 0 || a.n_bands > kMaxBands)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const long long blocks = (a.B + kThreads - 1) / kThreads;
  star_lnlike_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int star_lnlike_max_bands() { return kMaxBands; }

int star_lnlike_args_size() { return (int)sizeof(StarArgs); }

const char* star_lnlike_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// `args` points to a StarArgs; it is passed as void* because a parameter of a
// type from the unnamed namespace would give these functions internal linkage
int star_lnlike_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const StarArgs*>(args), stream);
}

int star_lnlike_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const StarArgs*>(args), stream);
}

}  // extern "C"
