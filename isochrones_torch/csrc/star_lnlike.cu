// Fused single/binary/triple star log-likelihood: a group of lanes per
// (point, component).
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
// ops/interp.py): cell location gives find_cells_1d's cell step for step (the
// exact_affine fix-up, the two-step fix-up of the affine and log kinds,
// _pin_top, searchsorted's count of knots below x, the compare kind's count),
// with explicitly rounded products and sums so that nvcc's FMA contraction
// cannot move a point into another cell; every corner's product enters the
// sum, weight 0 included, so a NaN-padded neighbour poisons the result as
// IEEE 0 * NaN does in torch; a NaN or out-of-bounds coordinate on any axis
// makes the component's row NaN, and a NaN Teff/logg/feh from the model step
// makes the BC step NaN in turn.
//
// What bounds it: latency of dependent gathers, not bytes or arithmetic. Per
// point and component it reads 8 rows of the model pack and 16 short rows of
// the BC table at data-dependent addresses, each address known only after a
// cell search, and the BC search needs the model step's Teff/logg/feh; the
// bytes (parameters, outputs, the rows a batch touches) take ~0.1 us at the
// nested fit's 1024 points.
//
// Design, against that bound:
// * A team of NP * G lanes per point, NP = N rounded up to a power of two:
//   a group of G lanes per component, the components' groups side by side.
//   Each lane of a group takes corners i = l, l + G, ... of both lerps, so
//   the 8 + 16 row reads of a component are in flight together, and the group
//   sums its corners with xor shuffles; the components' fluxes are summed
//   the same way across groups (in the same order as a sequential sum).
// * Cell location in two passes over a point's axes: the first starts every
//   knot read that needs no decision (the end knots; the 2 knots of the
//   affine and log kinds' analytic guess; each lane's first 4 knots of the
//   compare kind), the second decides the cells, so a point's axes cost one
//   round of dependent reads instead of up to three each. The compare kind
//   counts when its knots fit in 4 reads a lane (each lane reads a G-th,
//   the cell's two knots come by shuffle) and otherwise searches like the
//   searchsorted kind, whose group probes G knots per step (a (G+1)-ary
//   search: 3 steps instead of 11 for 1710 knots at G = 16, 6 instead of 53
//   reads for the 53 Teff knots of the BC grid at G = 1).
// * Launch geometry from the batch (group_lanes): G = 16 (8 for N = 3) while
//   B * NP * G stays within kFillThreads (about one full card of threads),
//   halving G down to 1 at large batches; B = 1024 and N = 2 take G = 16,
//   B = 131072 takes G = 1 (one thread per component); the widths 8 to 2
//   between them (batches of 8k-65k points at N = 2) are tested but were not
//   timed on any path. One kernel body for
//   every G; at G = 1 the batch fills the card, so the kernel is held to 102
//   registers (5 blocks per SM; in float64 the compiler would take 128-140).
// * The argument struct (grid descriptions, observations) is a
//   __grid_constant__ kernel parameter: it is read from the constant bank,
//   and taking its arrays' addresses makes no local copy.
// * 64-bit row offsets (the full model table has 41 M elements); instantiated
//   for float and double.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxStars = 3;
constexpr int kPackCols = 6;
constexpr int kMaxGroup = 16;  // at most 16 lanes per group
constexpr long long kFillThreads = 1LL << 18;
constexpr unsigned kFull = 0xffffffffu;

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

// sum over the G lanes of this lane's group (groups are aligned runs of G
// lanes); every lane of the warp must call it
template <int G, typename V>
__device__ __forceinline__ V group_sum(V v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// What the cell location of one coordinate reads before it decides
// anything, so that the reads of every axis of a point are in flight
// together: the end knots (bounds, _pin_top) and, for the affine and log
// kinds, the knots c0 and c0 + 1 of the analytic guess c0 (the fix-ups
// rarely move off it), or for the compare kind this lane's first 4 of its
// share of the knots.
template <typename T>
struct AxisReads {
  T first, last;
  T kn[4];
  long long c0;
};

template <typename T, int G>
__device__ __forceinline__ void locate_reads(const Axis& ax, T x, int l, AxisReads<T>& r) {
  const long long n = ax.n;
  r.first = knot<T>(ax, 0);
  r.last = knot<T>(ax, n - 1);
  r.c0 = 0;
  if ((ax.kind == kAffine || ax.kind == kLog) && n > 1) {
    const T lo0 = T(ax.lo0), step = T(ax.step);
    const T xs = ax.kind == kLog ? d_log(x > T(0) ? x : T(0)) : x;
    r.c0 = floor_to_cell<T>(div_rn(sub_rn(xs, lo0), step), n);
    r.kn[0] = knot<T>(ax, r.c0);
    r.kn[1] = knot<T>(ax, r.c0 + 1);
  } else if (ax.kind == kCompare && n > 1 && n <= 4 * G) {
#pragma unroll
    for (int u = 0; u < 4; ++u) r.kn[u] = l + u * G < n ? knot<T>(ax, l + u * G) : T(0);
  }
}

// The number of knots below x (searchsorted side "left"), or at or below x
// with `right` (side "right"), by a (G+1)-ary search of the group: the
// answer lies in [lo, hi]; lane l probes p_l = lo + (l + 1) span / (G + 1),
// and the c probes that count (a prefix, the knots being sorted) move lo
// past p_(c-1) and hi to p_c. Every lane of the warp calls it.
template <typename T, int G>
__device__ long long group_count(const Axis& ax, T x, bool skip, int l, bool right) {
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  long long lo = 0, hi = skip ? 0 : ax.n;
  while (__any_sync(kFull, lo < hi)) {
    const long long span = hi - lo;
    const bool live = lo < hi;
    bool below = false;
    if (live) {
      const T k = knot<T>(ax, lo + ((l + 1) * span) / (G + 1));
      below = right ? k <= x : k < x;
    }
    const unsigned votes = __ballot_sync(kFull, below) >> gbase;
    const int c = __popc(votes & ((1u << G) - 1u));
    if (live) {
      const long long p_c = lo + ((c + 1) * span) / (G + 1);
      if (c > 0) lo = lo + (c * span) / (G + 1) + 1;
      if (c < G) hi = p_c;
    }
  }
  return lo;
}

// one of four registers by a runtime index, without local memory
template <typename T>
__device__ __forceinline__ T pick4(const T* v, long long u) {
  return u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
}

// ops/interp.py::find_cells_1d for one in-bounds, non-NaN x, from the reads
// of locate_reads, by the G lanes of a group together: the lower cell index
// (may be n - 1 at the top knot) and the in-cell coordinate t. Lanes with
// `skip` (a NaN or out-of-bounds point) read no further knots; every lane of
// the warp calls it (the searches vote and shuffle).
template <typename T, int G>
__device__ void locate_finish(const Axis& ax, T x, bool skip, int l, const AxisReads<T>& r, long long& cell,
                              T& t) {
  const long long n = ax.n;
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  if (ax.kind != kSearch && n > 1) {
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
      // the count of knots <= x: the knots increase, so it is also an
      // upper-bound search, which wide axes (more than 4 knots a lane) take
      long long c;
      T lo, hi;
      if (n <= 4 * G) {  // one read per knot, all made by locate_reads
        int cnt = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) cnt += (!skip && l + u * G < n && x >= r.kn[u]) ? 1 : 0;
        c = clampll(group_sum<G>(cnt) - 1, 0, n - 2);
        // knot i is lane (i % G)'s kn[i / G]
        lo = __shfl_sync(kFull, pick4(r.kn, c / G), gbase + (int)(c % G));
        hi = __shfl_sync(kFull, pick4(r.kn, (c + 1) / G), gbase + (int)((c + 1) % G));
      } else {
        c = clampll(group_count<T, G>(ax, x, skip, l, true) - 1, 0, n - 2);
        lo = knot<T>(ax, c);
        hi = knot<T>(ax, c + 1);
      }
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(hi, lo));
    } else {  // kAffine, kLog: knots c0 and c0 + 1 are read, others on demand
      auto kat = [&](long long i) { return i == r.c0 ? r.kn[0] : i == r.c0 + 1 ? r.kn[1] : knot<T>(ax, i); };
      long long c = r.c0;
      // two-step fix-up against the true knots absorbs rounding in raw
      if (x < kat(c)) c -= 1;
      c = clampll(c, 0, n - 2);
      if (x >= kat(clampll(c + 1, 0, n - 1))) c += 1;
      c = clampll(c, 0, n - 2);
      const T lo = kat(c);
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(kat(c + 1), lo));
    }
    if (x == r.last) {  // _pin_top
      cell = n - 1;
      t = T(0);
    }
    return;
  }
  // searchsorted(side="left"): the number of knots below x
  const long long i_ins = group_count<T, G>(ax, x, skip, l, false);
  const long long i_safe = clampll(i_ins, 0, n - 1);
  const bool eq = knot<T>(ax, i_safe) == x;
  const long long c = eq ? i_safe : i_ins - 1;
  const long long c_safe = n > 1 ? clampll(c, 0, n - 2) : 0;
  const T lo_k = knot<T>(ax, c_safe);
  const T hi_k = knot<T>(ax, clampll(c_safe + 1, 0, n - 1));
  cell = eq ? c : c_safe;
  t = eq ? T(0) : safe_div(sub_rn(x, lo_k), sub_rn(hi_k, lo_k));
}

// Multilinear interpolation of `ncols` (<= NC) columns (cols[i], or i when
// cols is null) of a dense (dims..., row_len) table at one point, by the G
// lanes of a group, into out[0, ncols); NaN when the point is NaN or out of
// bounds on any axis. Every lane of the group gets the sums of all 2**NDIM
// corners' products.
template <typename T, int NDIM, int G, int NC>
__device__ void interp_group(const T* __restrict__ table, const Axis* axes, const T* x, int row_len,
                             const int* cols, int ncols, int l, T* out) {
  AxisReads<T> reads[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) locate_reads<T, G>(axes[d], x[d], l, reads[d]);
  bool bad = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) bad = bad || isnan(x[d]) || x[d] < reads[d].first || x[d] > reads[d].last;
  long long cell[NDIM];
  T t[NDIM];
  long long stride[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) locate_finish<T, G>(axes[d], x[d], bad, l, reads[d], cell[d], t[d]);
  stride[NDIM - 1] = 1;
#pragma unroll
  for (int d = NDIM - 2; d >= 0; --d) stride[d] = stride[d + 1] * axes[d + 1].n;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == ncols) break;
    out[c] = T(0);
  }
  if (!bad) {
    for (int i = l; i < (1 << NDIM); i += G) {
      T w = T(1);
      long long row = 0;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        const int o = (i >> (NDIM - 1 - d)) & 1;
        w = w * (o ? t[d] : T(1) - t[d]);
        row += clampll(cell[d] + o, 0, axes[d].n - 1) * stride[d];
      }
      const T* r = table + row * row_len;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c == ncols) break;
        out[c] += w * __ldg(r + (cols ? cols[c] : c));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == ncols) break;
    const T sum = group_sum<G>(out[c]);  // every lane shuffles, bad or not
    out[c] = bad ? T(NAN) : sum;
  }
}

// reference likelihood.py:10-13, with its +log(unc) constant
template <typename T>
__device__ __forceinline__ T gauss_lnprob(T val, T unc, T model_val) {
  const T resid = val - model_val;
  return T(-0.91893853320467274178) + d_log(unc) - T(0.5) * resid * resid / (unc * unc);
}

// teams of G << np_shift lanes (1, 2 or 4 component groups); a team never
// straddles a warp
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 5 : 1) star_lnlike_kernel(const __grid_constant__ StarArgs a, int np_shift) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps B * np * G < 2^31
  const int team = G << np_shift;
  const unsigned tshift = __ffs(team) - 1;
  if ((long long)((tid & ~31u) >> tshift) >= a.B) return;  // the whole warp lies past the batch
  const long long b = tid >> tshift;
  const int c = (int)(tid & (team - 1)) / G;
  const int l = (int)(tid % G);
  const int N = a.N;
  const bool active = b < a.B && c < N;
  const T* p = static_cast<const T*>(a.pars) + (b < a.B ? b : a.B - 1) * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* bc = static_cast<const T*>(a.bc);
  const T eep = active ? p[c] : T(NAN);  // an idle lane's point is NaN: no reads
  const T age = p[N], feh = p[N + 1], dist = p[N + 2], av = p[N + 3];
  auto comp = [&](int i) { return i == 0 ? eep : i == 1 ? age : i == 2 ? feh : i == 3 ? dist : av; };

  const T gx[3] = {comp(a.io[0]), comp(a.io[1]), comp(a.io[2])};
  T v[kPackCols];
  interp_group<T, 3, G, kPackCols>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, v);
  if (active && l == 0) {
    static_cast<T*>(a.orig)[b * N + c] = v[4];
    static_cast<T*>(a.deriv)[b * N + c] = v[5];
  }

  T mags[kMaxBands];  // the BC values, then the magnitudes
  if (a.n_bands > 0) {
    const T bx[4] = {v[0], v[1], v[2], comp(a.io[4])};
    interp_group<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, a.n_bands, l, mags);
    const T dist_mod = T(5) * d_log10(comp(a.io[3]) / T(10));
#pragma unroll
    for (int k = 0; k < kMaxBands; ++k) {
      if (k == a.n_bands) break;
      const T m = v[3] + dist_mod - mags[k];
      if (N == 1) {
        mags[k] = m;
      } else {
        T f = active ? d_pow(T(10), T(-0.4) * m) : T(0);
        for (int off = G; off < team; off <<= 1) f += __shfl_xor_sync(kFull, f, off);
        mags[k] = T(-2.5) * d_log10(f);
      }
    }
  }

  if (c != 0 || l != 0 || b >= a.B) return;
  T ll = T(0);
  for (int k = 0; k < 3; ++k) {
    if (a.has_spec[k]) ll += gauss_lnprob<T>(T(a.spec_val[k]), T(a.spec_unc[k]), v[k]);
  }
  T phot = T(0);
#pragma unroll
  for (int k = 0; k < kMaxBands; ++k) {
    if (k == a.n_bands) break;
    phot += gauss_lnprob<T>(T(a.mag_val[k]), T(a.mag_unc[k]), mags[k]);
  }
  ll += phot;
  if (a.dist_idx >= 0) ll += gauss_lnprob<T>(T(a.plax), T(a.plax_unc), T(1000) / p[a.dist_idx]);
  static_cast<T*>(a.ll)[b] = ll;
}

// log2 of the component groups per team: N rounded up to a power of two
int team_shift(int N) { return N == 1 ? 0 : (N == 2 ? 1 : 2); }

int group_lanes(long long B, int N) {
  const int np = 1 << team_shift(N);
  int g = kMaxGroup;
  while (g > 1 && (np * g > 32 || B * np * g > kFillThreads)) g >>= 1;
  return g;
}

template <typename T, int G>
cudaError_t launch_g(const StarArgs& a, int np_shift, cudaStream_t st) {
  const long long threads = (a.B * G) << np_shift;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  star_lnlike_kernel<T, G><<<(unsigned)blocks, kThreads, 0, st>>>(a, np_shift);
  return cudaGetLastError();
}

template <typename T>
int launch(const StarArgs* args, void* stream) {
  const StarArgs& a = *args;
  if (a.B < 0 || a.N < 1 || a.N > kMaxStars || a.P != a.N + 4 || a.n_bands < 0 || a.n_bands > kMaxBands)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int ns = team_shift(a.N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group_lanes(a.B, a.N)) {
    case 16: return (int)launch_g<T, 16>(a, ns, st);
    case 8: return (int)launch_g<T, 8>(a, ns, st);
    case 4: return (int)launch_g<T, 4>(a, ns, st);
    case 2: return (int)launch_g<T, 2>(a, ns, st);
    default: return (int)launch_g<T, 1>(a, ns, st);
  }
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
