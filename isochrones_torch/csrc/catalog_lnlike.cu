// Catalog log-posterior: every star of a catalog with its own observations,
// one thread per (star, point).
//
// Replaces the JAX package's catalog posterior, isochrones_tpu/batch.py:145-208
// (_build_lnpost_data), which XLA compiles into one TPU fusion: for
// parameters (S, B, 5) in the order (eep, age, feh, distance, AV), or
// unit-cube points with the per-star box of the nested fit (the box map of
// BatchStarFitter.fit_multinest's lnlike_u first), it
//
//   1. locates the cell on the 3 model-grid axes and lerps the 8 corner rows of
//      the 6-column packed table (Teff, logg, feh, Mbol, the EEP-prior
//      quantity orig_val and its d/dEEP derivative);
//   2. locates the cell on the 4 BC-grid axes at (Teff, logg, feh, AV) and
//      lerps the wanted band columns of the 16 corner rows;
//   3. forms the magnitudes Mbol + 5 log10(d / 10) - BC and adds the star's
//      own Gaussian spectroscopy, photometry and parallax terms, each exactly 0
//      where the star's observed value is NaN (selected term by term, before
//      any sum);
//   4. (posterior) adds the default priors from constants packed once per
//      fitter (ops/catalog.py::pack_catalog_priors, the order of CONST_NAMES
//      there): the flat-log age prior, the [Fe/H] disk-and-halo mixture, the
//      flat AV prior, the per-star distance power law, and the EEP change of
//      variables Chabrier(orig_val) + ln max(deriv, 1e-300) with its masks;
//      then NaN ll -> -inf and -inf wherever the prior sum is not finite.
//
// Two instantiations of one body, chosen by POST: the posterior writes lnpost
// (S, B) (and orig_val when the caller adds a replaced mass prior itself); the
// likelihood writes ll, orig_val and deriv (S, B), the triple the plain
// version's tests and the card's checks hold it to.
//
// Semantics are those of the plain version (isochrones_torch/ops/catalog.py
// and ops/interp.py), through interp_common.cuh: cell location step for step
// with explicitly rounded arithmetic, every corner's product in the sum
// (weight 0 included, so 0 * NaN poisons as in torch), a NaN or out-of-bounds
// coordinate makes the row NaN. The box map lo + (hi - lo) u and the prior
// terms follow torch's operation order with each Python constant rounded to
// the working type and no FMA contraction (__f*_rn): a point's grid cell
// depends on the box map's last bit. T(1e-300) is 0 in float, as torch's
// clamp(x, min=1e-300) is in float32: log gives -inf and the masks decide.
// Clamps keep NaN, as torch's do.
//
// What bounds it: not the bytes (the kernel reaches a small share of its bytes
// bound at the nested fit's (256, 256), PERF.md) but each point's long chain of
// dependent work: the parameters' load, cell location on 7 axes (64-bit
// index arithmetic, searches, fix-ups), 8 rows of the model pack and 16 short
// rows of the BC table at data-dependent addresses, the observation row, the
// epilogue's exp/log and divisions. At (256, 32) the card is half empty and
// one point's chain takes the whole ~20,000 cycles (0.010 ms); 8x the points
// at (256, 256) take 0.017 ms. The grids' knots (~8 KB) are read by every
// point and stay in L1, so staging them in shared memory (and persistent
// blocks to pay for the staging) would trade ~33-cycle L1 hits for ~30-cycle
// shared reads: not built. No tensor cores: there is no matrix product
// anywhere in the function.
//
// Design:
// * The stars' observations are one (S, row_len) block in global memory:
//   [Teff, logg, feh | their errors | n_bands magnitudes | their errors |
//   parallax, its error]; the distance prior's per-star (d_hi, ln 3 - 3 ln
//   d_hi) one (S, 2) block. The B points of a star are consecutive teams, so
//   a warp's rows are one broadcast read served from L1/L2.
// * One lane a point. A group of G lanes per (star, point) could share the
//   corners of both lerps (interp_group) and sum them with xor shuffles, but
//   every lane repeats the cell location, so more lanes do not shorten a
//   point's chain: measured on the H100 (PERF.md; scripts/tune_torch_catalog.py)
//   one lane was 2.6x faster than the 4 lanes of the earlier rule at
//   (256, 256), and 8 or 16 lanes gained at most ~1 us, only on batches of a
//   few thousand points. The prior terms run on the lane that forms the
//   likelihood: spread over a group's idle lanes they took as long (divergent
//   branches of one warp run one after another).
// * __launch_bounds__ asks for CATALOG_MIN_BLOCKS = 5 resident blocks a SM
//   (96 registers, no spill); higher minimums spill and lower ones took no
//   less time (the measurement rebuilds the source with -DCATALOG_MIN_BLOCKS).
// * The prior constants and the grids' descriptions are a __grid_constant__
//   kernel parameter (the constant bank): uniform reads.
// * A compact BC table, built once per likelihood: only the wanted band
//   columns, padded with zeros to W = 4, 8 or 16 columns (the instantiated
//   widths), so that a corner is W / 2 aligned pair loads from one or two
//   sectors; 30% faster than the scattered columns of the full table at
//   (256, 256) with 3 bands.
// * Every lane of a warp reaches every shuffle and vote of the cell location:
//   lanes past the batch take a NaN point (no reads) and stay; only a warp
//   wholly past the batch leaves.
// * 64-bit row offsets; instantiated for float and double.

#include "interp_common.cuh"

#ifndef CATALOG_MIN_BLOCKS
#define CATALOG_MIN_BLOCKS 5
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kPackCols = 6;

// the packed prior constants, in the order of ops/catalog.py::CONST_NAMES
enum Const : int {
  kAgeLo, kAgeHi, kAgeLnLn10, kAgeLn10, kAgeLnNorm,
  kFehLo, kFehHi, kFehHalo, kFehDisk, kFehLnNorm, kFehHaloC, kFehHaloMu, kFehHaloVar, kFehDiskC, kFehA1, kFehM1,
  kFehV1, kFehA2, kFehM2, kFehV2,
  kAvLo, kAvHi, kAvLnp,
  kMassLo, kMassHi, kMassBreak, kMassLnNorm0, kMassLnNorm1,
  kLnLo, kLnHi, kLnLnNorm, kLnScale, kLnLogS, kLnSigma, kLnMu, kLnC0,
  kPlLo, kPlHi, kPlLnC, kPlAlpha,
  kEepLo, kEepHi,
  kLos0,  // kLos0 + k: the unit-cube box's bottom on parameter k
  kNConst = kLos0 + 5
};

enum Term : int { kAgeTerm, kFehTerm, kAvTerm, kMassTerm };

struct CatalogArgs {
  const void* pars;   // (S, B, 5): parameters, or unit-cube points when `his` is set
  const void* model;  // (m0, m1, m2, 6) packed model table
  const void* bc;     // (b0, b1, b2, b3, bc_ncols) compact BC table: the band columns, zero-padded
  const void* obs;    // (S, row_len) observation rows
  const void* his;    // (S, 5) box tops of the unit-cube form, or null
  const void* dist;   // (S, 2): d_hi, ln 3 - 3 ln d_hi (posterior)
  void* out;          // (S, B): lnpost (posterior) or ll (likelihood)
  void* orig;         // (S, B) orig_val; in the posterior null unless the caller adds the mass prior
  void* deriv;        // (S, B) (likelihood)
  long long S;
  long long B;
  int io[3];          // grid axis d takes parameter column io[d]
  int n_bands;
  int bc_ncols;       // W: 4, 8 or 16, at least n_bands
  int row_len;        // 6 + 2 n_bands + 2
  int has_plax;       // the catalog has a parallax column
  int on[4];          // the age, [Fe/H], AV and mass priors are the kernel's (Term)
  Axis model_ax[3];
  Axis bc_ax[4];
  double c[kNConst];
};

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

template <typename T>
__device__ __forceinline__ T neg_inf() {
  return -T(INFINITY);
}

// the term of one observation: exactly 0 where the observed value is NaN
template <typename T>
__device__ __forceinline__ T obs_term(T val, T unc, T model_val) {
  const T term = gauss_lnprob<T>(val, unc, model_val);
  return isnan(val) ? T(0) : term;
}

// priors.py::FlatLogPrior (AgePrior) with BoundedPrior's strict bounds
template <typename T>
__device__ T age_lnpdf(T x, const double* c) {
  const T ln = sub_rn(add_rn(mul_rn(x, T(c[kAgeLn10])), T(c[kAgeLnLn10])), T(c[kAgeLnNorm]));
  return (x < T(c[kAgeLo]) || x > T(c[kAgeHi])) ? neg_inf<T>() : ln;
}

// exp(-0.5 (x - mu)^2 / var), in torch's order
template <typename T>
__device__ __forceinline__ T gauss_kernel(T x, double mu, double var) {
  const T r = sub_rn(x, T(mu));
  return d_exp(div_rn(mul_rn(mul_rn(r, r), T(-0.5)), T(var)));
}

// priors.py::FehPrior (local): the halo fraction of the halo Gaussian and the
// rest of the two-Gaussian disk, log(clamp(pdf, 1e-300)) - log(_norm),
// strict bounds
template <typename T>
__device__ T feh_lnpdf(T x, const double* c) {
  const T halo = mul_rn(gauss_kernel(x, c[kFehHaloMu], c[kFehHaloVar]), T(c[kFehHaloC]));
  const T d1 = mul_rn(gauss_kernel(x, c[kFehM1], c[kFehV1]), T(c[kFehA1]));
  const T d2 = mul_rn(gauss_kernel(x, c[kFehM2], c[kFehV2]), T(c[kFehA2]));
  const T disk = mul_rn(add_rn(d1, d2), T(c[kFehDiskC]));
  const T pdf = add_rn(mul_rn(halo, T(c[kFehHalo])), mul_rn(disk, T(c[kFehDisk])));
  const T ln = sub_rn(d_log(clamp_min(pdf, T(1e-300))), T(c[kFehLnNorm]));
  return (x < T(c[kFehLo]) || x > T(c[kFehHi])) ? neg_inf<T>() : ln;
}

// priors.py::FlatPrior (AVPrior)
template <typename T>
__device__ T av_lnpdf(T x, const double* c) {
  return (x < T(c[kAvLo]) || x > T(c[kAvHi])) ? neg_inf<T>() : T(c[kAvLnp]);
}

// priors.py::ChabrierPrior: a BrokenPrior of LogNormalPrior (Prior's inclusive
// bounds where finite) and PowerLawPrior (strict bounds), each with its own
// -inf rules; a NaN counts as above the breakpoint
template <typename T>
__device__ T mass_lnpdf(T x, const double* c) {
  const T y = div_rn(x, T(c[kLnScale]));
  const T lg = d_log(clamp_min(y, T(1e-300)));
  const T z = div_rn(lg, T(c[kLnSigma]));
  T ln0 = sub_rn(sub_rn(sub_rn(T(c[kLnC0]), add_rn(lg, T(c[kLnLogS]))), mul_rn(mul_rn(z, z), T(0.5))), T(c[kLnMu]));
  ln0 = sub_rn(y > T(0) ? ln0 : neg_inf<T>(), T(c[kLnLnNorm]));
  if ((isfinite(c[kLnLo]) && !(x >= T(c[kLnLo]))) || (isfinite(c[kLnHi]) && !(x <= T(c[kLnHi])))) ln0 = neg_inf<T>();
  T ln1 = add_rn(mul_rn(d_log(clamp_min(x, T(1e-300))), T(c[kPlAlpha])), T(c[kPlLnC]));
  if (x < T(c[kPlLo]) || x > T(c[kPlHi])) ln1 = neg_inf<T>();
  const T ln = !(x < T(c[kMassBreak])) ? sub_rn(ln1, T(c[kMassLnNorm1])) : sub_rn(ln0, T(c[kMassLnNorm0]));
  return (x < T(c[kMassLo]) || x > T(c[kMassHi])) ? neg_inf<T>() : ln;
}

template <typename T, int W, bool POST>
__global__ void __launch_bounds__(kThreads, CATALOG_MIN_BLOCKS)
    catalog_lnlike_kernel(const __grid_constant__ CatalogArgs a) {
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;  // (star, point), star-major; the launch keeps S * B < 2^31
  const long long n = a.S * a.B;
  if ((long long)(q & ~31u) >= n) return;  // the whole warp lies past the batch
  const bool active = q < n;
  const long long qc = active ? q : n - 1;
  const long long star = qc / a.B;
  const T* p = static_cast<const T*>(a.pars) + qc * 5;
  T x[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) x[k] = p[k];
  if (POST && a.his) {  // fit_multinest's box map: los + (his - los) * u, rounded as torch rounds it
    const T* hi = static_cast<const T*>(a.his) + star * 5;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const T lo = T(a.c[kLos0 + k]);
      x[k] = add_rn(lo, mul_rn(sub_rn(hi[k], lo), x[k]));
    }
  }
  if (!active) x[0] = T(NAN);  // an idle lane's point is NaN: no reads
  const T eep = x[0], age = x[1], feh = x[2], dist = x[3], av = x[4];
  auto user = [&](int i) { return i == 0 ? eep : i == 1 ? age : feh; };  // selects: no local memory

  const T gx[3] = {user(a.io[0]), user(a.io[1]), user(a.io[2])};
  T v[kPackCols];
  interp_group<T, 3, 1, kPackCols, 2>(static_cast<const T*>(a.model), a.model_ax, gx, kPackCols, nullptr,
                                         kPackCols, 0, v);
  T mags[kMaxBands];  // the BC values, then the magnitudes
  if (a.n_bands > 0) {
    const T bx[4] = {v[0], v[1], v[2], av};
    interp_group<T, 4, 1, W, 2>(static_cast<const T*>(a.bc), a.bc_ax, bx, W, nullptr, W, 0, mags);
  }

  if (!active) return;

  const T* o = static_cast<const T*>(a.obs) + star * a.row_len;
  T ll = T(0);
  for (int k = 0; k < 3; ++k) ll += obs_term<T>(o[k], o[3 + k], v[k]);
  if (a.n_bands > 0) {
    const T dist_mod = T(5) * d_log10(dist / T(10));
    const T* mv = o + 6;
    const T* mu = mv + a.n_bands;
    T phot = T(0);
#pragma unroll
    for (int k = 0; k < kMaxBands; ++k) {
      if (k == a.n_bands) break;
      phot += obs_term<T>(mv[k], mu[k], v[3] + dist_mod - mags[k]);
    }
    ll += phot;
  }
  if (a.has_plax) {
    const T* pl = o + 6 + 2 * a.n_bands;
    ll += obs_term<T>(pl[0], pl[1], T(1000) / dist);
  }
  if constexpr (POST) {
    // the prior terms in the plain version's order: age, [Fe/H], AV,
    // distance, EEP
    const double* c = a.c;
    T lnp = a.on[kAgeTerm] ? age_lnpdf(age, c) : T(0);
    if (a.on[kFehTerm]) lnp = add_rn(lnp, feh_lnpdf(feh, c));
    if (a.on[kAvTerm]) lnp = add_rn(lnp, av_lnpdf(av, c));
    const T* dr = static_cast<const T*>(a.dist) + star * 2;  // ln 3 - 3 ln d_hi + 2 ln d on 0 < d < d_hi
    const T lnd = add_rn(dr[1], mul_rn(d_log(clamp_min(dist, T(1e-300))), T(2)));
    lnp = add_rn(lnp, (dist > T(0) && dist < dr[0]) ? lnd : neg_inf<T>());
    const T orig = v[4], deriv = v[5];  // the EEP change of variables
    T e = add_rn(a.on[kMassTerm] ? mass_lnpdf(orig, c) : T(0), d_log(clamp_min(deriv, T(1e-300))));
    e = (isfinite(orig) && deriv > T(0)) ? e : neg_inf<T>();
    e = (eep < T(c[kEepLo]) || eep > T(c[kEepHi])) ? neg_inf<T>() : e;
    lnp = add_rn(lnp, e);
    ll = isnan(ll) ? neg_inf<T>() : ll;
    static_cast<T*>(a.out)[q] = isfinite(lnp) ? add_rn(lnp, ll) : neg_inf<T>();
    if (a.orig) static_cast<T*>(a.orig)[q] = v[4];
  } else {
    static_cast<T*>(a.out)[q] = ll;
    static_cast<T*>(a.orig)[q] = v[4];
    static_cast<T*>(a.deriv)[q] = v[5];
  }
}

template <typename T, int W, bool POST>
cudaError_t launch_w(const CatalogArgs& a, cudaStream_t st) {
  const long long blocks = (a.S * a.B + kThreads - 1) / kThreads;
  catalog_lnlike_kernel<T, W, POST><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool POST>
int launch(const CatalogArgs* args, void* stream) {
  const CatalogArgs& a = *args;
  if (a.S < 0 || a.B < 0 || a.S * a.B >= (1LL << 31) || a.n_bands < 0 || a.n_bands > a.bc_ncols ||
      a.row_len != 8 + 2 * a.n_bands || (POST && !a.dist) || (!POST && (a.his || !a.orig || !a.deriv)))
    return (int)cudaErrorInvalidValue;
  if (a.S == 0 || a.B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.bc_ncols) {  // the compact table's instantiated widths only
    case 4: return (int)launch_w<T, 4, POST>(a, st);
    case 8: return (int)launch_w<T, 8, POST>(a, st);
    case 16: return (int)launch_w<T, 16, POST>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int catalog_lnlike_max_bands() { return kMaxBands; }

int catalog_lnlike_args_size() { return (int)sizeof(CatalogArgs); }

int catalog_lnlike_n_consts() { return kNConst; }

// `args` points to a CatalogArgs (void*: see star_lnlike.cu)
int catalog_lnlike_f32(const void* args, void* stream) {
  return launch<float, false>(static_cast<const CatalogArgs*>(args), stream);
}

int catalog_lnlike_f64(const void* args, void* stream) {
  return launch<double, false>(static_cast<const CatalogArgs*>(args), stream);
}

int catalog_lnpost_f32(const void* args, void* stream) {
  return launch<float, true>(static_cast<const CatalogArgs*>(args), stream);
}

int catalog_lnpost_f64(const void* args, void* stream) {
  return launch<double, true>(static_cast<const CatalogArgs*>(args), stream);
}

}  // extern "C"
