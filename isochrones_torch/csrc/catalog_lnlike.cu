// Catalog log-likelihood: every star of a catalog with its own observations,
// a group of lanes per (star, point).
//
// Replaces the likelihood half of the JAX package's catalog posterior,
// isochrones_tpu/batch.py:145-192 (_build_lnpost_data), which XLA compiles
// into one TPU fusion. For parameters (S, B, 5) in the order (eep, age, feh,
// distance, AV) it
//
//   1. locates the cell on the 3 model-grid axes and lerps the 8 corner rows of
//      the 6-column packed table (Teff, logg, feh, Mbol, the EEP-prior
//      quantity and its d/dEEP derivative);
//   2. locates the cell on the 4 BC-grid axes at (Teff, logg, feh, AV) and
//      lerps the wanted band columns of the 16 corner rows;
//   3. forms the magnitudes Mbol + 5 log10(d / 10) - BC;
//
// then adds the star's own Gaussian spectroscopy terms, photometry terms and
// parallax term, each of which adds exactly 0 where the star's observed value
// is NaN (selected term by term, before any sum), and writes ll (S, B),
// orig_val (S, B), deriv (S, B). The priors, the NaN -> -inf of ll and the
// per-star distance bound stay in torch around the call
// (isochrones_torch/batch.py).
//
// Semantics are those of the plain version (isochrones_torch/ops/catalog.py
// and ops/interp.py), through interp_common.cuh: cell location step for step
// with explicitly rounded arithmetic, every corner's product in the sum
// (weight 0 included, so 0 * NaN poisons as in torch), a NaN or out-of-bounds
// coordinate makes the row NaN.
//
// What bounds it: as the star kernel (star_lnlike.cu), latency of dependent
// gathers: per point 8 rows of the model pack and 16 short rows of the BC
// table at data-dependent addresses, each known only after a cell search.
// The bytes are the parameters, the outputs, the rows a batch touches and the
// observation rows.
//
// Design:
// * The star kernel keeps one star's observations in its __grid_constant__
//   struct; here every star has its own, so they are one (S, row_len) block
//   in global memory: [Teff, logg, feh | their errors | n_bands magnitudes |
//   their errors | parallax, its error]. A star's row is read by the lane
//   that forms the likelihood; the B points of a star are consecutive teams,
//   so its row is fetched once and then served from L1/L2.
// * A group of G lanes per (star, point) shares the corners of both lerps
//   (interp_group) and sums them with xor shuffles; G from the number of
//   points S * B (group_lanes: 16 while S * B * G stays within about a full
//   card of threads, down to 1).
// * The grids' descriptions and the band columns are a __grid_constant__
//   kernel parameter (the constant bank), as in the star kernel.
// * Every lane of a warp reaches every shuffle: lanes past the batch take a
//   NaN point (no reads) and stay; only a warp wholly past the batch leaves.
// * 64-bit row offsets; instantiated for float and double.

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kPackCols = 6;
constexpr int kMaxGroup = 16;
constexpr long long kFillThreads = 1LL << 18;

struct CatalogArgs {
  const void* pars;  // (S, B, 5)
  const void* model;  // (m0, m1, m2, 6) packed model table
  const void* bc;     // (b0, b1, b2, b3, bc_ncols) BC table
  const void* obs;    // (S, row_len) observation rows
  void* ll;           // (S, B)
  void* orig;         // (S, B)
  void* deriv;        // (S, B)
  long long S;
  long long B;
  int io[3];          // grid axis d takes parameter column io[d]
  int n_bands;
  int bc_ncols;
  int row_len;        // 6 + 2 n_bands + 2
  int has_plax;       // the catalog has a parallax column
  int band_cols[kMaxBands];
  Axis model_ax[3];
  Axis bc_ax[4];
};

// the term of one observation: exactly 0 where the observed value is NaN
template <typename T>
__device__ __forceinline__ T obs_term(T val, T unc, T model_val) {
  const T term = gauss_lnprob<T>(val, unc, model_val);
  return isnan(val) ? T(0) : term;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 5 : 1) catalog_lnlike_kernel(const __grid_constant__ CatalogArgs a) {
  constexpr unsigned kShift = G == 16 ? 4 : G == 8 ? 3 : G == 4 ? 2 : G == 2 ? 1 : 0;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps S * B * G < 2^31
  const long long n = a.S * a.B;
  if ((long long)((tid & ~31u) >> kShift) >= n) return;  // the whole warp lies past the batch
  const long long q = tid >> kShift;  // (star, point), star-major
  const int l = (int)(tid % G);
  const bool active = q < n;
  const long long qc = active ? q : n - 1;
  const T* p = static_cast<const T*>(a.pars) + qc * 5;
  const T eep = active ? p[0] : T(NAN);  // an idle lane's point is NaN: no reads
  const T age = p[1], feh = p[2], dist = p[3], av = p[4];
  auto user = [&](int i) { return i == 0 ? eep : i == 1 ? age : feh; };

  const T gx[3] = {user(a.io[0]), user(a.io[1]), user(a.io[2])};
  T v[kPackCols];
  interp_group<T, 3, G, kPackCols, true>(static_cast<const T*>(a.model), a.model_ax, gx, kPackCols, nullptr,
                                         kPackCols, l, v);
  T mags[kMaxBands];  // the BC values, then the magnitudes
  if (a.n_bands > 0) {
    const T bx[4] = {v[0], v[1], v[2], av};
    interp_group<T, 4, G, kMaxBands>(static_cast<const T*>(a.bc), a.bc_ax, bx, a.bc_ncols, a.band_cols, a.n_bands,
                                     l, mags);
  }
  if (!active || l != 0) return;

  const T* o = static_cast<const T*>(a.obs) + (q / a.B) * a.row_len;
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
  static_cast<T*>(a.ll)[q] = ll;
  static_cast<T*>(a.orig)[q] = v[4];
  static_cast<T*>(a.deriv)[q] = v[5];
}

int group_lanes(long long n) {
  int g = kMaxGroup;
  while (g > 1 && n * g > kFillThreads) g >>= 1;
  return g;
}

template <typename T, int G>
cudaError_t launch_g(const CatalogArgs& a, cudaStream_t st) {
  const long long threads = a.S * a.B * G;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  catalog_lnlike_kernel<T, G><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const CatalogArgs* args, void* stream) {
  const CatalogArgs& a = *args;
  if (a.S < 0 || a.B < 0 || a.n_bands < 0 || a.n_bands > kMaxBands || a.row_len != 8 + 2 * a.n_bands)
    return (int)cudaErrorInvalidValue;
  if (a.S == 0 || a.B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group_lanes(a.S * a.B)) {
    case 16: return (int)launch_g<T, 16>(a, st);
    case 8: return (int)launch_g<T, 8>(a, st);
    case 4: return (int)launch_g<T, 4>(a, st);
    case 2: return (int)launch_g<T, 2>(a, st);
    default: return (int)launch_g<T, 1>(a, st);
  }
}

}  // namespace

extern "C" {

int catalog_lnlike_max_bands() { return kMaxBands; }

int catalog_lnlike_args_size() { return (int)sizeof(CatalogArgs); }

int catalog_lnlike_group_lanes(long long n) { return group_lanes(n); }

// `args` points to a CatalogArgs (void*: see star_lnlike.cu)
int catalog_lnlike_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const CatalogArgs*>(args), stream);
}

int catalog_lnlike_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const CatalogArgs*>(args), stream);
}

}  // extern "C"
