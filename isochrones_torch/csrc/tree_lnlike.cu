// Observation-tree log-likelihood: one thread per point, one launch per call.
//
// Replaces the tree likelihood that the JAX package leaves to XLA to fuse,
// isochrones_tpu/observation.py:1269-1361 (make_tree_lnlike). For each point
// (row of `pars`, n_params values: per system its stars' EEPs, then age, feh,
// distance, AV) and each model star s of the plan it
//
//   1. gathers the star's 5 parameters through star_param_idx;
//   2. lerps (Teff, logg, feh, Mbol) on the 3 axes of the packed model table,
//      and the density column of the full table when a spectroscopy or limit
//      row needs it;
//   3. lerps the plan's bands on the 4 axes of the BC table at
//      (Teff, logg, feh, AV) and forms the star's fluxes
//      10^(-0.4 (Mbol + 5 log10(d / 10) - BC));
//   4. adds the fluxes into every observation row through the membership
//      matrix. A NaN flux (an off-grid star) is zeroed before the sum and
//      remembered per row, so only rows that contain that star go bad;
//   5. adds the star's Gaussian spectroscopy terms and checks its limits;
//
// then turns the rows' flux sums into magnitudes, takes relative rows (and
// their observed values) against their reference row, adds the active rows'
// Gaussian terms, the parallax and AV terms of each system, and writes
// -inf where an active row (or its reference row) is bad, a spectroscopy
// value is not finite, a limit is broken, or the sum is NaN.
//
// Semantics are those of the plain version (isochrones_torch/ops/tree.py),
// interpolation included (interp_common.cuh, shared with star_lnlike.cu).
// There are no atomics: a point's result does not depend on the launch.
//
// What bounds it: latency of dependent gathers, as for the star kernel. Per
// point and star it reads 8 rows of the model pack and 16 short rows of the
// BC table at addresses known only after a cell search, the BC search waits
// for the model step, and here the stars of a point follow each other in one
// thread. The bytes a batch must move (parameters, the output, the table
// rows it touches) take well under a microsecond at the nested fit's 1024
// points.
//
// Design: the simple one. One thread per point (the shared interpolation
// code at a group width of 1), a loop over the stars, the rows' flux sums in
// a per-thread array. The plan (index and value arrays of a few dozen
// entries) is read from device memory at addresses uniform across a warp.
// Caps, checked by the wrapper and here: kMaxStars stars, kMaxObs
// observation rows, kMaxBands bands.

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBands = 16;
constexpr int kMaxStars = 16;
constexpr int kMaxObs = 64;

struct TreeArgs {
  const void* pars;        // (B, P)
  void* ll;                // (B,)
  const void* model;       // (m0, m1, m2, 4) packed model table: Teff, logg, feh, Mbol
  const void* dens_table;  // (m0, m1, m2, dens_row_len) full model table, or null
  const void* bc;          // (b0, b1, b2, b3, bc_ncols) BC table
  // the plan; value arrays are of the grids' dtype, index arrays int32
  const int* star_param_idx;  // (n_stars, 5)
  const void* member;         // (n_obs, n_stars) 0/1
  const int* obs_band;        // (n_obs,) index into band_cols
  const void* obs_val;
  const void* obs_unc;
  const int* obs_ref;     // (n_obs,) reference row, -1 for an absolute row
  const int* obs_active;  // (n_obs,) 0/1
  const int* spec_star;   // (n_spec,)
  const int* spec_prop;   // 0 Teff, 1 logg, 2 feh, 3 density
  const void* spec_val;
  const void* spec_unc;
  const int* lim_star;  // (n_lim,)
  const int* lim_prop;
  const void* lim_lo;
  const void* lim_hi;
  const int* plax_idx;  // (n_plax,) parameter column of the distance
  const void* plax_val;
  const void* plax_unc;
  const int* av_idx;  // (n_av,) parameter column of AV
  const void* av_val;
  const void* av_unc;
  long long B;
  int P;
  int n_stars;
  int n_obs;
  int n_bands;
  int n_spec;
  int n_lim;
  int n_plax;
  int n_av;
  int io[5];  // user order -> (grid axis 0, 1, 2, distance, AV)
  int bc_ncols;
  int dens_row_len;
  int dens_col;
  int band_cols[kMaxBands];
  Axis model_ax[3];
  Axis bc_ax[4];
};

// the Gaussian term of observation.py, with its +log(unc) constant
template <typename T>
__device__ __forceinline__ T tree_gauss(T val, T unc, T mod) {
  const T resid = val - mod;
  return T(-0.5) * resid * resid / (unc * unc) + T(-0.91893853320467274178) + d_log(unc);
}

template <typename T>
__device__ __forceinline__ bool finite_t(T x) {
  return !isnan(x) && !isinf(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tree_lnlike_kernel(const __grid_constant__ TreeArgs a) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  // a whole warp past the batch leaves; a partial warp keeps its idle lanes
  // (on the last point), because the cell searches vote across the warp
  if ((tid & ~31LL) >= a.B) return;
  const bool in_range = tid < a.B;
  const long long b = in_range ? tid : a.B - 1;
  const T* p = static_cast<const T*>(a.pars) + b * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* dens_table = static_cast<const T*>(a.dens_table);
  const T* bc = static_cast<const T*>(a.bc);
  const T* member = static_cast<const T*>(a.member);
  const T* obs_val = static_cast<const T*>(a.obs_val);
  const T* obs_unc = static_cast<const T*>(a.obs_unc);
  const int n_stars = a.n_stars, n_obs = a.n_obs, n_bands = a.n_bands;

  T row[kMaxObs];  // the rows' flux sums, then their magnitudes
  for (int o = 0; o < n_obs; ++o) row[o] = T(0);
  unsigned long long row_bad = 0;  // bit o: row o holds an off-grid star or has no finite magnitude
  T spec_ll = T(0);
  bool bad = false;

  for (int s = 0; s < n_stars; ++s) {
    const int* idx = a.star_param_idx + 5 * s;
    const T sp[5] = {p[idx[0]], p[idx[1]], p[idx[2]], p[idx[3]], p[idx[4]]};
    auto par = [&](int i) { return i == 0 ? sp[0] : i == 1 ? sp[1] : i == 2 ? sp[2] : i == 3 ? sp[3] : sp[4]; };
    const T gx[3] = {par(a.io[0]), par(a.io[1]), par(a.io[2])};
    T v[4];
    interp_group<T, 3, 1, 4>(model, a.model_ax, gx, 4, nullptr, 4, 0, v);
    T dens = T(0);
    if (dens_table != nullptr) {
      T d[1];
      interp_group<T, 3, 1, 1>(dens_table, a.model_ax, gx, a.dens_row_len, &a.dens_col, 1, 0, d);
      dens = d[0];
    }

    if (n_obs > 0) {
      T flux[kMaxBands];  // the BC values, then the star's fluxes
      const T bx[4] = {v[0], v[1], v[2], par(a.io[4])};
      interp_group<T, 4, 1, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, n_bands, 0, flux);
      const T dist_mod = T(5) * d_log10(par(a.io[3]) / T(10));
      for (int k = 0; k < n_bands; ++k) flux[k] = d_pow(T(10), T(-0.4) * (v[3] + dist_mod - flux[k]));
      for (int o = 0; o < n_obs; ++o) {
        const T m = member[o * n_stars + s];
        const T f = flux[a.obs_band[o]];
        const bool f_nan = isnan(f);
        // the product is kept (0 * inf is NaN in the plain version's sum too)
        row[o] += (f_nan ? T(0) : f) * m;
        if (f_nan && m > T(0)) row_bad |= 1ULL << o;
      }
    }

    auto prop = [&](int k) { return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : dens; };
    for (int r = 0; r < a.n_spec; ++r) {
      if (a.spec_star[r] != s) continue;
      const T mod = prop(a.spec_prop[r]);
      spec_ll += tree_gauss<T>(static_cast<const T*>(a.spec_val)[r], static_cast<const T*>(a.spec_unc)[r], mod);
      if (!finite_t(mod)) bad = true;
    }
    for (int r = 0; r < a.n_lim; ++r) {
      if (a.lim_star[r] != s) continue;
      const T mod = prop(a.lim_prop[r]);
      if (mod < static_cast<const T*>(a.lim_lo)[r] || mod > static_cast<const T*>(a.lim_hi)[r] || !finite_t(mod))
        bad = true;
    }
  }

  T ll = T(0);
  for (int o = 0; o < n_obs; ++o) {
    const T mm = T(-2.5) * d_log10(row[o]);
    row[o] = mm;
    if (!finite_t(mm)) row_bad |= 1ULL << o;
  }
  for (int o = 0; o < n_obs; ++o) {
    if (a.obs_active[o] == 0) continue;
    const int ref = a.obs_ref[o];
    const bool is_rel = ref >= 0;
    const T mod = is_rel ? row[o] - row[ref] : row[o];
    const T val = is_rel ? obs_val[o] - obs_val[ref] : obs_val[o];
    ll += tree_gauss<T>(val, obs_unc[o], mod);
    if (((row_bad >> o) & 1ULL) || (is_rel && ((row_bad >> ref) & 1ULL))) bad = true;
  }
  ll += spec_ll;
  for (int r = 0; r < a.n_plax; ++r) {
    const T mod = T(1000) / p[a.plax_idx[r]];
    ll += tree_gauss<T>(static_cast<const T*>(a.plax_val)[r], static_cast<const T*>(a.plax_unc)[r], mod);
  }
  for (int r = 0; r < a.n_av; ++r) {
    ll += tree_gauss<T>(static_cast<const T*>(a.av_val)[r], static_cast<const T*>(a.av_unc)[r], p[a.av_idx[r]]);
  }
  if (bad || isnan(ll)) ll = -INFINITY;
  if (in_range) static_cast<T*>(a.ll)[b] = ll;
}

template <typename T>
int launch(const TreeArgs* args, void* stream) {
  const TreeArgs& a = *args;
  if (a.B < 0 || a.P < 5 || a.n_stars < 1 || a.n_stars > kMaxStars || a.n_obs < 0 || a.n_obs > kMaxObs ||
      a.n_bands < 0 || a.n_bands > kMaxBands || a.n_spec < 0 || a.n_lim < 0 || a.n_plax < 0 || a.n_av < 0)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const long long blocks = (a.B + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  tree_lnlike_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tree_lnlike_max_bands() { return kMaxBands; }

int tree_lnlike_max_stars() { return kMaxStars; }

int tree_lnlike_max_obs() { return kMaxObs; }

int tree_lnlike_args_size() { return (int)sizeof(TreeArgs); }

const char* tree_lnlike_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// `args` points to a TreeArgs; it is passed as void* because a parameter of a
// type from the unnamed namespace would give these functions internal linkage
int tree_lnlike_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const TreeArgs*>(args), stream);
}

int tree_lnlike_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const TreeArgs*>(args), stream);
}

}  // extern "C"
