// Observation-tree log-likelihood and the EEP prior's two columns: a team of
// lanes per point, one launch per call.
//
// Replaces the tree likelihood that the JAX package leaves to XLA to fuse,
// isochrones_tpu/observation.py:1269-1361 (make_tree_lnlike), and the
// interpolation that its tree prior repeats per star
// (isochrones_tpu/treemodel.py:370-406). For each point (row of `pars`,
// n_params values: per system its stars' EEPs, then age, feh, distance, AV)
// and each model star s of the plan it
//
//   1. gathers the star's 5 parameters through star_par;
//   2. lerps the 6 columns of the packed model table (Teff, logg, feh, Mbol,
//      the EEP-prior quantity and its d/dEEP derivative) on its 3 axes, and
//      the density column of the full table when a spectroscopy or limit row
//      needs it; the prior's two columns go out as orig (B, n_stars) and
//      deriv (B, n_stars), NaN where the star is off the grid;
//   3. lerps the plan's bands on the 4 axes of the BC table at
//      (Teff, logg, feh, AV) and forms the star's fluxes
//      10^(-0.4 (Mbol + 5 log10(d / 10) - BC));
//
// then, per observation row, sums the member stars' fluxes (a NaN flux, an
// off-grid star, is zeroed before the sum and makes the rows that hold the
// star bad; the product with the membership value is kept, so 0 * inf of a
// non-member is NaN as in the plain version's sum), turns the sums into
// magnitudes, takes relative rows (and their observed values) against their
// reference row, adds the active rows' Gaussian terms, the spectroscopy terms
// and limits of each star, the parallax and AV terms of each system, and
// writes -inf where an active row (or its reference row) is bad, a
// spectroscopy value is not finite, a limit is broken, or the sum is NaN.
//
// Semantics are those of the plain version (isochrones_torch/ops/tree.py),
// interpolation included (interp_common.cuh, shared with star_lnlike.cu).
// There are no atomics, and every sum is taken in an order fixed by the
// launch geometry: a point's result does not depend on the launch.
//
// What bounds it: latency of dependent gathers, not bytes or arithmetic. Per
// point and star it reads 8 rows of the model pack and 16 short rows of the
// BC table at addresses known only after a cell search, and the BC search
// waits for the model step's Teff/logg/feh; the bytes a batch must move
// (parameters, outputs, the table rows it touches) take well under a
// microsecond at the nested fit's 1024 points. No tile of either table is
// contiguous and there is no matrix product, so TMA and the tensor cores have
// nothing to take; the one contiguous read, the plan, is a few hundred bytes
// and goes to shared memory by cp.async behind the first cell search.
//
// Design, against that bound:
// * A team of NP * G lanes per point, NP = n_stars rounded up to a power of
//   two: a group of G lanes per star, the stars' groups side by side, as in
//   star_lnlike.cu. Each lane of a group takes corners i = l, l + G, ... of
//   both lerps (a row of the pack two columns per load), so a star's 8 + 16
//   row reads are in flight together (the two passes of cell location in
//   interp_common.cuh start every knot read of a point's axes before
//   deciding any cell), and all stars of a point go at once. A team never
//   spans warps; G follows the batch (launch_geometry): as wide as 32 / NP
//   allows (at most 16) while B * NP * G stays within kFillThreads, halving
//   down to 1 at large batches. B = 1024 with 3 stars takes G = 8 (one warp
//   per point).
// * Once the batch fills the card at G = 1, a padded group only adds warps
//   that issue every instruction for nothing, so there the team shrinks to
//   the number of groups, a power of two, that leaves the fewest idle star
//   slots, and a group takes its stars in turn (stars sg, sg + groups, ...):
//   B = 131072 with 3 stars takes one lane per point and three rounds, 6
//   stars two groups and three rounds, 16 stars 16 groups and one. On an
//   H100 that read 0.126 against 0.130 ms in float32 and 0.205 against
//   0.224 ms in float64 at 131072 points of 3 stars.
// * The stars meet in shared memory: each group writes its star's fluxes and
//   (Teff, logg, feh, density) into the team's scratch, and then the team's
//   lanes share out the rows: lane j takes rows j, j + team, ... of the
//   observation rows (summing the stars' fluxes in star order, as the plain
//   version's sum does), then of the active rows' Gaussian terms, the
//   spectroscopy rows, the limits, the parallax and AV rows. Row magnitudes
//   live in the team's scratch (a bad row's as NaN), not in a per-thread
//   array. The lanes' partial sums meet in an xor-shuffle sum over the team,
//   the -inf flags in a ballot.
// * The plan is one packed block that the wrapper builds once per plan
//   (observed values, then one descriptor word per row: band, reference row,
//   active flag and a 16-bit membership mask; star and property of each
//   spectroscopy and limit row; parameter columns of parallax and AV rows).
//   A block copies it to shared memory once; the stars' parameter columns
//   and the band columns ride in the __grid_constant__ argument struct.
// * Every shuffle, vote and barrier is reached by all lanes: padded stars'
//   groups and teams past the batch run on a NaN point (no table reads),
//   serve as row workers where they can, and write nothing; every branch
//   around a lerp is uniform across the grid (plan-level conditions only).
// * Registers at G = 1, where the batch fills the card: held to 128 by
//   __launch_bounds__(128, 4), 4 blocks and 16 warps per SM, without spills
//   in float32. At 131072 points of 3 stars (H100, float32 / float64) that
//   read 0.120 / 0.191 ms; 5 blocks (96 registers, spills) 0.126 / 0.205,
//   6 blocks 0.133-0.144 / 0.275, 3 blocks 0.147-0.149 / 0.219. The wide
//   groups run one warp or less per point on a card they do not fill, and
//   take what the compiler gives them (106 registers, 142 in float64).
// Caps, checked by the wrapper and here: kMaxStars stars, kMaxObs observation
// rows, kMaxBands bands, kMaxProps spectroscopy rows and as many limits.
//
// The float64 entry points are built from tree_lnlike_f64.cu, this file
// compiled with TREE_F64_UNIT, so that both types build in parallel.

#include <cuda_pipeline_primitives.h>

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxStars = 16;
constexpr int kMaxObs = 64;
constexpr int kMaxProps = 4 * kMaxStars;  // Teff, logg, feh, density of every star
constexpr int kPackCols = 6;
constexpr int kMaxGroup = 16;  // at most 16 lanes per group
constexpr long long kFillThreads = 1LL << 18;
constexpr int kStaticShared = 48 * 1024;
constexpr int kMaxShared = 227 * 1024;

struct TreeArgs {
  const void* pars;        // (B, P)
  void* ll;                // (B,)
  void* orig;              // (B, n_stars)
  void* deriv;             // (B, n_stars)
  const void* model;       // (m0, m1, m2, 6) packed model table
  const void* dens_table;  // (m0, m1, m2, dens_row_len) full model table, or null
  const void* bc;          // (b0, b1, b2, b3, bc_ncols) BC table
  // The packed plan, plan_bytes (a multiple of 16) long. Values of the
  // grids' dtype: obs_val, obs_unc (n_obs each), spec_val, spec_unc (n_spec),
  // lim_lo, lim_hi (n_lim), plax_val, plax_unc (n_plax), av_val, av_unc
  // (n_av); then 32-bit words: per observation row band | (ref + 1) << 4 |
  // active << 11 | member mask << 16, per spectroscopy row and per limit
  // star | prop << 8 (prop: 0 Teff, 1 logg, 2 feh, 3 density), the parameter
  // column of each parallax row's distance and of each AV row's AV.
  const void* plan;
  long long B;
  int P;
  int n_stars;
  int n_obs;
  int n_bands;
  int n_spec;
  int n_lim;
  int n_plax;
  int n_av;
  int plan_bytes;
  int io[5];  // user order -> (grid axis 0, 1, 2, distance, AV)
  int bc_ncols;
  int dens_row_len;
  int dens_col;
  int band_cols[kMaxBands];
  short star_par[kMaxStars][5];  // parameter columns of each star's 5 parameters
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

// values of the grids' dtype that a team keeps in shared memory: its stars'
// fluxes and 4 properties, and the rows' magnitudes
__host__ __device__ __forceinline__ int team_scratch(int n_stars, int n_bands, int n_obs) {
  return n_stars * (n_bands + 4) + n_obs;
}

// teams of G << np_shift lanes (1 to 16 star groups, each taking stars sg,
// sg + groups, ...); a team never straddles a warp
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 4 : 1)
    tree_lnlike_kernel(const __grid_constant__ TreeArgs a, int np_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  {
    const char* src = static_cast<const char*>(a.plan);
    for (int i = threadIdx.x; i < (a.plan_bytes >> 4); i += kThreads)
      __pipeline_memcpy_async(smem + 16 * i, src + 16 * i, 16);
    __pipeline_commit();
  }
  const int n_stars = a.n_stars, n_obs = a.n_obs, n_bands = a.n_bands;
  const int team = G << np_shift;
  const unsigned tshift = __ffs(team) - 1;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps B * team < 2^31
  const long long b = tid >> tshift;
  const int j = (int)(tid & (team - 1));  // lane of the team
  const int sg = j / G;                   // star group
  const int l = j % G;                    // lane of the group
  const bool valid = b < a.B;
  const T* p = static_cast<const T*>(a.pars) + (valid ? b : a.B - 1) * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* dens_table = static_cast<const T*>(a.dens_table);
  const T* bc = static_cast<const T*>(a.bc);
  T* scratch = reinterpret_cast<T*>(smem + a.plan_bytes) +
               (threadIdx.x >> tshift) * team_scratch(n_stars, n_bands, n_obs);
  T* flux_sm = scratch;                      // [n_stars][n_bands]
  T* prop_sm = flux_sm + n_stars * n_bands;  // [n_stars][4]
  T* mag_sm = prop_sm + 4 * n_stars;         // [n_obs]

  // every group makes the same number of rounds: the lerps vote and shuffle
  const int groups = 1 << np_shift;
  const int padded_stars = (n_stars + groups - 1) & ~(groups - 1);
  for (int s = sg; s < padded_stars; s += groups) {
    const bool active = valid && s < n_stars;
    const short* idx = a.star_par[active ? s : 0];
    // an idle group's star is NaN: no table reads
    const T sp[5] = {active ? p[idx[0]] : T(NAN), p[idx[1]], p[idx[2]], p[idx[3]], p[idx[4]]};
    auto par = [&](int i) { return i == 0 ? sp[0] : i == 1 ? sp[1] : i == 2 ? sp[2] : i == 3 ? sp[3] : sp[4]; };
    const T gx[3] = {par(a.io[0]), par(a.io[1]), par(a.io[2])};
    T v[kPackCols];
    interp_group<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, v);
    T dens = T(0);
    if (dens_table != nullptr) {
      T d[1];
      interp_group<T, 3, G, 1>(dens_table, a.model_ax, gx, a.dens_row_len, &a.dens_col, 1, l, d);
      dens = d[0];
    }
    if (active && l == 0) {
      static_cast<T*>(a.orig)[b * n_stars + s] = v[4];
      static_cast<T*>(a.deriv)[b * n_stars + s] = v[5];
      prop_sm[4 * s + 0] = v[0];
      prop_sm[4 * s + 1] = v[1];
      prop_sm[4 * s + 2] = v[2];
      prop_sm[4 * s + 3] = dens;
    }
    if (n_obs > 0) {
      T flux[kMaxBands];  // the BC values, then the star's fluxes
      const T bx[4] = {v[0], v[1], v[2], par(a.io[4])};
      interp_group<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, n_bands, l, flux);
      const T dist_mod = T(5) * d_log10(par(a.io[3]) / T(10));
      if (active && l == 0) {
#pragma unroll
        for (int k = 0; k < kMaxBands; ++k) {
          if (k == n_bands) break;
          flux_sm[s * n_bands + k] = d_pow(T(10), T(-0.4) * (v[3] + dist_mod - flux[k]));
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the plan and every team's stars are in shared memory

  const T* obs_val = reinterpret_cast<const T*>(smem);
  const T* obs_unc = obs_val + n_obs;
  const T* spec_val = obs_unc + n_obs;
  const T* spec_unc = spec_val + a.n_spec;
  const T* lim_lo = spec_unc + a.n_spec;
  const T* lim_hi = lim_lo + a.n_lim;
  const T* plax_val = lim_hi + a.n_lim;
  const T* plax_unc = plax_val + a.n_plax;
  const T* av_val = plax_unc + a.n_plax;
  const T* av_unc = av_val + a.n_av;
  const unsigned* obs_desc = reinterpret_cast<const unsigned*>(av_unc + a.n_av);
  const unsigned* spec_desc = obs_desc + n_obs;
  const unsigned* lim_desc = spec_desc + a.n_spec;
  const unsigned* plax_idx = lim_desc + a.n_lim;
  const unsigned* av_idx = plax_idx + a.n_plax;

  // the rows' magnitudes; a row that holds an off-grid star is kept as NaN
  for (int o = j; o < n_obs; o += team) {
    const unsigned d = obs_desc[o];
    const int band = d & 15u;
    const unsigned member = d >> 16;
    T sum = T(0);
    bool off_grid = false;
    for (int t = 0; t < n_stars; ++t) {
      const T f = flux_sm[t * n_bands + band];
      const bool f_nan = isnan(f);
      const bool m = (member >> t) & 1u;
      // the product is kept (0 * inf is NaN in the plain version's sum too)
      sum += (f_nan ? T(0) : f) * (m ? T(1) : T(0));
      off_grid = off_grid || (f_nan && m);
    }
    mag_sm[o] = off_grid ? T(NAN) : T(-2.5) * d_log10(sum);
  }
  __syncwarp();

  T ll = T(0);
  bool bad = false;
  for (int o = j; o < n_obs; o += team) {
    const unsigned d = obs_desc[o];
    if (((d >> 11) & 1u) == 0) continue;
    const int ref = (int)((d >> 4) & 127u) - 1;
    const bool is_rel = ref >= 0;
    const T mo = mag_sm[o];
    const T mr = is_rel ? mag_sm[ref] : T(0);
    const T val = is_rel ? obs_val[o] - obs_val[ref] : obs_val[o];
    ll += tree_gauss<T>(val, obs_unc[o], is_rel ? mo - mr : mo);
    if (!finite_t(mo) || !finite_t(mr)) bad = true;
  }
  for (int r = j; r < a.n_spec; r += team) {
    const unsigned d = spec_desc[r];
    const T mod = prop_sm[4 * (d & 255u) + (d >> 8)];
    ll += tree_gauss<T>(spec_val[r], spec_unc[r], mod);
    if (!finite_t(mod)) bad = true;
  }
  for (int r = j; r < a.n_lim; r += team) {
    const unsigned d = lim_desc[r];
    const T mod = prop_sm[4 * (d & 255u) + (d >> 8)];
    if (mod < lim_lo[r] || mod > lim_hi[r] || !finite_t(mod)) bad = true;
  }
  for (int r = j; r < a.n_plax; r += team) ll += tree_gauss<T>(plax_val[r], plax_unc[r], T(1000) / p[plax_idx[r]]);
  for (int r = j; r < a.n_av; r += team) ll += tree_gauss<T>(av_val[r], av_unc[r], p[av_idx[r]]);

  for (int off = team >> 1; off > 0; off >>= 1) ll += __shfl_xor_sync(kFull, ll, off);
  const unsigned votes = __ballot_sync(kFull, bad);
  const unsigned mine = (team == 32 ? kFull : (1u << team) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(team - 1));
  if ((votes & mine) != 0u || isnan(ll)) ll = -INFINITY;
  if (valid && j == 0) static_cast<T*>(a.ll)[b] = ll;
}

// log2 of the star groups per team: n_stars rounded up to a power of two
int team_shift(int n_stars) {
  int shift = 0;
  while ((1 << shift) < n_stars) ++shift;
  return shift;
}

// The star groups per team (as their log2) and the lanes per group that a
// batch of B points takes: the rule is in the header.
void launch_geometry(long long B, int n_stars, int& np_shift, int& lanes) {
  np_shift = team_shift(n_stars);
  lanes = kMaxGroup;
  while (lanes > 1 && ((lanes << np_shift) > 32 || ((B * lanes) << np_shift) > kFillThreads)) lanes >>= 1;
  if (lanes == 1 && (B << np_shift) > kFillThreads) {
    int slots = 1 << np_shift;
    for (int shift = np_shift - 1; shift >= 0; --shift) {
      const int padded = ((n_stars + (1 << shift) - 1) >> shift) << shift;
      if (padded < slots) {
        slots = padded;
        np_shift = shift;
      }
    }
  }
}

// ---- the backward kernel (C'): d ll, orig_val, deriv / d pars
//
// Replaces XLA's reverse-mode of the tree posterior (the likelihood of
// isochrones_tpu/observation.py:1269-1361 and the prior's lerped columns,
// isochrones_tpu/treemodel.py:370-406), which NUTS takes through
// jax.value_and_grad. Given the cotangents g_ll (B,), g_orig (B, n_stars) and
// g_deriv (B, n_stars), it writes g_pars (B, P): the gradient that
// torch.autograd takes through the plain version (ops/tree.py), whose rule it
// keeps: a non-finite output passes no gradient (a row whose ll is not finite
// passes none of g_ll, a NaN orig_val or deriv none of its cotangent; a NaN
// flux and an inactive row pass none).
//
// What bounds it on the H100: as the forward, the latency of dependent
// gathers, made twice (the forward's values, then the lerps' vector-Jacobian
// products), not bytes or arithmetic (the bound is 0.00015 ms at the nested
// fit's 1024 points). A NUTS leaf launches it at 4 to 8 points, so its time
// there is one point's chain of dependent steps. The first design ran
// one lane a point: the lane recomputed the forward star by star into arrays
// sized by the caps, in local memory (3760 bytes of stack in float64), then
// per star recomputed the BC lerp and fluxes and, inside each lerp's VJP, the
// lerp's values again; 0.1658 ms at 1024 points, 0.4541 ms at 131072,
// against the forward's 0.011 and 0.119 (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// The design against that takes the forward's team geometry (launch_geometry,
// one rule for both kernels):
// * A team of NP * G lanes a point, a group of G lanes a star, the stars'
//   groups side by side; at large batches the team shrinks as the forward's
//   and a group takes its stars in turn.
// * Pass 1 is the forward's star step: a group lerps its star's pack columns,
//   density and bands (interp_group, the corners shared out over the group)
//   and keeps the pack columns, the density, each band's magnitude and flux
//   in the team's shared scratch (grad_scratch, sized by the plan, not by the
//   caps).
// * The rows go to the team's lanes (rows j, j + team, ...): the flux sums
//   and magnitudes, the ll and its -inf flags (a shuffle sum and a ballot
//   over the team, as the forward), each active row's Gaussian cotangent,
//   each row's magnitude cotangent (gathered from the rows relative to it, in
//   row order: no scatter) taken onto its flux sum, and each (star, band)'s
//   flux cotangent taken onto the star's magnitude.
// * Pass 2 recomputes no value: a group reads its star's values from the
//   scratch and takes the cotangents through the BC lerp, the density and
//   the model lerp by interp_common.cuh::group_vjp (the corners shared out
//   over the group, the products summed by a group shuffle; a column whose
//   value is NaN gets no cotangent), then keeps the star's five partials in
//   the scratch.
// * The team's lanes share out the gradient's columns: each column sums the
//   parallax and AV terms, then the stars' partials, in the first design's
//   order, and one lane writes it into the point's row of g_pars.
// * No atomics: every sum is taken in an order that the launch geometry
//   fixes. Every shuffle, vote and barrier is reached by all lanes: padded
//   stars and teams past the batch run a NaN point and write nothing.
// * A block holds 128 lanes where its teams' scratch fits in shared memory,
//   else 64 or 32 (plans near the caps, one lane a point).
// Caps, as the forward's: kMaxStars stars, kMaxObs observation rows,
// kMaxBands bands, kMaxProps spectroscopy rows and as many limits.

struct TreeGradArgs {
  const void* g_ll;     // (B,)
  const void* g_orig;   // (B, n_stars)
  const void* g_deriv;  // (B, n_stars)
  void* g_pars;         // (B, P)
};

constexpr double kLn10 = 2.302585092994045684;

// values of the grids' dtype that a team of the backward keeps in shared
// memory: per star its 6 pack columns, density, 5 partials, and each band's
// magnitude and flux (the flux later replaced by the magnitude's cotangent);
// per row its flux sum (later that sum's cotangent), its magnitude and its
// Gaussian term's cotangent
__host__ __device__ __forceinline__ int grad_star_len(int n_bands) { return 12 + 2 * n_bands; }

__host__ __device__ __forceinline__ int grad_scratch(int n_stars, int n_bands, int n_obs) {
  return n_stars * grad_star_len(n_bands) + 3 * n_obs;
}

// teams of G << np_shift lanes, as tree_lnlike_kernel's; blockDim.x is 128,
// 64 or 32 (launch_grad_g)
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    tree_lnlike_grad_kernel(const __grid_constant__ TreeArgs a, const __grid_constant__ TreeGradArgs ga, int np_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  {
    const char* src = static_cast<const char*>(a.plan);
    for (int i = threadIdx.x; i < (a.plan_bytes >> 4); i += blockDim.x)
      __pipeline_memcpy_async(smem + 16 * i, src + 16 * i, 16);
    __pipeline_commit();
  }
  const int n_stars = a.n_stars, n_obs = a.n_obs, nb = a.n_bands;
  const int team = G << np_shift;
  const unsigned tshift = __ffs(team) - 1;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;  // the launch keeps B * team < 2^31
  const long long b = tid >> tshift;
  const int j = (int)(tid & (team - 1));  // lane of the team
  const int sg = j / G;                   // star group
  const int l = j % G;                    // lane of the group
  const bool valid = b < a.B;
  const T* p = static_cast<const T*>(a.pars) + (valid ? b : a.B - 1) * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* dens_table = static_cast<const T*>(a.dens_table);
  const T* bc = static_cast<const T*>(a.bc);
  const int star_len = grad_star_len(nb);
  T* scratch = reinterpret_cast<T*>(smem + a.plan_bytes) + (threadIdx.x >> tshift) * grad_scratch(n_stars, nb, n_obs);
  // star s: pack columns [0, 6), density 6, partials [7, 12), magnitudes [12, 12 + nb), fluxes after them
  auto star_sm = [&](int s) { return scratch + s * star_len; };
  T* rowsum_sm = scratch + n_stars * star_len;  // [n_obs]: flux sums, then their cotangents
  T* mag_sm = rowsum_sm + n_obs;               // [n_obs]
  T* rcot_sm = mag_sm + n_obs;                 // [n_obs]: the Gaussian terms' cotangents

  const int groups = 1 << np_shift;
  const int padded_stars = (n_stars + groups - 1) & ~(groups - 1);
  // star s's 5 parameters (eep, age, feh, distance, AV); an idle group's EEP is NaN: no table reads
  auto star_pars = [&](int s, bool active, T* sp) {
    const short* idx = a.star_par[active ? s : 0];
    sp[0] = active ? p[idx[0]] : T(NAN);
#pragma unroll
    for (int i = 1; i < 5; ++i) sp[i] = p[idx[i]];
  };
  auto pick = [](const T* sp, int i) { return i == 0 ? sp[0] : i == 1 ? sp[1] : i == 2 ? sp[2] : i == 3 ? sp[3] : sp[4]; };

  // pass 1: the forward's star step, into the scratch
  for (int s = sg; s < padded_stars; s += groups) {
    const bool active = valid && s < n_stars;
    T sp[5];
    star_pars(s, active, sp);
    const T gx[3] = {pick(sp, a.io[0]), pick(sp, a.io[1]), pick(sp, a.io[2])};
    T v[kPackCols];
    interp_group<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, v);
    T dens = T(0);
    if (dens_table != nullptr) {
      T d[1];
      interp_group<T, 3, G, 1>(dens_table, a.model_ax, gx, a.dens_row_len, &a.dens_col, 1, l, d);
      dens = d[0];
    }
    T* st = star_sm(s < n_stars ? s : 0);
    const bool writer = l == 0 && s < n_stars;
    if (writer) {
#pragma unroll
      for (int c = 0; c < kPackCols; ++c) st[c] = v[c];
      st[6] = dens;
    }
    if (n_obs > 0) {
      T bcv[kMaxBands];
      const T bx[4] = {v[0], v[1], v[2], pick(sp, a.io[4])};
      interp_group<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, l, bcv);
      const T dist_mod = T(5) * d_log10(pick(sp, a.io[3]) / T(10));
      if (writer) {
#pragma unroll
        for (int k = 0; k < kMaxBands; ++k) {
          if (k == nb) break;
          const T m = v[3] + dist_mod - bcv[k];
          st[12 + k] = m;
          st[12 + nb + k] = d_pow(T(10), T(-0.4) * m);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the plan and every team's stars are in shared memory

  const T* obs_val = reinterpret_cast<const T*>(smem);
  const T* obs_unc = obs_val + n_obs;
  const T* spec_val = obs_unc + n_obs;
  const T* spec_unc = spec_val + a.n_spec;
  const T* lim_lo = spec_unc + a.n_spec;
  const T* lim_hi = lim_lo + a.n_lim;
  const T* plax_val = lim_hi + a.n_lim;
  const T* plax_unc = plax_val + a.n_plax;
  const T* av_val = plax_unc + a.n_plax;
  const T* av_unc = av_val + a.n_av;
  const unsigned* obs_desc = reinterpret_cast<const unsigned*>(av_unc + a.n_av);
  const unsigned* spec_desc = obs_desc + n_obs;
  const unsigned* lim_desc = spec_desc + a.n_spec;
  const unsigned* plax_idx = lim_desc + a.n_lim;
  const unsigned* av_idx = plax_idx + a.n_plax;

  // the rows' flux sums in star order (0 * inf kept) and magnitudes (NaN for a row that holds an off-grid star)
  for (int o = j; o < n_obs; o += team) {
    const unsigned d = obs_desc[o];
    const int band = d & 15u;
    const unsigned member = d >> 16;
    T sum = T(0);
    bool off_grid = false;
    for (int t = 0; t < n_stars; ++t) {
      const T f = star_sm(t)[12 + nb + band];
      const bool f_nan = isnan(f);
      const bool m = (member >> t) & 1u;
      sum += (f_nan ? T(0) : f) * (m ? T(1) : T(0));
      off_grid = off_grid || (f_nan && m);
    }
    rowsum_sm[o] = sum;
    mag_sm[o] = off_grid ? T(NAN) : T(-2.5) * d_log10(sum);
  }
  __syncwarp();

  // ll and its -inf flags, as the forward, for the rule on g_ll
  T ll = T(0);
  bool bad = false;
  for (int o = j; o < n_obs; o += team) {
    const unsigned d = obs_desc[o];
    if (((d >> 11) & 1u) == 0) continue;
    const int ref = (int)((d >> 4) & 127u) - 1;
    const T mo = mag_sm[o];
    const T mr = ref >= 0 ? mag_sm[ref] : T(0);
    const T val = ref >= 0 ? obs_val[o] - obs_val[ref] : obs_val[o];
    ll += tree_gauss<T>(val, obs_unc[o], ref >= 0 ? mo - mr : mo);
    if (!finite_t(mo) || !finite_t(mr)) bad = true;
  }
  for (int r = j; r < a.n_spec; r += team) {
    const unsigned d = spec_desc[r];
    const T* st = star_sm(d & 255u);
    const T mod = (d >> 8) == 3u ? st[6] : st[d >> 8];
    ll += tree_gauss<T>(spec_val[r], spec_unc[r], mod);
    if (!finite_t(mod)) bad = true;
  }
  for (int r = j; r < a.n_lim; r += team) {
    const unsigned d = lim_desc[r];
    const T* st = star_sm(d & 255u);
    const T mod = (d >> 8) == 3u ? st[6] : st[d >> 8];
    if (mod < lim_lo[r] || mod > lim_hi[r] || !finite_t(mod)) bad = true;
  }
  for (int r = j; r < a.n_plax; r += team) ll += tree_gauss<T>(plax_val[r], plax_unc[r], T(1000) / p[plax_idx[r]]);
  for (int r = j; r < a.n_av; r += team) ll += tree_gauss<T>(av_val[r], av_unc[r], p[av_idx[r]]);
  for (int off = team >> 1; off > 0; off >>= 1) ll += __shfl_xor_sync(kFull, ll, off);
  const unsigned votes = __ballot_sync(kFull, bad);
  const unsigned mine = (team == 32 ? kFull : (1u << team) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(team - 1));
  const T gl = valid && (votes & mine) == 0u && finite_t(ll) ? static_cast<const T*>(ga.g_ll)[b] : T(0);

  // each active row's Gaussian cotangent (with gl != 0 every active row and its reference are finite)
  for (int o = j; o < n_obs; o += team) {
    const unsigned d = obs_desc[o];
    T r = T(0);
    if (gl != T(0) && ((d >> 11) & 1u)) {
      const int ref = (int)((d >> 4) & 127u) - 1;
      const T mod = ref >= 0 ? mag_sm[o] - mag_sm[ref] : mag_sm[o];
      const T val = ref >= 0 ? obs_val[o] - obs_val[ref] : obs_val[o];
      r = gl * (val - mod) / (obs_unc[o] * obs_unc[o]);
    }
    rcot_sm[o] = r;
  }
  __syncwarp();
  // each row's magnitude cotangent (its own term, minus those of the active
  // rows relative to it, in row order), taken onto its flux sum
  for (int o = j; o < n_obs; o += team) {
    T g = T(0);
    for (int o2 = 0; o2 < n_obs; ++o2) {
      const unsigned d = obs_desc[o2];
      if (o2 == o) g += rcot_sm[o2];
      if (((d >> 11) & 1u) && (int)((d >> 4) & 127u) - 1 == o) g -= rcot_sm[o2];
    }
    rowsum_sm[o] = g != T(0) ? g * T(-2.5) / (rowsum_sm[o] * T(kLn10)) : T(0);
  }
  __syncwarp();
  // each (star, band)'s flux cotangent taken onto the star's magnitude; a
  // non-finite magnitude's flux passes none
  for (int q = j; q < n_stars * nb; q += team) {
    const int s = q / nb, k = q - (q / nb) * nb;
    T* st = star_sm(s);
    T gf = T(0);
    if (finite_t(st[12 + k])) {
      for (int o = 0; o < n_obs; ++o) {
        const unsigned d = obs_desc[o];
        if ((int)(d & 15u) == k && ((d >> (16 + s)) & 1u)) gf += rowsum_sm[o];
      }
    }
    st[12 + nb + k] = gf != T(0) ? gf * st[12 + nb + k] * T(-0.4 * kLn10) : T(0);
  }
  __syncwarp();

  // pass 2: per star, the cotangents through the BC lerp, the density and the model lerp, from the scratch's values
  for (int s = sg; s < padded_stars; s += groups) {
    const bool active = valid && s < n_stars;
    T sp[5];
    star_pars(s, active, sp);
    const T gx[3] = {pick(sp, a.io[0]), pick(sp, a.io[1]), pick(sp, a.io[2])};
    T* st = star_sm(s < n_stars ? s : 0);
    T v[kPackCols];
#pragma unroll
    for (int c = 0; c < kPackCols; ++c) v[c] = active ? st[c] : T(NAN);
    const T dens = active ? st[6] : T(NAN);
    // the spectroscopy terms onto the star's properties
    T gp[4] = {T(0), T(0), T(0), T(0)};
    if (gl != T(0)) {
      for (int r = 0; r < a.n_spec; ++r) {
        const unsigned d = spec_desc[r];
        if ((int)(d & 255u) != s) continue;
        const int q = (int)(d >> 8);
        const T mod = q == 3 ? dens : q == 0 ? v[0] : q == 1 ? v[1] : v[2];
        add_at<T, 4>(gp, q, gl * (spec_val[r] - mod) / (spec_unc[r] * spec_unc[r]));
      }
    }
    T g6[kPackCols] = {gp[0], gp[1], gp[2], T(0), T(0), T(0)};
    g6[4] = active ? static_cast<const T*>(ga.g_orig)[b * n_stars + s] : T(0);
    g6[5] = active ? static_cast<const T*>(ga.g_deriv)[b * n_stars + s] : T(0);
    T gsp[5] = {T(0), T(0), T(0), T(0), T(0)};
    T g_dmod = T(0);
    if (n_obs > 0) {
      // a NaN BC value has a NaN magnitude, whose cotangent is 0
      T g_bc[kMaxBands], gbx[4];
#pragma unroll
      for (int k = 0; k < kMaxBands; ++k) {
        if (k == nb) break;
        const T gm = active ? st[12 + nb + k] : T(0);
        g_dmod += gm;
        g_bc[k] = -gm;
      }
      g6[3] = g_dmod;
      const T bx[4] = {v[0], v[1], v[2], pick(sp, a.io[4])};
      group_vjp<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, l, g_bc, gbx);
#pragma unroll
      for (int k = 0; k < 3; ++k) g6[k] += gbx[k];
      add_at<T, 5>(gsp, a.io[4], gbx[3]);
    }
    if (dens_table != nullptr) {
      const T gd[1] = {isnan(dens) ? T(0) : gp[3]};
      T gdx[3];
      group_vjp<T, 3, G, 1>(dens_table, a.model_ax, gx, a.dens_row_len, &a.dens_col, 1, l, gd, gdx);
#pragma unroll
      for (int k = 0; k < 3; ++k) add_at<T, 5>(gsp, a.io[k], gdx[k]);
    }
#pragma unroll
    for (int c = 0; c < kPackCols; ++c) g6[c] = isnan(v[c]) ? T(0) : g6[c];
    T ggx[3];
    group_vjp<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, g6, ggx);
#pragma unroll
    for (int k = 0; k < 3; ++k) add_at<T, 5>(gsp, a.io[k], ggx[k]);
    if (g_dmod != T(0)) add_at<T, 5>(gsp, a.io[3], g_dmod * (T(5) / (pick(sp, a.io[3]) * T(kLn10))));
    if (l == 0 && s < n_stars) {
#pragma unroll
      for (int k = 0; k < 5; ++k) st[7 + k] = gsp[k];
    }
  }
  __syncwarp();

  // the gradient's columns, shared out over the team: the parallax and AV
  // terms, then the stars' partials, each column written by one lane
  if (!valid) return;
  T* out = static_cast<T*>(ga.g_pars) + b * a.P;
  for (int col = j; col < a.P; col += team) {
    T acc = T(0);
    if (gl != T(0)) {
      for (int r = 0; r < a.n_plax; ++r) {
        if ((int)plax_idx[r] != col) continue;
        const T dd = p[col];
        acc += gl * (plax_val[r] - T(1000) / dd) / (plax_unc[r] * plax_unc[r]) * (T(-1000) / (dd * dd));
      }
      for (int r = 0; r < a.n_av; ++r) {
        if ((int)av_idx[r] != col) continue;
        acc += gl * (av_val[r] - p[col]) / (av_unc[r] * av_unc[r]);
      }
    }
    for (int s = 0; s < n_stars; ++s)
      for (int k = 0; k < 5; ++k)
        if (a.star_par[s][k] == col) acc += star_sm(s)[7 + k];
    out[col] = acc;
  }
}

template <typename T, int G>
cudaError_t launch_grad_g(const TreeArgs& a, const TreeGradArgs& ga, int np_shift, cudaStream_t st) {
  const int team = G << np_shift;
  const long long threads = a.B * team;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  // 128 lanes a block where the teams' scratch fits, else 64 or 32
  const long long per_team = (long long)grad_scratch(a.n_stars, a.n_bands, a.n_obs) * sizeof(T);
  int block = kThreads;
  while (block > 32 && a.plan_bytes + (block / team) * per_team > kMaxShared) block >>= 1;
  const long long shared = a.plan_bytes + (long long)(block / team) * per_team;
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  if (shared > kStaticShared) {
    const cudaError_t err = cudaFuncSetAttribute(tree_lnlike_grad_kernel<T, G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (threads + block - 1) / block;
  tree_lnlike_grad_kernel<T, G><<<(unsigned)blocks, block, (size_t)shared, st>>>(a, ga, np_shift);
  return cudaGetLastError();
}

template <typename T>
int launch_grad(const TreeArgs* args, const TreeGradArgs* grad, void* stream) {
  const TreeArgs& a = *args;
  if (a.B < 0 || a.P < 5 || a.n_stars < 1 || a.n_stars > kMaxStars || a.n_obs < 0 || a.n_obs > kMaxObs ||
      a.n_bands < 0 || a.n_bands > kMaxBands || a.n_spec < 0 || a.n_spec > kMaxProps || a.n_lim < 0 ||
      a.n_lim > kMaxProps || a.n_plax < 0 || a.n_plax > kMaxStars || a.n_av < 0 || a.n_av > kMaxStars ||
      a.plan_bytes < 0 || (a.plan_bytes & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)a.n_obs + a.n_spec + a.n_lim + a.n_plax + a.n_av;
  if (a.plan_bytes < (long long)(2 * sizeof(T) + sizeof(unsigned)) * n_rows) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  int ns, lanes;
  launch_geometry(a.B, a.n_stars, ns, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 16: return (int)launch_grad_g<T, 16>(a, *grad, ns, st);
    case 8: return (int)launch_grad_g<T, 8>(a, *grad, ns, st);
    case 4: return (int)launch_grad_g<T, 4>(a, *grad, ns, st);
    case 2: return (int)launch_grad_g<T, 2>(a, *grad, ns, st);
    default: return (int)launch_grad_g<T, 1>(a, *grad, ns, st);
  }
}

template <typename T, int G>
cudaError_t launch_g(const TreeArgs& a, int np_shift, cudaStream_t st) {
  const int team = G << np_shift;
  const long long threads = a.B * team;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const long long shared =
      a.plan_bytes + (long long)(kThreads / team) * team_scratch(a.n_stars, a.n_bands, a.n_obs) * sizeof(T);
  if (shared > kMaxShared) return cudaErrorInvalidValue;
  if (shared > kStaticShared) {
    const cudaError_t err = cudaFuncSetAttribute(tree_lnlike_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)shared);
    if (err != cudaSuccess) return err;
  }
  tree_lnlike_kernel<T, G><<<(unsigned)blocks, kThreads, (size_t)shared, st>>>(a, np_shift);
  return cudaGetLastError();
}

template <typename T>
int launch(const TreeArgs* args, void* stream) {
  const TreeArgs& a = *args;
  if (a.B < 0 || a.P < 5 || a.n_stars < 1 || a.n_stars > kMaxStars || a.n_obs < 0 || a.n_obs > kMaxObs ||
      a.n_bands < 0 || a.n_bands > kMaxBands || a.n_spec < 0 || a.n_spec > kMaxProps || a.n_lim < 0 ||
      a.n_lim > kMaxProps || a.n_plax < 0 || a.n_plax > kMaxStars || a.n_av < 0 || a.n_av > kMaxStars ||
      a.plan_bytes < 0 || (a.plan_bytes & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)a.n_obs + a.n_spec + a.n_lim + a.n_plax + a.n_av;
  if (a.plan_bytes < (long long)(2 * sizeof(T) + sizeof(unsigned)) * n_rows) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  int ns, lanes;
  launch_geometry(a.B, a.n_stars, ns, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 16: return (int)launch_g<T, 16>(a, ns, st);
    case 8: return (int)launch_g<T, 8>(a, ns, st);
    case 4: return (int)launch_g<T, 4>(a, ns, st);
    case 2: return (int)launch_g<T, 2>(a, ns, st);
    default: return (int)launch_g<T, 1>(a, ns, st);
  }
}

}  // namespace

// `args` points to a TreeArgs and `grad` to a TreeGradArgs (the cotangents
// and the gradient's output); they are passed as void* because a parameter of
// a type from the unnamed namespace would give these functions internal
// linkage
extern "C" {

#ifdef TREE_F64_UNIT

int tree_lnlike_f64(const void* args, void* stream) {
  return launch<double>(static_cast<const TreeArgs*>(args), stream);
}

int tree_lnlike_grad_f64(const void* args, const void* grad, void* stream) {
  return launch_grad<double>(static_cast<const TreeArgs*>(args), static_cast<const TreeGradArgs*>(grad), stream);
}

#else

int tree_lnlike_max_bands() { return kMaxBands; }

int tree_lnlike_max_stars() { return kMaxStars; }

int tree_lnlike_max_obs() { return kMaxObs; }

int tree_lnlike_max_props() { return kMaxProps; }

int tree_lnlike_args_size() { return (int)sizeof(TreeArgs); }

// star groups per team and lanes per group that a batch of B points of a plan
// with n_stars stars takes
void tree_lnlike_geometry(long long B, int n_stars, int* groups, int* lanes) {
  int np_shift;
  launch_geometry(B, n_stars, np_shift, *lanes);
  *groups = 1 << np_shift;
}

const char* tree_lnlike_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tree_lnlike_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const TreeArgs*>(args), stream);
}

int tree_lnlike_grad_args_size() { return (int)sizeof(TreeGradArgs); }

int tree_lnlike_grad_f32(const void* args, const void* grad, void* stream) {
  return launch_grad<float>(static_cast<const TreeArgs*>(args), static_cast<const TreeGradArgs*>(grad), stream);
}

#endif

}  // extern "C"
