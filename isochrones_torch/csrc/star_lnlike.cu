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
// * A row of the 6-column pack is read two columns per load (float2 or
//   double2): half the gathers of a lane, which is what a full card waits
//   for at one lane per component.
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

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxStars = 3;
constexpr int kPackCols = 6;
constexpr int kMaxGroup = 16;  // at most 16 lanes per group
constexpr long long kFillThreads = 1LL << 18;

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
  interp_group<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, v);
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

// ---- the backward kernel (A'): d ll, orig_val, deriv / d pars
//
// Replaces XLA's reverse-mode of the same function, which NUTS takes through
// jax.value_and_grad of the fused posterior (isochrones_tpu/samplers/nuts.py:
// 59-69, _safe_value_and_grad). Given the cotangents g_ll (B,), g_orig (B, N)
// and g_deriv (B, N), it writes g_pars (B, N + 4): the gradient that
// torch.autograd takes through the plain version (ops/star.py), whose rule it
// keeps: a non-finite output passes no gradient (a row whose ll is not finite
// passes none of g_ll, a NaN orig_val or deriv none of its cotangent).
//
// One lane a point (the simple design; parameter counts are at most 7). Pass
// 1 recomputes the point's forward: each component's 6 pack columns and band
// BCs (interp_group), magnitudes, the flux sum and ll. Then the cotangents
// run backward in closed form: the Gaussian terms' (val - model) / unc^2,
// the flux sum's weights f_c / sum f (a softmax over components), the
// distance modulus' 5 / (d ln 10), the parallax' -1000 / d^2. Pass 2, per
// component, takes the vector-Jacobian products of the BC lerp at (Teff, logg,
// feh, AV) and of the model lerp (interp_common.cuh::interp_vjp: every axis'
// slope, with autograd's conventions at knots), chaining the BC lookup's
// coordinates into the model lerp's columns.
//
// What bounds it: as the forward, dependent gathers; it makes them twice (the
// values, then the products), and its per-lane arrays live in local memory.
// The bytes a call must move are the forward's parameters and rows plus the
// cotangents in and the (B, N + 4) gradient out.

struct StarGradArgs {
  const void* g_ll;     // (B,)
  const void* g_orig;   // (B, N)
  const void* g_deriv;  // (B, N)
  void* g_pars;         // (B, P)
};

constexpr double kLn10 = 2.302585092994045684;

template <typename T>
__global__ void __launch_bounds__(kThreads) star_lnlike_grad_kernel(const __grid_constant__ StarArgs a,
                                                                    const __grid_constant__ StarGradArgs ga) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid - (threadIdx.x & 31u) >= a.B) return;  // the whole warp lies past the batch
  const bool valid = tid < a.B;
  const long long b = valid ? tid : a.B - 1;
  const int N = a.N;
  const T* p = static_cast<const T*>(a.pars) + b * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* bc = static_cast<const T*>(a.bc);
  const T age = p[N], feh = p[N + 1], dist = p[N + 2], av = p[N + 3];
  // component c's parameter j (eep, age, feh, distance, AV); an idle lane's EEP is NaN: no reads
  auto comp = [&](int c, int j) {
    return j == 0 ? (valid ? p[c] : T(NAN)) : j == 1 ? age : j == 2 ? feh : j == 3 ? dist : av;
  };
  auto col = [&](int c, int j) { return j == 0 ? c : N + j - 1; };  // its column of pars
  const int nb = a.n_bands;

  // pass 1: the forward
  T v6[kMaxStars][kPackCols];
  T cm[kMaxStars][kMaxBands];  // component magnitudes, then their cotangents
  T dmod[kMaxStars];
  for (int c = 0; c < N; ++c) {
    const T gx[3] = {comp(c, a.io[0]), comp(c, a.io[1]), comp(c, a.io[2])};
    interp_group<T, 3, 1, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, 0, v6[c]);
    dmod[c] = T(5) * d_log10(comp(c, a.io[3]) / T(10));
    if (nb > 0) {
      T bcv[kMaxBands];
      const T bx[4] = {v6[c][0], v6[c][1], v6[c][2], comp(c, a.io[4])};
      interp_group<T, 4, 1, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, 0, bcv);
      for (int k = 0; k < nb; ++k) cm[c][k] = v6[c][3] + dmod[c] - bcv[k];
    }
  }
  T mags[kMaxBands];
  T fsum[kMaxBands];
  for (int k = 0; k < nb; ++k) {
    if (N == 1) {
      mags[k] = cm[0][k];
    } else {
      T f = T(0);
      for (int c = 0; c < N; ++c) f += d_pow(T(10), T(-0.4) * cm[c][k]);
      fsum[k] = f;
      mags[k] = T(-2.5) * d_log10(f);
    }
  }
  T ll = T(0);
  for (int k = 0; k < 3; ++k) {
    if (a.has_spec[k]) ll += gauss_lnprob<T>(T(a.spec_val[k]), T(a.spec_unc[k]), v6[0][k]);
  }
  for (int k = 0; k < nb; ++k) ll += gauss_lnprob<T>(T(a.mag_val[k]), T(a.mag_unc[k]), mags[k]);
  if (a.dist_idx >= 0) ll += gauss_lnprob<T>(T(a.plax), T(a.plax_unc), T(1000) / p[a.dist_idx]);
  const T gl = valid && !isnan(ll) && !isinf(ll) ? static_cast<const T*>(ga.g_ll)[b] : T(0);

  // the cotangents, backward
  T gp[kMaxStars + 4];
  for (int j = 0; j < N + 4; ++j) gp[j] = T(0);
  T g6[kMaxStars][kPackCols];
  for (int c = 0; c < N; ++c) {
    for (int k = 0; k < 4; ++k) g6[c][k] = T(0);
    g6[c][4] = valid ? static_cast<const T*>(ga.g_orig)[b * N + c] : T(0);
    g6[c][5] = valid ? static_cast<const T*>(ga.g_deriv)[b * N + c] : T(0);
  }
  if (gl != T(0)) {
    for (int k = 0; k < 3; ++k) {
      if (a.has_spec[k]) g6[0][k] = gl * (T(a.spec_val[k]) - v6[0][k]) / (T(a.spec_unc[k]) * T(a.spec_unc[k]));
    }
    for (int k = 0; k < nb; ++k) {
      const T g_mag = gl * (T(a.mag_val[k]) - mags[k]) / (T(a.mag_unc[k]) * T(a.mag_unc[k]));
      for (int c = 0; c < N; ++c) cm[c][k] = N == 1 ? g_mag : g_mag * d_pow(T(10), T(-0.4) * cm[c][k]) / fsum[k];
    }
    if (a.dist_idx >= 0) {
      const T d = p[a.dist_idx];
      const T r = gl * (T(a.plax) - T(1000) / d) / (T(a.plax_unc) * T(a.plax_unc));
      gp[a.dist_idx] += r * (T(-1000) / (d * d));
    }
  } else {
    for (int c = 0; c < N; ++c)
      for (int k = 0; k < nb; ++k) cm[c][k] = T(0);
  }

  // pass 2: per component, the BC lerp's and the model lerp's products
  for (int c = 0; c < N; ++c) {
    T g_dmod = T(0);
    for (int k = 0; k < nb; ++k) g_dmod += cm[c][k];
    g6[c][3] = g_dmod;
    if (nb > 0) {
      T g_bc[kMaxBands], bcv[kMaxBands], gbx[4];
      for (int k = 0; k < nb; ++k) g_bc[k] = -cm[c][k];
      const T bx[4] = {v6[c][0], v6[c][1], v6[c][2], comp(c, a.io[4])};
      interp_vjp<T, 4, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, g_bc, bcv, gbx);
      for (int k = 0; k < 3; ++k) g6[c][k] += gbx[k];
      gp[col(c, a.io[4])] += gbx[3];
    }
    T vals[kPackCols], ggx[3];
    const T gx[3] = {comp(c, a.io[0]), comp(c, a.io[1]), comp(c, a.io[2])};
    interp_vjp<T, 3, kPackCols>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, g6[c], vals, ggx);
    for (int k = 0; k < 3; ++k) gp[col(c, a.io[k])] += ggx[k];
    if (g_dmod != T(0)) gp[col(c, a.io[3])] += g_dmod * (T(5) / (comp(c, a.io[3]) * T(kLn10)));
  }
  if (!valid) return;
  T* out = static_cast<T*>(ga.g_pars) + b * a.P;
  for (int j = 0; j < a.P; ++j) out[j] = gp[j];
}

template <typename T>
int launch_grad(const StarArgs* args, const StarGradArgs* grad, void* stream) {
  const StarArgs& a = *args;
  if (a.B < 0 || a.N < 1 || a.N > kMaxStars || a.P != a.N + 4 || a.n_bands < 0 || a.n_bands > kMaxBands)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const long long blocks = (a.B + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  star_lnlike_grad_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, *grad);
  return (int)cudaGetLastError();
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

int star_lnlike_grad_args_size() { return (int)sizeof(StarGradArgs); }

// `grad` points to a StarGradArgs: the cotangents and the gradient's output
int star_lnlike_grad_f32(const void* args, const void* grad, void* stream) {
  return launch_grad<float>(static_cast<const StarArgs*>(args), static_cast<const StarGradArgs*>(grad), stream);
}

int star_lnlike_grad_f64(const void* args, const void* grad, void* stream) {
  return launch_grad<double>(static_cast<const StarArgs*>(args), static_cast<const StarGradArgs*>(grad), stream);
}

}  // extern "C"
