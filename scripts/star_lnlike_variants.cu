// Kernel A''s design variant, as measured by scripts/tune_torch_star_grad.py:
// a copy of isochrones_torch/csrc/star_lnlike.cu whose backward (A') locates
// the model cell and the BC cell again in its second pass (group_vjp), where
// the library's A' keeps the cells that its first pass located. Only the tune
// script builds it, as star_lnlike.cu in a copy of csrc/ (for
// interp_common.cuh and the other kernels' entry points); the library never
// does. Its entry points and argument structs are the library's. The header
// notes of the kernels themselves are the library's.

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
// What bounds it on the H100: as the forward, the latency of dependent
// gathers, made twice (the forward's values, then the lerps' vector-Jacobian
// products), not bytes or arithmetic. A NUTS leaf launches it at 4 to 8
// points, so its time there is one point's chain of dependent steps. The
// first design ran one lane a point: the lane recomputed each component's
// forward in turn into arrays sized by the caps, in local memory (1264 bytes
// of stack in float64, 672 in float32), then per component the BC lerp's and
// the model lerp's products by a one-lane VJP that located both cells again
// and read every corner twice; 0.0849 ms at 4 points and 0.0814 ms at 1024
// (nearly the same: a latency chain), 0.2752 ms at 131072, against the
// forward's 0.0096 ms at 1024 (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// The design against that takes the forward's team geometry (group_lanes,
// team_shift: one rule for both kernels):
// * A team of NP * G lanes a point, a group of G lanes a component, the
//   components' groups side by side; G = 16 at the NUTS chains' batches,
//   halving to 1 at large batches as the forward's.
// * Pass 1 is the forward's component step: the model cell located and
//   lerped on the pack, then the BC cell on the BC table (group_locate,
//   interp_group_at: the corners shared out over the group; both cells kept
//   for pass 2), the magnitudes, and the components' fluxes summed across
//   the groups by xor shuffles in the forward's order, so that every lane
//   holds the forward's magnitudes and the team's first lane the forward's
//   ll, which it hands to the team.
// * The cotangents stay in registers, one component a group: the Gaussian
//   terms' (val - model) / unc^2, the flux sum's weights f_c / sum f, the
//   distance modulus' 5 / (d ln 10), the parallax' -1000 / d^2.
// * Pass 2 takes the BC lerp's and then the model lerp's vector-Jacobian
//   products at the cells that pass 1 located and kept (group_vjp_corners,
//   group_slopes: the corners shared out over the group, the products summed
//   by a group shuffle), chaining the BC lookup's coordinates into the model
//   lerp's columns; a column whose value is NaN gets no cotangent. Locating
//   both cells again in pass 2 (group_vjp) took 1.6x as long at 4 and 8
//   points and 1.3x at 131072 on an NVIDIA H100 80GB HBM3 (700.00 W);
//   scripts/tune_torch_star_grad.py builds that design from its own copy,
//   scripts/star_lnlike_variants.cu.
// * The gradient's columns meet by shuffles from each group's lanes: each
//   column sums the parallax term, then the components' partials in
//   component order (the first design's order), and one lane writes it.
// * No atomics: the result does not depend on the launch. Every shuffle and
//   vote is reached by all 32 lanes: padded components and teams past the
//   batch run a NaN point and write nothing.
// Caps, as the forward's: kMaxStars components, kMaxBands bands.

struct StarGradArgs {
  const void* g_ll;     // (B,)
  const void* g_orig;   // (B, N)
  const void* g_deriv;  // (B, N)
  void* g_pars;         // (B, P)
};

constexpr double kLn10 = 2.302585092994045684;
constexpr int kMaxGroups = 4;  // component groups a team: kMaxStars rounded up to a power of two

// teams of G << np_shift lanes, as star_lnlike_kernel's
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 4 : 1)
    star_lnlike_grad_kernel(const __grid_constant__ StarArgs a, const __grid_constant__ StarGradArgs ga,
                            int np_shift) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps B * np * G < 2^31
  const int team = G << np_shift;
  const unsigned tshift = __ffs(team) - 1;
  if ((long long)((tid & ~31u) >> tshift) >= a.B) return;  // the whole warp lies past the batch
  const long long b = tid >> tshift;
  const int j = (int)(tid & (team - 1));  // lane of the team
  const int c = j / G;                    // component
  const int l = j % G;                    // lane of the group
  const int N = a.N;
  const bool valid = b < a.B;
  const bool active = valid && c < N;
  const T* p = static_cast<const T*>(a.pars) + (valid ? b : a.B - 1) * a.P;
  const T* model = static_cast<const T*>(a.model);
  const T* bc = static_cast<const T*>(a.bc);
  const T eep = active ? p[c] : T(NAN);  // an idle lane's point is NaN: no reads
  const T age = p[N], feh = p[N + 1], dist = p[N + 2], av = p[N + 3];
  auto comp = [&](int i) { return i == 0 ? eep : i == 1 ? age : i == 2 ? feh : i == 3 ? dist : av; };
  const int nb = a.n_bands;

  // pass 1: the forward's component step
  const T gx[3] = {comp(a.io[0]), comp(a.io[1]), comp(a.io[2])};
  T v[kPackCols];
  interp_group<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, v);
  const T dmod_x = comp(a.io[3]);
  const T dmod = T(5) * d_log10(dmod_x / T(10));
  T fc[kMaxBands];  // the BC values, then the component's magnitude (N = 1) or flux
  T fs[kMaxBands];  // the components' flux sum (N > 1)
  if (nb > 0) {
    const T bx[4] = {v[0], v[1], v[2], comp(a.io[4])};
    interp_group<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, l, fc);
#pragma unroll
    for (int k = 0; k < kMaxBands; ++k) {
      if (k == nb) break;
      const T m = v[3] + dmod - fc[k];
      if (N == 1) {
        fc[k] = m;
      } else {
        T f = active ? d_pow(T(10), T(-0.4) * m) : T(0);
        fc[k] = f;
        for (int off = G; off < team; off <<= 1) f += __shfl_xor_sync(kFull, f, off);
        fs[k] = f;
      }
    }
  }
  // the magnitude of band k, the same on every lane of the team
  auto mag = [&](int k) { return N == 1 ? fc[k] : T(-2.5) * d_log10(fs[k]); };
  T ll = T(0);
  for (int k = 0; k < 3; ++k) {
    if (a.has_spec[k]) ll += gauss_lnprob<T>(T(a.spec_val[k]), T(a.spec_unc[k]), v[k]);
  }
  T phot = T(0);
#pragma unroll
  for (int k = 0; k < kMaxBands; ++k) {
    if (k == nb) break;
    phot += gauss_lnprob<T>(T(a.mag_val[k]), T(a.mag_unc[k]), mag(k));
  }
  ll += phot;
  if (a.dist_idx >= 0) ll += gauss_lnprob<T>(T(a.plax), T(a.plax_unc), T(1000) / p[a.dist_idx]);
  const int base = (int)(threadIdx.x & 31u) & ~(team - 1);  // the team's first lane: component 0's ll
  ll = __shfl_sync(kFull, ll, base);
  const T gl = valid && !isnan(ll) && !isinf(ll) ? static_cast<const T*>(ga.g_ll)[b] : T(0);

  // the cotangents of the component's pack columns and bands; with gl != 0
  // every magnitude is finite, so no band's BC value is NaN
  T g6[kPackCols] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  g6[4] = active ? static_cast<const T*>(ga.g_orig)[b * N + c] : T(0);
  g6[5] = active ? static_cast<const T*>(ga.g_deriv)[b * N + c] : T(0);
  if (gl != T(0) && c == 0) {
    for (int k = 0; k < 3; ++k) {
      if (a.has_spec[k]) g6[k] = gl * (T(a.spec_val[k]) - v[k]) / (T(a.spec_unc[k]) * T(a.spec_unc[k]));
    }
  }
  T g_bc[kMaxBands];
  T g_dmod = T(0);
#pragma unroll
  for (int k = 0; k < kMaxBands; ++k) {
    if (k == nb) break;
    T gm = T(0);
    if (gl != T(0)) {
      const T g_mag = gl * (T(a.mag_val[k]) - mag(k)) / (T(a.mag_unc[k]) * T(a.mag_unc[k]));
      gm = N == 1 ? g_mag : g_mag * fc[k] / fs[k];
    }
    g_dmod += gm;
    g_bc[k] = -gm;
  }
  g6[3] = g_dmod;

  // pass 2: the BC lerp's and the model lerp's products; this component's
  // partials of (eep, age, feh, distance, AV)
  T gsp[5] = {T(0), T(0), T(0), T(0), T(0)};
  if (nb > 0) {
    T gbx[4];
    const T bx[4] = {v[0], v[1], v[2], comp(a.io[4])};
    group_vjp<T, 4, G, kMaxBands>(bc, a.bc_ax, bx, a.bc_ncols, a.band_cols, nb, l, g_bc, gbx);
#pragma unroll
    for (int k = 0; k < 3; ++k) g6[k] += gbx[k];
    add_at<T, 5>(gsp, a.io[4], gbx[3]);
  }
#pragma unroll
  for (int k = 0; k < kPackCols; ++k) g6[k] = isnan(v[k]) ? T(0) : g6[k];
  T ggx[3];
  group_vjp<T, 3, G, kPackCols, 2>(model, a.model_ax, gx, kPackCols, nullptr, kPackCols, l, g6, ggx);
#pragma unroll
  for (int k = 0; k < 3; ++k) add_at<T, 5>(gsp, a.io[k], ggx[k]);
  if (g_dmod != T(0)) add_at<T, 5>(gsp, a.io[3], g_dmod * (T(5) / (dmod_x * T(kLn10))));

  // the gradient's columns: column col takes the parallax term, then part q
  // of the components' partials (q = 0, the EEP, of its own component only)
  // in component order; lanes j, j + team, ... of the team write columns j,
  // j + team, ...
  T part[5][kMaxGroups];
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int s = 0; s < kMaxGroups; ++s)
      part[q][s] = s < (1 << np_shift) ? __shfl_sync(kFull, gsp[q], base + s * G) : T(0);
  if (!valid) return;
  T* out = static_cast<T*>(ga.g_pars) + b * a.P;
  for (int col = j; col < a.P; col += team) {
    T acc = T(0);
    if (col == a.dist_idx && gl != T(0)) {
      const T d = p[col];
      const T r = gl * (T(a.plax) - T(1000) / d) / (T(a.plax_unc) * T(a.plax_unc));
      acc += r * (T(-1000) / (d * d));
    }
    const int q = col < N ? 0 : col - N + 1;
#pragma unroll
    for (int qq = 0; qq < 5; ++qq) {
      if (qq != q) continue;
#pragma unroll
      for (int s = 0; s < kMaxGroups; ++s)
        if (s < N && (q != 0 || s == col)) acc += part[qq][s];
    }
    out[col] = acc;
  }
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

template <typename T, int G>
cudaError_t launch_grad_g(const StarArgs& a, const StarGradArgs& ga, int np_shift, cudaStream_t st) {
  const long long threads = (a.B * G) << np_shift;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  star_lnlike_grad_kernel<T, G><<<(unsigned)blocks, kThreads, 0, st>>>(a, ga, np_shift);
  return cudaGetLastError();
}

template <typename T>
int launch_grad(const StarArgs* args, const StarGradArgs* grad, void* stream) {
  const StarArgs& a = *args;
  if (a.B < 0 || a.N < 1 || a.N > kMaxStars || a.P != a.N + 4 || a.n_bands < 0 || a.n_bands > kMaxBands)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int ns = team_shift(a.N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group_lanes(a.B, a.N)) {
    case 16: return (int)launch_grad_g<T, 16>(a, *grad, ns, st);
    case 8: return (int)launch_grad_g<T, 8>(a, *grad, ns, st);
    case 4: return (int)launch_grad_g<T, 4>(a, *grad, ns, st);
    case 2: return (int)launch_grad_g<T, 2>(a, *grad, ns, st);
    default: return (int)launch_grad_g<T, 1>(a, *grad, ns, st);
  }
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
