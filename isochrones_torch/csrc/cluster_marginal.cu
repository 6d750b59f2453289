// Hierarchical-cluster marginal likelihood: one CUDA kernel for a batch of
// walkers.
//
// Replaces the Pallas TPU kernel isochrones_tpu/ops/cluster_pallas.py
// (_cluster_kernel, launched by cluster_lnmarginal_pallas). For walker w and
// star s it returns
//
//   ln sum_{j, k<=j} W2[j,k] exp(a[w,s,j,k]),
//   a = sum_b logaddexp(x_b, y_b) + lnq[j,k] + lnjrow[w,s,j],
//   x_b = ln fB - r_bin^2/2u^2,  y_b = ln(1-fB) - r_single^2/2u^2,
//
// over the (primary EEP j, secondary EEP k) plane, where r_bin uses the
// binary magnitude -2.5 log10(f_j + f_k) and r_single the primary's own.
// Cells outside the mask (q < q_lo, k > j, invalid j or k, zero trapezoid
// weight) do not enter the sum.
//
// What bounds it: special functions. In the product form below a cell needs
// one exponential per (star, band), one per star for the log-sum-exp and one
// log10 per band: S (B + 1) + B results, 203 at (S, B) = (50, 3), in each of
// up to E (E + 1) / 2 = 245,350 cells per walker at E = 700, against ~0.4 M
// input values and ~10 flops per (star, band): above both the FP32 and the
// memory bound.
//
// Design, against that bound:
// * Product form of the band sum: sum_b logaddexp(x_b, y_b) =
//   sum_b max(x_b, y_b) + log prod_b (1 + e^-|x_b - y_b|). The log-sum-exp
//   keeps its running max on M = sum_b max_b + lnq + row and adds
//   W2 * prod_b(1 + e_b) * exp(M - max); the dropped log prod lies in
//   [0, B ln 2], so the rescaled sum cannot overflow. A cell costs B + 1
//   exponentials per star and no logarithm.
// * Everything runs in log2 units (inputs scaled by log2 e once), so each
//   float32 exponential is one ex2.approx (MUFU) instruction; float64 keeps
//   the accurate exp2. The per-(cell, band) log10 of the binary flux stays
//   accurate: it is shared by the block's stars and its error enters every
//   star.
// * The single-star term y_b depends on (j, star, band) only and is hoisted
//   out of the k loop; with r = (m - m_obs) g and g = sqrt(log2 e / 2) / u,
//   x_b = ln fB log2 e - (fma(m_bin, g, -m_obs g))^2 is two FMAs per
//   (cell, star, band). The band count is a template parameter (1-4, the
//   bands models use) so the star tile's g, -m_obs g and y_b live in
//   registers; a generic instantiation takes 5..kMaxBands bands.
// * One block takes (walker, tile of TS stars, tile of 16 primary rows j):
//   4 warps, each owning 4 interleaved rows, its lanes striding over k <= j.
//   Tiles of long rows are scheduled first. The star tile is as wide as
//   registers allow (stars_per_block): at 3 bands in float32, 10 stars
//   (S = 50 splits evenly) was measured against 5, 8 and 12 on an H100 at
//   (50, 700, 3) and (50, 1710, 3) and was fastest; so were 4 rows per warp
//   (against 2) and the default register budget (against 2 blocks per SM).
//   The widths of the other band counts and of float64 follow the register
//   count (2 + 3 * bands per star) and were not timed against others.
//   ptxas gives that instantiation 168 registers, 12 bytes of spill stores
//   and 24 of spill loads; the float64 one (5 stars) 255 registers, 12 and
//   12.
// * The log-sum-exp push has no branch (a select between the two rescaled
//   forms), so the compiler interleaves the stars' dependency chains.
// * Per block, the walker's k-vectors (flux per band, mass, the k part of the
//   q prior, the trapezoid weights with valid_k folded in) are staged in
//   dynamic shared memory, in chunks of k that keep it under 48 KB.
//   W2[j,k] = w_outer[j] * w_inner[j,k] is the closed form of
//   ops/cluster_cuda.py::trapezoid_weights, so no (E, E) plane is written.
// * Each thread keeps a streaming log-sum-exp per star (running max and
//   rescaled sum), merged by warp shuffles and shared memory at the end of
//   the block into a partial (max, sum) per (walker, star, j tile); a second
//   small kernel merges the partials and applies log2(sum) + max with the
//   -inf cut below -1e20 (nats).
// * NaN route: a NaN cell term turns that star's sum into NaN, and the
//   finish kernel returns -inf for it, as the Pallas kernel does.
//
// Built with -Xptxas -v; chip_smoke.py prints the registers and spills of
// each instantiation.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // primary rows j per block
constexpr int kMaxBands = 16;
constexpr int kSmemBytes = 45056;  // dynamic shared memory per block, under the 48 KB default
constexpr double kNegBig = -1e30;  // the kernel's "no support" sentinel
constexpr double kLog2e = 1.44269504088896340736;
constexpr double kLn2 = 0.69314718055994530942;
constexpr double kSqrtHalfLog2e = 0.84932180028801904272;  // sqrt(log2(e) / 2)

// stars per block: each costs 2 + 3 * bands registers of its type
template <typename T, int NB>
__host__ __device__ constexpr int stars_per_block() {
  return sizeof(T) == 4 ? (NB == 1 ? 16 : NB == 2 ? 12 : NB == 3 ? 10 : 8)
                        : (NB == 1 ? 8 : NB == 2 ? 6 : NB == 3 ? 5 : 4);
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double exp2_fast(double x) { return exp2(x); }
__device__ __forceinline__ float d_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double d_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float d_max(float a, float b) { return fmaxf(a, b); }  // NaN-ignoring
__device__ __forceinline__ double d_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log2(float x) { return log2f(x); }
__device__ __forceinline__ double d_log2(double x) { return log2(x); }
__device__ __forceinline__ float d_log10(float x) { return log10f(x); }
__device__ __forceinline__ double d_log10(double x) { return log10(x); }

// streaming log-sum-exp in log2 units: fold wp * 2^M into (m, s) with one
// exponential and no branch, so the stars' chains interleave. A cell with
// M = -inf adds nothing (its product may be NaN: both band terms -inf); a
// NaN M or wp poisons s.
template <typename T>
__device__ __forceinline__ void lse_push(T& m, T& s, T M, T wp) {
  const T d = M - m;
  const T e = exp2_fast(-fabs(d));
  const T wq = M == T(-INFINITY) ? T(0) : wp;
  const bool up = d > T(0);
  s = up ? d_fma(s, e, wq) : d_fma(wq, e, s);
  m = up ? M : m;
}

template <typename T>
__device__ __forceinline__ void lse_merge(T& m, T& s, T m2, T s2) {
  const T mn = m > m2 ? m : m2;
  s = s * exp2_fast(m - mn) + s2 * exp2_fast(m2 - mn);
  m = mn;
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads) cluster_marginal_partial(
    const T* __restrict__ flux,            // (W, B, E) primary/secondary flux
    const T* __restrict__ mags,            // (W, B, E) model magnitudes
    const T* __restrict__ masses,          // (W, E)
    const T* __restrict__ ln_dm,           // (W, E) ln|dm/dEEP|
    const uint8_t* __restrict__ valid,     // (W, E) primary rows
    const uint8_t* __restrict__ valid_k,   // (W, E) secondary rows
    const T* __restrict__ lnjrow,          // (W, S, E) prop lnlike + mass prior
    const T* __restrict__ eeps,            // (E,)
    const T* __restrict__ magv,            // (S, B)
    const T* __restrict__ magu,            // (S, B)
    const T* __restrict__ params,          // (W, 4) ln fB, ln(1-fB), gamma, ln c_q
    T q_lo, int q_jacobian, int S, int E, int n_bands, int kc,
    T* __restrict__ part_m, T* __restrict__ part_s) {  // (W, S, n_jt), log2 units
  constexpr int TS = stars_per_block<T, NB>();
  constexpr int BC = NB > 0 ? NB : kMaxBands;  // band capacity of the per-star arrays
  const int nb = NB > 0 ? NB : n_bands;
  const int n_jt = gridDim.x;
  const int jt = n_jt - 1 - blockIdx.x;  // long rows first
  const int s0 = blockIdx.y * TS;
  const int w = blockIdx.z;
  const int j0 = jt * kRows;
  const int j_hi = min(j0 + kRows, E) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sh_flux = reinterpret_cast<T*>(smem);  // [nb][kc]
  T* sh_mass = sh_flux + nb * kc;           // [kc]
  T* sh_lnq = sh_mass + kc;                 // [kc] (ln c_q + gamma ln m_k [+ ln dm_k]) log2 e
  T* sh_woff = sh_lnq + kc;                 // [kc] w_inner for k < j, 0 where !valid_k
  T* sh_wdiag = sh_woff + kc;               // [kc] w_inner for k == j, 0 where !valid_k
  __shared__ T red_m[kWarps][TS];
  __shared__ T red_s[kWarps][TS];

  const T* flux_w = flux + (size_t)w * nb * E;
  const T* mags_w = mags + (size_t)w * nb * E;
  const T* masses_w = masses + (size_t)w * E;
  const T* ln_dm_w = ln_dm + (size_t)w * E;
  const uint8_t* valid_w = valid + (size_t)w * E;
  const uint8_t* valid_k_w = valid_k + (size_t)w * E;
  const T lfb = params[w * 4 + 0] * T(kLog2e);
  const T l1mfb = params[w * 4 + 1] * T(kLog2e);
  const T gamma = params[w * 4 + 2];
  const T ln_cq = params[w * 4 + 3];

  // the star tile's constants: r g = fma(m, g, -m_obs g)
  T cg[TS][BC], cn[TS][BC];
#pragma unroll
  for (int t = 0; t < TS; ++t) {
    const int s = min(s0 + t, S - 1);
#pragma unroll
    for (int b = 0; b < nb; ++b) {
      const T g = T(kSqrtHalfLog2e) / magu[s * nb + b];
      cg[t][b] = g;
      cn[t][b] = -magv[s * nb + b] * g;
    }
  }
  T run_m[TS], run_s[TS];
#pragma unroll
  for (int t = 0; t < TS; ++t) {
    run_m[t] = T(kNegBig);
    run_s[t] = T(0);
  }

  for (int c0 = 0; c0 <= j_hi; c0 += kc) {
    const int nk = min(kc, j_hi + 1 - c0);
    __syncthreads();  // the previous chunk is read
    for (int i = threadIdx.x; i < nk; i += kThreads) {
      const int k = c0 + i;
      for (int b = 0; b < nb; ++b) sh_flux[b * kc + i] = flux_w[b * E + k];
      const T mk = masses_w[k];
      sh_mass[i] = mk;
      T lq = ln_cq + gamma * d_log(mk);
      if (q_jacobian) lq = lq + ln_dm_w[k];
      sh_lnq[i] = lq * T(kLog2e);
      const T de_km1 = k > 0 ? eeps[k] - eeps[k - 1] : T(0);
      const T de_k = k < E - 1 ? eeps[k + 1] - eeps[k] : T(0);
      const bool vk = valid_k_w[k] != 0;
      sh_woff[i] = vk ? T(0.5) * (de_k + de_km1) : T(0);
      sh_wdiag[i] = vk ? T(0.5) * (T(0) + de_km1) : T(0);
    }
    __syncthreads();

    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int j = j0 + warp + rr * kWarps;
      if (j > j_hi || j < c0 || !valid_w[j]) continue;
      const T m_j = masses_w[j];
      const T ln_m_j = d_log(m_j);
      const T lnq_j = (gamma * ln_m_j + (q_jacobian ? ln_m_j : T(0))) * T(kLog2e);
      const T de_jm1 = j > 0 ? eeps[j] - eeps[j - 1] : T(0);
      const T de_j = j < E - 1 ? eeps[j + 1] - eeps[j] : T(0);
      const T w_outer = T(0.5) * (de_jm1 + de_j);
      T fj[BC], y[TS][BC], row[TS];
#pragma unroll
      for (int b = 0; b < nb; ++b) fj[b] = flux_w[b * E + j];
#pragma unroll
      for (int t = 0; t < TS; ++t) {
        const int s = min(s0 + t, S - 1);
        row[t] = lnjrow[((size_t)w * S + s) * E + j] * T(kLog2e);
#pragma unroll
        for (int b = 0; b < nb; ++b) {
          const T z = d_fma(mags_w[b * E + j], cg[t][b], cn[t][b]);
          y[t][b] = d_fma(-z, z, l1mfb);
        }
      }

      const int k_end = min(j, c0 + nk - 1);
      for (int k = c0 + lane; k <= k_end; k += 32) {
        const int kk = k - c0;
        const T q = sh_mass[kk] / m_j;
        if (!(q >= q_lo)) continue;
        const T w2 = w_outer * (k < j ? sh_woff[kk] : sh_wdiag[kk]);
        if (!(w2 > T(0))) continue;
        const T lnq = sh_lnq[kk] - lnq_j;
        T mb[BC];
#pragma unroll
        for (int b = 0; b < nb; ++b) mb[b] = T(-2.5) * d_log10(fj[b] + sh_flux[b * kc + kk]);
#pragma unroll
        for (int t = 0; t < TS; ++t) {
          T sm = row[t] + lnq;
          T prod = T(1);
#pragma unroll
          for (int b = 0; b < nb; ++b) {
            const T z = d_fma(mb[b], cg[t][b], cn[t][b]);
            const T x = d_fma(-z, z, lfb);
            sm += d_max(x, y[t][b]);
            prod = d_fma(prod, exp2_fast(-fabs(x - y[t][b])), prod);
          }
          lse_push(run_m[t], run_s[t], sm, w2 * prod);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TS; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T m2 = __shfl_xor_sync(0xffffffffu, run_m[t], off);
      const T s2 = __shfl_xor_sync(0xffffffffu, run_s[t], off);
      lse_merge(run_m[t], run_s[t], m2, s2);
    }
    if (lane == 0) {
      red_m[warp][t] = run_m[t];
      red_s[warp][t] = run_s[t];
    }
  }
  __syncthreads();
  if (threadIdx.x < TS && s0 + (int)threadIdx.x < S) {
    const int t = threadIdx.x;
    T m = red_m[0][t], s = red_s[0][t];
    for (int i = 1; i < kWarps; ++i) lse_merge(m, s, red_m[i][t], red_s[i][t]);
    const size_t o = ((size_t)w * S + s0 + t) * n_jt + jt;
    part_m[o] = m;
    part_s[o] = s;
  }
}

template <typename T>
__global__ void cluster_marginal_finish(const T* __restrict__ part_m, const T* __restrict__ part_s,
                                        int n_items, int n_jt, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  T m = T(kNegBig), s = T(0);
  for (int jt = 0; jt < n_jt; ++jt) lse_merge(m, s, part_m[(size_t)i * n_jt + jt], part_s[(size_t)i * n_jt + jt]);
  // no support -> s == 0 -> -inf; support only through the -1e30 sentinel
  // lands near -1e30 -> -inf as well (no physical ln-marginal nears -1e20);
  // a NaN sum (a NaN cell term) -> -inf
  const T res = (d_log2(s) + m) * T(kLn2);
  out[i] = res > T(-1e20) ? res : T(-INFINITY);
}

int n_jtiles(int E) { return (E + kRows - 1) / kRows; }

// k per staged chunk: as many as fit in kSmemBytes, a multiple of 32
int chunk_k(int E, int B, int elem) {
  const int fit = kSmemBytes / ((B + 4) * elem) / 32 * 32;
  const int need = (E + 31) / 32 * 32;
  return fit < need ? fit : need;
}

template <typename T, int NB>
cudaError_t launch_partial(const T* flux, const T* mags, const T* masses, const T* ln_dm, const uint8_t* valid,
                           const uint8_t* valid_k, const T* lnjrow, const T* eeps, const T* magv, const T* magu,
                           const T* params, double q_lo, int q_jacobian, int W, int S, int E, int B, T* part_m,
                           T* part_s, cudaStream_t st) {
  constexpr int TS = stars_per_block<T, NB>();
  const int kc = chunk_k(E, B, (int)sizeof(T));
  const size_t smem = (size_t)(B + 4) * kc * sizeof(T);
  const dim3 grid(n_jtiles(E), (S + TS - 1) / TS, W);
  cluster_marginal_partial<T, NB><<<grid, kThreads, smem, st>>>(
      flux, mags, masses, ln_dm, valid, valid_k, lnjrow, eeps, magv, magu, params, T(q_lo), q_jacobian, S, E, B,
      kc, part_m, part_s);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* flux, const T* mags, const T* masses, const T* ln_dm, const uint8_t* valid,
           const uint8_t* valid_k, const T* lnjrow, const T* eeps, const T* magv, const T* magu,
           const T* params, double q_lo, int q_jacobian, int W, int S, int E, int B, T* part_m,
           T* part_s, T* out, void* stream) {
  if (W <= 0 || S <= 0 || E <= 0 || B <= 0 || B > kMaxBands) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CLUSTER_PARTIAL(NB)                                                                                  \
  launch_partial<T, NB>(flux, mags, masses, ln_dm, valid, valid_k, lnjrow, eeps, magv, magu, params, q_lo, \
                        q_jacobian, W, S, E, B, part_m, part_s, st)
  cudaError_t err;
  switch (B) {
    case 1: err = CLUSTER_PARTIAL(1); break;
    case 2: err = CLUSTER_PARTIAL(2); break;
    case 3: err = CLUSTER_PARTIAL(3); break;
    case 4: err = CLUSTER_PARTIAL(4); break;
    default: err = CLUSTER_PARTIAL(0); break;
  }
#undef CLUSTER_PARTIAL
  if (err != cudaSuccess) return (int)err;
  const int n_items = W * S;
  cluster_marginal_finish<T><<<(n_items + 255) / 256, 256, 0, st>>>(part_m, part_s, n_items, n_jtiles(E), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cluster_marginal_num_jtiles(int E) { return n_jtiles(E); }

int cluster_marginal_max_bands() { return kMaxBands; }

const char* cluster_marginal_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int cluster_marginal_f32(const float* flux, const float* mags, const float* masses, const float* ln_dm,
                         const uint8_t* valid, const uint8_t* valid_k, const float* lnjrow, const float* eeps,
                         const float* magv, const float* magu, const float* params, double q_lo,
                         int q_jacobian, int W, int S, int E, int B, float* part_m, float* part_s, float* out,
                         void* stream) {
  return launch<float>(flux, mags, masses, ln_dm, valid, valid_k, lnjrow, eeps, magv, magu, params, q_lo,
                       q_jacobian, W, S, E, B, part_m, part_s, out, stream);
}

int cluster_marginal_f64(const double* flux, const double* mags, const double* masses, const double* ln_dm,
                         const uint8_t* valid, const uint8_t* valid_k, const double* lnjrow,
                         const double* eeps, const double* magv, const double* magu, const double* params,
                         double q_lo, int q_jacobian, int W, int S, int E, int B, double* part_m,
                         double* part_s, double* out, void* stream) {
  return launch<double>(flux, mags, masses, ln_dm, valid, valid_k, lnjrow, eeps, magv, magu, params, q_lo,
                        q_jacobian, W, S, E, B, part_m, part_s, out, stream);
}

}  // extern "C"
