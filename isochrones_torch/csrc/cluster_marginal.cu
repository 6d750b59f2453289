// Hierarchical-cluster marginal likelihood: one CUDA kernel for a batch of
// walkers.
//
// Replaces the Pallas TPU kernel isochrones_tpu/ops/cluster_pallas.py
// (_cluster_kernel, launched by cluster_lnmarginal_pallas). For walker w and
// star s it returns
//
//   ln sum_{j, k<=j} W2[j,k] exp(a[w,s,j,k]),
//   a = sum_b logaddexp(ln fB - r_bin^2/2u^2, ln(1-fB) - r_single^2/2u^2)
//       + lnq[j,k] + lnjrow[w,s,j],
//
// over the (primary EEP j, secondary EEP k) plane, where r_bin uses the
// binary magnitude -2.5 log10(f_j + f_k) and r_single the primary's own.
// Cells outside the mask (q < q_lo, k > j, invalid j or k, zero trapezoid
// weight) do not enter the sum.
//
// What bounds it: special functions and FMAs, not bytes. Per walker it reads
// O(E*B + S*E) values but evaluates about S*E^2/2*B logaddexp (one exp and
// one log1p each) and one exp per (star, cell): ~37 M logaddexp per walker at
// S=50, E=700, B=3.
//
// Design, against that bound:
// * One block takes (walker, tile of 8 stars, tile of 16 primary rows j) and
//   loops over the secondary axis k inside the block: each warp owns rows,
//   its lanes stride over k <= j, so blocks above the diagonal never exist.
// * The star-independent binary magnitude (one log10 per band and cell) is
//   computed once and reused across the 8 stars of the tile, whose running
//   sums live in registers.
// * The q prior, the mask and the trapezoid weight are computed per cell from
//   the per-walker vectors (masses, ln dm/dEEP, validity, the EEP ladder):
//   W2[j,k] = w_outer[j] * w_inner[j,k] is the closed form of
//   ops/cluster_cuda.py::trapezoid_weights, so no (E, E) plane is ever
//   written to device memory.
// * Each thread keeps a streaming log-sum-exp per star (running max and
//   rescaled sum; one exp per cell). A warp-shuffle and shared-memory
//   reduction ends the block, which writes a partial (max, sum) per
//   (walker, star, j tile); a second small kernel merges the partials over
//   j tiles and applies log(sum) + max with the -inf cut below -1e20.
// * Accurate expf/log1pf/log10f (no fast math). Instantiated for float and
//   double.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStars = 8;   // stars per block, kept in registers
constexpr int kRows = 16;   // primary rows j per block
constexpr int kMaxBands = 16;
constexpr double kNegBig = -1e30;  // the kernel's "no support" sentinel

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float d_log10(float x) { return log10f(x); }
__device__ __forceinline__ double d_log10(double x) { return log10(x); }

// jnp.logaddexp semantics: two infinities of one sign return that infinity,
// NaN propagates.
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  const T d = a - b;
  if (isnan(d)) return a + b;
  const T mx = d > T(0) ? a : b;
  return mx + d_log1p(d_exp(-fabs(d)));
}

// streaming log-sum-exp: fold w * exp(a) into (m, s), one exp per call
template <typename T>
__device__ __forceinline__ void lse_push(T& m, T& s, T a, T w) {
  if (a > m) {
    s = s * d_exp(m - a) + w;
    m = a;
  } else {
    s += w * d_exp(a - m);
  }
}

template <typename T>
__device__ __forceinline__ void lse_merge(T& m, T& s, T m2, T s2) {
  const T mn = m > m2 ? m : m2;
  s = s * d_exp(m - mn) + s2 * d_exp(m2 - mn);
  m = mn;
}

template <typename T>
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
    T q_lo, int q_jacobian, int S, int E, int B,
    T* __restrict__ part_m, T* __restrict__ part_s) {  // (W, S, n_jt)
  const int jt = blockIdx.x;
  const int n_jt = gridDim.x;
  const int s0 = blockIdx.y * kStars;
  const int w = blockIdx.z;
  const int j0 = jt * kRows;

  __shared__ T sh_magv[kStars][kMaxBands];
  __shared__ T sh_inv[kStars][kMaxBands];
  __shared__ T sh_row[kStars][kRows];
  __shared__ T red_m[kWarps][kStars];
  __shared__ T red_s[kWarps][kStars];

  for (int i = threadIdx.x; i < kStars * kMaxBands; i += kThreads) {
    const int t = i / kMaxBands, b = i % kMaxBands, s = s0 + t;
    const bool ok = s < S && b < B;
    const T u = ok ? magu[s * B + b] : T(1);
    sh_magv[t][b] = ok ? magv[s * B + b] : T(0);
    sh_inv[t][b] = T(1) / (u * u);
  }
  for (int i = threadIdx.x; i < kStars * kRows; i += kThreads) {
    const int t = i / kRows, r = i % kRows, s = s0 + t, j = j0 + r;
    sh_row[t][r] = (s < S && j < E) ? lnjrow[((size_t)w * S + s) * E + j] : T(kNegBig);
  }
  __syncthreads();

  const T* flux_w = flux + (size_t)w * B * E;
  const T* mags_w = mags + (size_t)w * B * E;
  const T* masses_w = masses + (size_t)w * E;
  const T* ln_dm_w = ln_dm + (size_t)w * E;
  const uint8_t* valid_w = valid + (size_t)w * E;
  const uint8_t* valid_k_w = valid_k + (size_t)w * E;
  const T ln_fb = params[w * 4 + 0];
  const T ln_1mfb = params[w * 4 + 1];
  const T gamma = params[w * 4 + 2];
  const T ln_cq = params[w * 4 + 3];

  T run_m[kStars], run_s[kStars];
#pragma unroll
  for (int t = 0; t < kStars; ++t) {
    run_m[t] = T(kNegBig);
    run_s[t] = T(0);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int j = j0 + r;
    if (j >= E || !valid_w[j]) continue;
    const T m_j = masses_w[j];
    const T ln_m_j = d_log(m_j);
    const T de_jm1 = j > 0 ? eeps[j] - eeps[j - 1] : T(0);
    const T de_j = j < E - 1 ? eeps[j + 1] - eeps[j] : T(0);
    const T w_outer = T(0.5) * (de_jm1 + de_j);
    T row[kStars];
#pragma unroll
    for (int t = 0; t < kStars; ++t) row[t] = sh_row[t][r];

    for (int k = lane; k <= j; k += 32) {
      if (!valid_k_w[k]) continue;
      const T q = masses_w[k] / m_j;
      if (!(q >= q_lo)) continue;
      const T de_km1 = k > 0 ? eeps[k] - eeps[k - 1] : T(0);
      const T de_k = k < E - 1 ? eeps[k + 1] - eeps[k] : T(0);
      const T w2 = w_outer * (T(0.5) * ((k + 1 <= j ? de_k : T(0)) + de_km1));
      if (!(w2 > T(0))) continue;
      T lnq = ln_cq + gamma * d_log(q);
      if (q_jacobian) lnq = lnq + ln_dm_w[k] - ln_m_j;

      T acc[kStars];
#pragma unroll
      for (int t = 0; t < kStars; ++t) acc[t] = T(0);
      for (int b = 0; b < B; ++b) {
        const T mag_bin = T(-2.5) * d_log10(flux_w[b * E + j] + flux_w[b * E + k]);
        const T mag_j = mags_w[b * E + j];
#pragma unroll
        for (int t = 0; t < kStars; ++t) {
          const T mv = sh_magv[t][b];
          const T inv = sh_inv[t][b];
          const T rb = mag_bin - mv;
          const T rs = mag_j - mv;
          acc[t] += logaddexp(ln_fb - T(0.5) * rb * rb * inv, ln_1mfb - T(0.5) * rs * rs * inv);
        }
      }
#pragma unroll
      for (int t = 0; t < kStars; ++t) lse_push(run_m[t], run_s[t], acc[t] + lnq + row[t], w2);
    }
  }

#pragma unroll
  for (int t = 0; t < kStars; ++t) {
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
  if (threadIdx.x < kStars) {
    const int t = threadIdx.x;
    T m = red_m[0][t], s = red_s[0][t];
    for (int i = 1; i < kWarps; ++i) lse_merge(m, s, red_m[i][t], red_s[i][t]);
    if (s0 + t < S) {
      const size_t o = ((size_t)w * S + s0 + t) * n_jt + jt;
      part_m[o] = m;
      part_s[o] = s;
    }
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
  // lands near -1e30 -> -inf as well (no physical ln-marginal nears -1e20)
  const T res = d_log(s) + m;
  out[i] = res > T(-1e20) ? res : T(-INFINITY);
}

int n_jtiles(int E) { return (E + kRows - 1) / kRows; }

template <typename T>
int launch(const T* flux, const T* mags, const T* masses, const T* ln_dm, const uint8_t* valid,
           const uint8_t* valid_k, const T* lnjrow, const T* eeps, const T* magv, const T* magu,
           const T* params, double q_lo, int q_jacobian, int W, int S, int E, int B, T* part_m,
           T* part_s, T* out, void* stream) {
  if (W <= 0 || S <= 0 || E <= 0 || B <= 0 || B > kMaxBands) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_jt = n_jtiles(E);
  const dim3 grid(n_jt, (S + kStars - 1) / kStars, W);
  cluster_marginal_partial<T><<<grid, kThreads, 0, st>>>(flux, mags, masses, ln_dm, valid, valid_k, lnjrow,
                                                         eeps, magv, magu, params, T(q_lo), q_jacobian, S,
                                                         E, B, part_m, part_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_items = W * S;
  cluster_marginal_finish<T><<<(n_items + 255) / 256, 256, 0, st>>>(part_m, part_s, n_items, n_jt, out);
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
