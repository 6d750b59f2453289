// The forward model: (mass, age, feh, distance, AV) -> (EEP, model columns,
// magnitudes), one thread a point.
//
// Replaces the JAX package's fused forward model, _generate_g
// (isochrones_tpu/models/interpolator.py:109-156), which XLA compiles into one
// TPU program: for each point it
//
//   1. inverts (mass, age, feh) to an EEP on the evolution tracks
//      (isochrones_tpu/ops/eep.py::interp_eep): locates [Fe/H] and mass among
//      the track knots (searchsorted), finds the age in each of the four
//      corner tracks' +inf-padded age rows by searchsorted_rows' fixed-step
//      bisection, substitutes a neighbour for a corner past its track's end
//      in the reference's order, and blends the four integer EEPs
//      bilinearly; NaN for a NaN or out-of-bounds input and for an age past
//      a full-length track;
//   2. locates the cell of (feh, mass, eep) on the 3 model-grid axes once and
//      lerps the 8 corner rows' wanted columns: Teff, logg, feh and Mbol, then
//      the P columns the caller asked for;
//   3. locates the cell of (Teff, logg, feh, AV) on the 4 BC-grid axes and
//      lerps the band columns of the 16 corner rows, from a compact copy of
//      the BC table (ops/catalog_cuda.py::compact_table);
//   4. forms mag = Mbol + 5 log10(d / 10) - BC; with all_As once more at
//      AV = 0, reusing step 2's lerp (the JAX program recomputes it; the
//      numbers are the same).
//
// Three instantiations of one body (Mode): the inversion in the kernel
// (generate); the EEP given (generate(eeps=...), and the accurate path after
// the torch Newton step); the EEP alone (the fast get_eep on a track grid).
//
// Semantics are those of the plain version (isochrones_torch/ops/generate.py,
// ops/eep.py, ops/interp.py, ops/mags.py), through interp_common.cuh: cell
// location step for step, every corner's product in the sum (weight 0
// included, so a NaN-padded neighbour poisons the lerp as IEEE 0 * NaN does in
// torch), _pin_top and the exact_affine fix-up. The EEP blend
// (1 - d1) * e00 + d1 * e01 is written with __f*_rn / __d*_rn: eager torch
// never contracts it into a fused multiply-add, nvcc would, and one unit in
// the last place decides at a track's last valid EEP whether the lerp reads
// the NaN-padded neighbour. The EEP equals the plain version's bitwise.
// The track lengths are int64 and compared with the int64 insertion
// indices, as torch compares them.
//
// What bounds it: not the bytes (a point reads its 5 inputs and writes 1 +
// P + n_bands values; the rows it gathers are a few hundred bytes) but each
// point's chain of dependent reads: two knot searches, ~12 bisection steps
// over four age rows (the four run interleaved, so their reads are in flight
// together), then the model's 8 corner rows, then the BC table's 16. One lane
// a point, as the catalog kernel measured (PERF.md): more lanes a point would
// repeat the cell location and not shorten the chain. No tensor cores: there
// is no matrix product. Every lane of a warp reaches every shuffle and vote of
// the cell location: lanes past the batch take a NaN point and stay; only a
// warp wholly past the batch leaves. 64-bit row offsets; float and double.

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBands = 16;
constexpr int kMaxCols = 32;  // the 4 magnitude columns and up to 28 asked for

enum Mode : int { kInvert = 0, kGiven = 1, kEepOnly = 2 };

struct GenerateArgs {
  const void* in[5];        // mass, age, feh, distance, AV: N values each, element strides `stride`
  const void* eeps_in;      // (N,) contiguous EEPs (kGiven)
  const void* model;        // (m0, m1, m2, row_len) model table
  const void* bc;           // (b0, b1, b2, b3, bc_ncols) compact BC table, or null without bands
  const void* age_rows;     // (n_tracks, n_eep) track ages, +inf past each track's end
  const void* lengths;      // (n_tracks,) int64 track lengths
  void* eep;                // (N,) out (kInvert, kEepOnly)
  void* props;              // (N, P) out
  void* mags;               // (N, n_bands) out
  void* mags0;              // (N, n_bands) out at AV = 0, or null
  long long stride[5];
  long long N;
  long long n_eep;          // the age rows' length
  long long n_tracks;
  double eep0;              // the first EEP knot
  int io[3];                // model axis d takes column io[d] of (mass, eep, feh)
  int n_steps;              // bisection steps: ceil(log2(max(n_eep, 2))) + 1
  int row_len;              // the model table's columns
  int ncols;                // 4 + P
  int P;
  int n_bands;
  int bc_ncols;             // W: 4, 8 or 16, at least n_bands
  int pad;
  int cols[kMaxCols];       // model columns lerped: Teff, logg, feh, Mbol, then the P asked for
  Axis inv_ax[2];           // the tracks' [Fe/H] and mass knots (searchsorted)
  Axis model_ax[3];
  Axis bc_ax[4];
};

template <typename T>
__device__ __forceinline__ T input(const GenerateArgs& a, int k, long long i) {
  return static_cast<const T*>(a.in[k])[i * a.stride[k]];
}

// ops/eep.py::interp_eep for one point (NaN inputs, out-of-bounds [Fe/H] or
// mass and an age past a full-length track give NaN); every lane of the warp
// calls it (the knot searches vote)
template <typename T>
__device__ T invert(const GenerateArgs& a, T mass, T age, T feh) {
  AxisReads<T> rf, rm;
  locate_reads<T, 1>(a.inv_ax[0], feh, 0, rf);
  locate_reads<T, 1>(a.inv_ax[1], mass, 0, rm);
  const bool bad = isnan(age) || isnan(feh) || isnan(mass) || feh < rf.first || feh > rf.last ||
                   mass < rm.first || mass > rm.last;
  long long c0, c1;
  T d0, d1;
  locate_finish<T, 1>(a.inv_ax[0], feh, bad, 0, rf, c0, d0);
  locate_finish<T, 1>(a.inv_ax[1], mass, bad, 0, rm, c1, d1);
  if (bad) return T(NAN);
  const long long n_feh = a.inv_ax[0].n, n_mass = a.inv_ax[1].n;
  c0 = clampll(c0, 0, n_feh - 1);
  c1 = clampll(c1, 0, n_mass - 1);
  const long long c0p = clampll(c0 + 1, 0, n_feh - 1), c1p = clampll(c1 + 1, 0, n_mass - 1);
  const long long ind[4] = {c0 * n_mass + c1, c0 * n_mass + c1p, c0p * n_mass + c1, c0p * n_mass + c1p};

  // searchsorted_rows: the four lower bounds, one bisection step of each in turn
  const T* rows = static_cast<const T*>(a.age_rows);
  const long long last = a.n_tracks * a.n_eep - 1;
  long long lo[4] = {0, 0, 0, 0}, hi[4] = {a.n_eep, a.n_eep, a.n_eep, a.n_eep};
  for (int s = 0; s < a.n_steps; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long mid = (lo[k] + hi[k]) / 2;
      const long long idx = ind[k] * a.n_eep + mid;
      // once the interval has closed on n_eep the step reads the next row's
      // first entry (past the last row nothing), as the plain version does
      const bool pred = __ldg(rows + (idx < last ? idx : last)) < age && idx <= last;
      lo[k] = pred ? mid + 1 : lo[k];
      hi[k] = pred ? hi[k] : mid;
    }
  }
  bool past = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) past = past || lo[k] >= a.n_eep;  // past a full-length track
  if (past) return T(NAN);

  const long long* len = static_cast<const long long*>(a.lengths);
  T e[4];
  bool inv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = add_rn(T(lo[k]), T(a.eep0));
    inv[k] = lo[k] >= __ldg(len + ind[k]);
  }
  // the end-of-track substitution in sequence: e01 takes the substituted e00
  e[0] = inv[0] ? e[1] : e[0];
  e[1] = inv[1] ? e[0] : e[1];
  e[2] = inv[2] ? e[3] : e[2];
  e[3] = inv[3] ? e[2] : e[3];
  const T lo_m = add_rn(mul_rn(sub_rn(T(1), d1), e[0]), mul_rn(d1, e[1]));
  const T hi_m = add_rn(mul_rn(sub_rn(T(1), d1), e[2]), mul_rn(d1, e[3]));
  return add_rn(mul_rn(sub_rn(T(1), d0), lo_m), mul_rn(d0, hi_m));
}

// the magnitudes Mbol + 5 log10(d / 10) - BC at (Teff, logg, feh, av), in
// torch's order; every lane of the warp calls it
template <typename T, int W>
__device__ void bands_out(const GenerateArgs& a, const T* v, T dist_mod, T av, bool active, long long q, void* out) {
  T bcv[W];
  const T bx[4] = {v[0], v[1], v[2], av};
  interp_group<T, 4, 1, W, true>(static_cast<const T*>(a.bc), a.bc_ax, bx, W, nullptr, W, 0, bcv);
  if (!active) return;
  T* o = static_cast<T*>(out) + q * a.n_bands;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k == a.n_bands) break;
    o[k] = sub_rn(add_rn(v[3], dist_mod), bcv[k]);
  }
}

template <typename T, int W, int MODE>
__global__ void __launch_bounds__(kThreads) generate_kernel(const __grid_constant__ GenerateArgs a) {
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps N < 2^31
  if ((long long)(q & ~31u) >= a.N) return;  // the whole warp lies past the batch
  const bool active = q < a.N;
  const long long qc = active ? q : a.N - 1;
  const T mass = active ? input<T>(a, 0, qc) : T(NAN);  // an idle lane's point is NaN: no reads
  const T feh = input<T>(a, 2, qc);
  T eep;
  if constexpr (MODE == kGiven) {
    eep = active ? static_cast<const T*>(a.eeps_in)[qc] : T(NAN);
  } else {
    eep = invert<T>(a, mass, input<T>(a, 1, qc), feh);
    if (active) static_cast<T*>(a.eep)[q] = eep;
  }
  if constexpr (MODE != kEepOnly) {
    auto user = [&](int i) { return i == 0 ? mass : i == 1 ? eep : feh; };  // selects: no local memory
    const T gx[3] = {user(a.io[0]), user(a.io[1]), user(a.io[2])};
    T v[kMaxCols];
    interp_group<T, 3, 1, kMaxCols, false>(static_cast<const T*>(a.model), a.model_ax, gx, a.row_len, a.cols,
                                           a.ncols, 0, v);
    if (active) {
      T* p = static_cast<T*>(a.props) + q * a.P;
#pragma unroll
      for (int c = 0; c < kMaxCols - 4; ++c) {
        if (c == a.P) break;
        p[c] = v[4 + c];
      }
    }
    if (a.n_bands > 0) {
      const T dist_mod = mul_rn(T(5), d_log10(div_rn(input<T>(a, 3, qc), T(10))));
      bands_out<T, W>(a, v, dist_mod, input<T>(a, 4, qc), active, q, a.mags);
      if (a.mags0) bands_out<T, W>(a, v, dist_mod, T(0), active, q, a.mags0);
    }
  }
}

template <typename T, int W, int MODE>
cudaError_t launch_w(const GenerateArgs& a, cudaStream_t st) {
  const long long blocks = (a.N + kThreads - 1) / kThreads;
  generate_kernel<T, W, MODE><<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const GenerateArgs* args, int mode, void* stream) {
  const GenerateArgs& a = *args;
  const bool fwd = mode == kInvert || mode == kGiven;
  if (mode < kInvert || mode > kEepOnly || a.N < 0 || a.N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return 0;
  if (a.n_steps < 1 || a.n_eep < 1 || a.n_tracks != a.inv_ax[0].n * a.inv_ax[1].n || !a.in[0] || !a.in[2] ||
      (mode != kGiven && !a.in[1]) ||
      (mode != kGiven && (!a.eep || !a.age_rows || !a.lengths)) || (mode == kGiven && !a.eeps_in))
    return (int)cudaErrorInvalidValue;
  if (fwd && (a.P < 0 || a.ncols != 4 + a.P || a.ncols > kMaxCols || a.n_bands < 0 || a.n_bands > kMaxBands ||
              a.n_bands > a.bc_ncols || !a.model || (a.P > 0 && !a.props) ||
              (a.n_bands > 0 && (!a.bc || !a.mags || !a.in[3] || !a.in[4])) || (a.mags0 && a.n_bands == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kEepOnly) return (int)launch_w<T, 4, kEepOnly>(a, st);
  switch (a.bc_ncols) {  // the compact table's instantiated widths only
    case 4: return (int)(mode == kInvert ? launch_w<T, 4, kInvert>(a, st) : launch_w<T, 4, kGiven>(a, st));
    case 8: return (int)(mode == kInvert ? launch_w<T, 8, kInvert>(a, st) : launch_w<T, 8, kGiven>(a, st));
    case 16: return (int)(mode == kInvert ? launch_w<T, 16, kInvert>(a, st) : launch_w<T, 16, kGiven>(a, st));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int generate_args_size() { return (int)sizeof(GenerateArgs); }

int generate_max_bands() { return kMaxBands; }

int generate_max_cols() { return kMaxCols; }

// `args` points to a GenerateArgs (void*: see star_lnlike.cu); `mode` is a Mode
int generate_f32(const void* args, int mode, void* stream) {
  return launch<float>(static_cast<const GenerateArgs*>(args), mode, stream);
}

int generate_f64(const void* args, int mode, void* stream) {
  return launch<double>(static_cast<const GenerateArgs*>(args), mode, stream);
}

}  // extern "C"
