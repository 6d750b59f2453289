// Kernel B's design variants, as measured by scripts/tune_torch_interp.py:
// a copy of isochrones_torch/csrc/interp_nd.cu as it stood when the variants
// were timed, with the build switches that the library's source does not
// keep. Only the tune script builds it (with -I isochrones_torch/csrc, for
// interp_common.cuh); the library never does. Its entry points and argument
// struct are the library's, float32 and float64 in one unit; its B' entry
// points return cudaErrorNotSupported (B' is the library's alone).
//
// -DINTERP_STAGED_IO=1: the points in by 16-byte cp.async copies into
//   shared memory and, where ncols >= 2, the values out through shared
//   memory 16 bytes a store (measured slower at the ladder's call);
// -DINTERP_PART=1: the exact instances cut to the cell search, without the
//   gathers (the parts of the time; writes no lerp);
// -DINTERP_SHARED_LOCATE=1: interp_common.cuh's cell search in place of the
//   lane's own (64-bit cells, exact_affine's second step always taken);
// -DINTERP_CHUNK_UNROLL=n: the chunked instances' corner loop unrolled n
//   times in place of 2.
//
// The header note of the kernels themselves is the library's, in
// isochrones_torch/csrc/interp_nd.cu.

#include <cuda_pipeline_primitives.h>

#include <cstdint>
#include <type_traits>

#include "interp_common.cuh"

#ifndef INTERP_STAGED_IO
#define INTERP_STAGED_IO 0
#endif
#ifndef INTERP_PART
#define INTERP_PART 2
#endif
#ifndef INTERP_SHARED_LOCATE
#define INTERP_SHARED_LOCATE 0
#endif
#ifndef INTERP_CHUNK_UNROLL
#define INTERP_CHUNK_UNROLL 2
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDim = 6;
constexpr int kMaxCols = 128;
constexpr int kChunk = 8;
constexpr int kCornerUnroll = INTERP_CHUNK_UNROLL;  // the chunked instances' corner loop
constexpr int kExactCols = 4;    // exact column instances: 1 to kExactCols columns
constexpr int kExactMaxDim = 4;  // on grids of at most this many axes
constexpr long long kWideElements = 1LL << 31;

struct InterpArgs {
  const void* points;    // (P, ndim), the table's dtype
  const void* table;     // (n0, ..., n_{ndim-1}, row_len), or column-planar (ncols, n0, ...) with row_len 1
  const void* grad_out;  // B': (P, ncols) cotangent
  void* out;             // B: (P, ncols); B': (P, ndim)
  long long P;
  long long table_len;  // elements of the table
  int ndim;
  int ncols;
  int row_len;  // elements from one grid row to the next: the row's length, or 1 in the planar layout
  int nc_inst;  // B's column instance (the wrapper's choice): ncols for 1 to kExactCols, else kChunk
  int wide;     // 64-bit offsets (the wrapper's choice: tables of kWideElements or more)
  int pad;
  Axis axes[kMaxDim];
  int cols[kMaxCols];  // each wanted column's element offset within a row: its index, or c x (elements of a plane)
};

// n values from src to the 16-byte aligned shared dst, as 16-byte cp.async
// copies where src is 16-byte aligned, the rest value by value; committed
// as one group (every thread of the block calls it)
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, int n, T* dst) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    done = n / kPer * kPer;
    for (int i = threadIdx.x; i < n / kPer; i += kThreads) __pipeline_memcpy_async(dst + i * kPer, src + i * kPer, 16);
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  __pipeline_commit();
}

// n values from the 16-byte aligned shared src to dst, 16 bytes a store
// where dst is 16-byte aligned, the rest value by value
template <typename T>
__device__ __forceinline__ void stage_out(const T* src, int n, T* __restrict__ dst) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    done = n / kPer * kPer;
    for (int i = threadIdx.x; i < n / kPer; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// floor_to_cell in 32 bits: floor(raw) clamped to [0, n - 2]
template <typename T>
__device__ __forceinline__ int floor_cell32(T raw, int n) {
  const T f = floor(raw);
  if (!(f >= T(0))) return 0;
  if (f > T(n - 2)) return n - 2;
  return static_cast<int>(f);
}

// interp_common.cuh's cell search (locate_reads, then locate_finish) for one
// lane, in 32-bit cells, for the analytic kinds: the same rounded arithmetic
// and comparisons, so the same cell and t, with int in place of long long
// (a narrow launch's axes have fewer than 2^31 knots) and exact_affine's
// second step taken only by a lane whose first step lands a cell off (where
// the first step's cell stands, the second repeats its arithmetic). The
// searchsorted and compare kinds, which vote across the warp, and
// INTERP_SHARED_LOCATE builds take interp_common.cuh's functions.
template <typename T>
__device__ __forceinline__ void lane_reads(const Axis& ax, T x, AxisReads<T>& r) {
  const int n = static_cast<int>(ax.n);
  if (INTERP_SHARED_LOCATE || ax.kind == kSearch || ax.kind == kCompare || n < 2) {
    locate_reads<T, 1>(ax, x, 0, r);
    return;
  }
  const T* k = static_cast<const T*>(ax.knots);
  r.first = __ldg(k);
  r.last = __ldg(k + (n - 1));
  r.c0 = 0;
  if (ax.kind == kAffine || ax.kind == kLog) {
    const T xs = ax.kind == kLog ? d_log(x > T(0) ? x : T(0)) : x;
    const int c0 = floor_cell32<T>(div_rn(sub_rn(xs, T(ax.lo0)), T(ax.step)), n);
    r.c0 = c0;
    r.kn[0] = __ldg(k + c0);
    r.kn[1] = __ldg(k + (c0 + 1));
  }
}

template <typename T>
__device__ __forceinline__ void lane_finish(const Axis& ax, T x, bool skip, const AxisReads<T>& r, int& cell, T& t) {
  const int n = static_cast<int>(ax.n);
  if (INTERP_SHARED_LOCATE || ax.kind == kSearch || ax.kind == kCompare || n < 2) {
    long long c;
    locate_finish<T, 1>(ax, x, skip, 0, r, c, t);
    cell = static_cast<int>(c);
    return;
  }
  const T* k = static_cast<const T*>(ax.knots);
  if (ax.kind == kExactAffine) {
    const T lo0 = T(ax.lo0), step = T(ax.step);
    int c = floor_cell32<T>(div_rn(sub_rn(x, lo0), step), n);
    T tt = div_rn(sub_rn(x, add_rn(lo0, mul_rn(T(c), step))), step);
    const int shift = (tt >= T(1) ? 1 : 0) - (tt < T(0) ? 1 : 0);
    if (shift != 0) {  // division rounding may land one cell off near a knot
      c = min(max(c + shift, 0), n - 2);
      tt = div_rn(sub_rn(x, add_rn(lo0, mul_rn(T(c), step))), step);
    }
    cell = c;
    t = tt;
  } else {  // kAffine, kLog: knots c0 and c0 + 1 are read, others on demand
    const int c0 = static_cast<int>(r.c0);
    auto kat = [&](int i) { return i == c0 ? r.kn[0] : i == c0 + 1 ? r.kn[1] : __ldg(k + i); };
    int c = c0;
    // two-step fix-up against the true knots absorbs rounding in raw
    if (x < kat(c)) c -= 1;
    c = min(max(c, 0), n - 2);
    if (x >= kat(min(c + 1, n - 1))) c += 1;
    c = min(max(c, 0), n - 2);
    const T lo = kat(c);
    cell = c;
    t = safe_div(sub_rn(x, lo), sub_rn(kat(c + 1), lo));
  }
  if (x == r.last) {  // _pin_top
    cell = n - 1;
    t = T(0);
  }
}

// NC: 1 to kExactCols columns exactly, or kChunk (any count, in chunks);
// WIDE: 64-bit offsets
template <typename T, int NDIM, int NC, bool WIDE>
__global__ void __launch_bounds__(kThreads) interp_nd_kernel(const __grid_constant__ InterpArgs a) {
  using Off = std::conditional_t<WIDE, long long, int>;
  constexpr bool kExact = NC <= kExactCols;
  constexpr bool kStagedOut = kExact && NC >= 2 && INTERP_STAGED_IO;
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int cnt = a.P - p0 < kThreads ? static_cast<int>(a.P - p0) : kThreads;
  const int lane = threadIdx.x;
  const bool live = lane < cnt;
  const T* pts = static_cast<const T*>(a.points) + p0 * NDIM;
  T x[NDIM];
#if !INTERP_STAGED_IO
#pragma unroll
  for (int d = 0; d < NDIM; ++d) x[d] = live ? pts[lane * NDIM + d] : T(NAN);
#else
  __shared__ __align__(16) T xs[kThreads * NDIM];
  stage_in(pts, cnt * NDIM, xs);
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < NDIM; ++d) x[d] = live ? xs[lane * NDIM + d] : T(NAN);
#endif
  // the cell search: 32-bit in a narrow launch, interp_common.cuh's in a wide one
  using Cell = std::conditional_t<WIDE, long long, int>;
  AxisReads<T> reads[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    if constexpr (WIDE)
      locate_reads<T, 1>(a.axes[d], x[d], 0, reads[d]);
    else
      lane_reads<T>(a.axes[d], x[d], reads[d]);
  }
  bool bad = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) bad = bad || isnan(x[d]) || x[d] < reads[d].first || x[d] > reads[d].last;
  Cell cell[NDIM];
  T t[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    if constexpr (WIDE)
      locate_finish<T, 1>(a.axes[d], x[d], bad, 0, reads[d], cell[d], t[d]);
    else
      lane_finish<T>(a.axes[d], x[d], bad, reads[d], cell[d], t[d]);
  }

  // the corners' common offset, each axis' step to the upper corner (0 at a
  // top knot: torch clamps the upper index there) and the weight factors
  Off base = 0, step[NDIM];
  T lo_w[NDIM];  // 1 - t; the upper corner's factor is t
  {
    Off stride = static_cast<Off>(a.row_len);
#pragma unroll
    for (int d = NDIM - 1; d >= 0; --d) {
      base += static_cast<Off>(cell[d]) * stride;
      step[d] = cell[d] + 1 < static_cast<Cell>(a.axes[d].n) ? stride : Off(0);
      stride *= static_cast<Off>(a.axes[d].n);
      lo_w[d] = sub_rn(T(1), t[d]);
    }
  }
  // torch: weights = ones * where(o, t, 1 - t) axis by axis (1 * x is exact);
  // selects, not an array indexed by the corner's bits, so that a corner loop
  // the compiler keeps rolled holds them in registers
  auto corner = [&](int i, Off& off) {
    const bool o0 = (i >> (NDIM - 1)) & 1;
    T w = o0 ? t[0] : lo_w[0];
    off = base + (o0 ? step[0] : Off(0));
#pragma unroll
    for (int d = 1; d < NDIM; ++d) {
      const bool o = (i >> (NDIM - 1 - d)) & 1;
      w = mul_rn(w, o ? t[d] : lo_w[d]);
      off += o ? step[d] : Off(0);
    }
    return w;
  };
  const T* table = static_cast<const T*>(a.table);

  if constexpr (kExact) {
    T acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = T(0);
    if constexpr (INTERP_PART < 2) {  // the tuning cut: the cell search, no gathers
      T keep = T(0);
#pragma unroll
      for (int d = 0; d < NDIM; ++d) keep = keep + t[d] + T(cell[d]) + T(step[d]) + T(base);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = keep;
    } else if (live && !bad) {
#pragma unroll
      for (int i = 0; i < (1 << NDIM); ++i) {
        Off off;
        const T w = corner(i, off);
        const T* r = table + off;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = add_rn(acc[c], mul_rn(w, __ldg(r + a.cols[c])));
      }
    }
    T* out = static_cast<T*>(a.out) + p0 * NC;
    if constexpr (kStagedOut) {
      __shared__ __align__(16) T ys[kThreads * NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) ys[lane * NC + c] = bad ? T(NAN) : acc[c];
      __syncthreads();
      stage_out(ys, cnt * NC, out);
    } else if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) out[lane * NC + c] = bad ? T(NAN) : acc[c];
    }
  } else {
    if (!live) return;  // after the last vote of the cell searches
    T* out = static_cast<T*>(a.out) + (p0 + lane) * a.ncols;
    if (bad) {
      for (int c = 0; c < a.ncols; ++c) out[c] = T(NAN);
      return;
    }
    for (int c0 = 0; c0 < a.ncols; c0 += kChunk) {
      const int nc = a.ncols - c0 < kChunk ? a.ncols - c0 : kChunk;
      T acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = T(0);
#pragma unroll kCornerUnroll
      for (int i = 0; i < (1 << NDIM); ++i) {
        Off off;
        const T w = corner(i, off);
        const T* r = table + off;
        T v[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) v[c] = c < nc ? __ldg(r + a.cols[c0 + c]) : T(0);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) acc[c] = add_rn(acc[c], mul_rn(w, v[c]));
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < nc) out[c0 + c] = acc[c];
    }
  }
}

template <typename T, int NDIM, int NC, bool WIDE>
cudaError_t launch_b(const InterpArgs& a, unsigned blocks, cudaStream_t st) {
  interp_nd_kernel<T, NDIM, NC, WIDE><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool GRAD, int NDIM>
cudaError_t launch_nd(const InterpArgs& a, unsigned blocks, cudaStream_t st) {
  if constexpr (GRAD) {
    return cudaErrorNotSupported;  // B' is not among the variants: the library's source holds it
  } else {
    if (a.wide) return launch_b<T, NDIM, kChunk, true>(a, blocks, st);
    if constexpr (NDIM <= kExactMaxDim) {
      switch (a.nc_inst) {
        case 1: return launch_b<T, NDIM, 1, false>(a, blocks, st);
        case 2: return launch_b<T, NDIM, 2, false>(a, blocks, st);
        case 3: return launch_b<T, NDIM, 3, false>(a, blocks, st);
        case 4: return launch_b<T, NDIM, 4, false>(a, blocks, st);
        default: break;
      }
    }
    return launch_b<T, NDIM, kChunk, false>(a, blocks, st);
  }
}

template <typename T, bool GRAD>
int launch(const InterpArgs* args, void* stream) {
  const InterpArgs& a = *args;
  if (a.P < 0 || a.ndim < 1 || a.ndim > kMaxDim || a.ncols < 0 || a.ncols > kMaxCols || a.row_len < 1 ||
      a.table_len < 1)
    return (int)cudaErrorInvalidValue;
  // every corner offset of every wanted column lies inside the table, and a
  // narrow launch's offsets fit in 32 bits
  long long rows = 1;
  for (int d = 0; d < a.ndim; ++d) {
    if (a.axes[d].n < 1) return (int)cudaErrorInvalidValue;
    rows *= a.axes[d].n;
  }
  for (int c = 0; c < a.ncols; ++c)
    if (a.cols[c] < 0 || (rows - 1) * a.row_len + a.cols[c] >= a.table_len) return (int)cudaErrorInvalidValue;
  if (!a.wide && a.table_len >= kWideElements) return (int)cudaErrorInvalidValue;
  const bool exact = a.nc_inst >= 1 && a.nc_inst <= kExactCols;
  if (exact ? (a.nc_inst != a.ncols || a.ndim > kExactMaxDim || a.wide) : a.nc_inst != kChunk)
    return (int)cudaErrorInvalidValue;
  if (a.P == 0 || a.ncols == 0) return 0;
  const long long blocks = (a.P + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  switch (a.ndim) {
    case 1: return (int)launch_nd<T, GRAD, 1>(a, nb, st);
    case 2: return (int)launch_nd<T, GRAD, 2>(a, nb, st);
    case 3: return (int)launch_nd<T, GRAD, 3>(a, nb, st);
    case 4: return (int)launch_nd<T, GRAD, 4>(a, nb, st);
    case 5: return (int)launch_nd<T, GRAD, 5>(a, nb, st);
    default: return (int)launch_nd<T, GRAD, 6>(a, nb, st);
  }
}

}  // namespace

// `args` points to an InterpArgs; it is passed as void* because a parameter of
// a type from the unnamed namespace would give these functions internal linkage
extern "C" {

int interp_nd_f64(const void* args, void* stream) {
  return launch<double, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f64(const void* args, void* stream) {
  return launch<double, true>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_args_size() { return (int)sizeof(InterpArgs); }

int interp_nd_max_dim() { return kMaxDim; }

int interp_nd_max_cols() { return kMaxCols; }

// the column instances: exact ones up to this many columns, on grids of up to
// interp_nd_exact_max_dim() axes; chunks of interp_nd_chunk() otherwise
int interp_nd_exact_cols() { return kExactCols; }

int interp_nd_exact_max_dim() { return kExactMaxDim; }

int interp_nd_chunk() { return kChunk; }

const char* interp_nd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int interp_nd_f32(const void* args, void* stream) {
  return launch<float, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f32(const void* args, void* stream) {
  return launch<float, true>(static_cast<const InterpArgs*>(args), stream);
}

}  // extern "C"
