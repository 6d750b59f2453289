// Multilinear interpolation on a dense rectilinear grid (kernel B) and its
// gradient with respect to the points (kernel B').
//
// Replaces the row-gather path of the JAX package's interp_nd,
// isochrones_tpu/ops/interp.py:483-536 (corner_data, the einsum over the
// 2**ndim corners and the NaN mask), which XLA compiles into a fusion of
// gathers; the plain version beside it is
// isochrones_torch/ops/interp.py::interp_nd_plain. For P points (P, ndim) on
// a table (n0, ..., n_{ndim-1}, row_len) it writes (P, ncols): the wanted
// columns cols[0, ncols) of each point's lerp, NaN for a point that is NaN or
// out of bounds on any axis. B' writes (P, ndim): the vector-Jacobian product
// of a cotangent (P, ncols) with the lerp, by the plain version's autograd
// rule (dt/dx is 1 / step or 1 / (hi - lo), 0 where t is a constant; a NaN
// value passes no gradient; a bad point gets 0).
//
// Semantics come from interp_common.cuh: find_cells_1d's cell step for step
// for every axis kind (exact_affine's fix-up, the two-step fix-up of affine
// and log, _pin_top, searchsorted, the compare count), in explicitly rounded
// arithmetic so that nvcc's FMA contraction cannot move a point into another
// cell. Every one of the 2**ndim corners enters the sum, weight 0 included,
// so a NaN-padded neighbour poisons its column as torch's 0 * NaN does. The
// corner weights and the products are explicitly rounded too, and summed in
// corner order: the values differ from the plain version's only by the order
// of torch's sum.
//
// What bounds it: bytes, at the card's rate; in practice the latency of
// dependent gathers. Per point it reads its ndim coordinates, 2**ndim rows'
// wanted columns at addresses known only after the cell search, and writes
// ncols values. The cluster ladder's call (716,800 points, 3-d, 2 columns)
// touches few distinct rows, so the points in and the values out are nearly
// all of its bytes (14 MB in float32); each lane's gathers wait on its cell
// search, and those on its coordinates' loads.
//
// Design, simple first: one lane a point (interp_common.cuh's group width 1),
// 128 lanes a block. A lane locates its cell on every axis once (the reads of
// all axes in flight together, locate_reads), then takes the wanted columns
// in chunks of kChunk: per chunk one pass over the corners, each corner's
// row offset and weight recomputed (a few integer and float operations), the
// chunk's loads of a corner issued together. Lanes past P take a NaN point
// and stay to the end, since the searchsorted and wide compare kinds vote
// across the warp. Row offsets are 64-bit; ndim is at most kMaxDim and the
// columns of one call at most kMaxCols (the wrapper raises past either). The
// argument struct is a __grid_constant__ parameter: axes and column indices
// are read from the constant bank.

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDim = 6;
constexpr int kMaxCols = 128;
constexpr int kChunk = 8;

struct InterpArgs {
  const void* points;  // (P, ndim), the table's dtype
  const void* table;   // (n0, ..., n_{ndim-1}, row_len)
  const void* grad_out;  // B': (P, ncols) cotangent
  void* out;  // B: (P, ncols); B': (P, ndim)
  long long P;
  int ndim;
  int ncols;
  int row_len;
  int pad;
  Axis axes[kMaxDim];
  int cols[kMaxCols];
};

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) interp_nd_kernel(const __grid_constant__ InterpArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < a.P;
  const T* pts = static_cast<const T*>(a.points);
  const T* table = static_cast<const T*>(a.table);
  T x[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) x[d] = live ? pts[p * NDIM + d] : T(NAN);
  AxisReads<T> reads[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) locate_reads<T, 1>(a.axes[d], x[d], 0, reads[d]);
  bool bad = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) bad = bad || isnan(x[d]) || x[d] < reads[d].first || x[d] > reads[d].last;
  long long cell[NDIM];
  T t[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) locate_finish<T, 1>(a.axes[d], x[d], bad, 0, reads[d], cell[d], t[d]);
  if (!live) return;  // after the last vote of the cell searches
  T* out = static_cast<T*>(a.out) + p * a.ncols;
  if (bad) {
    for (int c = 0; c < a.ncols; ++c) out[c] = T(NAN);
    return;
  }
  long long stride[NDIM];
  stride[NDIM - 1] = a.row_len;
#pragma unroll
  for (int d = NDIM - 2; d >= 0; --d) stride[d] = stride[d + 1] * a.axes[d + 1].n;
  for (int c0 = 0; c0 < a.ncols; c0 += kChunk) {
    const int nc = a.ncols - c0 < kChunk ? a.ncols - c0 : kChunk;
    T acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = T(0);
    for (int i = 0; i < (1 << NDIM); ++i) {
      // torch: weights = ones * where(o, t, 1 - t) axis by axis
      T w = T(1);
      long long row = 0;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        const int o = (i >> (NDIM - 1 - d)) & 1;
        w = mul_rn(w, o ? t[d] : sub_rn(T(1), t[d]));
        row += clampll(cell[d] + o, 0, a.axes[d].n - 1) * stride[d];
      }
      const T* r = table + row;
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

// B': per chunk of columns, interp_common.cuh::interp_vjp (which locates the
// cell again: a chunk's cost is its gathers, not the knot reads); the chunks'
// slopes are summed.
template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) interp_nd_grad_kernel(const __grid_constant__ InterpArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < a.P;
  const T* pts = static_cast<const T*>(a.points);
  const T* gout = static_cast<const T*>(a.grad_out);
  const T* table = static_cast<const T*>(a.table);
  T x[NDIM], gx[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    x[d] = live ? pts[p * NDIM + d] : T(NAN);
    gx[d] = T(0);
  }
  for (int c0 = 0; c0 < a.ncols; c0 += kChunk) {
    const int nc = a.ncols - c0 < kChunk ? a.ncols - c0 : kChunk;
    T g[kChunk], vals[kChunk], gc[NDIM];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) g[c] = live && c < nc ? gout[p * a.ncols + c0 + c] : T(0);
    interp_vjp<T, NDIM, kChunk>(table, a.axes, x, a.row_len, a.cols + c0, nc, g, vals, gc);
#pragma unroll
    for (int d = 0; d < NDIM; ++d) gx[d] = add_rn(gx[d], gc[d]);
  }
  if (!live) return;
  T* out = static_cast<T*>(a.out) + p * NDIM;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) out[d] = gx[d];
}

template <typename T, bool GRAD, int NDIM>
cudaError_t launch_nd(const InterpArgs& a, unsigned blocks, cudaStream_t st) {
  if constexpr (GRAD)
    interp_nd_grad_kernel<T, NDIM><<<blocks, kThreads, 0, st>>>(a);
  else
    interp_nd_kernel<T, NDIM><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool GRAD>
int launch(const InterpArgs* args, void* stream) {
  const InterpArgs& a = *args;
  if (a.P < 0 || a.ndim < 1 || a.ndim > kMaxDim || a.ncols < 0 || a.ncols > kMaxCols || a.row_len < 1)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < a.ncols; ++c)
    if (a.cols[c] < 0 || a.cols[c] >= a.row_len) return (int)cudaErrorInvalidValue;
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

extern "C" {

int interp_nd_args_size() { return (int)sizeof(InterpArgs); }

int interp_nd_max_dim() { return kMaxDim; }

int interp_nd_max_cols() { return kMaxCols; }

const char* interp_nd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// `args` points to an InterpArgs; it is passed as void* because a parameter of
// a type from the unnamed namespace would give these functions internal linkage
int interp_nd_f32(const void* args, void* stream) {
  return launch<float, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_f64(const void* args, void* stream) {
  return launch<double, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f32(const void* args, void* stream) {
  return launch<float, true>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f64(const void* args, void* stream) {
  return launch<double, true>(static_cast<const InterpArgs*>(args), stream);
}

}  // extern "C"
