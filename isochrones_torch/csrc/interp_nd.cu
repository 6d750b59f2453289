// Multilinear interpolation on a dense rectilinear grid (kernel B) and its
// gradient with respect to the points (kernel B', whose note is by its
// kernel below).
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
// What bounds it on the H100: bytes at the card's rate, and before that the
// traffic between L2 and the SMs and the instructions a point issues. The
// cluster ladder's call (716,800 points, 3-d, 2 columns) touches few
// distinct rows, so the points in and the values out are nearly all of its
// bytes (14 MB in float32, 0.0043 ms). The first design (one lane a point,
// the columns in chunks of 8, 64-bit row offsets and cells, the row layout)
// took 0.052 ms there, 2.8x torch's grid_sample on the same work (NVIDIA
// H100 80GB HBM3, 700.00 W; scripts/tune_torch_interp.py): neighbouring
// lanes hold neighbouring EEPs, so in the row layout a warp's load of one
// column of one corner touches 32 sectors 60 bytes apart for 128 useful
// bytes; with 2 columns each corner still ran 8 predicated loads and 8
// rounded multiply-adds; every corner cost 3 64-bit multiplies and clamps.
// Measured by steps (the same script), the exact instances and 32-bit
// offsets bought little from the row layout (0.0519 to 0.0513 ms) and the
// planar layout most of the rest (0.0167 ms).
//
// The design against that:
// * The column-planar layout. A caller whose neighbouring points fall in
//   neighbouring cells (the cluster ladder) asks for it, and the wrapper
//   reads a copy of the wanted columns laid out (ncols, n0, ..., n_{ndim-1}),
//   built once per table and column tuple (ops/interp_cuda.py::
//   planar_columns): a warp's load of one column of one corner is then a run
//   of neighbouring values, 8-9 sectors at the ladder's EEP step. The kernel
//   does not know the layout: the wrapper describes a row by its stride
//   (row_len, or 1 in the planar layout) and a column by its element offset
//   within a row (its index, or c times the elements of a plane). Other
//   calls read the row layout.
// * Exact column instances. 1, 2, 3 and 4 columns (on grids of up to 4 axes)
//   are template instances: no load or multiply-add of an absent column;
//   wider calls and grids take chunks of kChunk columns, a chunk's loads of
//   two corners in flight together (the corner loop unrolled twice: at the
//   every-column call, 100,000 points and 15 columns, 0.0478 ms against
//   0.0688 rolled, 0.0517 four times and 0.0632 eight times).
// * 32-bit offsets wherever the table has fewer than 2^31 elements (a flag
//   the wrapper sets; the 64-bit instances stay for larger tables). A point
//   forms its common offset and each axis' step to the upper corner once (0
//   at a top knot, as the plain version's clamp), and a corner's offset is a
//   few 32-bit adds.
// * A lane-local cell search for the analytic axis kinds (exact_affine,
//   affine, log): interp_common.cuh's arithmetic and comparisons in 32-bit
//   cells, exact_affine's second step only where the first lands a cell off.
//   At the ladder's call the cell search is most of the time: alone (no
//   gathers) it took 0.0130 ms of B's 0.0167 ms. This is a second copy of
//   interp_common.cuh's search for those kinds, kept in step with it by
//   hand; the card tests hold both to the plain version on every kind.
// * Points in by one strided load a coordinate, values out by one store a
//   column, as the first design. Staging both through shared memory (a
//   block's 128 x ndim coordinates by 16-byte cp.async copies, the values
//   out 16 bytes a store after a barrier) was measured slower, 0.0190
//   against 0.0167 ms at the ladder's call and 0.0593 against 0.0513 ms from
//   the row layout.
// * Nothing here is for the tensor cores: there is no matrix product. TMA has
//   no tile to take either: the corners are gathers at addresses known only
//   after each point's cell search.
// Lanes past P take a NaN point and stay to the end, since the searchsorted
// and wide compare kinds vote across the warp. ndim is at most kMaxDim and
// the columns of one call at most kMaxCols (the wrapper raises past either).
// The argument struct is a __grid_constant__ parameter: axes and column
// offsets are read from the constant bank.
//
// scripts/tune_torch_interp.py times these steps; the variants it measured
// and the library does not keep (the staging, interp_common.cuh's cell
// search, the cell search alone, other unrolls) are built from its own copy,
// scripts/interp_nd_variants.cu.
//
// The float64 entry points are built from interp_nd_f64.cu, this file
// compiled with INTERP_F64_UNIT, so that both types build in parallel.

#include <type_traits>

#include "interp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDim = 6;
constexpr int kMaxCols = 128;
constexpr int kChunk = 8;
constexpr int kCornerUnroll = 2;  // the chunked instances' corner loop
constexpr int kExactCols = 4;    // exact column instances: 1 to kExactCols columns
constexpr int kExactMaxDim = 4;  // on grids of at most this many axes
constexpr long long kWideElements = 1LL << 31;
constexpr int kMaxGroup = 16;                // B': at most 16 lanes a point
constexpr long long kFillThreads = 1LL << 18;  // B': about one full card of threads

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
// searchsorted and compare kinds, which vote across the warp, take
// interp_common.cuh's functions.
template <typename T>
__device__ __forceinline__ void lane_reads(const Axis& ax, T x, AxisReads<T>& r) {
  const int n = static_cast<int>(ax.n);
  if (ax.kind == kSearch || ax.kind == kCompare || n < 2) {
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
  if (ax.kind == kSearch || ax.kind == kCompare || n < 2) {
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
  const long long p0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int cnt = a.P - p0 < kThreads ? static_cast<int>(a.P - p0) : kThreads;
  const int lane = threadIdx.x;
  const bool live = lane < cnt;
  const T* pts = static_cast<const T*>(a.points) + p0 * NDIM;
  T x[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) x[d] = live ? pts[lane * NDIM + d] : T(NAN);
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
    if (live && !bad) {
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
    if (live) {
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

// ---- B': the points' gradient
//
// What bounds it on the H100: as B, bytes at the card's rate where the batch
// is large, and at the NUTS chains' 4 to 8 points one point's chain of
// dependent steps (the cell search, then the corners' gathers). The first
// design ran one lane a point and, for every chunk of 8 columns, a one-lane
// VJP that located the cell again and read every corner twice (the values,
// then the products): 0.0072 / 0.0077 ms at 4 / 8 points of the seismic
// call (3 axes, nu_max and delta_nu), 0.0260 ms at 131072 (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W).
//
// The design against that:
// * A group of G lanes a point (grad_lanes): as many as the point has corners,
//   at most 16 (8 for 3 axes, 16 for 4), while P * G stays within
//   kFillThreads (about one full card of threads), halving to 1 at large
//   batches. The group locates the cell once for every chunk of columns
//   (interp_common.cuh::group_locate: the searchsorted kind and the wide
//   compare kind take the group's (G+1)-ary search), and shares the corners
//   of each chunk out over its lanes (group_vjp_corners: lane l takes
//   corners l, l + G, ...), the products summed by a group shuffle.
// * A NaN value passes no gradient: the plain version's autograd masks a
//   column any of whose corners is NaN. The corner pass notes the columns
//   with a cotangent that met a NaN corner; the group ORs the notes, and
//   only where one was met (a NaN-padded neighbour) takes the chunk's
//   products again without those columns. The values themselves are never
//   formed.
// * The row layout, as the first design (the planar copy is measured for B's
//   ladder call alone).
// * No atomics: a point's sums run in an order fixed by G, and each chunk's
//   slopes add up in chunk order; every lane of a group gets the sums and
//   lane d % G writes coordinate d.
// Lanes past P take a NaN point and stay to the end (the searches vote).
template <typename T, int NDIM, int G>
__global__ void __launch_bounds__(kThreads) interp_nd_grad_kernel(const __grid_constant__ InterpArgs a) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;  // the launch keeps P * G < 2^31
  if ((long long)((tid & ~31u) / G) >= a.P) return;           // the whole warp lies past the points
  const long long p = tid / G;
  const int l = (int)(tid % G);
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
  // the first chunk's cotangents are read beside the cell search's knots
  T g[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) g[c] = live && c < a.ncols ? gout[p * a.ncols + c] : T(0);
  GroupCell<T, NDIM> gc;
  group_locate<T, NDIM, G>(a.axes, x, l, gc);
  for (int c0 = 0; c0 < a.ncols; c0 += kChunk) {
    const int nc = a.ncols - c0 < kChunk ? a.ncols - c0 : kChunk;
    T gt[NDIM], slope[NDIM];
    if (c0 > 0) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) g[c] = live && c < nc ? gout[p * a.ncols + c0 + c] : T(0);
    }
    const unsigned nan_cols = group_or<G>(
        group_vjp_corners<T, NDIM, G, kChunk>(table, a.axes, gc, a.row_len, a.cols + c0, nc, l, g, gt));
    if (nan_cols != 0u) {  // the same for the whole group
#pragma unroll
      for (int c = 0; c < kChunk; ++c) g[c] = (nan_cols >> c) & 1u ? T(0) : g[c];
      group_vjp_corners<T, NDIM, G, kChunk>(table, a.axes, gc, a.row_len, a.cols + c0, nc, l, g, gt);
    }
    group_slopes<T, NDIM, G>(gc, gt, slope);
#pragma unroll
    for (int d = 0; d < NDIM; ++d) gx[d] = add_rn(gx[d], slope[d]);
  }
  if (!live) return;
  T* out = static_cast<T*>(a.out) + p * NDIM;
#pragma unroll
  for (int d = 0; d < NDIM; ++d)
    if (d % G == l) out[d] = gx[d];
}

template <typename T, int NDIM, int NC, bool WIDE>
cudaError_t launch_b(const InterpArgs& a, unsigned blocks, cudaStream_t st) {
  interp_nd_kernel<T, NDIM, NC, WIDE><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// B''s lanes a point for P points on NDIM axes: the rule is in its note
int grad_lanes(long long P, int ndim) {
  int g = ndim >= 4 ? kMaxGroup : 1 << ndim;
  while (g > 1 && P * g > kFillThreads) g >>= 1;
  return g;
}

template <typename T, int NDIM, int G>
cudaError_t launch_grad_g(const InterpArgs& a, cudaStream_t st) {
  const long long threads = a.P * G;
  if (threads >= (1LL << 31)) return cudaErrorInvalidValue;
  interp_nd_grad_kernel<T, NDIM, G><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int NDIM>
cudaError_t launch_grad(const InterpArgs& a, cudaStream_t st) {
  switch (grad_lanes(a.P, NDIM)) {
    case 16:
      if constexpr (NDIM >= 4) return launch_grad_g<T, NDIM, 16>(a, st);
      break;
    case 8:
      if constexpr (NDIM >= 3) return launch_grad_g<T, NDIM, 8>(a, st);
      break;
    case 4:
      if constexpr (NDIM >= 2) return launch_grad_g<T, NDIM, 4>(a, st);
      break;
    case 2: return launch_grad_g<T, NDIM, 2>(a, st);
    default: return launch_grad_g<T, NDIM, 1>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool GRAD, int NDIM>
cudaError_t launch_nd(const InterpArgs& a, unsigned blocks, cudaStream_t st) {
  if constexpr (GRAD) {
    return launch_grad<T, NDIM>(a, st);
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

#ifdef INTERP_F64_UNIT

int interp_nd_f64(const void* args, void* stream) {
  return launch<double, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f64(const void* args, void* stream) {
  return launch<double, true>(static_cast<const InterpArgs*>(args), stream);
}

#else

int interp_nd_args_size() { return (int)sizeof(InterpArgs); }

int interp_nd_max_dim() { return kMaxDim; }

int interp_nd_max_cols() { return kMaxCols; }

// the column instances: exact ones up to this many columns, on grids of up to
// interp_nd_exact_max_dim() axes; chunks of interp_nd_chunk() otherwise
int interp_nd_exact_cols() { return kExactCols; }

int interp_nd_exact_max_dim() { return kExactMaxDim; }

int interp_nd_chunk() { return kChunk; }

// the lanes a point that B' gives P points on ndim axes
int interp_nd_grad_lanes(long long P, int ndim) { return grad_lanes(P, ndim); }

const char* interp_nd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int interp_nd_f32(const void* args, void* stream) {
  return launch<float, false>(static_cast<const InterpArgs*>(args), stream);
}

int interp_nd_grad_f32(const void* args, void* stream) {
  return launch<float, true>(static_cast<const InterpArgs*>(args), stream);
}

#endif

}  // extern "C"
