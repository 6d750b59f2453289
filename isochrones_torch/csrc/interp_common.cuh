// Grid interpolation shared by the kernels (star_lnlike.cu, tree_lnlike.cu,
// catalog_lnlike.cu, generate.cu, interp_nd.cu): the axis description, cell location, the
// multilinear lerp of a group of lanes (or of one lane, with 16-byte row
// loads), the lerp's slope along one axis and the vector-Jacobian product
// of a group of lanes along every axis (the backward kernels), with the
// semantics of the plain version
// (isochrones_torch/ops/interp.py): find_cells_1d's cell step for step (the
// exact_affine fix-up, the two-step fix-up of the affine and log kinds,
// _pin_top, searchsorted's count of knots below x, the compare kind's count),
// with explicitly rounded products and sums so that nvcc's FMA contraction
// cannot move a point into another cell; every corner's product enters the
// sum, weight 0 included, so a NaN-padded neighbour poisons the result as
// IEEE 0 * NaN does in torch; a NaN or out-of-bounds coordinate on any axis
// makes the row NaN.
//
// Everything sits in an unnamed namespace on purpose: each .cu that includes
// this file gets its own internal copy, next to its own kernel code.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// axis-map kinds of ops/interp.py::compute_axis_maps (None = searchsorted)
enum AxisKind : int { kSearch = 0, kExactAffine = 1, kAffine = 2, kLog = 3, kCompare = 4 };

struct Axis {
  const void* knots;  // device pointer to n knots of the grid's dtype
  long long n;
  double lo0;
  double step;
  int kind;
  int pad;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log10(float x) { return log10f(x); }
__device__ __forceinline__ double d_log10(double x) { return log10(x); }
__device__ __forceinline__ float d_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double d_pow(double a, double b) { return pow(a, b); }

template <typename T>
__device__ __forceinline__ T knot(const Axis& ax, long long i) {
  return __ldg(static_cast<const T*>(ax.knots) + i);
}

// sum over the G lanes of this lane's group (groups are aligned runs of G
// lanes); every lane of the warp must call it
template <int G, typename V>
__device__ __forceinline__ V group_sum(V v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// torch: where(den == 0, 1, den)
template <typename T>
__device__ __forceinline__ T safe_den(T den) {
  return den == T(0) ? T(1) : den;
}

// torch: num / where(den == 0, 1, den)
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return div_rn(num, safe_den(den));
}

template <typename T>
__device__ __forceinline__ long long floor_to_cell(T raw, long long n) {
  // floor(raw) clamped to [0, n - 2]; raw is finite for in-bounds x
  T f = floor(raw);
  if (!(f >= T(0))) return 0;
  if (f > T(n - 2)) return n - 2;
  return static_cast<long long>(f);
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// What the cell location of one coordinate reads before it decides
// anything, so that the reads of every axis of a point are in flight
// together: the end knots (bounds, _pin_top) and, for the affine and log
// kinds, the knots c0 and c0 + 1 of the analytic guess c0 (the fix-ups
// rarely move off it), or for the compare kind this lane's first 4 of its
// share of the knots.
template <typename T>
struct AxisReads {
  T first, last;
  T kn[4];
  long long c0;
};

template <typename T, int G>
__device__ __forceinline__ void locate_reads(const Axis& ax, T x, int l, AxisReads<T>& r) {
  const long long n = ax.n;
  r.first = knot<T>(ax, 0);
  r.last = knot<T>(ax, n - 1);
  r.c0 = 0;
  if ((ax.kind == kAffine || ax.kind == kLog) && n > 1) {
    const T lo0 = T(ax.lo0), step = T(ax.step);
    const T xs = ax.kind == kLog ? d_log(x > T(0) ? x : T(0)) : x;
    r.c0 = floor_to_cell<T>(div_rn(sub_rn(xs, lo0), step), n);
    r.kn[0] = knot<T>(ax, r.c0);
    r.kn[1] = knot<T>(ax, r.c0 + 1);
  } else if (ax.kind == kCompare && n > 1 && n <= 4 * G) {
#pragma unroll
    for (int u = 0; u < 4; ++u) r.kn[u] = l + u * G < n ? knot<T>(ax, l + u * G) : T(0);
  }
}

// The number of knots below x (searchsorted side "left"), or at or below x
// with `right` (side "right"), by a (G+1)-ary search of the group: the
// answer lies in [lo, hi]; lane l probes p_l = lo + (l + 1) span / (G + 1),
// and the c probes that count (a prefix, the knots being sorted) move lo
// past p_(c-1) and hi to p_c. Every lane of the warp calls it.
template <typename T, int G>
__device__ long long group_count(const Axis& ax, T x, bool skip, int l, bool right) {
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  long long lo = 0, hi = skip ? 0 : ax.n;
  while (__any_sync(kFull, lo < hi)) {
    const long long span = hi - lo;
    const bool live = lo < hi;
    bool below = false;
    if (live) {
      const T k = knot<T>(ax, lo + ((l + 1) * span) / (G + 1));
      below = right ? k <= x : k < x;
    }
    const unsigned votes = __ballot_sync(kFull, below) >> gbase;
    const int c = __popc(votes & ((1u << G) - 1u));
    if (live) {
      const long long p_c = lo + ((c + 1) * span) / (G + 1);
      if (c > 0) lo = lo + (c * span) / (G + 1) + 1;
      if (c < G) hi = p_c;
    }
  }
  return lo;
}

// one of four registers by a runtime index, without local memory
template <typename T>
__device__ __forceinline__ T pick4(const T* v, long long u) {
  return u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
}

// ops/interp.py::find_cells_1d for one in-bounds, non-NaN x, from the reads
// of locate_reads, by the G lanes of a group together: the lower cell index
// (may be n - 1 at the top knot) and the in-cell coordinate t; with `den`,
// also the denominator of t, so that dt/dx = 1 / den (0 where t is a
// constant: see lerp_slope). Lanes with `skip` (a NaN or out-of-bounds point)
// read no further knots; every lane of the warp calls it (the searches vote
// and shuffle).
template <typename T, int G>
__device__ void locate_finish(const Axis& ax, T x, bool skip, int l, const AxisReads<T>& r, long long& cell,
                              T& t, T* den = nullptr) {
  const long long n = ax.n;
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  if (ax.kind != kSearch && n > 1) {
    if (ax.kind == kExactAffine) {
      const T lo0 = T(ax.lo0), step = T(ax.step);
      long long c = floor_to_cell<T>(div_rn(sub_rn(x, lo0), step), n);
      T lo = add_rn(lo0, mul_rn(T(c), step));
      T tt = div_rn(sub_rn(x, lo), step);
      // division rounding may land one cell off near a knot
      const long long shift = (tt >= T(1) ? 1 : 0) - (tt < T(0) ? 1 : 0);
      c = clampll(c + shift, 0, n - 2);
      lo = add_rn(lo0, mul_rn(T(c), step));
      tt = div_rn(sub_rn(x, lo), step);
      cell = c;
      t = tt;
      if (den) *den = step;
    } else if (ax.kind == kCompare) {
      // the count of knots <= x: the knots increase, so it is also an
      // upper-bound search, which wide axes (more than 4 knots a lane) take
      long long c;
      T lo, hi;
      if (n <= 4 * G) {  // one read per knot, all made by locate_reads
        int cnt = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) cnt += (!skip && l + u * G < n && x >= r.kn[u]) ? 1 : 0;
        c = clampll(group_sum<G>(cnt) - 1, 0, n - 2);
        // knot i is lane (i % G)'s kn[i / G]
        lo = __shfl_sync(kFull, pick4(r.kn, c / G), gbase + (int)(c % G));
        hi = __shfl_sync(kFull, pick4(r.kn, (c + 1) / G), gbase + (int)((c + 1) % G));
      } else {
        c = clampll(group_count<T, G>(ax, x, skip, l, true) - 1, 0, n - 2);
        lo = knot<T>(ax, c);
        hi = knot<T>(ax, c + 1);
      }
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(hi, lo));
      if (den) *den = safe_den(sub_rn(hi, lo));
    } else {  // kAffine, kLog: knots c0 and c0 + 1 are read, others on demand
      auto kat = [&](long long i) { return i == r.c0 ? r.kn[0] : i == r.c0 + 1 ? r.kn[1] : knot<T>(ax, i); };
      long long c = r.c0;
      // two-step fix-up against the true knots absorbs rounding in raw
      if (x < kat(c)) c -= 1;
      c = clampll(c, 0, n - 2);
      if (x >= kat(clampll(c + 1, 0, n - 1))) c += 1;
      c = clampll(c, 0, n - 2);
      const T lo = kat(c);
      cell = c;
      t = safe_div(sub_rn(x, lo), sub_rn(kat(c + 1), lo));
      if (den) *den = safe_den(sub_rn(kat(c + 1), lo));
    }
    if (x == r.last) {  // _pin_top
      cell = n - 1;
      t = T(0);
      if (den) *den = T(0);
    }
    return;
  }
  // searchsorted(side="left"): the number of knots below x
  const long long i_ins = group_count<T, G>(ax, x, skip, l, false);
  const long long i_safe = clampll(i_ins, 0, n - 1);
  const bool eq = knot<T>(ax, i_safe) == x;
  const long long c = eq ? i_safe : i_ins - 1;
  const long long c_safe = n > 1 ? clampll(c, 0, n - 2) : 0;
  const T lo_k = knot<T>(ax, c_safe);
  const T hi_k = knot<T>(ax, clampll(c_safe + 1, 0, n - 1));
  cell = eq ? c : c_safe;
  t = eq ? T(0) : safe_div(sub_rn(x, lo_k), sub_rn(hi_k, lo_k));
  if (den) *den = eq ? T(0) : safe_den(sub_rn(hi_k, lo_k));
}

// The slope along one axis of a lerp located by locate_finish, in the closed
// form torch.autograd takes through ops/interp.py::find_cells_1d and
// interp_nd: `diff` is the sum over the other axes' corners of their weight
// times (upper - lower corner value); dt/dx is 1 / den (1 / step for the
// exact_affine kind, 1 / (hi - lo) through _safe_div for the others), and 0
// where t is replaced by a constant (an exact knot on the searchsorted path,
// _pin_top), whatever diff is. A NaN-padded corner gives a NaN diff, as its
// 0 * NaN gives a NaN value (ops/eep.py::newton_slope is the plain version).
template <typename T>
__device__ __forceinline__ T lerp_slope(T diff, T den) {
  return den == T(0) ? T(0) : div_rn(diff, den);
}

// VEC neighbouring values of a row in one load: two floats (8 bytes), four
// floats or two doubles (16 bytes)
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

__device__ __forceinline__ void add_scaled(float* o, float2 v, float w) {
  o[0] += w * v.x;
  o[1] += w * v.y;
}
__device__ __forceinline__ void add_scaled(float* o, float4 v, float w) {
  o[0] += w * v.x;
  o[1] += w * v.y;
  o[2] += w * v.z;
  o[3] += w * v.w;
}
__device__ __forceinline__ void add_scaled(double* o, double2 v, double w) {
  o[0] += w * v.x;
  o[1] += w * v.y;
}

// A point's cell on NDIM axes as the G lanes of a group locate it
// (locate_reads on every axis, then locate_finish): each axis' lower cell,
// in-cell t and the denominator of t (dt/dx = 1 / den, 0 where t is a
// constant), the row strides of the table's axes, and whether the point is
// NaN or out of bounds on any axis (every lane of the group gets the same).
// Every lane of the warp calls it (the searches vote and shuffle).
template <typename T, int NDIM>
struct GroupCell {
  long long cell[NDIM];
  long long stride[NDIM];
  T t[NDIM];
  T den[NDIM];
  bool bad;
};

template <typename T, int NDIM, int G>
__device__ __forceinline__ void group_locate(const Axis* axes, const T* x, int l, GroupCell<T, NDIM>& gc) {
  AxisReads<T> reads[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d) locate_reads<T, G>(axes[d], x[d], l, reads[d]);
  gc.bad = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) gc.bad = gc.bad || isnan(x[d]) || x[d] < reads[d].first || x[d] > reads[d].last;
#pragma unroll
  for (int d = 0; d < NDIM; ++d)
    locate_finish<T, G>(axes[d], x[d], gc.bad, l, reads[d], gc.cell[d], gc.t[d], &gc.den[d]);
  gc.stride[NDIM - 1] = 1;
#pragma unroll
  for (int d = NDIM - 2; d >= 0; --d) gc.stride[d] = gc.stride[d + 1] * axes[d + 1].n;
}

// Multilinear interpolation of `ncols` (<= NC) columns (cols[i], or i when
// cols is null) of a dense (dims..., row_len) table at a cell that
// group_locate located, by the G lanes of a group, into out[0, ncols); NaN
// when the point is NaN or out of bounds on any axis. Every lane of the group
// gets the sums of all 2**NDIM corners' products. With VEC (2, or 16 bytes'
// worth: 4 floats, 2 doubles) the caller vouches that the columns to lerp are
// the first ncols of each row (cols null; ncols, NC and row_len multiples of
// VEC; the table aligned to VEC values): a row is then read VEC columns per
// load, fewer gathers of a lane for the same products in the same order. With
// VEC 0 one column a load. Every lane of the warp calls it (the sums
// shuffle).
template <typename T, int NDIM, int G, int NC, int VEC = 0>
__device__ __forceinline__ void interp_group_at(const T* __restrict__ table, const Axis* axes,
                                                const GroupCell<T, NDIM>& gc, int row_len, const int* cols, int ncols,
                                                int l, T* out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == ncols) break;
    out[c] = T(0);
  }
  auto corner = [&](int i) {
    T w = T(1);
    long long row = 0;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const int o = (i >> (NDIM - 1 - d)) & 1;
      w = w * (o ? gc.t[d] : T(1) - gc.t[d]);
      row += clampll(gc.cell[d] + o, 0, axes[d].n - 1) * gc.stride[d];
    }
    const T* r = table + row * row_len;
    if constexpr (VEC > 0) {
      static_assert(NC % VEC == 0, "whole vectors");
      const typename Vec<T, VEC>::type* rv = reinterpret_cast<const typename Vec<T, VEC>::type*>(r);
#pragma unroll
      for (int c = 0; c < NC / VEC; ++c) {
        if (c * VEC >= ncols) break;
        add_scaled(out + c * VEC, __ldg(rv + c), w);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c == ncols) break;
        out[c] += w * __ldg(r + (cols ? cols[c] : c));
      }
    }
  };
  if (!gc.bad) {
    if constexpr (G == 1) {
#pragma unroll
      for (int i = 0; i < (1 << NDIM); ++i) corner(i);  // one lane: every corner's loads in flight together
    } else {
      for (int i = l; i < (1 << NDIM); i += G) corner(i);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == ncols) break;
    const T sum = group_sum<G>(out[c]);  // every lane shuffles, bad or not
    out[c] = gc.bad ? T(NAN) : sum;
  }
}

// interp_group_at at the point x, which the group locates first
// (group_locate); every lane of the warp calls it (the cell searches vote).
template <typename T, int NDIM, int G, int NC, int VEC = 0>
__device__ void interp_group(const T* __restrict__ table, const Axis* axes, const T* x, int row_len,
                             const int* cols, int ncols, int l, T* out) {
  GroupCell<T, NDIM> gc;
  group_locate<T, NDIM, G>(axes, x, l, gc);
  interp_group_at<T, NDIM, G, NC, VEC>(table, axes, gc, row_len, cols, ncols, l, out);
}

// v[i] += x for the i that equals the runtime index k (no local memory)
template <typename T, int N>
__device__ __forceinline__ void add_at(T* v, int k, T x) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i == k) v[i] += x;
}

// bitwise OR over the G lanes of this lane's group (each lane gets the
// OR); every lane of the warp must call it
template <int G>
__device__ __forceinline__ unsigned group_or(unsigned v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v |= __shfl_xor_sync(kFull, v, off);
  return v;
}

// This lane's share of the vector-Jacobian product of a multilinear lerp at a
// located cell, with the corners shared out as interp_group's (lane l takes
// corners l, l + G, ...; VEC as there): gt[d] = the sum over its corners i of
// s_i * d w_i / d t_d, where s_i = the sum over the columns c with g[c] != 0
// of g[c] times the corner's value, and d w_i / d t_d is the product of the
// other axes' factors with the sign of the corner's side. Nothing is read at
// a bad point or where every g[c] is 0. Returns the bits (1 << c) of the
// columns with g[c] != 0 of which one of this lane's corners holds a NaN
// (callers that know the values already ignore it). No shuffle or vote.
template <typename T, int NDIM, int G, int NC, int VEC = 0>
__device__ __forceinline__ unsigned group_vjp_corners(const T* __restrict__ table, const Axis* axes,
                                                      const GroupCell<T, NDIM>& gc, int row_len, const int* cols,
                                                      int ncols, int l, const T* g, T* gt) {
  static_assert(NC <= 32, "one bit a column");
  bool any = false;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c == ncols) break;
    any = any || g[c] != T(0);
  }
#pragma unroll
  for (int d = 0; d < NDIM; ++d) gt[d] = T(0);
  unsigned nan_cols = 0u;
  auto corner = [&](int i) {
    long long r = 0;
#pragma unroll
    for (int d = 0; d < NDIM; ++d)
      r += clampll(gc.cell[d] + ((i >> (NDIM - 1 - d)) & 1), 0, axes[d].n - 1) * gc.stride[d];
    const T* row = table + r * row_len;
    T s = T(0);
    if constexpr (VEC > 0) {
      static_assert(NC % VEC == 0 && VEC == 2, "whole pairs");
      const typename Vec<T, VEC>::type* rv = reinterpret_cast<const typename Vec<T, VEC>::type*>(row);
#pragma unroll
      for (int c = 0; c < NC / VEC; ++c) {
        if (c * VEC >= ncols) break;
        const typename Vec<T, VEC>::type w = __ldg(rv + c);
        if (g[2 * c] != T(0)) {
          s += g[2 * c] * w.x;
          nan_cols |= isnan(w.x) ? 1u << (2 * c) : 0u;
        }
        if (g[2 * c + 1] != T(0)) {
          s += g[2 * c + 1] * w.y;
          nan_cols |= isnan(w.y) ? 1u << (2 * c + 1) : 0u;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c == ncols) break;
        if (g[c] != T(0)) {
          const T v = __ldg(row + (cols ? cols[c] : c));
          s += g[c] * v;
          nan_cols |= isnan(v) ? 1u << c : 0u;
        }
      }
    }
    // d w_i / d t_d: the product of the other axes' factors, with the sign of the corner's side
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      T w = T(1);
#pragma unroll
      for (int e = 0; e < NDIM; ++e) {
        if (e == d) continue;
        w = w * (((i >> (NDIM - 1 - e)) & 1) ? gc.t[e] : T(1) - gc.t[e]);
      }
      const T sw = s * w;
      gt[d] += ((i >> (NDIM - 1 - d)) & 1) ? sw : -sw;
    }
  };
  if (!gc.bad && any) {
    if constexpr (G == 1 && NDIM <= 4) {
#pragma unroll
      for (int i = 0; i < (1 << NDIM); ++i) corner(i);
    } else {  // past 16 corners a lane, unrolling them all spills
      for (int i = l; i < (1 << NDIM); i += G) corner(i);
    }
  }
  return nan_cols;
}

// The group's slopes from its lanes' shares gt (group_vjp_corners): gx[d] =
// lerp_slope of the group's sum, 0 at a bad point. Every lane of the warp
// calls it, and every lane of the group gets the sums.
template <typename T, int NDIM, int G>
__device__ __forceinline__ void group_slopes(const GroupCell<T, NDIM>& gc, const T* gt, T* gx) {
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    const T sum = group_sum<G>(gt[d]);  // every lane shuffles, bad or not
    gx[d] = gc.bad ? T(0) : lerp_slope(sum, gc.den[d]);
  }
}

// The vector-Jacobian product of a multilinear lerp by the G lanes of a
// group, in the closed form torch.autograd takes through ops/interp.py's
// gradient-safe path: gx[d] = the sum over the columns c with g[c] != 0 of
// g[c] * d out[c] / d x[d] (group_locate, group_vjp_corners, group_slopes).
// The caller, which holds the values from its forward pass, zeroes g[c]
// where out[c] is NaN, so the corners are read for the products alone. A NaN
// or out-of-bounds point gets 0. Every lane of the warp calls it (the cell
// searches vote, the sums shuffle), and every lane of the group gets the
// sums.
template <typename T, int NDIM, int G, int NC, int VEC = 0>
__device__ void group_vjp(const T* __restrict__ table, const Axis* axes, const T* x, int row_len, const int* cols,
                          int ncols, int l, const T* g, T* gx) {
  GroupCell<T, NDIM> gc;
  group_locate<T, NDIM, G>(axes, x, l, gc);
  T gt[NDIM];
  group_vjp_corners<T, NDIM, G, NC, VEC>(table, axes, gc, row_len, cols, ncols, l, g, gt);
  group_slopes<T, NDIM, G>(gc, gt, gx);
}

// reference likelihood.py:10-13, with its +log(unc) constant
template <typename T>
__device__ __forceinline__ T gauss_lnprob(T val, T unc, T model_val) {
  const T resid = val - model_val;
  return T(-0.91893853320467274178) + d_log(unc) - T(0.5) * resid * resid / (unc * unc);
}

}  // namespace
