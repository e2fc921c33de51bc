// Hopper kernel for te_map's conservative vertical PPM remap.
//
// Replaces the Pallas TPU kernel _te_map_kernel (te_map_remap_pallas,
// cam_nor_physics_tpu/ops/remap_pallas.py): PPM edges with the kord limiter,
// then the cumulative mass of the piecewise-parabolic reconstruction at each
// target interface, for the center fields (pt, tracers) on pe_s -> pe_t and
// for u / v on their own staggered interface sets.
//
// Design. One thread per (column, field), one launch for all fields: the
// grid's x runs over blocks of columns and its y over the nf center fields,
// then u, then v. Neighbouring threads take neighbouring columns of the
// (k, ncol) layout, so every load and store is coalesced. A thread walks its
// column once, top to bottom, with a sliding window in registers: q and
// the interfaces at k..k+2, the limited slopes of k and k+1 and the edge
// above k, with q and the interface at k+3 loaded one cell ahead. It keeps the
// in-order sum P of the whole-cell masses above the current cell, the
// column total of q dp, and a pointer kt to the next target interface. At
// cell k it evaluates the clip fraction s of target kt in that cell (the
// plain version's expression): while s < 1 the target lies in the cell, and
// its cumulative mass is P plus the partial-cell term; once s = 1 the cell
// is added to P and the walk moves down. That is O(km + km_t) work a
// column and field, with no search and no per-thread arrays.
//
// Exactness. The plain version (ops/remap_kernels.py::_remap_set_ref) sums
// the clip integral over all km cells in index order. With monotone
// interfaces and monotone rounding, every cell wholly above a target gets
// s = 1 exactly and every cell wholly below it s = 0, whose term is a zero:
// the plain fold c_0 + ... + c_j + 0 + ... equals P_j + c_j bit for bit, a
// zero-thickness layer (dp = 0, divided by 1e-30) and a target on a source
// interface included. That argument needs finite terms and monotone
// interfaces; the walk checks both as it goes (a whole-cell mass that is
// not finite, a source layer of negative thickness, a target that is not
// finite or lies above the one before it) and writes a column it flags
// again with the plain version's sums, term by term (remap_exact: O(km
// km_t)). A NaN or inf in a column makes some cell's terms NaN, and with
// them every target's sum, in the plain version and in remap_exact alike
// (0 * inf below a target, as in JAX's _remap_set); crossed interfaces
// give the plain version's sums. So the kernel is bitwise equal to the
// plain version, NaN where it has NaN; a finite, monotone column pays only
// the checks.
//
// Bound. A call reads the 6 interface sets ((km+1) x ncol) and the nf+2
// fields once and writes nf+2 fields once: at f19 (13,824 columns, km = 26,
// nf = 2) about 20 MB in float32, 6 us at 3.35 TB/s. Its arithmetic (PPM
// edges and limiter, ~40 operations a source cell; ~11 a target interface;
// the walk's km + km_t comparisons) is under 1e8 operations, so the bytes
// bound it. The walk's loads are a chain of km steps a thread; with
// ncol (nf+2) threads (55,296 at f19) their latency, not the bytes, is what
// holds it above the bound at the smallest grid.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// limited slope of an interior cell from its neighbours (zero in the end
// cells, which the caller sets)
template <typename T>
__device__ __forceinline__ T slope(T qm, T q0, T qp) {
  const T dqc = T(0.5) * ((qp - q0) + (q0 - qm));
  const T qmax = tmax(tmax(qm, q0), qp) - q0;
  const T qmin = q0 - tmin(tmin(qm, q0), qp);
  return sgn(dqc) * tmin(tmin(fabs(dqc), qmax), qmin);
}

// the PPM edge between cells a (above) and b (below)
template <typename T>
__device__ __forceinline__ T edge(T qa, T qb, T dpa, T dpb, T dma, T dmb) {
  return qa + dpa / (dpa + dpb) * (qb - qa) + (dma - dmb) * T(1.0 / 3.0);
}

// mass of the top fraction s of a cell with thickness dp and parabola
// coefficients (al, half, third)
template <typename T>
__device__ __forceinline__ T part(T dp, T s, T al, T half, T third) {
  return dp * (s * (al + s * (half - third * s)));
}

// the fraction of a cell (top p, thickness dps, 1e-30 for 0) above the
// interface x, clipped to [0, 1] (NaN stays NaN, as in torch.clamp)
template <typename T>
__device__ __forceinline__ T clip(T x, T p, T dps) {
  const T s = (x - p) / dps;
  return s < T(0) ? T(0) : (s > T(1) ? T(1) : s);
}

// The PPM parabolas of one field's column, cell by cell from the top: q
// (km values) on the interfaces ps (km + 1), both at stride n. A window in
// registers: q_0..q_2 = q[k..k+2], p_0..p_2 = ps[k..k+2], dp_0 and dp_1
// the thicknesses of k and k+1, dm_0 and dm_1 their limited slopes, e_top
// the unlimited edge above k (the edge below k-1); q_3 and p_3, the cell
// and interface three below, are loaded one step ahead of their use.
template <typename T>
struct Column {
  const T* __restrict__ ps;
  const T* __restrict__ q;
  size_t n;
  int km, kord;
  T q_0, q_1, q_2, q_3, p_0, p_1, p_2, p_3, dp_0, dp_1, dm_0, dm_1, e_top;
  T a_l, half, third;          // cell k's parabola, after parabola(k)

  __device__ Column(const T* ps_, const T* q_, int km_, size_t n_, int kord_)
      : ps(ps_), q(q_), n(n_), km(km_), kord(kord_) {
    q_0 = q[0];
    q_1 = km > 1 ? q[n] : T(0);
    q_2 = km > 2 ? q[2 * n] : T(0);
    p_0 = ps[0];
    p_1 = ps[n];
    p_2 = km > 1 ? ps[2 * n] : T(0);
    dp_0 = p_1 - p_0;
    dp_1 = km > 1 ? p_2 - p_1 : T(0);
    dm_0 = T(0);
    dm_1 = 1 < km - 1 ? slope(q_0, q_1, q_2) : T(0);
    e_top = q_0;
  }

  __device__ void load_ahead(int k) {
    q_3 = k + 3 < km ? q[(size_t)(k + 3) * n] : T(0);
    p_3 = k + 3 <= km ? ps[(size_t)(k + 3) * n] : T(0);
  }

  // edges, limiter and parabola coefficients of cell k
  __device__ void parabola(int k) {
    T a_r, a6;
    T e_bot = q_0;
    if (kord <= 2) {
      a_l = q_0 - dm_0;
      a_r = q_0 + dm_0;
      a6 = T(0);
    } else {
      if (k < km - 1) e_bot = edge(q_0, q_1, dp_0, dp_1, dm_0, dm_1);
      a_l = e_top;
      a_r = e_bot;
      a6 = T(3.0) * (q_0 + q_0 - (a_l + a_r));
      if (kord == 3) {            // lmppm lmt = 0
        const T da1 = a_r - a_l;
        const T da2 = da1 * da1;
        const T a6da = a6 * da1;
        const bool lo = a6da < -da2, hi = a6da > da2, zero = dm_0 == T(0);
        const T a6_lo = T(3.0) * (a_l - q_0), ar_lo = a_l - a6_lo;
        const T a6_hi = T(3.0) * (a_r - q_0), al_hi = a_r - a6_hi;
        const T a6n = zero ? T(0) : (lo ? a6_lo : (hi ? a6_hi : a6));
        const T arn = zero ? q_0 : (lo ? ar_lo : a_r);
        const T aln = zero ? q_0 : (hi ? al_hi : a_l);
        a6 = a6n;
        a_r = arn;
        a_l = aln;
      } else {                    // lmppm lmt >= 1
        const T da1 = dm_0 + dm_0;
        const T dl = sgn(da1) * tmin(fabs(da1), fabs(a_l - q_0));
        const T dr = sgn(da1) * tmin(fabs(da1), fabs(a_r - q_0));
        a_r = q_0 + dr;
        a_l = q_0 - dl;
        a6 = T(3.0) * (dl - dr);
      }
    }
    e_top = e_bot;
    half = T(0.5) * ((a_r - a_l) + a6);
    third = a6 * T(1.0 / 3.0);
  }

  // slide the window one cell down
  __device__ void slide(int k) {
    q_0 = q_1;
    q_1 = q_2;
    q_2 = q_3;
    p_0 = p_1;
    p_1 = p_2;
    p_2 = p_3;
    dp_0 = dp_1;
    dp_1 = k + 2 < km ? p_2 - p_1 : T(0);
    dm_0 = dm_1;
    dm_1 = k + 2 < km - 1 ? slope(q_0, q_1, q_2) : T(0);
  }
};

// The plain version's answer for one column, term by term: each interior
// target's mass the in-order sum of the clip integral over all km cells,
// O(km * km_t). Taken only by a column the walk flags; not inlined, so
// that the walk keeps its registers.
template <typename T>
__device__ __attribute__((noinline)) void remap_exact(const T* __restrict__ ps, const T* __restrict__ pt,
                            const T* __restrict__ q, T* __restrict__ out,
                            int km, int km_t, size_t n, int kord, T total) {
  T m_prev = T(0);
  T x_prev = pt[0];
  for (int kt = 1; kt < km_t; ++kt) {
    const T x = pt[(size_t)kt * n];
    Column<T> c(ps, q, km, n, kord);
    T m = T(0);
    for (int k = 0; k < km; ++k) {
      c.load_ahead(k);
      c.parabola(k);
      const T dps = c.dp_0 == T(0) ? T(1e-30) : c.dp_0;
      const T term = part(c.dp_0, clip(x, c.p_0, dps), c.a_l, c.half,
                          c.third);
      m = k == 0 ? term : m + term;
      c.slide(k);
    }
    out[(size_t)(kt - 1) * n] = (m - m_prev) / (x - x_prev);
    m_prev = m;
    x_prev = x;
  }
  out[(size_t)(km_t - 1) * n] =
      (total - m_prev) / (pt[(size_t)km_t * n] - x_prev);
}

// Remap one field of one column: q (km values at stride ncol) from source
// interfaces ps to target interfaces pt (km + 1 and km_t + 1 values at
// stride ncol), in one walk down the column. A column where the walk meets
// a non-finite cell mass or target, a source layer of negative thickness
// or a target above the one before it is written again by remap_exact.
template <typename T>
__device__ void remap_walk(const T* __restrict__ ps, const T* __restrict__ pt,
                           const T* __restrict__ q, T* __restrict__ out,
                           int km, int km_t, int ncol, int kord) {
  const size_t n = (size_t)ncol;
  Column<T> c(ps, q, km, n, kord);
  T P = T(0), total = T(0), m_prev = T(0);
  int kt = 1;                    // next target interface
  T x_prev = pt[0];
  T x = pt[(size_t)kt * n];
  bool flag = !isfinite(x_prev) || !isfinite(x) || !(x >= x_prev);
  for (int k = 0; k < km; ++k) {
    c.load_ahead(k);
    total = total + c.q_0 * c.dp_0;
    c.parabola(k);
    const T whole = part(c.dp_0, T(1), c.a_l, c.half, c.third);
    flag = flag || !isfinite(whole) || c.dp_0 < T(0);
    if (kt < km_t) {
      const T dps = c.dp_0 == T(0) ? T(1e-30) : c.dp_0;
      // the targets inside cell k, then the cell itself into P
      for (;;) {
        const T s = clip(x, c.p_0, dps);
        if (!(s < T(1))) {
          P = P + whole;
          break;
        }
        const T m = P + part(c.dp_0, s, c.a_l, c.half, c.third);
        out[(size_t)(kt - 1) * n] = (m - m_prev) / (x - x_prev);
        m_prev = m;
        x_prev = x;
        ++kt;
        x = pt[(size_t)kt * n];
        flag = flag || !isfinite(x) || !(x >= x_prev);
        if (kt == km_t) break;
      }
    }
    c.slide(k);
  }
  // targets below the last source interface take the whole column; the
  // bottom interface the column's total
  for (; kt < km_t; ++kt) {
    out[(size_t)(kt - 1) * n] = (P - m_prev) / (x - x_prev);
    m_prev = P;
    x_prev = x;
    x = pt[(size_t)(kt + 1) * n];
    flag = flag || !isfinite(x) || !(x >= x_prev);
  }
  out[(size_t)(km_t - 1) * n] = (total - m_prev) / (x - x_prev);
  if (flag) remap_exact(ps, pt, q, out, km, km_t, n, kord, total);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
te_map_kernel(const T* __restrict__ pe_s, const T* __restrict__ pe_t,
              const T* __restrict__ pe_su, const T* __restrict__ pe_tu,
              const T* __restrict__ pe_sv, const T* __restrict__ pe_tv,
              const T* __restrict__ cen, const T* __restrict__ u,
              const T* __restrict__ v, int nf, int km, int km_t, int ncol,
              int kord, T* __restrict__ cen_out, T* __restrict__ u_out,
              T* __restrict__ v_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const int f = blockIdx.y;
  const T *ps = pe_s, *pt = pe_t, *q;
  T* out;
  if (f < nf) {
    q = cen + (size_t)f * km * ncol;
    out = cen_out + (size_t)f * km_t * ncol;
  } else if (f == nf) {
    ps = pe_su;
    pt = pe_tu;
    q = u;
    out = u_out;
  } else {
    ps = pe_sv;
    pt = pe_tv;
    q = v;
    out = v_out;
  }
  remap_walk(ps + col, pt + col, q + col, out + col, km, km_t, ncol, kord);
}

template <typename T>
int launch_te_map(const T* pe_s, const T* pe_t, const T* pe_su,
                  const T* pe_tu, const T* pe_sv, const T* pe_tv, const T* cen,
                  const T* u, const T* v, int nf, int km, int km_t, int ncol,
                  int kord, T* cen_out, T* u_out, T* v_out, void* stream) {
  const dim3 blocks((ncol + kThreads - 1) / kThreads, nf + 2);
  te_map_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u, v, nf, km, km_t, ncol,
      kord, cen_out, u_out, v_out);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_REMAP_ENTRY(SUF, T)                                               \
  extern "C" int cam_te_map_remap_##SUF(                                      \
      const T* pe_s, const T* pe_t, const T* pe_su, const T* pe_tu,           \
      const T* pe_sv, const T* pe_tv, const T* cen, const T* u, const T* v,   \
      int nf, int km, int km_t, int ncol, int kord, T* cen_out, T* u_out,     \
      T* v_out, void* stream) {                                               \
    return launch_te_map<T>(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u,   \
                            v, nf, km, km_t, ncol, kord, cen_out, u_out,      \
                            v_out, stream);                                   \
  }

CAM_REMAP_ENTRY(f32, float)
CAM_REMAP_ENTRY(f64, double)
