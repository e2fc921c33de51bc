// The polar filter's two-sided real-DFT sums as two tiled FP32/FP64
// products over all levels and rows, for the fused small step's K4 (and,
// through the same entry points, K2).
//
// Replace the DFT matmuls of the Pallas kernels (_dft_filter,
// cam_nor_physics_tpu/models/fv/cd_pallas.py:135-140, which the TPU runs on
// its MXU at Precision.HIGHEST). Plain version: models/fv/cd_fused.py::
// _dft_filter. For a field's increments a, a (M, im) row-major matrix with
// M = km*jm level rows, and a response table resp (jm, nf), nf = im/2+1:
//   forward:  sr = (a Fc) o resp,  si = (a Fs) o resp      (M, nf) each
//   inverse:  out = base + (sr Gc + si Gs)                  (M, im)
// Fc, Fs (im, nf) and Gc, Gs (nf, im) are the grid's DFT tables; row r
// takes the response of its latitude j = r mod jm.
//
// Design. Both are two-accumulator products: the forward reads one A tile
// and two B tiles (Fc, Fs), the inverse two A tiles (sr, si) and two B
// tiles (Gc, Gs). A block of kThreads threads owns a BM x BN output tile of
// one field; the grid covers row tiles x column tiles x the fields, so at
// f05 (M = 12,288) the forward runs 1,920 blocks and fills the 132 SMs.
// Tiles of A and B are staged in shared memory by cp.async, 16 bytes a
// copy where the matrix's row stride and base allow it (element copies
// otherwise: Fc and Fs have nf columns, an odd count), double-buffered so
// that the next k-tile loads while the current one is summed. Each thread
// keeps a TM x TN register tile of both accumulators. Ragged edges are
// masked in the kernel: rows and columns past M or N are not stored, and
// the last k-tile sums only its valid terms.
//
// Numerics. Every output is one thread's sum over k in index order from 0,
// one rounded product and one rounded addition a term (the library builds
// with --fmad=false): no split over k, no tree, no atomics, so the result
// is bitwise the plain version's in float32 and float64. No tensor cores:
// the dynamics' products run in full FP32 (TF32 would round the inputs).
//
// Bound. 4 M nf im operations a field for each of the two products, a
// multiply and an add a term: on the FP32 pipes one operation per lane and
// clock, about 33.5e12 a second on 132 SMs at 1.98 GHz.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace dftf {

constexpr int kThreads = 256;

template <typename T>
struct Tile {                    // BM x BN outputs, k-tiles of BK terms
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
  static constexpr int BK = sizeof(T) == 4 ? 16 : 8;
  static constexpr int V = 16 / sizeof(T);      // elements a 16-byte copy
  static constexpr int LDA = BK + V;            // padded A rows, 16B-aligned
  static_assert((BM / TM) * (BN / TN) == kThreads, "one thread a microtile");
};

// one field of the forward sums: a (M, lda) -> sr, si (M, lds)
template <typename T>
struct Forward {
  const T* a;
  const T* resp;                 // (jm, nf)
  T* sr;
  T* si;
};

// one field of the inverse sums: sr, si (M, lds) -> out (M, im) = base +
// (sr Gc + si Gs); with base null, out = sr Gc + si Gs
template <typename T>
struct Inverse {
  const T* sr;
  const T* si;
  const T* base;
  T* out;
};

// ------------------------------------------------------------ async copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  const char* a = (const char*)src;
  char* b = (char*)dst;
  for (int e = 0; e < 16; ++e) b[e] = a[e];
#endif
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// rows r0.. and columns c0.. of a (nr, nc) matrix with row stride ld into
// a ROWS x COLS shared tile with row stride LD; zeros past the edges
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld,
                                          int r0, int c0, int nr, int nc,
                                          bool vec) {
  constexpr int V = Tile<T>::V, CPR = COLS / V;
  for (int q = threadIdx.x; q < ROWS * CPR; q += blockDim.x) {
    const int r = q / CPR, c = (q - r * CPR) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * LD + c;
    const T* s = src + (size_t)gr * ld + gc;
    if (vec && gr < nr && gc + V <= nc) {
      cp_async16(d, s);
    } else {
      for (int e = 0; e < V; ++e) {
        if (gr < nr && gc + e < nc) {
          cp_async_elem(d + e, s + e);
        } else {
          d[e] = T(0);
        }
      }
    }
  }
}

// four consecutive elements of a 16-byte-aligned shared row
template <typename T>
__device__ __forceinline__ void ld4(T (&d)[4], const T* p) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    const double2 w = *reinterpret_cast<const double2*>(p + 2);
    d[0] = v.x, d[1] = v.y, d[2] = w.x, d[3] = w.y;
  }
#else
  for (int e = 0; e < 4; ++e) d[e] = p[e];
#endif
}

// whether 16-byte copies fit the rows of a matrix (base and stride)
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, size_t ld) {
  return ((uintptr_t)p % 16 == 0) && (ld % Tile<T>::V == 0);
}

// ------------------------------------------------------------ the product

// acc0 = A0 B0, acc1 = A1 B1 over k in order, for the block's output tile
// (rows m0.., columns n0..) of (M, N) outputs with K terms; A (M, K) with
// row stride lda, B (K, N) with row stride ldb. With kSharedA, A1 is A0
// (one A tile). Each thread's TM x TN microtile: rows m0 + ty*TM + t,
// columns n0 + tx*TN + u.
template <typename T, bool kSharedA>
__device__ __forceinline__ void two_products(
    const T* A0, const T* A1, size_t lda, const T* B0, const T* B1,
    size_t ldb, int M, int N, int K, int m0, int n0,
    T (&acc0)[Tile<T>::TM][Tile<T>::TN],
    T (&acc1)[Tile<T>::TM][Tile<T>::TN]) {
  using P = Tile<T>;
  static_assert(P::TN == 4, "B fragments are read as one ld4");
  constexpr int NA = kSharedA ? 1 : 2;
  __shared__ __align__(16) T sA[2][NA][P::BM * P::LDA];
  __shared__ __align__(16) T sB[2][2][P::BK * P::BN];
  const int tx = threadIdx.x % (P::BN / P::TN);
  const int ty = threadIdx.x / (P::BN / P::TN);
  const bool va0 = vec_ok(A0, lda), va1 = vec_ok(A1, lda);
  const bool vb0 = vec_ok(B0, ldb), vb1 = vec_ok(B1, ldb);
#pragma unroll
  for (int t = 0; t < P::TM; ++t)
#pragma unroll
    for (int u = 0; u < P::TN; ++u) acc0[t][u] = acc1[t][u] = T(0);

  auto load = [&](int st, int k0) {
    load_tile<T, P::BM, P::BK, P::LDA>(sA[st][0], A0, lda, m0, k0, M, K,
                                       va0);
    if (!kSharedA)
      load_tile<T, P::BM, P::BK, P::LDA>(sA[st][NA - 1], A1, lda, m0, k0, M,
                                         K, va1);
    load_tile<T, P::BK, P::BN, P::BN>(sB[st][0], B0, ldb, k0, n0, K, N, vb0);
    load_tile<T, P::BK, P::BN, P::BN>(sB[st][1], B1, ldb, k0, n0, K, N, vb1);
    cp_async_commit();
  };
  // one term k of the stage's tiles into both accumulators
  auto term = [&](int st, int kk) {
    T a0[P::TM], a1[P::TM], b0[P::TN], b1[P::TN];
#pragma unroll
    for (int t = 0; t < P::TM; ++t) {
      a0[t] = sA[st][0][(ty * P::TM + t) * P::LDA + kk];
      a1[t] = sA[st][NA - 1][(ty * P::TM + t) * P::LDA + kk];
    }
    ld4(b0, &sB[st][0][kk * P::BN + tx * P::TN]);
    ld4(b1, &sB[st][1][kk * P::BN + tx * P::TN]);
#pragma unroll
    for (int t = 0; t < P::TM; ++t)
#pragma unroll
      for (int u = 0; u < P::TN; ++u) {
        acc0[t][u] = acc0[t][u] + a0[t] * b0[u];
        acc1[t][u] = acc1[t][u] + a1[t] * b1[u];
      }
  };

  const int nt = (K + P::BK - 1) / P::BK;
  load(0, 0);
  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nt) {
      load(st ^ 1, (kt + 1) * P::BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kmax = K - kt * P::BK;
    if (kmax >= P::BK) {
#pragma unroll
      for (int kk = 0; kk < P::BK; ++kk) term(st, kk);
    } else {
      for (int kk = 0; kk < kmax; ++kk) term(st, kk);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ kernels

// grid (ceil(nf / BN), ceil(M / BM), fields): the forward sums of field
// blockIdx.z times its response
template <typename T>
__global__ void __launch_bounds__(kThreads)
dft_forward_kernel(Forward<T> f0, Forward<T> f1, const T* __restrict__ fc,
                   const T* __restrict__ fs, int M, int jm, int im, int nf,
                   int lds) {
  using P = Tile<T>;
  const Forward<T> f = blockIdx.z == 0 ? f0 : f1;
  const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
  T c[P::TM][P::TN], s[P::TM][P::TN];
  two_products<T, true>(f.a, f.a, im, fc, fs, nf, M, nf, im, m0, n0, c, s);
  const int tx = threadIdx.x % (P::BN / P::TN);
  const int ty = threadIdx.x / (P::BN / P::TN);
#pragma unroll
  for (int t = 0; t < P::TM; ++t) {
    const int r = m0 + ty * P::TM + t;
    if (r >= M) continue;
    const T* rs = f.resp + (size_t)(r % jm) * nf;
#pragma unroll
    for (int u = 0; u < P::TN; ++u) {
      const int m = n0 + tx * P::TN + u;
      if (m >= nf) continue;
      f.sr[(size_t)r * lds + m] = c[t][u] * rs[m];
      f.si[(size_t)r * lds + m] = s[t][u] * rs[m];
    }
  }
}

// grid (ceil(im / BN), ceil(M / BM), fields): the inverse sums of field
// blockIdx.z added to its base
template <typename T>
__global__ void __launch_bounds__(kThreads)
dft_inverse_kernel(Inverse<T> f0, Inverse<T> f1, const T* __restrict__ gc,
                   const T* __restrict__ gs, int M, int im, int nf,
                   int lds) {
  using P = Tile<T>;
  const Inverse<T> f = blockIdx.z == 0 ? f0 : f1;
  const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * P::BN;
  T c[P::TM][P::TN], s[P::TM][P::TN];
  two_products<T, false>(f.sr, f.si, lds, gc, gs, im, M, im, nf, m0, n0, c,
                         s);
  const int tx = threadIdx.x % (P::BN / P::TN);
  const int ty = threadIdx.x / (P::BN / P::TN);
#pragma unroll
  for (int t = 0; t < P::TM; ++t) {
    const int r = m0 + ty * P::TM + t;
    if (r >= M) continue;
#pragma unroll
    for (int u = 0; u < P::TN; ++u) {
      const int i = n0 + tx * P::TN + u;
      if (i >= im) continue;
      const size_t idx = (size_t)r * im + i;
      const T d = c[t][u] + s[t][u];
      f.out[idx] = f.base ? f.base[idx] + d : d;
    }
  }
}

// the spectra's row stride: nf rounded up to whole 16-byte copies
inline int spectrum_stride(int nf) { return (nf + 3) / 4 * 4; }

// The filter of two fields (M = km*jm rows each): forward sums into the
// spectra, then the inverse sums into out = base + filtered. Two launches.
template <typename T>
void launch_dft_filter(Forward<T> f0, Forward<T> f1, Inverse<T> g0,
                       Inverse<T> g1, const T* fc, const T* fs, const T* gc,
                       const T* gs, int M, int jm, int im,
                       cudaStream_t stream) {
  using P = Tile<T>;
  const int nf = im / 2 + 1, lds = spectrum_stride(nf);
  const int rows = (M + P::BM - 1) / P::BM;
  const dim3 fwd((nf + P::BN - 1) / P::BN, rows, 2);
  dft_forward_kernel<T><<<fwd, kThreads, 0, stream>>>(f0, f1, fc, fs, M, jm,
                                                      im, nf, lds);
  const dim3 inv((im + P::BN - 1) / P::BN, rows, 2);
  dft_inverse_kernel<T><<<inv, kThreads, 0, stream>>>(g0, g1, gc, gs, M, im,
                                                      nf, lds);
}

}  // namespace dftf
