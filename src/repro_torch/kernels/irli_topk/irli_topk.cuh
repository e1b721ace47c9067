// Device routines of the fused scorer GEMM + running top-m, shared by
// irli_topk.cu, the fused query kernel (mega_query.cu) and the masked
// distance top-k (distance_topk.cu).
//
// A "tile worker" is a group of 256 threads (a whole block in irli_topk.cu,
// half of one in mega_query.cu) that synchronises on its own named barrier,
// so two workers can share a block. Its routines:
//
//   gemm_tile     C[128, 128] = A[row0:+128, :K] @ B[:K, col0:+128] in fp32
//                 on the FMA units: BK = 8 slices of A and B staged in
//                 double-buffered shared memory (the next slice's global
//                 loads are in flight while the current one is multiplied),
//                 each thread accumulating an 8x8 block of C in registers in
//                 k order. Inputs are fp32 or bf16, widened on load. B may
//                 come as its transpose (the corpus rows of distance_topk.cu).
//   scorer_topk_tile
//                 logits = h @ w2 + b2 for 128 rows over every 128-wide
//                 column tile of w2, with a running top-m and (optionally) a
//                 streaming log-sum-exp per row: the [rows, N] logits are
//                 never written to device memory.
//
// Top-m rule (jax.lax.top_k's): values descending in the floats' total
// order (-0.0 below +0.0), the smaller column first on equal values. Each
// tile's logits go to a shared [128, 129] tile; thread t then scans row
// t % 128, columns (t / 128)·64 .. +63 of it, in increasing column order,
// against its own sorted list of m (value, column) pairs in shared memory:
// a value enters only when its key is strictly above the list's last, so an
// equal value at a larger column never displaces a smaller one. The two
// half-row lists of a row are merged at the end by (key desc, column asc).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "../quant_rerank/quant_rerank.cuh"

namespace irli {

constexpr int kTileThreads = 256;
constexpr int kBM = 128;               // rows of a tile (queries)
constexpr int kBN = 128;               // columns of a tile (buckets / hidden)
constexpr int kBK = 8;                 // depth of one staged slice
constexpr int kAStride = kBM + 4;      // transposed A rows: conflict-free
                                       // stores, 16-byte aligned float4 reads
constexpr int kCStride = kBN + 1;      // logit tile rows: conflict-free scans
constexpr int kMaxM = 64;              // widest top-m a worker's lists hold
constexpr int kAsFloats = 2 * kBK * kAStride;
constexpr int kBsFloats = 2 * kBK * kBN;
constexpr int kCtFloats = kBM * kCStride;

// Shared memory of one worker: gemm_tile alone, and scorer_topk_tile at m.
__host__ __device__ constexpr int gemm_smem_bytes() {
  return (kAsFloats + kBsFloats) * 4;
}
__host__ __device__ constexpr int topk_tile_smem_bytes(int m) {
  return (kAsFloats + kBsFloats + kCtFloats + 2 * kBM) * 4 +
         kTileThreads * m * 8;
}

// The worker's barrier: bar.sync on named barrier `bar` over its 256
// threads (bar 0 is __syncthreads'; a worker that is a whole block may use
// any id). Orders the workers' shared and global memory accesses as
// __syncthreads does.
__device__ __forceinline__ void tile_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kTileThreads) : "memory");
}

// A float's bits as an int in the floats' total order (-0.0 below +0.0).
__device__ __forceinline__ int fkey(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

// Row / column of a thread's accumulator (i, j): two 4-wide groups 64 apart,
// so that a quarter-warp's float4 reads of a staged slice are consecutive.
__device__ __forceinline__ int tile_off(int i, int t16) {
  return (i < 4 ? 0 : 64) + t16 * 4 + (i & 3);
}

// One BK-deep slice of A [M, K] and of B [K, N] into registers, zero
// outside the bounds. With kBT, B is given as its transpose Bt [N, K]
// (row stride ldb), as distance_topk.cu's corpus rows: thread lt then reads
// four consecutive depths of one column, so two threads cover one column's
// 32-byte slice.
template <typename T, bool kBT>
__device__ __forceinline__ void load_slice(const T* A, long long lda,
                                           const T* B, long long ldb, int M,
                                           int N, int K, int row0, int col0,
                                           int k0, int lt, float (&ra)[4],
                                           float (&rb)[4]) {
  const int ak = k0 + (lt & 7);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = row0 + (lt >> 3) + 32 * c;
    ra[c] = (r < M && ak < K) ? widen(A[r * lda + ak]) : 0.0f;
  }
  if constexpr (kBT) {
    const int col = col0 + (lt >> 1);
    const int bk = k0 + (lt & 1) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rb[c] = (col < N && bk + c < K) ? widen(B[col * ldb + bk + c]) : 0.0f;
    }
  } else {
    const int bk = k0 + (lt >> 5);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + (lt & 31) + 32 * c;
      rb[c] = (bk < K && col < N) ? widen(B[bk * ldb + col]) : 0.0f;
    }
  }
}

template <bool kBT>
__device__ __forceinline__ void store_slice(float* as, float* bs, int lt,
                                            const float (&ra)[4],
                                            const float (&rb)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    as[(lt & 7) * kAStride + (lt >> 3) + 32 * c] = ra[c];
    if constexpr (kBT) {
      bs[((lt & 1) * 4 + c) * kBN + (lt >> 1)] = rb[c];
    } else {
      bs[(lt >> 5) * kBN + (lt & 31) + 32 * c] = rb[c];
    }
  }
}

// acc[i][j] = Σ_k A[row0 + tile_off(i, ty), k] · B[k, col0 + tile_off(j,
// tx)], k ascending, zero outside [M, N, K]. A [M, K] and B [K, N] are
// row-major with leading dimensions lda, ldb (with kBT, B is given as its
// transpose [N, K], row stride ldb). Every thread of the worker calls it; it leaves As/Bs free (it ends on a barrier). The pointers carry
// no __restrict__: in mega_query.cu, A is scratch that other blocks wrote
// earlier in the same launch, which the non-coherent read-only path must
// not serve.
template <typename T, bool kBT = false>
__device__ void gemm_tile(const T* A, long long lda, const T* B,
                          long long ldb, int M, int N, int K, int row0,
                          int col0, float* As, float* Bs, int bar,
                          float (&acc)[8][8]) {
  const int lt = threadIdx.x & (kTileThreads - 1);
  const int ty = lt >> 4, tx = lt & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int nk = (K + kBK - 1) / kBK;
  float ra[4], rb[4];
  load_slice<T, kBT>(A, lda, B, ldb, M, N, K, row0, col0, 0, lt, ra, rb);
  store_slice<kBT>(As, Bs, lt, ra, rb);
  tile_sync(bar);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_slice<T, kBT>(A, lda, B, ldb, M, N, K, row0, col0,
                         (kt + 1) * kBK, lt, ra, rb);
    }
    const float* as = As + cur * kBK * kAStride;
    const float* bs = Bs + cur * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * kAStride + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * kAStride + 64 + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * kBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * kBN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (kt + 1 < nk) {
      store_slice<kBT>(As + (cur ^ 1) * kBK * kAStride,
                       Bs + (cur ^ 1) * kBK * kBN, lt, ra, rb);
    }
    tile_sync(bar);
  }
}

// Running top-m and log-sum-exp of rows row0 .. row0+127 (those < M) of
// logits = h[M, K] @ w2[K, N] + b2[N], over all N columns; m <= kMaxM <= N.
// Writes out_v[row·m + j] (f32), out_i[row·m + j] (int32 column) and, when
// out_lse is given, out_lse[row] = log Σ_c exp(logit[row, c]). smem holds
// topk_tile_smem_bytes(m) bytes, 16-byte aligned. Every thread of the
// worker calls it.
template <typename T>
__device__ void scorer_topk_tile(const T* h, const T* w2, const T* b2,
                                 int M, int N, int K, int m, int row0,
                                 float* out_v, int* out_i, float* out_lse,
                                 float* smem, int bar) {
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Ct = Bs + kBsFloats;
  float* xmx = Ct + kCtFloats;                        // [kBM] half-row max
  float* xse = xmx + kBM;                             // [kBM] half-row sum
  float* lv = xse + kBM;                              // [256, m] values
  int* li = reinterpret_cast<int*>(lv + kTileThreads * m);   // [256, m]
  const int lt = threadIdx.x & (kTileThreads - 1);
  const int ty = lt >> 4, tx = lt & 15;
  const int srow = lt & (kBM - 1);                    // the row it scans
  const int c_lo = (lt >> 7) * 64;                    // its half of a tile
  float* my_v = lv + lt * m;
  int* my_i = li + lt * m;
  for (int j = 0; j < m; ++j) {
    my_v[j] = -INFINITY;
    my_i[j] = INT_MAX;
  }
  int count = 0;
  int thr = INT_MIN;
  // the row's running max and sum of exp(logit - max), Kahan-compensated
  // (sc): a thread adds ~B/2 terms one by one, and a plain fp32 sum of that
  // many terms drifts by up to 1e-4 relative once the logits are trained
  float mx = -INFINITY, se = 0.0f, sc = 0.0f;
  float acc[8][8];

  for (int col0 = 0; col0 < N; col0 += kBN) {
    gemm_tile(h, K, w2, N, M, N, K, row0, col0, As, Bs, bar, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tile_off(j, tx);
      const float bias = col < N ? widen(b2[col]) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Ct[tile_off(i, ty) * kCStride + tile_off(j, tx)] = acc[i][j] + bias;
      }
    }
    tile_sync(bar);
    const int n_here = min(64, N - col0 - c_lo);
    const float* crow = Ct + srow * kCStride + c_lo;
    if (n_here > 0) {
      if (out_lse != nullptr) {
        float tmx = -INFINITY;
        for (int c = 0; c < n_here; ++c) tmx = fmaxf(tmx, crow[c]);
        const float nmx = fmaxf(mx, tmx);
        const float f = mx == -INFINITY ? 0.0f : expf(mx - nmx);
        float s = se * f, comp = sc * f;
        for (int c = 0; c < n_here; ++c) {
          const float y = expf(crow[c] - nmx) - comp;
          const float t = s + y;
          comp = (t - s) - y;
          s = t;
        }
        mx = nmx;
        se = s;
        sc = comp;
      }
      for (int c = 0; c < n_here; ++c) {
        const float v = crow[c];
        const int key = fkey(v);
        if (count < m || key > thr) {
          int p = count < m ? count : m - 1;
          while (p > 0 && fkey(my_v[p - 1]) < key) {
            my_v[p] = my_v[p - 1];
            my_i[p] = my_i[p - 1];
            --p;
          }
          my_v[p] = v;
          my_i[p] = col0 + c_lo + c;
          if (count < m) ++count;
          if (count == m) thr = fkey(my_v[m - 1]);
        }
      }
    }
    tile_sync(bar);
  }

  se -= sc;
  if (c_lo != 0) {
    xmx[srow] = mx;
    xse[srow] = se;
  }
  tile_sync(bar);
  if (c_lo == 0 && row0 + srow < M) {
    const long long row = row0 + srow;
    const float* ov = lv + (lt + kBM) * m;
    const int* oi = li + (lt + kBM) * m;
    int a = 0, b = 0;
    for (int j = 0; j < m; ++j) {
      const int ka = fkey(my_v[a]), kb = fkey(ov[b]);
      const bool take_a = ka > kb || (ka == kb && my_i[a] < oi[b]);
      out_v[row * m + j] = take_a ? my_v[a] : ov[b];
      out_i[row * m + j] = take_a ? my_i[a] : oi[b];
      if (take_a) ++a; else ++b;
    }
    if (out_lse != nullptr) {
      const float omx = xmx[srow], ose = xse[srow];
      const float top = fmaxf(mx, omx);
      float s = 0.0f;
      if (mx != -INFINITY) s += se * expf(mx - top);
      if (omx != -INFINITY) s += ose * expf(omx - top);
      out_lse[row] = top == -INFINITY ? -INFINITY : top + logf(s);
    }
  }
  tile_sync(bar);
}

}  // namespace irli
