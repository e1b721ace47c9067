// Device routines of the fp32 tile GEMM on the FMA units and the fused
// scorer GEMM + running top-m, shared by irli_topk.cu, the fused query
// kernel (mega_query.cu) and the masked distance top-k (distance_topk.cu).
//
// A "tile worker" is a group of 256 threads (a whole block in irli_topk.cu
// and distance_topk.cu, half of one in mega_query.cu) that synchronises on
// its own named barrier, so two workers can share a block. Its routines:
//
//   Ring          stages of shared memory (kStages = 3 unless a kernel
//                 asks more), each guarded by a full and an empty
//                 mbarrier. The worker's thread 0 is the producer: it
//                 claims a stage once its 8 warps have released it (one
//                 arrival a warp) and fills it by TMA (tma.cuh); every
//                 thread waits on the stage's full barrier and releases the
//                 stage when its warp is done. The copies of the next
//                 stages - 1 slices are in flight while one is multiplied,
//                 and no slice passes through registers.
//   slice_fma     one slice of the 128 x 128 tile: slice_depth<T>() =
//                 128 / sizeof(T) steps of k (32 fp32, 64 bf16), every
//                 thread accumulating
//                 an 8 x 8 block in registers. One operand, X, arrives
//                 row-major (a row is one 128-byte swizzle span of k: TMA's
//                 128-byte swizzle, so that 16 rows at one k lie in 8
//                 distinct bank groups) and is read as 4 consecutive k at
//                 once; the other, Y, arrives K-major ([k][128]) and is read
//                 as 4 consecutive columns at once. Per 4 steps of k a
//                 thread issues 16 shared loads for 256 FFMAs.
//   walk          a worker's sequence of 128 x 128 output tiles, slice after
//                 slice through the ring: the copies run ahead across tile
//                 boundaries (the ring never drains inside a walk), and
//                 done(t, acc) takes each finished tile from the registers.
//                 mega_query's phase 1 and distance_topk walk all their
//                 tiles in one walk.
//   scorer_topk_tile
//                 logits = h @ w2 + b2 for 128 rows over every 128-wide
//                 column tile of w2, with a running top-m and (optionally) a
//                 streaming log-sum-exp per row: the [rows, N] logits are
//                 never written to device memory. One walk a column tile:
//                 the ring drains at each, and the tile's logits go through
//                 its memory into every thread's half-row scan.
//
// The choice of layouts. A is read as it lies, row-major: h [G, Q, H] is
// the caller's (irli_topk) or phase 1's (mega_query), and the fit hands
// irli_topk up to [32, 65536, 1024] (8.6 GB), so a transposed copy would
// cost as much memory again. With A row-major and a thread's 8 rows at
// 4ty + {0..3} and 64 + 4ty + {0..3}, the two rows of a warp's load lie in
// two bank groups under the swizzle, and 4 k cost one load. distance_topk.cu
// uses the same slice with the roles swapped (X the corpus rows, Y its
// resident query tile transposed once into shared memory).
//
// Arithmetic. Every output is one fmaf chain over k ascending, from +0.0,
// with no split of K, so the sums depend on neither the slice depth nor
// the ring (zero-filled k past K add an exact +0.0 product to a sum that is
// never -0.0); the card tests hold the top values bit-equal to a float64
// emulation of that chain. The products stay IEEE fp32: TF32 or bf16 would
// move the top-m choice off the reference.
//
// Top-m rule (jax.lax.top_k's): values descending in the floats' total
// order (-0.0 below +0.0), the smaller column first on equal values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "../quant_rerank/quant_rerank.cuh"
#include "../tma.cuh"

namespace irli {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kBM = 128;               // rows of a tile (queries)
constexpr int kBN = 128;               // columns of a tile (buckets / hidden)
constexpr int kRowBytes = 128;         // an X row of a slice: one swizzle span
constexpr int kStages = 3;             // ring depth
constexpr int kXBytes = kBM * kRowBytes;          // 16 KB
constexpr int kYBytes = kRowBytes * kBN;          // 16 KB ([BK][128] of T)
constexpr int kStageBytes = kXBytes + kYBytes;    // 32 KB
constexpr int kRingBytes = kStages * kStageBytes; // 96 KB
constexpr int kAlign = 1024;           // the swizzled X slices' alignment
constexpr int kMaxM = 64;              // widest top-m a worker's lists hold

// depth of one slice: a 128-byte X row of T
template <typename T>
__host__ __device__ constexpr int slice_depth() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

// Shared memory of one worker (a multiple of kAlign): the ring alone, and
// scorer_topk_tile at m (the ring, which the tile's logits reuse, and
// lists_bytes(m): the lse halves and 256 half-row lists of m). A kernel
// adds kAlign bytes of slack to align the first worker.
__host__ __device__ constexpr int gemm_smem_bytes() { return kRingBytes; }
__host__ __device__ constexpr int lists_bytes(int m);
__host__ __device__ constexpr int topk_tile_smem_bytes(int m) {
  return kRingBytes + lists_bytes(m);
}

// The first kAlign-aligned byte at or after p (a kernel's dynamic shared
// memory, which the swizzled X slices need aligned).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = tma::smem_addr(p);
  return p + (((a + kAlign - 1) & ~(kAlign - 1)) - a);
}

// A kernel's registers a thread and local (spill) bytes a thread, into
// out[0..1]. Returns a cudaError_t.
template <typename K>
inline int kernel_attrs(K kernel, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  return 0;
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
// so that a quarter-warp's float4 reads of a K-major slice are consecutive.
__device__ __forceinline__ int tile_off(int i, int t16) {
  return (i < 4 ? 0 : 64) + t16 * 4 + (i & 3);
}

// ------------------------------------------------------------- the ring --
struct Ring {
  unsigned char* base;   // stage 0 (generic pointer, kAlign-aligned)
  uint32_t addr;         // its shared-memory address
  uint32_t bars;         // full[s] at bars + 8s, empty[s] at + 8(kStages + s)
  int bar;               // the worker's named barrier
  int stride;            // bytes a stage: X and Y, or X alone
  int stages;            // its depth (kStages unless the kernel asks more)
  unsigned n;            // slices through the ring so far (every thread)

  __device__ uint32_t x(int s) const { return addr + s * stride; }
  __device__ uint32_t y(int s) const { return x(s) + kXBytes; }
  __device__ const unsigned char* xp(int s) const {
    return base + s * stride;
  }
  __device__ const unsigned char* yp(int s) const {
    return xp(s) + kXBytes;
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
};

// The worker's ring of `stages` stages of `stride` bytes over `base`
// (kAlign-aligned) with the 2·stages mbarriers at `bars`; every thread of
// the worker calls it (its thread 0 initialises the barriers, then the
// worker syncs).
__device__ __forceinline__ Ring make_ring(unsigned char* base,
                                          uint64_t* bars, int bar,
                                          int stride = kStageBytes,
                                          int stages = kStages) {
  Ring r;
  r.base = base;
  r.addr = tma::smem_addr(base);
  r.bars = tma::smem_addr(bars);
  r.bar = bar;
  r.stride = stride;
  r.stages = stages;
  r.n = 0;
  if ((threadIdx.x & (kTileThreads - 1)) == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::mbar_init(r.full(s), 1);
      tma::mbar_init(r.empty(s), kTileWarps);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  tile_sync(bar);
  return r;
}

// The producer's half of slice n: wait until its stage is free (the first
// pass over the ring finds every stage free), then announce `bytes` of
// copies on the stage's full barrier. Returns the stage.
__device__ __forceinline__ int claim(const Ring& r, unsigned n,
                                     uint32_t bytes) {
  const unsigned d = static_cast<unsigned>(r.stages);
  const int s = static_cast<int>(n % d);
  tma::mbar_wait(r.empty(s), ((n / d) & 1) ^ 1);
  tma::mbar_expect_tx(r.full(s), bytes);
  return s;
}

// The consumers' half: wait until slice n has landed. Returns the stage.
__device__ __forceinline__ int await_slice(const Ring& r, unsigned n) {
  const unsigned d = static_cast<unsigned>(r.stages);
  const int s = static_cast<int>(n % d);
  tma::mbar_wait(r.full(s), (n / d) & 1);
  return s;
}

// The warp is done with slice n's stage.
__device__ __forceinline__ void release(const Ring& r, unsigned n) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    tma::mbar_arrive(r.empty(static_cast<int>(n % r.stages)));
}

// ------------------------------------------------------------ one slice --
// Four consecutive T at p (16 bytes for fp32, 8 for bf16) as floats.
template <typename T>
__device__ __forceinline__ void ld4(const unsigned char* p, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  }
}

// acc[i][j] += Σ_k over one slice, k ascending, in the thread's fmaf
// chains. kNT false (irli, mega): X = A rows tile_off(i, ty), Y = B
// columns tile_off(j, tx) (K-major, unswizzled: [depth][128] of T). kNT
// true (distance_topk): X = the corpus rows of output columns tx + 16j, Y
// = the query tile transposed ([k][128] fp32, rows tile_off(i, ty)), its
// k-th row at yk + k·512. xs: the X slice, 128 rows of kRowBytes under
// the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)).
template <typename T, bool kNT>
__device__ __forceinline__ void slice_fma(const unsigned char* xs,
                                          const unsigned char* ys, int ty,
                                          int tx, float (&acc)[8][8]) {
  constexpr int ES = static_cast<int>(sizeof(T));
  constexpr int BK = slice_depth<T>();
  // X row addresses without their chunk: for kNT the 8 rows tx + 16j
  // share one swizzle (tx & 7); else rows 4ty + (i & 3) (+64) swizzle by
  // (i & 3) ^ 4(ty & 1), so chunk c ^ (i & 3) sits at +16c from p_lo
  // (c < 4) or p_hi (c >= 4) with the flip of bit 2 folded in.
  const int flip = (ty & 1) ? 64 : 0;
  const unsigned char* p_lo = xs + ty * 512 + flip;
  const unsigned char* p_hi = xs + ty * 512 - flip;
  const unsigned char* p_nt = xs + tx * 128;
  const int sw_nt = tx & 7;
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    float xv[8][4];
    const int byte = k4 * ES;
    if constexpr (kNT) {
      const unsigned char* p =
          p_nt + (((byte >> 4) ^ sw_nt) << 4) + (byte & 15);
#pragma unroll
      for (int j = 0; j < 8; ++j) ld4<T>(p + j * 16 * 128, xv[j]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = (byte >> 4) ^ (i & 3);
        const unsigned char* p = (c < 4 ? p_lo : p_hi) + (i & 3) * 128 +
                                 (i >> 2) * 64 * 128 + c * 16 + (byte & 15);
        ld4<T>(p, xv[i]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float yv[8];
      if constexpr (kNT) {
        const unsigned char* q = ys + (k4 + kk) * 512 + ty * 16;
        ld4<float>(q, yv);
        ld4<float>(q + 256, yv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(yv[i], xv[j][kk], acc[i][j]);
      } else {
        const unsigned char* q = ys + (k4 + kk) * kBN * ES + tx * 4 * ES;
        ld4<T>(q, yv);
        ld4<T>(q + 64 * ES, yv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(xv[i][kk], yv[j], acc[i][j]);
      }
    }
  }
}

// ----------------------------------------------------------------- walk --
// The worker's walk over n_tiles output tiles of nk slices each, in order:
// slice u of the walk (tile u / nk, slice u % nk) is issued by load(u) on
// the producer thread (it claims the stage and starts the copies), its
// products go into acc by slice_fma<T, kNT> from the stage's X and from
// ys(u, stage), and done(t, acc) runs once tile t's products are complete.
// The copies run r.stages - 1 slices ahead, across tile boundaries: the
// ring never drains inside a walk, and nothing in it waits for the whole
// worker, so one warp's epilogue overlaps the others' products. Every
// thread of the worker calls it.
template <typename T, bool kNT, class Load, class Ys, class Done>
__device__ __forceinline__ void walk(Ring& r, int n_tiles, int nk, Load load,
                                     Ys ys, Done done) {
  const int lt = threadIdx.x & (kTileThreads - 1);
  const int ty = lt >> 4, tx = lt & 15;
  const unsigned n0 = r.n;
  const unsigned total = static_cast<unsigned>(n_tiles) * nk;
  const unsigned ahead = static_cast<unsigned>(r.stages) - 1;
  if (lt == 0) {
    for (unsigned u = 0; u < ahead && u < total; ++u) load(u);
  }
  unsigned u = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int sl = 0; sl < nk; ++sl, ++u) {
      if (lt == 0 && u + ahead < total) load(u + ahead);
      const int st = await_slice(r, n0 + u);
      slice_fma<T, kNT>(r.xp(st), ys(u, st), ty, tx, acc);
      release(r, n0 + u);
    }
    done(t, acc);
  }
  r.n = n0 + total;
}

// ----------------------------------------------------- scorer_topk_tile --
// Shared memory of one worker beyond its ring (topk_tile_smem_bytes(m) -
// kRingBytes): two [128] lse halves and the 256 half-row lists of m
// (value, column) pairs. The tile's logits, ct[128][kCStride], reuse the
// ring.
constexpr int kCStride = kBN + 1;      // tile rows: conflict-free scans
constexpr int kCtBytes = kBM * kCStride * 4;
__host__ __device__ constexpr int lists_bytes(int m) {
  return 2 * kBM * 4 + kTileThreads * m * 8;
}
static_assert(kCtBytes <= kRingBytes, "the logit tile reuses the ring");

// Running top-m and log-sum-exp of rows row0 .. row0+127 (those < M) of
// logits = h[g, M, K] @ w2[g, K, N] + b2[N] (b2 already at rep g), over
// all N columns; m <= kMaxM <= N. mh, mw: h's and w2's tensor maps (X boxes
// of h, Y boxes of w2). Writes out_v[row·m + j] (f32), out_i[row·m + j]
// (int32 column) and, when out_lse is given, out_lse[row] = log Σ_c
// exp(logit[row, c]). r: the worker's ring; lists: lists_bytes(m) bytes,
// 16-byte aligned. Every thread of the worker calls it.
//
// Each column tile is one walk: the ring drains at its end, the tile's
// logits go through the ring's memory (ct), and every thread then owns a
// half-row: thread lt scans row lt % 128, columns (lt / 128)·64 .. +63, in
// increasing column order, against its own sorted list of m (value,
// column) pairs (count and thr, the key of its m-th entry once full, in
// registers). A value enters only when its key is strictly above the
// list's last once the list is full, so an equal value at a larger column
// never displaces a smaller one; the two half-row lists of a row are
// merged at the end by (key desc, column asc). Nothing multiplies in the
// worker meanwhile (in mega_query the block's other worker may); the
// drain, the barriers and the scans are phase 2's epilogue, whose share
// chip_smoke.py measures with select = false: then the worker walks every
// column tile in one walk, the ring never drains, and nothing is selected
// or written (a timing probe: the outputs are left as they were).
template <typename T>
__device__ void scorer_topk_tile(Ring& r, const CUtensorMap* mh,
                                 const CUtensorMap* mw, int g, const T* b2,
                                 int M, int N, int K, int m, int row0,
                                 float* out_v, int* out_i, float* out_lse,
                                 float* lists, bool select = true) {
  constexpr int BK = slice_depth<T>();
  const int nk = (K + BK - 1) / BK;
  auto ys = [&](unsigned, int st) { return r.yp(st); };
  if (!select) {
    float sink = 0.0f;          // keeps every product live
    auto load = [&](unsigned u) {
      const int st = claim(r, r.n + u, kStageBytes);
      const int s = static_cast<int>(u % nk);
      const int col0 = static_cast<int>(u / nk) * kBN;
      tma::tma_load(r.x(st), mh, r.full(st), s * BK, row0, g, 0);
      tma::tma_load(r.y(st), mw, r.full(st), col0, s * BK, g, 0);
    };
    auto done = [&](int, float (&acc)[8][8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sink += acc[i][j];
    };
    walk<T, false>(r, (N + kBN - 1) / kBN, nk, load, ys, done);
    if (sink == 0.5f) out_v[0] = sink;   // the probe's outputs are not read
    tile_sync(r.bar);
    return;
  }
  float* Ct = reinterpret_cast<float*>(r.base);       // reuses the ring
  float* xmx = lists;                                 // [kBM] half-row max
  float* xse = xmx + kBM;                             // [kBM] half-row sum
  float* lists_v = xse + kBM;                         // [256, m] values
  int* lists_i = reinterpret_cast<int*>(lists_v + kTileThreads * m);
  const int lt = threadIdx.x & (kTileThreads - 1);
  const int ty = lt >> 4, tx = lt & 15;
  const int srow = lt & (kBM - 1);                    // the row it scans
  const int c_lo = (lt >> 7) * 64;                    // its half of a tile
  float* lv = lists_v + lt * m;                       // its own list
  int* li = lists_i + lt * m;
  for (int j = 0; j < m; ++j) {
    lv[j] = -INFINITY;
    li[j] = INT_MAX;
  }
  int count = 0, thr = INT_MIN;
  // the row's running max and sum of exp(logit - max), Kahan-compensated
  // (sc): a thread adds ~B/2 terms one by one, and a plain fp32 sum of that
  // many terms drifts by up to 1e-4 relative once the logits are trained
  float mx = -INFINITY, se = 0.0f, sc = 0.0f;
  for (int col0 = 0; col0 < N; col0 += kBN) {
    auto load = [&](unsigned u) {
      const int s = static_cast<int>(u);
      const int st = claim(r, r.n + u, kStageBytes);
      tma::tma_load(r.x(st), mh, r.full(st), s * BK, row0, g, 0);
      tma::tma_load(r.y(st), mw, r.full(st), col0, s * BK, g, 0);
    };
    auto done = [&](int, float (&acc)[8][8]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + tile_off(j, tx);
        const float bias = col < N ? widen(b2[col]) : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] += bias;
      }
      tile_sync(r.bar);              // every warp is done with the ring
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Ct[tile_off(i, ty) * kCStride + tile_off(j, tx)] = acc[i][j];
    };
    walk<T, false>(r, 1, nk, load, ys, done);
    tile_sync(r.bar);
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
      // the half-row against the thread's list, in column order
      for (int c = 0; c < n_here; ++c) {
        const float v = crow[c];
        const int key = fkey(v);
        if (count < m || key > thr) {
          int p = count < m ? count : m - 1;
          while (p > 0 && fkey(lv[p - 1]) < key) {
            lv[p] = lv[p - 1];
            li[p] = li[p - 1];
            --p;
          }
          lv[p] = v;
          li[p] = col0 + c_lo + c;
          if (count < m) ++count;
          if (count == m) thr = fkey(lv[m - 1]);
        }
      }
    }
    // the next tile's copies overwrite the logits
    tma::fence_proxy_shared();
    tile_sync(r.bar);
  }

  se -= sc;
  if (c_lo != 0) {
    xmx[srow] = mx;
    xse[srow] = se;
  }
  tile_sync(r.bar);
  if (c_lo == 0 && row0 + srow < M) {
    // the row's two half-row lists merged by (key desc, column asc)
    const long long row = row0 + srow;
    const float* bv = lists_v + (lt + kBM) * m;
    const int* bi = lists_i + (lt + kBM) * m;
    int a = 0, b = 0;
    for (int j = 0; j < m; ++j) {
      const int ka = fkey(lv[a]), kb = fkey(bv[b]);
      const bool take_a = ka > kb || (ka == kb && li[a] < bi[b]);
      out_v[row * m + j] = take_a ? lv[a] : bv[b];
      out_i[row * m + j] = take_a ? li[a] : bi[b];
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
  tile_sync(r.bar);
}

// ------------------------------------------------------------ host side --
// A tensor map for a [G, rows, cols] operand of T (row stride ld, rep
// stride sg, in elements; 16-byte aligned base and byte strides): X boxes
// (slice_depth<T>() columns x 128 rows, 128-byte swizzle) or Y boxes (128
// columns x slice_depth<T>() rows, no swizzle). False when the driver
// refuses it.
template <typename T>
inline bool operand_map(CUtensorMap* map, const void* ptr, long long G,
                        long long rows, long long cols, long long ld,
                        long long sg, bool x_box) {
  constexpr int ES = static_cast<int>(sizeof(T));
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(G), 1};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ld * ES),
                                 static_cast<cuuint64_t>(sg * ES),
                                 static_cast<cuuint64_t>(sg * G * ES)};
  const cuuint32_t bk = static_cast<cuuint32_t>(slice_depth<T>());
  const cuuint32_t box[4] = {x_box ? bk : static_cast<cuuint32_t>(kBN),
                             x_box ? static_cast<cuuint32_t>(kBM) : bk, 1,
                             1};
  return tma::encode_4d(map,
                        ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        ptr, dims, strides, box,
                        x_box ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// whether a device pointer and element strides suit a tensor map
inline bool tma_aligned(const void* p, long long es, long long ld,
                        long long sg) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * es) % 16 == 0 &&
         (sg * es) % 16 == 0;
}

}  // namespace irli
