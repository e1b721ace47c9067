// Masked similarity of queries against corpus rows + running top-k,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/distance_topk/distance_topk.py
// (distance_topk, pallas_call at :68), which walks L in sequence on one core
// with a [tq, k] top-k carried in scratch. Contract, shared with the plain
// version (ref.py): sim[q, l] = q·b (metric "dot") or, for "l2",
// -((|q|² - 2 q·b) + |b|²) in core/query.pairwise_sim's order, with |q|² and
// |b|² computed by the caller as pairwise_sim computes them; entries whose
// mask byte is 0 are dropped; per query the k largest in jax.lax.top_k's
// order (value descending in the floats' total order, -0.0 below +0.0, the
// smaller column first on a tie). Slots past the survivors hold -inf and
// INT_MAX; the wrapper (ops.rerank_topk) writes id -1 where the score is not
// finite. The [Q, L] similarities never reach device memory.
//
// What bounds it on the H100: operations. 2·Q·L·d fp32 multiply-adds: at the
// stream cell's oracle (Q = 1024, L = 2,065,536, d = 96) 4.06e11, 6.06 ms at
// 67 TFLOP/s; its bytes (the corpus once, 0.79 GB) take 0.24 ms. The products
// stay IEEE fp32 on the FMA units (no TF32): TF32 would move near-tie ids.
//
// Design: the tile GEMM of irli_topk.cuh (gemm_tile, 128 x 128 fp32 tiles, 8
// x 8 a thread in registers) with the corpus as the transposed operand.
// Blocks of 256 threads over (128-query tile, L split): the TPU's sequential
// L axis is cut into `splits` contiguous ranges of 128-column tiles, so a
// few query tiles still fill the card (one block at an audit window of 64
// queries would use one SM of 132). A block walks its range; each tile's
// similarities go through shared memory, and warp w keeps rows w, w + 8,
// ... of the query tile, each in a sorted (value, column) list of k entries.
// It reads a row 32 columns at a time; a value enters only when its key is
// strictly above the list's last once the list is full, so an equal value
// at a larger column never displaces a smaller one, and the entering values
// go in one by one in column order, each inserted by the whole warp. (With
// one thread a row, every insert stalls the warp's other 31 rows, and at
// k = 100 some row inserts at most columns of the first tiles: chip_smoke's
// neighbours chunk took 35 ms that way on the H100, 7.5 ms this way.) The
// lists sit in shared memory
// for k <= 31 (kMaxK) and, for a larger k, in the block's slice of the
// partial outputs in device memory, so that two blocks share an SM. The block writes its
// [128, k] lists to part[split]; a second kernel merges each query's
// `splits` sorted lists by (key desc, column asc) with one warp:
// deterministic, no atomics.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

#include "../irli_topk/irli_topk.cuh"

namespace {

constexpr int kMaxSplits = 1024;  // 32 heads a lane in the merge
constexpr int kMergeThreads = 256;
// Shared memory of the GEMM staging and the similarity tile; the lists go
// in shared memory too while two blocks still fit an SM (2 x (dynamic +
// 1 KB static + 1 KB reserved) <= 228 KB), which gives k <= 31. A larger k
// keeps them in device memory, where they stay in L1/L2: one block an SM
// (eight warps) cannot hide the GEMM's and the selection's latencies, two
// can.
constexpr int kTileBytes =
    (irli::kAsFloats + irli::kBsFloats + irli::kCtFloats) * 4;
constexpr int kMaxK = ((228 * 1024) / 2 - 2048 - kTileBytes) / (irli::kBM * 8);
static_assert(kMaxK == 31, "two blocks an SM up to k = 31");

__host__ __device__ constexpr int smem_bytes(int k) {
  return kTileBytes + (k <= kMaxK ? irli::kBM * k * 8 : 0);
}

constexpr int kWarps = irli::kTileThreads / 32;
constexpr int kRowsPerWarp = irli::kBM / kWarps;
constexpr int kChunks = irli::kBN / 32;   // 32-column reads of a tile row

// Insert (v, col) with key `key` into a row's sorted list lv/li of k
// entries holding `count`, by one warp: its slot p is the number of
// entries whose key is >= key (an equal key already there sits at a smaller
// column), the entries from p on move down one (the last falls off a full
// list), 32 at a time from the bottom. Every lane calls it with the same
// arguments.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int count,
                                            int k, int key, float v, int col,
                                            int lane) {
  int ge = 0;
  for (int j = lane; j < count; j += 32) ge += irli::fkey(lv[j]) >= key;
  const int p = __reduce_add_sync(0xffffffffu, ge);
  const int last = min(count, k - 1);   // entries [p, last) move to j + 1
  for (int hi = last; hi > p; hi -= 32) {
    const int j = hi - 1 - lane;
    const bool mv = j >= p;
    float tv = 0.0f;
    int ti = 0;
    if (mv) {
      tv = lv[j];
      ti = li[j];
    }
    __syncwarp();
    if (mv) {
      lv[j + 1] = tv;
      li[j + 1] = ti;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = v;
    li[p] = col;
  }
  __syncwarp();
}

// part_v / part_i [splits, Q, k]: split s's top-k of each query over columns
// [s·tps·128, (s+1)·tps·128) ∩ [0, L). Warp w keeps rows w, w + 8, ... of
// the query tile: per 128-column tile it reads each of its rows 32 columns
// at a time (lane = column), and the columns whose key passes the row's
// threshold enter the row's list one by one, in column order, each by the
// whole warp (warp_insert): an insert costs the warp O(k / 32), and no
// lane waits on another lane's insert.
__global__ void __launch_bounds__(irli::kTileThreads, 2)
    distance_topk_kernel(const float* q, const float* base,
                         const unsigned char* mask, long long mask_ld,
                         const float* qn, const float* bn, int Q, int L,
                         int d, int k, int l2, int tps, float* part_v,
                         int* part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count[irli::kBM];   // a row's list length
  __shared__ int s_thr[irli::kBM];     // key of its k-th entry once full
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + irli::kAsFloats;
  float* Ct = Bs + irli::kBsFloats;
  float* lv_all = Ct + irli::kCtFloats;                       // [128, k]
  int* li_all = reinterpret_cast<int*>(lv_all + irli::kBM * k);
  const int lt = threadIdx.x;
  const int ty = lt >> 4, tx = lt & 15;
  const int warp = lt >> 5, lane = lt & 31;
  const int row0 = blockIdx.x * irli::kBM;
  const long long s = blockIdx.y;
  const int c_begin = static_cast<int>(s * tps * irli::kBN);
  const int c_end = static_cast<int>(
      min(static_cast<long long>(L), (s + 1) * tps * irli::kBN));
  const bool in_smem = k <= kMaxK;
  // row r's list: shared memory, or (k > kMaxK) its slice of the outputs
  auto list_v = [&](int r) {
    return in_smem ? lv_all + r * k
                   : part_v + (s * Q + row0 + r) * static_cast<long long>(k);
  };
  auto list_i = [&](int r) {
    return in_smem ? li_all + r * k
                   : part_i + (s * Q + row0 + r) * static_cast<long long>(k);
  };
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (row0 + r >= Q) break;
    float* lv = list_v(r);
    int* li = list_i(r);
    for (int j = lane; j < k; j += 32) {
      lv[j] = -INFINITY;
      li[j] = INT_MAX;
    }
    if (lane == 0) {
      s_count[r] = 0;
      s_thr[r] = INT_MIN;
    }
  }
  float acc[8][8];
  for (int col0 = c_begin; col0 < c_end; col0 += irli::kBN) {
    irli::gemm_tile<float, true>(q, d, base, d, Q, L, d, row0, col0, As, Bs,
                                 1, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Ct[irli::tile_off(i, ty) * irli::kCStride + irli::tile_off(j, tx)] =
            acc[i][j];
      }
    }
    irli::tile_sync(1);
    const int n_here = min(irli::kBN, c_end - col0);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int row = row0 + r;
      if (row >= Q) break;
      float* lv = list_v(r);
      int* li = list_i(r);
      int count = s_count[r];
      int thr = s_thr[r];
      const unsigned char* mrow = mask + row * mask_ld + col0;
      const float qnr = l2 ? qn[row] : 0.0f;
      // the row's 128 columns first (independent loads), then the inserts
      float v[kChunks];
      bool live[kChunks];
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const int c = cc * 32 + lane;
        live[cc] = c < n_here && mrow[c];
        v[cc] = live[cc] ? Ct[r * irli::kCStride + c] : 0.0f;
        if (live[cc] && l2) v[cc] = -((qnr - 2.0f * v[cc]) + bn[col0 + c]);
      }
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const int key = irli::fkey(v[cc]);
        unsigned ball = __ballot_sync(
            0xffffffffu, live[cc] && (count < k || key > thr));
        while (ball) {
          const int src = __ffs(ball) - 1;
          ball &= ball - 1;
          const int kk = __shfl_sync(0xffffffffu, key, src);
          const float vv = __shfl_sync(0xffffffffu, v[cc], src);
          if (count == k && kk <= thr) continue;   // the list moved on
          warp_insert(lv, li, count, k, kk, vv, col0 + cc * 32 + src, lane);
          if (count < k) ++count;
          if (count == k) thr = irli::fkey(lv[k - 1]);
        }
      }
      if (lane == 0) {
        s_count[r] = count;
        s_thr[r] = thr;
      }
    }
    irli::tile_sync(1);
  }
  if (in_smem) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (row0 + r >= Q) break;
      const long long o = (s * Q + row0 + r) * k;
      for (int j = lane; j < k; j += 32) {
        part_v[o + j] = lv_all[r * k + j];
        part_i[o + j] = li_all[r * k + j];
      }
    }
  }
}

// One warp a query: lane l holds the heads of splits l, l + 32, ...; each
// output slot takes the best head by (key desc, column asc) over the warp.
__global__ void __launch_bounds__(kMergeThreads)
    distance_topk_merge(const float* part_v, const int* part_i, int Q,
                        int splits, int k, float* out_v, int* out_i) {
  const int query = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (query >= Q) return;
  int head[kMaxSplits / 32];
  for (int h = 0; h < kMaxSplits / 32; ++h) head[h] = 0;
  for (int j = 0; j < k; ++j) {
    int bk = INT_MIN, bi = INT_MAX, bh = -1;
    for (int h = 0; lane + 32 * h < splits; ++h) {
      if (head[h] >= k) continue;
      const long long o =
          (static_cast<long long>(lane + 32 * h) * Q + query) * k + head[h];
      const int key = irli::fkey(part_v[o]);
      const int id = part_i[o];
      if (bh < 0 || key > bk || (key == bk && id < bi)) {
        bk = key;
        bi = id;
        bh = h;
      }
    }
    int wk = bk, wi = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, wk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      if (ok > wk || (ok == wk && oi < wi)) {
        wk = ok;
        wi = oi;
      }
    }
    const unsigned mine =
        __ballot_sync(0xffffffffu, bh >= 0 && bk == wk && bi == wi);
    if (lane == __ffs(mine) - 1) {
      ++head[bh];
      out_v[static_cast<long long>(query) * k + j] =
          __int_as_float(bk < 0 ? (bk ^ 0x7fffffff) : bk);
      out_i[static_cast<long long>(query) * k + j] = bi;
    }
  }
}

}  // namespace

// The number of L splits for (Q, L, k): one wave of blocks on this device
// (query tiles x splits = SMs x resident blocks an SM), at most one split a
// 128-column tile and kMaxSplits. Returns a cudaError_t (0 on success).
extern "C" int distance_topk_splits(int Q, int L, int k, int* splits) {
  if (Q < 1 || L < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int smem = smem_bytes(k);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(distance_topk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, distance_topk_kernel, irli::kTileThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (Q + irli::kBM - 1) / irli::kBM;
  const int tiles = (L + irli::kBN - 1) / irli::kBN;
  int s = (sms * std::max(per_sm, 1) + q_tiles - 1) / q_tiles;
  s = std::max(1, std::min({s, tiles, kMaxSplits}));
  const int tps = (tiles + s - 1) / s;
  *splits = (tiles + tps - 1) / tps;  // no empty split
  return 0;
}

// queries [Q, d] and base [L, d] fp32 row-major; mask: byte (q, l) at
// mask[q·mask_ld + l] (mask_ld 0: one row for every query), nonzero keeps;
// qn [Q] and bn [L] the squared norms (read only when l2); part_v / part_i
// [splits, Q, k] scratch; out_v [Q, k] f32, out_i [Q, k] int32. Any Q, L >= 1,
// 1 <= k, 1 <= splits <= 1024. Returns cudaGetLastError() after the two
// launches (0 on success).
extern "C" int distance_topk_launch(const float* q, const float* base,
                                    const unsigned char* mask,
                                    long long mask_ld, const float* qn,
                                    const float* bn, int Q, int L, int d,
                                    int k, int l2, int splits, float* part_v,
                                    int* part_i, float* out_v, int* out_i,
                                    void* stream) {
  if (Q < 1 || L < 1 || d < 1 || k < 1 || splits < 1 ||
      splits > kMaxSplits || (Q + irli::kBM - 1) / irli::kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      distance_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L + irli::kBN - 1) / irli::kBN;
  const int tps = (tiles + splits - 1) / splits;
  const dim3 grid((Q + irli::kBM - 1) / irli::kBM, splits);
  distance_topk_kernel<<<grid, irli::kTileThreads, smem, st>>>(
      q, base, mask, mask_ld, qn, bn, Q, L, d, k, l2, tps, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Q * 32 + kMergeThreads - 1) / kMergeThreads;
  distance_topk_merge<<<blocks, kMergeThreads, 0, st>>>(part_v, part_i, Q,
                                                         splits, k, out_v,
                                                         out_i);
  return static_cast<int>(cudaGetLastError());
}
