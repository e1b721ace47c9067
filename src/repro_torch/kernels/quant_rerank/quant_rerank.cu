// Quantized coarse rerank: gather each candidate's code row, block-dequantize
// it, score it against the query, keep the top-k', hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quant_rerank/quant_rerank.py
// (quant_rerank, pallas_call at :95; its top-k' merge is irli_topk's
// _topk_merge). Contract, shared with the plain version (ref.py): score =
// q · (codes * repeat(scales, block)) for angular, -Σ(q - deq)² for l2; a
// slot with id < 0 or count < tau scores -inf and emits id -1; the top-k'
// is by score descending, ties toward the smaller candidate position. The
// fp32 sums run in another order than the plain version's, so the scores
// agree to 1e-5 relative, not bit for bit — which is why the refine stage
// re-scores the survivors (store/rerank.py).
//
// What bounds it on the H100: device memory. Per query it reads C ids and
// counts and gathers the valid slots' code rows of D bytes (int8; 2·D for
// bf16) plus D/block fp32 scales — ~108 B a row at D=96 — and does 2·D
// flops a row, about 1.8 flops a byte, far below the card's ~20 fp32 flops
// a byte. At the compact search's tau = 2 only 6% of the slots are valid
// (63,137 of 1,048,576), so the bound is 4.6 us; what a kernel spends
// beyond it is latency: chains of dependent loads and block barriers.
//
// Design: one block of 128 threads a query, at most 64 registers a thread
// so that 8 blocks share an SM (the compact search's 1024 queries run as
// one wave), the query row in shared memory. The slots go in tiles of
// 1024, 8 consecutive slots a thread:
//   1. Each thread loads its slots' ids and counts (16-byte loads where C %
//      4 == 0 and the arrays are aligned) and keeps the valid ones (id >= 0
//      and count >= tau). A block prefix (irli::radix::block_prefix) gives
//      each its place in a shared list, in position order.
//   2. The valid slots are scored, a group of G lanes a slot: a lane loads
//      one VB-byte vector of the row (16 bytes where D·itemsize % 16 == 0:
//      96 int8 bytes are six; narrower loads otherwise), and its scale once
//      where the vector lies in one scale block; each lane issues its loads
//      for 2 slots before it uses the first; G (a power of two, <= 32) lanes
//      add their partial sums by shuffles. Each score becomes one unique
//      int64 key, order(score)·2^32 + (2^32-1-position), in shared memory.
//   3. The top-k' of the n keys: where n <= 128, warp 0 sorts them in
//      registers (a bitonic network over 2 or 4 keys a lane, shuffles and
//      no block barrier). Past that, a radix select over the keys' score
//      halves (8-bit digits, most significant first, stopping once the
//      digit's bucket is taken whole; the lanes of a warp that share a
//      digit count it with one shared-memory atomic) finds the k'-th score;
//      the keys above it, and the first of those equal to it in position
//      order (the smaller positions win the tie), are compacted in order,
//      then sorted: in registers by warp 0 when k' <= 128, else by a
//      bitonic sort in shared memory. Slots past the valid count emit id -1
//      and -inf.
// Slots past one block's shared memory (pass_slots in ops.py: topC > 16384
// at D <= 22972) go in passes of P slots (a power of two); each pass's best
// k' merges into a running top-k' that lives in global scratch ([Q, 2, k']
// int64, double-buffered, so k' itself has no shared-memory limit): each
// key's slot in the merged list is its index in its own list plus the
// count of larger keys in the other (a binary search; the keys are unique,
// as they carry the position). The score comes back out of the key (its
// high half is the score's total-order bits), exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_rerank.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                  // consecutive slots a thread
constexpr int kTile = kThreads * kPerThread;   // slots a tile: 1024
constexpr int kSortKeys = 128;                 // keys warp 0 sorts: 4 a lane
constexpr int kBins = 256;                     // radix select: 8-bit digits
constexpr int kUnroll = 2;                     // slots a lane loads at once
constexpr int kBlocksPerSM = 8;                // 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCards = 64;
using irli::radix::kRed;

// Shared memory after the keys: the tile's valid ids and positions, the
// radix histogram, block-prefix scratch and the select's result; then the
// query. The layout is ops.smem_bytes's.
constexpr int kFixedInts = 2 * kTile + kBins + kRed + 4;

// The float a key's high half encodes (the inverse of irli::order_key).
__device__ __forceinline__ float key_score(long long key) {
  const int k = static_cast<int>(key >> 32);
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

// The key's score half as an unsigned in the same order.
__device__ __forceinline__ unsigned key_high(long long key) {
  return static_cast<unsigned>(key >> 32) ^ 0x80000000u;
}

// The count of a[0:n] (descending) above v.
__device__ __forceinline__ int count_above(const long long* a, int n,
                                           long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ------------------------------------------------------------- scoring --
// One lane's VB-byte vector of a code row, as raw words.
template <int VB>
struct Raw {
  unsigned w[(VB + 3) / 4];
};

template <int VB>
__device__ __forceinline__ void load_raw(const void* p, Raw<VB>& r) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  } else if constexpr (VB == 2) {
    r.w[0] = __ldg(static_cast<const unsigned short*>(p));
  } else {
    r.w[0] = static_cast<unsigned char>(__ldg(static_cast<const char*>(p)));
  }
}

// Element i of a raw vector, widened to fp32 (int8 or bf16 codes). An
// int8 code b comes out of its word exactly, without a conversion
// instruction: with its sign bit flipped it is the unsigned b + 128, which
// a byte permute sets under the exponent of 2^23, giving the float 2^23 +
// b + 128, and one subtraction leaves b.
template <typename T, int VB>
__device__ __forceinline__ float element(const Raw<VB>& r, int i) {
  if constexpr (sizeof(T) == 1) {
    return __int_as_float(static_cast<int>(__byte_perm(
               r.w[i >> 2] ^ 0x80808080u, 0x4B000000u, 0x7540u + (i & 3)))) -
           8388736.0f;                                   // 2^23 + 128
  } else {
    const unsigned w = r.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// keys[i] for the n listed slots (ids list_id, positions list_pos), a
// group of G lanes a slot (G a power of two, <= 32; a lane takes the
// vectors c, c + G, ... of the row's cols), kUnroll slots a lane at a time:
// their row and scale loads issued first, then each element of q read
// once for them. Each element is widened and scaled by srow[d / block]
// (once a vector where the vector lies in one scale block). rows [L, D] of
// T, scales [L, n_blocks] or nullptr.
template <typename T, int VB>
__device__ __forceinline__ void score_list(
    const float* q, const T* __restrict__ rows,
    const float* __restrict__ scales, int n_blocks, int block, int D,
    const int* list_id, const int* list_pos, int n, int l2, long long* keys) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int cols = D / E;
  const int G = cols >= 32 ? 32 : irli::pow2_at_least(cols);
  const int per_warp = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / G, c = lane & (G - 1);
  const int stride = kWarps * per_warp;
  const bool one_scale = block % E == 0;
  const char* base = reinterpret_cast<const char*>(rows);
  const unsigned row_bytes = static_cast<unsigned>(D) * sizeof(T);
  for (int b = warp * per_warp; b < n; b += kUnroll * stride) {
    int id[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = b + u * stride + sub;
      id[u] = i < n ? list_id[i] : -1;
      acc[u] = 0.0f;
    }
    for (int v = c; v < cols; v += G) {
      // every load first, unconditional (row 0 stands in for an empty
      // slot: a branch would hold the next slot's loads back)
      const int d0 = v * E;
      const int s0 = d0 / block;               // the vector's first block
      Raw<VB> x[kUnroll];
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned long long r = id[u] >= 0 ? id[u] : 0;
        load_raw<VB>(base + r * row_bytes + v * VB, x[u]);
        if constexpr (sizeof(T) == 1) sc[u] = __ldg(scales + r * n_blocks + s0);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float qe = q[d0 + e];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float ce = element<T, VB>(x[u], e);
          if constexpr (sizeof(T) == 1) {
            const unsigned long long r = id[u] >= 0 ? id[u] : 0;
            ce *= one_scale ? sc[u]
                            : __ldg(scales + r * n_blocks + (d0 + e) / block);
          }
          if (l2) {
            const float diff = qe - ce;
            acc[u] += diff * diff;
          } else {
            acc[u] += qe * ce;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        acc[u] += __shfl_xor_sync(kFull, acc[u], o);
      }
      const int i = b + u * stride + sub;
      if (c == 0 && i < n) {
        const float s = l2 ? -acc[u] : acc[u];
        keys[i] = irli::order_key(s) * (irli::kLow + 1) +
                  (irli::kLow - list_pos[i]);
      }
    }
  }
}

// ----------------------------------------------------------- selection --
// Warp 0 sorts keys[0:n] (n <= 32·R) descending in registers, element
// R·lane + r in register r: a bitonic network, shuffles between lanes, no
// block barrier. Writes keys[0:n] back.
template <int R>
__device__ __forceinline__ void warp_sort(long long* keys, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  long long a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = R * lane + r;
    a[r] = e < n ? keys[e] : LLONG_MIN;
  }
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < R) {                         // both keys of a pair in a lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & j) == 0) {
            const int e = R * lane + r;
            const bool desc = (e & k) == 0;
            const long long hi = a[r] > a[r | j] ? a[r] : a[r | j];
            const long long lo = a[r] > a[r | j] ? a[r | j] : a[r];
            a[r] = desc ? hi : lo;
            a[r | j] = desc ? lo : hi;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = R * lane + r;
          const long long p = __shfl_xor_sync(kFull, a[r], j / R);
          const bool keep_max = ((e & j) == 0) == ((e & k) == 0);
          a[r] = keep_max ? (a[r] > p ? a[r] : p) : (a[r] > p ? p : a[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = R * lane + r;
    if (e < n) keys[e] = a[r];
  }
}

// Sort keys[0:m] descending, the whole block (m <= the keys' room, a power
// of two at least m): in registers by warp 0 when m <= 128 (2 keys a lane
// up to 64, else 4), else a bitonic sort over pow2(m) keys padded with
// LLONG_MIN. Every thread calls it.
__device__ __forceinline__ void sort_keys(long long* keys, int m) {
  if (m <= kSortKeys) {
    if (m <= kSortKeys / 2) {
      warp_sort<kSortKeys / 64>(keys, m);
    } else {
      warp_sort<kSortKeys / 32>(keys, m);
    }
    __syncthreads();
    return;
  }
  const int mp = irli::pow2_at_least(m);
  for (int i = m + threadIdx.x; i < mp; i += blockDim.x) keys[i] = LLONG_MIN;
  __syncthreads();
  irli::bitonic_sort<true>(keys, mp);
  __syncthreads();
}

// The best kp of keys[0:n] (n > kp), compacted to keys[0:kp] in position
// order: a radix select over the keys' high halves finds the kp-th score
// (prefix under mask) and how many of the keys equal to it are taken
// (need); those are the first in position order.
__device__ void select_top(long long* keys, int n, int kp, int* hist,
                           int* red, int* found) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0u, mask = 0u;
  int need = kp;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i0 = threadIdx.x - lane; i0 < n; i0 += blockDim.x) {
      // the lanes of a warp that share a digit add once, by their leader:
      // the scores' top bits crowd into few digits
      const int i = i0 + lane;
      unsigned d = kBins;                    // no digit: out of range
      if (i < n) {
        const unsigned u = key_high(keys[i]);
        if ((u & mask) == prefix) d = (u >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(kFull, d);
      if (d < kBins && lane == __ffs(peers) - 1) {
        atomicAdd(&hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds digits 255 - 8l - j, j = 0..7 (largest first)
      int cnt[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[kBins - 1 - 8 * lane - j];
        s += cnt[j];
      }
      int incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - s;
      if (run < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run < need && need <= run + cnt[j]) {
            found[0] = kBins - 1 - 8 * lane - j;
            found[1] = run;
            found[2] = cnt[j];
          }
          run += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(found[0]) << shift;
    mask |= 0xffu << shift;
    need -= found[1];
    const bool whole = need == found[2];
    __syncthreads();                  // found[] is read before its rewrite
    if (whole) break;                 // the bucket is taken whole
  }
  // compaction in rounds of kTile keys: a round's keys go to places below
  // their own, and below every later round's
  int taken = 0, eq_seen = 0;
  for (int r0 = 0; r0 < n; r0 += kTile) {
    long long k[kPerThread];
    bool gt[kPerThread], eq[kPerThread];
    int n_eq = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = r0 + threadIdx.x * kPerThread + j;
      k[j] = i < n ? keys[i] : LLONG_MIN;
      const unsigned u = key_high(k[j]) & mask;
      gt[j] = i < n && u > prefix;
      eq[j] = i < n && u == prefix;
      n_eq += eq[j];
    }
    int total_eq;
    int rank = eq_seen + irli::radix::block_prefix(n_eq, &total_eq, red);
    bool sel[kPerThread];
    int n_sel = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      sel[j] = gt[j] || (eq[j] && rank < need);
      rank += eq[j];
      n_sel += sel[j];
    }
    int total_sel;
    int at = taken + irli::radix::block_prefix(n_sel, &total_sel, red);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (sel[j]) keys[at++] = k[j];
    }
    taken += total_sel;
    eq_seen += total_eq;
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernel --
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) quant_rerank_kernel(
    const float* __restrict__ queries, const T* __restrict__ codes,
    const float* __restrict__ scales, int n_blocks, int block,
    const int* __restrict__ cid, const float* __restrict__ cnt, int C, int P,
    int D, float tau, int kp, int l2, bool vec, long long* run,
    int* __restrict__ out_ids, float* __restrict__ out_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* keys = reinterpret_cast<long long*>(smem);  // [P]
  int* tile_id = reinterpret_cast<int*>(keys + P);       // [kTile]
  int* tile_pos = tile_id + kTile;                       // [kTile]
  int* hist = tile_pos + kTile;                          // [kBins]
  int* red = hist + kBins;                               // [kRed]
  int* found = red + kRed;                               // [4]
  float* q = reinterpret_cast<float*>(found + 4);        // [D]
  const long long row = blockIdx.x;
  const int* row_cid = cid + row * C;
  const float* row_cnt = cnt + row * C;
  const int n_pass = (C + P - 1) / P;

  for (int d = threadIdx.x; d < D; d += blockDim.x) q[d] = queries[row * D + d];
  for (int p = 0; p < n_pass; ++p) {
    const int p0 = p * P;
    const int end = min(p0 + P, C);
    int n = 0;                                 // valid keys of the pass
    for (int t0 = p0; t0 < end; t0 += kTile) {
      const int s0 = t0 + threadIdx.x * kPerThread;
      int id[kPerThread];
      float ct[kPerThread];
      if (vec && s0 < end) {
#pragma unroll
        for (int h = 0; h < kPerThread; h += 4) {
          const int4 iv =
              __ldg(reinterpret_cast<const int4*>(row_cid + s0 + h));
          const float4 cv =
              __ldg(reinterpret_cast<const float4*>(row_cnt + s0 + h));
          id[h] = iv.x; id[h + 1] = iv.y; id[h + 2] = iv.z; id[h + 3] = iv.w;
          ct[h] = cv.x; ct[h + 1] = cv.y; ct[h + 2] = cv.z; ct[h + 3] = cv.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const bool in = s0 + j < end;
          id[j] = in ? __ldg(row_cid + s0 + j) : -1;
          ct[j] = in ? __ldg(row_cnt + s0 + j) : 0.0f;
        }
      }
      int nv = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (s0 + j >= end || id[j] < 0 || !(ct[j] >= tau)) id[j] = -1;
        nv += id[j] >= 0;
      }
      int total;
      int at = irli::radix::block_prefix(nv, &total, red);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (id[j] >= 0) {
          tile_id[at] = id[j];
          tile_pos[at] = s0 + j;
          ++at;
        }
      }
      __syncthreads();
      score_list<T, VB>(q, codes, scales, n_blocks, block, D, tile_id,
                        tile_pos, total, l2, keys + n);
      n += total;
      __syncthreads();
    }
    // the pass's best m keys, sorted, in keys[0:m]
    const int m = min(kp, n);
    if (n > m) select_top(keys, n, m, hist, red, found);
    sort_keys(keys, m);
    if (n_pass == 1) {
      for (int j = threadIdx.x; j < kp; j += blockDim.x) {
        float s = -INFINITY;
        int id = -1;
        if (j < m) {
          const long long key = keys[j];
          s = key_score(key);
          if (isfinite(s)) id = row_cid[irli::key_pos(key)];
        }
        out_scores[row * kp + j] = s;
        out_ids[row * kp + j] = id;
      }
      return;
    }
    // merge the pass's best into the running top-k' (scratch)
    long long* mine = run + row * 2 * kp;   // this row's [2, kp] buffers
    const long long* in = mine + ((p + 1) & 1) * kp;
    long long* out = mine + (p & 1) * kp;
    const int nb = min(P, kp);
    for (int j = m + threadIdx.x; j < nb; j += blockDim.x) {
      keys[j] = LLONG_MIN;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kp; j += blockDim.x) {
      out[j] = (p == 0 && j < nb) ? keys[j] : LLONG_MIN;
    }
    __syncthreads();
    if (p > 0) {
      for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        const long long a = in[i];
        if (a == LLONG_MIN) continue;
        const int rank = i + count_above(keys, nb, a);
        if (rank < kp) out[rank] = a;
      }
      for (int j = threadIdx.x; j < nb; j += blockDim.x) {
        const long long b = keys[j];
        if (b == LLONG_MIN) continue;
        const int rank = j + count_above(in, kp, b);
        if (rank < kp) out[rank] = b;
      }
    }
    __syncthreads();
  }
  const long long* best = run + row * 2 * kp + ((n_pass - 1) & 1) * kp;
  for (int j = threadIdx.x; j < kp; j += blockDim.x) {
    const long long key = best[j];
    const float s = key == LLONG_MIN ? -INFINITY : key_score(key);
    out_scores[row * kp + j] = s;
    out_ids[row * kp + j] =
        isfinite(s) ? row_cid[irli::key_pos(key)] : -1;
  }
}

// The code vector's bytes: 16 where the row's bytes and the codes pointer
// allow it, else the widest of 4, 2, 1 (int8) or 4, 2 (bf16) that does.
int vector_bytes(const void* codes, int D, int es) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
  int vb = 16;
  while (vb > es && ((D * es) % vb != 0 || a % vb != 0)) {
    vb = vb == 16 ? 4 : vb >> 1;
  }
  return vb;
}

size_t smem_bytes(int P, int D) {
  return static_cast<size_t>(P) * sizeof(long long) +
         static_cast<size_t>(kFixedInts + D) * 4;
}

template <typename T, int VB>
int launch(const float* queries, const void* codes, const float* scales,
           int n_blocks, int block, const int* cid, const float* cnt, int Q,
           int C, int P, int D, float tau, int kp, int l2, long long* run,
           int* out_ids, float* out_scores, cudaStream_t stream) {
  const size_t smem = smem_bytes(P < C ? P : irli::pow2_at_least(C), D);
  // the most the kernel is allowed so far, on each card
  static size_t smem_set[kMaxCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxCards || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(quant_rerank_kernel<T, VB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxCards) smem_set[dev] = smem;
  }
  const bool vec = C % kPerThread == 0 &&
                   (reinterpret_cast<uintptr_t>(cid) |
                    reinterpret_cast<uintptr_t>(cnt)) % 16 == 0;
  quant_rerank_kernel<T, VB><<<Q, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(codes), scales, n_blocks, block, cid, cnt,
      C, P < C ? P : irli::pow2_at_least(C), D, tau, kp, l2, vec, run,
      out_ids, out_scores);
  return static_cast<int>(cudaGetLastError());
}

int kernel_attrs(const void* kernel, long long* regs, long long* spill) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.numRegs > *regs) *regs = a.numRegs;
  if (static_cast<long long>(a.localSizeBytes) > *spill) {
    *spill = static_cast<long long>(a.localSizeBytes);
  }
  return 0;
}

}  // namespace

// The most registers and local (spill) bytes a thread of any of the
// kernel's instantiations takes: out[0], out[1]; out[2] the shared bytes
// outside the keys (ops.smem_bytes's constant, with D = 0).
extern "C" int quant_rerank_attrs(long long* out) {
  out[0] = out[1] = 0;
  const void* kernels[] = {
      reinterpret_cast<const void*>(quant_rerank_kernel<int8_t, 16>),
      reinterpret_cast<const void*>(quant_rerank_kernel<int8_t, 4>),
      reinterpret_cast<const void*>(quant_rerank_kernel<int8_t, 2>),
      reinterpret_cast<const void*>(quant_rerank_kernel<int8_t, 1>),
      reinterpret_cast<const void*>(quant_rerank_kernel<__nv_bfloat16, 16>),
      reinterpret_cast<const void*>(quant_rerank_kernel<__nv_bfloat16, 4>),
      reinterpret_cast<const void*>(quant_rerank_kernel<__nv_bfloat16, 2>)};
  for (const void* k : kernels) {
    const int err = kernel_attrs(k, out, out + 1);
    if (err != 0) return err;
  }
  out[2] = static_cast<long long>(smem_bytes(0, 0));
  return 0;
}

// queries [Q, D] f32; codes [L, D] int8 (code_dtype 0) or bf16 (1); scales
// [L, n_blocks] f32 with D = n_blocks·block for int8, NULL for bf16; cid [Q, C]
// int32 (pad -1, every id < L); cnt [Q, C] f32; 1 <= kp <= C; metric 0 =
// angular, 1 = l2. P: slots a pass, a power of two (P·8 + (kFixedInts + D)·4
// bytes of shared memory, P taken as pow2(C) where P >= C); run: [Q, 2, kp]
// int64 scratch, read only when P < C (NULL allowed otherwise). out_ids /
// out_scores [Q, kp]. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int quant_rerank_launch(const float* queries, const void* codes,
                                   int code_dtype, const float* scales,
                                   int n_blocks, int block, const int* cid,
                                   const float* cnt, int Q, int C, int P,
                                   int D, float tau, int kp, int metric,
                                   long long* run, int* out_ids,
                                   float* out_scores, void* stream) {
  if (C < 1 || kp < 1 || kp > C || D < 1 || block < 1 || P < 1 ||
      (P & (P - 1)) != 0 || (P < C && run == nullptr) ||
      (code_dtype == 0) != (scales != nullptr) ||
      (scales != nullptr && n_blocks * block != D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QR_LAUNCH(T, VB)                                                     \
  launch<T, VB>(queries, codes, scales, n_blocks, block, cid, cnt, Q, C, P, \
                D, tau, kp, metric, run, out_ids, out_scores, s)
  if (code_dtype == 0) {
    switch (vector_bytes(codes, D, 1)) {
      case 16: return QR_LAUNCH(int8_t, 16);
      case 4: return QR_LAUNCH(int8_t, 4);
      case 2: return QR_LAUNCH(int8_t, 2);
      default: return QR_LAUNCH(int8_t, 1);
    }
  }
  if (code_dtype == 1) {
    switch (vector_bytes(codes, D, 2)) {
      case 16: return QR_LAUNCH(__nv_bfloat16, 16);
      case 4: return QR_LAUNCH(__nv_bfloat16, 4);
      default: return QR_LAUNCH(__nv_bfloat16, 2);
    }
  }
#undef QR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
