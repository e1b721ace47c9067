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
// counts and gathers up to C code rows of D bytes (int8; 2·D for bf16) plus
// D/block fp32 scales — ~108 B a row at D=96 — and does 2·D flops a row,
// about 1.8 flops a byte, far below the card's ~20 fp32 flops a byte. The
// gather is random over the store, so the rows come in 32-byte sectors and
// the L2 cache catches the rows that several queries share.
//
// Design: one CTA of 256 threads (8 warps) per query. The query row sits in
// shared memory. The warps walk the C candidate slots; a warp loads one
// code row with consecutive lanes on consecutive bytes, widens and scales
// each element, and reduces the dot product or the squared distance with
// warp shuffles into a shared [C] score array — nothing of the fp32 row
// leaves registers. Then each slot's (score, position) becomes one unique
// int64 key, order(score)·2^32 + (2^32-1-position), and a bitonic sort of
// the C keys in shared memory (padded to a power of two) puts the top-k'
// first. Vectorised row loads and a wider tile of queries per CTA are left
// for a later change. The scoring and the packed-key sort are device
// routines of quant_rerank.cuh, which the fused query kernel (mega_query.cu)
// shares.
//
// The kernel takes the slots in passes of P (a power of two): P covers all C
// slots wherever their keys fit one block's shared memory (topC <= 16384 at
// D <= 8960), so the usual call is one pass whose sorted keys give the top-k'
// directly. Wider rows take several passes; each pass's best k' merges into a
// running top-k' that lives in global scratch ([Q, 2, k'] int64,
// double-buffered, so k' itself has no shared-memory limit): each key's slot
// in the merged list is its index in its own list plus the count of larger
// keys in the other (a binary search; the keys are unique, as they carry the
// position). The score comes back out of the key (its high half is the
// score's total-order bits), exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_rerank.cuh"

namespace {

constexpr int kThreads = 256;

// The float a key's high half encodes (the inverse of irli::order_key).
__device__ __forceinline__ float key_score(long long key) {
  const int k = static_cast<int>(key >> 32);
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
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

template <typename T>
__global__ void quant_rerank_kernel(
    const float* __restrict__ queries, const T* __restrict__ codes,
    const float* __restrict__ scales, int n_blocks, int block,
    const int* __restrict__ cid, const float* __restrict__ cnt, int C, int P,
    int D, float tau, int kp, int l2, long long* run,
    int* __restrict__ out_ids, float* __restrict__ out_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = min(P, C);                                // slots a pass
  long long* keys = reinterpret_cast<long long*>(smem);   // [P]
  float* score = reinterpret_cast<float*>(keys + P);      // [S]
  float* q = score + S;                                   // [D]
  const long long row = blockIdx.x;
  const int n_pass = (C + P - 1) / P;

  for (int d = threadIdx.x; d < D; d += blockDim.x) q[d] = queries[row * D + d];
  __syncthreads();
  for (int p = 0; p < n_pass; ++p) {
    const int p0 = p * P;
    const int n = min(P, C - p0);
    irli::score_slots(q, codes, scales, n_blocks, block, D, cid + row * C + p0,
                      cnt + row * C + p0, tau, n, l2, score);
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      keys[i] = i < n ? irli::order_key(score[i]) * (irli::kLow + 1) +
                            (irli::kLow - (p0 + i))
                      : LLONG_MIN;
    }
    __syncthreads();
    irli::bitonic_sort<true>(keys, P);
    if (n_pass == 1) break;                 // keys[0:kp] is the top-k'
    long long* mine = run + row * 2 * kp;   // this row's [2, kp] buffers
    const long long* in = mine + ((p + 1) & 1) * kp;
    long long* out = mine + (p & 1) * kp;
    const int nb = min(P, kp);
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
  const long long* best =
      n_pass == 1 ? keys : run + row * 2 * kp + ((n_pass - 1) & 1) * kp;
  for (int j = threadIdx.x; j < kp; j += blockDim.x) {
    const long long key = best[j];
    const float s = key_score(key);
    out_scores[row * kp + j] = s;
    out_ids[row * kp + j] =
        isfinite(s) ? cid[row * C + irli::key_pos(key)] : -1;
  }
}

template <typename T>
int launch(const float* queries, const void* codes, const float* scales,
           int n_blocks, int block, const int* cid, const float* cnt, int Q,
           int C, int P, int D, float tau, int kp, int l2, long long* run,
           int* out_ids, float* out_scores, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(P) * sizeof(long long) +
                      static_cast<size_t>((P < C ? P : C) + D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quant_rerank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_rerank_kernel<T><<<Q, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(codes), scales, n_blocks, block, cid, cnt,
      C, P, D, tau, kp, l2, run, out_ids, out_scores);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [Q, D] f32; codes [L, D] int8 (code_dtype 0) or bf16 (1); scales
// [L, n_blocks] f32 with D = n_blocks·block, or NULL for bf16; cid [Q, C]
// int32 (pad -1, every id < L); cnt [Q, C] f32; 1 <= kp <= C; metric 0 =
// angular, 1 = l2. P: slots a pass, a power of two (P·8 + (min(P, C) + D)·4
// bytes of shared memory); run: [Q, 2, kp] int64 scratch, read only when
// P < C (NULL allowed otherwise). out_ids / out_scores [Q, kp]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int quant_rerank_launch(const float* queries, const void* codes,
                                   int code_dtype, const float* scales,
                                   int n_blocks, int block, const int* cid,
                                   const float* cnt, int Q, int C, int P,
                                   int D, float tau, int kp, int metric,
                                   long long* run, int* out_ids,
                                   float* out_scores, void* stream) {
  if (C < 1 || kp < 1 || kp > C || D < 1 || block < 1 || P < 1 ||
      (P & (P - 1)) != 0 || (P < C && run == nullptr) ||
      (scales != nullptr && n_blocks * block != D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_dtype == 0) {
    return launch<int8_t>(queries, codes, scales, n_blocks, block, cid, cnt, Q,
                          C, P, D, tau, kp, metric, run, out_ids, out_scores,
                          s);
  }
  if (code_dtype == 1) {
    return launch<__nv_bfloat16>(queries, codes, scales, n_blocks, block, cid,
                                 cnt, Q, C, P, D, tau, kp, metric, run,
                                 out_ids, out_scores, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
