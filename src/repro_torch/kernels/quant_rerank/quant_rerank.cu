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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_rerank.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void quant_rerank_kernel(
    const float* __restrict__ queries, const T* __restrict__ codes,
    const float* __restrict__ scales, int n_blocks, int block,
    const int* __restrict__ cid, const float* __restrict__ cnt, int C, int Cp,
    int D, float tau, int kp, int l2, int* __restrict__ out_ids,
    float* __restrict__ out_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* keys = reinterpret_cast<long long*>(smem);   // [Cp]
  float* score = reinterpret_cast<float*>(keys + Cp);     // [C]
  float* q = score + C;                                   // [D]
  const long long row = blockIdx.x;

  for (int d = threadIdx.x; d < D; d += blockDim.x) q[d] = queries[row * D + d];
  __syncthreads();
  irli::score_slots(q, codes, scales, n_blocks, block, D, cid + row * C,
                    cnt + row * C, tau, C, l2, score);
  irli::sort_score_keys(score, C, Cp, keys);

  for (int j = threadIdx.x; j < kp; j += blockDim.x) {
    const int pos = irli::key_pos(keys[j]);
    const float s = score[pos];
    out_scores[row * kp + j] = s;
    out_ids[row * kp + j] = isfinite(s) ? cid[row * C + pos] : -1;
  }
}

template <typename T>
int launch(const float* queries, const void* codes, const float* scales,
           int n_blocks, int block, const int* cid, const float* cnt, int Q,
           int C, int D, float tau, int kp, int l2, int* out_ids,
           float* out_scores, cudaStream_t stream) {
  const int Cp = irli::pow2_at_least(C);
  const size_t smem = static_cast<size_t>(Cp) * sizeof(long long) +
                      static_cast<size_t>(C + D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quant_rerank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_rerank_kernel<T><<<Q, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(codes), scales, n_blocks, block, cid, cnt,
      C, Cp, D, tau, kp, l2, out_ids, out_scores);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries [Q, D] f32; codes [L, D] int8 (code_dtype 0) or bf16 (1); scales
// [L, n_blocks] f32 with D = n_blocks·block, or NULL for bf16; cid [Q, C]
// int32 (pad -1, every id < L); cnt [Q, C] f32; 1 <= kp <= C; metric 0 =
// angular, 1 = l2. out_ids / out_scores [Q, kp]. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int quant_rerank_launch(const float* queries, const void* codes,
                                   int code_dtype, const float* scales,
                                   int n_blocks, int block, const int* cid,
                                   const float* cnt, int Q, int C, int D,
                                   float tau, int kp, int metric, int* out_ids,
                                   float* out_scores, void* stream) {
  if (C < 1 || kp < 1 || kp > C || D < 1 || block < 1 ||
      (scales != nullptr && n_blocks * block != D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_dtype == 0) {
    return launch<int8_t>(queries, codes, scales, n_blocks, block, cid, cnt, Q,
                          C, D, tau, kp, metric, out_ids, out_scores, s);
  }
  if (code_dtype == 1) {
    return launch<__nv_bfloat16>(queries, codes, scales, n_blocks, block, cid,
                                 cnt, Q, C, D, tau, kp, metric, out_ids,
                                 out_scores, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
