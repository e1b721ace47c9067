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
// for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kLow = 0xffffffffLL;

__device__ __forceinline__ float widen(int8_t c) {
  return static_cast<float>(c);
}
__device__ __forceinline__ float widen(__nv_bfloat16 c) {
  return __bfloat162float(c);
}

// A float's bits as a signed integer in the floats' total order (-0 below
// +0, as jax.lax.top_k sorts): the same map as core/topk.float_order_key.
__device__ __forceinline__ long long order_key(float s) {
  const int b = __float_as_int(s);
  return static_cast<long long>(b < 0 ? (b ^ 0x7fffffff) : b);
}

// In-place descending bitonic sort of unique keys a[0:n], n a power of two.
__device__ void bitonic_sort_desc(long long* a, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const bool up = (i & k) != 0;      // descending overall
        const long long x = a[i], y = a[p];
        if ((x > y) == up) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncthreads();
    }
  }
}

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
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int d = threadIdx.x; d < D; d += blockDim.x) q[d] = queries[row * D + d];
  __syncthreads();

  for (int c = warp; c < C; c += kWarps) {
    const int id = cid[row * C + c];
    float s = -INFINITY;
    if (id >= 0 && cnt[row * C + c] >= tau) {     // uniform across the warp
      const T* crow = codes + static_cast<long long>(id) * D;
      const float* srow =
          scales ? scales + static_cast<long long>(id) * n_blocks : nullptr;
      float acc = 0.0f;
      for (int d = lane; d < D; d += 32) {
        float v = widen(crow[d]);
        if (srow) v *= srow[d / block];
        if (l2) {
          const float diff = q[d] - v;
          acc += diff * diff;
        } else {
          acc += q[d] * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      s = l2 ? -acc : acc;
    }
    if (lane == 0) score[c] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Cp; i += blockDim.x) {
    keys[i] = i < C ? order_key(score[i]) * (kLow + 1) + (kLow - i)
                    : LLONG_MIN;                  // pads rank below -inf
  }
  __syncthreads();
  bitonic_sort_desc(keys, Cp);

  for (int j = threadIdx.x; j < kp; j += blockDim.x) {
    const int pos = static_cast<int>(kLow - (keys[j] & kLow));
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
  int Cp = 1;
  while (Cp < C) Cp <<= 1;
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
