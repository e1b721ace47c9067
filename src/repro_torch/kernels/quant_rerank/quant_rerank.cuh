// Device routines of the quantized coarse rerank: scoring gathered rows
// against a query (a warp per row) and the packed-key top-k' of a score row,
// which the fused query kernel (mega_query.cu) runs; quant_rerank.cu takes
// the key packing (order_key, key_pos) and scores and selects its own way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "../freq_topc/freq_topc.cuh"

namespace irli {

constexpr long long kLow = 0xffffffffLL;

__device__ __forceinline__ float widen(int8_t c) {
  return static_cast<float>(c);
}
__device__ __forceinline__ float widen(__nv_bfloat16 c) {
  return __bfloat162float(c);
}
__device__ __forceinline__ float widen(float c) { return c; }

// A float's bits as a signed integer in the floats' total order (-0 below
// +0, as jax.lax.top_k sorts): the same map as core/topk.float_order_key.
__device__ __forceinline__ long long order_key(float s) {
  const int b = __float_as_int(s);
  return static_cast<long long>(b < 0 ? (b ^ 0x7fffffff) : b);
}

// One row against the query q[0:D], by one warp: consecutive lanes on
// consecutive elements, each widened (and scaled by srow[d / block] when
// srow is given), reduced with shuffles. Returns q·v (angular) or
// -Σ(q - v)² (l2) on every lane. row and srow are global memory that no
// thread writes during the launch: __ldg sends the random row gathers
// through the read-only data path, which a kernel's __restrict__
// parameters no longer select once this is a routine of its own.
template <typename T>
__device__ __forceinline__ float warp_row_score(const float* __restrict__ q,
                                                const T* __restrict__ row,
                                                const float* __restrict__ srow,
                                                int block, int D, int l2) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) {
    float v = widen(__ldg(row + d));
    if (srow) v *= __ldg(srow + d / block);
    if (l2) {
      const float diff = q[d] - v;
      acc += diff * diff;
    } else {
      acc += q[d] * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return l2 ? -acc : acc;
}

// score[c] for the C slots of one query, a warp per slot: slot c is valid
// when cid[c] >= 0 and (cnt == nullptr or cnt[c] >= tau); an invalid slot
// scores -inf. rows [L, D] of T, scales [L, n_blocks] or nullptr. The
// caller synchronises before reading score. No two of the arrays overlap
// (__restrict__), so the compiler may load the next slot's id and count
// before this slot's score is stored. Without the __restrict__ and __ldg
// here, moving this loop out of quant_rerank.cu made that kernel 45-55%
// slower on the H100 (PERF.md).
template <typename T>
__device__ __forceinline__ void score_slots(
    const float* __restrict__ q, const T* __restrict__ rows,
    const float* __restrict__ scales, int n_blocks, int block, int D,
    const int* __restrict__ cid, const float* __restrict__ cnt, float tau,
    int C, int l2, float* __restrict__ score) {
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int c = warp; c < C; c += n_warps) {
    const int id = cid[c];
    float s = -INFINITY;
    if (id >= 0 && (cnt == nullptr || cnt[c] >= tau)) {   // warp-uniform
      const long long r = id;
      s = warp_row_score(q, rows + r * D,
                         scales ? scales + r * n_blocks : nullptr, block, D,
                         l2);
    }
    if ((threadIdx.x & 31) == 0) score[c] = s;
  }
}

// Sort the C scores' packed keys order(score)·2^32 + (2^32-1-position),
// padded to Cp (a power of two >= C) with keys below -inf, descending in
// keys[0:Cp]: keys[j] is the j-th best slot, the smaller position first on
// equal scores. Reads score after a barrier; every thread must call it.
__device__ __forceinline__ void sort_score_keys(const float* score, int C,
                                                int Cp, long long* keys) {
  __syncthreads();
  for (int i = threadIdx.x; i < Cp; i += blockDim.x) {
    keys[i] = i < C ? order_key(score[i]) * (kLow + 1) + (kLow - i)
                    : LLONG_MIN;
  }
  __syncthreads();
  bitonic_sort<true>(keys, Cp);
}

// The slot position a sorted key encodes.
__device__ __forceinline__ int key_pos(long long key) {
  return static_cast<int>(kLow - (key & kLow));
}

__host__ __device__ __forceinline__ int pow2_at_least(int c) {
  int p = 1;
  while (p < c) p <<= 1;
  return p;
}

}  // namespace irli
