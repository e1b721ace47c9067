// Fused scorer output GEMM + running top-m (+ log-sum-exp) over buckets,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/irli_topk/irli_topk.py
// (irli_topk, pallas_call at :92; its merge _topk_merge at :26). It computes
// logits = h @ w2 + b2 per rep and keeps the top-m buckets of every query
// row without writing the logits: at the irli-deep1b widths (R = 32,
// Q = 1024, H = 1024, B = 20000) those are 2.62 GB. Contract, shared with
// the plain version (ref.py): vals [.., Q, m] f32 descending, idx int32,
// jax.lax.top_k's ties (the smaller index first, -0.0 below +0.0); lse
// [.., Q] f32 = log Σ_b exp(logit) when asked (the adaptive-m keep mask).
// The fp32 sums run in k order on the FMA units, another order than
// cuBLAS's, so logits agree with the plain version's to ~1e-6 relative and
// a row whose m-th and (m+1)-th logits lie that close may pick the other.
//
// What bounds it on the H100: operations. 2·R·Q·H·B = 1.342 TFLOP at the
// cell; fp32 outside the tensor cores (67 TFLOP/s) gives 20.0 ms. TF32 or
// bf16 tensor cores would move the top-m choice off the reference, so the
// kernel stays on the FMA units (bf16 inputs are widened and summed in
// fp32). Its bytes (w2 read once, 2.62 GB) take 0.78 ms.
//
// Design: one block of 256 threads per (rep, 128-query tile); grid
// (ceil(Q/128), R), the query tiles fastest, so the 8 blocks of one rep run
// side by side and read the same w2 slices while they sit in the 50 MB L2:
// each block reads its rep's whole w2 (82 MB), 8 · 2.62 = 21 GB from L2 at
// the cell, but device memory serves w2 about once. A block walks all B in
// 128-wide tiles (the TPU grid's sequential B axis becomes this loop):
// gemm_tile (irli_topk.cuh) accumulates the 128 x 128 logit tile in
// registers (8 x 8 a thread, 8-deep double-buffered slices), then the tile
// goes through shared memory into the running top-m lists. At m = 5 a block
// holds 94 KB of shared memory, so two blocks share an SM (256 blocks, one
// wave on 132 SMs). Tensor-core-free register blocking is the simple first
// step; a faster kernel (TMA-fed slices, a wider tile) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "irli_topk.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(irli::kTileThreads, 2)
    irli_topk_kernel(const T* h, const T* w2, const T* b2, int Q, int H,
                     int B, int m, float* vals, int* idx, float* lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g = blockIdx.y;
  irli::scorer_topk_tile(h + g * Q * H, w2 + g * H * B, b2 + g * B, Q, B, H,
                         m, blockIdx.x * irli::kBM, vals + g * Q * m,
                         idx + g * Q * m, lse ? lse + g * Q : nullptr,
                         reinterpret_cast<float*>(smem), 1);
}

template <typename T>
int launch(const void* h, const void* w2, const void* b2, int G, int Q,
           int H, int B, int m, float* vals, int* idx, float* lse,
           cudaStream_t stream) {
  const int smem = irli::topk_tile_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      irli_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + irli::kBM - 1) / irli::kBM, G);
  irli_topk_kernel<T><<<grid, irli::kTileThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2),
      static_cast<const T*>(b2), Q, H, B, m, vals, idx, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [G, Q, H], w2 [G, H, B], b2 [G, B], all float32 (dtype 0) or bf16 (1);
// 1 <= m <= min(B, 64); G <= 65535. vals [G, Q, m] f32, idx [G, Q, m]
// int32, lse [G, Q] f32 or NULL. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int irli_topk_launch(const void* h, const void* w2, const void* b2,
                                int dtype, int G, int Q, int H, int B, int m,
                                float* vals, int* idx, float* lse,
                                void* stream) {
  if (G < 1 || G > 65535 || H < 1 || m < 1 || m > irli::kMaxM || m > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(h, w2, b2, G, Q, H, B, m, vals, idx, lse, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(h, w2, b2, G, Q, H, B, m, vals, idx, lse, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
