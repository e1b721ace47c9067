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
//
// m > 64 (the lists above hold 64; the fit's affinity asks for K of them):
// irli_topk_wide_kernel, a persistent grid of 256-thread blocks, each
// walking (rep, 128-query) tiles with the same gemm_tile. A block writes its
// tile's 128 x B logits into its own slab of scratch (grid x 128 x B fp32,
// bounded by the grid, not by Q: 1.35 GB at B = 20000 on 132 SMs, where the
// [R, Q, B] logits at the cell are 2.62 GB and the fit's [R, chunk, B] block
// 168 GB), then selects each row's top-m there: a 4-pass radix select of the
// m-th largest key (8-bit digits of the floats' total order, a 256-bin
// shared histogram), then each key at or above it is ranked by one warp
// counting the row's larger keys and the equal keys at smaller columns —
// jax.lax.top_k's order, written straight to its output slot. The ranking
// costs O(m·B) a row: right for any 1 <= m <= B, fast only for small m.
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

__device__ __forceinline__ unsigned ukey(float v) {
  return static_cast<unsigned>(irli::fkey(v)) ^ 0x80000000u;
}

// The top-m of one row x[0:B] (global memory this block wrote) by the whole
// block: out_v / out_i [m] in jax.lax.top_k's order, out_lse the row's
// log-sum-exp when asked. hist holds 256 counters, sh 2, red 8 floats.
__device__ void select_row(const float* x, int B, int m, float* out_v,
                           int* out_i, float* out_lse, unsigned* hist,
                           unsigned* sh, float* red) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31;
  unsigned prefix = 0, mask = 0, remaining = m;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += nt) hist[i] = 0;
    __syncthreads();
    for (int c = t; c < B; c += nt) {
      const unsigned u = ukey(x[c]);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (t == 0) {
      unsigned rem = remaining;
      int d = 255;
      for (; d > 0; --d) {
        if (hist[d] >= rem) break;
        rem -= hist[d];
      }
      sh[0] = prefix | (static_cast<unsigned>(d) << shift);
      sh[1] = rem;
    }
    __syncthreads();
    prefix = sh[0];
    remaining = sh[1];
    mask |= 255u << shift;
  }
  // prefix is the m-th largest key: every key above it is taken, and the
  // keys equal to it at the smallest columns. A key's slot is its rank.
  for (int c0 = warp * 32; c0 < B; c0 += nt) {
    const int c = c0 + lane;
    const unsigned u = c < B ? ukey(x[c]) : 0u;
    unsigned ball = __ballot_sync(0xffffffffu, c < B && u >= prefix);
    while (ball) {
      const int src = __ffs(ball) - 1;
      ball &= ball - 1;
      const unsigned uc = __shfl_sync(0xffffffffu, u, src);
      const int cc = c0 + src;
      int cnt = 0;
      for (int j = lane; j < B; j += 32) {
        const unsigned v = ukey(x[j]);
        cnt += (v > uc) || (v == uc && j < cc);
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0 && cnt < m) {
        out_v[cnt] = x[cc];
        out_i[cnt] = cc;
      }
    }
  }
  if (out_lse != nullptr) {
    float mx = -INFINITY;
    for (int c = t; c < B; c += nt) mx = fmaxf(mx, x[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
    for (int i = 1; i < (nt >> 5); ++i) mx = fmaxf(mx, red[i]);
    __syncthreads();
    float se = 0.0f;
    if (mx != -INFINITY) {
      for (int c = t; c < B; c += nt) se += expf(x[c] - mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      se += __shfl_xor_sync(0xffffffffu, se, o);
    if (lane == 0) red[warp] = se;
    __syncthreads();
    if (t == 0) {
      float s = 0.0f;
      for (int i = 0; i < (nt >> 5); ++i) s += red[i];
      *out_lse = mx == -INFINITY ? -INFINITY : mx + logf(s);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(irli::kTileThreads)
    irli_topk_wide_kernel(const T* h, const T* w2, const T* b2, int G, int Q,
                          int H, int B, int m, float* vals, int* idx,
                          float* lse, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[2];
  __shared__ float red[irli::kTileThreads / 32];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + irli::kAsFloats;
  float* slab = scratch + static_cast<long long>(blockIdx.x) * irli::kBM * B;
  const int lt = threadIdx.x;
  const int ty = lt >> 4, tx = lt & 15;
  const int n_qt = (Q + irli::kBM - 1) / irli::kBM;
  const long long n_tiles = static_cast<long long>(G) * n_qt;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long g = tile / n_qt;
    const int row0 = static_cast<int>(tile % n_qt) * irli::kBM;
    const T* hg = h + g * Q * H;
    const T* wg = w2 + g * H * B;
    const T* bg = b2 + g * B;
    for (int col0 = 0; col0 < B; col0 += irli::kBN) {
      float acc[8][8];
      irli::gemm_tile(hg, H, wg, B, Q, B, H, row0, col0, As, Bs, 1, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + irli::tile_off(j, tx);
        if (col < B) {
          const float bias = irli::widen(bg[col]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            slab[static_cast<long long>(irli::tile_off(i, ty)) * B + col] =
                acc[i][j] + bias;
          }
        }
      }
    }
    __syncthreads();
    const int n_rows = min(irli::kBM, Q - row0);
    for (int r = 0; r < n_rows; ++r) {
      const long long orow = g * Q + row0 + r;
      select_row(slab + static_cast<long long>(r) * B, B, m, vals + orow * m,
                 idx + orow * m, lse ? lse + orow : nullptr, hist, sh, red);
    }
  }
}

template <typename T>
int launch_wide(const void* h, const void* w2, const void* b2, int G, int Q,
                int H, int B, int m, float* vals, int* idx, float* lse,
                float* scratch, int grid, cudaStream_t stream) {
  const int smem = irli::gemm_smem_bytes();
  irli_topk_wide_kernel<T><<<grid, irli::kTileThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2),
      static_cast<const T*>(b2), G, Q, H, B, m, vals, idx, lse, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Any 1 <= m <= B (meant for m > 64): as irli_topk_launch, with scratch
// [grid, 128, B] f32 and grid >= 1 persistent blocks. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int irli_topk_wide_launch(const void* h, const void* w2,
                                     const void* b2, int dtype, int G, int Q,
                                     int H, int B, int m, float* vals,
                                     int* idx, float* lse, float* scratch,
                                     int grid, void* stream) {
  if (G < 1 || H < 1 || m < 1 || m > B || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_wide<float>(h, w2, b2, G, Q, H, B, m, vals, idx, lse,
                              scratch, grid, s);
  }
  if (dtype == 1) {
    return launch_wide<__nv_bfloat16>(h, w2, b2, G, Q, H, B, m, vals, idx,
                                      lse, scratch, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
