// FrequentOnes top-C: per-row sort + run-length count + the C most frequent
// candidate ids, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/freq_topc/freq_topc.py
// (freq_topc, pallas_call at :144; tile body freq_topc_tile). Output is
// bit-identical to it and to the plain version (ref.py): ids [Q, C] int32
// by count descending, ties toward the smaller id, -1 past the distinct
// candidate count; counts [Q, C] float32, 0 there.
//
// What bounds it on the H100: memory says ~42 us for [1024, 32000] (the
// input read once, the outputs written once, at 3.35 TB/s), but the two
// bitonic sorts are log2(n)·(log2(n)+1)/2 = 120 shared-memory passes over a
// 32768-wide row each, so the shared-memory traffic and the __syncthreads
// between passes bound it, not device memory.
//
// Design: one CTA of up to 1024 threads per query row. The sort, the run
// count and the key decode are device routines of freq_topc.cuh, which the
// fused query kernel (mega_query.cu) shares.
//   1. The row is padded to n (a power of two, n <= 32768) with INT32_MAX
//      in place of every pad (-1), and sorted ascending in shared memory.
//      A 32768-wide row is 128 KB: it fits one of the 227 KB a block may
//      use (dynamic shared memory, opted in above 48 KB), but the row and a
//      second key row (256 KB) would not.
//   2. The sorted ids go to a global scratch row that the wrapper allocates,
//      so the same shared buffer can hold the keys next.
//   3. Each run start i gets its run length by a binary search for the end
//      of its run, and every position the packed key cnt·n + (n-1-i) — the
//      TPU kernel's key: unique, and count <= C0 <= n keeps it in int32. The
//      keys are kept in registers (at most 32 a thread) until the buffer is
//      free, then written back to shared memory. A block of 1024 threads
//      allows 64 registers a thread (__launch_bounds__ holds ptxas to it).
//   4. A second bitonic pass sorts the keys descending; slot j decodes
//      count = key / n and position = n-1 - key % n, and reads the id from
//      the scratch row.
// Faster sorts (warp-level stages in registers, fewer block barriers) are
// left for a later change.
#include <cuda_runtime.h>
#include <limits.h>

#include "freq_topc.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWidth = 32768;
constexpr int kMaxPerThread = kMaxWidth / kMaxThreads;   // 32

// 1024 threads leave 64 registers a thread: the bound makes ptxas keep to
// it (the key array may spill to local memory, which L1 caches).
__global__ void __launch_bounds__(kMaxThreads)
    freq_topc_kernel(const int* __restrict__ cands, int C0, int n, int C,
                     int* __restrict__ sorted, int* __restrict__ out_ids,
                     float* __restrict__ out_cnt) {
  extern __shared__ int a[];
  const long long row = blockIdx.x;
  const int* src = cands + row * C0;
  int* srt = sorted + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i < C0 ? src[i] : -1;
    a[i] = v < 0 ? INT_MAX : v;
  }
  __syncthreads();
  irli::bitonic_sort<false>(a, n);

  int keys[kMaxPerThread];
#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i < n) {
      srt[i] = a[i];
      keys[r] = irli::run_key(a, i, n);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i < n) a[i] = keys[r];
  }
  __syncthreads();
  irli::bitonic_sort<true>(a, n);

  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    int id, cnt;
    irli::decode_slot(a, srt, j, n, &id, &cnt);
    out_ids[row * C + j] = id;
    out_cnt[row * C + j] = static_cast<float>(cnt);
  }
}

}  // namespace

// cands [Q, C0] int32 (pad -1); n: a power of two with C0 <= n <= 32768;
// sorted: [Q, n] int32 scratch; out_ids [Q, C] int32, out_cnt [Q, C] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int freq_topc_launch(const int* cands, int Q, int C0, int n, int C,
                                int* sorted, int* out_ids, float* out_cnt,
                                void* stream) {
  if (n < 1 || n > kMaxWidth || (n & (n - 1)) != 0 || C0 > n || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  const int threads = n < kMaxThreads ? n : kMaxThreads;
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      freq_topc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  freq_topc_kernel<<<Q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cands, C0, n, C, sorted, out_ids, out_cnt);
  return static_cast<int>(cudaGetLastError());
}
