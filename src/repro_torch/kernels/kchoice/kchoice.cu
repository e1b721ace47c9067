// Exact power-of-K re-assignment (Alg. 1's re-partition, Thm. 2's process),
// hand-written for Hopper (sm_90a).
//
// There is no TPU kernel to replace: the reference runs this step as a
// lax.scan over the labels (src/repro/core/repartition.py kchoice_exact,
// the scan at :93), which XLA compiles to a sequential loop. Its semantics,
// shared with the plain version (ref.py): labels are taken in the given
// insertion order; each goes to the FIRST of its K candidate buckets (in
// descending affinity) that holds the least float32 load, and that load
// grows by the label's weight. Bit for bit: the same adds in the same order.
//
// What bounds it on the H100: neither the bytes nor the count of operations
// but the chain of L dependent steps per rep (each step reads loads the
// previous one may have written). Its bytes (the [R, L, K] candidates, the
// order, the assignment: 201 MB at R = 32, L = 131072, K = 10) take 0.06 ms;
// each step chains at least one shared-memory read-add-write (its read
// waits for the last step's write) and ceil(log2 K) levels of a
// shuffle-and-min reduction. kchoice_step_cycles measures those two
// latencies on the card, so the bound is L x (read-add-write +
// ceil(log2 K) levels) / the SM clock.
//
// Design: one block of 256 threads per rep; the rep's [B] loads sit in
// shared memory (80 KB at B = 20000). Warp 0 walks the labels: its lanes
// read the label's K candidates' loads, reduce (load, choice rank)
// lexicographically with shuffles, and lane 0 adds the weight and writes the
// assignment. Meanwhile warps 1-7 gather the next chunk of 256 labels'
// candidate rows (in insertion order) from device memory into the other half
// of a double buffer, so the walk never waits on device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;   // labels per staged chunk

__device__ void stage_chunk(const int* __restrict__ topk,
                            const int* __restrict__ order, long long g,
                            int L, int K, int c, int* cand, int* lbl,
                            int t0, int nt) {
  const int s0 = c * kChunk;
  const int n = min(kChunk, L - s0);
  for (int i = threadIdx.x - t0; i < n * K; i += nt) {
    const int s = i / K, j = i - s * K;
    const int l = order[g * L + s0 + s];
    if (j == 0) lbl[s] = l;
    cand[i] = topk[(g * L + l) * K + j];
  }
}

__global__ void __launch_bounds__(kThreads)
    kchoice_kernel(const int* __restrict__ topk, const int* __restrict__ order,
                   const float* __restrict__ load0, long long load0_stride,
                   const float* __restrict__ w, int L, int K, int B,
                   int* __restrict__ assign) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* loads = reinterpret_cast<float*>(smem);                 // [B]
  int* cand = reinterpret_cast<int*>(loads + B);                 // [2][chunk·K]
  int* lbl = cand + 2 * kChunk * K;                              // [2][chunk]
  const long long g = blockIdx.x;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    loads[i] = load0 ? load0[g * load0_stride + i] : 0.0f;
  }
  stage_chunk(topk, order, g, L, K, 0, cand, lbl, 0, blockDim.x);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    const int* cc = cand + cur * kChunk * K;
    const int* cl = lbl + cur * kChunk;
    if (warp == 0) {
      const int n = min(kChunk, L - c * kChunk);
      for (int s = 0; s < n; ++s) {
        const int* row = cc + s * K;
        float best = INFINITY;
        int bj = 0x7fffffff;
        for (int j = lane; j < K; j += 32) {   // ascending: strict < keeps
          const float v = loads[row[j]];       // the first of equal loads
          if (v < best) {
            best = v;
            bj = j;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, o);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
          if (ov < best || (ov == best && oj < bj)) {
            best = ov;
            bj = oj;
          }
        }
        if (lane == 0) {
          const int b = row[bj];
          const int l = cl[s];
          loads[b] += w ? w[l] : 1.0f;
          assign[g * L + l] = b;
        }
        __syncwarp();
      }
    } else if (c + 1 < n_chunks) {
      stage_chunk(topk, order, g, L, K, c + 1,
                  cand + (cur ^ 1) * kChunk * K, lbl + (cur ^ 1) * kChunk, 32,
                  blockDim.x - 32);
    }
    __syncthreads();
  }
}

// The latencies (SM clocks) of the step's dependent operations, each timed
// with clock64 over a chain of n on one warp: out[0] a shared-memory
// read-add-write whose read waits for the last write, out[1] one level of a
// shuffle-and-min reduction. Volatile stores close each chain before the
// clock is read.
__global__ void latency_kernel(int n, long long* out) {
  __shared__ float acc[32];
  __shared__ float sink[32];
  volatile float* va = acc;
  volatile float* vs = sink;
  const int lane = threadIdx.x;
  va[lane] = 0.0f;
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) va[lane] = va[lane] + 1.0f;
  const long long t1 = clock64();
  float v = va[lane];
  const long long t2 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  vs[lane] = v;
  const long long t3 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t3 - t2;
  }
}

}  // namespace

// SM clocks a step of the walk chains at the least: rmw and level (one
// each), measured over n-long chains on the card. Returns cudaError_t.
extern "C" int kchoice_step_cycles(int n, double* rmw, double* level) {
  long long* d = nullptr;
  long long h[2] = {0, 0};
  cudaError_t err = cudaMalloc(&d, sizeof(h));
  if (err != cudaSuccess) return static_cast<int>(err);
  latency_kernel<<<1, 32>>>(n, d);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  }
  cudaFree(d);
  *rmw = static_cast<double>(h[0]) / n;
  *level = static_cast<double>(h[1]) / n;
  return static_cast<int>(err);
}

// Shared memory the kernel needs at (B, K).
extern "C" long long kchoice_smem_bytes(int B, int K) {
  return (static_cast<long long>(B) + 2LL * kChunk * (K + 1)) * 4;
}

// topk [G, L, K] int32 bucket ids (each < B); order [G, L] int32, a
// permutation of 0..L-1 per rep; load0 [G, B] f32 (load0_stride B), one [B]
// row for every rep (stride 0) or NULL (zeros); w [L] f32 or NULL (ones).
// assign [G, L] int32. Returns cudaGetLastError() after the launch.
extern "C" int kchoice_launch(const int* topk, const int* order,
                              const float* load0, long long load0_stride,
                              const float* w, int G, int L, int K, int B,
                              int* assign, void* stream) {
  if (G < 1 || L < 1 || K < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = kchoice_smem_bytes(B, K);
  cudaError_t err = cudaFuncSetAttribute(
      kchoice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kchoice_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      topk, order, load0, load0_stride, w, L, K, B, assign);
  return static_cast<int>(cudaGetLastError());
}
