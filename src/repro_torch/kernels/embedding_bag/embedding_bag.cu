// EmbeddingBag: the weighted sum of each bag's table rows, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py:49
// (embedding_bag, pallas_call at :57), which keeps a tile of bags in VMEM,
// their ids in scalar memory, and loads one table row at a time from HBM.
// Contract, shared with the plain version (ref.py): ids [N, P] int32 (a
// negative id is a pad), weights [N, P] fp32, table [V, D] fp32 or bf16 ->
// out [N, D] in the table's dtype, out[n] = Σ_p w[n, p] · table[ids[n, p]]
// over the slots with an id >= 0, accumulated in fp32 in slot order and
// rounded once to the table's dtype. A pad adds nothing; a slot with weight
// 0 adds 0·row, as the reference does. An id >= V (which the plain version
// refuses) adds nothing: the kernel reads no row outside the table.
//
// What bounds it on the H100: bytes. It reads ids and weights once (8 B a
// slot), each distinct table row it touches, and writes the output once.
// At DIEN's serve_bulk history (N = 262,144 bags of P = 100 over the
// 1,048,576 x 18 fp32 item table, Zipf ids: 928,061 distinct rows in
// chip_smoke.py's batch) that is 0.21 GB of ids and weights, 67 MB of rows
// and 19 MB of output: 0.088 ms at 3.35 TB/s. Its 2·N·P·D flops are
// nothing beside that.
//
// Design: one warp a bag, the warps striding over the bags, so no bag is
// split across blocks: no atomics, and the result is the same from run to
// run. The warp reads 32 of the bag's ids and weights at once (coalesced),
// zeroes the weight of a pad, and hands them round with __shfl_sync; the
// lanes cover D in steps of 32 and walk the slots in order, each lane one
// fp32 accumulator, so a row is read by neighbouring lanes at neighbouring
// addresses. The slot loop is unrolled so that several rows are in flight
// a lane: the rows are the latency, and Zipf ids make the hot ones L2 hits.
// Rows of D = 18 are 72 bytes (36 in bf16), not 16-byte aligned, so loads
// are scalar. Row offsets are 64-bit (id · D passes 2^31 on DLRM's tables).
// At D = 18 14 of 32 lanes idle: packing two slots a warp is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const int* __restrict__ ids,
                         const float* __restrict__ weights,
                         const T* __restrict__ table, long long n_bags,
                         int P, long long V, int D, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       bag < n_bags; bag += n_warps) {
    const int* bag_ids = ids + bag * P;
    const float* bag_w = weights + bag * P;
    T* row_out = out + bag * D;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      const bool col = d < D;
      float acc = 0.0f;
      for (int p0 = 0; p0 < P; p0 += 32) {
        int my_id = -1;
        float my_w = 0.0f;
        if (p0 + lane < P) {
          my_id = bag_ids[p0 + lane];
          my_w = bag_w[p0 + lane];
        }
        if (my_id < 0 || my_id >= V) {
          my_id = -1;
          my_w = 0.0f;
        }
        const int n = min(32, P - p0);
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const int id = __shfl_sync(kFull, my_id, j);
          const float w = __shfl_sync(kFull, my_w, j);
          const float r = (col && id >= 0)
                              ? to_float(table[(long long)id * D + d])
                              : 0.0f;
          acc = fmaf(w, r, acc);
        }
      }
      if (col) row_out[d] = from_float<T>(acc);
    }
  }
}

template <typename T>
int launch(const int* ids, const float* weights, const void* table,
           long long n_bags, int P, long long V, int D, void* out,
           cudaStream_t s) {
  const long long want = (n_bags + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  embedding_bag_kernel<T><<<grid, kThreads, 0, s>>>(
      ids, weights, static_cast<const T*>(table), n_bags, P, V, D,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids, weights [n_bags, P] (int32, fp32), table [V, D] and out [n_bags, D]
// row-major and contiguous; dtype 0 = fp32 table and output, 1 = bf16.
// n_bags >= 1, P >= 0, D >= 1. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int embedding_bag_launch(const int* ids, const float* weights,
                                    const void* table, long long n_bags,
                                    int P, long long V, int D, int dtype,
                                    void* out, void* stream) {
  if (n_bags < 1 || P < 0 || V < 0 || D < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(ids, weights, table, n_bags, P, V, D, out, s);
  }
  return launch<__nv_bfloat16>(ids, weights, table, n_bags, P, V, D, out, s);
}
