// Fused sigmoid-BCE loss + gradient over [rows, B] fp32 logits, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bce_logits/bce_logits.py
// (bce_logits, pallas_call at :39; body _kernel at :21). Per element, one
// pass computes the stable loss max(x, 0) - x·y + log1p(exp(-|x|)) and the
// gradient σ(x) - y, and writes the gradient scaled by w[row mod n] · scale;
// the loss, weighted the same way, goes to one partial sum per block. With
// unit weights and scale 1/N it is the TPU kernel's (mean loss, dlogits / N).
// The fit runs it on its [R, N, B] logits viewed as [R·N, B], with the
// batch's row weights (0 on the tail batch's padding rows) and scale
// 1/(R·max(Σw, 1)): the loss of one train step and its gradient in one pass.
//
// What bounds it on the H100: device memory. It reads 8 B and writes 4 B an
// element (logits, targets in; gradient out): 12 B · 2.62e9 = 31.5 GB at the
// fit step (R = 32, batch 4096, B = 20000), 9.4 ms at 3.35 TB/s. Its ~20
// flops an element are far below the fp32 rate.
//
// Design: a fixed grid of blocks walks the rows (block b takes rows b,
// b + grid, ...), 256 threads across a row in float4s when B % 4 == 0 (the
// rows then start 16-byte aligned), scalar otherwise. Each thread sums its
// elements' weighted loss in double; the block reduces in a fixed order
// into partials[b]; a second one-block kernel sums the partials in a fixed
// order and writes the fp32 loss. No float atomics: the loss is the same
// from run to run. expf / log1pf, not the fast intrinsics, so the gradient
// is within a few ulp of the plain version (torch.sigmoid).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct Elem {
  float loss;
  float sig;
};

__device__ __forceinline__ Elem bce(float x) {
  const float e = expf(-fabsf(x));
  const float inv = 1.0f / (1.0f + e);
  return {fmaxf(x, 0.0f) + log1pf(e), x >= 0.0f ? inv : e * inv};
}

__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (blockDim.x >> 5); ++i) s += red[i];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    bce_logits_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ w, int n_w, long long rows,
                      int B, float scale, float* __restrict__ grad,
                      double* __restrict__ partials) {
  __shared__ double red[kThreads / 32];
  double acc = 0.0;
  const bool vec = (B & 3) == 0;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float wr = w ? w[r % n_w] : 1.0f;
    const float gs = wr * scale;
    const long long base = r * B;
    double row = 0.0;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(x + base);
      const float4* y4 = reinterpret_cast<const float4*>(y + base);
      float4* g4 = reinterpret_cast<float4*>(grad + base);
      for (int c = threadIdx.x; c < (B >> 2); c += kThreads) {
        const float4 xv = x4[c], yv = y4[c];
        const Elem a = bce(xv.x), b = bce(xv.y), d = bce(xv.z), f = bce(xv.w);
        row += (double)(a.loss - xv.x * yv.x) + (double)(b.loss - xv.y * yv.y) +
               (double)(d.loss - xv.z * yv.z) + (double)(f.loss - xv.w * yv.w);
        g4[c] = make_float4((a.sig - yv.x) * gs, (b.sig - yv.y) * gs,
                            (d.sig - yv.z) * gs, (f.sig - yv.w) * gs);
      }
    } else {
      for (int c = threadIdx.x; c < B; c += kThreads) {
        const float xv = x[base + c], yv = y[base + c];
        const Elem a = bce(xv);
        row += (double)(a.loss - xv * yv);
        grad[base + c] = (a.sig - yv) * gs;
      }
    }
    acc += row * (double)wr;
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const double* __restrict__ partials, int n,
                        double scale, float* __restrict__ loss) {
  __shared__ double red[kThreads / 32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) *loss = static_cast<float>(s * scale);
}

}  // namespace

// The grid the kernel runs for `rows` rows; the caller allocates that many
// double partials.
extern "C" int bce_logits_grid(long long rows) {
  return static_cast<int>(rows < kMaxBlocks ? (rows > 0 ? rows : 1)
                                            : kMaxBlocks);
}

// x, y, grad [rows, B] f32, row-major, 16-byte aligned; w [n_w] f32 or NULL
// (unit weights); partials [bce_logits_grid(rows)] doubles of scratch; loss
// one f32. loss = scale · Σ_r w[r mod n_w] · Σ_b bce(x, y), grad = scale ·
// w[r mod n_w] · (σ(x) - y). Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int bce_logits_launch(const float* x, const float* y,
                                 const float* w, int n_w, long long rows,
                                 int B, double scale, float* grad,
                                 double* partials, float* loss,
                                 void* stream) {
  if (rows < 1 || B < 1 || (w != nullptr && (n_w < 1 || rows % n_w != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = bce_logits_grid(rows);
  bce_logits_kernel<<<grid, kThreads, 0, s>>>(
      x, y, w, w ? n_w : 1, rows, B, static_cast<float>(scale), grad,
      partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, grid, scale, loss);
  return static_cast<int>(cudaGetLastError());
}
