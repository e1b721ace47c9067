// Causal flash attention (forward), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/flash_attn.py
// (flash_attention, pallas_call at :85), the runtime path of the LM
// family's attend_train. That kernel walks a (B·H, S/tq, S/tk) grid with
// the KV axis minor and sequential, carrying a [tq, D] fp32 accumulator
// and the running max and sum in VMEM, and runs the tiles above the
// diagonal for nothing. Contract, shared with the plain version (ref.py):
// q [B, H, S, D], k, v [B, Hkv, S, D] with any strides (unit stride on D);
// query head h reads KV head h / (H / Hkv); scores q·k / sqrt(D) in fp32,
// causal by absolute position; online softmax; P cast to the input type
// before the PV product, which accumulates in fp32; out = acc / max(l,
// 1e-30) in q's type. No score tensor reaches device memory.
//
// What bounds it on the H100: operations. The causal half is 2·B·H·S²·D
// FLOP (QKᵀ and PV over the lower triangle): at gemma-7b's [1, 16, 32768,
// 256] 8.80e12, 8.89 ms at 989.4 TFLOP/s bf16, against 1.07 GB of q, k, v
// and o (0.32 ms at 3.35 TB/s).
//
// Design. bf16 (the model's path): a block of four warps owns 64 query
// rows (16 a warp) of one (batch, head) and walks the key tiles up to its
// last row only: the tiles above the diagonal are skipped, and the blocks
// are numbered longest first (query tile S/64 - 1 of every head before
// tile S/64 - 2) so that the causal triangle balances across the SMs.
// The head dimension is padded to DT in {64, 128, 256} (zeros in shared
// memory); key tiles are 64 wide (32 at DT = 256, to keep the [16, 256]
// fp32 accumulator and the score tile in registers). Q, K and V tiles come
// in by cp.async (16 bytes a thread, zero-filled past S and D): the next K
// tile loads while the softmax and PV run, the next V tile while QKᵀ runs.
// Both products are mma.sync m16n8k16 bf16 with fp32 accumulation, the
// operands read by ldmatrix (V transposed on the way: .trans); the score
// fragment becomes PV's A operand in registers. The running max and sum
// are per row in the log2 domain (exp2 of scores pre-scaled by
// log2(e)/sqrt(D)). fp32 (the tests' type): IEEE fp32 on the FMA units,
// no TF32: a warp owns two query rows, a lane one key of a 32-key tile
// for QKᵀ and 1/32 of D for PV. A simple tensor-core kernel: no wgmma,
// no TMA, no warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Operand {
  const void* ptr;
  long long sb, sh, ss;  // element strides of batch, head and position
};

struct Params {
  Operand q, k, v, o;
  int B, H, Hkv, S, D;
  int n_qtiles;
};

// The block's (batch, head, query tile): query tiles longest first, every
// head's tile t before any head's tile t - 1.
struct Work {
  int b, h, hk, qt;
};

__device__ __forceinline__ Work block_work(const Params& p) {
  const int bh_count = p.B * p.H;
  const int bh = blockIdx.x % bh_count;
  Work w;
  w.qt = p.n_qtiles - 1 - blockIdx.x / bh_count;
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.hk = w.h / (p.H / p.Hkv);
  return w;
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const Operand& x, int b, int h) {
  return static_cast<const T*>(x.ptr) + b * x.sb + h * x.sh;
}

// ------------------------------------------------------------------ bf16 --
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c[16x8] += a[16x16] · b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int DT>
struct Bf16Tile {
  static constexpr int kThreads = 128;
  static constexpr int BQ = 64;                  // query rows a block
  static constexpr int BK = DT >= 256 ? 32 : 64; // keys a tile
  static constexpr int LD = DT + 8;  // row stride in shared memory (bf16):
                                     // ldmatrix's 8 rows hit 8 bank groups
  static constexpr int kSmem = (BQ + 2 * BK) * LD * 2;
};

// rows [r0, r0 + ROWS) of one head's [S, D] operand into sm[ROWS][LD]
template <int ROWS, int DT, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g,
                                          long long ss, int r0, int S, int D,
                                          int tid, int nthreads) {
  constexpr int kChunks = DT / 8;  // 16-byte pieces a row
  for (int c = tid; c < ROWS * kChunks; c += nthreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < S && col < D;
    const __nv_bfloat16* src = ok ? g + (r0 + r) * ss + col : g;
    cp_async16(sm + r * LD + col, src, ok);
  }
}

template <int DT>
__global__ void __launch_bounds__(Bf16Tile<DT>::kThreads)
    flash_bf16_kernel(Params p) {
  using T = Bf16Tile<DT>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, NTH = T::kThreads;
  constexpr int NT = BK / 8;   // 8-key column tiles of a score tile
  constexpr int DN = DT / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const Work w = block_work(p);
  const __nv_bfloat16* qg = head_ptr<__nv_bfloat16>(p.q, w.b, w.h);
  const __nv_bfloat16* kg = head_ptr<__nv_bfloat16>(p.k, w.b, w.hk);
  const __nv_bfloat16* vg = head_ptr<__nv_bfloat16>(p.v, w.b, w.hk);
  const int q0 = w.qt * BQ;
  const int q_end = min(q0 + BQ, p.S);
  const int n_kt = (q_end + BK - 1) / BK;  // keys [0, q_end): causal
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(p.D));

  load_rows<BQ, DT, LD>(Qs, qg, p.q.ss, q0, p.S, p.D, tid, NTH);
  load_rows<BK, DT, LD>(Ks, kg, p.k.ss, 0, p.S, p.D, tid, NTH);
  cp_async_commit();
  load_rows<BK, DT, LD>(Vs, vg, p.v.ss, 0, p.S, p.D, tid, NTH);
  cp_async_commit();

  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  // rows row0 (fragment elements 0, 1) and row0 + 8 (elements 2, 3)
  const int row0 = q0 + warp * 16 + g;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  // this lane's ldmatrix row: matrix lane / 8, row lane % 8
  const int lrow = lane & 7, lsel1 = (lane >> 3) & 1, lsel2 = lane >> 4;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    cp_async_wait_but_one();  // Q and K_t have landed
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      unsigned a[4];  // rows +0/+8 x cols +0/+8
      ldsm_x4(a, Qs + (warp * 16 + lrow + lsel1 * 8) * LD + kk * 16 +
                     lsel2 * 8);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned b[4];  // keys nt·8 (d +0, +8), keys (nt+1)·8 (d +0, +8)
        ldsm_x4(b, Ks + (nt * 8 + lrow + lsel2 * 8) * LD + kk * 16 +
                       lsel1 * 8);
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with K_t
    if (t + 1 < n_kt)
      load_rows<BK, DT, LD>(Ks, kg, p.k.ss, k0 + BK, p.S, p.D, tid, NTH);
    cp_async_commit();

    // scale, mask (the diagonal and the ragged end), online softmax
    const bool masked = k0 + BK > q0 || k0 + BK > p.S;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int key = k0 + nt * 8 + tig * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key > row || key >= p.S) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a group hold one row's columns
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      // key 0 is in tile 0 for every row, so mx is finite from tile 0 on
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = pe;
        rsum[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait_but_one();  // V_t has landed
    __syncthreads();
    // O += P V: P (cast to bf16) from the score fragment, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        unsigned b[4];  // d dn·8 (keys +0, +8), d (dn+1)·8 (keys +0, +8)
        ldsm_x4_trans(b, Vs + (kk * 16 + lrow + lsel1 * 8) * LD + dn * 8 +
                             lsel2 * 8);
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with V_t
    if (t + 1 < n_kt)
      load_rows<BK, DT, LD>(Vs, vg, p.v.ss, k0 + BK, p.S, p.D, tid, NTH);
    cp_async_commit();
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(const_cast<void*>(p.o.ptr)) +
                      w.b * p.o.sb + w.h * p.o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.S) continue;
    __nv_bfloat16* orow = og + row * p.o.ss;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int col = dn * 8 + tig * 2;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[dn][2 * r] / l_run[r],
                                  acc[dn][2 * r + 1] / l_run[r]);
    }
  }
}

// ------------------------------------------------------------------ fp32 --
constexpr int kF32Warps = 8;
constexpr int kF32Rows = 2;                    // query rows a warp
constexpr int kF32BQ = kF32Warps * kF32Rows;   // 16 query rows a block
constexpr int kF32BK = 32;                     // keys a tile: one a lane
constexpr int kF32Cols = 8;                    // D / 32 output columns a lane

__host__ __device__ constexpr int f32_smem_floats(int D) {
  return kF32BQ * D + kF32BK * (D + 1) + kF32BK * D;
}

__global__ void __launch_bounds__(kF32Warps * 32)
    flash_f32_kernel(Params p) {
  extern __shared__ float fsm[];
  const int D = p.D;
  float* Qs = fsm;                 // [BQ][D]
  float* Ks = Qs + kF32BQ * D;     // [BK][D + 1]: lane j reads row j
  float* Vs = Ks + kF32BK * (D + 1);  // [BK][D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Work w = block_work(p);
  const float* qg = head_ptr<float>(p.q, w.b, w.h);
  const float* kg = head_ptr<float>(p.k, w.b, w.hk);
  const float* vg = head_ptr<float>(p.v, w.b, w.hk);
  const int q0 = w.qt * kF32BQ;
  const int q_end = min(q0 + kF32BQ, p.S);
  const int n_kt = (q_end + kF32BK - 1) / kF32BK;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  for (int i = tid; i < kF32BQ * D; i += kF32Warps * 32) {
    const int r = i / D, c = i % D;
    Qs[i] = q0 + r < p.S ? qg[(q0 + r) * p.q.ss + c] : 0.0f;
  }
  float acc[kF32Rows][kF32Cols];
  float m_run[kF32Rows], l_run[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) acc[r][c] = 0.0f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kF32BK;
    __syncthreads();  // the previous tile is consumed (and Q is in)
    for (int i = tid; i < kF32BK * D; i += kF32Warps * 32) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.S;
      Ks[r * (D + 1) + c] = ok ? kg[(k0 + r) * p.k.ss + c] : 0.0f;
      Vs[i] = ok ? vg[(k0 + r) * p.v.ss + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int row = q0 + warp * kF32Rows + r;
      if (row >= p.S || k0 > row) continue;  // warp-uniform
      const float* qr = Qs + (warp * kF32Rows + r) * D;
      const float* kr = Ks + lane * (D + 1);
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int key = k0 + lane;
      const float sc = key <= row && key < p.S ? dot * scale : -INFINITY;
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      const float pr = expf(sc - m_new);
      const float alpha = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      float ps = pr;
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l_run[r] = l_run[r] * alpha + ps;
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) acc[r][c] *= alpha;
      for (int j = 0; j < kF32BK; ++j) {
        const float pj = __shfl_sync(kFull, pr, j);
        const float* vr = Vs + j * D + lane;
#pragma unroll
        for (int c = 0; c < kF32Cols; ++c)
          if (lane + 32 * c < D) acc[r][c] = fmaf(pj, vr[32 * c], acc[r][c]);
      }
    }
  }

  float* og = static_cast<float*>(const_cast<void*>(p.o.ptr)) + w.b * p.o.sb +
              w.h * p.o.sh;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = q0 + warp * kF32Rows + r;
    if (row >= p.S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c)
      if (lane + 32 * c < D) og[row * p.o.ss + lane + 32 * c] = acc[r][c] / l;
  }
}

template <int DT>
cudaError_t launch_bf16(Params p, cudaStream_t stream) {
  using T = Bf16Tile<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return err;
  p.n_qtiles = (p.S + T::BQ - 1) / T::BQ;
  const long long blocks = static_cast<long long>(p.n_qtiles) * p.B * p.H;
  flash_bf16_kernel<DT><<<static_cast<unsigned>(blocks), T::kThreads,
                          T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32(Params p, cudaStream_t stream) {
  const int smem = f32_smem_floats(p.D) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.n_qtiles = (p.S + kF32BQ - 1) / kF32BQ;
  const long long blocks = static_cast<long long>(p.n_qtiles) * p.B * p.H;
  flash_f32_kernel<<<static_cast<unsigned>(blocks), kF32Warps * 32, smem,
                     stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers; bf16: 1 for bfloat16, 0 for float32;
// strides: element strides (batch, head, position) of q, k, v and o, 12
// values, on a host pointer; D a multiple of 16 in [16, 256], H a multiple
// of Hkv, 16-byte aligned rows (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                 void* o, int bf16, int B, int H, int Hkv,
                                 int S, int D, const long long* strides,
                                 void* stream) {
  if (D % 16 != 0 || D < 16 || D > 256 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const void* ptrs[4] = {q, k, v, o};
  Operand* ops[4] = {&p.q, &p.k, &p.v, &p.o};
  for (int i = 0; i < 4; ++i) {
    ops[i]->ptr = ptrs[i];
    ops[i]->sb = strides[3 * i];
    ops[i]->sh = strides[3 * i + 1];
    ops[i]->ss = strides[3 * i + 2];
  }
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.n_qtiles = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16)
    err = launch_f32(p, st);
  else if (D <= 64)
    err = launch_bf16<64>(p, st);
  else if (D <= 128)
    err = launch_bf16<128>(p, st);
  else
    err = launch_bf16<256>(p, st);
  return static_cast<int>(err);
}
