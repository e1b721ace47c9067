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
// and o (0.32 ms at 3.35 TB/s). Only wgmma reaches that rate, and only if
// the tensor cores never wait for a load, a barrier or the softmax.
//
// Design, bf16 (the model's path; flash_bf16_wgmma_kernel). A block of
// three warpgroups owns BQ = 128 query rows of one (batch, head):
// - A producer warpgroup gives its registers away (setmaxnreg.dec to 24)
//   and one of its threads issues every load by TMA: the block's Q tile
//   once, then the K and V tiles of BK keys into a ring of two stages,
//   each guarded by a full and an empty mbarrier. Only the key tiles up to
//   the block's last row are loaded: none above the diagonal.
// - Two consumer warpgroups (setmaxnreg.inc to 240) own 64 query rows
//   each. S = Q·Kᵀ is wgmma m64nBKk16 with both operands K-major in shared
//   memory; O += P·V is wgmma m64nDTk16 with P from registers (the fp32
//   score fragment rounded to bf16 is already the A-operand layout) and V
//   MN-major (the transpose bit). The [64, DT] fp32 accumulator stays in
//   registers: 128 a thread at DT = 256, no spills.
// - Within a consumer, tile t's QKᵀ and tile t-1's PV are issued together
//   and tile t's softmax runs while that PV does. Across consumers (FA3's
//   ping-pong), named barriers make them issue their wgmma in turns, so
//   one's softmax runs while the other's products hold the tensor cores.
//   A consumer frees a stage (one arrival a warp) only after the wgmma
//   that read it has completed.
// - Tiles are [rows, 64]-column boxes with the 128-byte swizzle, which the
//   wgmma descriptors repeat; 4-D tensor maps over (D, S, heads, B) take
//   the caller's strides, so [B, S, H, D] views are read in place, rows
//   past S and columns past D come in as zeros, and a tile never reads the
//   next head. D is padded to DT in {64, 128, 256}.
// - The softmax runs in the log2 domain: one FFMA a score (scale
//   log2(e)/sqrt(D), minus the running max) and ex2.approx; a row's max
//   is reduced over the four lanes that hold it; only tiles that cross the
//   diagonal are masked; a warp skips the rescale of O when none of its
//   rows' max moved. Blocks go longest first (block_work).
// - The output goes out through shared memory (each consumer's own Q rows)
//   by a TMA store, so a block leaves while its bytes are in flight.
// BK = 64 at DT = 256 (Q 64 KB + 2 stages x (32 + 32) KB = 192 KB of
// shared memory), BK = 128 below (DT = 128: 160 KB; DT = 64: 80 KB). At
// DT = 256 the shared-memory traffic of a 64-key tile pair (both
// consumers' QKᵀ operands, 128 KB; PV's V, 64 KB; the TMA writes, 64 KB)
// at 128 bytes a clock takes about as long as its wgmma: that, not the
// loads, caps this design below the peak (PERF.md).
// The launch geometry is computed once, in Python (ops.flash_plan); the C
// entry checks it against the constants here.
//
// fp32 (the tests' type): IEEE fp32 on the FMA units, no TF32: a warp owns
// two query rows, a lane one key of a 32-key tile for QKᵀ and 1/32 of D for
// PV.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;

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
template <int DT>
struct Bf16Tile {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int BK = DT >= 256 ? 64 : 128; // keys a tile
  static constexpr int kStages = 2;               // K and V ring depth
  static constexpr int kChunks = DT / 64;  // 64-column (128-byte) boxes a row
  static constexpr int kThreads = 384;     // producer + two consumers
  static constexpr int kQBytes = BQ * DT * 2;
  static constexpr int kKVBytes = BK * DT * 2;    // one K or one V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  // 1024 bytes of slack: the swizzled tiles start on a 1024-byte boundary
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

// A wgmma shared-memory descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warp are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma uses: after wgmma_wait, no
// access to them moves above this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the SFU; subnormal results flush to 0 (a probability under
// 2^-126 of the row's max)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The shared-memory layout of one block: Q, then the K ring, the V ring
// and the barriers. Tile c-th 64-column box: rows x 128 bytes, swizzled.
template <int DT>
struct Smem {
  using T = Bf16Tile<DT>;
  uint32_t q, k, v, bar;
  __device__ explicit Smem(uint32_t base)
      : q(base),
        k(base + T::kQBytes),
        v(base + T::kQBytes + T::kStages * T::kKVBytes),
        bar(base + T::kQBytes + 2 * T::kStages * T::kKVBytes) {}
  __device__ uint32_t q_full() const { return bar; }
  __device__ uint32_t k_full(int s) const { return bar + 8 * (1 + 4 * s); }
  __device__ uint32_t k_empty(int s) const { return bar + 8 * (2 + 4 * s); }
  __device__ uint32_t v_full(int s) const { return bar + 8 * (3 + 4 * s); }
  __device__ uint32_t v_empty(int s) const { return bar + 8 * (4 + 4 * s); }
  __device__ uint32_t k_tile(int s) const { return k + s * T::kKVBytes; }
  __device__ uint32_t v_tile(int s) const { return v + s * T::kKVBytes; }
};

// S = Q·K_sᵀ for one consumer's 64 rows: DT / 16 wgmma k-steps, issued
// and committed as one group. Q and K are K-major (D contiguous): a k16
// step is 32 bytes into a 64-column box, a box is rows x 128 bytes on.
template <int DT>
__device__ __forceinline__ void issue_qk(float (&s)[Bf16Tile<DT>::BK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  using T = Bf16Tile<DT>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const int c = kk / 4, j = kk % 4;
    wgmma_ss(s, sw128_desc(q_rows + c * T::BQ * 128 + j * 32, 16, 1024),
             sw128_desc(k_tile + c * T::BK * 128 + j * 32, 16, 1024),
             kk > 0);
  }
  wgmma_commit();
}

// O += P·V_s: BK / 16 wgmma k-steps over the tile's keys, P from
// registers. V is MN-major (D contiguous): 8 keys are 1024 bytes on (the
// stride byte offset), the next 64-column box BK x 128 bytes (the leading
// byte offset).
template <int DT>
__device__ __forceinline__ void issue_pv(
    float (&o)[DT / 2], const uint32_t (&pa)[Bf16Tile<DT>::BK / 16][4],
    uint32_t v_tile) {
  using T = Bf16Tile<DT>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    wgmma_rs(o, pa[kk], sw128_desc(v_tile + kk * 2048, T::BK * 128, 1024));
  wgmma_commit();
}

// One score tile of a consumer thread's two rows (row0, row0 + 8): mask
// keys past the row where the tile crosses the diagonal, update the
// running max in the log2 domain (alpha: the old sum's factor), turn the
// scores into probabilities, 2^(s·scale_log2 - max) by one FFMA and ex2,
// and add them to the running sums. The fragment of n8 block j holds
// columns 8j + 2·tig + {0, 1} of rows row0 (elements 0, 1) and row0 + 8
// (elements 2, 3).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0,
                                             bool masked, int row0, int tig,
                                             float scale_log2,
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked && k0 + 8 * j + 2 * tig + (e & 1) > row0 + 8 * (e >> 1))
        s[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]));
      s[4 * j + e] = pe;
      rsum[e >> 1] += pe;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
}

// P in bf16, in wgmma's A-operand layout: for keys 16kk..16kk + 15 the
// fragments of n8 blocks 2kk and 2kk + 1.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&a)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= a[(i >> 1) & 1];
}

// named barriers: 1 and 2 order the consumers' turns (256 threads), 3 and
// 4 are each consumer's own (128 threads); 0 is __syncthreads'
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int DT>
__global__ void __launch_bounds__(Bf16Tile<DT>::kThreads, 1)
    flash_bf16_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            __grid_constant__ const CUtensorMap to,
                            Params p) {
  using T = Bf16Tile<DT>;
  constexpr int BQ = T::BQ, BK = T::BK, ST = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DT> sm((smem_addr(smem_raw) + 1023) & ~1023u);

  const Work w = block_work(p);
  const int q0 = w.qt * BQ;
  const int n_kt = (min(q0 + BQ, p.S) + BK - 1) / BK;  // keys [0, last row]

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.k_empty(s), 8);  // one arrival a consumer warp
      mbar_init(sm.v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.q_full(), T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sm.q + c * BQ * 128, &tq, sm.q_full(), 64 * c, q0, w.h,
                 w.b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % ST;
        // the first pass over the ring finds every stage free
        const uint32_t parity = ((t / ST) & 1) ^ 1;
        mbar_wait(sm.k_empty(s), parity);
        mbar_expect_tx(sm.k_full(s), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sm.k_tile(s) + c * BK * 128, &tk, sm.k_full(s), 64 * c,
                   t * BK, w.hk, w.b);
        mbar_wait(sm.v_empty(s), parity);
        mbar_expect_tx(sm.v_full(s), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(sm.v_tile(s) + c * BK * 128, &tv, sm.v_full(s), 64 * c,
                   t * BK, w.hk, w.b);
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int r0 = q0 + 64 * cw;            // the consumer's first row
    const int row0 = r0 + 16 * warp + g;    // this thread's rows: +0, +8
    const int r_end = min(r0 + 64, p.S);
    // the key tiles with a key <= one of this consumer's rows
    const int n_mine = r_end > r0 ? (r_end + BK - 1) / BK : 0;
    const float scale_log2 = kLog2e / sqrtf(static_cast<float>(p.D));
    const uint32_t q_rows = sm.q + 64 * cw * 128;

    float o[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) o[i] = 0.0f;
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    float alpha[2];

    // Turns: the consumers issue their wgmma groups in alternation,
    // consumer 0 first, n_kt + 1 turns each (tile t's QKᵀ with tile t-1's
    // PV, then the last PV; tiles past a consumer's rows give empty turns).
    // Consumer 1's last turn hands on to no one.
    const int my_bar = 1 + cw, other_bar = 2 - cw;
    int turn = 0;
    auto begin_turn = [&]() { bar_sync(my_bar, 256); };
    auto end_turn = [&]() {
      if (!(cw == 1 && turn == n_kt)) bar_arrive(other_bar, 256);
      ++turn;
    };
    if (cw == 1) bar_arrive(1, 256);
    if (n_mine > 0) {
      mbar_wait(sm.q_full(), 0);
      mbar_wait(sm.k_full(0), 0);
      begin_turn();
      issue_qk<DT>(s, q_rows, sm.k_tile(0));
      end_turn();
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(sm.k_empty(0));
      softmax_tile<BK>(s, 0, BK - 1 > r0, row0, tig, scale_log2, m_run,
                       l_run, alpha);
      pack_p<BK>(s, pa);
      for (int t = 1; t < n_mine; ++t) {
        const int st = t % ST, sp = (t - 1) % ST;
        mbar_wait(sm.k_full(st), (t / ST) & 1);
        mbar_wait(sm.v_full(sp), ((t - 1) / ST) & 1);
        begin_turn();
        issue_qk<DT>(s, q_rows, sm.k_tile(st));
        issue_pv<DT>(o, pa, sm.v_tile(sp));
        end_turn();
        wgmma_wait<1>();  // S_t is in
        fence_regs(s);
        if (lane == 0) mbar_arrive(sm.k_empty(st));
        const int k0 = t * BK;
        softmax_tile<BK>(s, k0, k0 + BK - 1 > r0, row0, tig, scale_log2,
                         m_run, l_run, alpha);
        wgmma_wait<0>();  // PV_{t-1} is in: P's registers and O are free
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(sm.v_empty(sp));
        if (__any_sync(kFull, alpha[0] != 1.0f || alpha[1] != 1.0f))
          rescale(o, alpha);
        pack_p<BK>(s, pa);
      }
      const int sl = (n_mine - 1) % ST;
      mbar_wait(sm.v_full(sl), ((n_mine - 1) / ST) & 1);
      begin_turn();
      issue_pv<DT>(o, pa, sm.v_tile(sl));
      end_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(sm.v_empty(sl));
    } else {
      begin_turn();
      end_turn();
    }
    for (int t = n_mine; t < n_kt; ++t) {
      const int st = t % ST;
      const uint32_t parity = (t / ST) & 1;
      mbar_wait(sm.k_full(st), parity);
      if (lane == 0) mbar_arrive(sm.k_empty(st));
      mbar_wait(sm.v_full(st), parity);
      if (lane == 0) mbar_arrive(sm.v_empty(st));
      begin_turn();
      end_turn();
    }

    // ------------------------------------------------------ epilogue --
    // O / l in bf16 into this consumer's own Q rows (its last QKᵀ has
    // completed), swizzled as the output's tensor map reads them, then one
    // TMA store a 64-column box: rows past S and columns past D are not
    // written, and the block leaves while the bytes are in flight.
    if (n_mine > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
        l_run[r] = fmaxf(l_run[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;  // within the consumer's 64
#pragma unroll
        for (int j = 0; j < DT / 8; ++j) {
          const uint32_t at = q_rows + (j / 8) * BQ * 128 + row * 128 +
                              (((j % 8) ^ (row % 8)) * 16) + tig * 4;
          const uint32_t v = pack_bf16(o[4 * j + 2 * r] / l_run[r],
                                       o[4 * j + 2 * r + 1] / l_run[r]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v)
                       : "memory");
        }
      }
      // the generic-proxy writes, visible to the TMA unit
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(3 + cw, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_store(&to, q_rows + c * BQ * 128, 64 * c, r0, w.h, w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // shared memory stays until the store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
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


// --------------------------------------------------------------- launch --
// The launch plan (ops.flash_plan), 7 + 4 x 11 values: DT, BQ, BK, stages,
// threads, shared-memory bytes, grid; then for q, k, v and o the tensor
// map's dims (D, S, heads, B), byte strides (S, heads, B) and box (4
// values). o's box is one consumer's 64 rows.

// one operand's bf16 tensor map from its plan entry, 128-byte swizzle,
// zeros out of bounds
bool make_map(CUtensorMap* map, const void* ptr, const long long* e) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(e[i]);
    box[i] = static_cast<cuuint32_t>(e[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(e[4 + i]);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the plan's geometry against this file's constants and the call's shapes
bool plan_matches(const Params& p, const long long* plan, int dt, int bq,
                  int bk, int stages, int threads, int smem) {
  return plan[0] == dt && plan[1] == bq && plan[2] == bk &&
         plan[3] == stages && plan[4] == threads && plan[5] == smem &&
         plan[6] == ceil_div(p.S, bq) * p.B * p.H;
}

template <int DT>
cudaError_t launch_bf16(Params p, const long long* plan,
                        cudaStream_t stream) {
  using T = Bf16Tile<DT>;
  if (!plan_matches(p, plan, DT, T::BQ, T::BK, T::kStages, T::kThreads,
                    T::kSmem))
    return cudaErrorInvalidValue;
  const Operand* ops[4] = {&p.q, &p.k, &p.v, &p.o};
  const long long heads[4] = {p.H, p.Hkv, p.Hkv, p.H};
  const long long rows[4] = {T::BQ, T::BK, T::BK, T::BQ / 2};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const long long* e = plan + 7 + 11 * i;
    const long long want[11] = {p.D, p.S, heads[i], p.B, 2 * ops[i]->ss,
                                2 * ops[i]->sh, 2 * ops[i]->sb, 64, rows[i],
                                1, 1};
    for (int j = 0; j < 11; ++j)
      if (e[j] != want[j]) return cudaErrorInvalidValue;
    if (!make_map(&maps[i], ops[i]->ptr, e)) return cudaErrorNotSupported;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_wgmma_kernel<DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  p.n_qtiles = static_cast<int>(ceil_div(p.S, T::BQ));
  flash_bf16_wgmma_kernel<DT>
      <<<static_cast<unsigned>(plan[6]), T::kThreads, T::kSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

cudaError_t launch_f32(Params p, const long long* plan,
                       cudaStream_t stream) {
  const int smem = f32_smem_floats(p.D) * 4;
  if (!plan_matches(p, plan, p.D, kF32BQ, kF32BK, 1, kF32Warps * 32, smem))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.n_qtiles = static_cast<int>(ceil_div(p.S, kF32BQ));
  flash_f32_kernel<<<static_cast<unsigned>(plan[6]), kF32Warps * 32, smem,
                     stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers; bf16: 1 for bfloat16, 0 for float32;
// strides: element strides (batch, head, position) of q, k, v and o, 12
// values, on a host pointer; plan: 51 values (ops.flash_plan), on a host
// pointer. D a multiple of 16 in [16, 256], H a multiple of Hkv,
// 16-byte aligned base and strides (the wrapper checks). Returns
// cudaErrorInvalidValue for arguments or a plan this file does not take,
// cudaErrorNotSupported when the driver encodes no tensor map, else
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16,
                                      int B, int H, int Hkv, int S, int D,
                                      const long long* strides,
                                      const long long* plan, void* stream) {
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
    err = launch_f32(p, plan, st);
  else if (D <= 64)
    err = launch_bf16<64>(p, plan, st);
  else if (D <= 128)
    err = launch_bf16<128>(p, plan, st);
  else
    err = launch_bf16<256>(p, plan, st);
  return static_cast<int>(err);
}

// The bf16 kernel's registers a thread at launch, local (spill) bytes a
// thread and dynamic shared memory a block, at DT = 64, 128 or 256, into
// out[0..2]. Returns a cudaError_t.
extern "C" int flash_attention_attrs(int dt, long long* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  int smem;
  if (dt == 64) {
    err = cudaFuncGetAttributes(&a, flash_bf16_wgmma_kernel<64>);
    smem = Bf16Tile<64>::kSmem;
  } else if (dt == 128) {
    err = cudaFuncGetAttributes(&a, flash_bf16_wgmma_kernel<128>);
    smem = Bf16Tile<128>::kSmem;
  } else if (dt == 256) {
    err = cudaFuncGetAttributes(&a, flash_bf16_wgmma_kernel<256>);
    smem = Bf16Tile<256>::kSmem;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = smem;
  return 0;
}
