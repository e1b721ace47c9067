// The whole compact query path in ONE launch, hand-written for Hopper
// (sm_90a): both scorer layers, the top-m buckets per rep (with the
// streaming log-sum-exp of adaptive m), the member gather, FrequentOnes
// top-C, the coarse rerank and the refine.
//
// Replaces the TPU kernel src/repro/kernels/mega_query/mega_query.py
// (mega_query, pallas_call at :301; body _kernel at :158-247). Contract,
// shared with the plain version (ref.py mega_search_ref, the compact op
// sequence): ids [Q, k] int32 (-1 pads), scores [Q, k] f32 (-inf pads),
// n_candidates [Q] int32 = the valid slots (id >= 0, count >= tau) of the
// top-C. Store kinds: fp32 rows (one rerank stage over the C slots), int8
// codes with per-block scales or bf16 codes (a coarse top-k' on the codes,
// then a refine of the k' survivors on the exact fp32 tier when given, else
// on the dequantized codes). Metrics: angular (q·v) and l2 in the direct
// -Σ(q - v)² form. Every fp32 sum runs in another order than the plain
// version's (cuBLAS, torch reductions), so the scores agree to ~1e-6 and a
// row whose m-th and (m+1)-th logits, k'-th and (k'+1)-th coarse scores or
// k-th and (k+1)-th refine scores lie that close may differ at that cut.
//
// What bounds it on the H100: operations. The scorer's two GEMMs are
// 2·R·Q·(d·H + H·B) = 1.349 TFLOP at the irli-deep1b widths (R = 32,
// Q = 1024, d = 96, H = 1024, B = 20000): 20.1 ms at 67 TFLOP/s of fp32
// outside the tensor cores (TF32 or bf16 would move the top-m choice off
// the reference). Everything after the scorer reads under 0.3 GB.
//
// Why one block cannot own a query tile here (as one TPU program does):
// the per-query candidate row is n = 32768 int32 (128 KB of a block's
// 227 KB), so a block holds one query row at a time in the FrequentOnes
// stage, while the scorer stage at a one-row (or 8-row) tile would re-read
// the 2.62 GB w2 once per tile. The launch therefore has cross-block
// phases. Design: a cooperative persistent kernel (design (a): launched
// with cudaLaunchCooperativeKernel, grid = blocks that fit an SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) x SMs, so every block is
// resident and cooperative_groups' grid.sync() can separate the phases).
// It was chosen over ticketed work from an atomic counter because the
// counters would need zeroing before each launch: a memset, a second
// launch. A block is 512 threads = two 256-thread tile workers, each with
// its own named barrier, its own tile ring (irli_topk.cuh: 3 stages of
// 32-deep slices that TMA brings in, each guarded by an mbarrier) and half
// the shared memory in phases 1-2:
//   1. hidden = relu(queries @ w1[r] + b1[r]) [R, Q, H] into device scratch
//      (134 MB at the cell, rows padded to 16 bytes), one 128 x 128 tile
//      per work item, a worker's items in one walk; the writes are fenced
//      for the async proxy before the grid sync, since phase 2 reads them
//      by TMA.
//   2. per (rep, 128-query tile) item: scorer_topk_tile (irli_topk.cuh)
//      streams w2 [R, H, B] in its own layout (no per-call transpose, as
//      the TPU wrapper's :292 makes) with a running top-m (+ lse) per row
//      into scratch [R, Q, m]. Items are ordered query tile fastest, so the
//      8 workers of one rep read the same w2 slices while they sit in L2.
//      The 256 items of the cell fill the 264 workers of 132 SMs at once.
//      Each column tile is one walk: the worker's ring drains, and the
//      tile's logits go through its memory into the half-row scans (the
//      block's other worker may multiply meanwhile). That epilogue is not
//      overlapped with the worker's next tile: chip_smoke.py measures its
//      share of phase 2 (PERF.md).
//   3. per query (block-strided): the keep mask from the top-m values and
//      lse, the R·m probed member rows gathered into the shared row (pads
//      and dropped probes -> INT_MAX), freq_topc.cuh's sort, run count and
//      second sort (the sorted ids and keys go through a per-block global
//      scratch row), then quant_rerank.cuh's scoring and packed-key top-k'
//      (fp32 stores: top-k), the refine of the k' survivors and its top-k.
// queries, w1, hidden and w2 reach the GEMMs as tensor maps (16-byte
// aligned rows; ops.py pads other shapes), so the rows past Q, D, H and B
// arrive as zeros. A register-level sort for phase 3 is later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../irli_topk/irli_topk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWorkers = 2;                              // tile workers
constexpr int kThreads = kWorkers * irli::kTileThreads;  // 512

// The launch's pointer and integer slots (ops.py fills them in this order).
enum PtrSlot {
  kQueries, kW1, kB1, kW2, kB2, kMembers, kRows, kScales, kExact, kHid,
  kPartV, kPartI, kPartLse, kSrt, kKscr, kOutIds, kOutScores, kOutNc,
  kNumPtrs
};
enum IntSlot {
  kQ, kD, kR, kH, kB, kML, kNBlocks, kBlock, kM, kN, kC, kCp, kKp, kKpPow2,
  kK, kKEff, kMetricL2, kAdaptive, kLdQ, kLdW1, kLdH, kLdW2, kPhases,
  kSelect, kNumInts
};

struct Args {
  CUtensorMap mq;         // queries [1, Q, D]: X boxes
  CUtensorMap mw1;        // w1 [R, D, H]: Y boxes
  CUtensorMap mh;         // hid [R, Q, H]: X boxes
  CUtensorMap mw2;        // w2 [R, H, B]: Y boxes
  const float* queries;   // [Q, D], row stride ldq
  const float* w1;        // [R, D, H]
  const float* b1;        // [R, H]
  const float* w2;        // [R, H, B]
  const float* b2;        // [R, B]
  const int* members;     // [R, B, ML]
  const void* rows;       // [L, D] f32 | int8 | bf16
  const float* scales;    // [L, n_blocks] (int8) or nullptr
  const float* exact;     // [L, D] f32 or nullptr
  float* hid;             // scratch [R, Q, H], row stride ldh
  float* part_v;          // scratch [R, Q, m]
  int* part_i;            // scratch [R, Q, m]
  float* part_lse;        // scratch [R, Q] (adaptive) or nullptr
  int* srt;               // scratch [grid, n]
  int* kscr;              // scratch [grid, n]
  int* out_ids;           // [Q, k]
  float* out_scores;      // [Q, k]
  int* out_nc;            // [Q]
  int Q, D, R, H, B, ML, n_blocks, block, m, n, C, Cp, kp, Kp, k, k_eff, l2,
      adaptive, ldq, ldw1, ldh, ldw2;
  // a timing probe's: the phases run (3 unless probing), and whether
  // phase 2 selects (0: its GEMM alone, scorer_topk_tile's select = false)
  int phases, select;
  float tau, probe_mass;
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Phase 3's shared memory, byte offsets. region0 holds in turn the sort row
// (n int32), the coarse keys (Cp int64) and the refine keys (Kp int64).
struct QueryLayout {
  int region0, score, cid, cnt, q, probe_b, probe_keep, cids, sc2, nc, total;
};

__host__ __device__ inline QueryLayout query_layout(const Args& a) {
  QueryLayout L;
  int off = 0;
  L.region0 = off;
  off += align16(imax(imax(4 * a.n, 8 * a.Cp), 8 * a.Kp));
  L.score = off;
  off += align16(4 * a.C);
  L.cid = off;
  off += align16(4 * a.C);
  L.cnt = off;
  off += align16(4 * a.C);
  L.q = off;
  off += align16(4 * a.D);
  L.probe_b = off;
  off += align16(4 * a.R * a.m);
  L.probe_keep = off;
  off += align16(4 * a.R * a.m);
  L.cids = off;
  off += align16(4 * a.kp);
  L.sc2 = off;
  off += align16(4 * a.kp);
  L.nc = off;
  off += 16;
  L.total = off;
  return L;
}

// The two workers' scorer tiles (each a multiple of 1024 bytes, the first
// aligned by irli::kAlign bytes of slack)
__host__ __device__ constexpr int tiles_smem(int m) {
  return irli::kAlign + kWorkers * irli::topk_tile_smem_bytes(m);
}

// The launch's dynamic shared memory: the larger of phase 3's layout and
// the two workers' scorer tiles (ops.smem_bytes mirrors it).
int smem_needed(const Args& a) {
  return imax(query_layout(a).total, tiles_smem(a.m));
}

// Phase 3 for the queries q = blockIdx.x, + gridDim.x, ...: every thread of
// the block calls it.
template <typename T>
__device__ void per_query(const Args& a, unsigned char* smem) {
  const QueryLayout L = query_layout(a);
  int* sa = reinterpret_cast<int*>(smem + L.region0);
  long long* keys = reinterpret_cast<long long*>(smem + L.region0);
  float* score = reinterpret_cast<float*>(smem + L.score);
  int* cid = reinterpret_cast<int*>(smem + L.cid);
  float* cnt = reinterpret_cast<float*>(smem + L.cnt);
  float* qv = reinterpret_cast<float*>(smem + L.q);
  int* pb = reinterpret_cast<int*>(smem + L.probe_b);
  int* pk = reinterpret_cast<int*>(smem + L.probe_keep);
  int* cids = reinterpret_cast<int*>(smem + L.cids);
  float* sc2 = reinterpret_cast<float*>(smem + L.sc2);
  int* nc = reinterpret_cast<int*>(smem + L.nc);
  int* srt = a.srt + static_cast<long long>(blockIdx.x) * a.n;
  int* kscr = a.kscr + static_cast<long long>(blockIdx.x) * a.n;
  const T* rows = static_cast<const T*>(a.rows);
  const int W = a.R * a.m * a.ML;

  for (int q = blockIdx.x; q < a.Q; q += gridDim.x) {
    for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
      qv[d] = a.queries[static_cast<long long>(q) * a.ldq + d];
    }
    for (int s = threadIdx.x; s < a.R * a.m; s += blockDim.x) {
      pb[s] = a.part_i[(static_cast<long long>(s / a.m) * a.Q + q) * a.m +
                       s % a.m];
    }
    // the adaptive-m keep mask (core/query.probe_keep_from_lse): probe j
    // of a rep stays while the softmax mass before it is < probe_mass
    for (int r = threadIdx.x; r < a.R; r += blockDim.x) {
      const long long rq = static_cast<long long>(r) * a.Q + q;
      float cum = 0.0f;
      for (int j = 0; j < a.m; ++j) {
        int keep = 1;
        if (a.adaptive) {
          const float p = expf(a.part_v[rq * a.m + j] - a.part_lse[rq]);
          const float incl = cum + p;
          keep = (incl - p) < a.probe_mass;
          cum = incl;
        }
        pk[r * a.m + j] = keep;
      }
    }
    if (threadIdx.x == 0) *nc = 0;
    __syncthreads();

    // gather: slot s = r·m + j holds bucket pb[s]'s ML members, in the
    // compact path's order; pads and dropped probes sort last as INT_MAX
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
      int v = -1;
      if (i < W) {
        const int s = i / a.ML;
        if (pk[s]) {
          v = a.members[(static_cast<long long>(s / a.m) * a.B + pb[s]) *
                            a.ML + i % a.ML];
        }
      }
      sa[i] = v < 0 ? INT_MAX : v;
    }
    __syncthreads();

    // FrequentOnes top-C (freq_topc.cuh)
    irli::bitonic_sort<false>(sa, a.n);
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
      srt[i] = sa[i];
      kscr[i] = irli::run_key(sa, i, a.n);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) sa[i] = kscr[i];
    __syncthreads();
    irli::bitonic_sort<true>(sa, a.n);
    int valid = 0;
    for (int j = threadIdx.x; j < a.C; j += blockDim.x) {
      int id, c;
      irli::decode_slot(sa, srt, j, a.n, &id, &c);
      cid[j] = id;
      cnt[j] = static_cast<float>(c);
      valid += id >= 0 && static_cast<float>(c) >= a.tau;
    }
    if (valid) atomicAdd(nc, valid);
    __syncthreads();
    if (threadIdx.x == 0) a.out_nc[q] = *nc;

    // coarse rerank (quant_rerank.cuh); fp32 rows: the only stage
    irli::score_slots(qv, rows, a.scales, a.n_blocks, a.block, a.D, cid, cnt,
                      a.tau, a.C, a.l2, score);
    irli::sort_score_keys(score, a.C, a.Cp, keys);
    const long long o = static_cast<long long>(q) * a.k;
    if constexpr (std::is_same<T, float>::value) {
      for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
        int id = -1;
        float s = -INFINITY;
        if (j < a.k_eff) {
          const int pos = irli::key_pos(keys[j]);
          s = score[pos];
          if (isfinite(s)) id = cid[pos];
        }
        a.out_ids[o + j] = id;
        a.out_scores[o + j] = s;
      }
    } else {
      for (int j = threadIdx.x; j < a.kp; j += blockDim.x) {
        const int pos = irli::key_pos(keys[j]);
        cids[j] = isfinite(score[pos]) ? cid[pos] : -1;
      }
      __syncthreads();
      // refine: the exact fp32 tier, or the dequantized codes
      if (a.exact != nullptr) {
        irli::score_slots(qv, a.exact, nullptr, 1, 1, a.D, cids, nullptr,
                          0.0f, a.kp, a.l2, sc2);
      } else {
        irli::score_slots(qv, rows, a.scales, a.n_blocks, a.block, a.D, cids,
                          nullptr, 0.0f, a.kp, a.l2, sc2);
      }
      irli::sort_score_keys(sc2, a.kp, a.Kp, keys);
      for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
        int id = -1;
        float s = -INFINITY;
        if (j < a.k_eff) {
          const int pos = irli::key_pos(keys[j]);
          s = sc2[pos];
          if (isfinite(s)) id = cids[pos];
        }
        a.out_ids[o + j] = id;
        a.out_scores[o + j] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mega_query_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kWorkers][2 * irli::kStages];
  cg::grid_group grid = cg::this_grid();
  const int sub = threadIdx.x / irli::kTileThreads;
  const int worker = blockIdx.x * kWorkers + sub;
  const int n_workers = gridDim.x * kWorkers;
  unsigned char* wsmem =
      irli::aligned_smem(smem) + sub * irli::topk_tile_smem_bytes(a.m);
  irli::Ring ring = irli::make_ring(wsmem, bars[sub], 1 + sub);
  const int lt = threadIdx.x & (irli::kTileThreads - 1);
  const int ty = lt >> 4, tx = lt & 15;
  const int nqt = (a.Q + irli::kBM - 1) / irli::kBM;

  // 1. hidden = relu(queries @ w1[r] + b1[r]): this worker's items it =
  // worker, worker + n_workers, ..., one walk (the ring runs ahead across
  // items)
  const int nht = (a.H + irli::kBN - 1) / irli::kBN;
  const int n_items = a.R * nqt * nht;
  const int mine = worker < n_items ? (n_items - 1 - worker) / n_workers + 1
                                    : 0;
  const int nk1 = (a.D + irli::slice_depth<float>() - 1) /
                  irli::slice_depth<float>();
  const CUtensorMap* mq = &a.mq;
  const CUtensorMap* mw1 = &a.mw1;
  // item t of this worker: (rep, first row, first column)
  auto item = [&](int t) {
    const int it = worker + t * n_workers;
    return make_int3(it / (nqt * nht), (it / nht) % nqt * irli::kBM,
                     it % nht * irli::kBN);
  };
  auto load1 = [&](unsigned u) {
    const int3 w = item(static_cast<int>(u / nk1));
    const int k0 = static_cast<int>(u % nk1) * irli::slice_depth<float>();
    const int st = irli::claim(ring, ring.n + u, irli::kStageBytes);
    tma::tma_load(ring.x(st), mq, ring.full(st), k0, w.y, 0, 0);
    tma::tma_load(ring.y(st), mw1, ring.full(st), w.z, k0, w.x, 0);
  };
  auto ys1 = [&](unsigned, int st) { return ring.yp(st); };
  auto done1 = [&](int t, float (&acc)[8][8]) {
    const int3 w = item(t);
    const int r = w.x, row0 = w.y, col0 = w.z;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + irli::tile_off(j, tx);
      if (col >= a.H) continue;
      const float bias = a.b1[static_cast<long long>(r) * a.H + col];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + irli::tile_off(i, ty);
        if (row < a.Q) {
          a.hid[(static_cast<long long>(r) * a.Q + row) * a.ldh + col] =
              fmaxf(acc[i][j] + bias, 0.0f);
        }
      }
    }
  };
  irli::walk<float, false>(ring, mine, nk1, load1, ys1, done1);
  if (a.phases < 2) return;
  // phase 2 reads hid through the async proxy (TMA)
  tma::fence_proxy_global();
  grid.sync();
  tma::fence_proxy_global();

  // 2. per (rep, query tile): logits = hidden @ w2[r] + b2[r] -> top-m, lse
  for (int it = worker; it < a.R * nqt; it += n_workers) {
    const int r = it / nqt;
    const long long rl = r;
    irli::scorer_topk_tile<float>(
        ring, &a.mh, &a.mw2, r, a.b2 + rl * a.B, a.Q, a.B, a.H, a.m,
        it % nqt * irli::kBM, a.part_v + rl * a.Q * a.m,
        a.part_i + rl * a.Q * a.m,
        a.adaptive ? a.part_lse + rl * a.Q : nullptr,
        reinterpret_cast<float*>(wsmem + irli::kRingBytes), a.select != 0);
  }
  if (a.phases < 3) return;
  grid.sync();

  // 3. per query: gather, FrequentOnes, rerank
  per_query<T>(a, smem);
}

template <typename T>
int grid_for(int smem, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_query_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = per_sm * sms;
  return 0;
}

template <typename T>
int launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args copy = a;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel((const void*)mega_query_kernel<T>,
                                    dim3(grid), dim3(kThreads), params,
                                    static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The four GEMM operands' tensor maps (false when one is not aligned for
// TMA or the driver refuses it)
bool make_maps(Args* a) {
  const long long Q = a->Q, D = a->D, R = a->R, H = a->H, B = a->B;
  return irli::tma_aligned(a->queries, 4, a->ldq, Q * a->ldq) &&
         irli::tma_aligned(a->w1, 4, a->ldw1, D * a->ldw1) &&
         irli::tma_aligned(a->hid, 4, a->ldh, Q * a->ldh) &&
         irli::tma_aligned(a->w2, 4, a->ldw2, H * a->ldw2) &&
         a->ldq >= D && a->ldw1 >= H && a->ldh >= H && a->ldw2 >= B &&
         irli::operand_map<float>(&a->mq, a->queries, 1, Q, D, a->ldq,
                                  Q * a->ldq, true) &&
         irli::operand_map<float>(&a->mw1, a->w1, R, D, H, a->ldw1,
                                  D * a->ldw1, false) &&
         irli::operand_map<float>(&a->mh, a->hid, R, Q, H, a->ldh,
                                  Q * a->ldh, true) &&
         irli::operand_map<float>(&a->mw2, a->w2, R, H, B, a->ldw2,
                                  H * a->ldw2, false);
}

}  // namespace

// The kernel's registers a thread and local (spill) bytes a thread for
// store kind (0 fp32, 1 int8, 2 bf16), then the two workers' scorer-tile
// shared memory at m, the ring's stages and slice depth, into out[0..4].
// Returns a cudaError_t.
extern "C" int mega_query_attrs(int kind, int m, long long* out) {
  int err;
  if (kind == 0) {
    err = irli::kernel_attrs(mega_query_kernel<float>, out);
  } else if (kind == 1) {
    err = irli::kernel_attrs(mega_query_kernel<int8_t>, out);
  } else if (kind == 2) {
    err = irli::kernel_attrs(mega_query_kernel<__nv_bfloat16>, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[2] = tiles_smem(m);
  out[3] = irli::kStages;
  out[4] = irli::slice_depth<float>();
  return err;
}

// The cooperative grid for store kind (0 fp32, 1 int8, 2 bf16) at `smem`
// bytes of dynamic shared memory: the blocks that fit one SM at once times
// the SMs. Returns 0 or a cudaError_t.
extern "C" int mega_query_grid(int kind, int smem, int* grid) {
  if (kind == 0) return grid_for<float>(smem, grid);
  if (kind == 1) return grid_for<int8_t>(smem, grid);
  if (kind == 2) return grid_for<__nv_bfloat16>(smem, grid);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ptrs[kNumPtrs] and ints[kNumInts] in the PtrSlot / IntSlot order above
// (kPhases 3 and kSelect 1 for a search; a timing probe runs phases 1 ..
// kPhases only, or phase 2's GEMM without its selection, kSelect 0, which
// leaves phase 3 nothing to read: kPhases < 3 then); grid from mega_query_grid at the same kind and smem, the scratch srt and
// kscr [grid, n]. Returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue when the arguments break the contract.
extern "C" int mega_query_launch(void* const* ptrs, const int* ints,
                                 float tau, float probe_mass, int kind,
                                 int grid, int smem, void* stream) {
  Args a;
  a.queries = static_cast<const float*>(ptrs[kQueries]);
  a.w1 = static_cast<const float*>(ptrs[kW1]);
  a.b1 = static_cast<const float*>(ptrs[kB1]);
  a.w2 = static_cast<const float*>(ptrs[kW2]);
  a.b2 = static_cast<const float*>(ptrs[kB2]);
  a.members = static_cast<const int*>(ptrs[kMembers]);
  a.rows = ptrs[kRows];
  a.scales = static_cast<const float*>(ptrs[kScales]);
  a.exact = static_cast<const float*>(ptrs[kExact]);
  a.hid = static_cast<float*>(ptrs[kHid]);
  a.part_v = static_cast<float*>(ptrs[kPartV]);
  a.part_i = static_cast<int*>(ptrs[kPartI]);
  a.part_lse = static_cast<float*>(ptrs[kPartLse]);
  a.srt = static_cast<int*>(ptrs[kSrt]);
  a.kscr = static_cast<int*>(ptrs[kKscr]);
  a.out_ids = static_cast<int*>(ptrs[kOutIds]);
  a.out_scores = static_cast<float*>(ptrs[kOutScores]);
  a.out_nc = static_cast<int*>(ptrs[kOutNc]);
  a.Q = ints[kQ];
  a.D = ints[kD];
  a.R = ints[kR];
  a.H = ints[kH];
  a.B = ints[kB];
  a.ML = ints[kML];
  a.n_blocks = ints[kNBlocks];
  a.block = ints[kBlock];
  a.m = ints[kM];
  a.n = ints[kN];
  a.C = ints[kC];
  a.Cp = ints[kCp];
  a.kp = ints[kKp];
  a.Kp = ints[kKpPow2];
  a.k = ints[kK];
  a.k_eff = ints[kKEff];
  a.l2 = ints[kMetricL2];
  a.adaptive = ints[kAdaptive];
  a.ldq = ints[kLdQ];
  a.ldw1 = ints[kLdW1];
  a.ldh = ints[kLdH];
  a.ldw2 = ints[kLdW2];
  a.phases = ints[kPhases];
  a.select = ints[kSelect];
  a.tau = tau;
  a.probe_mass = probe_mass;
  const long long W = static_cast<long long>(a.R) * a.m * a.ML;
  const bool ok =
      a.Q >= 0 && a.D >= 1 && a.R >= 1 && a.H >= 1 && a.ML >= 1 &&
      a.m >= 1 && a.m <= irli::kMaxM && a.m <= a.B && is_pow2(a.n) &&
      a.n <= 32768 && W <= a.n && a.C >= 1 && a.C <= W && is_pow2(a.Cp) &&
      a.Cp >= a.C && a.kp >= 1 && a.kp <= a.C && is_pow2(a.Kp) &&
      a.Kp >= a.kp && a.k >= 1 && a.k_eff >= 1 && a.k_eff <= a.k &&
      a.k_eff <= a.C && a.k_eff <= a.kp && grid >= 1 &&
      smem >= smem_needed(a) && (kind == 1) == (a.scales != nullptr) &&
      (a.scales == nullptr || a.n_blocks * a.block == a.D) &&
      (a.adaptive == 0 || a.part_lse != nullptr) && kind >= 0 && kind <= 2 &&
      a.phases >= 1 && a.phases <= 3 && (a.select != 0 || a.phases < 3);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (a.Q == 0) return 0;
  if (!make_maps(&a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch<float>(a, grid, smem, s);
  if (kind == 1) return launch<int8_t>(a, grid, smem, s);
  return launch<__nv_bfloat16>(a, grid, smem, s);
}
