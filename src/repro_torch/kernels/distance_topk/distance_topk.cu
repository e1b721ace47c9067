// Masked similarity of queries against corpus rows + running top-k,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/distance_topk/distance_topk.py
// (distance_topk, pallas_call at :68), which walks L in sequence on one core
// with a [tq, k] top-k carried in scratch. Contract, shared with the plain
// version (ref.py): sim[q, l] = q·b (metric "dot") or, for "l2",
// -((|q|² - 2 q·b) + |b|²) in core/query.pairwise_sim's order, with |q|² and
// |b|² computed by the caller as pairwise_sim computes them; entries whose
// mask byte is 0 are dropped; per query the k largest in jax.lax.top_k's
// order (value descending in the floats' total order, -0.0 below +0.0, the
// smaller column first on a tie). Slots past the survivors hold -inf and
// INT_MAX; the wrapper (ops.rerank_topk) writes id -1 where the score is not
// finite. The [Q, L] similarities never reach device memory.
//
// What bounds it on the H100: operations. 2·Q·L·d fp32 multiply-adds: at the
// stream cell's oracle (Q = 1024, L = 2,065,536, d = 96) 4.06e11, 6.06 ms at
// 67 TFLOP/s; its bytes (the corpus once, 0.79 GB) take 0.24 ms. The products
// stay IEEE fp32 on the FMA units (no TF32): TF32 would move near-tie ids.
//
// Design: one block of 256 threads an SM (up to 255 registers a thread) over
// (128-query tile, L split): the TPU's sequential L axis is cut into `splits`
// contiguous ranges of 128-column tiles, so a few query tiles still fill the
// card (one block at an audit window of 64 queries would use one SM of 132).
// A block transposes its query tile into shared memory once ([ceil32(d)][128]
// fp32, 48 KB at d = 96) and keeps it there for its whole range; the corpus
// rows stream through the tile ring of irli_topk.cuh (4 mbarrier-guarded
// stages of 16 KB, one 128-row x 32-deep TMA box each, 128-byte swizzled,
// zeros past L and d), which runs ahead across tile boundaries, so the copies
// of the next tile's first slices are in flight while a tile is multiplied
// and selected. Past d = 288 the resident tile does not fit beside the ring:
// then each stage (32 KB) also brings the query tile's 32-deep slice, a TMA
// box of the queries' transpose that the wrapper makes ([d, Q], 4 bytes x d
// x Q), read from L2 again for every corpus tile; the sums are the same.
// slice_fma (the corpus as X, the query tile as Y) leaves each thread an 8 x
// 8 block of similarities in registers: rows tile_off(i, ty), columns tx +
// 16j, so warp w holds rows 8w .. 8w + 7 and 64 + 8w .. 64 + 8w + 7 whole.
// The selection needs no block barrier: each lane compares its values
// against their rows' k-th values (kept in shared memory), and the warp goes
// on at once unless one may enter (after the first tiles, rarely). Else the
// warp passes each row with candidates through its own one-row staging area
// and scans it 32 columns at a time (lane = column): a ballot of the values
// whose key passes the row's k-th key (the oracle's shared mask row is loaded
// a tile ahead; a row's own mask is read only for those), and the survivors
// enter the row's sorted (value, column) list one by one in column order. A
// list of k <= 128 is held in the warp's registers while its row is scanned
// (1 entry a lane up to k = 32, else 4: an insertion is one reduction and
// two shuffles); a longer one is shifted in memory (warp_insert). A value enters only when its
// key is strictly above the list's last once the list is full, so an equal
// value at a larger column never displaces a smaller one. A warp's selection
// thus overlaps the other warps' products, held back only by the ring's
// depth. The lists sit in shared memory while they fit beside the rest
// (lists_in_smem: k <= 108 at d = 96) and otherwise in the block's slice of
// the partial outputs in device memory, where they stay in L1/L2. The block
// writes its [128, k] lists to part[split]; a second kernel merges each
// query's `splits` sorted lists by (key desc, column asc) with one warp:
// deterministic, no atomics.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

#include "../irli_topk/irli_topk.cuh"

namespace {

using irli::kAlign;
using irli::kBM;
using irli::kBN;

constexpr int kMaxSplits = 1024;  // 32 heads a lane in the merge
constexpr int kMergeThreads = 256;
constexpr int kSliceK = irli::slice_depth<float>();      // 32
constexpr int kStages = 4;        // one more than the scorer's: slack for
                                  // a warp's selection
constexpr int kRegK = 128;        // lists up to this long sit in registers
                                  // while a row is scanned (1 or 4 a lane)
// Dynamic shared memory: a block may use 232,448 bytes with its static
// barriers (under 128 bytes).
constexpr int kSmemLimit = 232448 - 128;
// the warps' one-row staging areas and the rows' counts, threshold keys
// and threshold values
constexpr int kFixed = 8 * kBN * 4 + 3 * kBM * 4;

__host__ __device__ constexpr int padded_d(int d) {
  return (d + kSliceK - 1) / kSliceK * kSliceK;
}
// Whether the transposed query tile ([ceil32(d)][128] fp32) stays resident
// beside a ring of corpus slices (d <= 288); else each stage also brings
// the query tile's slice.
__host__ __device__ constexpr bool query_resident(int d) {
  return d <= kSmemLimit / (kBM * 4) &&
         kAlign + kStages * irli::kXBytes + padded_d(d) * kBM * 4 + kFixed <=
             kSmemLimit;
}
__host__ __device__ constexpr int ring_bytes(int d) {
  return kStages * (query_resident(d) ? irli::kXBytes : irli::kStageBytes);
}
// the alignment slack, the ring, the resident query tile, kFixed
__host__ __device__ constexpr int base_bytes(int d) {
  return kAlign + ring_bytes(d) +
         (query_resident(d) ? padded_d(d) * kBM * 4 : 0) + kFixed;
}
__host__ __device__ constexpr bool lists_in_smem(int d, int k) {
  return base_bytes(d) + kBM * k * 8 <= kSmemLimit;
}
__host__ __device__ constexpr int smem_bytes(int d, int k) {
  return base_bytes(d) + (lists_in_smem(d, k) ? kBM * k * 8 : 0);
}
static_assert(lists_in_smem(96, 10), "the oracle's lists in shared memory");
static_assert(base_bytes(4096) <= kSmemLimit, "every d fits a block");

// Insert (v, col) with key `key` into a row's sorted list lv/li of k
// entries holding `count`, by one warp: its slot p is the number of
// entries whose key is >= key (an equal key already there sits at a smaller
// column), the entries from p on move down one (the last falls off a full
// list), 32 at a time from the bottom. Every lane calls it with the same
// arguments.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int count,
                                            int k, int key, float v, int col,
                                            int lane) {
  int ge = 0;
  for (int j = lane; j < count; j += 32) ge += irli::fkey(lv[j]) >= key;
  const int p = __reduce_add_sync(0xffffffffu, ge);
  const int last = min(count, k - 1);   // entries [p, last) move to j + 1
  for (int hi = last; hi > p; hi -= 32) {
    const int j = hi - 1 - lane;
    const bool mv = j >= p;
    float tv = 0.0f;
    int ti = 0;
    if (mv) {
      tv = lv[j];
      ti = li[j];
    }
    __syncwarp();
    if (mv) {
      lv[j + 1] = tv;
      li[j + 1] = ti;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = v;
    li[p] = col;
  }
  __syncwarp();
}

// The same insertion into a list of k <= 32·E entries that the warp holds
// in registers, lane l entries E·l .. E·l + E - 1 (ev, ei): the slot p by
// one reduction, each entry from p on takes its predecessor (the first of
// a lane's E from the lane below), the k-th's key by one shuffle. count and
// thr (the key of the k-th entry once full) are every lane's; a candidate
// enters only when the list is not full or its key is strictly above thr.
// Returns whether it entered. Every lane calls it with the same arguments.
// E is 1 or 4.
template <int E>
__device__ __forceinline__ bool reg_insert(float (&ev)[E], int (&ei)[E],
                                           int& count, int& thr, int k,
                                           float v, int col, int lane) {
  static_assert(E == 1 || E == 4, "one or four entries a lane");
  const int key = irli::fkey(v);
  if (count == k && key <= thr) return false;
  int ge = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    ge += E * lane + e < count && irli::fkey(ev[e]) >= key;
  const int p = __reduce_add_sync(0xffffffffu, ge);
  const float below_v = __shfl_up_sync(0xffffffffu, ev[E - 1], 1);
  const int below_i = __shfl_up_sync(0xffffffffu, ei[E - 1], 1);
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    const int j = E * lane + e;
    if (j > p) {
      ev[e] = e > 0 ? ev[e > 0 ? e - 1 : 0] : below_v;
      ei[e] = e > 0 ? ei[e > 0 ? e - 1 : 0] : below_i;
    } else if (j == p) {
      ev[e] = v;
      ei[e] = col;
    }
  }
  if (count < k) ++count;
  if (count == k) {
    // a select chain: a loop of selects here became an indexed local array
    float last = ev[0];
    if constexpr (E == 4) {
      const int e = (k - 1) & 3;
      last = e == 0 ? ev[0] : e == 1 ? ev[1] : e == 2 ? ev[2] : ev[3];
    }
    thr = irli::fkey(__shfl_sync(0xffffffffu, last, (k - 1) / E));
  }
  return true;
}

// the float whose total-order key is key (irli::fkey's inverse)
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key < 0 ? (key ^ 0x7fffffff) : key);
}

constexpr int kWarps = irli::kTileThreads / 32;
constexpr int kRowsPerWarp = kBM / kWarps;
constexpr int kChunks = kBN / 32;   // 32-column reads of a tile row

// A staged row into its list lv/li of k (count and thr, the key of its k-th
// entry once full, in every lane): lane l holds the row's columns cc·32 + l
// of the tile at col0 in v (n of them valid). The values that may enter
// (the list not full or the key above thr, and a nonzero mask byte: the
// tile's shared mask bytes tile_mask when mrow is null, else the row's own
// mask, read only for those) go in column order, each inserted by the whole
// warp: with E > 0 into the list held in registers while the row is scanned
// (E entries a lane, k <= 32·E; written back if one entered), with E = 0 by
// warp_insert in memory. Every lane calls it with the same arguments.
template <int E>
__device__ __forceinline__ void scan_row(const float (&v)[kChunks], int n,
                                         int col0, unsigned tile_mask,
                                         const unsigned char* mrow, float* lv,
                                         int* li, int& count, int& thr, int k,
                                         int lane) {
  constexpr int kE = E > 0 ? E : 1;
  float ev[kE];
  int ei[kE];
  if constexpr (E > 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = E * lane + e;
      ev[e] = j < k ? lv[j] : -INFINITY;
      ei[e] = j < k ? li[j] : INT_MAX;
    }
  }
  bool entered = false;
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int c = cc * 32 + lane;
    const int key = irli::fkey(v[cc]);
    const bool pass =
        c < n && (count < k || key > thr) &&
        (mrow == nullptr ? ((tile_mask >> (8 * cc)) & 0xffu) != 0
                         : mrow[c] != 0);
    unsigned ball = __ballot_sync(0xffffffffu, pass);
    while (ball) {
      const int src = __ffs(ball) - 1;
      ball &= ball - 1;
      const float vv = __shfl_sync(0xffffffffu, v[cc], src);
      const int col = col0 + cc * 32 + src;
      if constexpr (E > 0) {
        entered |= reg_insert<E>(ev, ei, count, thr, k, vv, col, lane);
      } else {
        const int kk = irli::fkey(vv);
        if (count == k && kk <= thr) continue;
        warp_insert(lv, li, count, k, kk, vv, col, lane);
        if (count < k) ++count;
        if (count == k) thr = irli::fkey(lv[k - 1]);
      }
    }
  }
  if constexpr (E > 0) {
    if (!entered) return;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = E * lane + e;
      if (j < k) {
        lv[j] = ev[e];
        li[j] = ei[e];
      }
    }
  }
}

// part_v / part_i [splits, Q, k]: split s's top-k of each query over columns
// [s·tps·128, (s+1)·tps·128) ∩ [0, L). mb: the corpus's tensor map (dims
// (d, L, 1, 1), X boxes). q [Q, d] row-major (kStream false: the block
// transposes its tile into shared memory); mq: the transposed queries'
// tensor map (kStream: dims (Q, d, 1, 1), Y boxes).
template <bool kL2, bool kStream>
__global__ void __launch_bounds__(irli::kTileThreads, 1)
    distance_topk_kernel(const __grid_constant__ CUtensorMap mb,
                         const __grid_constant__ CUtensorMap mq,
                         const float* q, const unsigned char* mask,
                         long long mask_ld, const float* qn, const float* bn,
                         int Q, int L, int d, int k, int tps, float* part_v,
                         int* part_i) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  unsigned char* smem = irli::aligned_smem(smem_raw);
  const int dp = padded_d(d);
  const int lt = threadIdx.x;
  const int ty = lt >> 4, tx = lt & 15;
  const int warp = lt >> 5, lane = lt & 31;
  const int row0 = blockIdx.x * kBM;
  const long long s = blockIdx.y;
  const int c_begin = static_cast<int>(s * tps * kBN);
  const int c_end = static_cast<int>(
      min(static_cast<long long>(L), (s + 1) * tps * kBN));
  const bool in_smem = lists_in_smem(d, k);
  constexpr int kStageBytes = kStream ? irli::kStageBytes : irli::kXBytes;
  float* qt = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* stage = qt + (kStream ? 0 : dp * kBM);   // [8 warps][128]: a row
  int* s_count = reinterpret_cast<int*>(stage + 8 * kBN);
  int* s_thr = s_count + kBM;           // key of its k-th entry once full
  float* s_thrf = reinterpret_cast<float*>(s_thr + kBM);    // and its value
  float* lv_all = s_thrf + kBM;                             // [128, k]
  int* li_all = reinterpret_cast<int*>(lv_all + kBM * k);
  // row r's list: shared memory, or its slice of the outputs
  auto list_v = [&](int r) {
    return in_smem ? lv_all + r * k
                   : part_v + (s * Q + row0 + r) * static_cast<long long>(k);
  };
  auto list_i = [&](int r) {
    return in_smem ? li_all + r * k
                   : part_i + (s * Q + row0 + r) * static_cast<long long>(k);
  };
  irli::Ring ring = irli::make_ring(smem, bars, 1, kStageBytes, kStages);
  // the resident query tile, transposed: qt[c·128 + r] = q[row0 + r, c],
  // zeros past Q and d
  if constexpr (!kStream) {
    for (int e = lt; e < dp * kBM; e += irli::kTileThreads) {
      const int r = e & (kBM - 1), c = e >> 7;
      qt[e] = row0 + r < Q && c < d
                  ? q[static_cast<long long>(row0 + r) * d + c]
                  : 0.0f;
    }
  }
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (row0 + r >= Q) break;
    float* lv = list_v(r);
    int* li = list_i(r);
    for (int j = lane; j < k; j += 32) {
      lv[j] = -INFINITY;
      li[j] = INT_MAX;
    }
    if (lane == 0) {
      s_count[r] = 0;
      s_thr[r] = INT_MIN;
    }
  }
  // the prefilter's threshold: -inf until a list is full, +inf past Q
  for (int r = lt; r < kBM; r += irli::kTileThreads)
    s_thrf[r] = row0 + r < Q ? -INFINITY : INFINITY;
  float qnr[8];                              // the l2 norms of its rows
#pragma unroll
  for (int i = 0; i < 8; ++i)
    qnr[i] = kL2 ? qn[min(row0 + irli::tile_off(i, ty), Q - 1)] : 0.0f;
  irli::tile_sync(1);

  const int ns = dp / kSliceK;
  const CUtensorMap* map = &mb;
  const CUtensorMap* qmap = &mq;
  auto load = [&](unsigned u) {
    const int st = irli::claim(ring, ring.n + u, kStageBytes);
    const int k0 = static_cast<int>(u % ns) * kSliceK;
    tma::tma_load(ring.x(st), map, ring.full(st), k0,
                  c_begin + static_cast<int>(u / ns) * kBN, 0, 0);
    if constexpr (kStream)
      tma::tma_load(ring.y(st), qmap, ring.full(st), row0, k0, 0, 0);
  };
  auto ys = [&](unsigned u, int st) -> const unsigned char* {
    if constexpr (kStream) return ring.yp(st);
    return reinterpret_cast<const unsigned char*>(qt) +
           static_cast<int>(u % ns) * kSliceK * kBM * 4;
  };
  // a shared mask row (mask_ld 0, the oracle's): each lane's four bytes of
  // a tile (columns cc·32 + lane) are loaded one tile ahead, so the
  // selection never waits for them
  const bool one_row = mask_ld == 0;
  const int n_tiles = (c_end - c_begin + kBN - 1) / kBN;
  auto mask_bytes = [&](int col0) {
    unsigned w = 0;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const int c = col0 + cc * 32 + lane;
      if (c < c_end) w |= static_cast<unsigned>(mask[c]) << (8 * cc);
    }
    return w;
  };
  unsigned next_mask = one_row && n_tiles > 0 ? mask_bytes(c_begin) : 0u;
  auto done = [&](int t, float (&acc)[8][8]) {
    const int col0 = c_begin + t * kBN;
    const unsigned tile_mask = next_mask;
    if (one_row && t + 1 < n_tiles) next_mask = mask_bytes(col0 + kBN);
    if constexpr (kL2) {   // pairwise_sim's l2: -((|q|² - 2 q·b) + |b|²)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = bn[min(col0 + tx + 16 * j, L - 1)];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i][j] = -((qnr[i] - 2.0f * acc[i][j]) + bv);
      }
    }
    // the prefilter: which of the lane's rows hold a value at or above
    // the row's k-th (or a NaN)
    unsigned rm = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float th = s_thrf[irli::tile_off(i, ty)];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(acc[i][j] < th)) rm |= 1u << i;
    }
    if (!__any_sync(0xffffffffu, rm != 0)) return;
    // the rows with candidates (local row i + 8h: row tile_off(i, 2·warp +
    // h)), one at a time through the warp's one-row staging area
    float* st = stage + warp * kBN;
    const int h = ty & 1;
    unsigned rows = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned b = __ballot_sync(0xffffffffu, (rm >> i) & 1);
      rows |= ((b & 0xffffu) ? 1u : 0u) << i;
      rows |= ((b >> 16) ? 1u : 0u) << (i + 8);
    }
    const int n_here = min(kBN, c_end - col0);
    while (rows) {
      const int rl = __ffs(rows) - 1;
      rows &= rows - 1;
      const int r = irli::tile_off(rl & 7, 2 * warp + (rl >> 3));
      const int row = row0 + r;
      if (row >= Q) continue;
      __syncwarp();
      if (h == rl >> 3) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = acc[0][j];
#pragma unroll
          for (int i = 1; i < 8; ++i) x = (rl & 7) == i ? acc[i][j] : x;
          st[tx + 16 * j] = x;
        }
      }
      __syncwarp();
      float* lv = list_v(r);
      int* li = list_i(r);
      int count = s_count[r];
      int thr = s_thr[r];
      const unsigned char* mrow =
          one_row ? nullptr : mask + row * mask_ld + col0;
      float v[kChunks];
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc)
        v[cc] = st[cc * 32 + lane];
      if (k <= 32) {
        scan_row<1>(v, n_here, col0, tile_mask, mrow, lv, li, count, thr, k,
                    lane);
      } else if (k <= kRegK) {
        scan_row<kRegK / 32>(v, n_here, col0, tile_mask, mrow, lv, li, count,
                             thr, k, lane);
      } else {
        scan_row<0>(v, n_here, col0, tile_mask, mrow, lv, li, count, thr, k,
                    lane);
      }
      __syncwarp();
      if (lane == 0) {
        s_count[r] = count;
        s_thr[r] = thr;
        s_thrf[r] = count == k ? key_value(thr) : -INFINITY;
      }
      __syncwarp();
    }
  };
  irli::walk<float, true>(ring, n_tiles, ns, load, ys, done);
  irli::tile_sync(1);                        // every warp's lists are final
  if (in_smem) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (row0 + r >= Q) break;
      const long long o = (s * Q + row0 + r) * k;
      for (int j = lane; j < k; j += 32) {
        part_v[o + j] = lv_all[r * k + j];
        part_i[o + j] = li_all[r * k + j];
      }
    }
  }
}

// One warp a query: lane l holds the heads of splits l, l + 32, ...; each
// output slot takes the best head by (key desc, column asc) over the warp.
__global__ void __launch_bounds__(kMergeThreads)
    distance_topk_merge(const float* part_v, const int* part_i, int Q,
                        int splits, int k, float* out_v, int* out_i) {
  const int query = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (query >= Q) return;
  int head[kMaxSplits / 32];
  for (int h = 0; h < kMaxSplits / 32; ++h) head[h] = 0;
  for (int j = 0; j < k; ++j) {
    int bk = INT_MIN, bi = INT_MAX, bh = -1;
    for (int h = 0; lane + 32 * h < splits; ++h) {
      if (head[h] >= k) continue;
      const long long o =
          (static_cast<long long>(lane + 32 * h) * Q + query) * k + head[h];
      const int key = irli::fkey(part_v[o]);
      const int id = part_i[o];
      if (bh < 0 || key > bk || (key == bk && id < bi)) {
        bk = key;
        bi = id;
        bh = h;
      }
    }
    int wk = bk, wi = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, wk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      if (ok > wk || (ok == wk && oi < wi)) {
        wk = ok;
        wi = oi;
      }
    }
    const unsigned mine =
        __ballot_sync(0xffffffffu, bh >= 0 && bk == wk && bi == wi);
    if (lane == __ffs(mine) - 1) {
      ++head[bh];
      out_v[static_cast<long long>(query) * k + j] = key_value(bk);
      out_i[static_cast<long long>(query) * k + j] = bi;
    }
  }
}

// the kernel for a metric and a query tile kept resident or streamed
using KernelFn = decltype(&distance_topk_kernel<false, false>);
KernelFn kernel_for(bool l2, bool stream) {
  if (stream)
    return l2 ? distance_topk_kernel<true, true>
              : distance_topk_kernel<false, true>;
  return l2 ? distance_topk_kernel<true, false>
            : distance_topk_kernel<false, false>;
}

}  // namespace

// The kernel's footprint at (d, k), into out[0..13]: dynamic shared memory,
// whether the lists sit in shared memory, the blocks an SM holds at that
// footprint (cudaOccupancyMaxActiveBlocksPerMultiprocessor), ring stages,
// slice depth, whether the query tile stays resident, then registers a
// thread and local (spill) bytes a thread of the dot and the l2 kernel with
// the query tile resident, and of the two with it streamed. Returns a
// cudaError_t.
extern "C" int distance_topk_attrs(int d, int k, long long* out) {
  if (d < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(d, k);
  const bool resident = query_resident(d);
  out[0] = smem;
  out[1] = lists_in_smem(d, k);
  const KernelFn kernel = kernel_for(false, !resident);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, irli::kTileThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = per_sm;
  out[3] = kStages;
  out[4] = kSliceK;
  out[5] = resident;
  for (int v = 0; v < 4; ++v) {
    const int e = irli::kernel_attrs(kernel_for(v & 1, v >> 1), out + 6 + 2 * v);
    if (e != 0) return e;
  }
  return 0;
}

// queries [Q, d] fp32 row-major, and (when the query tile is not resident,
// d > 288) their transpose qt [d, Q] with row stride ldqt (16-byte aligned,
// ldqt·4 a multiple of 16; else qt may be null); base [L, d] fp32 with row
// stride ldb (the same alignment); mask: byte (q, l) at mask[q·mask_ld + l]
// (mask_ld 0: one row for every query), nonzero keeps; qn [Q] and bn [L]
// the squared norms (read only when l2); part_v / part_i [splits, Q, k]
// scratch; out_v [Q, k] f32, out_i [Q, k] int32. Any Q, L, d >= 1, 1 <= k,
// 1 <= splits <= 1024. Returns cudaErrorInvalidValue for arguments it does
// not take, else cudaGetLastError() after the two launches (0 on success).
extern "C" int distance_topk_launch(const float* q, const float* qt,
                                    long long ldqt, const float* base,
                                    long long ldb,
                                    const unsigned char* mask,
                                    long long mask_ld, const float* qn,
                                    const float* bn, int Q, int L, int d,
                                    int k, int l2, int splits, float* part_v,
                                    int* part_i, float* out_v, int* out_i,
                                    void* stream) {
  const bool stream_q = !query_resident(d);
  if (Q < 1 || L < 1 || d < 1 || k < 1 || splits < 1 ||
      splits > kMaxSplits || (Q + kBM - 1) / kBM > 65535 ||
      smem_bytes(d, k) > kSmemLimit || ldb < d ||
      !irli::tma_aligned(base, 4, ldb, ldb) ||
      (stream_q && (ldqt < Q || !irli::tma_aligned(qt, 4, ldqt, ldqt)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mb, mq = {};
  if (!irli::operand_map<float>(&mb, base, 1, L, d, ldb, ldb * L, true) ||
      (stream_q &&
       !irli::operand_map<float>(&mq, qt, 1, d, Q, ldqt, ldqt * d, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(d, k);
  const KernelFn kernel = kernel_for(l2 != 0, stream_q);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L + kBN - 1) / kBN;
  const int tps = (tiles + splits - 1) / splits;
  const dim3 grid((Q + kBM - 1) / kBM, splits);
  kernel<<<grid, irli::kTileThreads, smem, st>>>(mb, mq, q, mask, mask_ld, qn,
                                                 bn, Q, L, d, k, tps, part_v,
                                                 part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Q * 32 + kMergeThreads - 1) / kMergeThreads;
  distance_topk_merge<<<blocks, kMergeThreads, 0, st>>>(part_v, part_i, Q,
                                                         splits, k, out_v,
                                                         out_i);
  return static_cast<int>(cudaGetLastError());
}
