// FrequentOnes top-C: the C most frequent candidate ids of each row,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/freq_topc/freq_topc.py
// (freq_topc, pallas_call at :144; tile body freq_topc_tile). Output is
// bit-identical to it and to the plain version (ref.py): ids [Q, C] int32
// by count descending, ties toward the smaller id, -1 past the distinct
// candidate count; counts [Q, C] float32, 0 there.
//
// What bounds it on the H100: memory says ~42 us for [1024, 32000] (the
// input read once, the outputs written once, at 3.35 TB/s). The work is a
// sort of each row, and the design keeps that sort's passes few and its
// keys in registers: the TPU kernel's bitonic networks take
// log2(n)·(log2(n)+1)/2 = 120 passes over a 32768-wide row, each a block
// barrier, twice; here a row takes ceil(b / 6) radix passes over the b bits
// its largest id needs (4 at the deep1b cell's ids under 2^21), each two
// walks of one shared-memory atomic a key and one scatter through shared
// memory, and the top-C one more ranking pass over the run counts.
//
// freq_topc_kernel: a thread block cluster of one block a chunk of kChunk
// = 32768 ids (512 threads, 64 ids a thread in registers, 128 registers a
// thread), up to kMaxCluster = 8 blocks a row; rows up to 32768 take one
// block of 32·ceil(C0 / 2048) threads. The routines are freq_topc.cuh's
// irli::radix.
//   1. Load the chunk into registers (16-byte loads where the row is
//      aligned). A cluster max over the real ids gives pad = max_id + 1,
//      the key of every pad (negative id), so pads sort last; b =
//      bit_length(pad). No padding to a power of two.
//   2. LSD radix passes over b bits, <= 6 a digit. Each pass: each thread
//      counts its keys by digit in its own 16-bit counters (a shared-memory
//      atomic a key, so no key waits on the last), the block scans the
//      [64 digits][threads] counters, the blocks of the cluster exchange
//      their 64 digit totals, and each thread walks its keys again, takes
//      each key's rank from an atomic on its counter, and writes the key to
//      its place in the shared row of the block that holds that rank
//      (distributed shared memory). After a cluster barrier each thread
//      reads back its 64 slots t·64 .. t·64+63. Ranks run digit, block,
//      thread, then key order, so each pass is stable and the row ends
//      ascending.
//   3. Runs: equal ids are contiguous and a thread's 64 slots are
//      consecutive, so a thread counts its runs in registers; a run that
//      starts in an earlier thread is found by galloping back (in a
//      neighbouring block's row if need be). Each run's count sits at its
//      last slot, in place of the key; the ids stay in the shared rows.
//   4. Top-C without a second sort: one more ranking pass over the run
//      ends, digit = hi - count for counts in (hi - 63, hi] (hi the
//      largest count; everything else in the last bin). Ranks run count
//      descending, then position, so a run's rank is its output slot:
//      slots < C take (id, count). A row whose counts spread wider than 63
//      takes a next window from the largest count below it, until C slots
//      are filled. The slots past the row's run count take -1/0.
//
// freq_topc_wide_kernel takes rows past 8 chunks (up to the wrapper's
// 2^30): one block of kWideThreads = 256 a row (255 registers a thread,
// beside its 64 keys), the same routines chunk by chunk of 16384. Each
// pass first counts every chunk's digits into a global [64, chunks] table
// and scans it; then it ranks each chunk in registers, scatters it in
// shared memory, and writes it out digit by digit to its place in the
// other of two global scratch rows (ping-pong), so the writes of a
// digit's keys are contiguous. The runs take a global count row; the
// top-C windows rank its chunks the same way and write the output slots
// directly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "freq_topc.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace irli::radix;

constexpr int kMaxCluster = 8;  // blocks a cluster (the portable most)
// The wide kernel's blocks: 256 threads, so that a thread may take 255
// registers beside its 64 keys and the kernel's many row pointers.
constexpr int kWideThreads = 256;
constexpr int kWideChunk = kKeys * kWideThreads;  // 16384

// Shared bytes of the row kernel at `threads` threads: the padded row, the
// counters, the reduction scratch, the cluster's exchange area.
constexpr int kExchangeInts = 3 * kBins + 3 + kMaxCluster * (kBins + 2);
constexpr int row_smem(int threads) {
  return (padded(threads * kKeys) + counter_words(threads) + kRed +
          kExchangeInts) * 4;
}
// Of the wide kernel: one chunk's padded staging row, the counters, a
// chunk's digit starts and global bases, the reduction scratch.
constexpr int kWideSmem =
    (padded(kWideChunk) + counter_words(kWideThreads) + 2 * kBins + kRed) * 4;

// Ints of global scratch a row of the wide kernel takes: two rows of
// chunks·kWideChunk keys and the [kBins, chunks] chunk-digit table.
__host__ __device__ constexpr long long wide_scratch_ints(int chunks) {
  return 2LL * chunks * kWideChunk + static_cast<long long>(kBins) * chunks;
}

__device__ __forceinline__ void fill_empty(int* oid, float* ocnt, int from,
                                           int C) {
  for (int j = from + threadIdx.x; j < C; j += blockDim.x) {
    oid[j] = -1;
    ocnt[j] = 0.0f;
  }
}

// One ranking pass's first half: the counters zeroed, counted, scanned.
template <class Digit>
__device__ __forceinline__ void count_and_scan(const unsigned (&keys)[kKeys],
                                               Digit digit, unsigned* cnt,
                                               int* red) {
  block_zero(cnt, counter_words(blockDim.x));
  __syncthreads();
  count_keys(keys, digit, cnt);
  __syncthreads();
  scan_counters(cnt, red);
}

// The cluster's blocks' exchange area (shared memory, read by the other
// blocks of the cluster): each digit's count in this block, its first rank
// in the block, and its first rank in the row; the keys of the row below
// the last digit; two ints of reductions; and every block's of these,
// copied in by one remote load a thread.
struct Exchange {
  int total[kBins], start[kBins], base[kBins];
  int ranked, mx, sm;
  int all[kMaxCluster][kBins];        // every block's totals, copied here
  int all_mx[kMaxCluster], all_sm[kMaxCluster];
};
static_assert(sizeof(Exchange) == kExchangeInts * 4, "row_smem's count");

// Each digit's first rank and count in this block, from its scanned
// counters (n slots), into the exchange area.
__device__ __forceinline__ void block_totals(const unsigned* cnt, int n,
                                             Exchange* x) {
  for (int d = threadIdx.x; d < kBins; d += blockDim.x) {
    x->start[d] = digit_start(cnt, d);
    x->total[d] = (d + 1 < kBins ? digit_start(cnt, d + 1) : n) -
                  x->start[d];
  }
}

// Each digit's first rank in the row, from every block's totals (the
// blocks of a cluster hold consecutive chunks of the row): the digits
// below it in all blocks, then the digit in the blocks before this one;
// and the row's count of keys below the last digit (the same in every
// block). The cluster has synced since the totals were set.
__device__ __forceinline__ void row_bases(cg::cluster_group& cluster,
                                          Exchange* x) {
  const int me = cluster.block_rank(), nb = cluster.num_blocks();
  for (int i = threadIdx.x; i < nb * kBins; i += blockDim.x) {
    x->all[i / kBins][i % kBins] =
        cluster.map_shared_rank(x, i / kBins)->total[i % kBins];
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= kBins; t += blockDim.x) {
    const int d = t < kBins ? t : kBins - 1;
    int base = 0;
    for (int b = 0; b < nb; ++b) {
      for (int e = 0; e < d; ++e) base += x->all[b][e];
      if (t < kBins && b < me) base += x->all[b][d];
    }
    if (t < kBins) x->base[d] = base; else x->ranked = base;
  }
  __syncthreads();
}

// The cluster's max of mx and sum of sm (block_max_sum, then every
// block's through the exchange area).
__device__ __forceinline__ void cluster_max_sum(cg::cluster_group& cluster,
                                                Exchange* x, int* mx, int* sm,
                                                int* red) {
  block_max_sum(mx, sm, red);
  if (threadIdx.x == 0) {
    x->mx = *mx;
    x->sm = *sm;
  }
  cluster.sync();
  const int nb = cluster.num_blocks();
  if (threadIdx.x < nb) {
    const Exchange* o = cluster.map_shared_rank(x, threadIdx.x);
    x->all_mx[threadIdx.x] = o->mx;
    x->all_sm[threadIdx.x] = o->sm;
  }
  cluster.sync();
  *mx = INT_MIN;
  *sm = 0;
  for (int b = 0; b < nb; ++b) {
    *mx = max(*mx, x->all_mx[b]);
    *sm += x->all_sm[b];
  }
}

// A row's key at position p, held by the cluster's blocks kChunk a block.
struct ClusterRow {
  cg::cluster_group* cluster;
  unsigned* row;
  int n;
  __device__ __forceinline__ unsigned operator()(int p) const {
    return cluster->map_shared_rank(row, p / n)[padded(p % n)];
  }
};

// Rows up to kMaxCluster·kChunk wide: a cluster of ceil(C0 / kChunk)
// blocks a row, each a chunk of 64 ids a thread (one block of
// 32·ceil(C0 / 2048) threads for rows up to kChunk). A pass scatters each
// key into the shared row of the block that holds its rank.
__global__ void __launch_bounds__(kMaxThreads)
    freq_topc_kernel(const int* __restrict__ cands, int C0, int C, bool vec,
                     int* __restrict__ out_ids,
                     float* __restrict__ out_cnt) {
  extern __shared__ unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = cluster.num_blocks(), me = cluster.block_rank();
  const int n = blockDim.x * kKeys, p0 = threadIdx.x * kKeys;
  const int g0 = me * n;  // the block's first position in the row
  unsigned* row = smem;
  unsigned* cnt = smem + padded(n);
  int* red = reinterpret_cast<int*>(cnt + counter_words(blockDim.x));
  Exchange* x = reinterpret_cast<Exchange*>(red + kRed);
  const long long q = blockIdx.x / nb;
  int* oid = out_ids + q * C;
  float* ocnt = out_cnt + q * C;

  // 1. the ids, their largest, the pad key
  unsigned keys[kKeys];
  load_ids(keys, cands + q * C0, g0, C0, vec);
  int mx = max_id(keys), unused = 0;
  cluster_max_sum(cluster, x, &mx, &unused, red);
  const unsigned pad = static_cast<unsigned>(mx) + 1u;
  if (pad == 0) {  // no real id in the row
    if (me == 0) fill_empty(oid, ocnt, 0, C);
    return;
  }
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    if (static_cast<int>(keys[r]) < 0) keys[r] = pad;
  }

  // 2. the radix passes: rank, scatter to the row (of the block that holds
  // the rank), read back in slot order
  const Passes ps = sort_passes(pad);
  for (int pass = 0; pass < ps.passes; ++pass) {
    const SortDigit digit{pass * ps.bits, (1u << ps.bits) - 1};
    count_and_scan(keys, digit, cnt, red);
    block_totals(cnt, n, x);
    cluster.sync();
    row_bases(cluster, x);
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const unsigned k = opaque(keys[r]), d = digit(k);
      const int at = x->base[d] + rank_key(d, cnt) - x->start[d];
      // more than one block: n == kChunk
      unsigned* to = nb == 1 ? row : cluster.map_shared_rank(row, at / kChunk);
      to[padded(nb == 1 ? at : at % kChunk)] = k;
    }
    cluster.sync();
#pragma unroll
    for (int r = 0; r < kKeys; ++r) keys[r] = row[padded(p0 + r)];
  }

  // 3. runs: each run's count at its last slot, in place of the key
  const ClusterRow sorted{&cluster, row, n};
  const int g = g0 + p0, last = nb * n;
  const unsigned prev = g > 0 ? sorted(g - 1) : kNone;
  const unsigned next = g + kKeys < last ? sorted(g + kKeys) : kNone;
  const int start = prev == keys[0] ? run_start(sorted, g, keys[0]) : g;
  int maxc = 0, runs = 0;
  run_counts(keys, g, start, next, pad, &maxc, &runs);
  cluster_max_sum(cluster, x, &maxc, &runs, red);

  // 4. top-C: ranking windows over the counts, largest first
  int placed = 0;
  for (int hi = maxc; hi > 0 && placed < C;) {
    const WindowDigit digit{hi};
    int below = digit.below(keys);
    count_and_scan(keys, digit, cnt, red);
    block_totals(cnt, n, x);
    cluster_max_sum(cluster, x, &below, &unused, red);
    row_bases(cluster, x);
    const int ranked = x->ranked;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const unsigned k = opaque(keys[r]), d = digit(k);
      const int j = placed + x->base[d] + rank_key(d, cnt) - x->start[d];
      if (d < kBins - 1 && j < C) {
        oid[j] = static_cast<int>(row[padded(p0 + r)]);
        ocnt[j] = static_cast<float>(static_cast<int>(k));
      }
    }
    cluster.sync();
    placed += ranked;
    hi = below;
  }
  if (me == 0) fill_empty(oid, ocnt, min(runs, C), C);
}

// The wide kernel's chunk k of a pass's input into keys: the ids (pass 0,
// in == nullptr; pads to `pad`; any slot order) or, in slot order (thread
// t: positions t·32 .. t·32+31), a row the block wrote (plain loads: the
// read-only path does not see the block's own writes).
__device__ __forceinline__ void load_chunk(unsigned (&keys)[kKeys],
                                           const int* __restrict__ src,
                                           const unsigned* in, int k, int C0,
                                           bool vec, unsigned pad) {
  if (in == nullptr) {
    load_ids(keys, src, static_cast<long long>(k) * kWideChunk, C0, vec);
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      if (static_cast<int>(keys[r]) < 0) keys[r] = pad;
    }
    return;
  }
  const uint4* at =
      reinterpret_cast<const uint4*>(in + k * kWideChunk + threadIdx.x * kKeys);
#pragma unroll
  for (int j = 0; j < kKeys / 4; ++j) {
    const uint4 v = at[j];
    keys[4 * j] = v.x;
    keys[4 * j + 1] = v.y;
    keys[4 * j + 2] = v.z;
    keys[4 * j + 3] = v.w;
  }
}

// Chunk k's count of each digit into hist[d, k], from its scanned counters.
__device__ __forceinline__ void chunk_totals(const unsigned* cnt, int* hist,
                                             int chunks, int k) {
  if (threadIdx.x < kBins) {
    const int d = threadIdx.x;
    const int end = d + 1 < kBins ? digit_start(cnt, d + 1) : kWideChunk;
    hist[d * chunks + k] = end - digit_start(cnt, d);
  }
}

// Rows past kMaxCluster chunks of kChunk: one block of kWideThreads a row,
// `chunks` chunks of kWideChunk slots; scratch: wide_scratch_ints(chunks)
// ints a row.
__global__ void __launch_bounds__(kWideThreads)
    freq_topc_wide_kernel(const int* __restrict__ cands, int C0, int chunks,
                          int C, bool vec, unsigned* scratch,
                          int* __restrict__ out_ids,
                          float* __restrict__ out_cnt) {
  extern __shared__ unsigned smem[];
  const int p0 = threadIdx.x * kKeys;  // within a chunk
  unsigned* stage = smem;
  unsigned* cnt = smem + padded(kWideChunk);
  int* lstart = reinterpret_cast<int*>(cnt + counter_words(kWideThreads));
  int* gbase = lstart + kBins;
  int* red = gbase + kBins;
  const long long q = blockIdx.x;
  const int n = chunks * kWideChunk;
  unsigned* A = scratch + q * wide_scratch_ints(chunks);
  unsigned* B = A + n;
  int* hist = reinterpret_cast<int*>(B + n);  // [kBins, chunks]
  const int* src = cands + q * C0;
  int* oid = out_ids + q * C;
  float* ocnt = out_cnt + q * C;

  // 1. the largest id, the pad key
  unsigned keys[kKeys];
  int mx = -1, unused = 0;
  for (int k = 0; k < chunks; ++k) {
    load_ids(keys, src, static_cast<long long>(k) * kWideChunk, C0, vec);
    mx = max(mx, max_id(keys));
  }
  block_max_sum(&mx, &unused, red);
  const unsigned pad = static_cast<unsigned>(mx) + 1u;
  if (pad == 0) {
    fill_empty(oid, ocnt, 0, C);
    return;
  }

  // 2. the radix passes, between A and B: every chunk's digit totals,
  // scanned; then each chunk ranked, staged, written out digit by digit
  const Passes ps = sort_passes(pad);
  for (int pass = 0; pass < ps.passes; ++pass) {
    const unsigned* in = pass == 0 ? nullptr : (pass % 2 ? A : B);
    unsigned* out = pass % 2 ? B : A;
    const SortDigit digit{pass * ps.bits, (1u << ps.bits) - 1};
    for (int k = 0; k < chunks; ++k) {
      load_chunk(keys, src, in, k, C0, vec, pad);
      count_and_scan(keys, digit, cnt, red);
      chunk_totals(cnt, hist, chunks, k);
      __syncthreads();
    }
    block_scan_excl(hist, kBins * chunks, red);
    for (int k = 0; k < chunks; ++k) {
      load_chunk(keys, src, in, k, C0, vec, pad);
      count_and_scan(keys, digit, cnt, red);
      if (threadIdx.x < kBins) {
        lstart[threadIdx.x] = digit_start(cnt, threadIdx.x);
        gbase[threadIdx.x] = hist[threadIdx.x * chunks + k];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const unsigned k = opaque(keys[r]);
        stage[padded(rank_key(digit(k), cnt))] = k;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kWideChunk; i += blockDim.x) {
        const unsigned key = stage[padded(i)];
        const unsigned d = digit(key);
        out[gbase[d] + i - lstart[d]] = key;
      }
      __syncthreads();
    }
  }
  const unsigned* S = ps.passes % 2 ? A : B;  // the sorted row
  unsigned* counts = ps.passes % 2 ? B : A;

  // 3. runs: each run's count at its last slot of the count row
  int maxc = 0, runs = 0;
  for (int k = 0; k < chunks; ++k) {
    const int p = k * kWideChunk + p0;
    load_chunk(keys, src, S, k, C0, vec, pad);
    const unsigned prev = p > 0 ? S[p - 1] : kNone;
    const unsigned next = p + kKeys < n ? S[p + kKeys] : kNone;
    const int start = prev == keys[0] ? run_start(PlainRow{S}, p, keys[0]) : p;
    run_counts(keys, p, start, next, pad, &maxc, &runs);
    uint4* to = reinterpret_cast<uint4*>(counts + p);
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      to[j] = make_uint4(keys[4 * j], keys[4 * j + 1], keys[4 * j + 2],
                         keys[4 * j + 3]);
    }
  }
  block_max_sum(&maxc, &runs, red);

  // 4. top-C: ranking windows over the count row, largest count first
  int placed = 0;
  for (int hi = maxc; hi > 0 && placed < C;) {
    const WindowDigit digit{hi};
    int below = 0;
    for (int k = 0; k < chunks; ++k) {
      load_chunk(keys, src, counts, k, C0, vec, pad);
      below = max(below, digit.below(keys));
      count_and_scan(keys, digit, cnt, red);
      chunk_totals(cnt, hist, chunks, k);
      __syncthreads();
    }
    block_scan_excl(hist, kBins * chunks, red);
    const int ranked = hist[(kBins - 1) * chunks];
    block_max_sum(&below, &unused, red);
    for (int k = 0; k < chunks; ++k) {
      load_chunk(keys, src, counts, k, C0, vec, pad);
      count_and_scan(keys, digit, cnt, red);
      if (threadIdx.x < kBins) {
        lstart[threadIdx.x] = digit_start(cnt, threadIdx.x);
        gbase[threadIdx.x] = hist[threadIdx.x * chunks + k];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const unsigned c = opaque(keys[r]), d = digit(c);
        const int rank = rank_key(d, cnt);
        if (d < kBins - 1) {
          const int j = placed + gbase[d] + rank - lstart[d];
          if (j < C) {
            oid[j] = static_cast<int>(S[k * kWideChunk + p0 + r]);
            ocnt[j] = static_cast<float>(static_cast<int>(c));
          }
        }
      }
      __syncthreads();
    }
    placed += ranked;
    hi = below;
  }
  fill_empty(oid, ocnt, min(runs, C), C);
}

// The launch plan (ops.radix_plan is its Python twin): the kernel (0 the
// row kernel, 1 the wide one), blocks a row (a cluster), threads, chunks,
// slots, dynamic shared bytes, global scratch ints a row.
struct Plan {
  int wide, cluster, threads, chunks, slots, smem;
  long long scratch;
};
Plan launch_plan(int C0) {
  Plan p{};
  p.chunks = (C0 + kChunk - 1) / kChunk;
  p.wide = p.chunks > kMaxCluster;
  if (p.wide) {
    p.chunks = (C0 + kWideChunk - 1) / kWideChunk;
    p.cluster = 1;
    p.threads = kWideThreads;
    p.slots = p.chunks * kWideChunk;
    p.smem = kWideSmem;
    p.scratch = wide_scratch_ints(p.chunks);
  } else if (p.chunks > 1) {
    p.cluster = p.chunks;
    p.threads = kMaxThreads;
    p.slots = p.chunks * kChunk;
    p.smem = row_smem(kMaxThreads);
    p.scratch = 0;
  } else {
    const int warps = C0 < 1 ? 1 : (C0 + 32 * kKeys - 1) / (32 * kKeys);
    p.cluster = 1;
    p.threads = warps * 32;
    p.slots = p.threads * kKeys;
    p.smem = row_smem(p.threads);
    p.scratch = 0;
  }
  return p;
}

int kernel_attrs(const void* kernel, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  return 0;
}

}  // namespace

// The launch plan at row width C0 whose largest id is max_id: out = the
// kernel (0 row, 1 wide), blocks a row, threads, chunks, slots, dynamic
// shared bytes, scratch ints a row, radix passes, digit bits.
extern "C" int freq_topc_plan(int C0, int max_id, long long* out) {
  if (C0 < 1 || C0 > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = launch_plan(C0);
  const Passes ps = sort_passes(static_cast<unsigned>(max_id) + 1u);
  const long long v[] = {p.wide,  p.cluster, p.threads, p.chunks, p.slots,
                         p.smem,  p.scratch, ps.passes, ps.bits};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Registers and local (spill) bytes a thread, and the largest dynamic
// shared bytes, of the row kernel (out[0:3]) and the wide kernel
// (out[3:6]).
extern "C" int freq_topc_attrs(long long* out) {
  int err = kernel_attrs(reinterpret_cast<const void*>(freq_topc_kernel), out);
  if (err != 0) return err;
  out[2] = row_smem(kMaxThreads);
  err = kernel_attrs(reinterpret_cast<const void*>(freq_topc_wide_kernel),
                     out + 3);
  out[5] = kWideSmem;
  return err;
}

// cands [Q, C0] int32 (pad: any negative id), 1 <= C0 <= 2^30; scratch:
// [Q, plan scratch ints] (rows past kMaxCluster chunks; else unused, may be
// null); out_ids [Q, C] int32, out_cnt [Q, C] f32. One launch. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int freq_topc_launch(const int* cands, int Q, int C0, int C,
                                unsigned* scratch, int* out_ids,
                                float* out_cnt, void* stream) {
  if (C0 < 1 || C0 > (1 << 30) || C < 1 || Q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) return 0;
  const Plan p = launch_plan(C0);
  const bool vec =
      C0 % 4 == 0 && reinterpret_cast<uintptr_t>(cands) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.wide) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        freq_topc_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    freq_topc_wide_kernel<<<Q, p.threads, p.smem, s>>>(
        cands, C0, p.chunks, C, vec, scratch, out_ids, out_cnt);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      freq_topc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Q) * p.cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, freq_topc_kernel, cands, C0, C, vec,
                           out_ids, out_cnt);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
