// Device routines of FrequentOnes top-C.
//
// The fused query kernel (mega_query.cu) and quant_rerank share the first
// part: the bitonic sort of one row in shared memory and the run-length
// count that turns a sorted row into packed (count, position) keys.
//
// freq_topc.cu's two kernels use the second part (namespace irli::radix):
// a stable ranking of one block's keys held in registers, 64 a thread
// (thread t: slots t·64 .. t·64+63), by a digit of at most 6 bits; the
// block scans, reductions and run lengths around it.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace irli {

// In-place bitonic sort of a[0:n] in shared memory (n a power of two),
// ascending or descending. Every thread of the block takes compare-exchange
// pairs; one barrier per pass, so every thread of the block must call it.
template <bool kDescending, typename K>
__device__ void bitonic_sort(K* a, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const bool up = ((i & k) == 0) != kDescending;
        const K x = a[i], y = a[p];
        if ((x > y) == up) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncthreads();
    }
  }
}

// First index in [lo, n) whose value exceeds v (a ascending).
__device__ __forceinline__ int upper_bound(const int* a, int lo, int n,
                                           int v) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The packed key of position i of a sorted row a[0:n] whose pads are
// INT_MAX: cnt·n + (n-1-i), where cnt is the run length if i starts a run
// of a real id and 0 otherwise — the TPU kernel's key. Keys are unique,
// the largest count first and the smaller position (= the smaller id) first
// on a tie. Key int holds them while n <= 32768 (count <= n); wider rows
// take long long keys.
template <typename Key = int>
__device__ __forceinline__ Key run_key(const int* a, int i, int n) {
  const int v = a[i];
  int cnt = 0;
  if (v != INT_MAX && (i == 0 || a[i - 1] != v)) {
    cnt = upper_bound(a, i + 1, n, v) - i;
  }
  return static_cast<Key>(cnt) * n + (n - 1 - i);
}

// Slot j of the top-C, decoded from the descending-sorted keys and the
// ascending-sorted ids: (id, count), or (-1, 0) past the distinct ids.
template <typename Key>
__device__ __forceinline__ void decode_slot(const Key* keys, const int* srt,
                                            int j, int n, int* id,
                                            int* cnt) {
  *id = -1;
  *cnt = 0;
  if (j < n) {
    const Key key = keys[j];
    *cnt = static_cast<int>(key / n);
    if (*cnt > 0) *id = srt[n - 1 - static_cast<int>(key % n)];
  }
}

namespace radix {

constexpr int kKeys = 64;              // keys a thread: slots t·64 .. t·64+63
constexpr int kMaxThreads = 512;
constexpr int kChunk = kKeys * kMaxThreads;  // keys one block holds: 32768
constexpr int kDigitBits = 6;          // a ranking pass's digit
constexpr int kBins = 1 << kDigitBits;
constexpr int kRed = 64;               // ints of block-reduction scratch
constexpr unsigned kNone = 0xffffffffu;  // a key no id or pad takes

// The id sort's digits: b = bit_length(pad) bits, pad = max_id + 1 (the
// key of every pad, so that pads sort last), in ceil(b / kDigitBits)
// passes of equal width. Host and device compute it alike.
struct Passes {
  int passes, bits;
};
__host__ __device__ inline Passes sort_passes(unsigned pad) {
  int b = 0;
  for (unsigned v = pad; v != 0; v >>= 1) ++b;
  const int passes = (b + kDigitBits - 1) / kDigitBits;
  return {passes, passes ? (b + passes - 1) / passes : 0};
}

// A row of slots in shared memory, one pad word after every 64, so that
// the 32 lanes of a warp reading slot t·64 + r hit 32 banks (a shift: a
// division of the signed p costs registers the row kernel has not got).
__host__ __device__ constexpr int padded(int p) { return p + (p >> 6); }
static_assert(kKeys == 64, "padded() pads after every kKeys slots");

// The rank counters: a 16-bit counter per (digit, thread), digit-major,
// two to a word, one pad word after every 16 (so that a thread's words of
// the scan hit other banks than its neighbours'). Words at `threads`.
__host__ __device__ constexpr int counter_words(int threads) {
  return kBins * threads / 2 + kBins * threads / 32;
}
static_assert(kBins % 32 == 0, "scan_counters: whole runs of 16 words");
__device__ __forceinline__ unsigned* counter(unsigned* cnt, unsigned d) {
  const int w = d * (blockDim.x >> 1) + (threadIdx.x >> 1);
  return cnt + w + (w >> 4);
}
__device__ __forceinline__ int counter_shift() {
  return (threadIdx.x & 1) << 4;
}

// The digits of a ranking pass, from a key's value: the id sort's digit at
// `shift`, and the count windows' (WindowDigit below).
struct SortDigit {
  int shift;
  unsigned mask;
  __device__ __forceinline__ unsigned operator()(unsigned key) const {
    return (key >> shift) & mask;
  }
};

// v, which the compiler may not assume it knows: each walk computes
// its keys' digits anew rather than keep another walk's kKeys digits live.
__device__ __forceinline__ unsigned opaque(unsigned v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Walk 1 of a ranking pass: each thread counts its keys by digit in its own
// counters (zeroed). Shared-memory atomics, so that no key waits on the
// last one's count.
template <class Digit>
__device__ __forceinline__ void count_keys(const unsigned (&keys)[kKeys],
                                           Digit digit, unsigned* cnt) {
  const unsigned one = 1u << counter_shift();
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    atomicAdd(counter(cnt, digit(opaque(keys[r]))), one);
  }
}

// Walk 2, one key at a time in r order, after scan_counters: the key's
// stable rank. Ranks run over digits first, then threads, then r: the slot
// order breaks ties, so each pass is stable.
__device__ __forceinline__ int rank_key(unsigned d, unsigned* cnt) {
  const int sh = counter_shift();
  return (atomicAdd(counter(cnt, d), 1u << sh) >> sh) & 0xffffu;
}

// The block's exclusive prefix of one int a thread, and the total, by warp
// shuffles and a pass over the warp sums. red: kRed ints of shared memory.
__device__ inline int block_prefix(int v, int* total, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[w] = x;
  __syncthreads();
  if (w == 0) {
    const int s = lane < nw ? red[lane] : 0;
    int is = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, is, o);
      if (lane >= o) is += y;
    }
    if (lane < nw) red[lane] = is - s;
    if (lane == 31) red[32] = is;
  }
  __syncthreads();
  const int before = red[w] + x - v;
  *total = red[32];
  __syncthreads();
  return before;
}

// The counters turned into each (digit, thread)'s first rank: an exclusive
// prefix over digits, then threads. Thread t scans the kBins / 2 words
// that follow kBins / 2 · t (kBins counters). Ranks stay under 2^16 (a
// block holds 32768 keys).
__device__ inline void scan_counters(unsigned* cnt, int* red) {
  constexpr int kWords = kBins / 2;
  unsigned* run = cnt + threadIdx.x * (kWords + kWords / 16);
  int s = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const unsigned v = run[i + i / 16];
    s += (v & 0xffffu) + (v >> 16);
  }
  int total;
  unsigned at = block_prefix(s, &total, red);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const unsigned v = run[i + i / 16];
    const unsigned lo = at;
    at += v & 0xffffu;
    run[i + i / 16] = lo | (at << 16);
    at += v >> 16;
  }
  __syncthreads();
}

// The first rank of digit d in the scanned counters (thread 0's).
__device__ __forceinline__ int digit_start(const unsigned* cnt, int d) {
  const int w = d * (blockDim.x >> 1);
  return cnt[w + (w >> 4)] & 0xffffu;
}

// In-place exclusive prefix sum of a[0:len] (global memory) by the whole
// block, each thread a run of consecutive entries.
__device__ inline void block_scan_excl(int* a, int len, int* red) {
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, len);
  const int hi = min(lo + per, len);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int total;
  int run = block_prefix(s, &total, red);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// The block's max of mx and sum of sm, to every thread. red: kRed ints.
__device__ inline void block_max_sum(int* mx, int* sm, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int m = __reduce_max_sync(0xffffffffu, *mx);
  const int s = __reduce_add_sync(0xffffffffu, *sm);
  if (lane == 0) {
    red[w] = m;
    red[32 + w] = s;
  }
  __syncthreads();
  *mx = red[0];
  *sm = red[32];
  for (int i = 1; i < nw; ++i) {
    *mx = max(*mx, red[i]);
    *sm += red[32 + i];
  }
  __syncthreads();
}

// Zero a[0:len] (shared), the whole block.
__device__ __forceinline__ void block_zero(unsigned* a, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) a[i] = 0;
}

// The kKeys ids a thread takes of a segment of kKeys·blockDim elements that
// starts at element `base` of src: pads (negative ids, and elements at or
// past `valid`) read as -1. Any assignment of the segment's elements to
// slots serves the first pass (the id sort orders equal ids alike), so the
// loads are striped across the block; with `vec` (src 16-byte aligned,
// valid a multiple of 4) a thread reads 4 neighbours at once.
__device__ __forceinline__ void load_ids(unsigned (&keys)[kKeys],
                                         const int* __restrict__ src,
                                         long long base, long long valid,
                                         bool vec) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      const long long e = base + 4LL * (j * nt + t);
      const int4 v = e < valid ? __ldg(reinterpret_cast<const int4*>(src + e))
                               : make_int4(-1, -1, -1, -1);
      keys[4 * j] = v.x;
      keys[4 * j + 1] = v.y;
      keys[4 * j + 2] = v.z;
      keys[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const long long e = base + r * nt + t;
      keys[r] = e < valid ? __ldg(src + e) : -1;
    }
  }
}

// The largest id among the keys (negative: pads), or -1.
__device__ __forceinline__ int max_id(const unsigned (&keys)[kKeys]) {
  int mx = -1;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) mx = max(mx, static_cast<int>(keys[r]));
  return mx;
}

// A sorted row's key at position p, the row in global memory (the wide
// kernel's; freq_topc.cu's ClusterRow reads the cluster's shared rows).
struct PlainRow {
  const unsigned* a;
  __device__ __forceinline__ unsigned operator()(int p) const { return a[p]; }
};

// First position of the run through position p of an ascending row (at(p)
// == key): gallops back 1, 2, 4, ... positions, then bisects.
template <class At>
__device__ __forceinline__ int run_start(At at, int p, unsigned key) {
  int hi = p, lo = -1;
  for (int step = 1;; step <<= 1) {
    const int q = hi - step;
    if (q < 0) break;
    if (at(q) != key) {
      lo = q;
      break;
    }
    hi = q;
  }
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (at(mid) == key) hi = mid; else lo = mid;
  }
  return hi;
}

// Run counts over a thread's sorted keys at slots p0 .. p0+kKeys-1: the slot
// that ends a run of a real id (not `pad`) takes the run's length, every
// other slot 0, in place of its key. prev: the key at p0 - 1 (kNone at 0),
// next: at p0 + kKeys (kNone past the row); start: the first position of the
// run through p0 (run_start, when prev equals keys[0]). The thread's most
// runs and count go to maxc and runs.
__device__ __forceinline__ void run_counts(unsigned (&keys)[kKeys], int p0,
                                           int start, unsigned next,
                                           unsigned pad, int* maxc,
                                           int* runs) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const unsigned key = keys[r];
    const unsigned after = r + 1 < kKeys ? keys[r + 1] : next;
    const int c = key != pad && after != key ? p0 + r - start + 1 : 0;
    if (after != key) start = p0 + r + 1;
    keys[r] = c;
    *maxc = max(*maxc, c);
    *runs += c > 0;
  }
}

// The count ranking's window: the counts in (hi - 63, hi] take digit
// hi - count (largest count first); every other slot, and slots that end
// no run (count 0), take the last bin, past every ranked one.
struct WindowDigit {
  int hi;
  __device__ __forceinline__ unsigned operator()(unsigned key) const {
    const int c = static_cast<int>(key);
    return c > 0 && c > hi - (kBins - 1) && c <= hi
               ? static_cast<unsigned>(hi - c) : kBins - 1;
  }
  // the largest count below this window, or 0
  __device__ __forceinline__ int below(const unsigned (&keys)[kKeys]) const {
    int b = 0;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int c = static_cast<int>(opaque(keys[r]));
      if (c > 0 && c <= hi - (kBins - 1)) b = max(b, c);
    }
    return b;
  }
};

}  // namespace radix
}  // namespace irli
