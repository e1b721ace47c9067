// Device routines of FrequentOnes top-C, shared by freq_topc.cu and the
// fused query kernel (mega_query.cu): the bitonic sort of one row in shared
// memory and the run-length count that turns a sorted row into packed
// (count, position) keys.
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
// on a tie; count <= n <= 32768 keeps them in int32.
__device__ __forceinline__ int run_key(const int* a, int i, int n) {
  const int v = a[i];
  int cnt = 0;
  if (v != INT_MAX && (i == 0 || a[i - 1] != v)) {
    cnt = upper_bound(a, i + 1, n, v) - i;
  }
  return cnt * n + (n - 1 - i);
}

// Slot j of the top-C, decoded from the descending-sorted keys and the
// ascending-sorted ids: (id, count), or (-1, 0) past the distinct ids.
__device__ __forceinline__ void decode_slot(const int* keys, const int* srt,
                                            int j, int n, int* id,
                                            int* cnt) {
  *id = -1;
  *cnt = 0;
  if (j < n) {
    const int key = keys[j];
    *cnt = key / n;
    if (*cnt > 0) *id = srt[n - 1 - key % n];
  }
}

}  // namespace irli
