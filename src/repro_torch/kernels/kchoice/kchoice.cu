// Exact power-of-K re-assignment (Alg. 1's re-partition, Thm. 2's process),
// hand-written for Hopper (sm_90a).
//
// There is no TPU kernel to replace: the reference runs this step as a
// lax.scan over the labels (src/repro/core/repartition.py kchoice_exact,
// the scan at :93), which XLA compiles to a sequential loop. Its semantics,
// shared with the plain version (ref.py): labels are taken in the given
// insertion order; each goes to the FIRST of its K candidate buckets (in
// descending affinity) that holds the least float32 load (-0.0 equal to
// +0.0), and that load grows by the label's weight. Bit for bit: the same
// adds in the same order.
//
// What bounds it on the H100: the process looks sequential, but label i
// depends on an earlier label only where that label was placed in one of
// i's K candidates. The longest such chain of a rep (its dependence depth,
// ref.dependence_depth) times the cheapest link the card can chain (a min
// of two loads and an add, in registers: kchoice_step_cycles measures it)
// bounds any exact walk from below; the bytes (the [R, L, K] candidates,
// the order, the assignment, the starting loads and weights, each once)
// are the other bound. On uniform candidates at R = 32, L = 131072,
// B = 20000, K = 10 the depth is about 170 and the bytes bound it (201 MB,
// 0.06 ms); a fit's real candidate lists are hot (depth up to 58,435
// there) and the chain bounds it.
//
// Design: one block a rep, its [B] loads and a one-byte claim table in
// shared memory (100 KB at B = 20000). Warp 0 walks the labels in windows
// of 32, one label a lane. Each lane takes the first least-loaded of its K
// candidates from the window's starting loads (its K reads independent).
// The lowest lane that chose each bucket claims it (a plain store, then
// __match_any_sync only where two lanes chose one bucket); a lane is dirty
// when an earlier lane of the window claimed one of its candidates. The
// lanes before the first dirty one commit together: none of them saw a
// load another changed, and their buckets are distinct. Where walk_below
// or more are clean (uniform-like lists) the next window starts at the
// first dirty lane (the first lane is never dirty); where fewer are, as on
// hot candidate lists, the rest of the window is walked in registers: each
// lane holds its candidates' loads (K <= walk_max_k <= 16), and lane by
// lane a label's bucket and new load go by shuffle to the later lanes,
// which update and choose again. The caller passes walk_below and
// walk_max_k (ref.WALK_BELOW, ref.WALK_MAX_K, which the plain schedule
// follows too). Either way each bucket receives the sequential walk's adds
// in its order.
// Meanwhile warps 1-8 gather chunks of 256 labels (ids, weights, candidate
// rows, in insertion order) from device memory into a ring of three, two
// chunks ahead of the walk, so the walk reads shared memory only and a
// window may cross a chunk's edge.
//
// Slots (the MoE router's top-k, src/repro/models/moe.py:81-118): with
// slots = S > 1 each label takes S distinct candidates in turn, slot j the
// first least-loaded of those its earlier slots did not take, each pick
// adding the label's weight. The walk is then over the L·S (label, slot)
// picks: the ring stages picks, and a label's picks sit in neighbouring
// lanes. A label's second pick always waits on its first (they share the
// K candidates), so no window has a clean prefix worth committing: each
// window holds the picks of 32 / S whole labels and is walked in
// registers from its first lane, a lane striking its own label's earlier
// picks from its candidates (+inf) where another label's pick would give
// the bucket's new load. At S = 1 none of this runs.
#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;                  // labels a window, one a lane
constexpr int kChunk = 256;                  // labels a staged chunk
constexpr int kRing = 3 * kChunk;            // staged label slots
constexpr int kThreads = kWindow + kChunk;   // warp 0 walks, 1-8 stage
constexpr int kGroup = 16;                   // candidates staged at once
constexpr unsigned char kFree = 0xFF;        // an unclaimed bucket
constexpr int kMaxKG = 16;                   // candidates a lane holds

// Staging thread t gathers pick s = c·kChunk + t of the walk (chunk c; the
// pick of slot s mod S of label s / S of the insertion order) into ring
// slot s mod kRing: its label's id, weight and K candidates, transposed
// ([K][kRing]) so that the walk's lanes read neighbouring words.
__device__ void stage(const int* __restrict__ topk,
                      const int* __restrict__ order,
                      const float* __restrict__ w, long long g, int L, int S,
                      int K, int c, int t, int* cand, int* lbl, float* wt) {
  const int s = c * kChunk + t;
  if (s >= L * S) return;
  const int l = order[g * L + (S > 1 ? s / S : s)];
  const int p = s % kRing;
  const float wl = w ? w[l] : 1.0f;
  const int* row = topk + (g * L + l) * K;
  for (int j0 = 0; j0 < K; j0 += kGroup) {
    int v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j0 + u < K) v[u] = row[j0 + u];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j0 + u < K) cand[(j0 + u) * kRing + p] = v[u];
    }
  }
  lbl[p] = l;
  wt[p] = wl;
}

// One lane's label of a window, read from the ring ahead of the window:
// its ring slot, id, weight and first KG candidates. Candidates past K
// repeat the last one: a repeat changes neither the first minimum nor the
// dirty test, and every read is unconditional.
template <int KG>
struct Label {
  int q, l;
  float wl;
  int b[KG];

  __device__ void read(const int* cand, const int* lbl, const float* wt,
                       int K, int slot) {
    q = slot;
    l = lbl[q];
    wl = wt[q];
#pragma unroll
    for (int u = 0; u < KG; ++u) b[u] = cand[min(u, K - 1) * kRing + q];
  }
};

// The first of b's buckets at the least of the loads v, as (load, bucket):
// a tree of pairs, lower ranks on the left; the right one wins only with a
// strictly smaller load, so the first minimum survives every level.
template <int KG>
__device__ void min_of(const float (&v)[KG], const int (&b)[KG], float& best,
                       int& choice) {
  float m[KG];
  int c[KG];
#pragma unroll
  for (int u = 0; u < KG; ++u) {
    m[u] = v[u];
    c[u] = b[u];
  }
#pragma unroll
  for (int h = 1; h < KG; h <<= 1) {
#pragma unroll
    for (int u = 0; u + h < KG; u += 2 * h) {
      if (m[u + h] < m[u]) {
        m[u] = m[u + h];
        c[u] = c[u + h];
      }
    }
  }
  best = m[0];
  choice = c[0];
}

// The first of b's buckets at the least load in `loads`.
template <int KG>
__device__ void first_min(const float* loads, const int (&b)[KG],
                          float& best, int& choice) {
  float v[KG];
#pragma unroll
  for (int u = 0; u < KG; ++u) v[u] = loads[b[u]];
  min_of(v, b, best, choice);
}

// The labels from lane `first` to n - 1 of a window, placed one after
// another in registers (K <= KG: each lane holds every candidate's load).
// Lane i's choice is final once the labels before it are placed: it
// broadcasts its bucket and that bucket's new load, and every later lane
// that has the bucket among its candidates takes the new load and chooses
// again. Returns each lane's choice and its bucket's load after its add in
// (choice, after), with `last` false where a later label of the window
// took the same bucket.
template <int KG>
__device__ void walk(int first, int n, const float* loads,
                     const int (&b)[KG], float wl, int& choice, float& after,
                     bool& last) {
  const int lane = threadIdx.x & 31;
  float v[KG];
#pragma unroll
  for (int u = 0; u < KG; ++u) v[u] = loads[b[u]];
  float best;
  min_of(v, b, best, choice);
  after = best + wl;
  last = true;
  int d = lane - first;   // lane - i
  // two steps a loop body: the compiler schedules one step's bookkeeping
  // beside the next step's chain (faster than 1, 4 or 8 on hot lists)
#pragma unroll 2
  for (int i = first; i < n; ++i, --d) {
    const int c = __shfl_sync(0xffffffffu, choice, i);
    const float load = __shfl_sync(0xffffffffu, after, i);
    const bool later = d > 0;
    last = last && (d >= 0 || choice != c);
#pragma unroll
    for (int u = 0; u < KG; ++u) v[u] = later && b[u] == c ? load : v[u];
    min_of(v, b, best, choice);   // unchanged where nothing was hit
    after = best + wl;
  }
}

// The picks of a window of whole labels (S a label, lanes 0 to n - 1),
// placed one after another in registers from lane 0 (K <= KG), as walk()
// places labels: lane i's choice is final once the picks before it are
// placed; it broadcasts its bucket and that bucket's new load. A later
// lane of another label takes the new load where the bucket is among its
// candidates; a later lane of the same label strikes the bucket out
// (+inf): a label takes S distinct candidates. Another label's pick never
// follows a lane's own label's first pick, so nothing restores a struck
// candidate.
template <int KG>
__device__ void walk_slots(int n, int S, const float* loads,
                           const int (&b)[KG], float wl, int& choice,
                           float& after, bool& last) {
  const int lane = threadIdx.x & 31;
  const int head = lane - lane % S;   // the lane of this label's first pick
  float v[KG];
#pragma unroll
  for (int u = 0; u < KG; ++u) v[u] = loads[b[u]];
  float best;
  min_of(v, b, best, choice);
  after = best + wl;
  last = true;
  for (int i = 0; i < n; ++i) {
    const int c = __shfl_sync(0xffffffffu, choice, i);
    const float load = __shfl_sync(0xffffffffu, after, i);
    const bool later = lane > i;
    const float hit = i >= head ? __int_as_float(0x7f800000) : load;
    last = last && (lane >= i || choice != c);
#pragma unroll
    for (int u = 0; u < KG; ++u) v[u] = later && b[u] == c ? hit : v[u];
    min_of(v, b, best, choice);   // unchanged where nothing was hit
    after = best + wl;
  }
}

// Candidates KG.. (K > KG) of the label in slot q, KG at a time.
template <int KG>
__device__ void read_group(const int* cand, int K, int q, int j0,
                           int (&b)[KG]) {
#pragma unroll
  for (int u = 0; u < KG; ++u) b[u] = cand[min(j0 + u, K - 1) * kRing + q];
}

// The least claim on the label's candidates.
template <int KG>
__device__ int least_claim(const unsigned char* claim, const int* cand,
                           const Label<KG>& x, int K) {
  int m[KG];
#pragma unroll
  for (int u = 0; u < KG; ++u) m[u] = claim[x.b[u]];
  for (int j0 = KG; j0 < K; j0 += KG) {
    int b[KG];
    read_group(cand, K, x.q, j0, b);
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      m[u] = min(m[u], static_cast<int>(claim[b[u]]));
    }
  }
#pragma unroll
  for (int h = 1; h < KG; h <<= 1) {
#pragma unroll
    for (int u = 0; u + h < KG; u += 2 * h) m[u] = min(m[u], m[u + h]);
  }
  return m[0];
}

// The ring slot of label `start` + lane, or of `start` past L.
__device__ int slot_of(int start, int qs, int L) {
  const int lane = threadIdx.x & 31;
  const int q = qs + lane;
  return start + lane >= L ? qs : q < kRing ? q : q - kRing;
}

// One window of warp 0 from label `start` of the insertion order (ring
// slot qs), its lanes' labels in x: commits the labels before the first
// dirty lane (and, when they are few, walks the rest), reads the next
// window's labels into x and returns the count committed (>= 1). Adds the
// window and the walk's steps to `rounds`.
template <int KG>
__device__ int window(int start, int qs, int L, int K, long long g,
                      float* loads, unsigned char* claim, const int* cand,
                      const int* lbl, const float* wt, Label<KG>& x,
                      int walk_below, int walk_max_k,
                      int* __restrict__ assign, int& rounds) {
  const int lane = threadIdx.x & 31;
  const bool live = start + lane < L;
  const float wl = x.wl;
  float best;
  int choice;
  first_min(loads, x.b, best, choice);
  for (int j0 = KG; j0 < K; j0 += KG) {
    int b[KG];
    read_group(cand, K, x.q, j0, b);
    float v;
    int c;
    first_min(loads, b, v, c);
    if (v < best) {
      best = v;
      choice = c;
    }
  }
  // claim[b]: the lowest live lane that chose bucket b. A plain store per
  // lane settles it unless two lanes chose one bucket (a lane reads back
  // another's claim on its own choice); then the lowest lane of each such
  // group (__match_any_sync, slow on distinct values) writes again. A lane
  // is dirty when an earlier lane claimed one of its candidates.
  if (live) claim[choice] = static_cast<unsigned char>(lane);
  __syncwarp();
  int least = least_claim(claim, cand, x, K);
  if (__any_sync(0xffffffffu, live && claim[choice] != lane)) {
    const unsigned peers = __match_any_sync(0xffffffffu, live ? choice : -1);
    if (live && __ffs(peers) - 1 == lane) {
      claim[choice] = static_cast<unsigned char>(lane);
    }
    __syncwarp();
    least = least_claim(claim, cand, x, K);
  }
  const unsigned dirty_lanes = __ballot_sync(0xffffffffu,
                                             live && least < lane);
  const int n = min(kWindow, L - start);
  const int first = dirty_lanes ? __ffs(dirty_lanes) - 1 : n;
  // a short clean prefix: place the rest of the window in registers
  // rather than starting the next window a few labels on
  const bool walked = first < walk_below && first < n && K <= walk_max_k;
  const int take = walked ? n : first;
  const int claimed = choice;
  // the next window's labels (staged: at most 63 past this chunk's end)
  Label<KG> next;
  int qn = qs + take;
  qn -= qn < kRing ? 0 : kRing;
  next.read(cand, lbl, wt, K, slot_of(start + take, qn, L));
  if (lane < first) {
    // no earlier lane of the window chose this bucket: its load is still
    // the one read
    loads[choice] = best + wl;
    assign[g * L + x.l] = choice;
  }
  ++rounds;
  if (walked) {
    __syncwarp();
    float after;
    bool last;
    walk(first, n, loads, x.b, wl, choice, after, last);
    rounds += n - first;
    if (lane >= first && lane < n) {
      if (last) loads[choice] = after;   // one writer a bucket
      assign[g * L + x.l] = choice;
    }
  }
  if (live) claim[claimed] = kFree;   // every read of claim fed a vote
  x = next;
  __syncwarp();
  return take;
}

// One window of warp 0 at S > 1 picks a label, from pick `start` of the
// walk (ring slot qs; a multiple of S), its lanes' labels in x: walks the
// picks of the window's 32 / S labels in registers (walk_slots), writes
// each pick to assign [G, L, S], reads the next window's labels into x and
// returns the picks placed. Adds the window and its picks to `rounds`.
template <int KG>
__device__ int window_slots(int start, int qs, int L, int S, int K,
                            long long g, float* loads, const int* cand,
                            const int* lbl, const float* wt, Label<KG>& x,
                            int* __restrict__ assign, int& rounds) {
  const int lane = threadIdx.x & 31;
  const int n = min(kWindow - kWindow % S, L * S - start);
  Label<KG> next;
  int qn = qs + n;
  qn -= qn < kRing ? 0 : kRing;
  next.read(cand, lbl, wt, K, slot_of(start + n, qn, L * S));
  int choice;
  float after;
  bool last;
  walk_slots(n, S, loads, x.b, x.wl, choice, after, last);
  rounds += 1 + n;
  if (lane < n) {
    if (last) loads[choice] = after;   // one writer a bucket
    assign[(g * L + x.l) * S + lane % S] = choice;
  }
  x = next;
  __syncwarp();
  return n;
}

template <int KG>
__global__ void __launch_bounds__(kThreads)
    kchoice_kernel(const int* __restrict__ topk, const int* __restrict__ order,
                   const float* __restrict__ load0, long long load0_stride,
                   const float* __restrict__ w, int L, int K, int B, int S,
                   int walk_below, int walk_max_k,
                   int* __restrict__ assign, int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* loads = reinterpret_cast<float*>(smem);                 // [B]
  int* cand = reinterpret_cast<int*>(loads + B);                 // [K][ring]
  int* lbl = cand + K * kRing;                                   // [ring]
  float* wt = reinterpret_cast<float*>(lbl + kRing);             // [ring]
  unsigned char* claim = reinterpret_cast<unsigned char*>(wt + kRing);  // [B]
  const long long g = blockIdx.x;
  const float* row0 = load0 ? load0 + g * load0_stride : nullptr;
  for (int i0 = threadIdx.x; i0 < B; i0 += 8 * kThreads) {
    float v[8];   // eight reads in flight a thread
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = row0 && i < B ? row0[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads;
      if (i < B) {
        loads[i] = v[u];
        claim[i] = kFree;
      }
    }
  }
  const int warp = threadIdx.x >> 5, t = threadIdx.x - kWindow;
  if (warp > 0) {
    stage(topk, order, w, g, L, S, K, 0, t, cand, lbl, wt);
    stage(topk, order, w, g, L, S, K, 1, t, cand, lbl, wt);
  }
  __syncthreads();
  const int N = L * S;   // the walk's picks
  const int n_chunks = (N + kChunk - 1) / kChunk;
  int start = 0, qs = 0, rounds = 0;
  Label<KG> x;
  if (warp == 0) x.read(cand, lbl, wt, K, slot_of(0, 0, N));
  for (int c = 0; c < n_chunks; ++c) {
    if (warp == 0) {
      // windows that start in chunk c read at most 31 picks into chunk
      // c + 1, and read the next window's ahead at most 63 into it: both
      // are staged
      const int end = min(N, (c + 1) * kChunk);
      while (start < end) {
        const int take =
            S > 1 ? window_slots(start, qs, L, S, K, g, loads, cand, lbl, wt,
                                 x, assign, rounds)
                  : window(start, qs, L, K, g, loads, claim, cand, lbl, wt,
                           x, walk_below, walk_max_k, assign, rounds);
        start += take;
        qs += take;
        qs -= qs < kRing ? 0 : kRing;
      }
    } else if (c + 2 < n_chunks) {
      stage(topk, order, w, g, L, S, K, c + 2, t, cand, lbl, wt);
    }
    __syncthreads();
  }
  if (rounds_out && threadIdx.x == 0) rounds_out[g] = rounds;
}

// The latency (SM clocks) of one link of a dependence chain at its
// cheapest: the new load is the least of two loads plus a weight (a min,
// then an add), each link's input the last one's output, in registers;
// timed with clock64 over a chain of n on one warp. `other` and `wl` come
// from the caller, so nothing folds; a volatile store of the chain's end
// closes it before the clock is read.
__global__ void link_kernel(int n, float other, float wl, long long* out) {
  __shared__ float end[32];
  volatile float* ve = end;
  const int lane = threadIdx.x;
  float x = static_cast<float>(lane);
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = fminf(x, other) + wl;
  ve[lane] = x;
  const long long t1 = clock64();
  if (lane == 0) out[0] = t1 - t0;
}

}  // namespace

// SM clocks of the cheapest link of a dependence chain (a min and an add
// in registers), measured over an n-long chain on the card. Returns
// cudaError_t.
extern "C" int kchoice_step_cycles(int n, double* link) {
  long long* d = nullptr;
  long long h = 0;
  cudaError_t err = cudaMalloc(&d, sizeof(h));
  if (err != cudaSuccess) return static_cast<int>(err);
  link_kernel<<<1, 32>>>(n, 1e30f, 1.0f, d);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = cudaMemcpy(&h, d, sizeof(h), cudaMemcpyDeviceToHost);
  }
  cudaFree(d);
  *link = static_cast<double>(h) / n;
  return static_cast<int>(err);
}

// Shared memory the kernel needs at (B, K): the [B] loads, the ring's
// candidates, ids and weights, the [B] claim bytes.
extern "C" long long kchoice_smem_bytes(int B, int K) {
  return 5LL * B + static_cast<long long>(kRing) * (K + 2) * 4;
}

namespace {

// One launch of the kernel that holds KG candidates a lane.
template <int KG>
int launch(const int* topk, const int* order, const float* load0,
           long long load0_stride, const float* w, int G, int L, int K, int B,
           int S, int walk_below, int walk_max_k, int* assign, int* rounds,
           void* stream) {
  const long long smem = kchoice_smem_bytes(B, K);
  cudaError_t err = cudaFuncSetAttribute(
      kchoice_kernel<KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kchoice_kernel<KG>
      <<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          topk, order, load0, load0_stride, w, L, K, B, S, walk_below,
          walk_max_k, assign, rounds);
  return static_cast<int>(cudaGetLastError());
}

// The launch whose KG is K, for K <= kMaxKG; KG = kMaxKG above.
template <int KG>
int dispatch(const int* topk, const int* order, const float* load0,
             long long load0_stride, const float* w, int G, int L, int K,
             int B, int S, int walk_below, int walk_max_k, int* assign,
             int* rounds, void* stream) {
  if constexpr (KG > 1) {
    if (K < KG) {
      return dispatch<KG - 1>(topk, order, load0, load0_stride, w, G, L, K,
                              B, S, walk_below, walk_max_k, assign, rounds,
                              stream);
    }
  }
  return launch<KG>(topk, order, load0, load0_stride, w, G, L, K, B, S,
                    walk_below, walk_max_k, assign, rounds, stream);
}

}  // namespace

// topk [G, L, K] int32 bucket ids (each < B); order [G, L] int32, a
// permutation of 0..L-1 per rep; load0 [G, B] f32 (load0_stride B), one [B]
// row for every rep (stride 0) or NULL (zeros); w [L] f32 or NULL (ones).
// slots S in [1, K] picks a label (S > 1: K <= kMaxKG and L·S < 2^31).
// A window whose clean prefix is shorter than walk_below (0..32) is walked
// in registers when K <= walk_max_k (at most kMaxKG). assign [G, L] int32
// ([G, L, S] at S > 1, a label's picks in slot order); rounds [G] int32 or
// NULL: each rep's sequential rounds, its windows and the walks' steps.
// Returns cudaGetLastError() after the launch.
extern "C" int kchoice_launch(const int* topk, const int* order,
                              const float* load0, long long load0_stride,
                              const float* w, int G, int L, int K, int B,
                              int slots, int walk_below, int walk_max_k,
                              int* assign, int* rounds, void* stream) {
  if (G < 1 || L < 1 || K < 1 || B < 1 || walk_below < 0 ||
      walk_below > kWindow || walk_max_k > kMaxKG || slots < 1 ||
      slots > K || (slots > 1 && K > kMaxKG) ||
      static_cast<long long>(L) * slots > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a lane holds all its K candidates (at most kMaxKG; more are read from
  // the ring kMaxKG at a time)
  return dispatch<kMaxKG>(topk, order, load0, load0_stride, w, G, L, K, B,
                          slots, walk_below, walk_max_k, assign, rounds,
                          stream);
}
