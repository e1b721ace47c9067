// EmbeddingBag: the weighted sum of each bag's table rows, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py:49
// (embedding_bag, pallas_call at :57), which keeps a tile of bags in VMEM,
// their ids in scalar memory, and loads one table row at a time from HBM.
// Contract, shared with the plain version (ref.py): ids [N, P] int32 (a
// negative id is a pad), weights [N, P] fp32, table [V, D] fp32 or bf16 ->
// out [N, D] in the table's dtype, out[n] = Σ_p w[n, p] · table[ids[n, p]]
// over the slots with an id >= 0, accumulated in fp32 in the fixed order
// below and rounded once to the table's dtype. A pad adds nothing; a slot
// with weight 0 adds 0·row, as the reference does. An id >= V (which the
// plain version refuses) adds nothing: the kernel reads no row outside the
// table.
//
// What bounds it on the H100: bytes. It reads ids and weights once (8 B a
// slot), each distinct table row it touches, and writes the output once.
// At DIEN's serve_bulk history (N = 262,144 bags of P = 100 over the
// 1,048,576 x 18 fp32 item table, Zipf ids: 928,061 distinct rows in
// chip_smoke.py's batch) that is 0.21 GB of ids and weights, 67 MB of rows
// and 19 MB of output: 0.088 ms at 3.35 TB/s. Its 2·N·P·D flops are
// nothing beside that. Zipf(1.2) ids put most slots on a few thousand hot
// rows, which the L1 and L2 caches hold, so what limits a kernel that
// reads them is the instructions and the latency a slot costs.
//
// Design: one warp a bag, the warps striding over the bags, so no bag is
// split across blocks: no atomics, and the result is the same from run to
// run. Lanes work on (slot, column-vector) pairs:
//   - A row is cols = D / E vectors of VB bytes (E elements each): VB is
//     the widest of 16, 8, 4 (and 2 for bf16) bytes that divides the row's
//     bytes and the alignment of the table and output pointers (bag_plan;
//     DIEN's D = 18: 9 float2 in fp32, 9 __nv_bfloat162 in bf16).
//   - A group of G = min(cols, 32) lanes takes one slot, lane c of the
//     group its c-th vector; a warp holds S = 32 / G groups (3 at D = 18:
//     27 of 32 lanes work). Rows of more than 32 vectors take the warp as
//     one group in chunks of 32 vectors.
//   - Each warp stages its next segment of a bag (kSeg = 128 slots: the
//     whole bag at P = 100) of ids and weights into shared memory with
//     cp.async (16-byte copies where P % 4 == 0 and the arrays are
//     aligned, else 4-byte ones) while it works on the current one, so the
//     ids' trip to device memory overlaps a segment's row loads. The grid
//     is one wave of resident blocks (occupancy x SMs), each warp taking
//     every n_warps-th bag.
//   - A segment's slots go in chunks of 4: group g takes chunks g, g + S,
//     g + 2S, ... Each lane reads its chunk's 4 ids and 4 weights from the
//     stage as one 16-byte shared load each (the lanes of a group read the
//     same address: a broadcast, no shuffles), and loads its 4 row vectors
//     before it uses the first.
//   - The order of the sum, fixed: each lane sums its group's chunks in
//     order, segment after segment, each chunk's 4 slots in order (one
//     fmaf a slot and element);
//     then group 0 adds groups 1 .. S-1 in that order, by shuffles, rounds
//     once and writes the output row as vectors.
// Row offsets are 64-bit (id · D passes 2^31 on DLRM's tables).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;                 // slots a group takes a step
constexpr int kSeg = 128;                 // slots a warp stages at a time
constexpr unsigned kFull = 0xffffffffu;

// The launch plan at row width D of es-byte elements, with the table and
// output pointers aligned to `align` bytes (16 for fresh allocations).
struct Plan {
  int vec_bytes, vec_elems, cols, group, slots, col_chunks;
};
__host__ __device__ inline Plan bag_plan(int D, int es, int align) {
  int vb = 16;
  while (vb > es && ((D * es) % vb != 0 || align % vb != 0)) vb >>= 1;
  const int e = vb / es;
  const int cols = D / e;
  const int group = cols < 32 ? cols : 32;
  return {vb, e, cols, group, 32 / group, (cols + 31) / 32};
}

// The raw words of one VB-byte vector.
template <int VB>
struct Raw {
  unsigned w[(VB + 3) / 4];
};

template <int VB>
__device__ __forceinline__ void load_raw(const void* p, Raw<VB>& r) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x; r.w[1] = v.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    r.w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

template <int VB>
__device__ __forceinline__ void store_raw(void* p, const Raw<VB>& r) {
  if constexpr (VB == 16) {
    *static_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (VB == 8) {
    *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (VB == 4) {
    *static_cast<unsigned*>(p) = r.w[0];
  } else {
    *static_cast<unsigned short*>(p) = static_cast<unsigned short>(r.w[0]);
  }
}

// Element i of a raw vector, widened to fp32.
template <typename T, int VB>
__device__ __forceinline__ float element(const Raw<VB>& r, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[i]);
  } else {                                   // bf16: two to a word, low first
    const unsigned w = r.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, int VB>
__device__ __forceinline__ void pack(const float* f, Raw<VB>& r) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < E; ++i) r.w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < (VB + 3) / 4; ++i) r.w[i] = 0;
#pragma unroll
    for (int i = 0; i < E; ++i) {            // round to nearest even, as .to()
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16(f[i]));
      r.w[i >> 1] |= h << ((i & 1) * 16);
    }
  }
}

// 4 or 16 bytes global -> shared, asynchronously (cp.async, no registers)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// A warp's staging buffer: one segment's ids and weights.
struct Stage {
  int id[kSeg];
  float w[kSeg];
};

// Stage slots [s0, s0 + kSeg) of a bag (ids and weights of P slots from
// bag_ids, bag_w): 16-byte copies where vec (P % 4 == 0, aligned arrays),
// else 4-byte ones; slots past P read as pads (-1, 0). One commit group.
__device__ __forceinline__ void stage(Stage& st, const int* bag_ids,
                                      const float* bag_w, int s0, int P,
                                      bool vec, int lane) {
  if (vec) {
    const int s = 4 * lane;
    if (s0 + s < P) {
      copy16(st.id + s, bag_ids + s0 + s);
      copy16(st.w + s, bag_w + s0 + s);
    } else {
      *reinterpret_cast<int4*>(st.id + s) = make_int4(-1, -1, -1, -1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSeg / 32; ++j) {
      const int s = lane + 32 * j;
      if (s0 + s < P) {
        copy4(st.id + s, bag_ids + s0 + s);
        copy4(st.w + s, bag_w + s0 + s);
      } else {
        st.id[s] = -1;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A warp's place in its units: bag, column chunk, segment.
struct Unit {
  long long bag;
  int col, seg;
  __device__ __forceinline__ void advance(int n_segs, int n_col,
                                          long long n_warps) {
    if (++seg < n_segs) return;
    seg = 0;
    if (++col < n_col) return;
    col = 0;
    bag += n_warps;
  }
};

// One chunk of kChunk slots: weights and this lane's row vectors.
template <int VB>
struct Chunk {
  float w[kChunk];
  Raw<VB> row[kChunk];
  bool ok[kChunk];
};

// Chunk k of a stage: its weights from the stage, and the lane's vectors
// of its rows from the table (lane_rows: the table at the lane's column).
// The 4 loads go out together and without a branch: a pad or an id past
// the table loads row 0 in place of its own, and ok marks it, so that its
// weight and its row count as 0 (it adds nothing, whatever row 0 holds).
template <int VB>
__device__ __forceinline__ void fetch(Chunk<VB>& ch, const Stage& st, int k,
                                      const char* lane_rows,
                                      unsigned row_bytes, unsigned V) {
  const int4 iv = *reinterpret_cast<const int4*>(st.id + k * kChunk);
  const float4 wv = *reinterpret_cast<const float4*>(st.w + k * kChunk);
  const int id[kChunk] = {iv.x, iv.y, iv.z, iv.w};
  const float w[kChunk] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    const bool ok = static_cast<unsigned>(id[r]) < V;
    ch.w[r] = ok ? w[r] : 0.0f;
    load_raw<VB>(lane_rows + static_cast<unsigned long long>(
                                 ok ? static_cast<unsigned>(id[r]) : 0u) *
                                 row_bytes,
                 ch.row[r]);
    ch.ok[r] = ok;
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const int* __restrict__ ids,
                         const float* __restrict__ weights,
                         const T* __restrict__ table, long long n_bags,
                         int P, unsigned V, int cols, int group, int slots,
                         bool vec_ids, T* __restrict__ out) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  // two chunks' loads in flight where a vector holds at most 2 elements
  // (wider ones spilled at 2)
  constexpr int kChunkUnroll = E <= 2 ? 2 : 1;
  __shared__ __align__(16) Stage stages[kWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / group;                // the lane's group
  const int c = lane - g * group;            // its vector in a column chunk
  const unsigned row_bytes = static_cast<unsigned>(cols) * VB;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (first >= n_bags) return;
  // the warp's units, in order: (bag, column chunk, segment of kSeg
  // slots), walked with counters (no division on the way)
  const int n_segs = P > 0 ? (P + kSeg - 1) / kSeg : 1;
  const int n_col = (cols + 31) / 32;
  Unit cur{first, 0, 0}, nxt = cur;
  nxt.advance(n_segs, n_col, n_warps);
  stage(stages[warp][0], ids + cur.bag * P, weights + cur.bag * P, 0, P,
        vec_ids, lane);
  float acc[E];
  for (int buf = 0; cur.bag < n_bags; buf ^= 1) {
    if (nxt.bag < n_bags) {
      stage(stages[warp][buf ^ 1], ids + nxt.bag * P, weights + nxt.bag * P,
            nxt.seg * kSeg, P, vec_ids, lane);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const Stage& st = stages[warp][buf];
    const int seg = cur.seg;
    const int c0 = cur.col * 32;
    const int col = c0 + c;
    const bool active = g < slots && col < cols;
    if (seg == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    }
    const char* lane_rows =
        reinterpret_cast<const char*>(table) + static_cast<long long>(col) * VB;
    const int n_chunks = (min(P - seg * kSeg, kSeg) + kChunk - 1) / kChunk;
#pragma unroll kChunkUnroll
    for (int k = active ? g : n_chunks; k < n_chunks; k += slots) {
      Chunk<VB> ch;
      fetch(ch, st, k, lane_rows, row_bytes, V);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[e] = fmaf(ch.w[r],
                        ch.ok[r] ? element<T, VB>(ch.row[r], e) : 0.0f,
                        acc[e]);
        }
      }
    }
    __syncwarp();                     // the buffer is restaged next unit
    if (seg == n_segs - 1) {
      // lane c of group 0 adds lane c of groups 1 .. slots-1, in order
      float tot[E];
#pragma unroll
      for (int e = 0; e < E; ++e) tot[e] = acc[e];
      for (int h = 1; h < slots; ++h) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tot[e] += __shfl_sync(kFull, acc[e], (lane + h * group) & 31);
        }
      }
      if (g == 0 && col < cols) {
        Raw<VB> o;
        pack<T, VB>(tot, o);
        store_raw<VB>(reinterpret_cast<char*>(out) +
                          cur.bag * static_cast<long long>(row_bytes) +
                          static_cast<long long>(col) * VB,
                      o);
      }
    }
    cur = nxt;
    nxt.advance(n_segs, n_col, n_warps);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int VB>
int launch(const int* ids, const float* weights, const void* table,
           long long n_bags, int P, long long V, const Plan& p, bool vec_ids,
           void* out, cudaStream_t s) {
  // one wave of resident blocks, the warps striding over the bags: every
  // warp takes the same number of bags, give or take one. Occupancy x SMs,
  // asked once a process (every card of a host is alike here)
  static int wave_blocks = 0;
  if (wave_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_kernel<T, VB>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    wave_blocks = sms * per_sm;
  }
  const long long wave = wave_blocks;
  const long long want = (n_bags + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < wave ? want : wave);
  const unsigned v = V < (1LL << 31) ? static_cast<unsigned>(V) : 1u << 31;
  embedding_bag_kernel<T, VB><<<grid, kThreads, 0, s>>>(
      ids, weights, static_cast<const T*>(table), n_bags, P, v, p.cols,
      p.group, p.slots, vec_ids, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const int* ids, const float* weights, const void* table,
             long long n_bags, int P, long long V, const Plan& p,
             bool vec_ids, void* out, cudaStream_t s) {
  switch (p.vec_bytes) {
    case 16:
      return launch<T, 16>(ids, weights, table, n_bags, P, V, p, vec_ids, out,
                           s);
    case 8:
      return launch<T, 8>(ids, weights, table, n_bags, P, V, p, vec_ids, out,
                          s);
    case 4:
      return launch<T, 4>(ids, weights, table, n_bags, P, V, p, vec_ids, out,
                          s);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch<T, 2>(ids, weights, table, n_bags, P, V, p, vec_ids,
                            out, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int alignment(const void* a, const void* b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) | 16u;
  return static_cast<int>(bits & (~bits + 1));   // the lowest set bit
}

int kernel_attrs(const void* kernel, long long* regs, long long* spill) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.numRegs > *regs) *regs = a.numRegs;
  if (static_cast<long long>(a.localSizeBytes) > *spill) {
    *spill = static_cast<long long>(a.localSizeBytes);
  }
  return 0;
}

}  // namespace

// The launch plan at row width D, dtype 0 = fp32 and 1 = bf16, for table
// and output pointers aligned to 16 bytes: out = vector bytes, elements a
// vector, vectors a row, lanes a slot, slots a warp step, column chunks.
extern "C" int embedding_bag_plan(int D, int dtype, long long* out) {
  if (D < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = bag_plan(D, dtype == 0 ? 4 : 2, 16);
  const long long v[] = {p.vec_bytes, p.vec_elems, p.cols,
                         p.group,     p.slots,     p.col_chunks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// The most registers and local (spill) bytes a thread of any of the
// kernel's instantiations takes: out[0], out[1].
extern "C" int embedding_bag_attrs(long long* out) {
  out[0] = out[1] = 0;
  const void* kernels[] = {
      reinterpret_cast<const void*>(embedding_bag_kernel<float, 16>),
      reinterpret_cast<const void*>(embedding_bag_kernel<float, 8>),
      reinterpret_cast<const void*>(embedding_bag_kernel<float, 4>),
      reinterpret_cast<const void*>(embedding_bag_kernel<__nv_bfloat16, 16>),
      reinterpret_cast<const void*>(embedding_bag_kernel<__nv_bfloat16, 8>),
      reinterpret_cast<const void*>(embedding_bag_kernel<__nv_bfloat16, 4>),
      reinterpret_cast<const void*>(embedding_bag_kernel<__nv_bfloat16, 2>)};
  for (const void* k : kernels) {
    const int err = kernel_attrs(k, out, out + 1);
    if (err != 0) return err;
  }
  return 0;
}

// ids, weights [n_bags, P] (int32, fp32), table [V, D] and out [n_bags, D]
// row-major and contiguous; dtype 0 = fp32 table and output, 1 = bf16.
// n_bags >= 1, P >= 0, D >= 1. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int embedding_bag_launch(const int* ids, const float* weights,
                                    const void* table, long long n_bags,
                                    int P, long long V, int D, int dtype,
                                    void* out, void* stream) {
  if (n_bags < 1 || P < 0 || V < 0 || D < 1 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(D) * (dtype == 0 ? 4 : 2) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 0) {              // every slot adds nothing, and there is no row 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_bags) * D * (dtype == 0 ? 4 : 2), s));
  }
  const Plan p = bag_plan(D, dtype == 0 ? 4 : 2, alignment(table, out));
  const bool vec_ids = P % kChunk == 0 && alignment(ids, weights) == 16;
  if (dtype == 0) {
    return dispatch<float>(ids, weights, table, n_bags, P, V, p, vec_ids, out,
                           s);
  }
  return dispatch<__nv_bfloat16>(ids, weights, table, n_bags, P, V, p,
                                 vec_ids, out, s);
}
