// Indexed-row gathers for Hopper (sm_90a), with a plain C interface for
// ctypes: the row gather, the gathered max-pool and the weighted 3-NN
// interpolation.
//
// Replaces three TPU kernels of mvp_benchmark_tpu/ops/pallas_kernels.py:
//
//   gather_rows_forward      <- `_gather_rows_onehot` :1712 (body
//                               `_gather_rows_kernel` :1684), behind
//                               `gather_rows` :1769 (gather_points,
//                               grouping_operation):
//                               out[b, m, :] = f[b, idx[b, m], :]
//   group_max_forward        <- `_group_max_forward` :887 (body
//                               `_group_max_fwd_kernel` :808):
//                               out[b, m, c] = max_j f[b, idx[b, m, j], c],
//                               slot = the lowest j reaching the max
//   three_interpolate_forward <- `_ti_forward` :1050 (body `_ti_fwd_kernel`
//                               :983), behind `three_interpolate_fused`:
//                               out[b, n, c] = ((f0*w0 + f1*w1) + f2*w2)
//
// The TPU kernels gather with one-hot matrix products on the MXU, with the
// table rounded to bf16. On the GPU a gather is an indexed load, so all three
// are exact fp32 here and equal ops/ref.py bitwise: the gather copies, the
// max compares (strict `>` over ascending j, as the Pallas kernel), and the
// interpolation rounds each product and sum on its own (__fmul_rn,
// __fadd_rn) in the order above.
//
// Design: one thread per output element, or per 4 channels (16-byte loads
// and stores) where C % 4 == 0 and the pointers are 16-byte aligned. A warp
// covers consecutive channels of consecutive output rows, so each gathered
// row is read as one contiguous segment; group_max's forward stages a slice
// of the table or its rows' indices in shared memory (see below). An index
// outside [0, N) writes NaN (and slot 255) instead of reading out of
// bounds: the wrappers do not range-check on the host, which would need a
// device sync.
//
// What bounds them on an H100: bytes. None does arithmetic worth counting
// (group_max k - 1 compares, three_interpolate 5 operations per output).
// The largest on ECG's path, DenseEdge's neighbour gather at level 1
// (B 32, 3072 x 16 rows of 24 floats), writes 151 MB and reads 15 MB:
// 0.05 ms at 3.35 TB/s. A row is re-read for every query that gathers it;
// L2 (50 MB) holds the tables on this path, so device memory sees each about
// once. A later PR would fuse these into their consumers (the gathered
// DenseEdge projection is added to the centre term and max-pooled right
// after, so the (B, N, k, C) tensor need never be written).
//
// The backwards of the three, for training:
//
//   scatter_add_rows            <- `scatter_add_rows` :1613 (body
//                                  `_scatter_rows_kernel` :1588), the
//                                  backward of `gather_rows` (:1800):
//                                  out[b, idx[b, m], :] += g[b, m, :]
//   group_max_backward          <- `_group_max_bwd_rule` :928 (body
//                                  `_group_max_bwd_kernel` :830):
//                                  d[b, idx[b, m, slot], c] += g[b, m, c]
//   three_interpolate_backward  <- `_ti_bwd_rule` :1086 (body
//                                  `_ti_bwd_kernel` :993):
//                                  d_f[b, idx[b, n, l], c] += w[b, n, l] g[b, n, c],
//                                  d_w[b, n, l] = <g[b, n], f[b, idx[b, n, l]]>
//
// The TPU kernels scatter with one-hot-transpose MXU products (bf16 or
// hi/lo-bf16 tables) into one output block that the grid revisits in order,
// which is deterministic. GPU blocks run in no order, so each backward here
// turns its scatter into a gather over the reverse list of its index (every
// row's sources, ascending), then writes every output row once with a plain
// store, its incoming terms summed in ascending source order, as
// ops/ref.py's scatters sum them on the CPU. No float atomics, so two runs
// are bitwise equal. group_max_backward, a scatter_add_rows of at most
// 8192 entries a cloud (26 of ECG's 28 a train step, all 4 of VRCNet's) and
// a three_interpolate_backward of at most 1024 (ECG's smallest) are one
// launch each, which lists in shared memory and gathers (no list in
// memory, no second launch; their counts are integer atomicAdd in shared
// memory, the same in any order); a larger three_interpolate_backward or
// scatter_add_rows first builds the list in device memory (reverse_list.cu).
// scatter_add_rows's one-launch forms, by the host plan kernels.scatter_plan:
//   - packed (scatter_add_rows_packed_kernel), clouds of at most 256
//     entries and 1024 output vectors (the uniform losses' kNN gathers,
//     3264 clouds of 48 entries into 24 rows): a warp a cloud, 8 clouds a
//     block; the warp holds its cloud's indices in registers, ranks each
//     step's entries of a row with __match_any_sync and __popc, and needs
//     no barrier but __syncwarp;
//   - by row range (scatter_add_rows_local_kernel), clouds of a few
//     thousand entries: a block a cloud and range of rows, each thread
//     holding up to 16 of the cloud's indices in registers, read once.
// Both list an entry whose index is outside [0, n) under row 0 as ~e, which
// adds NaN. group_max_backward (kernels.group_max_backward_plan) lists as
// the range form does (local_list.cuh) over idx's m k edges, in batches
// of 16 entries a lane where a warp holds more, 16 warps and about eight
// output vectors
// of 8 channels a thread: it adds g[m, c] for the edges (m, j) whose saved
// slot[m, c] (a byte, written by group_max_forward) is j, so each element
// goes to the row the forward saved, in ascending m. scatter_add_rows's
// list form takes one thread per output element (4 channels where C % 4 ==
// 0 and the pointers are 16-byte aligned), walking the row's list;
// three_interpolate_backward's, 8 channels a thread (where C % 8 == 0),
// rows inside a warp and four entries' loads before their adds, the walk
// (ti_walk) its one-launch form shares. d_w is a dot product per (n, l): one
// warp per target row, lanes over channels, a shuffle reduction. An index
// outside [0, N) is listed under row 0 of its cloud, which adds NaN instead
// of reading out of bounds; a slot outside [0, k) sets NaN in row 0 of its
// cloud and channel.
//
// What bounds them: bytes, and the lists' serial steps. At VRCNet's largest
// three_interpolate backward (B 64, 3072 x 128 from 1536 rows) g is 101 MB
// and d_f 50 MB: 0.045 ms at 3.35 TB/s; the gather reads each g row once
// for each of its 3 targets, 300 MB from L2, where a cloud's rows stay
// while the 1-D grid's few clouds in flight read them. The one-launch form
// lost there on an H100: each of a cloud's blocks lists all of its 9216
// entries, and few blocks a cloud put ~44 clouds' g (66 MB) in flight. group_max_backward at VRCNet's
// level 1 (B 64, 1536 points x 10 edges into 3072 rows of 64 channels)
// moves 86 MB (0.026 ms); it reads an edge's slot bytes and g vector
// together, k x 6 MB and k x 25 MB from L2, and each of a cloud's six
// blocks lists all 15,360 of the cloud's edges to find its rows'. The
// one-launch forms read a cloud's index once a block. At ECG's small
// clouds the bytes are ~1 us and what is left is latency: the packed
// form's warp a cloud runs a few dependent steps with no barrier, the
// range form one load of the index a thread and four barriers.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "local_list.cuh"
#include "reverse_list.h"
#include "smem_opt_in.h"

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p[e];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

// out (B, rows, C) from f (B, n, C) and idx (B, rows); `total` = B*rows*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                   int n, int c, int rows, int total, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int r = t / cv;                 // b * rows + m
  const int cc = (t - r * cv) * V;
  const int b = r / rows;
  const int src = idx[r];
  float v[V];
  if (src >= 0 && src < n) {
    load_vec<V>(f + (static_cast<size_t>(b) * n + src) * c + cc, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = CUDART_NAN_F;
  }
  store_vec<V>(out + static_cast<size_t>(r) * c + cc, v);
}

// group_max's forward: out/slot (B, m, C) from f (B, n, C) and idx (B, m,
// k <= 255), in one of two forms by the host plan
// kernels.group_max_forward_plan. The slot is a byte, kBadSlot where an
// index is outside [0, n), which also sets NaN in every channel. The
// compares run in ascending j with a strict `>`, a chain a thread, so the
// slot is the lowest j reaching the max and a NaN at j = 0 stays.
//   - direct (group_max_direct_kernel): a thread V channels (4 or 1) of one
//     output row, its k rows of f read through L2. Those gathered reads, k a
//     row (10 x 25 MB at VRCNet's level 1), cross L2 at ~5.6 TB/s on an
//     H100, which sets its time: more loads in flight a thread, 8 channels
//     a thread or the row's indices staged in shared memory read no faster;
//   - staged (group_max_staged_kernel), where a slice of at least 16
//     channels of a cloud's table fits in shared memory in at most 8 slices
//     (the index is read once a slice): block (b, slice), kGmsThreads
//     threads, copies f[b, :, slice] from device memory once, then a thread
//     takes V channels of one output row of the slice, its k rows read from
//     shared memory, the loop over j unrolled for K (10, 16; the row's
//     indices in K / 2 8-byte loads) where the plan says so.
constexpr unsigned char kBadSlot = 255;
constexpr int kGmsThreads = 512;
constexpr int kGmsSmem = 232448;        // the staged form's table: what a block may opt in to

template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    const float4 u = *reinterpret_cast<const float4*>(p + 4);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    v[4] = u.x; v[5] = u.y; v[6] = u.z; v[7] = u.w;
  } else {
    load_vec<V>(p, v);
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    store_vec<V>(p, v);
  }
}

template <int V>
__device__ __forceinline__ void store_slots(unsigned char* so, const int (&sl)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uchar4*>(so) = make_uchar4(sl[0], sl[1], sl[2], sl[3]);
  } else {
    so[0] = static_cast<unsigned char>(sl[0]);
  }
}

// acc/sl take v, the row of neighbour j, where it is larger (or j == 0).
template <int V>
__device__ __forceinline__ void take_max(const float (&v)[V], int j, float (&acc)[V],
                                         int (&sl)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (j == 0 || v[e] > acc[e]) {
      acc[e] = v[e];
      sl[e] = j;
    }
  }
}

// `total` = B*m*C/V threads, one a (row, V channels).
template <int V>
__global__ void __launch_bounds__(kThreads)
group_max_direct_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                        int n, int c, int m, int k, int total, float* __restrict__ out,
                        unsigned char* __restrict__ slot) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int r = t / cv;                 // b * m + row
  const int cc = (t - r * cv) * V;
  const int b = r / m;
  const int* ir = idx + static_cast<size_t>(r) * k;
  const float* fb = f + static_cast<size_t>(b) * n * c + cc;
  float acc[V] = {};
  int sl[V] = {};
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const int src = ir[j];
    if (src < 0 || src >= n) {
      bad = true;
      continue;
    }
    float v[V];
    load_vec<V>(fb + static_cast<size_t>(src) * c, v);
    take_max<V>(v, j, acc, sl);
  }
  if (bad) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc[e] = CUDART_NAN_F;
      sl[e] = kBadSlot;
    }
  }
  store_vec<V>(out + static_cast<size_t>(r) * c + cc, acc);
  store_slots<V>(slot + static_cast<size_t>(r) * c + cc, sl);
}

// The staged form: block (b, slice) of a 1-D grid, b = blockIdx.x / slices,
// the channels [c0, c0 + cs) of cloud b (fewer in the last slice; cs a
// multiple of V). Shared memory: n cs floats, row r of the slice at r cs.
template <int V, int K>
__global__ void __launch_bounds__(kGmsThreads)
group_max_staged_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                        int n, int c, int m, int k, int cs, int slices,
                        float* __restrict__ out, unsigned char* __restrict__ slot) {
  extern __shared__ float gms_smem[];
  const int kk = K > 0 ? K : k;
  const int b = blockIdx.x / slices;
  const int c0 = (blockIdx.x - b * slices) * cs;
  const int wv = min(cs, c - c0) / V;               // the slice's vectors a row
  const float* fb = f + static_cast<size_t>(b) * n * c + c0;
  const int items = n * wv;
  for (int t = threadIdx.x; t < items; t += 4 * blockDim.x) {   // 4 loads in flight
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = t + u * blockDim.x;
      if (i < items) {
        const int r = i / wv;
        load_vec<V>(fb + static_cast<size_t>(r) * c + (i - r * wv) * V, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = t + u * blockDim.x;
      if (i < items) {
        const int r = i / wv;
        store_vec<V>(gms_smem + r * cs + (i - r * wv) * V, v[u]);
      }
    }
  }
  __syncthreads();
  const int* ib = idx + static_cast<size_t>(b) * m * kk;
  for (int t = threadIdx.x; t < m * wv; t += blockDim.x) {
    const int q = t / wv;
    const int x = (t - q * wv) * V;
    const int* ir = ib + static_cast<size_t>(q) * kk;
    float acc[V] = {};
    int sl[V] = {};
    bool bad = false;
    if constexpr (K > 0) {                          // the row's K indices in K / 2 loads
      int src[K];
#pragma unroll
      for (int j = 0; j < K; j += 2) {
        const int2 t = *reinterpret_cast<const int2*>(ir + j);
        src[j] = t.x;
        src[j + 1] = t.y;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool ok = src[j] >= 0 && src[j] < n;
        bad |= !ok;
        float v[V];
        load_vec<V>(gms_smem + (ok ? src[j] : 0) * cs + x, v);
        take_max<V>(v, j, acc, sl);
      }
    } else {
      for (int j = 0; j < k; ++j) {
        const int src = ir[j];
        const bool ok = src >= 0 && src < n;
        bad |= !ok;
        float v[V];
        load_vec<V>(gms_smem + (ok ? src : 0) * cs + x, v);
        take_max<V>(v, j, acc, sl);
      }
    }
    if (bad) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] = CUDART_NAN_F;
        sl[e] = kBadSlot;
      }
    }
    const size_t o = (static_cast<size_t>(b) * m + q) * c + c0 + x;
    store_vec<V>(out + o, acc);
    store_slots<V>(slot + o, sl);
  }
}

// out (B, n, C) from f (B, ms, C), idx and w (B, n, 3); `total` = B*n*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
three_interpolate_kernel(const float* __restrict__ f,
                         const int* __restrict__ idx,
                         const float* __restrict__ w, int ms, int c, int n,
                         int total, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int r = t / cv;                 // b * n + row
  const int cc = (t - r * cv) * V;
  const int b = r / n;
  const float* fb = f + static_cast<size_t>(b) * ms * c + cc;
  float o[V];
  bool bad = false;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int src = idx[static_cast<size_t>(r) * 3 + l];
    const float wl = w[static_cast<size_t>(r) * 3 + l];
    float v[V];
    if (src >= 0 && src < ms) {
      load_vec<V>(fb + static_cast<size_t>(src) * c, v);
    } else {
      bad = true;
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float term = __fmul_rn(v[e], wl);
      o[e] = l == 0 ? term : __fadd_rn(o[e], term);
    }
  }
  if (bad) {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = CUDART_NAN_F;
  }
  store_vec<V>(out + static_cast<size_t>(r) * c + cc, o);
}

// out (B, n, C) from g (B, rows, C): row (b, r) sums, ascending, the g rows
// of its list of idx (B, rows); `total` = B*n*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                        const int* __restrict__ order, const int* __restrict__ off,
                        int n, int c, int total, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int row = t / cv;               // b * n + r
  const int cc = (t - row * cv) * V;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  const bool first = row % n == 0;      // row 0 also lists bad indices
#pragma unroll 4
  for (int i = off[row]; i < off[row + 1]; ++i) {
    const int src = order[i];           // b * rows + m
    float v[V];
    if (!first || (idx[src] >= 0 && idx[src] < n)) {
      load_vec<V>(g + static_cast<size_t>(src) * c + cc, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = CUDART_NAN_F;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  }
  store_vec<V>(out + static_cast<size_t>(row) * c + cc, acc);
}

// The one-launch forms. An entry is listed as e, or as ~e (negative) where
// its index is outside [0, n): listed under row 0, it adds NaN.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackEntries = 256;       // the packed form: 8 entries a lane
constexpr int kPackSteps = kPackEntries / 32;
constexpr int kPackOutputs = 1024;      // output vectors (rows x C / V) a cloud
constexpr int kPackWarps = 8;           // clouds a block
constexpr int kLocalEntries = 8192;     // the range form
constexpr int kLocalRows = 256;
constexpr int kLocalSteps = 16;         // entries a thread
constexpr int kLocalMaxWarps = 16;

// Sums, in list order, the g rows (channels cc .. cc + V) of the entries
// lst[lo .. hi).
template <int V>
__device__ __forceinline__ void sum_list(const float* __restrict__ gb,
                                         const int* lst, int lo, int hi, int c,
                                         int cc, float (&acc)[V]) {
#pragma unroll
  for (int x = 0; x < V; ++x) acc[x] = 0.f;
  for (int i = lo; i < hi; ++i) {
    const int e = lst[i];
    float v[V];
    if (e >= 0) {
      load_vec<V>(gb + static_cast<size_t>(e) * c + cc, v);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) v[x] = CUDART_NAN_F;
    }
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = __fadd_rn(acc[x], v[x]);
  }
}

// The packed form: warp w of block b takes cloud b * 8 + w (B clouds of
// `rows` <= 256 entries into n rows, n * C / V <= 1024). Its shared memory,
// (n + rows) ints a warp: n counts, scanned to each row's first slot and
// moved to its end as the row's entries are placed, then the list. Lane
// `lane` holds the entries s * 32 + lane (step s) in registers; a step's
// entries of one row take consecutive slots in lane order (their rank
// among the step's lower lanes of that row, __match_any_sync and __popc),
// after the slots of the steps before, so every row lists its entries
// ascending. Then each output sums its row's list in order.
template <int V>
__global__ void __launch_bounds__(kPackWarps * 32)
scatter_add_rows_packed_kernel(const float* __restrict__ g,
                               const int* __restrict__ idx, int batch, int n,
                               int c, int rows, float* __restrict__ out) {
  extern __shared__ int pk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;                 // whole warps leave together
  int* end = pk_smem + warp * (n + rows);
  int* lst = end + n;
  for (int q = lane; q < n; q += 32) end[q] = 0;
  const int* ib = idx + static_cast<size_t>(b) * rows;
  int key[kPackSteps];                    // the entry's row, -1 past the end
  unsigned bad = 0;
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    const int e = s * 32 + lane;
    key[s] = -1;
    if (e < rows) {
      const int v = ib[e];
      const bool o = v < 0 || v >= n;
      key[s] = o ? 0 : v;
      bad |= static_cast<unsigned>(o) << s;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    if (key[s] >= 0) atomicAdd(end + key[s], 1);   // an integer count
  }
  __syncwarp();
  // exclusive scan of the counts: rows [q0, q1) a lane
  const int rp = (n + 31) / 32;
  const int q0 = min(n, lane * rp), q1 = min(n, q0 + rp);
  int sum = 0;
  for (int q = q0; q < q1; ++q) sum += end[q];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
  for (int q = q0; q < q1; ++q) {
    const int v = end[q];
    end[q] = run;
    run += v;
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kPackSteps; ++s) {
    if (s * 32 < rows) {                  // the same on every lane
      const int q = key[s];
      const unsigned peers = __match_any_sync(kFull, q);
      const int e = s * 32 + lane;
      if (q >= 0) lst[end[q] + __popc(peers & lower)] = (bad >> s) & 1u ? ~e : e;
      __syncwarp();
      if (q >= 0 && lane == __ffs(peers) - 1) end[q] += __popc(peers);
      __syncwarp();
    }
  }
  // end[q] is now the end of row q's list, end[q - 1] its start
  const float* gb = g + static_cast<size_t>(b) * rows * c;
  const int cv = c / V;
  for (int t = lane; t < n * cv; t += 32) {
    const int q = t / cv;
    const int cc = (t - q * cv) * V;
    float acc[V];
    sum_list<V>(gb, lst, q == 0 ? 0 : end[q - 1], end[q], c, cc, acc);
    store_vec<V>(out + (static_cast<size_t>(b) * n + q) * c + cc, acc);
  }
}

// The range form: block (b, range) of a 1-D grid, b = blockIdx.x / ranges,
// `blockDim.x / 32` warps, takes the rows [r0, r0 + nr) of cloud b (of
// `rows` <= 8192 entries). Warp w holds the entries w * 32 * steps + 32 s +
// lane (step s < steps <= 16) in registers, read once; the block counts its
// rows' entries per (warp, row) in shared memory, scans them rows in order
// and, within a row, warps in order, places each warp's entries as the
// packed form does (a warp's steps in order), then gathers its rows.
// Shared memory: (warps + 1) nr + 1 + warps + rows ints.
template <int V>
__global__ void __launch_bounds__(kLocalMaxWarps * 32)
scatter_add_rows_local_kernel(const float* __restrict__ g,
                              const int* __restrict__ idx, int n, int c,
                              int rows, int nr, int ranges, int steps,
                              float* __restrict__ out) {
  extern __shared__ int lc_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / ranges;
  const int r0 = (blockIdx.x - b * ranges) * nr;
  const int m = min(n, r0 + nr) - r0;
  int* cnt = lc_smem;                     // (warps, m): counts, then slots
  int* first = cnt + warps * m;           // (m + 1)
  int* warp_total = first + m + 1;        // (warps)
  int* lst = warp_total + warps;          // (rows)
  for (int t = threadIdx.x; t < warps * m; t += blockDim.x) cnt[t] = 0;

  const int* ib = idx + static_cast<size_t>(b) * rows;
  const int e0 = warp * 32 * steps + lane;
  int key[kLocalSteps];                   // the entry's row - r0; -1 if not the block's
  unsigned bad = 0;
#pragma unroll
  for (int s = 0; s < kLocalSteps; ++s) {
    key[s] = -1;
    const int e = e0 + 32 * s;
    if (s < steps && e < rows) {
      const int v = ib[e];
      const bool o = v < 0 || v >= n;
      const int q = (o ? 0 : v) - r0;
      if (q >= 0 && q < m) key[s] = q;
      bad |= static_cast<unsigned>(o) << s;
    }
  }
  __syncthreads();
  int* wc = cnt + warp * m;
#pragma unroll
  for (int s = 0; s < kLocalSteps; ++s) {
    if (key[s] >= 0) atomicAdd(wc + key[s], 1);     // an integer count
  }
  __syncthreads();

  // rows [q0, q1) a thread: their totals over the warps, a block exclusive
  // scan, then each (warp, q) count becomes that warp's first slot of q
  const int rp = (m + blockDim.x - 1) / blockDim.x;
  const int q0 = min(m, static_cast<int>(threadIdx.x) * rp);
  const int q1 = min(m, q0 + rp);
  int sum = 0;
  for (int q = q0; q < q1; ++q) {
    for (int w = 0; w < warps; ++w) sum += cnt[w * m + q];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int q = q0; q < q1; ++q) {
    first[q] = run;
    for (int w = 0; w < warps; ++w) {
      const int v = cnt[w * m + q];
      cnt[w * m + q] = run;
      run += v;
    }
  }
  if (q0 < q1 && q1 == m) first[m] = run;
  __syncthreads();

  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kLocalSteps; ++s) {
    if (s < steps) {                      // the same on every lane
      const int q = key[s];
      const unsigned peers = __match_any_sync(kFull, q);
      const int e = e0 + 32 * s;
      if (q >= 0) lst[wc[q] + __popc(peers & lower)] = (bad >> s) & 1u ? ~e : e;
      __syncwarp();
      if (q >= 0 && lane == __ffs(peers) - 1) wc[q] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  const float* gb = g + static_cast<size_t>(b) * rows * c;
  const int cv = c / V;
  for (int t = threadIdx.x; t < m * cv; t += blockDim.x) {
    const int q = t / cv;
    const int cc = (t - q * cv) * V;
    float acc[V];
    sum_list<V>(gb, lst, first[q], first[q + 1], c, cc, acc);
    store_vec<V>(out + (static_cast<size_t>(b) * n + r0 + q) * c + cc, acc);
  }
}

// group_max's backward in one launch: block (b, range) of a 1-D grid, b =
// blockIdx.x / ranges, kGmWarps warps, takes the rows [r0, r0 + nr) of cloud
// b. For each chunk of `chunk` of the cloud's m k entries (idx (B, m, k),
// entry point k + j), ascending, it lists the entries of its rows in shared
// memory (local_list.cuh), then a thread an output vector (row q, channels
// cc .. cc + V) walks q's list and adds g[point, c] where slot[point, c] ==
// j: the elements routed to the row, in ascending point. A later chunk adds
// to what the earlier ones stored. Four entries at a time: their slot bytes
// and g vectors loaded together (one wait on memory, not two: the g vector
// read whether or not a slot names the entry), then the adds in list order.
// An entry whose index is outside [0, n) is listed under row 0 as ~e and
// adds NaN where its slot names it; the block of row 0 reads its cloud's
// slots once, and a channel with a slot outside [0, k) gets NaN in row 0.
// Shared memory: list_ints(kGmWarps, nr) + chunk + c ints.
constexpr int kGmWarps = 16;

template <int V>
__device__ __forceinline__ unsigned long long load_slots(const unsigned char* p) {
  if constexpr (V == 8) {
    return *reinterpret_cast<const unsigned long long*>(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ unsigned slot_byte(unsigned long long w, int x) {
  return static_cast<unsigned>(w >> (8 * x)) & 0xffu;
}

// Rows [0, m) of a block (d's row q at dq + q c), each output vector summed
// over its row's list lst[first[q] .. first[q + 1]); ADD: onto what an
// earlier chunk stored. A row takes `lanes` >= c / V consecutive threads,
// the ones past c / V idle, so that rows of fewer than 32 vectors do not
// straddle warps (a warp then walks the longest of fewer lists).
template <int V, bool ADD>
__device__ __forceinline__ void group_max_gather(const float* __restrict__ gb,
                                                 const unsigned char* __restrict__ sb,
                                                 const int* first, const int* lst, int m,
                                                 int c, int k, int lanes,
                                                 float* __restrict__ dq) {
  const int cv = c / V;
  for (int t = threadIdx.x; t < m * lanes; t += blockDim.x) {
    const int q = t / lanes;
    const int x = t - q * lanes;
    if (x >= cv) continue;                // an idle lane
    const int cc = x * V;
    float acc[V];
    if constexpr (ADD) {
      load_row<V>(dq + static_cast<size_t>(q) * c + cc, acc);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) acc[x] = 0.f;
    }
    const int hi = first[q + 1];
    for (int i = first[q]; i < hi; i += 4) {
      int j[4];
      unsigned long long w[4];
      unsigned bad = 0;
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {       // past the list's end: point 0, j -1
        const int raw = i + u < hi ? lst[i + u] : 0;
        const int e = raw < 0 ? ~raw : raw;
        const int pt = e / k;
        bad |= static_cast<unsigned>(raw < 0) << u;
        j[u] = i + u < hi ? e - pt * k : -1;
        w[u] = load_slots<V>(sb + static_cast<size_t>(pt) * c + cc);
        load_row<V>(gb + static_cast<size_t>(pt) * c + cc, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int x = 0; x < V; ++x) {
          if (slot_byte(w[u], x) == static_cast<unsigned>(j[u])) {
            acc[x] = __fadd_rn(acc[x], (bad >> u) & 1u ? CUDART_NAN_F : v[u][x]);
          }
        }
      }
    }
    store_row<V>(dq + static_cast<size_t>(q) * c + cc, acc);
  }
}

template <int V>
__global__ void __launch_bounds__(kGmWarps * 32, 2)   // two blocks an SM: 64 registers
group_max_backward_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                          const unsigned char* __restrict__ slot, int n, int c,
                          int mp, int k, int nr, int ranges, int chunk, int lanes,
                          float* __restrict__ d) {
  extern __shared__ int gm_smem[];
  const int b = blockIdx.x / ranges;
  const int r0 = (blockIdx.x - b * ranges) * nr;
  const int m = min(n, r0 + nr) - r0;
  const int entries = mp * k;
  const int* first = gm_smem + kGmWarps * m;
  int* lst = gm_smem + list_ints(kGmWarps, m);
  int* bad_channel = lst + chunk;         // (c), the block of row 0
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const unsigned char* sb = slot + static_cast<size_t>(b) * mp * c;
  const float* gb = g + static_cast<size_t>(b) * mp * c;
  float* db = d + (static_cast<size_t>(b) * n + r0) * c;
  if (r0 == 0) {
    for (int t = threadIdx.x; t < c; t += blockDim.x) bad_channel[t] = 0;
  }
  for (int e0 = 0; e0 == 0 || e0 < entries; e0 += chunk) {   // once at least
    build_list<true>(
        [&](int e, bool& bad) {
          const int v = ib[e];
          bad = v < 0 || v >= n;
          const int q = (bad ? 0 : v) - r0;
          return q >= 0 && q < m ? q : -1;
        },
        [&](int at, int e, bool bad, int) { lst[at] = bad ? ~e : e; }, e0,
        min(chunk, entries - e0), m, gm_smem);
    if (e0 == 0) {
      group_max_gather<V, false>(gb, sb, first, lst, m, c, k, lanes, db);
    } else {
      group_max_gather<V, true>(gb, sb, first, lst, m, c, k, lanes, db);
    }
  }
  if (r0 == 0) {                          // the same on the whole block
    // the cloud's slots: 16 bytes a load where aligned, a thread's 8 loads
    // in flight at once, each checked a byte at a time only where one of
    // its bytes is at least k (__vcmpgeu4); else a byte a load
    const int bytes = mp * c;
    const unsigned kk = static_cast<unsigned>(k) * 0x01010101u;
    if (bytes % 16 == 0 && (reinterpret_cast<size_t>(sb) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(sb);
      for (int t0 = threadIdx.x; t0 < bytes / 16; t0 += 8 * blockDim.x) {
        uint4 w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = t0 + u * blockDim.x;
          w[u] = t < bytes / 16 ? s4[t] : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned x4[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if (__vcmpgeu4(x4[h], kk) == 0u) continue;
            for (int x = 0; x < 4; ++x) {
              if (((x4[h] >> (8 * x)) & 0xffu) >= static_cast<unsigned>(k)) {
                bad_channel[((t0 + u * blockDim.x) * 16 + 4 * h + x) % c] = 1;
              }
            }
          }
        }
      }
    } else {
      for (int t = threadIdx.x; t < bytes; t += blockDim.x) {
        if (sb[t] >= k) bad_channel[t % c] = 1;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < c; t += blockDim.x) {
      if (bad_channel[t]) db[t] = CUDART_NAN_F;
    }
  }
}

// acc[V] += w[e] g[e / 3, cc .. cc + V) for the entries e of one row's list,
// positions [lo, hi) of `list` ascending, each product rounded as ref.py's
// `g * w` and added with __fadd_rn in list order; an entry whose index lies
// outside [0, ms) adds NaN. Four entries' w and g loads are made before
// their adds. The one-launch form's list (LOCAL, in shared memory) holds
// such an entry as ~e; the list form's (in device memory) holds e, and its
// row 0 (`first`) reads idx to find them. g and w start at the entries'
// cloud, or at entry 0 where the entries count from there.
template <int V, bool LOCAL>
__device__ __forceinline__ void ti_walk(const float* __restrict__ g,
                                        const float* __restrict__ w,
                                        const int* __restrict__ list,
                                        const int* __restrict__ idx, int ms, bool first,
                                        int lo, int hi, int c, int cc, float (&acc)[V]) {
  for (int i = lo; i < hi; i += 4) {
    float v[4][V];
    float wl[4];
    unsigned bad = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {       // past the list's end: an entry not added
      int ent;
      if constexpr (LOCAL) {
        const int raw = i + u < hi ? list[i + u] : 0;
        ent = raw < 0 ? ~raw : raw;
        bad |= static_cast<unsigned>(raw < 0) << u;
      } else {
        ent = list[i + u < hi ? i + u : i];
        if (first) {
          const int src = idx[ent];
          bad |= static_cast<unsigned>(src < 0 || src >= ms) << u;
        }
      }
      wl[u] = w[ent];
      load_row<V>(g + static_cast<size_t>(ent / 3) * c + cc, v[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u < hi) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[e] = __fadd_rn(acc[e], (bad >> u) & 1u ? CUDART_NAN_F
                                                     : __fmul_rn(v[u][e], wl[u]));
        }
      }
    }
  }
}

// d_f (B, ms, C) from g (B, n, C) and w (B, n, 3), the list form: row (b,
// r) sums, ascending over its list of idx (B, n, 3) in device memory
// (entries (b n + i) 3 + l), w[i, l] * g[i] (ti_walk). A thread V channels
// (8 or 1) of a row, `lanes` threads a row (the next power of two of the
// row's C / V vectors below 32, so that rows do not straddle warps), `rows`
// = B ms.
template <int V>
__global__ void __launch_bounds__(kThreads)
three_interpolate_backward_kernel(const float* __restrict__ g,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  const int* __restrict__ order,
                                  const int* __restrict__ off, int ms, int c,
                                  int lanes, int rows, float* __restrict__ df) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int row = static_cast<int>(t / lanes);      // b * ms + r
  const int x = static_cast<int>(t - static_cast<long long>(row) * lanes);
  if (row >= rows || x >= c / V) return;            // idle lanes, past the end
  const int cc = x * V;
  const bool first = row % ms == 0;                 // row 0 also lists bad indices
  float acc[V] = {};
  ti_walk<V, false>(g, w, order, idx, ms, first, off[row], off[row + 1], c, cc, acc);
  store_row<V>(df + static_cast<size_t>(row) * c + cc, acc);
}

// three_interpolate's backward in one launch: block (b, range) of a 1-D
// grid, b = blockIdx.x / ranges, kTiWarps warps, takes the rows [r0, r0 +
// nr) of cloud b's d_f. For each chunk of `chunk` of the cloud's 3 n entries
// (idx (B, n, 3), entry point 3 + l), ascending, it lists the entries of its
// rows in shared memory (local_list.cuh), then a thread an output vector
// (row q, channels cc .. cc + V; `lanes` threads a row, as group_max's
// backward) walks q's list as the list form does (ti_walk). A later chunk
// adds to what the earlier ones stored, so every row is
// summed in ascending (point, l), as ref.py's scatter on the CPU. An entry
// whose index is outside [0, ms) is listed under row 0 as ~e and adds NaN.
// Shared memory: list_ints(kTiWarps, nr) + chunk ints.
constexpr int kTiWarps = 16;

template <int V, bool ADD>
__device__ __forceinline__ void ti_backward_gather(const float* __restrict__ gb,
                                                   const float* __restrict__ wb,
                                                   const int* first, const int* lst, int m,
                                                   int c, int lanes, float* __restrict__ dq) {
  const int cv = c / V;
  for (int t = threadIdx.x; t < m * lanes; t += blockDim.x) {
    const int q = t / lanes;
    const int x = t - q * lanes;
    if (x >= cv) continue;                // an idle lane
    const int cc = x * V;
    float acc[V];
    if constexpr (ADD) {
      load_row<V>(dq + static_cast<size_t>(q) * c + cc, acc);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
    }
    ti_walk<V, true>(gb, wb, lst, nullptr, 0, false, first[q], first[q + 1], c, cc, acc);
    store_row<V>(dq + static_cast<size_t>(q) * c + cc, acc);
  }
}

template <int V>
__global__ void __launch_bounds__(kTiWarps * 32, 2)   // two blocks an SM: 64 registers
three_interpolate_backward_local_kernel(const float* __restrict__ g,
                                        const int* __restrict__ idx,
                                        const float* __restrict__ w, int ms, int c, int n,
                                        int nr, int ranges, int chunk, int lanes,
                                        float* __restrict__ df) {
  extern __shared__ int ti_smem[];
  const int b = blockIdx.x / ranges;
  const int r0 = (blockIdx.x - b * ranges) * nr;
  const int m = min(ms, r0 + nr) - r0;
  const int entries = n * 3;
  const int* first = ti_smem + kTiWarps * m;
  int* lst = ti_smem + list_ints(kTiWarps, m);
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const float* wb = w + static_cast<size_t>(b) * entries;
  const float* gb = g + static_cast<size_t>(b) * n * c;
  float* db = df + (static_cast<size_t>(b) * ms + r0) * c;
  for (int e0 = 0; e0 == 0 || e0 < entries; e0 += chunk) {   // once at least
    build_list<true>(
        [&](int e, bool& bad) {
          const int v = ib[e];
          bad = v < 0 || v >= ms;
          const int q = (bad ? 0 : v) - r0;
          return q >= 0 && q < m ? q : -1;
        },
        [&](int at, int e, bool bad, int) { lst[at] = bad ? ~e : e; }, e0,
        min(chunk, entries - e0), m, ti_smem);
    if (e0 == 0) {
      ti_backward_gather<V, false>(gb, wb, first, lst, m, c, lanes, db);
    } else {
      ti_backward_gather<V, true>(gb, wb, first, lst, m, c, lanes, db);
    }
  }
}

// d_w (B, n, 3) = <g[b, n], f[b, idx[b, n, l]]>: one warp per row of
// (B*n), `rows` = B*n.
__global__ void __launch_bounds__(kThreads)
three_interpolate_dweight_kernel(const float* __restrict__ g,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ f, int ms, int c,
                                 int n, int rows, float* __restrict__ dw) {
  const int r = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                // whole warps leave together
  const int b = r / n;
  const float* gr = g + static_cast<size_t>(r) * c;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int src = idx[static_cast<size_t>(r) * 3 + l];
    float s = 0.f;
    if (src >= 0 && src < ms) {
      const float* fr = f + (static_cast<size_t>(b) * ms + src) * c;
      for (int cc = lane; cc < c; cc += 32) s = fmaf(gr[cc], fr[cc], s);
    } else {
      s = CUDART_NAN_F;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dw[static_cast<size_t>(r) * 3 + l] = s;
  }
}

int blocks_for(int total) { return (total + kThreads - 1) / kThreads; }

// three_interpolate's d_weight (B, N, 3), the dot products, where dw is
// not null.
int three_interpolate_dweight(const float* g, const int* idx, const float* f, int batch,
                              int ms, int c, int n, float* dw, cudaStream_t s) {
  if (dw == nullptr || n == 0) return 0;
  const int rows = batch * n;
  three_interpolate_dweight_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                                     kThreads, 0, s>>>(g, idx, f, ms, c, n, rows, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All arrays contiguous on the device; `vec4` (0 or 1) asks for 16-byte
// accesses, which needs C % 4 == 0 and 16-byte-aligned f/out; every element
// count fits in int32. Each launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).

// f (B, N, C) float32, idx (B, M) int32 -> out (B, M, C).
int gather_rows_forward(const float* f, const int* idx, int batch, int n,
                        int c, int rows, int vec4, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * rows * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  if (vec4) {
    gather_rows_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, n, c, rows, total, out);
  } else {
    gather_rows_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, n, c, rows, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// f (B, N, C) float32, idx (B, M, K <= 255) int32 -> out (B, M, C)
// float32, slot (B, M, C) uint8, by the host plan
// kernels.group_max_forward_plan: `vec` (4 or 1) channels a thread, which
// needs C % vec == 0 and, at 4, f and out 16-byte and slot 4-byte aligned.
// With `cs` > 0 the staged form, cs channels a slice (a multiple of vec; N
// cs floats of shared memory, at most kGmsSmem), `unroll` 10 or 16 (== k,
// idx 8-byte aligned) for the loop over j unrolled, else 0; with cs 0 the
// direct form, `unroll` 0.
int group_max_forward(const float* f, const int* idx, int batch, int n, int c,
                      int m, int k, int vec, int cs, int unroll, float* out,
                      unsigned char* slot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(batch) * m * c == 0) return 0;
  const size_t align = reinterpret_cast<size_t>(f) | reinterpret_cast<size_t>(out);
  if (k < 1 || k > kBadSlot || (vec != 1 && vec != 4) || c % vec != 0 ||
      (vec == 4 && ((align & 15) != 0 || (reinterpret_cast<size_t>(slot) & 3) != 0)) ||
      cs < 0 || cs % vec != 0 ||
      (unroll != 0 && (cs == 0 || unroll != k || (unroll != 10 && unroll != 16) ||
                       (reinterpret_cast<size_t>(idx) & 7) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cs == 0) {
    const int total = batch * m * (c / vec);
    if (vec == 4) {
      group_max_direct_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
          f, idx, n, c, m, k, total, out, slot);
    } else {
      group_max_direct_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
          f, idx, n, c, m, k, total, out, slot);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int slices = (c + cs - 1) / cs;
  const size_t smem = sizeof(float) * static_cast<size_t>(n) * cs;
  if (smem > static_cast<size_t>(kGmsSmem) ||
      static_cast<long long>(batch) * slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static SmemOptIn opt_in[6];
  const int which = (vec == 4 ? 3 : 0) + (unroll == 10 ? 1 : unroll == 16 ? 2 : 0);
  auto kernel = vec == 4 ? (unroll == 10   ? group_max_staged_kernel<4, 10>
                            : unroll == 16 ? group_max_staged_kernel<4, 16>
                                           : group_max_staged_kernel<4, 0>)
                         : (unroll == 10   ? group_max_staged_kernel<1, 10>
                            : unroll == 16 ? group_max_staged_kernel<1, 16>
                                           : group_max_staged_kernel<1, 0>);
  cudaError_t err = opt_in[which].raise(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * slices, kGmsThreads, smem, s>>>(f, idx, n, c, m, k, cs, slices, out, slot);
  return static_cast<int>(cudaGetLastError());
}

// f (B, Ms, C) float32, idx (B, N, 3) int32, w (B, N, 3) float32 ->
// out (B, N, C).
int three_interpolate_forward(const float* f, const int* idx, const float* w,
                              int batch, int ms, int c, int n, int vec4,
                              float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  if (vec4) {
    three_interpolate_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, w, ms, c, n, total, out);
  } else {
    three_interpolate_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, w, ms, c, n, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backwards first build the reverse list of their index
// (reverse_list.cu: `list_warps` warps a block and `ranges` blocks a
// cloud, as kernels.reverse_list_plan says; order and off sized as there),
// then write every output row once.

// g (B, M, C) float32, idx (B, M) int32 -> out (B, N, C), the scatter-add
// in one launch, by the host plan kernels.scatter_plan (rows a block, warps
// a block, clouds a block): with clouds > 1 the packed form (M <= 256,
// N C / V <= 1024; a warp a cloud, `local_warps` == clouds a block); else
// the range form (M <= 8192, local_rows <= 256 rows a block, `local_warps`
// <= 16 warps of at most 16 entries a thread).
int scatter_add_rows_local(const float* g, const int* idx, int batch, int n, int c,
                           int rows, int local_rows, int local_warps, int clouds,
                           int vec4, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  if (clouds > 1) {
    if (rows > kPackEntries || total / batch > kPackOutputs || clouds != local_warps ||
        clouds > kPackWarps) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = sizeof(int) * static_cast<size_t>(clouds) * (n + rows);
    const int grid = (batch + clouds - 1) / clouds;
    static SmemOptIn opt_in[2];
    if (vec4) {
      auto kernel = scatter_add_rows_packed_kernel<4>;
      cudaError_t err = opt_in[1].raise(reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, clouds * 32, smem, s>>>(g, idx, batch, n, c, rows, out);
    } else {
      auto kernel = scatter_add_rows_packed_kernel<1>;
      cudaError_t err = opt_in[0].raise(reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, clouds * 32, smem, s>>>(g, idx, batch, n, c, rows, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int steps = (rows + 32 * local_warps - 1) / (32 * local_warps);
  const int row_ranges = local_rows > 0 ? (n + local_rows - 1) / local_rows : 0;
  if (local_rows < 1 || rows > kLocalEntries || local_rows > kLocalRows || local_warps < 1 ||
      local_warps > kLocalMaxWarps || steps > kLocalSteps ||
      static_cast<long long>(batch) * row_ranges > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (static_cast<size_t>(local_warps + 1) * local_rows +
                                     1 + local_warps + rows);
  static SmemOptIn opt_in[2];
  if (vec4) {
    auto kernel = scatter_add_rows_local_kernel<4>;
    cudaError_t err = opt_in[1].raise(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch * row_ranges, local_warps * 32, smem, s>>>(
        g, idx, n, c, rows, local_rows, row_ranges, steps, out);
  } else {
    auto kernel = scatter_add_rows_local_kernel<1>;
    cudaError_t err = opt_in[0].raise(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch * row_ranges, local_warps * 32, smem, s>>>(
        g, idx, n, c, rows, local_rows, row_ranges, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for clouds of more than 8192 entries: the reverse list of idx
// (reverse_list.cu: `list_warps` warps a block and `ranges` blocks a cloud,
// as kernels.reverse_list_plan says; order and off sized as there), then
// the gather.
int scatter_add_rows(const float* g, const int* idx, int batch, int n, int c,
                     int rows, int list_warps, int ranges, int* order, int* off,
                     int vec4, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  const int err = reverse_list_build(idx, batch, rows, n, list_warps, ranges,
                                     order, off, stream);
  if (err != 0) return err;
  if (vec4) {
    scatter_add_rows_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
        g, idx, order, off, n, c, total, out);
  } else {
    scatter_add_rows_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        g, idx, order, off, n, c, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (B, M, C) float32, idx (B, M, K) int32, slot (B, M, C) uint8 -> d
// (B, N, C), the routed g, in one launch by the host plan
// kernels.group_max_backward_plan: `rows` rows a block, entries listed
// `chunk` at a time, `lanes` threads a row; `vec8` (0 or 1) asks for 8
// channels a thread, which needs C % 8 == 0 and g, d 16-byte, slot 8-byte
// aligned.
int group_max_backward(const float* g, const int* idx, const unsigned char* slot,
                       int batch, int n, int c, int m, int k, int rows, int chunk,
                       int lanes, int vec8, float* d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * n * c == 0) return 0;
  const int ranges = rows > 0 ? (n + rows - 1) / rows : 0;
  if (rows < 1 || chunk < 1 || lanes < c / (vec8 ? 8 : 1) ||
      static_cast<long long>(batch) * ranges > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (static_cast<size_t>(list_ints(kGmWarps, rows)) + chunk + c);
  static SmemOptIn opt_in[2];
  auto kernel = vec8 ? group_max_backward_kernel<8> : group_max_backward_kernel<1>;
  cudaError_t err = opt_in[vec8 ? 1 : 0].raise(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * ranges, kGmWarps * 32, smem, s>>>(g, idx, slot, n, c, m, k, rows, ranges,
                                                    chunk, lanes, d);
  return static_cast<int>(cudaGetLastError());
}

// g (B, N, C), idx (B, N, 3) int32, w (B, N, 3), f (B, Ms, C) float32 ->
// df (B, Ms, C), and dw (B, N, 3) when dw is not null: the list form, the
// reverse list of idx in device memory, then the gather; `vec8` (0 or 1)
// asks for 8 channels a thread, which needs C % 8 == 0 and g, df 16-byte
// aligned.
int three_interpolate_backward(const float* g, const int* idx, const float* w,
                               const float* f, int batch, int ms, int c, int n,
                               int list_warps, int ranges, int* order,
                               int* off, int vec8,
                               float* df, float* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(batch) * ms * c == 0) return 0;
  const size_t align = reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(df);
  if (vec8 && (c % 8 != 0 || (align & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cv = vec8 ? c / 8 : c;
  int lanes = 1;
  while (lanes < cv && lanes < 32) lanes <<= 1;
  if (cv >= 32) lanes = cv;
  const long long grid =
      (static_cast<long long>(batch) * ms * lanes + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int err = reverse_list_build(idx, batch, n * 3, ms, list_warps, ranges,
                                     order, off, stream);
  if (err != 0) return err;
  auto kernel = vec8 ? three_interpolate_backward_kernel<8>
                     : three_interpolate_backward_kernel<1>;
  kernel<<<static_cast<int>(grid), kThreads, 0, s>>>(g, idx, w, order, off, ms, c, lanes,
                                                     batch * ms, df);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return three_interpolate_dweight(g, idx, f, batch, ms, c, n, dw, s);
}

// The same in one launch, by the host plan
// kernels.three_interpolate_backward_plan: `rows` rows of df a block, the 3 N
// entries listed `chunk` at a time, `lanes` threads a row; `vec8` (0 or 1)
// asks for 8 channels a thread, which needs C % 8 == 0 and g, df 16-byte
// aligned.
int three_interpolate_backward_local(const float* g, const int* idx, const float* w,
                                     const float* f, int batch, int ms, int c, int n,
                                     int rows, int chunk, int lanes, int vec8, float* df,
                                     float* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(batch) * ms * c == 0) return 0;
  const int ranges = rows > 0 ? (ms + rows - 1) / rows : 0;
  const size_t align = reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(df);
  if (rows < 1 || chunk < 1 || lanes < c / (vec8 ? 8 : 1) ||
      (vec8 && (c % 8 != 0 || (align & 15) != 0)) ||
      static_cast<long long>(batch) * ranges > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (static_cast<size_t>(list_ints(kTiWarps, rows)) + chunk);
  static SmemOptIn opt_in[2];
  auto kernel = vec8 ? three_interpolate_backward_local_kernel<8>
                     : three_interpolate_backward_local_kernel<1>;
  cudaError_t err = opt_in[vec8 ? 1 : 0].raise(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * ranges, kTiWarps * 32, smem, s>>>(g, idx, w, ms, c, n, rows, ranges,
                                                    chunk, lanes, df);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return three_interpolate_dweight(g, idx, f, batch, ms, c, n, dw, s);
}

}  // extern "C"
