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
// row is read as one contiguous segment; no shared memory. An index outside
// [0, N) writes NaN (and slot -1) instead of reading out of bounds: the
// wrappers do not range-check on the host, which would need a device sync.
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
// turns its scatter into a gather: it first builds the reverse list of its
// index (reverse_list.cu: every row's sources, ascending), then writes every
// output row once with a plain store, its incoming terms summed in
// ascending source order, as ops/ref.py's scatters sum them on the CPU. No
// float atomics, so two runs are bitwise equal. A scatter_add_rows of at
// most 8192 entries a cloud (most of ECG's 28 a train step: the uniform
// losses' small clouds, the sampled centres) is one launch instead:
// scatter_add_rows_local_kernel, a block a cloud and range of rows, lists
// the range's entries in shared memory in the same order and gathers them
// (no list in memory, no second launch; its counts, as the list's, are
// integer atomicAdd in shared memory, the same in any order).
// scatter_add_rows and
// three_interpolate_backward take one thread per output element (4
// channels where C % 4 == 0 and the pointers are 16-byte aligned), walking
// the row's list; group_max_backward walks the list of idx too and adds
// g[m, c] for the edges (m, j) whose slot[m, c] is j, so each element goes
// to the row the forward saved, in ascending m. d_w is a dot product per
// (n, l): one warp per target row, lanes over channels, a shuffle
// reduction. An index outside [0, N) is listed under row 0 of its cloud,
// which adds NaN instead of reading out of bounds; a slot outside [0, k)
// sets a flag from which a last small kernel writes NaN to row 0 of its
// cloud and channel.
//
// What bounds them: bytes. At VRCNet's largest three_interpolate backward
// (B 64, 3072 x 128 from 1536 rows) g is 101 MB and d_f 50 MB: 0.045 ms at
// 3.35 TB/s; the gather reads each g row once for each of its 3 targets,
// the 3 x 25 M reads mostly from L2, where a cloud's rows stay while its
// blocks run. group_max_backward reads slot once for each of a point's k
// edges (k x 25 MB at VRCNet's level 1, from L2). The list costs a launch
// and the index's reads; the local form reads its cloud's index twice a
// block, the launch's fixed cost being what it saves at these sizes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "reverse_list.h"

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

template <int V>
__device__ __forceinline__ void load_ivec(const int* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
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
__device__ __forceinline__ void store_ivec(int* p, const int (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
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

// out/slot (B, m, C) from f (B, n, C) and idx (B, m, k); `total` = B*m*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
group_max_kernel(const float* __restrict__ f, const int* __restrict__ idx,
                 int n, int c, int m, int k, int total, float* __restrict__ out,
                 int* __restrict__ slot) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int r = t / cv;                 // b * m + row
  const int cc = (t - r * cv) * V;
  const int b = r / m;
  const int* ir = idx + static_cast<size_t>(r) * k;
  const float* fb = f + static_cast<size_t>(b) * n * c + cc;
  float acc[V];
  int sl[V];
  bool bad = false;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc[e] = 0.f;
    sl[e] = 0;
  }
  for (int j = 0; j < k; ++j) {
    const int src = ir[j];
    if (src < 0 || src >= n) {
      bad = true;
      continue;
    }
    float v[V];
    load_vec<V>(fb + static_cast<size_t>(src) * c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (j == 0 || v[e] > acc[e]) {
        acc[e] = v[e];
        sl[e] = j;
      }
    }
  }
  if (bad) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc[e] = CUDART_NAN_F;
      sl[e] = -1;
    }
  }
  store_vec<V>(out + static_cast<size_t>(r) * c + cc, acc);
  store_ivec<V>(slot + static_cast<size_t>(r) * c + cc, sl);
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

// The one-launch form of scatter_add_rows_kernel for clouds of at most
// kLocalEntries entries: block (range, b), `warps` warps, takes the rows
// [r0, r0 + nr) of cloud b, lists the cloud's entries of those rows in
// shared memory as reverse_list.cu does (each warp counts, then places, a
// contiguous range of the entries, 32 a step; the counts scanned rows in
// order and, within a row, warps in order; a lane's slot is its row's
// next slot plus its rank among the step's lower lanes of that row, so
// every row lists its entries ascending), then gathers its rows as
// scatter_add_rows_kernel does. Each block reads its cloud's index twice.
constexpr int kLocalEntries = 8192;
constexpr int kLocalRows = 256;
constexpr int kLocalWarps = kThreads / 32;

template <int V>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_local_kernel(const float* __restrict__ g,
                              const int* __restrict__ idx, int n, int c,
                              int rows, int nr, float* __restrict__ out) {
  __shared__ int cnt[kLocalWarps * kLocalRows];   // (warps, m) counts, then slots
  __shared__ int first[kLocalRows + 1];
  __shared__ int lst[kLocalEntries];
  __shared__ int warp_total[kLocalWarps];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * nr;
  const int m = min(n, r0 + nr) - r0;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < warps * m; t += blockDim.x) cnt[t] = 0;
  __syncthreads();

  const int* ib = idx + static_cast<size_t>(b) * rows;
  const int per = (rows + warps - 1) / warps;
  const int lo = min(rows, warp * per), hi = min(rows, lo + per);
  int* wc = cnt + warp * m;
  for (int e = lo + lane; e < hi; e += 32) {
    const int v = ib[e];
    const int q = (v >= 0 && v < n ? v : 0) - r0;   // a bad index: row 0
    if (q >= 0 && q < m) atomicAdd(wc + q, 1);        // an integer count
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
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
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
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int e = e0 + lane;
    int q = -1;
    if (e < hi) {
      const int v = ib[e];
      q = (v >= 0 && v < n ? v : 0) - r0;
      if (q < 0 || q >= m) q = -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, q);
    if (q >= 0) lst[wc[q] + __popc(peers & lower)] = e;
    __syncwarp();
    if (q >= 0 && lane == __ffs(peers) - 1) wc[q] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  const int cv = c / V;
  for (int t = threadIdx.x; t < m * cv; t += blockDim.x) {
    const int q = t / cv;
    const int cc = (t - q * cv) * V;
    const bool row0 = r0 + q == 0;      // row 0 also lists bad indices
    float acc[V];
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = 0.f;
    for (int i = first[q]; i < first[q + 1]; ++i) {
      const int e = lst[i];
      float v[V];
      if (!row0 || (ib[e] >= 0 && ib[e] < n)) {
        load_vec<V>(g + (static_cast<size_t>(b) * rows + e) * c + cc, v);
      } else {
#pragma unroll
        for (int x = 0; x < V; ++x) v[x] = CUDART_NAN_F;
      }
#pragma unroll
      for (int x = 0; x < V; ++x) acc[x] = __fadd_rn(acc[x], v[x]);
    }
    store_vec<V>(out + (static_cast<size_t>(b) * n + r0 + q) * c + cc, acc);
  }
}

// d (B, n, C) from g (B, m, C): thread (b r, c .. c + V) walks r's list of
// idx (B, m, k) (entries (b m + i) k + j, ascending) and adds g[i, c] where
// slot[i, c] == j: the elements routed to r, in ascending i. A slot outside
// [0, k) sets the flag of its cloud and channel instead; `total` =
// B*n*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
group_max_backward_kernel(const float* __restrict__ g,
                          const int* __restrict__ idx,
                          const int* __restrict__ slot,
                          const int* __restrict__ order,
                          const int* __restrict__ off, int n, int c, int k,
                          int total, float* __restrict__ d,
                          int* __restrict__ flags) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int row = t / cv;               // b * n + r
  const int cc = (t - row * cv) * V;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int i = off[row]; i < off[row + 1]; ++i) {
    const int ent = order[i];           // (b m + point) k + j
    const int src = ent / k;
    const int j = ent - src * k;
    int s[V];
    load_ivec<V>(slot + static_cast<size_t>(src) * c + cc, s);
    bool hit = false;
#pragma unroll
    for (int e = 0; e < V; ++e) hit |= s[e] == j;
    if (hit) {
      float v[V];
      load_vec<V>(g + static_cast<size_t>(src) * c + cc, v);
      const bool ok = row % n != 0 || (idx[ent] >= 0 && idx[ent] < n);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (s[e] == j) acc[e] = __fadd_rn(acc[e], ok ? v[e] : CUDART_NAN_F);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (s[e] < 0 || s[e] >= k) flags[(row / n) * c + cc + e] = 1;
    }
  }
  store_vec<V>(d + static_cast<size_t>(row) * c + cc, acc);
}

// d[b, 0, c] = NaN where a slot of cloud b and channel c is outside
// [0, k): `total` = B*C.
__global__ void __launch_bounds__(kThreads)
group_max_flag_kernel(const int* __restrict__ flags, int n, int c, int total,
                      float* __restrict__ d) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < total && flags[t] != 0) d[static_cast<size_t>(t / c) * n * c + t % c] = CUDART_NAN_F;
}

// d_f (B, ms, C) from g (B, n, C) and w (B, n, 3): row (b, r) sums,
// ascending over its list of idx (B, n, 3) (entries (b n + i) 3 + l),
// w[i, l] * g[i], each product rounded as ref.py's `g * w`; `total` =
// B*ms*C/V.
template <int V>
__global__ void __launch_bounds__(kThreads)
three_interpolate_backward_kernel(const float* __restrict__ g,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  const int* __restrict__ order,
                                  const int* __restrict__ off, int ms, int c,
                                  int total, float* __restrict__ df) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int cv = c / V;
  const int row = t / cv;               // b * ms + r
  const int cc = (t - row * cv) * V;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  const bool first = row % ms == 0;     // row 0 also lists bad indices
#pragma unroll 4
  for (int i = off[row]; i < off[row + 1]; ++i) {
    const int ent = order[i];           // (b n + point) 3 + l
    float v[V];
    if (!first || (idx[ent] >= 0 && idx[ent] < ms)) {
      load_vec<V>(g + static_cast<size_t>(ent / 3) * c + cc, v);
      const float wl = w[ent];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __fmul_rn(v[e], wl);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = CUDART_NAN_F;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  }
  store_vec<V>(df + static_cast<size_t>(row) * c + cc, acc);
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

// f (B, N, C) float32, idx (B, M, K) int32 -> out (B, M, C) float32,
// slot (B, M, C) int32.
int group_max_forward(const float* f, const int* idx, int batch, int n, int c,
                      int m, int k, int vec4, float* out, int* slot,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * m * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  if (vec4) {
    group_max_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, n, c, m, k, total, out, slot);
  } else {
    group_max_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        f, idx, n, c, m, k, total, out, slot);
  }
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

// g (B, M, C) float32, idx (B, M) int32 -> out (B, N, C), the scatter-add.
// With `local_rows` > 0 (M <= 8192 and local_rows <= 256, the host plan
// kernels.scatter_plan) one launch of the local form, `local_warps` warps
// a block and local_rows rows a block, lists and gathers, and order and
// off are not used; else the list, then the gather.
int scatter_add_rows(const float* g, const int* idx, int batch, int n, int c,
                     int rows, int local_rows, int local_warps, int list_warps,
                     int ranges, int* order, int* off, int vec4,
                     float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  if (local_rows > 0) {
    if (rows > kLocalEntries || local_rows > kLocalRows || local_warps < 1 ||
        local_warps > kLocalWarps || batch > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((n + local_rows - 1) / local_rows, batch);
    if (vec4) {
      scatter_add_rows_local_kernel<4><<<grid, local_warps * 32, 0, s>>>(
          g, idx, n, c, rows, local_rows, out);
    } else {
      scatter_add_rows_local_kernel<1><<<grid, local_warps * 32, 0, s>>>(
          g, idx, n, c, rows, local_rows, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
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

// g (B, M, C) float32, idx (B, M, K) int32, slot (B, M, C) int32 ->
// d (B, N, C), the routed g; `flags` (B, C) int32 scratch; `vec4` as for
// the forwards (g, slot and d). The list is over idx.
int group_max_backward(const float* g, const int* idx, const int* slot,
                       int batch, int n, int c, int m, int k, int list_warps,
                       int ranges, int* order, int* off, int* flags, int vec4,
                       float* d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * c;
  if (total == 0) return 0;
  int err = reverse_list_build(idx, batch, m * k, n, list_warps, ranges, order,
                               off, stream);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int) * batch * c, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec4) {
    group_max_backward_kernel<4><<<blocks_for(total / 4), kThreads, 0, s>>>(
        g, idx, slot, order, off, n, c, k, total / 4, d, flags);
  } else {
    group_max_backward_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        g, idx, slot, order, off, n, c, k, total, d, flags);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  group_max_flag_kernel<<<blocks_for(batch * c), kThreads, 0, s>>>(flags, n, c,
                                                                   batch * c, d);
  return static_cast<int>(cudaGetLastError());
}

// g (B, N, C), idx (B, N, 3) int32, w (B, N, 3), f (B, Ms, C) float32 ->
// df (B, Ms, C), and dw (B, N, 3) when dw is not null.
int three_interpolate_backward(const float* g, const int* idx, const float* w,
                               const float* f, int batch, int ms, int c, int n,
                               int list_warps, int ranges, int* order,
                               int* off, int vec4,
                               float* df, float* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * ms * (vec4 ? c / 4 : c);
  if (total == 0) return 0;
  const int err = reverse_list_build(idx, batch, n * 3, ms, list_warps, ranges,
                                     order, off, stream);
  if (err != 0) return err;
  if (vec4) {
    three_interpolate_backward_kernel<4><<<blocks_for(total), kThreads, 0, s>>>(
        g, idx, w, order, off, ms, c, total, df);
  } else {
    three_interpolate_backward_kernel<1><<<blocks_for(total), kThreads, 0, s>>>(
        g, idx, w, order, off, ms, c, total, df);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dw == nullptr || n == 0) return static_cast<int>(e);
  const int rows = batch * n;
  three_interpolate_dweight_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                                     kThreads, 0, s>>>(g, idx, f, ms, c, n,
                                                       rows, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
