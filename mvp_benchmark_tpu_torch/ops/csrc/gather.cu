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
// hi/lo-bf16 tables) into one output block that the grid revisits in order.
// On a GPU that carry is a race, so each scatter here is an fp32 atomicAdd
// into an output the wrapper zeroes: one thread per element of g, each
// adding its value (times the weight) at the row its index names. The sum
// into one row is taken in atomic order, which changes from run to run, so
// these agree with ops/ref.py to a tolerance, not bitwise. d_w is a dot
// product per (n, l): one warp per target row, lanes over channels, a
// shuffle reduction. An index outside [0, N) (or a slot outside [0, k))
// adds NaN to row 0 of its cloud instead of writing out of bounds.
//
// What bounds them: bytes, and the atomics. At VRCNet's largest
// three_interpolate backward (B 64, 3072 x 128 from 1536 rows) g is 101 MB
// and d_f 50 MB: 0.045 ms at 3.35 TB/s. Each of the 3 * 25 M atomic adds
// is a read-modify-write in L2; rows gathered by many queries serialise
// there. A later PR would sort the indices and sum segments in registers.

#include <cuda_runtime.h>
#include <math_constants.h>

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

// out (B, n, C) += g (B, rows, C) at rows idx (B, rows); `total` = B*rows*C.
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                        int n, int c, int rows, int total,
                        float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int r = t / c;                  // b * rows + m
  const int cc = t - r * c;
  const int b = r / rows;
  const int dst = idx[r];
  float* ob = out + static_cast<size_t>(b) * n * c + cc;
  if (dst >= 0 && dst < n) {
    atomicAdd(ob + static_cast<size_t>(dst) * c, g[t]);
  } else {
    atomicAdd(ob, CUDART_NAN_F);
  }
}

// d (B, n, C) += g (B, m, C) at rows idx[b, m, slot[b, m, c]]; `total` =
// B*m*C.
__global__ void __launch_bounds__(kThreads)
group_max_backward_kernel(const float* __restrict__ g,
                          const int* __restrict__ idx,
                          const int* __restrict__ slot, int n, int c, int m,
                          int k, int total, float* __restrict__ d) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int r = t / c;                  // b * m + row
  const int cc = t - r * c;
  const int b = r / m;
  const int s = slot[t];
  const int src = s >= 0 && s < k ? idx[static_cast<size_t>(r) * k + s] : -1;
  float* db = d + static_cast<size_t>(b) * n * c + cc;
  if (src >= 0 && src < n) {
    atomicAdd(db + static_cast<size_t>(src) * c, g[t]);
  } else {
    atomicAdd(db, CUDART_NAN_F);
  }
}

// d_f (B, ms, C) += w * g from g (B, n, C), idx and w (B, n, 3); `total` =
// B*n*C. Each term is rounded as ref.py's `g * w` is.
__global__ void __launch_bounds__(kThreads)
three_interpolate_backward_kernel(const float* __restrict__ g,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w, int ms, int c,
                                  int n, int total, float* __restrict__ df) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int r = t / c;                  // b * n + row
  const int cc = t - r * c;
  const int b = r / n;
  const float gv = g[t];
  float* fb = df + static_cast<size_t>(b) * ms * c + cc;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int src = idx[static_cast<size_t>(r) * 3 + l];
    if (src >= 0 && src < ms) {
      atomicAdd(fb + static_cast<size_t>(src) * c,
                __fmul_rn(gv, w[static_cast<size_t>(r) * 3 + l]));
    } else {
      atomicAdd(fb, CUDART_NAN_F);
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

// The backwards take `out`/`d`/`df` zeroed by the caller and add into it.

// g (B, M, C) float32, idx (B, M) int32 -> out (B, N, C) += scatter.
int scatter_add_rows(const float* g, const int* idx, int batch, int n, int c,
                     int rows, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * rows * c;
  if (total == 0) return 0;
  scatter_add_rows_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      g, idx, n, c, rows, total, out);
  return static_cast<int>(cudaGetLastError());
}

// g (B, M, C) float32, idx (B, M, K) int32, slot (B, M, C) int32 ->
// d (B, N, C) += routed g.
int group_max_backward(const float* g, const int* idx, const int* slot,
                       int batch, int n, int c, int m, int k, float* d,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * m * c;
  if (total == 0) return 0;
  group_max_backward_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      g, idx, slot, n, c, m, k, total, d);
  return static_cast<int>(cudaGetLastError());
}

// g (B, N, C), idx (B, N, 3) int32, w (B, N, 3), f (B, Ms, C) float32 ->
// df (B, Ms, C) += scatter, and dw (B, N, 3) when dw is not null.
int three_interpolate_backward(const float* g, const int* idx, const float* w,
                               const float* f, int batch, int ms, int c, int n,
                               float* df, float* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = batch * n * c;
  if (total == 0) return 0;
  three_interpolate_backward_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      g, idx, w, ms, c, n, total, df);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return static_cast<int>(err);
  const int rows = batch * n;
  three_interpolate_dweight_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                                     kThreads, 0, s>>>(g, idx, f, ms, c, n,
                                                       rows, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
