// Chamfer forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_chamfer_pallas` / `_chamfer_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:133 and :95). It computes what
// that kernel computes, not its block structure:
//
//   dist1[b, i] = min_j |a_i - b_j|^2, idx1 = argmin (lowest j on ties)
//   dist2[b, j] = min_i |b_j - a_i|^2, idx2 = argmin (lowest i on ties)
//
// The Pallas kernel folds the column direction (dist2/idx2) into one output
// block across its grid axis 1, which a TPU runs in order. GPU blocks run in
// no order, so that carry would be a race here. Instead one row-min kernel is
// launched twice, for (a -> b) and then (b -> a): each thread owns one query
// row and keeps a running min and argmin over the other cloud, which the
// block stages through shared memory tile by tile. j ascends and the compare
// is a strict `<`, so ties go to the lower index, as `jnp.argmin`, the Pallas
// kernel and `ops/ref.py` resolve them.
//
// Rounding: every distance is ((dx*dx + dy*dy) + dz*dz) with each operation
// rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn). nvcc would otherwise
// contract a*b+c into an FMA, which changes distances in the last bit and can
// flip near-tie argmins against the plain version. With this, distances are
// bitwise equal to ref.chamfer_distance's on the card (eager torch
// elementwise ops are not fused).
//
// What bounds it on an H100: compute. Each pair costs 3 subtractions and
// 5 fp32 multiplies/adds plus a compare and select, and the slice's shape
// (B=32, N=M=2048) is about 134 M pairs per direction, against 24 KB of
// points per cloud in device memory; the N x M matrix never exists. The
// design keeps the query point and the running min in registers, reads each
// point of the other cloud once per block from device memory into shared
// memory, and has all threads of a warp read the same shared word at once
// (a broadcast, no bank conflicts). Register blocking of several query rows
// per thread and warp-level tiling are left for later work.
//
// Chamfer backward: replaces `_chamfer_grad_mxu` / `_chamfer_grad_mxu_kernel`
// (pallas_kernels.py:333 and :270), the default backward of `_chamfer_bwd`
// :417. For one side p of the pair (p, q), with the argmins ip (p -> q) and
// iq (q -> p) and the cotangents gp, gq of the two distance vectors:
//
//   dp[i] = 2 gp[i] (p[i] - q[ip[i]]) - sum_{j: iq[j] = i} 2 gq[j] (q[j] - p[i])
//
// (the XLA form of :442-450). The TPU kernel builds both terms as one-hot
// MXU products, accumulating over its grid in order. Here the scatter term
// is a gather: the wrapper's call first builds the reverse list of iq
// (reverse_list.cu), then a thread a point i of p takes the gather term at
// its own row and subtracts the sum of the q terms that name i, taken in
// ascending j, with one plain store: no atomics, so two runs are bitwise
// equal. A random-weight prediction sends many gt points to a few of its
// points, so a list longer than eight entries is summed by the whole warp,
// 32 terms a step, in the same order. (On VRCNet's step on an H100 a thread
// a point alone took 11x the atomic form's device time, a warp a point
// 3.7x, eight lanes a point, diverging over their lists, 8.4x.) Each term is (2 g) * (p - q),
// rounded as ops/ref.py rounds it, and the sum is taken in the order
// ref.py's scatter takes it on the CPU. The wrapper launches it only for a
// side whose gradient is asked for: `calc_cd(pred, gt)` needs the
// prediction side alone. An index outside its cloud makes the gather term
// NaN at the point's own row, or is listed under row 0 (scatter term),
// whose thread adds NaN, instead of reading out of bounds.
//
// What bounds it: bytes, and the list's serial steps. At VRCNet's step (B
// 64, 3072 predicted against 2048 gt points) it reads 3.2 MB and writes
// 2.4 MB (~0.002 ms at 3.35 TB/s); the lists' lengths follow the
// prediction, and a warp takes a long one 32 entries at a time.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "reverse_list.h"

namespace {

constexpr int kThreads = 128;  // query rows per block
constexpr int kTile = 1024;    // points of the other cloud per shared tile

__global__ void __launch_bounds__(kThreads)
chamfer_rowmin_kernel(const float* __restrict__ query,
                      const float* __restrict__ points, int nq, int np,
                      float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* q = query + static_cast<size_t>(b) * nq * 3;
  const float* p = points + static_cast<size_t>(b) * np * 3;
  const bool active = i < nq;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = CUDART_INF_F;
  int best_j = 0;

  for (int j0 = 0; j0 < np; j0 += kTile) {
    const int n = min(kTile, np - j0);  // ragged last tile
    for (int t = threadIdx.x; t < 3 * n; t += kThreads) {
      tile[t] = p[3 * j0 + t];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float dx = __fsub_rn(qx, tile[3 * j]);
        const float dy = __fsub_rn(qy, tile[3 * j + 1]);
        const float dz = __fsub_rn(qz, tile[3 * j + 2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d < best) {
          best = d;
          best_j = j0 + j;
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    dist[static_cast<size_t>(b) * nq + i] = best;
    idx[static_cast<size_t>(b) * nq + i] = best_j;
  }
}

void launch_rowmin(const float* query, const float* points, int batch, int nq,
                   int np, float* dist, int* idx, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  chamfer_rowmin_kernel<<<grid, kThreads, 0, stream>>>(query, points, nq, np,
                                                       dist, idx);
}

constexpr int kBwdThreads = 256;

// dp (B, np, 3): a thread a point i of p takes the gather term at its own
// row and subtracts the sum, ascending over its list of iq (B, nq), of the
// q terms that name it. A list longer than kShort is summed by the whole
// warp, 32 terms a step, every lane adding them in list order (the same
// order a thread takes), one such list at a time. `rows` = B np.
constexpr int kShort = 8;

__global__ void __launch_bounds__(kBwdThreads)
chamfer_backward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                        const int* __restrict__ ip, const float* __restrict__ gp,
                        const int* __restrict__ iq, const float* __restrict__ gq,
                        const int* __restrict__ order, const int* __restrict__ off,
                        int np, int nq, int rows, float* __restrict__ dp) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBwdThreads + threadIdx.x;
  const bool live = row < rows;                      // no early exit: shuffles below
  const int b = live ? row / np : 0;
  const int i = live ? row - b * np : 0;
  float pi[3], s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pi[c] = live ? p[3 * static_cast<size_t>(row) + c] : 0.f;
    s[c] = 0.f;
  }
  const int begin = live ? off[row] : 0;
  const int end = live ? off[row + 1] : 0;
  // 2 gq[j] (q[j] - p[i]) for entry t of the cloud b row (b, i) lists
  auto term = [&](int t, int tb, int ti, const float (&tp)[3], float (&v)[3]) {
    const int e = order[t];                          // tb nq + j
    const int j = e - tb * nq;
    const bool ok = ti != 0 || (iq[e] >= 0 && iq[e] < np);  // row 0 lists bad ones
    const float coef = __fmul_rn(2.f, gq[e]);
    const float* qj = q + (static_cast<size_t>(tb) * nq + j) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = ok ? __fmul_rn(coef, __fsub_rn(qj[c], tp[c])) : CUDART_NAN_F;
    }
  };
  if (end - begin <= kShort) {
    for (int t = begin; t < end; ++t) {
      float v[3];
      term(t, b, i, pi, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = __fadd_rn(s[c], v[c]);
    }
  }
  for (unsigned longs = __ballot_sync(full, end - begin > kShort); longs != 0;
       longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const int lb = __shfl_sync(full, begin, src), le = __shfl_sync(full, end, src);
    const int tb = __shfl_sync(full, b, src), ti = __shfl_sync(full, i, src);
    float tp[3], acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) tp[c] = __shfl_sync(full, pi[c], src);
    for (int t0 = lb; t0 < le; t0 += 32) {
      float v[3] = {0.f, 0.f, 0.f};
      if (t0 + lane < le) term(t0 + lane, tb, ti, tp, v);
      const int count = min(32, le - t0);
      for (int u = 0; u < count; ++u) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = __fadd_rn(acc[c], __shfl_sync(full, v[c], u));
      }
    }
    if (lane == src) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = acc[c];
    }
  }
  if (!live) return;
  const int j = ip[row];                             // 2 gp[i] (p[i] - q[ip[i]])
  const float coef = __fmul_rn(2.f, gp[row]);
  const float* qb = q + static_cast<size_t>(b) * nq * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = j >= 0 && j < nq
        ? __fmul_rn(coef, __fsub_rn(pi[c], qb[3 * j + c]))
        : CUDART_NAN_F;
    dp[3 * static_cast<size_t>(row) + c] = __fsub_rn(v, s[c]);
  }
}

}  // namespace

extern "C" {

// a (B, N, 3), b (B, M, 3) float32 contiguous on the device; outputs
// d1/i1 (B, N), d2/i2 (B, M). Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
int chamfer_forward(const float* a, const float* b, int batch, int n, int m,
                    float* d1, int* i1, float* d2, int* i2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_rowmin(a, b, batch, n, m, d1, i1, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_rowmin(b, a, batch, m, n, d2, i2, s);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of one side: p (B, NP, 3), q (B, NQ, 3) float32, ip/gp
// (B, NP), iq/gq (B, NQ) (int32 / float32), all contiguous on the device;
// the reverse list of iq (reverse_list.cu: `list_warps`, `ranges`, order
// (B NQ), off (B NP + 1)) -> dp (B, NP, 3). For da of chamfer_forward(a, b) pass
// (a, b, i1, g1, i2, g2); for db, (b, a, i2, g2, i1, g1). Launches on
// `stream` without synchronising; returns cudaGetLastError().
int chamfer_backward(const float* p, const float* q, const int* ip,
                     const float* gp, const int* iq, const float* gq,
                     int batch, int np, int nq, int list_warps, int ranges,
                     int* order, int* off, float* dp, void* stream) {
  if (batch == 0 || np == 0) return 0;
  const int err = reverse_list_build(iq, batch, nq, np, list_warps, ranges, order,
                                     off, stream);
  if (err != 0) return err;
  const int rows = batch * np;
  chamfer_backward_kernel<<<(rows + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, q, ip, gp, iq, gq, order, off, np, nq, rows, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
