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
// MXU products, accumulating over its grid in order; here one thread takes
// one point of either cloud and adds its term with fp32 atomicAdd into dp,
// which the wrapper zeroes: a thread of p adds the gather term at its own
// row, a thread of q subtracts its term at row iq[j]. Each term is
// (2 g) * (p - q), rounded as ops/ref.py rounds it; the sum into one row is
// in atomic order, so dp agrees with ref.chamfer_backward to a tolerance.
// The wrapper launches it only for a side whose gradient is asked for:
// `calc_cd(pred, gt)` needs the prediction side alone. An index outside its
// cloud adds NaN to the thread's own row (gather term) or to row 0 (scatter
// term) instead of reading or writing out of bounds.
//
// What bounds it: bytes and atomics. At VRCNet's step (B 64, 3072 predicted
// against 2048 gt points) it reads 3.2 MB and writes 2.4 MB (~0.002 ms at
// 3.35 TB/s) with 3 * (3072 + 2048) atomic adds per cloud; a collapsed
// prediction sends many q rows to one p row, which serialise in L2.

#include <cuda_runtime.h>
#include <math_constants.h>

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

// dp (B, np, 3) += the gradient terms; threads [0, np) of a cloud take the
// points of p, [np, np + nq) those of q. Grid (ceil((np + nq) / 256), B).
__global__ void __launch_bounds__(kBwdThreads)
chamfer_backward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                        const int* __restrict__ ip, const float* __restrict__ gp,
                        const int* __restrict__ iq, const float* __restrict__ gq,
                        int np, int nq, float* __restrict__ dp) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kBwdThreads + threadIdx.x;
  if (t >= np + nq) return;
  const float* pb = p + static_cast<size_t>(b) * np * 3;
  const float* qb = q + static_cast<size_t>(b) * nq * 3;
  float* db = dp + static_cast<size_t>(b) * np * 3;
  if (t < np) {                           // 2 gp[i] (p[i] - q[ip[i]]) at i
    const int i = t;
    const int j = ip[static_cast<size_t>(b) * np + i];
    const float coef = __fmul_rn(2.f, gp[static_cast<size_t>(b) * np + i]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = j >= 0 && j < nq
          ? __fmul_rn(coef, __fsub_rn(pb[3 * i + c], qb[3 * j + c]))
          : CUDART_NAN_F;
      atomicAdd(db + 3 * i + c, v);
    }
  } else {                                // -2 gq[j] (q[j] - p[iq[j]]) at iq[j]
    const int j = t - np;
    const int i = iq[static_cast<size_t>(b) * nq + j];
    const bool ok = i >= 0 && i < np;
    const float coef = __fmul_rn(2.f, gq[static_cast<size_t>(b) * nq + j]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (ok) {
        atomicAdd(db + 3 * i + c,
                  -__fmul_rn(coef, __fsub_rn(qb[3 * j + c], pb[3 * i + c])));
      } else {
        atomicAdd(db + c, CUDART_NAN_F);
      }
    }
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
// dp (B, NP, 3) zeroed by the caller. For da of chamfer_forward(a, b) pass
// (a, b, i1, g1, i2, g2); for db, (b, a, i2, g2, i1, g1). Launches on
// `stream` without synchronising; returns cudaGetLastError().
int chamfer_backward(const float* p, const float* q, const int* ip,
                     const float* gp, const int* iq, const float* gq,
                     int batch, int np, int nq, float* dp, void* stream) {
  if (batch == 0 || np + nq == 0) return 0;
  const dim3 grid((np + nq + kBwdThreads - 1) / kBwdThreads, batch);
  chamfer_backward_kernel<<<grid, kBwdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, q, ip, gp, iq, gq, np, nq, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
