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

}  // extern "C"
