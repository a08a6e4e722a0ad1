// Ball query for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `ball_query` / `_ball_query_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:1525 and :1491), itself the
// semantics of the reference CUDA op (ball_query_cuda.cu:12-54):
//
//   point j is a hit of center c iff d == 0 or lo <= d < hi,
//   d = ((dx*dx + dy*dy) + dz*dz), lo = min_r^2, hi = max_r^2 (float32);
//   idx[c, 0..] = the first `nsample` hits in ascending j; unfilled slots
//   repeat the first hit; a center with no hit gets a row of zeros.
//
// The Pallas kernel builds a (TM, N) distance tile and extracts the hits by
// `nsample` min sweeps over an index key. Here one warp owns one center and
// streams the cloud: the lanes test 32 consecutive points at once,
// `__ballot_sync` gives the warp the hit mask, and a lane that hit writes its
// index at slot count + popc(mask of the lower lanes), so slots fill in
// ascending index order with no sort. The warp stops scanning once `nsample`
// slots are full and then writes the fill. A block of 8 warps takes 8 centers
// of one cloud and stages the cloud through shared memory in chunks of 1024
// points, read once per block; the block leaves the chunk loop as soon as
// all its warps are done (`__syncthreads_and`).
//
// Rounding: each operation rounded on its own (__fsub_rn/__fmul_rn/
// __fadd_rn), as ops/ref.py computes d. nvcc would otherwise contract to FMA
// and move d in the last bit, which changes the d == 0 and boundary tests.
//
// What bounds it on an H100: operations. At ECG's uniform loss, (32, 2048)
// points with 102 centers, at most 32 x 102 x 2048 pairs of ~12 fp32
// operations (1 ms would be 80 G of them; the bound is ~0.001 ms), and
// 0.8 MB read; in practice the scan ends early for small nsample. With B x
// ceil(M / 8) = 416 blocks of 256 threads every SM has work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // centers per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;           // cloud points per shared chunk

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int n, int m, int nsample, float lo, float hi,
                  int* __restrict__ idx) {
  __shared__ float sxyz[kChunk * 3];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + warp;
  const bool active = c < m;
  const float* x = xyz + static_cast<size_t>(b) * n * 3;
  int* out = idx + (static_cast<size_t>(b) * m + (active ? c : 0)) * nsample;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* cc = centers + (static_cast<size_t>(b) * m + c) * 3;
    cx = cc[0];
    cy = cc[1];
    cz = cc[2];
  }
  int count = 0;       // hits so far, the same in every lane
  int first = 0;       // index of the first hit
  bool done = !active;

  for (int j0 = 0; j0 < n; j0 += kChunk) {
    const int len = min(kChunk, n - j0);
    for (int t = threadIdx.x; t < 3 * len; t += kThreads) {
      sxyz[t] = x[3 * j0 + t];
    }
    __syncthreads();
    for (int s = 0; s < len && !done; s += 32) {
      const int j = s + lane;
      bool hit = false;
      if (j < len) {
        const float dx = __fsub_rn(cx, sxyz[3 * j]);
        const float dy = __fsub_rn(cy, sxyz[3 * j + 1]);
        const float dz = __fsub_rn(cz, sxyz[3 * j + 2]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        hit = d == 0.f || (d >= lo && d < hi);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0u) {
        if (count == 0) first = j0 + s + __ffs(mask) - 1;
        const int slot = count + __popc(mask & ((1u << lane) - 1u));
        if (hit && slot < nsample) out[slot] = j0 + j;
        count += __popc(mask);
        done = count >= nsample;
      }
    }
    // leave the loop once every warp of the block is done; the barrier also
    // keeps the chunk until all warps have read it
    if (__syncthreads_and(done)) break;
  }
  if (active) {
    const int fill = count > 0 ? first : 0;
    for (int slot = count + lane; slot < nsample; slot += 32) out[slot] = fill;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3), centers (B, M, 3) float32 contiguous on the device; idx
// (B, M, nsample) int32. lo and hi are the squared radii as float32. N, M,
// nsample >= 1, B <= 65535. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
int ball_query_forward(const float* xyz, const float* centers, int batch, int n,
                       int m, int nsample, float lo, float hi, int* idx,
                       void* stream) {
  if (batch < 1 || n < 1 || m < 1 || nsample < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kWarps - 1) / kWarps, batch);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, centers, n, m, nsample, lo, hi, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
