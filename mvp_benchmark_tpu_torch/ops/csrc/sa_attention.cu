// VRCNet's SA block for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_sa_primal` / `_sa_fwd_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:1354 and :1214), the forward of
// `sa_attention` :1323. Per point p of (B, N), with k neighbours idx[p, :]
// and ms = mid / share:
//
//   w_in = relu([x1[p], proj[idx_0, :rel], ..., proj[idx_{k-1}, :rel]])
//   u    = relu(w_in . W1)                 W1 ((1+k)*rel, ms), no bias
//   w    = u . W2 + b2, viewed (k, ms)     W2 (ms, k*ms), b2 (k*ms)
//   out[p, c] = sum_j w[j, c % ms] * proj[idx_j, rel + c],   c < mid
//
// the semantics of the XLA block in mvp_benchmark_tpu/models/vrcnet.py:100-108
// and of ops/ref.py `sa_attention`. The Pallas kernel gathers through bf16
// one-hot MXU products and rounds W1 and W2 to bf16; here a gather is an
// indexed load and everything stays fp32. The products are summed in
// another order than ref.py's matmuls, so the two agree to a tolerance
// (|kernel - plain| <= 1e-5 + 1e-4 |plain| at unit-scale inputs), not bitwise.
//
// Design: one warp per point, 8 warps a block, a grid of as many blocks as
// fit on the card at once, each warp walking points with a grid stride. The
// block stages W1 (transposed, so that lanes read consecutive addresses),
// W2 and b2 in shared memory once. Per point:
//   - lane j < k holds the neighbour index idx_j; others read it by shuffle;
//   - the (1+k)*rel inputs of the first layer are spread over the lanes
//     (element e on lane e % 32), each lane keeps ms partial sums, and a
//     butterfly of shuffles leaves u on every lane;
//   - lane t computes w[t], w[t+32], ... into a per-warp shared buffer;
//   - lane t accumulates out[c] for c = t, t+32, ... over the k neighbours,
//     reading the mid part of each neighbour row as one contiguous segment.
// Templated on (rel, mid, ms) for VRCNet's four pyramid levels (4, 16, 2),
// (8, 32, 4), (16, 64, 8) and (32, 128, 16); k is a runtime value in
// [1, 32]. An index outside [0, N) makes the point's output NaN instead of
// reading out of bounds (the wrapper does not range-check on the host).
//
// What bounds it on an H100: bytes. At level 1 of the protocol config
// (B 32, N 3072, rel 4, mid 16, k 16) the inputs proj, x1 and idx and the
// output are 22 MB (6.6 us at 3.35 TB/s) against 0.09 GFLOP of MLP and
// weighted sum (1.4 us at the 67 TFLOP/s fp32 peak); level 4 (N 384, rel 32,
// mid 128) is 4.5 MB against 0.37 GFLOP. A neighbour row is read once per
// point that gathers it (k times on average); L2 (50 MB) holds proj, so
// device memory sees it about once. This simple design is latency-bound: one
// point a warp leaves half the lanes idle in the weighted sum at level 1
// (mid 16), and the first layer's reduction costs 5 shuffles per output. A
// later PR would give a warp several points, or run the first layer as a
// tensor-core product over a tile of points.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

// Shared floats a block needs for k neighbours: W1^T, W2, b2, and one w
// buffer per warp.
int smem_floats(int rel, int ms, int k) {
  return (1 + k) * rel * ms + ms * k * ms + k * ms + kWarps * k * ms;
}

// At least 4 blocks an SM: up to 64 registers a thread. Without the floor
// ptxas aims at 8 blocks (32 registers) and spilled at (8, 32, 4).
template <int REL, int MID, int MS>
__global__ void __launch_bounds__(kThreads, 4)
sa_attention_kernel(const float* __restrict__ proj,
                    const float* __restrict__ x1, const int* __restrict__ idx,
                    const float* __restrict__ w1, const float* __restrict__ w2,
                    const float* __restrict__ b2, int n, int k, int points,
                    float* __restrict__ out) {
  constexpr int C = REL + MID;           // width of a proj row
  constexpr int OUT_PER_LANE = (MID + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  const int in_w = (1 + k) * REL;        // rows of W1
  const int kms = k * MS;                // columns of W2
  float* sw1t = smem;                    // (MS, in_w): W1 transposed
  float* sw2 = sw1t + in_w * MS;         // (MS, kms)
  float* sb2 = sw2 + MS * kms;           // (kms)
  for (int t = threadIdx.x; t < in_w * MS; t += kThreads) {
    sw1t[(t % MS) * in_w + t / MS] = w1[t];
  }
  for (int t = threadIdx.x; t < MS * kms; t += kThreads) sw2[t] = w2[t];
  for (int t = threadIdx.x; t < kms; t += kThreads) sb2[t] = b2[t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* wb = sb2 + kms + warp * kms;    // this warp's w (k, MS)

  for (int p = blockIdx.x * kWarps + warp; p < points;
       p += gridDim.x * kWarps) {
    const float* pb = proj + static_cast<size_t>(p / n) * n * C;
    const int nb = lane < k ? idx[static_cast<size_t>(p) * k + lane] : 0;
    float* op = out + static_cast<size_t>(p) * MID;
    if (__any_sync(kFull, nb < 0 || nb >= n)) {
      for (int c = lane; c < MID; c += 32) op[c] = CUDART_NAN_F;
      continue;
    }

    // First layer: element e of w_in on lane e % 32, ms partial sums a lane.
    float acc[MS];
#pragma unroll
    for (int q = 0; q < MS; ++q) acc[q] = 0.f;
    for (int e0 = 0; e0 < in_w; e0 += 32) {
      const int e = e0 + lane;
      const int j = e >= REL ? (e - REL) / REL : 0;
      const int row = __shfl_sync(kFull, nb, j < k ? j : 0);
      if (e < in_w) {
        const float v = fmaxf(
            e < REL ? x1[static_cast<size_t>(p) * REL + e]
                    : pb[static_cast<size_t>(row) * C + (e - REL) % REL],
            0.f);
#pragma unroll
        for (int q = 0; q < MS; ++q) acc[q] = fmaf(v, sw1t[q * in_w + e], acc[q]);
      }
    }
    float u[MS];
#pragma unroll
    for (int q = 0; q < MS; ++q) {
      float s = acc[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      u[q] = fmaxf(s, 0.f);
    }

    // Second layer: w[o] = u . W2[:, o] + b2[o] into the warp's buffer.
    for (int o = lane; o < kms; o += 32) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MS; ++q) s = fmaf(u[q], sw2[q * kms + o], s);
      wb[o] = s + sb2[o];
    }
    __syncwarp();

    // Weighted sum over the neighbours, channel c on lane c % 32.
    float o_acc[OUT_PER_LANE];
#pragma unroll
    for (int m = 0; m < OUT_PER_LANE; ++m) o_acc[m] = 0.f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const int row = __shfl_sync(kFull, nb, j);
      const float* pr = pb + static_cast<size_t>(row) * C + REL;
#pragma unroll
      for (int m = 0; m < OUT_PER_LANE; ++m) {
        const int c = lane + 32 * m;
        if (c < MID) o_acc[m] = fmaf(wb[j * MS + c % MS], pr[c], o_acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < OUT_PER_LANE; ++m) {
      const int c = lane + 32 * m;
      if (c < MID) op[c] = o_acc[m];
    }
    __syncwarp();                        // wb is rewritten for the next point
  }
}

template <int REL, int MID, int MS>
int launch(const float* proj, const float* x1, const int* idx, const float* w1,
           const float* w2, const float* b2, int batch, int n, int k,
           float* out, cudaStream_t stream) {
  auto kernel = sa_attention_kernel<REL, MID, MS>;
  const size_t smem = sizeof(float) * smem_floats(REL, MS, k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int points = batch * n;
  int grid = per_sm * sms;                  // every block resident at once
  if (grid < 1) grid = 1;
  if (grid > (points + kWarps - 1) / kWarps) grid = (points + kWarps - 1) / kWarps;
  sa_attention_kernel<REL, MID, MS><<<grid, kThreads, smem, stream>>>(
      proj, x1, idx, w1, w2, b2, n, k, points, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// proj (B, N, rel+mid), x1 (B, N, rel), idx (B, N, k) int32, W1
// ((1+k)*rel, ms), W2 (ms, k*ms), b2 (k*ms), ms = mid / share, all
// contiguous float32 on the device -> out (B, N, mid). (rel, mid, ms) is
// one of (4, 16, 2), (8, 32, 4), (16, 64, 8), (32, 128, 16); 1 <= k <= 32.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for shapes outside those limits.
int sa_attention_forward(const float* proj, const float* x1, const int* idx,
                         const float* w1, const float* w2, const float* b2,
                         int batch, int n, int rel, int mid, int share, int k,
                         float* out, void* stream) {
  if (k < 1 || k > kMaxK || share < 1 || mid % share != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ms = mid / share;
  if (rel == 4 && mid == 16 && ms == 2) {
    return launch<4, 16, 2>(proj, x1, idx, w1, w2, b2, batch, n, k, out, s);
  } else if (rel == 8 && mid == 32 && ms == 4) {
    return launch<8, 32, 4>(proj, x1, idx, w1, w2, b2, batch, n, k, out, s);
  } else if (rel == 16 && mid == 64 && ms == 8) {
    return launch<16, 64, 8>(proj, x1, idx, w1, w2, b2, batch, n, k, out, s);
  } else if (rel == 32 && mid == 128 && ms == 16) {
    return launch<32, 128, 16>(proj, x1, idx, w1, w2, b2, batch, n, k, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
