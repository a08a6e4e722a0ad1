// IDAM's fused Propagate edge block for Hopper (sm_90a), eval, with a plain C
// interface for ctypes.
//
// Replaces the two TPU kernels that `gnn_propagate_eval`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:4466) runs one after the other:
// the edge build `_gp_edge_build` :4370 (`_gp_edge_kernel` :4309), which
// writes the (B, k, N, C) bf16 edge tensor to device memory, and
// `gnn_edge_eval` :4242 (`_ge_final_kernel` :4042), which reads it back for
// the BatchNorm -> relu -> Dense -> max-over-k chain. Per point i of p
// (B, N, C) and each of its k neighbours j = idx[b, i, s]:
//
//   e   = bf16(bf16(p[b, j]) - p[b, i])        the edge, bf16 as the TPU stores it
//   x1  = bf16(relu(((e - mean) * inv) * gamma + beta))
//   h   = sum_c x1[c] * W[c, :]  + b           W bf16, fp32 sum in channel order
//   out[b, i] = max over s of h                (B, N, C) fp32
//
// with inv = rsqrt(var + 1e-5) computed once by the wrapper (torch.rsqrt on
// the card, so that ops/ref.py `gnn_propagate_eval` uses the same bits): the
// semantics of `gnn_propagate_reference(train=False)` :4472, BatchNorm in
// `_em_bn`'s order :2749. Rounding: every operation before the product is
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction),
// as the plain version's separate PyTorch operations are; the product of two
// bf16 values is exact in fp32, so acc = fma(x1[c], W[c, d], acc) is the
// plain version's acc + x1[c] * W[c, d], summed in the same channel order.
// The output is then bitwise equal to ref.gnn_propagate_eval's on the card.
//
// What bounds it on an H100: memory. At IDAM's protocol width (B 32, N 2048,
// k 12, C 64) a call reads p (16.8 MB) and idx (3.1 MB) and writes the
// output (16.8 MB): 37 MB, 0.011 ms at 3.35 TB/s, against 2 B k N C^2 =
// 6.4 GFLOP (bf16 operands), 0.0065 ms on the tensor cores. The design keeps
// the edge tensor out of device memory (on the TPU 100 MB a call, written by
// one pass and read by the next): a block takes 16 points and, for one
// neighbour slot s at a time, builds their 16 edge rows in shared memory
// (4 KB, each thread a few of the 16 x C entries, reading p's rows through
// L2), then each thread computes one output channel d of 4 (C 64) or 2
// (C 32) points against W's column d, held in registers (C floats), reading
// the edge rows as 16-byte broadcasts, and keeps the running max over s in
// registers. The sequential fp32 sum on CUDA cores (the order that makes the
// result bitwise the plain version's) is what this simple kernel pays for:
// 3.2 G fused multiply-adds a call, ~0.1 ms at the fp32 peak, and the
// gathered rows (200 MB through L2). A later PR would run the product on
// the tensor cores and hold the plain version to a tolerance instead.
//
// An index outside [0, N) makes its point's output NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;      // points a block takes at once

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ inv,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     int n, int k, long long points, float* __restrict__ out) {
  constexpr int kLanes = kThreads / C;          // points computed at once
  constexpr int kPer = kTile / kLanes;          // points a thread computes
  __shared__ __align__(16) float edge[kTile][C];
  const int d = threadIdx.x % C;
  const int q = threadIdx.x / C;

  float wcol[C];
#pragma unroll
  for (int c = 0; c < C; ++c) wcol[c] = bf16r(w[c * C + d]);
  const float bd = bias[d];

  for (long long t0 = static_cast<long long>(blockIdx.x) * kTile; t0 < points;
       t0 += static_cast<long long>(gridDim.x) * kTile) {
    float best[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) best[r] = -CUDART_INF_F;
    for (int s = 0; s < k; ++s) {
      // build the 16 edge rows of slot s
      for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
        const int pl = e / C, c = e % C;
        const long long pt = t0 + pl;
        float x = 0.f;
        if (pt < points) {
          const long long b = pt / n;
          const int j = idx[pt * k + s];
          if (j < 0 || j >= n) {
            x = CUDART_NAN_F;
          } else {
            const float nb = bf16r(p[(b * n + j) * C + c]);
            const float ed = bf16r(__fsub_rn(nb, p[pt * C + c]));
            const float hh = __fmul_rn(__fsub_rn(ed, mean[c]), inv[c]);
            const float y = __fadd_rn(__fmul_rn(hh, gamma[c]), beta[c]);
            x = bf16r(y > 0.f ? y : 0.f);
          }
        }
        edge[pl][c] = x;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const float4* row = reinterpret_cast<const float4*>(edge[q + kLanes * r]);
        float acc = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < C / 4; ++c4) {
          const float4 v = row[c4];
          acc = c4 == 0 ? __fmul_rn(v.x, wcol[0]) : __fmaf_rn(v.x, wcol[4 * c4], acc);
          acc = __fmaf_rn(v.y, wcol[4 * c4 + 1], acc);
          acc = __fmaf_rn(v.z, wcol[4 * c4 + 2], acc);
          acc = __fmaf_rn(v.w, wcol[4 * c4 + 3], acc);
        }
        const float h = __fadd_rn(acc, bd);
        // a NaN (an index out of range) stays NaN, as torch.amax keeps it
        best[r] = (h > best[r] || h != h) ? h : best[r];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const long long pt = t0 + q + kLanes * r;
      if (pt < points) out[pt * C + d] = best[r];
    }
  }
}

template <int C>
int launch(const float* p, const int* idx, const float* w, const float* bias,
           const float* mean, const float* inv, const float* gamma, const float* beta,
           int batch, int n, int k, float* out, cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n;
  const long long tiles = (points + kTile - 1) / kTile;
  const int grid = static_cast<int>(tiles < (1LL << 30) ? tiles : (1LL << 30));
  gnn_propagate_kernel<C><<<grid, kThreads, 0, stream>>>(
      p, idx, w, bias, mean, inv, gamma, beta, n, k, points, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// p (B, N, C) fp32, idx (B, N, k) int32, W (C, C) fp32 in the flax (in, out)
// orientation (rounded to bf16 here), bias, mean, inv = rsqrt(var + 1e-5),
// gamma, beta (C,) fp32, all contiguous on the device -> out (B, N, C) fp32.
// C is 32 or 64. Launches on `stream` without synchronising; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another C, B < 1, N < 1
// or k < 1.
int gnn_propagate_forward(const float* p, const int* idx, const float* w,
                          const float* bias, const float* mean, const float* inv,
                          const float* gamma, const float* beta, int batch, int n,
                          int c, int k, float* out, void* stream) {
  if (batch < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 64) return launch<64>(p, idx, w, bias, mean, inv, gamma, beta, batch, n, k, out, st);
  if (c == 32) return launch<32>(p, idx, w, bias, mean, inv, gamma, beta, batch, n, k, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
