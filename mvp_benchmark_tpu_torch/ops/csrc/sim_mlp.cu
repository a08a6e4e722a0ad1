// IDAM's similarity-matrix MLP for Hopper (sm_90a), eval, with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel `_sm_final_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:3468, with `_sm_h0` :3329 and
// `_sm_chain` :3365), launched by `_sm_pass` :3727 from `sim_mlp_eval`
// :3936 with the running statistics. For every pair (i, j) of the M kept
// source and target points of a cloud, from the per-point projections sp, tp
// (B, M, C) (a plain product outside the kernel, as `_sm_prep` :3880 leaves
// it to XLA) and the positions src, tgt (B, M, 3):
//
//   diff = src_i - tgt_j,  dist = sqrt(dx dx + dy dy + dz dz)
//   h0   = (sp_i + tp_j) + (dist * w0 + bf16(diff / (dist + 1e-8)) . bf16(Wxyz))
//   x1   = bf16(relu(((h0 - mean1) * inv1) * gamma1 + beta1))
//   h1   = x1 . bf16(W2) + b2               wmax[b, i] = max over j of h1
//   h2   = bf16(h1) . bf16(W3)
//   x2   = relu(((h2 - mean2) * inv2) * gamma2 + beta2)
//   simr[b, i, j] = sum_c x2[c] * W4[c]      fp32
//
// (C = 32; inv = rsqrt(var + 1e-5) from the wrapper, torch.rsqrt on the card):
// the semantics of `sim_mlp_reference(train=False)` :3961 before its bias
// and clip, which the wrapper's caller adds. The direction is diff divided
// by (dist + 1e-8), as the reference writes it; the TPU kernel multiplies
// by the reciprocal (:3349-3359). Rounding: each operation outside the bf16
// products rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction), as the plain version's separate PyTorch
// operations are; bf16 products are exact in fp32, so their sums use fma in
// the plain version's channel order. simr and wmax are then bitwise equal to
// ops/ref.py `sim_mlp_core`'s on the card.
//
// The TPU form is not carried over: its G = 128 // C lane packing, block
// diagonal weights, spread and segment matrices and the padding of M to 128
// are workarounds for 128-lane vector registers. Here a block takes 8 rows
// i of one cloud, a warp a row; the warp's 32 lanes walk the targets j =
// lane, lane + 32, ... < M (the ragged end masked by the loop bound, so no
// padded j enters the max or the stores), each lane carrying one pair's 32
// channels through the chain in registers and a running max of h1 per
// channel; at the end the warp reduces the 32 lanes' maxima with shuffles
// (max is exact in any order). The block stages W2, W3 and the vectors
// (10 KB) and the cloud's tp and target points (M x 36 floats, rows padded
// to 33 so that the lanes' reads hit 32 banks) in shared memory; the
// weights are read as 16-byte broadcasts. Nothing of the (B, M, M, 32)
// stack reaches device memory; simr is written once, coalesced over j.
//
// What bounds it on an H100: operations. At IDAM's protocol width (B 32,
// M 341) a call is 3.72 M pairs x ~4.4 K operations (two 32 x 32 products,
// the 3 x 32 direction product, BatchNorms, the 32-wide logit) = ~16.5
// GFLOP, against 15 MB of logits written and 3 MB read. This simple kernel
// runs the products on CUDA cores in fp32 (the order that makes it bitwise
// the plain version's), ~0.25 ms at the fp32 peak; on the tensor cores the
// bf16 products would take 0.02 ms. A later PR would move them there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = kC + 1;                  // padded tp row in shared memory
// packed parameters (floats): w0, wxyz (3 x C), W2 (C x C), b2, W3 (C x C),
// W4, mean1, inv1, gamma1, beta1, mean2, inv2, gamma2, beta2
constexpr int kW0 = 0, kWxyz = kC, kW2 = 4 * kC, kB2 = kW2 + kC * kC,
              kW3 = kB2 + kC, kW4 = kW3 + kC * kC, kBn = kW4 + kC,
              kParams = kBn + 8 * kC;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bn_relu(float h, const float* bn, int c) {
  const float hh = __fmul_rn(__fsub_rn(h, bn[c]), bn[kC + c]);
  const float y = __fadd_rn(__fmul_rn(hh, bn[2 * kC + c]), bn[3 * kC + c]);
  return y > 0.f ? y : 0.f;
}

// out[d] = sum_c x[c] * W[c, d] in channel order (bf16 x bf16 is exact, so
// the fma rounds as the plain version's add does); W row-major in shared.
__device__ __forceinline__ void matvec(const float (&x)[kC], const float* W,
                                       float (&out)[kC]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float4* row = reinterpret_cast<const float4*>(W + c * kC);
#pragma unroll
    for (int d4 = 0; d4 < kC / 4; ++d4) {
      const float4 w = row[d4];
      if (c == 0) {
        out[4 * d4] = __fmul_rn(x[0], w.x);
        out[4 * d4 + 1] = __fmul_rn(x[0], w.y);
        out[4 * d4 + 2] = __fmul_rn(x[0], w.z);
        out[4 * d4 + 3] = __fmul_rn(x[0], w.w);
      } else {
        out[4 * d4] = __fmaf_rn(x[c], w.x, out[4 * d4]);
        out[4 * d4 + 1] = __fmaf_rn(x[c], w.y, out[4 * d4 + 1]);
        out[4 * d4 + 2] = __fmaf_rn(x[c], w.z, out[4 * d4 + 2]);
        out[4 * d4 + 3] = __fmaf_rn(x[c], w.w, out[4 * d4 + 3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sim_mlp_kernel(const float* __restrict__ sp, const float* __restrict__ tp,
               const float* __restrict__ src, const float* __restrict__ tgt,
               const float* __restrict__ params, int m, float* __restrict__ simr,
               float* __restrict__ wmax) {
  extern __shared__ __align__(16) float smem[];
  float* prm = smem;                           // kParams
  float* sps = prm + kParams;                  // kWarps x C
  float* tps = sps + kWarps * kC;              // m x kRow
  float* tgs = tps + m * kRow;                 // m x 3
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kWarps;
  const long long cloud = static_cast<long long>(b) * m;

  for (int e = threadIdx.x; e < kParams; e += kThreads) {
    const bool rounded = (e >= kWxyz && e < kB2) || (e >= kW3 && e < kW4);
    prm[e] = rounded ? bf16r(params[e]) : params[e];
  }
  for (int e = threadIdx.x; e < kWarps * kC; e += kThreads) {
    const int i = i0 + e / kC;
    sps[e] = i < m ? sp[(cloud + i) * kC + e % kC] : 0.f;
  }
  for (int e = threadIdx.x; e < m * kC; e += kThreads)
    tps[(e / kC) * kRow + e % kC] = tp[cloud * kC + e];
  for (int e = threadIdx.x; e < m * 3; e += kThreads) tgs[e] = tgt[cloud * 3 + e];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = i0 + warp;
  if (i >= m) return;
  const float* spi = sps + warp * kC;
  const float sx = src[(cloud + i) * 3], sy = src[(cloud + i) * 3 + 1],
              sz = src[(cloud + i) * 3 + 2];
  const float* bn1 = prm + kBn;
  const float* bn2 = prm + kBn + 4 * kC;

  float wm[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) wm[c] = -CUDART_INF_F;

  for (int j = lane; j < m; j += 32) {
    const float dx = __fsub_rn(sx, tgs[3 * j]);
    const float dy = __fsub_rn(sy, tgs[3 * j + 1]);
    const float dz = __fsub_rn(sz, tgs[3 * j + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const float dist = __fsqrt_rn(d2);
    const float den = __fadd_rn(dist, 1e-8f);
    const float nx = bf16r(__fdiv_rn(dx, den));
    const float ny = bf16r(__fdiv_rn(dy, den));
    const float nz = bf16r(__fdiv_rn(dz, den));
    const float* tpj = tps + j * kRow;

    float x[kC], h[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float dot = __fmul_rn(nx, prm[kWxyz + c]);
      dot = __fmaf_rn(ny, prm[kWxyz + kC + c], dot);
      dot = __fmaf_rn(nz, prm[kWxyz + 2 * kC + c], dot);
      const float dproj = __fadd_rn(__fmul_rn(dist, prm[kW0 + c]), dot);
      const float h0 = __fadd_rn(__fadd_rn(spi[c], tpj[c]), dproj);
      x[c] = bf16r(bn_relu(h0, bn1, c));
    }
    matvec(x, prm + kW2, h);
#pragma unroll
    for (int d = 0; d < kC; ++d) {
      h[d] = __fadd_rn(h[d], prm[kB2 + d]);
      wm[d] = fmaxf(wm[d], h[d]);
      x[d] = bf16r(h[d]);
    }
    matvec(x, prm + kW3, h);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      const float p = __fmul_rn(bn_relu(h[e], bn2, e), prm[kW4 + e]);
      s = e == 0 ? p : __fadd_rn(s, p);
    }
    simr[(cloud + i) * m + j] = s;
  }

  float mine = -CUDART_INF_F;
#pragma unroll
  for (int d = 0; d < kC; ++d) {
    float v = wm[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == d) mine = v;
  }
  wmax[(cloud + i) * kC + lane] = mine;
}

}  // namespace

extern "C" {

// Shared memory a launch at M points needs, in bytes (the wrapper refuses an
// M whose need exceeds the 227 KB a block may opt in to).
int sim_mlp_smem_bytes(int m) {
  return static_cast<int>(sizeof(float)) * (kParams + kWarps * kC + m * (kRow + 3));
}

// sp, tp (B, M, 32), src, tgt (B, M, 3) fp32, params (2496,) fp32 packed as
// w0 (32), Wxyz (3, 32), W2 (32, 32), b2 (32), W3 (32, 32), W4 (32), then
// mean1, inv1, gamma1, beta1, mean2, inv2, gamma2, beta2 (32 each; weights in
// the flax (in, out) orientation, Wxyz, W2 and W3 rounded to bf16 here), all
// contiguous on the device -> simr (B, M, M) pre-bias logits and wmax
// (B, M, 32) fp32. Launches on `stream` without synchronising; returns
// cudaGetLastError(), or cudaErrorInvalidValue for B < 1 or M < 1.
int sim_mlp_forward(const float* sp, const float* tp, const float* src,
                    const float* tgt, const float* params, int batch, int m,
                    float* simr, float* wmax, void* stream) {
  if (batch < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sim_mlp_smem_bytes(m);
  const cudaError_t err = cudaFuncSetAttribute(
      sim_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kWarps - 1) / kWarps, batch);
  sim_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sp, tp, src, tgt, params, m, simr, wmax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
