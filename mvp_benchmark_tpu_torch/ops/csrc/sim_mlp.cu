// IDAM's similarity-matrix MLP for Hopper (sm_90a), eval and train, with a
// plain C interface for ctypes.
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
//
// Train mode (`sim_mlp_train` :3915: `_sim_mlp_forward` :3741 and
// `_sim_mlp_core_bwd` :3806) runs six passes, each recomputing the chain
// from sp, tp and the positions, each summing per-block partials that the
// wrapper adds in a fixed order (no float atomics: two runs are bitwise
// equal):
//
// - two stat passes (`_sm_stat_kernel` :3439): [sum h0, sum h0^2], then,
//   with BatchNorm 1 on those statistics, [sum h2, sum h2^2], in the final
//   pass's layout (a lane a pair, 64 accumulators a lane, reduced over the
//   lanes by shuffles and over the warps in order);
// - the final pass with the batch statistics, which also saves the first j
//   of each wmax (the TPU routes wmax's cotangent by h1 equality, :3432);
// - three backward passes as `_sm_bwd1/2/3_kernel` split the work (S2 needs
//   every pair before dh2 exists, S1 every pair before dh0): S2 = [sum dy2,
//   sum dy2 hhat2] and dW4; then S1, dW3, dW2, db2; then dsp, dtp, dw0 and
//   dWxyz. These run a warp a pair, a lane a channel: the products' inputs
//   come from the other lanes through a staged vector in shared memory read
//   as 16-byte broadcasts, and each lane owns a column of dW3 and dW2 (64
//   accumulators), so the outer products need no atomics. A block takes 16 rows i of a cloud, its warps
//   the columns j in turn: dsp of its rows is complete in the block (the
//   warps' shares added in order), dtp is one partial a block of rows
//   (`_sm_bwd3_kernel` adds it across row tiles with `+=` over a
//   sequential grid axis, :3588-3602, a race on a GPU).
//
// The rounding of the backward is ops/ref.py's (`sim_mlp_backward`): the
// cotangents of bf16(h1) and of x1 round to bf16, every other sum is fp32;
// the sums run in another order than the plain version's, so the two agree
// to a tolerance. The recomputed forward values equal the final pass's
// bitwise (the same operations in the same order).

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

// What a forward pass does: the eval or train final pass (simr, wmax and,
// in train, the first j of each wmax), or a stat pass (the sums of h0, or of
// h2 given BatchNorm 1's statistics).
enum Mode { kEval = 0, kTrainFinal = 1, kStat0 = 2, kStat1 = 3 };

template <int Mode>
__global__ void __launch_bounds__(kThreads, 1)
sim_mlp_kernel(const float* __restrict__ sp, const float* __restrict__ tp,
               const float* __restrict__ src, const float* __restrict__ tgt,
               const float* __restrict__ params, int m, float* __restrict__ simr,
               float* __restrict__ wmax, int* __restrict__ argj,
               float* __restrict__ part) {
  constexpr bool kStat = Mode == kStat0 || Mode == kStat1;
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
  if (!kStat && i >= m) return;
  const float* spi = sps + warp * kC;
  const float* bn1 = prm + kBn;
  const float* bn2 = prm + kBn + 4 * kC;

  float wm[kC];      // the final passes: running max; the stat passes: sum
  float wq[kC];      // the stat passes: sum of squares
  int wj[Mode == kTrainFinal ? kC : 1];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    wm[c] = kStat ? 0.f : -CUDART_INF_F;
    wq[c] = 0.f;
    if (Mode == kTrainFinal) wj[c] = 0;
  }
  const float sx = i < m ? src[(cloud + i) * 3] : 0.f;
  const float sy = i < m ? src[(cloud + i) * 3 + 1] : 0.f;
  const float sz = i < m ? src[(cloud + i) * 3 + 2] : 0.f;

  for (int j = lane; i < m && j < m; j += 32) {
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
      if (Mode == kStat0) {
        wm[c] = __fadd_rn(wm[c], h0);
        wq[c] = __fmaf_rn(h0, h0, wq[c]);
      }
      x[c] = bf16r(bn_relu(h0, bn1, c));
    }
    if (Mode == kStat0) continue;
    matvec(x, prm + kW2, h);
#pragma unroll
    for (int d = 0; d < kC; ++d) {
      h[d] = __fadd_rn(h[d], prm[kB2 + d]);
      if (Mode == kTrainFinal) {
        if (h[d] > wm[d]) {         // the first maximal j
          wm[d] = h[d];
          wj[d] = j;
        }
      } else if (Mode == kEval) {
        wm[d] = fmaxf(wm[d], h[d]);
      }
      x[d] = bf16r(h[d]);
    }
    matvec(x, prm + kW3, h);
    if (Mode == kStat1) {
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        wm[e] = __fadd_rn(wm[e], h[e]);
        wq[e] = __fmaf_rn(h[e], h[e], wq[e]);
      }
      continue;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      const float p = __fmul_rn(bn_relu(h[e], bn2, e), prm[kW4 + e]);
      s = e == 0 ? p : __fadd_rn(s, p);
    }
    simr[(cloud + i) * m + j] = s;
  }

  if (kStat) {
    // lanes by a butterfly, then warps in order: one partial a block
    __shared__ float red[kWarps][2][kC];
    float mine = 0.f, mine2 = 0.f;
#pragma unroll
    for (int d = 0; d < kC; ++d) {
      float v = wm[d], v2 = wq[d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        v2 = __fadd_rn(v2, __shfl_xor_sync(0xffffffffu, v2, off));
      }
      if (lane == d) {
        mine = v;
        mine2 = v2;
      }
    }
    red[warp][0][lane] = mine;
    red[warp][1][lane] = mine2;
    __syncthreads();
    if (threadIdx.x < 2 * kC) {
      const int which = threadIdx.x / kC, c = threadIdx.x % kC;
      float t = red[0][which][c];
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w][which][c]);
      const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
      part[(blk * 2 + which) * kC + c] = t;
    }
    return;
  }
  float mine = -CUDART_INF_F;
  int mine_j = 0;
#pragma unroll
  for (int d = 0; d < kC; ++d) {
    float v = wm[d];
    int vj = Mode == kTrainFinal ? wj[d] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      if (Mode == kTrainFinal) {
        // the larger value, a tie to the lower j: the same on every lane
        const int oj = __shfl_xor_sync(0xffffffffu, vj, off);
        if (o > v || (o == v && oj < vj)) {
          v = o;
          vj = oj;
        }
      } else {
        v = fmaxf(v, o);
      }
    }
    if (lane == d) {
      mine = v;
      mine_j = vj;
    }
  }
  wmax[(cloud + i) * kC + lane] = mine;
  if (Mode == kTrainFinal) argj[(cloud + i) * kC + lane] = mine_j;
}

// ---------------------------------------------------------------------------
// Backward passes: a warp a pair, a lane a channel
// ---------------------------------------------------------------------------

constexpr int kRows = 16;          // rows i a backward block takes
// after the forward parameters: scale2 = gamma2 inv2, m12 = S2_0 / E,
// m22 = S2_1 / E, scale1, m11, m21 (BatchNorm 1's, from S1)
constexpr int kS2 = kParams, kM12 = kS2 + kC, kM22 = kM12 + kC, kS1 = kM22 + kC,
              kM11 = kS1 + kC, kM21 = kM11 + kC;
constexpr int kPad = kC + 4;       // a weight row in shared memory: float4 reads, no conflicts

// out = sum_k v[k] * row[k] in k order (the first a product, then fused
// multiply-adds): v is the warp's staged vector (every lane reads the same
// address, a broadcast), row the lane's own row of a weight matrix, both
// read 16 bytes at a time from shared memory.
__device__ __forceinline__ float row_dot(const float* __restrict__ v,
                                         const float* __restrict__ row) {
  const float4* vv = reinterpret_cast<const float4*>(v);
  const float4* ww = reinterpret_cast<const float4*>(row);
  float4 a = vv[0], w = ww[0];
  float acc = __fmul_rn(a.x, w.x);
  acc = __fmaf_rn(a.y, w.y, acc);
  acc = __fmaf_rn(a.z, w.z, acc);
  acc = __fmaf_rn(a.w, w.w, acc);
#pragma unroll
  for (int k4 = 1; k4 < kC / 4; ++k4) {
    a = vv[k4];
    w = ww[k4];
    acc = __fmaf_rn(a.x, w.x, acc);
    acc = __fmaf_rn(a.y, w.y, acc);
    acc = __fmaf_rn(a.z, w.z, acc);
    acc = __fmaf_rn(a.w, w.w, acc);
  }
  return acc;
}

// acc[k] += v[k] * g for every k: a lane's column of an outer product summed
// over pairs, v the warp's staged vector.
__device__ __forceinline__ void outer_add(float (&acc)[kC], const float* __restrict__ v,
                                          float g) {
  const float4* vv = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int k4 = 0; k4 < kC / 4; ++k4) {
    const float4 a = vv[k4];
    acc[4 * k4] = __fmaf_rn(a.x, g, acc[4 * k4]);
    acc[4 * k4 + 1] = __fmaf_rn(a.y, g, acc[4 * k4 + 1]);
    acc[4 * k4 + 2] = __fmaf_rn(a.z, g, acc[4 * k4 + 2]);
    acc[4 * k4 + 3] = __fmaf_rn(a.w, g, acc[4 * k4 + 3]);
  }
}

// Pass 1 (S2, dW4), 2 (S1, dW3, dW2, db2) or 3 (dsp, dtp, dw0, dWxyz).
// part rows a block: pass 1: S2_0, S2_1, dW4; pass 2: dW3 (kC rows, row d
// column e), dW2 (kC rows, row c column d), S1_0, S1_1, db2; pass 3: dw0,
// dWxyz (3 rows). A warp takes a pair at a time, a lane a channel: the
// vector a product needs from every lane (x1, bf16(h1), dh2, dh1) is staged
// in the warp's 512 bytes of shared memory and read back as 16-byte
// broadcasts, each lane holding its row of the matrix (W2 or W3, as is or
// transposed, bf16) in a padded copy in shared memory.
template <int Pass>
__global__ void __launch_bounds__(kThreads)
sim_mlp_backward_kernel(const float* __restrict__ sp, const float* __restrict__ tp,
                        const float* __restrict__ src, const float* __restrict__ tgt,
                        const float* __restrict__ params, int m,
                        const float* __restrict__ dsimr, const float* __restrict__ dwmax,
                        const int* __restrict__ argj, float* __restrict__ part,
                        float* __restrict__ dsp, float* __restrict__ dtp_part) {
  constexpr int kPartRows = Pass == 1 ? 3 : Pass == 2 ? 2 * kC + 3 : 4;
  // lane c's rows: w2t[c][k] = W2[k][c] (h1), w3t[c][k] = W3[k][c] (h2),
  // w3r[c][k] = W3[c][k] (dh1), w2r[c][k] = W2[c][k] (dx1)
  __shared__ __align__(16) float w2t[kC][kPad], w3t[kC][kPad], w3r[kC][kPad],
      w2r[kC][kPad];
  __shared__ __align__(16) float stage[kWarps][4][kC];
  __shared__ float sps[kRows][kC], srs[kRows][3], dwm[kRows][kC];
  __shared__ int ajs[kRows][kC];
  // pass 3: each warp's share of dsp of the block's rows; passes 1-2: the
  // warps' accumulators added in order
  __shared__ float scratch[kWarps * kRows * kC];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const long long cloud = static_cast<long long>(b) * m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < kC * kC; e += kThreads) {
    const int r = e / kC, k = e % kC;              // W[r][k]
    const float w2 = bf16r(params[kW2 + e]), w3 = bf16r(params[kW3 + e]);
    w2t[k][r] = w2;
    w3t[k][r] = w3;
    w2r[r][k] = w2;
    w3r[r][k] = w3;
  }
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = e % kC, i = i0 + r;
    const bool live = i < m;
    sps[r][c] = live ? sp[(cloud + i) * kC + c] : 0.f;
    dwm[r][c] = live && Pass > 1 ? dwmax[(cloud + i) * kC + c] : 0.f;
    ajs[r][c] = live && Pass > 1 ? argj[(cloud + i) * kC + c] : -1;
  }
  for (int e = threadIdx.x; e < kRows * 3; e += kThreads) {
    const int i = i0 + e / 3;
    srs[e / 3][e % 3] = i < m ? src[(cloud + i) * 3 + e % 3] : 0.f;
  }
  for (int e = threadIdx.x; e < kWarps * kRows * kC; e += kThreads) scratch[e] = 0.f;
  __syncthreads();

  const int c = lane;
  const float w0 = params[kW0 + c], wx = bf16r(params[kWxyz + c]),
              wy = bf16r(params[kWxyz + kC + c]), wz = bf16r(params[kWxyz + 2 * kC + c]);
  const float* bn1 = params + kBn;
  const float* bn2 = params + kBn + 4 * kC;
  const float mu1 = bn1[c], inv1 = bn1[kC + c], g1 = bn1[2 * kC + c], be1 = bn1[3 * kC + c];
  const float mu2 = bn2[c], inv2 = bn2[kC + c], g2 = bn2[2 * kC + c], be2 = bn2[3 * kC + c];
  const float b2 = params[kB2 + c], w4 = params[kW4 + c];
  const float sc2 = params[kS2 + c], m12 = params[kM12 + c], m22 = params[kM22 + c];
  const float sc1 = params[kS1 + c], m11 = params[kM11 + c], m21 = params[kM21 + c];
  float* st_x1 = stage[warp][0];
  float* st_h1 = stage[warp][1];
  float* st_dh2 = stage[warp][2];
  float* st_dh1 = stage[warp][3];

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;   // per-channel sums
  float acc3[Pass == 2 ? kC : 1], acc2[Pass == 2 ? kC : 1];
#pragma unroll
  for (int d = 0; d < (Pass == 2 ? kC : 1); ++d) acc3[d] = acc2[d] = 0.f;

  for (int j = warp; j < m; j += kWarps) {
    const float tpj = tp[(cloud + j) * kC + c];
    const float tx = tgt[(cloud + j) * 3], ty = tgt[(cloud + j) * 3 + 1],
                tz = tgt[(cloud + j) * 3 + 2];
    float dtp = 0.f;
    for (int r = 0; r < kRows && i0 + r < m; ++r) {
      const int i = i0 + r;
      const float dx = __fsub_rn(srs[r][0], tx);
      const float dy = __fsub_rn(srs[r][1], ty);
      const float dz = __fsub_rn(srs[r][2], tz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float dist = __fsqrt_rn(d2);
      const float den = __fadd_rn(dist, 1e-8f);
      const float nx = bf16r(__fdiv_rn(dx, den));
      const float ny = bf16r(__fdiv_rn(dy, den));
      const float nz = bf16r(__fdiv_rn(dz, den));
      float dot = __fmul_rn(nx, wx);
      dot = __fmaf_rn(ny, wy, dot);
      dot = __fmaf_rn(nz, wz, dot);
      const float dproj = __fadd_rn(__fmul_rn(dist, w0), dot);
      const float h0 = __fadd_rn(__fadd_rn(sps[r][c], tpj), dproj);
      const float hhat1 = __fmul_rn(__fsub_rn(h0, mu1), inv1);
      const float y1 = __fadd_rn(__fmul_rn(hhat1, g1), be1);
      const float x1 = bf16r(y1 > 0.f ? y1 : 0.f);
      __syncwarp();                    // the previous pair's reads of the stage
      st_x1[c] = x1;
      __syncwarp();
      const float h1b = bf16r(__fadd_rn(row_dot(st_x1, w2t[c]), b2));
      st_h1[c] = h1b;
      __syncwarp();
      const float h2 = row_dot(st_h1, w3t[c]);
      const float hhat2 = __fmul_rn(__fsub_rn(h2, mu2), inv2);
      const float y2 = __fadd_rn(__fmul_rn(hhat2, g2), be2);
      const float x2 = y2 > 0.f ? y2 : 0.f;
      const float ds = dsimr[(cloud + i) * m + j];
      const float dy2 = y2 > 0.f ? __fmul_rn(ds, w4) : 0.f;
      if (Pass == 1) {
        a0 = __fadd_rn(a0, dy2);
        a1 = __fmaf_rn(dy2, hhat2, a1);
        a2 = __fmaf_rn(x2, ds, a2);
        continue;
      }
      const float dh2 = __fmul_rn(sc2, __fsub_rn(__fsub_rn(dy2, m12), __fmul_rn(hhat2, m22)));
      st_dh2[c] = dh2;
      __syncwarp();
      float dh1 = bf16r(row_dot(st_dh2, w3r[c]));
      if (ajs[r][c] == j) dh1 = __fadd_rn(dh1, dwm[r][c]);
      st_dh1[c] = dh1;
      __syncwarp();
      const float dx1 = bf16r(row_dot(st_dh1, w2r[c]));
      const float dy1 = y1 > 0.f ? dx1 : 0.f;
      if constexpr (Pass == 2) {
        a0 = __fadd_rn(a0, dy1);
        a1 = __fmaf_rn(dy1, hhat1, a1);
        a2 = __fadd_rn(a2, dh1);
        outer_add(acc3, st_h1, dh2);   // dW3[d][c] += bf16(h1)[d] dh2[c]
        outer_add(acc2, st_x1, dh1);   // dW2[d][c] += x1[d] dh1[c]
        continue;
      }
      const float dh0 = __fmul_rn(sc1, __fsub_rn(__fsub_rn(dy1, m11), __fmul_rn(hhat1, m21)));
      dtp = __fadd_rn(dtp, dh0);
      float* mine = scratch + (warp * kRows + r) * kC + c;
      *mine = __fadd_rn(*mine, dh0);
      a0 = __fmaf_rn(dist, dh0, a0);
      a1 = __fmaf_rn(nx, dh0, a1);
      a2 = __fmaf_rn(ny, dh0, a2);
      a3 = __fmaf_rn(nz, dh0, a3);
    }
    if (Pass == 3)
      dtp_part[((static_cast<long long>(blockIdx.x) * gridDim.y + b) * m + j) * kC + c] = dtp;
  }
  __syncthreads();

  const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  float* out = part + blk * kPartRows * kC;
  if (Pass == 3) {
    for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
      const int r = e / kC, cc = e % kC;
      if (i0 + r >= m) continue;
      float t = scratch[r * kC + cc];
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, scratch[(w * kRows + r) * kC + cc]);
      dsp[(cloud + i0 + r) * kC + cc] = t;
    }
    __syncthreads();
  }
  // the warps' per-lane sums, added in warp order
  constexpr int kVals = Pass == 2 ? 2 * kC + 3 : Pass == 1 ? 3 : 4;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        float x;
        if (Pass == 2) {
          x = v < kC ? acc3[v % kC] : v < 2 * kC ? acc2[v % kC] : v == 2 * kC ? a0
              : v == 2 * kC + 1 ? a1 : a2;
        } else {
          x = v == 0 ? a0 : v == 1 ? a1 : v == 2 ? a2 : a3;
        }
        float* cell = scratch + v * kC + c;
        *cell = w == 0 ? x : __fadd_rn(*cell, x);
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kPartRows * kC; e += kThreads) out[e] = scratch[e];
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
// contiguous on the device. mode 0 (eval) -> simr (B, M, M) pre-bias logits
// and wmax (B, M, 32) fp32; mode 1 (the train final pass) -> those and argj
// (B, M, 32) int32, the first j of each wmax; mode 2 / 3 (the stat passes)
// -> part (blocks, 2, 32) fp32, a block's [sum h0, sum h0^2] / [sum h2,
// sum h2^2] of every channel (blocks = ceil(M / 8) B; mode 3 reads the
// first BatchNorm's mean and inv, mode 2 no BatchNorm). Launches on `stream`
// without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for B < 1, M < 1 or another mode.
int sim_mlp_forward(int mode, const float* sp, const float* tp, const float* src,
                    const float* tgt, const float* params, int batch, int m,
                    float* simr, float* wmax, int* argj, float* part, void* stream) {
  if (batch < 1 || m < 1 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sim_mlp_smem_bytes(m);
  const dim3 grid((m + kWarps - 1) / kWarps, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(sp, tp, src, tgt, params, m, simr, wmax, argj,
                                         part);
    return static_cast<int>(cudaGetLastError());
  };
  if (mode == 0) return run(sim_mlp_kernel<kEval>);
  if (mode == 1) return run(sim_mlp_kernel<kTrainFinal>);
  if (mode == 2) return run(sim_mlp_kernel<kStat0>);
  return run(sim_mlp_kernel<kStat1>);
}

// The backward passes 1-3: the forward's inputs with params (2688,) = the
// forward's 2496 (the batch statistics' mean and inv), then scale2 = gamma2
// inv2, S2_0 / E, S2_1 / E, scale1, S1_0 / E, S1_1 / E (32 each; pass 1 reads
// none of these, pass 2 the first three); dsimr (B, M, M) fp32, the
// cotangent of simr; dwmax (B, M, 32) fp32 and argj (B, M, 32) int32 from the
// final pass (passes 2 and 3). -> part (blocks, rows, 32) fp32 with blocks =
// ceil(M / 16) B and rows 3 / 67 / 4 (see sim_mlp_backward_kernel); pass 3
// also dsp (B, M, 32) and dtp_part (ceil(M / 16), B, M, 32), the partial
// dtp of each block of rows.
int sim_mlp_backward(int pass, const float* sp, const float* tp, const float* src,
                     const float* tgt, const float* params, int batch, int m,
                     const float* dsimr, const float* dwmax, const int* argj, float* part,
                     float* dsp, float* dtp_part, void* stream) {
  if (batch < 1 || m < 1 || pass < 1 || pass > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kRows - 1) / kRows, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pass == 1)
    sim_mlp_backward_kernel<1><<<grid, kThreads, 0, st>>>(
        sp, tp, src, tgt, params, m, dsimr, dwmax, argj, part, dsp, dtp_part);
  else if (pass == 2)
    sim_mlp_backward_kernel<2><<<grid, kThreads, 0, st>>>(
        sp, tp, src, tgt, params, m, dsimr, dwmax, argj, part, dsp, dtp_part);
  else
    sim_mlp_backward_kernel<3><<<grid, kThreads, 0, st>>>(
        sp, tp, src, tgt, params, m, dsimr, dwmax, argj, part, dsp, dtp_part);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
