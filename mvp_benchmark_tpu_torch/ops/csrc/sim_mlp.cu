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
//   dWxyz. A block takes 16 rows i of a cloud and its 4 warps the columns j
//   in turn, a warp the 16 pairs of a column as the rows of mma.m16n8k16
//   tiles 32 channels wide. The four products of a pair (x1 W2, bf16(h1)
//   W3, dh2 W3^T, dh1 W2^T) run on the tensor cores with A in registers,
//   each accumulator packed to bf16 the next product's A; the fp32
//   cotangents dh2 and dh1 go in as three bf16 terms (hi + mid + lo carries
//   all 24 bits: ops/ref.py `split_bf16x3`), so their products are fp32's
//   to fp32 rounding. dW3 and dW2 sum over the pairs on the tensor cores
//   too, the pairs their depth (movmatrix transposes the packed tiles), each
//   tile's sum added to a warp's registers rounded to nearest. dsp of the
//   block's rows is complete in the block (the warps' shares added in
//   order), dtp is one partial a block of rows (`_sm_bwd3_kernel` adds it
//   across row tiles with `+=` over a sequential grid axis, :3588-3602, a
//   race on a GPU).
//
// The rounding of the backward is ops/ref.py's (`sim_mlp_backward`): the
// cotangents of bf16(h1) and of x1 round to bf16, every other sum is fp32.
// The tensor cores sum a product's terms in another order than the plain
// version's channel order; where that could change a discrete outcome (a
// bf16 rounding, relu's mask of BatchNorm 2, h2 at its batch mean) the
// element is summed again in channel order (see `kMargin16`), so the
// backward's recomputed forward and its bf16 cotangents equal the plain
// version's, and the outputs agree to summation order.
//
// What bounds the backward on an H100: operations, ~0.5 ms at the peaks
// for a call at (32, 341, C 32) (chip_smoke.py's count); the tensor cores
// take ~3 x 50 GFLOP of bf16 products a call, the elementwise work of the
// chain (geometry, two BatchNorms and their backwards, the splits and the
// guards) runs on the CUDA cores.

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
// Backward passes: tensor cores, 16 pairs a warp
// ---------------------------------------------------------------------------

constexpr int kRows = 16;          // rows i a backward block takes
constexpr int kBWarps = 4;
constexpr int kBThreads = 32 * kBWarps;
// after the forward parameters: scale2 = gamma2 inv2, m12 = S2_0 / E,
// m22 = S2_1 / E, scale1, m11, m21 (BatchNorm 1's, from S1)
constexpr int kS2 = kParams, kM12 = kS2 + kC, kM22 = kM12 + kC, kS1 = kM22 + kC,
              kM11 = kS1 + kC, kM21 = kM11 + kC;
// the per-channel vectors a backward block stages, a row of kC each
enum Col { cW0, cWx, cWy, cWz, cMu1, cInv1, cG1, cBe1, cB2, cMu2, cInv2, cG2, cBe2, cW4,
           cSc2, cM12, cM22, cSc1, cM11, cM21, kCols };

__host__ __device__ constexpr int col_src(int v) {
  return v == cW0 ? kW0 : v == cWx ? kWxyz : v == cWy ? kWxyz + kC : v == cWz ? kWxyz + 2 * kC
       : v == cB2 ? kB2 : v == cW4 ? kW4 : v <= cBe1 ? kBn + (v - cMu1) * kC
       : v <= cBe2 ? kBn + (4 + v - cMu2) * kC : kS2 + (v - cSc2) * kC;
}

constexpr int kVec = kC + 4;       // a staged fp32 row: 16-byte aligned, rows on other banks
constexpr int kStg = 20;           // a staged bf16 row, in 32-bit words

// A block's shared memory: the products' B fragments (W2, W3 for the
// forward, W3^T, W2^T for the backward, bf16 pairs in (kk, nt, lane)
// order); the same four matrices as bf16 rows for the sums taken again in
// channel order (wv[q][col]: the 32 inputs of output col); the per-channel
// vectors and the block's rows; each warp's tile rows (x1 and bf16(h1) as
// bf16, dh2 or dh1 as fp32) and its recomputed values, whose space the
// reductions take after the tiles.
struct BwdSmem {
  uint2 wf[4][2 * 4 * 32];
  uint32_t wv[4][kC][kStg];        // bf16 pairs, a row of 32 inputs an output
  float cp[kCols][kC];
  float sps[kRows][kC], dwm[kRows][kC];
  int ajs[kRows][kC];
  float srs[kRows][4];
  float colred[kBWarps][4][kC];
  union {
    struct {
      uint32_t stg[kBWarps][2][16 * kStg];
      float vec[kBWarps][16 * kVec];
      float fix[kBWarps][32 * 16];
    } tile;
    float red[2 * kC * kC];        // after the tiles: the warps' sums added in order
  } u;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 matrix whose row g lane 4 g + t holds (columns 2 t, 2 t + 1)
// transposed, in the same distribution.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// A warp's 16 x 32 tile: v[nt][x] is row g + 8 (x >> 1), column 8 nt + 2 t +
// (x & 1), as an mma.m16n8 accumulator holds it; packed[nt][r] its bf16
// pairs of row g + 8 r, which are also the A fragments of the next product
// (k-step kk: packed[2 kk][0], [2 kk][1], [2 kk + 1][0], [2 kk + 1][1]).
typedef float Tile[4][4];
typedef uint32_t Packed[4][2];

__device__ __forceinline__ int tile_col(int nt, int x, int t) { return 8 * nt + 2 * t + (x & 1); }

__device__ __forceinline__ void zero(Tile& v) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) v[nt][0] = v[nt][1] = v[nt][2] = v[nt][3] = 0.f;
}

__device__ __forceinline__ void pack(const Tile& v, Packed& p) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    p[nt][0] = pack_bf16(v[nt][0], v[nt][1]);
    p[nt][1] = pack_bf16(v[nt][2], v[nt][3]);
  }
}

__device__ __forceinline__ void abs_packed(const Packed& p, Packed& q) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    q[nt][0] = p[nt][0] & 0x7fff7fffu;
    q[nt][1] = p[nt][1] & 0x7fff7fffu;
  }
}

// v = hi + mid + lo, each a bf16 of 8 significant bits: the three carry all
// 24 of an fp32 (ops/ref.py `split_bf16x3`), so a product with a bf16
// operand, three bf16 products summed in fp32, is the fp32 product to fp32
// rounding.
__device__ __forceinline__ void split3(const Tile& v, Packed (&p)[3]) {
  Tile hi, mid, lo;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      hi[nt][x] = bf16r(v[nt][x]);
      const float r = __fsub_rn(v[nt][x], hi[nt][x]);
      mid[nt][x] = bf16r(r);
      lo[nt][x] = __fsub_rn(r, mid[nt][x]);
    }
  }
  pack(hi, p[0]);
  pack(mid, p[1]);
  pack(lo, p[2]);
}

// acc += A . B over K = 32: A the packed tile, B the staged fragments of a
// 32 x 32 bf16 matrix; kAbs: |B| (A given as |A|).
template <bool kAbs = false>
__device__ __forceinline__ void product(Tile& acc, const Packed& a,
                                        const uint2* __restrict__ wf, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint2 b = wf[(kk * 4 + nt) * 32 + lane];
      if (kAbs) {
        b.x &= 0x7fff7fffu;
        b.y &= 0x7fff7fffu;
      }
      mma_bf16(acc[nt], a[2 * kk][0], a[2 * kk][1], a[2 * kk + 1][0], a[2 * kk + 1][1],
               b.x, b.y);
    }
  }
}

__device__ __forceinline__ void transpose(const Packed& p, Packed& q) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    q[nt][0] = transpose8x8(p[nt][0]);
    q[nt][1] = transpose8x8(p[nt][1]);
  }
}

// acc (32 x 32: row 16 mt + g (+ 8), column 8 nt + 2 t (+ 1)) += X^T Y over
// the tile's 16 pairs, xt = transpose(X), y[s] the three bf16 terms of Y:
// the pairs are the product's depth. The tile's sum is formed from zero on
// the tensor cores and added to acc on the CUDA cores, rounded to nearest:
// a warp's sums over its ~40 columns kept in the accumulator drifted from
// the plain version's (dW3 6.9e-4 normwise on an H100, against 4.2e-5).
__device__ __forceinline__ void outer(float (&acc)[2][4][4], const Packed& xt,
                                      const Packed (&y)[3]) {
  float tile[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero(tile[mt]);
#pragma unroll
  for (int s = 2; s >= 0; --s) {
    Packed yt;
    transpose(y[s], yt);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(tile[mt][nt], xt[2 * mt][0], xt[2 * mt + 1][0], xt[2 * mt][1],
                 xt[2 * mt + 1][1], yt[nt][0], yt[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][nt][x] = __fadd_rn(acc[mt][nt][x], tile[mt][nt][x]);
}

// The plain version sums each product's 32 terms in channel order in fp32
// (sequential fused multiply-adds: its own loop for the forward, cuBLAS's
// for the backward's two products), the tensor cores in another order;
// each stays within a few fp32 ulps of the sum of the terms' magnitudes
// from the exact sum, so the two differ by well under the margins below
// (2^-21 of that sum for bf16 operands, 2^-20 for three-way split fp32
// ones, which take more accumulation steps). Where the gap could change
// what the backward uses discretely -- a bf16 rounding of h1, dh1's
// product or dx1, relu's mask of BatchNorm 2, or h2 at the batch mean
// (hhat2 then exactly 0) -- the element is summed again in channel order,
// so those values equal the plain version's.
constexpr float kMargin16 = 1.0f / 2097152.0f;  // 2^-21: bf16 x bf16 terms
constexpr float kMargin32 = 1.0f / 1048576.0f;  // 2^-20: three-way split fp32 x bf16

// sum_c x[c] w[c] in channel order: x a staged row (bf16 words or fp32),
// w a staged bf16 row, both 16-byte aligned in shared memory
template <bool kBf16>
__device__ __forceinline__ float seq_dot(const void* xrow, const uint32_t* w) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const uint2 wv = reinterpret_cast<const uint2*>(w)[q];
    const float4 wq = make_float4(__uint_as_float(wv.x << 16), __uint_as_float(wv.x & 0xffff0000u),
                                  __uint_as_float(wv.y << 16), __uint_as_float(wv.y & 0xffff0000u));
    float xq[4];
    if (kBf16) {
      const uint2 v = reinterpret_cast<const uint2*>(xrow)[q];
      xq[0] = __uint_as_float(v.x << 16);
      xq[1] = __uint_as_float(v.x & 0xffff0000u);
      xq[2] = __uint_as_float(v.y << 16);
      xq[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
      const float4 v = reinterpret_cast<const float4*>(xrow)[q];
      xq[0] = v.x;
      xq[1] = v.y;
      xq[2] = v.z;
      xq[3] = v.w;
    }
    s = q == 0 ? __fmul_rn(xq[0], wq.x) : __fmaf_rn(xq[0], wq.x, s);
    s = __fmaf_rn(xq[1], wq.y, s);
    s = __fmaf_rn(xq[2], wq.z, s);
    s = __fmaf_rn(xq[3], wq.w, s);
  }
  return s;
}

// The flagged elements of a thread's tile (bit 4 nt + x of flags) summed
// again in channel order: row g + 8 (x >> 1) of the warp's staged rows
// against wv's row of column 8 nt + 2 t + (x & 1). The warp takes them
// together, each lane one of its own at a time.
template <bool kBf16>
__device__ __forceinline__ void resum(Tile& v, uint32_t flags, const void* rows, int row_words,
                                      const uint32_t (*wv)[kStg], float* fix, int lane, int g,
                                      int t) {
  if (!__any_sync(0xffffffffu, flags != 0u)) return;
  for (uint32_t f = flags; __any_sync(0xffffffffu, f != 0u);) {
    if (f != 0u) {
      const int i = __ffs(f) - 1;
      f &= f - 1;
      const int row = g + 8 * ((i & 3) >> 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
      fix[lane * 16 + i] = seq_dot<kBf16>(
          reinterpret_cast<const uint32_t*>(rows) + row * row_words, wv[col]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if ((flags >> (4 * nt + x)) & 1u) v[nt][x] = fix[lane * 16 + 4 * nt + x];
}

// Whether bf16(v) may differ for a value within m of v.
__device__ __forceinline__ bool bf16_unsure(float v, float m) {
  return bf16r(__fsub_rn(v, m)) != bf16r(__fadd_rn(v, m));
}

// a warp's packed tile, or its fp32 tile, into its staged rows (row g + 8 r,
// channels in order)
__device__ __forceinline__ void stage_rows(const Packed& p, uint32_t* rows, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    rows[g * kStg + nt * 4 + t] = p[nt][0];
    rows[(g + 8) * kStg + nt * 4 + t] = p[nt][1];
  }
}
__device__ __forceinline__ void stage_rows(const Tile& v, float* rows, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(rows + g * kVec + tile_col(nt, 0, t)) =
        make_float2(v[nt][0], v[nt][1]);
    *reinterpret_cast<float2*>(rows + (g + 8) * kVec + tile_col(nt, 0, t)) =
        make_float2(v[nt][2], v[nt][3]);
  }
}

// A tile's product of an fp32 tile with W^T (mat 2: W3, 3: W2) on the tensor
// cores, its three bf16 terms and their sum's bound; bf16 of it where
// certain, else of its channel-order sum.
__device__ __forceinline__ void backward_product(Tile& out, const Tile& v, Packed (&p)[3],
                                                 const BwdSmem& sm, int mat, float* vrows,
                                                 float* fix, int lane, int g, int t) {
  split3(v, p);
  Tile bnd;
  Packed pa;
  zero(out);
  zero(bnd);
#pragma unroll
  for (int s = 2; s >= 0; --s) product(out, p[s], sm.wf[mat], lane);
  abs_packed(p[0], pa);
  product<true>(bnd, pa, sm.wf[mat], lane);
  uint32_t flags = 0u;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      // |hi| within 2^-8 of |v|: the bound over the three terms
      const float m = __fmul_rn(bnd[nt][x], kMargin32 * 1.0078125f);
      if (bf16_unsure(out[nt][x], m)) flags |= 1u << (4 * nt + x);
    }
  }
  if (__any_sync(0xffffffffu, flags != 0u)) {
    stage_rows(v, vrows, g, t);
    __syncwarp();
    resum<false>(out, flags, vrows, kVec, sm.wv[mat], fix, lane, g, t);
    __syncwarp();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) out[nt][x] = bf16r(out[nt][x]);
}

// Pass 1 (S2, dW4), 2 (S1, dW3, dW2, db2) or 3 (dsp, dtp, dw0, dWxyz).
// part rows a block: pass 1: S2_0, S2_1, dW4; pass 2: dW3 (kC rows, row d
// column e), dW2 (kC rows, row c column d), S1_0, S1_1, db2; pass 3: dw0,
// dWxyz (3 rows). A block takes 16 rows i of a cloud; its warps take the
// columns j in turn, a warp the 16 pairs (i, j) of a column as the rows of
// mma.m16n8k16 tiles, 32 channels wide. The four 32 x 32 products of a
// pair (x1 W2, bf16(h1) W3, dh2 W3^T, dh1 W2^T) run with A from registers
// (each tile's accumulator packed to bf16 is the next product's A
// fragments) and B from the block's staged fragments; the fp32 cotangents
// dh2 and dh1 split in three bf16 terms first. dW3 and dW2 sum over the
// pairs on the tensor cores too, with the pairs as the depth: movmatrix
// transposes the packed tiles into the A and B fragments.
template <int Pass>
__global__ void __launch_bounds__(kBThreads, Pass == 2 ? 2 : 3)
sim_mlp_backward_kernel(const float* __restrict__ sp, const float* __restrict__ tp,
                        const float* __restrict__ src, const float* __restrict__ tgt,
                        const float* __restrict__ params, int m,
                        const float* __restrict__ dsimr, const float* __restrict__ dwmax,
                        const int* __restrict__ argj, float* __restrict__ part,
                        float* __restrict__ dsp, float* __restrict__ dtp_part) {
  constexpr int kPartRows = Pass == 1 ? 3 : Pass == 2 ? 2 * kC + 3 : 4;
  constexpr int kVals = Pass == 3 ? 4 : 3;       // column sums a thread carries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const long long cloud = static_cast<long long>(b) * m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the four matrices, bf16: q 0 W2, 1 W3 (B[k][n] = W[k][n]), 2 W3^T,
  // 3 W2^T (B[k][n] = W[n][k]); fragments, and wv[q][n][k] = B[k][n]
  for (int e = threadIdx.x; e < 4 * 256; e += kBThreads) {
    const int q = e >> 8, rest = e & 255;
    const int kk = rest >> 7, nt = (rest >> 5) & 3, ln = rest & 31;
    const float* W = params + (q == 0 || q == 3 ? kW2 : kW3);
    const int k0 = 16 * kk + 2 * (ln & 3), n = 8 * nt + (ln >> 2);
    auto at = [&](int k) { return bf16r(q >= 2 ? W[n * kC + k] : W[k * kC + n]); };
    sm.wf[q][rest] = make_uint2(pack_bf16(at(k0), at(k0 + 1)), pack_bf16(at(k0 + 8), at(k0 + 9)));
  }
  for (int e = threadIdx.x; e < 4 * kC * kC / 2; e += kBThreads) {
    const int q = e / (kC * kC / 2), n = (e / (kC / 2)) % kC, k = 2 * (e % (kC / 2));
    const float* W = params + (q == 0 || q == 3 ? kW2 : kW3);
    auto at = [&](int kk) { return q >= 2 ? W[n * kC + kk] : W[kk * kC + n]; };
    sm.wv[q][n][k / 2] = pack_bf16(at(k), at(k + 1));
  }
  for (int e = threadIdx.x; e < kCols * kC; e += kBThreads) {
    const int v = e / kC, c = e % kC;
    const float x = params[col_src(v) + c];
    sm.cp[v][c] = v >= cWx && v <= cWz ? bf16r(x) : x;
  }
  for (int e = threadIdx.x; e < kRows * kC; e += kBThreads) {
    const int r = e / kC, c = e % kC, i = i0 + r;
    const bool live = i < m;
    sm.sps[r][c] = live ? sp[(cloud + i) * kC + c] : 0.f;
    sm.dwm[r][c] = live && Pass > 1 ? dwmax[(cloud + i) * kC + c] : 0.f;
    sm.ajs[r][c] = live && Pass > 1 ? argj[(cloud + i) * kC + c] : -1;
  }
  for (int e = threadIdx.x; e < kRows * 3; e += kBThreads) {
    const int i = i0 + e / 3;
    sm.srs[e / 3][e % 3] = i < m ? src[(cloud + i) * 3 + e % 3] : 0.f;
  }
  __syncthreads();

  const float (*cp)[kC] = sm.cp;
  uint32_t* stg_x1 = sm.u.tile.stg[warp][0];
  uint32_t* stg_h1 = sm.u.tile.stg[warp][1];
  float* fix = sm.u.tile.fix[warp];
  const bool ok[2] = {i0 + g < m, i0 + g + 8 < m};
  float cs[kVals][4][2];                         // column sums of the thread's two rows
#pragma unroll
  for (int v = 0; v < kVals; ++v)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) cs[v][nt][0] = cs[v][nt][1] = 0.f;
  float dw3[Pass == 2 ? 2 : 1][4][4], dw2[Pass == 2 ? 2 : 1][4][4];
  Tile dsp_rows;
  if constexpr (Pass == 2) {
    zero(dw3[0]);
    zero(dw3[1]);
    zero(dw2[0]);
    zero(dw2[1]);
  }
  if constexpr (Pass == 3) zero(dsp_rows);

  for (int j = warp; j < m; j += kBWarps) {
    const float tx = tgt[(cloud + j) * 3], ty = tgt[(cloud + j) * 3 + 1],
                tz = tgt[(cloud + j) * 3 + 2];
    float dist[2], nx[2], ny[2], nz[2], ds[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* s = sm.srs[g + 8 * r];
      const float dx = __fsub_rn(s[0], tx), dy = __fsub_rn(s[1], ty), dz = __fsub_rn(s[2], tz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      dist[r] = __fsqrt_rn(d2);
      const float den = __fadd_rn(dist[r], 1e-8f);
      nx[r] = bf16r(__fdiv_rn(dx, den));
      ny[r] = bf16r(__fdiv_rn(dy, den));
      nz[r] = bf16r(__fdiv_rn(dz, den));
      ds[r] = ok[r] ? dsimr[(cloud + i0 + g + 8 * r) * m + j] : 0.f;
    }
    // the forward chain, each operation outside the products as the final
    // pass rounds it
    Tile hh1, y1;
    Packed px;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 tpj =
          *reinterpret_cast<const float2*>(tp + (cloud + j) * kC + tile_col(nt, 0, t));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x >> 1, c = tile_col(nt, x, t);
        float dot = __fmul_rn(nx[r], cp[cWx][c]);
        dot = __fmaf_rn(ny[r], cp[cWy][c], dot);
        dot = __fmaf_rn(nz[r], cp[cWz][c], dot);
        const float dproj = __fadd_rn(__fmul_rn(dist[r], cp[cW0][c]), dot);
        const float h0 = __fadd_rn(__fadd_rn(sm.sps[g + 8 * r][c], (x & 1) ? tpj.y : tpj.x), dproj);
        hh1[nt][x] = __fmul_rn(__fsub_rn(h0, cp[cMu1][c]), cp[cInv1][c]);
        y1[nt][x] = __fadd_rn(__fmul_rn(hh1[nt][x], cp[cG1][c]), cp[cBe1][c]);
      }
      px[nt][0] = pack_bf16(y1[nt][0] > 0.f ? y1[nt][0] : 0.f, y1[nt][1] > 0.f ? y1[nt][1] : 0.f);
      px[nt][1] = pack_bf16(y1[nt][2] > 0.f ? y1[nt][2] : 0.f, y1[nt][3] > 0.f ? y1[nt][3] : 0.f);
    }
    stage_rows(px, stg_x1, g, t);
    Tile acc, bnd;
    zero(acc);
    zero(bnd);
    product(acc, px, sm.wf[0], lane);           // x1 . W2
    product<true>(bnd, px, sm.wf[0], lane);     // x1 >= 0: |x1| . |W2|
    uint32_t flags = 0u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float b2 = cp[cB2][tile_col(nt, x, t)];
        const float h = __fadd_rn(acc[nt][x], b2);
        if (bf16_unsure(h, __fmul_rn(__fadd_rn(bnd[nt][x], fabsf(b2)), kMargin16))) {
          flags |= 1u << (4 * nt + x);
        }
        acc[nt][x] = h;
      }
    }
    __syncwarp();
    if (__any_sync(0xffffffffu, flags != 0u)) {
      resum<true>(acc, flags, stg_x1, kStg, sm.wv[0], fix, lane, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if ((flags >> (4 * nt + x)) & 1u) {
            acc[nt][x] = __fadd_rn(acc[nt][x], cp[cB2][tile_col(nt, x, t)]);
          }
    }
    Packed ph, pa;                               // bf16(h1), |bf16(h1)|
    pack(acc, ph);
    abs_packed(ph, pa);
    stage_rows(ph, stg_h1, g, t);
    zero(acc);
    zero(bnd);
    product(acc, ph, sm.wf[1], lane);           // h2 = bf16(h1) . W3
    product<true>(bnd, pa, sm.wf[1], lane);
    flags = 0u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = tile_col(nt, x, t);
        const float mu2 = cp[cMu2][c], inv2 = cp[cInv2][c], g2 = cp[cG2][c], be2 = cp[cBe2][c];
        auto bn2 = [&](float h) {
          return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h, mu2), inv2), g2), be2);
        };
        const float h2 = acc[nt][x], mg = __fmul_rn(bnd[nt][x], kMargin16);
        if ((bn2(__fsub_rn(h2, mg)) > 0.f) != (bn2(__fadd_rn(h2, mg)) > 0.f) ||
            fabsf(__fsub_rn(h2, mu2)) <= mg) {
          flags |= 1u << (4 * nt + x);
        }
      }
    }
    __syncwarp();
    resum<true>(acc, flags, stg_h1, kStg, sm.wv[1], fix, lane, g, t);
    Tile dh;                                     // dh2
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x >> 1, e = x & 1, c = tile_col(nt, x, t);
        const float hh2 = __fmul_rn(__fsub_rn(acc[nt][x], cp[cMu2][c]), cp[cInv2][c]);
        const float y2 = __fadd_rn(__fmul_rn(hh2, cp[cG2][c]), cp[cBe2][c]);
        const float dy2 = y2 > 0.f ? __fmul_rn(ds[r], cp[cW4][c]) : 0.f;
        if constexpr (Pass == 1) {
          cs[0][nt][e] = __fadd_rn(cs[0][nt][e], dy2);
          cs[1][nt][e] = __fmaf_rn(dy2, hh2, cs[1][nt][e]);
          cs[2][nt][e] = __fmaf_rn(y2 > 0.f ? y2 : 0.f, ds[r], cs[2][nt][e]);
        } else {
          dh[nt][x] = ok[r] ? __fmul_rn(cp[cSc2][c], __fsub_rn(__fsub_rn(dy2, cp[cM12][c]),
                                                               __fmul_rn(hh2, cp[cM22][c])))
                            : 0.f;
        }
      }
    }
    if constexpr (Pass > 1) {
      // dh1 = bf16(dh2 W3^T) + the wmax cotangent at its saved j (0 on rows
      // past the end, whose dh2 is 0 and argj -1)
      Packed pd[3];
      backward_product(acc, dh, pd, sm, 2, sm.u.tile.vec[warp], fix, lane, g, t);
      if constexpr (Pass == 2) {
        Packed xt;
        transpose(ph, xt);
        outer(dw3, xt, pd);                     // dW3 += bf16(h1)^T dh2
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = g + 8 * (x >> 1), c = tile_col(nt, x, t);
          dh[nt][x] = sm.ajs[r][c] == j ? __fadd_rn(acc[nt][x], sm.dwm[r][c]) : acc[nt][x];
        }
      }
      Packed pe[3];
      backward_product(acc, dh, pe, sm, 3, sm.u.tile.vec[warp], fix, lane, g, t);   // dx1
      if constexpr (Pass == 2) {
        Packed xt;
        transpose(px, xt);
        outer(dw2, xt, pe);                     // dW2 += x1^T dh1
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float dtp[2] = {0.f, 0.f};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1, e = x & 1, c = tile_col(nt, x, t);
          const float dy1 = y1[nt][x] > 0.f ? acc[nt][x] : 0.f;
          if constexpr (Pass == 2) {
            cs[0][nt][e] = __fadd_rn(cs[0][nt][e], dy1);
            cs[1][nt][e] = __fmaf_rn(dy1, hh1[nt][x], cs[1][nt][e]);
            cs[2][nt][e] = __fadd_rn(cs[2][nt][e], dh[nt][x]);
          } else {
            const float dh0 =
                ok[r] ? __fmul_rn(cp[cSc1][c], __fsub_rn(__fsub_rn(dy1, cp[cM11][c]),
                                                         __fmul_rn(hh1[nt][x], cp[cM21][c])))
                      : 0.f;
            dsp_rows[nt][x] = __fadd_rn(dsp_rows[nt][x], dh0);
            dtp[e] = __fadd_rn(dtp[e], dh0);
            cs[0][nt][e] = __fmaf_rn(dist[r], dh0, cs[0][nt][e]);
            cs[1][nt][e] = __fmaf_rn(nx[r], dh0, cs[1][nt][e]);
            cs[2][nt][e] = __fmaf_rn(ny[r], dh0, cs[2][nt][e]);
            cs[3][nt][e] = __fmaf_rn(nz[r], dh0, cs[3][nt][e]);
          }
        }
        if constexpr (Pass == 3) {
          // dtp of column j over the block's rows: the 8 row pairs by a butterfly
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            dtp[0] = __fadd_rn(dtp[0], __shfl_xor_sync(0xffffffffu, dtp[0], off));
            dtp[1] = __fadd_rn(dtp[1], __shfl_xor_sync(0xffffffffu, dtp[1], off));
          }
          if (g == 0) {
            *reinterpret_cast<float2*>(
                dtp_part + ((static_cast<long long>(blockIdx.x) * gridDim.y + b) * m + j) * kC +
                tile_col(nt, 0, t)) = make_float2(dtp[0], dtp[1]);
          }
        }
      }
    }
    __syncwarp();                      // the staged rows read before the next tile's
  }

  // the column sums over the 8 row pairs by a butterfly, then the warps in order
#pragma unroll
  for (int v = 0; v < kVals; ++v) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = cs[v][nt][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
        if (g == 0) sm.colred[warp][v][tile_col(nt, e, t)] = x;
      }
    }
  }
  const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  float* out = part + blk * kPartRows * kC;
  float* red = sm.u.red;
  __syncthreads();                     // every warp done with its tiles' space
  // the warps' register tiles (dW3 and dW2; dsp of the rows) added in warp order
  for (int w = 0; w < kBWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = g + 8 * (x >> 1), col = tile_col(nt, x, t);
          if constexpr (Pass == 2) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float* c3 = red + (16 * mt + row) * kC + col;
              float* c2 = red + kC * kC + (16 * mt + row) * kC + col;
              *c3 = w == 0 ? dw3[mt][nt][x] : __fadd_rn(*c3, dw3[mt][nt][x]);
              *c2 = w == 0 ? dw2[mt][nt][x] : __fadd_rn(*c2, dw2[mt][nt][x]);
            }
          } else if constexpr (Pass == 3) {
            float* c0 = red + row * kC + col;
            *c0 = w == 0 ? dsp_rows[nt][x] : __fadd_rn(*c0, dsp_rows[nt][x]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kVals * kC; e += kBThreads) {
    const int v = e / kC, c = e % kC;
    float s = sm.colred[0][v][c];
    for (int w = 1; w < kBWarps; ++w) s = __fadd_rn(s, sm.colred[w][v][c]);
    out[(Pass == 2 ? 2 * kC : 0) * kC + e] = s;
  }
  if constexpr (Pass == 2) {
    for (int e = threadIdx.x; e < 2 * kC * kC; e += kBThreads) out[e] = red[e];
  }
  if constexpr (Pass == 3) {
    for (int e = threadIdx.x; e < kRows * kC; e += kBThreads) {
      const int r = e / kC;
      if (i0 + r < m) dsp[(cloud + i0 + r) * kC + e % kC] = red[e];
    }
  }
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

// Dynamic shared memory a backward block takes, in bytes.
int sim_mlp_backward_smem() { return static_cast<int>(sizeof(BwdSmem)); }

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
  auto run = [&](auto kernel) {
    const int smem = static_cast<int>(sizeof(BwdSmem));
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kBThreads, smem, st>>>(sp, tp, src, tgt, params, m, dsimr, dwmax, argj,
                                          part, dsp, dtp_part);
    return static_cast<int>(cudaGetLastError());
  };
  if (pass == 1) return run(sim_mlp_backward_kernel<1>);
  if (pass == 2) return run(sim_mlp_backward_kernel<2>);
  return run(sim_mlp_backward_kernel<3>);
}

}  // extern "C"
