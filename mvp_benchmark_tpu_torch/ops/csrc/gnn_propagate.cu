// IDAM's fused Propagate edge block for Hopper (sm_90a), eval and train,
// with a plain C interface for ctypes.
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
//
// Train mode (`gnn_propagate_train` :4397 and its backward :4420) adds four
// kernels, each summing per-block partials that the wrapper adds in a fixed
// order (no float atomics: two runs are bitwise equal):
//
// - gnn_propagate_stat_kernel: [sum e, sum e^2] of every channel over the
//   B N k edges, each edge built as above and never stored (on the TPU the
//   (B, k, N, C) bf16 edge tensor, 100 MB at the protocol width, is written
//   and reduced by XLA, :4163-4166). The wrapper turns the sums into the
//   batch mean and biased variance.
// - the final pass above with those statistics, which also saves the first
//   neighbour slot s of each output's max (a byte a channel): the max routes
//   its cotangent there (the TPU kernel recomputes h and compares, :4072).
// - gnn_propagate_backward1_kernel (`_ge_bwd1_kernel` :4057): per point, the
//   routed cotangent dh (nonzero at one slot a channel), db = sum dh, dW =
//   sum x1^T dh, dx1 = bf16(dh W^T) (scattered into the slot's row of a
//   shared tile, so a point costs C^2 and not k C^2 multiply-adds), dy = dx1
//   where BatchNorm's output > 0, and S = [sum dy, sum dy hhat].
// - gnn_propagate_backward2_kernel: da = bf16(gamma inv (dy - S0/E - hhat
//   S1/E)) of every edge, written once as bf16 (B, N, k, C) (50 MB at the
//   protocol width; JAX's autodiff rounds this cotangent to bf16 through the
//   stored bf16 edge, so the store loses nothing), then
//   gnn_propagate_scatter_kernel (`_gp_bwd2_kernel` :4324): d_p[j] =
//   bf16(sum of da over the edges whose neighbour is j, in edge order, from
//   a reverse list, reverse_list.cu) - sum over s of da at j as the centre.
//   A gather by reverse list sums each point's incoming edges in a fixed
//   order without atomics; recomputing da per incoming edge would repeat
//   the C^2 dx1 product for every one of the k edges.
//
// The rounding of the backward is ops/ref.py's (`gnn_propagate_backward`):
// dx1, da and the scatter sum round to bf16, every other sum is fp32; the
// sums run in another order than the plain version's, so the two agree to a
// tolerance.

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
                     int n, int k, long long points, float* __restrict__ out,
                     unsigned char* __restrict__ slot) {
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
    int arg[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      best[r] = -CUDART_INF_F;
      arg[r] = 0;
    }
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
        // a NaN (an index out of range) stays NaN, as torch.amax keeps it;
        // a tie keeps the first slot
        if (h > best[r] || h != h) {
          best[r] = h;
          arg[r] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const long long pt = t0 + q + kLanes * r;
      if (pt < points) {
        out[pt * C + d] = best[r];
        if (slot != nullptr) slot[pt * C + d] = static_cast<unsigned char>(arg[r]);
      }
    }
  }
}

template <int C>
int launch(const float* p, const int* idx, const float* w, const float* bias,
           const float* mean, const float* inv, const float* gamma, const float* beta,
           int batch, int n, int k, float* out, unsigned char* slot,
           cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n;
  const long long tiles = (points + kTile - 1) / kTile;
  const int grid = static_cast<int>(tiles < (1LL << 30) ? tiles : (1LL << 30));
  gnn_propagate_kernel<C><<<grid, kThreads, 0, stream>>>(
      p, idx, w, bias, mean, inv, gamma, beta, n, k, points, out, slot);
  return static_cast<int>(cudaGetLastError());
}


// The edge e = bf16(bf16(p[b, j]) - p[pt]) of point pt and its neighbour j
// in channel c, as the final pass builds it (NaN for j outside [0, n)).
__device__ __forceinline__ float edge_value(const float* __restrict__ p, long long pt,
                                            long long b, int n, int j, int c, int C) {
  if (j < 0 || j >= n) return CUDART_NAN_F;
  const float nb = bf16r(p[(b * n + j) * C + c]);
  return bf16r(__fsub_rn(nb, p[pt * C + c]));
}

// Sums [e, e^2] of every channel over the edges of the points a block takes
// (kLanes points at a time, a thread a channel), one partial a block:
// part[block][0][c], part[block][1][c].
template <int C>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_stat_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                          int n, int k, long long points, float* __restrict__ part) {
  constexpr int kLanes = kThreads / C;
  __shared__ float red[2][kLanes][C];
  const int c = threadIdx.x % C;
  const int q = threadIdx.x / C;
  float s1 = 0.f, s2 = 0.f;
  for (long long pt = static_cast<long long>(blockIdx.x) * kLanes + q; pt < points;
       pt += static_cast<long long>(gridDim.x) * kLanes) {
    const long long b = pt / n;
    for (int s = 0; s < k; ++s) {
      const float e = edge_value(p, pt, b, n, idx[pt * k + s], c, C);
      s1 = __fadd_rn(s1, e);
      s2 = __fmaf_rn(e, e, s2);
    }
  }
  red[0][q][c] = s1;
  red[1][q][c] = s2;
  __syncthreads();
  if (q == 0) {
    float a = red[0][0][c], bsum = red[1][0][c];
    for (int r = 1; r < kLanes; ++r) {
      a = __fadd_rn(a, red[0][r][c]);
      bsum = __fadd_rn(bsum, red[1][r][c]);
    }
    part[(static_cast<long long>(blockIdx.x) * 2) * C + c] = a;
    part[(static_cast<long long>(blockIdx.x) * 2 + 1) * C + c] = bsum;
  }
}

// BatchNorm parameters of the backward, (C,) each: mean, inv = rsqrt(var +
// eps), gamma, beta, then (pass 2) scale = gamma inv, m1 = S0 / E, m2 = S1 / E.
struct BnParams {
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* scale;
  const float* m1;
  const float* m2;
};

// The dx1 of every slot of the kLanes points of a tile, in shared memory:
// dx1[q][s][c] = sum over d with slot[q][d] == s of dout[q][d] W[c][d], d in
// order; the caller rounds it to bf16. Thread (q, c) owns column c of its
// point's rows, so no two threads write one word.
template <int C>
__device__ __forceinline__ void tile_dx1(const float (&wrow)[C], const float* sh_dout,
                                         const int* sh_slot, float* sh_dx1, int k,
                                         int q, int c) {
  for (int s = 0; s < k; ++s) sh_dx1[(q * k + s) * C + c] = 0.f;
  for (int d = 0; d < C; ++d) {
    const int s = sh_slot[q * C + d];
    float* cell = sh_dx1 + (q * k + s) * C + c;
    *cell = __fmaf_rn(sh_dout[q * C + d], wrow[d], *cell);
  }
}

// Pass 1: per block, S = [sum dy, sum dy hhat] (2, C), dW (C, C) and db (C,)
// of its points, written as one partial each.
template <int C>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_backward1_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                               const float* __restrict__ w, BnParams bn,
                               const float* __restrict__ dout,
                               const unsigned char* __restrict__ slot, int n, int k,
                               long long points, float* __restrict__ s_part,
                               float* __restrict__ dw_part, float* __restrict__ db_part) {
  constexpr int kLanes = kThreads / C;          // points a tile
  constexpr int kCols = C / kLanes;             // dW rows a thread owns
  extern __shared__ __align__(16) float smem[];
  float* sh_dout = smem;                                  // kLanes x C
  int* sh_slot = reinterpret_cast<int*>(sh_dout + kLanes * C);   // kLanes x C
  float* sh_dx1 = reinterpret_cast<float*>(sh_slot + kLanes * C); // kLanes x k x C
  float* sh_x1 = sh_dx1 + kLanes * k * C;                 // kLanes x k x (C + 1)
  const int c = threadIdx.x % C;
  const int q = threadIdx.x / C;
  float wrow[C];
#pragma unroll
  for (int d = 0; d < C; ++d) wrow[d] = bf16r(w[c * C + d]);
  const float mean = bn.mean[c], inv = bn.inv[c], gamma = bn.gamma[c], beta = bn.beta[c];
  // dW[cb * kCols + cc][dd] for the thread's column dd and row block cb
  const int dd = threadIdx.x % C;
  const int cb = threadIdx.x / C;
  float acc[kCols];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) acc[cc] = 0.f;
  float s0 = 0.f, s1 = 0.f, dbacc = 0.f;

  for (long long t0 = static_cast<long long>(blockIdx.x) * kLanes; t0 < points;
       t0 += static_cast<long long>(gridDim.x) * kLanes) {
    const long long pt = t0 + q;
    const bool live = pt < points;
    sh_dout[q * C + c] = live ? dout[pt * C + c] : 0.f;
    sh_slot[q * C + c] = live ? slot[pt * C + c] : 0;
    __syncthreads();
    tile_dx1<C>(wrow, sh_dout, sh_slot, sh_dx1, k, q, c);
    if (live) {
      const long long b = pt / n;
      for (int s = 0; s < k; ++s) {
        const float e = edge_value(p, pt, b, n, idx[pt * k + s], c, C);
        const float hhat = __fmul_rn(__fsub_rn(e, mean), inv);
        const float y = __fadd_rn(__fmul_rn(hhat, gamma), beta);
        sh_x1[(q * k + s) * (C + 1) + c] = bf16r(y > 0.f ? y : 0.f);
        const float dy = y > 0.f ? bf16r(sh_dx1[(q * k + s) * C + c]) : 0.f;
        s0 = __fadd_rn(s0, dy);
        s1 = __fmaf_rn(dy, hhat, s1);
      }
    } else {
      for (int s = 0; s < k; ++s) sh_x1[(q * k + s) * (C + 1) + c] = 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kLanes; ++r) {
      const int sd = sh_slot[r * C + dd];
      const float g = sh_dout[r * C + dd];
      const float* row = sh_x1 + (r * k + sd) * (C + 1) + cb * kCols;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[cc] = __fmaf_rn(row[cc], g, acc[cc]);
      if (cb == 0) dbacc = __fadd_rn(dbacc, g);
    }
    __syncthreads();
  }
  const long long blk = blockIdx.x;
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) dw_part[(blk * C + cb * kCols + cc) * C + dd] = acc[cc];
  if (cb == 0) db_part[blk * C + dd] = dbacc;
  sh_dout[q * C + c] = s0;
  reinterpret_cast<float*>(sh_slot)[q * C + c] = s1;
  __syncthreads();
  if (q == 0) {
    float a = sh_dout[c], bb = reinterpret_cast<float*>(sh_slot)[c];
    for (int r = 1; r < kLanes; ++r) {
      a = __fadd_rn(a, sh_dout[r * C + c]);
      bb = __fadd_rn(bb, reinterpret_cast<float*>(sh_slot)[r * C + c]);
    }
    s_part[(blk * 2) * C + c] = a;
    s_part[(blk * 2 + 1) * C + c] = bb;
  }
}

// Pass 2: da of every edge, bf16, (B, N, k, C).
template <int C>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_backward2_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                               const float* __restrict__ w, BnParams bn,
                               const float* __restrict__ dout,
                               const unsigned char* __restrict__ slot, int n, int k,
                               long long points, __nv_bfloat16* __restrict__ da) {
  constexpr int kLanes = kThreads / C;
  extern __shared__ __align__(16) float smem[];
  float* sh_dout = smem;
  int* sh_slot = reinterpret_cast<int*>(sh_dout + kLanes * C);
  float* sh_dx1 = reinterpret_cast<float*>(sh_slot + kLanes * C);
  const int c = threadIdx.x % C;
  const int q = threadIdx.x / C;
  float wrow[C];
#pragma unroll
  for (int d = 0; d < C; ++d) wrow[d] = bf16r(w[c * C + d]);
  const float mean = bn.mean[c], inv = bn.inv[c], gamma = bn.gamma[c], beta = bn.beta[c];
  const float scale = bn.scale[c], m1 = bn.m1[c], m2 = bn.m2[c];
  for (long long t0 = static_cast<long long>(blockIdx.x) * kLanes; t0 < points;
       t0 += static_cast<long long>(gridDim.x) * kLanes) {
    const long long pt = t0 + q;
    const bool live = pt < points;
    sh_dout[q * C + c] = live ? dout[pt * C + c] : 0.f;
    sh_slot[q * C + c] = live ? slot[pt * C + c] : 0;
    __syncthreads();
    tile_dx1<C>(wrow, sh_dout, sh_slot, sh_dx1, k, q, c);
    if (live) {
      const long long b = pt / n;
      for (int s = 0; s < k; ++s) {
        const float e = edge_value(p, pt, b, n, idx[pt * k + s], c, C);
        const float hhat = __fmul_rn(__fsub_rn(e, mean), inv);
        const float y = __fadd_rn(__fmul_rn(hhat, gamma), beta);
        const float dy = y > 0.f ? bf16r(sh_dx1[(q * k + s) * C + c]) : 0.f;
        const float g = __fmul_rn(scale, __fsub_rn(__fsub_rn(dy, m1), __fmul_rn(hhat, m2)));
        da[(pt * k + s) * C + c] = __float2bfloat16_rn(g);
      }
    }
    __syncthreads();
  }
}

// d_p[j][c] = bf16(sum over the reverse list of j of da) - sum over s of
// da[j][s]; order[off[j] .. off[j + 1]) lists the edges (pt k + s) whose
// neighbour is j, ascending. A thread a (point, channel).
__global__ void __launch_bounds__(kThreads)
gnn_propagate_scatter_kernel(const __nv_bfloat16* __restrict__ da,
                             const int* __restrict__ order, const int* __restrict__ off,
                             int k, int C, long long total, float* __restrict__ d_p) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long j = e / C;
    const int c = static_cast<int>(e % C);
    float acc = 0.f;
    for (int t = off[j]; t < off[j + 1]; ++t)
      acc = __fadd_rn(acc, __bfloat162float(da[static_cast<long long>(order[t]) * C + c]));
    float cs = 0.f;
    for (int s = 0; s < k; ++s) cs = __fadd_rn(cs, __bfloat162float(da[(j * k + s) * C + c]));
    d_p[e] = __fsub_rn(bf16r(acc), cs);
  }
}

template <int C>
size_t backward_smem(int k, bool with_x1) {
  constexpr int kLanes = kThreads / C;
  return sizeof(float) * (2 * kLanes * C + kLanes * k * C +
                          (with_x1 ? kLanes * k * (C + 1) : 0));
}

template <int C>
int launch_stat(const float* p, const int* idx, int batch, int n, int k, int blocks,
                float* part, cudaStream_t stream) {
  gnn_propagate_stat_kernel<C><<<blocks, kThreads, 0, stream>>>(
      p, idx, n, k, static_cast<long long>(batch) * n, part);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_backward(int pass, const float* p, const int* idx, const float* w,
                    BnParams bn, const float* dout, const unsigned char* slot, int batch,
                    int n, int k, int blocks, float* s_part, float* dw_part,
                    float* db_part, __nv_bfloat16* da, cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n;
  const size_t smem = backward_smem<C>(k, pass == 1);
  if (pass == 1) {
    cudaError_t err = cudaFuncSetAttribute(gnn_propagate_backward1_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gnn_propagate_backward1_kernel<C><<<blocks, kThreads, smem, stream>>>(
        p, idx, w, bn, dout, slot, n, k, points, s_part, dw_part, db_part);
  } else {
    cudaError_t err = cudaFuncSetAttribute(gnn_propagate_backward2_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gnn_propagate_backward2_kernel<C><<<blocks, kThreads, smem, stream>>>(
        p, idx, w, bn, dout, slot, n, k, points, da);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// p (B, N, C) fp32, idx (B, N, k) int32, W (C, C) fp32 in the flax (in, out)
// orientation (rounded to bf16 here), bias, mean, inv = rsqrt(var + 1e-5),
// gamma, beta (C,) fp32, all contiguous on the device -> out (B, N, C) fp32
// and, unless `slot` is null, the first maximal neighbour slot of each
// output (B, N, C) uint8 (k <= 255). C is 32 or 64. Launches on `stream`
// without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another C, B < 1, N < 1 or k < 1.
int gnn_propagate_forward(const float* p, const int* idx, const float* w,
                          const float* bias, const float* mean, const float* inv,
                          const float* gamma, const float* beta, int batch, int n,
                          int c, int k, float* out, unsigned char* slot, void* stream) {
  if (batch < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 64)
    return launch<64>(p, idx, w, bias, mean, inv, gamma, beta, batch, n, k, out, slot, st);
  if (c == 32)
    return launch<32>(p, idx, w, bias, mean, inv, gamma, beta, batch, n, k, out, slot, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The stat pass: p, idx as above -> part (blocks, 2, C) fp32, block b's
// [sum e, sum e^2] of every channel (a block with no points writes zeros).
int gnn_propagate_stat(const float* p, const int* idx, int batch, int n, int c, int k,
                       int blocks, float* part, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 64) return launch_stat<64>(p, idx, batch, n, k, blocks, part, st);
  if (c == 32) return launch_stat<32>(p, idx, batch, n, k, blocks, part, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward passes. bn (7, C) fp32: mean, inv, gamma, beta, scale = gamma
// inv, m1 = S0 / E, m2 = S1 / E (pass 1 reads the first four); dout (B, N, C)
// fp32 and slot (B, N, C) uint8 from the final pass; k <= 32. Pass 1 ->
// s_part (blocks, 2, C), dw_part (blocks, C, C) (row c, column d of dW),
// db_part (blocks, C); pass 2 -> da (B, N, k, C) bf16.
int gnn_propagate_backward(int pass, const float* p, const int* idx, const float* w,
                           const float* bn, const float* dout, const unsigned char* slot,
                           int batch, int n, int c, int k, int blocks, float* s_part,
                           float* dw_part, float* db_part, void* da, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > 32 || blocks < 1 || (pass != 1 && pass != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BnParams prm{bn, bn + c, bn + 2 * c, bn + 3 * c, bn + 4 * c, bn + 5 * c, bn + 6 * c};
  __nv_bfloat16* dab = static_cast<__nv_bfloat16*>(da);
  if (c == 64)
    return launch_backward<64>(pass, p, idx, w, prm, dout, slot, batch, n, k, blocks,
                               s_part, dw_part, db_part, dab, st);
  if (c == 32)
    return launch_backward<32>(pass, p, idx, w, prm, dout, slot, batch, n, k, blocks,
                               s_part, dw_part, db_part, dab, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The d_p gather: da (B N k, C) bf16, order (B N k) int32 and off (B N + 1)
// int32, the reverse list -> d_p (B, N, C) fp32.
int gnn_propagate_scatter(const void* da, const int* order, const int* off, int batch,
                          int n, int c, int k, float* d_p, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * n * c;
  const long long want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  gnn_propagate_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(da), order, off, k, c, total, d_p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
