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
// Design (after the backward's pass 1): a group of G = rel lanes a point,
// 32 / G points a warp and PTS points a group (1 at levels 1-2, 4 at
// level 3, 2 at level 4, so that each weight read from shared memory
// serves PTS points), `warps` warps a block. The block stages W1 (rows
// padded so that a group's 16-byte reads of consecutive rows miss no bank
// twice), W2 and b2 in shared memory once; after that a warp needs no
// other warp: each group keeps its points' indices, u and w in its own
// slice of shared memory, so the block has no barrier past the staging.
// The blocks take contiguous chunks of the points (block b the b-th of
// `grid` chunks, its warps consecutive parts of it), so an SM's blocks
// work inside one or two clouds. Lane l of a group holds rel channel l and
// mid channels 4l .. 4l + 3 of a row (VRCNet's levels have mid = 4 rel =
// 8 ms). Per point:
//   - its k indices read once by the group's lanes into shared memory;
//   - walk 1: each neighbour row's rel channel l, relu'd, times row
//     (1 + j) rel + l of W1 into MS partial sums a lane (the x1 term first);
//   - the group's partial sums reduced by halving (lane bits pick the half
//     kept, MS - 1 + log2(G / MS) shuffles instead of MS log2(G)), u = relu
//     of the sums written to shared memory by the first MS lanes, read back
//     by every lane of the group; at level 4 instead, for a warp's 16
//     points at a time, the first layer on the tensor cores (3xTF32 on
//     mma.sync m16n8k8: W1 staged once as its B fragments, hi and lo, the
//     points' rows read as 16-byte vectors straight into A fragments);
//   - w = u W2 + b2, outputs 4i .. 4i + 3 on lane i % G (16-byte reads of
//     W2 and b2; one output a lane at ms 2), into the group's w buffer;
//   - walk 2: each neighbour row's mid channels 4l .. 4l + 3 as one 16-byte
//     read, times w[j, (4l .. 4l + 3) % ms] (one 16-byte shared read), into
//     four sums a lane, stored as one 16-byte write.
// The plan (warps, grid) is the host function `kernels.sa_forward_plan`'s,
// a function of the shape and the card's SM count. Templated on (rel, mid,
// ms) for VRCNet's four pyramid levels (4, 16, 2), (8, 32, 4), (16, 64, 8)
// and (32, 128, 16); k is a runtime value in [1, 32]. An index outside
// [0, N) makes the point's output NaN instead of reading out of bounds (the
// wrapper does not range-check on the host).
//
// What bounds it on an H100: bytes, in the count of the bound. At level 1
// of the protocol config (B 32, N 3072, rel 4, mid 16, k 16) the inputs
// proj, x1 and idx and the output are 22 MB (6.6 us at 3.35 TB/s) against
// 0.09 GFLOP of MLP and weighted sum (1.4 us at the 67 TFLOP/s fp32 peak);
// level 4 (N 384, rel 32, mid 128) is 4.5 MB against 0.37 GFLOP. But a
// neighbour row is read once for each point that gathers it, k times on
// average: k (rel + mid) N floats a cloud, the same at every level (126 MB
// at B 32), from L2 or L1. On the card the time is the SM's, not these
// bytes': with every neighbour drawn from a few rows that L1 holds, a
// level runs within 10-15% of its time with rows from all over the cloud.
// At level 4 the first layer's W1 rows (2 KB a neighbour a warp, read from
// shared memory for PTS points) and its 14.8 k multiply-adds a point set
// it, hence the tensor cores there.
//
// The backward replaces `_sa_bwd` / `_sa_bwd_kernel` (pallas_kernels.py:1417
// and :1241), at fp32 with the `c % ms` layout of `_sa_fold`/`_sa_expand`.
// Per point, given d_out (mid), with the forward recomputed (w_in, u, w):
//
//   d_w[j, q] = sum_{c % ms = q} d_out[c] * proj[idx_j, rel + c]
//   d_proj[idx_j, rel + c] += w[j, c % ms] * d_out[c]
//   db2 += d_w,  dW2 += u^T d_w
//   d_u = (d_w . W2^T) * [u > 0],  dW1 += w_in^T d_u
//   d_cat = (d_u . W1^T) * [cat > 0]
//   d_x1 = d_cat[:rel],  d_proj[idx_j, :rel] += d_cat[rel + j rel : ...]
//
// The TPU kernel reads the forward's bf16 stash of the gathered rows and
// accumulates d_proj, dW1, dW2 and db2 into output blocks that its grid
// revisits in order, which is deterministic; on a GPU that carry is a race.
// Here, with no float atomics, in a fixed order, so two runs are bitwise
// equal:
//   - pass 1 (`sa_backward_points_kernel`): a group of G = rel lanes a point,
//     32 / G points a warp (VRCNet's levels have mid = 4 rel = 8 ms, so a
//     lane holds one rel channel and four mid channels of a row), up to 16
//     warps a block and a tile of the block's points at a time, W1^T, W2
//     and b2 staged once a block. Per point the forward is recomputed from
//     proj (no stash: the rows are an indexed load) in one walk over the
//     neighbour rows, which also forms d_w[j, :] from the row's mid part
//     and d_out (a butterfly over the lanes sharing q = c % ms); then u,
//     d_u (a butterfly over the group), d_x1, and a record of w[p, j, :]
//     and d_u[p, :] an edge for pass 2 (B N k, 2 ms). Then the block adds
//     the tile's dW1 += w_in^T d_u, dW2 += u^T d_w and db2 += d_w to its
//     sums in shared memory, each thread its own elements, points in tile
//     order, and writes them once as its partial;
//   - pass 3 (`sa_backward_sum_kernel`): the partials summed in block order;
//   - the reverse list of idx (reverse_list.cu);
//   - pass 2 (`sa_backward_rows_kernel`): d_proj as a gather, a group of G
//     lanes a row r, over r's incoming edges (p, j) in ascending order:
//       d_proj[r, rel + c] = sum w[p, j, c % ms] d_out[p, c]
//       d_proj[r, e] = [proj[r, e] > 0] sum d_u[p, :] . W1[rel + j rel + e, :]
//     (the relu's input is proj[r, e] itself, so the (B, N, k rel) d_cat
//     never reaches memory), one plain store a channel.
// The sums are taken in another order than ops/ref.py's, so the backward
// agrees with `sa_attention_backward` there to a tolerance. A null output
// pointer skips that gradient; pass 1's plan (warps, grid) is the host
// function `kernels.sa_backward_plan`'s, a function of the shape alone. An index outside [0, N) makes the point's d_x1 NaN and adds NaN to
// db2[0] instead of reading or writing out of bounds; the point adds
// nothing to d_proj (its scratch rows are zeros).
//
// Shared memory of pass 1: W1^T, W2, b2 and the block's three sums, plus a
// tile's indices, w_in, u, d_u, d_w and flags: 159 KB at level 4 and k 16
// with 16 warps. The plan drops to 8, 4, 2 or 1 warps where that does not
// fit (k 32 at level 4: 4 warps); pass 2 holds W1^T alone.
//
// What bounds it on an H100: bytes, most of them re-read from L2. At level 1
// of the train step (B 64, N 3072, k 16, rel 4, mid 16) the inputs, d_out
// and the outputs are 63 MB (0.019 ms at 3.35 TB/s) and 0.4 GFLOP; but
// pass 1 gathers k neighbour rows a point (250 MB of 80-byte rows, ~3
// sectors each) and pass 2 re-reads d_out and an edge's record once an
// edge (250 MB), the same at every level (k (rel + mid) N is the same at
// the four), plus the records (50 MB written and read) and the list.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "reverse_list.h"
#include "smem_opt_in.h"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBwdMaxThreads = 512;   // the backward's pass 1: up to 16 warps

// The forward by level (ms): at level 4 (ms 16) the first layer runs on
// the tensor cores, a warp 16 points at a time (kTC); PTS points a group
// in the second layer and the weighted sum (4 points a group at level 3 and
// 2 at level 4 ran fastest on an H100; 4 at level 4, and 1 or 2 at level
// 3, were slower); the largest block: 64 registers a thread at levels 1-2
// (32 warps), 128 at levels 3-4 (16).
template <int MS>
struct SaFwd {
  static constexpr int kRel = 2 * MS;    // VRCNet's levels (share 8)
  static constexpr bool kTC = MS >= 16;
  static constexpr int kPts = MS <= 4 ? 1 : (MS == 8 ? 4 : 2);
  static constexpr int kMaxThreads = MS <= 4 ? 1024 : 512;
  // W1's rows in shared memory on the CUDA cores: MS floats, padded to
  // MS + 4 where a row is 32 bytes or more, so that the 16-byte reads of a
  // group's lanes (rows e .. e + G - 1) fall on distinct banks
  static constexpr int kW1Stride = MS <= 4 ? MS : MS + 4;
  // Points of one pass of a warp's 32 / rel groups, and the points a warp
  // takes at a time: 16 (an m16 tile) on the tensor cores, else a pass.
  static constexpr int kPass = (32 / kRel) * kPts;
  static constexpr int kUnit = kTC ? 16 : kPass;
  // Shared floats of W1: its padded rows on the CUDA cores, on the tensor
  // cores its B fragments, hi and lo.
  __host__ __device__ static constexpr int w1_floats(int k) {
    return kTC ? 2 * (1 + k) * kRel * MS : (1 + k) * kRel * kW1Stride;
  }
  // Shared floats of a block (`kernels._sa_fwd_smem` mirrors it): W1, W2,
  // b2, and for each warp w for a pass of its groups, and u, the k indices
  // and a bad-index flag for each point it takes at a time.
  __host__ __device__ static constexpr int smem_floats(int k, int warps) {
    return w1_floats(k) + MS * k * MS + k * MS + warps * (kPass * k * MS + kUnit * (MS + k + 1));
  }
};

// x split into TF32 hi and lo = x - hi (3xTF32, as hopper.cuh's split_tf32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MS consecutive floats (16-byte aligned where MS % 4 == 0, else 8-byte).
template <int MS>
__device__ __forceinline__ void load_ms(const float* p, float (&v)[MS]) {
  if constexpr (MS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MS; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  } else {
    static_assert(MS == 2, "ms is 2 or a multiple of 4");
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// The sum over a group of G lanes of each lane's MS values, by halving: at
// step S (offset 2^S, S < log2 MS) a lane keeps the half of its values that
// bit S of its place l names and adds its partner's other half; then the
// one value left is summed over the remaining lanes. Returns, on every lane,
// the total of q = qmap(l) (below). A template a step, so that every index
// into `a` is a constant (a loop left rolled put `a` in local memory).
template <int MS, int G, int S = 0>
__device__ __forceinline__ float group_reduce_scatter(float (&a)[MS], int l) {
  if constexpr ((1 << S) < MS) {
    constexpr int h = MS >> (S + 1);
    const bool up = (l >> S) & 1;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? a[i + h] : a[i];
      const float send = up ? a[i] : a[i + h];
      a[i] = keep + __shfl_xor_sync(kFull, send, 1 << S);
    }
    return group_reduce_scatter<MS, G, S + 1>(a, l);
  } else {
    float v = a[0];
#pragma unroll
    for (int o = MS; o < G; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
}

// The q whose total group_reduce_scatter leaves on place l of a group.
template <int MS>
__device__ __forceinline__ int qmap(int l) {
  int q = 0;
#pragma unroll
  for (int s = 0; (1 << s) < MS; ++s) q += ((l >> s) & 1) * (MS >> (s + 1));
  return q;
}

// W1's B fragments for the tensor cores: entry ((src KS + s) NT + nt) 32 +
// lane, lane (g, t) = (lane / 4, lane % 4), the float4 (b0 hi, b1 hi, b0 lo,
// b1 lo) with b0 = W1[src REL + t CPL + 2 s][8 nt + g] and b1 the next row:
// source src (0 the point's x1, 1 + j its neighbour j) contributes REL rows
// in KS = REL / 8 k-steps, lane t taking its CPL = REL / 4 consecutive
// channels, k-step s the pair 2 s, 2 s + 1 of them (A's columns t and
// t + 4).
template <int REL, int MS>
__device__ __forceinline__ void stage_w1_fragments(const float* __restrict__ w1, int k,
                                                   float4* frag) {
  constexpr int KS = REL / 8, CPL = REL / 4, NT = MS / 8;
  const int entries = (1 + k) * KS * NT * 32;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const int lane = i & 31, g = lane >> 2, t = lane & 3;
    const int nt = (i >> 5) % NT;
    const int ks = (i >> 5) / NT;             // src KS + s
    const int row = (ks / KS) * REL + t * CPL + 2 * (ks % KS);
    uint32_t h0, l0, h1, l1;
    split_tf32(w1[row * MS + 8 * nt + g], h0, l0);
    split_tf32(w1[(row + 1) * MS + 8 * nt + g], h1, l1);
    frag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
  }
}

// The first layer of a warp's 16 points on the tensor cores (3xTF32 on
// mma.sync m16n8k8): A = relu(w_in) (points g and g + 8 of lane (g, t),
// read from their rows as 16-byte vectors), B = W1's fragments; u = relu
// of the sums into ub (16, MS).
template <int REL, int MID, int MS>
__device__ __forceinline__ void first_layer_tc(
    const float* __restrict__ proj, const float* __restrict__ x1, const float4* frag,
    const int* ib, int k, int n, int points, int p0, float* ub) {
  constexpr int KS = REL / 8, CPL = REL / 4, NT = MS / 8, C = REL + MID;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pa = min(p0 + g, points - 1), pb = min(p0 + g + 8, points - 1);
  const float* ca = proj + static_cast<size_t>(pa / n) * n * C + t * CPL;
  const float* cb = proj + static_cast<size_t>(pb / n) * n * C + t * CPL;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 2
  for (int src = 0; src <= k; ++src) {
    const float* ra;
    const float* rb;
    if (src == 0) {
      ra = x1 + static_cast<size_t>(pa) * REL + t * CPL;
      rb = x1 + static_cast<size_t>(pb) * REL + t * CPL;
    } else {
      ra = ca + static_cast<size_t>(ib[g * k + src - 1]) * C;
      rb = cb + static_cast<size_t>(ib[(g + 8) * k + src - 1]) * C;
    }
    float va[CPL], vb[CPL];
#pragma unroll
    for (int c = 0; c < CPL; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(ra + c));
      const float4 y = __ldg(reinterpret_cast<const float4*>(rb + c));
      va[c] = x.x; va[c + 1] = x.y; va[c + 2] = x.z; va[c + 3] = x.w;
      vb[c] = y.x; vb[c + 1] = y.y; vb[c + 2] = y.z; vb[c + 3] = y.w;
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t hi[4], lo[4];
      split_tf32(fmaxf(va[2 * s], 0.f), hi[0], lo[0]);
      split_tf32(fmaxf(vb[2 * s], 0.f), hi[1], lo[1]);
      split_tf32(fmaxf(va[2 * s + 1], 0.f), hi[2], lo[2]);
      split_tf32(fmaxf(vb[2 * s + 1], 0.f), hi[3], lo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 b = frag[((src * KS + s) * NT + nt) * 32 + lane];
        mma_tf32(acc[nt], lo, __float_as_uint(b.x), __float_as_uint(b.y));
        mma_tf32(acc[nt], hi, __float_as_uint(b.z), __float_as_uint(b.w));
        mma_tf32(acc[nt], hi, __float_as_uint(b.x), __float_as_uint(b.y));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(ub + g * MS + 8 * nt + 2 * t) =
        make_float2(fmaxf(acc[nt][0], 0.f), fmaxf(acc[nt][1], 0.f));
    *reinterpret_cast<float2*>(ub + (g + 8) * MS + 8 * nt + 2 * t) =
        make_float2(fmaxf(acc[nt][2], 0.f), fmaxf(acc[nt][3], 0.f));
  }
}

template <int REL, int MID, int MS>
__global__ void __launch_bounds__(SaFwd<MS>::kMaxThreads, 1)
sa_attention_kernel(const float* __restrict__ proj,
                    const float* __restrict__ x1, const int* __restrict__ idx,
                    const float* __restrict__ w1, const float* __restrict__ w2,
                    const float* __restrict__ b2, int n, int k, int points,
                    float* __restrict__ out) {
  constexpr int G = REL;
  constexpr bool TC = SaFwd<MS>::kTC;
  constexpr int PTS = SaFwd<MS>::kPts;
  constexpr int PASS = SaFwd<MS>::kPass;     // points of one pass of the groups
  constexpr int UNIT = SaFwd<MS>::kUnit;     // points a warp takes at a time
  constexpr int W1S = SaFwd<MS>::kW1Stride;
  constexpr int C = REL + MID;
  static_assert(MID == 4 * REL && SaFwd<MS>::kRel == REL && MID == 8 * MS,
                "the lane maps below take VRCNet's levels (share 8)");
  static_assert(UNIT % PASS == 0, "a warp's points are whole passes");
  extern __shared__ __align__(16) float smem[];
  const int in_w = (1 + k) * REL;
  const int kms = k * MS;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sw1 = smem;                       // (in_w, W1S), or W1's fragments
  float* sw2 = sw1 + SaFwd<MS>::w1_floats(k);             // (MS, kms)
  float* sb2 = sw2 + MS * kms;             // (kms)
  float* wb = sb2 + kms + warp * PASS * kms;              // the warp's (PASS, kms): w
  float* ub = sb2 + kms + warps * PASS * kms + warp * UNIT * MS;   // (UNIT, MS): u
  int* ib = reinterpret_cast<int*>(sb2 + kms + warps * (PASS * kms + UNIT * MS)) +
            warp * UNIT * (k + 1);         // (UNIT, k) indices, then (UNIT) flags
  int* bf = ib + UNIT * k;
  if constexpr (TC) {
    stage_w1_fragments<REL, MS>(w1, k, reinterpret_cast<float4*>(sw1));
  } else {
    for (int t = threadIdx.x; t < in_w * MS; t += blockDim.x) {
      sw1[(t / MS) * W1S + t % MS] = w1[t];
    }
  }
  for (int t = threadIdx.x; t < MS * kms; t += blockDim.x) sw2[t] = w2[t];
  for (int t = threadIdx.x; t < kms; t += blockDim.x) sb2[t] = b2[t];
  __syncthreads();

  const int grp = lane / G, l = lane % G;
  // The block's chunk of the warps' units of UNIT points, then its warp's
  // part of the chunk.
  const int units = (points + UNIT - 1) / UNIT;
  const int c0 = static_cast<int>(static_cast<long long>(units) * blockIdx.x / gridDim.x);
  const int c1 = static_cast<int>(static_cast<long long>(units) * (blockIdx.x + 1) / gridDim.x);
  const int u0 = c0 + static_cast<int>(static_cast<long long>(c1 - c0) * warp / warps);
  const int u1 = c0 + static_cast<int>(static_cast<long long>(c1 - c0) * (warp + 1) / warps);
  const int qm = qmap<MS>(l);

  for (int unit = u0; unit < u1; ++unit) {
    const int p0 = unit * UNIT;
    // The unit's indices, one coalesced read; an index outside [0, n) is
    // read as row 0 and flags its point.
    // (Points past the end read the last point's indices.)
    for (int t = lane; t < UNIT; t += 32) bf[t] = 0;
    __syncwarp();
    const size_t i0 = static_cast<size_t>(p0) * k, i_last = static_cast<size_t>(points) * k - 1;
    for (int t = lane; t < UNIT * k; t += 32) {
      const int v = idx[min(i0 + t, i_last)];
      const bool o = v < 0 || v >= n;
      ib[t] = o ? 0 : v;
      if (o) bf[t / k] = 1;
    }
    __syncwarp();

    if constexpr (TC) {
      first_layer_tc<REL, MID, MS>(proj, x1, reinterpret_cast<const float4*>(sw1), ib, k, n,
                                   points, p0, ub);
    } else {
      // Walk 1 on the CUDA cores: the first layer's MS partial sums a lane.
      float acc[PTS][MS];
      const float* cloud[PTS];             // the point's cloud, at channel l
      {
        float wv[MS];
        load_ms<MS>(sw1 + l * W1S, wv);
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
          const int p = min(p0 + grp * PTS + r, points - 1);
          cloud[r] = proj + static_cast<size_t>(p / n) * n * C + l;
          const float v = fmaxf(x1[static_cast<size_t>(p) * REL + l], 0.f);
#pragma unroll
          for (int q = 0; q < MS; ++q) acc[r][q] = v * wv[q];
        }
      }
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        float v[PTS];
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
          const int row = ib[(grp * PTS + r) * k + j];
          v[r] = fmaxf(__ldg(cloud[r] + static_cast<size_t>(row) * C), 0.f);
        }
        float wv[MS];
        load_ms<MS>(sw1 + ((1 + j) * REL + l) * W1S, wv);
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
#pragma unroll
          for (int q = 0; q < MS; ++q) acc[r][q] = fmaf(v[r], wv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < PTS; ++r) {
        const float s = group_reduce_scatter<MS, G>(acc[r], l);
        if (l < MS) ub[(grp * PTS + r) * MS + qm] = fmaxf(s, 0.f);
      }
    }
    __syncwarp();

    for (int pass = 0; pass < UNIT; pass += PASS) {
      const int slot = pass + grp * PTS;   // the group's first point of the unit
      // w = u W2 + b2: outputs o .. o + 3 on lane o / 4 % G (16-byte reads
      // of W2 and b2, 16-byte writes of w; kms % 4 == 0 where MS >= 4),
      // output o on lane o % G where MS == 2.
      {
        float u[PTS][MS];
#pragma unroll
        for (int r = 0; r < PTS; ++r) load_ms<MS>(ub + (slot + r) * MS, u[r]);
        float* wg = wb + grp * PTS * kms;
        if constexpr (MS >= 4) {
          for (int o = 4 * l; o < kms; o += 4 * G) {
            float4 s[PTS];
#pragma unroll
            for (int r = 0; r < PTS; ++r) s[r] = *reinterpret_cast<const float4*>(sb2 + o);
#pragma unroll
            for (int q = 0; q < MS; ++q) {
              const float4 wq = *reinterpret_cast<const float4*>(sw2 + q * kms + o);
#pragma unroll
              for (int r = 0; r < PTS; ++r) {
                s[r].x = fmaf(u[r][q], wq.x, s[r].x);
                s[r].y = fmaf(u[r][q], wq.y, s[r].y);
                s[r].z = fmaf(u[r][q], wq.z, s[r].z);
                s[r].w = fmaf(u[r][q], wq.w, s[r].w);
              }
            }
#pragma unroll
            for (int r = 0; r < PTS; ++r) *reinterpret_cast<float4*>(wg + r * kms + o) = s[r];
          }
        } else {
          for (int o = l; o < kms; o += G) {
            float s[PTS];
#pragma unroll
            for (int r = 0; r < PTS; ++r) s[r] = sb2[o];
#pragma unroll
            for (int q = 0; q < MS; ++q) {
              const float wq = sw2[q * kms + o];
#pragma unroll
              for (int r = 0; r < PTS; ++r) s[r] = fmaf(u[r][q], wq, s[r]);
            }
#pragma unroll
            for (int r = 0; r < PTS; ++r) wg[r * kms + o] = s[r];
          }
        }
      }
      __syncwarp();

      // Walk 2: out[c] = sum_j w[j, c % MS] proj[idx_j, REL + c], c = 4l .. 4l + 3.
      float4 o4[PTS];
      const float* cloud[PTS];             // the point's cloud, at channel REL + 4l
#pragma unroll
      for (int r = 0; r < PTS; ++r) {
        o4[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int p = min(p0 + slot + r, points - 1);
        cloud[r] = proj + static_cast<size_t>(p / n) * n * C + REL + 4 * l;
      }
      const int q0 = (4 * l) % MS;
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int r = 0; r < PTS; ++r) {
          const int row = ib[(slot + r) * k + j];
          const float4 pm = __ldg(reinterpret_cast<const float4*>(
              cloud[r] + static_cast<size_t>(row) * C));
          const float* wr = wb + (grp * PTS + r) * kms + j * MS;
          float4 w4;
          if constexpr (MS == 2) {
            const float2 t = *reinterpret_cast<const float2*>(wr);
            w4 = make_float4(t.x, t.y, t.x, t.y);
          } else {
            w4 = *reinterpret_cast<const float4*>(wr + q0);
          }
          o4[r].x = fmaf(w4.x, pm.x, o4[r].x);
          o4[r].y = fmaf(w4.y, pm.y, o4[r].y);
          o4[r].z = fmaf(w4.z, pm.z, o4[r].z);
          o4[r].w = fmaf(w4.w, pm.w, o4[r].w);
        }
      }
#pragma unroll
      for (int r = 0; r < PTS; ++r) {
        const int p = p0 + slot + r;
        if (p >= points) continue;
        if (bf[slot + r]) {
          o4[r] = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
        }
        *reinterpret_cast<float4*>(out + static_cast<size_t>(p) * MID + 4 * l) = o4[r];
      }
      __syncwarp();                      // wb is the next pass's
    }
  }
}

template <int REL, int MID, int MS>
int launch(const float* proj, const float* x1, const int* idx, const float* w1,
           const float* w2, const float* b2, int batch, int n, int k, int warps,
           int grid, float* out, cudaStream_t stream) {
  if (warps * 32 > SaFwd<MS>::kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sa_attention_kernel<REL, MID, MS>;
  const size_t smem = sizeof(float) * SaFwd<MS>::smem_floats(k, warps);
  static SmemOptIn opt_in;
  cudaError_t err = opt_in.raise(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The rest of the SM's 256 KB as L1, where the chunk's neighbour rows are
  // re-read: a hint for the least shared memory that holds the block and
  // its 1 KB of reserve (per cent of the SM's 228 KB), set when it changes.
  static int carveout = -1;
  const int pct = min(100, static_cast<int>((100 * (smem + 1024) + 233471) / 233472));
  if (carveout != pct) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributePreferredSharedMemoryCarveout, pct);
    if (err != cudaSuccess) return static_cast<int>(err);
    carveout = pct;
  }
  sa_attention_kernel<REL, MID, MS><<<grid, warps * 32, smem, stream>>>(
      proj, x1, idx, w1, w2, b2, n, k, batch * n, out);
  return static_cast<int>(cudaGetLastError());
}

// The backward's pass 1 keeps in shared memory W1^T, W2, b2, their per-block
// sums (dW1^T, dW2, db2), and for each of the tile's points its indices, its
// relu'd first-layer input, u, d_u, d_w and a flag: the floats of
// `kernels.sa_backward_plan`.
int bwd_smem_floats(int rel, int ms, int k, int points) {
  const int in_w = (1 + k) * rel, kms = k * ms;
  return 2 * (in_w * ms + ms * kms + kms) + points * (in_w + 2 * ms + kms + k + 1);
}

// W1 (in_w, MS) into shared memory transposed, (MS, in_w): consecutive
// threads write consecutive words.
template <int MS>
__device__ __forceinline__ void stage_w1t(const float* __restrict__ w1, int in_w,
                                          float* sw1t) {
  for (int t = threadIdx.x; t < in_w * MS; t += blockDim.x) {
    sw1t[t] = w1[(t % in_w) * MS + t / in_w];
  }
}

// Pass 1: a group of G = REL lanes a point, 32 / G points a warp and
// `warps` warps a block, the tile's points in one pass each; the block walks
// tiles with a grid stride. Lane l of a group holds rel channel l and mid
// channels 4l .. 4l + 3 of a row. Per point, one walk over its neighbour
// rows: the first layer's partial sums, and d_w[j, :] from the row's mid
// part and d_out (reduced over the lanes sharing a q = c % MS). Then u on
// every lane of the group, w and d_u into the per-edge scratch `rec`
// ((B N k, 2 MS): w[p, j, :] then d_u[p, :]), d_x1. Then the block adds the
// tile's dW1, dW2 and db2 to its sums, each thread its own elements, points
// in tile order, and writes its sums to `part` once.
template <int REL, int MID, int MS>
__global__ void __launch_bounds__(kBwdMaxThreads, MS <= 4 ? 2 : 1)
sa_backward_points_kernel(
    const float* __restrict__ proj, const float* __restrict__ x1,
    const int* __restrict__ idx, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g, int n, int k, int points, int tiles,
    float* __restrict__ dx1, float* __restrict__ rec, float* __restrict__ part) {
  constexpr int G = REL;
  constexpr int PW = 32 / G;
  constexpr int C = REL + MID;
  static_assert(MID == 4 * REL && SaFwd<MS>::kRel == REL && MID == 8 * MS,
                "the lane maps below take VRCNet's levels (share 8)");
  extern __shared__ __align__(16) float smem[];
  const int in_w = (1 + k) * REL;
  const int kms = k * MS;
  const int tile_points = (blockDim.x >> 5) * PW;
  float* sw1t = smem;                    // (MS, in_w): W1 transposed
  float* sw2 = sw1t + MS * in_w;         // (MS, kms)
  float* sb2 = sw2 + MS * kms;           // (kms)
  float* adw1t = sb2 + kms;              // (MS, in_w): the block's dW1^T
  float* adw2 = adw1t + MS * in_w;       // (MS, kms)
  float* adb2 = adw2 + MS * kms;         // (kms)
  float* winb = adb2 + kms;              // (points, in_w)
  float* ub = winb + tile_points * in_w; // (points, MS)
  float* dub = ub + tile_points * MS;    // (points, MS)
  float* dwb = dub + tile_points * MS;   // (points, kms)
  int* idxb = reinterpret_cast<int*>(dwb + tile_points * kms);  // (points, k)
  int* flagb = idxb + tile_points * k;   // 0 live, 1 bad index, 2 past the end
  stage_w1t<MS>(w1, in_w, sw1t);
  for (int t = threadIdx.x; t < in_w * MS; t += blockDim.x) adw1t[t] = 0.f;
  for (int t = threadIdx.x; t < MS * kms; t += blockDim.x) {
    sw2[t] = w2[t];
    adw2[t] = 0.f;
  }
  for (int t = threadIdx.x; t < kms; t += blockDim.x) {
    sb2[t] = b2[t];
    adb2[t] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / G, l = lane % G;
  const int pt = (threadIdx.x >> 5) * PW + grp;   // the group's point of the tile
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (grp * G);
  int* ib = idxb + pt * k;
  float* wi = winb + pt * in_w;
  float* dw = dwb + pt * kms;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p_raw = tile * tile_points + pt;
    const bool live = p_raw < points;
    const int p = live ? p_raw : points - 1;
    const size_t cloud = static_cast<size_t>(p / n) * n * C;
    bool bad = false;
    for (int t = l; t < k; t += G) {
      const int v = idx[static_cast<size_t>(p) * k + t];
      const bool out = v < 0 || v >= n;
      bad |= out;
      ib[t] = out ? 0 : v;
    }
    bad = (__ballot_sync(kFull, bad) & gmask) != 0;
    __syncwarp();

    // One walk over the neighbour rows: the first layer (element e of w_in
    // on lane e % G, MS partial sums a lane) and d_w[j, :].
    const float xv = x1[static_cast<size_t>(p) * REL + l];
    const float4 g4 = *reinterpret_cast<const float4*>(g + static_cast<size_t>(p) * MID + 4 * l);
    float acc[MS];
    {
      const float v = fmaxf(xv, 0.f);
      wi[l] = v;
#pragma unroll
      for (int q = 0; q < MS; ++q) acc[q] = v * sw1t[q * in_w + l];
    }
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const float* row = proj + cloud + static_cast<size_t>(ib[j]) * C;
      const float v = fmaxf(row[l], 0.f);
      const float4 pm = *reinterpret_cast<const float4*>(row + REL + 4 * l);
      const int e = REL + j * REL + l;
      wi[e] = v;
#pragma unroll
      for (int q = 0; q < MS; ++q) acc[q] = fmaf(v, sw1t[q * in_w + e], acc[q]);
      // channel 4l + i has q = (4l + i) % MS: with MS >= 4 the lane's four
      // channels are four consecutive q's, shared with the lanes l' = l
      // mod MS / 4; with MS == 2 channels i and i + 2 share q = i.
      float s[4] = {g4.x * pm.x, g4.y * pm.y, g4.z * pm.z, g4.w * pm.w};
      if constexpr (MS == 2) {
        s[0] += s[2];
        s[1] += s[3];
      }
      constexpr int kQ = MS == 2 ? 2 : 4;
      constexpr int kFrom = MS == 2 ? 1 : MS / 4;
#pragma unroll
      for (int o = kFrom; o < G; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) s[i] += __shfl_xor_sync(kFull, s[i], o);
      }
      if (l < kFrom) {
#pragma unroll
        for (int i = 0; i < kQ; ++i) dw[j * MS + kQ * l + i] = s[i];
      }
    }
    float u[MS];
#pragma unroll
    for (int q = 0; q < MS; ++q) {
      float s = acc[q];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      u[q] = fmaxf(s, 0.f);
    }
    __syncwarp();

    // d_u = (d_w W2^T) [u > 0] and, for pass 2, w = u W2 + b2; output o of
    // the second layer on lane o % G.
    float du[MS];
#pragma unroll
    for (int q = 0; q < MS; ++q) du[q] = 0.f;
    for (int o = l; o < kms; o += G) {
      const float d = dw[o];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < MS; ++q) {
        du[q] = fmaf(d, sw2[q * kms + o], du[q]);
        s = fmaf(u[q], sw2[q * kms + o], s);
      }
      if (rec != nullptr && live) {
        rec[(static_cast<size_t>(p) * k + o / MS) * 2 * MS + o % MS] =
            bad ? 0.f : s + sb2[o];
      }
    }
#pragma unroll
    for (int q = 0; q < MS; ++q) {
      float s = du[q];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      du[q] = u[q] > 0.f ? s : 0.f;
    }

    // d_x1 = (d_u W1^T)[:REL] [x1 > 0], channel l on lane l.
    if (dx1 != nullptr && live) {
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < MS; ++q) d = fmaf(du[q], sw1t[q * in_w + l], d);
      dx1[static_cast<size_t>(p) * REL + l] = bad ? CUDART_NAN_F : (xv > 0.f ? d : 0.f);
    }
    const bool keep = live && !bad;
#pragma unroll
    for (int q = 0; q < MS; ++q) {
      if (q == l) {
        ub[pt * MS + q] = keep ? u[q] : 0.f;
        dub[pt * MS + q] = keep ? du[q] : 0.f;
      }
    }
    if (l == 0) flagb[pt] = live ? (bad ? 1 : 0) : 2;
    __syncwarp();
    if (rec != nullptr && live) {                 // d_u beside each edge's w
      for (int t = l; t < kms; t += G) {
        rec[(static_cast<size_t>(p) * k + t / MS) * 2 * MS + MS + t % MS] =
            dub[pt * MS + t % MS];
      }
    }
    __syncthreads();

    // The tile's dW1 += w_in^T d_u, dW2 += u^T d_w, db2 += d_w, points in
    // order; a thread owns column e of dW1^T and column o of dW2 and db2.
    if (part != nullptr) {
      for (int e = threadIdx.x; e < in_w; e += blockDim.x) {
        float a[MS];
#pragma unroll
        for (int q = 0; q < MS; ++q) a[q] = adw1t[q * in_w + e];
        for (int t = 0; t < tile_points; ++t) {
          const float x = winb[t * in_w + e];
          float d[MS];
          load_ms<MS>(dub + t * MS, d);
#pragma unroll
          for (int q = 0; q < MS; ++q) a[q] = fmaf(x, d[q], a[q]);
        }
#pragma unroll
        for (int q = 0; q < MS; ++q) adw1t[q * in_w + e] = a[q];
      }
      for (int o = threadIdx.x; o < kms; o += blockDim.x) {
        float a[MS];
#pragma unroll
        for (int q = 0; q < MS; ++q) a[q] = adw2[q * kms + o];
        float bsum = adb2[o];
        for (int t = 0; t < tile_points; ++t) {
          const float d = dwb[t * kms + o];
          float uu[MS];
          load_ms<MS>(ub + t * MS, uu);
#pragma unroll
          for (int q = 0; q < MS; ++q) a[q] = fmaf(uu[q], d, a[q]);
          const int f = flagb[t];
          if (f == 0) {
            bsum += d;
          } else if (f == 1 && o == 0) {
            bsum += CUDART_NAN_F;
          }
        }
#pragma unroll
        for (int q = 0; q < MS; ++q) adw2[q * kms + o] = a[q];
        adb2[o] = bsum;
      }
    }
    __syncthreads();
  }

  if (part != nullptr) {
    float* pb = part + static_cast<size_t>(blockIdx.x) * (in_w * MS + MS * kms + kms);
    for (int t = threadIdx.x; t < in_w * MS; t += blockDim.x) {
      pb[t] = adw1t[(t % MS) * in_w + t / MS];     // dW1 as W1, (in_w, MS)
    }
    for (int t = threadIdx.x; t < MS * kms; t += blockDim.x) pb[in_w * MS + t] = adw2[t];
    for (int t = threadIdx.x; t < kms; t += blockDim.x) {
      pb[in_w * MS + MS * kms + t] = adb2[t];
    }
  }
}

// Pass 2: d_proj as a gather over the reverse list of idx (entries p k + j,
// ascending). A group of G lanes a row r, 32 / G rows a warp, the blocks
// walking rows with a grid stride; lane l takes the rel channel l and the
// mid channels l + G s (s < 4), whose q = c % MS is l % MS:
//   d_proj[r, REL + c] = sum w[p, j, q] g[p, c]
//   d_proj[r, l] = [proj[r, l] > 0] sum_{q'} d_u[p, q'] W1[(1 + j) REL + l, q']
// with w[p, j, :] and d_u[p, :] read as one record of `rec`. W1^T in shared
// memory, (MS, in_w) floats.
template <int REL, int MID, int MS>
__global__ void __launch_bounds__(kThreads)
sa_backward_rows_kernel(const float* __restrict__ proj,
                        const float* __restrict__ w1, const float* __restrict__ g,
                        const float* __restrict__ rec,
                        const int* __restrict__ order, const int* __restrict__ off,
                        int k, int rows, float* __restrict__ dproj) {
  constexpr int G = REL;
  constexpr int PW = 32 / G;
  constexpr int C = REL + MID;
  extern __shared__ __align__(16) float sw1t[];
  const int in_w = (1 + k) * REL;
  stage_w1t<MS>(w1, in_w, sw1t);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int l = lane % G;
  const int q = l % MS;
  for (int row = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * PW + lane / G;
       row < rows; row += gridDim.x * (kThreads / 32) * PW) {
    float mid[4] = {0.f, 0.f, 0.f, 0.f};
    float rel = 0.f;
#pragma unroll 4
    for (int t = off[row]; t < off[row + 1]; ++t) {
      const int e = order[t];            // p k + j, p over the batch
      const int p = e / k;
      const int j = e - p * k;
      const float* re = rec + static_cast<size_t>(e) * 2 * MS;
      const float w = re[q];
      float du[MS];
      load_ms<MS>(re + MS, du);
      const float* gp = g + static_cast<size_t>(p) * MID + l;
#pragma unroll
      for (int s = 0; s < 4; ++s) mid[s] = __fadd_rn(mid[s], __fmul_rn(w, gp[G * s]));
      const int col = (1 + j) * REL + l;
      float z = 0.f;
#pragma unroll
      for (int qq = 0; qq < MS; ++qq) z = fmaf(du[qq], sw1t[qq * in_w + col], z);
      rel = __fadd_rn(rel, z);
    }
    const size_t at = static_cast<size_t>(row) * C;
    dproj[at + l] = proj[at + l] > 0.f ? rel : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) dproj[at + REL + l + G * s] = mid[s];
  }
}

// Pass 3: out[f] = the sum of part[0 .. blocks)[f], in block order; a
// thread an element of the F = in_w ms + ms k ms + k ms weight gradients.
__global__ void __launch_bounds__(kThreads)
sa_backward_sum_kernel(const float* __restrict__ part, int blocks, int f_total,
                       float* __restrict__ out) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= f_total) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<size_t>(b) * f_total + f];
  out[f] = s;
}

template <int REL, int MID, int MS>
int launch_backward(const float* proj, const float* x1, const int* idx,
                    const float* w1, const float* w2, const float* b2,
                    const float* g, int batch, int n, int k, int warps, int grid,
                    int list_warps, int list_ranges, int* order, int* off,
                    float* rec, float* part, float* wsum, float* dproj,
                    float* dx1, cudaStream_t stream) {
  const int points = batch * n;
  const int tile_points = warps * (32 / REL);
  const int tiles = (points + tile_points - 1) / tile_points;
  const size_t smem = sizeof(float) * bwd_smem_floats(REL, MS, k, tile_points);
  auto points_kernel = sa_backward_points_kernel<REL, MID, MS>;
  cudaError_t err = cudaFuncSetAttribute(
      points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  points_kernel<<<grid, warps * 32, smem, stream>>>(
      proj, x1, idx, w1, w2, b2, g, n, k, points, tiles, dx1,
      dproj == nullptr ? nullptr : rec, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (part != nullptr) {
    const int f_total = (1 + k) * REL * MS + MS * k * MS + k * MS;
    sa_backward_sum_kernel<<<(f_total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        part, grid, f_total, wsum);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dproj == nullptr) return 0;
  const int list_err = reverse_list_build(idx, batch, n * k, n, list_warps,
                                          list_ranges, order, off, stream);
  if (list_err != 0) return list_err;
  const size_t smem2 = sizeof(float) * MS * (1 + k) * REL;
  auto rows_kernel = sa_backward_rows_kernel<REL, MID, MS>;
  err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel, kThreads,
                                                      smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRowsABlock = (kThreads / 32) * (32 / REL);
  int grid2 = per_sm * sms;              // every block resident at once
  if (grid2 < 1) grid2 = 1;
  if (grid2 > (points + kRowsABlock - 1) / kRowsABlock) {
    grid2 = (points + kRowsABlock - 1) / kRowsABlock;
  }
  rows_kernel<<<grid2, kThreads, smem2, stream>>>(proj, w1, g, rec, order, off, k,
                                                 points, dproj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// proj (B, N, rel+mid), x1 (B, N, rel), idx (B, N, k) int32, W1
// ((1+k)*rel, ms), W2 (ms, k*ms), b2 (k*ms), ms = mid / share, all
// contiguous float32 on the device, proj and out 16-byte aligned -> out
// (B, N, mid). (rel, mid, ms) is one of (4, 16, 2), (8, 32, 4), (16, 64, 8),
// (32, 128, 16); 1 <= k <= 32. `grid` blocks of `warps` warps, the plan of
// `kernels.sa_forward_plan`. Launches on `stream` without synchronising
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for shapes or plans outside those limits.
int sa_attention_forward(const float* proj, const float* x1, const int* idx,
                         const float* w1, const float* w2, const float* b2,
                         int batch, int n, int rel, int mid, int share, int k,
                         int warps, int grid, float* out, void* stream) {
  if (k < 1 || k > kMaxK || share < 1 || mid % share != 0 || warps < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ms = mid / share;
#define MVP_SA_FORWARD(R, M, S) \
  launch<R, M, S>(proj, x1, idx, w1, w2, b2, batch, n, k, warps, grid, out, s)
  if (rel == 4 && mid == 16 && ms == 2) return MVP_SA_FORWARD(4, 16, 2);
  if (rel == 8 && mid == 32 && ms == 4) return MVP_SA_FORWARD(8, 32, 4);
  if (rel == 16 && mid == 64 && ms == 8) return MVP_SA_FORWARD(16, 64, 8);
  if (rel == 32 && mid == 128 && ms == 16) return MVP_SA_FORWARD(32, 128, 16);
#undef MVP_SA_FORWARD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory bytes the forward takes for k neighbours and `warps`
// warps a block (kernels.sa_forward_plan mirrors it), or -1 for a level
// outside VRCNet's four.
int sa_attention_forward_smem(int rel, int ms, int k, int warps) {
  const int f = static_cast<int>(sizeof(float));
  if (rel == 4 && ms == 2) return f * SaFwd<2>::smem_floats(k, warps);
  if (rel == 8 && ms == 4) return f * SaFwd<4>::smem_floats(k, warps);
  if (rel == 16 && ms == 8) return f * SaFwd<8>::smem_floats(k, warps);
  if (rel == 32 && ms == 16) return f * SaFwd<16>::smem_floats(k, warps);
  return -1;
}

// The backward: inputs as sa_attention_forward plus g (B, N, mid) -> dx1
// (B, N, rel) and dproj (B, N, rel+mid) written, and `wsum` (in_w ms +
// ms k ms + k ms) dW1, dW2 and db2 in that order, the sums in block order
// of the per-block sums pass 1 writes to `part` (grid, the same); a null
// output pointer skips that gradient (part and wsum both null, or both
// not).
// Pass 1 runs `grid` blocks of `warps` warps; with dproj it writes the
// scratch rec (B N k, 2 ms), then builds the reverse list of idx
// (reverse_list.cu: `list_warps`, `list_ranges`, order (B N k), off
// (B N + 1)) and runs pass 2. The plan is `kernels.sa_backward_plan`'s.
// The same shape limits; returns cudaErrorInvalidValue outside them.
int sa_attention_backward(const float* proj, const float* x1, const int* idx,
                          const float* w1, const float* w2, const float* b2,
                          const float* g, int batch, int n, int rel, int mid,
                          int share, int k, int warps, int grid,
                          int list_warps, int list_ranges, int* order, int* off,
                          float* rec,
                          float* part, float* wsum, float* dproj, float* dx1,
                          void* stream) {
  if (k < 1 || k > kMaxK || share < 1 || mid % share != 0 || warps < 1 ||
      warps * 32 > kBwdMaxThreads || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ms = mid / share;
#define MVP_SA_BACKWARD(R, M, S)                                               \
  launch_backward<R, M, S>(proj, x1, idx, w1, w2, b2, g, batch, n, k, warps, \
                           grid, list_warps, list_ranges, order, off, rec,   \
                           part, wsum, dproj, dx1, s)
  if (rel == 4 && mid == 16 && ms == 2) return MVP_SA_BACKWARD(4, 16, 2);
  if (rel == 8 && mid == 32 && ms == 4) return MVP_SA_BACKWARD(8, 32, 4);
  if (rel == 16 && mid == 64 && ms == 8) return MVP_SA_BACKWARD(16, 64, 8);
  if (rel == 32 && mid == 128 && ms == 16) return MVP_SA_BACKWARD(32, 128, 16);
#undef MVP_SA_BACKWARD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory bytes pass 1 takes for k neighbours and `points` points
// a tile (kernels.sa_backward_plan mirrors it).
int sa_attention_backward_smem(int rel, int ms, int k, int points) {
  return static_cast<int>(sizeof(float)) * bwd_smem_floats(rel, ms, k, points);
}

}  // extern "C"
