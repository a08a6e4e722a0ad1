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

#include "reverse_list.h"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBwdMaxThreads = 512;   // the backward's pass 1: up to 16 warps

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
  static_assert(MID == 4 * REL && 2 * MS == REL && MID == 8 * MS,
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
