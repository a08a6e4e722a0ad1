// Chamfer forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_chamfer_pallas` / `_chamfer_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:133 and :95). It computes what
// that kernel computes, not its block structure:
//
//   dist1[b, i] = min_j |a_i - b_j|^2, idx1 = argmin (lowest j on ties)
//   dist2[b, j] = min_i |b_j - a_i|^2, idx2 = argmin (lowest i on ties)
//
// Rounding: every distance is ((dx*dx + dy*dy) + dz*dz) with each operation
// rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn). nvcc would otherwise
// contract a*b+c into an FMA, which changes distances in the last bit and can
// flip near-tie argmins against the plain version. With this, distances are
// bitwise equal to ref.chamfer_distance's on the card (eager torch
// elementwise ops are not fused).
//
// What bounds it on an H100: instruction issue. Each pair costs 8 separately
// rounded fp32 operations for its distance and a min a direction; at the
// slice's shape (B=32, N=M=2048) that is 134 M pairs against 24 KB of points
// a cloud in device memory, and the N x M matrix never exists. Design: both
// directions in one pass, each distance computed once.
//   * Rows: the larger cloud ("rows", a if N >= M), 256 a block (8 warps),
//     8 a lane in registers; the other cloud ("columns") staged as float4 in
//     shared memory, 2048 columns a tile, every lane reading 4 columns a
//     step of 32 (lane = ry * 8 + cx: rows ry * 8 + [0, 8) of its warp's 32,
//     columns cx + 8 q of the step; 8 lanes read 8 consecutive float4, no
//     bank conflict). A step is 32 distances a lane, each tile column read
//     once a lane for 8 rows.
//   * Row minima: a running min (fminf), and the step where it last fell.
//     At the end the 8 lanes sharing a row take the min and, among the
//     lanes that hold it, the first step; the lanes recompute that step's
//     32 distances and the lowest column equal to the min is the argmin.
//     fminf of exact values is exact, and the first step holding the min
//     holds its lowest index, so dist1/idx1 are the plain version's.
//   * Column minima: each lane the min over its 8 rows, then over the 4
//     lanes of the warp that share the column (shuffles), one value a warp
//     and column in shared memory; after the tile, the block's min and the
//     first warp holding it, one int2 a column and row block in `part`.
//     A second kernel takes, per column, the min over the row blocks, the
//     first row block and warp holding it, and recomputes that warp's 32
//     distances (a lane a row, a ballot) for the lowest row equal to the
//     min: dist2/idx2.
// Min and argmin with the lowest index on ties are functions of the set of
// distances, so no tiling or order of combining changes a bit. A min equal
// to +inf (overflowing coordinates) takes index 0, as a running `d < best`
// from +inf does. Rows past the cloud's end read as +inf points.
//
// Chamfer backward: replaces `_chamfer_grad_mxu` / `_chamfer_grad_mxu_kernel`
// (pallas_kernels.py:333 and :270), the default backward of `_chamfer_bwd`
// :417. For one side p of the pair (p, q), with the argmins ip (p -> q) and
// iq (q -> p) and the cotangents gp, gq of the two distance vectors:
//
//   dp[i] = 2 gp[i] (p[i] - q[ip[i]]) - sum_{j: iq[j] = i} 2 gq[j] (q[j] - p[i])
//
// (the XLA form of :442-450). The TPU kernel builds both terms as one-hot
// MXU products, accumulating over its grid in order. Here the scatter term
// is a gather: the wrapper's call first builds the reverse list of iq
// (reverse_list.cu), then a thread a point i of p takes the gather term at
// its own row and subtracts the sum of the q terms that name i, taken in
// ascending j, with one plain store: no atomics, so two runs are bitwise
// equal. A random-weight prediction sends many gt points to a few of its
// points, so a list longer than eight entries is summed by the whole warp,
// 32 terms a step, in the same order. (On VRCNet's step on an H100 a thread
// a point alone took 11x the atomic form's device time, a warp a point
// 3.7x, eight lanes a point, diverging over their lists, 8.4x.) Each term is (2 g) * (p - q),
// rounded as ops/ref.py rounds it, and the sum is taken in the order
// ref.py's scatter takes it on the CPU. The wrapper launches it only for a
// side whose gradient is asked for: `calc_cd(pred, gt)` needs the
// prediction side alone. An index outside its cloud makes the gather term
// NaN at the point's own row, or is listed under row 0 (scatter term),
// whose thread adds NaN, instead of reading out of bounds.
//
// What bounds it: bytes, and the list's serial steps. At VRCNet's step (B
// 64, 3072 predicted against 2048 gt points) it reads 3.2 MB and writes
// 2.4 MB (~0.002 ms at 3.35 TB/s); the lists' lengths follow the
// prediction, and a warp takes a long one 32 entries at a time.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "reverse_list.h"
#include "smem_opt_in.h"

namespace {

constexpr int kLaneRows = 8;                     // rows a lane
constexpr int kLaneCols = 4;                     // columns a lane a step
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kWarpRows = 4 * kLaneRows;         // 4 row groups (ry) a warp
constexpr int kBlockRows = kFwdWarps * kWarpRows;   // 256
constexpr int kStepCols = 8 * kLaneCols;         // 8 column groups (cx): 32
constexpr int kTileCols = 2048;                  // columns staged a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqdist(float px, float py, float pz, float qx,
                                        float qy, float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// rows (B, nr, 3), cols (B, nc, 3): dist/idx (B, nr) of the rows, and
// part (B, ceil(nr / 256), nc): each row block's column min (as bits) and
// the first of its warps holding it.
__global__ void __launch_bounds__(kFwdThreads, 2)
chamfer_fused_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                     int nr, int nc, float* __restrict__ dist, int* __restrict__ idx,
                     int2* __restrict__ part) {
  extern __shared__ float4 tile[];                                // kTileCols
  float* colpart = reinterpret_cast<float*>(tile + kTileCols);   // warps x kTileCols
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ry = lane >> 3;
  const int cx = lane & 7;
  const int b = blockIdx.y;
  const int rb = blockIdx.x;
  const float* p = rows + static_cast<size_t>(b) * nr * 3;
  const float* q = cols + static_cast<size_t>(b) * nc * 3;
  const int row0 = rb * kBlockRows + warp * kWarpRows + ry * kLaneRows;

  float* col = colpart + warp * kTileCols + cx;   // this lane's column slots
  float px[kLaneRows], py[kLaneRows], pz[kLaneRows], best[kLaneRows];
  int bstep[kLaneRows];
#pragma unroll
  for (int k = 0; k < kLaneRows; ++k) {
    const int r = row0 + k;
    const bool live = r < nr;
    px[k] = live ? p[3 * r] : CUDART_INF_F;
    py[k] = live ? p[3 * r + 1] : CUDART_INF_F;
    pz[k] = live ? p[3 * r + 2] : CUDART_INF_F;
    best[k] = CUDART_INF_F;
    bstep[k] = 0;
  }

  for (int t0 = 0; t0 < nc; t0 += kTileCols) {
    const int tcols = min(kTileCols, nc - t0);
    const int steps = (tcols + kStepCols - 1) / kStepCols;
    __syncthreads();                  // the last tile's reads are done
    for (int c = tid; c < steps * kStepCols; c += kFwdThreads) {
      tile[c] = c < tcols
          ? make_float4(q[3 * (t0 + c)], q[3 * (t0 + c) + 1], q[3 * (t0 + c) + 2], 0.f)
          : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      float4 c4[kLaneCols];
#pragma unroll
      for (int u = 0; u < kLaneCols; ++u) c4[u] = tile[s * kStepCols + cx + 8 * u];
      float cmin[kLaneCols];
      const int gstep = t0 / kStepCols + s;
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        float d[kLaneCols];
#pragma unroll
        for (int u = 0; u < kLaneCols; ++u) {
          d[u] = sqdist(px[k], py[k], pz[k], c4[u].x, c4[u].y, c4[u].z);
          cmin[u] = k == 0 ? d[u] : fminf(cmin[u], d[u]);
        }
        const float m = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        if (m < best[k]) {
          best[k] = m;
          bstep[k] = gstep;
        }
      }
      float* cp = col + s * kStepCols;
#pragma unroll
      for (int u = 0; u < kLaneCols; ++u) {
        float c = cmin[u];
        c = fminf(c, __shfl_xor_sync(kFull, c, 8));
        c = fminf(c, __shfl_xor_sync(kFull, c, 16));
        if (ry == 0) cp[8 * u] = c;
      }
    }
    __syncthreads();
    int2* out = part + (static_cast<size_t>(b) * gridDim.x + rb) * nc + t0;
    for (int c = tid; c < tcols; c += kFwdThreads) {
      float m = colpart[c];
      int w = 0;
#pragma unroll
      for (int v = 1; v < kFwdWarps; ++v) {
        const float x = colpart[v * kTileCols + c];
        if (x < m) {
          m = x;
          w = v;
        }
      }
      out[c] = make_int2(__float_as_int(m), w);
    }
  }

  // the rows: min over the 8 lanes of the row, the first step holding it,
  // then the lowest column of that step at the min
#pragma unroll
  for (int k = 0; k < kLaneRows; ++k) {
    float m = best[k];
    int s = bstep[k];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float om = __shfl_xor_sync(kFull, m, off);
      const int os = __shfl_xor_sync(kFull, s, off);
      if (om < m || (om == m && os < s)) {
        m = om;
        s = os;
      }
    }
    int j_at = 0x7fffffff;
#pragma unroll
    for (int u = kLaneCols - 1; u >= 0; --u) {
      const int j = s * kStepCols + cx + 8 * u;
      if (j < nc && sqdist(px[k], py[k], pz[k], q[3 * j], q[3 * j + 1], q[3 * j + 2]) == m) {
        j_at = j;
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) j_at = min(j_at, __shfl_xor_sync(kFull, j_at, off));
    const int r = row0 + k;
    if (cx == 0 && r < nr) {
      dist[static_cast<size_t>(b) * nr + r] = m;
      idx[static_cast<size_t>(b) * nr + r] = m < CUDART_INF_F ? j_at : 0;
    }
  }
}

// dist/idx (B, nc) of the columns from `part` (B, blocks, nc): a warp takes
// 32 columns, a lane a column for the min over the row blocks and the first
// block and warp holding it; then for each of the 32 columns in turn the
// lanes take that warp's 32 rows, one a lane (one coalesced load), and the
// lowest row at the min comes from a ballot.
__global__ void __launch_bounds__(256)
chamfer_columns_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                       const int2* __restrict__ part, int batch, int nr, int nc,
                       int blocks, float* __restrict__ dist, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int per_cloud = (nc + 31) / 32;
  const int b = gw / per_cloud;
  if (b >= batch) return;                    // the whole warp
  const int j = (gw - b * per_cloud) * 32 + lane;
  const bool live = j < nc;
  float m = CUDART_INF_F;
  int r0 = 0;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const int2* pb = part + static_cast<size_t>(b) * blocks * nc + j;
    int2 at = pb[0];
    int at_block = 0;
    for (int v = 1; v < blocks; ++v) {
      const int2 x = pb[static_cast<size_t>(v) * nc];
      if (__int_as_float(x.x) < __int_as_float(at.x)) {
        at = x;
        at_block = v;
      }
    }
    m = __int_as_float(at.x);
    r0 = at_block * kBlockRows + at.y * kWarpRows;
    const float* qj = cols + (static_cast<size_t>(b) * nc + j) * 3;
    qx = qj[0];
    qy = qj[1];
    qz = qj[2];
  }
  const float* p = rows + static_cast<size_t>(b) * nr * 3;
  int i_at = 0;
#pragma unroll 4
  for (int c = 0; c < 32; ++c) {
    const float mc = __shfl_sync(kFull, m, c);
    const int r = __shfl_sync(kFull, r0, c) + lane;
    const float cx = __shfl_sync(kFull, qx, c);
    const float cy = __shfl_sync(kFull, qy, c);
    const float cz = __shfl_sync(kFull, qz, c);
    const bool hit = mc < CUDART_INF_F && r < nr &&
                     sqdist(p[3 * r], p[3 * r + 1], p[3 * r + 2], cx, cy, cz) == mc;
    const unsigned at = __ballot_sync(kFull, hit);
    if (lane == c && at != 0u) i_at = r - lane + __ffs(at) - 1;
  }
  if (live) {
    dist[static_cast<size_t>(b) * nc + j] = m;
    idx[static_cast<size_t>(b) * nc + j] = i_at;
  }
}

size_t fused_smem() {
  return kTileCols * sizeof(float4) + kFwdWarps * kTileCols * sizeof(float);
}

constexpr int kBwdThreads = 256;

// dp (B, np, 3): a thread a point i of p takes the gather term at its own
// row and subtracts the sum, ascending over its list of iq (B, nq), of the
// q terms that name it. A list longer than kShort is summed by the whole
// warp, 32 terms a step, every lane adding them in list order (the same
// order a thread takes), one such list at a time. `rows` = B np.
constexpr int kShort = 8;

__global__ void __launch_bounds__(kBwdThreads)
chamfer_backward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                        const int* __restrict__ ip, const float* __restrict__ gp,
                        const int* __restrict__ iq, const float* __restrict__ gq,
                        const int* __restrict__ order, const int* __restrict__ off,
                        int np, int nq, int rows, float* __restrict__ dp) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBwdThreads + threadIdx.x;
  const bool live = row < rows;                      // no early exit: shuffles below
  const int b = live ? row / np : 0;
  const int i = live ? row - b * np : 0;
  float pi[3], s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pi[c] = live ? p[3 * static_cast<size_t>(row) + c] : 0.f;
    s[c] = 0.f;
  }
  const int begin = live ? off[row] : 0;
  const int end = live ? off[row + 1] : 0;
  // 2 gq[j] (q[j] - p[i]) for entry t of the cloud b row (b, i) lists
  auto term = [&](int t, int tb, int ti, const float (&tp)[3], float (&v)[3]) {
    const int e = order[t];                          // tb nq + j
    const int j = e - tb * nq;
    const bool ok = ti != 0 || (iq[e] >= 0 && iq[e] < np);  // row 0 lists bad ones
    const float coef = __fmul_rn(2.f, gq[e]);
    const float* qj = q + (static_cast<size_t>(tb) * nq + j) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = ok ? __fmul_rn(coef, __fsub_rn(qj[c], tp[c])) : CUDART_NAN_F;
    }
  };
  if (end - begin <= kShort) {
    for (int t = begin; t < end; ++t) {
      float v[3];
      term(t, b, i, pi, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = __fadd_rn(s[c], v[c]);
    }
  }
  for (unsigned longs = __ballot_sync(full, end - begin > kShort); longs != 0;
       longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const int lb = __shfl_sync(full, begin, src), le = __shfl_sync(full, end, src);
    const int tb = __shfl_sync(full, b, src), ti = __shfl_sync(full, i, src);
    float tp[3], acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) tp[c] = __shfl_sync(full, pi[c], src);
    for (int t0 = lb; t0 < le; t0 += 32) {
      float v[3] = {0.f, 0.f, 0.f};
      if (t0 + lane < le) term(t0 + lane, tb, ti, tp, v);
      const int count = min(32, le - t0);
      for (int u = 0; u < count; ++u) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = __fadd_rn(acc[c], __shfl_sync(full, v[c], u));
      }
    }
    if (lane == src) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = acc[c];
    }
  }
  if (!live) return;
  const int j = ip[row];                             // 2 gp[i] (p[i] - q[ip[i]])
  const float coef = __fmul_rn(2.f, gp[row]);
  const float* qb = q + static_cast<size_t>(b) * nq * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = j >= 0 && j < nq
        ? __fmul_rn(coef, __fsub_rn(pi[c], qb[3 * j + c]))
        : CUDART_NAN_F;
    dp[3 * static_cast<size_t>(row) + c] = __fsub_rn(v, s[c]);
  }
}

}  // namespace

extern "C" {

// a (B, N, 3), b (B, M, 3) float32 contiguous on the device; outputs
// d1/i1 (B, N), d2/i2 (B, M); part, scratch of B * ceil(max(N, M) / 256) *
// min(N, M) int2 (chamfer_part_entries). The larger cloud (a when N >= M)
// takes the rows. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
int chamfer_forward(const float* a, const float* b, int batch, int n, int m,
                    float* d1, int* i1, float* d2, int* i2, void* part,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_rows = n >= m;
  const float* rows = a_rows ? a : b;
  const float* cols = a_rows ? b : a;
  const int nr = a_rows ? n : m, nc = a_rows ? m : n;
  const int blocks = (nr + kBlockRows - 1) / kBlockRows;
  const size_t smem = fused_smem();
  static SmemOptIn opted;
  cudaError_t err = opted.raise(reinterpret_cast<const void*>(chamfer_fused_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int2* p = static_cast<int2*>(part);
  chamfer_fused_kernel<<<dim3(blocks, batch), kFwdThreads, smem, s>>>(
      rows, cols, nr, nc, a_rows ? d1 : d2, a_rows ? i1 : i2, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = batch * ((nc + 31) / 32) * 32;
  chamfer_columns_kernel<<<(threads + 255) / 256, 256, 0, s>>>(
      rows, cols, p, batch, nr, nc, blocks, a_rows ? d2 : d1, a_rows ? i2 : i1);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of one side: p (B, NP, 3), q (B, NQ, 3) float32, ip/gp
// (B, NP), iq/gq (B, NQ) (int32 / float32), all contiguous on the device;
// the reverse list of iq (reverse_list.cu: `list_warps`, `ranges`, order
// (B NQ), off (B NP + 1)) -> dp (B, NP, 3). For da of chamfer_forward(a, b) pass
// (a, b, i1, g1, i2, g2); for db, (b, a, i2, g2, i1, g1). Launches on
// `stream` without synchronising; returns cudaGetLastError().
int chamfer_backward(const float* p, const float* q, const int* ip,
                     const float* gp, const int* iq, const float* gq,
                     int batch, int np, int nq, int list_warps, int ranges,
                     int* order, int* off, float* dp, void* stream) {
  if (batch == 0 || np == 0) return 0;
  const int err = reverse_list_build(iq, batch, nq, np, list_warps, ranges, order,
                                     off, stream);
  if (err != 0) return err;
  const int rows = batch * np;
  chamfer_backward_kernel<<<(rows + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, q, ip, gp, iq, gq, order, off, np, nq, rows, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
