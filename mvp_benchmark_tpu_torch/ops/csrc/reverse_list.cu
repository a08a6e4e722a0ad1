// Reverse lists for Hopper (sm_90a): the index bookkeeping that turns the
// completion backwards' scatters into gathers summed in a fixed order, with
// a plain C interface for ctypes.
//
// Replaces no TPU kernel. The TPU kernels behind those scatters
// (mvp_benchmark_tpu/ops/pallas_kernels.py: `_chamfer_grad_mxu` :333,
// `_group_max_bwd_rule` :928, `_ti_bwd_rule` :1086, `_sa_bwd` :1417 and
// `scatter_add_rows` :1613) add one-hot-transposed MXU products into output
// blocks that their grid revisits in order, which is deterministic. GPU
// blocks run in no order, so each of those backwards here first builds the
// reverse list of its index and then gathers: every output row sums its
// incoming terms in ascending source order with plain stores and no float
// atomics, so two runs are bitwise equal.
//
// The list: for idx (B, E) int32 (E entries a cloud, each naming a row in
// [0, n)), order (B E) and off (B n + 1) int32 with
//
//   order[off[b n + r] .. off[b n + r + 1]) = the entries b E + e with
//                                             idx[b, e] == r, ascending,
//
// a stable counting sort of each cloud, equal bitwise to ops/ref.py
// `reverse_list`. An entry outside [0, n) is listed under row 0 of its
// cloud, whose gather reads its index and adds NaN there.
//
// Design: a block a cloud and range of rows, W warps a block (the host plan
// `kernels.reverse_list_plan`: about 16 steps of 32 entries a warp, at most
// 32 warps, and `ranges` ranges of ceil(n / ranges) rows, as few as let the
// W warps count every row of theirs in shared memory), each warp a
// contiguous range of the cloud's entries. Pass 1: each warp counts the
// entries of its range that fall in the block's rows, 32 a step, with
// integer atomicAdd into its own counts (the one atomic here: an integer
// count is the same in any order), and the entries below the block's rows.
// Pass 2: a block scan turns the counts into each warp's first slot of
// each row, rows in order and, within a row, warps in order, after the
// entries below. Pass 3: each warp walks its range again and places an
// entry of the block's rows at its row's slot plus its rank among the
// step's lower lanes naming the same row, found with one ballot a bit of
// the row. Ranges ascend with the warp and each is walked in order, so
// every row lists its entries ascending, and each slot is a function of the
// index alone: every run builds the same list. (A first form, one block a
// cloud with as many warps as fit and `__match_any_sync` ranks, took 0.159
// ms at the shape below on an H100.)
//
// What bounds it on an H100: the serial steps of a warp, not bytes. At the
// SA block's level 1 in VRCNet's train step (B 64, 3072 x 16 entries into
// 3072 rows) two blocks a cloud of 32 warps take 1536 rows each, 128
// blocks, each warp 1536 entries, 48 steps a pass; the blocks read idx
// four times (50 MB)
// and write order and off once (13 MB, 4 us at 3.35 TB/s). A warp loads 16
// steps' rows at once, so it waits on memory once in 16 steps.

#include <cuda_runtime.h>

#include "reverse_list.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kBatch = 16;  // steps whose rows a warp loads at once

// The lanes of the warp whose `r` equals this lane's, for 0 <= r < 2^bits:
// one ballot a bit.
__device__ __forceinline__ unsigned same_row(int r, int bits) {
  unsigned peers = kFull;
  for (int i = 0; i < bits; ++i) {
    const bool one = (r >> i) & 1;
    const unsigned set = __ballot_sync(kFull, one);
    peers &= one ? set : ~set;
  }
  return peers;
}

// Row of entry value v: v in [0, n), else 0; -1 past the range's end.
__device__ __forceinline__ int row_of(const int* ib, int e, int hi, int n) {
  const int v = e < hi ? ib[e] : -1;
  return e < hi ? (v >= 0 && v < n ? v : 0) : -1;
}

// grid (ranges, B), W warps; shared memory W * rows_a_range ints.
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
reverse_list_kernel(const int* __restrict__ idx, int entries, int n,
                    int* __restrict__ order, int* __restrict__ off) {
  extern __shared__ int cnt[];           // (W, nr): this block's rows
  __shared__ int warp_total[kMaxWarps];
  __shared__ int warp_below[kMaxWarps];
  const int b = blockIdx.y;
  const int nr = (n + gridDim.x - 1) / gridDim.x;
  const int r0 = min(n, static_cast<int>(blockIdx.x) * nr);
  const int r1 = min(n, r0 + nr);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < warps * nr; t += blockDim.x) cnt[t] = 0;
  __syncthreads();

  // Pass 1: each warp counts its range [lo, hi) of the cloud's entries: the
  // ones in [r0, r1) by row, the ones below r0 in all.
  const int* ib = idx + static_cast<long long>(b) * entries;
  const int per = (entries + warps - 1) / warps;
  const int lo = min(entries, warp * per), hi = min(entries, lo + per);
  int* wc = cnt + warp * nr;
  int below = 0;
  for (int e0 = lo; e0 < hi; e0 += 32 * kBatch) {
    int r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) r[u] = row_of(ib, e0 + 32 * u + lane, hi, n);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] >= r0 && r[u] < r1) atomicAdd(wc + (r[u] - r0), 1);
      below += r[u] >= 0 && r[u] < r0;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (lane == 0) warp_below[warp] = below;
  __syncthreads();

  // Pass 2: rows [q0, q1) of the block's a thread; their totals over the
  // warps, a block exclusive scan of those, then each (warp, row) count
  // becomes its slot.
  int start = 0;                         // the cloud's entries below r0
  for (int w = 0; w < warps; ++w) start += warp_below[w];
  const int rp = (nr + blockDim.x - 1) / blockDim.x;
  const int q0 = min(r1 - r0, static_cast<int>(threadIdx.x) * rp);
  const int q1 = min(r1 - r0, q0 + rp);
  int sum = 0;
  for (int q = q0; q < q1; ++q) {
    for (int w = 0; w < warps; ++w) sum += cnt[w * nr + q];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < warps ? warp_total[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += x;
    }
    warp_total[lane] = v;                // inclusive over the warps
  }
  __syncthreads();
  const long long base = static_cast<long long>(b) * entries;
  int run = start + incl - sum + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int q = q0; q < q1; ++q) {
    off[static_cast<long long>(b) * n + r0 + q] = static_cast<int>(base) + run;
    for (int w = 0; w < warps; ++w) {
      const int v = cnt[w * nr + q];
      cnt[w * nr + q] = run;
      run += v;
    }
  }
  if (b == gridDim.y - 1 && r1 == n && threadIdx.x == 0) {
    off[static_cast<long long>(gridDim.y) * n] = static_cast<int>(base + entries);
  }
  __syncthreads();

  // Pass 3: each warp places the entries of its range in [r0, r1), a row's
  // lanes in lane order; `nr` marks an entry outside them.
  const unsigned lower = (1u << lane) - 1u;
  const int bits = 32 - __clz(nr);
  for (int e0 = lo; e0 < hi; e0 += 32 * kBatch) {
    int q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = row_of(ib, e0 + 32 * u + lane, hi, n);
      q[u] = r >= r0 && r < r1 ? r - r0 : nr;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!__any_sync(kFull, q[u] < nr)) continue;
      const unsigned peers = same_row(q[u], bits);
      const bool mine = q[u] < nr;
      const int at = mine ? wc[q[u]] + __popc(peers & lower) : 0;
      __syncwarp();
      if (mine) {
        order[base + at] = static_cast<int>(base) + e0 + 32 * u + lane;
        if (lane == __ffs(peers) - 1) wc[q[u]] += __popc(peers);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// idx (B, entries) int32 into n rows a cloud; `ranges` blocks a cloud,
// each with `warps` warps counting ceil(n / ranges) rows in shared memory
// -> order (B entries) and off (B n + 1) int32. B entries must fit in
// int32. Launches on `stream` without synchronising; returns
// cudaGetLastError(), or cudaErrorInvalidValue outside those limits.
extern "C" int reverse_list_build(const int* idx, int batch, int entries, int n,
                                  int warps, int ranges, int* order, int* off,
                                  void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || entries < 0 || warps < 1 ||
      warps > kMaxWarps || ranges < 1 || ranges > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * warps * ((n + ranges - 1) / ranges);
  cudaError_t err = cudaFuncSetAttribute(
      reverse_list_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  reverse_list_kernel<<<dim3(ranges, batch), warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(idx, entries, n,
                                                             order, off);
  return static_cast<int>(cudaGetLastError());
}
