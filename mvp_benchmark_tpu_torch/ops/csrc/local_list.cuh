// The reverse list of a block's rows, built in shared memory inside the
// kernel that walks it (gather.cu's group_max_backward, chamfer.cu's
// backward): no list in device memory, no second launch. gather.cu's
// scatter_add_rows_local_kernel lists the same way in code of its own: through
// this helper it read 14-20% slower at ECG's and VRCNet's centre gathers
// on an H100.
//
// A block takes the rows [r0, r0 + m) of one cloud and a chunk of the
// cloud's entries, [e0, e0 + len), each naming a row. It places every entry
// of its rows in list order: row by row, and within a row ascending, so a
// row summed in list order is summed in ascending entry order (the order
// ops/ref.py's scatters sum in on the CPU). Each warp holds a contiguous
// segment of the chunk, `steps` entries a lane (32 s + lane, step s), at
// most kListSteps of them in registers at once: a longer segment (where the
// caller asks for batches) is walked in batches, its rows read again for
// the placing pass. Pass 1 counts each
// warp's entries of each row in shared memory with integer atomicAdd (the
// same in any order); pass 2 scans the counts, rows in order and, within a
// row, warps in order, into each (warp, row)'s first slot and each row's
// first slot `first`; pass 3 places each warp's entries step by step, a
// step's entries of one row in lane order (their rank among the step's
// lower lanes naming that row, __match_any_sync and __popc). The slots are
// a function of the index alone, so every run builds the same list.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kListFull = 0xffffffffu;
constexpr int kListSteps = 16;          // entries a lane holds at once

// The ints of shared memory build_list takes before the caller's list:
// `warps` counts a row, each row's first slot and the end, the warps' totals.
__host__ __device__ constexpr int list_ints(int warps, int m) {
  return warps * m + m + 1 + warps;
}

// `row(e, bad)` gives entry e's row less r0 where it is one of the block's
// rows, else -1 (an index outside the table counts as row 0, bad set);
// `place(slot, e, bad, q)` stores entry e, of row q, at list slot `slot`.
// `smem` holds list_ints(warps, m) ints; on return (after a barrier) row q's
// slots are [first[q], first[q + 1]), first = smem + warps m. Without
// kBatches the caller's plan keeps len <= 32 warps kListSteps: one batch,
// no loop around the passes.
template <bool kBatches, class Row, class Place>
__device__ __forceinline__ void build_list(Row row, Place place, int e0, int len, int m,
                                           int* smem) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* cnt = smem;                        // (warps, m): counts, then slots
  int* first = cnt + warps * m;           // (m + 1)
  int* warp_total = first + m + 1;        // (warps)
  for (int t = threadIdx.x; t < warps * m; t += blockDim.x) cnt[t] = 0;
  const int steps = (len + 32 * warps - 1) / (32 * warps);
  const int batches = kBatches ? (steps + kListSteps - 1) / kListSteps : 1;
  const int seg = e0 + warp * 32 * steps + lane;
  const int end = e0 + len;
  int key[kListSteps];                    // the entry's row less r0; -1 if not the block's
  unsigned bad = 0;
#pragma unroll
  for (int s = 0; s < kListSteps; ++s) {
    const int e = seg + 32 * s;
    bool b = false;
    key[s] = s < steps && e < end ? row(e, b) : -1;
    bad |= static_cast<unsigned>(b) << s;
  }
  __syncthreads();                        // the counts zeroed
  int* wc = cnt + warp * m;
#pragma unroll
  for (int s = 0; s < kListSteps; ++s) {
    if (key[s] >= 0) atomicAdd(wc + key[s], 1);     // an integer count
  }
  for (int bt = 1; bt < batches; ++bt) {  // a longer segment, a batch at a time
#pragma unroll
    for (int s = 0; s < kListSteps; ++s) {
      const int e = seg + 32 * (bt * kListSteps + s);
      bool b = false;
      key[s] = bt * kListSteps + s < steps && e < end ? row(e, b) : -1;
    }
#pragma unroll
    for (int s = 0; s < kListSteps; ++s) {
      if (key[s] >= 0) atomicAdd(wc + key[s], 1);
    }
  }
  __syncthreads();

  // rows [q0, q1) a thread: their totals over the warps, a block exclusive
  // scan, then each (warp, q) count becomes that warp's first slot of q
  const int rp = (m + blockDim.x - 1) / blockDim.x;
  const int q0 = min(m, static_cast<int>(threadIdx.x) * rp);
  const int q1 = min(m, q0 + rp);
  int sum = 0;
  for (int q = q0; q < q1; ++q) {
    for (int w = 0; w < warps; ++w) sum += cnt[w * m + q];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kListFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int q = q0; q < q1; ++q) {
    first[q] = run;
    for (int w = 0; w < warps; ++w) {
      const int v = cnt[w * m + q];
      cnt[w * m + q] = run;
      run += v;
    }
  }
  if (q0 < q1 && q1 == m) first[m] = run;
  __syncthreads();

  const unsigned lower = (1u << lane) - 1u;
  for (int bt = 0; bt < batches; ++bt) {
    const int s0 = bt * kListSteps;
    if (batches > 1) {                    // the same on every lane: read again
      bad = 0;
#pragma unroll
      for (int s = 0; s < kListSteps; ++s) {
        const int e = seg + 32 * (s0 + s);
        bool b = false;
        key[s] = s0 + s < steps && e < end ? row(e, b) : -1;
        bad |= static_cast<unsigned>(b) << s;
      }
    }
#pragma unroll
    for (int s = 0; s < kListSteps; ++s) {
      if (s0 + s < steps) {               // the same on every lane
        const int q = key[s];
        const unsigned peers = __match_any_sync(kListFull, q);
        if (q >= 0) {
          place(wc[q] + __popc(peers & lower), seg + 32 * (s0 + s), (bad >> s) & 1u, q);
        }
        __syncwarp();
        if (q >= 0 && lane == __ffs(peers) - 1) wc[q] += __popc(peers);
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

}  // namespace
