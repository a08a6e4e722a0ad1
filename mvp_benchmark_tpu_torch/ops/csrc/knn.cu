// Exact k-nearest-neighbour search for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel `knn_pallas` / `_knn_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:714 and :522), behind
// `knn_indices`, `knn_points` and three_nn (`dispatch.py:84-104`). It
// computes what that kernel approximates, not its form:
//
//   dist[b, i, s], idx[b, i, s] = the s-th nearest point of query i,
//   s < k, nearest first, ties to the lower point index,
//
// with d = sum_c (q_c - p_c)^2 over any channel count C. The Pallas kernel
// packs distance and index into one int32 key (quantising distances to
// ~5e-4 relative) and switches to a bf16x2 matmul expansion for C > 8; this
// kernel selects on exact fp32 distances at every C, the semantics of the
// reference CUDA op and of `ops/ref.py`'s stable sort.
//
// Rounding: diff = q - p, then d = d + diff * diff in channel order, each
// operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn, no FMA
// contraction). Distances are then bitwise equal to ref.knn's on the card.
//
// What bounds it on an H100: issued instructions. Under the rounding rule a
// channel costs 3 fp32 instructions a pair (sub, mul, add), so (B 32,
// 3072 x 3072, C 24) is 302 M pairs x 72 = 21.7 G thread-instructions,
// ~0.65 ms at the fp32 issue rate (33.5 T instructions/s), against 19 MB of
// inputs (0.006 ms at 3.35 TB/s). At C = 3 a pair is 8 instructions, and
// inserting each hit into a top 16 at once would cost more: a candidate that
// beats a row's 16th distance runs a 16-step insertion while the other 31
// lanes of the warp wait, and at random order that happens on most of a
// warp's first ~500 candidates. Two kernels:
//
// `knn_queue_kernel` (k > 3 and more than 64 candidates; ops/kernels.py
// `knn_plan` chooses):
// - Threshold first, batched insertion. Each row keeps a sorted top-K list
//   (distance, index) in registers. A candidate whose distance is below the
//   row's threshold (the list's K-th distance at the last merge) is only
//   appended to the row's queue in shared memory (a predicated store).
//   Every kVote candidates the warp checks whether some lane's queue could
//   overflow (`__any_sync`), and only then, and at the end, the warp merges
//   the queues into the lists in lockstep: each queued candidate, in the
//   order queued (ascending index), enters if it is below the list's
//   current K-th distance and goes after the entries equal to it. That is
//   exactly the sequential scan's result (ties to the lower index), with
//   one insertion per queued hit and the lanes inserting together.
// - R query rows a thread (the launch plan's R; 2 at C = 24, where one
//   16-byte shared load of a candidate then feeds two rows' 12 products).
// - Candidate tiles of at most 8 KB (C = 3 padded to float4), double-
//   buffered with cp.async, so that the next tile's load overlaps the scan
//   of this one and a block leaves room for many on an SM.
//
// `knn_direct_kernel` (k <= 3, and scans of at most 64 candidates): one
// row a thread, the list updated at once on a hit (a 3-step insertion), the
// other cloud staged 24 KB at a time. At k = 3 hits are rare (~3 ln(N/3) a
// row) and cheap: the queue kernel, with one row a thread or more, read
// slower than this form at most three_nn shapes of the paths
// (probe_knn_fps.py's sweeps; PERF.md).
//
// The query rows sit in registers for the path's widths (C = 3, 24, 48,
// templated) and are read from global memory otherwise; K is templated
// (3, 16, and 32 for any k <= 32, whose first k entries are the top k).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;           // threads a block
constexpr int kQueue = 16;              // queued candidates a row
constexpr int kVote = 4;                // candidates between two queue checks
constexpr int kTileBytes = 8192;        // a queue kernel's tile, at most
constexpr int kDirectTileFloats = 6144; // the direct kernel's tile, 24 KB

template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int j) {
  // Precondition: d < bd[K-1]. Entries greater than d move down one slot;
  // d goes right after the last entry <= d.
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s - 1] > d) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (bd[s] > d) {
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (bd[0] > d) {
    bd[0] = d;
    bi[0] = j;
  }
}

__device__ __forceinline__ float add_sq(float d, float q, float p) {
  const float diff = __fsub_rn(q, p);
  return __fadd_rn(d, __fmul_rn(diff, diff));
}

__device__ __forceinline__ float first_sq(float q, float p) {
  const float diff = __fsub_rn(q, p);
  return __fmul_rn(diff, diff);  // == 0 + diff * diff, exactly
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Append (d, j) at the shared address `a`.
__device__ __forceinline__ void queue_store(unsigned a, float d, int j) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(d),
               "f"(__int_as_float(j)));
}

// Floats a staged point takes: C = 3 is padded to a float4.
__host__ __device__ constexpr int staged_width(int c, int dim) {
  return c == 3 ? 4 : (c > 0 ? c : dim);
}

// Points a tile buffer holds: a multiple of kVote, at most kTileBytes (at
// least kVote points) and no more than the cloud needs.
inline int tile_points(int width, int np) {
  int pts = (kTileBytes / 4 / width) / kVote * kVote;
  pts = pts > kVote ? pts : kVote;
  const int need = (np + kVote - 1) / kVote * kVote;
  return need < pts ? need : pts;
}

// Start copying points [j0, j0 + n) of `p` (width `c` floats a point) into
// `tile` (`w` floats a point), and set the points up to the next multiple of
// kVote to NaN, so that they never enter a list.
__device__ __forceinline__ void load_tile(float* tile, const float* p, int j0,
                                          int n, int c, int w, bool vec16) {
  const float* src = p + static_cast<size_t>(j0) * c;
  if (vec16) {  // c == w, c % 4 == 0, 16-byte aligned
    for (int t = threadIdx.x; t < n * c / 4; t += kThreads) {
      cp_async16(tile + 4 * t, src + 4 * t);
    }
  } else {
    for (int t = threadIdx.x; t < n * c; t += kThreads) {
      const int pt = t / c;
      cp_async4(tile + pt * w + (t - pt * c), src + t);
    }
  }
  const int pad = (n + kVote - 1) / kVote * kVote;
  for (int t = n * w + threadIdx.x; t < pad * w; t += kThreads) {
    tile[t] = CUDART_NAN_F;
  }
}

// Merge each row's queue (entries (distance, index bits), at the shared
// addresses from qbase[r] in steps of kThreads entries up to qend[r], in the
// order queued) into its sorted list, then reset the queue and the row's
// threshold.
template <int K, int R>
__device__ __forceinline__ void merge_queues(float (&bd)[R][K], int (&bi)[R][K],
                                             float (&thr)[R],
                                             unsigned (&qend)[R],
                                             const unsigned (&qbase)[R],
                                             const bool (&active)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (unsigned a = qbase[r]; a < qend[r]; a += kThreads * 8) {
      float d, j;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(d), "=f"(j) : "r"(a));
      if (d < bd[r][K - 1]) insert_sorted<K>(bd[r], bi[r], d, __float_as_int(j));
    }
    qend[r] = qbase[r];
    if (active[r]) thr[r] = bd[r][K - 1];
  }
}

// C > 0: the query rows are held in registers and the channel loop
// unrolled; C == 0: any channel count `dim`, the query rows read from global
// memory. Block (x, b) takes rows x * 128 * R + r * 128 + tid.
template <int K, int C, int R>
__global__ void __launch_bounds__(kThreads)
knn_queue_kernel(const float* __restrict__ query,
                 const float* __restrict__ points, int nq, int np, int dim,
                 int k_out, int tile_pts, bool vec16,
                 float* __restrict__ dist, int* __restrict__ idx) {
  constexpr int Q = kQueue;
  extern __shared__ __align__(16) float smem[];
  const int c_dim = C > 0 ? C : dim;
  const int w = staged_width(C, dim);
  float* tiles[2] = {smem, smem + tile_pts * w};
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const float* p = points + static_cast<size_t>(b) * np * c_dim;

  int row[R];
  bool active[R];
  float qr[R][C > 0 ? C : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = blockIdx.x * kThreads * R + r * kThreads + tid;
    active[r] = row[r] < nq;
    if constexpr (C > 0) {
      const float* q =
          query + (static_cast<size_t>(b) * nq + (active[r] ? row[r] : 0)) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) qr[r][c] = active[r] ? q[c] : 0.f;
    }
  }
  const float* qg =
      query + (static_cast<size_t>(b) * nq + (active[0] ? row[0] : 0)) * c_dim;

  float bd[R][K];
  int bi[R][K];
  float thr[R];        // the list's K-th distance at the last merge
  unsigned qbase[R];   // the row's queue: entry t at qbase + t * kThreads * 8
  unsigned qend[R];    // its next free entry
  const unsigned queue = shared_addr(smem + 2 * tile_pts * w) + tid * 8;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[r][s] = CUDART_INF_F;
      bi[r][s] = 0;
    }
    thr[r] = active[r] ? CUDART_INF_F : -1.f;  // an idle row queues nothing
    qbase[r] = queue + r * Q * kThreads * 8;
    qend[r] = qbase[r];
  }

  const int ntiles = (np + tile_pts - 1) / tile_pts;
  load_tile(tiles[0], p, 0, min(tile_pts, np), c_dim, w, vec16);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * tile_pts;
    if (t + 1 < ntiles) {
      const int j1 = j0 + tile_pts;
      load_tile(tiles[(t + 1) & 1], p, j1, min(tile_pts, np - j1), c_dim, w,
                vec16);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* tile = tiles[t & 1];
    const int n = min(tile_pts, np - j0);
    const int pad = (n + kVote - 1) / kVote * kVote;
    for (int j = 0; j < pad; j += kVote) {
#pragma unroll
      for (int u = 0; u < kVote; ++u) {
        const float* pt = tile + (j + u) * w;
        float d[R];
        if constexpr (C == 3) {
          const float4 v = *reinterpret_cast<const float4*>(pt);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            d[r] = add_sq(add_sq(first_sq(qr[r][0], v.x), qr[r][1], v.y),
                          qr[r][2], v.z);
          }
        } else if constexpr (C > 0 && C % 4 == 0) {
          const float4* pt4 = reinterpret_cast<const float4*>(pt);
#pragma unroll
          for (int r = 0; r < R; ++r) d[r] = 0.f;
#pragma unroll
          for (int c4 = 0; c4 < C / 4; ++c4) {
            const float4 v = pt4[c4];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              d[r] = c4 == 0 ? first_sq(qr[r][0], v.x)
                             : add_sq(d[r], qr[r][4 * c4], v.x);
              d[r] = add_sq(d[r], qr[r][4 * c4 + 1], v.y);
              d[r] = add_sq(d[r], qr[r][4 * c4 + 2], v.z);
              d[r] = add_sq(d[r], qr[r][4 * c4 + 3], v.w);
            }
          }
        } else if constexpr (C > 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            d[r] = first_sq(qr[r][0], pt[0]);
#pragma unroll
            for (int c = 1; c < C; ++c) d[r] = add_sq(d[r], qr[r][c], pt[c]);
          }
        } else {
          d[0] = first_sq(__ldg(qg), pt[0]);
          for (int c = 1; c < c_dim; ++c) d[0] = add_sq(d[0], __ldg(qg + c), pt[c]);
        }
        const int j_abs = j0 + j + u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (d[r] < thr[r]) {  // NaN (padding) never passes
            queue_store(qend[r], d[r], j_abs);
            qend[r] += kThreads * 8;
          }
        }
      }
      bool full = false;  // could a queue overflow within the next kVote?
#pragma unroll
      for (int r = 0; r < R; ++r) {
        full |= qend[r] - qbase[r] > (Q - kVote) * kThreads * 8;
      }
      if (__any_sync(0xffffffffu, full)) {
        merge_queues<K, R>(bd, bi, thr, qend, qbase, active);
      }
    }
    __syncthreads();  // before the next load overwrites this buffer
  }
  merge_queues<K, R>(bd, bi, thr, qend, qbase, active);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (active[r]) {
      const size_t o = (static_cast<size_t>(b) * nq + row[r]) * k_out;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s < k_out) {
          dist[o + s] = bd[r][s];
          idx[o + s] = bi[r][s];
        }
      }
    }
  }
}

// One row a thread, the whole candidate range: each candidate that beats the
// list's K-th distance enters at once (C > 0: the query row in registers;
// C == 0: any channel count `dim`, read from global memory).
template <int K, int C>
__global__ void __launch_bounds__(kThreads)
knn_direct_kernel(const float* __restrict__ query,
                  const float* __restrict__ points, int nq, int np, int dim,
                  int k_out, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ __align__(16) float tile[kDirectTileFloats];
  const int c_dim = C > 0 ? C : dim;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < nq;
  const float* q =
      query + (static_cast<size_t>(b) * nq + (active ? i : 0)) * c_dim;
  const float* p = points + static_cast<size_t>(b) * np * c_dim;

  float qr[C > 0 ? C : 1];
  if constexpr (C > 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) qr[c] = active ? q[c] : 0.f;
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  const int tile_pts = kDirectTileFloats / c_dim;
  for (int j0 = 0; j0 < np; j0 += tile_pts) {
    const int n = min(tile_pts, np - j0);  // ragged last tile
    const float* src = p + static_cast<size_t>(j0) * c_dim;
    for (int t = threadIdx.x; t < n * c_dim; t += kThreads) tile[t] = src[t];
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float* pt = tile + j * c_dim;
        float d;
        if constexpr (C > 0 && C % 4 == 0) {
          const float4* pt4 = reinterpret_cast<const float4*>(pt);
          d = 0.f;
#pragma unroll
          for (int c4 = 0; c4 < C / 4; ++c4) {
            const float4 v = pt4[c4];
            d = c4 == 0 ? first_sq(qr[0], v.x) : add_sq(d, qr[4 * c4], v.x);
            d = add_sq(d, qr[4 * c4 + 1], v.y);
            d = add_sq(d, qr[4 * c4 + 2], v.z);
            d = add_sq(d, qr[4 * c4 + 3], v.w);
          }
        } else if constexpr (C > 0) {
          d = first_sq(qr[0], pt[0]);
#pragma unroll
          for (int c = 1; c < C; ++c) d = add_sq(d, qr[c], pt[c]);
        } else {
          d = first_sq(__ldg(q), pt[0]);
          for (int c = 1; c < c_dim; ++c) d = add_sq(d, __ldg(q + c), pt[c]);
        }
        if (d < bd[K - 1]) insert_sorted<K>(bd, bi, d, j0 + j);
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t o = (static_cast<size_t>(b) * nq + i) * k_out;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k_out) {
        dist[o + s] = bd[s];
        idx[o + s] = bi[s];
      }
    }
  }
}

template <int K, int C, int R>
cudaError_t launch_queue(const float* q, const float* p, int batch, int nq,
                         int np, int dim, int k, float* dist, int* idx,
                         cudaStream_t stream) {
  const int w = staged_width(C, dim);
  const int tile_pts = tile_points(w, np);
  const size_t smem = (2 * static_cast<size_t>(tile_pts) * w) * 4 +
                      static_cast<size_t>(R) * kQueue * kThreads * 8;
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_queue_kernel<K, C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec16 = (C == 0 ? dim : C) % 4 == 0 && w == (C == 0 ? dim : C) &&
                     reinterpret_cast<size_t>(p) % 16 == 0;
  const dim3 grid((nq + kThreads * R - 1) / (kThreads * R), batch);
  knn_queue_kernel<K, C, R><<<grid, kThreads, smem, stream>>>(
      q, p, nq, np, dim, k, tile_pts, vec16, dist, idx);
  return cudaGetLastError();
}

// The plan's kernel: the direct kernel (queued == 0: one row a thread), or
// the queue kernel with R rows a thread, 2 only at C = 24 (the readings of
// probe_knn_fps.py: one row a thread was fastest at C = 3 at every path
// shape).
template <int K, int C>
cudaError_t launch_plan(const float* q, const float* p, int batch, int nq,
                        int np, int dim, int k, int queued, int rows,
                        float* dist, int* idx, cudaStream_t st) {
  if (queued == 0) {
    if (rows != 1) return cudaErrorInvalidValue;
    const dim3 grid((nq + kThreads - 1) / kThreads, batch);
    knn_direct_kernel<K, C><<<grid, kThreads, 0, st>>>(q, p, nq, np, dim, k,
                                                       dist, idx);
    return cudaGetLastError();
  }
  if constexpr (K > 3) {
    if (rows == 1) {
      return launch_queue<K, C, 1>(q, p, batch, nq, np, dim, k, dist, idx, st);
    }
    if constexpr (C == 24 && K == 16) {
      if (rows == 2) {
        return launch_queue<K, C, 2>(q, p, batch, nq, np, dim, k, dist, idx,
                                     st);
      }
    }
  }
  return cudaErrorInvalidValue;
}

template <int K>
cudaError_t launch_dim(const float* q, const float* p, int batch, int nq,
                       int np, int dim, int k, int queued, int rows,
                       float* dist, int* idx, cudaStream_t st) {
  switch (dim) {
    case 3:
      return launch_plan<K, 3>(q, p, batch, nq, np, dim, k, queued, rows,
                               dist, idx, st);
    case 24:
      return launch_plan<K, 24>(q, p, batch, nq, np, dim, k, queued, rows,
                                dist, idx, st);
    case 48:
      return launch_plan<K, 48>(q, p, batch, nq, np, dim, k, queued, rows,
                                dist, idx, st);
    default:
      return launch_plan<K, 0>(q, p, batch, nq, np, dim, k, queued, rows,
                               dist, idx, st);
  }
}

}  // namespace

extern "C" {

// query (B, M, C), points (B, N, C) float32 contiguous on the device;
// outputs dist (B, M, k) float32 and idx (B, M, k) int32, 1 <= k <= min(N, 32),
// 1 <= C <= 6144. The launch plan (ops/kernels.py `knn_plan`): `queued` 0
// for the direct kernel (rows 1), 1 for the queue kernel (k > 3) with
// `rows` query rows a thread (see launch_plan). Launches on `stream`
// without synchronising and returns the first cudaError_t (0 on success).
int knn_forward(const float* query, const float* points, int batch, int m,
                int n, int dim, int k, int queued, int rows, float* dist,
                int* idx, void* stream) {
  if (k < 1 || k > 32 || k > n || dim < 1 || dim > 6144) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 3) {
    err = launch_dim<3>(query, points, batch, m, n, dim, k, queued, rows, dist,
                        idx, s);
  } else if (k <= 16) {
    err = launch_dim<16>(query, points, batch, m, n, dim, k, queued, rows,
                         dist, idx, s);
  } else {
    err = launch_dim<32>(query, points, batch, m, n, dim, k, queued, rows,
                         dist, idx, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
