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
//   h   = sum_c x1[c] * W[c, :]  + b           W bf16, fp32 sums
//   out[b, i] = max over s of h                (B, N, C) fp32
//
// with inv = rsqrt(var + 1e-5) computed once by the wrapper (torch.rsqrt on
// the card, as ops/ref.py `gnn_propagate_eval` computes it): the semantics of
// `gnn_propagate_reference(train=False)` :4472, BatchNorm in `_em_bn`'s order
// :2749. Every operation before the product is rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), as the plain
// version's separate PyTorch operations are, so x1 is the plain version's
// bitwise.
//
// The final pass (gnn_propagate_kernel). What bounds it on an H100: memory.
// At IDAM's protocol width (B 32, N 2048, k 12, C 64) a call reads p (16.8
// MB) and idx (3.1 MB) and writes the output (16.8 MB; the train form also
// the 4.2 MB of slots): 37 MB, 0.011 ms at 3.35 TB/s, against 2 E C^2 = 6.4
// GFLOP with bf16 operands, 0.0065 ms on the tensor cores. The edge tensor
// never reaches device memory (on the TPU 100 MB a call, written by one pass
// and read by the next); the k gathered rows of every point, 201 MB, come
// through L2. Design: a warp owns 8 points at a time and runs the product
// on the tensor cores, mma.m16n8k16 with bf16 operands and fp32 sums, as
// h^T = W^T x1^T: W^T (64 x 64) is the A operand, held in registers as
// fragments for the whole kernel, and the 8 points' x1 rows of one slot are
// the B operand, built in registers straight from the gathered p rows (the
// reduction runs over the channels in an order of the kernel's choosing, so
// lane (g, t) takes channels 16 kt + 4 t .. + 3 of point g in k-step kt: a
// 16-byte load each). The running max over the slots and the first slot that
// reaches it stay in the accumulator's layout, h = acc + b compared as the
// plain version does (a NaN stays). The next slot's row is loaded before
// the current slot's product; no barrier inside the loop; a persistent grid.
// The tensor cores sum in another order than the plain version's channel
// order, so the output agrees with it to a stated bar (chip_smoke.py
// GNN_FINAL_ATOL / GNN_FINAL_RTOL), and a slot may differ only where the
// plain version's two largest candidates lie within that bar of each other.
//
// An index outside [0, N) makes its point's output NaN.
//
// Train mode (`gnn_propagate_train` :4397 and its backward :4420), with no
// float atomics (per-block partials that the wrapper adds in a fixed order,
// a gather by a reverse list), so two runs are bitwise equal:
//
// - gnn_propagate_stat_kernel: [sum e, sum e^2] of every channel over the
//   B N k edges, each edge built as above and never stored (on the TPU the
//   (B, k, N, C) bf16 edge tensor, 100 MB at the protocol width, is written
//   and reduced by XLA, :4163-4166). The wrapper turns the sums into the
//   batch mean and biased variance. What bounds it: 0.0059 ms for p and
//   idx read once (19.9 MB); the k gathered rows of every point, 201 MB,
//   come through L2. Each thread sums one channel of one lane's points in
//   a fixed order (ops/ref.py `gnn_propagate_stats_ordered` reproduces it
//   bitwise), a chain of ~740 edges a thread at the protocol width; the
//   first design loaded each edge's index and then its 4-byte value as the
//   chain reached it, one device-memory round trip an edge. Now the block
//   copies whole rows into shared memory with cp.async, 16 bytes a copy,
//   three stages of points ahead of the one being summed, so the chains
//   read shared memory and the gathers run at L2's rate.
// - the final pass above with those statistics, which also saves the first
//   neighbour slot s of each output's max (a byte a channel): the max routes
//   its cotangent there (the TPU kernel recomputes h and compares, :4072).
// - the backward, two launches (`_ge_bwd1_kernel` :4057 and
//   `_gp_bwd2_kernel` :4324). What bounds it: 0.0265 ms for the function
//   (p, idx, the cotangent and slots read once, d_p written once); the two
//   launches pass dy between them, (B, N, k, C) bf16, 100.7 MB written and
//   read twice, which puts their floor at ~0.09 ms.
//   gnn_propagate_backward_kernel (pass 1): a half-warp a point, each lane
//   four channels (C 64), a block tile of 16 points. The routed cotangent dh
//   is nonzero at one slot a channel, so dx1 = bf16(dh W^T) of slot s sums
//   only the output channels d routed to s, in ascending d (fmaf from 0, W^T
//   in shared memory), which keeps the previous design's bits. Ballots of
//   the slot bytes sort the point's C routes (d, cotangent) by slot, stably,
//   and one unrolled walk of the sorted routes, with no data-dependent
//   shared-memory chain, leaves each slot's bf16(dx1) in shared memory
//   (a loop over each slot's ballot bits waits on its loads at every
//   step). Then per slot
//   the edge and BatchNorm from the gathered row (two slots' rows loaded
//   ahead): dy = dx1 where BatchNorm's output > 0, stored as bf16 (it is
//   bf16-exact, so nothing is lost), x1 into the tile's shared rows, S =
//   [sum dy, sum dy hhat] per lane. The block then forms db = sum dh and
//   dW = sum x1^T dh from each output's routed row (a thread a column and
//   16 rows, fp32, points in order). S, dW and db leave as one partial a
//   block, the halves and warps added in a fixed order.
//   gnn_propagate_gather_kernel: a warp a target point j (a half-warp at C
//   32), each lane two channels. da = bf16(gamma inv (dy - S0/E - hhat
//   S1/E)) of each edge whose neighbour is j, recomputed from dy, the edge
//   and S in the reverse list's ascending order (reverse_list.cu, built once
//   a graph and step by the caller), summed in fp32 and rounded to bf16
//   (the bf16 gather table's cotangent), minus the sum over s of da of j's
//   own k edges as the centre: the previous scatter's arithmetic in its
//   order. da is never stored. The p rows it gathers for both ends of every
//   edge, 2 E 256 bytes = 403 MB through L2, bound it more than dy's bytes.
//
// The rounding of the backward is ops/ref.py's (`gnn_propagate_backward`):
// dx1, da and the gathered sum round to bf16, every other sum is fp32; the
// sums of S, dW and db run in another order than the plain version's, so
// the two agree to a tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two bf16 values packed low-then-high, each rounded to nearest even (exact
// for bf16-valued inputs)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x1 = bf16(relu(((e - mean) * inv) * gamma + beta)) of the edge e, each
// operation rounded on its own
__device__ __forceinline__ float bn_relu_bf16(float e, float mean, float inv, float gamma,
                                              float beta) {
  const float hh = __fmul_rn(__fsub_rn(e, mean), inv);
  const float y = __fadd_rn(__fmul_rn(hh, gamma), beta);
  return bf16r(y > 0.f ? y : 0.f);
}

// ---- the final pass -------------------------------------------------------

constexpr int kFinalWarps = 4;
constexpr int kPts = 8;        // points a warp tile: the n of mma.m16n8k16

template <int C, bool kSlot>
__global__ void __launch_bounds__(kFinalWarps * 32)
gnn_propagate_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ mean, const float* __restrict__ inv,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     int n, int k, long long points, float* __restrict__ out,
                     unsigned char* __restrict__ slot) {
  constexpr int KT = C / 16;        // k-steps over the input channels, m-tiles of outputs
  __shared__ __align__(16) float prm[4][C];   // mean, inv, gamma, beta
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    prm[0][i] = mean[i];
    prm[1][i] = inv[i];
    prm[2][i] = gamma[i];
    prm[3][i] = beta[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // A fragments of W^T: rows (outputs) 16 mt + g (+ 8), k-step kt's columns
  // (inputs) 16 kt + 4 t + {0, 1} (registers 0-1) and + {2, 3} (2-3), the
  // order in which the B fragments below hold x1's channels
  uint32_t a[KT][KT][4];
  float bo[KT][2];
#pragma unroll
  for (int mt = 0; mt < KT; ++mt) {
    const int o = 16 * mt + g;
    bo[mt][0] = bias[o];
    bo[mt][1] = bias[o + 8];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const float* wc = w + (16 * kt + 4 * t) * C;
      a[mt][kt][0] = pack_bf16(wc[o], wc[C + o]);
      a[mt][kt][1] = pack_bf16(wc[o + 8], wc[C + o + 8]);
      a[mt][kt][2] = pack_bf16(wc[2 * C + o], wc[3 * C + o]);
      a[mt][kt][3] = pack_bf16(wc[2 * C + o + 8], wc[3 * C + o + 8]);
    }
  }

  const long long tiles = (points + kPts - 1) / kPts;
  const long long warps = static_cast<long long>(gridDim.x) * kFinalWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kFinalWarps + (threadIdx.x >> 5);
       tile < tiles; tile += warps) {
    // this lane builds the x1 channels 16 kt + 4 t .. + 3 of point pt
    const long long pt = tile * kPts + g;
    const bool live = pt < points;
    const long long base = live ? (pt / n) * n : 0;
    const int* irow = idx + (live ? pt : 0) * k;
    float4 ctr[KT], nb[KT];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) nb[kt] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      ctr[kt] = live ? __ldg(reinterpret_cast<const float4*>(p + pt * C + 16 * kt + 4 * t))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    int j = live ? __ldg(irow) : 0;
    bool ok = j >= 0 && j < n;
    if (live && ok) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        nb[kt] = __ldg(reinterpret_cast<const float4*>(p + (base + j) * C + 16 * kt + 4 * t));
    }
    int jn = live && k > 1 ? __ldg(irow + 1) : 0;

    float best[KT][4];
    int arg[KT][4];
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        best[mt][r] = -CUDART_INF_F;
        arg[mt][r] = 0;
      }

    for (int s = 0; s < k; ++s) {
      // B fragments of slot s from this lane's gathered row
      uint32_t bf[KT][2];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        float x[4];
        const float nv[4] = {nb[kt].x, nb[kt].y, nb[kt].z, nb[kt].w};
        const float cv[4] = {ctr[kt].x, ctr[kt].y, ctr[kt].z, ctr[kt].w};
        const float4 mu = *reinterpret_cast<const float4*>(&prm[0][16 * kt + 4 * t]);
        const float4 iv = *reinterpret_cast<const float4*>(&prm[1][16 * kt + 4 * t]);
        const float4 ga = *reinterpret_cast<const float4*>(&prm[2][16 * kt + 4 * t]);
        const float4 be = *reinterpret_cast<const float4*>(&prm[3][16 * kt + 4 * t]);
        const float m4[4] = {mu.x, mu.y, mu.z, mu.w}, i4[4] = {iv.x, iv.y, iv.z, iv.w};
        const float g4[4] = {ga.x, ga.y, ga.z, ga.w}, b4[4] = {be.x, be.y, be.z, be.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = bf16r(__fsub_rn(bf16r(nv[r]), cv[r]));
          x[r] = !live ? 0.f : !ok ? CUDART_NAN_F : bn_relu_bf16(e, m4[r], i4[r], g4[r], b4[r]);
        }
        bf[kt][0] = pack_bf16(x[0], x[1]);
        bf[kt][1] = pack_bf16(x[2], x[3]);
      }
      // the next slot's row, loaded before this slot's product
      if (s + 1 < k) {
        j = jn;
        ok = j >= 0 && j < n;
        if (live && ok) {
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
            nb[kt] = __ldg(reinterpret_cast<const float4*>(p + (base + j) * C + 16 * kt + 4 * t));
        }
        if (live && s + 2 < k) jn = __ldg(irow + s + 2);
      }
      float acc[KT][4];
#pragma unroll
      for (int mt = 0; mt < KT; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) mma_bf16(acc[mt], a[mt][kt], bf[kt][0], bf[kt][1]);
      }
      // running max: a NaN (an index out of range) stays NaN, as torch.amax
      // keeps it; a tie keeps the first slot
#pragma unroll
      for (int mt = 0; mt < KT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float h = __fadd_rn(acc[mt][r], bo[mt][r >> 1]);
          if (h > best[mt][r] || h != h) {
            best[mt][r] = h;
            arg[mt][r] = s;
          }
        }
    }
    // accumulator element (mt, r): output 16 mt + g + 8 (r >> 1) of point
    // 2 t + (r & 1) of the tile
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long q = tile * kPts + 2 * t + (r & 1);
        if (q < points) {
          const long long at = q * C + 16 * mt + g + 8 * (r >> 1);
          out[at] = best[mt][r];
          if (kSlot) slot[at] = static_cast<unsigned char>(arg[mt][r]);
        }
      }
  }
}

// Opt a kernel into `smem` bytes of dynamic shared memory (when given) and
// size its persistent grid: every block resident, at most `need` blocks.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long need,
                            int* grid) {
  cudaError_t err;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  long long blocks = static_cast<long long>(per_sm) * sms;
  if (blocks > need) blocks = need;
  *grid = static_cast<int>(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

template <int C>
int launch(const float* p, const int* idx, const float* w, const float* bias,
           const float* mean, const float* inv, const float* gamma, const float* beta,
           int batch, int n, int k, float* out, unsigned char* slot, cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n;
  const long long tiles = (points + kPts - 1) / kPts;
  const long long need = (tiles + kFinalWarps - 1) / kFinalWarps;
  int grid = 0;
  cudaError_t err;
  if (slot == nullptr) {
    err = persistent_grid(gnn_propagate_kernel<C, false>, kFinalWarps * 32, 0, need, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    gnn_propagate_kernel<C, false><<<grid, kFinalWarps * 32, 0, stream>>>(
        p, idx, w, bias, mean, inv, gamma, beta, n, k, points, out, slot);
  } else {
    err = persistent_grid(gnn_propagate_kernel<C, true>, kFinalWarps * 32, 0, need, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    gnn_propagate_kernel<C, true><<<grid, kFinalWarps * 32, 0, stream>>>(
        p, idx, w, bias, mean, inv, gamma, beta, n, k, points, out, slot);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the stat pass --------------------------------------------------------

constexpr int kThreads = 256;
// A lane's points in a stage of the stat pass, and the most neighbours a
// point may have there.
constexpr int kStatPoints = 2;
constexpr int kStatMaxK = 32;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Shared memory of a stat-pass block: kStages stages of kThreads / C lanes
// x kStatPoints points, each point's k + 1 rows of C floats (its centre,
// then its neighbours in slot order), and the lanes' sums.
__host__ __device__ constexpr size_t stat_smem(int stages, int k) {
  return static_cast<size_t>(stages) * kThreads * kStatPoints * (k + 1) * 4 +
         2 * kThreads * 4;
}

// Sums [e, e^2] of every channel over the edges of the points of block
// blockIdx.x: lane q (0 .. kThreads / C - 1) takes points blockIdx.x kLanes
// + q + m gridDim.x kLanes, m = 0, 1, ..., and thread (q, c) sums channel
// c over them in that order, each point's slots in order (s1 += e; s2 =
// fma(e, e, s2)); the block adds its lanes in order q = 0, 1, ... into
// part[block][0][c], part[block][1][c]. That is the first design's order (a
// thread a channel loading one edge at a time), kept so that the
// statistics stay bitwise its. What changed is how the rows arrive: a
// stage is kStatPoints points of every lane, and the block copies each
// stage's rows into shared memory (cp.async, 16 bytes a copy: C / 4
// threads a row, two groups of them a point taking its even and odd rows)
// kStages - 1 stages ahead of the stage being summed, each thread's
// neighbour indices for a stage loaded a stage before its copies are
// issued. A neighbour outside [0, n) is written as NaN, so its edge is
// NaN. One barrier a stage.
template <int C, int kStages>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_stat_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                          int n, int k, long long points, float* __restrict__ part) {
  constexpr int kLanes = kThreads / C;
  constexpr int kRowCopies = C / 4;
  constexpr int kCopies = (kStatMaxK + 2) / 2;   // a thread's rows of a point, at most
  extern __shared__ __align__(16) float stat_buf[];
  const int stage_floats = kLanes * kStatPoints * (k + 1) * C;
  float* red = stat_buf + kStages * stage_floats;
  const int c = threadIdx.x % C;
  const int q = threadIdx.x / C;
  const long long stride = static_cast<long long>(gridDim.x) * kLanes;
  const long long first = static_cast<long long>(blockIdx.x) * kLanes;
  // lane 0 has the most points
  const long long lane0 = first < points ? (points - first + stride - 1) / stride : 0;
  const int stages = static_cast<int>((lane0 + kStatPoints - 1) / kStatPoints);
  // the thread's copies: point slot pp = lane kStatPoints + i of every
  // stage, rows half, half + 2, ... (row 0 the centre, row 1 + s slot s),
  // columns col .. col + 3
  const int col = 4 * (threadIdx.x % kRowCopies);
  const int pp = threadIdx.x / kRowCopies / 2, half = threadIdx.x / kRowCopies % 2;
  const long long pt0 = first + pp / kStatPoints + (pp % kStatPoints) * stride;
  const long long pt_step = kStatPoints * stride;
  int jn[kCopies];
  auto load_idx = [&](int s) {
    const long long pt = pt0 + s * pt_step;
#pragma unroll
    for (int v = 0; v < kCopies; ++v) {
      const int row = 2 * v + half;
      jn[v] = s < stages && pt < points && row >= 1 && row <= k
                  ? __ldg(idx + pt * k + row - 1) : 0;
    }
  };
  auto issue = [&](int s) {
    const long long pt = pt0 + s * pt_step;
    if (s < stages && pt < points) {
      float* dst = stat_buf + (s % kStages) * stage_floats + pp * (k + 1) * C + col;
      const long long base = pt / n * n;
#pragma unroll
      for (int v = 0; v < kCopies; ++v) {
        const int row = 2 * v + half;
        if (row > k) break;
        if (row == 0) {
          cp_async16(dst, p + pt * C + col);
        } else if (jn[v] >= 0 && jn[v] < n) {
          cp_async16(dst + row * C, p + (base + jn[v]) * C + col);
        } else {
          *reinterpret_cast<float4*>(dst + row * C) =
              make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    load_idx(s);
    issue(s);
  }
  load_idx(kStages - 1);

  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < stages; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    // every thread is past stage s - 1, so its buffer takes stage s + kStages - 1
    issue(s + kStages - 1);
    load_idx(s + kStages);
    const float* buf = stat_buf + (s % kStages) * stage_floats + c;
    for (int i = 0; i < kStatPoints; ++i) {
      if (first + q + (static_cast<long long>(s) * kStatPoints + i) * stride >= points) break;
      const float* rows = buf + (q * kStatPoints + i) * (k + 1) * C;
      const float centre = rows[0];
      for (int slot = 1; slot <= k; ++slot) {
        const float e = bf16r(__fsub_rn(bf16r(rows[slot * C]), centre));
        s1 = __fadd_rn(s1, e);
        s2 = __fmaf_rn(e, e, s2);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  red[q * C + c] = s1;
  red[kThreads + q * C + c] = s2;
  __syncthreads();
  if (q == 0) {
    float a = red[c], bsum = red[kThreads + c];
    for (int r = 1; r < kLanes; ++r) {
      a = __fadd_rn(a, red[r * C + c]);
      bsum = __fadd_rn(bsum, red[kThreads + r * C + c]);
    }
    part[(static_cast<long long>(blockIdx.x) * 2) * C + c] = a;
    part[(static_cast<long long>(blockIdx.x) * 2 + 1) * C + c] = bsum;
  }
}

// Stages of the stat pass: four where they fit two blocks on an SM, else two.
constexpr size_t kStatSmemTwoBlocks = 110 * 1024;

template <int C, int kStages>
int launch_stat_stages(const float* p, const int* idx, int batch, int n, int k, int blocks,
                       float* part, cudaStream_t stream) {
  auto kernel = gnn_propagate_stat_kernel<C, kStages>;
  const size_t smem = stat_smem(kStages, k);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(p, idx, n, k, static_cast<long long>(batch) * n,
                                             part);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_stat(const float* p, const int* idx, int batch, int n, int k, int blocks,
                float* part, cudaStream_t stream) {
  if (stat_smem(4, k) <= kStatSmemTwoBlocks)
    return launch_stat_stages<C, 4>(p, idx, batch, n, k, blocks, part, stream);
  return launch_stat_stages<C, 2>(p, idx, batch, n, k, blocks, part, stream);
}

// ---- the backward ---------------------------------------------------------

// BatchNorm parameters of the backward, (C,) each: mean, inv = rsqrt(var +
// eps), gamma, beta, then (the gather) scale = gamma inv, m1 = S0 / E, m2 =
// S1 / E.
struct BnParams {
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  const float* scale;
  const float* m1;
  const float* m2;
};

constexpr int kWarps = kThreads / 32;
constexpr int kTilePts = 2 * kWarps;            // points a block tile: a half-warp each

// Pass 1's shared memory: W^T (C x C fp32); the tile's cotangents (fp32),
// slots (bytes), each point's C sorted routes (8 bytes each), k rows of
// bf16(dx1) and k x1 rows (bf16, padded).
template <int C>
struct Pass1Smem {
  static constexpr int kRowBytes = 2 * C + 16;
  static size_t bytes(int k) {
    return sizeof(float) * (C * C + kTilePts * C) + 8 * kTilePts * C +
           static_cast<size_t>(kTilePts) * k * (2 * C + kRowBytes) + kTilePts * C;
  }
};

// Pass 1: per point, dy (B, N, k, C) bf16; per block, S = [sum dy, sum dy
// hhat] (2, C), dW (C, C) and db (C,) of its points, one partial each. A
// half-warp a point (C / 16 channels a lane), two a warp.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
gnn_propagate_backward_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                              const float* __restrict__ w, BnParams bn,
                              const float* __restrict__ dout,
                              const unsigned char* __restrict__ slot, int n, int k,
                              long long points, float* __restrict__ s_part,
                              float* __restrict__ dw_part, float* __restrict__ db_part,
                              __nv_bfloat16* __restrict__ dy) {
  constexpr int CPL = C / 16;                   // channels a lane: 4 at C 64
  constexpr int NM = C / 16;                    // output channels a lane routes
  constexpr int kRows = C * C / kThreads;       // dW rows a thread
  constexpr int kRowBytes = Pass1Smem<C>::kRowBytes;
  using Packed = typename std::conditional<CPL == 4, uint2, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);                  // wt[d][c] = bf16(W[c][d])
  float* sh_dout = wt + C * C;                                 // kTilePts x C
  int2* sh_route = reinterpret_cast<int2*>(sh_dout + kTilePts * C);     // kTilePts x C
  __nv_bfloat16* sh_dx = reinterpret_cast<__nv_bfloat16*>(sh_route + kTilePts * C);
  unsigned char* sh_x1 = reinterpret_cast<unsigned char*>(sh_dx + kTilePts * k * C);
  unsigned char* sh_slot = sh_x1 + static_cast<size_t>(kTilePts) * k * kRowBytes;
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    const int c = i / C, d = i % C;
    wt[d * C + c] = bf16r(w[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane & 15, half = lane >> 4;
  const int tp = 2 * warp + half;               // this half-warp's point of a tile
  const unsigned hmask = 0xffffu << (16 * half);
  const unsigned below = (1u << l) - 1u, above = 0xffffu & ~((2u << l) - 1u);
  float mean[CPL], inv[CPL], gam[CPL], bet[CPL], s0v[CPL], s1v[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = CPL * l + i;
    mean[i] = bn.mean[c];
    inv[i] = bn.inv[c];
    gam[i] = bn.gamma[c];
    bet[i] = bn.beta[c];
    s0v[i] = 0.f;
    s1v[i] = 0.f;
  }
  // dW[cb * kRows + r][dd] and db[dd] of the tiles' points
  const int dd = threadIdx.x % C, cb = threadIdx.x / C;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  float dbacc = 0.f;
  int2* route = sh_route + tp * C;
  __nv_bfloat16* dxw = sh_dx + static_cast<size_t>(tp) * k * C;
  unsigned char* xrow = sh_x1 + static_cast<size_t>(tp) * k * kRowBytes;
  __syncthreads();

  // the point's head (cotangents, slots, centre, neighbour indices: lane l
  // holds slots l and 16 + l), loaded one tile ahead
  const long long stride = static_cast<long long>(gridDim.x) * kTilePts;
  float go[NM], hgo[NM];
  int so[NM], hso[NM], jv[2], hjv[2];
  float pc[CPL], hpc[CPL];
  auto load_head = [&](long long pt) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      hgo[m] = pt < points ? dout[pt * C + l + 16 * m] : 0.f;
      hso[m] = pt < points ? slot[pt * C + l + 16 * m] : 0;
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) hpc[i] = pt < points ? p[pt * C + CPL * l + i] : 0.f;
    hjv[0] = pt < points && l < k ? idx[pt * k + l] : 0;
    hjv[1] = pt < points && 16 + l < k ? idx[pt * k + 16 + l] : 0;
  };
  load_head(static_cast<long long>(blockIdx.x) * kTilePts + tp);

  for (long long t0 = static_cast<long long>(blockIdx.x) * kTilePts; t0 < points;
       t0 += stride) {
    const long long pt = t0 + tp;
    const bool live = pt < points;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      go[m] = hgo[m];
      so[m] = hso[m];
      sh_dout[tp * C + l + 16 * m] = go[m];
      sh_slot[tp * C + l + 16 * m] = static_cast<unsigned char>(so[m]);
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) pc[i] = hpc[i];
    jv[0] = hjv[0];
    jv[1] = hjv[1];
    load_head(pt + stride);

    // dx1 = bf16(dh W^T) of every slot, each the sum of the output channels
    // d routed to it in ascending d: the routes (d, cotangent) sorted by slot,
    // stably, by ballots, then walked in one unrolled pass; a run's end
    // stores its slot's sum. A point past the end routes zeros to slot 0.
    unsigned nonempty = 0;
    int run = 0, st[NM];
    unsigned peers[NM];
    bool later[NM];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      st[m] = 0;
      peers[m] = 0;
      later[m] = false;
    }
    for (int s = 0; s < k; ++s) {
      unsigned bal[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m)
        bal[m] = (__ballot_sync(kFull, so[m] == s) & hmask) >> (16 * half);
      int before = run;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        bool more = false;
#pragma unroll
        for (int m2 = m + 1; m2 < NM; ++m2) more = more || bal[m2] != 0;
        const bool mine = so[m] == s;
        st[m] = mine ? before : st[m];
        peers[m] = mine ? bal[m] : peers[m];
        later[m] = mine ? more : later[m];
        before += __popc(bal[m]);
      }
      nonempty |= before != run ? 1u << s : 0u;
      run = before;
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const bool last = !later[m] && (peers[m] & above) == 0;
      route[st[m] + __popc(peers[m] & below)] =
          make_int2((l + 16 * m) | (so[m] << 8) | (last ? 1 << 16 : 0), __float_as_int(go[m]));
    }
    __syncwarp();
    {
      float dx[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) dx[i] = 0.f;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int2 r = route[q];
        const float* wr = wt + (r.x & 0xff) * C + CPL * l;
        const float gv = __int_as_float(r.y);
        if constexpr (CPL == 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr);
          dx[0] = __fmaf_rn(gv, wv.x, dx[0]);
          dx[1] = __fmaf_rn(gv, wv.y, dx[1]);
          dx[2] = __fmaf_rn(gv, wv.z, dx[2]);
          dx[3] = __fmaf_rn(gv, wv.w, dx[3]);
        } else {
          const float2 wv = *reinterpret_cast<const float2*>(wr);
          dx[0] = __fmaf_rn(gv, wv.x, dx[0]);
          dx[1] = __fmaf_rn(gv, wv.y, dx[1]);
        }
        if (r.x >> 16) {
          uint32_t* out = reinterpret_cast<uint32_t*>(dxw + ((r.x >> 8) & 0xff) * C + CPL * l);
#pragma unroll
          for (int i = 0; i < CPL; i += 2) {
            out[i / 2] = pack_bf16(dx[i], dx[i + 1]);
            dx[i] = 0.f;
            dx[i + 1] = 0.f;
          }
        }
      }
    }
    __syncwarp();

    // the epilogue of each slot: the edge, BatchNorm, x1 and dy; the
    // neighbour rows two slots at a time, the next two loaded first (four
    // spill registers at two blocks an SM)
    const long long base = live ? (pt / n) * n : 0;
    constexpr int kGroup = 2;
    float rows[kGroup][CPL], ahead[kGroup][CPL];
    bool ok[kGroup], ok_ahead[kGroup];
    auto load_rows = [&](int s0, float (&r)[kGroup][CPL], bool (&okr)[kGroup]) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int su = s0 + u;
        const int j = __shfl_sync(kFull, su < 16 ? jv[0] : jv[1], 16 * half + (su & 15));
        okr[u] = live && su < k && j >= 0 && j < n;
        if constexpr (CPL == 4) {
          const float4 v = okr[u] ? *reinterpret_cast<const float4*>(p + (base + j) * C + CPL * l)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          r[u][0] = v.x;
          r[u][1] = v.y;
          r[u][2] = v.z;
          r[u][3] = v.w;
        } else {
          const float2 v = okr[u] ? *reinterpret_cast<const float2*>(p + (base + j) * C + CPL * l)
                                  : make_float2(0.f, 0.f);
          r[u][0] = v.x;
          r[u][1] = v.y;
        }
      }
    };
    load_rows(0, rows, ok);
    for (int s0 = 0; s0 < k; s0 += kGroup) {
      if (s0 + kGroup < k) load_rows(s0 + kGroup, ahead, ok_ahead);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int s = s0 + u;
        if (s >= k) break;
        float dx[CPL];
        if ((nonempty >> s) & 1u) {
          const uint32_t* in = reinterpret_cast<const uint32_t*>(dxw + s * C + CPL * l);
#pragma unroll
          for (int i = 0; i < CPL; i += 2) {
            dx[i] = lo_bf16(in[i / 2]);
            dx[i + 1] = hi_bf16(in[i / 2]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < CPL; ++i) dx[i] = 0.f;
        }
        float x1v[CPL], dyv[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const float e = ok[u] ? bf16r(__fsub_rn(bf16r(rows[u][i]), pc[i])) : CUDART_NAN_F;
          const float hhat = __fmul_rn(__fsub_rn(e, mean[i]), inv[i]);
          const float y = __fadd_rn(__fmul_rn(hhat, gam[i]), bet[i]);
          x1v[i] = live ? bf16r(y > 0.f ? y : 0.f) : 0.f;
          dyv[i] = live && y > 0.f ? dx[i] : 0.f;     // dx is bf16 already
          s0v[i] = __fadd_rn(s0v[i], dyv[i]);
          s1v[i] = live ? __fmaf_rn(dyv[i], hhat, s1v[i]) : s1v[i];
        }
        Packed xp, dp;
        if constexpr (CPL == 4) {
          xp = make_uint2(pack_bf16(x1v[0], x1v[1]), pack_bf16(x1v[2], x1v[3]));
          dp = make_uint2(pack_bf16(dyv[0], dyv[1]), pack_bf16(dyv[2], dyv[3]));
        } else {
          xp = pack_bf16(x1v[0], x1v[1]);
          dp = pack_bf16(dyv[0], dyv[1]);
        }
        reinterpret_cast<Packed*>(xrow + s * kRowBytes)[l] = xp;
        if (live && dy != nullptr) reinterpret_cast<Packed*>(dy + (pt * k + s) * C)[l] = dp;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ok[u] = ok_ahead[u];
#pragma unroll
        for (int i = 0; i < CPL; ++i) rows[u][i] = ahead[u][i];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTilePts; ++t) {
      const int s = sh_slot[t * C + dd];
      const float gv = sh_dout[t * C + dd];
      // the thread's kRows bf16 of the routed x1 row, 8 bytes at a time
      const uint2* row = reinterpret_cast<const uint2*>(
          sh_x1 + (static_cast<size_t>(t) * k + s) * kRowBytes + cb * kRows * 2);
#pragma unroll
      for (int v = 0; v < kRows / 4; ++v) {
        const uint2 q4 = row[v];
        acc[4 * v] = __fmaf_rn(lo_bf16(q4.x), gv, acc[4 * v]);
        acc[4 * v + 1] = __fmaf_rn(hi_bf16(q4.x), gv, acc[4 * v + 1]);
        acc[4 * v + 2] = __fmaf_rn(lo_bf16(q4.y), gv, acc[4 * v + 2]);
        acc[4 * v + 3] = __fmaf_rn(hi_bf16(q4.y), gv, acc[4 * v + 3]);
      }
      dbacc = __fadd_rn(dbacc, gv);     // kept by the threads of cb 0
    }
    __syncthreads();
  }
  const long long blk = blockIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) dw_part[(blk * C + cb * kRows + r) * C + dd] = acc[r];
  if (cb == 0) db_part[blk * C + dd] = dbacc;
  // S: the two halves of each warp added, then the warps in order
  float* red = sh_dout;                         // kWarps x 2 x C
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const float a = __fadd_rn(s0v[i], __shfl_down_sync(kFull, s0v[i], 16));
    const float b = __fadd_rn(s1v[i], __shfl_down_sync(kFull, s1v[i], 16));
    if (half == 0) {
      red[(warp * 2) * C + CPL * l + i] = a;
      red[(warp * 2 + 1) * C + CPL * l + i] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    float a = red[c], bb = red[C + c];
    for (int r = 1; r < kWarps; ++r) {
      a = __fadd_rn(a, red[(r * 2) * C + c]);
      bb = __fadd_rn(bb, red[(r * 2 + 1) * C + c]);
    }
    s_part[(blk * 2) * C + c] = a;
    s_part[(blk * 2 + 1) * C + c] = bb;
  }
}

// q = x / d for 0 <= x < 2^31 and 1 <= d <= 32: umulhi(x, m) >> shift with
// m = ceil(2^(31 + l) / d), l = ceil(log2 d), shift = l - 1 (d = 1: q = x).
struct DivK {
  unsigned m;
  int shift;
  __device__ __forceinline__ unsigned operator()(unsigned x) const {
    return shift < 0 ? x : __umulhi(x, m) >> shift;
  }
};

DivK make_divk(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  if (l == 0) return DivK{0u, -1};
  const unsigned long long num = 1ULL << (31 + l);
  return DivK{static_cast<unsigned>((num + d - 1) / d), l - 1};
}

// da of one edge channel: bf16(scale ((dy - m1) - hhat m2)) with hhat =
// (e - mean) inv, each operation rounded on its own
__device__ __forceinline__ float edge_da(float e, float dyv, float mean, float inv,
                                         float scale, float m1, float m2) {
  const float hhat = __fmul_rn(__fsub_rn(e, mean), inv);
  return bf16r(__fmul_rn(scale, __fsub_rn(__fsub_rn(dyv, m1), __fmul_rn(hhat, m2))));
}

constexpr int kUnroll = 4;        // edges whose loads a lane issues at once

// The gather: d_p[j][c] = bf16(sum of da over the edges whose neighbour is
// j, in the reverse list's order) - sum over s of da[j][s]; order[off[j] ..
// off[j + 1]) lists the edges (pt k + s) whose neighbour is j, ascending.
// A warp (a half-warp at C 32) a point, two channels a lane; the loads of
// kUnroll edges are issued before any is used.
template <int C>
__global__ void __launch_bounds__(kThreads)
gnn_propagate_gather_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                            BnParams bn, const __nv_bfloat16* __restrict__ dy,
                            const int* __restrict__ order, const int* __restrict__ off,
                            int n, int k, DivK divk, long long points,
                            float* __restrict__ d_p) {
  constexpr int kLanes = C / 2;                 // lanes a point
  const int lane = threadIdx.x & 31;
  const int c = 2 * (lane % kLanes);
  const long long jj = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  if (jj >= points) return;
  const float2 mean = *reinterpret_cast<const float2*>(bn.mean + c);
  const float2 inv = *reinterpret_cast<const float2*>(bn.inv + c);
  const float2 scale = *reinterpret_cast<const float2*>(bn.scale + c);
  const float2 m1 = *reinterpret_cast<const float2*>(bn.m1 + c);
  const float2 m2 = *reinterpret_cast<const float2*>(bn.m2 + c);
  const float2 pj = __ldg(reinterpret_cast<const float2*>(p + jj * C + c));
  const float pb0 = bf16r(pj.x), pb1 = bf16r(pj.y);
  const uint32_t* dyw = reinterpret_cast<const uint32_t*>(dy);   // channel pairs

  // the edges whose neighbour is jj: bf16(pj) - p[centre]
  float a0 = 0.f, a1 = 0.f;
  const int beg = __ldg(off + jj), end = __ldg(off + jj + 1);
  for (int t = beg; t < end; t += kUnroll) {
    float2 pi[kUnroll];
    uint32_t dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < end) {
        const unsigned e = static_cast<unsigned>(__ldg(order + t + u));
        pi[u] = __ldg(reinterpret_cast<const float2*>(p + static_cast<long long>(divk(e)) * C + c));
        dv[u] = __ldg(dyw + (static_cast<long long>(e) * C + c) / 2);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < end) {
        a0 = __fadd_rn(a0, edge_da(bf16r(__fsub_rn(pb0, pi[u].x)), lo_bf16(dv[u]), mean.x,
                                   inv.x, scale.x, m1.x, m2.x));
        a1 = __fadd_rn(a1, edge_da(bf16r(__fsub_rn(pb1, pi[u].y)), hi_bf16(dv[u]), mean.y,
                                   inv.y, scale.y, m1.y, m2.y));
      }
    }
  }
  // jj's own edges, jj the centre
  const long long base = (jj / n) * n;
  float c0 = 0.f, c1 = 0.f;
  for (int s0 = 0; s0 < k; s0 += kUnroll) {
    float2 pn[kUnroll];
    uint32_t dv[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < k) {
        const int j = __ldg(idx + jj * k + s0 + u);
        ok[u] = j >= 0 && j < n;
        if (ok[u]) pn[u] = __ldg(reinterpret_cast<const float2*>(p + (base + j) * C + c));
        dv[u] = __ldg(dyw + ((jj * k + s0 + u) * C + c) / 2);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < k) {
        const float e0 = ok[u] ? bf16r(__fsub_rn(bf16r(pn[u].x), pj.x)) : CUDART_NAN_F;
        const float e1 = ok[u] ? bf16r(__fsub_rn(bf16r(pn[u].y), pj.y)) : CUDART_NAN_F;
        c0 = __fadd_rn(c0, edge_da(e0, lo_bf16(dv[u]), mean.x, inv.x, scale.x, m1.x, m2.x));
        c1 = __fadd_rn(c1, edge_da(e1, hi_bf16(dv[u]), mean.y, inv.y, scale.y, m1.y, m2.y));
      }
    }
  }
  *reinterpret_cast<float2*>(d_p + jj * C + c) =
      make_float2(__fsub_rn(bf16r(a0), c0), __fsub_rn(bf16r(a1), c1));
}

template <int C>
int launch_backward(const float* p, const int* idx, const float* w, BnParams bn,
                    const float* dout, const unsigned char* slot, int batch, int n, int k,
                    int blocks, float* s_part, float* dw_part, float* db_part,
                    __nv_bfloat16* dy, cudaStream_t stream) {
  const size_t smem = Pass1Smem<C>::bytes(k);
  cudaError_t err = cudaFuncSetAttribute(gnn_propagate_backward_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gnn_propagate_backward_kernel<C><<<blocks, kThreads, smem, stream>>>(
      p, idx, w, bn, dout, slot, n, k, static_cast<long long>(batch) * n, s_part, dw_part,
      db_part, dy);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_gather(const float* p, const int* idx, BnParams bn, const __nv_bfloat16* dy,
                  const int* order, const int* off, int batch, int n, int k, float* d_p,
                  cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n;
  const long long threads = points * (C / 2);
  const long long want = (threads + kThreads - 1) / kThreads;
  if (want >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  gnn_propagate_gather_kernel<C><<<static_cast<int>(want), kThreads, 0, stream>>>(
      p, idx, bn, dy, order, off, n, k, make_divk(k), points, d_p);
  return static_cast<int>(cudaGetLastError());
}

BnParams bn_params(const float* bn, int c) {
  return BnParams{bn, bn + c, bn + 2 * c, bn + 3 * c, bn + 4 * c, bn + 5 * c, bn + 6 * c};
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
  if (batch < 1 || n < 1 || k < 1 || k > kStatMaxK || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 64) return launch_stat<64>(p, idx, batch, n, k, blocks, part, st);
  if (c == 32) return launch_stat<32>(p, idx, batch, n, k, blocks, part, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's pass 1. bn (7, C) fp32: mean, inv, gamma, beta (rows 4-6,
// the gather's, not read here); dout (B, N, C) fp32 and slot (B, N, C) uint8
// from the final pass; k <= 32 -> dy (B, N, k, C) bf16, s_part (blocks, 2,
// C), dw_part (blocks, C, C) (row c, column d of dW), db_part (blocks, C);
// a null dy is not written (no d_p asked for).
int gnn_propagate_backward(const float* p, const int* idx, const float* w, const float* bn,
                           const float* dout, const unsigned char* slot, int batch, int n,
                           int c, int k, int blocks, float* s_part, float* dw_part,
                           float* db_part, void* dy, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > 32 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* dyb = static_cast<__nv_bfloat16*>(dy);
  if (c == 64)
    return launch_backward<64>(p, idx, w, bn_params(bn, c), dout, slot, batch, n, k, blocks,
                               s_part, dw_part, db_part, dyb, st);
  if (c == 32)
    return launch_backward<32>(p, idx, w, bn_params(bn, c), dout, slot, batch, n, k, blocks,
                               s_part, dw_part, db_part, dyb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's gather: p, idx as above, bn (7, C) with scale = gamma inv,
// m1 = S0 / E, m2 = S1 / E in rows 4-6, dy (B, N, k, C) bf16 from pass 1,
// order (B N k) int32 and off (B N + 1) int32, the reverse list of idx ->
// d_p (B, N, C) fp32. k <= 32.
int gnn_propagate_gather(const float* p, const int* idx, const float* bn, const void* dy,
                         const int* order, const int* off, int batch, int n, int c, int k,
                         float* d_p, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  if (c == 64)
    return launch_gather<64>(p, idx, bn_params(bn, c), dyb, order, off, batch, n, k, d_p, st);
  if (c == 32)
    return launch_gather<32>(p, idx, bn_params(bn, c), dyb, order, off, batch, n, k, d_p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
