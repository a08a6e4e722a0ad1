// Attention backward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the split backward of the TPU kernels: `_attn_bwd_split`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:2502), its dQ pass :2516 (body
// `_attn_bwd_dq_kernel` :2308) and its dK/dV pass :2534 (body
// `_attn_bwd_dkv_kernel` :2331), the backward of `fused_attention` :2427; and
// `_attn_bnhd_bwd` :2663 (body `_attn_bwd_kernel_bnhd` :2376), the backward
// of `fused_attention_bnhd` :2610. Per head, with the forward's output o and
// the row max m and row sum l that attention.cu saves:
//
//   delta[n] = sum_c dO[n, c] o[n, c]
//   p[n, j]  = exp(q[n] . k[j] * scale - m[n]) / l[n]
//   ds[n, j] = (p[n, j] (dO[n] . v[j] - delta[n])) * scale
//   dq[n] = sum_j ds[n, j] k[j]
//   dk[j] = sum_n ds[n, j] q[n],   dv[j] = sum_n p[n, j] dO[n]
//
// the semantics of ops/ref.py `attention_backward`. The TPU's bnhd backward
// adds every q-tile's dK/dV into one output block, relying on the TPU grid
// running in order; on a GPU that is a race, and fp32 atomics (as
// FlashAttention-3 adds dQ) would make two runs differ. Here every output
// tile is written once, by one block, from sums in a fixed order: two runs
// are bitwise equal.
//
// Layout: q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, Dv), read in place
// with each tensor's batch and row strides in elements (the last axis
// contiguous); o and dO (B, Nq, H, Dv), m and l (B, H, Nq) contiguous; dq,
// dk, dv contiguous in the inputs' layouts.
//
// 1. bf16, D = Dv = 128: the transformer's heads (B 32, N = M = 2048, H 4;
//    six calls a step). Bound: operations. The split form (no atomics)
//    forms S and dP in both passes, 7 products of 2 B H N M D = 137 GFLOP:
//    0.96 TFLOP, 0.97 ms at the 989 TFLOP/s bf16 dense peak (the least the
//    function needs, 5 products, 0.69 ms); the bytes (q, k, v, o, dO read,
//    dq, dk, dv written: 8 x 67 MB) 0.16 ms. The first version ran at 3.1x
//    SDPA's backward: mma.sync, which on Hopper does not reach the tensor
//    cores' rate; every fragment re-read from shared memory through
//    ldmatrix behind a barrier pair per 32-row tile; 8-12 warps an SM
//    behind two cp.async stages. This one:
//    - a statistics kernel forms delta (fp32 products of dO and o in a
//      fixed tree) and a table of the queries' m log2(e), 1 / l and delta,
//      64 queries a row, zeros past Nq;
//    - a block owns 128 rows (keys in the dK/dV pass, queries in the dQ
//      pass), 64 for each of two consumer warpgroups, loaded once by TMA
//      into 128-byte-swizzled shared memory; one producer thread streams
//      the walked tiles (64 rows of both walked operands, by TMA; in the
//      dK/dV pass also their queries' table row, by a bulk copy) through a
//      ring of 3 stages, each an mbarrier pair (full: the bytes; empty:
//      the 256 consumer threads); setmaxnreg gives the consumers 240
//      registers and the producer 24;
//    - a consumer forms its 64 x 64 scores, then dP, as two groups of
//      wgmma.m64n64k16 from shared memory (K-major A and B, no fragment
//      loads), forms p (exp2 of the scaled score less m log2(e), times 1 /
//      l) while dP is on the tensor cores, rounds p and ds to bf16 straight
//      into A fragments, and accumulates ds . Z (and p . W for dV) into
//      64 x 128 fp32 tiles in registers with wgmma.m64n128k16 (A from
//      registers, B MN-major: the walked tile as it lies), dV while ds is
//      formed. The tiles leave as bf16 once, at the end. A walked row past
//      the end arrives as zeros: its query's 1 / l is 0 in the table (dK/dV
//      pass); the dQ pass masks its last tile's keys, a branch a tile (a
//      select an element made the compiler branch around each exp, and the
//      call took ~1.4x as long).
//    As `_attn_bwd_dq_kernel`/`_attn_bwd_dkv_kernel`: bf16 operands, fp32
//    scores, p from the saved statistics in fp32, p and ds rounded to bf16
//    before their products, each gradient rounded to bf16 once.
//
// 2. fp32, D = 512, Dv = 3: the svd head's correspondence (B 32,
//    N = M = 2048, D 512, v the target cloud, whose gradient the model never
//    asks for). The first version ran at 3.8x SDPA's backward: it formed
//    the scores in both of its passes (4 products of 137 GFLOP where 3
//    suffice) on CUDA cores from a 4 x 4 register tile (8 shared floats for
//    16 FMAs), one block of 8 warps an SM, every D chunk loaded, synced and
//    consumed with no copy in flight, k read twice per walked tile. This
//    one forms the scores once, in three products on the tensor cores:
//    (a) the ds pass: a block owns a 128 x 128 (query, key) tile, forms S
//        over D = 512, then p, the 3-wide dP, and ds, which it writes to an
//        fp32 scratch (B H, Nq, Mp) (Mp = M rounded up to 4; 537 MB at
//        DCP's shape, written once, read by (b)); when dv is asked for, it
//        also writes pT . dO over its 128 queries as a partial
//        (B H, ceil(Nq / 128), M, 3) that the caller sums in a fixed order;
//    (b) the gradient pass, one launch over both problems: dq = ds . k and
//        dk = dsT . q, a block a 128 x 128 output tile summed over all of
//        the other axis.
//    The core of both is 3xTF32 (CUTLASS's fp32-accurate "fast F32"): each
//    fp32 operand x splits into hi = tf32(x) and lo = x - hi, and
//    hi . hi + hi . lo + lo . hi accumulate in fp32 on
//    mma.sync.m16n8k8.tf32; the dropped lo . lo term and lo's truncation
//    are ~2^-22 of a product, so no product is rounded to TF32's precision.
//    The split runs in registers on every fragment it loads, two integer
//    operations and a subtraction: with cvt.rna.tf32 it took ~1.17x as long.
//    4 warps a block of 64 x 64 each, depth staged 32 at a time by cp.async
//    through 3 stages, 2 blocks an SM. Bound: operations. 3 products of
//    137 GFLOP = 412 GFLOP, 6.17 ms at the 67 TFLOP/s fp32 peak; as 3xTF32
//    on the tensor cores 1.24 TFLOP, 2.50 ms at the 495 TFLOP/s TF32 peak;
//    the bytes (q, k read, dq, dk written: 4 x 134 MB) 0.16 ms, the scratch
//    ~1.6 GB of traffic ~0.5 ms more. (wgmma takes TF32 operands K-major
//    only, and the gradient products read k and q along their rows.)

#include "hopper.cuh"

namespace {

// ---- (1) bf16 on wgmma, D = Dv = 128 --------------------------------------

constexpr int kOwn = 128;                // own rows a block, 64 a consumer warpgroup
constexpr int kWalk = 64;                // walked rows a stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;            // consumer warpgroups; the producer is the third
constexpr int kThreadsB = 128 * (kConsumers + 1);
constexpr int kOwnHalf = 2 * kBox;       // one column half of an own tile (128 rows)
constexpr int kOwnBytes = 2 * kOwnHalf;  // an own tile, 128 x 128 bf16
constexpr int kWalkBytes = 2 * kBox;     // a walked tile, 64 x 128 bf16
constexpr size_t kSmemB = 1024 +         // slack to align the tiles to 1024 bytes
                          2 * kOwnBytes + 2 * kStages * kWalkBytes +
                          sizeof(float) * kStages * 3 * kWalk +
                          sizeof(uint64_t) * (2 * kStages + 1);

// The statistics of the queries, per head in tiles of kWalk: stats[((bh T +
// t) 3 + c) kWalk + i] for query n = t kWalk + i (T = ceil(Nq / kWalk)),
// c = 0: m log2(e), 1: 1 / l, 2: delta = sum_c dO[n, c] o[n, c] (fp32
// products summed in a fixed tree); zeros past Nq. 16 threads a query, 8
// channels each.
__global__ void __launch_bounds__(256)
attention_bf16_stats_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ d_out,
                            const float* __restrict__ row_max,
                            const float* __restrict__ row_sum, int heads, int nq,
                            int n_tiles, float* __restrict__ stats) {
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int n = blockIdx.x * 16 + (threadIdx.x >> 4), part = threadIdx.x & 15;
  float acc = 0.f;
  if (n < nq) {
    const long long row = ((static_cast<long long>(b) * nq + n) * heads + h) * kD + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row);
    const uint4 gv = *reinterpret_cast<const uint4*>(d_out + row);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && n < n_tiles * kWalk) {
    const bool ok = n < nq;
    const long long stat = static_cast<long long>(bh) * nq + n;
    float* dst = stats + (static_cast<long long>(bh) * n_tiles + n / kWalk) * 3 * kWalk + n % kWalk;
    dst[0] = ok ? row_max[stat] * kLog2e : 0.f;
    dst[kWalk] = ok ? 1.f / row_sum[stat] : 0.f;
    dst[2 * kWalk] = ok ? acc : 0.f;
  }
}

// Own rows X (with partner Y), walked rows Z (with W): the dQ pass (kKV
// false: X = q, Y = dO, Z = k, W = v) or the dK/dV pass (kKV true: X = k,
// Y = v, Z = q, W = dO), each a (128, H, N, B) tensor map with 64 x 64
// boxes. out0 = dq or dk, out1 = dv (kKV) or unused; the outputs are
// (B, N_own, H, 128) contiguous, written where not null.
template <bool kKV>
__global__ void __launch_bounds__(kThreadsB, 1)
attention_bf16_backward_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap ymap,
                               const __grid_constant__ CUtensorMap zmap,
                               const __grid_constant__ CUtensorMap wmap,
                               const float* __restrict__ stats, int heads, int n_own,
                               int n_walk, int nq, float scale,
                               __nv_bfloat16* __restrict__ out0,
                               __nv_bfloat16* __restrict__ out1) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sx = smem_addr(base);
  const uint32_t sy = sx + kOwnBytes;
  const uint32_t sz = sy + kOwnBytes;                       // [stage] kWalkBytes
  const uint32_t sw = sz + kStages * kWalkBytes;            // [stage] kWalkBytes
  float* sstat = reinterpret_cast<float*>(base + 2 * kOwnBytes + 2 * kStages * kWalkBytes);
  const uint32_t bars = smem_addr(sstat + kStages * 3 * kWalk);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t own_bar = bars + 8 * 2 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int own0 = blockIdx.x * kOwn;
  const int n_tiles = (n_walk + kWalk - 1) / kWalk;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  // this head's statistics table, (T, 3, kWalk)
  const float* sth = stats + static_cast<long long>(bh) * ((nq + kWalk - 1) / kWalk) * 3 * kWalk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues the TMA copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid != 0) return;
    mbar_arrive_expect_tx(own_bar, 2 * kOwnBytes);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        const uint32_t off = half * kOwnHalf + rb * kBox;
        tma_box(sx + off, &xmap, half * 64, h, own0 + rb * 64, b, own_bar);
        tma_box(sy + off, &ymap, half * 64, h, own0 + rb * 64, b, own_bar);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
      const int j0 = t * kWalk;
      constexpr uint32_t kStatBytes = sizeof(float) * 3 * kWalk;
      mbar_arrive_expect_tx(full(s), 2 * kWalkBytes + (kKV ? kStatBytes : 0));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        tma_box(sz + s * kWalkBytes + half * kBox, &zmap, half * 64, h, j0, b, full(s));
        tma_box(sw + s * kWalkBytes + half * kBox, &wmap, half * 64, h, j0, b, full(s));
      }
      // in the dK/dV pass the walked queries' statistics
      if (kKV) {
        bulk_copy(smem_addr(sstat + s * 3 * kWalk), sth + t * 3 * kWalk, kStatBytes, full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows own0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    const int r0 = own0 + wg * 64 + warp * 16 + g;   // this thread's rows r0, r0 + 8
    // the dQ pass's own rows carry the statistics
    float m_row[2] = {0.f, 0.f}, linv_row[2] = {0.f, 0.f}, d_row[2] = {0.f, 0.f};
    if (!kKV) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = r0 + 8 * half;
        if (n < n_own) {
          const float* sn = sth + (n / kWalk) * 3 * kWalk + n % kWalk;
          m_row[half] = sn[0];
          linv_row[half] = sn[kWalk];
          d_row[half] = sn[2 * kWalk];
        }
      }
    }
    float acc0[64], acc1[kKV ? 64 : 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kKV ? 64 : 1); ++i) acc1[i] = 0.f;
    const uint32_t xa = sx + wg * kBox, ya = sy + wg * kBox;   // rows 64 wg .. of each half
    mbar_wait(own_bar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int j0 = t * kWalk;
      mbar_wait(full(s), (t / kStages) & 1);
      const uint32_t za = sz + s * kWalkBytes, wa = sw + s * kWalkBytes;
      const float* st = sstat + s * 3 * kWalk;

      // S (or S^T) and dP (or dP^T) as two groups: p is formed while dP
      // is still on the tensor cores, and in the dK/dV pass ds while dV is
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t own_off = (kk >> 2) * kOwnHalf + (kk & 3) * 32;
        const uint32_t walk_off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(sc, desc_kmajor(xa + own_off), desc_kmajor(za + walk_off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t own_off = (kk >> 2) * kOwnHalf + (kk & 3) * 32;
        const uint32_t walk_off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(dp, desc_kmajor(ya + own_off), desc_kmajor(wa + walk_off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      pin(sc);

      // element i of an accumulator: row r0 + 8 ((i >> 1) & 1), walked
      // column (i >> 2) * 8 + 2 t4 + (i & 1). A walked row past n_walk is
      // zeros (TMA's fill): in the dK/dV pass its query's 1 / l is 0 in the
      // table, so p is 0; in the dQ pass the last tile masks its keys (a
      // branch per tile: a select per element costs a branch per element)
      if (kKV || j0 + kWalk <= n_walk) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
          const float mq = kKV ? st[col] : m_row[(i >> 1) & 1];
          const float linv = kKV ? st[kWalk + col] : linv_row[(i >> 1) & 1];
          sc[i] = exp2f(fmaf(sc[i], scale_log2, -mq)) * linv;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
          const float p = exp2f(fmaf(sc[i], scale_log2, -m_row[(i >> 1) & 1])) *
                          linv_row[(i >> 1) & 1];
          sc[i] = j0 + col < n_walk ? p : 0.f;
        }
      }
      uint32_t pa[4][4], da[4][4];
      if constexpr (kKV) {   // dV += p^T . dO, walked rows 16 kk .. 16 kk + 15 the K
#pragma unroll
        for (int kk = 0; kk < kWalk / 16; ++kk) to_a_frag(sc, kk, pa[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWalk / 16; ++kk) {
          wgmma_m64n128k16_rs(acc1, pa[kk], desc_mnmajor(wa + kk * 16 * 128), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      pin(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
        const float dq = kKV ? st[2 * kWalk + col] : d_row[(i >> 1) & 1];
        dp[i] = (sc[i] * (dp[i] - dq)) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < kWalk / 16; ++kk) to_a_frag(dp, kk, da[kk]);
      pin(acc0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWalk / 16; ++kk) {   // dQ += ds . k  |  dK += ds^T . q
        wgmma_m64n128k16_rs(acc0, da[kk], desc_mnmajor(za + kk * 16 * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc0);
      pin(acc1);
      mbar_arrive(empty(s));
    }

    if (out0 != nullptr) store_rows_bf16(acc0, out0, b, h, heads, n_own, r0, t4);
    if constexpr (kKV) {
      if (out1 != nullptr) store_rows_bf16(acc1, out1, b, h, heads, n_own, r0, t4);
    }
  }
}

// ---- (2) fp32 as 3xTF32 on mma.sync, D = 512, Dv = 3 ----------------------

constexpr int kDF = 512;
constexpr int kDv = 3;
constexpr int kFT = 128;                 // output tile rows and columns
constexpr int kFK = 32;                  // depth a stage
constexpr int kFStages = 3;
constexpr int kThreadsF = 128;           // 2 x 2 warps of 64 x 64
constexpr int kLdK = kFK + 4;            // a (row, k) stage with k contiguous: 36 floats a row
constexpr int kLdR = kFT + 8;            // a (k, row) stage with rows contiguous: 136 floats a k
constexpr int kSlotF = kFT * kLdK;       // floats an operand stage (>= kFK * kLdR)
constexpr size_t kSmemF = sizeof(float) * kFStages * 2 * kSlotF;
static_assert(kFK * kLdR <= kSlotF, "a (k, row) stage fits an operand slot");
static_assert(kFT * (kFT + 1) + kFT * 10 <= kFStages * 2 * kSlotF,
              "the ds pass's epilogue fits the stages");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand of a 128-row tile product: element (row r, depth k) at
// p + r ld + k (kKContig) or p + k ld + r; rows < rows and k < depth are
// read, the rest staged as zeros (16-byte chunks along the contiguous axis,
// whose extent is a multiple of 4).
struct TileOperand {
  const float* p;
  long long ld;
  int rows;
  int depth;
};

template <bool kKContig>
__device__ __forceinline__ void stage_operand(float* dst, const TileOperand& op, int k0) {
  if (kKContig) {
    for (int i = threadIdx.x; i < kFT * (kFK / 4); i += kThreadsF) {
      const int r = i >> 3, c = (i & 7) * 4;
      const bool ok = r < op.rows && k0 + c < op.depth;
      cp_async16(dst + r * kLdK + c, ok ? op.p + r * op.ld + k0 + c : op.p, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kFK * (kFT / 4); i += kThreadsF) {
      const int kr = i >> 5, c = (i & 31) * 4;
      const bool ok = c < op.rows && k0 + kr < op.depth;
      cp_async16(dst + kr * kLdR + c, ok ? op.p + (k0 + kr) * op.ld + c : op.p, ok);
    }
  }
}

template <bool kKContig>
__device__ __forceinline__ float staged(const float* s, int row, int k) {
  return kKContig ? s[row * kLdK + k] : s[k * kLdR + row];
}

// acc (128 x 128, a warp's 64 x 64: element [i][j][e] at row wm + 16 i + g +
// 8 (e >> 1), column wn + 8 j + 2 t + (e & 1)) += A . B^T over depth, A and B
// 128-row operands, in 3xTF32. Leaves the stages free (synchronised).
template <bool kAK, bool kBK>
__device__ __forceinline__ void tile_product_3xtf32(float (&acc)[4][8][4], const TileOperand& a,
                                                    const TileOperand& b, int depth,
                                                    float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int nk = (depth + kFK - 1) / kFK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) {
      stage_operand<kAK>(smem + s * 2 * kSlotF, a, s * kFK);
      stage_operand<kBK>(smem + s * 2 * kSlotF + kSlotF, b, s * kFK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFStages - 2));
    __syncthreads();   // stage kt landed; stage kt - 1 consumed by every warp
    const int nxt = kt + kFStages - 1;
    if (nxt < nk) {
      float* slot = smem + (nxt % kFStages) * 2 * kSlotF;
      stage_operand<kAK>(slot, a, nxt * kFK);
      stage_operand<kBK>(slot + kSlotF, b, nxt * kFK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const float* sa = smem + (kt % kFStages) * 2 * kSlotF;
    const float* sb = sa + kSlotF;
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 8) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + 16 * i + g;
        split_tf32(staged<kAK>(sa, r, kk + t), ahi[i][0], alo[i][0]);
        split_tf32(staged<kAK>(sa, r + 8, kk + t), ahi[i][1], alo[i][1]);
        split_tf32(staged<kAK>(sa, r, kk + t + 4), ahi[i][2], alo[i][2]);
        split_tf32(staged<kAK>(sa, r + 8, kk + t + 4), ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wn + 8 * j + g;
        uint32_t bhi[2], blo[2];
        split_tf32(staged<kBK>(sb, n, kk + t), bhi[0], blo[0]);
        split_tf32(staged<kBK>(sb, n, kk + t + 4), bhi[1], blo[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_tf32(acc[i][j], alo[i], bhi);
          mma_tf32(acc[i][j], ahi[i], blo);
          mma_tf32(acc[i][j], ahi[i], bhi);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Pass (a): block (key tile, query tile, b H + h) forms S = q . k^T over
// D, p, dP = dO . v^T and ds; writes ds (B H, Nq, mp) fp32 where not null
// (columns M .. mp - 1 as zeros) and, where dv_part is not null, its keys'
// pT . dO over its 128 queries to dv_part (B H, ceil(Nq / 128), M, 3).
__global__ void __launch_bounds__(kThreadsF)
attention_f32_ds_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_out,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        const float* __restrict__ delta, int heads, int nq, int m, int mp,
                        long long qb, long long qr, long long kb, long long kr, long long vb,
                        long long vr, float scale, float* __restrict__ ds,
                        float* __restrict__ dv_part) {
  extern __shared__ __align__(16) float smem_f[];
  const int bh = blockIdx.z;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.y * kFT, k0 = blockIdx.x * kFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  const TileOperand qa{q + b * qb + static_cast<long long>(h) * kDF + q0 * qr, qr, nq - q0, kDF};
  const TileOperand kbo{k + b * kb + static_cast<long long>(h) * kDF + k0 * kr, kr, m - k0, kDF};
  tile_product_3xtf32<true, true>(acc, qa, kbo, kDF, smem_f);

  // the epilogue's operands, in the free stages: per query m, 1 / l (0 past
  // Nq), delta, dO[3]; per key v[3] and a bias added to the scaled score
  // (-inf past M); p for the dv partials. p is 0 past Nq (1 / l is, and the
  // score is 0) and past M (its exp is): a product, not a select, which the
  // compiler would turn into a branch around every exp
  float* s_row = smem_f;                   // [kFT][6]
  float* s_col = s_row + kFT * 6;          // [kFT][4]
  float* s_p = s_col + kFT * 4;            // [kFT][kFT + 1]
  const long long stat0 = static_cast<long long>(bh) * nq;
  for (int i = threadIdx.x; i < kFT; i += kThreadsF) {
    const int n = q0 + i;
    const bool ok = n < nq;
    s_row[i * 6 + 0] = ok ? row_max[stat0 + n] : 0.f;
    s_row[i * 6 + 1] = ok ? 1.f / row_sum[stat0 + n] : 0.f;
    s_row[i * 6 + 2] = ok ? delta[stat0 + n] : 0.f;
    const float* dor = d_out + ((static_cast<long long>(b) * nq + n) * heads + h) * kDv;
    const int j = k0 + i;
    const float* vrow = v + b * vb + static_cast<long long>(j) * vr + h * kDv;
#pragma unroll
    for (int c = 0; c < kDv; ++c) {
      s_row[i * 6 + 3 + c] = ok ? dor[c] : 0.f;
      s_col[i * 4 + c] = j < m ? vrow[c] : 0.f;
    }
    s_col[i * 4 + 3] = j < m ? 0.f : -CUDART_INF_F;
  }
  __syncthreads();
  float* dsb = ds == nullptr ? nullptr : ds + (stat0 + q0) * mp + k0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + 16 * i + g + 8 * half;
      const float* rr = s_row + r * 6;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = wn + 8 * j + 2 * t;
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* cc = s_col + (c + e) * 4;
          const float dp = fmaf(rr[5], cc[2], fmaf(rr[4], cc[1], rr[3] * cc[0]));
          const float p = expf(__fmul_rn(acc[i][j][2 * half + e], scale) - rr[0] + cc[3]) * rr[1];
          out[e] = (p * (dp - rr[2])) * scale;
          if (dv_part != nullptr) s_p[r * (kFT + 1) + c + e] = p;
        }
        if (dsb != nullptr && q0 + r < nq && k0 + c < mp) {
          *reinterpret_cast<float2*>(dsb + static_cast<long long>(r) * mp + c) =
              make_float2(out[0], out[1]);
        }
      }
    }
  }
  if (dv_part != nullptr) {
    __syncthreads();
    const int key = k0 + threadIdx.x;   // a thread a key (kFT == kThreadsF), queries in order
    float sum[kDv] = {0.f, 0.f, 0.f};
    for (int r = 0; r < kFT; ++r) {
      const float p = s_p[r * (kFT + 1) + threadIdx.x];
#pragma unroll
      for (int c = 0; c < kDv; ++c) sum[c] = fmaf(p, s_row[r * 6 + 3 + c], sum[c]);
    }
    if (key < m) {
      float* dst =
          dv_part + ((static_cast<long long>(bh) * gridDim.y + blockIdx.y) * m + key) * kDv;
#pragma unroll
      for (int c = 0; c < kDv; ++c) dst[c] = sum[c];
    }
  }
}

// Pass (b): dq = ds . k (blockIdx.x < 4 when dq is asked for) and dk =
// dsT . q, a block a 128 x 128 tile (columns c0 = 128 (blockIdx.x % 4),
// rows 128 blockIdx.y) of one b H + h.
__global__ void __launch_bounds__(kThreadsF)
attention_f32_grad_kernel(const float* __restrict__ ds, const float* __restrict__ q,
                          const float* __restrict__ k, int heads, int nq, int m, int mp,
                          long long qb, long long qr, long long kb, long long kr,
                          float* __restrict__ dq, float* __restrict__ dk) {
  extern __shared__ __align__(16) float smem_f[];
  const bool is_dk = dq == nullptr || blockIdx.x >= kDF / kFT;
  const int bh = blockIdx.z;
  const int b = bh / heads, h = bh - b * heads;
  const int c0 = (blockIdx.x % (kDF / kFT)) * kFT, r0 = blockIdx.y * kFT;
  const int n_rows = is_dk ? m : nq;
  if (r0 >= n_rows) return;
  const float* dsb = ds + static_cast<long long>(bh) * nq * mp;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  if (!is_dk) {   // A(r, j) = ds[r0 + r, j], B(c, j) = k[j, c0 + c]
    const TileOperand a{dsb + static_cast<long long>(r0) * mp, mp, nq - r0, mp};
    const TileOperand bo{k + b * kb + static_cast<long long>(h) * kDF + c0, kr, kDF - c0, m};
    tile_product_3xtf32<true, false>(acc, a, bo, m, smem_f);
  } else {        // A(r, n) = ds[n, r0 + r], B(c, n) = q[n, c0 + c]
    const TileOperand a{dsb + r0, mp, mp - r0, nq};
    const TileOperand bo{q + b * qb + static_cast<long long>(h) * kDF + c0, qr, kDF - c0, nq};
    tile_product_3xtf32<false, false>(acc, a, bo, nq, smem_f);
  }
  float* out = is_dk ? dk : dq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = r0 + wm + 16 * i + g + 8 * half;
      if (n >= n_rows) continue;
      float* op = out + ((static_cast<long long>(b) * n_rows + n) * heads + h) * kDF + c0 + wn;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(op + 8 * j + 2 * t) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

// The backward of attention_bf16_forward: q (B, Nq, H, 128), k and v
// (B, M, H, 128) bf16 with their batch and row strides in elements (16-byte
// aligned rows, the last axis contiguous), the forward's output o and the
// output's cotangent d_out (B, Nq, H, 128) bf16 contiguous, its row_max
// and row_sum (B, H, Nq) fp32; stats, a (B H, ceil(Nq / 64), 3, 64) fp32
// scratch for the queries' m, 1 / l and delta -> dq (B, Nq, H, 128), dk
// and dv (B, M, H, 128) bf16 contiguous. The dQ pass runs when dq is not
// null, the dK/dV pass when dk or dv is not null. Launches on `stream`
// without synchronising; returns cudaGetLastError(), cudaErrorInvalidValue
// for an empty input, B * H > 65535 or strides a tensor map refuses,
// cudaErrorNotSupported where libcuda lacks cuTensorMapEncodeTiled.
int attention_bf16_backward(const void* q, const void* k, const void* v, const void* o,
                            const void* d_out, const float* row_max,
                            const float* row_sum, int batch, int heads, int nq, int m,
                            long long qb, long long qr, long long kb, long long kr,
                            long long vb, long long vr, float scale, float* stats,
                            void* dq, void* dk, void* dv, void* stream) {
  if (bad_shape(batch, heads, nq, m)) return static_cast<int>(cudaErrorInvalidValue);
  if (dq == nullptr && dk == nullptr && dv == nullptr) return static_cast<int>(cudaSuccess);
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm, om;
  if (!head_map(encode, &qm, q, heads, nq, batch, qr, qb) ||
      !head_map(encode, &km, k, heads, m, batch, kr, kb) ||
      !head_map(encode, &vm, v, heads, m, batch, vr, vb) ||
      !head_map(encode, &om, d_out, heads, nq, batch, static_cast<long long>(heads) * kD,
                static_cast<long long>(nq) * heads * kD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const int n_tiles = (nq + kWalk - 1) / kWalk;
  attention_bf16_stats_kernel<<<dim3(n_tiles * kWalk / 16, batch * heads), 256, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(d_out), row_max, row_sum, heads, nq,
      n_tiles, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dq != nullptr) {
    if ((err = allow_smem(attention_bf16_backward_kernel<false>, kSmemB)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((nq + kOwn - 1) / kOwn, batch * heads);
    attention_bf16_backward_kernel<false><<<grid, kThreadsB, kSmemB, s>>>(
        qm, om, km, vm, stats, heads, nq, m, nq, scale,
        static_cast<bf*>(dq), nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dk != nullptr || dv != nullptr) {
    if ((err = allow_smem(attention_bf16_backward_kernel<true>, kSmemB)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((m + kOwn - 1) / kOwn, batch * heads);
    attention_bf16_backward_kernel<true><<<grid, kThreadsB, kSmemB, s>>>(
        km, vm, qm, om, stats, heads, m, nq, nq, scale,
        static_cast<bf*>(dk), static_cast<bf*>(dv));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of attention_f32_forward at D = 512: q (B, Nq, H, 512) and k
// (B, M, H, 512) fp32 with 16-byte aligned rows, v (B, M, H, 3), strides as
// above; d_out (B, Nq, H, 3) fp32 contiguous, row stats and delta as above.
// ds: a (B H, Nq, mp) fp32 scratch (mp >= M, a multiple of 4), needed for
// dq or dk; dv_part: (B H, ceil(Nq / 128), M, 3) fp32, dv's partials over
// blocks of 128 queries, written where not null, for the caller to sum over
// its second axis -> dq (B, Nq, H, 512), dk (B, M, H, 512) fp32 contiguous,
// each computed where not null.
int attention_f32_backward(const float* q, const float* k, const float* v,
                           const float* d_out, const float* row_max,
                           const float* row_sum, const float* delta, int batch,
                           int heads, int nq, int m, int d, long long qb,
                           long long qr, long long kb, long long kr, long long vb,
                           long long vr, float scale, int mp, float* ds, float* dv_part,
                           float* dq, float* dk, void* stream) {
  const bool grads = dq != nullptr || dk != nullptr;
  if (bad_shape(batch, heads, nq, m) || d != kDF || mp < m || mp % 4 != 0 ||
      (grads && ds == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!grads && dv_part == nullptr) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = allow_smem(attention_f32_ds_kernel, kSmemF)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid_a((m + kFT - 1) / kFT, (nq + kFT - 1) / kFT, batch * heads);
  attention_f32_ds_kernel<<<grid_a, kThreadsF, kSmemF, s>>>(
      q, k, v, d_out, row_max, row_sum, delta, heads, nq, m, mp, qb, qr, kb, kr, vb, vr,
      scale, grads ? ds : nullptr, dv_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (grads) {
    if ((err = allow_smem(attention_f32_grad_kernel, kSmemF)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int problems = (dq != nullptr) + (dk != nullptr);
    const int rows = (nq > m ? nq : m);
    const dim3 grid_b(problems * (kDF / kFT), (rows + kFT - 1) / kFT, batch * heads);
    attention_f32_grad_kernel<<<grid_b, kThreadsF, kSmemF, s>>>(
        ds, q, k, heads, nq, m, mp, qb, qr, kb, kr, dq, dk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
