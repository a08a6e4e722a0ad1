// Attention forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernels `_attn_forward` (mvp_benchmark_tpu/ops/pallas_kernels.py
// :2449, bodies `_attn_fwd_kernel` :2283 and `_attn_fwd_save_kernel` :2288),
// the forward of `fused_attention` :2427, and `_attn_forward_bnhd` :2637, the
// forward of `fused_attention_bnhd` :2610. Per head and query row:
//
//   out[n] = softmax_j(q[n] . k[j] * scale) . v[j]
//
// the semantics of ops/ref.py `attention`. The TPU kernel keeps the whole
// (M, D) key and value panes in VMEM and runs one exact softmax pass per
// q-tile; here the keys are walked in tiles and the softmax is combined
// across them (FlashAttention): a row max m and row sum l in fp32, the
// output rescaled by exp(m_old - m_new) at each tile and divided by l at
// the end. The plain version normalises p before its product with v, so the
// two round differently and agree to a tolerance. The final m (the max of
// the scaled scores) and l of every row can be written out: the backward
// (attention_backward.cu) rebuilds p from them, as `_attn_bwd_split` :2502
// does. Each output is written once by one block, from sums in a fixed
// order, so two runs are bitwise equal.
//
// Layout: q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, Dv), read in place,
// with each tensor's batch and row strides in elements (head h of row n at
// n * row_stride + h * D; the last axis contiguous). The (B, N, D) entry of
// `fused_attention` is the case H = 1. out is (B, Nq, H, Dv) contiguous;
// row_max and row_sum (B, H, Nq) fp32, or null.
//
// 1. bf16, D = Dv = 128: the transformer's heads (B 32, N = M = 2048, H 4;
//    six calls a batch or step). Bound: operations, 4 B H Nq M D = 275
//    GFLOP, 0.28 ms at the 989 TFLOP/s bf16 dense peak; the bytes (4 x 67
//    MB) 0.08 ms. The first version (mma.sync with ldmatrix fragments, 4
//    warps of 16 rows, 64-key tiles behind two cp.async stages and a
//    barrier pair a tile) ran at 2.5x scaled_dot_product_attention. This
//    one is the heads' backward turned forward:
//    - one persistent block an SM walks items of 128 queries, 64 for each
//      of two consumer warpgroups, loaded by TMA (4-D tensor maps over the
//      heads in place, 64 x 64 boxes) into 128-byte-swizzled shared memory;
//      one producer thread streams the K and V tiles (kKeys keys each)
//      through a ring of kStagesB stages, each an mbarrier pair (full: the
//      bytes; empty: the 256 consumer threads), and loads the next item's Q
//      and first tiles while the consumers finish this one; setmaxnreg
//      gives the consumers 240 registers and the producer 24;
//    - a consumer forms its 64 x kKeys scores with wgmma from shared memory
//      (K-major A and B, no fragment loads), takes the tile's row max of the
//      raw scores (scale > 0, so m = max * scale is the max of the scaled
//      scores), forms p = exp2(s scale log2(e) - m log2(e)) in registers
//      (ex2.approx.ftz, one instruction), rounds p to bf16 straight into A
//      fragments and accumulates O += P . V into a 64 x 128 fp32 tile in
//      registers with wgmma.m64n128k16 (A from registers, B MN-major: the V
//      tile as it lies), the next tile's scores issued with it and its
//      softmax formed while it runs. O leaves as bf16 once, at the end,
//      after the division by l. The two consumer warpgroups taking turns
//      on the tensor cores on named barriers (FlashAttention-3's ping-pong)
//      measured no faster, and is not done.
//    - keys past M arrive as zeros (TMA's fill) and the last tile masks
//      them, a branch a tile (a select an element makes the compiler branch
//      around each exp); queries past Nq arrive as zeros and are not stored.
//    As `_attn_math_fwd` :2235: bf16 operands, fp32 scores, fp32 softmax,
//    p rounded to bf16 before P.V, fp32 accumulation, out rounded to bf16
//    once; but p is rounded before the division by l.
//
// 2. fp32, D any multiple of 32, Dv = 3: the svd head's soft correspondence
//    (B 32, N = M = 2048, D 512, v = the target cloud). The TPU pads v to 128
//    lanes and rounds q and k to bf16; the port keeps the svd head in fp32 (the
//    JAX package's CPU path) and reads the 3-wide v as it is. Bound:
//    operations, 2 B Nq M (D + Dv) = 138 GFLOP, 2.06 ms at the 67 TFLOP/s
//    fp32 peak; formed as 3xTF32, three TF32 products of 137 GFLOP at the
//    495 TFLOP/s TF32 peak and the 3-wide product on fp32 cores, ~0.85 ms;
//    the bytes (268 MB) 0.08 ms. The first version (an SGEMM register tile
//    on CUDA cores, every 32-deep chunk loaded, synced and used with no
//    copy in flight) ran at 1.14x scaled_dot_product_attention. This one
//    forms the scores as 3xTF32 (x = hi + lo, hi . hi + hi . lo + lo . hi,
//    fp32-accurate; hopper.cuh `split_tf32`) on wgmma, which takes TF32
//    operands K-major, as q and k lie; in two passes, one launch count:
//    (a) the partials pass: a block of two warpgroups owns a 128-query x
//        128-key tile; the threads load each 32-deep chunk of q and k two
//        chunks ahead into registers, split it and store hi and lo with
//        the 128-byte swizzle into one of two buffers, while
//        wgmma.m64n128k8 reads the other; the block then writes the tile's
//        row max, row sum of exp(s - max) and 3-wide p . v: 5 floats a
//        (query, key tile), (B H, ceil(M / 128), 5, Nq), 21 MB at DCP's
//        shape;
//    (b) the combine pass: a thread a query merges its partials in key-tile
//        order into out, m and l.
//    A full 128 x 512 fp32 q tile (256 KB) does not fit in shared memory, so
//    a block cannot keep its queries and walk every key in one pass. The
//    backward's mma.sync core (split in registers) took ~1.25x as long.

#include "hopper.cuh"

namespace {

// ---- (1) bf16 on wgmma, D = Dv = 128 --------------------------------------

// keys a K or V tile, and the ring's stages: 128 keys in 3 stages measured
// faster than 64 in 3 or 128 in 2 (PERF.md §6)
constexpr int kQRows = 128;              // query rows a block, 64 a consumer warpgroup
constexpr int kKeys = 128;               // two TMA boxes deep
constexpr int kStagesB = 3;
constexpr int kConsumers = 2;            // consumer warpgroups; the producer is the third
constexpr int kThreadsB = 128 * (kConsumers + 1);
constexpr int kQHalf = 2 * kBox;         // one 64-column half of the Q tile (128 rows)
constexpr int kQBytes = 2 * kQHalf;      // the Q tile, 128 x 128 bf16
constexpr int kKeyHalf = kKeys * 128;    // one 64-column half of a K or V tile
constexpr int kTileBytes = 2 * kKeyHalf; // a K or V tile, kKeys x 128 bf16
constexpr size_t kSmemB = 1024 +         // slack to align the tiles to 1024 bytes
                          kQBytes + 2 * kStagesB * kTileBytes +
                          sizeof(uint64_t) * (2 * kStagesB + 2);
static_assert(kSmemB <= 232448, "the ring fits a block's shared memory");

// s (64 x kKeys, fp32) = Q (64 rows at qa) . K (kKeys rows at ka)^T over D
__device__ __forceinline__ void scores(float (&s)[kKeys / 2], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t da = desc_kmajor(qa + (kk >> 2) * kQHalf + (kk & 3) * 32);
    const uint64_t db = desc_kmajor(ka + (kk >> 2) * kKeyHalf + (kk & 3) * 32);
    wgmma_m64n128k16_ss(s, da, db, kk > 0);
  }
}

// 2^x, flushing results below 2^-126 to zero (one MUFU instruction; p that
// small is lost against l >= 1 all the same)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the A fragments of a wgmma in flight live until it is waited for
template <int N>
__device__ __forceinline__ void pin_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// o (64 x 128, fp32) += p (64 x kKeys, bf16 A fragments) . V (the kKeys x
// 128 tile at va, MN-major); keys 16 kk .. 16 kk + 15 are k-step kk
__device__ __forceinline__ void pv_product(float (&o)[64], const uint32_t (&pa)[kKeys / 16][4],
                                           uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_m64n128k16_rs(o, pa[kk], desc_mnmajor<kKeyHalf>(va + kk * 16 * 128), 1);
  }
}

// The softmax of keys j0 .. j0 + kKeys - 1 over a thread's rows (element i
// of an accumulator: row 8 ((i >> 1) & 1) of its two, key j0 + (i >> 2) * 8
// + 2 t4 + (i & 1)): the new row max of the raw scores mraw, o's rescale
// alpha = exp(m_old - m_new), p = exp(s - m_new) in place of s (fp32), l
// rescaled and summed. Keys past m (the last tile's, TMA's zeros) are
// masked, a branch a tile.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&mraw)[2], float (&l)[2],
                                               float (&alpha)[2], int j0, int m, int t4,
                                               float scale_log2) {
  if (j0 + 2 * N > m) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (j0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= m) sc[i] = -CUDART_INF_F;
    }
  }
  float mx[2] = {mraw[0], mraw[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mb[r] = mx[r] * scale_log2;
    alpha[r] = exp2_ftz(fmaf(mraw[r], scale_log2, -mb[r]));   // 0 at the first tile
    mraw[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -mb[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// o rescaled by alpha (once the p . V in flight has left it), p rounded to
// bf16 into the A fragments of the next p . V
template <int N>
__device__ __forceinline__ void rescale_and_pack(float (&o)[64], const float (&alpha)[2],
                                                 const float (&sc)[N],
                                                 uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) to_a_frag(sc, kk, pa[kk]);
}

// Q, K and V as (128, H, N, B) tensor maps with 64 x 64 boxes; out (B, Nq, H,
// 128) bf16 contiguous; row_max and row_sum (B, H, Nq) where not null. A
// persistent block walks the items (b H + h, 128-query tile) blockIdx.x,
// blockIdx.x + gridDim.x, ..., so that the producer loads the next item's
// Q and first K and V tiles while the consumers finish this one.
__global__ void __launch_bounds__(kThreadsB, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, int heads, int nq, int m,
                      int n_items, float scale, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ row_max, float* __restrict__ row_sum) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_addr(base);
  const uint32_t sk = sq + kQBytes;                       // [stage] kTileBytes
  const uint32_t sv = sk + kStagesB * kTileBytes;         // [stage] kTileBytes
  const uint32_t bars = sv + kStagesB * kTileBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStagesB + s); };
  const uint32_t q_full = bars + 8 * 2 * kStagesB;        // Q landed
  const uint32_t q_empty = q_full + 8;                    // Q's last product done

  const int q_tiles = (nq + kQRows - 1) / kQRows;
  const int n_tiles = (m + kKeys - 1) / kKeys;            // K and V tiles an item
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues the TMA copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid != 0) return;
    int c = 0;   // K and V tiles loaded so far, over all items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / q_tiles, q0 = (item - bh * q_tiles) * kQRows;
      const int b = bh / heads, h = bh - b * heads;
      mbar_wait(q_empty, (it & 1) ^ 1);
      mbar_arrive_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          tma_box(sq + half * kQHalf + rb * kBox, &qmap, half * 64, h, q0 + rb * 64, b, q_full);
        }
      }
      for (int t = 0; t < n_tiles; ++t, ++c) {
        const int s = c % kStagesB;
        mbar_wait(empty(s), ((c / kStagesB) & 1) ^ 1);
        const int j0 = t * kKeys;
        mbar_arrive_expect_tx(full(s), 2 * kTileBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int rb = 0; rb < kKeys / 64; ++rb) {
            const uint32_t off = s * kTileBytes + half * kKeyHalf + rb * kBox;
            tma_box(sk + off, &kmap, half * 64, h, j0 + rb * 64, b, full(s));
            tma_box(sv + off, &vmap, half * 64, h, j0 + rb * 64, b, full(s));
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale_log2 = scale * kLog2e;
    const uint32_t qa = sq + wg * kBox;               // rows 64 wg .. of each half
    // Tile t's scores go to the tensor cores together with tile t - 1's
    // p . V, and tile t's softmax runs while p . V does (FlashAttention-3's
    // intra-warpgroup pipelining); stage t - 1 is released once both of its
    // products are done, Q once the item's last scores are.
    int c = 0;   // K and V tiles consumed so far, over all items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / q_tiles, q0 = (item - bh * q_tiles) * kQRows;
      const int b = bh / heads, h = bh - b * heads;
      const int r0 = q0 + wg * 64 + warp * 16 + g;   // this thread's rows r0, r0 + 8
      // element i of an accumulator: row r0 + 8 ((i >> 1) & 1), column
      // (i >> 2) * 8 + 2 t4 + (i & 1)
      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float mraw[2] = {-CUDART_INF_F, -CUDART_INF_F};   // row max of the raw scores
      float l[2] = {0.f, 0.f};                          // this thread's part of l
      float sc[kKeys / 2];                              // a tile's scores, then p
      float alpha[2];                                   // o's rescale for the tile
      uint32_t pa[kKeys / 16][4];                       // p in bf16 A fragments

      mbar_wait(q_full, it & 1);
      mbar_wait(full(c % kStagesB), (c / kStagesB) & 1);
      wgmma_fence();
      scores(sc, qa, sk + (c % kStagesB) * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      if (n_tiles == 1) mbar_arrive(q_empty);
      online_softmax(sc, mraw, l, alpha, 0, m, t4, scale_log2);
      rescale_and_pack(o, alpha, sc, pa);
      for (int t = 1; t < n_tiles; ++t) {
        const int s = (c + t) % kStagesB, prev = (c + t - 1) % kStagesB;
        mbar_wait(full(s), ((c + t) / kStagesB) & 1);
        wgmma_fence();
        scores(sc, qa, sk + s * kTileBytes);
        wgmma_commit();
        pv_product(o, pa, sv + prev * kTileBytes);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);
        if (t == n_tiles - 1) mbar_arrive(q_empty);
        online_softmax(sc, mraw, l, alpha, t * kKeys, m, t4, scale_log2);
        wgmma_wait<0>();
        pin(o);
        pin_frags(pa);
        mbar_arrive(empty(prev));
        rescale_and_pack(o, alpha, sc, pa);
      }
      c += n_tiles;
      const int last = (c - 1) % kStagesB;
      wgmma_fence();
      pv_product(o, pa, sv + last * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin_frags(pa);
      mbar_arrive(empty(last));

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= inv[(i >> 1) & 1];
      store_rows_bf16(o, out, b, h, heads, nq, r0, t4);
      if (row_max != nullptr && t4 == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = r0 + 8 * half;
          if (n < nq) {
            row_max[static_cast<long long>(bh) * nq + n] = mraw[half] * scale;
            row_sum[static_cast<long long>(bh) * nq + n] = l[half];
          }
        }
      }
    }
  }
}

// ---- (2) fp32 as 3xTF32 on wgmma, D % 32 == 0, Dv = 3 --------------------

constexpr int kDv = 3;
constexpr int kParts = 2 + kDv;          // a (query, key tile): max, sum, p . v
constexpr int kTileT = 128;              // queries and keys a block
constexpr int kThreadsT = 256;           // two warpgroups of 64 queries
constexpr int kChunkT = 32;              // depth a step: a 128-byte row of TF32
constexpr int kSplitBytes = kTileT * 128;        // one split operand, 128 rows
constexpr int kBufBytes = 4 * kSplitBytes;       // q hi, q lo, k hi, k lo
constexpr size_t kSmemT = 1024 + 2 * kBufBytes + sizeof(float) * kTileT * 4;

// d (64 x 128, fp32) += A (64 x 8, TF32 in shared memory, K-major) .
// B (128 x 8, TF32, K-major)^T
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// A thread's four 16-byte pieces of a 128 x 32 fp32 chunk (piece e = tid +
// 256 j: row e / 8, columns 4 (e % 8) ..), rows past `rows` as zeros
__device__ __forceinline__ void load_chunk(float4 (&x)[4], const float* p, long long ld,
                                           int rows, int c0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = threadIdx.x + kThreadsT * j, row = e >> 3, c4 = e & 7;
    x[j] = row < rows ? __ldg(reinterpret_cast<const float4*>(p + row * ld + c0 + 4 * c4))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the pieces split into TF32 hi and lo (split_tf32) and stored K-major with
// the 128-byte swizzle (16-byte piece c of row r at r 128 + (c ^ r % 8) 16)
__device__ __forceinline__ void store_split(const float4 (&x)[4], uint32_t hi, uint32_t lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = threadIdx.x + kThreadsT * j, row = e >> 3, c4 = e & 7;
    const uint32_t off = row * 128 + ((c4 ^ (row & 7)) << 4);
    uint32_t h[4], l[4];
    split_tf32(x[j].x, h[0], l[0]);
    split_tf32(x[j].y, h[1], l[1]);
    split_tf32(x[j].z, h[2], l[2]);
    split_tf32(x[j].w, h[3], l[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + off), "r"(h[0]),
                 "r"(h[1]), "r"(h[2]), "r"(h[3]) : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + off), "r"(l[0]),
                 "r"(l[1]), "r"(l[2]), "r"(l[3]) : "memory");
  }
}

// Pass (a): block (key tile, query tile, b H + h) forms S = q . k^T over D
// as lo . hi + hi . lo + hi . hi on wgmma, and writes its rows' max of the
// scaled scores, sum of exp(s - max) and p . v to part (B H, gridDim.x,
// kParts, Nq). The 32-deep chunks are split in two buffers: the threads
// split chunk c + 1 into one while the tensor cores read chunk c from the
// other.
__global__ void __launch_bounds__(kThreadsT, 1)
attention_f32_partials_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, int heads, int nq, int m, int d,
                              long long qb, long long qr, long long kb, long long kr,
                              long long vb, long long vr, float scale,
                              float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbuf = smem_addr(base);                       // [2] kBufBytes
  float* s_col = reinterpret_cast<float*>(base + 2 * kBufBytes);   // [kTileT][4]
  const int bh = blockIdx.z;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.y * kTileT, k0 = blockIdx.x * kTileT;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qp = q + b * qb + static_cast<long long>(h) * d + q0 * qr;
  const float* kp = k + b * kb + static_cast<long long>(h) * d + k0 * kr;

  // per key v[3] and a bias added to the scaled score (-inf past M: an
  // add, not a select, which the compiler would turn into a branch around
  // every exp)
  if (threadIdx.x < kTileT) {
    const int j = k0 + threadIdx.x;
    const float* vrow = v + b * vb + static_cast<long long>(j) * vr + h * kDv;
#pragma unroll
    for (int c = 0; c < kDv; ++c) s_col[threadIdx.x * 4 + c] = j < m ? vrow[c] : 0.f;
    s_col[threadIdx.x * 4 + 3] = j < m ? 0.f : -CUDART_INF_F;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // chunk c + 1 and c + 2 in flight from device memory in two register sets
  // (odd chunks in set 1, even in set 2) while the tensor cores take chunk c
  float4 q1[4], k1[4], q2[4], k2[4];
  const int n_chunks = d / kChunkT;
  load_chunk(q2, qp, qr, nq - q0, 0);
  load_chunk(k2, kp, kr, m - k0, 0);
  store_split(q2, sbuf, sbuf + kSplitBytes);
  store_split(k2, sbuf + 2 * kSplitBytes, sbuf + 3 * kSplitBytes);
  if (n_chunks > 1) {
    load_chunk(q1, qp, qr, nq - q0, kChunkT);
    load_chunk(k1, kp, kr, m - k0, kChunkT);
  }
  if (n_chunks > 2) {
    load_chunk(q2, qp, qr, nq - q0, 2 * kChunkT);
    load_chunk(k2, kp, kr, m - k0, 2 * kChunkT);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t buf = sbuf + (c & 1) * kBufBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunkT / 8; ++kk) {
      const uint32_t a = buf + wg * 64 * 128 + kk * 32, bk = buf + 2 * kSplitBytes + kk * 32;
      const uint64_t a_hi = desc_kmajor(a), a_lo = desc_kmajor(a + kSplitBytes);
      const uint64_t b_hi = desc_kmajor(bk), b_lo = desc_kmajor(bk + kSplitBytes);
      wgmma_m64n128k8_tf32(acc, a_lo, b_hi);
      wgmma_m64n128k8_tf32(acc, a_hi, b_lo);
      wgmma_m64n128k8_tf32(acc, a_hi, b_hi);
    }
    wgmma_commit();
    if (c + 1 < n_chunks) {   // chunk c + 1 into the other buffer, free since
                              // the last step's products ended; c + 3 loaded
      const uint32_t nbuf = sbuf + ((c + 1) & 1) * kBufBytes;
      const int c3 = (c + 3) * kChunkT;
      if ((c + 1) & 1) {
        store_split(q1, nbuf, nbuf + kSplitBytes);
        store_split(k1, nbuf + 2 * kSplitBytes, nbuf + 3 * kSplitBytes);
        if (c + 3 < n_chunks) {
          load_chunk(q1, qp, qr, nq - q0, c3);
          load_chunk(k1, kp, kr, m - k0, c3);
        }
      } else {
        store_split(q2, nbuf, nbuf + kSplitBytes);
        store_split(k2, nbuf + 2 * kSplitBytes, nbuf + 3 * kSplitBytes);
        if (c + 3 < n_chunks) {
          load_chunk(q2, qp, qr, nq - q0, c3);
          load_chunk(k2, kp, kr, m - k0, c3);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    wgmma_wait<0>();
    pin(acc);
    __syncthreads();   // both warpgroups' products of this buffer done
  }

  // element i of acc: row 64 wg + 16 warp + g + 8 ((i >> 1) & 1), key
  // (i >> 2) * 8 + 2 t + (i & 1); a row's 128 keys lie in the 4 lanes of
  // a quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 2 * r; i < 64; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = (i >> 2) * 8 + 2 * t + e;
        acc[i + e] = fmaf(acc[i + e], scale, s_col[key * 4 + 3]);
        mx = fmaxf(mx, acc[i + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 2 * r; i < 64; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* cc = s_col + ((i >> 2) * 8 + 2 * t + e) * 4;
        const float p = expf(acc[i + e] - mx);
        sum[0] += p;
#pragma unroll
        for (int c = 0; c < kDv; ++c) sum[1 + c] = fmaf(p, cc[c], sum[1 + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], 1);
      sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], 2);
    }
    const int n = q0 + wg * 64 + warp * 16 + g + 8 * r;
    if (t == 0 && n < nq) {
      float* dst =
          part + (static_cast<long long>(bh) * gridDim.x + blockIdx.x) * kParts * nq + n;
      dst[0] = mx;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[static_cast<long long>(1 + c) * nq] = sum[c];
    }
  }
}

// Pass (b): a thread a query merges its n_tiles partials in key-tile order.
__global__ void __launch_bounds__(128)
attention_f32_combine_kernel(const float* __restrict__ part, int heads, int nq, int n_tiles,
                             float* __restrict__ out, float* __restrict__ row_max,
                             float* __restrict__ row_sum) {
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int n = blockIdx.x * 128 + threadIdx.x;
  if (n >= nq) return;
  const float* p = part + static_cast<long long>(bh) * n_tiles * kParts * nq + n;
  const long long step = static_cast<long long>(nq);
  float mx = -CUDART_INF_F;
  for (int t = 0; t < n_tiles; ++t) mx = fmaxf(mx, p[t * kParts * step]);
  float l = 0.f, o[kDv] = {0.f, 0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const float* pt = p + t * kParts * step;
    const float w = expf(pt[0] - mx);
    l = fmaf(pt[step], w, l);
#pragma unroll
    for (int c = 0; c < kDv; ++c) o[c] = fmaf(pt[(2 + c) * step], w, o[c]);
  }
  float* op = out + ((static_cast<long long>(b) * nq + n) * heads + h) * kDv;
#pragma unroll
  for (int c = 0; c < kDv; ++c) op[c] = o[c] / l;
  if (row_max != nullptr) {
    row_max[static_cast<long long>(bh) * nq + n] = mx;
    row_sum[static_cast<long long>(bh) * nq + n] = l;
  }
}

}  // namespace

extern "C" {

// q (B, Nq, H, 128), k and v (B, M, H, 128) bf16 on the device, each with
// its batch and row strides in elements (16-byte aligned rows, the last axis
// contiguous), scale > 0 -> out (B, Nq, H, 128) bf16 contiguous, and the
// final row max and row sum (B, H, Nq) fp32 where row_max is not null.
// Launches on `stream` without synchronising; returns cudaGetLastError(),
// cudaErrorInvalidValue for an empty input, B * H > 65535 or strides a
// tensor map refuses, cudaErrorNotSupported where libcuda lacks
// cuTensorMapEncodeTiled.
int attention_bf16_forward(const void* q, const void* k, const void* v,
                           int batch, int heads, int nq, int m, long long qb,
                           long long qr, long long kb, long long kr,
                           long long vb, long long vr, float scale, void* out,
                           float* row_max, float* row_sum, void* stream) {
  if (bad_shape(batch, heads, nq, m)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!head_map(encode, &qm, q, heads, nq, batch, qr, qb) ||
      !head_map(encode, &km, k, heads, m, batch, kr, kb) ||
      !head_map(encode, &vm, v, heads, m, batch, vr, vb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(attention_bf16_kernel, kSmemB);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const int n_items = (nq + kQRows - 1) / kQRows * batch * heads;
  const int grid = n_items < sms ? n_items : sms;   // one persistent block an SM
  attention_bf16_kernel<<<grid, kThreadsB, kSmemB, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, heads, nq, m, n_items, scale, static_cast<__nv_bfloat16*>(out), row_max,
      row_sum);
  return static_cast<int>(cudaGetLastError());
}

// q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, 3) fp32 with D % 32 == 0,
// strides as above (q and k rows 16-byte aligned); part, a (B H,
// ceil(M / 128), 5, Nq) fp32 scratch for the partials pass -> out
// (B, Nq, H, 3) fp32 contiguous, row stats as above.
int attention_f32_forward(const float* q, const float* k, const float* v,
                          int batch, int heads, int nq, int m, int d,
                          long long qb, long long qr, long long kb, long long kr,
                          long long vb, long long vr, float scale, float* part,
                          float* out, float* row_max, float* row_sum, void* stream) {
  if (bad_shape(batch, heads, nq, m) || d < kChunkT || d % kChunkT != 0 || part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(attention_f32_partials_kernel, kSmemT);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (m + kTileT - 1) / kTileT;
  const dim3 grid_a(n_tiles, (nq + kTileT - 1) / kTileT, batch * heads);
  attention_f32_partials_kernel<<<grid_a, kThreadsT, kSmemT, s>>>(
      q, k, v, heads, nq, m, d, qb, qr, kb, kr, vb, vr, scale, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((nq + 127) / 128, batch * heads);
  attention_f32_combine_kernel<<<grid_b, 128, 0, s>>>(part, heads, nq, n_tiles, out, row_max,
                                                      row_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
