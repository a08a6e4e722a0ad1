// DGCNN's fused per-edge chain for Hopper (sm_90a), eval and train, with a
// plain C interface for ctypes.
//
// Replaces the TPU kernels of mvp_benchmark_tpu/ops/pallas_kernels.py's edge
// chain: `_edge_mlp_final_pass` :3025 (body `_em_final_kernel` :2828), which
// `edge_mlp_eval` :3155 runs with the running statistics and
// `_edge_mlp_forward` :3086 runs after its stat passes; `_edge_mlp_stat_pass`
// :3009 (body `_em_stat_kernel` :2800); and `_edge_mlp_bwd_pass` :3043 (body
// `_em_bwd_kernel` :2858, BatchNorm backward `_em_bnbwd` :2847), the five
// passes of `edge_mlp_train`'s backward :3124. Per edge (point p, neighbour
// j) of a1 (P, k, 6):
//
//   a_0 = a1[p, j];  for l = 0..3:
//     h_l = bf16(a_l) . bf16(W_l)           fp32 accumulation
//     a_{l+1} = relu(h_l * scale_l + shift_l)
//     x_l[p] = max_j a_{l+1}                 (P, ch_l) fp32
//
// with chs 64/64/128/256 and the BatchNorm folded to a per-channel scale and
// shift that the wrapper computes once per call (ops/ref.py
// `bn_scale_shift`), from the running statistics in eval and from the batch
// statistics in train: the semantics of ops/ref.py `edge_mlp_eval` and of
// `edge_mlp_train`'s forward. The products are summed in another order than
// the plain version's matmuls, and an activation that lands on the other
// side of a bf16 rounding carries that into the next layer, so the two agree
// to a tolerance.
//
// The final pass (edge_mlp_kernel), on the backward's machinery: a block is
// three warpgroups on wgmma; the weights, staged once a block in
// 128-byte-swizzled panels (~90 KB), are the B operand; each layer's
// accumulator, activated and packed to bf16, is the next product's A operand
// in registers, with no barrier between layers; layers 2 and 3 run in
// 64-column chunks, issued two at a time, so that a chunk's elementwise work
// overlaps the next chunk's product. Blocks are persistent, as many as the
// SMs hold, each warpgroup walking its rounds with a grid stride and loading
// the next tile's edges while it computes the current one. It walks rounds of
// 16 points, ceil(k / 4) tiles of 64 edges a round: row 16 w + g + 8 h of
// tile tau is point 4 w + (g >> 1), slot 4 tau + 2 (g & 1) + h. So a thread's
// two rows are two slots of one point and the lane g ^ 1 holds the tile's
// other two: the max over a tile's slots is a register max and one shuffle,
// which also leaves each lane half the columns. A round's running max-pools
// (16 points x 512 channels, 64 a thread) and slots stay in shared memory,
// each thread its own, until the round writes them. Only the four max-pools
// reach device memory (the (P, k, ch) activations never do) and, in train,
// each max-pool's argmax slot (P, 512) uint8: the first j reaching the max (a
// tie to the lower slot within a tile, a later tile only if larger), as
// torch.max routes its gradient (the TPU kernel finds the argmax again in its
// backward by float equality against a recompute, :2889). Slots past k and
// points past P read 0 and are not written.
// Its products sum each h in the tensor cores' order, the same for mma.sync
// and wgmma: given the same scale and shift its max-pools and slots are
// bitwise those of the first design (mma.sync tiles of 16 points).
//
// The stat passes (edge_mlp_stat_kernel<l>), on the same machinery: a
// block is three warpgroups on wgmma, each walking tiles of 64 flattened
// edges and running the chain up to layer l, whose h_l and h_l^2 each warp
// sums over its rows (a reduce-scatter of shuffles a 64-column chunk) into
// its lanes' running sums. The TPU adds every block into one accumulator in
// grid order, a race on a GPU: here the block's warps add their sums in
// warp order into one partial a block, and the wrapper adds the partials in
// a fixed order, so the statistics are the same from run to run. They sum
// in another order than the first design's stat passes (mma.sync tiles of
// 16 points walking their k slots): the DCP train step's check against the
// CPU (chip_smoke.py `check_dcp_step_on_cpu`) holds the statistics against
// the chain in fp64 and the step given them against the CPU's, stage by
// stage, so that a right summation order passes it.
//
// Backward passes (edge_mlp_backward_kernel), top-down as the TPU's: pass
// `level` (3, 2, 1, 0, -1) recomputes the chain for every edge, routes each
// max-pool's cotangent gx_l to its saved argmax slot, applies relu's mask and
// the BatchNorm backward with the sums S_l = [sum dy, sum dy hhat] of the
// layers above (found by the passes before) and pushes the cotangent down
// through W_l; pass 3 sums S_3, pass 2 S_2 and dW3's first 128 columns, pass
// 1 S_1 and its last 128, pass 0 S_0 and dW2, pass -1 dW1, dW0 and d_a1
// when asked (dW_{l+1} = a_{l+1}^T dh_{l+1}, formed in any pass at or below
// level l; spread so that no pass holds more than 64 KB of fp32 sums).
// dgamma_l = S_l[1], dbeta_l = S_l[0]. As `_em_bwd_kernel`: dh and a
// rounded to bf16 before their products, fp32 sums (ops/ref.py
// `edge_mlp_backward`). A block is two warpgroups on wgmma, each walking
// 64 flattened edges at a time (edge e: point e / k, slot e % k, so k does
// not shape the tiles); each layer's accumulator, packed to bf16, is the
// next product's A operand in registers, and the weights, staged once a
// block in 128-byte-swizzled panels (~90 KB), are the B operand: MN-major
// for W, K-major for W^T from the same bytes. The dW products take the
// edges as their depth from both warpgroups' staged tiles and add once per
// 128 edges into the block's sums in shared memory, each warpgroup its own
// rows; the S sums reduce over a tile's rows by a reduce-scatter of
// shuffles and stay in registers. No atomics: each block writes its
// partial S and dW and the wrapper adds them in a fixed order.
//
// What bounds it on an H100: operations. DCP's call is 32 x 2048 points x 20
// neighbours = 1.31 M edges of 2 (6*64 + 64*64 + 64*128 + 128*256) = 90.9 k
// flops, 119 GFLOP a pass: 0.12 ms at the 989 TFLOP/s bf16 dense peak; a1
// (15.7 MB) and the outputs (134 MB) take 0.045 ms. The four stat passes
// recompute 165 GFLOP (0.167 ms); the backward needs ~356 GFLOP (the forward once,
// every dW, the push-down), 0.36 ms, and the five passes form ~1.1 TFLOP
// (each recomputes the chain, layers 0-2 again where the way down needs
// them). Each warpgroup waits for its products before the elementwise work
// of the layer (the activation, the max-pool or the moment sums on the
// CUDA cores), so the tensor cores idle while both warpgroups of an SM are
// in their elementwise phases, and with up to 255 registers and two
// warpgroups an SM the latency of device-memory loads goes unhidden: the
// backward asks the next round's max-pool cotangents and slots into L2
// while a round runs, and the BatchNorm parameters sit in shared memory
// where it has room. Keeping the activations instead of recomputing them
// would store 671 MB of bf16 a call (layers 1-3) and read it back in every
// pass.

#include "hopper.cuh"

namespace {

constexpr int kC0 = 6;                         // a1 channels: [x_j | x_i]
constexpr int kCh0 = 64, kCh1 = 64, kCh2 = 128, kCh3 = 256;
constexpr int kChTotal = kCh0 + kCh1 + kCh2 + kCh3;
constexpr int kOff0 = 0, kOff1 = kCh0, kOff2 = kOff1 + kCh1, kOff3 = kOff2 + kCh2;
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The folded BatchNorm and relu of one pre-activation, as every pass
// computes it (no contraction into an FMA, so that all passes agree
// bitwise).
__device__ __forceinline__ float activate(float h, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(h, sc), sh), 0.f);
}

__host__ __device__ constexpr int layer_width(int layer) {
  return layer == 3 ? kCh3 : layer == 2 ? kCh2 : layer == 1 ? kCh1 : kCh0;
}

// ---- the wgmma chain: the backward's tiles, shared by the forward -----------

constexpr int kBEdges = 64;                    // edges a warpgroup takes at a time
constexpr int kBWGs = 2;                       // warpgroups a block
constexpr int kBThreads = 128 * kBWGs;
constexpr int kPanel = kBEdges * 128;          // a staging panel: 64 rows of 64 bf16
// the per-channel parameters, (7, 512) fp32, one row each: the folded
// scale and shift, mu and rsqrt(var + eps) for hhat, and the BatchNorm
// backward's dh = A dy - (B h + C) (A = gamma rsqrt(var + eps), B = A (S1 /
// E) rsqrt(var + eps), C = A (S0 / E) - B mu: c1 ((dy - m1) - hhat m2)
// multiplied out, so a column takes three loads, not five)
constexpr int kPSc = 0, kPSh = 1, kPMu = 2, kPRstd = 3, kPA = 4, kPB = 5, kPC = 6, kNP = 7;
// the weights in shared memory, bf16, 128-byte swizzled panels of 64 output
// channels, a row an input channel (W0's 6 rows padded to 16): panel q of
// W_l at kBW_l + q * rows_l * 128
constexpr uint32_t kBW0 = 0, kBW1 = kBW0 + 16 * 128, kBW2 = kBW1 + kCh0 * 128,
                   kBW3 = kBW2 + 2 * kCh1 * 128, kBWEnd = kBW3 + 4 * kCh2 * 128;
constexpr uint32_t kBScale = kBWEnd;           // scale, shift: (2, 512) fp32
constexpr uint32_t kBDyn = kBScale + 2 * kChTotal * 4;
// pass `level`'s dW sums, fp32, in the wgmma accumulators' order: level 2
// dW3[:, :128], level 1 dW3[:, 128:], level 0 dW2, level -1 dW1 and dW0
// (its input rows padded to 64)
__host__ __device__ constexpr int dw_floats(int level) {
  return level == 2 || level == 1 ? kCh2 * 128 : level == 0 ? kCh1 * kCh2
       : level == -1 ? kCh0 * kCh1 + 64 * kCh0 : 0;
}
// a warpgroup's staging tiles of a_l and dh_l for the dW products, in panels
// (level 2, 1: a_3, two; dh_3's half, two. level 0: a_2, one; dh_2, two.
// level -1: a_1, dh_1, a_0, dh_0, one each)
__host__ __device__ constexpr int stage_panels(int level) {
  return level == 2 || level == 1 ? 4 : level == 0 ? 3 : level == -1 ? 4 : 0;
}
__host__ __device__ constexpr int s_width(int level) { return level >= 0 ? layer_width(level) : 0; }
__host__ __device__ constexpr size_t stage_bytes(int level) {
  return kBWGs * stage_panels(level) * kPanel > kBThreads / 32 * 2 * s_width(level) * 4
             ? kBWGs * stage_panels(level) * kPanel
             : kBThreads / 32 * 2 * s_width(level) * 4;
}
// the per-channel parameters in shared memory where there is room: all of
// them at levels 3, 0 and -1; at levels 2 and 1 layer 3's A, B, C, the
// rest read from device memory through L1
__host__ __device__ constexpr bool params_staged(int level) { return level == 3 || level <= 0; }
__host__ __device__ constexpr size_t bwd_smem(int level) {
  return 1024 + kBDyn + 4 * dw_floats(level) + stage_bytes(level) +
         (params_staged(level) ? 4 * kNP * kChTotal : 4 * 3 * kCh3);
}

// A thread's bf16 pair (columns col, col + 1) of row `row` in a set of
// staging panels (64 columns each, 128-byte swizzled).
__device__ __forceinline__ void stage_pair(unsigned char* tile, int row, int col, uint32_t v) {
  const int c = col & 63;
  *reinterpret_cast<uint32_t*>(tile + (col >> 6) * kPanel + row * 128 +
                               (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2) = v;
}

// The A fragments of k-steps 0 .. KS - 1 (16 channels each, from channel
// 16 kk0) of a warpgroup's rows into its staging panels.
template <int KS>
__device__ __forceinline__ void stage_frags(unsigned char* tile, const uint32_t (&f)[KS][4],
                                            int kk0, int warp, int g, int t) {
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 16 * (kk0 + kk) + 2 * t;
    stage_pair(tile, r0, c, f[kk][0]);
    stage_pair(tile, r0 + 8, c, f[kk][1]);
    stage_pair(tile, r0, c + 8, f[kk][2]);
    stage_pair(tile, r0 + 8, c + 8, f[kk][3]);
  }
}

// Asks for `bytes` (a multiple of 16) at p (16-byte aligned) to be brought
// into L2, without waiting for them.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Element i of a 64 x N wgmma accumulator: row 16 warp + g + 8 ((i >> 1) & 1)
// of the warpgroup's tile, column (i >> 2) * 8 + 2 t + (i & 1).

// relu(h scale + shift) of an accumulator (columns col0 .. of a layer's
// channels at `off`) as the bf16 A fragments of the next product.
template <int F>
__device__ __forceinline__ void activate_frags(const float (&h)[F], const float* sc,
                                               const float* sh, int t,
                                               uint32_t (&a)[F / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk) {
    float y[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = 8 * kk + q, c = (i >> 2) * 8 + 2 * t + (i & 1);
      y[q] = activate(h[i], sc[c], sh[c]);
    }
    a[kk][0] = pack_bf16(y[0], y[1]);
    a[kk][1] = pack_bf16(y[2], y[3]);
    a[kk][2] = pack_bf16(y[4], y[5]);
    a[kk][3] = pack_bf16(y[6], y[7]);
  }
}

template <int F>
__device__ __forceinline__ void pack_frags(const float (&v)[F], uint32_t (&a)[F / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk) to_a_frag(v, kk, a[kk]);
}

// The edges of a thread's two rows: point p, slot j, and whether the row
// is an edge at all.
struct Rows {
  long long p[2];
  int j[2];
  bool ok[2];
};

// dy of an accumulator h of layer `off`'s channels col0 ..: the cotangent d
// carried from the layer above (kTop: none) plus the max-pool's cotangent
// gx routed to its saved slot, where the activation is positive; 0 on rows
// past the end. In place in d.
template <int F, bool kTop>
__device__ __forceinline__ void route_relu(const float (&h)[F], float (&d)[F],
                                           const float* __restrict__ gx, int ch,
                                           const uint8_t* __restrict__ slots, int off, int col0,
                                           const float* sc, const float* sh, const Rows& rw,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < F / 4; ++nt) {
    const int c = col0 + 8 * nt + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 gv = make_float2(0.f, 0.f);
      uint32_t sl = 0xffffu;
      if (rw.ok[r]) {
        gv = *reinterpret_cast<const float2*>(gx + rw.p[r] * ch + c);
        sl = *reinterpret_cast<const uint16_t*>(slots + rw.p[r] * kChTotal + off + c);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * nt + 2 * r + e;
        const float route = ((sl >> (8 * e)) & 0xffu) == static_cast<uint32_t>(rw.j[r])
                                ? (e ? gv.y : gv.x) : 0.f;
        const float y = activate(h[i], sc[c + e], sh[c + e]);
        d[i] = rw.ok[r] && y > 0.f ? (kTop ? 0.f : d[i]) + route : 0.f;
      }
    }
  }
}

__device__ __forceinline__ float hhat_of(float h, const float* __restrict__ params, int cc) {
  return __fmul_rn(__fsub_rn(h, params[kPMu * kChTotal + cc]), params[kPRstd * kChTotal + cc]);
}

// The sums over the tile's rows of 8 tiles of 8 columns, 4 values a column
// pair (v[nt][q]: q = 2 kind + e), by a reduce-scatter over the 8 lanes g
// that share t: lane g ends with tile g's (columns 8 g + 2 t + e).
__device__ __forceinline__ void reduce_scatter8(const float (&v)[8][4], float (&out)[4], int g) {
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
  float w[4][4], u[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float send = b2 ? v[i][q] : v[i + 4][q];
      const float keep = b2 ? v[i + 4][q] : v[i][q];
      w[i][q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float send = b1 ? w[i][q] : w[i + 2][q];
      const float keep = b1 ? w[i + 2][q] : w[i][q];
      u[i][q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float send = b0 ? u[0][q] : u[1][q];
    const float keep = b0 ? u[1][q] : u[0][q];
    out[q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
}

// S = [sum dy, sum dy hhat] of an accumulator's columns (layer `off`'s
// channels col0 ..) over the tile's rows, added to sacc[G0 + group] for each
// 64 columns: lane (g, t) keeps columns 64 group + 8 g + 2 t + e.
template <int F, int G0, int NG>
__device__ __forceinline__ void sum_s(const float (&dy)[F], const float (&h)[F],
                                      const float* __restrict__ params, int off, int col0,
                                      int g, int t, float (&sacc)[NG][4]) {
#pragma unroll
  for (int grp = 0; grp < F / 32; ++grp) {
    float v[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * (8 * grp + nt) + e, cc = off + col0 + 8 * (8 * grp + nt) + 2 * t + e;
        v[nt][e] = __fadd_rn(dy[i], dy[i + 2]);
        v[nt][2 + e] = __fadd_rn(__fmul_rn(dy[i], hhat_of(h[i], params, cc)),
                                 __fmul_rn(dy[i + 2], hhat_of(h[i + 2], params, cc)));
      }
    }
    float out[4];
    reduce_scatter8(v, out, g);
#pragma unroll
    for (int q = 0; q < 4; ++q) sacc[G0 + grp][q] = __fadd_rn(sacc[G0 + grp][q], out[q]);
  }
}

// BatchNorm backward with the batch's sums, in place: dh = A dy - (B h +
// C), 0 on rows past the end; abc the layer's A row, B and C `stride`
// floats after it.
template <int F>
__device__ __forceinline__ void bn_backward(float (&d)[F], const float (&h)[F],
                                            const float* __restrict__ abc, int stride,
                                            int col0, const Rows& rw, int t) {
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int c = col0 + (i >> 2) * 8 + 2 * t + (i & 1);
    const float v = __fmaf_rn(abc[c], d[i], -__fmaf_rn(abc[stride + c], h[i],
                                                       abc[2 * stride + c]));
    d[i] = rw.ok[(i >> 1) & 1] ? v : 0.f;
  }
}

// d (64 x 64) = A . W, the A fragments in registers, W (16 KS rows, one
// panel) MN-major in shared memory at w.
template <int KS>
__device__ __forceinline__ void forward64(float (&d)[32], uint32_t (&a)[KS][4], uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_m64n64k16_rs<1>(d, a[kk], sw128_desc(w + kk * 2048, KS * 16 * 128, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
  pin(a);
}

// d (64 x 128) = A . W2: W2's 64 rows in two panels
__device__ __forceinline__ void forward128(float (&d)[64], uint32_t (&a)[4][4], uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_rs<1>(d, a[kk], sw128_desc(w + kk * 2048, kCh1 * 128, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
  pin(a);
}

// d (64 x N) (+)= dh . W^T: dh's fragments (16 KS output channels of W from
// panel `w`, which holds N input rows) in registers, W^T read K-major from
// the same panels as the forward's W: k-step kk at panel kk / 4, byte
// 32 (kk % 4) of each row.
template <int KS, int F>
__device__ __forceinline__ void push_down(float (&d)[F], uint32_t (&a)[KS][4], uint32_t w,
                                          uint32_t panel_bytes, bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = sw128_desc(w + (kk >> 2) * panel_bytes + (kk & 3) * 32, 16, 1024);
    if constexpr (F == 64) {
      wgmma_m64n128k16_rs<0>(d, a[kk], db, accumulate || kk > 0);
    } else {
      wgmma_m64n64k16_rs<0>(d, a[kk], db, accumulate || kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
  pin(a);
}

// dW (64 x N) = a^T dh over both warpgroups' 64 edges (K = 128): a's
// channels from panel `ap` of each warpgroup's staging tile, dh's N
// channels from its panels at `bp`, both MN-major; then added in the
// accumulators' order to acc (this warpgroup's (F / 4, 128) float4 slots).
template <int F>
__device__ __forceinline__ void dw_product(uint32_t stage, uint32_t stage_bytes, uint32_t ap,
                                           uint32_t bp, float* acc, int tid) {
  float d[F];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t tile = stage + (kk >> 2) * stage_bytes + (kk & 3) * 2048;
    const uint64_t da = sw128_desc(tile + ap, kPanel, 1024);
    const uint64_t db = sw128_desc(tile + bp, kPanel, 1024);
    if constexpr (F == 64) {
      wgmma_m64n128k16_ss_mn(d, da, db, kk > 0);
    } else {
      wgmma_m64n64k16_ss_mn(d, da, db, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
  float4* a4 = reinterpret_cast<float4*>(acc);
#pragma unroll
  for (int v = 0; v < F / 4; ++v) {
    float4 x = a4[v * 128 + tid];
    x.x = __fadd_rn(x.x, d[4 * v]);
    x.y = __fadd_rn(x.y, d[4 * v + 1]);
    x.z = __fadd_rn(x.z, d[4 * v + 2]);
    x.w = __fadd_rn(x.w, d[4 * v + 3]);
    a4[v * 128 + tid] = x;
  }
}

// A warpgroup's accumulator slots (F floats a thread) as rows m0 .. of a
// (rows, cols) block partial, columns n0 ..
template <int F>
__device__ __forceinline__ void dw_store(const float* acc, float* out, int cols, int n0,
                                         int warp, int g, int t, int tid) {
#pragma unroll
  for (int v = 0; v < F; ++v) {
    const int row = 16 * warp + g + 8 * ((v >> 1) & 1), col = n0 + (v >> 2) * 8 + 2 * t + (v & 1);
    out[row * cols + col] = acc[(v >> 2) * 512 + tid * 4 + (v & 3)];
  }
}

// The four weights into their panels, 16 bytes (8 output channels) at a
// time, W0's rows past 6 zero; and the folded scale and shift.
__device__ __forceinline__ void stage_weights(unsigned char* base, const __nv_bfloat16* w0,
                                              const __nv_bfloat16* w1, const __nv_bfloat16* w2,
                                              const __nv_bfloat16* w3,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift) {
  const __nv_bfloat16* ws[4] = {w0, w1, w2, w3};
  const int rows[4] = {kC0, kCh0, kCh1, kCh2}, cols[4] = {kCh0, kCh1, kCh2, kCh3};
  const int prow[4] = {16, kCh0, kCh1, kCh2};
  const uint32_t offs[4] = {kBW0, kBW1, kBW2, kBW3};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    for (int i = threadIdx.x; i < prow[l] * cols[l] / 8; i += blockDim.x) {
      const int r = i / (cols[l] / 8), c8 = i % (cols[l] / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows[l]) v = *reinterpret_cast<const uint4*>(ws[l] + r * cols[l] + 8 * c8);
      *reinterpret_cast<uint4*>(base + offs[l] + (c8 >> 3) * prow[l] * 128 + r * 128 +
                                (((c8 & 7) ^ (r & 7)) << 4)) = v;
    }
  }
  float* ssc = reinterpret_cast<float*>(base + kBScale);
  for (int i = threadIdx.x; i < kChTotal; i += blockDim.x) {
    ssc[i] = scale[i];
    ssc[kChTotal + i] = shift[i];
  }
}

// ---- forward ----------------------------------------------------------------

// The final pass's rounds: 16 points, ceil(k / 4) tiles of 64 edges. Row
// 16 warp + g + 8 h of tile tau is point 4 warp + (g >> 1) of the round,
// slot 4 tau + 2 (g & 1) + h: a thread's two rows are two slots of one
// point, and the lane g ^ 1 holds its other two slots of the tile.
constexpr int kRoundPoints = 16;
// A thread's running max-pools of a round, 8 64-column chunks x 8 values,
// and with slots their bytes (4 a word), in shared memory, each thread its
// own column of a warpgroup's (64, 128) floats and (16, 128) words.
constexpr int kRunFloats = 64 * 128, kSlotWords = 16 * 128;
// Warpgroups a final-pass block (its round maxima take 40 KB a warpgroup
// beside the weights) and its dynamic shared memory: the weights' panels,
// the scale and shift, and the warpgroups' running max-pools and slots.
constexpr int kFwdWGs = 3;
constexpr size_t kFwdSmem = 1024 + kBDyn + kFwdWGs * (kRunFloats + kSlotWords) * 4;

// relu(h scale + shift) of a 64-column chunk of an accumulator in place
// (sc, sh at its first column).
__device__ __forceinline__ void activate64(float (&h)[32], const float* sc, const float* sh,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 a = *reinterpret_cast<const float2*>(sc + 8 * nt + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(sh + 8 * nt + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) h[4 * nt + x] = activate(h[4 * nt + x], x & 1 ? a.y : a.x,
                                                         x & 1 ? b.y : b.x);
  }
}

// The max over a tile's slots of a 64-column chunk of activations y (kMask:
// rows past the point's k slots, or past the last point, read as 0), added
// to the round's running max: the thread's two rows, then the lane g ^ 1's
// two, by a shuffle that leaves each lane half the columns (lane b = g & 1
// keeps tiles 2 m + b: run[128 (2 m + e)] is column 8 (2 m + b) + 2 t + e).
// With kSlots the first slot reaching each max, its byte in the word at
// sl[128 (idx / 4)]: a tie goes to the lower slot, and the running max
// takes a tile's only if larger, so the first slot reaching the max over
// all of the point's slots is kept (max >= 0, slot 0 from the start).
template <bool kSlots, bool kMask>
__device__ __forceinline__ void pool64(const float (&y)[32], bool ok0, bool ok1, int j0, int b,
                                       float* run, uint32_t* sl) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[2];
      int s[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float lo = !kMask || ok0 ? y[4 * (2 * m + q) + e] : 0.f;
        const float hi = !kMask || ok1 ? y[4 * (2 * m + q) + 2 + e] : 0.f;
        if constexpr (kSlots) {
          v[q] = hi > lo ? hi : lo;
          s[q] = hi > lo ? j0 + 1 : j0;
        } else {
          v[q] = fmaxf(lo, hi);
        }
      }
      float keep = b ? v[1] : v[0];
      const float o = __shfl_xor_sync(0xffffffffu, b ? v[0] : v[1], 4);
      const int idx = 2 * m + e;
      const float r = run[128 * idx];
      if constexpr (kSlots) {
        int ks = b ? s[1] : s[0];
        const int os = __shfl_xor_sync(0xffffffffu, b ? s[0] : s[1], 4);
        if (o > keep || (o == keep && os < ks)) {
          keep = o;
          ks = os;
        }
        if (keep > r) {
          run[128 * idx] = keep;
          reinterpret_cast<uint8_t*>(sl + 128 * (idx >> 2))[idx & 3] = static_cast<uint8_t>(ks);
        }
      } else {
        keep = fmaxf(keep, o);
        if (keep > r) run[128 * idx] = keep;
      }
    }
  }
}

// layer 0's A fragments of edges e0 and e1 (where ok): the edge [x_j |
// x_i], channels 6..15 zero
__device__ __forceinline__ void load_a0(const __nv_bfloat16* __restrict__ a1, long long e0,
                                        long long e1, bool ok0, bool ok1, int t,
                                        uint32_t (&f)[2]) {
  f[0] = f[1] = 0u;
  if (t < kC0 / 2) {
    if (ok0) f[0] = __ldg(reinterpret_cast<const unsigned int*>(a1 + e0 * kC0) + t);
    if (ok1) f[1] = __ldg(reinterpret_cast<const unsigned int*>(a1 + e1 * kC0) + t);
  }
}

// Issues d (64 x 64) = A . W (W's KS k-steps in the panel at w) on the
// tensor cores without waiting for it: wgmma_wait and pin(d) before d is
// read, pin(a) after the last product that reads a.
template <int KS>
__device__ __forceinline__ void issue64(float (&d)[32], uint32_t (&a)[KS][4], uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_m64n64k16_rs<1>(d, a[kk], sw128_desc(w + kk * 2048, KS * 16 * 128, 1024), kk > 0);
  }
  wgmma_commit();
  pin(d);
}

// The chain of a tile past layer 0's product h0 (the accumulator of f0 .
// W0): layer l's chunks (one for layers 0 and 1, two for layer 2, four for
// layer 3) each handed to chunk(h, c) (c 0..7 over the layers in order)
// after its activation. Each layer's activations packed to bf16 are the
// next product's A operand; layer 2's two products, and layer 3's four, are
// issued two at a time, so a chunk's elementwise work overlaps the next
// chunk's product. With kStat = l >= 0 (a stat pass) the chain stops at
// layer l, whose chunks are handed over before the activation: h_l.
template <int kStat = -1, typename Chunk>
__device__ __forceinline__ void chain(float (&h)[32], const float* ssc, const float* ssh,
                                      uint32_t sb, int t, Chunk&& chunk) {
  if constexpr (kStat == 0) {
    chunk(h, 0);
    return;
  }
  activate64(h, ssc + kOff0, ssh + kOff0, t);
  if constexpr (kStat < 0) chunk(h, 0);
  uint32_t f1[4][4];
  pack_frags(h, f1);
  forward64(h, f1, sb + kBW1);
  if constexpr (kStat == 1) {
    chunk(h, 1);
    return;
  }
  activate64(h, ssc + kOff1, ssh + kOff1, t);
  if constexpr (kStat < 0) chunk(h, 1);
  uint32_t f2[4][4];
  pack_frags(h, f2);
  float hb[32];
  uint32_t f3[8][4];
  issue64(h, f2, sb + kBW2);
  issue64(hb, f2, sb + kBW2 + kCh1 * 128);
  wgmma_wait<1>();
  pin(h);
  if constexpr (kStat == 2) {
    chunk(h, 2);
    wgmma_wait<0>();
    pin(hb);
    pin(f2);
    chunk(hb, 3);
    return;
  }
  activate64(h, ssc + kOff2, ssh + kOff2, t);
  if constexpr (kStat < 0) chunk(h, 2);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a_frag(h, kk, f3[kk]);
  wgmma_wait<0>();
  pin(hb);
  pin(f2);
  activate64(hb, ssc + kOff2 + 64, ssh + kOff2 + 64, t);
  if constexpr (kStat < 0) chunk(hb, 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a_frag(hb, kk, f3[4 + kk]);
  auto layer3 = [&](float (&d)[32], int q) {
    if constexpr (kStat < 0) {
      activate64(d, ssc + kOff3 + 64 * q, ssh + kOff3 + 64 * q, t);
      chunk(d, 4 + q);
    } else if constexpr (kStat == 3) {
      chunk(d, 4 + q);
    }
  };
  issue64(h, f3, sb + kBW3);
  issue64(hb, f3, sb + kBW3 + kCh2 * 128);
  wgmma_wait<1>();
  pin(h);
  layer3(h, 0);
  issue64(h, f3, sb + kBW3 + 2 * kCh2 * 128);
  wgmma_wait<1>();
  pin(hb);
  layer3(hb, 1);
  issue64(hb, f3, sb + kBW3 + 3 * kCh2 * 128);
  wgmma_wait<1>();
  pin(h);
  layer3(h, 2);
  wgmma_wait<0>();
  pin(hb);
  pin(f3);
  layer3(hb, 3);
}

// The final pass: the max-pools, with kSlots their first argmax slots. A
// block is kFwdWGs warpgroups on wgmma, the backward's machinery: each
// layer's accumulator activated and packed to bf16 is the next product's A
// operand in registers, the weights staged once a block in swizzled panels
// are the B operand (`chain`). A warpgroup walks rounds of 16 points
// (kRoundPoints), keeps their max-pools in shared memory, each thread its
// own, and loads the next tile's edges while it computes the current one.
template <bool kSlots>
__global__ void __launch_bounds__(128 * kFwdWGs, 1)
edge_mlp_kernel(const __nv_bfloat16* __restrict__ a1,
                const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                const float* __restrict__ scale, const float* __restrict__ shift,
                long long points, int k, float* __restrict__ x0, float* __restrict__ x1,
                float* __restrict__ x2, float* __restrict__ x3,
                uint8_t* __restrict__ slots) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  stage_weights(base, w0, w1, w2, w3, scale, shift);
  fence_proxy_async();
  __syncthreads();
  const float* ssc = reinterpret_cast<const float*>(base + kBScale);
  const float* ssh = ssc + kChTotal;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kWGs = kFwdWGs;
  const long long stride = static_cast<long long>(gridDim.x) * kWGs;
  float* run = reinterpret_cast<float*>(base + kBDyn) + wg * kRunFloats + tid;
  uint32_t* sl = reinterpret_cast<uint32_t*>(base + kBDyn) + kWGs * kRunFloats +
                 wg * kSlotWords + tid;
  const long long rounds = (points + kRoundPoints - 1) / kRoundPoints;
  const int per = (k + 3) / 4;                 // tiles a round
  const int b = g & 1;
  // the thread's rows in tile tau of round rd: point p, slots j0 and j0 + 1
  auto rows_of = [&](long long rd, int tau, long long& p, int& j0, bool& ok0, bool& ok1) {
    p = rd * kRoundPoints + 4 * warp + (g >> 1);
    j0 = 4 * tau + 2 * b;
    ok0 = rd < rounds && p < points && j0 < k;
    ok1 = rd < rounds && p < points && j0 + 1 < k;
  };
  long long rd = static_cast<long long>(blockIdx.x) * kWGs + wg;
  uint32_t nf[2];
  {
    long long p;
    int j0;
    bool ok0, ok1;
    rows_of(rd, 0, p, j0, ok0, ok1);
    load_a0(a1, p * k + j0, p * k + j0 + 1, ok0, ok1, t, nf);
  }
  for (; rd < rounds; rd += stride) {
#pragma unroll
    for (int i = 0; i < 64; ++i) run[128 * i] = 0.f;
    if constexpr (kSlots) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sl[128 * i] = 0u;
    }
    const long long p = rd * kRoundPoints + 4 * warp + (g >> 1);
    for (int tau = 0; tau < per; ++tau) {
      long long pt;
      int j0;
      bool ok0, ok1;
      rows_of(rd, tau, pt, j0, ok0, ok1);
      uint32_t f0[1][4] = {{nf[0], nf[1], 0u, 0u}};
      {
        const long long nrd = tau + 1 < per ? rd : rd + stride;
        long long np;
        int nj;
        bool nok0, nok1;
        rows_of(nrd, tau + 1 < per ? tau + 1 : 0, np, nj, nok0, nok1);
        load_a0(a1, np * k + nj, np * k + nj + 1, nok0, nok1, t, nf);
      }
      const bool full = __all_sync(0xffffffffu, ok0 && ok1);
      float h[32];
      forward64(h, f0, sb + kBW0);
      chain(h, ssc, ssh, sb, t, [&](float (&d)[32], int c) {
        if (full) {
          pool64<kSlots, false>(d, ok0, ok1, j0, b, run + 128 * 8 * c, sl + 128 * 2 * c);
        } else {
          pool64<kSlots, true>(d, ok0, ok1, j0, b, run + 128 * 8 * c, sl + 128 * 2 * c);
        }
      });
    }
    // the round's max-pools (and slots): chunk c is layer l's columns
    // from col0; run[128 (8 c + 2 m + e)] is column col0 + 16 m + 8 b + 2 t + e
    if (p < points) {
      float* xs[4] = {x0, x1, x2, x3};
      const int chs[4] = {kCh0, kCh1, kCh2, kCh3}, offs[4] = {kOff0, kOff1, kOff2, kOff3};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int l = c < 2 ? c : c < 4 ? 2 : 3;
        const int col0 = c < 2 ? 0 : c < 4 ? 64 * (c - 2) : 64 * (c - 4);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int col = col0 + 16 * m + 8 * b + 2 * t;
          *reinterpret_cast<float2*>(xs[l] + p * chs[l] + col) =
              make_float2(run[128 * (8 * c + 2 * m)], run[128 * (8 * c + 2 * m + 1)]);
          if constexpr (kSlots) {
            *reinterpret_cast<uint16_t*>(slots + p * kChTotal + offs[l] + col) =
                static_cast<uint16_t>((sl[128 * (2 * c + (m >> 1))] >> (16 * (m & 1))) &
                                      0xffffu);
          }
        }
      }
    }
  }
}

// ---- stat passes ------------------------------------------------------------
//
// The stat pass of layer l on the final pass's machinery: a block is
// kFwdWGs warpgroups on wgmma with the weights staged once in swizzled
// panels; a warpgroup walks tiles of 64 flattened edges (edge e: point e /
// k, slot e % k; the backward's tiling, since no max over slots is taken)
// with a grid stride, loading the next tile's edges while it computes the
// current one, and runs the chain up to layer l (`chain<l>`). Each 64-column
// chunk of h_l is summed over the tile's valid rows, h and h^2, by a
// reduce-scatter of shuffles (lane g keeps columns 8 g + 2 t + e) and added
// to the lane's running sums; at the end the block's twelve warps add their
// sums in warp order into one partial a block.

// A chunk's [sum h, sum h^2] over the tile's rows (kMask: rows not ok read
// 0), added to acc: acc[e] sums column 8 g + 2 t + e, acc[2 + e] its squares.
template <bool kMask>
__device__ __forceinline__ void sum_moments64(const float (&h)[32], bool ok0, bool ok1,
                                              int g, float (&acc)[4]) {
  float v[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x0 = !kMask || ok0 ? h[4 * nt + e] : 0.f;
      const float x1 = !kMask || ok1 ? h[4 * nt + 2 + e] : 0.f;
      v[nt][e] = __fadd_rn(x0, x1);
      v[nt][2 + e] = __fmaf_rn(x0, x0, __fmul_rn(x1, x1));
    }
  }
  float out[4];
  reduce_scatter8(v, out, g);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = __fadd_rn(acc[q], out[q]);
}

// Dynamic shared memory of a stat-pass block: the weights' panels, the
// scale and shift, and the warps' sums (two rows of 256 a warp).
constexpr size_t kStatSmem = 1024 + kBDyn + kFwdWGs * 4 * 2 * kCh3 * 4;

// The stat pass of layer kStat (0..3): [sum h, sum h^2] of each of its
// channels over the `edges` edges -> partial[block] (2, ch_kStat).
template <int kStat>
__global__ void __launch_bounds__(128 * kFwdWGs, 1)
edge_mlp_stat_kernel(const __nv_bfloat16* __restrict__ a1,
                     const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
                     const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                     const float* __restrict__ scale, const float* __restrict__ shift,
                     long long edges, float* __restrict__ partial) {
  constexpr int ch = layer_width(kStat), kChunks = ch / 64;
  constexpr int kFirst = kStat == 3 ? 4 : kStat;   // chain's index of the layer's first chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  stage_weights(base, w0, w1, w2, w3, scale, shift);
  fence_proxy_async();
  __syncthreads();
  const float* ssc = reinterpret_cast<const float*>(base + kBScale);
  const float* ssh = ssc + kChTotal;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (edges + kBEdges - 1) / kBEdges;
  const long long stride = static_cast<long long>(gridDim.x) * kFwdWGs;
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  const int r0 = 16 * warp + g;
  long long tile = static_cast<long long>(blockIdx.x) * kFwdWGs + wg;
  uint32_t nf[2];
  load_a0(a1, tile * kBEdges + r0, tile * kBEdges + r0 + 8, tile * kBEdges + r0 < edges,
          tile * kBEdges + r0 + 8 < edges, t, nf);
  for (; tile < tiles; tile += stride) {
    const long long e0 = tile * kBEdges + r0;
    const bool ok0 = e0 < edges, ok1 = e0 + 8 < edges;
    uint32_t f0[1][4] = {{nf[0], nf[1], 0u, 0u}};
    const long long n0 = e0 + stride * kBEdges;
    load_a0(a1, n0, n0 + 8, n0 < edges, n0 + 8 < edges, t, nf);
    const bool full = __all_sync(0xffffffffu, ok0 && ok1);
    float h[32];
    forward64(h, f0, sb + kBW0);
    chain<kStat>(h, ssc, ssh, sb, t, [&](float (&d)[32], int c) {
      if (full) {
        sum_moments64<false>(d, ok0, ok1, g, acc[c - kFirst]);
      } else {
        sum_moments64<true>(d, ok0, ok1, g, acc[c - kFirst]);
      }
    });
  }
  // the warps' sums, then the block's in warp order
  float* red = reinterpret_cast<float*>(base + kBDyn);
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[(w * 2 + (q >> 1)) * ch + 64 * c + 8 * g + 2 * t + (q & 1)] = acc[c][q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * ch; i += blockDim.x) {
    float s = red[i];
    for (int v = 1; v < kFwdWGs * 4; ++v) s = __fadd_rn(s, red[v * 2 * ch + i]);
    partial[static_cast<long long>(blockIdx.x) * 2 * ch + i] = s;
  }
}

// ---- backward ---------------------------------------------------------------

// One backward pass, `level` 3, 2, 1, 0 or -1 (the TPU's five top-down
// passes). w0..w3 the weights (in, out) bf16; params (7, 512) fp32: the
// folded scale and shift, mu, rsqrt(var + eps) and, for the layers above
// `level`, the BatchNorm backward's A, B, C (kPA..kPC); gx0..gx3 the
// max-pools' cotangents (P, ch_l) fp32; slots (P, 512) uint8 -> s_part
// (gridDim.x, 2, ch_level) for level >= 0, dw_part (gridDim.x,
// dw_floats(level)) for level <= 2 (level 2: dW3[:, :128], level 1:
// dW3[:, 128:] as (128, 128); level 0: dW2 (64, 128); level -1: dW1 (64,
// 64) then dW0 as (64, 64), its rows past 6 zero), da1 (E, 6) fp32 at
// level -1 where not null.
//
// A block is two warpgroups; each walks the flattened edges 64 at a time
// (edge e is point e / k, slot e % k), tiles 2 b and 2 b + 1 of round b, so
// that the k of the model does not shape the tiles. A warpgroup computes its
// 64 edges' chain on wgmma: layer l's activations, packed to bf16 straight
// from the accumulator, are the A fragments of layer l + 1 (registers, no
// barrier), the weights' B operand read from the panels staged once a
// block, MN-major for W and K-major for W^T from the same bytes. Layer 3 runs
// in four 64-channel chunks, each pushed down through W3^T into d2 as it is
// formed; layers 0..2 are formed again from their inputs' fragments where
// the way down needs them. The pass's dW products take the edges as their
// depth: both warpgroups stage a_l and dh_l (bf16, swizzled), and after a
// block barrier each forms its share over the round's 128 edges from shared
// memory (wgmma with both operands MN-major) and adds it into the block's
// fp32 sums, its own slots, so no two threads add to one sum.
template <int kLevel>
__global__ void __launch_bounds__(kBThreads, 1)
edge_mlp_backward_kernel(const __nv_bfloat16* __restrict__ a1,
                         const __nv_bfloat16* __restrict__ w0,
                         const __nv_bfloat16* __restrict__ w1,
                         const __nv_bfloat16* __restrict__ w2,
                         const __nv_bfloat16* __restrict__ w3,
                         const float* __restrict__ params, const float* __restrict__ gx0,
                         const float* __restrict__ gx1, const float* __restrict__ gx2,
                         const float* __restrict__ gx3, const uint8_t* __restrict__ slots,
                         long long edges, int k, float* __restrict__ s_part,
                         float* __restrict__ dw_part, float* __restrict__ da1) {
  constexpr int kStageBytes = stage_panels(kLevel) * kPanel;
  constexpr int kSGroups = kLevel == 3 ? 4 : kLevel == 2 ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  float* ssc = reinterpret_cast<float*>(base + kBScale);
  float* ssh = ssc + kChTotal;
  float* acc = reinterpret_cast<float*>(base + kBDyn);
  unsigned char* stage = base + kBDyn + 4 * dw_floats(kLevel);
  const uint32_t sstage = sb + kBDyn + 4 * dw_floats(kLevel);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned char* my_stage = stage + wg * kStageBytes;

  stage_weights(base, w0, w1, w2, w3, params + kPSc * kChTotal, params + kPSh * kChTotal);
  // the per-channel parameters where they are read, and layer 3's A, B, C
  const float* prm = params;
  const float* abc3 = params + kPA * kChTotal + kOff3;
  int abc3_stride = kChTotal;
  {
    float* sp = reinterpret_cast<float*>(stage + stage_bytes(kLevel));
    if constexpr (params_staged(kLevel)) {
      for (int i = threadIdx.x; i < kNP * kChTotal; i += kBThreads) sp[i] = params[i];
      prm = sp;
      abc3 = sp + kPA * kChTotal + kOff3;
    } else if constexpr (kLevel <= 2) {
      for (int i = threadIdx.x; i < 3 * kCh3; i += kBThreads) {
        sp[i] = params[(kPA + i / kCh3) * kChTotal + kOff3 + i % kCh3];
      }
      abc3 = sp;
      abc3_stride = kCh3;
    }
  }
  for (int i = threadIdx.x; i < dw_floats(kLevel) + kBWGs * kStageBytes / 4; i += kBThreads) {
    acc[i] = 0.f;                                // the sums, and the staging's padding
  }
  fence_proxy_async();
  __syncthreads();

  float sacc[kSGroups][4];
#pragma unroll
  for (int i = 0; i < kSGroups; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
  // W0^T's B fragments for d_a1 (mma.m16n8k16: k an output channel, n = g
  // an input channel, zero past 6)
  uint32_t wt0[4][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wt0[kk][0] = wt0[kk][1] = 0u;
    if (kLevel == -1 && g < kC0) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(w0 + g * kCh0 + 16 * kk + 2 * t);
      wt0[kk][0] = row[0];
      wt0[kk][1] = row[4];
    }
  }
  const long long tiles = (edges + kBEdges - 1) / kBEdges;

  for (long long round = blockIdx.x; round * kBWGs < tiles; round += gridDim.x) {
    // the next round's edges, their points' max-pool cotangents and slots
    // into L2 while this round runs: the routes read them in every pass
    const long long next = ((round + gridDim.x) * kBWGs + wg) * kBEdges;
    if (tid == 0 && next < edges) {
      const long long last = (next + kBEdges < edges ? next + kBEdges : edges) - 1;
      const long long p0 = next / k, np = last / k - p0 + 1;
      const float* gxs[4] = {gx0, gx1, gx2, gx3};
      const int chs[4] = {kCh0, kCh1, kCh2, kCh3};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        prefetch_l2(gxs[l] + p0 * chs[l], static_cast<uint32_t>(np * chs[l] * 4));
      }
      prefetch_l2(slots + p0 * kChTotal, static_cast<uint32_t>(np * kChTotal));
    }
    const long long e0 = (round * kBWGs + wg) * kBEdges + 16 * warp + g;
    Rows rw;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long e = e0 + 8 * r;
      rw.ok[r] = e < edges;
      rw.p[r] = rw.ok[r] ? e / k : 0;
      rw.j[r] = rw.ok[r] ? static_cast<int>(e - rw.p[r] * k) : 0;
    }
    // layer 0's A fragments: the edge [x_j | x_i], channels 6..15 zero
    uint32_t f0[1][4] = {{0u, 0u, 0u, 0u}};
    if (t < kC0 / 2) {
      if (rw.ok[0]) f0[0][0] = *reinterpret_cast<const uint32_t*>(a1 + e0 * kC0 + 2 * t);
      if (rw.ok[1]) f0[0][1] = *reinterpret_cast<const uint32_t*>(a1 + (e0 + 8) * kC0 + 2 * t);
    }
    if constexpr (kLevel == -1) stage_frags(my_stage + 2 * kPanel, f0, 0, warp, g, t);  // a_0
    // the forward chain, as the final pass computes it
    uint32_t f1[4][4], f2[4][4], f3[8][4];
    {
      float h[32];
      forward64(h, f0, sb + kBW0);
      activate_frags(h, ssc + kOff0, ssh + kOff0, t, f1);
      forward64(h, f1, sb + kBW1);
      activate_frags(h, ssc + kOff1, ssh + kOff1, t, f2);
    }
    {
      float h[64];
      forward128(h, f2, sb + kBW2);
      activate_frags(h, ssc + kOff2, ssh + kOff2, t, f3);
    }
    if constexpr (kLevel == 2 || kLevel == 1) stage_frags(my_stage, f3, 0, warp, g, t);
    if constexpr (kLevel == 0) stage_frags(my_stage, f2, 0, warp, g, t);     // a_2
    if constexpr (kLevel == -1) stage_frags(my_stage, f1, 0, warp, g, t);    // a_1

    // layer 3 in four chunks of 64 channels; below level 3 each chunk's dh3
    // is pushed down into d2
    float d2[64];
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      float h[32], d[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n64k16_rs<1>(h, f3[kk], sw128_desc(sb + kBW3 + q * kCh2 * 128 + kk * 2048,
                                                    kCh2 * 128, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(h);
      pin(f3);
      route_relu<32, true>(h, d, gx3, kCh3, slots, kOff3, 64 * q, ssc + kOff3, ssh + kOff3, rw,
                           t);
      if constexpr (kLevel == 3) {
        switch (q) {   // sacc's index must be a constant
          case 0: sum_s<32, 0>(d, h, prm, kOff3, 0, g, t, sacc); break;
          case 1: sum_s<32, 1>(d, h, prm, kOff3, 64, g, t, sacc); break;
          case 2: sum_s<32, 2>(d, h, prm, kOff3, 128, g, t, sacc); break;
          default: sum_s<32, 3>(d, h, prm, kOff3, 192, g, t, sacc); break;
        }
      } else {
        bn_backward(d, h, abc3, abc3_stride, 64 * q, rw, t);
        uint32_t fd[4][4];
        pack_frags(d, fd);
        if constexpr (kLevel == 2 || kLevel == 1) {
          if ((kLevel == 2) == (q < 2)) {
            stage_frags(my_stage + 2 * kPanel, fd, 4 * (q & 1), warp, g, t);
          }
        }
        push_down<4>(d2, fd, sb + kBW3 + q * kCh2 * 128, kCh2 * 128, q > 0);
      }
    }
    if constexpr (kLevel <= 2) {
      {
        float h[64];
        forward128(h, f2, sb + kBW2);
        route_relu<64, false>(h, d2, gx2, kCh2, slots, kOff2, 0, ssc + kOff2, ssh + kOff2, rw, t);
        if constexpr (kLevel == 2) {
          sum_s<64, 0>(d2, h, prm, kOff2, 0, g, t, sacc);
        } else {
          bn_backward(d2, h, prm + kPA * kChTotal + kOff2, kChTotal, 0, rw, t);
        }
      }
      if constexpr (kLevel <= 1) {
        uint32_t fd2[8][4];
        pack_frags(d2, fd2);
        if constexpr (kLevel == 0) stage_frags(my_stage + kPanel, fd2, 0, warp, g, t);
        float d1[32], h[32];
        push_down<8>(d1, fd2, sb + kBW2, kCh1 * 128, false);
        forward64(h, f1, sb + kBW1);
        route_relu<32, false>(h, d1, gx1, kCh1, slots, kOff1, 0, ssc + kOff1, ssh + kOff1, rw, t);
        if constexpr (kLevel == 1) {
          sum_s<32, 0>(d1, h, prm, kOff1, 0, g, t, sacc);
        } else {
          bn_backward(d1, h, prm + kPA * kChTotal + kOff1, kChTotal, 0, rw, t);
          uint32_t fd1[4][4];
          pack_frags(d1, fd1);
          if constexpr (kLevel == -1) stage_frags(my_stage + kPanel, fd1, 0, warp, g, t);
          float d0[32];
          push_down<4>(d0, fd1, sb + kBW1, kCh0 * 128, false);
          forward64(h, f0, sb + kBW0);
          route_relu<32, false>(h, d0, gx0, kCh0, slots, kOff0, 0, ssc + kOff0, ssh + kOff0, rw,
                                t);
          if constexpr (kLevel == 0) {
            sum_s<32, 0>(d0, h, prm, kOff0, 0, g, t, sacc);
          } else {
            bn_backward(d0, h, prm + kPA * kChTotal + kOff0, kChTotal, 0, rw, t);
            uint32_t fd0[4][4];
            pack_frags(d0, fd0);
            stage_frags(my_stage + 3 * kPanel, fd0, 0, warp, g, t);
            if (da1 != nullptr) {         // d_a1 = dh0 W0^T on mma.sync, 8 columns
              float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) mma_bf16(e, fd0[kk], wt0[kk][0], wt0[kk][1]);
              if (t < kC0 / 2) {
                if (rw.ok[0]) {
                  *reinterpret_cast<float2*>(da1 + e0 * kC0 + 2 * t) = make_float2(e[0], e[1]);
                }
                if (rw.ok[1]) {
                  *reinterpret_cast<float2*>(da1 + (e0 + 8) * kC0 + 2 * t) =
                      make_float2(e[2], e[3]);
                }
              }
            }
          }
        }
      }
      // the round's dW: both tiles staged, then each warpgroup its share
      fence_proxy_async();
      __syncthreads();
      if constexpr (kLevel == 2 || kLevel == 1) {
        // a_3's channels 64 wg .. against dh_3's half
        dw_product<64>(sstage, kStageBytes, wg * kPanel, 2 * kPanel, acc + wg * 64 * 128, tid);
      } else if constexpr (kLevel == 0) {
        // a_2 against dh_2's columns 64 wg ..
        dw_product<32>(sstage, kStageBytes, 0, (1 + wg) * kPanel, acc + wg * 64 * 64, tid);
      } else {
        // warpgroup 0 dW1 (a_1, dh_1), 1 dW0 (a_0, dh_0)
        dw_product<32>(sstage, kStageBytes, 2 * wg * kPanel, (2 * wg + 1) * kPanel,
                       acc + wg * 64 * 64, tid);
      }
      __syncthreads();                   // the staging read before the next round refills it
    }
  }

  // S: each warp's sums (lane (g, t) holds columns 64 group + 8 g + 2 t + e)
  // into its slots, then the warps added in order
  if constexpr (kLevel >= 0) {
    constexpr int ch = layer_width(kLevel);
    float* sred = reinterpret_cast<float*>(stage);
    const int w8 = threadIdx.x >> 5;
#pragma unroll
    for (int grp = 0; grp < kSGroups; ++grp) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sred[(w8 * 2 + (q >> 1)) * ch + 64 * grp + 8 * g + 2 * t + (q & 1)] = sacc[grp][q];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * ch; i += kBThreads) {
      float s = sred[i];
      for (int w = 1; w < kBThreads / 32; ++w) s = __fadd_rn(s, sred[w * 2 * ch + i]);
      s_part[static_cast<long long>(blockIdx.x) * 2 * ch + i] = s;
    }
  }
  if constexpr (kLevel <= 2) {
    float* out = dw_part + static_cast<long long>(blockIdx.x) * dw_floats(kLevel);
    if constexpr (kLevel == 2 || kLevel == 1) {
      dw_store<64>(acc + wg * 64 * 128, out + wg * 64 * 128, 128, 0, warp, g, t, tid);
    } else if constexpr (kLevel == 0) {
      dw_store<32>(acc + wg * 64 * 64, out, kCh2, 64 * wg, warp, g, t, tid);
    } else {
      dw_store<32>(acc + wg * 64 * 64, out + wg * 64 * 64, 64, 0, warp, g, t, tid);
    }
  }
}

// Opt a kernel into `smem` bytes of dynamic shared memory and size its
// persistent grid: every block resident, at most `need` and, if cap > 0, at
// most `cap` blocks.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long need,
                            long long cap, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  long long n = static_cast<long long>(per_sm) * sms;
  if (n > need) n = need;
  if (cap > 0 && n > cap) n = cap;
  *grid = static_cast<int>(n < 1 ? 1 : n);
  return cudaSuccess;
}

template <bool kSlots>
int launch_forward(const void* a1, const void* w0, const void* w1, const void* w2,
                   const void* w3, const float* scale, const float* shift,
                   long long points, int k, float* x0, float* x1, float* x2, float* x3,
                   uint8_t* slots, void* stream) {
  auto kernel = edge_mlp_kernel<kSlots>;
  // a warpgroup's units: rounds of 16 points
  const long long rounds = (points + kRoundPoints - 1) / kRoundPoints;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, 128 * kFwdWGs, kFwdSmem,
                                    (rounds + kFwdWGs - 1) / kFwdWGs, 0, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<grid, 128 * kFwdWGs, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(a1), static_cast<const bf*>(w0), static_cast<const bf*>(w1),
      static_cast<const bf*>(w2), static_cast<const bf*>(w3), scale, shift, points, k,
      x0, x1, x2, x3, slots);
  return static_cast<int>(cudaGetLastError());
}

template <int kStat>
int launch_stat(const void* a1, const void* w0, const void* w1, const void* w2,
                const void* w3, const float* scale, const float* shift, long long points,
                int k, float* partial, long long cap, void* stream) {
  auto kernel = edge_mlp_stat_kernel<kStat>;
  const long long edges = points * k;
  const long long tiles = (edges + kBEdges - 1) / kBEdges;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, 128 * kFwdWGs, kStatSmem,
                                    (tiles + kFwdWGs - 1) / kFwdWGs, cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<grid, 128 * kFwdWGs, kStatSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(a1), static_cast<const bf*>(w0), static_cast<const bf*>(w1),
      static_cast<const bf*>(w2), static_cast<const bf*>(w3), scale, shift, edges, partial);
  return static_cast<int>(cudaGetLastError());
}

template <int kLevel>
int launch_backward(const void* a1, const void* const* w, const float* params,
                    const float* const* gx, const uint8_t* slots, long long points, int k,
                    long long cap, float* s_part, float* dw_part, float* da1, void* stream) {
  auto kernel = edge_mlp_backward_kernel<kLevel>;
  const size_t smem = bwd_smem(kLevel);
  const long long edges = points * k;
  const long long rounds = ((edges + kBEdges - 1) / kBEdges + kBWGs - 1) / kBWGs;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, kBThreads, smem, rounds, cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(a1), static_cast<const bf*>(w[0]), static_cast<const bf*>(w[1]),
      static_cast<const bf*>(w[2]), static_cast<const bf*>(w[3]), params, gx[0], gx[1], gx[2],
      gx[3], slots, edges, k, s_part, dw_part, da1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a1 (P, k, 6) bf16 (P = B * N points, 1 <= k <= 255 neighbours), W0 (6,
// 64), W1 (64, 64), W2 (64, 128), W3 (128, 256) bf16 in the flax (in, out)
// orientation, scale and shift (512,) fp32 (the four layers' channels in
// order), all contiguous on the device -> x0 (P, 64), x1 (P, 64), x2
// (P, 128), x3 (P, 256) fp32 and, where `slots` is not null, each max-pool's
// first argmax slot (P, 512) uint8. Launches on `stream` without
// synchronising; returns cudaGetLastError(), or cudaErrorInvalidValue for
// P < 1 or k outside [1, 255].
int edge_mlp_forward(const void* a1, const void* w0, const void* w1,
                     const void* w2, const void* w3, const float* scale,
                     const float* shift, long long points, int k, float* x0,
                     float* x1, float* x2, float* x3, uint8_t* slots, void* stream) {
  if (points < 1 || k < 1 || k > 255) return static_cast<int>(cudaErrorInvalidValue);
  if (slots != nullptr) {
    return launch_forward<true>(a1, w0, w1, w2, w3, scale, shift, points, k, x0, x1, x2,
                                x3, slots, stream);
  }
  return launch_forward<false>(a1, w0, w1, w2, w3, scale, shift, points, k, x0, x1, x2,
                               x3, nullptr, stream);
}

// The stat pass of `layer` (0..3): inputs as edge_mlp_forward, with scale
// and shift read for the layers below `layer` only -> partial
// (max_blocks, 2, ch_layer) fp32, [sum h, sum h^2] of one block a row pair,
// rows past the launched blocks untouched (the caller zeroes them).
int edge_mlp_stat(const void* a1, const void* w0, const void* w1, const void* w2,
                  const void* w3, const float* scale, const float* shift,
                  long long points, int k, int layer, int max_blocks, float* partial,
                  void* stream) {
  if (points < 1 || k < 1 || k > 255 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (layer) {
    case 0:
      return launch_stat<0>(a1, w0, w1, w2, w3, scale, shift, points, k, partial,
                            max_blocks, stream);
    case 1:
      return launch_stat<1>(a1, w0, w1, w2, w3, scale, shift, points, k, partial,
                            max_blocks, stream);
    case 2:
      return launch_stat<2>(a1, w0, w1, w2, w3, scale, shift, points, k, partial,
                            max_blocks, stream);
    case 3:
      return launch_stat<3>(a1, w0, w1, w2, w3, scale, shift, points, k, partial,
                            max_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a block of backward pass `level` takes, in bytes
// (0 for another level).
int edge_mlp_backward_smem(int level) {
  return level >= -1 && level <= 3 ? static_cast<int>(bwd_smem(level)) : 0;
}

// Backward pass `level` (3, 2, 1, 0, -1): a1 and W0..W3 as edge_mlp_forward;
// params (7, 512) fp32: the folded scale and shift, mu, rsqrt(var + eps),
// and for the layers above `level` the BatchNorm backward's dh = A dy - (B
// h + C): A = gamma rsqrt(var + eps), B = A (S[1] / E) rsqrt(var + eps), C
// = A (S[0] / E) - B mu (E = P k); gx0..gx3 the max-pools' cotangents (P,
// ch_l) fp32 and slots (P, 512) uint8 -> s_part (max_blocks, 2, ch_level)
// for level >= 0, dw_part (max_blocks, n) for level <= 2 with n = 128 x
// 128 (level 2: dW3[:, :128]; level 1: dW3[:, 128:]), 64 x 128 (level 0:
// dW2) or 64 x 64 + 64 x 64 (level -1: dW1, then dW0 with its rows past 6
// zero), da1 (P, k, 6) fp32 at level -1 where not null. Rows past the
// launched blocks are untouched.
int edge_mlp_backward(const void* a1, const void* w0, const void* w1, const void* w2,
                      const void* w3, const float* params, const float* gx0,
                      const float* gx1, const float* gx2, const float* gx3,
                      const uint8_t* slots, long long points, int k, int level,
                      int max_blocks, float* s_part, float* dw_part, float* da1,
                      void* stream) {
  if (points < 1 || k < 1 || k > 255 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* w[4] = {w0, w1, w2, w3};
  const float* gx[4] = {gx0, gx1, gx2, gx3};
  switch (level) {
    case 3:
      return launch_backward<3>(a1, w, params, gx, slots, points, k, max_blocks, s_part,
                                dw_part, da1, stream);
    case 2:
      return launch_backward<2>(a1, w, params, gx, slots, points, k, max_blocks, s_part,
                                dw_part, da1, stream);
    case 1:
      return launch_backward<1>(a1, w, params, gx, slots, points, k, max_blocks, s_part,
                                dw_part, da1, stream);
    case 0:
      return launch_backward<0>(a1, w, params, gx, slots, points, k, max_blocks, s_part,
                                dw_part, da1, stream);
    case -1:
      return launch_backward<-1>(a1, w, params, gx, slots, points, k, max_blocks, s_part,
                                 dw_part, da1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
