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
// q-tile; here a block owns a tile of query rows and walks the keys in tiles
// staged in shared memory, with an online softmax (FlashAttention): a running
// row max m and row sum l in fp32, the output accumulator rescaled by
// exp(m_old - m_new) at each tile and divided by l at the end. The plain
// version normalises p before its product with v; the online form divides
// at the end, so the two round differently and agree to a tolerance. The
// final m and l of every row can be written out (the split backward of a
// later slice rebuilds p from them, as `_attn_bwd_split` :2502 does).
//
// Layout: q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, Dv), read in place,
// with each tensor's batch and row strides in elements (head h of row n at
// n * row_stride + h * D; the last axis contiguous). The (B, N, D) entry of
// `fused_attention` is the case H = 1. out is (B, Nq, H, Dv) contiguous;
// row_max and row_sum (B, H, Nq) fp32, or null.
//
// Two instantiations, the two shapes DCP's eval path gives:
//
// 1. bf16, D = Dv = 128: the transformer's multi-head attentions (B 32,
//    N = M = 2048, H 4; six calls a batch). Tensor cores through
//    mma.sync.m16n8k16 (bf16 operands, fp32 accumulation): 4 warps a block,
//    16 query rows a warp, key tiles of 64. The warp keeps its q rows as
//    A fragments in registers, computes the 16 x 64 score tile into fp32
//    accumulators, updates m and l, rounds p = exp(s - m) to bf16 straight
//    from the accumulator layout into the A fragments of the P.V product
//    (FlashAttention-2's register reuse), and accumulates out (16 x 128
//    fp32) in registers. K and V tiles are staged row-major in two stages
//    of dynamic shared memory by cp.async, the next tile's copy running
//    under this tile's products; ldmatrix reads K's B fragments and, with
//    .trans, V's. Each staged row is padded by 8 bf16, so that the eight
//    rows of an ldmatrix hit 32 distinct banks.
//    As `_attn_math_fwd` :2235: bf16 operands, fp32 scores, fp32 softmax,
//    p rounded to bf16 before P.V, fp32 accumulation, out rounded to bf16
//    once; but p is rounded before the division by l.
//
// 2. fp32, D any multiple of 32, Dv = 3: the svd head's soft correspondence
//    (B 32, N = M = 2048, D 512, v = the target cloud). The TPU pads v to 128
//    lanes and rounds q and k to bf16; the port keeps the svd head in fp32 (the
//    JAX package's CPU path) and reads the 3-wide v as it is. CUDA cores: 256
//    threads a block, 128 query rows by 128 keys a tile, each thread an 8 x 8
//    block of scores (SGEMM's register tiling: two float4 loads of q and two
//    of k from shared memory feed 64 FMAs) summed over D in chunks of 32
//    staged transposed in shared memory; the 16 threads of a half-warp share
//    8 rows and reduce m, l and the 3 outputs with shuffles. q and k rows
//    start on 16-byte boundaries.
//
// What bounds them on an H100. (1) operations: 4 B H Nq M D = 275 GFLOP a
// call at DCP's shapes, 0.28 ms at the 989 TFLOP/s bf16 dense peak, against
// 1.6 ms at the 67 TFLOP/s fp32 peak; the bytes (4 x 64 MB) take 0.08 ms.
// mma.sync reaches only part of the peak that wgmma and TMA would; those are
// later work. (2) operations: 2 B Nq M (D + Dv) = 138 GFLOP of fp32, 2.1 ms
// at 67 TFLOP/s; the bytes (268 MB) take 0.08 ms. A tensor-core form would
// need TF32 or bf16 inputs, which the fp32 contract does not allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- (1) bf16 tensor cores, D = Dv = 128 ----------------------------------

constexpr int kD = 128;
constexpr int kBQ = 64;                  // query rows a block, 16 a warp
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreadsB = 128;
constexpr int kRowB = kD + 8;            // bf16 a staged K or V row (272 bytes)
constexpr int kTileB = kBK * kRowB;      // bf16 a staged K or V tile
constexpr size_t kSmemB = sizeof(__nv_bfloat16) * 4 * kTileB;   // K, V x 2 stages

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane the transposed fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__global__ void __launch_bounds__(kThreadsB)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, int heads, int nq,
                      int m, long long qb, long long qr, long long kb,
                      long long kr, long long vb, long long vr, float scale,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ row_max, float* __restrict__ row_sum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // 2 stages
  __nv_bfloat16* sv = sk + 2 * kTileB;                              // 2 stages
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kBQ + warp * 16;      // this warp's first row
  const __nv_bfloat16* qh = q + b * qb + static_cast<long long>(h) * kD;
  const __nv_bfloat16* kh = k + b * kb + static_cast<long long>(h) * kD;
  const __nv_bfloat16* vh = v + b * vb + static_cast<long long>(h) * kD;

  // K and V rows j0 .. j0 + 63 into stage s, row-major, rows past m zero
  auto stage = [&](int s, int j0) {
    for (int i = threadIdx.x; i < kBK * (kD / 8); i += kThreadsB) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool ok = j0 + r < m;
      const long long row = ok ? j0 + r : 0;
      cp_async16(sk + s * kTileB + r * kRowB + c, kh + row * kr + c, ok);
      cp_async16(sv + s * kTileB + r * kRowB + c, vh + row * vr + c, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0, 0);

  // q rows r0 + g and r0 + g + 8 as A fragments, one per 16 columns of D
  uint32_t qa[kD / 16][4];
  {
    const bool ok0 = r0 + g < nq, ok1 = r0 + g + 8 < nq;
    const __nv_bfloat16* q0 = qh + static_cast<long long>(r0 + g) * qr;
    const __nv_bfloat16* q1 = q0 + 8 * qr;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qa[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
    }
  }
  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;   // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                       // this lane's part of l
  // ldmatrix lane addressing: matrix lane / 8, its row lane % 8
  const int mi = lane >> 3, ri = lane & 7;

  for (int j0 = 0, s = 0; j0 < m; j0 += kBK, s ^= 1) {
    if (j0 + kBK < m) {
      stage(s ^ 1, j0 + kBK);            // the next tile, while this one runs
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                     // tile s is in shared memory
    const __nv_bfloat16* ks = sk + s * kTileB;
    const __nv_bfloat16* vs = sv + s * kTileB;

    // scores: 16 rows x 64 keys, 8 accumulator tiles of 8 keys; one ldmatrix
    // gives the B fragments of two key tiles
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + (mi >> 1) * 8 + ri) * kRowB + kk * 16 + (mi & 1) * 8);
        mma_bf16(sc[2 * np], qa[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }
    // scale, mask the keys past m, the tile's row max
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const int key = j0 + nt * 8 + 2 * t;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool ok = key + (x & 1) < m;
        sc[nt][x] = ok ? sc[nt][x] * scale : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);   // 0 at the first tile
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    // p = exp(s - m), summed in fp32, rounded to bf16 for P.V; V's B
    // fragments come transposed out of its row-major tile
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = expf(sc[2 * kk][x] - (x < 2 ? m0 : m1));
        p[4 + x] = expf(sc[2 * kk + 1][x] - (x < 2 ? m0 : m1));
      }
      l0 += (p[0] + p[1]) + (p[4] + p[5]);
      l1 += (p[2] + p[3]) + (p[6] + p[7]);
      const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                              pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vs + (kk * 16 + (mi & 1) * 8 + ri) * kRowB + np * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * np], pa, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // tile s consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int rows[2] = {r0 + g, r0 + g + 8};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = rows[half];
    if (n >= nq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* op = out + (static_cast<long long>(b) * nq + n) * heads * kD
                        + static_cast<long long>(h) * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(op + nt * 8 + 2 * t) =
          pack_bf16(o[nt][2 * half] * inv, o[nt][2 * half + 1] * inv);
    }
    if (t == 0 && row_max != nullptr) {
      row_max[static_cast<long long>(bh) * nq + n] = half ? m1 : m0;
      row_sum[static_cast<long long>(bh) * nq + n] = half ? l1 : l0;
    }
  }
}

// ---- (2) fp32 CUDA cores, D % 32 == 0, Dv = 3 ------------------------------

constexpr int kDv = 3;
constexpr int kT = 16;                   // threads along each side of the tile
constexpr int kR = 8;                    // query rows and keys a thread
constexpr int kTile = kT * kR;           // 128 query rows and 128 keys a tile
constexpr int kChunk = 32;               // D a staging step
constexpr int kThreadsF = kT * kT;

// Row (or key) i of a thread's 8: 4 adjacent ones, then 4 more 64 further on,
// so that a thread's two float4 loads of a staged column hit other banks
// than its neighbours'.
__device__ __forceinline__ int spread(int t, int i) {
  return (i < 4 ? 0 : kTile / 2) + t * 4 + (i & 3);
}

__global__ void __launch_bounds__(kThreadsF)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, int heads, int nq, int m, int d,
                     long long qb, long long qr, long long kb, long long kr,
                     long long vb, long long vr, float scale,
                     float* __restrict__ out, float* __restrict__ row_max,
                     float* __restrict__ row_sum) {
  __shared__ __align__(16) float sq[kChunk * kTile];   // (D chunk, query row)
  __shared__ __align__(16) float sk[kChunk * kTile];   // (D chunk, key)
  __shared__ float sv[kTile * kDv];
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const int q0 = blockIdx.x * kTile;
  const float* qh = q + b * qb + static_cast<long long>(h) * d;
  const float* kh = k + b * kb + static_cast<long long>(h) * d;
  const float* vh = v + b * vb + static_cast<long long>(h) * kDv;

  float mrow[kR], lpart[kR], opart[kR][kDv];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    mrow[i] = -CUDART_INF_F;
    lpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDv; ++c) opart[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < m; j0 += kTile) {
    float acc[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) acc[i][jj] = 0.f;
    }
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();                   // the previous chunk (and sv) consumed
      // 128 rows x 32 columns of q and of k, a float4 a thread a step, stored
      // transposed; a warp reads 32 rows, so its stores hit 32 banks
      for (int i = threadIdx.x; i < kTile * kChunk / 4; i += kThreadsF) {
        const int r = i % kTile, c = (i / kTile) * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), e = a;
        if (q0 + r < nq) {
          a = *reinterpret_cast<const float4*>(qh + static_cast<long long>(q0 + r) * qr + c0 + c);
        }
        if (j0 + r < m) {
          e = *reinterpret_cast<const float4*>(kh + static_cast<long long>(j0 + r) * kr + c0 + c);
        }
        sq[(c + 0) * kTile + r] = a.x;
        sq[(c + 1) * kTile + r] = a.y;
        sq[(c + 2) * kTile + r] = a.z;
        sq[(c + 3) * kTile + r] = a.w;
        sk[(c + 0) * kTile + r] = e.x;
        sk[(c + 1) * kTile + r] = e.y;
        sk[(c + 2) * kTile + r] = e.z;
        sk[(c + 3) * kTile + r] = e.w;
      }
      if (c0 == 0) {
        for (int i = threadIdx.x; i < kTile * kDv; i += kThreadsF) {
          const int r = i / kDv, c = i % kDv;
          sv[i] = j0 + r < m ? vh[static_cast<long long>(j0 + r) * vr + c] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        const float4 qa = *reinterpret_cast<const float4*>(sq + c * kTile + ty * 4);
        const float4 qc = *reinterpret_cast<const float4*>(sq + c * kTile + kTile / 2 + ty * 4);
        const float4 ka = *reinterpret_cast<const float4*>(sk + c * kTile + tx * 4);
        const float4 kc = *reinterpret_cast<const float4*>(sk + c * kTile + kTile / 2 + tx * 4);
        const float qv[kR] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
        const float kv[kR] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
        for (int i = 0; i < kR; ++i) {
#pragma unroll
          for (int jj = 0; jj < kR; ++jj) acc[i][jj] = fmaf(qv[i], kv[jj], acc[i][jj]);
        }
      }
    }
    // online softmax over this tile's keys spread(tx, jj)
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        acc[i][jj] = j0 + spread(tx, jj) < m ? acc[i][jj] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, acc[i][jj]);
      }
#pragma unroll
      for (int off = 1; off < kT; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mn = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - mn);
      mrow[i] = mn;
      lpart[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kDv; ++c) opart[i][c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        const float p = expf(acc[i][jj] - mn);
        lpart[i] += p;
        const int key = spread(tx, jj);
#pragma unroll
        for (int c = 0; c < kDv; ++c) opart[i][c] = fmaf(p, sv[key * kDv + c], opart[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int off = 1; off < kT; off <<= 1) {
      lpart[i] += __shfl_xor_sync(kFull, lpart[i], off);
#pragma unroll
      for (int c = 0; c < kDv; ++c) opart[i][c] += __shfl_xor_sync(kFull, opart[i][c], off);
    }
    const int n = q0 + spread(ty, i);
    if (tx == 0 && n < nq) {
      float* op = out + ((static_cast<long long>(b) * nq + n) * heads + h) * kDv;
#pragma unroll
      for (int c = 0; c < kDv; ++c) op[c] = opart[i][c] / lpart[i];
      if (row_max != nullptr) {
        row_max[static_cast<long long>(bh) * nq + n] = mrow[i];
        row_sum[static_cast<long long>(bh) * nq + n] = lpart[i];
      }
    }
  }
}

bool bad_shape(int batch, int heads, int nq, int m) {
  return batch < 1 || heads < 1 || nq < 1 || m < 1 ||
         static_cast<long long>(batch) * heads > 65535;
}

}  // namespace

extern "C" {

// q (B, Nq, H, 128), k and v (B, M, H, 128) bf16 on the device, each with
// its batch and row strides in elements (16-byte aligned rows, the last axis
// contiguous), scale > 0 -> out (B, Nq, H, 128) bf16 contiguous, and the
// final row max and row sum (B, H, Nq) fp32 where row_max is not null.
// Launches on `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty input or B * H > 65535.
int attention_bf16_forward(const void* q, const void* k, const void* v,
                           int batch, int heads, int nq, int m, long long qb,
                           long long qr, long long kb, long long kr,
                           long long vb, long long vr, float scale, void* out,
                           float* row_max, float* row_sum, void* stream) {
  if (bad_shape(batch, heads, nq, m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemB));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((nq + kBQ - 1) / kBQ, batch * heads);
  attention_bf16_kernel<<<grid, kThreadsB, kSmemB, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), heads, nq, m, qb, qr, kb, kr, vb, vr,
      scale, static_cast<__nv_bfloat16*>(out), row_max, row_sum);
  return static_cast<int>(cudaGetLastError());
}

// q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, 3) fp32 with D % 32 == 0,
// strides as above (q and k rows 16-byte aligned) -> out (B, Nq, H, 3) fp32
// contiguous, row stats as above.
int attention_f32_forward(const float* q, const float* k, const float* v,
                          int batch, int heads, int nq, int m, int d,
                          long long qb, long long qr, long long kb, long long kr,
                          long long vb, long long vr, float scale, float* out,
                          float* row_max, float* row_sum, void* stream) {
  if (bad_shape(batch, heads, nq, m) || d < kChunk || d % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((nq + kTile - 1) / kTile, batch * heads);
  attention_f32_kernel<<<grid, kThreadsF, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, heads, nq, m, d, qb, qr, kb, kr, vb, vr, scale, out, row_max,
      row_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
