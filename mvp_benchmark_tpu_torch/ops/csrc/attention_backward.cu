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
//   delta[n] = sum_c dO[n, c] o[n, c]                  (computed by the caller)
//   p[n, j]  = exp(q[n] . k[j] * scale - m[n]) / l[n]
//   ds[n, j] = (p[n, j] (dO[n] . v[j] - delta[n])) * scale
//   dq[n] = sum_j ds[n, j] k[j]
//   dk[j] = sum_n ds[n, j] q[n],   dv[j] = sum_n p[n, j] dO[n]
//
// the semantics of ops/ref.py `attention_backward`. The TPU's bnhd backward
// (and its monolithic narrow-D one) adds every q-tile's dK/dV into one
// output block, relying on the TPU grid running in order; on a GPU that is a
// race. Both instantiations here take the split form for both layouts: a dQ
// pass whose block owns a tile of query rows and walks the keys, and a dK/dV
// pass whose block owns a tile of keys and walks the queries, each writing
// its own tiles once. No atomics: the results are the same from run to run.
// The two passes are one kernel with the roles of the operands swapped
// (kKV): the block's own rows X with partner Y (q with dO; k with v), the
// walked tiles Z with W (k with v; q with dO); the row statistics belong to
// the queries, so to the own rows in the dQ pass and to the walked columns
// in the dK/dV pass.
//
// Layout: q (B, Nq, H, D), k (B, M, H, D), v (B, M, H, Dv), read in place
// with each tensor's batch and row strides in elements (the last axis
// contiguous); dO (B, Nq, H, Dv), m, l and delta (B, H, Nq) contiguous; dq,
// dk, dv contiguous in the inputs' layouts.
//
// 1. bf16, D = Dv = 128: the transformer's heads (B 32, N = M = 2048, H 4;
//    six calls a step). Tensor cores through mma.sync.m16n8k16 (bf16
//    operands, fp32 accumulation): 4 warps a block, 16 own rows a warp
//    (64 a block), walked tiles of 32 staged by cp.async in two stages. A
//    warp computes its 16 x 32 score and dP tiles, turns them into p and ds
//    in registers, rounds them to bf16 straight into A fragments (as the
//    forward does with p) and accumulates ds . Z (and p . W for dV) into
//    16 x 128 fp32 tiles in registers. ldmatrix reads every fragment from
//    shared memory, .trans for the products over the walked rows. As
//    `_attn_bwd_dq_kernel`/`_attn_bwd_dkv_kernel`: bf16 operands, fp32
//    scores, p from the saved statistics in fp32, p and ds rounded to bf16
//    before their products, each gradient rounded to bf16 once.
//
// 2. fp32, D = 512, Dv = 3: the svd head's correspondence (B 32,
//    N = M = 2048, D 512, v the target cloud, whose gradient the model never
//    asks for). CUDA cores, 256 threads a block, 64 own rows by 64 walked
//    rows a tile: the score tile as the forward's (D in chunks of 32 staged
//    transposed, a 4 x 4 register tile a thread), p and ds into shared
//    memory, then the own rows' 64 x D gradient, held in registers (4 rows
//    x 32 columns a thread), gains ds . Z with Z staged 16 rows at a time.
//    dv (64 x 3 a block) sums p . dO from shared memory, only when asked.
//
// What bounds them on an H100: operations. (1) One call at DCP's shapes is
// 7 products of 2 B H N M D = 137 GFLOP (S, dP and dQ; S^T, dP^T, dK and
// dV): 0.96 TFLOP, 0.97 ms at the 989 TFLOP/s bf16 dense peak; the bytes
// (q, k, v, o, dO read, dq, dk, dv written: 8 x 67 MB) take 0.16 ms.
// mma.sync and 4 warps a block reach only part of that peak; wgmma and TMA
// are later work. (2) 4 products of 2 B N M D = 137 GFLOP plus the 3-wide
// ones: 0.55 TFLOP of fp32, 8.2 ms at 67 TFLOP/s; the bytes (4 x 134 MB)
// 0.16 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---- (1) bf16 tensor cores, D = Dv = 128 ----------------------------------

constexpr int kD = 128;
constexpr int kBR = 64;                  // own rows a block, 16 a warp
constexpr int kBC = 32;                  // walked rows a tile
constexpr int kThreadsB = 128;
constexpr int kRowB = kD + 8;            // bf16 a staged row (272 bytes)
constexpr int kOwnB = kBR * kRowB;       // bf16 an own tile (X or Y)
constexpr int kTileB = kBC * kRowB;      // bf16 a walked tile (Z or W), a stage
constexpr size_t kSmemB = sizeof(__nv_bfloat16) * (2 * kOwnB + 4 * kTileB) +
                          sizeof(float) * 2 * 3 * kBC;   // + m, l, delta x 2 stages

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

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

// 16 x 32 product of the warp's 16 own rows of `own` (rows at stride kRowB)
// with the 32 walked rows of `walk`, over D: acc[nt] holds walked rows
// nt * 8 .. nt * 8 + 7.
__device__ __forceinline__ void rows_by_tile(const __nv_bfloat16* own,
                                             const __nv_bfloat16* walk,
                                             float (&acc)[kBC / 8][4], int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int nt = 0; nt < kBC / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t af[4];   // matrices: rows 0-7 / 8-15 at columns +0, then +8
    ldsm_x4(af, own + ((mi & 1) * 8 + ri) * kRowB + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < kBC / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, walk + (np * 16 + (mi >> 1) * 8 + ri) * kRowB + kk * 16 + (mi & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 128) += P (16 x 32, bf16 A fragments from the register tile
// `src`) . walk (32 x 128, read transposed out of its row-major tile).
__device__ __forceinline__ void tile_by_walk(const float (&src)[kBC / 8][4],
                                             const __nv_bfloat16* walk,
                                             float (&acc)[kD / 8][4], int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kBC / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(src[2 * kk][0], src[2 * kk][1]),
                            pack_bf16(src[2 * kk][2], src[2 * kk][3]),
                            pack_bf16(src[2 * kk + 1][0], src[2 * kk + 1][1]),
                            pack_bf16(src[2 * kk + 1][2], src[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, walk + (kk * 16 + (mi & 1) * 8 + ri) * kRowB + np * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

// Rows r0 + g and r0 + g + 8 of a (N, row_stride) bf16 output whose row n
// starts at out + n * row_stride, rows past n_rows skipped.
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[kD / 8][4],
                                                __nv_bfloat16* out,
                                                long long row_stride, int r0,
                                                int n_rows, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = r0 + g + 8 * half;
    if (n >= n_rows) continue;
    __nv_bfloat16* op = out + n * row_stride;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(op + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// Own rows X (with partner Y), walked rows Z (with W): the dQ pass (kKV
// false: X = q, Y = dO, Z = k, W = v) or the dK/dV pass (kKV true: X = k,
// Y = v, Z = q, W = dO). out0 = dq or dk, out1 = dv (kKV) or unused; the
// outputs are (B, N_own, H, 128) contiguous, written where not null.
template <bool kKV>
__global__ void __launch_bounds__(kThreadsB)
attention_bf16_backward_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ delta, int heads, int n_own, int n_walk,
    long long xb, long long xr, long long yb, long long yr, long long zb,
    long long zr, long long wb, long long wr, int nq, float scale,
    __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sy = sx + kOwnB;
  __nv_bfloat16* sz = sy + kOwnB;                   // 2 stages
  __nv_bfloat16* sw = sz + 2 * kTileB;              // 2 stages
  float* sstat = reinterpret_cast<float*>(sw + 2 * kTileB);   // [stage][m, l, delta][kBC]
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int own0 = blockIdx.x * kBR;
  const int r0 = own0 + warp * 16;                  // this warp's first own row
  const __nv_bfloat16* xh = x + b * xb + static_cast<long long>(h) * kD;
  const __nv_bfloat16* yh = y + b * yb + static_cast<long long>(h) * kD;
  const __nv_bfloat16* zh = z + b * zb + static_cast<long long>(h) * kD;
  const __nv_bfloat16* wh = w + b * wb + static_cast<long long>(h) * kD;
  const float* mh = row_max + static_cast<long long>(bh) * nq;
  const float* lh = row_sum + static_cast<long long>(bh) * nq;
  const float* dh = delta + static_cast<long long>(bh) * nq;

  // the own tiles, rows past n_own zero
  for (int i = threadIdx.x; i < kBR * (kD / 8); i += kThreadsB) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const bool ok = own0 + r < n_own;
    const long long row = ok ? own0 + r : 0;
    cp_async16(sx + r * kRowB + c, xh + row * xr + c, ok);
    cp_async16(sy + r * kRowB + c, yh + row * yr + c, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // walked rows j0 .. j0 + 31 into stage s (rows past n_walk zero); in the
  // dK/dV pass also their queries' statistics
  auto stage = [&](int s, int j0) {
    for (int i = threadIdx.x; i < kBC * (kD / 8); i += kThreadsB) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool ok = j0 + r < n_walk;
      const long long row = ok ? j0 + r : 0;
      cp_async16(sz + s * kTileB + r * kRowB + c, zh + row * zr + c, ok);
      cp_async16(sw + s * kTileB + r * kRowB + c, wh + row * wr + c, ok);
    }
    if (kKV && threadIdx.x < kBC) {
      const int n = j0 + threadIdx.x;
      const bool ok = n < n_walk;
      float* st = sstat + s * 3 * kBC;
      st[threadIdx.x] = ok ? mh[n] : 0.f;
      st[kBC + threadIdx.x] = ok ? lh[n] : 1.f;
      st[2 * kBC + threadIdx.x] = ok ? dh[n] : 0.f;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0, 0);

  // the dQ pass's own rows g and g + 8 carry the statistics
  float m_row[2] = {0.f, 0.f}, l_row[2] = {1.f, 1.f}, d_row[2] = {0.f, 0.f};
  if (!kKV) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = r0 + g + 8 * half;
      if (n < n_own) {
        m_row[half] = mh[n];
        l_row[half] = lh[n];
        d_row[half] = dh[n];
      }
    }
  }
  float acc0[kD / 8][4], acc1[kKV ? kD / 8 : 1][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc0[i][0] = acc0[i][1] = acc0[i][2] = acc0[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (kKV ? kD / 8 : 1); ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
  const __nv_bfloat16* sxw = sx + warp * 16 * kRowB;
  const __nv_bfloat16* syw = sy + warp * 16 * kRowB;

  for (int j0 = 0, s = 0; j0 < n_walk; j0 += kBC, s ^= 1) {
    if (j0 + kBC < n_walk) {
      stage(s ^ 1, j0 + kBC);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* zs = sz + s * kTileB;
    const __nv_bfloat16* ws = sw + s * kTileB;
    const float* st = sstat + s * 3 * kBC;

    float p[kBC / 8][4], ds[kBC / 8][4];
    rows_by_tile(sxw, zs, p, lane);       // scores, unscaled
    rows_by_tile(syw, ws, ds, lane);      // dP
#pragma unroll
    for (int nt = 0; nt < kBC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int half = e >> 1;
        const bool ok = j0 + col < n_walk;
        float mq, lq, dq;
        if (kKV) {
          mq = st[col];
          lq = st[kBC + col];
          dq = st[2 * kBC + col];
        } else {
          mq = m_row[half];
          lq = l_row[half];
          dq = d_row[half];
        }
        const float pv = ok ? expf(__fmul_rn(p[nt][e], scale) - mq) / lq : 0.f;
        p[nt][e] = pv;
        ds[nt][e] = (pv * (ds[nt][e] - dq)) * scale;
      }
    }
    tile_by_walk(ds, zs, acc0, lane);     // dq += ds . k  |  dk += ds^T . q
    if constexpr (kKV) tile_by_walk(p, ws, acc1, lane);   // dv += p^T . dO
    __syncthreads();                      // stage s consumed before it is refilled
  }

  // out row n of head h at ((b N_own + n) H + h) 128
  const long long head0 = (static_cast<long long>(b) * n_own * heads + h) * kD;
  if (out0 != nullptr) store_rows_bf16(acc0, out0 + head0, heads * kD, r0, n_own, g, t);
  if constexpr (kKV) {
    if (out1 != nullptr) store_rows_bf16(acc1, out1 + head0, heads * kD, r0, n_own, g, t);
  }
}

// ---- (2) fp32 CUDA cores, D = 512, Dv = 3 ---------------------------------

constexpr int kDF = 512;
constexpr int kDv = 3;
constexpr int kFR = 64;                  // own rows a block
constexpr int kFC = 64;                  // walked rows a tile
constexpr int kChunk = 32;               // D a staging step of the scores
constexpr int kFZ = 16;                  // walked rows a staging step of the gradient
constexpr int kThreadsF = 256;           // 16 x 16
constexpr int kCols4 = kDF / 64;         // float4 columns of the gradient a thread
constexpr size_t kSmemF = sizeof(float) * (2 * kChunk * kFR + 2 * kFC * kFR +
                                           kFZ * kDF + kFC * (3 + kDv) + kFR * kDv);

template <bool kKV>
__global__ void __launch_bounds__(kThreadsF)
attention_f32_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ v, const float* __restrict__ d_out,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ delta, int heads, int n_own, int n_walk,
    long long xb, long long xr, long long zb, long long zr, long long vb,
    long long vr, int nq, float scale, float* __restrict__ out0,
    float* __restrict__ out1) {
  extern __shared__ __align__(16) float smem_f[];
  float* sxc = smem_f;                        // (D chunk, own row)
  float* szc = sxc + kChunk * kFR;            // (D chunk, walked row)
  float* sds = szc + kChunk * kFC;            // (walked, own): ds
  float* sp = sds + kFC * kFR;                // (walked, own): p, for dv
  float* sz = sp + kFC * kFR;                 // kFZ walked rows of Z, D wide
  float* swalk = sz + kFZ * kDF;              // per walked row: m, l, delta | v or dO
  float* sown = swalk + kFC * (3 + kDv);      // per own row: dO (dQ) or v (dK/dV)
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int own0 = blockIdx.x * kFR;
  const float* xh = x + b * xb + static_cast<long long>(h) * kDF;
  const float* zh = z + b * zb + static_cast<long long>(h) * kDF;
  const float* vh = v + b * vb + static_cast<long long>(h) * kDv;
  const float* doh = d_out + static_cast<long long>(b) * nq * heads * kDv + h * kDv;
  const float* mh = row_max + static_cast<long long>(bh) * nq;
  const float* lh = row_sum + static_cast<long long>(bh) * nq;
  const float* dh = delta + static_cast<long long>(bh) * nq;

  // the own rows' 3-wide partner: dO of the queries (dQ), v of the keys
  // (dK/dV); the dQ pass's own statistics
  for (int i = threadIdx.x; i < kFR * kDv; i += kThreadsF) {
    const int r = i / kDv, c = i % kDv;
    const int n = own0 + r;
    float val = 0.f;
    if (n < n_own) {
      val = kKV ? vh[static_cast<long long>(n) * vr + c]
                : doh[static_cast<long long>(n) * heads * kDv + c];
    }
    sown[i] = val;
  }
  float m_own[4], l_own[4], d_own[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = own0 + ty * 4 + i;
    const bool ok = !kKV && n < n_own;
    m_own[i] = ok ? mh[n] : 0.f;
    l_own[i] = ok ? lh[n] : 1.f;
    d_own[i] = ok ? dh[n] : 0.f;
  }
  float acc[4][4 * kCols4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * kCols4; ++c) acc[i][c] = 0.f;
  }
  float dv_acc = 0.f;                          // dv[key threadIdx / 3][threadIdx % 3]

  for (int j0 = 0; j0 < n_walk; j0 += kFC) {
    __syncthreads();                           // the previous tile consumed
    // the walked rows' statistics (in the dK/dV pass they are the queries)
    // and 3-wide partner: v of the keys (dQ), dO of the queries (dK/dV)
    for (int i = threadIdx.x; i < kFC; i += kThreadsF) {
      const int n = j0 + i;
      const bool ok = kKV && n < n_walk;
      swalk[i] = ok ? mh[n] : 0.f;
      swalk[kFC + i] = ok ? lh[n] : 1.f;
      swalk[2 * kFC + i] = ok ? dh[n] : 0.f;
    }
    for (int i = threadIdx.x; i < kFC * kDv; i += kThreadsF) {
      const int r = i / kDv, c = i % kDv;
      const int n = j0 + r;
      float val = 0.f;
      if (n < n_walk) {
        val = kKV ? doh[static_cast<long long>(n) * heads * kDv + c]
                  : vh[static_cast<long long>(n) * vr + c];
      }
      swalk[3 * kFC + i] = val;
    }
    // scores, own rows ty * 4 + i by walked rows tx * 4 + jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    for (int c0 = 0; c0 < kDF; c0 += kChunk) {
      __syncthreads();
      for (int i = threadIdx.x; i < kFR * kChunk / 4; i += kThreadsF) {
        const int r = i % kFR, c = (i / kFR) * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), e = a;
        if (own0 + r < n_own) {
          a = *reinterpret_cast<const float4*>(xh + static_cast<long long>(own0 + r) * xr + c0 + c);
        }
        if (j0 + r < n_walk) {
          e = *reinterpret_cast<const float4*>(zh + static_cast<long long>(j0 + r) * zr + c0 + c);
        }
        sxc[(c + 0) * kFR + r] = a.x;
        sxc[(c + 1) * kFR + r] = a.y;
        sxc[(c + 2) * kFR + r] = a.z;
        sxc[(c + 3) * kFR + r] = a.w;
        szc[(c + 0) * kFC + r] = e.x;
        szc[(c + 1) * kFC + r] = e.y;
        szc[(c + 2) * kFC + r] = e.z;
        szc[(c + 3) * kFC + r] = e.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(sxc + c * kFR + ty * 4);
        const float4 e = *reinterpret_cast<const float4*>(szc + c * kFC + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(av[i], ev[jj], sc[i][jj]);
        }
      }
    }
    // p and ds, stored (walked, own)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx * 4 + jj;
        const bool ok = j0 + c < n_walk;
        const float mq = kKV ? swalk[c] : m_own[i];
        const float lq = kKV ? swalk[kFC + c] : l_own[i];
        const float dq = kKV ? swalk[2 * kFC + c] : d_own[i];
        const float* a3 = sown + r * kDv;
        const float* b3 = swalk + 3 * kFC + c * kDv;
        const float dp = fmaf(a3[2], b3[2], fmaf(a3[1], b3[1], a3[0] * b3[0]));
        const float p = ok ? expf(__fmul_rn(sc[i][jj], scale) - mq) / lq : 0.f;
        sds[c * kFR + r] = (p * (dp - dq)) * scale;
        if (kKV) sp[c * kFR + r] = p;
      }
    }
    __syncthreads();
    if (kKV && out1 != nullptr && threadIdx.x < kFR * kDv) {
      const int key = threadIdx.x / kDv, c = threadIdx.x % kDv;
      for (int q = 0; q < kFC; ++q) {
        dv_acc = fmaf(sp[q * kFR + key], swalk[3 * kFC + q * kDv + c], dv_acc);
      }
    }
    // the own rows' gradient += ds . Z, Z staged kFZ rows at a time
    for (int z0 = 0; z0 < kFC; z0 += kFZ) {
      __syncthreads();
      for (int i = threadIdx.x; i < kFZ * kDF / 4; i += kThreadsF) {
        const int r = i / (kDF / 4), c = (i % (kDF / 4)) * 4;
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + z0 + r < n_walk) {
          e = *reinterpret_cast<const float4*>(zh + static_cast<long long>(j0 + z0 + r) * zr + c);
        }
        *reinterpret_cast<float4*>(sz + r * kDF + c) = e;
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kFZ; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(sds + (z0 + r) * kFR + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int c4 = 0; c4 < kCols4; ++c4) {
          const float4 e = *reinterpret_cast<const float4*>(sz + r * kDF + c4 * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c4 * 4 + 0] = fmaf(av[i], e.x, acc[i][c4 * 4 + 0]);
            acc[i][c4 * 4 + 1] = fmaf(av[i], e.y, acc[i][c4 * 4 + 1]);
            acc[i][c4 * 4 + 2] = fmaf(av[i], e.z, acc[i][c4 * 4 + 2]);
            acc[i][c4 * 4 + 3] = fmaf(av[i], e.w, acc[i][c4 * 4 + 3]);
          }
        }
      }
    }
  }

  // out row n of head h at ((b N_own + n) H + h) D
  const long long head0 = static_cast<long long>(b) * n_own * heads + h;
  if (out0 != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = own0 + ty * 4 + i;
      if (n >= n_own) continue;
      float* op = out0 + (head0 + static_cast<long long>(n) * heads) * kDF;
#pragma unroll
      for (int c4 = 0; c4 < kCols4; ++c4) {
        *reinterpret_cast<float4*>(op + c4 * 64 + tx * 4) =
            make_float4(acc[i][c4 * 4], acc[i][c4 * 4 + 1], acc[i][c4 * 4 + 2],
                        acc[i][c4 * 4 + 3]);
      }
    }
  }
  if (kKV && out1 != nullptr && threadIdx.x < kFR * kDv) {
    const int key = own0 + threadIdx.x / kDv;
    if (key < n_own) {
      out1[(head0 + static_cast<long long>(key) * heads) * kDv + threadIdx.x % kDv] = dv_acc;
    }
  }
}

bool bad_shape(int batch, int heads, int nq, int m) {
  return batch < 1 || heads < 1 || nq < 1 || m < 1 ||
         static_cast<long long>(batch) * heads > 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// The backward of attention_bf16_forward: q (B, Nq, H, 128), k and v
// (B, M, H, 128) bf16 with their batch and row strides in elements (16-byte
// aligned rows, the last axis contiguous), d_out (B, Nq, H, 128) bf16
// contiguous, row_max, row_sum (the forward's) and delta = rowsum(d_out o)
// (B, H, Nq) fp32 -> dq (B, Nq, H, 128), dk and dv (B, M, H, 128) bf16
// contiguous. The dQ pass runs when dq is not null, the dK/dV pass when dk
// or dv is not null. Launches on `stream` without synchronising; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty input or
// B * H > 65535.
int attention_bf16_backward(const void* q, const void* k, const void* v,
                            const void* d_out, const float* row_max,
                            const float* row_sum, const float* delta, int batch,
                            int heads, int nq, int m, long long qb, long long qr,
                            long long kb, long long kr, long long vb, long long vr,
                            float scale, void* dq, void* dk, void* dv,
                            void* stream) {
  if (bad_shape(batch, heads, nq, m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* q16 = static_cast<const bf*>(q);
  const bf* k16 = static_cast<const bf*>(k);
  const bf* v16 = static_cast<const bf*>(v);
  const bf* o16 = static_cast<const bf*>(d_out);
  const long long ob = static_cast<long long>(nq) * heads * kD, orow = heads * kD;
  cudaError_t err;
  if (dq != nullptr) {
    if ((err = allow_smem(attention_bf16_backward_kernel<false>, kSmemB)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((nq + kBR - 1) / kBR, batch * heads);
    attention_bf16_backward_kernel<false><<<grid, kThreadsB, kSmemB, s>>>(
        q16, o16, k16, v16, row_max, row_sum, delta, heads, nq, m, qb, qr, ob,
        orow, kb, kr, vb, vr, nq, scale, static_cast<bf*>(dq), nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dk != nullptr || dv != nullptr) {
    if ((err = allow_smem(attention_bf16_backward_kernel<true>, kSmemB)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((m + kBR - 1) / kBR, batch * heads);
    attention_bf16_backward_kernel<true><<<grid, kThreadsB, kSmemB, s>>>(
        k16, v16, q16, o16, row_max, row_sum, delta, heads, m, nq, kb, kr, vb,
        vr, qb, qr, ob, orow, nq, scale, static_cast<bf*>(dk), static_cast<bf*>(dv));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of attention_f32_forward at D = 512: q (B, Nq, H, 512) and k
// (B, M, H, 512) fp32 with 16-byte aligned rows, v (B, M, H, 3), strides as
// above; d_out (B, Nq, H, 3) fp32 contiguous, row stats and delta as above
// -> dq (B, Nq, H, 512), dk (B, M, H, 512), dv (B, M, H, 3) fp32
// contiguous, each computed where not null (dk and dv in one pass).
int attention_f32_backward(const float* q, const float* k, const float* v,
                           const float* d_out, const float* row_max,
                           const float* row_sum, const float* delta, int batch,
                           int heads, int nq, int m, int d, long long qb,
                           long long qr, long long kb, long long kr, long long vb,
                           long long vr, float scale, float* dq, float* dk,
                           float* dv, void* stream) {
  if (bad_shape(batch, heads, nq, m) || d != kDF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dq != nullptr) {
    if ((err = allow_smem(attention_f32_backward_kernel<false>, kSmemF)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((nq + kFR - 1) / kFR, batch * heads);
    attention_f32_backward_kernel<false><<<grid, kThreadsF, kSmemF, s>>>(
        q, k, v, d_out, row_max, row_sum, delta, heads, nq, m, qb, qr, kb, kr,
        vb, vr, nq, scale, dq, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dk != nullptr || dv != nullptr) {
    if ((err = allow_smem(attention_f32_backward_kernel<true>, kSmemF)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dim3 grid((m + kFR - 1) / kFR, batch * heads);
    attention_f32_backward_kernel<true><<<grid, kThreadsF, kSmemF, s>>>(
        k, q, v, d_out, row_max, row_sum, delta, heads, m, nq, kb, kr, qb, qr,
        vb, vr, nq, scale, dk, dv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
