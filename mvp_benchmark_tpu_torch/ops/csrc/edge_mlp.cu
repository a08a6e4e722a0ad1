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
// Forward passes (edge_mlp_kernel). Tensor cores through mma.sync.m16n8k16
// (bf16 operands, fp32 accumulation). A group of 4 warps runs 16 points, one
// neighbour slot j at a time: the 16 edges (p, j) form the 16 rows of every
// product. Warp q of the group computes a quarter of each layer's output
// channels, keeps the running max over j of exactly those channels in
// registers, and writes its bf16 activations to the group's buffer in shared
// memory, from which all 4 warps read the next layer's A fragments; a named
// barrier per group orders the layers. A block holds two groups (256
// threads) and the four weights, transposed to (out, in) and padded by 8 bf16
// a row so that the B-fragment loads hit 32 distinct banks (W0's 6 input rows
// are zero-padded to 16, one k-step). Blocks are persistent: one per SM that
// fits, each group walking tiles of 16 points with a grid stride, so the
// weights (100 KB) are staged once per block. Points past the end read zero
// edges and write nothing.
// - The final pass writes the four max-pools (only they reach device
//   memory; the (P, k, ch) activations never do) and, in train, each
//   max-pool's argmax slot (P, 512) uint8: the first j reaching the max, as
//   torch.max routes its gradient (the TPU kernel finds the argmax again in
//   its backward by float equality against a recompute, :2889).
// - The stat pass of layer l runs layers 0..l-1 with the statistics found so
//   far and sums h_l and h_l^2 over the edges. The TPU adds every block into
//   one accumulator in grid order, a race on a GPU: here each group writes
//   its partial sums and the wrapper adds them in a fixed order, so the
//   statistics are the same from run to run.
//
// Backward passes (edge_mlp_backward_kernel), top-down as the TPU's: pass
// `level` (3, 2, 1, 0, -1) recomputes the chain for every edge, routes each
// max-pool's cotangent gx_l to its saved argmax slot, applies relu's mask and
// the BatchNorm backward with the sums S_l = [sum dy, sum dy hhat] of the
// layers above (found by the passes before), pushes the cotangent down
// through W_l, and at its level sums S_level and dW_{level+1} = a^T dh; the
// level -1 pass sums dW_0 and writes d_a1 when asked. dgamma_l = S_l[1],
// dbeta_l = S_l[0]. A block is one group of 8 warps on 16 edges (warp w
// computes an eighth of each layer's channels), so that one block's dW
// accumulator (up to dW_3, 128 x 256 fp32) fits its shared memory; each warp
// adds the mma products of its own columns of dW into it (no atomics), the
// weights are read from device memory (L1/L2 resident), and every block
// writes its partial S and dW for a fixed-order sum in the wrapper. As
// `_em_bwd_kernel`: dh and a rounded to bf16 before their products, fp32 sums.
// Recomputing costs 4 layers of products an edge a pass; keeping the
// activations in memory instead would store 1.3 GB a call at DCP's shape.
//
// What bounds it on an H100: operations. DCP's call is 32 x 2048 points x 20
// neighbours = 1.31 M edges of 2 (6*64 + 64*64 + 64*128 + 128*256) = 90.9 k
// flops, 119 GFLOP a pass: 0.12 ms at the 989 TFLOP/s bf16 dense peak; a1
// (15.7 MB) and the outputs (134 MB) take 0.045 ms. The four stat passes
// recompute 165 GFLOP, the five backward passes ~1.15 TFLOP (recompute, push
// down, dW). mma.sync from registers, a barrier per layer and 8 warps an SM
// leave this well short of the tensor-core peak; wgmma over larger edge
// tiles, and fusing the passes, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC0 = 6;                         // a1 channels: [x_j | x_i]
constexpr int kCh0 = 64, kCh1 = 64, kCh2 = 128, kCh3 = 256;
constexpr int kChTotal = kCh0 + kCh1 + kCh2 + kCh3;
constexpr int kOff0 = 0, kOff1 = kCh0, kOff2 = kOff1 + kCh1, kOff3 = kOff2 + kCh2;
constexpr int kGroups = 2, kThreads = kGroups * 128;
// bf16 row strides (input width + 8) of the transposed weights and of the
// per-group activation buffers
constexpr int kS0 = 16 + 8, kS1 = kCh0 + 8, kS2 = kCh1 + 8, kS3 = kCh2 + 8;
constexpr int kW0 = 0, kW1 = kW0 + kCh0 * kS0, kW2 = kW1 + kCh1 * kS1,
              kW3 = kW2 + kCh2 * kS2, kWEnd = kW3 + kCh3 * kS3;
constexpr int kA0 = 0, kA1 = kA0 + 16 * kS1, kA2 = kA1 + 16 * kS2,
              kAEnd = kA2 + 16 * kS3;          // one group's buffers
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * (kWEnd + kGroups * kAEnd) + sizeof(float) * 2 * kChTotal;

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

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(128) : "memory");
}

// The folded BatchNorm and relu of one pre-activation, as every pass
// computes it (no contraction into an FMA, so that all passes agree
// bitwise).
__device__ __forceinline__ float activate(float h, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(h, sc), sh), 0.f);
}

// The products of one layer for the 16 edges of a slot: A (16 x K) from
// shared memory `a` (row stride SA bf16), B from the transposed weight `w`
// (row stride SW), this warp's NT output tiles of 8 channels from n_base.
template <int K, int NT, int SA, int SW>
__device__ __forceinline__ void mma_layer(const __nv_bfloat16* a,
                                          const __nv_bfloat16* w, int n_base,
                                          float (&acc)[NT][4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(a + g * SA + kk * 16 + 2 * t);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(a + (g + 8) * SA + kk * 16 + 2 * t);
    const uint32_t af[4] = {r0[0], r1[0], r0[4], r1[4]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(
          w + (n_base + nt * 8 + g) * SW + kk * 16 + 2 * t);
      mma_bf16(acc[nt], af, wr[0], wr[4]);
    }
  }
}

// Folded BatchNorm and relu of a layer's tiles, the running max over j (with
// kSlots its first argmax j, four bytes packed a tile) and, when `next` is
// not null, the bf16 activations for the next layer.
template <int NT, bool kSlots>
__device__ __forceinline__ void activate_tiles(const float (&acc)[NT][4],
                                               const float* sc, const float* sh,
                                               int n_base, float (&mx)[NT][4],
                                               uint32_t (&sl)[NT], int j,
                                               __nv_bfloat16* next, int snext,
                                               int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
    float y[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cc = c + (x & 1);
      y[x] = activate(acc[nt][x], sc[cc], sh[cc]);
      if (kSlots) {
        if (y[x] > mx[nt][x]) {
          mx[nt][x] = y[x];
          sl[nt] = (sl[nt] & ~(0xffu << (8 * x))) | (static_cast<uint32_t>(j) << (8 * x));
        }
      } else {
        mx[nt][x] = fmaxf(mx[nt][x], y[x]);
      }
    }
    if (next != nullptr) {
      *reinterpret_cast<uint32_t*>(next + g * snext + c) = pack_bf16(y[0], y[1]);
      *reinterpret_cast<uint32_t*>(next + (g + 8) * snext + c) = pack_bf16(y[2], y[3]);
    }
  }
}

// Sums of h and h^2 of the valid rows into this lane's channels.
template <int NT>
__device__ __forceinline__ void sum_moments(const float (&acc)[NT][4], bool ok0,
                                            bool ok1, float (&s)[NT][2],
                                            float (&ss)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = ok0 ? acc[nt][e] : 0.f, v1 = ok1 ? acc[nt][2 + e] : 0.f;
      s[nt][e] += v0 + v1;
      ss[nt][e] += v0 * v0 + v1 * v1;
    }
  }
}

// A warp's per-lane channel sums, reduced over the 8 rows of lanes that
// share a channel, written by lanes 0-3 to part[0][c] and part[1][c].
template <int NT>
__device__ __forceinline__ void write_sums(float (&s)[NT][2], float (&ss)[NT][2],
                                           float* part, int ch, int n_base,
                                           int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], off);
        ss[nt][e] += __shfl_xor_sync(0xffffffffu, ss[nt][e], off);
      }
      if (lane < 4) {
        const int c = n_base + nt * 8 + 2 * lane + e;
        part[c] = s[nt][e];
        part[ch + c] = ss[nt][e];
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_max(float* out, int ch, int n_base,
                                          const float (&mx)[NT][4], long long p0,
                                          long long points, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
    if (p0 + g < points) {
      *reinterpret_cast<float2*>(out + (p0 + g) * ch + c) = make_float2(mx[nt][0], mx[nt][1]);
    }
    if (p0 + g + 8 < points) {
      *reinterpret_cast<float2*>(out + (p0 + g + 8) * ch + c) =
          make_float2(mx[nt][2], mx[nt][3]);
    }
  }
}

// The packed slots of a layer's tiles into slots (P, 512) at channel offset
// `off`: bytes 0, 1 row g, bytes 2, 3 row g + 8.
template <int NT>
__device__ __forceinline__ void store_slots(uint8_t* slots, int off, int n_base,
                                            const uint32_t (&sl)[NT], long long p0,
                                            long long points, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = off + n_base + nt * 8 + 2 * t;
    if (p0 + g < points) {
      *reinterpret_cast<uint16_t*>(slots + (p0 + g) * kChTotal + c) =
          static_cast<uint16_t>(sl[nt] & 0xffffu);
    }
    if (p0 + g + 8 < points) {
      *reinterpret_cast<uint16_t*>(slots + (p0 + g + 8) * kChTotal + c) =
          static_cast<uint16_t>(sl[nt] >> 16);
    }
  }
}

template <int NT>
__device__ __forceinline__ void reset(float (&mx)[NT][4], uint32_t (&sl)[NT]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mx[nt][0] = mx[nt][1] = mx[nt][2] = mx[nt][3] = 0.f;
    sl[nt] = 0u;
  }
}

__host__ __device__ constexpr int stat_tiles(int layer) { return layer == 3 ? 8 : layer == 2 ? 4 : 2; }
__host__ __device__ constexpr int layer_width(int layer) {
  return layer == 3 ? kCh3 : layer == 2 ? kCh2 : layer == 1 ? kCh1 : kCh0;
}

// kStat = -1: the final pass (the max-pools, with kSlots their argmax slots).
// kStat = l in 0..3: the stat pass of layer l, whose group partials go to
// `partial` ((gridDim.x * kGroups, 2, ch_l) fp32).
template <int kStat, bool kSlots>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_kernel(const __nv_bfloat16* __restrict__ a1,
                const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                const float* __restrict__ scale, const float* __restrict__ shift,
                long long points, int k, float* __restrict__ x0, float* __restrict__ x1,
                float* __restrict__ x2, float* __restrict__ x3,
                uint8_t* __restrict__ slots, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sa_all = sw + kWEnd;
  float* ssc = reinterpret_cast<float*>(sa_all + kGroups * kAEnd);
  float* ssh = ssc + kChTotal;

  // stage the weights transposed, (in, out) -> (out, in); W0's rows 6..15 zero
  for (int i = threadIdx.x; i < kCh0 * 16; i += kThreads) {
    const int n = i / 16, c = i % 16;
    sw[kW0 + n * kS0 + c] = c < kC0 ? w0[c * kCh0 + n] : __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < kCh0 * kCh1; i += kThreads) {
    sw[kW1 + (i % kCh1) * kS1 + i / kCh1] = w1[i];
  }
  for (int i = threadIdx.x; i < kCh1 * kCh2; i += kThreads) {
    sw[kW2 + (i % kCh2) * kS2 + i / kCh2] = w2[i];
  }
  for (int i = threadIdx.x; i < kCh2 * kCh3; i += kThreads) {
    sw[kW3 + (i % kCh3) * kS3 + i / kCh3] = w3[i];
  }
  for (int i = threadIdx.x; i < kChTotal; i += kThreads) {
    ssc[i] = scale[i];
    ssh[i] = shift[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / 4, q = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* sa = sa_all + group * kAEnd;
  const long long tiles = (points + 15) / 16;

  float m0[2][4], m1[2][4], m2[4][4], m3[8][4];
  uint32_t l0[2], l1[2], l2[4], l3[8];
  constexpr int kSNT = stat_tiles(kStat);
  float s[kSNT][2], ss[kSNT][2];
#pragma unroll
  for (int nt = 0; nt < kSNT; ++nt) s[nt][0] = s[nt][1] = ss[nt][0] = ss[nt][1] = 0.f;

  for (long long tile = static_cast<long long>(blockIdx.x) * kGroups + group;
       tile < tiles; tile += static_cast<long long>(gridDim.x) * kGroups) {
    const long long p0 = tile * 16;
    reset(m0, l0);
    reset(m1, l1);
    reset(m2, l2);
    reset(m3, l3);
    const bool ok0 = p0 + g < points, ok1 = p0 + g + 8 < points;
    for (int j = 0; j < k; ++j) {
      // layer 0: the edge [x_j | x_i] of rows g, g + 8 straight from a1
      float acc0[2][4];
      {
        uint32_t af[4] = {0u, 0u, 0u, 0u};
        if (t < kC0 / 2) {
          if (ok0) af[0] = *reinterpret_cast<const uint32_t*>(
              a1 + ((p0 + g) * k + j) * kC0 + 2 * t);
          if (ok1) af[1] = *reinterpret_cast<const uint32_t*>(
              a1 + ((p0 + g + 8) * k + j) * kC0 + 2 * t);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc0[nt][0] = acc0[nt][1] = acc0[nt][2] = acc0[nt][3] = 0.f;
          const uint32_t* wr = reinterpret_cast<const uint32_t*>(
              sw + kW0 + (q * 16 + nt * 8 + g) * kS0 + 2 * t);
          mma_bf16(acc0[nt], af, wr[0], wr[4]);
        }
      }
      if constexpr (kStat == 0) {
        sum_moments(acc0, ok0, ok1, s, ss);
        continue;
      }
      activate_tiles<2, kSlots>(acc0, ssc + kOff0, ssh + kOff0, q * 16, m0, l0, j,
                                sa + kA0, kS1, g, t);
      group_barrier(group);
      float acc1[2][4];
      mma_layer<kCh0, 2, kS1, kS1>(sa + kA0, sw + kW1, q * 16, acc1, g, t);
      if constexpr (kStat == 1) {
        sum_moments(acc1, ok0, ok1, s, ss);
        group_barrier(group);              // layer 0's buffer read before it is refilled
        continue;
      }
      activate_tiles<2, kSlots>(acc1, ssc + kOff1, ssh + kOff1, q * 16, m1, l1, j,
                                sa + kA1, kS2, g, t);
      group_barrier(group);
      float acc2[4][4];
      mma_layer<kCh1, 4, kS2, kS2>(sa + kA1, sw + kW2, q * 32, acc2, g, t);
      if constexpr (kStat == 2) {
        sum_moments(acc2, ok0, ok1, s, ss);
        continue;
      }
      activate_tiles<4, kSlots>(acc2, ssc + kOff2, ssh + kOff2, q * 32, m2, l2, j,
                                sa + kA2, kS3, g, t);
      group_barrier(group);
      float acc3[8][4];
      mma_layer<kCh2, 8, kS3, kS3>(sa + kA2, sw + kW3, q * 64, acc3, g, t);
      if constexpr (kStat == 3) {
        sum_moments(acc3, ok0, ok1, s, ss);
        continue;
      }
      activate_tiles<8, kSlots>(acc3, ssc + kOff3, ssh + kOff3, q * 64, m3, l3, j,
                                nullptr, 0, g, t);
    }
    if constexpr (kStat < 0) {
      store_max(x0, kCh0, q * 16, m0, p0, points, g, t);
      store_max(x1, kCh1, q * 16, m1, p0, points, g, t);
      store_max(x2, kCh2, q * 32, m2, p0, points, g, t);
      store_max(x3, kCh3, q * 64, m3, p0, points, g, t);
      if constexpr (kSlots) {
        store_slots(slots, kOff0, q * 16, l0, p0, points, g, t);
        store_slots(slots, kOff1, q * 16, l1, p0, points, g, t);
        store_slots(slots, kOff2, q * 32, l2, p0, points, g, t);
        store_slots(slots, kOff3, q * 64, l3, p0, points, g, t);
      }
    }
  }
  if constexpr (kStat >= 0) {
    constexpr int ch = layer_width(kStat);
    write_sums(s, ss, partial + (static_cast<long long>(blockIdx.x) * kGroups + group) * 2 * ch,
               ch, q * (ch / 4), lane);
  }
}

// ---- backward ---------------------------------------------------------------

constexpr int kBThreads = 256;                 // one group of 8 warps
// the per-channel parameters, (7, 512) fp32, one row each
constexpr int kPSc = 0, kPSh = 1, kPMu = 2, kPRstd = 3, kPC1 = 4, kPM1 = 5, kPM2 = 6,
              kNP = 7;
// bf16 row strides of the backward's buffers: a_l (the input of layer l;
// a1 padded to 16 channels) and dh_l
constexpr int kBA0 = 16 + 8, kBA1 = kCh0 + 8, kBA2 = kCh1 + 8, kBA3 = kCh2 + 8;
constexpr int kBD0 = kCh0 + 8, kBD1 = kCh1 + 8, kBD2 = kCh2 + 8, kBD3 = kCh3 + 8;
constexpr int kOA0 = 0, kOA1 = kOA0 + 16 * kBA0, kOA2 = kOA1 + 16 * kBA1,
              kOA3 = kOA2 + 16 * kBA2, kOD0 = kOA3 + 16 * kBA3, kOD1 = kOD0 + 16 * kBD0,
              kOD2 = kOD1 + 16 * kBD1, kOD3 = kOD2 + 16 * kBD2, kOEnd = kOD3 + 16 * kBD3;
// the dW that pass `level` sums: dW_{level+1}, (cin, ch) (W0's cin padded to 16)
__host__ __device__ constexpr int dw_rows(int level) {
  return level == 2 ? kCh2 : level == 1 ? kCh1 : level == 0 ? kCh0 : level == -1 ? 16 : 0;
}
__host__ __device__ constexpr int dw_cols(int level) {
  return level == 2 ? kCh3 : level == 1 ? kCh2 : level == 0 ? kCh1 : level == -1 ? kCh0 : 0;
}
__host__ __device__ constexpr size_t bwd_smem(int level) {
  return sizeof(float) * (dw_rows(level) * (dw_cols(level) + 8) + kNP * kChTotal) +
         sizeof(__nv_bfloat16) * kOEnd;
}

// acc[nt] = A (16 x K, shared, row stride sa) . W[n_base + nt * 8 ..]^T, W
// in device memory with each output channel's K inputs contiguous.
template <int K, int NT>
__device__ __forceinline__ void mma_rows(const __nv_bfloat16* a, int sa,
                                         const __nv_bfloat16* __restrict__ w,
                                         int n_base, float (&acc)[NT][4], int g,
                                         int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(a + g * sa + kk * 16 + 2 * t);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(a + (g + 8) * sa + kk * 16 + 2 * t);
    const uint32_t af[4] = {r0[0], r1[0], r0[4], r1[4]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned int* wr = reinterpret_cast<const unsigned int*>(
          w + static_cast<long long>(n_base + nt * 8 + g) * K + kk * 16 + 2 * t);
      mma_bf16(acc[nt], af, __ldg(wr), __ldg(wr + 4));
    }
  }
}

// Folded BatchNorm and relu of this warp's tiles into the next layer's bf16
// buffer.
template <int NT>
__device__ __forceinline__ void activate_rows(const float (&h)[NT][4], const float* sp,
                                              int off, int n_base, __nv_bfloat16* next,
                                              int snext, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
    float y[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cc = off + c + (x & 1);
      y[x] = activate(h[nt][x], sp[kPSc * kChTotal + cc], sp[kPSh * kChTotal + cc]);
    }
    *reinterpret_cast<uint32_t*>(next + g * snext + c) = pack_bf16(y[0], y[1]);
    *reinterpret_cast<uint32_t*>(next + (g + 8) * snext + c) = pack_bf16(y[2], y[3]);
  }
}

// d (the cotangent carried from the layer above, 0 at the top) plus the
// max-pool's cotangent routed to its argmax slot, masked by relu: dy.
template <int NT>
__device__ __forceinline__ void route_relu(const float (&h)[NT][4], float (&d)[NT][4],
                                           const float* __restrict__ gx, int ch,
                                           const uint8_t* __restrict__ slots, int off,
                                           const float* sp, int n_base, long long p0,
                                           int j, bool ok0, bool ok1, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = p0 + g + 8 * half;
      const bool ok = half ? ok1 : ok0;
      const uint32_t sl = ok ? *reinterpret_cast<const uint16_t*>(slots + p * kChTotal + off + c)
                             : 0xffffu;
      const float2 gv = ok ? *reinterpret_cast<const float2*>(gx + p * ch + c)
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 2 * half + e, cc = off + c + e;
        const float route = ((sl >> (8 * e)) & 0xffu) == static_cast<uint32_t>(j)
                                ? (e ? gv.y : gv.x) : 0.f;
        const float y = activate(h[nt][x], sp[kPSc * kChTotal + cc], sp[kPSh * kChTotal + cc]);
        d[nt][x] = y > 0.f ? d[nt][x] + route : 0.f;
      }
    }
  }
}

__device__ __forceinline__ float hhat_of(float h, const float* sp, int cc) {
  return __fmul_rn(__fsub_rn(h, sp[kPMu * kChTotal + cc]), sp[kPRstd * kChTotal + cc]);
}

// S = [sum dy, sum dy hhat] of the valid rows into this lane's channels.
template <int NT>
__device__ __forceinline__ void sum_s(const float (&dy)[NT][4], const float (&h)[NT][4],
                                      const float* sp, int off, int n_base, bool ok0,
                                      bool ok1, int t, float (&s)[NT][2],
                                      float (&sh)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = off + n_base + nt * 8 + 2 * t + e;
      const float v0 = ok0 ? dy[nt][e] : 0.f, v1 = ok1 ? dy[nt][2 + e] : 0.f;
      s[nt][e] += v0 + v1;
      sh[nt][e] += v0 * hhat_of(h[nt][e], sp, cc) + v1 * hhat_of(h[nt][2 + e], sp, cc);
    }
  }
}

// BatchNorm backward with the batch's sums: dh = c1 ((dy - m1) - hhat m2),
// 0 on rows past the end, stored bf16 to this layer's dh buffer.
template <int NT>
__device__ __forceinline__ void bn_backward(const float (&dy)[NT][4], const float (&h)[NT][4],
                                            const float* sp, int off, int n_base,
                                            bool ok0, bool ok1, __nv_bfloat16* sd,
                                            int sds, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
    float dh[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cc = off + c + (x & 1);
      const float v = sp[kPC1 * kChTotal + cc] *
                      ((dy[nt][x] - sp[kPM1 * kChTotal + cc]) -
                       hhat_of(h[nt][x], sp, cc) * sp[kPM2 * kChTotal + cc]);
      dh[x] = (x < 2 ? ok0 : ok1) ? v : 0.f;
    }
    *reinterpret_cast<uint32_t*>(sd + g * sds + c) = pack_bf16(dh[0], dh[1]);
    *reinterpret_cast<uint32_t*>(sd + (g + 8) * sds + c) = pack_bf16(dh[2], dh[3]);
  }
}

// dW (shared, fp32, row stride dws) += a^T dh over the slot's 16 edges:
// rows of dW are a's MT * 16 channels, columns this warp's NT tiles of dh's
// channels from n_base. Each warp owns its columns: no two warps write one
// element.
template <int MT, int NT>
__device__ __forceinline__ void dw_accumulate(const __nv_bfloat16* a, int sa,
                                              const __nv_bfloat16* sd, int sds,
                                              float* dw, int dws, int n_base,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t bfr[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ldsm_x2_trans(bfr[nt], sd + (((lane >> 3) & 1) * 8 + (lane & 7)) * sds + n_base + nt * 8);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t af[4];
    ldsm_x4_trans(af, a + ((lane >> 4) * 8 + (lane & 7)) * sa + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* c0 = dw + (mt * 16 + g) * dws + n_base + nt * 8 + 2 * t;
      float* c1 = c0 + 8 * dws;
      float d[4] = {c0[0], c0[1], c1[0], c1[1]};
      mma_bf16(d, af, bfr[nt][0], bfr[nt][1]);
      c0[0] = d[0];
      c0[1] = d[1];
      c1[0] = d[2];
      c1[1] = d[3];
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
}

__host__ __device__ constexpr int level_tiles(int level) { return level == 3 ? 4 : level == 2 ? 2 : 1; }

// One backward pass. wt_l: W_l^T (out, in) bf16, W0^T padded to (64, 16);
// wp_l: W_l (in, out) bf16, W0 padded to (8, 64). gx_l (P, ch_l) fp32, slots
// (P, 512) uint8 from the final pass. s_part (gridDim.x, 2, ch_level) and
// dw_part (gridDim.x, cin, ch) of dW_{level+1} receive the block's sums;
// da1 (P, k, 6) fp32 at level -1 where not null.
template <int kLevel>
__global__ void __launch_bounds__(kBThreads, 1)
edge_mlp_backward_kernel(
    const __nv_bfloat16* __restrict__ a1, const __nv_bfloat16* __restrict__ wt0,
    const __nv_bfloat16* __restrict__ wt1, const __nv_bfloat16* __restrict__ wt2,
    const __nv_bfloat16* __restrict__ wt3, const __nv_bfloat16* __restrict__ wp0,
    const __nv_bfloat16* __restrict__ wp1, const __nv_bfloat16* __restrict__ wp2,
    const __nv_bfloat16* __restrict__ wp3, const float* __restrict__ params,
    const float* __restrict__ gx0, const float* __restrict__ gx1,
    const float* __restrict__ gx2, const float* __restrict__ gx3,
    const uint8_t* __restrict__ slots, long long points, int k,
    float* __restrict__ s_part, float* __restrict__ dw_part, float* __restrict__ da1) {
  constexpr int kDwRows = dw_rows(kLevel), kDwCols = dw_cols(kLevel);
  constexpr int kDws = kDwCols + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sdw = reinterpret_cast<float*>(smem_raw);
  float* sp = sdw + kDwRows * kDws;
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sp + kNP * kChTotal);
  __nv_bfloat16 *sa0 = sb + kOA0, *sa1 = sb + kOA1, *sa2 = sb + kOA2, *sa3 = sb + kOA3;
  __nv_bfloat16 *sd0 = sb + kOD0, *sd1 = sb + kOD1, *sd2 = sb + kOD2, *sd3 = sb + kOD3;
  for (int i = threadIdx.x; i < kDwRows * kDws; i += kBThreads) sdw[i] = 0.f;
  for (int i = threadIdx.x; i < kNP * kChTotal; i += kBThreads) sp[i] = params[i];
  for (int i = threadIdx.x; i < 16 * kBA0; i += kBThreads) sa0[i] = __float2bfloat16(0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nb0 = warp * (kCh0 / 8), nb1 = warp * (kCh1 / 8), nb2 = warp * (kCh2 / 8),
            nb3 = warp * (kCh3 / 8);
  constexpr int kSNT = level_tiles(kLevel);
  float s_dy[kSNT][2], s_dyh[kSNT][2];
#pragma unroll
  for (int nt = 0; nt < kSNT; ++nt) s_dy[nt][0] = s_dy[nt][1] = s_dyh[nt][0] = s_dyh[nt][1] = 0.f;
  const long long tiles = (points + 15) / 16;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * 16;
    const bool ok0 = p0 + g < points, ok1 = p0 + g + 8 < points;
    for (int j = 0; j < k; ++j) {
      // the slot's 16 edges, channels 6..15 zero
      if (threadIdx.x < 16 * (kC0 / 2)) {
        const int r = threadIdx.x / (kC0 / 2), c = (threadIdx.x % (kC0 / 2)) * 2;
        uint32_t v = 0u;
        if (p0 + r < points) {
          v = *reinterpret_cast<const uint32_t*>(a1 + ((p0 + r) * k + j) * kC0 + c);
        }
        *reinterpret_cast<uint32_t*>(sa0 + r * kBA0 + c) = v;
      }
      __syncthreads();
      // the forward chain, as the final pass computes it
      float h0[1][4], h1[1][4], h2[2][4], h3[4][4];
      mma_rows<16, 1>(sa0, kBA0, wt0, nb0, h0, g, t);
      activate_rows(h0, sp, kOff0, nb0, sa1, kBA1, g, t);
      __syncthreads();
      mma_rows<kCh0, 1>(sa1, kBA1, wt1, nb1, h1, g, t);
      activate_rows(h1, sp, kOff1, nb1, sa2, kBA2, g, t);
      __syncthreads();
      mma_rows<kCh1, 2>(sa2, kBA2, wt2, nb2, h2, g, t);
      activate_rows(h2, sp, kOff2, nb2, sa3, kBA3, g, t);
      __syncthreads();
      mma_rows<kCh2, 4>(sa3, kBA3, wt3, nb3, h3, g, t);

      // top-down to `level`
      float d3[4][4];
      zero(d3);
      route_relu(h3, d3, gx3, kCh3, slots, kOff3, sp, nb3, p0, j, ok0, ok1, g, t);
      if constexpr (kLevel == 3) {
        sum_s(d3, h3, sp, kOff3, nb3, ok0, ok1, t, s_dy, s_dyh);
      } else {
        bn_backward(d3, h3, sp, kOff3, nb3, ok0, ok1, sd3, kBD3, g, t);
        __syncthreads();
        if constexpr (kLevel == 2) {
          dw_accumulate<kCh2 / 16, 4>(sa3, kBA3, sd3, kBD3, sdw, kDws, nb3, lane);
        }
        float d2[2][4];
        mma_rows<kCh3, 2>(sd3, kBD3, wp3, nb2, d2, g, t);
        route_relu(h2, d2, gx2, kCh2, slots, kOff2, sp, nb2, p0, j, ok0, ok1, g, t);
        if constexpr (kLevel == 2) {
          sum_s(d2, h2, sp, kOff2, nb2, ok0, ok1, t, s_dy, s_dyh);
        } else {
          bn_backward(d2, h2, sp, kOff2, nb2, ok0, ok1, sd2, kBD2, g, t);
          __syncthreads();
          if constexpr (kLevel == 1) {
            dw_accumulate<kCh1 / 16, 2>(sa2, kBA2, sd2, kBD2, sdw, kDws, nb2, lane);
          }
          float d1[1][4];
          mma_rows<kCh2, 1>(sd2, kBD2, wp2, nb1, d1, g, t);
          route_relu(h1, d1, gx1, kCh1, slots, kOff1, sp, nb1, p0, j, ok0, ok1, g, t);
          if constexpr (kLevel == 1) {
            sum_s(d1, h1, sp, kOff1, nb1, ok0, ok1, t, s_dy, s_dyh);
          } else {
            bn_backward(d1, h1, sp, kOff1, nb1, ok0, ok1, sd1, kBD1, g, t);
            __syncthreads();
            if constexpr (kLevel == 0) {
              dw_accumulate<kCh0 / 16, 1>(sa1, kBA1, sd1, kBD1, sdw, kDws, nb1, lane);
            }
            float d0[1][4];
            mma_rows<kCh1, 1>(sd1, kBD1, wp1, nb0, d0, g, t);
            route_relu(h0, d0, gx0, kCh0, slots, kOff0, sp, nb0, p0, j, ok0, ok1, g, t);
            if constexpr (kLevel == 0) {
              sum_s(d0, h0, sp, kOff0, nb0, ok0, ok1, t, s_dy, s_dyh);
            } else {
              bn_backward(d0, h0, sp, kOff0, nb0, ok0, ok1, sd0, kBD0, g, t);
              __syncthreads();
              dw_accumulate<1, 1>(sa0, kBA0, sd0, kBD0, sdw, kDws, nb0, lane);
              if (da1 != nullptr && warp == 0) {
                float e[1][4];
                mma_rows<kCh0, 1>(sd0, kBD0, wp0, 0, e, g, t);
                if (t < kC0 / 2) {
                  if (ok0) {
                    *reinterpret_cast<float2*>(da1 + ((p0 + g) * k + j) * kC0 + 2 * t) =
                        make_float2(e[0][0], e[0][1]);
                  }
                  if (ok1) {
                    *reinterpret_cast<float2*>(da1 + ((p0 + g + 8) * k + j) * kC0 + 2 * t) =
                        make_float2(e[0][2], e[0][3]);
                  }
                }
              }
            }
          }
        }
      }
      __syncthreads();                     // the slot's buffers read before they are refilled
    }
  }
  if constexpr (kLevel >= 0) {
    constexpr int ch = layer_width(kLevel);
    write_sums(s_dy, s_dyh, s_part + static_cast<long long>(blockIdx.x) * 2 * ch, ch,
               warp * (ch / 8), lane);
  }
  if constexpr (kLevel <= 2) {
    __syncthreads();
    float* out = dw_part + static_cast<long long>(blockIdx.x) * kDwRows * kDwCols;
    for (int i = threadIdx.x; i < kDwRows * kDwCols; i += kBThreads) {
      out[i] = sdw[(i / kDwCols) * kDws + i % kDwCols];
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

template <int kStat, bool kSlots>
int launch_forward(const void* a1, const void* w0, const void* w1, const void* w2,
                   const void* w3, const float* scale, const float* shift,
                   long long points, int k, float* x0, float* x1, float* x2, float* x3,
                   uint8_t* slots, float* partial, long long cap, void* stream) {
  auto kernel = edge_mlp_kernel<kStat, kSlots>;
  const long long tiles = (points + 15) / 16;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, kThreads, kSmemBytes,
                                    (tiles + kGroups - 1) / kGroups, cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(a1), static_cast<const bf*>(w0), static_cast<const bf*>(w1),
      static_cast<const bf*>(w2), static_cast<const bf*>(w3), scale, shift, points, k,
      x0, x1, x2, x3, slots, partial);
  return static_cast<int>(cudaGetLastError());
}

template <int kLevel>
int launch_backward(const void* a1, const void* const* wt, const void* const* wp,
                    const float* params, const float* const* gx, const uint8_t* slots,
                    long long points, int k, long long cap, float* s_part,
                    float* dw_part, float* da1, void* stream) {
  auto kernel = edge_mlp_backward_kernel<kLevel>;
  const size_t smem = bwd_smem(kLevel);
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, kBThreads, smem, (points + 15) / 16, cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(a1), static_cast<const bf*>(wt[0]),
      static_cast<const bf*>(wt[1]), static_cast<const bf*>(wt[2]),
      static_cast<const bf*>(wt[3]), static_cast<const bf*>(wp[0]),
      static_cast<const bf*>(wp[1]), static_cast<const bf*>(wp[2]),
      static_cast<const bf*>(wp[3]), params, gx[0], gx[1], gx[2], gx[3], slots, points,
      k, s_part, dw_part, da1);
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
    return launch_forward<-1, true>(a1, w0, w1, w2, w3, scale, shift, points, k, x0, x1,
                                    x2, x3, slots, nullptr, 0, stream);
  }
  return launch_forward<-1, false>(a1, w0, w1, w2, w3, scale, shift, points, k, x0, x1,
                                   x2, x3, nullptr, nullptr, 0, stream);
}

// The stat pass of `layer` (0..3): inputs as edge_mlp_forward, with scale
// and shift read for the layers below `layer` only -> partial
// (max_blocks * 2, 2, ch_layer) fp32, one row pair a group, rows past the
// launched groups untouched (the caller zeroes them).
int edge_mlp_stat(const void* a1, const void* w0, const void* w1, const void* w2,
                  const void* w3, const float* scale, const float* shift,
                  long long points, int k, int layer, int max_blocks, float* partial,
                  void* stream) {
  if (points < 1 || k < 1 || k > 255 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (layer) {
    case 0:
      return launch_forward<0, false>(a1, w0, w1, w2, w3, scale, shift, points, k, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, partial,
                                      max_blocks, stream);
    case 1:
      return launch_forward<1, false>(a1, w0, w1, w2, w3, scale, shift, points, k, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, partial,
                                      max_blocks, stream);
    case 2:
      return launch_forward<2, false>(a1, w0, w1, w2, w3, scale, shift, points, k, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, partial,
                                      max_blocks, stream);
    case 3:
      return launch_forward<3, false>(a1, w0, w1, w2, w3, scale, shift, points, k, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, partial,
                                      max_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward pass `level` (3, 2, 1, 0, -1): a1 as above; wt0..wt3 the weights
// transposed, (out, in) bf16 with W0^T padded to (64, 16); wp0..wp3 the
// weights (in, out) bf16 with W0 padded to (8, 64); params (7, 512) fp32:
// the folded scale and shift, mu, rsqrt(var + eps), gamma rsqrt(var + eps),
// and S[0] / E, S[1] / E of the layers above `level` (E = P k); gx0..gx3 the
// max-pools' cotangents (P, ch_l) fp32 and slots (P, 512) uint8 ->
// s_part (max_blocks, 2, ch_level) for level >= 0, dw_part (max_blocks, cin,
// ch) of dW_{level+1} (cin 16 for W0) for level <= 2, da1 (P, k, 6) fp32 at
// level -1 where not null. Rows past the launched blocks are untouched.
int edge_mlp_backward(const void* a1, const void* wt0, const void* wt1,
                      const void* wt2, const void* wt3, const void* wp0,
                      const void* wp1, const void* wp2, const void* wp3,
                      const float* params, const float* gx0, const float* gx1,
                      const float* gx2, const float* gx3, const uint8_t* slots,
                      long long points, int k, int level, int max_blocks,
                      float* s_part, float* dw_part, float* da1, void* stream) {
  if (points < 1 || k < 1 || k > 255 || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* wt[4] = {wt0, wt1, wt2, wt3};
  const void* wp[4] = {wp0, wp1, wp2, wp3};
  const float* gx[4] = {gx0, gx1, gx2, gx3};
  switch (level) {
    case 3:
      return launch_backward<3>(a1, wt, wp, params, gx, slots, points, k, max_blocks,
                                s_part, dw_part, da1, stream);
    case 2:
      return launch_backward<2>(a1, wt, wp, params, gx, slots, points, k, max_blocks,
                                s_part, dw_part, da1, stream);
    case 1:
      return launch_backward<1>(a1, wt, wp, params, gx, slots, points, k, max_blocks,
                                s_part, dw_part, da1, stream);
    case 0:
      return launch_backward<0>(a1, wt, wp, params, gx, slots, points, k, max_blocks,
                                s_part, dw_part, da1, stream);
    case -1:
      return launch_backward<-1>(a1, wt, wp, params, gx, slots, points, k, max_blocks,
                                 s_part, dw_part, da1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
