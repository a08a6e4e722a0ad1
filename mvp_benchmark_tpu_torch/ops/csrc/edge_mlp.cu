// DGCNN's fused per-edge chain, eval pass, for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel `_edge_mlp_final_pass` (mvp_benchmark_tpu/ops/
// pallas_kernels.py:3025, body `_em_final_kernel` :2828), which `edge_mlp_eval`
// :3155 runs with the running statistics and `_edge_mlp_forward` :3086 runs
// after its stat passes. Per edge (point p, neighbour j) of a1 (P, k, 6):
//
//   a_0 = a1[p, j];  for l = 0..3:
//     h_l = bf16(a_l) . bf16(W_l)           fp32 accumulation
//     a_{l+1} = relu(h_l * scale_l + shift_l)
//     x_l[p] = max_j a_{l+1}                 (P, ch_l) fp32
//
// with chs 64/64/128/256 and the BatchNorm folded to a per-channel scale and
// shift that the wrapper computes once per call (ops/ref.py
// `bn_scale_shift`), the semantics of ops/ref.py `edge_mlp_eval`. Only the
// four max-pools reach device memory; the (P, k, ch) activations never do.
// The products are summed in another order than the plain version's
// matmuls, and an activation that lands on the other side of a bf16 rounding
// carries that into the next layer, so the two agree to a tolerance. Taking
// scale and shift as arguments makes this the final pass of the train-mode
// chain too, after passes that compute the batch statistics.
//
// Design: tensor cores through mma.sync.m16n8k16 (bf16 operands, fp32
// accumulation). A group of 4 warps runs 16 points, one neighbour slot j at
// a time: the 16 edges (p, j) form the 16 rows of every product. Warp q of
// the group computes a quarter of each layer's output channels, keeps the
// running max over j of exactly those channels in registers (64 floats a
// lane), and writes its bf16 activations to the group's buffer in shared
// memory, from which all 4 warps read the next layer's A fragments; a named
// barrier per group orders the layers. A block holds two groups (256 threads)
// and the four weights, transposed to (out, in) and padded by 8 bf16 a row
// so that the B-fragment loads hit 32 distinct banks (W0's 6 input rows are
// zero-padded to 16, one k-step). Blocks are persistent: one per SM that fits,
// each group walking tiles of 16 points with a grid stride, so the weights
// (100 KB) are staged once per block. Points past the end read zero edges
// and write nothing.
//
// What bounds it on an H100: operations. DCP's call is 32 x 2048 points x 20
// neighbours = 1.31 M edges of 2 (6*64 + 64*64 + 64*128 + 128*256) = 90.9 k
// flops, 119 GFLOP: 0.12 ms at the 989 TFLOP/s bf16 dense peak, 1.8 ms at the
// 67 TFLOP/s fp32 peak; a1 (15.7 MB) and the outputs (134 MB) take 0.045 ms.
// mma.sync from registers, three barriers per slot and 8 warps an SM leave
// this well short of the tensor-core peak; wgmma over larger edge tiles is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC0 = 6;                         // a1 channels: [x_j | x_i]
constexpr int kCh0 = 64, kCh1 = 64, kCh2 = 128, kCh3 = 256;
constexpr int kChTotal = kCh0 + kCh1 + kCh2 + kCh3;
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

__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(128) : "memory");
}

// One layer for the 16 edges of a slot: A (16 x K) from the group's buffer
// `a` (row stride SA bf16), B from the transposed weight `w` (row stride SW),
// this warp's NT output tiles of 8 channels from channel n_base. Folded
// BatchNorm and relu, the running max, and (when `next` is not null) the
// bf16 activations for the next layer.
template <int K, int NT, int SA, int SW>
__device__ __forceinline__ void layer(const __nv_bfloat16* a,
                                      const __nv_bfloat16* w, int n_base,
                                      const float* sc, const float* sh,
                                      float (&mx)[NT][4], __nv_bfloat16* next,
                                      int snext, int g, int t) {
  float acc[NT][4];
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
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n_base + nt * 8 + 2 * t;
    float y[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int cc = c + (x & 1);
      y[x] = fmaxf(__fadd_rn(__fmul_rn(acc[nt][x], sc[cc]), sh[cc]), 0.f);
      mx[nt][x] = fmaxf(mx[nt][x], y[x]);
    }
    if (next != nullptr) {
      *reinterpret_cast<uint32_t*>(next + g * snext + c) = pack_bf16(y[0], y[1]);
      *reinterpret_cast<uint32_t*>(next + (g + 8) * snext + c) = pack_bf16(y[2], y[3]);
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

template <int NT>
__device__ __forceinline__ void reset(float (&mx)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mx[nt][0] = mx[nt][1] = mx[nt][2] = mx[nt][3] = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_kernel(const __nv_bfloat16* __restrict__ a1,
                const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                const float* __restrict__ scale, const float* __restrict__ shift,
                long long points, int k, float* __restrict__ x0, float* __restrict__ x1,
                float* __restrict__ x2, float* __restrict__ x3) {
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
  for (long long tile = static_cast<long long>(blockIdx.x) * kGroups + group;
       tile < tiles; tile += static_cast<long long>(gridDim.x) * kGroups) {
    const long long p0 = tile * 16;
    reset(m0);
    reset(m1);
    reset(m2);
    reset(m3);
    const bool ok0 = p0 + g < points, ok1 = p0 + g + 8 < points;
    for (int j = 0; j < k; ++j) {
      // layer 0: the edge [x_j | x_i] of rows g, g + 8 straight from a1
      {
        uint32_t af[4] = {0u, 0u, 0u, 0u};
        if (t < kC0 / 2) {
          if (ok0) af[0] = *reinterpret_cast<const uint32_t*>(
              a1 + ((p0 + g) * k + j) * kC0 + 2 * t);
          if (ok1) af[1] = *reinterpret_cast<const uint32_t*>(
              a1 + ((p0 + g + 8) * k + j) * kC0 + 2 * t);
        }
        float acc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
          const uint32_t* wr = reinterpret_cast<const uint32_t*>(
              sw + kW0 + (q * 16 + nt * 8 + g) * kS0 + 2 * t);
          mma_bf16(acc[nt], af, wr[0], wr[4]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = q * 16 + nt * 8 + 2 * t;
          float y[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int cc = c + (x & 1);
            y[x] = fmaxf(__fadd_rn(__fmul_rn(acc[nt][x], ssc[cc]), ssh[cc]), 0.f);
            m0[nt][x] = fmaxf(m0[nt][x], y[x]);
          }
          *reinterpret_cast<uint32_t*>(sa + kA0 + g * kS1 + c) = pack_bf16(y[0], y[1]);
          *reinterpret_cast<uint32_t*>(sa + kA0 + (g + 8) * kS1 + c) = pack_bf16(y[2], y[3]);
        }
      }
      group_barrier(group);
      layer<kCh0, 2, kS1, kS1>(sa + kA0, sw + kW1, q * 16, ssc + kCh0, ssh + kCh0,
                               m1, sa + kA1, kS2, g, t);
      group_barrier(group);
      layer<kCh1, 4, kS2, kS2>(sa + kA1, sw + kW2, q * 32, ssc + kCh0 + kCh1,
                               ssh + kCh0 + kCh1, m2, sa + kA2, kS3, g, t);
      group_barrier(group);
      layer<kCh2, 8, kS3, kS3>(sa + kA2, sw + kW3, q * 64,
                               ssc + kCh0 + kCh1 + kCh2, ssh + kCh0 + kCh1 + kCh2,
                               m3, nullptr, 0, g, t);
    }
    store_max(x0, kCh0, q * 16, m0, p0, points, g, t);
    store_max(x1, kCh1, q * 16, m1, p0, points, g, t);
    store_max(x2, kCh2, q * 32, m2, p0, points, g, t);
    store_max(x3, kCh3, q * 64, m3, p0, points, g, t);
  }
}

}  // namespace

extern "C" {

// a1 (P, k, 6) bf16 (P = B * N points, k >= 1 neighbours), W0 (6, 64), W1
// (64, 64), W2 (64, 128), W3 (128, 256) bf16 in the flax (in, out)
// orientation, scale and shift (512,) fp32 (the four layers' channels in
// order), all contiguous on the device -> x0 (P, 64), x1 (P, 64), x2
// (P, 128), x3 (P, 256) fp32. Launches on `stream` without synchronising;
// returns cudaGetLastError(), or cudaErrorInvalidValue for P < 1 or k < 1.
int edge_mlp_forward(const void* a1, const void* w0, const void* w1,
                     const void* w2, const void* w3, const float* scale,
                     const float* shift, long long points, int k, float* x0,
                     float* x1, float* x2, float* x3, void* stream) {
  if (points < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_mlp_kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (points + 15) / 16;
  long long grid = static_cast<long long>(per_sm) * sms;   // every block resident
  const long long need = (tiles + kGroups - 1) / kGroups;
  if (grid > need) grid = need;
  if (grid < 1) grid = 1;
  edge_mlp_kernel<<<static_cast<int>(grid), kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(w3), scale, shift, points, k, x0, x1, x2, x3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
