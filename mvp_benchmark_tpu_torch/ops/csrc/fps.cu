// Furthest point sampling for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the TPU kernel `furthest_point_sample` / `_fps_kernel`
// (mvp_benchmark_tpu/ops/pallas_kernels.py:498 and :461):
//
//   out[b, 0] = 0; out[b, s] = argmax_i min_{t < s} |x_i - x_out[b, t]|^2,
//
// with a running min-distance buffer initialised to 1e10, and the argmax
// taking the LOWEST index among equal maxima (jnp.argmax, torch.argmax and
// ops/ref.py), so indices equal the plain version's exactly.
//
// The TPU kernel advances the whole batch one step per loop iteration as
// (B, N) vector ops, because a TPU grid runs in order. Here one block owns
// one cloud and the B blocks run side by side. The cloud (12 B a point) sits
// in shared memory, the min-distance buffer in registers (PER points a
// thread, templated). Each step: every thread updates its points against
// the last selected one and keeps its best (value, index); a warp reduces
// (value, -index) pairs with xor shuffles; lane 0 of each warp writes its
// pair to one of two shared slots (alternating by step parity); after one
// barrier every warp reduces the per-warp pairs itself, so all threads know
// the next point without a second barrier. The comparison is "larger value,
// or equal value and smaller index" at every level.
//
// Rounding: ((dx*dx + dy*dy) + dz*dz) with each operation rounded on its own
// (no FMA contraction), as ref.furthest_point_sample computes it.
//
// What bounds it on an H100: the serial chain of S steps, each a dependent
// update, warp reduction, barrier and second warp reduction (a few
// microseconds of latency), not bytes or operations. At (32, 3072 -> 2048)
// the bytes are 393 KB in and 262 KB out (0.0002 ms at 3.35 TB/s) and the
// operations 32 x 2047 x 3072 x 9 = 1.8 GFLOP (0.03 ms at 67 TFLOP/s). Only
// B of 132 SMs are busy. A later PR would shorten each step (one warp per
// cloud for small N, a cluster of blocks sharing the argmax through
// distributed shared memory for large N) or run several clouds per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void argmax_warp(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int n, int s,
           int* __restrict__ out) {
  extern __shared__ float sxyz[];  // 3 * n
  __shared__ float wval[2][32];
  __shared__ int widx[2][32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* x = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * s;

  for (int t = tid; t < 3 * n; t += nthreads) sxyz[t] = x[t];
  float md[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) md[p] = 1e10f;
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int step = 1; step < s; ++step) {
    const float lx = sxyz[3 * last];
    const float ly = sxyz[3 * last + 1];
    const float lz = sxyz[3 * last + 2];
    float best = -1.f;  // below every distance
    int best_i = 0x7fffffff;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = tid + p * nthreads;  // ascending in p
      if (i < n) {
        const float dx = __fsub_rn(sxyz[3 * i], lx);
        const float dy = __fsub_rn(sxyz[3 * i + 1], ly);
        const float dz = __fsub_rn(sxyz[3 * i + 2], lz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float m = fminf(md[p], d);
        md[p] = m;
        if (m > best) {
          best = m;
          best_i = i;
        }
      }
    }
    argmax_warp(best, best_i);
    const int buf = step & 1;
    if (lane == 0) {
      wval[buf][warp] = best;
      widx[buf][warp] = best_i;
    }
    __syncthreads();
    best = lane < nwarps ? wval[buf][lane] : -2.f;
    best_i = lane < nwarps ? widx[buf][lane] : 0x7fffffff;
    argmax_warp(best, best_i);
    last = best_i;
    if (tid == 0) o[step] = last;
  }
}

template <int PER>
cudaError_t launch(const float* xyz, int batch, int n, int s, int threads,
                   int* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PER><<<batch, threads, smem, stream>>>(xyz, n, s, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32 contiguous on the device, 1 <= N <= 16384; out
// (B, S) int32, S >= 1. Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 on success).
int fps_forward(const float* xyz, int batch, int n, int s, int* out,
                void* stream) {
  if (n < 1 || n > 16 * kMaxThreads || s < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  const int per = (n + threads - 1) / threads;
  cudaError_t err;
  if (per <= 1) {
    err = launch<1>(xyz, batch, n, s, threads, out, st);
  } else if (per <= 2) {
    err = launch<2>(xyz, batch, n, s, threads, out, st);
  } else if (per <= 4) {
    err = launch<4>(xyz, batch, n, s, threads, out, st);
  } else if (per <= 8) {
    err = launch<8>(xyz, batch, n, s, threads, out, st);
  } else {
    err = launch<16>(xyz, batch, n, s, threads, out, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
