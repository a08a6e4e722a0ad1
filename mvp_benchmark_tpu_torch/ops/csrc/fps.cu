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
// one cloud, and the clouds run side by side.
//
// What bounds it on an H100: the serial chain of S steps, not bytes or
// operations. At (32, 3072 -> 2048) the bytes are 393 KB in and 262 KB out
// (0.0002 ms at 3.35 TB/s) and the operations 32 x 2047 x 3072 x 10 = 2.0
// GFLOP (0.03 ms at 67 TFLOP/s). A step is one dependent round: update every
// point against the last selected one, find the cloud's maximum, broadcast
// it. Its time is the issue of the update (about 12 instructions a point on
// one SM: ~290 cycles at N = 3072) plus the latency of the round. The
// design shortens both:
//
// - Each thread holds its PER points' coordinates in registers beside their
//   running minimum (points tid + p * threads, so ascending in p), instead
//   of re-reading them from shared memory.
// - The selected point's coordinates come from a float4-padded copy of the
//   cloud in shared memory: one 16-byte broadcast load a step (from global
//   memory, through L1, where the cloud is too large to stage).
// - The maximum is two `redux.sync` a level: distances are >= 0, so their
//   bits order as unsigned integers; a warp takes the max of the bits, then
//   the min index among the lanes that hold it. Lane 0 writes the warp's
//   pair to one of two slots (alternating by step parity), one barrier, and
//   every warp reduces all the pairs itself, so every thread knows the next
//   point after a single barrier.
// - Each thread reduces its own points as a pairwise tree from 8 points a
//   thread up (a shorter dependent chain), else as a chain in p.
// - Threads a cloud and PER come from the launch plan (ops/kernels.py
//   `fps_plan`, from probe_knn_fps.py's readings): fewer warps make a
//   cheaper barrier, more points a thread a longer update.
//
// One block a cloud: a cluster of two blocks, splitting the points and
// sharing each step's pairs through distributed shared memory behind the
// cluster barrier, read 1.6-2.9x slower at every path shape on the card
// (PERF.md), the cluster barrier costing more than the half of the update
// it saves.
//
// Rounding: ((dx*dx + dy*dy) + dz*dz) with each operation rounded on its own
// (no FMA contraction), as ref.furthest_point_sample computes it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // index of an empty slot
// Clouds up to this many points are staged as float4 in shared memory
// (192 KB); larger ones are read through L1.
constexpr int kMaxStaged = 12288;

// Registers bound the threads a block can have with PER points a thread
// (4 floats a point): 64 registers a thread at 1024 threads, 128 at 512
// (PER = 32, only for N > 8192, spills a few).
__host__ __device__ constexpr int max_threads(int per) {
  return per <= 8 ? 1024 : 512;
}

// The (max bits, lowest index among them) of the warp's pairs.
__device__ __forceinline__ uint2 argmax_warp(unsigned v, unsigned i) {
  const unsigned m = __reduce_max_sync(kFull, v);
  return make_uint2(m, __reduce_min_sync(kFull, v == m ? i : kNone));
}

template <int PER>
__global__ void __launch_bounds__(max_threads(PER))
fps_kernel(const float* __restrict__ xyz, int n, int s, int* __restrict__ out) {
  extern __shared__ float4 s4[];  // n points, or none when n > kMaxStaged
  __shared__ uint2 slot[2][32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* x = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * s;
  const bool staged = n <= kMaxStaged;

  if (staged) {
    for (int t = tid; t < n; t += nthreads) {
      s4[t] = make_float4(__ldg(x + 3 * t), __ldg(x + 3 * t + 1),
                          __ldg(x + 3 * t + 2), 0.f);
    }
  }
  float px[PER], py[PER], pz[PER], md[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = tid + p * nthreads;
    const bool on = i < n;
    px[p] = on ? __ldg(x + 3 * i) : 0.f;
    py[p] = on ? __ldg(x + 3 * i + 1) : 0.f;
    pz[p] = on ? __ldg(x + 3 * i + 2) : 0.f;
    md[p] = on ? 1e10f : -1.f;  // -1: below every distance, never selected
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int step = 1; step < s; ++step) {
    float lx, ly, lz;
    if (staged) {
      const float4 l = s4[last];
      lx = l.x;
      ly = l.y;
      lz = l.z;
    } else {
      lx = __ldg(x + 3 * last);
      ly = __ldg(x + 3 * last + 1);
      lz = __ldg(x + 3 * last + 2);
    }
    float bv[PER];
    int bp[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const float dx = __fsub_rn(px[p], lx);
      const float dy = __fsub_rn(py[p], ly);
      const float dz = __fsub_rn(pz[p], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      md[p] = fminf(md[p], d);
      bv[p] = md[p];
      bp[p] = p;
    }
    // The thread's (max, lowest p among equal maxima): a pairwise tree for
    // 8 points or more (a shorter dependent chain), else a chain in p; a
    // later p wins only if strictly larger.
    if constexpr (PER >= 8) {
#pragma unroll
      for (int st = 1; st < PER; st *= 2) {
#pragma unroll
        for (int a = 0; a + st < PER; a += 2 * st) {
          if (bv[a + st] > bv[a]) {
            bv[a] = bv[a + st];
            bp[a] = bp[a + st];
          }
        }
      }
    } else {
#pragma unroll
      for (int p = 1; p < PER; ++p) {
        if (bv[p] > bv[0]) {
          bv[0] = bv[p];
          bp[0] = p;
        }
      }
    }
    const bool any = bv[0] >= 0.f;  // a thread with no point offers (0, none)
    const uint2 w = argmax_warp(
        any ? __float_as_uint(bv[0]) : 0u,
        any ? static_cast<unsigned>(tid + bp[0] * nthreads) : kNone);
    const int buf = step & 1;
    if (lane == 0) slot[buf][warp] = w;
    __syncthreads();
    const uint2 e = lane < nwarps ? slot[buf][lane] : make_uint2(0u, kNone);
    last = static_cast<int>(argmax_warp(e.x, e.y).y);
    if (tid == 0) o[step] = last;
  }
}

template <int PER>
cudaError_t launch(const float* xyz, int batch, int n, int s, int threads,
                   int* out, cudaStream_t stream) {
  if (threads > max_threads(PER)) return cudaErrorInvalidValue;
  const size_t smem =
      n <= kMaxStaged ? static_cast<size_t>(n) * sizeof(float4) : 0;
  if (smem > 32 * 1024) {  // the opt-in also covers the static slots
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PER><<<batch, threads, smem, stream>>>(xyz, n, s, out);
  return cudaGetLastError();
}

cudaError_t launch_per(const float* xyz, int batch, int n, int s, int threads,
                       int per, int* out, cudaStream_t st) {
  switch (per) {
    case 1: return launch<1>(xyz, batch, n, s, threads, out, st);
    case 2: return launch<2>(xyz, batch, n, s, threads, out, st);
    case 3: return launch<3>(xyz, batch, n, s, threads, out, st);
    case 4: return launch<4>(xyz, batch, n, s, threads, out, st);
    case 6: return launch<6>(xyz, batch, n, s, threads, out, st);
    case 8: return launch<8>(xyz, batch, n, s, threads, out, st);
    case 12: return launch<12>(xyz, batch, n, s, threads, out, st);
    case 16: return launch<16>(xyz, batch, n, s, threads, out, st);
    case 24: return launch<24>(xyz, batch, n, s, threads, out, st);
    case 32: return launch<32>(xyz, batch, n, s, threads, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// xyz (B, N, 3) float32 contiguous on the device, 1 <= N <= 16384; out
// (B, S) int32, S >= 1. The launch plan (ops/kernels.py `fps_plan`):
// `threads` a block (a multiple of 32, at most the PER's register bound),
// `per` points a thread (1, 2, 3, 4, 6, 8, 12, 16, 24 or 32),
// threads * per >= N. Launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 on success).
int fps_forward(const float* xyz, int batch, int n, int s, int threads,
                int per, int* out, void* stream) {
  if (n < 1 || n > 16384 || s < 1 || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads || static_cast<long long>(threads) * per < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_per(xyz, batch, n, s, threads, per, out, st));
}

}  // extern "C"
