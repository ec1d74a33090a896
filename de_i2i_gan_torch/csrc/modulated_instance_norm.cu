// Fused instance norm + per-(n, c) style modulation + optional activation,
// forward only, for NCHW-contiguous x (one (n, c) plane = one row of H*W):
//
//   mean  = E[x],  var = max(E[x^2] - mean^2, 0),  inv = rsqrt(var + eps)
//   scale = inv * (1 + gamma[n, c]),  shift = beta[n, c] - mean * scale
//   y     = act(x * scale + shift),   act in {none, relu, leaky_relu(0.2)}
//
// Replaces the TPU kernel de_i2i_gan_tpu/ops/pallas/norm_kernels.py::_fwd_kernel
// and computes what it computes: single-pass f32 moments, the same scale and
// shift, y in the IO dtype (float or bfloat16), and mean and inv as f32 (N, C)
// residuals for the backward kernel.
//
// What bounds it: memory traffic. It does about 4 flops per element against
// 4 bytes (bf16) or 8 bytes (f32) of one read of x and one write of y, far
// below the card's ~20 flops per byte of f32 CUDA-core work. The design keeps
// device-memory traffic near that one read and one write:
//   * one block per (n, c) row, so the statistics never leave the block;
//   * pass 1 streams the row in 16-byte vectors (8 bf16 or 4 floats per
//     load, neighbouring threads on neighbouring addresses), accumulates sum
//     and sum of squares in f32 registers, then reduces with warp shuffles
//     and one shared-memory exchange;
//   * pass 2 re-reads the row and writes y. The re-read is meant to hit the
//     50 MB L2, which holds while the rows in flight fit there (8 KB rows at
//     64x64). At 256x256 a row is 128 KB in bf16 and every row of a batch-8
//     call is resident at once (8 blocks of 256 threads per SM), so much of
//     the re-read goes back to device memory: PERF.md has the measured cost.
// Rows whose length or address does not allow 16-byte vectors take a scalar
// loop; any H*W and C work. No shared-memory staging, TMA or clusters: this
// is the simple version.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 0: none, 1: relu, 2: leaky_relu(0.2). NaN passes through, as jnp.maximum
// and jnp.where do.
template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 1) return y < 0.f ? 0.f : y;
  if (ACT == 2) return y < 0.f ? 0.2f * y : y;
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = warp_sum(lane < kWarps ? sa[lane] : 0.f);
  b = warp_sum(lane < kWarps ? sb[lane] : 0.f);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   T* __restrict__ y,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ inv_out,
                                   int64_t hw, float eps, bool vec) {
  constexpr int V = Vec<T>::N;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * hw;
  T* yr = y + row * hw;

  // pass 1: sum and sum of squares in f32
  float s = 0.f, ss = 0.f;
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / V; i += kThreads) {
      float v[V];
      Vec<T>::load(xr + i * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s += v[k];
        ss = fmaf(v[k], v[k], ss);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float v = to_f32(xr[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  block_sum2(s, ss);

  const float n = static_cast<float>(hw);
  const float mean = s / n;
  float var = ss / n - mean * mean;
  var = var < 0.f ? 0.f : var;
  const float inv = rsqrtf(var + eps);
  const float scale = inv * (1.f + gamma[row]);
  const float shift = beta[row] - mean * scale;
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }

  // pass 2: normalize + modulate + activate
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / V; i += kThreads) {
      float v[V];
      Vec<T>::load(xr + i * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = activate<ACT>(fmaf(v[k], scale, shift));
      Vec<T>::store(yr + i * V, v);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      yr[i] = from_f32<T>(activate<ACT>(fmaf(to_f32(xr[i]), scale, shift)));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   void* mean, void* inv, int64_t rows, int64_t hw, float eps,
                   int act, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* yp = static_cast<T*>(y);
  auto* mp = static_cast<float*>(mean);
  auto* ip = static_cast<float*>(inv);
  switch (act) {
    case 0:
      modulated_instance_norm_fwd_kernel<T, 0><<<grid, kThreads, 0, stream>>>(
          xp, gp, bp, yp, mp, ip, hw, eps, vec);
      break;
    case 1:
      modulated_instance_norm_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          xp, gp, bp, yp, mp, ip, hw, eps, vec);
      break;
    case 2:
      modulated_instance_norm_fwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          xp, gp, bp, yp, mp, ip, hw, eps, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, hw) in float (dtype 0) or bfloat16 (dtype 1); gamma, beta,
// mean, inv: (rows,) float. vec != 0 promises hw % (16 / sizeof(T)) == 0 and
// 16-byte aligned x and y. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int dig_modulated_instance_norm_fwd(
    const void* x, const void* gamma, const void* beta, void* y, void* mean,
    void* inv, int64_t rows, int64_t hw, float eps, int act, int dtype, int vec,
    int device, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || hw <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, beta, y, mean, inv, rows, hw, eps, act, vec != 0, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gamma, beta, y, mean, inv, rows, hw, eps, act, vec != 0, st);
  return cudaErrorInvalidValue;
}
