// Fused instance norm + per-(n, c) style modulation + optional activation,
// forward and backward, for NCHW-contiguous x (one (n, c) plane = one row of
// H*W).
//
// Forward (replaces de_i2i_gan_tpu/ops/pallas/norm_kernels.py::_fwd_kernel):
//
//   mean  = E[x],  var = max(E[x^2] - mean^2, 0),  inv = rsqrt(var + eps)
//   scale = inv * (1 + gamma[n, c]),  shift = beta[n, c] - mean * scale
//   y     = act(x * scale + shift),   act in {none, relu, leaky_relu(0.2)}
//
// computed as the TPU kernel computes it: single-pass f32 moments, the same
// scale and shift, y in the IO dtype (float or bfloat16), and mean and inv as
// f32 (N, C) residuals for the backward kernel.
//
// Backward (replaces norm_kernels.py::_bwd_kernel), from x, dy and the
// forward's mean and inv:
//
//   xhat = (x - mean) * inv
//   dy'  = dy gated at the recomputed pre-activation (1 + gamma) * xhat + beta
//          (relu passes > 0; leaky_relu passes >= 0 and scales the rest by 0.2)
//   dbeta = sum(dy'),  dgamma = sum(dy' * xhat)          (f32, per (n, c))
//   dx    = (1 + gamma) * inv * (dy' - mean(dy') - xhat * mean(dy' * xhat))
//
// with dx in the IO dtype.
//
// What bounds both: memory traffic. The forward does about 5 flops per
// element against 4 bytes (bf16) or 8 bytes (f32) of one read of x and one
// write of y; the backward about 12 flops against 6 (bf16) or 12 (f32) bytes
// of one read of x and dy and one write of dx. Both are far below the card's
// ~20 flops per byte of f32 CUDA-core work. A row's sums are needed before
// its first output, so a kernel that streams the row twice reads it twice;
// the TPU kernel keeps the whole slab in VMEM to read it once. Here the row
// is held on chip between the two passes, and where it lives is chosen per
// call by a planner (ops/cuda/norm_kernels.py::plan), in four tiers:
//
//   W  a warp per row, the row in registers (16-byte-aligned rows of at most
//      kWarpRowMax elements: StarGAN v2's 16x16 and 32x32). A 256-thread
//      block takes 8 rows. Each lane loads its vectors once, the sums are
//      reduced by warp shuffles alone (no shared memory, no __syncthreads),
//      and the output is written from the registers.
//   B  a block per row, the row in registers (aligned rows of at most
//      kBlockVectors 16-byte vectors a thread: 64x64). Every load is issued
//      before the first sum, one block_sum2 reduces, and the output is
//      written from the registers.
//   C  a thread-block cluster of 1, 2, 4 or 8 blocks per row (longer aligned
//      rows that fit kSliceBudget bytes a block: 128x128, 256x256). Each
//      block holds a slice of the row (of x and dy in the backward) in
//      dynamic shared memory, loaded by TMA bulk copies in 4 KB chunks, each
//      completing on its own mbarrier; the partial sums are taken as each
//      chunk lands. The blocks exchange their two partials through
//      distributed shared memory and every block sums all of them in rank
//      order, so all get the same totals. Pass 2 reads the slice from shared
//      memory.
//   S  streaming, a block per row: the first design, kept for rows that are
//      not 16-byte aligned or ragged (a scalar loop) and for rows longer
//      than a cluster of 8 holds. Pass 1 streams the row for the sums, pass
//      2 streams it again (from L2 where the rows in flight fit there).
//
// W, B and C read device memory once and write it once. In every tier a
// row's sums stay inside one warp, block or cluster, taken in a fixed order:
// no atomics, and dgamma and dbeta come out the same on every run.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// tier W: the longest row a warp keeps in registers
constexpr int64_t kWarpRowMax = 1024;
// tier B: the most 16-byte vectors a thread keeps of a row
constexpr int kBlockVectors = 4;
// tier C: shared memory a block may hold for its slices (x, and dy in the
// backward), which leaves two blocks resident on each SM; loaded in chunks
// of one 16-byte vector a thread a tensor
constexpr int kSliceBudget = 98304;
constexpr int kChunkBytes = kThreads * 16;
constexpr int kMaxChunks = kSliceBudget / kChunkBytes;
constexpr int kMaxCluster = 8;

enum Tier { kTierS = 0, kTierW = 1, kTierC = 2, kTierB = 3 };

// the launch the planner chose
struct Plan {
  int tier, rows_per_block, threads, cluster, smem;
};

// what every kernel takes besides its pointers
struct Rows {
  int64_t rows, hw;
  int cluster;  // tier C: blocks a row
  int vec;      // tier S: 16-byte vectors allowed
};

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&v)[N]) {
    v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float (&v)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return raw;
  }
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Vec<T>::N]) {
  Vec<T>::unpack(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[Vec<T>::N]) {
  *reinterpret_cast<uint4*>(p) = Vec<T>::pack(v);
}

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

// The activation's derivative at the recomputed pre-activation
// y = xhat * (1 + gamma) + beta, applied to dy, as _bwd_kernel gates it (NaN
// y: relu passes 0, leaky_relu 0.2 * dy). y is rounded after the product and
// again after the sum, never fused into one fma, so that an element within
// rounding of 0 takes the same side of the gate as in the plain version.
template <int ACT>
__device__ __forceinline__ float gate(float dy, float xhat, float g1, float b) {
  if (ACT == 0) return dy;
  const float y = __fadd_rn(__fmul_rn(xhat, g1), b);
  if (ACT == 1) return y > 0.f ? dy : 0.f;
  return y >= 0.f ? dy : 0.2f * dy;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; every thread gets both totals. A second call
// needs a __syncthreads between, so no warp overwrites sa or sb while
// another still reads them.
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

// ------------------------------------------------ TMA, mbarrier, cluster

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the arrival of the one issuing thread, with the bytes its copies bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits for the barrier's first phase. A wait that outlasts about 2^34
// cycles (~9 s) traps, so a copy that never lands fails the launch instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the float2 at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float2 load_remote(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// Tier C's common frame: the block's slice of the row (vectors [first,
// first + count) of nvec), loaded by TMA in chunks of kChunkBytes a tensor,
// chunk c completing on bars[c].
struct Slice {
  int64_t first;  // first vector of the row in this block's slice
  int count;      // vectors in the slice
  int chunks;
  uint32_t rank;
};

__device__ __forceinline__ Slice block_slice(int64_t nvec, int cluster) {
  Slice s;
  s.rank = cluster > 1 ? cluster_rank() : 0;
  const int64_t per = (nvec + cluster - 1) / cluster;
  s.first = per * s.rank;
  const int64_t left = nvec - s.first;
  s.count = static_cast<int>(left < 0 ? 0 : (left < per ? left : per));
  s.chunks = (s.count * 16 + kChunkBytes - 1) / kChunkBytes;
  return s;
}

// Thread 0 sets up one mbarrier a chunk; after the __syncthreads that shows
// them to every thread, it issues the TMA copies of NT slices (src[t] ->
// dst[t], each s.count vectors), every chunk's barrier expecting the bytes
// of that chunk of all the tensors.
template <int NT>
__device__ __forceinline__ void load_slices(const Slice& s, uint64_t* bars,
                                            unsigned char* const (&dst)[NT],
                                            const unsigned char* const (&src)[NT]) {
  if (threadIdx.x == 0) {
    for (int c = 0; c < s.chunks; ++c) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t total = static_cast<uint32_t>(s.count) * 16u;
    for (int c = 0; c < s.chunks; ++c) {
      const uint32_t off = static_cast<uint32_t>(c) * kChunkBytes;
      const uint32_t bytes = total - off < kChunkBytes ? total - off : kChunkBytes;
      mbar_expect_tx(&bars[c], NT * bytes);
#pragma unroll
      for (int t = 0; t < NT; ++t) bulk_load(dst[t] + off, src[t] + off, bytes, &bars[c]);
    }
  }
}

// The row's totals of a and b over the cluster: the block's sums (taken in a
// fixed order) are exchanged through distributed shared memory and every
// block adds all of them in rank order. With a cluster, leaves this block's
// second arrival open: the caller waits on it (cluster_wait) before it
// exits, so no block's shared memory goes while another still reads it.
__device__ __forceinline__ void cluster_sum2(float& a, float& b, int cluster) {
  __shared__ float2 part;
  block_sum2(a, b);
  if (cluster == 1) return;
  if (threadIdx.x == 0) part = make_float2(a, b);
  cluster_arrive();
  cluster_wait();
  a = 0.f;
  b = 0.f;
  for (int r = 0; r < cluster; ++r) {
    const float2 p = load_remote(&part, static_cast<uint32_t>(r));
    a += p.x;
    b += p.y;
  }
  cluster_arrive();
}

// ---------------------------------------------------------------- forward

// Tier S: a block per row, the row streamed twice.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   T* __restrict__ y,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ inv_out,
                                   Rows shape, float eps) {
  constexpr int V = Vec<T>::N;
  const int64_t hw = shape.hw;
  const bool vec = shape.vec != 0;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * hw;
  T* yr = y + row * hw;

  // pass 1: sum and sum of squares in f32
  float s = 0.f, ss = 0.f;
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / V; i += kThreads) {
      float v[V];
      load_vec(xr + i * V, v);
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
      load_vec(xr + i * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = activate<ACT>(fmaf(v[k], scale, shift));
      store_vec(yr + i * V, v);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      yr[i] = from_f32<T>(activate<ACT>(fmaf(to_f32(xr[i]), scale, shift)));
    }
  }
}

// The sums of a and b over the G threads that share a row: a warp's by
// shuffles alone, a block's through block_sum2.
template <int G>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
  if constexpr (G == 32) {
    a = warp_sum(a);
    b = warp_sum(b);
  } else {
    block_sum2(a, b);
  }
}

// Tiers W (G = 32: a warp per row) and B (G = kThreads: a block per row):
// thread t of a row's G keeps vectors t, t + G, ... (K of them at most) in
// registers from the one read to the write.
template <typename T, int G, int K, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_fwd_reg_kernel(const T* __restrict__ x,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       T* __restrict__ y,
                                       float* __restrict__ mean_out,
                                       float* __restrict__ inv_out,
                                       Rows shape, float eps) {
  constexpr int V = Vec<T>::N;
  const int t = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (row >= shape.rows) return;  // a whole warp (G = 32) or block: no sum loses a thread
  const int nvec = static_cast<int>(shape.hw / V);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * shape.hw);
  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) raw[k] = xr[t + G * k];
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) {
      float v[V];
      Vec<T>::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += v[j];
        ss = fmaf(v[j], v[j], ss);
      }
    }
  }
  group_sum2<G>(s, ss);

  const float n = static_cast<float>(shape.hw);
  const float mean = s / n;
  float var = ss / n - mean * mean;
  var = var < 0.f ? 0.f : var;
  const float inv = rsqrtf(var + eps);
  const float scale = inv * (1.f + gamma[row]);
  const float shift = beta[row] - mean * scale;
  if (t == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
  uint4* yr = reinterpret_cast<uint4*>(y + row * shape.hw);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) {
      float v[V];
      Vec<T>::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = activate<ACT>(fmaf(v[j], scale, shift));
      yr[t + G * k] = Vec<T>::pack(v);
    }
  }
}

// Tier C: shape.cluster blocks a row, each holding its slice of x in shared
// memory from one TMA read to the write.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_fwd_cluster_kernel(const T* __restrict__ x,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           T* __restrict__ y,
                                           float* __restrict__ mean_out,
                                           float* __restrict__ inv_out,
                                           Rows shape, float eps) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  const int64_t row = blockIdx.x / shape.cluster;
  const Slice sl = block_slice(shape.hw / V, shape.cluster);
  const int64_t base = row * shape.hw + sl.first * V;  // elements
  unsigned char* const dst[1] = {smem};
  const unsigned char* const src[1] = {
      reinterpret_cast<const unsigned char*>(x + base)};
  load_slices<1>(sl, bars, dst, src);
  const uint4* xs = reinterpret_cast<const uint4*>(smem);

  // pass 1: the sums, chunk by chunk as each lands
  float s = 0.f, ss = 0.f;
  for (int c = 0; c < sl.chunks; ++c) {
    mbar_wait(&bars[c]);
    const int i = c * kThreads + threadIdx.x;
    if (i < sl.count) {
      float v[V];
      Vec<T>::unpack(xs[i], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += v[j];
        ss = fmaf(v[j], v[j], ss);
      }
    }
  }
  cluster_sum2(s, ss, shape.cluster);

  const float n = static_cast<float>(shape.hw);
  const float mean = s / n;
  float var = ss / n - mean * mean;
  var = var < 0.f ? 0.f : var;
  const float inv = rsqrtf(var + eps);
  const float scale = inv * (1.f + gamma[row]);
  const float shift = beta[row] - mean * scale;
  if (threadIdx.x == 0 && sl.rank == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }

  // pass 2: from shared memory to y
  uint4* yr = reinterpret_cast<uint4*>(y + base);
  for (int i = threadIdx.x; i < sl.count; i += kThreads) {
    float v[V];
    Vec<T>::unpack(xs[i], v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = activate<ACT>(fmaf(v[j], scale, shift));
    yr[i] = Vec<T>::pack(v);
  }
  if (shape.cluster > 1) cluster_wait();
}

// --------------------------------------------------------------- backward

// Tier S: a block per row, x and dy streamed twice.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_bwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ mean_in,
                                   const float* __restrict__ inv_in,
                                   const T* __restrict__ dy,
                                   T* __restrict__ dx,
                                   float* __restrict__ dgamma,
                                   float* __restrict__ dbeta,
                                   Rows shape) {
  constexpr int V = Vec<T>::N;
  const int64_t hw = shape.hw;
  const bool vec = shape.vec != 0;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * hw;
  const T* dyr = dy + row * hw;
  T* dxr = dx + row * hw;
  const float mean = mean_in[row];
  const float inv = inv_in[row];
  const float g1 = 1.f + gamma[row];
  const float b = beta[row];

  // pass 1: sum(dy') and sum(dy' * xhat) in f32
  float s = 0.f, sx = 0.f;
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / V; i += kThreads) {
      float xv[V], gv[V];
      load_vec(xr + i * V, xv);
      load_vec(dyr + i * V, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (xv[k] - mean) * inv;
        const float d = gate<ACT>(gv[k], xh, g1, b);
        s += d;
        sx = fmaf(d, xh, sx);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float xh = (to_f32(xr[i]) - mean) * inv;
      const float d = gate<ACT>(to_f32(dyr[i]), xh, g1, b);
      s += d;
      sx = fmaf(d, xh, sx);
    }
  }
  block_sum2(s, sx);
  if (threadIdx.x == 0) {
    dgamma[row] = sx;
    dbeta[row] = s;
  }

  // pass 2: dx = (1 + gamma) * inv * (dy' - mean(dy') - xhat * mean(dy' * xhat))
  const float n = static_cast<float>(hw);
  const float a = g1 * inv;
  const float m_dy = s / n;
  const float m_dyx = sx / n;
  if (vec) {
    for (int64_t i = threadIdx.x; i < hw / V; i += kThreads) {
      float xv[V], gv[V];
      load_vec(xr + i * V, xv);
      load_vec(dyr + i * V, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (xv[k] - mean) * inv;
        const float d = gate<ACT>(gv[k], xh, g1, b);
        xv[k] = a * (d - m_dy - xh * m_dyx);
      }
      store_vec(dxr + i * V, xv);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float xh = (to_f32(xr[i]) - mean) * inv;
      const float d = gate<ACT>(to_f32(dyr[i]), xh, g1, b);
      dxr[i] = from_f32<T>(a * (d - m_dy - xh * m_dyx));
    }
  }
}

// The backward's per-vector steps, shared by tiers W and C: the two sums of
// one 16-byte vector of x and dy, and its dx.
template <typename T, int ACT>
struct BwdRow {
  static constexpr int V = Vec<T>::N;
  float mean, inv, g1, b;

  __device__ __forceinline__ void sums(const uint4& xraw, const uint4& draw,
                                       float& s, float& sx) const {
    float xv[V], gv[V];
    Vec<T>::unpack(xraw, xv);
    Vec<T>::unpack(draw, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (xv[k] - mean) * inv;
      const float d = gate<ACT>(gv[k], xh, g1, b);
      s += d;
      sx = fmaf(d, xh, sx);
    }
  }

  __device__ __forceinline__ uint4 dx(const uint4& xraw, const uint4& draw,
                                      float a, float m_dy, float m_dyx) const {
    float xv[V], gv[V];
    Vec<T>::unpack(xraw, xv);
    Vec<T>::unpack(draw, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (xv[k] - mean) * inv;
      const float d = gate<ACT>(gv[k], xh, g1, b);
      xv[k] = a * (d - m_dy - xh * m_dyx);
    }
    return Vec<T>::pack(xv);
  }
};

// Tiers W and B: a warp or a block per row, x and dy in registers.
template <typename T, int G, int K, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_bwd_reg_kernel(const T* __restrict__ x,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ mean_in,
                                       const float* __restrict__ inv_in,
                                       const T* __restrict__ dy,
                                       T* __restrict__ dx,
                                       float* __restrict__ dgamma,
                                       float* __restrict__ dbeta,
                                       Rows shape) {
  constexpr int V = Vec<T>::N;
  const int t = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (row >= shape.rows) return;  // a whole warp (G = 32) or block: no sum loses a thread
  const int nvec = static_cast<int>(shape.hw / V);
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * shape.hw);
  const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * shape.hw);
  uint4 xraw[K], draw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) {
      xraw[k] = xr[t + G * k];
      draw[k] = dyr[t + G * k];
    }
  }
  const BwdRow<T, ACT> r{mean_in[row], inv_in[row], 1.f + gamma[row], beta[row]};
  float s = 0.f, sx = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) r.sums(xraw[k], draw[k], s, sx);
  }
  group_sum2<G>(s, sx);
  if (t == 0) {
    dgamma[row] = sx;
    dbeta[row] = s;
  }
  const float n = static_cast<float>(shape.hw);
  const float a = r.g1 * r.inv;
  const float m_dy = s / n;
  const float m_dyx = sx / n;
  uint4* dxr = reinterpret_cast<uint4*>(dx + row * shape.hw);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + G * k < nvec) dxr[t + G * k] = r.dx(xraw[k], draw[k], a, m_dy, m_dyx);
  }
}

// Tier C: shape.cluster blocks a row, each holding its slices of x and dy in
// shared memory (x first, dy after it).
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
modulated_instance_norm_bwd_cluster_kernel(const T* __restrict__ x,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ mean_in,
                                           const float* __restrict__ inv_in,
                                           const T* __restrict__ dy,
                                           T* __restrict__ dx,
                                           float* __restrict__ dgamma,
                                           float* __restrict__ dbeta,
                                           Rows shape) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  const int64_t row = blockIdx.x / shape.cluster;
  const Slice sl = block_slice(shape.hw / V, shape.cluster);
  const int64_t base = row * shape.hw + sl.first * V;  // elements
  unsigned char* const dst[2] = {smem, smem + sl.count * 16};
  const unsigned char* const src[2] = {
      reinterpret_cast<const unsigned char*>(x + base),
      reinterpret_cast<const unsigned char*>(dy + base)};
  load_slices<2>(sl, bars, dst, src);
  const uint4* xs = reinterpret_cast<const uint4*>(dst[0]);
  const uint4* ds = reinterpret_cast<const uint4*>(dst[1]);
  const BwdRow<T, ACT> r{mean_in[row], inv_in[row], 1.f + gamma[row], beta[row]};

  // pass 1: the sums, chunk by chunk as each lands
  float s = 0.f, sx = 0.f;
  for (int c = 0; c < sl.chunks; ++c) {
    mbar_wait(&bars[c]);
    const int i = c * kThreads + threadIdx.x;
    if (i < sl.count) r.sums(xs[i], ds[i], s, sx);
  }
  cluster_sum2(s, sx, shape.cluster);
  if (threadIdx.x == 0 && sl.rank == 0) {
    dgamma[row] = sx;
    dbeta[row] = s;
  }

  // pass 2: from shared memory to dx
  const float n = static_cast<float>(shape.hw);
  const float a = r.g1 * r.inv;
  const float m_dy = s / n;
  const float m_dyx = sx / n;
  uint4* dxr = reinterpret_cast<uint4*>(dx + base);
  for (int i = threadIdx.x; i < sl.count; i += kThreads) {
    dxr[i] = r.dx(xs[i], ds[i], a, m_dy, m_dyx);
  }
  if (shape.cluster > 1) cluster_wait();
}

// ------------------------------------------------------------------- host

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int vec_elems(int dtype) { return dtype == 0 ? 4 : 8; }

// tiers W and B: vectors a thread keeps (1, 2, 4 or 8), the fewest that hold
// the row among `group` threads
int reg_vectors(int64_t hw, int dtype, int group) {
  const int64_t nvec = hw / vec_elems(dtype);
  int k = 1;
  while (group * k < nvec) k *= 2;
  return k;
}

// Whether the plan is one the kernels take for this call: the planner's own
// rules (ops/cuda/norm_kernels.py::plan), checked again here.
bool feasible(const Plan& p, int64_t rows, int64_t hw, int dtype, int ntensors,
              bool aligned) {
  if (p.threads != kThreads || rows <= 0 || hw <= 0) return false;
  const int v = vec_elems(dtype);
  const bool vec = aligned && hw % v == 0;
  if (p.tier == kTierS) {
    return p.rows_per_block == 1 && p.cluster == 1 && p.smem == 0 && rows <= 0x7fffffff;
  }
  if (!vec) return false;
  if (p.tier == kTierW) {
    return p.rows_per_block == kWarps && p.cluster == 1 && p.smem == 0 &&
           hw <= kWarpRowMax && (rows + kWarps - 1) / kWarps <= 0x7fffffff;
  }
  if (p.tier == kTierB) {
    return p.rows_per_block == 1 && p.cluster == 1 && p.smem == 0 &&
           hw / v <= kThreads * kBlockVectors && rows <= 0x7fffffff;
  }
  if (p.tier != kTierC || p.rows_per_block != 1) return false;
  if (p.cluster != 1 && p.cluster != 2 && p.cluster != 4 && p.cluster != kMaxCluster)
    return false;
  const int64_t per = (hw / v + p.cluster - 1) / p.cluster;
  return p.smem == ntensors * per * 16 && p.smem <= kSliceBudget &&
         rows * p.cluster <= 0x7fffffff;
}

// The kernel of a plan, for the forward (op 0) or the backward (op 1).
template <typename T, int ACT>
const void* kernel_of(int op, int tier, int k) {
  if (tier == kTierS)
    return op == 0 ? reinterpret_cast<const void*>(modulated_instance_norm_fwd_kernel<T, ACT>)
                   : reinterpret_cast<const void*>(modulated_instance_norm_bwd_kernel<T, ACT>);
  if (tier == kTierC)
    return op == 0
               ? reinterpret_cast<const void*>(modulated_instance_norm_fwd_cluster_kernel<T, ACT>)
               : reinterpret_cast<const void*>(modulated_instance_norm_bwd_cluster_kernel<T, ACT>);
#define DIG_REG(G, K)                                                                          \
  if (k == K)                                                                                  \
    return op == 0                                                                             \
               ? reinterpret_cast<const void*>(modulated_instance_norm_fwd_reg_kernel<T, G, K, ACT>) \
               : reinterpret_cast<const void*>(modulated_instance_norm_bwd_reg_kernel<T, G, K, ACT>);
  if (tier == kTierW) {
    DIG_REG(32, 1)
    DIG_REG(32, 2)
    DIG_REG(32, 4)
    if constexpr (Vec<T>::N == 4) {  // only float rows of 1024 need 8
      DIG_REG(32, 8)
    }
  }
  if (tier == kTierB) {
    DIG_REG(kThreads, 1)
    DIG_REG(kThreads, 2)
    DIG_REG(kThreads, 4)
  }
#undef DIG_REG
  return nullptr;
}

template <typename T>
const void* kernel_of_act(int op, int act, int tier, int k) {
  switch (act) {
    case 0: return kernel_of<T, 0>(op, tier, k);
    case 1: return kernel_of<T, 1>(op, tier, k);
    case 2: return kernel_of<T, 2>(op, tier, k);
    default: return nullptr;
  }
}

const void* kernel_for(int op, int dtype, int act, const Plan& p, int64_t hw) {
  const int k = p.tier == kTierW   ? reg_vectors(hw, dtype, 32)
                : p.tier == kTierB ? reg_vectors(hw, dtype, kThreads)
                                   : 0;
  if (dtype == 0) return kernel_of_act<float>(op, act, p.tier, k);
  if (dtype == 1) return kernel_of_act<__nv_bfloat16>(op, act, p.tier, k);
  return nullptr;
}

// Tier C's slices go above the 48 KB a block gets by default: raise each
// cluster kernel's limit to the budget once a device, before its first use.
cudaError_t allow_slices(const void* fn, int device) {
  constexpr int kMaxDevices = 64;
  constexpr int kKernels = 2 * 2 * 3;  // op x dtype x act
  static const void* seen[kMaxDevices][kKernels] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  for (int i = 0; i < kKernels; ++i) {
    if (seen[device][i] == fn) return cudaSuccess;
    if (seen[device][i] == nullptr) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceBudget);
      if (err == cudaSuccess) seen[device][i] = fn;
      return err;
    }
  }
  return cudaErrorUnknown;
}

cudaLaunchConfig_t launch_config(const Plan& p, int64_t rows,
                                 cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  const int64_t blocks = (rows + p.rows_per_block - 1) / p.rows_per_block * p.cluster;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(p.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  if (p.tier == kTierC) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = static_cast<unsigned>(p.cluster);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

cudaError_t launch(int op, int dtype, int act, const Plan& p, int64_t rows,
                   int64_t hw, void** args, int device, cudaStream_t stream) {
  const void* fn = kernel_for(op, dtype, act, p, hw);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (p.tier == kTierC) {
    const cudaError_t err = allow_slices(fn, device);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, rows, &attr, stream);
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x, y: (rows, hw) in float (dtype 0) or bfloat16 (dtype 1); gamma, beta,
// mean, inv: (rows,) float. The plan (tier 0 streaming, 1 a warp a row, 2 a
// cluster a row; rows a block, threads, cluster size, dynamic shared memory
// in bytes) is the planner's; one the kernels do not take for this call
// returns cudaErrorInvalidValue without launching. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dig_modulated_instance_norm_fwd(
    const void* x, const void* gamma, const void* beta, void* y, void* mean,
    void* inv, int64_t rows, int64_t hw, float eps, int act, int dtype,
    int tier, int rows_per_block, int threads, int cluster, int smem,
    int device, void* stream) {
  const Plan p{tier, rows_per_block, threads, cluster, smem};
  const bool aligned = aligned16(x) && aligned16(y);
  if ((dtype != 0 && dtype != 1) || !feasible(p, rows, hw, dtype, 1, aligned))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Rows shape{rows, hw, cluster, aligned && hw % vec_elems(dtype) == 0};
  void* args[] = {&x, &gamma, &beta, &y, &mean, &inv, &shape, &eps};
  return launch(0, dtype, act, p, rows, hw, args, device,
                static_cast<cudaStream_t>(stream));
}

// x, dy, dx: (rows, hw) in float (dtype 0) or bfloat16 (dtype 1); gamma,
// beta, mean, inv, dgamma, dbeta: (rows,) float. The plan as for the
// forward. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int dig_modulated_instance_norm_bwd(
    const void* x, const void* gamma, const void* beta, const void* mean,
    const void* inv, const void* dy, void* dx, void* dgamma, void* dbeta,
    int64_t rows, int64_t hw, int act, int dtype, int tier, int rows_per_block,
    int threads, int cluster, int smem, int device, void* stream) {
  const Plan p{tier, rows_per_block, threads, cluster, smem};
  const bool aligned = aligned16(x) && aligned16(dy) && aligned16(dx);
  if ((dtype != 0 && dtype != 1) || !feasible(p, rows, hw, dtype, 2, aligned))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Rows shape{rows, hw, cluster, aligned && hw % vec_elems(dtype) == 0};
  void* args[] = {&x, &gamma, &beta, &mean, &inv, &dy, &dx, &dgamma, &dbeta, &shape};
  return launch(1, dtype, act, p, rows, hw, args, device,
                static_cast<cudaStream_t>(stream));
}

// What a plan's kernel gets on the device: its blocks resident on one SM and,
// for a cluster plan, the clusters resident on the whole card at once
// (cudaOccupancyMaxActiveClusters; 0 for the other tiers). op 0 forward, 1
// backward; the plan must be feasible for an aligned row of hw.
extern "C" int dig_modulated_instance_norm_occupancy(
    int op, int64_t hw, int act, int dtype, int tier, int rows_per_block,
    int threads, int cluster, int smem, int device, int* blocks_per_sm,
    int* max_clusters) {
  const Plan p{tier, rows_per_block, threads, cluster, smem};
  if ((op != 0 && op != 1) || (dtype != 0 && dtype != 1) ||
      !feasible(p, kMaxCluster, hw, dtype, op + 1, true))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = kernel_for(op, dtype, act, p, hw);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (p.tier == kTierC && (err = allow_slices(fn, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, p.threads,
                                                      static_cast<size_t>(p.smem));
  if (err != cudaSuccess) return err;
  *max_clusters = 0;
  if (p.tier != kTierC) return cudaSuccess;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, kMaxCluster, &attr, nullptr);
  return cudaOccupancyMaxActiveClusters(max_clusters, fn, &cfg);
}
