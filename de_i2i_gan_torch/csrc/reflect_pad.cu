// Reflect padding of NCHW images on H and W, forward and backward, for
// contiguous float or bfloat16 tensors.
//
// Replaces no TPU kernel: the JAX package pads with jnp.pad, which XLA fuses
// into the convolution that follows. The port's convolutions are cuDNN's and
// take a padded tensor, and aten's reflection_pad2d took about a quarter of a
// replayed DefectGAN super-step (its forward at about a fifth of the bytes'
// bound, its backward a zero fill and an atomic scatter), so this pair takes
// its place for CUDA tensors (ops/cuda/pad_kernels.py).
//
// Forward: y[p, oh, ow] = x[p, r(oh - pt, H), r(ow - pl, W)], where r folds an
// index back into [0, n) by repeated reflection about 0 and n - 1 (numpy's
// 'reflect'; pads at or beyond the axis included, which F.pad refuses):
// a pure copy, so y is x's bits.
//
// Backward, its adjoint: dx[p, i, j] sums dy[p, oh, ow] over every (oh, ow)
// that the forward read from (i, j), rows ascending and within a row columns
// ascending, in float32, rounded once to the IO type. An element in the
// interior has one source; one at a corner 4, where each axis is longer than
// its two pads together (9 at most while every pad is shorter than its axis,
// more where a pad reaches it). Each dx element is written by one thread: no
// zero fill, no atomics, the same bits on every run.
//
// What bounds both: memory traffic, one read of the input and one write of
// the output, with no arithmetic to speak of. So each thread writes one
// 16-byte vector of consecutive output elements (8 bfloat16 or 4 float) and
// gathers its elements with independent loads, which keeps 16 bytes a
// thread in flight; a warp's loads fall on a few consecutive lines that the
// L1 serves after the first. Interior vectors (one source row, no reflected
// column) take a straight-line path: in the forward, from a 16-byte aligned
// input, the two aligned 16-byte vectors that hold them, shifted into place
// (faster than the element gather there; not in the backward, PERF.md §6);
// the others fold each index. A ragged tail, an unaligned output, (backward)
// rows that are not whole vectors, and pads that reach their axis (tiny
// maps: any number of sources) take a scalar loop. Offsets are 32-bit where
// the tensors allow, and divisions by the shape multiplies (they took a
// fifth of the forward's time at 256² rows).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;  // a grid-stride loop beyond

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The element's bits, and its value as a float: float as its 32 bits,
// bfloat16 as its 16.
template <typename S>
struct Bits;

template <>
struct Bits<uint32_t> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static float to_float(uint32_t v) { return __uint_as_float(v); }
  __device__ __forceinline__ static uint32_t from_float(float f) { return __float_as_uint(f); }
};

template <>
struct Bits<uint16_t> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float to_float(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ __forceinline__ static uint16_t from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

// Element k of a 16-byte vector held as four 32-bit words in registers.
__device__ __forceinline__ void put(uint32_t (&v)[4], int k, uint32_t e) { v[k] = e; }
__device__ __forceinline__ void put(uint32_t (&v)[4], int k, uint16_t e) {
  v[k >> 1] = (k & 1) ? v[k >> 1] | (static_cast<uint32_t>(e) << 16) : e;
}

// Element k's bits, and element k replaced.
__device__ __forceinline__ uint32_t get(const uint32_t (&v)[4], int k, uint32_t) {
  return v[k];
}
__device__ __forceinline__ uint16_t get(const uint32_t (&v)[4], int k, uint16_t) {
  return static_cast<uint16_t>(v[k >> 1] >> (16 * (k & 1)));
}
__device__ __forceinline__ void replace(uint32_t (&v)[4], int k, uint32_t e) { v[k] = e; }
__device__ __forceinline__ void replace(uint32_t (&v)[4], int k, uint16_t e) {
  const int sh = 16 * (k & 1);
  v[k >> 1] = (v[k >> 1] & ~(0xffffu << sh)) | (static_cast<uint32_t>(e) << sh);
}

template <typename S>
__device__ __forceinline__ void store16(S* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// Words k..k+4 of the eight in a and b (q in [0, 4)), by a switch: an index
// that varies would put the words in local memory.
__device__ __forceinline__ void window(const uint4& a, const uint4& b, int q,
                                       uint32_t (&t)[5]) {
  switch (q) {
    case 0: t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w; t[4] = b.x; break;
    case 1: t[0] = a.y; t[1] = a.z; t[2] = a.w; t[3] = b.x; t[4] = b.y; break;
    case 2: t[0] = a.z; t[1] = a.w; t[2] = b.x; t[3] = b.y; t[4] = b.z; break;
    default: t[0] = a.w; t[1] = b.x; t[2] = b.y; t[3] = b.z; t[4] = b.w; break;
  }
}

// The 16 bytes of elements src[s0], ..., src[s0 + kVec - 1] of a 16-byte
// aligned src of `total` elements, from the two aligned 16-byte vectors that
// hold them (one where s0 is aligned), shifted into place: a warp's loads
// touch a quarter of the lines of the scalar gather's. Element by element
// where the second vector would pass the end.
template <typename S, typename I>
__device__ __forceinline__ void load_span(const S* __restrict__ src, I s0, I total,
                                          uint32_t (&v)[4]) {
  constexpr int V = Bits<S>::kVec;
  const I a = s0 & ~static_cast<I>(V - 1);
  const int o = static_cast<int>(s0 - a);
  if (o && a + 2 * V > total) {
#pragma unroll
    for (int k = 0; k < V; ++k) put(v, k, src[s0 + k]);
    return;
  }
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src + a));
  const uint4 hi = o ? __ldg(reinterpret_cast<const uint4*>(src + a + V)) : lo;
  uint32_t t[5];
  const int per_word = 4 / sizeof(S);  // elements a word
  window(lo, hi, o / per_word, t);
  if (per_word == 2 && (o & 1)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(t[k], t[k + 1], 16);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = t[k];
  }
}

// Division by a fixed d of n in [0, 2^31) as a multiply and a shift
// (CUTLASS's FastDivmod): m and s from the host.
struct FastDiv {
  int d;
  unsigned m, s;
};

FastDiv fast_div(int64_t d) {
  FastDiv f{static_cast<int>(d), 0, 0};
  if (d > 1) {
    int log2 = 0;  // ceil(log2(d))
    while ((int64_t{1} << log2) < d) ++log2;
    f.m = static_cast<unsigned>(((uint64_t{1} << (31 + log2)) + d - 1) / d);
    f.s = static_cast<unsigned>(log2 - 1);
  }
  return f;
}

// n / d: by f where offsets are 32-bit, else the division.
template <typename I>
__device__ __forceinline__ I divide(I n, const FastDiv& f) {
  if constexpr (sizeof(I) == 4) {
    return f.d > 1 ? static_cast<I>(__umulhi(static_cast<unsigned>(n), f.m) >> f.s) : n;
  } else {
    return n / f.d;
  }
}

struct PadShape {
  int64_t planes, h, w, ho, wo;  // N * C; the input's and the output's H, W
  int64_t pt, pb, pl, pr;        // top, bottom, left, right
  int vec;                       // 16-byte vectors of the output allowed
  int simple;                    // every pad shorter than its axis
  int vec_in;                    // the input 16-byte aligned (forward)
  FastDiv by_h, by_w, by_ho, by_wo;
};

// The source of position i of a padded axis of length n (i in [-lo, n + hi)):
// one reflection where the pads are shorter than the axis, else the fold's
// period.
template <typename I>
__device__ __forceinline__ I reflect(I i, I n) {
  if (i < 0) {
    if (-i < n) return -i;
  } else if (i < n) {
    return i;
  } else if (i - n < n - 1) {
    return 2 * (n - 1) - i;
  }
  if (n == 1) return 0;
  const I period = 2 * (n - 1);
  I m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

// Every position of [-lo, n + hi) that reflects to i, for any pads: the
// candidates (k, side) for k in [k0, k1] and side 0, then 1, in increasing
// order of position; side 0 is k * period - i and side 1 is k * period + i
// (period 2 (n - 1)). For n = 1 every position reflects to 0, and side 0 of
// k is position k.
template <typename I>
__device__ __forceinline__ void source_range(I i, I n, I lo, I hi, I& k0, I& k1) {
  if (n == 1) {
    k0 = -lo;
    k1 = hi;
    return;
  }
  const I period = 2 * (n - 1);
  k0 = -((lo + i) / period) - 1;
  k1 = (n + hi + i) / period + 1;
}

// Candidate (k, side)'s position t; whether it lies in [-lo, n + hi) and is
// not the one before again (at i = 0 and n - 1 the two sides meet).
template <typename I>
__device__ __forceinline__ bool source(I i, I n, I lo, I hi, I k, int side, I& t) {
  if (n == 1) {
    t = k;
    return side == 0;
  }
  const I period = 2 * (n - 1);
  if (side == 0 && (i == 0 || i == n - 1)) return false;  // = side 1's
  t = side == 0 ? k * period - i : k * period + i;
  return t >= -lo && t < n + hi;
}

// Where lo and hi are shorter than n, the positions of [-lo, n + hi) that
// reflect to i are, ascending: -i where ok0 (the low edge), i itself, and
// 2 (n - 1) - i where ok2 (the high edge).
template <typename I>
__device__ __forceinline__ void edges(I i, I n, I lo, I hi, bool& ok0, bool& ok2) {
  ok0 = i >= 1 && i <= lo;
  ok2 = i >= n - 1 - hi && i <= n - 2;
}

// The first element in x of output row oh of plane p.
template <typename S, typename I>
__device__ __forceinline__ const S* source_row(const S* x, I p, I oh, const PadShape& s) {
  const I h = static_cast<I>(s.h);
  return x + (p * h + reflect<I>(oh - static_cast<I>(s.pt), h)) * static_cast<I>(s.w);
}

template <typename S, typename I>
__global__ void __launch_bounds__(kThreads)
reflect_pad_fwd_kernel(const S* __restrict__ x, S* __restrict__ y, const PadShape s) {
  constexpr int V = Bits<S>::kVec;
  const I wo = static_cast<I>(s.wo), w = static_cast<I>(s.w), pl = static_cast<I>(s.pl);
  const I ho = static_cast<I>(s.ho);
  const I total = static_cast<I>(s.planes * s.ho * s.wo);
  const I in_total = static_cast<I>(s.planes * s.h * s.w);
  const I nvec = s.vec ? total / V : 0;
  const I items = nvec + (total - nvec * V);
  for (I q = static_cast<I>(blockIdx.x) * kThreads + static_cast<I>(threadIdx.x);
       q < items; q += static_cast<I>(gridDim.x) * kThreads) {
    const I e = q < nvec ? q * V : nvec * V + (q - nvec);
    const I row = divide<I>(e, s.by_wo);
    I p = divide<I>(row, s.by_ho), oh = row - p * ho, c = e - row * wo;
    const S* src = source_row<S, I>(x, p, oh, s);
    if (q >= nvec) {  // the scalar tail, a pad that reaches its axis, or an unaligned y
      y[e] = src[reflect<I>(c - pl, w)];
      continue;
    }
    uint32_t out[4];
    if (c >= pl && c + V <= pl + w) {  // one source row, no folded column
      if (s.vec_in) {
        load_span<S, I>(x, static_cast<I>(src - x) + c - pl, in_total, out);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) put(out, j, src[c - pl + j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        put(out, j, src[reflect<I>(c - pl, w)]);
        if (++c == wo && j + 1 < V) {  // the vector goes on in the next row
          c = 0;
          if (++oh == ho) {
            oh = 0;
            ++p;
          }
          src = source_row<S, I>(x, p, oh, s);
        }
      }
    }
    store16(y + e, out);
  }
}

// `acc` plus the sources of column j in one row of dy, ascending: -j where
// c0, j, and 2 (w - 1) - j where c2 (`row` points at column pl).
template <typename S, typename I>
__device__ __forceinline__ float add_row(float acc, const S* row, I j, I w, bool c0,
                                         bool c2) {
  if (c0) acc += Bits<S>::to_float(row[-j]);
  acc += Bits<S>::to_float(row[j]);
  if (c2) acc += Bits<S>::to_float(row[2 * (w - 1) - j]);
  return acc;
}

// dx's element (p, i, j): its sources in dy summed in float32, rows ascending
// and within a row columns ascending, rounded once; `plane` points at dy's
// (p, pt, pl). Pads shorter than their axes: at most 3 sources an axis.
template <typename S, typename I>
__device__ __forceinline__ S bwd_simple(const S* plane, I i, I j, const PadShape& s) {
  const I h = static_cast<I>(s.h), w = static_cast<I>(s.w), wo = static_cast<I>(s.wo);
  bool r0, r2, c0, c2;
  edges<I>(i, h, static_cast<I>(s.pt), static_cast<I>(s.pb), r0, r2);
  edges<I>(j, w, static_cast<I>(s.pl), static_cast<I>(s.pr), c0, c2);
  float acc = -0.0f;  // -0 + v is v, so a single source keeps its bits
  if (r0) acc = add_row<S, I>(acc, plane - i * wo, j, w, c0, c2);
  acc = add_row<S, I>(acc, plane + i * wo, j, w, c0, c2);
  if (r2) acc = add_row<S, I>(acc, plane + (2 * (h - 1) - i) * wo, j, w, c0, c2);
  return Bits<S>::from_float(acc);
}

// The same for any pads.
template <typename S, typename I>
__device__ __forceinline__ S bwd_general(const S* plane, I i, I j, const PadShape& s) {
  const I h = static_cast<I>(s.h), w = static_cast<I>(s.w), wo = static_cast<I>(s.wo);
  const I pt = static_cast<I>(s.pt), pb = static_cast<I>(s.pb);
  const I pl = static_cast<I>(s.pl), pr = static_cast<I>(s.pr);
  I kr0, kr1, kc0, kc1;
  source_range<I>(i, h, pt, pb, kr0, kr1);
  source_range<I>(j, w, pl, pr, kc0, kc1);
  float acc = -0.0f;
  for (I kr = kr0; kr <= kr1; ++kr) {
    for (int sr = 0; sr < 2; ++sr) {
      I t;
      if (!source<I>(i, h, pt, pb, kr, sr, t)) continue;
      for (I kc = kc0; kc <= kc1; ++kc) {
        for (int sc = 0; sc < 2; ++sc) {
          I u;
          if (source<I>(j, w, pl, pr, kc, sc, u))
            acc += Bits<S>::to_float(plane[t * wo + u]);
        }
      }
    }
  }
  return Bits<S>::from_float(acc);
}

// (one block an SM at least: ptxas otherwise held the 64-bit bfloat16
// variant to 64 registers and spilled)
template <typename S, typename I>
__global__ void __launch_bounds__(kThreads, 1)
reflect_pad_bwd_kernel(const S* __restrict__ dy, S* __restrict__ dx, const PadShape s) {
  constexpr int V = Bits<S>::kVec;
  const I h = static_cast<I>(s.h), w = static_cast<I>(s.w);
  const I ho = static_cast<I>(s.ho), wo = static_cast<I>(s.wo);
  const I pt = static_cast<I>(s.pt), pb = static_cast<I>(s.pb);
  const I pl = static_cast<I>(s.pl), pr = static_cast<I>(s.pr);
  const I total = static_cast<I>(s.planes) * h * w;
  // vectors only where rows are whole vectors, so that none crosses a row
  const I nvec = s.vec ? total / V : 0;
  const I items = nvec + (total - nvec * V);
  for (I q = static_cast<I>(blockIdx.x) * kThreads + static_cast<I>(threadIdx.x);
       q < items; q += static_cast<I>(gridDim.x) * kThreads) {
    const I e = q < nvec ? q * V : q - nvec;
    const I row = divide<I>(e, s.by_w), j = e - row * w;
    const I p = divide<I>(row, s.by_h), i = row - p * h;
    const S* plane = dy + (p * ho + pt) * wo + pl;  // at (oh, ow) = (pt, pl)
    if (q >= nvec) {  // rows of odd length, a pad that reaches its axis, or an unaligned dx
      dx[e] = s.simple ? bwd_simple<S, I>(plane, i, j, s) : bwd_general<S, I>(plane, i, j, s);
      continue;
    }
    bool r0, r2;
    edges<I>(i, h, pt, pb, r0, r2);
    uint32_t out[4];
    if (!r0 && !r2) {  // an unfolded row: row i + pt holds every source
      const S* src = plane + i * wo;
#pragma unroll
      for (int k = 0; k < V; ++k) put(out, k, src[j + k]);
      if (j <= pl || j + V - 1 >= w - 1 - pr) {  // folded columns: add their others
#pragma unroll
        for (int k = 0; k < V; ++k) {
          bool c0, c2;
          edges<I>(j + k, w, pl, pr, c0, c2);
          if (!c0 && !c2) continue;
          // -(j + k), j + k, 2 (w - 1) - (j + k): (a + b) + c is (b + a) + c
          float acc = Bits<S>::to_float(get(out, k, S{}));
          if (c0) acc += Bits<S>::to_float(src[-(j + k)]);
          if (c2) acc += Bits<S>::to_float(src[2 * (w - 1) - (j + k)]);
          replace(out, k, Bits<S>::from_float(acc));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) put(out, k, bwd_simple<S, I>(plane, i, j + k, s));
    }
    store16(dx + e, out);
  }
}

unsigned blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename S>
cudaError_t launch(int op, const void* in, void* out, PadShape s, cudaStream_t stream) {
  constexpr int V = Bits<S>::kVec;
  const int64_t total = op == 0 ? s.planes * s.ho * s.wo : s.planes * s.h * s.w;
  const int64_t items = s.vec ? total / V + total % V : total;
  const unsigned grid = blocks_for(items);
  // 32-bit offsets where every offset and the grid's stride fit them
  const bool narrow = s.planes * s.ho * s.wo + int64_t{grid} * kThreads < INT32_MAX;
  const S* i = static_cast<const S*>(in);
  S* o = static_cast<S*>(out);
  if (op == 0) {
    if (narrow) reflect_pad_fwd_kernel<S, int32_t><<<grid, kThreads, 0, stream>>>(i, o, s);
    else reflect_pad_fwd_kernel<S, int64_t><<<grid, kThreads, 0, stream>>>(i, o, s);
  } else {
    if (narrow) reflect_pad_bwd_kernel<S, int32_t><<<grid, kThreads, 0, stream>>>(i, o, s);
    else reflect_pad_bwd_kernel<S, int64_t><<<grid, kThreads, 0, stream>>>(i, o, s);
  }
  return cudaGetLastError();
}

int run(int op, const void* in, void* out, int64_t planes, int64_t h, int64_t w,
        int64_t pt, int64_t pb, int64_t pl, int64_t pr, int dtype, int device,
        void* stream) {
  if ((dtype != 0 && dtype != 1) || planes < 1 || h < 1 || w < 1 || pt < 0 ||
      pb < 0 || pl < 0 || pr < 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PadShape s{planes, h, w, h + pt + pb, w + pl + pr, pt, pb, pl, pr, 0,
             pt < h && pb < h && pl < w && pr < w, aligned16(in),
             fast_div(h), fast_div(w), fast_div(h + pt + pb), fast_div(w + pl + pr)};
  const int v = dtype == 0 ? 4 : 8;
  // vectors where every pad is shorter than its axis; forward: every
  // vector of y (a flat copy target); backward: where a row of dx is whole
  // vectors
  s.vec = aligned16(out) && s.simple && (op == 0 || w % v == 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<uint32_t>(op, in, out, s, st)
                    : launch<uint16_t>(op, in, out, s, st);
}

}  // namespace

// x: (planes, h, w) contiguous, float (dtype 0) or bfloat16 (dtype 1); y:
// (planes, h + pt + pb, w + pl + pr) of the same type. Pads are >= 0 and may
// reach or pass the axis (repeated reflection). Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dig_reflect_pad_fwd(const void* x, void* y, int64_t planes, int64_t h,
                                   int64_t w, int64_t pt, int64_t pb, int64_t pl,
                                   int64_t pr, int dtype, int device, void* stream) {
  return run(0, x, y, planes, h, w, pt, pb, pl, pr, dtype, device, stream);
}

// dy: (planes, h + pt + pb, w + pl + pr) contiguous, float (dtype 0) or
// bfloat16 (dtype 1); dx: (planes, h, w) of the same type, each element the
// float32 sum of its sources in dy rounded once. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dig_reflect_pad_bwd(const void* dy, void* dx, int64_t planes, int64_t h,
                                   int64_t w, int64_t pt, int64_t pb, int64_t pl,
                                   int64_t pr, int dtype, int device, void* stream) {
  return run(1, dy, dx, planes, h, w, pt, pb, pl, pr, dtype, device, stream);
}
