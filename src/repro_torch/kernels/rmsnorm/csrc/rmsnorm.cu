// Fused RMSNorm over the last dimension, on Hopper.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::_kernel (launched there
// by rms_norm_pallas).
//
// Computes, for each row x of a (rows, d) input,
//     y = x * rsqrt(mean(x^2) + eps) * scale
// in f32, written back in x's type (f32 or bf16; the scale may be either
// type). The serving path calls it at d = 2048 (ln1, ln2 and the final
// norm of Qwen3-1.7B) and d = 128 (q_norm and k_norm, one row per token
// and head); training at d = 1024.
//
// Bound on an H100 SXM: bytes. Each element is read once and written
// once (2 * rows * d * sizeof(T), plus d * sizeof(S) for the scale) at
// 3.35 TB/s; the arithmetic (one fma for the sum of squares, two
// multiplies for the output, per element) is ~50x below the f32 rate.
//
// Design (the wrapper, kernel.py `plan`, picks the layout by width):
//  * Register tile (`rmsnorm_tile`). A row is read from HBM once: each
//    of its threads issues all of its 16-byte loads (V of them, V a
//    template argument up to 8) before the reduction, and scales and
//    stores from the same registers. Rows of at most 256 bytes share a
//    warp (`lanes` = 1..16 lanes per row, segmented shuffles), rows up
//    to 8 vectors per lane take one warp, and wider rows a group of up
//    to 8 warps that reduce through shared memory. Vector slots past
//    the row's end (d = 896 and 5120 bf16) load nothing. When the rows
//    are too few to give every SM a block (the decode step's 16 rows of
//    2048), a row is spread over up to 8 warps at one vector a lane.
//  * One row group per block. A persistent grid (blocks sized to the SMs
//    striding over the rows, each prefetching its next row) was built
//    and measured slower than this at the prefill shape: the hardware's
//    own block scheduling keeps as many rows in flight and leaves no
//    tail.
//  * The scale is widened to f32 into shared memory once per block, by
//    all of its threads together, while the first row's loads are in
//    flight (held per thread in registers it cost occupancy).
//  * Rows wider than the register tile (over 8 warps x 32 lanes x 8
//    vectors) and rows whose width or address does not allow 16-byte
//    access take `rmsnorm_loop`: one block per row, two passes (the
//    second read mostly from L2), vector or scalar loads.
// The TPU kernel's 256-row VMEM stripes and row padding have no
// counterpart: the grid covers the rows and masks the last group.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;   // 8 warps
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
struct Vec {
  static constexpr int N = 16 / int(sizeof(T));   // values per 16 bytes
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[N]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f32(e[j]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_f32<T>(f[j]);
    return u;
  }
};

// Row `row` of x into `v`: vector slot k of this thread is the 16-byte
// vector t + k * tpr of the row; slots past the row (or rows past the
// end) are zero, which adds nothing to the sum of squares.
template <typename T, int V>
__device__ __forceinline__ void load_row(uint4 (&v)[V],
                                         const T* __restrict__ x,
                                         long long row, long long rows,
                                         int d, int nvec, int t, int tpr) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = t + k * tpr;
    v[k] = (row < rows && j < nvec) ? __ldg(xr + j) : make_uint4(0, 0, 0, 0);
  }
}

// The scale values under one 16-byte vector of T (8, 16 or 32 bytes of
// S), widened to f32 into `f`.
template <typename T, typename S>
__device__ __forceinline__ void load_scale(const S* __restrict__ p,
                                           float* f) {
  constexpr int kBytes = Vec<T>::N * int(sizeof(S));
  using Chunk = std::conditional_t<(kBytes >= 16), uint4, uint2>;
  constexpr int kPer = int(sizeof(Chunk) / sizeof(S));
#pragma unroll
  for (int i = 0; i < kBytes / int(sizeof(Chunk)); ++i) {
    const Chunk u = __ldg(reinterpret_cast<const Chunk*>(p) + i);
    const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) f[i * kPer + j] = to_f32(e[j]);
  }
}

// Register tile: `rpb` rows per block, each row on `lanes` x `warps`
// threads (lanes < 32 only with warps == 1); one row group per block
// (the grid covers them; it strides only past the grid's limit).
// Dynamic shared memory: the scale in f32, d floats, loaded and widened
// by the block's threads together once, while the first row's loads are
// in flight.
template <typename T, typename S, int V>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_tile(const T* __restrict__ x, const S* __restrict__ scale,
                 T* __restrict__ out, long long rows, int d, float eps,
                 int lanes, int warps, int rpb) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem_f4[];
  float* sc = reinterpret_cast<float*>(smem_f4);
  __shared__ float red[2][kMaxWarps];
  const int tpr = lanes * warps;
  const int tid = threadIdx.x;
  const int r = tid / tpr;                 // row within the block
  const int t = tid - r * tpr;             // thread within the row
  const int nvec = d / N;
  const long long groups = (rows + rpb - 1) / rpb;
  int it = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
    const long long row = g * rpb + r;
    uint4 cur[V];
    load_row<T, V>(cur, x, row, rows, d, nvec, t, tpr);
    if (it == 0) {                         // beside the first row's loads
      for (int j = tid; j < nvec; j += blockDim.x)
        load_scale<T, S>(scale + j * N, sc + j * N);
      __syncthreads();
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float f[N];
      Vec<T>::unpack(cur[k], f);
#pragma unroll
      for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);
    }
    for (int o = lanes >> 1; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (warps > 1) {                       // rpb == 1: the block is the row
      if ((tid & 31) == 0) red[it & 1][tid >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < warps; ++w) ss += red[it & 1][w];
    }
    // correctly rounded sqrt and divide (no fast-math), as lax.rsqrt on f32
    const float rs = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = t + k * tpr;
        if (j < nvec) {
          float f[N];
          Vec<T>::unpack(cur[k], f);
          const float* s = sc + j * N;
#pragma unroll
          for (int e = 0; e < N; ++e) f[e] = (f[e] * rs) * s[e];
          yr[j] = Vec<T>::pack(f);
        }
      }
    }
  }
}

// Any width: one row per block at a time, two passes over the row, with
// 16-byte (kVec) or scalar loads.
template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_loop(const T* __restrict__ x, const S* __restrict__ scale,
                 T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][kMaxWarps];
  const int tid = threadIdx.x;
  const int nw = blockDim.x >> 5;
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const T* xr = x + row * d;
    T* yr = out + row * d;
    float ss = 0.f;
    if constexpr (kVec) {
      for (int j = tid; j < d / N; j += blockDim.x) {
        float f[N];
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xr) + j), f);
#pragma unroll
        for (int e = 0; e < N; ++e) ss = fmaf(f[e], f[e], ss);
      }
    } else {
      for (int c = tid; c < d; c += blockDim.x) {
        const float f = to_f32(xr[c]);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) red[it & 1][tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < nw; ++w) ss += red[it & 1][w];
    const float rs = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    if constexpr (kVec) {
      for (int j = tid; j < d / N; j += blockDim.x) {
        float f[N];
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xr) + j), f);
#pragma unroll
        for (int e = 0; e < N; ++e)
          f[e] = (f[e] * rs) * to_f32(scale[j * N + e]);
        reinterpret_cast<uint4*>(yr)[j] = Vec<T>::pack(f);
      }
    } else {
      for (int c = tid; c < d; c += blockDim.x)
        yr[c] = from_f32<T>((to_f32(xr[c]) * rs) * to_f32(scale[c]));
    }
  }
}

constexpr long long kMaxGrid = 0x7fffffffLL;   // gridDim.x's limit

template <typename T, typename S, int V>
int launch_tile(const void* x, const void* scale, void* out, long long rows,
                int d, float eps, int lanes, int warps, int rpb, int threads,
                cudaStream_t stream) {
  auto kernel = rmsnorm_tile<T, S, V>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {                  // rows past 12288 values
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long groups = (rows + rpb - 1) / rpb;
  kernel<<<static_cast<unsigned>(groups < kMaxGrid ? groups : kMaxGrid),
           threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, eps, lanes, warps, rpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, bool kVec>
int launch_loop(const void* x, const void* scale, void* out, long long rows,
                int d, float eps, int threads, cudaStream_t stream) {
  rmsnorm_loop<T, S, kVec><<<static_cast<unsigned>(
                                 rows < kMaxGrid ? rows : kMaxGrid),
                             threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows,
           int d, float eps, int kind, int vec, int lanes, int warps, int rpb,
           int threads, cudaStream_t s) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 1) return launch_loop<T, S, true>(x, scale, out, rows, d, eps,
                                                threads, s);
  if (kind == 2) return launch_loop<T, S, false>(x, scale, out, rows, d, eps,
                                                 threads, s);
  if (kind != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      warps < 1 || warps > kMaxWarps || (warps > 1 && (lanes != 32 ||
                                                       rpb != 1)) ||
      rpb * lanes * warps != threads)
    return static_cast<int>(cudaErrorInvalidValue);
#define RMS_TILE(VV)                                                       \
  case VV:                                                                 \
    return launch_tile<T, S, VV>(x, scale, out, rows, d, eps, lanes, warps, \
                                 rpb, threads, s);
  switch (vec) {
    RMS_TILE(1)
    RMS_TILE(2)
    RMS_TILE(3)
    RMS_TILE(4)
    RMS_TILE(5)
    RMS_TILE(6)
    RMS_TILE(7)
    RMS_TILE(8)
  }
#undef RMS_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: (rows, d) contiguous, dtype code x_dtype (0 = float32,
// 1 = bfloat16); scale: (d,) contiguous, dtype code s_dtype. The layout
// comes from kernel.py's `plan`: kind 0 is the register tile (`vec`
// 16-byte vectors per lane, `lanes` x `warps` threads per row, `rpb`
// rows per block of `threads`), 1 the vector loop and 2 the scalar loop
// (`threads` per row). Kinds 0 and 1 need x, out and scale 16-byte
// aligned and d * sizeof(x) a multiple of 16. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int rmsnorm_forward(const void* x, const void* scale, void* out,
                               long long rows, int d, float eps,
                               int x_dtype, int s_dtype, int kind, int vec,
                               int lanes, int warps, int rpb, int threads,
                               void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, kind, vec,
                                lanes, warps, rpb, threads, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, kind,
                                        vec, lanes, warps, rpb, threads, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, kind,
                                        vec, lanes, warps, rpb, threads, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                 kind, vec, lanes, warps, rpb,
                                                 threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
