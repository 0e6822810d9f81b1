// Fused RMSNorm over the last dimension, on Hopper.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::_kernel (launched there
// by rms_norm_pallas).
//
// Computes, for each row x of a (rows, d) input,
//     y = x * rsqrt(mean(x^2) + eps) * scale
// in f32, written back in x's type (f32 or bf16; the scale may be either
// type). The serving path calls it at two widths: d = 2048 (ln1, ln2 and
// the final norm of Qwen3-1.7B, one row per token) and d = 128 (q_norm
// and k_norm, one row per token and head).
//
// Bound on an H100 SXM: bytes. Each element is read once and written
// once (2 * rows * d * sizeof(T), plus d * sizeof(S) for the scale) at
// 3.35 TB/s; the arithmetic (one fma for the sum of squares, two
// multiplies for the output, per element) is ~50x below the f32 rate.
//
// Design: one warp per row, four rows per 128-thread block, so a row's
// reduction is a register sum plus five warp shuffles, with no shared
// memory and no block barrier. Each lane reads 16 bytes at a time
// (8 bf16 or 4 f32 values), neighbouring lanes on neighbouring
// addresses. The row is read twice — once for the sum of squares, once
// to scale it — and the second read comes from L1, which holds the
// row (4 KB at d = 2048 bf16). Rows whose width or base address does not
// allow 16-byte access take a scalar loop (`kVec` false); the wrapper
// chooses. The TPU kernel's 256-row VMEM stripes and row padding have no
// counterpart: blocks cover the rows, and the last block's spare warps
// return at once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// N values of type T at p (N * sizeof(T) a multiple of 8 bytes, p aligned
// to that) into f32 registers, with 16- or 8-byte loads.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&f)[N]) {
  constexpr int kBytes = N * int(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / int(sizeof(T));
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[i * kPer + j] = to_f32(e[j]);
    }
  } else {
    static_assert(kBytes % 8 == 0, "8-byte multiple expected");
    constexpr int kPer = 8 / int(sizeof(T));
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) {
      uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[i * kPer + j] = to_f32(e[j]);
    }
  }
}

// 16 bytes of T from f32 registers.
template <typename T>
__device__ __forceinline__ void store_16(T* __restrict__ p,
                                         const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < int(16 / sizeof(T)); ++j) e[j] = from_f32<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp: the row is warp-uniform
  const T* xr = x + row * d;
  T* yr = out + row * d;
  constexpr int V = 16 / int(sizeof(T));

  float ss = 0.f;
  if constexpr (kVec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float f[V];
      load_f32<T, V>(xr + c, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  // correctly rounded sqrt and divide (no fast-math), as lax.rsqrt on f32
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (kVec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float f[V], s[V];
      load_f32<T, V>(xr + c, f);
      load_f32<S, V>(scale + c, s);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] * r) * s[j];
      store_16<T>(yr + c, f);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      yr[c] = from_f32<T>((to_f32(xr[c]) * r) * to_f32(scale[c]));
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows,
           int d, float eps, int vec, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, S, true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(xp, sp, op, rows, d, eps);
  } else {
    rmsnorm_kernel<T, S, false><<<static_cast<unsigned>(blocks), kThreads,
                                  0, stream>>>(xp, sp, op, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous, dtype code x_dtype (0 = float32,
// 1 = bfloat16); scale: (d,) contiguous, dtype code s_dtype. vec != 0
// asks for 16-byte access: the caller guarantees that x, out and scale
// are 16-byte aligned and that d * sizeof(x) is a multiple of 16.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int rmsnorm_forward(const void* x, const void* scale, void* out,
                               long long rows, int d, float eps,
                               int x_dtype, int s_dtype, int vec,
                               void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, vec, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, vec, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, vec, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                 vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
