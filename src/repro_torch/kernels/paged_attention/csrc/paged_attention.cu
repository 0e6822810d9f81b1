// Single-token GQA decode attention over an SMS-paged KV pool, on Hopper.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py::_kernel
// (launched there by paged_decode_attention_pallas).
//
// Computes, for each sequence b and query head h = kvh * G + g,
//     out[b, h] = softmax_t(q[b, h] . k[b, t, kvh] / sqrt(hd)) @ v[b, t, kvh]
// over the logical positions t < lens[b], where logical page i of
// sequence b lives in physical page block_table[b, i] of its region of
// the pool: q (B, H, hd); k, v pools (B, P, ps, K, hd); f32 or bf16 in,
// the same type out. Softmax in f32 with a running max `m`, sum `l` and
// accumulator `acc`, as the Pallas body does; -1e30 is the reference's
// mask value.
//
// Bound on an H100 SXM: bytes. Every valid (b, t, kvh) row of K and V is
// read once — 2 * sum_b lens[b] * K * hd * sizeof(T) bytes, 138 MB per
// layer for Qwen3-1.7B at 16 sequences of 2112 tokens in bf16, ~41 us at
// 3.35 TB/s — against 2 * G flops per byte of cache, far below the
// card's ~20 f32 flops per byte.
//
// Design (flash-decoding):
//  * The TPU walks the pages of one sequence in order on one core. Here
//    one block takes one (sequence, kv head, split of the page walk):
//    at 16 sequences and 8 kv heads there are only 128 (b, kvh) pairs
//    for 132 SMs, so the walk is split until ~4 blocks per SM are in
//    flight, and a second kernel combines the splits' partial
//    softmaxes.
//  * Each block keeps the G query rows of its kv head (up to 4; more go
//    to further head groups on gridDim.y) in registers. Its 128 threads
//    form R token rows of hd / (16 / sizeof(T)) lanes each: a lane
//    reads 16 bytes of a K row and of a V row (8 bf16 or 4 f32 values),
//    neighbouring lanes on neighbouring addresses, and the row's lanes
//    reduce the dot product with warp shuffles. Each token row keeps its
//    own online softmax over every R-th token; the block merges its rows
//    through shared memory at the end and writes one partial (m, l, acc)
//    per split.
//  * The block looks each page up in block_table itself (the TPU
//    prefetched the table as scalars). Only positions below lens[b] are
//    read, so the pages past a sequence's end cost nothing, and a split
//    with no valid position writes l = 0, acc = 0, which the combine
//    weighs to nothing (no inf - inf, no NaN).
//  * No gathered copy of the cache is made: the JAX model's decode step
//    gathers the whole pool into logical order on every step and layer.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGMax = 4;       // query heads per kv head held by a block
constexpr int kUnroll = 2;     // tokens per row whose loads are in flight
constexpr float kMaskValue = -1e30f;

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

// 16 bytes of T at p (16-byte aligned) into f32 registers.
template <typename T>
__device__ __forceinline__ void load_16(const T* __restrict__ p,
                                        float (&f)[16 / sizeof(T)]) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < int(16 / sizeof(T)); ++j) f[j] = to_f32(e[j]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_partial(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ lens,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int P, int ps, int K,
                       int G, int pages_per_split, float scale) {
  constexpr int V = 16 / int(sizeof(T));   // values per 16-byte load
  constexpr int LPT = HD / V;              // lanes per token row
  constexpr int R = kThreads / LPT;        // token rows per block
  static_assert(LPT >= 1 && LPT <= 32 && (LPT & (LPT - 1)) == 0,
                "hd must give 1..32 lanes per token");
  __shared__ float sm_acc[R][kGMax][HD];
  __shared__ float sm_m[R][kGMax];
  __shared__ float sm_l[R][kGMax];

  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int ng = (G + kGMax - 1) / kGMax;
  const int kvh = blockIdx.y / ng;
  const int g0 = (blockIdx.y % ng) * kGMax;
  const int gl = min(kGMax, G - g0);       // block-uniform
  const int b = blockIdx.z;
  const int r = threadIdx.x / LPT;
  const int c = threadIdx.x % LPT;
  const int len = min(__ldg(lens + b), P * ps);
  const int t0 = split * pages_per_split * ps;
  const int t1 = min(t0 + pages_per_split * ps, len);
  const int H = K * G;

  float qf[kGMax][V];
  float m[kGMax], l[kGMax], acc[kGMax][V];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < gl) {
      load_16<T>(q + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * HD +
                     c * V,
                 qf[g]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) qf[g][j] = 0.f;
    }
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[g][j] = 0.f;
  }

  // Trip count is uniform across the block, so every lane of a row takes
  // part in its shuffles; positions past t1 load nothing and update
  // nothing.
  for (int tb = t0; tb < t1; tb += kUnroll * R) {
    float kf[kUnroll][V], vf[kUnroll][V];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = tb + u * R + r;
      valid[u] = t < t1;
      if (valid[u]) {
        const int page = t / ps;
        const int off = t - page * ps;
        const int phys = __ldg(table + static_cast<size_t>(b) * P + page);
        const size_t base =
            (((static_cast<size_t>(b) * P + phys) * ps + off) * K + kvh) *
                HD +
            c * V;
        load_16<T>(kp + base, kf[u]);
        load_16<T>(vp + base, vf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kf[u][j] = vf[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < gl) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) s = fmaf(qf[g][j], kf[u][j], s);
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (valid[u]) {
            s *= scale;
            const float m_new = fmaxf(m[g], s);
            const float corr = expf(m[g] - m_new);
            const float p = expf(s - m_new);
            l[g] = l[g] * corr + p;
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[g][j] = fmaf(acc[g][j], corr, p * vf[u][j]);
            m[g] = m_new;
          }
        }
      }
    }
  }

  // merge the block's R token rows into this split's partial
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < gl) {
#pragma unroll
      for (int j = 0; j < V; ++j) sm_acc[r][g][c * V + j] = acc[g][j];
      if (c == 0) {
        sm_m[r][g] = m[g];
        sm_l[r][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gl * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx - g * HD;
    float M = kMaskValue;
    for (int rr = 0; rr < R; ++rr) M = fmaxf(M, sm_m[rr][g]);
    float a = 0.f, den = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      const float w = expf(sm_m[rr][g] - M);
      a = fmaf(w, sm_acc[rr][g][d], a);
      den = fmaf(w, sm_l[rr][g], den);
    }
    const size_t o =
        (static_cast<size_t>(b * K + kvh) * S + split) * G + g0 + g;
    part_acc[o * HD + d] = a;
    if (d == 0) {
      part_ml[o * 2] = M;
      part_ml[o * 2 + 1] = den;
    }
  }
}

// One block per (b, kv head): merge the S splits' partials and write the
// normalised output in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_combine(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml, T* __restrict__ out,
                       int K, int G, int S, int hd) {
  const int bk = blockIdx.x;               // b * K + kvh
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    float M = kMaskValue;
    for (int s = 0; s < S; ++s)
      M = fmaxf(M, part_ml[((static_cast<size_t>(bk) * S + s) * G + g) * 2]);
    float a = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t o = (static_cast<size_t>(bk) * S + s) * G + g;
      const float w = expf(part_ml[o * 2] - M);
      a = fmaf(w, part_acc[o * hd + d], a);
      den = fmaf(w, part_ml[o * 2 + 1], den);
    }
    // (b, kvh, g) is query head kvh * G + g of sequence b
    out[(static_cast<size_t>(bk) * G + g) * hd + d] =
        from_f32<T>(a / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lens, void* part_acc, void* part_ml, void* out,
           int B, int P, int ps, int K, int G, int splits,
           int pages_per_split, float scale, cudaStream_t stream) {
  const int ng = (G + kGMax - 1) / kGMax;
  dim3 grid(splits, K * ng, B);
  paged_attn_partial<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), P, ps, K, G, pages_per_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attn_combine<T><<<B * K, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<T*>(out), K, G, splits,
      HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* table, const void* lens, void* part_acc,
                void* part_ml, void* out, int B, int P, int ps, int K, int G,
                int splits, int pps, float scale, cudaStream_t s) {
#define PA_CASE(HDV)                                                       \
  case HDV:                                                                \
    return launch<T, HDV>(q, k, v, table, lens, part_acc, part_ml, out, B, \
                          P, ps, K, G, splits, pps, scale, s);
  switch (hd) {
    PA_CASE(8)
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
  }
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, K*G, hd), k/v (B, P, ps, K, hd): contiguous, 16-byte aligned,
// dtype code 0 = float32, 1 = bfloat16, hd in {8, 16, 32, 64, 128};
// table (B, P) int32, lens (B,) int32, on the card. part_acc
// (B, K, splits, G, hd) and part_ml (B, K, splits, G, 2) are f32 scratch;
// each split covers pages_per_split pages. Launches the partial and the
// combine kernel on `stream`; returns cudaGetLastError() after them
// (0 = success).
extern "C" int paged_attention_forward(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, void* part_acc, void* part_ml, void* out, int B, int P,
    int ps, int K, int G, int hd, int splits, int pages_per_split,
    float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || G <= 0) return 0;
  if (P <= 0 || ps <= 0 || splits <= 0 || pages_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, table, lens, part_acc, part_ml,
                              out, B, P, ps, K, G, splits, pages_per_split,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, table, lens, part_acc,
                                      part_ml, out, B, P, ps, K, G, splits,
                                      pages_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
