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
// Design (flash-decoding, a tile of TILE tokens at a time):
//  * One block of 8 warps takes one (sequence, kv head, head group,
//    split of the page walk); `GB` (1, 2, 4 or 8, a template argument)
//    query heads share it, so no registers go to heads that are not
//    there. The wrapper picks the splits to fill one wave at the
//    occupancy the kernel reaches (`paged_attention_blocks_per_sm`), and
//    a second kernel combines the splits' partial softmaxes; with one
//    split the block writes the output itself. (Folding the combine
//    into the last block of each group, behind a counter, was built and
//    measured slower: that block's merge lengthens the wave's tail.)
//  * The block loads its split's slice of block_table into shared
//    memory once (one lookup per page), then streams K and V through a
//    ring of kStages tiles in shared memory with 16-byte cp.async copies
//    (one commit group per tile; TILE = 64 tokens in bf16, 32 in f32,
//    so 32 KB of K and V per stage at hd = 128), so two tiles are in
//    flight while it computes on the third. Only rows below lens[b] are
//    copied.
//  * Per tile, the softmax is taken once: each thread dots its 16-byte
//    chunk of q with its RPT rows of K for all GB heads, one butterfly
//    over the row's lanes leaves every (row, head) score complete in one
//    lane (RPT * GB - 1 shuffles, not RPT * GB * log2 of the lanes), the
//    scores go to shared memory, one warp per head takes the tile's
//    max, one exp per (head, row) and the tile's sum, and each thread
//    rescales its accumulator once before it adds P.V for its rows.
//  * acc[GB][hd] is spread over the threads as (chunk of hd, group of
//    rows); the groups' sums meet in shared memory at the end.
//  * No gathered copy of the cache is made: the JAX model's decode step
//    gathers the whole pool into logical order on every step and layer.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;     // stages of the ring
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

// 16 bytes of T at p (16-byte aligned, global or shared) into f32.
template <typename T>
__device__ __forceinline__ void load_16(const T* p,
                                        float (&f)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < int(16 / sizeof(T)); ++j) f[j] = to_f32(e[j]);
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shapes and shared-memory plan of one instantiation.
template <typename T, int HD, int GB>
struct Plan {
  static constexpr int N = 16 / int(sizeof(T));   // values per chunk
  static constexpr int CPR = HD / N;              // chunks per row
  static constexpr int NGRP = kThreads / CPR;     // token groups
  static constexpr int TILE = 128 / int(sizeof(T));   // tokens per stage
  static constexpr int RPT = TILE > NGRP ? TILE / NGRP : 1;  // rows/thread
  static constexpr int M = RPT * GB;              // scores per thread
  static_assert(CPR >= 1 && CPR <= 32 && (CPR & (CPR - 1)) == 0,
                "hd must give 1..32 chunks of 16 bytes per row");
  static constexpr size_t kRing =
      size_t(kStages) * 2 * TILE * HD * sizeof(T);
  static constexpr size_t kRed = size_t(NGRP) * GB * HD * sizeof(float);
  static constexpr size_t kBuf = kRing > kRed ? kRing : kRed;
  // ring (reused for the final sums), scores [GB][TILE], m, l, corr
  // [GB] each, then `pages` table entries
  static size_t smem(int pages) {
    return kBuf + (size_t(GB) * TILE + 3 * GB) * sizeof(float) +
           size_t(pages) * sizeof(int);
  }
};

// Sums v[0..CNT) over the lanes of an aligned segment whose size is
// 2 * O, halving the values a lane holds at each step (a butterfly
// reduce-scatter: CNT - 1 shuffles where a plain reduce of each value
// takes CNT * log2(2 * O)). At the end a lane holds `out_count<CNT, O>`
// complete sums, those of values base.. where `base` is worked out by
// `scatter_base`; once one value is left, the remaining steps are plain
// xor-reductions.
template <int O, int CNT, int M>
__device__ __forceinline__ void butterfly(float (&v)[M], int lane) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<O / 2, H, M>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<O / 2, 1, M>(v, lane);
    }
  }
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads)
    paged_attn_partial(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ lens,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, T* __restrict__ out,
                       int P, int ps, int K, int G, int pages_per_split,
                       float scale) {
  using C = Plan<T, HD, GB>;
  constexpr int N = C::N, CPR = C::CPR, NGRP = C::NGRP, TILE = C::TILE;
  constexpr int RPT = C::RPT, M = C::M;
  // butterfly steps, the sums a lane ends with, and the plain steps
  constexpr int LB = ilog2(CPR) < ilog2(M) ? ilog2(CPR) : ilog2(M);
  constexpr int KEEP = M >> LB;
  constexpr int PLAIN = CPR >> LB;         // lanes that end equal
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* sp = reinterpret_cast<float*>(smem + C::kBuf);   // [GB][TILE]
  float* sm = sp + GB * TILE;
  float* sl = sm + GB;
  float* scorr = sl + GB;
  int* tbl = reinterpret_cast<int*>(scorr + GB);

  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int ng = (G + GB - 1) / GB;
  const int kvh = blockIdx.y / ng;
  const int g0 = (blockIdx.y % ng) * GB;
  const int gl = min(GB, G - g0);          // block-uniform
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c = tid % CPR;                 // chunk of hd
  const int tg = tid / CPR;                // group of tokens
  const int len = min(__ldg(lens + b), P * ps);
  const int p0 = split * pages_per_split;
  const int t0 = p0 * ps;
  const int t1 = min(t0 + pages_per_split * ps, len);
  const int H = K * G;
  const size_t pbase = (static_cast<size_t>(b * K + kvh) * S + split) * G +
                       g0;
  T* outb = out + (static_cast<size_t>(b) * H + kvh * G + g0) * HD;

  if (t1 <= t0) {  // no valid position: a partial that weighs nothing
    for (int idx = tid; idx < gl * HD; idx += kThreads) {
      const int g = idx / HD, d = idx - g * HD;
      if (S == 1) {
        outb[idx] = from_f32<T>(0.f);
      } else {
        part_acc[(pbase + g) * HD + d] = 0.f;
        if (d == 0) {
          part_ml[(pbase + g) * 2] = kMaskValue;
          part_ml[(pbase + g) * 2 + 1] = 0.f;
        }
      }
    }
    return;
  }

  const int npages = (t1 - t0 + ps - 1) / ps;
  for (int i = tid; i < npages; i += kThreads)
    tbl[i] = __ldg(table + static_cast<size_t>(b) * P + p0 + i);
  if (tid < GB) {
    sm[tid] = kMaskValue;
    sl[tid] = 0.f;
  }
  __syncthreads();

  // copy tile i's valid rows of K and V into stage i % kStages
  const int ntiles = (t1 - t0 + TILE - 1) / TILE;
  auto issue = [&](int i) {
    T* kd = ring + static_cast<size_t>(i % kStages) * 2 * TILE * HD;
    T* vd = kd + TILE * HD;
    const int tb = t0 + i * TILE;
#pragma unroll
    for (int idx = tid; idx < TILE * CPR; idx += kThreads) {
      const int row = idx / CPR;
      const int cc = idx - row * CPR;
      const int t = tb + row;
      if (t < t1) {
        const int lp = t / ps;
        const int off = t - lp * ps;
        const size_t src =
            (((static_cast<size_t>(b) * P + tbl[lp - p0]) * ps + off) * K +
             kvh) * HD + cc * N;
        cp_async_16(kd + row * HD + cc * N, kp + src);
        cp_async_16(vd + row * HD + cc * N, vp + src);
      }
    }
  };

  float qf[GB][N], acc[GB][N];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gl) {
      load_16<T>(q + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * HD +
                     c * N,
                 qf[g]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) qf[g][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) acc[g][j] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) issue(i);
    cp_async_commit();
  }
  const int warp = tid >> 5, lane = tid & 31;
  // the scores this lane ends with: (row u, head g) pairs base.. base +
  // KEEP - 1, u * GB + g; one lane of each PLAIN writes them
  const int base = (c / PLAIN) * KEEP;
  const bool writer = c % PLAIN == 0;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();          // this thread's copies of tile i
    __syncthreads();                       // everyone's; tile i-1 is done
    if (i + kStages - 1 < ntiles) issue(i + kStages - 1);
    cp_async_commit();
    const T* ks = ring + static_cast<size_t>(i % kStages) * 2 * TILE * HD;
    const T* vs = ks + TILE * HD;
    const int n = min(TILE, t1 - (t0 + i * TILE));   // valid rows

    // scores of the thread's RPT rows x GB heads: loads first, then the
    // dot products, then one butterfly over the row's CPR lanes
    float kf[RPT][N];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int row = tg + u * NGRP;
      if (row < n) {
        load_16<T>(ks + row * HD + c * N, kf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) kf[u][j] = 0.f;
      }
    }
    float s[M];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) a = fmaf(qf[g][j], kf[u][j], a);
        s[u * GB + g] = a;
      }
    }
    butterfly<CPR / 2, M, M>(s, lane);
    if (writer) {
#pragma unroll
      for (int k = 0; k < KEEP; ++k) {
        const int u = (base + k) / GB, g = (base + k) % GB;
        const int row = tg + u * NGRP;
        if (row < n && g < gl) sp[g * TILE + row] = s[k] * scale;
      }
    }
    __syncthreads();

    // one max, one exp per (head, row) and one rescale per tile
    for (int g = warp; g < gl; g += kThreads / 32) {
      float* srow = sp + g * TILE;
      float mx = kMaskValue;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // P.V for the thread's rows, loads first
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gl) {
        const float corr = scorr[g];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[g][j] *= corr;
      }
    }
    float vf[RPT][N];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int row = tg + u * NGRP;
      if (row < n) load_16<T>(vs + row * HD + c * N, vf[u]);
    }
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int row = tg + u * NGRP;
      if (row < n) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < gl) {
            const float p = sp[g * TILE + row];
#pragma unroll
            for (int j = 0; j < N; ++j)
              acc[g][j] = fmaf(p, vf[u][j], acc[g][j]);
          }
        }
      }
    }
  }

  // the token groups' sums meet in the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);       // [NGRP][GB][HD]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gl) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        red[(tg * GB + g) * HD + c * N + j] = acc[g][j];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gl * HD; idx += kThreads) {
    const int g = idx / HD, d = idx - g * HD;
    float a = 0.f;
    for (int r = 0; r < NGRP; ++r) a += red[(r * GB + g) * HD + d];
    if (S == 1) {
      outb[idx] = from_f32<T>(a / fmaxf(sl[g], 1e-30f));
    } else {
      part_acc[(pbase + g) * HD + d] = a;
      if (d == 0) {
        part_ml[(pbase + g) * 2] = sm[g];
        part_ml[(pbase + g) * 2 + 1] = sl[g];
      }
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

// Lets the partial kernel take `smem` bytes of dynamic shared memory.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD, int GB>
int blocks_per_sm(int pages, int* out) {
  auto kernel = paged_attn_partial<T, HD, GB>;
  const size_t smem = Plan<T, HD, GB>::smem(pages);
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                      smem);
  return static_cast<int>(e);
}

template <typename T, int HD, int GB>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lens, void* part_acc, void* part_ml, void* out,
           int B, int P, int ps, int K, int G, int splits,
           int pages_per_split, float scale, cudaStream_t stream) {
  auto kernel = paged_attn_partial<T, HD, GB>;
  const size_t smem = Plan<T, HD, GB>::smem(pages_per_split);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ng = (G + GB - 1) / GB;
  dim3 grid(splits, K * ng, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<T*>(out), P, ps, K, G,
      pages_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  paged_attn_combine<T><<<B * K, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<T*>(out), K, G, splits,
      HD);
  return static_cast<int>(cudaGetLastError());
}

// Return CALL(T, HD, GB) for the run-time dtype, hd and gb.
#define PA_GB(T, HD, CALL)                              \
  switch (gb) {                                         \
    case 1: return CALL(T, HD, 1);                      \
    case 2: return CALL(T, HD, 2);                      \
    case 4: return CALL(T, HD, 4);                      \
    case 8: return CALL(T, HD, 8);                      \
  }                                                     \
  break;
#define PA_HD(T, CALL)                                  \
  switch (hd) {                                         \
    case 8: PA_GB(T, 8, CALL)                           \
    case 16: PA_GB(T, 16, CALL)                         \
    case 32: PA_GB(T, 32, CALL)                         \
    case 64: PA_GB(T, 64, CALL)                         \
    case 128: PA_GB(T, 128, CALL)                       \
  }
#define PA_DISPATCH(CALL)                               \
  if (dtype == 0) {                                     \
    PA_HD(float, CALL)                                  \
  } else if (dtype == 1) {                              \
    PA_HD(__nv_bfloat16, CALL)                          \
  }                                                     \
  return static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Blocks of the partial kernel for (hd, gb query heads per block, dtype)
// that fit on one SM when a split covers `pages` pages; into *out.
// Returns a CUDA error code (0 = success).
extern "C" int paged_attention_blocks_per_sm(int hd, int gb, int dtype,
                                             int pages, int* out) {
  if (pages <= 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define PA_OCC(T, HD, GB) blocks_per_sm<T, HD, GB>(pages, out)
  PA_DISPATCH(PA_OCC)
#undef PA_OCC
}

// q (B, K*G, hd), k/v (B, P, ps, K, hd): contiguous, 16-byte aligned,
// dtype code 0 = float32, 1 = bfloat16, hd in {8, 16, 32, 64, 128};
// table (B, P) int32, lens (B,) int32, on the card. A block takes gb
// (1, 2, 4 or 8) of a kv head's G query heads; each split covers
// pages_per_split pages. With splits > 1, part_acc (B, K, splits, G, hd)
// and part_ml (B, K, splits, G, 2) are f32 scratch and a combine kernel
// follows; with one split the partial kernel writes `out` itself (the
// scratch pointers are not read). Launches on `stream`; returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int paged_attention_forward(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, void* part_acc, void* part_ml, void* out, int B, int P,
    int ps, int K, int G, int gb, int hd, int splits, int pages_per_split,
    float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || G <= 0) return 0;
  if (P <= 0 || ps <= 0 || splits <= 0 || pages_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_RUN(T, HD, GB)                                                   \
  launch<T, HD, GB>(q, k, v, table, lens, part_acc, part_ml, out, B, P, ps, \
                    K, G, splits, pages_per_split, scale, s)
  PA_DISPATCH(PA_RUN)
#undef PA_RUN
}
