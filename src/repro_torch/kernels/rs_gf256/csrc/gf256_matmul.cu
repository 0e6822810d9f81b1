// GF(2^8) matrix product for Reed-Solomon coding on Hopper.
//
// Replaces: src/repro/kernels/rs_gf256/kernel.py::_rs_bitsliced_kernel
// (launched there by _call_bitsliced / gf256_matmul_bitsliced).
//
// Computes OUT = G o X over GF(2^8), polynomial 0x11D:
//     OUT[i, c] = XOR_j  G[i, j] * X[j, c]
// Encode multiplies by the Cauchy parity rows (m = p); degraded decode by
// the inverted survivor matrix (m = k), whose rows for surviving data
// chunks are unit rows (a copy of one survivor): RS(k+p) never has more
// than p rows that are not.
//
// A row plan made host-side from G (kernel.py::row_plan, cached with the
// operand) sorts the output rows into zero rows, unit rows (copies of
// input row j) and dense rows; a dense row drops its zero coefficients
// and XORs the input where its coefficient is 1.
//
// Arithmetic. Multiplication by a constant c is GF(2)-linear in the bits
// of x, so c*x = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6] with
// T0[i] = c*i, T1[i] = c*(i << 3), T2[i] = c*(i << 6). T0 and T1 hold 8
// bytes (two 32-bit words) and T2 4 bytes (one word), so each lookup is
// one byte permute (PRMT) of 4 payload bytes at once, its selector
// nibbles taken from the payload bytes. Per 4-byte word and coefficient:
// 3 PRMT and the XORs; per word and input row: the three selectors
// (one PRMT and 11 shift/and/or), shared by every dense row.
// Bit-identical to the bit-sliced TPU kernel and to gf_matmul_np.
//
// Design. One thread owns a 16-byte column chunk of every input row: it
// loads the k rows' chunks (16-byte loads, all issued before any
// arithmetic), stores the unit rows straight from those registers and
// accumulates the dense rows in registers, storing 16 bytes per row. A
// row of X that is not 16-byte aligned (the codec's rows are; a column
// slice of them need not be) is read as the two aligned 16-byte blocks
// that cover the chunk, realigned in registers with funnel shifts; a
// block is read only if it holds a byte of the row, so no load leaves
// the 16-byte blocks the row touches. The output rows are 16-byte
// aligned with a pitch of at least L rounded up to 16 (the wrapper
// allocates them so); the pad columns of the last chunk are written.
//
// Two kernels:
// - gf256_small<K, D>: the store's shapes, k in {4, 10}, m <= 16, at most
//   2 dense rows (every RS(10+2) and RS(4+2) encode and decode). The
//   plan and the dense rows' tables (400 bytes) travel by value as a
//   __grid_constant__ parameter: every table word is a warp-uniform
//   constant-bank operand, not a shared-memory load.
// - gf256_general: any m, k up to 255 and any G. Groups of kRows output
//   rows on gridDim.y; each group's tables and coefficient kinds sit in
//   shared memory (32 bytes a coefficient, two 16-byte broadcast loads
//   per coefficient and chunk, i.e. per 4 words).
//
// Bounds on an H100 SXM (3.35 TB/s HBM3): (k + m) * L bytes, each input
// byte read once and each output byte written once. At a 100 MB
// object's chunk (L = 10,485,761): 37.6 us to encode (2,10), 62.6 us to
// decode (10,10). Integer work, counted in the SASS of the store's
// aligned instantiations (scripts/sass_ops.py; integer-datapath
// instructions per thread and 16-byte chunk in the grid-stride loop, a
// static count): 1192 at k = 10 with 2 dense rows (the encode; 46.7 us
// at the int32 peak, so the encode is as much issue-bound as
// byte-bound), 863 with 1 dense row and 9 copies (a one-lost decode;
// 33.8 us, under its bytes), 487 at k = 4 with 2 dense rows. Bit-planes
// from the constant bank (masks by shift and sign-replicating PRMT; 8
// and-xors per coefficient and word) were measured slower than these
// tables at the encode and equal at the decode. chip_smoke.py prints
// each product's time beside its byte bound and these counts.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsMax = 256;
constexpr int kSmallDense = 2;   // dense rows of gf256_small
constexpr int kSmallK = 10;      // input rows of gf256_small, at most
constexpr int kSmallM = 16;      // output rows of gf256_small, at most
constexpr int kRows = 8;         // output rows per group, gf256_general
constexpr int kTableWords = 5;   // T0 (2 words), T1 (2), T2 (1)

// Mirrors kernel.py::small_plan_words, word for word.
struct SmallPlan {
  uint32_t tab[kSmallDense][kSmallK][kTableWords];  // dense rows' tables
  uint32_t kinds[kSmallDense];  // 2 bits per input row: 0 zero, 1 one,
                                // 2 a table product
  uint32_t copies[kSmallK];     // bit i: output row i copies input row j
  uint32_t zeros;               // bit i: output row i is zero
  int32_t dense_row[kSmallDense];  // output row of each dense row
};
constexpr int kSmallPlanWords = sizeof(SmallPlan) / sizeof(uint32_t);
static_assert(kSmallPlanWords == 115, "kernel.py::SMALL_PLAN_WORDS");

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// The three lookup selectors of one word: nibble n of sN indexes the
// table with bits of payload byte n. Byte n sits at bit 8n and its
// nibble belongs at bit 4n; swapping bytes 1 and 2 first lets one shift
// by 12 put all four nibbles in place (bits 16 and up are not read).
struct Sel {
  uint32_t s0, s1, s2;
};

__device__ __forceinline__ Sel selectors(uint32_t x) {
  const uint32_t xs = prmt(x, 0u, 0x3120u);
  const uint32_t t0 = xs & 0x07070707u;
  const uint32_t t1 = (xs >> 3) & 0x07070707u;
  const uint32_t t2 = (xs >> 6) & 0x03030303u;
  return {t0 | (t0 >> 12), t1 | (t1 >> 12), t2 | (t2 >> 12)};
}

__device__ __forceinline__ uint32_t mul(uint32_t t0a, uint32_t t0b,
                                        uint32_t t1a, uint32_t t1b,
                                        uint32_t t2, const Sel& s) {
  return prmt(t0a, t0b, s.s0) ^ prmt(t1a, t1b, s.s1) ^ prmt(t2, t2, s.s2);
}

__device__ __forceinline__ uint4 mul4(const uint32_t* t, const Sel* s) {
  return make_uint4(mul(t[0], t[1], t[2], t[3], t[4], s[0]),
                    mul(t[0], t[1], t[2], t[3], t[4], s[1]),
                    mul(t[0], t[1], t[2], t[3], t[4], s[2]),
                    mul(t[0], t[1], t[2], t[3], t[4], s[3]));
}

__device__ __forceinline__ void selectors4(uint4 x, Sel* s) {
  s[0] = selectors(x.x);
  s[1] = selectors(x.y);
  s[2] = selectors(x.z);
  s[3] = selectors(x.w);
}

__device__ __forceinline__ uint32_t fsr(uint32_t lo, uint32_t hi, int r) {
  return __funnelshift_r(lo, hi, r);
}

// Chunk c (columns 16c .. 16c+15) of a row that starts `shift` bytes
// into the 16-byte block `a`. Columns at or past L come back as
// whatever the covering blocks hold.
__device__ __forceinline__ uint4 load_chunk(const uint4* a, int shift,
                                            long long c, long long L) {
  const uint4 lo = __ldg(a + c);
  if (shift == 0) return lo;
  uint4 hi = make_uint4(0u, 0u, 0u, 0u);
  if (16 * c + 16 - shift < L) hi = __ldg(a + c + 1);
  const int r = (shift & 3) * 8;
  switch (shift >> 2) {
    case 0:
      return make_uint4(fsr(lo.x, lo.y, r), fsr(lo.y, lo.z, r),
                        fsr(lo.z, lo.w, r), fsr(lo.w, hi.x, r));
    case 1:
      return make_uint4(fsr(lo.y, lo.z, r), fsr(lo.z, lo.w, r),
                        fsr(lo.w, hi.x, r), fsr(hi.x, hi.y, r));
    case 2:
      return make_uint4(fsr(lo.z, lo.w, r), fsr(lo.w, hi.x, r),
                        fsr(hi.x, hi.y, r), fsr(hi.y, hi.z, r));
    default:
      return make_uint4(fsr(lo.w, hi.x, r), fsr(hi.x, hi.y, r),
                        fsr(hi.y, hi.z, r), fsr(hi.z, hi.w, r));
  }
}

__device__ __forceinline__ void store_chunk(uint8_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ const uint4* block_of(const uint8_t* row,
                                                 int* shift) {
  *shift = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u);
  return reinterpret_cast<const uint4*>(row - *shift);
}

// ALIGNED: X and ldx are 16-byte aligned (the codec's stacked rows), so
// every chunk is one 16-byte load and no row needs realigning.
template <int K, int D, bool ALIGNED>
__global__ void __launch_bounds__(kThreadsMax)
gf256_small(const __grid_constant__ SmallPlan P,
            const uint8_t* __restrict__ X, long long ldx,
            uint8_t* __restrict__ out, long long ldo, long long L) {
  const long long nchunks = (L + 15) >> 4;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < nchunks; c += step) {
    uint4 x[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (ALIGNED) {
        x[j] = __ldg(reinterpret_cast<const uint4*>(X + j * ldx) + c);
      } else {
        int shift;
        const uint4* a = block_of(X + j * ldx, &shift);
        x[j] = load_chunk(a, shift, c, L);
      }
    }
    uint8_t* oc = out + 16 * c;
    for (uint32_t z = P.zeros; z; z &= z - 1)
      store_chunk(oc + (__ffs(z) - 1) * ldo, make_uint4(0u, 0u, 0u, 0u));
#pragma unroll
    for (int j = 0; j < K; ++j)
      for (uint32_t u = P.copies[j]; u; u &= u - 1)
        store_chunk(oc + (__ffs(u) - 1) * ldo, x[j]);
    uint4 acc[D > 0 ? D : 1];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t need = 0u;
#pragma unroll
      for (int d = 0; d < D; ++d)
        need |= ((P.kinds[d] >> (2 * j)) & 3u) == 2u;
      Sel s[4];
      if (need) selectors4(x[j], s);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const uint32_t kind = (P.kinds[d] >> (2 * j)) & 3u;
        if (kind == 1u) {
          acc[d] = acc[d] ^ x[j];
        } else if (kind == 2u) {
          acc[d] = acc[d] ^ mul4(P.tab[d][j], s);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      store_chunk(oc + P.dense_row[d] * ldo, acc[d]);
  }
}

// coef: (m, k, 2) uint4 — words 0-4 the tables of G[i, j], word 5 its
// kind (0 zero, 1 one, 2 a table product), words 6-7 zero.
__global__ void __launch_bounds__(kThreadsMax)
gf256_general(const uint4* __restrict__ coef,
              const uint8_t* __restrict__ X, long long ldx,
              uint8_t* __restrict__ out, long long ldo, int m, int k,
              long long L) {
  extern __shared__ uint4 sc[];  // (rows, k, 2) of this row group
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - r0);
  const uint4* g = coef + static_cast<long long>(r0) * k * 2;
  for (int t = threadIdx.x; t < rows * k * 2; t += blockDim.x) sc[t] = g[t];
  __syncthreads();

  const long long nchunks = (L + 15) >> 4;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < nchunks; c += step) {
    uint4 acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
    int shift;
    const uint4* a = block_of(X, &shift);
    uint4 next = load_chunk(a, shift, c, L);
    for (int j = 0; j < k; ++j) {
      const uint4 x = next;
      if (j + 1 < k) {                      // the next row's chunk in flight
        a = block_of(X + (j + 1) * ldx, &shift);
        next = load_chunk(a, shift, c, L);
      }
      Sel s[4];
      selectors4(x, s);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < rows) {
          const uint4 t = sc[(i * k + j) * 2];
          const uint4 u = sc[(i * k + j) * 2 + 1];
          if (u.y == 1u) {
            acc[i] = acc[i] ^ x;
          } else if (u.y == 2u) {
            acc[i] = acc[i] ^ make_uint4(mul(t.x, t.y, t.z, t.w, u.x, s[0]),
                                         mul(t.x, t.y, t.z, t.w, u.x, s[1]),
                                         mul(t.x, t.y, t.z, t.w, u.x, s[2]),
                                         mul(t.x, t.y, t.z, t.w, u.x, s[3]));
          }
        }
      }
    }
    uint8_t* oc = out + 16 * c;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows) store_chunk(oc + (r0 + i) * ldo, acc[i]);
  }
}


template <int K, int D>
cudaError_t launch_small(const SmallPlan& plan, const uint8_t* X,
                         long long ldx, uint8_t* out, long long ldo,
                         long long L, int threads, int blocks,
                         cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(X) & 15u) == 0 && (ldx & 15) == 0;
  if (aligned)
    gf256_small<K, D, true><<<blocks, threads, 0, stream>>>(plan, X, ldx,
                                                           out, ldo, L);
  else
    gf256_small<K, D, false><<<blocks, threads, 0, stream>>>(plan, X, ldx,
                                                            out, ldo, L);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_small_k(int dense, const SmallPlan& plan,
                           const uint8_t* X, long long ldx, uint8_t* out,
                           long long ldo, long long L, int threads,
                           int blocks, cudaStream_t stream) {
  if (dense == 0)
    return launch_small<K, 0>(plan, X, ldx, out, ldo, L, threads, blocks,
                              stream);
  if (dense == 1)
    return launch_small<K, 1>(plan, X, ldx, out, ldo, L, threads, blocks,
                              stream);
  return launch_small<K, 2>(plan, X, ldx, out, ldo, L, threads, blocks,
                            stream);
}

}  // namespace

// X: k rows of L bytes, row stride ldx bytes, any alignment. out: m rows
// of stride ldo; out and ldo 16-byte aligned and ldo >= L rounded up to
// 16 (every row's last chunk is stored whole).
// small_plan (host memory, kSmallPlanWords words) non-null: the store's
// path, k in {4, 10}, m <= 16, `dense` <= 2 dense rows; coef unused.
// small_plan null: the general path, coef the (m, k, 8)-word device
// operand. threads x blocks is the grid over 16-byte column chunks
// (kernel.py::launch_shape). Launches on `stream`, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for operands it does not take (0 = success).
extern "C" int gf256_matmul_planned(const void* small_plan, const void* coef,
                                    const void* X, long long ldx, void* out,
                                    long long ldo, int m, int k, int dense,
                                    long long L, int threads, int blocks,
                                    void* stream) {
  if (L <= 0 || m <= 0) return 0;
  const long long padded = (L + 15) / 16 * 16;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0 || (ldo & 15) != 0 ||
      (m > 1 && ldo < padded) || threads <= 0 || threads > kThreadsMax ||
      blocks <= 0 || k <= 0 || k > 255 || m > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint8_t*>(X);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (small_plan != nullptr) {
    if (m > kSmallM || dense < 0 || dense > kSmallDense ||
        (k != 4 && k != kSmallK))
      return static_cast<int>(cudaErrorInvalidValue);
    SmallPlan plan;
    std::memcpy(&plan, small_plan, sizeof(plan));
    if (k == 4)
      return launch_small_k<4>(dense, plan, x, ldx, o, ldo, L, threads,
                               blocks, s);
    return launch_small_k<kSmallK>(dense, plan, x, ldx, o, ldo, L, threads,
                                   blocks, s);
  }
  const int groups = (m + kRows - 1) / kRows;
  const size_t smem = static_cast<size_t>(kRows) * k * 2 * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf256_general, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gf256_general<<<dim3(static_cast<unsigned>(blocks),
                       static_cast<unsigned>(groups)),
                  threads, smem, s>>>(static_cast<const uint4*>(coef), x, ldx,
                                      o, ldo, m, k, L);
  return static_cast<int>(cudaGetLastError());
}

