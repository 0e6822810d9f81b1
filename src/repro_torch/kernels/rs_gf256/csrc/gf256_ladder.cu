// xtime-ladder GF(2^8) matrix product on Hopper: the A/B baseline of the
// codec's kernel (gf256_matmul.cu).
//
// Replaces: src/repro/kernels/rs_gf256/kernel.py::_rs_ladder_kernel
// (launched there by _call_ladder / gf256_matmul_pallas_ladder, reached
// through gf256_matmul(..., backend="ladder")).
//
// Computes OUT = G o X over GF(2^8), polynomial 0x11D:
//     OUT[i, c] = XOR_j  G[i, j] * X[j, c]
// by the TPU kernel's algorithm: each constant product by the branch-free
// xtime ladder of _gf_mul_const,
//     res = 0; a = x
//     for bit in 0..7:
//         res ^= a & -((c >> bit) & 1)          take the running multiple
//         a = xtime(a)                          shift, 0x1D where bit 7 was
// formed at run time from x: no product tables, no log/exp, no bit-plane
// operand. The running multiples x * 2^bit depend on the byte only, so
// they are built once per input row and shared by every output row of
// the row group, whose takes are the only per-row work.
//
// Arithmetic, four bytes per 32-bit word (SWAR; the reference keeps one
// byte per lane, the products are identical). The xtime of a word a:
//     msb = prmt(a, 0, 0xBA98)                0xFF in each byte with bit 7
//     a'  = ((a & 0x7F7F7F7F) << 1) ^ (msb & 0x1D1D1D1D)
// (a byte permute, two LOP3 and a shift the compiler gives the FMA pipe).
// A take of multiple x for a coefficient bit is either a mask, x & -bit,
// or a product, x * bit; two takes and the accumulator meet in one LOP3,
// acc ^ t1 ^ t2. Masks cost the integer ALU one LOP3 a take, products
// half a LOP3 and an IMAD, which issues to the FMA pipe: with 1-4 output
// rows the xtimes keep the ALU busy and every take is a product; with
// more rows the takes are most of the work, so bits 0-1 are masks and
// bits 2-7 products, and the two pipes share it (kMaskBits; chosen by
// measurement on an H100 over 0, 2 and 4 mask bits).
//
// Design. One thread owns one 16-byte column chunk of every input row. A
// row of X that is not 16-byte aligned (rows back to back at an odd L,
// column slices) is rebuilt from the two aligned 16-byte loads that cover
// the chunk, by funnel shifts; a block is read only if it holds a byte of
// the row. The next input row's chunk is loaded while the current one is
// worked. Per input row the thread walks the bits in pairs: it forms
// x * 2^(2p + 1) from x * 2^(2p) by one xtime of its 4 words, takes both
// into every output row of its group, and forms the next pair's first
// multiple, so only two multiples are live (80 registers at 10 rows,
// against 123 when all 8 were formed first). The takes, 0 / ~0 or 0 / 1
// for every coefficient of the group and bit, are warp-uniform: each
// block builds them once from the (m, k) int32 coefficients into shared
// memory (32 bytes a coefficient), read as one 8-byte broadcast load per
// output row and bit pair. Groups of ROWS = min(m, 16) output rows on
// gridDim.y. The output rows are 16-byte aligned with a pitch of at
// least L rounded up to 16 (the wrapper allocates them so), and are
// stored 16 bytes wide; the pad columns of the last chunk are written.
// The grid is kernel.py::launch_shape's, one chunk a thread.
//
// Bound on an H100 SXM: the bytes, (k + m) * L (37.6 us to encode (2,10)
// at a 100 MB object's chunk, 62.6 us for a (10,10) product); the kernel
// is issue-bound above that (7 xtimes and 8m takes per word and input
// row, on the ALU and FMA pipes). chip_smoke.py counts its integer
// instructions in its SASS (`gf_loop_ops`) and prints them beside the
// bound.
//
// The realignment helpers are copied from gf256_matmul.cu, so that this
// source is self-contained (kernels/_build.py keys a build by the hash of
// the .cu alone).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsMax = 256;
constexpr int kMaxRows = 16;

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

__device__ __forceinline__ const uint4* block_of(const uint8_t* row,
                                                 int* shift) {
  *shift = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u);
  return reinterpret_cast<const uint4*>(row - *shift);
}

// xtime of four packed bytes: each byte times 2 in GF(2^8) mod 0x11D.
// The sign-replicating byte permute gives 0xFF in every byte whose bit 7
// is set.
__device__ __forceinline__ uint32_t xtime4(uint32_t a) {
  uint32_t msb;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(msb) : "r"(a));
  return ((a & 0x7F7F7F7Fu) << 1) ^ (msb & 0x1D1D1D1Du);
}

__device__ __forceinline__ uint4 xtime4(uint4 a) {
  return make_uint4(xtime4(a.x), xtime4(a.y), xtime4(a.z), xtime4(a.w));
}

// acc ^ (x & s) ^ (y & t), word by word, s and t 0 or ~0: two masked
// takes, one LOP3 each.
__device__ __forceinline__ uint4 take_masks(uint4 acc, uint4 x, uint32_t s,
                                            uint4 y, uint32_t t) {
  return make_uint4(acc.x ^ (x.x & s) ^ (y.x & t),
                    acc.y ^ (x.y & s) ^ (y.y & t),
                    acc.z ^ (x.z & s) ^ (y.z & t),
                    acc.w ^ (x.w & s) ^ (y.w & t));
}

// acc ^ (x * u) ^ (y * v), word by word, u and v 0 or 1: two takes as
// products on the FMA pipe (IMAD), XORed in one LOP3.
__device__ __forceinline__ uint4 take_products(uint4 acc, uint4 x,
                                               uint32_t u, uint4 y,
                                               uint32_t v) {
  return make_uint4(acc.x ^ (x.x * u) ^ (y.x * v),
                    acc.y ^ (x.y * u) ^ (y.y * v),
                    acc.z ^ (x.z * u) ^ (y.z * v),
                    acc.w ^ (x.w * u) ^ (y.w * v));
}

// The coefficient bits taken by masks; the others are taken by products.
template <int ROWS>
constexpr int kMaskBits = ROWS > 4 ? 2 : 0;

template <int ROWS>
__global__ void __launch_bounds__(kThreadsMax)
gf256_ladder(const int* __restrict__ G,         // (m, k) int32
             const uint8_t* __restrict__ X, long long ldx,
             uint8_t* __restrict__ out, long long ldo, int m, int k,
             long long L) {
  constexpr int kMask = kMaskBits<ROWS>;
  // (k, 4, ROWS): for input row j, bit pair p and output row i, the takes
  // of bits 2p and 2p + 1 of G[r0 + i, j] (a mask 0 / ~0 below kMask, else
  // 0 / 1); rows past m take nothing and are never stored
  extern __shared__ uint2 takes[];
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, m - r0);
  uint32_t* words = reinterpret_cast<uint32_t*>(takes);
  for (int t = threadIdx.x; t < k * 8 * ROWS; t += blockDim.x) {
    const int i = (t >> 1) % ROWS, jp = (t >> 1) / ROWS;
    const int b = (jp & 3) * 2 + (t & 1);
    const int c = i < rows ? G[static_cast<long long>(r0 + i) * k +
                               (jp >> 2)] : 0;
    const uint32_t bit = (c >> b) & 1;
    words[t] = b < kMask ? 0u - bit : bit;
  }
  __syncthreads();

  const long long nchunks = (L + 15) >> 4;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < nchunks; c += step) {
    uint4 acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
    int shift;
    const uint4* blk = block_of(X, &shift);
    uint4 next = load_chunk(blk, shift, c, L);
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
      uint4 a = next;                           // x * 2^(2p)
      if (j + 1 < k) {                          // the next row in flight
        blk = block_of(X + (j + 1) * ldx, &shift);
        next = load_chunk(blk, shift, c, L);
      }
      const uint2* tj = takes + j * 4 * ROWS;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint4 a1 = xtime4(a);             // x * 2^(2p + 1)
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const uint2 t = tj[p * ROWS + i];
          acc[i] = 2 * p < kMask ? take_masks(acc[i], a, t.x, a1, t.y)
                                 : take_products(acc[i], a, t.x, a1, t.y);
        }
        if (p < 3) a = xtime4(a1);
      }
    }
    uint8_t* oc = out + 16 * c;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (i < rows)
        *reinterpret_cast<uint4*>(oc + (r0 + i) * ldo) = acc[i];
  }
}

template <int ROWS>
cudaError_t launch(const int* G, const uint8_t* X, long long ldx,
                   uint8_t* out, long long ldo, int m, int k, long long L,
                   int threads, int blocks, cudaStream_t stream) {
  const int groups = (m + ROWS - 1) / ROWS;
  const size_t smem = static_cast<size_t>(ROWS) * k * 4 * sizeof(uint2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf256_ladder<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gf256_ladder<ROWS><<<dim3(static_cast<unsigned>(blocks),
                            static_cast<unsigned>(groups)),
                       threads, smem, stream>>>(G, X, ldx, out, ldo, m, k,
                                                L);
  return cudaGetLastError();
}

}  // namespace

// G: (m, k) int32 coefficients (0..255) on the device. X: k rows of L
// bytes, row stride ldx bytes, any alignment. out: m rows of stride ldo;
// out and ldo 16-byte aligned and ldo >= L rounded up to 16 (every row's
// last chunk is stored whole). threads x blocks is the grid over 16-byte
// column chunks (kernel.py::launch_shape). Launches on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for operands it does not take
// (0 = success).
extern "C" int gf256_matmul_ladder(const void* G, const void* X,
                                   long long ldx, void* out, long long ldo,
                                   int m, int k, long long L, int threads,
                                   int blocks, void* stream) {
  if (L <= 0 || m <= 0) return 0;
  const long long padded = (L + 15) / 16 * 16;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0 || (ldo & 15) != 0 ||
      (m > 1 && ldo < padded) || threads <= 0 || threads > kThreadsMax ||
      blocks <= 0 || k <= 0 || k > 255 || m > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const int*>(G);
  const auto* x = static_cast<const uint8_t*>(X);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define GF256_LADDER_CASE(R) \
  case R:                    \
    return launch<R>(g, x, ldx, o, ldo, m, k, L, threads, blocks, s);
  switch (m < kMaxRows ? m : kMaxRows) {
    GF256_LADDER_CASE(1) GF256_LADDER_CASE(2) GF256_LADDER_CASE(3)
    GF256_LADDER_CASE(4) GF256_LADDER_CASE(5) GF256_LADDER_CASE(6)
    GF256_LADDER_CASE(7) GF256_LADDER_CASE(8) GF256_LADDER_CASE(9)
    GF256_LADDER_CASE(10) GF256_LADDER_CASE(11) GF256_LADDER_CASE(12)
    GF256_LADDER_CASE(13) GF256_LADDER_CASE(14) GF256_LADDER_CASE(15)
    default: return launch<kMaxRows>(g, x, ldx, o, ldo, m, k, L, threads,
                                     blocks, s);
  }
#undef GF256_LADDER_CASE
}
