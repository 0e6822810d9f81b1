// Bit-sliced GF(2^8) matrix product for Reed-Solomon coding on Hopper.
//
// Replaces: src/repro/kernels/rs_gf256/kernel.py::_rs_bitsliced_kernel
// (launched there by _call_bitsliced / gf256_matmul_bitsliced).
//
// Computes OUT = G o X over GF(2^8), polynomial 0x11D:
//     OUT[i, c] = XOR_j  G[i, j] * X[j, c]
// Encode multiplies by the Cauchy parity rows (m = p = 2, k = 10);
// degraded decode multiplies by the inverted survivor matrix
// (m = k = 10).
//
// Arithmetic (identical to the TPU kernel, bit for bit): multiplication
// by a constant c is GF(2)-linear in the bits of x, so each coefficient
// expands host-side into 8 bit-planes plane[b] = c * 2^b, each byte
// replicated into a 32-bit word. Four payload bytes ride in one 32-bit
// word; for every input bit b,
//     mask = ((x >> b) & 0x01010101) * 0xFF     (0x00/0xFF per byte)
//     acc ^= mask & plane[b]
// with no data-dependent control flow.
//
// Design: one thread owns one 4-byte column word. It loads the X word of
// each of the k input rows ONCE and XOR-accumulates up to ROWS output
// rows in registers (the TPU grid re-read the stripe once per output
// row). Output rows beyond ROWS form row groups on gridDim.y. The
// planes of a row group (ROWS*k*8 words; 3.2 KB at m = k = 10) sit in
// shared memory and are read as warp-wide broadcasts.
//
// Layout: X is (k, L) uint8 with any row stride and any base
// alignment — the store hands in column-slice views of its stacked
// buffers, whose rows are generally not 4-byte aligned. A row that is
// 4-byte aligned is read with word loads; a misaligned row, and the
// ragged tail word when L % 4 != 0, are read byte by byte inside the
// kernel (no padded copy of the payload). The output is written the
// same way.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 32-bit integer ALU rate
// 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T ops/s):
//   bytes:  (k + m) * L  -> a 100 MB object in one 200 MB fragment gives
//           L ~ 10.5 MB: about 38 us to encode (k=10, m=2) and about
//           63 us to decode (k=10, m=10);
//   ops:    per 4-byte word and input row, 8 byte masks (shift, and,
//           multiply: 23 ops, bit 0 needs no shift) and one fused
//           and-xor (LOP3) per output row and bit (8m ops), so
//           k * (23 + 8m) / 4 32-bit integer ops per byte column
//           -> ~1.0 G ops to encode (~61 us), ~2.7 G ops to decode
//           (~162 us) at that L, so the kernel is ALU-bound rather than
//           bandwidth-bound.
// A shared-memory product-table or nibble-table (byte permute) design is
// the candidate for a faster version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLowBits = 0x01010101u;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2048;

__device__ __forceinline__ uint32_t load_word(const uint8_t* p,
                                              long long col, long long L,
                                              bool aligned) {
  if (aligned && col + 4 <= L) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t x = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (col + q < L) x |= static_cast<uint32_t>(p[q]) << (8 * q);
  }
  return x;
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t v,
                                           long long col, long long L,
                                           bool aligned) {
  if (aligned && col + 4 <= L) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (col + q < L) p[q] = static_cast<uint8_t>(v >> (8 * q));
  }
}

__device__ __forceinline__ bool is_aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0u;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
gf256_bitsliced_kernel(const uint32_t* __restrict__ planes,  // (m, k, 8)
                       const uint8_t* __restrict__ X, long long ldx,
                       uint8_t* __restrict__ out, long long ldo,
                       int m, int k, long long L) {
  extern __shared__ uint32_t sp[];  // (rows, k, 8) of this row group
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, m - r0);
  const int nplanes = rows * k * 8;
  const uint32_t* gp = planes + static_cast<long long>(r0) * k * 8;
  for (int t = threadIdx.x; t < nplanes; t += blockDim.x) sp[t] = gp[t];
  __syncthreads();

  const long long nwords = (L + 3) >> 2;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const int row_planes = k * 8;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < nwords; w += step) {
    const long long col = w << 2;
    uint32_t acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = 0u;
    for (int j = 0; j < k; ++j) {
      const uint8_t* xrow = X + j * ldx;
      const uint32_t x = load_word(xrow + col, col, L, is_aligned4(xrow));
      const uint32_t* pj = sp + j * 8;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t mask = ((x >> b) & kLowBits) * 0xFFu;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < rows) acc[i] ^= mask & pj[i * row_planes + b];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < rows) {
        uint8_t* orow = out + static_cast<long long>(r0 + i) * ldo;
        store_word(orow + col, acc[i], col, L, is_aligned4(orow));
      }
    }
  }
}

template <int ROWS>
cudaError_t launch(const uint32_t* planes, const uint8_t* X, long long ldx,
                   uint8_t* out, long long ldo, int m, int k, long long L,
                   cudaStream_t stream) {
  const long long nwords = (L + 3) / 4;
  long long blocks = (nwords + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int groups = (m + ROWS - 1) / ROWS;
  const size_t smem = static_cast<size_t>(ROWS) * k * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf256_bitsliced_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gf256_bitsliced_kernel<ROWS>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)),
         kThreads, smem, stream>>>(planes, X, ldx, out, ldo, m, k, L);
  return cudaGetLastError();
}

}  // namespace

// planes: (m, k, 8) uint32 byte-replicated bit-planes on the device.
// X: k rows of L bytes, row stride ldx bytes. out: m rows, stride ldo.
// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int gf256_matmul_bitsliced(const void* planes, const void* X,
                                      long long ldx, void* out,
                                      long long ldo, int m, int k,
                                      long long L, void* stream) {
  if (L <= 0 || m <= 0) return 0;
  const auto* p = static_cast<const uint32_t*>(planes);
  const auto* x = static_cast<const uint8_t*>(X);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= 2) return launch<2>(p, x, ldx, o, ldo, m, k, L, s);
  if (m <= 4) return launch<4>(p, x, ldx, o, ldo, m, k, L, s);
  if (m <= 8) return launch<8>(p, x, ldx, o, ldo, m, k, L, s);
  return launch<16>(p, x, ldx, o, ldo, m, k, L, s);
}
