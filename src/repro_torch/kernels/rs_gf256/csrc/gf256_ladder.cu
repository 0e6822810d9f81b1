// xtime-ladder GF(2^8) matrix product on Hopper: the A/B baseline of the
// bit-sliced kernel (gf256_matmul.cu).
//
// Replaces: src/repro/kernels/rs_gf256/kernel.py::_rs_ladder_kernel
// (launched there by _call_ladder / gf256_matmul_pallas_ladder, reached
// through gf256_matmul(..., backend="ladder")).
//
// Computes OUT = G o X over GF(2^8), polynomial 0x11D:
//     OUT[i, c] = XOR_j  G[i, j] * X[j, c]
// with the TPU kernel's arithmetic: one payload byte per 32-bit lane,
// and each constant product by the branch-free xtime ladder of
// _gf_mul_const,
//     res = 0; a = x
//     for bit in 0..7:
//         res ^= a & -((c >> bit) & 1)          take the running multiple
//         a = ((a << 1) & 0xFF) ^ (0x1D & -(a >> 7))      xtime, 0x1D fix
// The running multiple a = x * 2^bit depends on the byte only, so its
// chain is computed once per byte and input row and shared by the output
// rows, whose masked xors are the only per-row work.
//
// Design: one thread owns one 4-byte column word. It loads the X word of
// each of the k input rows ONCE, splits it into four int32 byte lanes,
// and XOR-accumulates all ROWS output rows of its row group in registers
// (ROWS = m for m <= 16, so no lane idles; larger m tiles into row
// groups of 16 on gridDim.y). The TPU kernel instead walked 1024-byte
// tiles in order and re-ran the whole ladder per (row, coefficient). The
// coefficients of the row group (ROWS * k int32) sit in shared memory and
// are read as warp-wide broadcasts; the take-masks are warp-uniform.
//
// Layout: X is (k, L) uint8 with any row stride and base alignment (the
// store's column-slice views); 4-byte aligned rows are read and written
// with word accesses, misaligned rows and the ragged tail word byte by
// byte, inside the kernel (no padded copy).
//
// Bound on an H100 SXM: operations. Per word, input row and bit the
// kernel does 4 xtimes (one per byte) and a masked xor per byte and
// output row, so it does about four times the integer work per byte of
// the bit-sliced kernel, which packs four bytes per word. chip_smoke.py
// counts the ops per word from this kernel's SASS (`ladder_ops`).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2048;
constexpr int kMaxRows = 16;

__device__ __forceinline__ bool is_aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0u;
}

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

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
gf256_ladder_kernel(const int* __restrict__ G,       // (m, k) int32
                    const uint8_t* __restrict__ X, long long ldx,
                    uint8_t* __restrict__ out, long long ldo,
                    int m, int k, long long L) {
  extern __shared__ int sg[];  // (ROWS, k) coefficients of this group
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, m - r0);
  // rows past m get coefficient 0: their accumulators stay 0 and are
  // never stored
  for (int t = threadIdx.x; t < ROWS * k; t += blockDim.x) {
    sg[t] = t < rows * k ? G[static_cast<long long>(r0) * k + t] : 0;
  }
  __syncthreads();

  const long long nwords = (L + 3) >> 2;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < nwords; w += step) {
    const long long col = w << 2;
    int acc[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0;
    }
    for (int j = 0; j < k; ++j) {
      const uint8_t* xrow = X + j * ldx;
      const uint32_t word = load_word(xrow + col, col, L, is_aligned4(xrow));
      int a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = (word >> (8 * q)) & 0xFF;
      int c[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) c[i] = sg[i * k + j];
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int take = -((c[i] >> bit) & 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] ^= a[q] & take;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = ((a[q] << 1) & 0xFF) ^ (0x1D & -((a[q] >> 7) & 1));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < rows) {
        const uint32_t v = static_cast<uint32_t>(acc[i][0]) |
                           (static_cast<uint32_t>(acc[i][1]) << 8) |
                           (static_cast<uint32_t>(acc[i][2]) << 16) |
                           (static_cast<uint32_t>(acc[i][3]) << 24);
        uint8_t* orow = out + static_cast<long long>(r0 + i) * ldo;
        store_word(orow + col, v, col, L, is_aligned4(orow));
      }
    }
  }
}

template <int ROWS>
cudaError_t launch(const int* G, const uint8_t* X, long long ldx,
                   uint8_t* out, long long ldo, int m, int k, long long L,
                   cudaStream_t stream) {
  const long long nwords = (L + 3) / 4;
  long long blocks = (nwords + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int groups = (m + ROWS - 1) / ROWS;
  const size_t smem = static_cast<size_t>(ROWS) * k * sizeof(int);
  gf256_ladder_kernel<ROWS>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)),
         kThreads, smem, stream>>>(G, X, ldx, out, ldo, m, k, L);
  return cudaGetLastError();
}

}  // namespace

// G: (m, k) int32 coefficients (0..255) on the device. X: k rows of L
// bytes, row stride ldx bytes. out: m rows, stride ldo. Launches on
// `stream`, does not synchronise, allocates nothing. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int gf256_matmul_ladder(const void* G, const void* X,
                                   long long ldx, void* out, long long ldo,
                                   int m, int k, long long L,
                                   void* stream) {
  if (L <= 0 || m <= 0) return 0;
  const auto* g = static_cast<const int*>(G);
  const auto* x = static_cast<const uint8_t*>(X);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (m < kMaxRows ? m : kMaxRows) {
    case 1: return launch<1>(g, x, ldx, o, ldo, m, k, L, s);
    case 2: return launch<2>(g, x, ldx, o, ldo, m, k, L, s);
    case 3: return launch<3>(g, x, ldx, o, ldo, m, k, L, s);
    case 4: return launch<4>(g, x, ldx, o, ldo, m, k, L, s);
    case 5: return launch<5>(g, x, ldx, o, ldo, m, k, L, s);
    case 6: return launch<6>(g, x, ldx, o, ldo, m, k, L, s);
    case 7: return launch<7>(g, x, ldx, o, ldo, m, k, L, s);
    case 8: return launch<8>(g, x, ldx, o, ldo, m, k, L, s);
    case 9: return launch<9>(g, x, ldx, o, ldo, m, k, L, s);
    case 10: return launch<10>(g, x, ldx, o, ldo, m, k, L, s);
    case 11: return launch<11>(g, x, ldx, o, ldo, m, k, L, s);
    case 12: return launch<12>(g, x, ldx, o, ldo, m, k, L, s);
    case 13: return launch<13>(g, x, ldx, o, ldo, m, k, L, s);
    case 14: return launch<14>(g, x, ldx, o, ldo, m, k, L, s);
    case 15: return launch<15>(g, x, ldx, o, ldo, m, k, L, s);
    default: return launch<16>(g, x, ldx, o, ldo, m, k, L, s);
  }
}
