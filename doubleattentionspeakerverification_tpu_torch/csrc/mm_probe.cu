// Tiled matrix-product rate probe for Hopper (sm_90a): int8 x int8 -> int32
// and bf16 x bf16 -> float32 on the tensor cores.
//
// Replaces the Pallas TPU kernel `mm_kernel` / `pallas_mm` in
// tools/_mxu_rate.py, which timed the TPU's matrix unit at M = K = N = 4096.
//
// In:  a  (M, K) row-major, bt (N, K) row-major (B transposed, so both
//         operands are read along K), int8 or bf16
// Out: c  (M, N) = a @ bt^T, int32 for int8 inputs, float32 for bf16
//
// What bounds it on the H100: operations. At 4096^3 it does 2 * 4096^3
// operations on 96 MB (int8) or 128 MB (bf16) of operands and result, over
// 1,000 operations a byte.
//
// Design (simple; no TMA, no wgmma, no pipelining): one block of 8 warps per
// 128 x 128 tile of c. The K loop stages a 128 x 64-byte slab of a and of bt
// in shared memory (rows padded to 80 bytes, so the fragment loads of a
// warp's 8 lane groups fall into distinct banks) and runs 2 k-steps of
// `mma.sync` on it: m16n8k32 for int8, m16n8k16 for bf16. Both fragments
// hold the same bytes of a row (4 bytes at 4*(lane%4), and 16 bytes on), so
// one loop serves both types. Each warp owns a 32 x 64 tile: 2 x 8 mma tiles,
// 64 accumulators a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;
constexpr int SLAB = 64;            // bytes of K per stage
constexpr int ROW = SLAB + 16;      // padded shared row
constexpr int THREADS = 256;
constexpr int WM = 32, WN = 64;
constexpr int MT = WM / 16, NT = WN / 8;

template <bool INT8>
struct Acc;
template <>
struct Acc<true> { using T = int; };
template <>
struct Acc<false> { using T = float; };

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// k_bytes: bytes of one row of a and bt (K * element size), a multiple of 64.
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ bt,
          typename Acc<INT8>::T* __restrict__ c, int N, int k_bytes) {
  __shared__ __align__(16) unsigned char a_s[BM * ROW];
  __shared__ __align__(16) unsigned char b_s[BN * ROW];
  using T = typename Acc<INT8>::T;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  T acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = T(0);

  for (int k0 = 0; k0 < k_bytes; k0 += SLAB) {
    // 128 rows x 64 bytes of each operand: 512 16-byte pieces, 2 a thread
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * THREADS;
      const int r = i >> 2, piece = (i & 3) * 16;
      *reinterpret_cast<int4*>(a_s + r * ROW + piece) =
          *reinterpret_cast<const int4*>(a + (int64_t)(m0 + r) * k_bytes + k0 + piece);
      *reinterpret_cast<int4*>(b_s + r * ROW + piece) =
          *reinterpret_cast<const int4*>(bt + (int64_t)(n0 + r) * k_bytes + k0 + piece);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SLAB; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* r0 = a_s + (wm * WM + mt * 16 + g) * ROW + kk + tig * 4;
        const unsigned char* r1 = r0 + 8 * ROW;
        af[mt][0] = lds32(r0);
        af[mt][1] = lds32(r1);
        af[mt][2] = lds32(r0 + 16);
        af[mt][3] = lds32(r1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* rb = b_s + (wn * WN + nt * 8 + g) * ROW + kk + tig * 4;
        const uint32_t b0 = lds32(rb), b1 = lds32(rb + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * WM + mt * 16 + g + 8 * (i >> 1);
        const int n = n0 + wn * WN + nt * 8 + tig * 2 + (i & 1);
        c[(int64_t)m * N + n] = acc[mt][nt][i];
      }
}

}  // namespace

// is_int8: 1 for int8 inputs and an int32 c, 0 for bf16 inputs and a float32
// c. M and N multiples of 128, K * element size a multiple of 64 bytes.
extern "C" int mm_probe(const void* a, const void* bt, void* c, int M, int N, int K,
                        int is_int8, void* stream) {
  const int k_bytes = is_int8 ? K : 2 * K;
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || k_bytes % SLAB)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_int8)
    mm_kernel<true><<<grid, THREADS, 0, s>>>((const unsigned char*)a, (const unsigned char*)bt,
                                            (int*)c, N, k_bytes);
  else
    mm_kernel<false><<<grid, THREADS, 0, s>>>((const unsigned char*)a, (const unsigned char*)bt,
                                             (float*)c, N, k_bytes);
  return (int)cudaGetLastError();
}
