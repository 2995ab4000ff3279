// Matrix-product rate probe for Hopper (sm_90a): int8 x int8 -> int32 and
// bf16 x bf16 -> float32 on the tensor cores, by `wgmma`.
//
// Replaces the Pallas TPU kernel `mm_kernel` / `pallas_mm` in
// tools/_mxu_rate.py, which timed the TPU's matrix unit at M = K = N = 4096.
//
// In:  a  (M, K) row-major, bt (N, K) row-major (B transposed, so both
//         operands are K-major, as 8-bit `wgmma` requires), int8 or bf16
// Out: c  (M, N) = a @ bt^T, int32 for int8 inputs, float32 for bf16
//
// What bounds it on the H100: operations. At 4096^3 it does 2 * 4096^3
// operations on 96 MB (int8) or 128 MB (bf16) of operands and result, over
// 1,000 operations a byte, far above the card's 590 (int8) or 295 (bf16).
//
// Design: one block of three warpgroups per 128 x 256 tile of c.
//   - Warpgroup 0 is the producer. It gives back registers (`setmaxnreg`
//     down to 40) and one of its threads keeps a ring of STAGES = 4 K slabs
//     full: per slab one TMA load of a's 128 x 128-byte box and one of bt's
//     256 x 128-byte box, both through 2-D tensor maps with the 128-byte
//     swizzle, completing on the slab's `full` mbarrier (expected bytes set
//     first). Before it refills a slab it waits on the slab's `empty`
//     mbarrier.
//   - Warpgroups 1 and 2 are the consumers (`setmaxnreg` up to 232), 64
//     rows of the tile each. Per slab each issues four `wgmma.mma_async`
//     m64n256k32 .s32.s8.s8 (or m64n256k16 .f32.bf16.bf16), both operands
//     read from shared memory by descriptor (128-byte swizzle, 1024 bytes
//     between 8-row groups, the start address moved 32 bytes along K per
//     step), into 128 accumulators a thread. It commits the slab's products
//     as one group and waits until only that group is in flight, so the
//     previous slab's products are done and that slab is released to the
//     producer: copies of later slabs overlap the products of this one.
//   - The epilogue writes each thread's accumulators straight to c, two
//     neighbouring columns at a time.
// The tensor maps are built on the host by cuTensorMapEncodeTiled, looked
// up in libcuda at run time with cudaGetDriverEntryPoint (so the library
// links no -lcuda), and passed as __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 256;
constexpr int BK = 128;                   // bytes of K per slab: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

template <bool INT8>
struct Acc;
template <>
struct Acc<true> { using T = int; };
template <>
struct Acc<false> { using T = float; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// K-major operand, 128-byte swizzle: rows of 128 bytes, 8-row groups 1024
// bytes apart (stride offset); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define ACC8(c, i) "+" c(d[i]), "+" c(d[i + 1]), "+" c(d[i + 2]), "+" c(d[i + 3]), \
                   "+" c(d[i + 4]), "+" c(d[i + 5]), "+" c(d[i + 6]), "+" c(d[i + 7])
#define ACC128(c) ACC8(c, 0), ACC8(c, 8), ACC8(c, 16), ACC8(c, 24), ACC8(c, 32), ACC8(c, 40), \
                  ACC8(c, 48), ACC8(c, 56), ACC8(c, 64), ACC8(c, 72), ACC8(c, 80), ACC8(c, 88), \
                  ACC8(c, 96), ACC8(c, 104), ACC8(c, 112), ACC8(c, 120)
#define REGS128                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "             \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x 256 per warpgroup) += a (64 x 32 bytes) . b (256 x 32 bytes)^T
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " REGS128 ", %128, %129, p; }\n"
      : ACC128("r") : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128 ", %128, %129, p, 1, 1, 0, 0; }\n"
      : ACC128("f") : "l"(da), "l"(db), "r"(1));
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
mm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          typename Acc<INT8>::T* __restrict__ c, int N, int k_tiles) {
  using T = typename Acc<INT8>::T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzle atoms are 1024 bytes
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's arrival, plus the TMA bytes
      mbar_init(empty + 8 * s, 8);    // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      constexpr int k_elems = INT8 ? BK : BK / 2;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t dst = base + s * STAGE_BYTES;
        tma_load_2d(dst, &map_a, full + 8 * s, kt * k_elems, m0);
        tma_load_2d(dst + A_BYTES, &map_b, full + 8 * s, kt * k_elems, n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                      // rows cw*64 .. cw*64+63 of the tile
    const int lane = threadIdx.x & 31;
    T acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = T(0);

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint32_t a_tile = base + s * STAGE_BYTES + cw * 64 * BK;
      const uint32_t b_tile = base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k) wgmma(acc, desc_sw128(a_tile + 32 * k), desc_sw128(b_tile + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();                          // the previous slab's products are done
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
    wgmma_wait<0>();

    // accumulator j*4 + 2*h + e: row 16*warp + g + 8*h, column 8*j + 2*tig + e
    const int w = (threadIdx.x >> 5) & 3, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + cw * 64 + 16 * w + g + 8 * h;
        const int n = n0 + 8 * j + 2 * tig;
        T* dst = c + (int64_t)m * N + n;
        if constexpr (INT8)
          *reinterpret_cast<int2*>(dst) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows x k_bytes row-major operand, boxes of box_rows x 128 bytes, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int rows, int k_bytes, int box_rows, bool int8) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const int el = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)(k_bytes / el), (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(BK / el), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool INT8>
int launch(const void* a, const void* bt, void* c, int M, int N, int k_bytes, cudaStream_t s) {
  static bool configured = false;   // one instantiation, one card
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(mm_kernel<INT8>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, k_bytes, BM, INT8) || !make_map(&map_b, bt, N, k_bytes, BN, INT8))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  mm_kernel<INT8><<<grid, THREADS, SMEM, s>>>(map_a, map_b, (typename Acc<INT8>::T*)c, N,
                                              k_bytes / BK);
  return (int)cudaGetLastError();
}

}  // namespace

// is_int8: 1 for int8 inputs and an int32 c, 0 for bf16 inputs and a float32
// c. M a multiple of 128, N of 256, K * element size of 128 bytes; a and bt
// 16-byte aligned.
extern "C" int mm_probe(const void* a, const void* bt, void* c, int M, int N, int K,
                        int is_int8, void* stream) {
  const int k_bytes = is_int8 ? K : 2 * K;
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || k_bytes % BK ||
      ((uintptr_t)a & 15) || ((uintptr_t)bt & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_int8 ? launch<true>(a, bt, c, M, N, k_bytes, s) : launch<false>(a, bt, c, M, N, k_bytes, s);
}
