// SAME-padded 3x3 int8 convolution with a fused requantize epilogue, for
// Hopper (sm_90a), on `wgmma`.
//
// Replaces the Pallas TPU kernel `_kernel` / `conv3x3_int8_fused` in
// doubleattentionspeakerverification_tpu/ops/conv_int8_pallas.py.
//
// In:  q     (B, T, F, Cin) int8, channels last; rows t outside 0..T-1 and
//            the F edges are zero padding
//      wp    the (9, Cin, Cout) taps re-laid out once by the wrapper
//            (ops/conv_int8.py:pack_weights) as
//            (ceil(Cout/128), ceil(Cin/32), 9, 16, 2, 8, 16) int8: for each
//            128-channel N tile and 32-channel chunk, one contiguous block of
//            9 taps x 128 output rows x 32 input bytes in wgmma's no-swizzle
//            K-major core-matrix order (8 rows x 16 bytes each; the two
//            16-byte halves of K 128 bytes apart, 8-row groups 256 bytes
//            apart); input channels >= Cin and outputs >= Cout zero
//      mult, bias (Cout,) float32
// Out: (B, T, F, Cout), with acc the exact int32 sum over the 3x3xCin window
//      and v = fadd_rn(fmul_rn(float_rn(acc), mult), bias) (no FMA):
//        int8:             clip(rint(v), 0, 127)   (round half to even)
//        float32/bfloat16: max(v, 0), rounded to nearest even for bfloat16
//      Only this result is written: the int32 sums never leave registers.
//
// What bounds it on the H100: operations. Each output position costs
// 2*9*Cin*Cout int8 operations and moves Cin + Cout bytes (int8 in and out),
// 1,152 operations a byte at Cin = Cout = 128 and more at the wider convs:
// far above the card's 590 int8 operations a byte (1,979 TOP/s over
// 3.35 TB/s), so the tensor cores are the limit and the design has to feed
// them.
//
// Design: an implicit GEMM, M = output positions, N = Cout, K = 9 taps x Cin.
// A tile is BM = 256 consecutive positions p = t*F+f of one batch row and
// BN = 128 output channels. One block of three warpgroups stays resident on
// each SM (222 KB of shared memory) and takes tiles in turn, N tile fastest,
// walking each tile's Cin in 32-channel chunks through a ring of STAGES = 3
// shared-memory slots, each guarded by a `full` and an `empty` mbarrier.
// The ring runs on across tiles, so the next tile's first chunks load while
// this tile's epilogue stores.
//   - Warpgroup 0 produces (`setmaxnreg` down to 104). Per chunk, one thread
//     sets the slot's expected bytes and fetches the chunk's 36 KB weight
//     block with one `cp.async.bulk`; all 128 threads fill the slot's halo
//     patch and then arrive.
//   - The patch holds the 32 channels of every position any tap of the tile
//     reads, as three bands of cells: band dt (the taps' time shift dt-1)
//     holds positions p0 + (dt-1)*F - 1 + j. Bands start BS = min(F, BM+2)
//     cells apart, so for F <= 258 they overlap into one flat run of
//     BM + 2F + 2 cells and for wider F they are three runs of BM + 2: at
//     most 774 cells of 48 bytes (32 used; the pitch puts the 8 rows a
//     fragment load reads in distinct banks) for any F. Tap (dt, df) of row
//     i is cell dt*BS + i + df, a shifted view, so im2col costs no copies;
//     a tap across the F edge is zeroed in registers (f = 0 with df = 0,
//     f = F-1 with df = 2), and positions outside 0..T*F-1 are zero cells.
//   - The patch loader is one code path for every Cin >= 1. A cell's
//     channels start at byte (position*Cin + c0), which for Cin = 3 is not
//     4-byte aligned, and cp.async and TMA cannot take such a source (nor a
//     tensor map a row stride that is not a multiple of 16). So each
//     16-byte piece is read as the one or two aligned 16-byte words that
//     hold it (ld.global.nc; the second only if the piece crosses into it),
//     shifted into place and masked past Cin. For Cin a multiple of 16, as
//     at every paper-width conv, that is one aligned load and no shift. The
//     producer warpgroup runs up to STAGES chunks ahead of the products, so
//     these loads overlap them as TMA would.
//   - Warpgroups 1 and 2 consume (`setmaxnreg` up to 200), 128 positions
//     each as two m64 tiles. Per tap each thread loads its 16-row A
//     fragments from the patch (4-byte loads, 4 channels of one cell each)
//     and issues two `wgmma.mma_async`
//     m64n128k32 .s32.s8.s8 with A in registers and the weights (B) from
//     shared memory by descriptor. Each tap's products are one commit group;
//     the warpgroup waits until only the newest group is in flight, so a
//     slot is released to the producer once the first tap of the next chunk
//     is issued and the last tap of its own is done.
//   - One 36 KB weight block serves 256 positions, so the weights are read
//     from L2 once for every 256 positions of each N tile.
// What holds it below the tensor cores' rate is shared memory: each
// m64n128k32 `wgmma` reads its 4 KB B tile from it (wgmma's M is 64 whatever
// N is, so B alone takes 64 of the SM's 128 bytes a clock at full rate),
// the A fragment loads add 32 and the ring's fills about 20.
// The fused epilogue applies mult and bias with `__fmul_rn` and `__fadd_rn`
// (the compiler may not contract them into an FMA) and rounds with `rintf`,
// which gives the plain version's and the Pallas kernel's numbers bit for
// bit; columns past Cout and positions past T*F are not stored.
//
// The library also exports three timing modes of the int8 kernel
// (tools/conv_int8_probe.py): full (this kernel), dot-only (the producer
// fetches the weights but never fills the patch; the products run on
// whatever the slots hold) and copy-only (the consumers wait for each slot
// and release it with no products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;                     // output positions per block
constexpr int BN = 128;                     // output channels per block
constexpr int KC = 32;                      // input channels per chunk: one wgmma k-step
constexpr int CELL = 48;                    // shared bytes per patch cell (32 + 16 pad)
constexpr int STAGES = 3;
constexpr int THREADS = 384;                // producer warpgroup + two consumer warpgroups
constexpr int TAP_BYTES = BN * KC;          // 4096: one tap of the weight block
constexpr int W_BYTES = 9 * TAP_BYTES;      // 36,864
constexpr int MAX_CELLS = 3 * (BM + 2);     // 774
constexpr int STAGE_BYTES = W_BYTES + MAX_CELLS * CELL;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int UNROLL = 8;                   // patch pieces a producer thread has in flight

enum Mode { FULL = 0, DOT_ONLY = 1, COPY_ONLY = 2 };
enum OutKind { OUT_I8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

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
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// K-major operand, no swizzle: core matrices of 8 rows x 16 bytes; the two
// 16-byte halves of a 32-byte K step 128 bytes apart (leading offset), 8-row
// groups 256 bytes apart (stride offset).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define ACC8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128 per warpgroup) += a (64 x 32 bytes, registers) . b (128 x 32 bytes)^T
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p; }\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OUT>
__device__ __forceinline__ void store1(void* out, int64_t idx, float v) {
  if constexpr (OUT == OUT_I8) {
    reinterpret_cast<int8_t*>(out)[idx] = (int8_t)(int)fminf(fmaxf(rintf(v), 0.0f), 127.0f);
  } else if constexpr (OUT == OUT_F32) {
    reinterpret_cast<float*>(out)[idx] = fmaxf(v, 0.0f);
  } else {
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(fmaxf(v, 0.0f));
  }
}

template <int OUT>
__device__ __forceinline__ void store2(void* out, int64_t idx, float v0, float v1) {
  if constexpr (OUT == OUT_I8) {
    const int r0 = (int)fminf(fmaxf(rintf(v0), 0.0f), 127.0f);
    const int r1 = (int)fminf(fmaxf(rintf(v1), 0.0f), 127.0f);
    *reinterpret_cast<uint16_t*>(reinterpret_cast<int8_t*>(out) + idx) = (uint16_t)(r0 | (r1 << 8));
  } else if constexpr (OUT == OUT_F32) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) = make_float2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  } else {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) =
        __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  }
}

template <int MODE, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wp,
                    const float* __restrict__ mult, const float* __restrict__ bias,
                    void* __restrict__ out, int T, int F, int Cin, int Cout, int n_chunks,
                    int n_tiles, int m_blocks, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;

  const int TF = T * F;
  const int BS = min(F, BM + 2);             // cells between the bands' starts
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 128);          // every producer thread, plus the weights' bytes
      mbar_init(empty + 8 * s, 8);           // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tiles (N tile fastest, then position block, then batch row) are dealt to
  // the resident blocks in turn; `it` counts the chunks a block has passed
  // through its ring, across tiles.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    const int tid = threadIdx.x;
    const int n_pieces = 2 * (2 * BS + BM + 2);    // two 16-byte halves a cell
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int n_tile = tile % n_tiles, p0 = (tile / n_tiles) % m_blocks * BM;
      const int8_t* w_tile = wp + (int64_t)n_tile * n_chunks * W_BYTES;
      const int64_t q_row = (int64_t)(tile / (n_tiles * m_blocks)) * TF;
      for (int ch = 0; ch < n_chunks; ++ch, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t slot = base + s * STAGE_BYTES;
        if (tid == 0) {
          mbar_expect_tx(full + 8 * s, W_BYTES);
          bulk_load(slot, w_tile + (int64_t)ch * W_BYTES, W_BYTES, full + 8 * s);
        }
        if (MODE != DOT_ONLY) {
          const uint32_t patch = slot + W_BYTES;
          const int c0 = ch * KC;
          for (int first = tid; first < n_pieces; first += 128 * UNROLL) {
            uint4 w0[UNROLL], w1[UNROLL];
            int off[UNROLL], need[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int piece = first + 128 * u;
              const int x = piece >> 1, c = c0 + 16 * (piece & 1);
              const int dt = min(x / BS, 2);
              const int pos = p0 + (dt - 1) * F - 1 + (x - dt * BS);
              need[u] = (piece < n_pieces && pos >= 0 && pos < TF) ? max(0, min(16, Cin - c)) : 0;
              w0[u] = w1[u] = make_uint4(0, 0, 0, 0);
              off[u] = 0;
              if (need[u] > 0) {
                const uintptr_t src = reinterpret_cast<uintptr_t>(q + (q_row + pos) * Cin + c);
                const uint4* aligned = reinterpret_cast<const uint4*>(src & ~(uintptr_t)15);
                off[u] = (int)(src & 15);
                w0[u] = __ldg(aligned);
                if (off[u] + need[u] > 16) w1[u] = __ldg(aligned + 1);
              }
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int piece = first + 128 * u;
              if (piece >= n_pieces) break;
              // the 16 bytes at offset off of the 32 bytes w0 w1, bytes past need zero
              const uint32_t W[8] = {w0[u].x, w0[u].y, w0[u].z, w0[u].w,
                                     w1[u].x, w1[u].y, w1[u].z, w1[u].w};
              const int o4 = off[u] >> 2, sh = (off[u] & 3) * 8;
              uint32_t X[5], r[4];
#pragma unroll
              for (int k = 0; k < 5; ++k)
                X[k] = o4 == 0 ? W[k] : o4 == 1 ? W[k + 1] : o4 == 2 ? W[k + 2] : W[k + 3];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int nb = min(max(need[u] - 4 * i, 0), 4);
                const uint32_t mask = nb == 4 ? 0xFFFFFFFFu : (1u << (8 * nb)) - 1u;
                r[i] = __funnelshift_r(X[i], X[i + 1], sh) & mask;
              }
              sts128(patch + (piece >> 1) * CELL + (piece & 1) * 16, r[0], r[1], r[2], r[3]);
            }
          }
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int cw = wg - 1;                   // positions cw*128 .. cw*128+127 of the tile
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int n_tile = tile % n_tiles, p0 = (tile / n_tiles) % m_blocks * BM;
      const int b = tile / (n_tiles * m_blocks);

      // A fragment rows g and g + 8 of m tile mt: their cell offset and their
      // F-edge masks (f = 0 has no left tap, f = F-1 no right tap)
      uint32_t row_off[2][2], lmask[2][2], rmask[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = cw * 128 + mt * 64 + 16 * w + g + 8 * h;
          const int f = (p0 + i) % F;
          row_off[mt][h] = i * CELL + 4 * tig;
          lmask[mt][h] = f != 0 ? 0xFFFFFFFFu : 0u;
          rmask[mt][h] = f != F - 1 ? 0xFFFFFFFFu : 0u;
        }

      int acc[2][64];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0;

      for (int ch = 0; ch < n_chunks; ++ch, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const uint32_t slot = base + s * STAGE_BYTES;
        const uint32_t patch = slot + W_BYTES;
        if (MODE == COPY_ONLY) {
          acc[0][0] += (int)lds32(patch + row_off[0][0]);   // keep the staging live
          if (lane == 0) mbar_arrive(empty + 8 * s);
        } else {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int dt = tap / 3, df = tap % 3;
            const uint32_t tap_off = patch + (dt * BS + df) * CELL;
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const uint32_t r0 = tap_off + row_off[mt][0], r1 = tap_off + row_off[mt][1];
              a[mt][0] = lds32(r0);
              a[mt][1] = lds32(r1);
              a[mt][2] = lds32(r0 + 16);
              a[mt][3] = lds32(r1 + 16);
              if (df != 1) {
                const uint32_t m0 = df == 0 ? lmask[mt][0] : rmask[mt][0];
                const uint32_t m1 = df == 0 ? lmask[mt][1] : rmask[mt][1];
                a[mt][0] &= m0;
                a[mt][2] &= m0;
                a[mt][1] &= m1;
                a[mt][3] &= m1;
              }
            }
            wgmma_fence();
            const uint64_t db = desc_b(slot + tap * TAP_BYTES);
            wgmma(acc[0], a[0], db);
            wgmma(acc[1], a[1], db);
            wgmma_commit();
            wgmma_wait<1>();                   // every earlier tap's products are done
            if (tap == 0 && ch > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
          }
        }
      }
      if (MODE != COPY_ONLY) {
        wgmma_wait<0>();                       // the tile's last chunk is done: release it
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }

      // accumulator 4*j + 2*h + e of m tile mt: position row 16*w + g + 8*h,
      // output channel 8*j + 2*tig + e
      const int n_base = n_tile * BN + 2 * tig;
      const bool pairs = (Cout & 1) == 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n_base + 8 * j;
        if (n >= Cout) break;
        const bool two = n + 1 < Cout;
        const float m0 = mult[n], b0 = bias[n];
        const float m1 = two ? mult[n + 1] : 0.0f, b1 = two ? bias[n + 1] : 0.0f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + cw * 128 + mt * 64 + 16 * w + g + 8 * h;
            if (p >= TF) continue;
            const int64_t idx = ((int64_t)b * TF + p) * Cout + n;
            const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * h]), m0), b0);
            if (two) {
              const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * h + 1]), m1), b1);
              if (pairs) {
                store2<OUT>(out, idx, v0, v1);
              } else {
                store1<OUT>(out, idx, v0);
                store1<OUT>(out, idx + 1, v1);
              }
            } else {
              store1<OUT>(out, idx, v0);
            }
          }
      }
    }
  }
}

template <int MODE, int OUT>
int launch(const void* q, const void* wp, const void* mult, const void* bias,
           void* out, int B, int T, int F, int Cin, int Cout, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || F <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tf = (int64_t)T * F;
  const int64_t m_blocks = (tf + BM - 1) / BM, n_tiles = (Cout + BN - 1) / BN;
  const int64_t total = m_blocks * n_tiles * B;
  if (tf > INT32_MAX / 2 || total > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  static int sms = 0;  // one instantiation, one card
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv3x3_int8_kernel<MODE, OUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  const int grid = (int)(total < sms ? total : sms);   // one resident block per SM
  conv3x3_int8_kernel<MODE, OUT><<<grid, THREADS, SMEM, stream>>>(
      (const int8_t*)q, (const int8_t*)wp, (const float*)mult, (const float*)bias, out,
      T, F, Cin, Cout, (Cin + KC - 1) / KC, (int)n_tiles, (int)m_blocks, (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

// out_kind: 0 int8, 1 float32, 2 bfloat16.
extern "C" int conv3x3_int8_fused(const void* q, const void* wp, const void* mult,
                                  const void* bias, void* out, int B, int T, int F,
                                  int Cin, int Cout, int out_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case OUT_I8: return launch<FULL, OUT_I8>(q, wp, mult, bias, out, B, T, F, Cin, Cout, s);
    case OUT_F32: return launch<FULL, OUT_F32>(q, wp, mult, bias, out, B, T, F, Cin, Cout, s);
    case OUT_BF16: return launch<FULL, OUT_BF16>(q, wp, mult, bias, out, B, T, F, Cin, Cout, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The probe's three modes, with conv3x3_int8_fused's arguments; they take
// out_kind 0 (int8) only. `full` is the same code as conv3x3_int8_fused.
#define PROBE_ENTRY(name, MODE)                                                           \
  extern "C" int name(const void* q, const void* wp, const void* mult, const void* bias,  \
                      void* out, int B, int T, int F, int Cin, int Cout, int out_kind,    \
                      void* stream) {                                                     \
    if (out_kind != OUT_I8) return (int)cudaErrorInvalidValue;                            \
    return launch<MODE, OUT_I8>(q, wp, mult, bias, out, B, T, F, Cin, Cout,               \
                                (cudaStream_t)stream);                                    \
  }
PROBE_ENTRY(conv3x3_int8_full, FULL)
PROBE_ENTRY(conv3x3_int8_dot_only, DOT_ONLY)
PROBE_ENTRY(conv3x3_int8_copy_only, COPY_ONLY)
