// SAME-padded 3x3 int8 convolution with a fused requantize epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `conv3x3_int8_fused` in
// doubleattentionspeakerverification_tpu/ops/conv_int8_pallas.py.
//
// In:  q     (B, T, F, Cin) int8, channels last; rows t >= T and the F edges
//            are zero padding
//      wp    (ceil(Cin/32), 9, Cout, 32) int8: the (9, Cin, Cout) taps
//            re-laid out once by the wrapper (ops/conv_int8.py:pack_weights),
//            32 input channels of one tap contiguous for each output channel,
//            channels >= Cin zero
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
// Design (a simple, exact first version; no TMA, no wgmma, no pipelining):
// an implicit GEMM with M = output positions, N = Cout, K = 9 taps x Cin.
// A block takes BM = 128 consecutive positions (t*F + f) of one batch row
// and BN = 128 output channels. For each 32-channel chunk of Cin it stages
// in shared memory
//   - the zero-padded halo patch: every (t, f) cell of the rows its positions
//     span plus one row above and below, and the F edges, 32 bytes a cell;
//   - the chunk's weights for all 9 taps and its BN output channels.
// Each of 8 warps (4 along M x 2 along N, a 32 x 64 warp tile) then runs the
// 9 taps as shifted reads of the same patch: tap (dt, df) of position
// (t, f) is the cell at (t - t0 + dt, f + df), so im2col costs no copies.
// Products are `mma.sync.m16n8k32` s8 x s8 -> s32 on the tensor cores. Cells
// and weight rows are padded to 48 bytes, which makes the fragment loads of
// the 8 lane groups of a warp fall into distinct banks. Input channels that
// are not a multiple of 32 are zero-filled in shared memory, so any Cin >= 1
// is exact. The fused epilogue applies mult and bias with `__fmul_rn` and
// `__fadd_rn` (the compiler may not contract them into an FMA) and rounds
// with `rintf`, which gives the plain version's and the Pallas kernel's
// numbers bit for bit.
//
// The library also exports three timing variants of the int8 kernel
// (tools/conv_int8_probe.py): the full kernel, dot-only (the patch is never
// staged from device memory) and copy-only (staging, no mma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output positions per block
constexpr int BN = 128;      // output channels per block
constexpr int KC = 32;       // input channels per chunk: one mma k-step
constexpr int CELL = 48;     // shared bytes per cell or weight row (32 + 16 pad)
constexpr int THREADS = 256; // 8 warps
constexpr int WM = 32;       // warp tile rows (positions)
constexpr int WN = 64;       // warp tile columns (output channels)
constexpr int MT = WM / 16;  // m16 tiles per warp
constexpr int NT = WN / 8;   // n8 tiles per warp
constexpr int MAX_SMEM = 232448;

enum Mode { FULL = 0, DOT_ONLY = 1, COPY_ONLY = 2 };
enum OutKind { OUT_I8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int MODE, int OUT>
__global__ void __launch_bounds__(THREADS)
conv3x3_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wp,
                    const float* __restrict__ mult, const float* __restrict__ bias,
                    void* __restrict__ out, int T, int F, int Cin, int Cout,
                    int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* w_s = smem;                     // [9 * BN] rows of CELL bytes
  unsigned char* x_s = smem + 9 * BN * CELL;     // [rows * (F + 2)] cells

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int TF = T * F;
  const int p0 = blockIdx.x * BM;
  const int t0 = p0 / F;                          // first output row of the block
  const int rows = (min(p0 + BM, TF) - 1) / F - t0 + 3;
  const int W2 = F + 2;
  const int cells = rows * W2;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  // byte offset of tap (0, 0) for the fragment rows g and g + 8 of each m tile
  int a_off[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(p0 + wm * WM + mt * 16 + g + 8 * h, TF - 1);
      const int t = p / F;
      const int f = p - t * F;
      a_off[mt][h] = ((t - t0) * W2 + f) * CELL + tig * 4;
    }
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const bool vec_ok = (Cin & 15) == 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * KC;
    // weights of this chunk: 9 * BN rows of 32 bytes, as two 16-byte halves
    for (int i = tid; i < 9 * BN * 2; i += THREADS) {
      const int half = i & 1, row = i >> 1;
      const int tap = row / BN, n = n0 + (row - tap * BN);
      int4 v = make_int4(0, 0, 0, 0);
      if (n < Cout)
        v = *reinterpret_cast<const int4*>(wp + (((int64_t)ch * 9 + tap) * Cout + n) * KC + half * 16);
      *reinterpret_cast<int4*>(w_s + row * CELL + half * 16) = v;
    }
    if (MODE != DOT_ONLY) {
      // the zero-padded halo patch of this chunk
      for (int i = tid; i < cells * 2; i += THREADS) {
        const int half = i & 1, cell = i >> 1;
        const int r = cell / W2;
        const int t = t0 - 1 + r, f = cell - r * W2 - 1;
        const int c = c0 + half * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (t >= 0 && t < T && f >= 0 && f < F && c < Cin) {
          const int8_t* src = q + (((int64_t)b * T + t) * F + f) * Cin + c;
          if (vec_ok) {
            v = *reinterpret_cast<const int4*>(src);
          } else {
            union {
              int4 v;
              int8_t bytes[16];
            } u;
#pragma unroll
            for (int j = 0; j < 16; ++j) u.bytes[j] = c + j < Cin ? src[j] : (int8_t)0;
            v = u.v;
          }
        }
        *reinterpret_cast<int4*>(x_s + cell * CELL + half * 16) = v;
      }
    }
    __syncthreads();
    if (MODE != COPY_ONLY) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3, df = tap - dt * 3;
        const int tap_off = (dt * W2 + df) * CELL;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* r0 = x_s + a_off[mt][0] + tap_off;
          const unsigned char* r1 = x_s + a_off[mt][1] + tap_off;
          a[mt][0] = lds32(r0);
          a[mt][1] = lds32(r1);
          a[mt][2] = lds32(r0 + 16);
          a[mt][3] = lds32(r1 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* wr = w_s + (tap * BN + wn * WN + nt * 8 + g) * CELL + tig * 4;
          const uint32_t b0 = lds32(wr), b1 = lds32(wr + 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
        }
      }
    } else {
      acc[0][0][0] += (int)lds32(x_s + a_off[0][0]);  // keep the staging live
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + wm * WM + mt * 16 + g + 8 * (i >> 1);
        const int n = n0 + wn * WN + nt * 8 + tig * 2 + (i & 1);
        if (p >= TF || n >= Cout) continue;
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), mult[n]), bias[n]);
        const int64_t idx = ((int64_t)b * TF + p) * Cout + n;
        if (OUT == OUT_I8) {
          const float r = fminf(fmaxf(rintf(v), 0.0f), 127.0f);
          reinterpret_cast<int8_t*>(out)[idx] = (int8_t)(int)r;
        } else if (OUT == OUT_F32) {
          reinterpret_cast<float*>(out)[idx] = fmaxf(v, 0.0f);
        } else {
          reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(fmaxf(v, 0.0f));
        }
      }
    }
  }
}

template <int MODE, int OUT>
int launch(const void* q, const void* wp, const void* mult, const void* bias,
           void* out, int B, int T, int F, int Cin, int Cout, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || F <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  int rows = (BM - 1 + F - 1) / F + 3;  // rows BM consecutive positions can span, plus halo
  if (rows > T + 2) rows = T + 2;
  const size_t smem = (size_t)(9 * BN + rows * (F + 2)) * CELL;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one instantiation, one card
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_int8_kernel<MODE, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int64_t tf = (int64_t)T * F;
  const dim3 grid((unsigned)((tf + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN), (unsigned)B);
  conv3x3_int8_kernel<MODE, OUT><<<grid, THREADS, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)wp, (const float*)mult, (const float*)bias, out,
      T, F, Cin, Cout, (Cin + KC - 1) / KC);
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

// The probe's three variants, with conv3x3_int8_fused's arguments; they take
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
