// Fused masked multi-head attention pooling (forward) for Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel `_kernel` /
// `_mha_pool_fused_fwd_impl` / `mha_pool_pallas` in
// doubleattentionspeakerverification_tpu/ops/pooling_pallas.py.
//
// In:  ht      (B, T, H, d_h) float32 or bfloat16 (upcast on load)
//      q       (H, d_h) float32, the transposed query with the score scale
//              already folded in
//      lengths (B,) int32; steps t >= lengths[b] are masked
// Out: out     (B, H, d_h) float32,
//      out[b,h,:] = sum_t softmax_t(<ht[b,t,h,:], q[h,:]>) * ht[b,t,h,:]
//      over the valid steps; a row with no valid step gives zeros, as the
//      Pallas kernel's acc / max(l, 1e-30) does.
//
// What bounds it on the H100: memory. Every valid (t, h) row of ht is read
// once and used for one dot product and one weighted add, about 1 flop a
// byte, so its bound is the bytes of the valid rows over 3.35 TB/s.
//
// Design: one block per (head, batch row); blocks share nothing. The TPU's
// sequential time grid axis, which carried the online-softmax state in VMEM
// from one tile to the next, becomes a loop inside the block: each of the
// block's warps takes every WARPS-th time step and keeps its own running max
// m, denominator l and weighted sum acc[d_h] in registers (d_h spread over the
// lanes, PL values a lane). A step's score is a warp reduction over d_h.
// Masked steps are never loaded: their weight in the Pallas kernel is exactly
// 0, so skipping them gives the same result and reads only the valid bytes.
// At the end the warps' states meet in shared memory and combine with the
// usual rescaling by exp(m_w - M). A row's d_h values are contiguous, so each
// warp's loads are coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_PL = 16;  // d_h <= 32 * MAX_PL = 512
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int PL>
__global__ void mha_pool_kernel(const T* __restrict__ ht,
                                const float* __restrict__ q,
                                const int* __restrict__ lengths,
                                float* __restrict__ out, int T_len, int H,
                                int d_h) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][32 * PL];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(max(lengths[b], 0), T_len);

  float qr[PL], acc[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < d_h ? q[h * d_h + d] : 0.0f;
    acc[j] = 0.0f;
  }
  float m = NEG_BIG;
  float l = 0.0f;

  for (int t = warp; t < len; t += WARPS) {
    const T* row = ht + (((int64_t)b * T_len + t) * H + h) * d_h;
    float x[PL];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int d = lane + 32 * j;
      x[j] = d < d_h ? load_f32(row + d) : 0.0f;
      s = fmaf(x[j], qr[j], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int j = 0; j < PL; ++j) acc[j] = fmaf(acc[j], corr, p * x[j]);
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < PL; ++j) sm_acc[warp][lane + 32 * j] = acc[j];
  __syncthreads();

  float M = NEG_BIG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
  for (int d = threadIdx.x; d < d_h; d += blockDim.x) {
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w] - M);
      L = fmaf(sm_l[w], c, L);
      A = fmaf(sm_acc[w][d], c, A);
    }
    out[((int64_t)b * H + h) * d_h + d] = A / fmaxf(L, 1e-30f);
  }
}

template <typename T>
int launch(const void* ht, const void* q, const void* lengths, void* out,
           int B, int T_len, int H, int d_h, cudaStream_t stream) {
  const dim3 grid(H, B);
  const int threads = 32 * WARPS;
  const int pl = (d_h + 31) / 32;
  const T* h = (const T*)ht;
  const float* qq = (const float*)q;
  const int* ll = (const int*)lengths;
  float* o = (float*)out;
  if (pl <= 1) mha_pool_kernel<T, 1><<<grid, threads, 0, stream>>>(h, qq, ll, o, T_len, H, d_h);
  else if (pl <= 2) mha_pool_kernel<T, 2><<<grid, threads, 0, stream>>>(h, qq, ll, o, T_len, H, d_h);
  else if (pl <= 4) mha_pool_kernel<T, 4><<<grid, threads, 0, stream>>>(h, qq, ll, o, T_len, H, d_h);
  else if (pl <= 8) mha_pool_kernel<T, 8><<<grid, threads, 0, stream>>>(h, qq, ll, o, T_len, H, d_h);
  else if (pl <= MAX_PL) mha_pool_kernel<T, MAX_PL><<<grid, threads, 0, stream>>>(h, qq, ll, o, T_len, H, d_h);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// ht_is_bf16: 0 for float32 ht, 1 for bfloat16 ht.
extern "C" int mha_pool_fwd(const void* ht, const void* q, const void* lengths,
                            void* out, int B, int T_len, int H, int d_h,
                            int ht_is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ht_is_bf16) return launch<__nv_bfloat16>(ht, q, lengths, out, B, T_len, H, d_h, s);
  return launch<float>(ht, q, lengths, out, B, T_len, H, d_h, s);
}
