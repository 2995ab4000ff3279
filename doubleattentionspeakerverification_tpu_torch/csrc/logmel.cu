// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `log_mel_spectrogram_pallas` in
// doubleattentionspeakerverification_tpu/ops/logmel_pallas.py.
//
// In:  y     (B, N) float32, already rescaled and pre-emphasized (a torch op
//            before the launch, as the JAX path does it outside its kernel)
//      cosb, sinb (n_fft, n_bins) float32, the Hamming window folded in
//      melT  (n_bins, n_mels) float32
// Out: out   (B, T, n_mels) float32 = log(max(log_floor, |DFT(frame)| @ melT)),
//            frame t = y[t*hop : t*hop + n_fft], T = 1 + (N - n_fft) / hop.
//
// What bounds it on the H100: arithmetic. Each frame costs
// 2*(n_fft*2*n_bins + n_bins*n_mels) = 2*(512*514 + 257*80) flops against
// 4*hop + 4*n_mels bytes of audio in and features out, about 800 flops a byte,
// far above the card's float32 balance (67 TFLOP/s over 3.35 TB/s = 20). The
// products must be true float32 on the CUDA cores: TF32 tensor cores keep ten
// mantissa bits, and the near-cancelling low DFT bins of the pre-emphasized
// signal (x32768) lose their value in them.
//
// Design: one block per (tile of TF frames, batch row). The block copies the
// tile's overlapping samples, (TF-1)*hop + n_fft of them, from global memory
// into shared memory once; the DFT bases are constant, so no roll or
// re-framing is needed. Each thread owns one DFT bin k and keeps the real and
// imaginary sums of all TF frames in registers, so each basis value read
// (coalesced across the warp's bins, L2-resident: 1 MB for both bases) feeds
// 2*TF fused multiply-adds. Samples are read from shared memory four at a
// time (one 16-byte broadcast load per frame and four n) when hop and n_fft
// allow it, so loads stay well below the FMAs. TF = 8 keeps enough blocks in
// flight for one short upload (25 blocks for 2 s, 125 for 10 s). The
// magnitudes go to shared memory, then each thread computes (frame, mel)
// outputs against melT and applies the log floor. Blocks share nothing. Not done yet:
// splitting bins across blocks, tensor cores in 3xTF32 for the DFT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 8;  // frames per block

// VEC samples of n per step: 4 when hop and n_fft are multiples of 4 (16-byte
// aligned shared-memory loads), else 1.
template <int VEC>
__global__ void logmel_kernel(const float* __restrict__ y,
                              const float* __restrict__ cosb,
                              const float* __restrict__ sinb,
                              const float* __restrict__ melT,
                              float* __restrict__ out,
                              int N, int T, int hop, int n_fft, int n_bins,
                              int n_mels, float log_floor) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, T - t0);
  const int span = (TF - 1) * hop + n_fft;
  float* samples = smem;         // span
  float* mag = smem + span;      // TF * n_bins

  const float* yb = y + (int64_t)b * N;
  const int64_t base = (int64_t)t0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int64_t s = base + i;
    samples[i] = s < N ? yb[s] : 0.0f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    for (int n = 0; n < n_fft; n += VEC) {
      float c[VEC], s[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        c[v] = __ldg(cosb + (int64_t)(n + v) * n_bins + k);
        s[v] = __ldg(sinb + (int64_t)(n + v) * n_bins + k);
      }
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        float x[VEC];
        if constexpr (VEC == 4) {
          const float4 q = *reinterpret_cast<const float4*>(samples + f * hop + n);
          x[0] = q.x;
          x[1] = q.y;
          x[2] = q.z;
          x[3] = q.w;
        } else {
          x[0] = samples[f * hop + n];
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          re[f] = fmaf(x[v], c[v], re[f]);
          im[f] = fmaf(x[v], s[v], im[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      mag[f * n_bins + k] = sqrtf(re[f] * re[f] + im[f] * im[f]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nf * n_mels; i += blockDim.x) {
    const int f = i / n_mels;
    const int m = i - f * n_mels;
    const float* mrow = mag + f * n_bins;
    float acc = 0.0f;
    for (int k = 0; k < n_bins; ++k) {
      acc = fmaf(mrow[k], __ldg(melT + (int64_t)k * n_mels + m), acc);
    }
    out[((int64_t)b * T + t0 + f) * n_mels + m] = logf(fmaxf(log_floor, acc));
  }
}

template <int VEC>
int launch(const void* y, const void* cosb, const void* sinb, const void* melT,
           void* out, int B, int N, int T, int hop, int n_fft, int n_bins,
           int n_mels, float log_floor, cudaStream_t stream) {
  const int span = (TF - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * ((size_t)span + (size_t)TF * n_bins);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmel_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((T + TF - 1) / TF, B);
  logmel_kernel<VEC><<<grid, threads, smem, stream>>>(
      (const float*)y, (const float*)cosb, (const float*)sinb,
      (const float*)melT, (float*)out, N, T, hop, n_fft, n_bins, n_mels,
      log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int logmel_f32(const void* y, const void* cosb, const void* sinb,
                          const void* melT, void* out, int B, int N, int T,
                          int hop, int n_fft, int n_bins, int n_mels,
                          float log_floor, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hop % 4 == 0 && n_fft % 4 == 0)
    return launch<4>(y, cosb, sinb, melT, out, B, N, T, hop, n_fft, n_bins, n_mels, log_floor, s);
  return launch<1>(y, cosb, sinb, melT, out, B, N, T, hop, n_fft, n_bins, n_mels, log_floor, s);
}
