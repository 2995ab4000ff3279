// Fused log-mel spectrogram for Hopper (sm_90a): a shared-memory FFT.
//
// Replaces the Pallas TPU kernel `_kernel` / `log_mel_spectrogram_pallas` in
// doubleattentionspeakerverification_tpu/ops/logmel_pallas.py.
//
// In:  x      (B, N) float32 raw audio in [-1, 1]
//      window (n_fft,) float32, the zero-padded periodic Hamming window
//      tw     complex float32 table: per-stage twiddles, radix roots and the
//             split twiddles of the host-built plan (ops/logmel.py fft_plan)
//      plan   int32 [n_stages, split_offset, (radix, Ns, tw_off, root_off)...]
//      melT   (n_bins, n_mels) float32, bands (n_mels, 2) int32 [k_lo, k_hi)
// Out: out    (B, T, n_mels) float32 = log(max(log_floor, |rFFT(w * frame)| @ melT)),
//             frame t = y[t*hop : t*hop + n_fft], T = 1 + (N - n_fft) / hop,
//             y = pre-emphasis of x * rescale, rounded as dsp/features.py
//             `preemphasize` rounds it (no contracted multiply-add).
//
// Design: one block per (tile of TF frames, batch row). The block stages its
// tile's overlapping samples, (TF-1)*hop + n_fft of them, from global memory
// once, pre-emphasizing on the way (it reads the one sample of history it
// needs). It then windows and packs each frame (even n_fft: sample pairs are
// the complex points of an n_fft/2-point FFT; odd n_fft: a full complex FFT
// of the real frame) into shared memory and runs a Stockham mixed-radix FFT
// there, one barrier per stage, ping-ponging between two buffers: radix 4 and
// 2 as butterflies, any other prime radix as a direct DFT that computes each
// output from its R inputs (a prime n_fft is one such stage: slow, but in
// this kernel). A split step gives bins 0..n_fft/2 and their magnitudes, and
// each (frame, mel) output sums only its filter's nonzero band in ascending
// bin order. All arithmetic is true float32 on the CUDA cores: TF32 tensor
// cores would lose the near-cancelling low bins of the x32768 signal, and no
// table is computed on the card (no __sinf/__cosf).
//
// What bounds it on the H100: not bytes (4*hop audio + 4*n_mels feature
// bytes a frame) and not operations (about 14 kflop a frame at n_fft 512
// with the band-limited mel sum, under a fifth of a microsecond for 1000
// frames at 67 TFLOP/s), but latency: a block is a chain of 4 + n_stages
// phases split by barriers, each a few shared-memory round trips with one to
// four items a thread. TF = 4 keeps the chain short and puts 50 blocks on a
// 2 s upload (250 at 10 s), all resident at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 4;          // frames per block
constexpr int THREADS = 256;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i * a

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ x, const float* __restrict__ window,
              const float2* __restrict__ tw, const int* __restrict__ plan,
              const float* __restrict__ melT, const int* __restrict__ bands,
              float* __restrict__ out, int N, int T, int hop, int n_fft, int n_mels,
              float log_floor, float rescale, float preemph, float first_coef) {
  extern __shared__ __align__(16) float smem[];
  const bool packed = (n_fft & 1) == 0;
  const int nc = packed ? n_fft / 2 : n_fft;   // complex points per frame
  const int n_bins = n_fft / 2 + 1;
  const int span = (TF - 1) * hop + n_fft;
  float2* src = reinterpret_cast<float2*>(smem);
  float2* dst = src + TF * nc;
  float* samples = reinterpret_cast<float*>(dst + TF * nc);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, T - t0);
  const float* xb = x + (int64_t)b * N;
  const int64_t base = (int64_t)t0 * hop;

  // 1. the tile's samples, rescaled and pre-emphasized
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const int64_t s = base + i;
    float v = 0.0f;
    if (s < N) {
      const float cur = __fmul_rn(xb[s], rescale);
      v = s == 0 ? __fmul_rn(cur, first_coef)
                 : __fsub_rn(cur, __fmul_rn(preemph, __fmul_rn(xb[s - 1], rescale)));
    }
    samples[i] = v;
  }
  __syncthreads();

  // 2. windowed frames as complex points (frames past T are computed, not stored)
  for (int i = threadIdx.x; i < TF * nc; i += THREADS) {
    const int f = i / nc, m = i - f * nc;
    const float* fr = samples + f * hop;
    src[i] = packed ? make_float2(__fmul_rn(fr[2 * m], window[2 * m]),
                                  __fmul_rn(fr[2 * m + 1], window[2 * m + 1]))
                    : make_float2(__fmul_rn(fr[m], window[m]), 0.0f);
  }
  __syncthreads();

  // 3. Stockham stages: point j + r*nr (twiddled by tw[r*Ns + j%Ns]) goes
  //    through a radix-R DFT to (j - j%Ns)*R + j%Ns + k*Ns
  const int n_stages = plan[0];
  for (int s = 0; s < n_stages; ++s) {
    const int radix = plan[2 + 4 * s], ns = plan[3 + 4 * s];
    const float2* twid = tw + plan[4 + 4 * s];
    const float2* roots = tw + plan[5 + 4 * s];
    const int nr = nc / radix;
    if (radix == 4) {
      for (int i = threadIdx.x; i < TF * nr; i += THREADS) {
        const int f = i / nr, j = i - f * nr, jm = j % ns;
        const float2* in = src + f * nc + j;
        float2 v0 = in[0], v1 = in[nr], v2 = in[2 * nr], v3 = in[3 * nr];
        if (ns > 1) {
          v1 = cmul(v1, __ldg(twid + ns + jm));
          v2 = cmul(v2, __ldg(twid + 2 * ns + jm));
          v3 = cmul(v3, __ldg(twid + 3 * ns + jm));
        }
        const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
        const float2 a2 = cadd(v1, v3), a3 = cmul_neg_i(csub(v1, v3));
        float2* o = dst + f * nc + (j - jm) * 4 + jm;
        o[0] = cadd(a0, a2);
        o[ns] = cadd(a1, a3);
        o[2 * ns] = csub(a0, a2);
        o[3 * ns] = csub(a1, a3);
      }
    } else if (radix == 2) {
      for (int i = threadIdx.x; i < TF * nr; i += THREADS) {
        const int f = i / nr, j = i - f * nr, jm = j % ns;
        const float2* in = src + f * nc + j;
        float2 v0 = in[0], v1 = in[nr];
        if (ns > 1) v1 = cmul(v1, __ldg(twid + ns + jm));
        float2* o = dst + f * nc + (j - jm) * 2 + jm;
        o[0] = cadd(v0, v1);
        o[ns] = csub(v0, v1);
      }
    } else {
      // any other prime: each thread computes one output k of one j
      for (int i = threadIdx.x; i < TF * nc; i += THREADS) {
        const int f = i / nc, rest = i - f * nc;
        const int k = rest / nr, j = rest - k * nr, jm = j % ns;
        const float2* in = src + f * nc + j;
        float2 acc = in[0];
        int e = 0;  // r*k mod radix
        for (int r = 1; r < radix; ++r) {
          float2 v = in[r * nr];
          if (ns > 1) v = cmul(v, __ldg(twid + r * ns + jm));
          e += k;
          if (e >= radix) e -= radix;
          acc = cadd(acc, cmul(v, __ldg(roots + e)));
        }
        dst[f * nc + (j - jm) * radix + jm + k * ns] = acc;
      }
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }

  // 4. bins 0..n_fft/2 (split step when packed) and their magnitudes
  float* mag = reinterpret_cast<float*>(dst);   // TF*n_bins <= 2*TF*nc floats
  const float2* split = tw + plan[1];
  for (int i = threadIdx.x; i < TF * n_bins; i += THREADS) {
    const int f = i / n_bins, k = i - f * n_bins;
    const float2* z = src + f * nc;
    float2 X;
    if (packed) {
      const float2 a = z[k == nc ? 0 : k];
      const float2 c = z[k == 0 ? 0 : nc - k];   // conj(Z[(nc - k) % nc])
      const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 d = make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y));
      X = cadd(e, cmul(__ldg(split + k), cmul_neg_i(d)));
    } else {
      X = z[k];
    }
    mag[f * n_bins + k] = sqrtf(X.x * X.x + X.y * X.y);
  }
  __syncthreads();

  // 5. mel over each filter's nonzero band, log floor
  for (int i = threadIdx.x; i < nf * n_mels; i += THREADS) {
    const int f = i / n_mels, m = i - f * n_mels;
    const float* mrow = mag + f * n_bins;
    const int hi = __ldg(bands + 2 * m + 1);
    float acc = 0.0f;
    for (int k = __ldg(bands + 2 * m); k < hi; ++k) {
      acc = fmaf(mrow[k], __ldg(melT + (int64_t)k * n_mels + m), acc);
    }
    out[((int64_t)b * T + t0 + f) * n_mels + m] = logf(fmaxf(log_floor, acc));
  }
}

}  // namespace

extern "C" int logmel_f32(const void* x, const void* window, const void* tw,
                          const void* plan, const void* melT, const void* bands,
                          void* out, int B, int N, int T, int hop, int n_fft,
                          int n_mels, float log_floor, float rescale,
                          float preemph, float first_coef, void* stream) {
  const int nc = n_fft % 2 == 0 ? n_fft / 2 : n_fft;
  const int span = (TF - 1) * hop + n_fft;
  const size_t smem = sizeof(float2) * 2 * TF * (size_t)nc + sizeof(float) * (size_t)span;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + TF - 1) / TF, B);
  logmel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)window, (const float2*)tw, (const int*)plan,
      (const float*)melT, (const int*)bands, (float*)out, N, T, hop, n_fft,
      n_mels, log_floor, rescale, preemph, first_coef);
  return (int)cudaGetLastError();
}
