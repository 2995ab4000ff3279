// Fused masked multi-head attention pooling (forward) for Hopper (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel `_kernel` /
// `_mha_pool_fused_fwd_impl` / `mha_pool_pallas` in
// doubleattentionspeakerverification_tpu/ops/pooling_pallas.py.
//
// In:  ht      (B, T, H, d_h) float32 or bfloat16 (upcast on use)
//      q       (H, d_h) float32, the transposed query with the score scale
//              already folded in
//      lengths (B,) int32; steps t >= lengths[b] are masked (lengths clamp
//              to [0, T])
// Out: out     (B, H, d_h) float32,
//      out[b,h,:] = sum_t softmax_t(<ht[b,t,h,:], q[h,:]>) * ht[b,t,h,:]
//      over the valid steps; a row with no valid step gives zeros, as the
//      Pallas kernel's acc / max(l, 1e-30) does.
//
// What bounds it on the H100: memory, in principle. Every valid (t, h) row
// of ht is read once for one dot product and one weighted add, about 1 flop
// a byte. At the serving shapes (B = 8, 0.3 to 28 MB) the bytes take 0.2 to
// 8.4 microseconds, so below the longest bucket what is left to design
// against is latency: the launch, the length load, one load round trip, the
// instructions a warp issues on its own, and the combine.
//
// Design: the work follows the valid steps. A block is (rank r, group of G
// heads, batch row b); the R ranks of one (group, row) form a thread block
// cluster of R blocks on neighbouring SMs. Each rank reads lengths[b] on the
// device and takes ceil(len / R) consecutive valid steps, and only those are
// loaded; inside the block S warps per head, each split into NG chains of LG
// lanes (NG = 4 chains of 8 lanes while a lane's share of one step stays
// small, else one of 32), take every (S * NG)-th of the rank's steps. A
// row's valid steps are so spread over R * S * NG chains. The wrapper
// chooses G, S and R (powers of two) from the batch and T
// (ops/mha_pool.py launch_plan).
//   - Lane i of a chain owns the pieces VEC * (i + LG k), k < KP, of its
//     head's d_h values: 16 bytes each (4 float32 or 8 bfloat16) where ht
//     and q are 16-byte aligned and d_h values are whole pieces, else single
//     values (VEC = 1). A lane's loads for a chunk of CH steps of its chain
//     go straight into registers, all at once, and two chunk buffers take
//     turns so that the next chunk's loads are in flight during this one's
//     math; each byte is read once, used twice, and never staged in shared
//     memory (staging made the SM's shared-memory bandwidth the limit when
//     long blocks shared an SM).
//   - A chunk's scores come out at once: each lane's partial dot products,
//     reduced over the chain's LG lanes together; log2(e) is folded into the
//     scores so that the softmax runs on exp2. The warp's chains share one
//     running maximum (the chunk's maximum over the warp), so acc is
//     rescaled only when it grows, and at the end the chains' (l, acc) add
//     up in registers. No block barrier in the loop.
//   - Combine: rank f finalises 1/R of the block's (G, d_h) outputs from the
//     R * S warps' partial (m, l, acc): it rescales them by exp2(m_i - M)
//     and divides by max(L, 1e-30). Within a cluster every warp stores its
//     partial of rank f's part with st.async straight into rank f's shared
//     memory, each store counting its bytes on rank f's mbarrier, and rank f
//     waits for the bytes of all R * S partials; one cluster barrier, arrived
//     at once the mbarrier is set and waited on just before the first store,
//     makes sure every peer can take them. With R = 1 the warps store into
//     their own block's shared memory behind one block barrier, and with
//     R = S = 1 a warp's state is its head's result. No workspace, no
//     atomics, one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;        // G * S warps a block
constexpr int MAX_RANKS = 2;        // ranks a cluster: 1 or 2 (ops/mha_pool.py's plan)
constexpr int MAX_PARTS = 16;       // partial states combined, R * S
constexpr int CHUNK = 8;            // steps of a chain loaded at once, at most
constexpr int MAX_WIDTH = 1280;     // G * d_h a block: G = 8 at d_h = 160
constexpr int MAX_HEAD = 512;       // d_h
constexpr int MAX_X = 32;           // values of a chunk a lane holds: CH * KP * VEC
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into dynamic shared memory: the combine's mbarrier, then what
// the R * S partials store here: their acc of this rank's part (share pieces
// each) and their (m, l) of every head.
struct Layout {
  int acc, ml, total;
};

__host__ __device__ inline int share_of(int G, int d_h, int vec, int R) {
  return ((G * d_h) / vec + R - 1) / R;          // pieces a rank finalises
}

__host__ __device__ inline Layout layout(int G, int S, int R, int d_h, int vec, int share) {
  Layout L;
  L.acc = 16;
  L.ml = L.acc + align16(R * S * share * vec * 4);
  L.total = L.ml + R * S * G * 8;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this CTA's shared-memory address `addr` in rank `rank`'s
// shared memory, and a store through it.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Stores into a rank's shared memory (addresses from map_rank) that count
// their bytes on that rank's mbarrier `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(addr), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               :: "r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t addr, const float* v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(addr), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar) : "memory");
}

// VEC float32 values at p from or to shared or global memory, 16 bytes at
// a time where VEC is a multiple of 4.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + v);
      x[v] = u.x; x[v + 1] = u.y; x[v + 2] = u.z; x[v + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = p[v];
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* x) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; v += 4)
      *reinterpret_cast<float4*>(p + v) = make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) p[v] = x[v];
  }
}

// One piece of VEC values of ht at p, as float32: 16 bytes at once for a
// whole piece, else one value.
template <int VEC>
__device__ __forceinline__ void load_piece(const float* p, float* x) { load_f32<VEC>(p, x); }

template <int VEC>
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float* x) {
  static_assert(VEC == 8 || VEC == 1, "bfloat16 pieces are 8 values or 1");
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

// The combine's last step, for P = R * S partial states in shared memory:
// rank r's pieces [r * share, r * share + mine) of the block's span (o),
// each rescaled by exp2(m_p - M) and divided by max(L, 1e-30). P is a
// template argument so that the partials' loads all go out at once.
template <int P, int VEC>
__device__ __forceinline__ void finalize(const unsigned char* smem, const Layout& L, int G,
                                         int d_h, int share, int r, int mine, float* o) {
  const float* acc_s = reinterpret_cast<const float*>(smem + L.acc);
  const float2* ml_s = reinterpret_cast<const float2*>(smem + L.ml);
  const float inv_dh = 1.0f / (float)d_h;
  for (int t = threadIdx.x; t < mine; t += blockDim.x) {
    // e / d_h, exactly: e < 2^11, so (e + 0.5) / d_h is at least 1 / (2 d_h)
    // from the next integer, far above float32's rounding.
    const int e = (r * share + t) * VEC;
    const int hh = (int)((e + 0.5f) * inv_dh);
    float2 ml[P];
    float M = NEG_BIG;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ml[p] = ml_s[p * G + hh];
      M = fmaxf(M, ml[p].x);
    }
    float den = 0.0f, a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float y[VEC];
      load_f32<VEC>(acc_s + (p * share + t) * VEC, y);
      const float c = exp2f(ml[p].x - M);
      den = fmaf(ml[p].y, c, den);
#pragma unroll
      for (int v = 0; v < VEC; ++v) a[v] = fmaf(y[v], c, a[v]);
    }
    const float inv = __fdividef(1.0f, fmaxf(den, 1e-30f));
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] *= inv;
    store_f32<VEC>(o + e, a);
  }
}

// VEC = 16 / sizeof(T) needs d_h * sizeof(T) % 16 == 0 and ht and q
// 16-byte aligned; VEC = 1 takes any shape. A chain is LG lanes (8, 16 or 32) of
// a warp, KP * LG * VEC >= d_h. The block is G * S warps, S = 1 << s_log:
// warp w takes head w / S; R = 1 << r_log ranks, R * S <= MAX_PARTS.
template <typename T, int VEC, int LG, int KP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
mha_pool_kernel(const T* __restrict__ ht, const float* __restrict__ q,
                const int* __restrict__ lengths, float* __restrict__ out,
                int T_len, int H, int d_h, int G, int s_log, int r_log) {
  constexpr int NG = 32 / LG;                    // chains a warp
  constexpr int NG_LOG = NG == 4 ? 2 : NG == 2 ? 1 : 0;
  constexpr int CH = MAX_X / (KP * VEC) < CHUNK ? MAX_X / (KP * VEC) : CHUNK;   // rows a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const int len_b = lengths[b];
  const int R = 1 << r_log;                      // the cluster is (R, 1, 1) = gridDim.x
  const int S = 1 << s_log;
  const int h0 = blockIdx.y * G;
  const int gh = min(G, H - h0);                 // heads of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = warp >> s_log, w = warp & (S - 1);
  const int g = lane / LG, i = lane % LG;        // chain g of the warp, lane i of the chain
  const bool live = h < gh;

  // This lane's slice of its head's q: pieces VEC * (i + LG * k). Its loads
  // go out right behind the length's, so that the two round trips overlap.
  float qr[KP][VEC], acc[KP][VEC];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int d = VEC * (i + LG * k);
    if (live && d < d_h) {
      load_f32<VEC>(q + (int64_t)(h0 + h) * d_h + d, qr[k]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) qr[k][v] = 0.0f;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;
  }
  const int r = R > 1 ? (int)cluster_rank() : 0;
  const int np = gh * d_h / VEC;                 // pieces of one step's span
  const int share = (G * d_h / VEC + R - 1) >> r_log;   // pieces a rank finalises
  const int mine = max(0, min(share, np - r * share));   // pieces this rank finalises
  const Layout L = layout(G, S, R, d_h, VEC, share);
  const uint32_t base = smem_u32(smem);          // the mbarrier, then L.acc, L.ml
  if (R > 1) {
    if (tid == 0) {
      mbar_init(base, 1);
      mbar_arrive_expect_tx(base, (uint32_t)(R * S * (mine * VEC * 4 + gh * 8)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive();                            // the mbarrier is set
  }

  // This rank's steps: [t0, t0 + n) of the row's len valid steps, split
  // over C = S * NG chains; chain c = w * NG + g takes steps t0 + c + C * j,
  // j < steps. Only those are loaded. A chunk is CH rows j of every chain of
  // the warp (the warp's first chain has the most, `rows`); a step past a
  // chain's end, and a piece past d_h, is zero and gets weight 0.
  const int len = min(max(len_b, 0), T_len);
  const int per = (len + R - 1) >> r_log;
  const int t0 = min(len, r * per);
  const int n = min(len, t0 + per) - t0;
  const int c_log = s_log + NG_LOG, C = 1 << c_log, c = w * NG + g;
  const int steps = live && n > c ? (n - c + C - 1) >> c_log : 0;          // this chain's
  const int rows = live && n > w * NG ? (n - w * NG + C - 1) >> c_log : 0;  // the warp's most
  const int64_t step = (int64_t)H * d_h;                        // values between steps
  const T* src = ht + ((int64_t)b * T_len + t0 + c) * step + (int64_t)(h0 + h) * d_h;
  auto load = [&](float (&dst)[CH][KP][VEC], int c0) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const T* row = src + (int64_t)(C * (c0 + j)) * step;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int d = VEC * (i + LG * k);
        if (c0 + j < steps && d < d_h) {
          load_piece<VEC>(row + d, dst[j][k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) dst[j][k][v] = 0.0f;
        }
      }
    }
  };
  float xa[CH][KP][VEC], xb[CH][KP][VEC];       // two chunk buffers, taking turns
  load(xa, 0);
  load(xb, CH);
  // A chunk's scores at once (log2(e) folded in, so the softmax runs on
  // exp2), one maximum for the whole warp, so that its chains share m and
  // combine by plain sums; acc is rescaled only when that maximum grows.
  float m = NEG_BIG, l = 0.0f;
  auto scores = [&](const float (&x)[CH][KP][VEC], float (&s)[CH]) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float sv[VEC];                             // VEC short chains, not one long one
#pragma unroll
      for (int v = 0; v < VEC; ++v) sv[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) sv[v] = fmaf(x[j][k][v], qr[k][v], sv[v]);
      s[j] = sv[0];
#pragma unroll
      for (int v = 1; v < VEC; ++v) s[j] += sv[v];
    }
#pragma unroll
    for (int off = LG / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < CH; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
#pragma unroll
    for (int j = 0; j < CH; ++j) s[j] *= LOG2E;
  };
  auto top = [&](const float (&s)[CH], int c0, float mx) {   // over this chain's steps
#pragma unroll
    for (int j = 0; j < CH; ++j) mx = c0 + j < steps ? fmaxf(mx, s[j]) : mx;
    return mx;
  };
  auto lift = [&](float m_new) {                 // to the warp's maximum
#pragma unroll
    for (int off = LG; off < 32; off <<= 1)
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
    if (m_new > m) {                             // warp-uniform
      if (m > NEG_BIG) {
        const float corr = exp2f(m - m_new);
        l *= corr;
#pragma unroll
        for (int k = 0; k < KP; ++k)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[k][v] *= corr;
      }
      m = m_new;
    }
  };
  auto accumulate = [&](const float (&x)[CH][KP][VEC], const float (&s)[CH], int c0) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float p = c0 + j < steps ? exp2f(s[j] - m) : 0.0f;
      l += p;
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(p, x[j][k][v], acc[k][v]);
    }
  };
  if (rows > 0 && rows <= 2 * CH) {
    // Both buffers hold every step: one step of math over both, so that
    // their scores' chains run side by side.
    float sa[CH], sb[CH];
    scores(xa, sa);
    scores(xb, sb);
    lift(top(sb, CH, top(sa, 0, m)));
    accumulate(xa, sa, 0);
    accumulate(xb, sb, CH);
  } else {
    // A buffer's next loads go out as soon as its chunk is done, so that two
    // chunks are in flight during the math.
    auto chunk = [&](const float (&x)[CH][KP][VEC], int c0) {
      float s[CH];
      scores(x, s);
      lift(top(s, c0, m));
      accumulate(x, s, c0);
    };
#pragma unroll 1
    for (int c0 = 0; c0 < rows; c0 += 2 * CH) {   // warp-uniform: every lane shuffles
      chunk(xa, c0);
      if (c0 + CH >= rows) break;
      load(xa, c0 + 2 * CH);
      chunk(xb, c0 + CH);
      load(xb, c0 + 3 * CH);
    }
  }

  // The warp's NG chains share m: their (l, acc) add up in registers, and
  // then every chain holds the warp's state; chain g writes pieces k = g
  // (mod NG).
  if constexpr (NG > 1) {
#pragma unroll
    for (int off = LG; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] += __shfl_xor_sync(0xffffffffu, acc[k][v], off);
    }
  }

  if (R == 1 && S == 1) {   // one warp a head: its state is the result
    if (live) {
      const float inv = __fdividef(1.0f, fmaxf(l, 1e-30f));
      float* o = out + ((int64_t)b * H + h0 + h) * d_h;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int d = VEC * (i + LG * k);
        if (k % NG == g && d < d_h) {
          float y[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) y[v] = acc[k][v] * inv;
          store_f32<VEC>(o + d, y);
        }
      }
    }
    return;
  }

  // Partial p = r * S + w of the R * S: its acc pieces of rank f's part go
  // to slot (p * share + piece - f * share), its (m, l) of head h to slot
  // (p * G + h), in rank f's shared memory. With one rank the block's own
  // warps are the only partials: plain stores and a block barrier.
  if (R == 1) {
    if (live) {
      float* acc_s = reinterpret_cast<float*>(smem + L.acc);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int d = VEC * (i + LG * k);
        if (k % NG == g && d < d_h) store_f32<VEC>(acc_s + (w * share * VEC + h * d_h + d), acc[k]);
      }
      if (lane == 0) reinterpret_cast<float2*>(smem + L.ml)[w * G + h] = make_float2(m, l);
    }
    __syncthreads();
  } else {
    cluster_wait();                              // every peer's mbarrier is set
    if (live) {
      const int p = r * S + w;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int d = VEC * (i + LG * k);
        if (k % NG == g && d < d_h) {
          const int piece = (h * d_h + d) / VEC;
          const int f = piece / share;
          const uint32_t bar = map_rank(base, f);
          const uint32_t dst = bar + L.acc + 4 * VEC * (p * share + piece - f * share);
          if constexpr (VEC >= 4) {
#pragma unroll
            for (int v = 0; v < VEC; v += 4) st_async4(dst + 4 * v, acc[k] + v, bar);
          } else {
            st_async(dst, acc[k][0], bar);
          }
        }
      }
      if (lane < R) {
        const uint32_t bar = map_rank(base, lane);
        st_async2(bar + L.ml + 8 * (p * G + h), m, l, bar);
      }
    }
    mbar_wait(base, 0);   // every partial of this rank's part has landed
  }

  // Rank r's part: pieces [r * share, r * share + mine) of the block's span,
  // from the R * S partial states, all read at once.
  float* o = out + ((int64_t)b * H + h0) * d_h;
  const int parts = R * S;                       // 2, 4, 8 or 16
  if (parts == 2) finalize<2, VEC>(smem, L, G, d_h, share, r, mine, o);
  else if (parts == 4) finalize<4, VEC>(smem, L, G, d_h, share, r, mine, o);
  else if (parts == 8) finalize<8, VEC>(smem, L, G, d_h, share, r, mine, o);
  else finalize<16, VEC>(smem, L, G, d_h, share, r, mine, o);
}

cudaLaunchConfig_t config(int B, int H, int d_h, int G, int S, int R, int vec,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, (H + G - 1) / G, B);
  cfg.blockDim = dim3(32 * G * S);
  cfg.dynamicSmemBytes = layout(G, S, R, d_h, vec, share_of(G, d_h, vec, R)).total;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid(int B, int T_len, int H, int d_h, int G, int S, int R, int vec, int elt) {
  return B > 0 && B <= 65535 && T_len >= 0 && H > 0 && d_h > 0 && d_h <= MAX_HEAD && G > 0 &&
         S > 0 && (S & (S - 1)) == 0 && G * S <= MAX_WARPS && G * d_h <= MAX_WIDTH &&
         (H + G - 1) / G <= 65535 && R >= 1 && (R & (R - 1)) == 0 && R <= MAX_RANKS &&
         R * S <= MAX_PARTS &&
         (vec == 1 || (vec == 16 / elt && (d_h * elt) % 16 == 0));
}

// The instantiation for a piece of `vec` values and d_h: chains of 8 or 16
// lanes (four or two a warp) while a lane's pieces of one step stay few,
// else of 32; the fewest pieces a lane can own. ops/mha_pool.py's
// chain_lanes mirrors it.
template <typename T, int VEC>
const void* pick(int d_h) {
  const int pieces = d_h / VEC;
  if constexpr (VEC == 4) {
    if (pieces <= 16) return (const void*)mha_pool_kernel<T, 4, 8, 2>;
    if (pieces <= 48) return (const void*)mha_pool_kernel<T, 4, 16, 3>;
    return (const void*)mha_pool_kernel<T, 4, 32, MAX_HEAD / 128>;
  } else if constexpr (VEC == 8) {
    if (pieces <= 16) return (const void*)mha_pool_kernel<T, 8, 8, 2>;
    if (pieces <= 32) return (const void*)mha_pool_kernel<T, 8, 16, 2>;
    return (const void*)mha_pool_kernel<T, 8, 32, MAX_HEAD / 256>;
  } else {
    if (pieces <= 16) return (const void*)mha_pool_kernel<T, 1, 8, 2>;
    if (pieces <= 64) return (const void*)mha_pool_kernel<T, 1, 16, 4>;
    return (const void*)mha_pool_kernel<T, 1, 32, MAX_HEAD / 32>;
  }
}

const void* pick(int ht_is_bf16, int vec, int d_h) {
  if (ht_is_bf16) return vec > 1 ? pick<__nv_bfloat16, 8>(d_h) : pick<__nv_bfloat16, 1>(d_h);
  return vec > 1 ? pick<float, 4>(d_h) : pick<float, 1>(d_h);
}

}  // namespace

// ht_is_bf16: 0 for float32 ht, 1 for bfloat16 ht. G heads a block, S warps
// a head and R ranks a cluster (each a power of two); vec the values of a
// lane's piece: 16 bytes' worth (4 float32, 8 bfloat16) where ht and q are
// 16-byte aligned and d_h values are whole 16-byte pieces (the wrapper's
// plan), else 1.
extern "C" int mha_pool_fwd(const void* ht, const void* q, const void* lengths, void* out,
                            int B, int T_len, int H, int d_h, int ht_is_bf16, int G, int S,
                            int R, int vec, void* stream) {
  const int elt = ht_is_bf16 ? 2 : 4;
  if (!valid(B, T_len, H, d_h, G, S, R, vec, elt) ||
      (vec > 1 && (((uintptr_t)ht) % 16 || ((uintptr_t)q) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B, H, d_h, G, S, R, vec, (cudaStream_t)stream, &attr);
  int s_log = 0, r_log = 0;
  while ((1 << s_log) < S) ++s_log;
  while ((1 << r_log) < R) ++r_log;
  void* args[] = {(void*)&ht, (void*)&q, (void*)&lengths, (void*)&out, &T_len, &H, &d_h, &G,
                  &s_log, &r_log};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, pick(ht_is_bf16, vec, d_h), args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
