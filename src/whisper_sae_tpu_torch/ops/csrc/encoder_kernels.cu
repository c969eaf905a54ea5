// Hand-written Hopper kernels of the Whisper-encoder extraction path.
//
// conv_stem_kernel<64, 80> ("conv_stem_fwd", D <= 512) and its wide form
// conv_stem_kernel<32, 33> (512 < D <= 1536)
//   replace whisper_sae_tpu/ops/pallas_encoder.py:_conv_stem_kernel
//   (fused_conv_stem, pallas_call at :604).
// ln_rows_kernel ("wst_ln_rows_fwd")  LN1 of the attention block, ahead of
//   the q/k/v product; with the Hopper GEMM of encoder_gemm.cu (q/k/v and
//   the out-projection) and the core of attention_kernel.cu it replaces
//   _attention_block_kernel and _attention_block_kernel_tiled
//   (fused_attention_block, pallas_call at :340).
// wst_mlp_block_fwd    the MLP block at every width the fused route takes
//   (D and F multiples of 128, D <= 1536), all four output modes: LN2
//   (ln_rows_kernel, also the mlp_in capture), fc1 with GELU into a bf16
//   [rows, F] hidden in device memory (encoder_gemm.cu, kGelu), fc2 with
//   the bias and the residual (kResidual, also the mlp_out capture) and,
//   when asked, the final-LN capture (ln_rows_kernel): four launches of
//   one C call.  It replaces _mlp_block_kernel (fused_mlp_block,
//   pallas_call at :500).
//
// Numerics are the Pallas kernels': bf16 operands with f32 sums, every
// bias added in f32 before the single rounding to bf16, LN (eps 1e-5,
// population variance) in f32, exact erff GELU (the TPU kernels' erf
// polynomial, 3.4e-5, is a Mosaic workaround), the residual add rounded
// once to bf16, and the final-LN capture taken from the bf16-rounded
// layer output.
//
// Bounds on the H100 at whisper-tiny, 64 clips (T=1500, D=384, F=1536;
// 989 TFLOP/s bf16, 3.35 TB/s): both are bound by operations.
//   MLP block        4*(64*T)*D*F           = 226 GFLOP   0.23 ms
//   conv stem        2*64*T*D*(3*80+3*D)    = 103 GFLOP   0.10 ms
// At whisper-large-v3, 8 clips (D=1280, F=5120, 128 mels) a layer's MLP
// block is 315 GFLOP (0.32 ms) and the stem 130 GFLOP (0.13 ms).  An LN
// pass reads a row and writes it once (bytes: 0.03 ms for 96,000 rows of
// 384), one warp a row holding it in registers.
//
// The stem's design: its products run on the tensor cores (mma.sync,
// warp_gemm) from a tile of frames staged once in shared memory, the
// weights streaming from L2 as 32-bit B fragments in the [N, K] layout;
// the [T_mel, D] hidden never reaches device memory.  Its 64-frame tile
// needs 2 x 80 rows of h in shared memory (412 KB at D=1280); the wide
// form takes 32 output frames a CTA and keeps the 33 h rows of each
// parity conv2 reads (231,008 B at D=1536 and 128 mels, under the
// 232,448 B a block may have).  The stem is the one product left on
// mma.sync; encoder_gemm.cu's GEMM is its next candidate (conv2 is three
// shifted products of the stride-2 h rows, K = 3D).
//
// The MLP block's design: every product on the warp-specialised
// wgmma/TMA GEMM of encoder_gemm.cu, whose notes give its bounds and why
// one route serves every width (the hidden's round trip, 2 x rows x F x
// 2 bytes, against a fused kernel that would re-read both weights every
// 64 rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "encoder_gemm.cuh"

namespace wst_enc {

using wst_gemm::bf16_t;
using wst_gemm::bf2f;
using wst_gemm::gelu;
using wst_gemm::pack2;

constexpr int kWarp = 32;
constexpr float kLnEps = 1e-5f;

// the stem and the LN rows: 8 warps a CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kColTile = 32;  // columns per warp step: four n8 MMA tiles
constexpr int kStemNarrowMax = 512;  // widest D of the 64-frame stem
constexpr int kWideMax = 1536;       // widest D of the encoder kernels (the fused route's gate)

// the attention core's head dim (ops/csrc/attention_kernel.cu)
constexpr int kHeadDim = 64;

__device__ __forceinline__ bf16_t f2bf(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }
__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ void st32(bf16_t* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[m][t] += A[m*16 .. +16, 0 .. 16*ksteps) . Bt[t*8 .. +8, same k]^T
//   a:  shared memory, row-major with stride lda, at the warp tile's (row 0, k 0)
//   bt: global, [N, K] row-major with stride ldb, at (the warp's n0, k 0)
// The next k-step's B fragments load while this step's MMAs run.
template <int MT, int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const bf16_t* a, int lda,
                                          const bf16_t* bt, int ldb, int ksteps, int lane) {
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const bf16_t* ap = a + fr * lda + fc;
  const bf16_t* bp = bt + (size_t)fr * ldb + fc;
  uint32_t b[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    b[t][0] = ldg32(bp + (size_t)t * 8 * ldb);
    b[t][1] = ldg32(bp + (size_t)t * 8 * ldb + 8);
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    const int kn = ks + 1 < ksteps ? k0 + 16 : k0;
    uint32_t bn[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      bn[t][0] = ldg32(bp + (size_t)t * 8 * ldb + kn);
      bn[t][1] = ldg32(bp + (size_t)t * 8 * ldb + kn + 8);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16_t* am = ap + m * 16 * lda + k0;
      const uint32_t a0 = ld32(am), a1 = ld32(am + 8 * lda);
      const uint32_t a2 = ld32(am + 8), a3 = ld32(am + 8 * lda + 8);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma16816(acc[m][t], a0, a1, a2, a3, b[t][0], b[t][1]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      b[t][0] = bn[t][0];
      b[t][1] = bn[t][1];
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.0f;
}

// LN in f32 of one row by one warp (two passes over the row held in
// registers: mean, then population variance, as jnp.mean / jnp.var),
// stored bf16 (dst_bf) or f32 (dst_f32).  D = 128 P: lane l holds columns
// 128i + 4l .. +4 for i < P, read as one 8-byte piece each.
template <int P>
__device__ __forceinline__ void ln_row(const bf16_t* src, const float* g, const float* b,
                                       bf16_t* dst_bf, float* dst_f32, int lane) {
  float v[P][4];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const uint2 u = *reinterpret_cast<const uint2*>(src + 128 * i + 4 * lane);
    v[i][0] = bf2f((bf16_t)(u.x & 0xffffu));
    v[i][1] = bf2f((bf16_t)(u.x >> 16));
    v[i][2] = bf2f((bf16_t)(u.y & 0xffffu));
    v[i][3] = bf2f((bf16_t)(u.y >> 16));
    s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  }
  constexpr float d = 128 * P;
  const float mean = warp_sum(s) / d;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dv = v[i][j] - mean;
      q = fmaf(dv, dv, q);
    }
  }
  const float rs = rsqrtf(warp_sum(q) / d + kLnEps);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int c = 128 * i + 4 * lane;
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + c));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + c));
    const float y0 = (v[i][0] - mean) * rs * gg.x + bb.x;
    const float y1 = (v[i][1] - mean) * rs * gg.y + bb.y;
    const float y2 = (v[i][2] - mean) * rs * gg.z + bb.z;
    const float y3 = (v[i][3] - mean) * rs * gg.w + bb.w;
    if (dst_f32)
      *reinterpret_cast<float4*>(dst_f32 + c) = make_float4(y0, y1, y2, y3);
    else
      *reinterpret_cast<uint2*>(dst_bf + c) = make_uint2(pack2(y0, y1), pack2(y2, y3));
  }
}

// ---------------------------------------------------------------------------
// LN rows: LN1, LN2 and the final-LN capture
// ---------------------------------------------------------------------------

// One warp a row: dst = LN(x row) in f32, stored bf16 (out_bf) or f32
// (D = 128 P up to kWideMax).
template <int P>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(const bf16_t* x, long long n,
                                                           const float* g, const float* b,
                                                           bf16_t* out_bf, float* out_f32) {
  constexpr int d = 128 * P;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long r = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (r >= n) return;
  ln_row<P>(x + r * d, g, b, out_bf ? out_bf + r * d : nullptr,
            out_f32 ? out_f32 + r * d : nullptr, lane);
}

// ---------------------------------------------------------------------------
// conv stem: GELU(conv2(GELU(conv1(mel)))) + pos
// ---------------------------------------------------------------------------

// even/odd: [B, t, n_mels] bf16, the mel's even and odd time columns.
// w1t: [d, 3*n_mels] (tap j in columns j*n_mels ..), w2t: [d, 3*d].
// T_OUT output frames a CTA (t0 ..); conv1 computes T_OUT + 16 h rows of
// each parity (row r is time t0-1+r) from the T_OUT + 18 mel rows t0-2 ..,
// and keeps the first H_KEEP of them, of which conv2 reads rows 0 .. T_OUT.
// h rows outside [0, t) are zero, which is conv2's zero padding on h;
// conv1's padding is the zero mel rows staged outside [0, t).
//   <64, 80>: the narrow form (D <= 512); <32, 33>: the wide form.
template <int T_OUT, int H_KEEP>
__global__ void __launch_bounds__(kThreads, 1) conv_stem_kernel(
    const bf16_t* even, const bf16_t* odd, int t, int n_mels, int d, const bf16_t* w1t,
    const float* b1, const bf16_t* w2t, const float* b2, const bf16_t* pos, bf16_t* out) {
  constexpr int kH = T_OUT + 16, kIn = kH + 2;
  static_assert(H_KEEP > T_OUT && H_KEEP <= kH, "conv2 reads h rows 0 .. T_OUT");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lm = n_mels + 8, lh = d + 8;
  bf16_t* ev = reinterpret_cast<bf16_t*>(smem);
  bf16_t* od = ev + kIn * lm;
  bf16_t* he = od + kIn * lm;
  bf16_t* ho = he + H_KEEP * lh;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const int t0 = blockIdx.x * T_OUT;
  const size_t clip = (size_t)blockIdx.y * t;

  for (int i = threadIdx.x; i < kIn * (n_mels / 2); i += kThreads) {
    const int u = i / (n_mels / 2), c = (i - u * (n_mels / 2)) * 2;
    const int tt = t0 - 2 + u;
    uint32_t e = 0u, o = 0u;
    if (tt >= 0 && tt < t) {
      e = ldg32(even + (clip + tt) * n_mels + c);
      o = ldg32(odd + (clip + tt) * n_mels + c);
    }
    st32(ev + u * lm + c, e);
    st32(od + u * lm + c, o);
  }
  __syncthreads();

  // conv1, even then odd h rows:
  //   h_even[tau] = odd[tau-1] W0 + even[tau] W1 + odd[tau] W2
  //   h_odd[tau]  = even[tau]  W0 + odd[tau]  W1 + even[tau+1] W2
  const int k1 = n_mels / 16, ld1 = 3 * n_mels;
  for (int n0 = warp * kColTile; n0 < d; n0 += kWarps * kColTile) {
    const bf16_t* w = w1t + (size_t)n0 * ld1;
#pragma unroll 1
    for (int par = 0; par < 2; ++par) {
      float acc[kH / 16][4][4];
      zero(acc);
      warp_gemm<kH / 16, 4>(acc, par ? ev + lm : od, lm, w, ld1, k1, lane);
      warp_gemm<kH / 16, 4>(acc, par ? od + lm : ev + lm, lm, w + n_mels, ld1, k1, lane);
      warp_gemm<kH / 16, 4>(acc, par ? ev + 2 * lm : od + lm, lm, w + 2 * n_mels, ld1, k1, lane);
      bf16_t* dst = par ? ho : he;
#pragma unroll
      for (int tl = 0; tl < 4; ++tl) {
        const int col = n0 + tl * 8 + fc;
        const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
        for (int m = 0; m < kH / 16; ++m) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = m * 16 + fr + hh * 8;
            if (r >= H_KEEP) continue;
            const int tau = t0 - 1 + r;
            const uint32_t val = (tau >= 0 && tau < t)
                                     ? pack2(gelu(acc[m][tl][2 * hh] + bb0),
                                             gelu(acc[m][tl][2 * hh + 1] + bb1))
                                     : 0u;
            st32(dst + r * lh + col, val);
          }
        }
      }
    }
  }
  __syncthreads();

  // conv2 (stride 2): out[t0+j] = h_odd[t0+j-1] V0 + h_even[t0+j] V1 + h_odd[t0+j] V2,
  // i.e. h rows j, j+1, j+1 of the tile
  const int k2 = d / 16, ld2 = 3 * d;
  for (int n0 = warp * kColTile; n0 < d; n0 += kWarps * kColTile) {
    const bf16_t* w = w2t + (size_t)n0 * ld2;
    float acc[T_OUT / 16][4][4];
    zero(acc);
    warp_gemm<T_OUT / 16, 4>(acc, ho, lh, w, ld2, k2, lane);
    warp_gemm<T_OUT / 16, 4>(acc, he + lh, lh, w + d, ld2, k2, lane);
    warp_gemm<T_OUT / 16, 4>(acc, ho + lh, lh, w + 2 * d, ld2, k2, lane);
#pragma unroll
    for (int tl = 0; tl < 4; ++tl) {
      const int col = n0 + tl * 8 + fc;
      const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
      for (int m = 0; m < T_OUT / 16; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tt = t0 + m * 16 + fr + hh * 8;
          if (tt >= t) continue;
          const uint32_t pv = ldg32(pos + (size_t)tt * d + col);
          const float o0 = round_bf(gelu(acc[m][tl][2 * hh] + bb0));
          const float o1 = round_bf(gelu(acc[m][tl][2 * hh + 1] + bb1));
          st32(out + (clip + tt) * d + col,
               pack2(o0 + bf2f((bf16_t)(pv & 0xffffu)), o1 + bf2f((bf16_t)(pv >> 16))));
        }
      }
    }
  }
}

template <int T_OUT, int H_KEEP>
size_t stem_smem(int n_mels, int d) {
  return ((size_t)2 * (T_OUT + 18) * (n_mels + 8) + (size_t)2 * H_KEEP * (d + 8)) * sizeof(bf16_t);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_ln_rows(const bf16_t* x, long long n, int d, const float* g, const float* b,
                   bf16_t* out_bf, float* out_f32, cudaStream_t s) {
  if (d <= 0 || d % 128 || d > kWideMax) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  static_assert(kWideMax == 12 * 128, "one instantiation for each D / 128");
  switch (d / 128) {
#define WST_LN_CASE(P) \
  case P: ln_rows_kernel<P><<<blocks, kThreads, 0, s>>>(x, n, g, b, out_bf, out_f32); break;
    WST_LN_CASE(1) WST_LN_CASE(2) WST_LN_CASE(3) WST_LN_CASE(4) WST_LN_CASE(5) WST_LN_CASE(6)
    WST_LN_CASE(7) WST_LN_CASE(8) WST_LN_CASE(9) WST_LN_CASE(10) WST_LN_CASE(11) WST_LN_CASE(12)
#undef WST_LN_CASE
  }
  return (int)cudaGetLastError();
}

template <int T_OUT, int H_KEEP>
int launch_stem(const bf16_t* even, const bf16_t* odd, int b, int t, int n_mels, int d,
                const bf16_t* w1t, const float* b1, const bf16_t* w2t, const float* b2,
                const bf16_t* pos, bf16_t* out, cudaStream_t s) {
  const size_t smem = stem_smem<T_OUT, H_KEEP>(n_mels, d);
  int err = set_smem(conv_stem_kernel<T_OUT, H_KEEP>, smem);
  if (err) return err;
  const dim3 grid((t + T_OUT - 1) / T_OUT, b);
  conv_stem_kernel<T_OUT, H_KEEP><<<grid, kThreads, smem, s>>>(even, odd, t, n_mels, d, w1t, b1,
                                                               w2t, b2, pos, out);
  return (int)cudaGetLastError();
}

}  // namespace wst_enc

extern "C" {

// Geometry the kernels take (checked again in Python before each launch).
int wst_enc_head_dim() { return wst_enc::kHeadDim; }
int wst_enc_narrow_max() { return wst_enc::kStemNarrowMax; }
int wst_enc_wide_max() { return wst_enc::kWideMax; }

// LN of each row of x ([n, d] bf16, D a multiple of 128 up to 1536) in
// f32, stored bf16: the attention block's LN1 ahead of the q/k/v product
// (encoder_gemm.cu).
int wst_ln_rows_fwd(const void* x, long long n, int d, const void* g, const void* b, void* out,
                    void* stream) {
  using namespace wst_enc;
  if (n <= 0) return 0;
  return launch_ln_rows(static_cast<const bf16_t*>(x), n, d, static_cast<const float*>(g),
                        static_cast<const float*>(b), static_cast<bf16_t*>(out), nullptr,
                        static_cast<cudaStream_t>(stream));
}

// The MLP block (D a multiple of 128 up to 1536, F a multiple of 128),
// four launches on ``stream``: LN2 of x ([n, d] bf16) into xln ([n, d]
// bf16: the mlp_in capture, or scratch); fc1 with GELU into hid ([n, f]
// bf16 scratch); fc2 with b2 and the residual into out, and y into
// mlp_out unless it is null; for cap_mode 1 (bf16) or 2 (f32) the final
// LN of out into cap (cap_mode 0: none).  w1t: [f, d], w2t: [d, f] bf16.
int wst_mlp_block_fwd(const void* x, long long n, int d, int f, const void* g, const void* bln,
                      const void* w1t, const void* b1, const void* w2t, const void* b2,
                      const void* fg, const void* fb, int cap_mode, void* out, void* cap,
                      void* xln, void* hid, void* mlp_out, void* stream) {
  using namespace wst_enc;
  if (n <= 0) return 0;
  if (d <= 0 || d % 128 || d > kWideMax || f <= 0 || f % 128 || cap_mode < 0 || cap_mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16_t* xl = static_cast<bf16_t*>(xln);
  int err = launch_ln_rows(static_cast<const bf16_t*>(x), n, d, static_cast<const float*>(g),
                           static_cast<const float*>(bln), xl, nullptr, s);
  if (!err)
    err = wst_enc_gemm_fwd(wst_gemm::kGelu, xl, w1t, n, f, d, b1, 1.0f, d, hid, nullptr, nullptr,
                           nullptr, stream);
  if (!err)
    err = wst_enc_gemm_fwd(wst_gemm::kResidual, hid, w2t, n, d, f, b2, 1.0f, d, out, mlp_out,
                           nullptr, x, stream);
  if (!err && cap_mode)
    err = launch_ln_rows(static_cast<const bf16_t*>(out), n, d, static_cast<const float*>(fg),
                         static_cast<const float*>(fb),
                         cap_mode == 1 ? static_cast<bf16_t*>(cap) : nullptr,
                         cap_mode == 2 ? static_cast<float*>(cap) : nullptr, s);
  return err;
}

// The conv stem: 64 output frames a CTA up to D = 512, 32 above (the
// wide form), D a multiple of 32 up to 1536.
int wst_conv_stem_fwd(const void* even, const void* odd, int b, int t, int n_mels, int d,
                      const void* w1t, const void* b1, const void* w2t, const void* b2,
                      const void* pos, void* out, void* stream) {
  using namespace wst_enc;
  if (b <= 0 || t <= 0) return 0;
  if (d > kWideMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16_t *e = static_cast<const bf16_t*>(even), *od = static_cast<const bf16_t*>(odd);
  const bf16_t *w1 = static_cast<const bf16_t*>(w1t), *w2 = static_cast<const bf16_t*>(w2t);
  const float *bb1 = static_cast<const float*>(b1), *bb2 = static_cast<const float*>(b2);
  const bf16_t* p = static_cast<const bf16_t*>(pos);
  bf16_t* o = static_cast<bf16_t*>(out);
  if (d <= kStemNarrowMax) return launch_stem<64, 80>(e, od, b, t, n_mels, d, w1, bb1, w2, bb2, p, o, s);
  return launch_stem<32, 33>(e, od, b, t, n_mels, d, w1, bb1, w2, bb2, p, o, s);
}

}  // extern "C"
