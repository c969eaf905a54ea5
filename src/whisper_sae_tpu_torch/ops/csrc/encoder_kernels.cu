// Hand-written Hopper kernels of the Whisper-encoder extraction path.
//
// wst_conv_stem_fwd    the conv stem, three launches of one C call:
//   stem_prep_kernel (the mel time-major with conv1's zero rows, and the
//   hidden's zero row h[-1], conv2's padding), conv1 with its bias and
//   GELU (gemm_conv_kernel<kGelu> of encoder_gemm.cu) into a bf16 [T_mel
//   + 1, D] hidden a clip in device memory, and conv2 with its bias, GELU
//   and the positions (gemm_conv_kernel<kGeluPos>).  It replaces
//   whisper_sae_tpu/ops/pallas_encoder.py:_conv_stem_kernel
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
// polynomial, 3.4e-5, is a Mosaic workaround), the residual add and the
// positions' add rounded once to bf16 after the GELU's own rounding, and
// the final-LN capture taken from the bf16-rounded layer output.
//
// Bounds on the H100 at whisper-tiny, 64 clips (T=1500, D=384, F=1536,
// 80 mels; 989 TFLOP/s bf16, 3.35 TB/s): both are bound by operations.
//   MLP block        4*(64*T)*D*F                     = 226 GFLOP   0.23 ms
//   conv stem        2*64*T*D*(6*80 + 3*D)            = 120 GFLOP   0.12 ms
// (conv1 runs at all 2T mel frames, conv2 at the T output frames).  At
// whisper-large-v3, 8 clips (D=1280, F=5120, 128 mels) a layer's MLP block
// is 315 GFLOP (0.32 ms) and the stem 142 GFLOP (0.14 ms).  An LN pass
// reads a row and writes it once (bytes: 0.03 ms for 96,000 rows of 384),
// one warp a row holding it in registers.
//
// The stem's design: both convolutions are products of three taps on the
// warp-specialised wgmma/TMA GEMM of encoder_gemm.cu (its conv row order:
// clip-shaped 3-D tensor maps whose rows are the three taps' window, read
// in place through a row stride of one frame for conv1 and two hidden rows
// for conv2, so no copy of shifted rows is made).  The prep copy and the hidden's bf16 round trip
// through device memory (147 MB at 64 tiny clips) are the price: a kernel
// keeping the hidden on chip needs all D columns of 257 hidden rows for a
// 128-frame tile (658 KB at D = 1280), or conv1 recomputed for every
// column tile of conv2 (the single-kernel stem this route replaced
// recomputed 16-18 halo rows of conv1 for every 32- or 64-frame tile and
// ran at ~90 TFLOP/s).
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

// the stem's prep and the LN rows: 8 warps a CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kPrepTile = 64;  // frames and mels of the prep's transpose tile
constexpr int kWideMax = 1536;  // widest D of the encoder kernels (the fused route's gate)

// the attention core's head dim (ops/csrc/attention_kernel.cu)
constexpr int kHeadDim = 64;

__device__ __forceinline__ uint32_t ldg32(const bf16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ void st32(bf16_t* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
// conv stem: the prep ahead of its two tap products
// ---------------------------------------------------------------------------

// mel [B, n_mels, t_mel] -> mel_pad [B, t_mel + 2, n_mels] (time-major, a
// zero row at each end of every clip: conv1's padding), and a zero row 0
// of each clip's hidden h_pad [B, t_mel + 1, d] (conv2's padding, h[-1]);
// the pad rows are written on every call (the caller's scratch is not
// zeroed).  One CTA transposes a 64-frame x 64-mel tile of one clip
// through shared memory as bf16 pairs (t_mel and n_mels even): each warp
// reads 32 frame pairs of a mel row, then writes 32 mel pairs of a frame.
// The CTAs of the first frame tile also write their mels of the two pad
// rows, and the first of them the hidden's pad row.  Bytes: 2 x 30.7 MB
// at 64 whisper-tiny clips, 0.02 ms at 3.35 TB/s.
__global__ void __launch_bounds__(kThreads) stem_prep_kernel(const bf16_t* mel, int t_mel,
                                                             int n_mels, int d, bf16_t* mel_pad,
                                                             bf16_t* h_pad) {
  __shared__ uint32_t tile[kPrepTile][kPrepTile / 2 + 1];  // [mel][frame pair]
  const int t0 = blockIdx.x * kPrepTile, c0 = blockIdx.y * kPrepTile;
  const long long clip = blockIdx.z;
  const bf16_t* src = mel + clip * n_mels * t_mel;
  bf16_t* dst = mel_pad + clip * (t_mel + 2) * n_mels;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  for (int c = warp; c < kPrepTile; c += kWarps) {
    uint32_t v = 0u;
    if (c0 + c < n_mels && t0 + 2 * lane < t_mel)
      v = ldg32(src + (long long)(c0 + c) * t_mel + t0 + 2 * lane);
    tile[c][lane] = v;
  }
  __syncthreads();
  const bool in = c0 + 2 * lane < n_mels;  // n_mels is even: so is the pair's second mel
  for (int t = warp; t < kPrepTile; t += kWarps) {
    if (!in || t0 + t >= t_mel) continue;
    const int sh = (t & 1) * 16;
    const uint32_t lo = (tile[2 * lane][t >> 1] >> sh) & 0xffffu;
    const uint32_t hi = (tile[2 * lane + 1][t >> 1] >> sh) & 0xffffu;
    st32(dst + (long long)(1 + t0 + t) * n_mels + c0 + 2 * lane, lo | (hi << 16));
  }
  if (blockIdx.x == 0) {
    if (warp < 2 && in) st32(dst + (long long)warp * (t_mel + 1) * n_mels + c0 + 2 * lane, 0u);
    if (blockIdx.y == 0)
      for (int i = threadIdx.x; i < d / 2; i += kThreads)
        st32(h_pad + clip * (t_mel + 1) * d + 2 * i, 0u);
  }
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

}  // namespace wst_enc

extern "C" {

// Geometry the kernels take (checked again in Python before each launch).
int wst_enc_head_dim() { return wst_enc::kHeadDim; }
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

// The conv stem, three launches on ``stream``: stem_prep_kernel (mel [b,
// n_mels, t_mel] bf16 into mel_pad [b, t_mel + 2, n_mels] and the pad rows
// of h_pad [b, t_mel + 1, d], both bf16 scratch), conv1 on the encoder
// GEMM (gemm_conv_kernel<kGelu>: tap j of frame f reads mel_pad row f + j;
// into rows 1 .. t_mel of h_pad) and conv2 (gemm_conv_kernel<kGeluPos>:
// tap j of frame t reads h_pad row 2t + j; into out [b, t_mel / 2, d]
// bf16).  w1t [d, 3 n_mels]
// and w2t [d, 3d] bf16 with tap j in columns j n_mels .. / j d ..; b1, b2
// [d] f32; pos [t_mel / 2, d] bf16.  d a multiple of 128 up to 1536,
// n_mels a multiple of 16, t_mel even; every pointer 16-byte aligned.
int wst_conv_stem_fwd(const void* mel, int b, int t_mel, int n_mels, int d, const void* w1t,
                      const void* b1, const void* w2t, const void* b2, const void* pos,
                      void* mel_pad, void* h_pad, void* out, void* stream) {
  using namespace wst_enc;
  if (b <= 0 || t_mel <= 0) return 0;
  if (d <= 0 || d % 128 || d > kWideMax || n_mels <= 0 || n_mels % 16 || t_mel % 2 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16_t* mp = static_cast<bf16_t*>(mel_pad);
  bf16_t* hp = static_cast<bf16_t*>(h_pad);
  const dim3 grid((t_mel + kPrepTile - 1) / kPrepTile, (n_mels + kPrepTile - 1) / kPrepTile, b);
  stem_prep_kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16_t*>(mel), t_mel, n_mels, d,
                                             mp, hp);
  int err = (int)cudaGetLastError();
  const long long h_clip = (long long)(t_mel + 1) * d;  // a clip of h_pad
  if (!err)  // row f: mel_pad rows f .. f + 2, one frame apart
    err = wst_conv_gemm_fwd(wst_gemm::kGelu, b, t_mel, 3 * n_mels, d, mp, n_mels,
                            (long long)(t_mel + 2) * n_mels, w1t, b1, hp + d, h_clip, nullptr,
                            stream);
  if (!err)  // row t: h_pad rows 2t .. 2t + 2, two rows apart
    err = wst_conv_gemm_fwd(wst_gemm::kGeluPos, b, t_mel / 2, 3 * d, d, hp, 2LL * d, h_clip, w2t,
                            b2, out, (long long)(t_mel / 2) * d, pos, stream);
  return err;
}

}  // extern "C"
