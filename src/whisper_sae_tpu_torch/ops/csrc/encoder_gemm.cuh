// The encoder GEMM's C entries (encoder_gemm.cu) and its epilogue codes,
// for the sources that launch it (encoder_kernels.cu: the MLP block;
// sae_kernels.cu: kernel A's encode; blocked_encode.cu: the large-H
// encode's product; coder_kernels.cu: the coder modes' encodes, the ReLU
// modes' decode and the Skip mode's skip product; encoder_kernels.cu also
// the conv stem's two tap products), and
// the element functions both sources' epilogues share: the bf16 reads and
// packing, and the exact erff GELU of the Pallas kernels.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wst_gemm {

constexpr int kQkv = 0;       // q/k/v: the biases, the q scale, three outputs
constexpr int kResidual = 1;  // the bias and the residual (+ the pre-residual output)
constexpr int kGelu = 2;      // the bias and GELU
constexpr int kPre = 3;       // the bias, f32 out (the SAE's pre-activation)
constexpr int kRelu = 4;      // the bias and ReLU, bf16 out, per-feature sums, l0
constexpr int kResid = 5;     // the bias minus the rows, f32 out, sum-of-squares partials
constexpr int kGeluPos = 6;   // the bias and GELU, rounded, plus the positions (the stem's conv2)
constexpr int kEpilogues = 7;

typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) { return __uint_as_float((uint32_t)u << 16); }
// bf16(lo) in the low half, bf16(hi) in the high half: one conversion
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the exact GELU in f32 (the TPU kernels' erf polynomial is a Mosaic workaround)
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

}  // namespace wst_gemm

extern "C" int wst_enc_gemm_fwd(int epi, const void* a, const void* b, long long m, int n, int k,
                                const void* bias, float q_scale, int d, void* out0, void* out1,
                                void* out2, const void* res, void* stream);
extern "C" int wst_coder_gemm_fwd(int epi, const void* a, const void* b, long long m, int n,
                                  int k, const void* bias, void* out, void* partial, void* l0,
                                  const void* x, int x_bf16, long long row_offset,
                                  void* stream);
extern "C" int wst_conv_gemm_fwd(int epi, int clips, int rows, int k, int n, const void* a,
                                 long long a_row, long long a_clip, const void* w,
                                 const void* bias, void* out, long long out_clip,
                                 const void* pos, void* stream);
extern "C" int wst_gemm_tile();
