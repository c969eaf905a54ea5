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
// mlp_block_kernel     ("mlp_block_fwd", D <= 512) and the wide form
//   ln_rows_kernel + gemm_tn_kernel<kGelu> + gemm_tn_kernel<kResidual>
//   (+ ln_rows_kernel) ("mlp_block_wide_fwd", D = 768 .. 1536)
//   replace _mlp_block_kernel (fused_mlp_block, pallas_call at :500), all
//   four output modes.
//
// Numerics are the Pallas kernels': bf16 operands with f32 sums
// (mma.sync.m16n8k16), every bias added in f32 before the single
// rounding to bf16, LN (eps 1e-5, population variance) in f32, exact erff
// GELU (the TPU kernels' erf polynomial, 3.4e-5, is a Mosaic workaround),
// the residual add rounded once to bf16, and the final-LN capture taken
// from the bf16-rounded layer output.
//
// Bounds on the H100 at whisper-tiny, 64 clips (T=1500, D=384, F=1536;
// 989 TFLOP/s bf16): all are bound by operations, not bytes.
//   MLP block        4*(64*T)*D*F           = 226 GFLOP   0.23 ms
//   conv stem        2*64*T*D*(3*80+3*D)    = 103 GFLOP   0.10 ms
// At whisper-large-v3, 8 clips (D=1280, F=5120, 128 mels) a layer's MLP
// block is 315 GFLOP (0.32 ms) and the stem 130 GFLOP (0.13 ms).
// What the design does about it: every product runs on the tensor cores
// from a tile of rows staged once in shared memory; the weights stream
// from L2 as 32-bit B fragments in the [N, K] layout.  Up to D = 512 the
// MLP's [rows, F] hidden and the stem's [T_mel, D] hidden never reach
// device memory.
//
// The wide forms.  The stem's 64-frame tile needs 2 x 80 rows of h in
// shared memory (412 KB at D=1280); its wide form takes 32 output frames
// a CTA and keeps the 33 h rows of each parity conv2 reads (231,008 B at
// D=1536 and 128 mels, under the 232,448 B a block may have).  The
// narrow MLP kernel keeps a 64-row tile's whole [64, D] output in
// registers (D/4 floats a thread, 320 at D=1280 against 255) and both
// weight chunks in shared memory (539 KB at D=1280).  Its wide form is
// four launches: LN2 of the rows (which is also the mlp_in capture), the
// fc1 product with GELU into a [rows, F] bf16 hidden in device memory,
// the fc2 product with the bias and the residual, and, when asked, the
// final-LN capture.  The hidden's round trip is 2 x rows x F x 2 bytes
// (246 MB a layer at 8 large clips, ~0.07 ms at 3.35 TB/s) against 0.32
// ms of products.  The products are one 128 x 128-tile GEMM
// (gemm_tn_kernel, 4-stage cp.async ring, ldmatrix fragments, mma.sync).
//
// Which products run where.  The attention block's q/k/v product and
// out-projection run on the warp-specialised wgmma/TMA GEMM of
// encoder_gemm.cu.  The products here are still mma.sync: the MLP block
// (cp.async ring, ldmatrix fragments) and the conv stem (its weights read
// as 32-bit B fragments straight from L2, warp_gemm); encoder_gemm.cu's
// GEMM is their next candidate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wst_enc {

typedef unsigned short bf16_t;

constexpr int kWarp = 32;
constexpr float kLnEps = 1e-5f;

// row-tile GEMM kernels (LN+QKV, out-projection, MLP): 64 rows, 8 warps
constexpr int kRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kColTile = 32;  // columns per warp step: four n8 MMA tiles
constexpr int kMlpChunk = 32;  // F columns per step of the MLP's hidden loop
constexpr int kMlpNarrowMax = 512;  // widest D of mlp_block_kernel and the 64-frame stem
constexpr int kWideMax = 1536;      // widest D of the wide forms

// the attention core's head dim (ops/csrc/attention_kernel.cu)
constexpr int kHeadDim = 64;

// the wide MLP's GEMM: 128 x 128 output tiles, 32-deep K steps, 4 stages
constexpr int kGM = 128, kGN = 128, kGK = 32, kGStages = 4, kGLd = kGK + 8;  // 80-byte rows

__device__ __forceinline__ float bf2f(bf16_t u) { return __uint_as_float((uint32_t)u << 16); }
__device__ __forceinline__ bf16_t f2bf(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)f2bf(lo) | ((uint32_t)f2bf(hi) << 16);
}
__device__ __forceinline__ uint32_t ld32(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ void st32(bf16_t* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}
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
// 128i + 4l .. +4 for i < P, read as one 8-byte piece each.  src and
// dst_bf may lie in global or shared memory.
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

// LN2 prologue: rows row0 .. row0+kRows of x (D = 128 P) into xs (bf16,
// stride lds); rows past n are zeros.
template <int P>
__device__ __forceinline__ void ln_tile(const bf16_t* x, long long n, long long row0,
                                        const float* g, const float* b, bf16_t* xs, int lds,
                                        int warp, int lane) {
  constexpr int d = 128 * P;
  for (int r = warp; r < kRows; r += kWarps) {
    const long long gr = row0 + r;
    if (gr < n) {
      ln_row<P>(x + gr * d, g, b, xs + r * lds, nullptr, lane);
    } else {
      for (int c = lane; c < d; c += kWarp) xs[r * lds + c] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// shared helpers of the pipelined kernels
// ---------------------------------------------------------------------------

// 16-byte global->shared copy that bypasses the registers (zero-filled
// when !valid), its group fences, and the ldmatrix fragment loads.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// ---------------------------------------------------------------------------
// MLP block: out = x + bf16(GELU(LN2(x) @ W1 + b1) @ W2 + b2)
// ---------------------------------------------------------------------------

// NY = d / 64: each warp owns d/8 output columns (NY n8 tiles) of all 64
// rows, accumulated in f32 registers across the whole F loop.  F runs in
// chunks of kMlpChunk hidden columns; each chunk's W1 rows and W2 columns
// stream into one of two shared-memory stages by cp.async while the
// previous chunk is used, and every MMA fragment comes from ldmatrix.
// w1t: [f, d] (W1 transposed), w2t: [d, f] (W2 transposed).
// cap_mode: 0 none, 1 bf16, 2 f32 -- ln_f(out) of the bf16-rounded out.
template <int NY>
__global__ void __launch_bounds__(kThreads, 1) mlp_block_kernel(
    const bf16_t* x, long long n, int d, int f, const float* g, const float* bln,
    const bf16_t* w1t, const float* b1, const bf16_t* w2t, const float* b2, const float* fg,
    const float* fb, int cap_mode, bf16_t* out, void* cap, bf16_t* mlp_in, bf16_t* mlp_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldh = kMlpChunk + 8;  // 80-byte rows: ldmatrix reads hit 32 banks
  const int lds = d + 8;
  bf16_t* xs = reinterpret_cast<bf16_t*>(smem);  // LN2(x), later the rounded out rows
  bf16_t* hs = xs + kRows * lds;                 // one chunk of the GELU hidden
  bf16_t* w1s = hs + kRows * ldh;                // 2 stages of [kMlpChunk, d + 8]
  bf16_t* w2s = w1s + 2 * kMlpChunk * lds;       // 2 stages of [d, kMlpChunk + 8]
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const long long row0 = (long long)blockIdx.x * kRows;

  auto load_chunk = [&](int stage, int c0) {
    bf16_t* w1 = w1s + stage * kMlpChunk * lds;
    bf16_t* w2 = w2s + stage * d * ldh;
    const int v1 = d / 8;  // 16-byte pieces of a W1 row
    for (int i = tid; i < kMlpChunk * v1; i += kThreads) {
      const int r = i / v1, c = (i - r * v1) * 8;
      cp_async16(w1 + r * lds + c, w1t + (size_t)(c0 + r) * d + c, true);
    }
    constexpr int v2 = kMlpChunk / 8;  // 16-byte pieces of a W2 chunk row
    for (int i = tid; i < d * v2; i += kThreads) {
      const int r = i / v2, c = (i - r * v2) * 8;
      cp_async16(w2 + r * ldh + c, w2t + (size_t)r * f + c0 + c, true);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  static_assert(NY % 2 == 0, "LN takes D a multiple of 128");
  ln_tile<NY / 2>(x, n, row0, g, bln, xs, lds, warp, lane);
  __syncthreads();
  if (mlp_in) {
    for (int i = tid; i < kRows * (d / 2); i += kThreads) {
      const int r = i / (d / 2), c = (i - r * (d / 2)) * 2;
      if (row0 + r < n) st32(mlp_in + (row0 + r) * d + c, ld32(xs + r * lds + c));
    }
  }

  float y[4][NY][4];
  zero(y);
  const int ycol0 = warp * NY * 8;
  const int hm = warp & 3, hn = (warp >> 2) * 16;  // this warp's h tile: rows 16*hm, 16 columns
  const int chunks = f / kMlpChunk;
  for (int ci = 0; ci < chunks; ++ci) {
    const int st = ci & 1, c0 = ci * kMlpChunk;
    if (ci + 1 < chunks) {
      load_chunk(st ^ 1, c0 + kMlpChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16_t* w1 = w1s + st * kMlpChunk * lds;
    const bf16_t* w2 = w2s + st * d * ldh;
    {
      // h[16 rows, 16 columns] = xln . W1[:, c0 + hn ..] over all of d
      float h[2][4] = {};
      for (int k0 = 0; k0 < d; k0 += 16) {
        uint32_t a[4], b[4];
        ldsm_x4(a, xs + (hm * 16 + (lm & 1) * 8 + lr) * lds + k0 + (lm >> 1) * 8);
        ldsm_x4(b, w1 + (hn + (lm >> 1) * 8 + lr) * lds + k0 + (lm & 1) * 8);
        mma16816(h[0], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma16816(h[1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = hn + j * 8 + fc;
        const float bb0 = b1[c0 + col], bb1 = b1[c0 + col + 1];
        st32(hs + (hm * 16 + fr) * ldh + col, pack2(gelu(h[j][0] + bb0), gelu(h[j][1] + bb1)));
        st32(hs + (hm * 16 + fr + 8) * ldh + col,
             pack2(gelu(h[j][2] + bb0), gelu(h[j][3] + bb1)));
      }
    }
    __syncthreads();
    // y[64 rows, this warp's d/8 columns] += h . W2[c0 .., columns]
#pragma unroll
    for (int k0 = 0; k0 < kMlpChunk; k0 += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        ldsm_x4(a[m], hs + (m * 16 + (lm & 1) * 8 + lr) * ldh + k0 + (lm >> 1) * 8);
#pragma unroll
      for (int t = 0; t < NY; t += 2) {
        uint32_t b[4];
        ldsm_x4(b, w2 + (ycol0 + (t + (lm >> 1)) * 8 + lr) * ldh + k0 + (lm & 1) * 8);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma16816(y[m][t], a[m][0], a[m][1], a[m][2], a[m][3], b[0], b[1]);
          mma16816(y[m][t + 1], a[m][0], a[m][1], a[m][2], a[m][3], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // hs and this stage are rewritten by the next chunk
  }

#pragma unroll
  for (int t = 0; t < NY; ++t) {
    const int col = ycol0 + t * 8 + fc;
    const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m * 16 + fr + hh * 8;
        const long long gr = row0 + r;
        if (gr >= n) continue;
        const uint32_t yv = pack2(y[m][t][2 * hh] + bb0, y[m][t][2 * hh + 1] + bb1);
        const uint32_t xv = ldg32(x + gr * d + col);
        const uint32_t ov = pack2(bf2f((bf16_t)(xv & 0xffffu)) + bf2f((bf16_t)(yv & 0xffffu)),
                                  bf2f((bf16_t)(xv >> 16)) + bf2f((bf16_t)(yv >> 16)));
        st32(out + gr * d + col, ov);
        if (mlp_out) st32(mlp_out + gr * d + col, yv);
        if (cap_mode) st32(xs + r * lds + col, ov);
      }
    }
  }
  if (cap_mode) {
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const long long gr = row0 + r;
      if (gr >= n) continue;
      if (cap_mode == 2)
        ln_row<NY / 2>(xs + r * lds, fg, fb, nullptr, static_cast<float*>(cap) + gr * d, lane);
      else
        ln_row<NY / 2>(xs + r * lds, fg, fb, static_cast<bf16_t*>(cap) + gr * d, nullptr, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// MLP block, wide form: LN rows, then two 128 x 128-tile GEMMs
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

constexpr int kGelu = 0;      // out = bf16(GELU(acc + bias))
constexpr int kResidual = 1;  // y = bf16(acc + bias); out = bf16(res + y); aux = y

// C[m, n] = A[m, k] . B[n, k]^T with A and B bf16 and contiguous along k
// (the [N, K] weight layout), f32 sums, the epilogue EPI.  One CTA a
// 128 x 128 tile of C, 8 warps as 2 x 4 of 64 x 32; A and B tiles of 32
// columns stream through a 4-stage cp.async ring, fragments by ldmatrix.
// Rows of A past m load as zeros and are not stored.  n % 128 == 0,
// k % 32 == 0.
template <int EPI>
__global__ void __launch_bounds__(kThreads) gemm_tn_kernel(const bf16_t* a, const bf16_t* b,
                                                           long long m, int n, int k,
                                                           const float* bias, const bf16_t* res,
                                                           bf16_t* out, bf16_t* aux) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* as = reinterpret_cast<bf16_t*>(smem);  // [stages][128][40]
  bf16_t* bs = as + kGStages * kGM * kGLd;       // [stages][128][40]
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int wm = warp >> 2, wn = warp & 3;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const long long row0 = (long long)blockIdx.y * kGM;
  const int col0 = blockIdx.x * kGN;
  const int ksteps = k / kGK;

  auto load = [&](int stage, int k0) {
    bf16_t* ad = as + stage * kGM * kGLd;
    bf16_t* bd = bs + stage * kGN * kGLd;
    for (int i = tid; i < kGM * (kGK / 8); i += kThreads) {
      const int r = i / (kGK / 8), c = (i % (kGK / 8)) * 8;
      const long long gr = row0 + r;
      const bool ok = gr < m;
      cp_async16(ad + r * kGLd + c, a + (ok ? gr : 0) * k + k0 + c, ok);
      cp_async16(bd + r * kGLd + c, b + (size_t)(col0 + r) * k + k0 + c, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < ksteps) load(st, st * kGK);
    else cp_async_commit();
  }

  float acc[4][4][4];
  zero(acc);
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // step ks has landed; every warp is done with step ks-1's stage
    const int nk = ks + kGStages - 1;
    if (nk < ksteps) load(nk % kGStages, nk * kGK);
    else cp_async_commit();
    const bf16_t* at = as + (ks % kGStages) * kGM * kGLd + (wm * 64) * kGLd;
    const bf16_t* bt = bs + (ks % kGStages) * kGN * kGLd + (wn * 32) * kGLd;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], at + (mi * 16 + (lm & 1) * 8 + lr) * kGLd + kk + (lm >> 1) * 8);
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
        ldsm_x4(bf[t2], bt + (t2 * 16 + (lm >> 1) * 8 + lr) * kGLd + kk + (lm & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          mma16816(acc[mi][t], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bf[t >> 1][(t & 1) * 2],
                   bf[t >> 1][(t & 1) * 2 + 1]);
    }
  }

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int col = col0 + wn * 32 + t * 8 + fc;
    const float bb0 = bias[col], bb1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long gr = row0 + wm * 64 + mi * 16 + fr + hh * 8;
        if (gr >= m) continue;
        const float v0 = acc[mi][t][2 * hh] + bb0, v1 = acc[mi][t][2 * hh + 1] + bb1;
        if (EPI == kGelu) {
          st32(out + gr * n + col, pack2(gelu(v0), gelu(v1)));
        } else {
          const uint32_t yv = pack2(v0, v1);
          const uint32_t xv = ldg32(res + gr * n + col);
          st32(out + gr * n + col,
               pack2(bf2f((bf16_t)(xv & 0xffffu)) + bf2f((bf16_t)(yv & 0xffffu)),
                     bf2f((bf16_t)(xv >> 16)) + bf2f((bf16_t)(yv >> 16))));
          if (aux) st32(aux + gr * n + col, yv);
        }
      }
    }
  }
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

size_t mlp_smem(int d) {
  return (size_t)kRows * (d + 8) * sizeof(bf16_t) + (size_t)kRows * (kMlpChunk + 8) * sizeof(bf16_t) +
         (size_t)2 * kMlpChunk * (d + 8) * sizeof(bf16_t) +
         (size_t)2 * d * (kMlpChunk + 8) * sizeof(bf16_t);
}
constexpr size_t kGemmTnSmem = (size_t)kGStages * (kGM + kGN) * kGLd * sizeof(bf16_t);
template <int T_OUT, int H_KEEP>
size_t stem_smem(int n_mels, int d) {
  return ((size_t)2 * (T_OUT + 18) * (n_mels + 8) + (size_t)2 * H_KEEP * (d + 8)) * sizeof(bf16_t);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NY>
int launch_mlp(const bf16_t* x, long long n, int d, int f, const float* g, const float* bln,
               const bf16_t* w1t, const float* b1, const bf16_t* w2t, const float* b2,
               const float* fg, const float* fb, int cap_mode, bf16_t* out, void* cap,
               bf16_t* mlp_in, bf16_t* mlp_out, cudaStream_t s) {
  const size_t smem = mlp_smem(d);
  int err = set_smem(mlp_block_kernel<NY>, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  mlp_block_kernel<NY><<<blocks, kThreads, smem, s>>>(x, n, d, f, g, bln, w1t, b1, w2t, b2, fg,
                                                      fb, cap_mode, out, cap, mlp_in, mlp_out);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_gemm_tn(const bf16_t* a, const bf16_t* b, long long m, int n, int k, const float* bias,
                   const bf16_t* res, bf16_t* out, bf16_t* aux, cudaStream_t s) {
  int err = set_smem(gemm_tn_kernel<EPI>, kGemmTnSmem);
  if (err) return err;
  const dim3 grid(n / kGN, (unsigned)((m + kGM - 1) / kGM));
  gemm_tn_kernel<EPI><<<grid, kThreads, kGemmTnSmem, s>>>(a, b, m, n, k, bias, res, out, aux);
  return (int)cudaGetLastError();
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
int wst_enc_mlp_chunk() { return wst_enc::kMlpChunk; }
int wst_enc_narrow_max() { return wst_enc::kMlpNarrowMax; }
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

int wst_mlp_block_fwd(const void* x, long long n, int d, int f, const void* g, const void* bln,
                      const void* w1t, const void* b1, const void* w2t, const void* b2,
                      const void* fg, const void* fb, int cap_mode, void* out, void* cap,
                      void* mlp_in, void* mlp_out, void* stream) {
  using namespace wst_enc;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16_t* xx = static_cast<const bf16_t*>(x);
  const float *gg = static_cast<const float*>(g), *bb = static_cast<const float*>(bln);
  const bf16_t *w1 = static_cast<const bf16_t*>(w1t), *w2 = static_cast<const bf16_t*>(w2t);
  const float *bb1 = static_cast<const float*>(b1), *bb2 = static_cast<const float*>(b2);
  const float *ffg = static_cast<const float*>(fg), *ffb = static_cast<const float*>(fb);
  bf16_t* o = static_cast<bf16_t*>(out);
  bf16_t *mi = static_cast<bf16_t*>(mlp_in), *mo = static_cast<bf16_t*>(mlp_out);
  switch (d) {
    case 128: return launch_mlp<2>(xx, n, d, f, gg, bb, w1, bb1, w2, bb2, ffg, ffb, cap_mode, o, cap, mi, mo, s);
    case 256: return launch_mlp<4>(xx, n, d, f, gg, bb, w1, bb1, w2, bb2, ffg, ffb, cap_mode, o, cap, mi, mo, s);
    case 384: return launch_mlp<6>(xx, n, d, f, gg, bb, w1, bb1, w2, bb2, ffg, ffb, cap_mode, o, cap, mi, mo, s);
    case 512: return launch_mlp<8>(xx, n, d, f, gg, bb, w1, bb1, w2, bb2, ffg, ffb, cap_mode, o, cap, mi, mo, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide MLP block (D a multiple of 128 up to 1536, F a multiple of
// 128).  xln: [n, d] bf16, LN2(x) (the mlp_in capture when asked);
// hid: [n, f] bf16 scratch; mlp_out: [n, d] bf16 or null; cap as in
// wst_mlp_block_fwd (cap_mode 0 none, 1 bf16, 2 f32).
int wst_mlp_block_wide_fwd(const void* x, long long n, int d, int f, const void* g,
                           const void* bln, const void* w1t, const void* b1, const void* w2t,
                           const void* b2, const void* fg, const void* fb, int cap_mode,
                           void* out, void* cap, void* xln, void* hid, void* mlp_out,
                           void* stream) {
  using namespace wst_enc;
  if (n <= 0) return 0;
  if (d % kGN || d > kWideMax || f % kGN || d % kGK || f % kGK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16_t* xx = static_cast<const bf16_t*>(x);
  bf16_t *xl = static_cast<bf16_t*>(xln), *h = static_cast<bf16_t*>(hid);
  bf16_t* o = static_cast<bf16_t*>(out);
  int err = launch_ln_rows(xx, n, d, static_cast<const float*>(g), static_cast<const float*>(bln),
                           xl, nullptr, s);
  if (!err)
    err = launch_gemm_tn<kGelu>(xl, static_cast<const bf16_t*>(w1t), n, f, d,
                                static_cast<const float*>(b1), nullptr, h, nullptr, s);
  if (!err)
    err = launch_gemm_tn<kResidual>(h, static_cast<const bf16_t*>(w2t), n, d, f,
                                    static_cast<const float*>(b2), xx, o,
                                    static_cast<bf16_t*>(mlp_out), s);
  if (!err && cap_mode)
    err = launch_ln_rows(o, n, d, static_cast<const float*>(fg), static_cast<const float*>(fb),
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
  if (d <= kMlpNarrowMax) return launch_stem<64, 80>(e, od, b, t, n_mels, d, w1, bb1, w2, bb2, p, o, s);
  return launch_stem<32, 33>(e, od, b, t, n_mels, d, w1, bb1, w2, bb2, p, o, s);
}

}  // extern "C"
