// Hand-written Hopper kernels of the TopK-SAE training path.
//
// sae_rows_kernel<kFusedLoss>   (kernel A, "sae_fused_loss_fwd")
//   replaces whisper_sae_tpu/ops/pallas_sae.py:_fused_loss_kernel, reached
//   by fused_sae_loss (pallas_call at :249) and, with a row offset into the
//   epoch buffer, by fused_sae_loss_indexed (:424).
// sae_rows_kernel<kEncodeBf16|kEncodeF32>   (kernel B, "sae_topk_encode_fwd")
//   replaces ops/pallas_sae.py:_encode_kernel (fused_topk_encode, :77).
// topk_mask_kernel   (kernel C, "topk_mask_fwd")
//   replaces ops/pallas_topk.py:_mask_kernel (topk_mask_pallas, :51).
//
// What A computes for each row (B shares the first three lines):
//   xc     = bf16(x - b_pre)
//   pre    = xc @ W_enc + b_enc                  (bf16 products, f32 sums)
//   th     = exact k-th largest of pre           (topk_common.cuh)
//   hid    = bf16(relu(pre) * [pre >= th])
//   resid  = sum_{hid_j > 0} hid_j * W_dec[j, :] + b_out - x    (f32)
//   and sum(resid^2), count(hid > 0), active[j] |= hid_j > 0.
//
// Bound on the H100 at whisper-tiny (D=384, H=3072, k=32; 989 TFLOP/s
// bf16, 3.35 TB/s): the encode product is 2*B*D*H FLOPs (9.7 GFLOP at
// B=4096, 9.8 us) and the kernel must move x, hid, resid, xc and the two
// weight matrices (B*(4D + 2H + 4D + 2D) + 2*2*D*H bytes: 50 MB at
// B=4096, 15 us), so it is bound by bytes, chiefly the bf16 latent it
// writes for the backward.  The decode reads only the k selected rows
// of W_dec (2*B*k*D FLOPs), not the dense H*D product.
//
// What the design does about it: a CTA owns 16 rows (one m16 tile of
// mma.sync.m16n8k16) and keeps their whole [16, H] f32 pre-activation in
// shared memory (192 KB at H=3072), so pre never reaches device memory,
// exactly as the TPU kernel keeps it in VMEM.  W_enc is read as its
// transpose [H, D] so each B fragment is two 32-bit loads; it stays in
// L2 (2.25 MB).  Then one warp per row moves the row into registers, runs
// the bisection there, writes the latent once and decodes straight from
// a compacted list of its selected features.
//
// Cross-CTA reductions: CTAs run concurrently (unlike the TPU grid's
// read-modify-write accumulation, pallas_sae.py:213-223), so l0 and
// active use int32 atomics (order-free, deterministic) and sum(resid^2)
// is written as one partial per CTA and summed in a fixed order by
// sae_loss_finalize_kernel.  No float atomics: the loss has the same
// bits from run to run.
//
// Not yet fast: no wgmma, TMA, warp specialisation or persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace wst {

constexpr int kRows = 16;  // rows per CTA: the M of one mma.sync tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxD = 384;  // decode keeps D/32 f32 sums per lane
constexpr int kColsPerWarpStep = 32;  // four n8 MMA tiles per warp step
constexpr int kFinalizeThreads = 256;

enum Mode { kEncodeBf16 = 0, kEncodeF32 = 1, kFusedLoss = 2 };

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(x)[i])
                : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct RowsArgs {
  const void* x;             // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  long long row_offset;      // first row of this batch in x
  int rows, d, h, k;
  const unsigned short* w_enc_t;  // [h, d] bf16: W_enc transposed
  const float* b_enc;        // [h]
  const float* b_pre;        // [d]
  const unsigned short* w_dec;    // [h, d] bf16          (A only)
  const float* b_out;        // [d] = b_dec + b_pre   (A only)
  void* hidden;              // [rows, h] bf16 (A, B bf16) or f32 (B f32)
  float* resid;              // [rows, d]             (A only)
  unsigned short* xc;        // [rows, d] bf16        (A only)
  float* sq_partial;         // [gridDim.x]           (A only)
  int* counts;               // [1 + h]: l0, active   (A only; zeroed)
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) sae_rows_kernel(RowsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = a.h + 4;  // padded strides keep MMA fragment traffic
  const int ds = a.d + 8;  // off a single bank
  float* pre_s = reinterpret_cast<float*>(smem);
  unsigned short* xc_s = reinterpret_cast<unsigned short*>(pre_s + kRows * hs);
  __shared__ float row_sq[kRows];
  __shared__ int row_l0[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int row0 = blockIdx.x * kRows;

  // -- centred bf16 rows; rows past the batch are zeros ----------------
  for (int i = tid; i < kRows * a.d; i += kThreads) {
    const int r = i / a.d, c = i - r * a.d;
    const int g = row0 + r;
    unsigned short v = 0;
    if (g < a.rows) {
      const float xv = load_x(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + c);
      v = float_to_bf16_bits(xv - a.b_pre[c]);
      if (MODE == kFusedLoss) a.xc[(size_t)g * a.d + c] = v;
    }
    xc_s[r * ds + c] = v;
  }
  if (tid < kRows) {
    row_sq[tid] = 0.0f;
    row_l0[tid] = 0;
  }
  __syncthreads();

  // -- encode: pre = xc @ W_enc + b_enc, into shared memory -------------
  {
    const int fr = lane >> 2;       // fragment row / column group
    const int fc = (lane & 3) * 2;  // fragment k (or n) pair
    for (int n0 = warp * kColsPerWarpStep; n0 < a.h; n0 += kWarps * kColsPerWarpStep) {
      float acc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      for (int k0 = 0; k0 < a.d; k0 += 16) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&xc_s[fr * ds + k0 + fc]);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(&xc_s[(fr + 8) * ds + k0 + fc]);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(&xc_s[fr * ds + k0 + fc + 8]);
        const uint32_t a3 =
            *reinterpret_cast<const uint32_t*>(&xc_s[(fr + 8) * ds + k0 + fc + 8]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned short* wp = a.w_enc_t + (size_t)(n0 + t * 8 + fr) * a.d + k0 + fc;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
          mma_bf16_16816(acc[t], a0, a1, a2, a3, b0, b1);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = n0 + t * 8 + fc;
        const float be0 = a.b_enc[col], be1 = a.b_enc[col + 1];
        pre_s[fr * hs + col] = acc[t][0] + be0;
        pre_s[fr * hs + col + 1] = acc[t][1] + be1;
        pre_s[(fr + 8) * hs + col] = acc[t][2] + be0;
        pre_s[(fr + 8) * hs + col + 1] = acc[t][3] + be1;
      }
    }
  }
  __syncthreads();

  // -- one warp per row: bisection in registers, latent, decode ---------
  for (int r = warp; r < kRows; r += kWarps) {
    const int g = row0 + r;
    if (g >= a.rows) continue;  // warp-uniform
    int xi[kMaxPerLane];
    load_row_monotone(pre_s + r * hs, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);

    if (MODE != kFusedLoss) {
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int c = j * kWarp + lane;
        if (c < a.h) {
          const float v = masked_relu(xi[j], th);
          if (MODE == kEncodeF32) {
            static_cast<float*>(a.hidden)[(size_t)g * a.h + c] = v;
          } else {
            static_cast<unsigned short*>(a.hidden)[(size_t)g * a.h + c] = float_to_bf16_bits(v);
          }
        }
      }
      continue;
    }

    // Compact the positive selections into this row's (now free) shared
    // slice as (feature << 16 | bf16 bits), in feature order.
    __syncwarp();
    unsigned int* list = reinterpret_cast<unsigned int*>(pre_s + r * hs);
    int nsel = 0;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int c = j * kWarp + lane;
      const float v = c < a.h ? masked_relu(xi[j], th) : 0.0f;
      const unsigned short bits = float_to_bf16_bits(v);
      if (c < a.h) static_cast<unsigned short*>(a.hidden)[(size_t)g * a.h + c] = bits;
      const bool pos = v > 0.0f;
      const unsigned int m = __ballot_sync(0xffffffffu, pos);
      if (pos) {
        list[nsel + __popc(m & ((1u << lane) - 1u))] = (static_cast<unsigned int>(c) << 16) | bits;
        atomicOr(&a.counts[1 + c], 1);
      }
      nsel += __popc(m);
    }
    __syncwarp();

    // resid = sum_sel hid_j * W_dec[j, :] + b_out - x, lanes over D
    float acc[kMaxD / kWarp];
#pragma unroll
    for (int t = 0; t < kMaxD / kWarp; ++t) acc[t] = 0.0f;
    const int nt = a.d / kWarp;
    for (int s = 0; s < nsel; ++s) {
      const unsigned int e = list[s];
      const float hv = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
      const unsigned short* wr = a.w_dec + (size_t)(e >> 16) * a.d + lane;
#pragma unroll
      for (int t = 0; t < kMaxD / kWarp; ++t) {
        if (t < nt) acc[t] = fmaf(hv, bf16_bits_to_float(__ldg(wr + t * kWarp)), acc[t]);
      }
    }
    float sq = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxD / kWarp; ++t) {
      if (t < nt) {
        const int c = t * kWarp + lane;
        const float xv = load_x(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + c);
        const float res = (acc[t] + a.b_out[c]) - xv;
        a.resid[(size_t)g * a.d + c] = res;
        sq = fmaf(res, res, sq);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) {
      row_sq[r] = sq;
      row_l0[r] = nsel;
    }
  }

  if (MODE == kFusedLoss) {
    __syncthreads();
    if (tid == 0) {
      float sq = 0.0f;
      int l0 = 0;
      for (int r = 0; r < kRows; ++r) {
        sq += row_sq[r];
        l0 += row_l0[r];
      }
      a.sq_partial[blockIdx.x] = sq;
      atomicAdd(&a.counts[0], l0);
    }
  }
}

// loss = sum(partials) / (rows * d) and l0 = count / rows, summed in a
// fixed order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(kFinalizeThreads) sae_loss_finalize_kernel(
    const float* partial, int n, const int* counts, int rows, int d, float* loss, float* l0) {
  __shared__ float buf[kFinalizeThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kFinalizeThreads) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kFinalizeThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *loss = buf[0] / static_cast<float>((long long)rows * d);
    *l0 = static_cast<float>(counts[0]) / static_cast<float>(rows);
  }
}

// Kernel C: hidden = relu(pre) * [pre >= k-th largest], one warp per row.
// Bound: bytes (read pre once, write hidden once: 8*B*H bytes, 30 us at
// B=4096, H=3072 on 3.35 TB/s); the TPU kernel's point, one read of pre
// instead of 32, holds here by keeping the row in registers.
__global__ void __launch_bounds__(kThreads) topk_mask_kernel(const float* pre, float* out,
                                                              int rows, int h, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (r >= rows) return;  // warp-uniform
  int xi[kMaxPerLane];
  load_row_monotone(pre + (size_t)r * h, h, lane, xi);
  const int th = warp_kth_largest(xi, k);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = j * kWarp + lane;
    if (c < h) out[(size_t)r * h + c] = masked_relu(xi[j], th);
  }
}

size_t rows_smem_bytes(int d, int h) {
  return (size_t)kRows * (h + 4) * sizeof(float) + (size_t)kRows * (d + 8) * sizeof(unsigned short);
}

template <int MODE>
int launch_rows(const RowsArgs& a, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(a.d, a.h);
  cudaError_t err = cudaFuncSetAttribute(sae_rows_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.rows + kRows - 1) / kRows;
  sae_rows_kernel<MODE><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wst

extern "C" {

// Largest row count / widths the kernels take (checked again in Python).
int wst_max_row_width() { return wst::kMaxRow; }
int wst_max_d() { return wst::kMaxD; }
int wst_rows_per_cta() { return wst::kRows; }

// Kernel A (+ the fixed-order finalize into the scalars loss and l0).
int wst_sae_fused_loss_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                           int h, int k, const void* w_enc_t, const void* b_enc,
                           const void* b_pre, const void* w_dec, const void* b_out,
                           void* hidden, void* resid, void* xc, void* sq_partial, void* counts,
                           void* loss, void* l0, void* stream) {
  wst::RowsArgs a{x,
                  x_bf16,
                  row_offset,
                  rows,
                  d,
                  h,
                  k,
                  static_cast<const unsigned short*>(w_enc_t),
                  static_cast<const float*>(b_enc),
                  static_cast<const float*>(b_pre),
                  static_cast<const unsigned short*>(w_dec),
                  static_cast<const float*>(b_out),
                  hidden,
                  static_cast<float*>(resid),
                  static_cast<unsigned short*>(xc),
                  static_cast<float*>(sq_partial),
                  static_cast<int*>(counts)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = wst::launch_rows<wst::kFusedLoss>(a, s);
  if (err != 0) return err;
  const int blocks = (rows + wst::kRows - 1) / wst::kRows;
  wst::sae_loss_finalize_kernel<<<1, wst::kFinalizeThreads, 0, s>>>(
      static_cast<const float*>(sq_partial), blocks, static_cast<const int*>(counts), rows, d,
      static_cast<float*>(loss), static_cast<float*>(l0));
  return (int)cudaGetLastError();
}

// Kernel B: hidden in bf16 (out_f32 = 0) or f32 (out_f32 = 1).
int wst_sae_topk_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                            const void* w_enc_t, const void* b_enc, const void* b_pre,
                            void* hidden, int out_f32, void* stream) {
  wst::RowsArgs a{x,       x_bf16,  0,       rows,    d,       h,       k,
                  static_cast<const unsigned short*>(w_enc_t),
                  static_cast<const float*>(b_enc),
                  static_cast<const float*>(b_pre),
                  nullptr, nullptr, hidden,  nullptr, nullptr, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? wst::launch_rows<wst::kEncodeF32>(a, s)
                 : wst::launch_rows<wst::kEncodeBf16>(a, s);
}

// Kernel C.
int wst_topk_mask_fwd(const void* pre, void* out, int rows, int h, int k, void* stream) {
  const int blocks = (rows + wst::kWarps - 1) / wst::kWarps;
  wst::topk_mask_kernel<<<blocks, wst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<float*>(out), rows, h, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
