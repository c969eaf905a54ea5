// Hand-written Hopper kernels of the TopK-SAE training path.
//
// Kernel A ("sae_fused_loss_fwd"), one C call of four launches:
//   sae_centre_kernel, gemm_kernel<kPre> (encoder_gemm.cu),
//   sae_select_decode_kernel, sae_loss_finalize_kernel;
//   replaces whisper_sae_tpu/ops/pallas_sae.py:_fused_loss_kernel, reached
//   by fused_sae_loss (pallas_call at :249) and, with a row offset into the
//   epoch buffer, by fused_sae_loss_indexed (:424).
// sae_rows_kernel<kEncodeBf16|kEncodeF32>   (kernel B, "sae_topk_encode_fwd")
//   replaces ops/pallas_sae.py:_encode_kernel (fused_topk_encode, :77).
// topk_mask_kernel   (kernel C, "topk_mask_fwd")
//   replaces ops/pallas_topk.py:_mask_kernel (topk_mask_pallas, :51);
//   topk_mask_wide_kernel<N> ("topk_mask_wide_fwd") is its form for rows
//   wider than a warp's registers (the TPU kernel's H = 40960).
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
// B=4096, 9.8 us) and the function must move x, hid, resid, xc and the
// two weight matrices (B*(4D + 2H + 4D + 2D) + 2*2*D*H bytes: 50 MB at
// B=4096, 15 us), so it is bound by bytes, chiefly the bf16 latent it
// writes for the backward.  The decode reads only the k selected rows
// of W_dec (2*B*k*D FLOPs), not the dense H*D product.
//
// A's route, and its price:
//  1. sae_centre_kernel writes xc once, read at the row offset: it is
//     both an output (the backward's) and the encode's A operand.
//  2. The encode is encoder_gemm.cu's warp-specialised TMA/wgmma GEMM
//     with the kPre epilogue: A = xc [B, D], B = W_enc^T [H, D], pre =
//     acc + b_enc in f32 to a workspace.  Ragged D and H (multiples of
//     32) load as zeros past their ends.
//  3. sae_select_decode_kernel: one warp a row reads its row of pre into
//     registers (96 values a lane), finds the threshold (warp_kth_largest:
//     per-lane counts, stop at count == k), writes the bf16 latent,
//     compacts its positive selections into the warp's slice of shared
//     memory in feature order and decodes from those W_dec rows only,
//     four rows at a time, lanes over D (select_to_list and sparse_decode
//     of select_decode.cuh, which the coder's TopK modes share).  Shared
//     memory is the lists
//     alone (H entries of 4 bytes a warp: 48 KB a CTA at H = 3072), so
//     four CTAs of four warps fit an SM, against the one 16-row CTA that
//     the fused kernel's 192 KB tile of pre allowed.
//  4. sae_loss_finalize_kernel sums the per-CTA loss partials.
// The price is the f32 pre's round trip through device memory, 2*B*H*4
// bytes beyond the bound (101 MB, ~0.03 ms at B=4096): the traffic the
// TPU kernel keeps in VMEM.  Keeping it on chip needs a cluster holding a
// 64-row tile's pre (768 KB f32) across DSMEM.
//
// Cross-CTA reductions: CTAs run concurrently (unlike the TPU grid's
// read-modify-write accumulation, pallas_sae.py:213-223), so l0 and
// active use int32 atomics (order-free, deterministic) and sum(resid^2)
// is written as one partial per CTA and summed in a fixed order by
// sae_loss_finalize_kernel.  No float atomics: the loss has the same
// bits from run to run.
//
// Kernel B is the fused form A had before: a CTA owns 16 rows (one m16
// tile of mma.sync.m16n8k16) and keeps their [16, H] f32 pre in shared
// memory (192 KB at H=3072); W_enc^T is read from L2 with __ldg.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "select_decode.cuh"
#include "topk_common.cuh"

namespace wst {

constexpr int kRows = 16;  // kernel B: rows per CTA, the M of one mma.sync tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxD = kDecCols;  // kernel A decodes D in one pass (select_decode.cuh)
constexpr int kColsPerWarpStep = 32;  // four n8 MMA tiles per warp step
constexpr int kFinalizeThreads = 256;
constexpr int kCentreThreads = 128;

enum Mode { kEncodeBf16 = 0, kEncodeF32 = 1 };

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

// -- kernel A -------------------------------------------------------------

// xc[r, :] = bf16(x[row_offset + r, :] - b_pre), one CTA a row.
__global__ void __launch_bounds__(kCentreThreads) sae_centre_kernel(
    const void* x, int x_bf16, long long row_offset, int d, const float* b_pre,
    unsigned short* xc) {
  const size_t r = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += kCentreThreads) {
    const float xv = load_x(x, x_bf16, (size_t)(row_offset + (long long)r) * d + c);
    xc[r * d + c] = float_to_bf16_bits(xv - b_pre[c]);
  }
}

struct LossArgs {
  const void* x;             // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  long long row_offset;      // first row of this batch in x
  int rows, d, h, k;
  const float* pre;          // [rows, h] f32: xc @ W_enc + b_enc
  const unsigned short* w_dec;  // [h, d] bf16
  const float* b_out;        // [d] = b_dec + b_pre
  unsigned short* hidden;    // [rows, h] bf16
  float* resid;              // [rows, d]
  float* sq_partial;         // [gridDim.x]
  int* counts;               // [1 + h]: l0, active (zeroed)
};

// One warp a row: the threshold, the latent, the decode and the row's
// share of the loss; dynamic shared memory holds each warp's list of
// selections (h entries at most).
__global__ void __launch_bounds__(kSelThreads, 4) sae_select_decode_kernel(LossArgs a) {
  extern __shared__ unsigned int sel_lists[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int g = blockIdx.x * kSelWarps + warp;
  float sq = 0.0f;
  int nsel = 0;
  if (g < a.rows) {  // warp-uniform
    int xi[kMaxPerLane];
    load_row_monotone(a.pre + (size_t)g * a.h, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);
    unsigned int* list = sel_lists + warp * a.h;
    nsel = select_to_list(xi, th, a.h, lane, a.hidden + (size_t)g * a.h, a.counts + 1, list);

    // resid = sum_sel hid_j * W_dec[j, :] + b_out - x, lanes over D
    const int nt = a.d / kWarp;
    float acc[kDecTiles];
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) acc[t] = 0.0f;
    sparse_decode(list, nsel, a.w_dec, a.d, 0, nt, lane, acc);
    float xv[kDecTiles], bo[kDecTiles];
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) {
      const int c = (t < nt ? t : 0) * kWarp + lane;
      xv[t] = load_x(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + c);
      bo[t] = a.b_out[c];
    }
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) {
      if (t < nt) {
        const float res = (acc[t] + bo[t]) - xv[t];
        a.resid[(size_t)g * a.d + t * kWarp + lane] = res;
        sq = fmaf(res, res, sq);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  cta_partial(sq, nsel, a.sq_partial, a.counts);
}

// -- kernel B -------------------------------------------------------------

struct RowsArgs {
  const void* x;             // [rows, d] f32 or bf16
  int x_bf16;
  int rows, d, h, k;
  const unsigned short* w_enc_t;  // [h, d] bf16: W_enc transposed
  const float* b_enc;        // [h]
  const float* b_pre;        // [d]
  void* hidden;              // [rows, h] bf16 or f32
};

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) sae_rows_kernel(RowsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = a.h + 4;  // padded strides keep MMA fragment traffic
  const int ds = a.d + 8;  // off a single bank
  float* pre_s = reinterpret_cast<float*>(smem);
  unsigned short* xc_s = reinterpret_cast<unsigned short*>(pre_s + kRows * hs);

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int row0 = blockIdx.x * kRows;

  // -- centred bf16 rows; rows past the batch are zeros ----------------
  for (int i = tid; i < kRows * a.d; i += kThreads) {
    const int r = i / a.d, c = i - r * a.d;
    const int g = row0 + r;
    unsigned short v = 0;
    if (g < a.rows) v = float_to_bf16_bits(load_x(a.x, a.x_bf16, (size_t)g * a.d + c) - a.b_pre[c]);
    xc_s[r * ds + c] = v;
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

  // -- one warp per row: bisection in registers, the latent --------------
  for (int r = warp; r < kRows; r += kWarps) {
    const int g = row0 + r;
    if (g >= a.rows) continue;  // warp-uniform
    int xi[kMaxPerLane];
    load_row_monotone(pre_s + r * hs, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);
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

// Kernel C's wide form, for rows wider than one warp's registers
// (kMaxRow < h <= kMaxWideRow): one CTA per row (topk_common.cuh:
// cta_kth_largest), the row read once into registers.  Same bound as
// the warp form: bytes, 8*B*H (1.34 GB at B=8192, H=40960: 0.40 ms).
template <int N>
__global__ void __launch_bounds__(kWideThreads, 1) topk_mask_wide_kernel(const float* pre,
                                                                         float* out, int h,
                                                                         int k) {
  __shared__ int warp_cnt[2][kWideWarps];
  const size_t base = (size_t)blockIdx.x * h;
  int xi[N];
  load_wide_monotone(pre + base, h, xi);
  const int th = cta_kth_largest(xi, k, warp_cnt);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    if (c < h) out[base + c] = masked_relu(xi[j], th);
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
// Rows a CTA of the select-and-decode kernels takes (kernel A's and the
// coder's TopK modes'): one loss partial each.
int wst_rows_per_cta() { return wst::kSelWarps; }

// xc[r, :] = bf16(x[row_offset + r, :] - b_pre) for r < rows (xc [rows,
// d] bf16): kernel A's first launch, and the blocked encode's first a
// chunk (blocked_encode.cu).
int wst_sae_centre_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                       const void* b_pre, void* xc, void* stream) {
  wst::sae_centre_kernel<<<rows, wst::kCentreThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, row_offset, d, static_cast<const float*>(b_pre), static_cast<unsigned short*>(xc));
  return (int)cudaGetLastError();
}

// Kernel A: centre, encode (the GEMM's kPre epilogue into ``pre``, an
// f32 [rows, h] workspace), select and decode, then the fixed-order
// finalize into the scalars loss and l0.
int wst_sae_fused_loss_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                           int h, int k, const void* w_enc_t, const void* b_enc,
                           const void* b_pre, const void* w_dec, const void* b_out,
                           void* hidden, void* resid, void* xc, void* pre, void* sq_partial,
                           void* counts, void* loss, void* l0, void* stream) {
  if (rows <= 0 || d <= 0 || d % wst::kWarp || d > wst::kMaxD || h <= 0 || h % wst::kWarp ||
      h > wst::kMaxRow || k < 1 || k > h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = wst_sae_centre_fwd(x, x_bf16, row_offset, rows, d, b_pre, xc, stream);
  if (err) return err;
  err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, rows, h, d, b_enc, 1.0f, 0, pre, nullptr,
                         nullptr, nullptr, stream);
  if (err) return err;
  const wst::LossArgs a{x,
                        x_bf16,
                        row_offset,
                        rows,
                        d,
                        h,
                        k,
                        static_cast<const float*>(pre),
                        static_cast<const unsigned short*>(w_dec),
                        static_cast<const float*>(b_out),
                        static_cast<unsigned short*>(hidden),
                        static_cast<float*>(resid),
                        static_cast<float*>(sq_partial),
                        static_cast<int*>(counts)};
  const size_t smem = (size_t)wst::kSelWarps * h * sizeof(unsigned int);
  err = (int)cudaFuncSetAttribute(wst::sae_select_decode_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = (rows + wst::kSelWarps - 1) / wst::kSelWarps;
  wst::sae_select_decode_kernel<<<blocks, wst::kSelThreads, smem, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  wst::sae_loss_finalize_kernel<<<1, wst::kFinalizeThreads, 0, s>>>(
      static_cast<const float*>(sq_partial), blocks, static_cast<const int*>(counts), rows, d,
      static_cast<float*>(loss), static_cast<float*>(l0));
  return (int)cudaGetLastError();
}

// Kernel B: hidden in bf16 (out_f32 = 0) or f32 (out_f32 = 1).
int wst_sae_topk_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                            const void* w_enc_t, const void* b_enc, const void* b_pre,
                            void* hidden, int out_f32, void* stream) {
  wst::RowsArgs a{x,       x_bf16,  rows,    d,       h,       k,
                  static_cast<const unsigned short*>(w_enc_t),
                  static_cast<const float*>(b_enc),
                  static_cast<const float*>(b_pre),
                  hidden};
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

// Widest row the CTA-per-row kernels take.
int wst_max_wide_row_width() { return wst::kMaxWideRow; }

// Kernel C's wide form: one CTA per row.
int wst_topk_mask_wide_fwd(const void* pre, void* out, int rows, int h, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WST_LAUNCH_MASK_WIDE(N)                                                        \
  wst::topk_mask_wide_kernel<N><<<rows, wst::kWideThreads, 0, s>>>(                    \
      static_cast<const float*>(pre), static_cast<float*>(out), h, k)
  WST_WIDE_DISPATCH(h, WST_LAUNCH_MASK_WIDE)
#undef WST_LAUNCH_MASK_WIDE
  return (int)cudaGetLastError();
}

}  // extern "C"
